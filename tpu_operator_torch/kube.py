"""The smallest in-cluster apiserver client the port's agents need.

The node agents' and the validator's ``main()``s talk to the apiserver
from their pods: read their Node and a few ConfigMaps, publish labels,
conditions and cache entries, and run the validator's workload pod. This
client speaks the kube REST API over ``urllib`` with the pod's
service-account token and CA, as the reference's ``HttpClient.in_cluster``
does (``tpu_operator/kube/http_client.py:341``), and offers only the verbs
the agents call, for v1 Nodes, ConfigMaps and Pods:

    get_or_none, create, patch (JSON merge patch), update,
    update_status, delete

Objects are plain dicts. Errors raise ``ApiError`` or one of its
subclasses ``NotFound``, ``AlreadyExists`` and ``Conflict``: the port
matches client errors by class name through the MRO (``is_api_error``),
so its agents and stores treat this client and the reference's alike.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

# kind -> (REST plural, namespaced): the only kinds the agents touch
KINDS = {"Node": ("nodes", False), "ConfigMap": ("configmaps", True), "Pod": ("pods", True)}


class ApiError(Exception):
    """An apiserver error (the HTTP status in ``code``; 0 when no response
    arrived)."""

    code = 500

    def __init__(self, message: str = "", code: Optional[int] = None):
        super().__init__(message or self.__class__.__name__)
        if code is not None:
            self.code = code


class NotFound(ApiError):
    code = 404


class AlreadyExists(ApiError):
    code = 409


class Conflict(ApiError):
    """resourceVersion mismatch on update (optimistic concurrency)."""

    code = 409


def is_api_error(exc: BaseException, *names: str) -> bool:
    """Whether ``exc`` is one of the apiserver errors ``names``. Matched by
    class name, not class: the port imports nothing of the control plane,
    and a client of any apiserver (this one, the reference's) names them
    so."""
    return any(cls.__name__ in names for cls in type(exc).__mro__)


def new_object(api_version: str, kind: str, name: str, namespace: Optional[str] = None,
               labels: Optional[dict] = None, **fields: Any) -> dict:
    """A kube object dict (the reference's ``kube.objects.new_object``)."""
    md: dict = {"name": name}
    if namespace:
        md["namespace"] = namespace
    if labels:
        md["labels"] = dict(labels)
    obj = {"apiVersion": api_version, "kind": kind, "metadata": md}
    obj.update(fields)
    return obj


class Client:
    """Requests against one apiserver. ``token_path`` is re-read on every
    request (bound service-account tokens rotate); ``ca_path`` verifies an
    https server."""

    def __init__(self, base_url: str, token: Optional[str] = None,
                 token_path: Optional[str] = None, ca_path: Optional[str] = None,
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.token_path = token_path
        self.timeout = timeout
        self._ssl = ssl.create_default_context(cafile=ca_path) if ca_path else None

    @classmethod
    def in_cluster(cls) -> "Client":
        """The pod's own apiserver, from the service env and the mounted
        service-account credentials."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise ApiError("not running in a cluster (KUBERNETES_SERVICE_HOST unset)", code=0)
        return cls(f"https://{host}:{port}", token_path=TOKEN_PATH, ca_path=CA_PATH)

    # -- plumbing -------------------------------------------------------------

    def _path(self, api_version: str, kind: str, namespace: Optional[str],
              name: str) -> str:
        if api_version != "v1" or kind not in KINDS:
            raise ValueError(f"unsupported kind {api_version}/{kind}")
        plural, namespaced = KINDS[kind]
        parts = ["/api/v1"]
        if namespaced and namespace:
            parts.append(f"namespaces/{urllib.parse.quote(namespace)}")
        parts.append(plural)
        if name:
            parts.append(urllib.parse.quote(name))
        return "/".join(parts)

    def _bearer(self) -> Optional[str]:
        if self.token_path:
            with open(self.token_path) as f:
                self.token = f.read().strip()
        return self.token

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json") -> dict:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Accept": "application/json"}
        if data is not None:
            headers["Content-Type"] = content_type
        token = self._bearer()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        req = urllib.request.Request(self.base_url + path, data=data, headers=headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout, context=self._ssl) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            if e.code == 404:
                raise NotFound(detail) from e
            if e.code == 409:
                raise (AlreadyExists if "AlreadyExists" in detail else Conflict)(detail) from e
            raise ApiError(f"{method} {path}: HTTP {e.code}: {detail}", code=e.code) from e
        except OSError as e:  # refused, reset, timed out: no response at all
            raise ApiError(f"{method} {path}: {e}", code=0) from e
        return json.loads(payload) if payload else {}

    # -- verbs ----------------------------------------------------------------

    def get_or_none(self, api_version: str, kind: str, name: str,
                    namespace: Optional[str] = None) -> Optional[dict]:
        try:
            return self._request("GET", self._path(api_version, kind, namespace, name))
        except NotFound:
            return None

    def create(self, obj: dict) -> dict:
        md = obj.get("metadata", {})
        return self._request(
            "POST", self._path(obj["apiVersion"], obj["kind"], md.get("namespace"), ""), obj)

    def patch(self, api_version: str, kind: str, name: str, patch: dict,
              namespace: Optional[str] = None) -> dict:
        """JSON merge patch (RFC 7386): a None value deletes the key."""
        return self._request("PATCH", self._path(api_version, kind, namespace, name), patch,
                             content_type="application/merge-patch+json")

    def update(self, obj: dict) -> dict:
        md = obj.get("metadata", {})
        return self._request(
            "PUT", self._path(obj["apiVersion"], obj["kind"], md.get("namespace"), md["name"]),
            obj)

    def update_status(self, obj: dict) -> dict:
        md = obj.get("metadata", {})
        path = self._path(obj["apiVersion"], obj["kind"], md.get("namespace"), md["name"])
        return self._request("PUT", path + "/status", obj)

    def delete(self, api_version: str, kind: str, name: str,
               namespace: Optional[str] = None) -> None:
        self._request("DELETE", self._path(api_version, kind, namespace, name))
