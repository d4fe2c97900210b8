"""The kubelet device plugin on a card node (port of
``tpu_operator/agents/device_plugin_agent.py``; the kubelet's v1beta1 API).

Advertises ``nvidia.com/gpu`` to the kubelet and wires the allocated cards
into containers, as NVIDIA's k8s-device-plugin does:

  1. serve the DevicePlugin service on a unix socket (``consts.PLUGIN_SOCKET_NAME``,
     the reference's name, which the health monitor checks) under the
     kubelet's device-plugin directory;
  2. dial the kubelet's Registration service on ``kubelet.sock`` and
     register the resource and that endpoint;
  3. answer ``ListAndWatch`` (the inventory, re-sent on every health
     change), ``GetPreferredAllocation`` and ``Allocate``.

The inventory comes from the one card probe (``native/gpuinfo.probe``):
one device per card, its id the card node's name (``nvidia<minor>``, the
key of the health monitor's verdicts too). A card once seen and now gone
is re-sent Unhealthy (the kubelet keeps it in capacity and stops
allocating it), as is a card whose node fails to open; the health
monitor's verdicts file overrides with Unhealthy while it is fresh.
``replicas`` (the named config's time-slicing analog) advertises each card
N times.

``Allocate`` is the card's counterpart of the reference's (its
``/dev/accel<N>`` nodes, ``TPU_VISIBLE_CHIPS`` and ``TPU_LIBRARY_PATH``):
each allocated card's ``/dev/nvidia<minor>`` plus ``/dev/nvidiactl`` and
``/dev/nvidia-uvm``, a read-only mount of the driver installer's directory,
and the env that confines the container: ``CUDA_VISIBLE_DEVICES`` and
``NVIDIA_VISIBLE_DEVICES`` name the cards by UUID, since a container's CUDA
numbers its cards from 0 whatever their minors, and ``LD_LIBRARY_PATH``
points the loader at the installed driver library.

gRPC bindings are hand-rolled over ``grpc.method_handlers_generic_handler``
on the copied messages (``agents/dpapi``), as the reference does.

    python -m tpu_operator_torch.agents.device_plugin_agent

reads ``KUBELET_SOCKET_DIR``, ``LIBTPU_INSTALL_DIR``, ``HEALTH_DIR``,
``HEALTH_VERDICTS_TTL`` and, for a named config, ``PLUGIN_CONFIG_MAP``,
``PLUGIN_CONFIG_DEFAULT``, ``NODE_NAME`` and ``OPERATOR_NAMESPACE``.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import queue
import re
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from tpu_operator_torch import consts
from tpu_operator_torch.agents.dpapi import deviceplugin_pb2 as pb
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.native import gpuinfo

log = logging.getLogger(__name__)

API_VERSION = "v1beta1"
# the node label that selects a named plugin config (the reference's key)
PLUGIN_CONFIG_LABEL = "tpu.google.com/device-plugin.config"
HEALTHY, UNHEALTHY = "Healthy", "Unhealthy"
# the driver's nodes every container with a card needs
CONTROL_DEVICES = ("/dev/nvidiactl", "/dev/nvidia-uvm")


def _unary(fn, request_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=request_cls.FromString,
        response_serializer=lambda msg: msg.SerializeToString())


def _stream(fn, request_cls):
    return grpc.unary_stream_rpc_method_handler(
        fn, request_deserializer=request_cls.FromString,
        response_serializer=lambda msg: msg.SerializeToString())


class GPUDevicePlugin:
    """Serves DevicePlugin; the inventory from the card probe."""

    # verdicts older than this are ignored: the health monitor rewrites the
    # file every tick, so a stale one means it is dead or disabled
    VERDICTS_TTL_SECONDS = 600.0
    # combination cap of the coordinate search; beyond it the index window
    # answers (C(16,8) = 12870 is the realistic worst case)
    _MAX_COMBINATIONS = 20000

    def __init__(
        self,
        socket_dir: str = consts.KUBELET_SOCKET_DIR,
        resource_name: str = consts.GPU_RESOURCE_NAME,
        install_dir: str = consts.LIBTPU_INSTALL_DIR,
        health_check_interval: float = 30.0,
        config: Optional[dict] = None,  # the selected named config
        health_dir: Optional[str] = None,  # the health monitor's verdicts dir
    ):
        self.config = config or {}
        self.socket_dir = socket_dir
        self.socket_path = os.path.join(socket_dir, consts.PLUGIN_SOCKET_NAME)
        self.resource_name = resource_name
        self.install_dir = install_dir
        self.health_dir = health_dir if health_dir is not None else os.environ.get(
            "HEALTH_DIR", consts.HEALTH_DIR)
        self.health_check_interval = health_check_interval
        self._server: Optional[grpc.Server] = None
        self._pool: Optional[futures.ThreadPoolExecutor] = None
        # one queue per ListAndWatch stream: a re-dialled stream must not have
        # its updates stolen by a zombie predecessor
        self._subscribers: List["queue.Queue"] = []
        self._sub_lock = threading.Lock()
        self._stop = threading.Event()
        self._known_devices: set = set()  # every card ever advertised
        self._last_health: Dict[str, str] = {}
        self._coords_cache: Optional[dict] = None

    # -- inventory -----------------------------------------------------------

    def discover(self) -> List[str]:
        """The card nodes this process may open (raises when the probe fails)."""
        return gpuinfo.probe()["devices"]

    def read_external_verdicts(self) -> Dict[str, str]:
        """Per-card verdicts of the health monitor (its atomically written
        JSON). A missing, torn, malformed or stale file reads as none."""
        path = os.path.join(self.health_dir, consts.HEALTH_VERDICTS_FILE)
        try:
            ttl = float(os.environ.get("HEALTH_VERDICTS_TTL", "") or self.VERDICTS_TTL_SECONDS)
        except ValueError:
            ttl = self.VERDICTS_TTL_SECONDS
        try:
            if ttl > 0 and time.time() - os.stat(path).st_mtime > ttl:
                return {}
            with open(path) as f:
                data = json.load(f)
            chips = data.get("chips") if isinstance(data, dict) else None
            if not isinstance(chips, dict):
                return {}
            return {str(k): str(v) for k, v in chips.items()}
        except (OSError, ValueError):
            return {}

    def current_health(self) -> Dict[str, str]:
        """The per-card health map: the probe's openable cards Healthy, its
        failed ones and cards seen before but gone Unhealthy, then the
        health monitor's Unhealthy verdicts over ours. A probe that fails
        keeps the last map (indeterminate)."""
        try:
            inventory = gpuinfo.probe()
        except (OSError, RuntimeError) as e:
            log.warning("device plugin: card probe failed: %s", e)
            return dict(self._last_health)
        present = {os.path.basename(p) for p in inventory["devices"]}
        self._known_devices |= present | {os.path.basename(p) for p in inventory["failed"]}
        health = {dev: HEALTHY if dev in present else UNHEALTHY
                  for dev in sorted(self._known_devices)}
        for dev, verdict in self.read_external_verdicts().items():
            if dev in health and verdict != HEALTHY:
                health[dev] = UNHEALTHY
        return health

    def _device_list(self, inventory) -> pb.ListAndWatchResponse:
        """The ListAndWatch response from a health map ({device: verdict});
        a plain list of card nodes reads as all Healthy."""
        if not isinstance(inventory, dict):
            inventory = {os.path.basename(p): HEALTHY for p in inventory}
        replicas = int(self.config.get("replicas", 1) or 1)
        devices = []
        for base in sorted(inventory, key=self._chip_index):
            health = inventory[base]
            if replicas <= 1:
                devices.append(pb.Device(ID=base, health=health))
            else:
                devices.extend(pb.Device(ID=f"{base}-rep{r}", health=health)
                               for r in range(replicas))
        return pb.ListAndWatchResponse(devices=devices)

    # -- DevicePlugin service -------------------------------------------------

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(pre_start_required=False,
                                      get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        """Stream the inventory; re-send it whenever it changes."""
        my_queue: "queue.Queue" = queue.Queue()
        with self._sub_lock:
            self._subscribers.append(my_queue)
        try:
            # _last_health belongs to health_tick: writing it here would
            # suppress the publish other subscribers rely on
            yield self._device_list(self.current_health())
            while not self._stop.is_set():
                try:
                    current = my_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                yield self._device_list(current)
        finally:
            with self._sub_lock:
                if my_queue in self._subscribers:
                    self._subscribers.remove(my_queue)

    def GetPreferredAllocation(self, request, context):
        """Prefer adjacent cards by their coordinates (``gpuinfo.chip_coords``):
        the candidate set with the least total pairwise Manhattan distance,
        then the least bounding-box volume; the contiguous index window when
        the search space is too large."""
        responses = []
        for req in request.container_requests:
            available = list(req.available_deviceIDs)
            size = req.allocation_size or len(available)
            must = list(req.must_include_deviceIDs)
            if not available or size <= 0:
                responses.append(pb.ContainerPreferredAllocationResponse(deviceIDs=must))
                continue
            best = self._torus_preferred(available, size, must)
            if best is None:
                best = self._window_preferred(available, size, must)
            responses.append(pb.ContainerPreferredAllocationResponse(deviceIDs=best))
        return pb.PreferredAllocationResponse(container_responses=responses)

    @staticmethod
    def _chip_index(dev_id: str) -> int:
        digits = re.sub(r"\D", "", dev_id.split("-rep")[0])
        return int(digits) if digits else 0

    def _torus_preferred(self, available, size, must):
        """Exhaustive search over candidate sets by block-local Manhattan
        distance (no wrap); None when infeasible or over the cap."""
        if self._coords_cache is None:
            self._coords_cache = gpuinfo.chip_coords()  # fixed for the plugin's life
        coords = self._coords_cache["coords"]
        free = [d for d in available if d not in must]
        needed = size - len(must)
        if needed < 0 or needed > len(free):
            return None
        if math.comb(len(free), needed) > self._MAX_COMBINATIONS:
            return None

        def coord(dev_id):
            idx = self._chip_index(dev_id)
            return coords[idx] if idx < len(coords) else [idx, 0, 0]

        def score(devs):
            pts = [coord(d) for d in devs]
            pairwise = sum(sum(abs(a[axis] - b[axis]) for axis in range(3))
                           for i, a in enumerate(pts) for b in pts[i + 1:])
            volume = 1
            for axis in range(3):
                vals = [p[axis] for p in pts]
                volume *= max(vals) - min(vals) + 1
            return (pairwise, volume)

        best, best_score = None, None
        for combo in itertools.combinations(free, needed):
            devs = must + list(combo)
            s = score(devs)
            if best_score is None or s < best_score:
                best, best_score = devs, s
        return best

    def _window_preferred(self, available, size, must):
        """The contiguous index window of the least spread that holds
        must_include."""
        ordered = sorted(available, key=self._chip_index)
        rest = [d for d in ordered if d not in must]
        best = (must + rest)[:size]
        best_spread = None
        for start in range(0, max(1, len(ordered) - size + 1)):
            window = ordered[start:start + size]
            if len(window) < size or not all(m in window for m in must):
                continue
            spread = self._chip_index(window[-1]) - self._chip_index(window[0])
            if best_spread is None or spread < best_spread:
                best, best_spread = window, spread
        return best

    def Allocate(self, request, context):
        """Per container: the allocated cards' device nodes and the driver's
        control nodes, the installer's directory read-only, and the env
        naming the cards by UUID. Raises when a card is unknown to the
        probe or has no UUID (the kubelet sees the call fail)."""
        cards = {os.path.basename(c["device"]): c for c in gpuinfo.probe()["cards"]}
        responses = []
        for creq in request.container_requests:
            physical = []  # replicas collapse onto their card
            for dev_id in creq.devicesIDs:
                phys = dev_id.split("-rep")[0]
                if phys not in physical:
                    physical.append(phys)
            unknown = [p for p in physical if not cards.get(p, {}).get("uuid")]
            if unknown:
                raise RuntimeError(f"no card with a UUID for {unknown} (probed {sorted(cards)})")
            uuids = ",".join(cards[p]["uuid"] for p in physical)
            paths = [f"/dev/{p}" for p in physical] + list(CONTROL_DEVICES)
            responses.append(pb.ContainerAllocateResponse(
                envs={"CUDA_VISIBLE_DEVICES": uuids, "NVIDIA_VISIBLE_DEVICES": uuids,
                      "LD_LIBRARY_PATH": self.install_dir},
                mounts=[pb.Mount(container_path=self.install_dir, host_path=self.install_dir,
                                 read_only=True)],
                devices=[pb.DeviceSpec(container_path=p, host_path=p, permissions="rw")
                         for p in paths]))
        return pb.AllocateResponse(container_responses=responses)

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()

    # -- lifecycle ------------------------------------------------------------

    def _handlers(self) -> grpc.GenericRpcHandler:
        return grpc.method_handlers_generic_handler(f"{API_VERSION}.DevicePlugin", {
            "GetDevicePluginOptions": _unary(self.GetDevicePluginOptions, pb.Empty),
            "ListAndWatch": _stream(self.ListAndWatch, pb.Empty),
            "GetPreferredAllocation": _unary(self.GetPreferredAllocation,
                                             pb.PreferredAllocationRequest),
            "Allocate": _unary(self.Allocate, pb.AllocateRequest),
            "PreStartContainer": _unary(self.PreStartContainer, pb.PreStartContainerRequest),
        })

    def serve(self) -> str:
        """Serve on the plugin socket (a stale socket file is replaced)."""
        self._shutdown()
        try:
            os.remove(self.socket_path)
        except FileNotFoundError:
            pass
        os.makedirs(self.socket_dir, exist_ok=True)
        self._pool = futures.ThreadPoolExecutor(max_workers=8)
        server = grpc.server(thread_pool=self._pool)
        server.add_generic_rpc_handlers((self._handlers(),))
        server.add_insecure_port(f"unix://{self.socket_path}")
        server.start()
        self._server = server
        return self.socket_path

    def _shutdown(self) -> None:
        """Stop the server (its streams cancelled after a second's grace)
        and its thread pool."""
        if self._server is not None:
            self._server.stop(grace=1).wait(5)
            self._server = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def register(self, kubelet_socket: Optional[str] = None) -> None:
        """Dial the kubelet's Registration service and announce ourselves."""
        kubelet_socket = kubelet_socket or os.path.join(self.socket_dir, "kubelet.sock")
        with grpc.insecure_channel(f"unix://{kubelet_socket}") as channel:
            register = channel.unary_unary(
                f"/{API_VERSION}.Registration/Register",
                request_serializer=lambda msg: msg.SerializeToString(),
                response_deserializer=pb.Empty.FromString)
            register(pb.RegisterRequest(version=API_VERSION, endpoint=consts.PLUGIN_SOCKET_NAME,
                                        resource_name=self.resource_name), timeout=10)
        log.info("registered %s with the kubelet at %s", self.resource_name, kubelet_socket)

    def health_tick(self) -> bool:
        """One health pass: re-probe, merge the health monitor's verdicts,
        and publish a ListAndWatch update only on change. True when one
        was published."""
        current = self.current_health()
        if current == self._last_health:
            return False
        self._last_health = current
        self._publish(current)
        return True

    def health_loop(self, kubelet_socket: Optional[str] = None) -> None:
        """Re-probe and re-publish each tick, and serve and register again
        when the socket vanishes (a kubelet restart wipes its device-plugin
        directory, and v1beta1 then requires registering again)."""
        while not self._stop.is_set():
            self.health_tick()
            if not os.path.exists(self.socket_path):
                log.warning("plugin socket vanished (kubelet restart?); re-registering")
                try:
                    self.serve()
                    self.register(kubelet_socket)
                except Exception as e:  # noqa: BLE001 — retried next tick
                    log.warning("re-registration failed: %s", e)
            self._stop.wait(self.health_check_interval)

    def _publish(self, inventory) -> None:
        with self._sub_lock:
            for sub in self._subscribers:
                sub.put(inventory)

    def run_forever(self, kubelet_socket: Optional[str] = None) -> None:
        self._last_health = self.current_health()
        self.serve()
        self.register(kubelet_socket)
        self.health_loop(kubelet_socket)

    def stop(self) -> None:
        self._stop.set()
        self._shutdown()


def select_plugin_config(client, node_name: str, configmap_name: str, namespace: str,
                         default: str = "") -> dict:
    """The named config for this node: the ConfigMap holds one YAML entry
    per name, and a node opts into one with ``PLUGIN_CONFIG_LABEL``, else
    ``default`` applies. {} when nothing is configured or the entry is
    not valid YAML."""
    import yaml

    if not configmap_name or client is None:
        return {}
    cm = client.get_or_none("v1", "ConfigMap", configmap_name, namespace)
    if cm is None:
        return {}
    data = cm.get("data", {}) or {}
    wanted = default
    if node_name:
        node = client.get_or_none("v1", "Node", node_name)
        if node is not None:
            wanted = (node["metadata"].get("labels") or {}).get(PLUGIN_CONFIG_LABEL, default)
    raw = data.get(wanted, "")
    if not raw:
        return {}
    try:
        return yaml.safe_load(raw) or {}
    except yaml.YAMLError:
        log.warning("plugin config %r in %s is invalid YAML", wanted, configmap_name)
        return {}


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    config = {}
    configmap = os.environ.get("PLUGIN_CONFIG_MAP", "")
    if configmap and os.environ.get("KUBERNETES_SERVICE_HOST"):
        from tpu_operator_torch.kube import Client

        try:
            config = select_plugin_config(
                Client.in_cluster(), os.environ.get("NODE_NAME", ""), configmap,
                os.environ.get(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_OPERATOR_NAMESPACE),
                default=os.environ.get("PLUGIN_CONFIG_DEFAULT", ""))
        except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
            # the config is optional: an apiserver error degrades to the
            # defaults rather than crash-looping the node's card scheduling
            if not is_api_error(e, "ApiError"):
                raise
            log.warning("plugin config unavailable (%s); using defaults", e)
        log.info("plugin config: %s", config or "(none)")
    GPUDevicePlugin(
        socket_dir=os.environ.get("KUBELET_SOCKET_DIR", consts.KUBELET_SOCKET_DIR),
        install_dir=os.environ.get("LIBTPU_INSTALL_DIR", consts.LIBTPU_INSTALL_DIR),
        config=config,
    ).run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
