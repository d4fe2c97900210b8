"""tpu-health-monitor on the card: continuous per-node health probing
(port of ``tpu_operator/agents/health_monitor_agent.py``).

Every tick the agent probes what it can observe directly:

    chips    the node's cards from the one card probe
             (``native/gpuinfo.probe``), against the card count the node
             advertises (a yanked card or a dead driver loses its device
             node); per-card verdicts keyed by the card's node name
             (``nvidia<minor>``, as the device plugin's device ids)
    libtpu   the driver installer's ready marker under ``install_dir``
    plugin   the device plugin's socket under ``socket_dir``
    matmul   a cheap matmul burst on the agent's device, gated like the
             exporter's probes: ``auto`` skips quietly when a tenant holds
             the card, ``on`` counts a failure, ``off`` never runs it

The marker and the socket keep the reference's names (``consts``), which the
port's driver installer and device plugin write; their directories are
parameters.

The verdict goes out three ways: an atomically written JSON file under
``health_dir`` (the device plugin reads it), the ``tpu.google.com/tpu.health``
label with a per-card verdict annotation (the remediation controller
reads them), and a ``TPUHealthy`` node condition with an Event on each
flip (given a ``recorder``). A probe that fails to run changes nothing.

    python -m tpu_operator_torch.agents.health_monitor_agent

reads ``NODE_NAME``, ``HEALTH_CHECK_INTERVAL``, ``TPU_HEALTH_ACTIVE_PROBES``,
``LIBTPU_INSTALL_DIR``, ``KUBELET_SOCKET_DIR`` and ``HEALTH_DIR`` and
bursts on the node's card.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.consts import PLUGIN_SOCKET_NAME
from tpu_operator_torch.device import DeviceLike
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.nodeinfo import expected_cards

log = logging.getLogger(__name__)

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


class HealthMonitorAgent:
    def __init__(
        self,
        client,
        node_name: str,
        install_dir: str = consts.LIBTPU_INSTALL_DIR,
        socket_dir: str = consts.KUBELET_SOCKET_DIR,
        health_dir: str = consts.HEALTH_DIR,
        interval: float = 30.0,
        active_probes: str = "auto",
        expected_chips: Optional[int] = None,
        recorder=None,
        dev_root: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if active_probes not in ("auto", "on", "off"):
            raise ValueError(f"active_probes must be auto/on/off, got {active_probes!r}")
        self.client = client
        self.node_name = node_name
        self.install_dir = install_dir
        self.socket_dir = socket_dir
        self.health_dir = health_dir
        self.interval = interval
        self.active_probes = active_probes
        self._expected_chips = expected_chips
        # Events on verdict flips go through it (anything with the
        # reference's ``event(obj, type, reason, message)``); None: none
        self.recorder = recorder
        # the device directory the probe scans; None: its scan root's /dev
        self.dev_root = dev_root
        self.device = device
        self._last_verdict: Optional[str] = None

    # -- probes ---------------------------------------------------------------

    def expected_chips(self, node: Optional[dict] = None) -> Optional[int]:
        """How many cards this node should have (``nodeinfo.expected_cards``:
        GFD's count label, else the reference's chips-per-node label or
        catalog). Deliberately NOT the allocatable resource: device-plugin
        time-slicing replicas inflate it. Recomputed each pass; None when
        the node is unreadable or unlabelled (presence-only then)."""
        if self._expected_chips is not None:
            return self._expected_chips
        if node is None:
            if self.client is None:
                return None
            node = self.client.get_or_none("v1", "Node", self.node_name)
            if node is None:
                return None
        return expected_cards(node)

    def probe_chips(self, node: Optional[dict] = None) -> Optional[Dict[str, str]]:
        """Per-card verdicts from the card probe: a card node this container
        may open is Healthy, one of its own that fails to open is
        Unhealthy, and other containers' nodes are not its cards. When fewer
        cards are found than expected, the shortfall is named Unhealthy by
        the lowest indices with no node at all (a container sees the host's
        device minors, which need not start at 0). None when the probe
        fails (indeterminate)."""
        try:
            inventory = gpuinfo.probe(self.dev_root)
        except (OSError, RuntimeError) as e:
            log.warning("health: card probe failed: %s", e)
            return None
        verdicts = {os.path.basename(d): HEALTHY for d in inventory["devices"]}
        verdicts.update({os.path.basename(d): UNHEALTHY for d in inventory["failed"]})
        names = set(verdicts) | {os.path.basename(d) for d in inventory["refused"]}
        missing = (self.expected_chips(node) or 0) - len(verdicts)
        i = 0
        while missing > 0:
            if f"nvidia{i}" not in names:
                verdicts[f"nvidia{i}"] = UNHEALTHY
                missing -= 1
            i += 1
        return verdicts

    def probe_libtpu(self) -> bool:
        """The installer's ready marker: losing it means workloads would
        load a stale or missing runtime."""
        return os.path.exists(os.path.join(self.install_dir, consts.LIBTPU_CTR_READY_FILE))

    def probe_plugin_socket(self) -> bool:
        return os.path.exists(os.path.join(self.socket_dir, PLUGIN_SOCKET_NAME))

    def probe_matmul(self) -> Optional[bool]:
        """Cheap matmul burst on the agent's device: does the card still
        deliver compute? None (indeterminate) when the probe is off, or
        fails in ``auto`` mode: a card a tenant holds is not unhealthy."""
        if self.active_probes == "off":
            return None
        try:
            from tpu_operator_torch.workloads.matmul_bench import matmul_tflops

            report = matmul_tflops(size=256, iters=2, device=self.device)
            return report["tflops"] > 0
        except Exception as e:  # noqa: BLE001
            if self.active_probes == "auto":
                log.info("health: matmul probe skipped (card busy or unavailable): %s", e)
                return None
            log.warning("health: matmul probe failed: %s", e)
            return False

    def probe(self, node: Optional[dict] = None) -> Optional[dict]:
        """One full probe pass -> report, or None when the card inventory
        itself was indeterminate (change nothing this tick)."""
        chips = self.probe_chips(node)
        if chips is None:
            return None
        reasons: List[str] = []
        missing = sorted(c for c, v in chips.items() if v != HEALTHY)
        if missing:
            reasons.append(f"missing devices: {','.join(missing)}")
        if not chips:
            reasons.append("no TPU devices visible")
        if not self.probe_libtpu():
            reasons.append("libtpu install marker missing")
        if not self.probe_plugin_socket():
            reasons.append("device-plugin socket absent")
        matmul = self.probe_matmul()
        if matmul is False:
            reasons.append("matmul sanity probe failed")
        verdict = consts.HEALTH_DEGRADED if reasons else consts.HEALTH_HEALTHY
        return {"verdict": verdict, "chips": chips, "reasons": reasons}

    # -- publication ----------------------------------------------------------

    def write_verdicts_file(self, report: dict) -> None:
        """Atomic write so the device plugin never reads a torn file."""
        os.makedirs(self.health_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.health_dir, prefix=".verdicts-")
        with os.fdopen(fd, "w") as f:
            json.dump({"verdict": report["verdict"], "chips": report["chips"],
                       "reasons": report["reasons"]}, f)
        os.replace(tmp, os.path.join(self.health_dir, consts.HEALTH_VERDICTS_FILE))

    def _set_condition(self, node: dict, report: dict) -> None:
        """The TPUHealthy node condition through the status subresource;
        best-effort (the label is the load-bearing signal)."""
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        healthy = report["verdict"] == consts.HEALTH_HEALTHY
        cond = {
            "type": consts.TPU_HEALTH_CONDITION,
            "status": "True" if healthy else "False",
            "reason": "ProbesPassed" if healthy else "ProbeFailed",
            "message": "; ".join(report["reasons"]) or "all health probes passed",
            "lastTransitionTime": now,
        }
        conds = node.setdefault("status", {}).setdefault("conditions", [])
        existing = next((c for c in conds if c.get("type") == cond["type"]), None)
        if existing is not None:
            if existing.get("status") == cond["status"] and existing.get("message") == cond["message"]:
                return
            cond["lastTransitionTime"] = (
                existing.get("lastTransitionTime", now)
                if existing.get("status") == cond["status"]
                else now
            )
            conds[conds.index(existing)] = cond
        else:
            conds.append(cond)
        try:
            self.client.update_status(node)
        except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
            if not is_api_error(e, "ApiError"):
                raise
            log.debug("health: condition publish skipped: %s", e)

    def apply_once(self) -> bool:
        """One probe + publish pass; returns True when anything changed.
        The node is fetched once and threaded through the probe, the
        label/annotation write and the condition write."""
        node = (
            self.client.get_or_none("v1", "Node", self.node_name)
            if self.client is not None
            else None
        )
        report = self.probe(node)
        if report is None:
            return False  # indeterminate: keep current state
        self.write_verdicts_file(report)
        if self.client is None or node is None:
            return False
        labels = node["metadata"].setdefault("labels", {})
        annotations = node["metadata"].setdefault("annotations", {})
        chips_json = json.dumps(report["chips"], sort_keys=True)
        previous = labels.get(consts.TPU_HEALTH_LABEL)
        changed = (
            previous != report["verdict"]
            or annotations.get(consts.TPU_HEALTH_CHIPS_ANNOTATION) != chips_json
        )
        # a first-ever healthy verdict is not a transition: only flips
        # (and a node BORN degraded) warrant an Event
        transitioned = previous != report["verdict"] and (
            previous is not None or report["verdict"] == consts.HEALTH_DEGRADED
        )
        if changed:
            labels[consts.TPU_HEALTH_LABEL] = report["verdict"]
            annotations[consts.TPU_HEALTH_CHIPS_ANNOTATION] = chips_json
            if previous != report["verdict"]:
                # the remediation grace period is measured from this stamp
                annotations[consts.TPU_HEALTH_SINCE_ANNOTATION] = str(int(time.time()))
            try:
                # the server's response carries the fresh resourceVersion
                # for the condition write
                node = self.client.update(node) or node
            except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
                if not is_api_error(e, "Conflict"):
                    raise
                return False  # node moved under us; next tick retries
        self._set_condition(node, report)
        if transitioned and self.recorder is not None:
            degraded = report["verdict"] == consts.HEALTH_DEGRADED
            self.recorder.event(
                node,
                "Warning" if degraded else "Normal",
                "TPUHealthDegraded" if degraded else "TPUHealthRestored",
                f"node {self.node_name}: {report['verdict']}"
                + (f" ({'; '.join(report['reasons'])})" if report["reasons"] else ""),
            )
        self._last_verdict = report["verdict"]
        return changed

    def run_forever(self) -> None:
        while True:
            try:
                self.apply_once()
            except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
                if not is_api_error(e, "ApiError"):
                    raise
                log.warning("health-monitor: %s", e)
            time.sleep(self.interval)


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    from tpu_operator_torch.kube import Client

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("NODE_NAME required")
        return 1
    try:
        interval = float(os.environ.get("HEALTH_CHECK_INTERVAL", "30").strip())
    except ValueError:
        log.warning("invalid HEALTH_CHECK_INTERVAL %r; using 30s",
                    os.environ.get("HEALTH_CHECK_INTERVAL"))
        interval = 30.0
    active = os.environ.get("TPU_HEALTH_ACTIVE_PROBES", "auto").strip().lower()
    if active not in ("auto", "on", "off"):
        log.warning("invalid TPU_HEALTH_ACTIVE_PROBES %r; using auto", active)
        active = "auto"
    HealthMonitorAgent(
        Client.in_cluster(),
        node_name,
        install_dir=os.environ.get("LIBTPU_INSTALL_DIR", consts.LIBTPU_INSTALL_DIR),
        socket_dir=os.environ.get("KUBELET_SOCKET_DIR", consts.KUBELET_SOCKET_DIR),
        health_dir=os.environ.get("HEALTH_DIR", consts.HEALTH_DIR),
        interval=interval,
        active_probes=active,
    ).run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
