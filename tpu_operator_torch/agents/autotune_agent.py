"""tpu-autotuner agent on the card: the elected node's half of the
autotune loop (port of ``tpu_operator/agents/autotune_agent.py``).

The autotune controller elects ONE in-service node per un-swept
generation by stamping ``consts.AUTOTUNE_ELECTED_LABEL``; the autotuner
DaemonSet selects on that label, so this agent runs on an elected node
only, holding its cards for the sweep window. One pass:

  1. read the own Node (election label and generation labels,
     ``nodeinfo.node_generation``);
  2. read the ``tpu-autotune-results`` ConfigMap: a valid entry for
     (generation, toolchain version) is a cache hit, with zero writes;
  3. otherwise run the generation sweep
     (``workloads.autotune.run_generation_sweep``: both tile heights of
     the flash forward and fwd+bwd kernels, the bf16 and int8 matmul
     chains) and publish the entry under ``<generation>.json`` (a
     key-scoped merge patch; the ConfigMap is created on first use).

The controller then clears the election, folds the winners into the
perf floors and publishes the winning configs. An entry swept on the CPU
records ``platform="cpu"`` and never folds.

    python -m tpu_operator_torch.agents.autotune_agent [--oneshot]

reads ``NODE_NAME``, ``OPERATOR_NAMESPACE``, ``AUTOTUNE_INTERVAL`` and
``AUTOTUNE_PROFILE`` and runs on the node's cards.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.device import DeviceLike
from tpu_operator_torch.kube import is_api_error, new_object
from tpu_operator_torch.nodeinfo import node_generation
from tpu_operator_torch.workloads.autotune import (
    entry_key,
    entry_valid,
    parse_entry,
    run_generation_sweep,
    runtime_fingerprint,
)

log = logging.getLogger(__name__)


class AutotuneAgent:
    def __init__(
        self,
        client,
        node_name: str,
        namespace: str = consts.DEFAULT_OPERATOR_NAMESPACE,
        interval: float = 60.0,
        sweep_fn: Optional[Callable[[str, str], dict]] = None,
        profile: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.client = client
        self.node_name = node_name
        self.namespace = namespace
        self.interval = interval
        # injectable for tests; the default is the real sweep on `device`
        self.sweep_fn = sweep_fn or (
            lambda gen, version: run_generation_sweep(gen, version, profile=profile,
                                                      device=device)
        )
        self._stop = False

    # -- one pass -------------------------------------------------------------

    def reconcile_once(self) -> str:
        """Returns the pass outcome (tests and logs read it):
        ``not-elected`` | ``no-generation`` | ``cache-hit`` | ``swept``."""
        node = self.client.get_or_none("v1", "Node", self.node_name)
        if node is None:
            return "not-elected"
        labels = node["metadata"].get("labels") or {}
        if labels.get(consts.AUTOTUNE_ELECTED_LABEL) != consts.AUTOTUNE_ELECTED:
            # the DaemonSet nodeSelector should make this unreachable,
            # but a just-cleared label can race the pod teardown
            return "not-elected"
        generation = node_generation(node)
        if not generation or generation == "unknown":
            log.warning("autotune: node %s has no recognizable generation", self.node_name)
            return "no-generation"
        version = runtime_fingerprint()
        cm = self.client.get_or_none(
            "v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP, self.namespace
        )
        entry = parse_entry(((cm or {}).get("data") or {}).get(entry_key(generation)))
        if entry_valid(entry, version):
            # sweep-once: the generation is already measured for this
            # toolchain; a rebooted elected node issues ZERO writes
            return "cache-hit"
        log.info("autotune: sweeping generation %s on %s (toolchain %s)",
                 generation, self.node_name, version)
        started = time.monotonic()
        entry = self.sweep_fn(generation, version)
        entry["swept_by"] = self.node_name
        entry["sweep_seconds"] = round(time.monotonic() - started, 2)
        self._publish(generation, entry, cm_exists=cm is not None)
        return "swept"

    def _publish(self, generation: str, entry: dict, cm_exists: bool) -> None:
        """Key-scoped merge patch of this generation's entry; the
        ConfigMap is created on first use (concurrent creators converge
        through AlreadyExists -> patch)."""
        body = {"data": {entry_key(generation): json.dumps(entry, sort_keys=True)}}
        if not cm_exists:
            cm = new_object(
                "v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP,
                self.namespace, labels={"app": "tpu-autotuner"},
                data=body["data"],
            )
            try:
                self.client.create(cm)
                return
            except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
                if not is_api_error(e, "AlreadyExists"):
                    raise
                # another generation's agent won the race
        self.client.patch(
            "v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP, body, self.namespace,
        )

    # -- loop -----------------------------------------------------------------

    def run_forever(self) -> None:
        while not self._stop:
            try:
                log.info("autotune: pass outcome %s", self.reconcile_once())
            except Exception as e:  # noqa: BLE001 — a sweep crash must not kill the pod
                if is_api_error(e, "ApiError"):
                    log.warning("autotune: pass failed: %s", e)
                else:
                    log.exception("autotune: sweep failed")
            time.sleep(self.interval)

    def stop(self) -> None:
        self._stop = True


def float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)).strip())
    except ValueError:
        log.warning("invalid %s %r; using %s", name, os.environ.get(name), default)
        return default


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    import argparse

    from tpu_operator_torch.kube import Client

    p = argparse.ArgumentParser("tpu-autotuner")
    p.add_argument(
        "--oneshot", action="store_true",
        help="run one reconcile pass and exit (image smoke / debugging)",
    )
    args = p.parse_args()
    agent = AutotuneAgent(
        Client.in_cluster(),
        node_name=os.environ.get("NODE_NAME", ""),
        namespace=os.environ.get(
            consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_OPERATOR_NAMESPACE
        ),
        interval=float_env("AUTOTUNE_INTERVAL", 60.0),
        profile=os.environ.get("AUTOTUNE_PROFILE") or None,
    )
    if args.oneshot:
        print(json.dumps({"outcome": agent.reconcile_once()}))
        return 0
    agent.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
