"""tpu-compile-cache agent on the card: the elected node's half of the
prewarm loop (port of ``tpu_operator/agents/compilecache_agent.py``).

The compile-cache controller elects ONE in-service node per generation
with unsatisfied prewarm demand by stamping
``consts.COMPILE_CACHE_ELECTED_LABEL``; the prewarm DaemonSet selects on
that label. One pass:

  1. read the own Node (election label and generation labels,
     ``nodeinfo.node_generation``);
  2. read the ``tpu-compile-cache`` ConfigMap: prewarm requests of this
     generation whose content address already has a valid record for
     (generation, topology, model hash, toolchain version) are cache
     hits, with zero writes;
  3. otherwise warm up: bind the kernel build directory to the node's
     compile cache (``compilecache.bind_persistent_cache``), run the
     serving engine's warm-up, and publish the measured seconds as the
     generation's record plus a prewarm ack
     (``CompileCacheStore.publish`` and ``ack``).

The controller then clears the election and the serving controller its
satisfied request; the next replica's warm-up resolves a hit.

    python -m tpu_operator_torch.agents.compilecache_agent [--oneshot]

reads ``NODE_NAME``, ``OPERATOR_NAMESPACE`` and
``COMPILE_CACHE_INTERVAL`` and warms up on the node's card.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.agents.autotune_agent import float_env
from tpu_operator_torch.device import DeviceLike
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.nodeinfo import node_generation
from tpu_operator_torch.workloads.autotune import runtime_fingerprint
from tpu_operator_torch.workloads.compilecache import (
    CompileCacheStore,
    bind_persistent_cache,
    cache_record,
    entry_key,
    parse_entry,
    parse_requests,
)

log = logging.getLogger(__name__)


def default_warm_fn(request: dict, version: str, device: DeviceLike = None) -> float:
    """The real prewarm: bind the build directory to the node's compile
    cache, build the serving engine of the default config on ``device``
    (the card unless told otherwise) and return its measured warm-up
    (decode, chunked prefill and page gather: the warm-up a worker runs).
    The default config serves without flash prefill, as the reference's,
    whose hash the serving controller addresses requests by, so on the
    card this warm-up builds no kernel."""
    from tpu_operator_torch.workloads.serving import DecodeEngine, ServingModelConfig

    bind_persistent_cache(device=device)
    cfg = ServingModelConfig()
    engine = DecodeEngine(cfg, device=device)
    started = time.perf_counter()
    engine.warmup(min(cfg.prefill_chunk, cfg.max_seq // 4))
    return time.perf_counter() - started


class CompileCacheAgent:
    def __init__(
        self,
        client,
        node_name: str,
        namespace: str = consts.DEFAULT_OPERATOR_NAMESPACE,
        interval: float = 60.0,
        warm_fn: Optional[Callable[[dict, str], float]] = None,
        device: DeviceLike = None,
    ):
        self.client = client
        self.node_name = node_name
        self.namespace = namespace
        self.interval = interval
        # injectable for tests; the default is the real warm-up on `device`
        self.warm_fn = warm_fn or (
            lambda request, version: default_warm_fn(request, version, device=device)
        )
        self._stop = False

    # -- one pass -------------------------------------------------------------

    def reconcile_once(self) -> str:
        """Returns the pass outcome (tests and logs read it):
        ``not-elected`` | ``no-generation`` | ``no-requests`` |
        ``cache-hit`` | ``prewarmed``."""
        node = self.client.get_or_none("v1", "Node", self.node_name)
        if node is None:
            return "not-elected"
        labels = node["metadata"].get("labels") or {}
        if labels.get(consts.COMPILE_CACHE_ELECTED_LABEL) != consts.COMPILE_CACHE_ELECTED:
            # the DaemonSet nodeSelector should make this unreachable,
            # but a just-cleared label can race the pod teardown
            return "not-elected"
        generation = node_generation(node)
        if not generation or generation == "unknown":
            log.warning("compilecache: node %s has no recognizable generation",
                        self.node_name)
            return "no-generation"
        version = runtime_fingerprint()
        cm = self.client.get_or_none(
            "v1", "ConfigMap", consts.COMPILE_CACHE_CONFIGMAP, self.namespace
        )
        data = (cm or {}).get("data") or {}
        requests = parse_requests(data.get(consts.COMPILE_PREWARM_REQUEST_KEY))
        mine = {rid: r for rid, r in requests.items() if r.get("generation") == generation}
        if not mine:
            return "no-requests"
        entry = parse_entry(data.get(entry_key(generation)))
        pending = {
            rid: r for rid, r in mine.items()
            if cache_record(entry, r.get("topology", ""), r.get("model", ""), version) is None
        }
        if not pending:
            # compile-once: every requested build is already cached for
            # this toolchain; a rebooted elected node issues ZERO writes
            return "cache-hit"
        store = CompileCacheStore(self.client, self.namespace, version)
        for rid in sorted(pending):
            request = pending[rid]
            log.info("compilecache: prewarming %s on %s (toolchain %s)",
                     rid, self.node_name, version)
            seconds = self.warm_fn(request, version)
            store.publish(
                generation, request.get("topology", ""), request.get("model", ""), seconds,
                source="prewarm", serving=request.get("serving", ""), node=self.node_name,
            )
            store.ack(rid, self.node_name, seconds, "prewarmed")
        return "prewarmed"

    # -- loop -----------------------------------------------------------------

    def run_forever(self) -> None:
        while not self._stop:
            try:
                log.info("compilecache: pass outcome %s", self.reconcile_once())
            except Exception as e:  # noqa: BLE001 — a warm-up crash must not kill the pod
                if is_api_error(e, "ApiError"):
                    log.warning("compilecache: pass failed: %s", e)
                else:
                    log.exception("compilecache: prewarm failed")
            time.sleep(self.interval)

    def stop(self) -> None:
        self._stop = True


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    import argparse

    from tpu_operator_torch.kube import Client

    p = argparse.ArgumentParser("tpu-compile-cache")
    p.add_argument(
        "--oneshot", action="store_true",
        help="run one reconcile pass and exit (image smoke / debugging)",
    )
    args = p.parse_args()
    agent = CompileCacheAgent(
        Client.in_cluster(),
        node_name=os.environ.get("NODE_NAME", ""),
        namespace=os.environ.get(
            consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_OPERATOR_NAMESPACE
        ),
        interval=float_env("COMPILE_CACHE_INTERVAL", 60.0),
    )
    if args.oneshot:
        print(json.dumps({"outcome": agent.reconcile_once()}))
        return 0
    agent.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
