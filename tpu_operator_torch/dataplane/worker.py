"""Data-plane side of the pod runtime: the worker-pod mains (port of the
job half of ``tpu_operator/dataplane/worker.py``).

A kubelet runs a worker pod's *pod main*, resolved from the pod's
pod-main label value through the registry here. A main has one contract:

- ``step() -> bool`` — one data-plane beat; True means the pod's work is
  finished (phase ``Succeeded``). An exception fails the pod.

:class:`JobWorkerMain` is one TPUJob gang member. Every member publishes
``rendezvous.<index> = <gang hash>`` into the job's progress ConfigMap;
the chief (index 0) wraps
:class:`~tpu_operator_torch.workloads.training.InProcessJobRunner` and
gates training until every expected index has checked in with the
CURRENT gang hash (a stale hash is a worker from a previous generation
still draining). Checkpoint/restart barriers ride the same progress CM.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.dataplane.pods import rendezvous_state
from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.workloads.checkpoint import CheckpointStore
from tpu_operator_torch.workloads.training import (
    InProcessJobRunner,
    publish_configmap,
    read_progress,
)

# pod-main registry: pod-main label value -> factory(client, namespace, env)
_POD_MAINS: Dict[str, Callable] = {}


def register_pod_main(kind: str, factory: Callable) -> None:
    _POD_MAINS[kind] = factory


def resolve_pod_main(kind: str) -> Optional[Callable]:
    return _POD_MAINS.get(kind)


def default_checkpoint_dir(namespace: str, job_name: str) -> str:
    """Deterministic fallback store location when the TPUJob spec does
    not pin one — every gang generation of one job must resume from the
    SAME store or checkpoint-resume silently becomes restart-from-zero."""
    return os.path.join(
        tempfile.gettempdir(), f"tpuop-ckpt-{namespace}-{job_name}"
    )


class JobWorkerMain:
    """One gang member's training loop (chief) or rendezvous heartbeat
    (non-chief). ``device=None`` is CUDA (raises without it)."""

    def __init__(self, client, namespace: str, env: Dict[str, str],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.client = client
        self.namespace = env.get(consts.WORKER_ENV_NAMESPACE) or namespace
        self.job_name = env[consts.WORKER_ENV_JOB_NAME]
        self.index = int(env.get(consts.WORKER_ENV_WORKER_INDEX, "0"))
        self.count = int(env.get(consts.WORKER_ENV_WORKER_COUNT, "1"))
        self.gang_hash = env.get(consts.WORKER_ENV_GANG_HASH, "")
        self.checkpoint_dir = (
            env.get(consts.WORKER_ENV_CHECKPOINT_DIR)
            or default_checkpoint_dir(self.namespace, self.job_name)
        )
        self.steps_per_sync = int(env.get(consts.WORKER_ENV_STEPS_PER_SYNC, "3"))
        self.runner: Optional[InProcessJobRunner] = None  # chief-only, built on first step
        self.rendezvous: dict = {}

    @property
    def is_chief(self) -> bool:
        return self.index == 0

    @property
    def trainer(self):
        """The chief's trainer (history/checkpoints harvested across pod
        generations); None on non-chiefs."""
        return self.runner.trainer if self.runner is not None else None

    def _progress_name(self) -> str:
        return self.job_name + consts.JOB_PROGRESS_SUFFIX

    def step(self) -> bool:
        progress = read_progress(self.client, self._progress_name(), self.namespace)
        # check in (idempotent): rendezvous.<index> = this generation's
        # gang hash — the CM may have been recreated, so re-verify
        key = f"{consts.JOB_RENDEZVOUS_PREFIX}{self.index}"
        if progress.get(key) != self.gang_hash:
            publish_configmap(self.client, self._progress_name(), self.namespace,
                              {key: self.gang_hash})
            progress = dict(progress, **{key: self.gang_hash})
        status = progress.get(consts.JOB_PROGRESS_STATUS, "")
        if status == consts.JOB_PROGRESS_COMPLETE:
            return True  # training finished (possibly by a prior chief)
        if not self.is_chief:
            return False  # heartbeat only; the pod runs until swept
        self.rendezvous = rendezvous_state(progress, self.count, self.gang_hash)
        if not self.rendezvous["complete"]:
            return False  # gate training until the whole gang checked in
        if self.runner is None:
            self.runner = InProcessJobRunner(
                self.client, self.namespace, self.job_name,
                CheckpointStore(self.checkpoint_dir),
                steps_per_sync=self.steps_per_sync,
                device=self.device,
            )
        self.runner.sync()
        trainer = self.runner.trainer
        if trainer is None or not trainer.done:
            return False
        self.runner.close()  # the pod is done: stop its rank pool
        return True


register_pod_main(consts.POD_MAIN_JOB_WORKER, JobWorkerMain)
