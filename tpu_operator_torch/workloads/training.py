"""Resumable elastic training: the TPUJob data plane (port of
``tpu_operator/workloads/training.py``).

A :class:`ResumableTrainer` wraps the burn-in train step
(``workloads/burnin.py``) with the two properties elastic training
needs:

- **checkpoint/resume** through ``workloads/checkpoint.py``: params leave
  the ranks as float32 numpy arrays in the reference's global layout, so
  a checkpoint taken on one world restores onto any world, and a store
  written by the JAX package's trainer restores here (and the reverse);
- **world re-derivation**: the trainer is told how many hosts its gang
  has and derives a world of ranks for it (:func:`derive_world`), one
  rank per card. The global batch is fixed, so the loss at step *k* is a
  function of the initial params and *k* alone, which is what makes
  loss-curve continuity provable across a shrink (modulo reduction-order
  float noise).

A world of one rank steps in the trainer's own process, through one
step built once (on a card, a CUDA graph replay: a resume restores the
checkpoint into its parameter tensors in place). A larger world
is a :class:`~tpu_operator_torch.workloads.distributed.RankPool`: the
sharded step runs SPMD on ``world`` rank processes over
``torch.distributed`` (NCCL, rank r on card r; gloo when the caller names
the CPU), the trainer sends them bursts of steps and collects rank 0's
losses. The pool lives until the next :meth:`ResumableTrainer.resume` or
:meth:`ResumableTrainer.close`.

:class:`InProcessJobRunner` plays the data plane against an apiserver
client (reads the job's placed gang, pauses when it is broken, resumes
when its host count changes, honours the checkpoint barrier and the
restart handshake, publishes the progress ConfigMap).
:func:`verify_continuity` is the acceptance predicate, copied unchanged.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.weights import burnin_params
from tpu_operator_torch.workloads.burnin import (
    BurninConfig,
    build_train_step,
    gather_burnin_params,
    make_mesh,
    param_shardings,
    seeded_params,
)
from tpu_operator_torch.workloads.checkpoint import CheckpointStore
from tpu_operator_torch.workloads.distributed import RankPool

log = logging.getLogger(__name__)


class TrainerError(RuntimeError):
    """A training step failed (injected fault or a real non-finite
    loss): the runner publishes ``status=error`` and the controller
    decides whether to burn a restart or quarantine the job."""


def trainer_config(overrides: Optional[dict] = None) -> BurninConfig:
    """A BurninConfig from a TPUJob's ``spec.workload.config`` dict
    (keys = BurninConfig field names; unknown keys ignored so a newer CR
    never crashes an older trainer). The default is a deliberately tiny
    model."""
    base = {
        "d_model": 32,
        "n_heads": 2,
        "d_ff": 64,
        "seq_len": 16,
        "batch": 8,
        "n_layers": 1,
    }
    known = {f.name for f in dataclasses.fields(BurninConfig)}
    for key, value in (overrides or {}).items():
        if key in known:
            base[key] = value
    return BurninConfig(**base)


def derive_world(hosts: int, batch: int, ranks: int = 1) -> int:
    """Ranks for a gang of ``hosts``: the largest power of two that fits
    the hosts, the ``ranks`` this machine can run (its cards) and the
    fixed global batch. Deterministic, so every gang member derives the
    same world."""
    cap = max(1, min(hosts, ranks, batch))
    world = 1
    while world * 2 <= cap:
        world *= 2
    return world


def mesh_shape(cfg: BurninConfig, world: int) -> tuple:
    """(data, model) for a world: model is the largest of 1, 2 and 4 that
    divides the world, the heads, the kv heads and d_ff (the port shards
    each of them over ``model``), and data takes the rest."""
    model = max(m for m in (1, 2, 4)
                if not (world % m or cfg.n_heads % m or cfg.resolved_kv_heads % m or cfg.d_ff % m))
    return world // model, model


@dataclasses.dataclass
class ResumeInfo:
    epoch: int  # checkpoint epoch resumed from (0 = from scratch)
    step: int  # step the trainer restarts at
    world: int  # ranks in the re-derived world
    hosts: int  # gang hosts the world was derived from
    latency_s: float  # wall time of the whole resume (world + load + build)


def _run_steps(step, params, batch, count: int) -> tuple:
    """Up to ``count`` steps, stopping after a non-finite loss: (params,
    [(loss, seconds)])."""
    done = []
    for _ in range(count):
        t0 = time.perf_counter()
        params, loss = step(params, batch)
        loss = float(loss)  # waits for the step
        done.append((loss, time.perf_counter() - t0))
        if not math.isfinite(loss):
            break
    return params, done


# a pool rank's share of the trainer (each rank is a process of its own)
_RANK: dict = {}


def _rank_setup(cfg: BurninConfig, device: str, arrays, batch, data: int, model: int) -> None:
    """A pool rank's share of the trainer: its mesh and its shards."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    mesh = make_mesh(data, model)
    step, params, local = build_train_step(cfg, dev, params=arrays, batch=batch, mesh=mesh)
    _RANK.update(cfg=cfg, mesh=mesh, step=step, params=params, batch=local)


def _rank_run(count: int):
    """``count`` steps on every rank (the losses are global); rank 0
    returns [(loss, seconds)]."""
    _RANK["params"], done = _run_steps(_RANK["step"], _RANK["params"], _RANK["batch"], count)
    return done if torch.distributed.get_rank() == 0 else None


def _rank_release() -> None:
    """Drops the rank's step and shards before its world is torn down: on a
    card the step's graph holds the world's NCCL communicators, and a rank
    that destroys its process group with the graph alive does not exit
    within the pool's grace (on four H100s every resume took the grace's
    10 s longer)."""
    _RANK.clear()


def _rank_gather():
    """The global params (a collective); rank 0 returns them."""
    arrays = gather_burnin_params(_RANK["params"], _RANK["cfg"], _RANK["mesh"])
    return arrays if torch.distributed.get_rank() == 0 else None


class ResumableTrainer:
    """One job's stepped training loop, elastically resumable.

    ``params``/``batch`` are the state a fresh start begins from (the
    reference's numpy arrays in its global layout; by default the port's
    seeded ones). ``device=None`` is CUDA, with one rank per card; on the
    CPU, which a caller must name, ``cpu_ranks`` stands for the cards."""

    def __init__(
        self,
        store: CheckpointStore,
        cfg: Optional[BurninConfig] = None,
        total_steps: int = 40,
        checkpoint_every: int = 10,
        fail_at_steps: Sequence[int] = (),
        device: DeviceLike = None,
        cpu_ranks: int = 1,
        params: Optional[Mapping[str, np.ndarray]] = None,
        batch: Optional[Sequence[np.ndarray]] = None,
    ):
        self.store = store
        self.cfg = cfg or trainer_config()
        self.total_steps = int(total_steps)
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.device = device
        self.cpu_ranks = int(cpu_ranks)
        self.step = 0
        self.hosts = 0
        self.world = 0
        self.checkpoint_epoch = 0
        self.checkpoint_step = 0
        # executed-step history incl. re-runs after resume: the
        # continuity evidence (step, loss, world)
        self.history: List[dict] = []
        self.checkpoints: List[dict] = []  # {epoch, step}
        self.step_times: Dict[int, List[float]] = {}  # world -> durations
        self.resumes: List[ResumeInfo] = []
        # one-shot injected faults: executing one of these steps raises
        # TrainerError instead (then arms off, like a transient crash)
        self._fail_at = set(int(s) for s in fail_at_steps)
        self._init_params = params
        self._init_batch = batch
        # a world of one rank: the step and its state in this process
        self._step_fn = None
        self._params = None
        self._batch = None
        # a larger world: its rank processes
        self._pool: Optional[RankPool] = None

    @property
    def done(self) -> bool:
        return self.step >= self.total_steps

    @property
    def ready(self) -> bool:
        """Resumed, and its world still up."""
        return self._step_fn is not None or (self._pool is not None and not self._pool.closed)

    # -- resume --------------------------------------------------------------

    def resume(self, hosts: int) -> ResumeInfo:
        """(Re)build the world for a gang of ``hosts`` and restore from
        the newest good checkpoint (or initialize at step 0). Always
        restarts at the checkpoint step: work past it is re-executed —
        that is the resume guarantee's cost, bounded by the cadence."""
        dev = resolve_device(self.device)
        t0 = time.perf_counter()
        self._close_pool()
        ranks = torch.cuda.device_count() if dev.type == "cuda" else self.cpu_ranks
        world = derive_world(hosts, self.cfg.batch, ranks)
        arrays = self._init_params
        ckpt = self.store.latest_good()
        if ckpt is not None:
            arrays = {k: np.asarray(ckpt.arrays[k]) for k in param_shardings(self.cfg)}
            self.step = ckpt.step
            self.checkpoint_epoch = ckpt.epoch
            self.checkpoint_step = ckpt.step
        else:
            self.step = 0
        if world == 1 and self._step_fn is not None:
            self._restore(arrays)
        elif world == 1:
            self._step_fn, self._params, self._batch = build_train_step(
                self.cfg, dev, params=arrays, batch=self._init_batch)
        else:
            self._drop_local()
            self._pool = RankPool(world, _rank_setup,
                                  (self.cfg, dev.type, arrays, self._init_batch,
                                   *mesh_shape(self.cfg, world)), device=dev)
        self.hosts, self.world = hosts, world
        info = ResumeInfo(
            epoch=self.checkpoint_epoch,
            step=self.step,
            world=world,
            hosts=hosts,
            latency_s=time.perf_counter() - t0,
        )
        self.resumes.append(info)
        return info

    def _restore(self, arrays: Optional[Mapping[str, np.ndarray]]) -> None:
        """Write ``arrays`` (None: the seeded start) into the one-rank
        step's parameter tensors in place: on a card the step's graph reads
        exactly those tensors, so rebinding them would leave it reading
        stale ones."""
        new = burnin_params(seeded_params(self.cfg) if arrays is None else arrays,
                            self.cfg, "cpu")
        with torch.no_grad():
            for name, param in self._params.items():
                param.copy_(new[name])

    def _close_pool(self) -> None:
        if self._pool is not None:
            if not self._pool.closed:
                self._pool.call(_rank_release)
            self._pool.close()
            self._pool = None

    def _drop_local(self) -> None:
        self._step_fn = self._params = self._batch = None
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()  # a pool's rank 0 shares card 0

    def close(self) -> None:
        """Stop the world: the rank pool, or the in-process state. The
        trainer must :meth:`resume` before it runs again."""
        self._close_pool()
        self._drop_local()

    # -- stepping ------------------------------------------------------------

    def _steps(self, count: int) -> list:
        if self._pool is not None:
            return self._pool.call(_rank_run, count)[0]
        self._params, done = _run_steps(self._step_fn, self._params, self._batch, count)
        return done

    def run(self, max_steps: int) -> int:
        """Advance up to ``max_steps`` (stopping at total_steps),
        checkpointing at the cadence; returns steps executed. Steps go to
        the world in bursts that end at the next checkpoint, injected
        fault or the end."""
        if not self.ready:
            raise RuntimeError("resume() before run()")
        executed = 0
        while executed < max_steps and self.step < self.total_steps:
            nxt = self.step + 1
            if nxt in self._fail_at:
                self._fail_at.discard(nxt)
                raise TrainerError(f"injected failure at step {nxt}")
            fault = min((s for s in self._fail_at if s > nxt), default=self.total_steps + 1)
            burst = min(max_steps - executed, self.total_steps - self.step,
                        self.checkpoint_every - self.step % self.checkpoint_every, fault - nxt)
            for loss, duration in self._steps(burst):
                nxt = self.step + 1
                if not math.isfinite(loss):
                    raise TrainerError(f"non-finite loss at step {nxt}: {loss}")
                self.step = nxt
                self.step_times.setdefault(self.world, []).append(duration)
                self.history.append({"step": nxt, "loss": loss, "world": self.world})
                executed += 1
            if self.step % self.checkpoint_every == 0 or self.done:
                self.checkpoint()
        return executed

    def checkpoint(self) -> int:
        """Persist the live params; returns the new epoch. Idempotent at
        a step: the barrier path may call it with zero new steps."""
        if not self.ready:
            raise RuntimeError("resume() before checkpoint()")
        if self.checkpoint_step == self.step and self.checkpoint_epoch:
            return self.checkpoint_epoch  # nothing new to persist
        if self._pool is not None:
            arrays = self._pool.call(_rank_gather)[0]
        else:
            arrays = {k: v.detach().float().cpu().numpy() for k, v in self._params.items()}
        last_loss = self.history[-1]["loss"] if self.history else None
        epoch = self.store.save(
            self.step, arrays,
            meta={"world": self.world, "hosts": self.hosts, "loss": last_loss},
        )
        self.checkpoint_epoch = epoch
        self.checkpoint_step = self.step
        self.checkpoints.append({"epoch": epoch, "step": self.step})
        return epoch


# ---------------------------------------------------------------------------
# continuity verification
# ---------------------------------------------------------------------------


def verify_continuity(
    history: Sequence[dict],
    checkpoints: Sequence[dict],
    total_steps: int,
    loss_rtol: float = 1e-3,
) -> dict:
    """The loss-curve-continuity acceptance predicate over a trainer's
    executed-step history. Verifies:

    - **coverage**: the executed steps cover 1..total_steps with no gap
      and the run finished;
    - **bounded rewinds**: every backward jump lands exactly one past a
      step some checkpoint covered (work is only ever lost back to the
      last checkpoint, never an arbitrary distance), and nothing past
      the newest checkpoint is ever REPEATED without an intervening
      rewind (monotone within segments);
    - **loss continuity**: a re-executed step reproduces the loss its
      first execution recorded (same checkpointed params + fixed batch
      ⇒ same curve, within reduction-order float noise across meshes).

    Returns {ok, violations, rewinds, max_lost_steps, covered}.
    """
    violations: List[str] = []
    ckpt_steps = {int(c["step"]) for c in checkpoints}
    seen_loss: Dict[int, float] = {}
    rewinds = 0
    max_lost = 0
    prev = 0
    covered = set()
    for record in history:
        step, loss = int(record["step"]), float(record["loss"])
        if step <= prev:  # a rewind (resume re-executing lost work)
            rewinds += 1
            if (step - 1) not in ckpt_steps and step != 1:
                violations.append(
                    f"rewind to step {step} not anchored at a checkpoint"
                )
            max_lost = max(max_lost, prev - step + 1)
        elif step != prev + 1:
            violations.append(f"forward gap: step {prev} -> {step}")
        if step in seen_loss:
            ref = seen_loss[step]
            if abs(loss - ref) > loss_rtol * (1.0 + abs(ref)):
                violations.append(
                    f"loss discontinuity at step {step}: {ref} -> {loss}"
                )
        else:
            seen_loss[step] = loss
        covered.add(step)
        prev = step
    if total_steps and covered != set(range(1, total_steps + 1)):
        missing = sorted(set(range(1, total_steps + 1)) - covered)[:5]
        violations.append(f"steps never executed: {missing}")
    return {
        "ok": not violations,
        "violations": violations,
        "rewinds": rewinds,
        "max_lost_steps": max_lost,
        "covered": len(covered),
    }


# ---------------------------------------------------------------------------
# the in-process gang harness
# ---------------------------------------------------------------------------


def labels_unavailable(labels: dict) -> bool:
    """The health subsystem's exclusion predicate (a copy of the placement
    engine's): a node mid-repair, flagged degraded, or below its perf
    floor is out of service."""
    return (
        bool(labels.get(consts.REPAIR_STATE_LABEL))
        or labels.get(consts.TPU_HEALTH_LABEL) == consts.HEALTH_DEGRADED
        or labels.get(consts.TPU_PERF_LABEL) == consts.PERF_DEGRADED
    )


def node_unavailable(node: dict) -> bool:
    return labels_unavailable(node["metadata"].get("labels") or {})


def publish_configmap(client, name: str, namespace: str, data: Dict[str, str]) -> None:
    """Create-or-patch ``data`` into a ConfigMap (merge-patch semantics:
    keys not in ``data`` are never touched). A create that loses a race
    to another writer ends in a patch."""
    patch = {"data": data}
    try:
        client.patch("v1", "ConfigMap", name, patch, namespace)
        return
    except Exception as e:
        if not is_api_error(e, "NotFound"):
            raise
    try:
        client.create({"apiVersion": "v1", "kind": "ConfigMap",
                       "metadata": {"name": name, "namespace": namespace}, "data": data})
    except Exception as e:
        if not is_api_error(e, "AlreadyExists"):
            raise
        client.patch("v1", "ConfigMap", name, patch, namespace)


def read_progress(client, name: str, namespace: str) -> dict:
    cm = client.get_or_none("v1", "ConfigMap", name, namespace)
    return (cm or {}).get("data") or {}


class InProcessJobRunner:
    """Plays a TPUJob's gang against the cluster. Each ``sync()`` is one
    data-plane beat:

    1. read the job + its owned slice; pause (no steps) unless the gang
       is Scheduled AND every member is in service — a real gang's
       collectives hang on a dead member, they don't keep stepping;
    2. when the placed gang's host count differs from the trainer's,
       resume from the newest good checkpoint on a re-derived world
       (recording the resume latency);
    3. honor the controller's checkpoint barrier (``checkpointRequest`` →
       checkpoint now → ``checkpointAck``) and restart handshake;
    4. run a bounded burst of steps (checkpointing at the cadence) and
       publish the progress ConfigMap.

    The client is any apiserver client with ``get_or_none``, ``patch``
    and ``create`` over plain dicts."""

    def __init__(
        self,
        client,
        namespace: str,
        job_name: str,
        store: CheckpointStore,
        steps_per_sync: int = 4,
        fail_at_steps: Sequence[int] = (),
        device: DeviceLike = None,
    ):
        self.client = client
        self.namespace = namespace
        self.job_name = job_name
        self.store = store
        self.steps_per_sync = steps_per_sync
        self.device = resolve_device(device)
        self._fail_at = tuple(fail_at_steps)
        self.trainer: Optional[ResumableTrainer] = None
        self._errored = False
        self._migration_acked = False  # this generation is being moved

    # -- cluster reads -------------------------------------------------------

    def _job(self) -> Optional[dict]:
        return self.client.get_or_none(consts.TPU_JOB_API_VERSION, consts.TPU_JOB_KIND,
                                       self.job_name)

    def _gang_hosts(self) -> int:
        """Hosts of the job's placed gang — 0 unless the owned slice is
        Scheduled and every member is in service."""
        obj = self.client.get_or_none(
            consts.TPU_SLICE_API_VERSION, consts.TPU_SLICE_KIND,
            self.job_name + consts.JOB_SLICE_SUFFIX,
        )
        if obj is None:
            return 0
        placement = (obj.get("status") or {}).get("placement") or {}
        if placement.get("phase") != "Scheduled":
            return 0
        nodes = placement.get("nodes") or []
        for name in nodes:
            node = self.client.get_or_none("v1", "Node", name)
            if node is None or node_unavailable(node):
                return 0
        return len(nodes)

    def _new_trainer(self, job: dict) -> ResumableTrainer:
        """The trainer a TPUJob's spec asks for, with the spec's defaults
        (steps 100, config {}, everySteps 10)."""
        spec = job.get("spec") or {}
        workload = spec.get("workload") or {}
        return ResumableTrainer(
            self.store,
            cfg=trainer_config(workload.get("config", {})),
            total_steps=workload.get("steps", 100),
            checkpoint_every=(spec.get("checkpoint") or {}).get("everySteps", 10),
            fail_at_steps=self._fail_at,
            device=self.device,
        )

    # -- progress publication ------------------------------------------------

    @property
    def progress_name(self) -> str:
        return self.job_name + consts.JOB_PROGRESS_SUFFIX

    # -- one beat ------------------------------------------------------------

    def sync(self) -> dict:
        actions: dict = {}
        obj = self._job()
        if obj is None:
            return {"paused": "job gone"}
        if ((obj.get("status") or {}).get("job") or {}).get("phase") in consts.TERMINAL_PHASES:
            return {"paused": "terminal"}
        hosts = self._gang_hosts()
        if hosts <= 0:
            return {"paused": "gang not placed/healthy"}
        if self.trainer is None:
            self.trainer = self._new_trainer(obj)
        trainer = self.trainer
        if trainer.hosts != hosts or not trainer.ready:
            actions["resumed"] = dataclasses.asdict(trainer.resume(hosts))
            self._errored = False
        progress = read_progress(self.client, self.progress_name, self.namespace)
        data: Dict[str, str] = {}
        restart_req = progress.get(consts.JOB_RESTART_REQUEST, "")
        restart_ack = progress.get(consts.JOB_PROGRESS_RESTART_ACK, "")
        if restart_req and restart_req != restart_ack:
            # the controller restarted the job after a trainer error:
            # resume from the newest good checkpoint, like fresh worker
            # pods replacing crashed ones
            actions["restarted"] = dataclasses.asdict(trainer.resume(hosts))
            self._errored = False
            data[consts.JOB_PROGRESS_RESTART_ACK] = restart_req
            data[consts.JOB_PROGRESS_ERROR] = ""
        request = progress.get(consts.JOB_CHECKPOINT_REQUEST, "")
        ack = progress.get(consts.JOB_PROGRESS_CHECKPOINT_ACK, "")
        if request and request != ack:
            trainer.checkpoint()
            data[consts.JOB_PROGRESS_CHECKPOINT_ACK] = request
            actions["checkpointed"] = trainer.checkpoint_epoch
        # hold at a planned-MIGRATION barrier (defrag-/risk- tokens): the
        # controller is about to tear this gang down, and any step run
        # past the acked checkpoint would be re-executed by the next pod
        # generation. The controller clears the key for the NEXT
        # generation; this one stays held for the rest of its life (the
        # re-placed gang can come up before this pod is reaped, and a
        # zombie worker must not steal steps past its own barrier
        # checkpoint). Grow barriers don't hold.
        if request.startswith(("defrag-", "risk-")):
            self._migration_acked = True
        hold = self._migration_acked
        if hold:
            actions["held"] = request
        status = consts.JOB_PROGRESS_RUNNING
        if not hold and not trainer.done and not self._errored:
            try:
                actions["steps"] = trainer.run(self.steps_per_sync)
            except TrainerError as e:
                log.warning("trainer for %s failed: %s", self.job_name, e)
                self._errored = True
                status = consts.JOB_PROGRESS_FAILED
                data[consts.JOB_PROGRESS_ERROR] = str(e)
        if trainer.done:
            status = consts.JOB_PROGRESS_COMPLETE
        data.update({
            consts.JOB_PROGRESS_STEP: str(trainer.step),
            consts.JOB_PROGRESS_EPOCH: str(trainer.checkpoint_epoch),
            consts.JOB_PROGRESS_CHECKPOINT_STEP: str(trainer.checkpoint_step),
            consts.JOB_PROGRESS_WORLD: str(trainer.hosts),
            consts.JOB_PROGRESS_STATUS: status,
        })
        publish_configmap(self.client, self.progress_name, self.namespace, data)
        actions["status"] = status
        actions["step"] = trainer.step
        return actions

    def clear_error(self) -> None:
        """Re-arm after the controller restarts the job (the real gang
        analog: fresh worker pods replace the crashed ones)."""
        self._errored = False

    def close(self) -> None:
        """Stop the trainer's world (its rank pool)."""
        if self.trainer is not None:
            self.trainer.close()
