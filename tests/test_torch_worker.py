"""The port's job and serving data planes against the JAX package's
control plane on the CPU: ``InProcessJobRunner``
(``tpu_operator_torch/workloads/training.py``) and ``JobWorkerMain``
(``tpu_operator_torch/dataplane/worker.py``) driven by the reference's job
and placement reconcilers over its ``FakeClient``, beside the reference's
own runner; the chaos acceptance at seed 7; a job and a serving drill in
pod mode under the sim's ``PodKubelet`` with the port's registry; port
``ServingWorkerMain`` replicas behind the reference's ``KVAwareRouter``,
aggregated and disaggregated, against the reference engine's greedy
tokens; and the copied constants and rendezvous predicate.
"""

import functools
import tempfile

import pytest

import tests.test_job as ref_job
from tpu_operator import consts as ref_consts
from tpu_operator.api import tpujob, tpuslice
from tpu_operator.controllers.job_controller import JobReconciler
from tpu_operator.controllers.placement_controller import QUEUE_REQUEST, PlacementReconciler
from tpu_operator.dataplane import pods as ref_pods
from tpu_operator.dataplane import worker as ref_worker
from tpu_operator.dataplane.router import KVAwareRouter
from tpu_operator.kube.controller import Request
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.sim import GangFaultSchedule
from tpu_operator.placement import engine as ref_engine
from tpu_operator.workloads import serving as ref_serving
from tpu_operator.workloads import training as ref_training
from tpu_operator.workloads.checkpoint import CheckpointStore as RefStore
from tpu_operator_torch import consts
from tpu_operator_torch.dataplane import pods, worker
from tpu_operator_torch.workloads import serving, training
from tpu_operator_torch.workloads.checkpoint import CheckpointStore

NS = ref_job.NS


def _runner(kind, client, store_dir, **kw):
    if kind == "reference":
        return ref_training.InProcessJobRunner(client, NS, "job1", RefStore(store_dir), **kw)
    return training.InProcessJobRunner(client, NS, "job1", CheckpointStore(store_dir),
                                       device="cpu", **kw)


def _placed(job=None):
    client = ref_job.torus_cluster()
    client.create(job or ref_job.make_job())
    JobReconciler(client, NS).reconcile(Request(name="job1"))
    PlacementReconciler(client, NS).reconcile(QUEUE_REQUEST)
    return client


def _progress(client):
    cm = client.get_or_none("v1", "ConfigMap", "job1" + consts.JOB_PROGRESS_SUFFIX, NS)
    return dict((cm or {}).get("data") or {})


def _comparable(actions):
    """A beat's actions without what differs by design: resume latency,
    and the world (the reference counts 8 virtual devices, the port one
    CPU rank)."""
    out = dict(actions)
    for key in ("resumed", "restarted"):
        if key in out:
            out[key] = {k: v for k, v in out[key].items() if k not in ("latency_s", "world")}
    return out


# ------------------------------------------------------------ the runner


def test_paused_until_gang_placed_and_healthy(tmp_path):
    client = ref_job.torus_cluster()
    client.create(ref_job.make_job())
    runner = _runner("port", client, str(tmp_path / "r"))
    assert "paused" in runner.sync()  # no slice yet
    JobReconciler(client, NS).reconcile(Request(name="job1"))
    PlacementReconciler(client, NS).reconcile(QUEUE_REQUEST)
    acts = runner.sync()
    assert acts.get("steps")
    assert acts["resumed"]["hosts"] == 4 and acts["resumed"]["world"] == 1
    client.patch("v1", "Node", "tj-0",
                 {"metadata": {"labels": {ref_consts.TPU_HEALTH_LABEL: "degraded"}}})
    assert "paused" in runner.sync()
    client.patch("v1", "Node", "tj-0",
                 {"metadata": {"labels": {ref_consts.TPU_HEALTH_LABEL: None,
                                          ref_consts.REPAIR_STATE_LABEL: "cordon"}}})
    assert "paused" in runner.sync()


# (beat label, progress keys the controller writes before the beat)
SCRIPT = [
    ("train", {}),
    ("grow barrier", {ref_consts.JOB_CHECKPOINT_REQUEST: "grow-1"}),
    ("fault", {}),  # the runner fails at step 7
    ("errored", {}),
    ("restart", {ref_consts.JOB_RESTART_REQUEST: "restart-1"}),
    ("train after restart", {}),
    ("defrag barrier", {ref_consts.JOB_CHECKPOINT_REQUEST: "defrag-100-1"}),
    ("held", {}),
    ("held after the key clears", {ref_consts.JOB_CHECKPOINT_REQUEST: ""}),
]


def _scripted(kind, tmp_path):
    client = _placed(ref_job.make_job(steps=20, every=4))
    runner = _runner(kind, client, str(tmp_path / kind), steps_per_sync=3, fail_at_steps=(7,))
    beats = []
    for label, keys in SCRIPT:
        if keys:
            ref_job.publish_progress(client, **keys)
        beats.append((label, _comparable(runner.sync()), _progress(client)))
    return beats, runner.trainer


def test_runner_beats_match_reference(tmp_path):
    """The barrier ack, the injected fault and its error status, the
    restart request and ack (a resume to the checkpoint), the defrag
    hold for the rest of the generation: beat for beat the reference
    runner's actions and published progress."""
    got, trainer = _scripted("port", tmp_path)
    want, _ = _scripted("reference", tmp_path)
    assert got == want
    by_label = {label: (acts, data) for label, acts, data in got}
    acts, data = by_label["grow barrier"]
    assert acts["checkpointed"] == 1 and data[consts.JOB_PROGRESS_CHECKPOINT_ACK] == "grow-1"
    assert acts["steps"] == 3  # a grow barrier does not hold
    acts, data = by_label["fault"]
    assert data[consts.JOB_PROGRESS_STATUS] == consts.JOB_PROGRESS_FAILED
    assert "injected failure at step 7" in data[consts.JOB_PROGRESS_ERROR]
    assert "steps" not in by_label["errored"][0]
    acts, data = by_label["restart"]
    assert acts["restarted"]["step"] == 4 and data[consts.JOB_PROGRESS_RESTART_ACK] == "restart-1"
    assert data[consts.JOB_PROGRESS_ERROR] == "" and acts["steps"] == 3
    for label in ("defrag barrier", "held", "held after the key clears"):
        acts, data = by_label[label]
        assert "steps" not in acts and "held" in acts, label
    assert by_label["defrag barrier"][1][consts.JOB_PROGRESS_CHECKPOINT_ACK] == "defrag-100-1"
    report = training.verify_continuity(trainer.history, trainer.checkpoints, 0)
    assert report["ok"] and report["rewinds"] == 1, report


def test_publish_ends_in_a_patch_when_create_loses_the_race():
    """Patch finds no ConfigMap, create finds one (another writer won):
    the keys land by a patch. Errors are matched by class name, so the
    reference's and any client's errors work."""
    from tpu_operator.kube import errors

    client = FakeClient()
    name = "job1" + consts.JOB_PROGRESS_SUFFIX
    calls = []
    real_patch = client.patch

    def patch(*args):
        calls.append("patch")
        if len(calls) == 1:
            client.create({"apiVersion": "v1", "kind": "ConfigMap",
                           "metadata": {"name": name, "namespace": NS}, "data": {"a": "1"}})
            raise errors.NotFound("gone")
        return real_patch(*args)

    client.patch = patch
    training.publish_configmap(client, name, NS, {"b": "2"})
    assert calls == ["patch", "patch"]
    assert client.get("v1", "ConfigMap", name, NS)["data"] == {"a": "1", "b": "2"}

    def forbidden(*args):
        raise errors.Forbidden("no")

    client.patch = forbidden  # any other error reaches the caller
    with pytest.raises(errors.Forbidden):
        training.publish_configmap(client, name, NS, {"c": "3"})


# ------------------------------------------------------ chaos acceptance


def _port_chaos(seed):
    """The reference's chaos drive (tests/test_job.py) with the port's
    runner."""
    client = ref_job.torus_cluster()
    client.create(ref_job.make_job(steps=120, every=5, retry_limit=10, base=0.01, max_s=0.05))
    job_rec = JobReconciler(client, NS)
    place_rec = PlacementReconciler(client, NS)
    runner = training.InProcessJobRunner(
        client, NS, "job1", CheckpointStore(tempfile.mkdtemp(prefix="tpujob-chaos-")),
        steps_per_sync=3, device="cpu")
    schedule = GangFaultSchedule(client, NS, "job1-slice", seed=seed, start_at=3, every=10,
                                 heal_after=4)
    for _ in range(400):
        job_rec.reconcile(Request(name="job1"))
        place_rec.reconcile(QUEUE_REQUEST)
        runner.sync()
        schedule.step()
        if ref_job.job_block(client).get("phase") == tpujob.JobPhase.SUCCEEDED:
            break
    return client, runner, schedule


def _resizes(client):
    return [(r["kind"], r["from"], r["to"]) for r in ref_job.job_block(client)["shrinks"]]


def test_chaos_acceptance_at_seed_7_matches_reference():
    client, runner, schedule = _port_chaos(7)
    block = ref_job.job_block(client)
    assert block["phase"] == tpujob.JobPhase.SUCCEEDED, block
    assert schedule.done()
    assert schedule.fired == set(GangFaultSchedule.FAULT_CLASSES)
    trainer = runner.trainer
    report = training.verify_continuity(trainer.history, trainer.checkpoints, 120)
    assert report["ok"], report
    assert report["max_lost_steps"] <= 5
    resizes = _resizes(client)
    assert any(r[0] == "shrink" for r in resizes) and any(r[0] == "grow" for r in resizes)
    assert resizes[-1][2] == "2x2x1"
    epochs = [c["epoch"] for c in trainer.checkpoints]
    assert epochs == sorted(set(epochs))
    ref_client, ref_runner, ref_schedule = ref_job.TestChaosAcceptance().drive(seed=7)
    assert schedule.log == ref_schedule.log
    assert resizes == _resizes(ref_client)
    assert [h["step"] for h in trainer.history] == [h["step"] for h in ref_runner.trainer.history]


# ------------------------------------------------------------- pod mode


@pytest.fixture()
def port_registry(monkeypatch):
    """The sim kubelet resolves pod mains through the reference's
    registry at call time: point it at the port's, on the CPU, and
    record every main it builds."""
    built = []

    def resolve(kind):
        factory = worker.resolve_pod_main(kind)
        if factory is None:
            return None

        def build(client, namespace, env):
            main = functools.partial(factory, device="cpu")(client, namespace, env)
            built.append(main)
            return main
        return build

    monkeypatch.setattr(ref_worker, "resolve_pod_main", resolve)
    return built


def test_pod_mode_job_succeeds_with_continuity_across_generations(port_registry):
    from drill import assert_job_drill_passed, run_job_drill

    obs = run_job_drill(FakeClient(), NS)
    assert_job_drill_passed(obs)
    assert obs["continuity"]["ok"], obs["continuity"]
    assert obs["generations"] >= 2
    assert port_registry and all(isinstance(m, worker.JobWorkerMain) for m in port_registry)
    chiefs = [m for m in port_registry if m.is_chief and m.trainer is not None]
    assert len(chiefs) == obs["generations"]
    assert all(isinstance(m.trainer, training.ResumableTrainer) for m in chiefs)


def test_chief_gates_training_until_the_gang_checked_in(tmp_path):
    client = _placed()
    env = {consts.WORKER_ENV_JOB_NAME: "job1", consts.WORKER_ENV_WORKER_COUNT: "2",
           consts.WORKER_ENV_GANG_HASH: "g1", consts.WORKER_ENV_CHECKPOINT_DIR: str(tmp_path),
           consts.WORKER_ENV_STEPS_PER_SYNC: "40"}
    chief = worker.JobWorkerMain(client, NS, dict(env, **{consts.WORKER_ENV_WORKER_INDEX: "0"}),
                                 device="cpu")
    member = worker.JobWorkerMain(client, NS, dict(env, **{consts.WORKER_ENV_WORKER_INDEX: "1"}),
                                  device="cpu")
    assert chief.step() is False and chief.trainer is None  # member 1 not in yet
    assert chief.rendezvous["checked_in"] == [0]
    assert member.step() is False and member.trainer is None  # heartbeat only
    assert chief.step() is True  # 40 steps in one beat: the job's all
    assert chief.trainer.done and chief.trainer.step == 40
    assert _progress(client)[consts.JOB_PROGRESS_STATUS] == consts.JOB_PROGRESS_COMPLETE
    assert member.step() is True  # the job is complete
    assert worker.default_checkpoint_dir(NS, "job1") == ref_worker.default_checkpoint_dir(NS, "job1")


def test_registry_resolves_the_job_worker():
    assert worker.resolve_pod_main(consts.POD_MAIN_JOB_WORKER) is worker.JobWorkerMain
    assert worker.resolve_pod_main(ref_consts.POD_MAIN_SERVING_WORKER) is worker.ServingWorkerMain
    assert worker.resolve_pod_main("bogus") is None


# ------------------------------------------------------------- serving


def test_pod_mode_serving_drill_runs_port_replicas(port_registry, monkeypatch):
    """The reference's serving drill (burst to 3 replicas, lull to 1) with
    every replica a port ``ServingWorkerMain``. The drill's TPUServing names
    a generation, so each replica's warm-up goes through the compile cache:
    the first misses and publishes, later ones hit."""
    import drill
    from tpu_operator.api.tpuserving import TPU_SERVING_API_VERSION, TPU_SERVING_KIND

    setup = drill.ServingDrill.setup

    def setup_with_generation(self):
        setup(self)
        self.client.patch(TPU_SERVING_API_VERSION, TPU_SERVING_KIND, self.serving_name,
                          {"spec": {"model": {"generation": "h100-sxm"}}})

    monkeypatch.setattr(drill.ServingDrill, "setup", setup_with_generation)
    obs = drill.run_serving_drill(FakeClient(), NS)
    drill.assert_serving_drill_passed(obs)
    assert len(port_registry) >= 3
    assert all(isinstance(m, worker.ServingWorkerMain) for m in port_registry)
    outcomes = [m.compile_outcome for m in port_registry]
    assert set(outcomes) <= {"miss", "hit"} and outcomes[0] == "miss" and "hit" in outcomes
    assert all(m.generation == "h100-sxm" and m.topology == "2x1x1" for m in port_registry)


ROUTER_CFG = dict(d_model=16, n_heads=2, head_dim=8, d_ff=32, vocab=64, page_tokens=4,
                  max_pages=32, max_batch=4, max_seq=32, prefill_chunk=4)


def _replica(client, name, pool=""):
    env = {consts.WORKER_ENV_SERVING_NAME: "chat", consts.WORKER_ENV_REPLICA_NAME: name,
           consts.WORKER_ENV_POOL: pool}
    return worker.ServingWorkerMain(client, NS, env, cfg=serving.ServingModelConfig(**ROUTER_CFG),
                                    device="cpu")


def _reference_tokens(count):
    engine = ref_serving.DecodeEngine(ref_serving.ServingModelConfig(**ROUTER_CFG), seed=0)
    for r in ref_serving.make_requests(count, seed=11, prompt_len=10, decode_min=3,
                                       decode_max=12, vocab=64):
        engine.submit(r)
    engine.run_until_drained()
    return {r.rid: list(r.output) for r in engine.completed}


@pytest.mark.parametrize("layout", ["aggregated", "disaggregated"])
def test_router_over_port_replicas_gives_the_reference_tokens(layout):
    """The reference's KV router over two port replicas (two aggregated, or
    a prefill-pool and a decode-pool one with the paged-KV hand-off): every
    completed request's greedy tokens equal the reference engine's."""
    client = FakeClient()
    if layout == "aggregated":
        mains = {"chat-decode-0": _replica(client, "chat-replica-0"),
                 "chat-decode-1": _replica(client, "chat-replica-1")}
    else:
        mains = {"chat-prefill-0": _replica(client, "chat-replica-0", consts.SERVING_POOL_PREFILL),
                 "chat-decode-0": _replica(client, "chat-replica-1", consts.SERVING_POOL_DECODE)}
    assert {m.compile_outcome for m in mains.values()} == {"unkeyed"}
    assert [m.engine.prefill_only for m in mains.values()] == \
        ([False, False] if layout == "aggregated" else [True, False])
    router = KVAwareRouter(client, NS, "chat")
    router.sync_workers(mains)
    count = 8
    for r in serving.make_requests(count, seed=11, prompt_len=10, decode_min=3, decode_max=12,
                                   vocab=64):
        router.submit(r)
    for _ in range(400):
        router.tick()
        for main in mains.values():
            assert main.step() is False
        if len(router.completed_requests()) == count:
            break
    got = {r.rid: list(r.output) for r in router.completed_requests()}
    assert got == _reference_tokens(count)
    if layout == "aggregated":
        assert all(n > 0 for n in router.routed.values()) and router.handoff_bytes == 0
    else:
        assert router.handoffs == count and router.handoff_bytes > 0


# ------------------------------------------------------------- copies


def test_copied_constants_equal_the_reference():
    sources = {
        "TPU_JOB_API_VERSION": tpujob.TPU_JOB_API_VERSION, "TPU_JOB_KIND": tpujob.TPU_JOB_KIND,
        "TPU_SLICE_API_VERSION": tpuslice.TPU_SLICE_API_VERSION,
        "TPU_SLICE_KIND": tpuslice.TPU_SLICE_KIND, "TERMINAL_PHASES": tpujob.TERMINAL_PHASES,
    }
    # the device plugin's socket keeps the reference plugin's names
    from tpu_operator.agents import device_plugin_agent as ref_dp

    sources.update({"KUBELET_SOCKET_DIR": ref_dp.KUBELET_SOCKET_DIR,
                    "PLUGIN_SOCKET_NAME": ref_dp.PLUGIN_SOCKET_NAME})
    # the card's own keys have no control-plane counterpart: NVIDIA's and
    # Kubernetes' names
    gfd = {"GFD_PRODUCT_LABEL": "nvidia.com/gpu.product",
           "GFD_COUNT_LABEL": "nvidia.com/gpu.count",
           "GFD_MEMORY_LABEL": "nvidia.com/gpu.memory",
           "GFD_DRIVER_MAJOR_LABEL": "nvidia.com/cuda.driver.major",
           "GFD_DRIVER_MINOR_LABEL": "nvidia.com/cuda.driver.minor",
           "GFD_DRIVER_REV_LABEL": "nvidia.com/cuda.driver.rev"}
    sources.update(gfd, GFD_LABELS=tuple(gfd.values()), GPU_RESOURCE_NAME="nvidia.com/gpu",
                   NFD_PRESENT_LABEL="feature.node.kubernetes.io/pci-10de.present",
                   GKE_GPU_ACCELERATOR_LABEL="cloud.google.com/gke-accelerator",
                   DRIVER_READY_FILE="driver-ready", DRIVER_LIBRARY="libcuda.so.1")
    names = [n for n in vars(consts) if n.isupper()]
    assert len(names) == 87
    for name in names:
        want = sources[name] if name in sources else getattr(ref_consts, name)
        assert getattr(consts, name) == want, name


@pytest.mark.parametrize("labels", [
    {}, {ref_consts.TPU_HEALTH_LABEL: "degraded"}, {ref_consts.TPU_HEALTH_LABEL: "healthy"},
    {ref_consts.TPU_PERF_LABEL: "degraded"}, {ref_consts.REPAIR_STATE_LABEL: "quarantined"},
    {ref_consts.REPAIR_STATE_LABEL: ""}, {"other": "x"},
])
def test_labels_unavailable_equals_the_reference(labels):
    assert training.labels_unavailable(labels) == ref_engine.labels_unavailable(labels)
    node = {"metadata": {"name": "n", "labels": labels}}
    assert training.node_unavailable(node) == ref_engine.node_unavailable(node)


@pytest.mark.parametrize("data,expected,gang", [
    ({}, 0, "g1"), ({}, 2, "g1"),
    ({"rendezvous.0": "g2", "rendezvous.1": "g2", "rendezvous.2": "g1"}, 3, "g2"),
    ({"rendezvous.0": "g2", "rendezvous.1": "g2"}, 2, "g2"),
    ({"rendezvous.0": "", "rendezvous.1": "g1", "step": "4"}, 2, "g1"), (None, 1, ""),
])
def test_rendezvous_state_equals_the_reference(data, expected, gang):
    assert pods.rendezvous_state(data, expected, gang) == \
        ref_pods.rendezvous_state(data, expected, gang)
