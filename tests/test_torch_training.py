"""The port's elastic trainer (``tpu_operator_torch/workloads/training.py``)
against the JAX package's ``workloads/training.py`` on the CPU: the same
continuity verdicts and worlds, the same losses from the same params and
batch, stores that cross between the two trainers, and the reference's
trainer cases on a world of 4 gloo ranks (``cpu_ranks=4``, where the
reference runs on the conftest's 8 virtual devices).

The port's trainer is held at 1e-5 relative in f32 and 2e-2 in bf16 (the
reference's bf16 train-step bar); ``verify_continuity`` holds a
re-executed step to its first execution at 1e-3.
"""

import dataclasses

import numpy as np
import pytest

from tpu_operator.workloads import training as ref
from tpu_operator.workloads.checkpoint import CheckpointStore as RefStore
from tpu_operator_torch.workloads import training as port
from tpu_operator_torch.workloads.burnin import BurninConfig
from tpu_operator_torch.workloads.checkpoint import CheckpointStore

F32, BF16 = 1e-5, 2e-2
TOTAL = 12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _losses(trainer):
    return [h["loss"] for h in trainer.history]


def _reference_state(overrides):
    """The reference's initial params and batch for a config, as numpy."""
    import jax

    from tpu_operator.workloads.burnin import build_train_step, make_mesh

    _, params, batch = build_train_step(make_mesh(jax.devices()[:1]),
                                        ref.trainer_config(overrides))
    return ({k: np.asarray(v) for k, v in jax.device_get(params).items()},
            tuple(np.asarray(a, dtype=np.float32) for a in batch))


def _reference_run(tmp_path, overrides, steps=TOTAL, name="ref"):
    trainer = ref.ResumableTrainer(RefStore(str(tmp_path / name)), ref.trainer_config(overrides),
                                   total_steps=TOTAL, checkpoint_every=4)
    trainer.resume(hosts=1)
    trainer.run(steps)
    return trainer


@pytest.fixture(scope="module")
def f32_reference(tmp_path_factory):
    """The reference trainer's 12 f32 losses at world 1, with its state."""
    overrides = {"dtype": "float32"}
    trainer = _reference_run(tmp_path_factory.mktemp("f32"), overrides)
    return _losses(trainer), _reference_state(overrides)


# ----------------------------------------------------------- pure functions


VIOLATION_CASES = {
    "unanchored rewind": ([1, 2, 3, 2, 3, 4], [1.0] * 6, [3], 4),
    "forward gap": ([1, 2, 4], [1.0] * 3, [], 4),
    "loss discontinuity": ([1, 2, 2], [1.0, 0.9, 5.0], [1], 2),
    "never finished": ([1, 2, 3], [1.0] * 3, [2], 5),
    "clean rewind": ([1, 2, 3, 4, 5, 5, 6], [1.0, 0.9, 0.8, 0.7, 0.6, 0.6, 0.5], [4], 6),
}


@pytest.mark.parametrize("case", sorted(VIOLATION_CASES))
def test_verify_continuity_matches_reference_on_its_cases(case):
    steps, losses, ckpts, total = VIOLATION_CASES[case]
    history = [{"step": s, "loss": l, "world": 2} for s, l in zip(steps, losses)]
    checkpoints = [{"epoch": i + 1, "step": s} for i, s in enumerate(ckpts)]
    want = ref.verify_continuity(history, checkpoints, total)
    assert port.verify_continuity(history, checkpoints, total) == want
    assert want["ok"] == (case == "clean rewind")


@pytest.mark.parametrize("seed", range(8))
def test_verify_continuity_matches_reference_on_random_histories(seed):
    rng = np.random.default_rng(seed)
    history, checkpoints, step = [], [], 0
    for _ in range(int(rng.integers(5, 40))):
        step = max(1, step + int(rng.choice([1, 1, 1, 2, -1, -3])))
        history.append({"step": step, "loss": float(1.0 + rng.normal() * 1e-3),
                        "world": int(rng.integers(1, 5))})
        if rng.random() < 0.3:
            checkpoints.append({"epoch": len(checkpoints) + 1, "step": step})
    total = int(rng.integers(0, step + 3))
    assert port.verify_continuity(history, checkpoints, total) == \
        ref.verify_continuity(history, checkpoints, total)


def test_derive_world_matches_reference():
    import jax

    assert len(jax.devices()) == 8  # the conftest's virtual devices
    for hosts in range(10):
        for batch in (1, 2, 8, 16):
            assert port.derive_world(hosts, batch, ranks=8) == ref.derive_world(hosts, batch)


def test_config_fields_and_defaults_match_reference():
    from tpu_operator.workloads.burnin import BurninConfig as RefConfig

    assert [f.name for f in dataclasses.fields(BurninConfig)] == \
        [f.name for f in dataclasses.fields(RefConfig)]
    for overrides in (None, {}, {"d_model": 64, "use_flash_attention": True, "bogus": 1}):
        assert dataclasses.asdict(port.trainer_config(overrides)) == \
            dataclasses.asdict(ref.trainer_config(overrides))


@pytest.mark.parametrize("overrides,world,want", [
    ({}, 1, (1, 1)), ({}, 2, (1, 2)), ({}, 4, (2, 2)), ({}, 8, (4, 2)),
    ({"n_heads": 4}, 8, (2, 4)), ({"kv_heads": 1}, 4, (4, 1)), ({"d_ff": 66}, 4, (2, 2)),
    ({"d_ff": 65}, 4, (4, 1)),
])
def test_mesh_shape_keeps_the_heads_divisible(overrides, world, want):
    """The reference's mesh takes model up to 4 wherever it divides the
    world; the port also needs it to divide the heads, the kv heads and
    d_ff (the default has n_heads=2)."""
    assert port.mesh_shape(port.trainer_config(overrides), world) == want


# ----------------------------------------------------- losses and stores


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_match_reference_trainer(tmp_path, dtype, f32_reference):
    overrides = {"dtype": dtype}
    if dtype == "float32":
        want, (params, batch) = f32_reference
    else:
        want = _losses(_reference_run(tmp_path, overrides))
        params, batch = _reference_state(overrides)
    trainer = port.ResumableTrainer(CheckpointStore(str(tmp_path / "port")),
                                    port.trainer_config(overrides), total_steps=TOTAL,
                                    checkpoint_every=4, device="cpu", params=params, batch=batch)
    trainer.resume(hosts=1)
    assert trainer.run(TOTAL) == TOTAL and trainer.done
    assert [c["step"] for c in trainer.checkpoints] == [4, 8, 12]
    assert _rel(_losses(trainer), want) <= (F32 if dtype == "float32" else BF16)


def test_port_resumes_a_store_the_reference_wrote(tmp_path, f32_reference):
    """The JAX trainer checkpoints at 8; the port resumes there and steps
    9-12 give the JAX trainer's losses."""
    want, (_, batch) = f32_reference
    overrides = {"dtype": "float32"}
    _reference_run(tmp_path, overrides, steps=8, name="shared")
    trainer = port.ResumableTrainer(CheckpointStore(str(tmp_path / "shared")),
                                    port.trainer_config(overrides), total_steps=TOTAL,
                                    checkpoint_every=4, device="cpu", batch=batch)
    info = trainer.resume(hosts=1)
    assert (info.step, info.epoch) == (8, 2)
    trainer.run(TOTAL)
    assert [h["step"] for h in trainer.history] == [9, 10, 11, 12]
    assert _rel(_losses(trainer), want[8:]) <= F32


def test_reference_resumes_a_store_the_port_wrote(tmp_path, f32_reference):
    """The reverse: the port checkpoints at 8 and the JAX trainer resumes
    there from exactly the port's arrays."""
    want, (params, batch) = f32_reference
    overrides = {"dtype": "float32"}
    store = CheckpointStore(str(tmp_path / "shared"))
    trainer = port.ResumableTrainer(store, port.trainer_config(overrides), total_steps=TOTAL,
                                    checkpoint_every=4, device="cpu", params=params, batch=batch)
    trainer.resume(hosts=1)
    trainer.run(8)
    resumed = ref.ResumableTrainer(RefStore(store.directory), ref.trainer_config(overrides),
                                   total_steps=TOTAL, checkpoint_every=4)
    assert resumed.resume(hosts=1).step == 8
    import jax

    restored = jax.device_get(resumed._params)
    saved = store.latest_good().arrays
    for k, v in saved.items():
        assert np.asarray(restored[k]).tobytes() == v.tobytes()
    resumed.run(TOTAL)
    assert _rel(_losses(resumed), want[8:]) <= F32


# --------------------------------------- the reference's trainer cases, 4 ranks


def _trainer(tmp_path, name, **kw):
    kw.setdefault("cfg", port.trainer_config())
    return port.ResumableTrainer(CheckpointStore(str(tmp_path / name)), device="cpu",
                                 cpu_ranks=4, **kw)


def test_checkpoint_resume_same_curve_across_worlds(tmp_path):
    trainer = _trainer(tmp_path, "a", total_steps=12, checkpoint_every=4)
    resumed = _trainer(tmp_path, "a", total_steps=12, checkpoint_every=4)
    try:
        assert trainer.resume(hosts=4).world == 4
        trainer.run(8)
        assert trainer.checkpoint_step == 8
        losses_first = {h["step"]: h["loss"] for h in trainer.history}
        trainer.close()
        info = resumed.resume(hosts=2)
        assert info.step == 8 and info.epoch == 2 and info.world <= 2
        resumed.run(10)
        assert resumed.done
        for h in resumed.history:
            if h["step"] in losses_first:
                assert h["loss"] == pytest.approx(losses_first[h["step"]], rel=1e-3, abs=1e-5)
    finally:
        trainer.close()
        resumed.close()


def test_resume_after_lost_steps_rewinds_to_checkpoint(tmp_path):
    trainer = _trainer(tmp_path, "b", total_steps=10, checkpoint_every=4)
    try:
        trainer.resume(hosts=4)
        trainer.run(6)
        trainer.resume(hosts=2)
        assert trainer.step == 4
        trainer.run(10)
        assert trainer.done
    finally:
        trainer.close()
    report = port.verify_continuity(trainer.history, trainer.checkpoints, 10)
    assert report["ok"], report
    assert report["rewinds"] == 1
    assert report["max_lost_steps"] == 2


def test_verify_continuity_flags_violations():
    bad = [{"step": s, "loss": 1.0, "world": 2} for s in (1, 2, 3, 2, 3, 4)]
    assert not port.verify_continuity(bad, [{"epoch": 1, "step": 3}], 4)["ok"]
    gap = [{"step": s, "loss": 1.0, "world": 2} for s in (1, 2, 4)]
    assert not port.verify_continuity(gap, [], 4)["ok"]
    wobble = [
        {"step": 1, "loss": 1.0, "world": 2},
        {"step": 2, "loss": 0.9, "world": 2},
        {"step": 2, "loss": 5.0, "world": 1},
    ]
    assert not port.verify_continuity(wobble, [{"epoch": 1, "step": 1}], 2)["ok"]


def test_injected_fault_raises_once(tmp_path):
    trainer = _trainer(tmp_path, "c", total_steps=6, checkpoint_every=2, fail_at_steps=(3,))
    try:
        trainer.resume(hosts=2)
        with pytest.raises(port.TrainerError):
            trainer.run(6)
        assert trainer.step == 2
        trainer.resume(hosts=2)
        trainer.run(10)
        assert trainer.done
    finally:
        trainer.close()


def test_shrink_4_2_1_keeps_the_reference_curve(tmp_path, f32_reference):
    """From the reference's f32 params and batch: 4 ranks, then a shrink
    to 2 and to 1, each losing the steps past the last checkpoint. Every
    executed step, first run or re-run, gives the reference trainer's
    world-1 loss."""
    want, (params, batch) = f32_reference
    trainer = _trainer(tmp_path, "d", cfg=port.trainer_config({"dtype": "float32"}),
                       total_steps=TOTAL, checkpoint_every=4, params=params, batch=batch)
    try:
        assert trainer.resume(hosts=8).world == 4
        trainer.run(6)
        assert trainer.resume(hosts=2).step == 4
        trainer.run(5)
        assert trainer.resume(hosts=1).step == 8
        trainer.run(TOTAL)
    finally:
        trainer.close()
    assert [r.world for r in trainer.resumes] == [4, 2, 1]
    assert sorted(trainer.step_times) == [1, 2, 4]
    report = port.verify_continuity(trainer.history, trainer.checkpoints, TOTAL)
    assert report["ok"] and report["rewinds"] == 2 and report["max_lost_steps"] == 2, report
    assert _rel(_losses(trainer), [want[h["step"] - 1] for h in trainer.history]) <= F32


def test_run_and_checkpoint_need_a_resume(tmp_path):
    trainer = port.ResumableTrainer(CheckpointStore(str(tmp_path / "e")), device="cpu")
    with pytest.raises(RuntimeError, match="resume"):
        trainer.run(1)
    with pytest.raises(RuntimeError, match="resume"):
        trainer.checkpoint()
    trainer.resume(1)
    trainer.close()
    assert not trainer.ready
    with pytest.raises(RuntimeError, match="resume"):
        trainer.run(1)


def test_non_finite_loss_is_a_trainer_error(tmp_path):
    """A step whose loss is not finite raises at that step and does not
    count it."""
    trainer = port.ResumableTrainer(CheckpointStore(str(tmp_path / "f")),
                                    port.trainer_config({"learning_rate": 1e30}),
                                    total_steps=6, checkpoint_every=10, device="cpu")
    trainer.resume(1)
    with pytest.raises(port.TrainerError, match="non-finite loss at step"):
        trainer.run(6)
    assert 1 <= trainer.step < 6
    assert len(trainer.history) == trainer.step
