"""The port's checkpoint store (``tpu_operator_torch/workloads/checkpoint.py``)
against the JAX package's: each reads the other's store byte for byte,
and the reference's store cases run against both classes."""

import io
import os
import threading

import numpy as np
import pytest

from tpu_operator.workloads import checkpoint as ref_checkpoint
from tpu_operator_torch.workloads import checkpoint as port_checkpoint

MODULES = {"reference": ref_checkpoint, "port": port_checkpoint}


@pytest.fixture(params=sorted(MODULES))
def module(request):
    return MODULES[request.param]


def _store(module, tmp_path):
    return module.CheckpointStore(str(tmp_path / "ckpt"))


def _params(seed):
    """A burn-in-like dict of float32 arrays."""
    rng = np.random.default_rng(seed)
    return {"l0/qkv": rng.standard_normal((32, 96)).astype(np.float32),
            "l0/ln_scale": np.ones(32, np.float32),
            "out_norm": rng.standard_normal(32).astype(np.float32)}


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_each_package_reads_the_others_store(tmp_path, writer, reader):
    first, second = _params(0), _params(1)
    w = _store(MODULES[writer], tmp_path)
    assert w.save(4, first, meta={"world": 2, "loss": 1.5}) == 1
    assert w.save(8, second) == 2
    r = _store(MODULES[reader], tmp_path)
    assert r.manifest() == w.manifest()
    ckpt = r.latest_good()
    assert (ckpt.epoch, ckpt.step) == (2, 8)
    older = r.load(1)
    assert older.meta == {"world": 2, "loss": 1.5}
    for got, want in ((ckpt.arrays, second), (older.arrays, first)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes()
    # the reader appends the next epoch to the writer's manifest
    assert r.save(12, first) == 3
    assert w.latest_good().step == 12


def test_roundtrip_and_epoch_monotonicity(module, tmp_path):
    store = _store(module, tmp_path)
    a = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(3)}
    assert store.save(10, a) == 1
    assert store.save(20, {"w": a["w"] * 2, "b": a["b"]}) == 2
    ckpt = store.latest_good()
    assert ckpt.epoch == 2 and ckpt.step == 20
    np.testing.assert_array_equal(ckpt.arrays["w"], a["w"] * 2)
    older = store.load(1)
    assert older.step == 10
    np.testing.assert_array_equal(older.arrays["w"], a["w"])


def test_empty_store(module, tmp_path):
    assert _store(module, tmp_path).latest_good() is None


def test_torn_blob_falls_back_to_last_good_epoch(module, tmp_path):
    store = _store(module, tmp_path)
    store.save(10, {"w": np.ones(4)})
    store.save(20, {"w": np.full(4, 2.0)})
    newest = store.manifest()[-1]["file"]
    path = os.path.join(store.directory, newest)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    ckpt = store.latest_good()
    assert ckpt.epoch == 1 and ckpt.step == 10
    np.testing.assert_array_equal(ckpt.arrays["w"], np.ones(4))


def test_corrupt_blob_with_valid_size_falls_back(module, tmp_path):
    store = _store(module, tmp_path)
    store.save(5, {"w": np.ones(2)})
    store.save(9, {"w": np.zeros(2)})
    path = os.path.join(store.directory, store.manifest()[-1]["file"])
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert store.latest_good().step == 5


def test_vanished_blob_falls_back(module, tmp_path):
    store = _store(module, tmp_path)
    store.save(1, {"w": np.ones(1)})
    store.save(2, {"w": np.ones(1)})
    os.unlink(os.path.join(store.directory, store.manifest()[-1]["file"]))
    assert store.latest_good().epoch == 1


def test_unreadable_manifest_reads_as_empty_store(module, tmp_path):
    store = _store(module, tmp_path)
    store.save(10, {"w": np.ones(1)})
    with open(os.path.join(store.directory, module.MANIFEST_NAME), "w") as f:
        f.write('{"epochs": [{"epo')
    assert store.manifest() == []
    assert store.latest_good() is None
    assert store.save(11, {"w": np.ones(1)}) == 1


def test_orphan_blob_is_invisible_and_replaced(module, tmp_path):
    """A blob published before a crash kept the manifest from naming it:
    the previous epoch stays latest-good, and the next save reuses the
    orphan's epoch cleanly."""
    store = _store(module, tmp_path)
    store.save(10, {"w": np.ones(2)})
    buf = io.BytesIO()
    np.savez(buf, w=np.full(2, 9.0))
    with open(os.path.join(store.directory, store._blob_name(2)), "wb") as f:
        f.write(buf.getvalue())
    assert store.latest_good().step == 10
    assert store.save(20, {"w": np.full(2, 3.0)}) == 2
    ckpt = store.latest_good()
    assert ckpt.epoch == 2 and ckpt.step == 20
    np.testing.assert_array_equal(ckpt.arrays["w"], np.full(2, 3.0))


def test_concurrent_writers_never_publish_half_written_manifest(module, tmp_path):
    store = _store(module, tmp_path)
    errors = []

    def writer(i):
        try:
            for j in range(5):
                store.save(i * 100 + j, {"w": np.full(3, float(i))})
                store.manifest()
                assert store.latest_good() is not None
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors
    entries = store.manifest()
    assert [e["epoch"] for e in entries] == list(range(1, 21))
    for entry in entries:
        assert store.load(entry["epoch"]) is not None


def test_prune_keeps_newest(module, tmp_path):
    store = _store(module, tmp_path)
    for i in range(5):
        store.save(i, {"w": np.ones(1)})
    assert store.prune(keep=2) == 3
    assert [e["epoch"] for e in store.manifest()] == [4, 5]
    assert store.latest_good().epoch == 5
    assert not os.path.exists(os.path.join(store.directory, store._blob_name(1)))


def test_idempotent_step_writes_one_epoch(module, tmp_path):
    """The port's trainer checkpoints once per step: a second barrier at
    the same step returns the same epoch and writes nothing, through
    either package's store."""
    from tpu_operator_torch.workloads.training import ResumableTrainer, trainer_config

    store = _store(module, tmp_path)
    trainer = ResumableTrainer(store, trainer_config({"dtype": "float32"}), total_steps=6,
                               checkpoint_every=4, device="cpu")
    trainer.resume(1)
    trainer.run(3)
    epoch = trainer.checkpoint()
    assert trainer.checkpoint() == epoch == 1
    assert [e["step"] for e in store.manifest()] == [3]
    trainer.run(1)  # step 4 is on the cadence
    assert trainer.checkpoint() == 2
    assert [e["step"] for e in store.manifest()] == [3, 4]
