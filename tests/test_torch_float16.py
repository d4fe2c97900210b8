"""float16 in the port against the JAX package on the CPU: a TPUJob config
that asks for ``dtype: float16`` (the reference's ``BurninConfig.jdtype =
jnp.dtype(dtype)``) trains in both, through flash attention.

The same numpy inputs go through the reference's ``flash_attention`` (its
Pallas kernels in interpret mode, as its own tests run them) and the port's
(on the CPU its kernels' plain versions; the fp16 CUDA kernels are held to
those on the card: ``tests/test_torch_float16_kernels.py``, ``chip_smoke.py``
phases 3 and 16). The burn-in steps start from the reference's params and
batch (``weights.py`` carries them across).

Tolerances are the reference's 16-bit bar (``flashattention.py:1351``):
outputs and gradients within 2e-2 of the largest |value|, losses within
2e-2 relative. The two sides round at other places: the reference's
triangle kernels round q·log2(e)/√d to fp16 before q·k, the port keeps that
scale in f32 after the product (``ROADMAP.md``, Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import burnin as jb
from tpu_operator.workloads import flashattention as jfa
from tpu_operator.workloads import training as jtr
from tpu_operator.workloads.checkpoint import CheckpointStore as RefStore
from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import flashattention as tfa
from tpu_operator_torch.workloads import training as ttr
from tpu_operator_torch.workloads.checkpoint import CheckpointStore

TOL = 2e-2
MASKS = {
    # name: (heads, kv heads, flash_attention kwargs, segment cut or None)
    "causal": (2, 2, dict(), None),
    "gqa": (4, 2, dict(), None),
    "segments": (2, 2, dict(), 72),
    "window": (2, 2, dict(window=40), None),
}
HEAD_DIMS = (64, 96, 256)
SMALL = dict(d_model=64, n_heads=2, d_ff=128, seq_len=128, batch=2, n_layers=1,
             dtype="float16")
CONFIGS = {
    "dense": dict(),
    "flash": dict(use_flash_attention=True),
    "packed": dict(use_flash_attention=True, packed_segments=2),
    "moe": dict(use_flash_attention=True, moe_experts=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_flash_attention_output_and_gradients_match_reference(mask, d):
    h, h_kv, kwargs, cut = MASKS[mask]
    s = 128
    q, k, v, w = _arrays(d + h, ((1, s, h, d), (1, s, h_kv, d), (1, s, h_kv, d), (1, s, h, d)))
    seg = None if cut is None else (np.arange(s)[None] >= cut).astype(np.int32)
    kwargs = dict(kwargs, block_q=64, block_k=64)

    def jout(q, k, v):
        return jfa.flash_attention(q, k, v, segment_ids=None if seg is None else jnp.asarray(seg),
                                   **kwargs)

    def jloss(q, k, v):
        return jnp.sum(jout(q, k, v).astype(jnp.float32) * w)

    jargs = [jnp.asarray(a, jnp.float16) for a in (q, k, v)]
    want = [jout(*jargs), *jax.grad(jloss, argnums=(0, 1, 2))(*jargs)]
    leaves = [torch.from_numpy(a).to(torch.float16).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=None if seg is None else torch.from_numpy(seg),
                              **kwargs)
    got = [out, *torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)]
    for name, x, y in zip(("out", "dq", "dk", "dv"), want, got):
        assert y.dtype == torch.float16 and tuple(y.shape) == x.shape, name
        x = np.asarray(jnp.asarray(x, jnp.float32))
        assert np.isfinite(x).all() and torch.isfinite(y).all(), name
        err = float(np.max(np.abs(x - y.detach().float().numpy())))
        assert err <= TOL * float(np.max(np.abs(x))), (name, err)


@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("q_start, sq, sk", [(512, 128, 128), (896, 128, 256), (0, 64, 256)])
def test_with_lse_at_global_offsets_matches_reference(q_start, sq, sk, d):
    """A ring hop, a chunked prefill and a chunk whose rows see a prefix of
    the keys, fp16, GQA 2 -> 1."""
    arrays = _arrays(q_start + sq + d, ((1, sq, 2, d), (1, sk, 1, d), (1, sk, 1, d)))
    kwargs = dict(causal=True, block_q=64, block_k=64, q_start=q_start, k_start=0)
    want = jfa.flash_attention_with_lse(*(jnp.asarray(a, jnp.float16) for a in arrays), **kwargs)
    got = tfa.flash_attention_with_lse(*(torch.from_numpy(a).to(torch.float16) for a in arrays),
                                       **kwargs)
    assert got[0].dtype == torch.float16 and got[1].dtype == torch.float32
    w_out, w_lse = (np.asarray(jnp.asarray(x, jnp.float32)) for x in want)
    assert np.array_equal(np.isneginf(w_lse), np.isneginf(got[1].numpy()))
    assert float(np.max(np.abs(w_out - got[0].float().numpy()))) <= TOL * float(
        np.max(np.abs(w_out)))
    fin = np.isfinite(w_lse)
    assert float(np.max(np.abs(w_lse[fin] - got[1].numpy()[fin]))) <= TOL


def _reference_step(cfg):
    if cfg.moe_experts:  # the reference's price for experts: an 'ep' axis
        mesh = jb.make_mesh_4d(jax.devices("cpu")[:1], data=1, sp=1, model=1, ep=1)
    else:
        mesh = jb.make_mesh(jax.devices("cpu")[:1])
    return jb.build_train_step(mesh, cfg)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_burnin_losses_match_reference(config):
    """3 SGD steps in fp16 from the reference's params and batch, as
    run_burnin takes them; f32 master weights stay f32."""
    kw = dict(SMALL, **CONFIGS[config])
    jstep, jparams, jbatch = _reference_step(jb.BurninConfig(**kw))
    assert jbatch[0].dtype == jnp.float16
    params = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tuple(np.asarray(a.astype(jnp.float32)) for a in jbatch)
    step, tparams, tbatch = tb.build_train_step(tb.BurninConfig(**kw), "cpu", params, batch)
    assert tbatch[0].dtype == torch.float16
    want, got = [], []
    for _ in range(3):
        jparams, loss = jstep(jparams, jbatch)
        want.append(float(loss))
        tparams, loss = step(tparams, tbatch)
        got.append(float(loss))
    assert all(np.isfinite(got)) and got[-1] < got[0]
    rel = max(abs(w - g) / abs(w) for w, g in zip(want, got))
    assert rel <= TOL, (want, got)
    assert all(p.dtype == torch.float32 for p in tparams.values())


def test_run_burnin_trains_in_float16():
    cfg = tb.BurninConfig(**dict(SMALL, use_flash_attention=True, kv_heads=1))
    result = tb.run_burnin(steps=3, cfg=cfg, device="cpu")
    assert result["ok"] and result["losses"][-1] < result["losses"][0]


def test_trainer_config_takes_float16_in_both_packages():
    over = {"dtype": "float16", "use_flash_attention": True}
    jcfg, cfg = jtr.trainer_config(over), ttr.trainer_config(over)
    assert jcfg.jdtype == jnp.float16 and cfg.tdtype == torch.float16
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_resumable_trainer_keeps_continuity_in_float16(tmp_path):
    """A fault at step 5 and a resume from the checkpoint at 3: continuity
    holds, the re-executed step gives its first loss bit for bit, the
    checkpoint keeps f32 params, and the first losses are the reference
    trainer's from the same params and batch."""
    over = {"dtype": "float16", "use_flash_attention": True, "seq_len": 64}
    jtrainer = jtr.ResumableTrainer(RefStore(str(tmp_path / "ref")),
                                    jtr.trainer_config(over), total_steps=3, checkpoint_every=3)
    jtrainer.resume(hosts=1)
    jtrainer.run(3)
    want = [h["loss"] for h in jtrainer.history]
    _, jparams, jbatch = jb.build_train_step(jb.make_mesh(jax.devices("cpu")[:1]),
                                             jtr.trainer_config(over))
    params = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tuple(np.asarray(a, dtype=np.float32) for a in jbatch)
    store = CheckpointStore(str(tmp_path / "port"))
    trainer = ttr.ResumableTrainer(store, ttr.trainer_config(over), total_steps=6,
                                   checkpoint_every=3, fail_at_steps=(5,), device="cpu",
                                   params=params, batch=batch)
    trainer.resume(1)
    with pytest.raises(ttr.TrainerError):
        trainer.run(6)
    trainer.resume(1)
    assert trainer.run(6) == 3 and trainer.done  # steps 4-6 again
    report = ttr.verify_continuity(trainer.history, trainer.checkpoints, 6)
    assert report["ok"] and report["rewinds"] == 1 and report["max_lost_steps"] == 1, report
    first, again = {}, {}
    for h in trainer.history:
        (again if h["step"] in first else first)[h["step"]] = h["loss"]
    assert again == {4: first[4]}
    assert all(a.dtype == np.float32 for a in store.latest_good().arrays.values())
    got = [first[s] for s in (1, 2, 3)]
    assert max(abs(w - g) / abs(w) for w, g in zip(want, got)) <= TOL, (want, got)
