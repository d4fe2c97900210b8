"""Burn-in forward of the port (tpu_operator_torch.workloads.burnin and
entry) against the JAX package: the reference's own weights (JAX
init_params -> numpy -> weights.py) and the same numpy input go through
both forwards on the CPU. Errors are relative to max |out|: the output is
RMS-normalised, so its scale is O(1) and one bf16 rounding step of the
largest value is ~0.4% of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from tpu_operator.workloads import burnin as jb
from tpu_operator_torch import entry as tentry
from tpu_operator_torch.weights import burnin_params
from tpu_operator_torch.workloads import burnin as tb

F32_TOL = 1e-4
BF16_TOL = 2e-2
SMALL = dict(d_model=64, n_heads=4, d_ff=128, batch=2, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny; torch's default of one thread per core would
    crowd the wall-clock-sensitive tests running beside this file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_err(want, got) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape and np.all(np.isfinite(got))
    return float(np.max(np.abs(want - got)) / np.max(np.abs(want)))


def _pair(seq_len, dtype, **over):
    kw = dict(SMALL, seq_len=seq_len, dtype=dtype, **over)
    jcfg, tcfg = jb.BurninConfig(**kw), tb.BurninConfig(**kw)
    jparams = jb.init_params(jax.random.PRNGKey(0), jcfg)
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    x = np.random.default_rng(seq_len).standard_normal(
        (kw["batch"], seq_len, kw["d_model"])).astype(np.float32)
    want = jax.jit(lambda p, a: jb.forward(p, a, jcfg))(jparams, jnp.asarray(x, jcfg.jdtype))
    got = tb.forward(burnin_params(arrays, tcfg, "cpu"), torch.from_numpy(x).to(tcfg.tdtype), tcfg)
    return want, got


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_forward_matches_reference(flash, dtype, tol):
    want, got = _pair(64, dtype, use_flash_attention=flash)
    assert got.dtype == tb._DTYPES[dtype]
    assert _rel_err(want, got) <= tol


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_grouped_query_attention(flash):
    want, got = _pair(32, "float32", kv_heads=2, use_flash_attention=flash)
    assert _rel_err(want, got) <= F32_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_packed_segments_on_the_flash_path(dtype, tol):
    want, got = _pair(64, dtype, use_flash_attention=True, packed_segments=2)
    assert _rel_err(want, got) <= tol
    _, unpacked = _pair(64, dtype, use_flash_attention=True)
    assert not torch.allclose(got.float(), unpacked.float())  # the mask really changed


def test_packed_ids_match_reference():
    for s, packed in ((32, 2), (64, 3), (128, 4)):
        want = np.asarray(jb._packed_ids(2, s, packed))
        assert tb._packed_ids(2, s, packed, "cpu").numpy().tolist() == want.tolist()


def test_loss_matches_reference():
    cfg_kw = dict(SMALL, seq_len=32, dtype="float32")
    jcfg, tcfg = jb.BurninConfig(**cfg_kw), tb.BurninConfig(**cfg_kw)
    jparams = jb.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    x, target = (rng.standard_normal((2, 32, 64)).astype(np.float32) for _ in range(2))
    want = float(jb.loss_fn(jparams, (jnp.asarray(x), jnp.asarray(target)), jcfg))
    params = burnin_params({k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")
    got = float(tb.loss_fn(params, (torch.from_numpy(x), torch.from_numpy(target)), tcfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_init_params_follows_reference_shapes_and_scales():
    cfg = tb.BurninConfig(**SMALL, kv_heads=2)
    params = tb.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ref = jb.init_params(jax.random.PRNGKey(0), jb.BurninConfig(**SMALL, kv_heads=2))
    assert set(params) == set(ref)
    for name, value in params.items():
        assert tuple(value.shape) == ref[name].shape and value.dtype == torch.float32
        assert abs(float(value.std()) - float(np.std(np.asarray(ref[name])))) < 0.05 * (
            float(np.std(np.asarray(ref[name]))) + 1e-3)


def test_unported_paths_raise():
    """The ring and the experts, once refused when the config was built,
    now construct; without a mesh the one-device step refuses the ring
    with the reference's words for a mesh that has no 'sp' axis."""
    assert tb.BurninConfig(sequence_parallel=True).sequence_parallel
    assert tb.BurninConfig(moe_experts=4).moe_experts == 4
    kw = dict(SMALL, seq_len=32, sequence_parallel=True)
    with pytest.raises(ValueError) as want:
        jb.build_train_step(jb.make_mesh(jax.devices("cpu")[:1]), jb.BurninConfig(**kw))
    with pytest.raises(ValueError) as got:
        tb.build_train_step(tb.BurninConfig(**kw), "cpu")
    assert str(got.value) == str(want.value) and "'sp'" in str(got.value)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_entry_matches_reference_entry(flash):
    """entry() at the flagship's real widths (bf16, d 256, seq 128, batch
    8, 2 layers) on the reference's weights and input."""
    jfn, (jparams, jx) = __graft_entry__.entry()
    want = jax.jit(jfn)(jparams, jx)
    fn, (params, x) = tentry.entry(
        device="cpu", params={k: np.asarray(v) for k, v in jparams.items()},
        use_flash_attention=flash,
    )
    assert x.shape == jx.shape and x.dtype == torch.bfloat16
    got = fn(params, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16))
    assert _rel_err(want, got) <= BF16_TOL


def test_weights_reject_a_mismatched_dict():
    cfg = tb.BurninConfig(**SMALL)
    arrays = {k: np.asarray(v) for k, v in jb.init_params(jax.random.PRNGKey(0), jb.BurninConfig(**SMALL)).items()}
    with pytest.raises(ValueError):
        burnin_params({k: v for k, v in arrays.items() if k != "out_norm"}, cfg, "cpu")
    with pytest.raises(ValueError):
        burnin_params(arrays, tb.BurninConfig(**dict(SMALL, d_ff=64)), "cpu")
