"""The general backward pair above head dim 576, at 640:
``flash_attention``'s output and gradients against the JAX package's on
the same numpy inputs, under full attention, a sliding window, segment ids,
and a window with segment ids and grouped-query attention; and an f32
packed train step at head dim 640 against the reference's own step. The
zero-padded route (700 -> 704) is held the same way in
``tests/test_torch_flash_head_dim_wide_general_padded.py``, which shares
this file's helpers (one file would pass a minute on one worker: each case
compiles the reference's three interpret-mode kernels).

The JAX package's ``flash_attention`` takes any head dim and mask. Above
576 the port runs the D-streaming general pair (``kernels/flash_bwd.cu``,
``flash_bwd_{dq,dkv}_rect_wide_kernel``); on the CPU its wrappers run the
plain version on the padded tensors at the true head dim's scale, so these
cases hold the padding, the scale passed down, the routing to the general
pair, the masks and the slices back. The CUDA kernels are held to the same
plain version on the card (``tests/test_torch_flash_wide_plans.py``). The
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do. Toy sizes: 128 tokens, 64-row blocks, 2 heads.

Tolerances: f32 within 1e-4 absolute (the reference's own bar,
tests/test_workloads.py); bf16 and fp16 within 2e-2 of the largest |value|
(the reference's 16-bit bar; both sides round P and dS to the input dtype
before each product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import burnin as jb
from tpu_operator.workloads import flashattention as jfa
from tpu_operator.workloads import training as jtr
from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import flashattention as tfa
from tpu_operator_torch.workloads import training as ttr

F32_TOL = 1e-4
TOL_16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
HEAD_DIM = 640
MASKS = {
    # name: (heads, kv heads, flash_attention kwargs, segment cut or None)
    "full": (2, 2, dict(causal=False), None),
    "window": (2, 2, dict(window=40), None),
    "segments": (2, 2, dict(), 72),
    "window, segments, gqa": (2, 1, dict(window=40), 72),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(d, mask, dtype, s=128):
    """(reference (out, dq, dk, dv), port's) under ``mask`` as float32
    numpy arrays: the gradients of sum(out * w) for a seeded weight w."""
    h, h_kv, kwargs, cut = MASKS[mask]
    rng = np.random.default_rng(d + len(mask))
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((1, s, h, d), (1, s, h_kv, d), (1, s, h_kv, d), (1, s, h, d)))
    seg = None if cut is None else (np.arange(s)[None] >= cut).astype(np.int32)
    kwargs = dict(kwargs, block_q=64, block_k=64)
    jd, td = DTYPES[dtype]

    @jax.jit
    def out_and_grads(q, k, v):
        # one compiled call: the interpret-mode kernels run once each
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, segment_ids=None if seg is None else jnp.asarray(seg), **kwargs), q, k, v)
        return (out, *vjp(jnp.asarray(w, out.dtype)))

    want = out_and_grads(*(jnp.asarray(a, jd) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=None if seg is None else torch.from_numpy(seg),
                              **kwargs)
    got = [out, *torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)]
    assert out.shape == q.shape and all(g.dtype == td for g in got)
    return ([np.asarray(jnp.asarray(x, jnp.float32)) for x in want],
            [x.detach().float().numpy() for x in got])


def check_f32(d, mask):
    """The f32 output and gradients within ``F32_TOL`` of the reference's."""
    want, got = _both(d, mask, "float32")
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        assert w.shape == g.shape
        assert float(np.max(np.abs(w - g))) <= F32_TOL, (name, d, mask)


def check_16bit(d, mask, dtype):
    """The 16-bit output and gradients within ``TOL_16`` of the largest
    |value| of the reference's (the gradients: of dq, dk and dv)."""
    want, got = _both(d, mask, dtype)
    assert float(np.max(np.abs(want[0] - got[0]))) <= TOL_16 * float(np.max(np.abs(want[0])))
    scale = max(float(np.max(np.abs(w))) for w in want[1:])
    for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
        assert float(np.max(np.abs(w - g))) <= TOL_16 * scale, (name, d, mask)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_f32_general_output_and_gradients_match_reference(mask):
    check_f32(HEAD_DIM, mask)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_general_output_and_gradients_match_reference(dtype, mask):
    check_16bit(HEAD_DIM, mask, dtype)


def test_f32_packed_train_step_at_head_dim_640_matches_reference():
    """Two f32 SGD steps of the TPUJob trainer's config at d_model 1280 and
    2 heads on one kv head (head dim 640), two packed documents (segment
    ids: the general pair), flash attention, from the reference's params and
    batch, against the reference's own step."""
    over = {"d_model": 1280, "n_heads": 2, "kv_heads": 1, "d_ff": 256, "n_layers": 1,
            "seq_len": 64, "batch": 2, "dtype": "float32", "use_flash_attention": True,
            "packed_segments": 2}
    jcfg, cfg = jtr.trainer_config(over), ttr.trainer_config(over)
    assert cfg.d_model // cfg.n_heads == 640 and cfg.packed_segments == 2
    jstep, jparams, jbatch = jb.build_train_step(jb.make_mesh(jax.devices("cpu")[:1]), jcfg)
    params = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tuple(np.asarray(a) for a in jbatch)
    step, tparams, tbatch = tb.build_train_step(cfg, "cpu", params, batch)
    for _ in range(2):
        jparams, want = jstep(jparams, jbatch)
        tparams, got = step(tparams, tbatch)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for k in params:
        assert float(np.max(np.abs(np.asarray(jparams[k]) - tparams[k].numpy()))) <= 1e-5, k
