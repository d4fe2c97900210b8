"""Flash attention at head dims above 576 (640, and 700 zero-padded to
704): the port against the JAX package on the same numpy inputs.

The JAX package's ``flash_attention`` and ``flash_attention_with_lse``
take any head dim. Above 576 the port's kernels stream the head dim
(``kernels/flash_wide.cuh``): both forwards and both backward pairs take
every multiple of 64, and other head dims run zero-padded to the next one
with the true head dim's softmax scale (``workloads/flashattention.py``).
The general pair's gradients against the JAX package are in
``tests/test_torch_flash_head_dim_wide_general.py``. On
the CPU the port's wrappers run the kernels' plain versions on the padded
tensors, so these cases hold the padding, the scale passed down, the
slices back and the routing; the CUDA kernels are held to the same plain
versions on the card (``tests/test_torch_flash_wide_plans.py``). The JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do. Toy sizes only: 128 tokens, 2 heads.

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
from tpu_operator_torch.kernels import flash_bwd, flash_fwd
from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import flashattention as tfa
from tpu_operator_torch.workloads import training as ttr

F32_TOL = 1e-4
TOL_16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
HEAD_DIMS = (640, 700)
MASKS = {
    # name: (heads, kv heads, flash_attention kwargs, segment cut or None)
    "triangle": (2, 2, dict(), None),
    "full": (2, 2, dict(causal=False), None),
    "window, segments, gqa": (2, 1, dict(window=40), 72),
}
WRAPPERS = ("flash_fwd_tri", "flash_fwd_rect", "flash_bwd_dq_tri", "flash_bwd_dkv_tri",
            "flash_bwd_dq_rect", "flash_bwd_dkv_rect")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(seed, s, h, h_kv, d):
    """q, k, v and a cotangent weight w, standard normal, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = ((1, s, h, d), (1, s, h_kv, d), (1, s, h_kv, d), (1, s, h, d))
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _inputs(d, mask, s=128):
    h, h_kv, kwargs, cut = MASKS[mask]
    q, k, v, w = _arrays(d, s, h, h_kv, d)
    seg = None if cut is None else (np.arange(s)[None] >= cut).astype(np.int32)
    return (q, k, v, w), seg, dict(kwargs, block_q=64, block_k=64)


def _triangle_both(d, dtype):
    """(reference (out, dq, dk, dv), port's) of the triangle as float32
    numpy arrays."""
    (q, k, v, w), _, kwargs = _inputs(d, "triangle")
    jd, td = DTYPES[dtype]

    @jax.jit
    def out_and_grads(q, k, v):
        # the gradients of sum(out * w): w in out's dtype is the cotangent
        # (one compiled call: the interpret-mode kernels run once each)
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, **kwargs), q, k, v)
        return (out, *vjp(jnp.asarray(w, out.dtype)))

    want = out_and_grads(*(jnp.asarray(a, jd) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, **kwargs)
    got = [out, *torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)]
    assert out.shape == q.shape and all(g.dtype == td for g in got)
    return ([np.asarray(jnp.asarray(x, jnp.float32)) for x in want],
            [x.detach().float().numpy() for x in got])


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_triangle_output_and_gradients_match_reference(d):
    want, got = _triangle_both(d, "float32")
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        assert w.shape == g.shape
        assert float(np.max(np.abs(w - g))) <= F32_TOL, (name, d)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_triangle_output_and_gradients_match_reference(dtype, d):
    want, got = _triangle_both(d, dtype)
    out_err = float(np.max(np.abs(want[0] - got[0])))
    assert out_err <= TOL_16 * float(np.max(np.abs(want[0]))), d
    scale = max(float(np.max(np.abs(w))) for w in want[1:])
    for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
        assert float(np.max(np.abs(w - g))) <= TOL_16 * scale, (name, d)


@pytest.mark.parametrize("mask", ["full", "window, segments, gqa"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_general_forward_matches_reference(dtype, d, mask):
    """The general kernel's masks above 576, the forward without a gradient
    (the gradients: ``test_torch_flash_head_dim_wide_general.py``)."""
    (q, k, v, _), seg, kwargs = _inputs(d, mask)
    jd, td = DTYPES[dtype]
    want = jfa.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                               segment_ids=None if seg is None else jnp.asarray(seg), **kwargs)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = tfa.flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                              segment_ids=None if seg is None else torch.from_numpy(seg),
                              **kwargs)
    assert got.dtype == td and got.shape == want.shape
    bar = F32_TOL if dtype == "float32" else TOL_16 * float(np.max(np.abs(want)))
    assert float(np.max(np.abs(want - got.float().numpy()))) <= bar


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("q_start, sq, sk", [(512, 128, 128), (896, 128, 256), (0, 64, 256)])
def test_with_lse_at_global_offsets_and_sq_ne_sk(d, q_start, sq, sk):
    """flash_attention_with_lse above 576, f32: a ring hop (every key before
    every row), a chunked prefill and a chunk at the start whose rows see a
    prefix of the keys."""
    rng = np.random.default_rng(q_start + sq + d)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((1, sq, 2, d), (1, sk, 1, d), (1, sk, 1, d))]
    kwargs = dict(causal=True, block_q=64, block_k=64, q_start=q_start, k_start=0)
    want = jfa.flash_attention_with_lse(*(jnp.asarray(a) for a in arrays), **kwargs)
    got = tfa.flash_attention_with_lse(*(torch.from_numpy(a) for a in arrays), **kwargs)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape)
        assert np.array_equal(np.isneginf(w), np.isneginf(g.numpy()))
        fin = np.isfinite(w)
        assert float(np.max(np.abs(w[fin] - g.numpy()[fin]))) <= F32_TOL


def test_f32_train_step_at_head_dim_640_matches_reference():
    """Two f32 SGD steps of the TPUJob trainer's config at d_model 1280 and
    2 heads on one kv head (head dim 640), flash attention, from the
    reference's params and batch (``weights.py`` carries them across),
    against the reference's own step."""
    over = {"d_model": 1280, "n_heads": 2, "kv_heads": 1, "d_ff": 256, "n_layers": 1,
            "seq_len": 64, "batch": 2, "dtype": "float32", "use_flash_attention": True}
    jcfg, cfg = jtr.trainer_config(over), ttr.trainer_config(over)
    assert cfg.d_model // cfg.n_heads == 640
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


@pytest.mark.parametrize("d", [577, 641, 700, 1000])
@pytest.mark.parametrize("causal, window, cut", [(True, None, None), (False, None, 50),
                                                 (True, 20, 50)])
def test_padding_to_a_multiple_of_64_then_the_plain_versions_at_the_true_scale_is_exact(
        d, causal, window, cut):
    """The padded route above 576 on the plain versions: zero-padding the
    head to the next multiple of 64 and passing 1/√d gives the unpadded
    forward and backward within 4e-6 (f32: the same sums over more columns
    in another order), and the padded columns of O and of every gradient
    are zero."""
    width = flash_fwd.padded_head_dim(d)
    assert width == -(-d // 64) * 64 and width > 576
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(d + 1, 96, 4, 2, d))
    seg = None if cut is None else (torch.arange(96)[None] >= cut).to(torch.int32)
    qb, kb, vb, h, hk = tfa._collapse_heads(q, k, v)
    pq, pk, pv, _, _ = tfa._collapse_heads(q, k, v, width)
    dout = tfa._collapse_heads(g, g, g)[0]
    pdout = tfa._collapse_heads(g, g, g, width)[0]
    assert pq.shape[-1] == width and torch.equal(pq[..., :d], qb) and not pq[..., d:].any()
    scale = 1.0 / d ** 0.5
    out, lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, causal, window=window, seg=seg)
    pout, plse = flash_fwd.attention_plain(pq, pk, pv, h, hk, causal, window=window, seg=seg,
                                           sm_scale=scale)
    assert float((pout[..., :d] - out).abs().max()) <= 4e-6 and not pout[..., d:].any()
    assert float((plse - lse).abs().max()) <= 4e-6
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, hk, causal, window, seg)
    got = flash_bwd.attention_bwd_plain(pq, pk, pv, pout, plse, pdout, h, hk, causal, window,
                                        seg, sm_scale=scale)
    for w, p in zip(want, got):
        assert float((p[..., :d] - w).abs().max()) <= 4e-6 and not p[..., d:].any()


def _spy_on_wrappers(monkeypatch, names=WRAPPERS):
    """Record (wrapper, head dim it got, sm_scale) for every call of the
    named wrappers through the port's flash attention."""
    seen = []
    for name in names:
        real = getattr(tfa, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, args[0].shape[-1], kw["sm_scale"]))
            return _real(*args, **kw)
        monkeypatch.setattr(tfa, name, spy)
    return seen


@pytest.mark.parametrize("d, width, causal, names", [
    (700, 704, True, ("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri")),
    (640, 640, True, ("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri")),
    (1000, 1024, False, ("flash_fwd_rect",)),
])
def test_every_wrapper_gets_the_padded_columns_and_the_true_scale(monkeypatch, d, width, causal,
                                                                 names):
    """flash_attention above 576 hands every wrapper the padded tensors and
    1/√d (padded) or the kernels' own scale (None, a multiple of 64): the
    triangle forward and backward, and full attention's forward."""
    seen = _spy_on_wrappers(monkeypatch)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(causal) for a in _arrays(3, 64, 2, 2, d))
    out = tfa.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    assert out.shape == (1, 64, 2, d)
    if causal:
        out.sum().backward()
        assert q.grad.shape == q.shape
    assert [(n, w) for n, w, _ in seen] == [(n, width) for n in names]
    if width == d:
        assert all(s is None for _, _, s in seen)
    else:
        assert all(abs(s - d ** -0.5) < 1e-12 for _, _, s in seen)


def _masked_dense(q, k, v, causal, window=None, seg=None):
    """Dense softmax attention (B, S, H, D) under the kernels' masks
    (``keep_mask``), f32: autograd's reference."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    keep = flash_fwd.keep_mask(b * h, s, s, h, causal, window=window, seg=seg)
    scores = scores.masked_fill(~keep.expand(b * h, s, s).reshape(b, h, s, s), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


@pytest.mark.parametrize("d", [577, 640, 1024])
@pytest.mark.parametrize("kwargs", [dict(causal=False), dict(window=16),
                                    dict(segment_ids=(np.arange(64)[None] >= 24).astype(np.int32))],
                         ids=["full", "window", "segments"])
def test_the_general_backward_above_576_raises_before_any_launch(monkeypatch, d, kwargs):
    """A gradient through the general pair above 576 runs: the forward and
    both gradients go through ``flash_fwd_rect``, ``flash_bwd_dq_rect`` and
    ``flash_bwd_dkv_rect`` at the padded width and the true head dim's scale,
    and match autograd through dense attention under the same masks (f32,
    1e-4)."""
    seen = _spy_on_wrappers(monkeypatch)
    arrays = _arrays(5, 64, 2, 2, d)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    w = torch.from_numpy(arrays[3])
    if "segment_ids" in kwargs:
        kwargs = dict(segment_ids=torch.from_numpy(kwargs["segment_ids"]))
    out = tfa.flash_attention(q, k, v, block_q=32, block_k=32, **kwargs)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    width = flash_fwd.padded_head_dim(d)
    scale = None if width == d else 1.0 / d ** 0.5
    assert [(n, wd) for n, wd, _ in seen] == [
        (n, width) for n in ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")]
    assert all(s == scale if scale is None else abs(s - scale) < 1e-12 for _, _, s in seen)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    want = _masked_dense(*leaves, kwargs.get("causal", True), kwargs.get("window"),
                         kwargs.get("segment_ids"))
    wants = torch.autograd.grad((want * w).sum(), leaves)
    assert float((out.detach() - want.detach()).abs().max()) <= F32_TOL
    for name, g, wg in zip(("dq", "dk", "dv"), grads, wants):
        assert g.shape == wg.shape and float((g - wg).abs().max()) <= F32_TOL, name
