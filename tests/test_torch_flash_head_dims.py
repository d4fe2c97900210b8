"""Flash attention at head dims other than 16, 32, 64 and 128: the port
against the JAX package on the same numpy inputs.

The JAX package's ``flash_attention`` and ``flash_attention_with_lse``
take any head dim. The port's kernels take 16, 32, 64, 128, 256, 512 and
576 natively; any other head dim up to 576 runs zero-padded to the next of
those, with the true head dim's softmax scale (``workloads/
flashattention.py``). This file holds the head dims up to 256;
``tests/test_torch_flash_head_dim_512.py`` holds 512 and the route to it,
``tests/test_torch_flash_head_dim_576.py`` 576 and the route to it. On the
CPU the port's wrappers run the kernels'
plain versions on the padded tensors, so these cases hold the padding,
the scale passed down and the slices back; the CUDA kernels at D 256 are
held to the same plain versions on the card
(``tests/test_torch_flash_head_dim_plans.py``). The JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do.

Tolerances: f32 within 1e-4 absolute (the reference's own bar,
tests/test_workloads.py); bf16 within 2e-2 of the largest |value| (the
reference's bf16 bar; both sides round P and dS to bf16 before each
product, the reference's triangle also q·log2e/√d).
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
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HEAD_DIMS = (256, 112, 96, 80)
MASKS = {
    # name: (heads, kv heads, flash_attention kwargs, segment cut or None)
    "triangle": (2, 2, dict(), None),
    "full": (2, 2, dict(causal=False), None),
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


def _arrays(seed, s, h, h_kv, d):
    """q, k, v and a cotangent weight w, standard normal, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = ((1, s, h, d), (1, s, h_kv, d), (1, s, h_kv, d), (1, s, h, d))
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _both(d, mask, dtype, s=128):
    """(reference (out, dq, dk, dv), port's) as float32 numpy arrays."""
    h, h_kv, kwargs, cut = MASKS[mask]
    q, k, v, w = _arrays(d, s, h, h_kv, d)
    seg = None if cut is None else (np.arange(s)[None] >= cut).astype(np.int32)
    kwargs = dict(kwargs, block_q=64, block_k=64)
    jd, td = DTYPES[dtype]

    def jout(q, k, v):
        return jfa.flash_attention(q, k, v, segment_ids=None if seg is None else jnp.asarray(seg),
                                   **kwargs)

    def jloss(q, k, v):
        return jnp.sum(jout(q, k, v).astype(jnp.float32) * w)

    jargs = [jnp.asarray(a, jd) for a in (q, k, v)]
    want = [jout(*jargs), *jax.grad(jloss, argnums=(0, 1, 2))(*jargs)]
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=None if seg is None else torch.from_numpy(seg),
                              **kwargs)
    got = [out, *torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)]
    assert out.shape == q.shape and all(g.dtype == td for g in got)
    return ([np.asarray(jnp.asarray(x, jnp.float32)) for x in want],
            [x.detach().float().numpy() for x in got])


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_output_and_gradients_match_reference(d, mask):
    want, got = _both(d, mask, "float32")
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        assert w.shape == g.shape
        assert float(np.max(np.abs(w - g))) <= F32_TOL, (name, d, mask)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_output_and_gradients_match_reference(d, mask):
    want, got = _both(d, mask, "bfloat16")
    out_err = float(np.max(np.abs(want[0] - got[0])))
    assert out_err <= BF16_TOL * float(np.max(np.abs(want[0]))), (d, mask)
    scale = max(float(np.max(np.abs(w))) for w in want[1:])
    for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
        assert float(np.max(np.abs(w - g))) <= BF16_TOL * scale, (name, d, mask)


@pytest.mark.parametrize("q_start, sq, sk", [(512, 128, 128), (896, 128, 256), (0, 64, 256)])
def test_with_lse_at_global_offsets_and_sq_ne_sk(q_start, sq, sk):
    """flash_attention_with_lse at D 256, f32: a ring hop (every key before
    every row), a chunked prefill and a chunk at the start whose rows see a
    prefix of the keys."""
    rng = np.random.default_rng(q_start + sq)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((1, sq, 2, 256), (1, sk, 1, 256), (1, sk, 1, 256))]
    kwargs = dict(causal=True, block_q=64, block_k=64, q_start=q_start, k_start=0)
    want = jfa.flash_attention_with_lse(*(jnp.asarray(a) for a in arrays), **kwargs)
    got = tfa.flash_attention_with_lse(*(torch.from_numpy(a) for a in arrays), **kwargs)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape)
        assert np.array_equal(np.isneginf(w), np.isneginf(g.numpy()))
        fin = np.isfinite(w)
        assert float(np.max(np.abs(w[fin] - g.numpy()[fin]))) <= F32_TOL


def test_f32_train_step_at_head_dim_256_matches_reference():
    """Two f32 SGD steps of the TPUJob trainer's config at d_model 512 and
    2 heads (head dim 256), flash attention, from the reference's params and
    batch, against the reference's own step."""
    over = {"d_model": 512, "n_heads": 2, "n_layers": 1, "seq_len": 64, "batch": 2,
            "dtype": "float32", "use_flash_attention": True}
    jcfg, cfg = jtr.trainer_config(over), ttr.trainer_config(over)
    assert cfg.d_model // cfg.n_heads == 256
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


@pytest.mark.parametrize("d", HEAD_DIMS[1:])
@pytest.mark.parametrize("causal, window, cut", [(True, None, None), (False, None, 50),
                                                 (True, 20, 50)])
def test_padding_then_the_plain_versions_at_the_true_scale_is_exact(d, causal, window, cut):
    """The padded route on the plain versions: zero-padding the head to
    padded_head_dim(d) and passing 1/√d gives the unpadded forward and
    backward within 1e-6 (f32), and the padded columns of O and of every
    gradient are zero."""
    width = flash_fwd.padded_head_dim(d)
    assert width == 128
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
    assert float((pout[..., :d] - out).abs().max()) <= 1e-6 and not pout[..., d:].any()
    assert float((plse - lse).abs().max()) <= 1e-6
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, hk, causal, window, seg)
    got = flash_bwd.attention_bwd_plain(pq, pk, pv, pout, plse, pdout, h, hk, causal, window,
                                        seg, sm_scale=scale)
    for w, p in zip(want, got):
        assert float((p[..., :d] - w).abs().max()) <= 1e-6 and not p[..., d:].any()


def test_padded_head_keeps_its_own_scale_in_every_wrapper(monkeypatch):
    """flash_attention at D 96 hands every wrapper the 128-wide tensors and
    1/√96, forward and backward alike."""
    seen = []
    for name in ("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri"):
        real = getattr(tfa, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, args[0].shape[-1], kw["sm_scale"]))
            return _real(*args, **kw)
        monkeypatch.setattr(tfa, name, spy)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True) for a in _arrays(3, 64, 2, 2, 96))
    out = tfa.flash_attention(q, k, v, block_q=32, block_k=32)
    assert out.shape == (1, 64, 2, 96)
    out.sum().backward()
    assert [(n, w) for n, w, _ in seen] == [("flash_fwd_tri", 128), ("flash_bwd_dq_tri", 128),
                                           ("flash_bwd_dkv_tri", 128)]
    assert all(abs(s - 96 ** -0.5) < 1e-12 for _, _, s in seen)


@pytest.mark.parametrize("d", [577, 640, 1024, 0])
def test_head_dims_past_256_raise_naming_the_roadmap_item(d):
    """Only head dim 0 still raises here. The name is older than the
    D-streaming route: it dates from when every head dim past 256, and then
    past 576, raised naming a ROADMAP.md item. Since item 23 was done the
    cases 577, 640 and 1024 check the opposite: each pads to the next
    multiple of 64 (577 -> 640) and runs ``flash_attention`` and
    ``flash_attention_with_lse`` against dense attention."""
    q = torch.from_numpy(np.random.default_rng(d).standard_normal((1, 8, 1, d)).astype(np.float32))
    if d == 0:
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention(q, q, q, block_q=8, block_k=8)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention_with_lse(q, q, q, block_q=8, block_k=8)
        return
    assert tfa._head_dims(d)[0] == {577: 640, 640: 640, 1024: 1024}[d]
    out = tfa.flash_attention(q, q, q, block_q=8, block_k=8)
    out_lse, lse = tfa.flash_attention_with_lse(q, q, q, block_q=8, block_k=8)
    assert out.shape == out_lse.shape == q.shape and lse.shape == (1, 8, 1)
    assert float((out - out_lse).abs().max()) <= 1e-6
    from tpu_operator_torch.workloads.ringattention import dense_attention

    want = dense_attention(q, q, q, causal=True)
    assert float((out - want).abs().max()) <= 1e-5
