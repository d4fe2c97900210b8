"""Flash-attention backward of the port (``_FlashCore.backward`` and
``kernels/flash_bwd.py``) against the JAX package on the same numpy
inputs, and its plain version against a second oracle.

On the CPU the port's wrappers run ``attention_bwd_plain``; the JAX side
differentiates its ``flash_attention`` through the Pallas backward kernels
in interpret mode, as the JAX package's own tests do. The CUDA kernels are
held against the plain version on the card in tests/test_torch_kernels.py.

Tolerances: f32 gradients within 1e-4 absolute (the reference's own bar,
tests/test_workloads.py); bf16 within 2e-2 of the largest |gradient| of
dq, dk and dv: both sides round P and dS to bf16 before each product, and
the reference's triangle pair also rounds q·log2e and k/√d to bf16 before
the scores, where the port scores in f32 exactly as its forward did.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import flashattention as jfa
from tpu_operator_torch.kernels import flash_bwd, flash_fwd
from tpu_operator_torch.workloads import flashattention as tfa
from tpu_operator_torch.workloads.ringattention import dense_attention

F32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(seed, b, s, h, d, h_kv=None):
    """q, k, v and a cotangent weight w, standard normal, from a numpy seed."""
    rng = np.random.default_rng(seed)
    kv = (b, s, h_kv or h, d)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), kv, kv,
                                                                         (b, s, h, d))]


def _segments(b, s, cuts):
    """Segment ids (b, s) int32: row i switches from 0 to 1 at cuts[i]."""
    return np.stack([(np.arange(s) >= cuts[i % len(cuts)]) for i in range(b)]).astype(np.int32)


CASES = {
    # name: (seed, (b, s, h, d, h_kv), flash_attention kwargs, segment cuts)
    "triangle": (0, (1, 64, 2, 16, None), dict(block_q=16, block_k=32), None),
    "full": (1, (2, 32, 2, 8, None), dict(causal=False, block_q=16, block_k=16), None),
    "window_straddling_a_block_edge": (2, (1, 64, 2, 8, None),
                                       dict(block_q=16, block_k=16, window=20), None),
    "segments_boundary_mid_block": (3, (2, 64, 2, 16, None), dict(block_q=32, block_k=32), [40]),
    # two documents on a block edge: each block's ids are uniform, so the
    # reference takes its unmasked fast path (and skips cross-document blocks)
    "segments_block_aligned": (11, (2, 64, 2, 16, None), dict(block_q=32, block_k=32), [32]),
    "gqa_4_2": (4, (2, 32, 4, 8, 2), dict(block_q=16, block_k=16), None),
    "gqa_segments_window": (5, (2, 64, 4, 8, 2), dict(block_q=16, block_k=16, window=24),
                            [24, 50]),
}


def _grads(case, dtype):
    """(reference grads, port grads) as float32 numpy arrays."""
    seed, (b, s, h, d, h_kv), kwargs, cuts = CASES[case]
    q, k, v, w = _arrays(seed, b, s, h, d, h_kv)
    seg = None if cuts is None else _segments(b, s, cuts)
    jd, td = DTYPES[dtype]

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, segment_ids=None if seg is None else jnp.asarray(seg),
                                  **kwargs)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jd) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=None if seg is None else torch.from_numpy(seg),
                              **kwargs)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)
    assert all(g.dtype == td for g in got)
    return ([np.asarray(jnp.asarray(x, jnp.float32)) for x in want],
            [x.float().numpy() for x in got])


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_gradients_match_reference(case):
    want, got = _grads(case, "float32")
    for name, w, g in zip("qkv", want, got):
        assert w.shape == g.shape
        assert float(np.max(np.abs(w - g))) <= F32_TOL, f"d{name}"


@pytest.mark.parametrize("case", ["triangle", "segments_boundary_mid_block", "segments_block_aligned",
                                  "gqa_4_2"])
def test_bf16_gradients_match_reference(case):
    want, got = _grads(case, "bfloat16")
    scale = max(float(np.max(np.abs(w))) for w in want)
    for name, w, g in zip("qkv", want, got):
        assert float(np.max(np.abs(w - g))) <= BF16_TOL * scale, f"d{name}"


def _collapsed(seed, b, s, h, d, h_kv, dtype=torch.float32):
    q, k, v, w = (torch.from_numpy(a) for a in _arrays(seed, b, s, h, d, h_kv))
    qb, kb, vb, h, h_kv = tfa._collapse_heads(q, k, v)
    return qb.to(dtype), kb.to(dtype), vb.to(dtype), tfa._collapse_heads(w, w, w)[0], h, h_kv


PLAIN_CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=5),
    "segments": dict(causal=True, seg=True),
    "full_segments": dict(causal=False, seg=True),
    "window_segments": dict(causal=True, window=9, seg=True),
}


@pytest.mark.parametrize("h_kv", [4, 2, 1])
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_backward_matches_autograd_through_the_plain_forward(case, h_kv):
    """Second oracle: attention_bwd_plain against torch.autograd through
    attention_plain, in f32 (where its rounding points are no-ops)."""
    kwargs = dict(PLAIN_CASES[case])
    qb, kb, vb, wb, h, hk = _collapsed(6, 2, 24, 4, 8, h_kv)
    if kwargs.pop("seg", False):
        kwargs["seg"] = torch.from_numpy(_segments(2, 24, [7, 15]))
    leaves = [x.clone().requires_grad_(True) for x in (qb, kb, vb)]
    out, lse = flash_fwd.attention_plain(*leaves, h, hk, **kwargs)
    want = torch.autograd.grad((out * wb).sum(), leaves)
    got = flash_bwd.attention_bwd_plain(qb, kb, vb, out.detach(), lse.detach(), wb, h, hk,
                                        kwargs["causal"], kwargs.get("window"), kwargs.get("seg"))
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((w - g).abs().max()) <= 1e-5


def test_plain_backward_rounds_where_the_reference_does():
    """bf16 inputs: P is rounded before dV and dS before dQ/dK, so the
    plain version differs from the f32 computation by about one bf16 step,
    and returns the inputs' dtype."""
    qb, kb, vb, wb, h, hk = _collapsed(7, 1, 32, 2, 16, 2, torch.bfloat16)
    out, lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, causal=True)
    dout = wb.to(torch.bfloat16)
    got = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, hk, True)
    exact = flash_bwd.attention_bwd_plain(qb.float(), kb.float(), vb.float(), out.float(), lse,
                                          dout.float(), h, hk, True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    scale = max(float(e.abs().max()) for e in exact)
    diffs = [float((g.float() - e).abs().max()) for g, e in zip(got, exact)]
    assert 0 < max(diffs) <= BF16_TOL * scale


@pytest.mark.parametrize("kwargs,pair", [
    (dict(), "tri"),
    (dict(causal=False), "rect"),
    (dict(window=8), "rect"),
    (dict(segment_ids=True), "rect"),
])
def test_backward_takes_the_reference_pair(monkeypatch, kwargs, pair):
    """Plain causal attention runs the triangle pair, everything else the
    general pair — the reference's choice (flashattention.py:1069)."""
    calls = []

    def spy(name, real):
        def wrapped(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return wrapped

    for name in ("flash_bwd_dq_tri", "flash_bwd_dkv_tri", "flash_bwd_dq_rect",
                 "flash_bwd_dkv_rect"):
        monkeypatch.setattr(tfa, name, spy(name, getattr(tfa, name)))
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True) for a in _arrays(8, 1, 32, 2, 8))
    if kwargs.get("segment_ids"):
        kwargs = dict(segment_ids=torch.from_numpy(_segments(1, 32, [12])))
    tfa.flash_attention(q, k, v, block_q=16, block_k=16, **kwargs).sum().backward()
    assert calls == [f"flash_bwd_dq_{pair}", f"flash_bwd_dkv_{pair}"]


def test_gradients_match_dense_attention():
    """The reference's own gradient test (tests/test_workloads.py), at a
    CPU-sized shape: autograd through flash_attention against autograd
    through dense attention, f32."""
    q, k, v, w = (torch.from_numpy(a) for a in _arrays(9, 1, 128, 2, 32))
    grads = {}
    for name, attn in (("flash", tfa.flash_attention), ("dense", dense_attention)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        grads[name] = torch.autograd.grad((attn(*leaves, causal=True) * w).sum(), leaves)
    for got, want in zip(grads["flash"], grads["dense"]):
        assert float((got - want).abs().max()) <= F32_TOL


def test_a_broadcast_cotangent_gives_the_same_gradients():
    """``out.sum()`` hands the backward a stride-0 cotangent; it must give
    the gradients of the same cotangent materialised."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(10, 2, 32, 2, 8))
    seg = torch.from_numpy(_segments(2, 32, [9, 20]))
    grads = []
    for loss in (lambda o: o.sum(), lambda o: (o * torch.ones_like(o)).sum()):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = tfa.flash_attention(*leaves, block_q=16, block_k=16, segment_ids=seg)
        grads.append(torch.autograd.grad(loss(out), leaves))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_uniform_attention_gradients_in_closed_form():
    """q = 0 and identical keys: every P row is uniform, so dq = dk = 0
    and, for out.sum(), dv = the column sums of P = 1."""
    b, s, h, d = 1, 8, 1, 16
    q = torch.zeros((b, s, h, d), requires_grad=True)
    k = torch.ones((b, s, h, d), requires_grad=True)
    v = torch.randn((b, s, h, d), generator=torch.Generator().manual_seed(0), requires_grad=True)
    tfa.flash_attention(q, k, v, causal=False, block_q=8, block_k=8).sum().backward()
    assert float(q.grad.abs().max()) <= 1e-6 and float(k.grad.abs().max()) <= 1e-6
    assert torch.allclose(v.grad, torch.ones_like(v.grad), atol=1e-6)
