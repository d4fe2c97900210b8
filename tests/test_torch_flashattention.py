"""Flash-attention port (tpu_operator_torch.workloads.flashattention)
against the JAX package on the same numpy inputs.

On the CPU the port runs the kernels' plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode, as the JAX package's
own tests do. The CUDA kernels themselves are held against the plain
version on the card in tests/test_torch_kernels.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import flashattention as jfa
from tpu_operator_torch.kernels import flash_bwd, flash_fwd
from tpu_operator_torch.workloads import flashattention as tfa

F32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny; torch's default of one thread per core would
    crowd the wall-clock-sensitive tests running beside this file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(seed, b, sq, h, d, h_kv=None, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kv_shape = (b, sk or sq, h_kv or h, d)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    return q, k, v


def _both(arrays, dtype="float32"):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    same_inf = np.isneginf(a) & np.isneginf(b)
    return float(np.max(np.abs(np.where(same_inf, 0.0, a) - np.where(same_inf, 0.0, b))))


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_causal_triangle_out_and_lse(dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, 1, 64, 2, 16), dtype)
    jo, jl = jfa.flash_attention_with_lse(jq, jk, jv, causal=True, block_q=16, block_k=32)
    to, tl = tfa.flash_attention_with_lse(tq, tk, tv, causal=True, block_q=16, block_k=32)
    assert to.dtype == DTYPES[dtype][1] and tl.shape == (1, 64, 2)
    assert _err(jo, to) <= tol
    # the reference's triangle path rounds the pre-scaled q to bf16
    # (flashattention.py:750); the port keeps it f32, which moves bf16 lse
    # by up to ~2^-8 of the largest score
    assert _err(jl, tl) <= (1e-5 if dtype == "float32" else 1e-2)
    got = tfa.flash_attention(tq, tk, tv, causal=True, block_q=16, block_k=32)
    want = jfa.flash_attention(jq, jk, jv, causal=True, block_q=16, block_k=32)
    assert _err(want, got) <= tol


def test_full_attention():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 32, 2, 8))
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_q=16, block_k=16)
    got = tfa.flash_attention(tq, tk, tv, causal=False, block_q=16, block_k=16)
    assert _err(want, got) <= F32_TOL


def test_window_straddling_a_block_edge():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 64, 2, 8))
    want = jfa.flash_attention(jq, jk, jv, block_q=16, block_k=16, window=20)
    got = tfa.flash_attention(tq, tk, tv, block_q=16, block_k=16, window=20)
    assert _err(want, got) <= F32_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_segments_boundary_mid_block(dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 2, 64, 2, 16), dtype)
    seg = np.broadcast_to((np.arange(64) >= 40).astype(np.int32), (2, 64))
    want = jfa.flash_attention(jq, jk, jv, block_q=32, block_k=32, segment_ids=jnp.asarray(seg))
    got = tfa.flash_attention(tq, tk, tv, block_q=32, block_k=32,
                              segment_ids=torch.from_numpy(seg.copy()))
    assert _err(want, got) <= tol


def test_gqa():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 2, 32, 4, 8, h_kv=2))
    want = jfa.flash_attention(jq, jk, jv, block_q=16, block_k=16)
    got = tfa.flash_attention(tq, tk, tv, block_q=16, block_k=16)
    assert _err(want, got) <= F32_TOL


def test_gqa_with_segments_and_window():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 2, 64, 4, 8, h_kv=2))
    seg = np.repeat(np.array([[0] * 24 + [1] * 40, [0] * 50 + [1] * 14]), 1, axis=0).astype(np.int32)
    want = jfa.flash_attention(jq, jk, jv, block_q=16, block_k=16, window=24,
                               segment_ids=jnp.asarray(seg))
    got = tfa.flash_attention(tq, tk, tv, block_q=16, block_k=16, window=24,
                              segment_ids=torch.from_numpy(seg))
    assert _err(want, got) <= F32_TOL


@pytest.mark.parametrize("q_start", [0, 8, 16, 56])
def test_serving_prefill_shape(q_start):
    """The chunked-prefill call: 8 q rows at global offset q_start against
    the 64-row paged context, f32."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 1, 8, 2, 16, sk=64))
    jo, jl = jfa.flash_attention_with_lse(jq, jk, jv, causal=True, q_start=q_start)
    to, tl = tfa.flash_attention_with_lse(tq, tk, tv, causal=True, q_start=q_start)
    assert _err(jo, to) <= 1e-5
    assert _err(jl, tl) <= 1e-5


def test_rows_before_k_start_are_fully_masked():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 1, 32, 2, 8))
    jo, jl = jfa.flash_attention_with_lse(jq, jk, jv, causal=True, block_q=16, block_k=16,
                                          k_start=16)
    to, tl = tfa.flash_attention_with_lse(tq, tk, tv, causal=True, block_q=16, block_k=16,
                                          k_start=16)
    assert _err(jo, to) <= F32_TOL and _err(jl, tl) <= F32_TOL
    assert torch.all(to[:, :16] == 0) and torch.all(torch.isneginf(tl[:, :16]))
    assert torch.all(torch.isfinite(tl[:, 16:]))


def test_lse_is_natural_log():
    _, (tq, tk, tv) = _both(_qkv(8, 1, 32, 2, 16))
    _, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=False)
    scores = torch.einsum("bqhd,bkhd->bqhk", tq, tk) / math.sqrt(16)
    assert torch.allclose(lse, torch.logsumexp(scores, dim=-1), atol=1e-5)


def _cases():
    q = np.zeros((1, 32, 4, 8), np.float32)
    kv3 = np.zeros((1, 32, 3, 8), np.float32)
    kv2 = np.zeros((1, 32, 2, 8), np.float32)
    short = np.zeros((1, 16, 4, 8), np.float32)
    seg_bad = np.zeros((1, 16), np.int32)
    seg_float = np.zeros((1, 32), np.float32)
    return {
        "blocks_do_not_divide": ("fa", (q, q, q), dict(block_q=12, block_k=16)),
        "window_without_causal": ("fa", (q, q, q), dict(causal=False, window=4, block_q=16, block_k=16)),
        "window_below_one": ("fa", (q, q, q), dict(window=0, block_q=16, block_k=16)),
        "kv_len_differs": ("fa", (q, short, short), dict(block_q=16, block_k=16)),
        "heads_not_multiple": ("fa", (q, kv3, kv3), dict(block_q=16, block_k=16)),
        "k_v_shapes_differ": ("fa", (q, q, kv2), dict(block_q=16, block_k=16)),
        "segment_shape": ("fa", (q, q, q), dict(block_q=16, block_k=16, segment_ids=seg_bad)),
        "segment_dtype": ("fa", (q, q, q), dict(block_q=16, block_k=16, segment_ids=seg_float)),
        "lse_blocks_do_not_divide": ("lse", (q, q, q), dict(block_q=12, block_k=16)),
        "lse_heads_not_multiple": ("lse", (q, kv3, kv3), dict()),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_value_errors_match(case):
    fn, arrays, kwargs = _cases()[case]
    seg = kwargs.pop("segment_ids", None)
    jargs, targs = _both(arrays)
    name = "flash_attention" if fn == "fa" else "flash_attention_with_lse"
    jkw, tkw = dict(kwargs), dict(kwargs)
    if seg is not None:
        jkw["segment_ids"], tkw["segment_ids"] = jnp.asarray(seg), torch.from_numpy(seg)
    with pytest.raises(ValueError):
        getattr(jfa, name)(*jargs, **jkw)
    with pytest.raises(ValueError):
        getattr(tfa, name)(*targs, **tkw)


def test_window_with_offsets_rejected():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(9, 1, 16, 1, 8))
    qb, kb, vb = (x.reshape(1, 16, 8) for x in (tq, tk, tv))
    with pytest.raises(ValueError):
        jfa._flash_forward(*(x.reshape(1, 16, 8) for x in (jq, jk, jv)), True, 16, 16,
                           q_start=8, window=4)
    with pytest.raises(ValueError):
        tfa._flash_forward(qb, kb, vb, True, 16, 16, q_start=8, window=4)


def test_helpers_match_reference():
    for heads, kv_heads in ((4, 4), (4, 2), (8, 1)):
        rows = np.arange(3 * heads)
        assert [tfa._kv_row(int(i), heads, kv_heads) for i in rows] == [
            int(jfa._kv_row(int(i), heads, kv_heads)) for i in rows
        ]
    for args in ((4, 4, 16, 16), (2, 4, 32, 16), (4, 2, 16, 32)):
        want = jfa._causal_triangle_tables(*args)
        got = tfa._causal_triangle_tables(*args)
        for w, g in zip(want, got):
            assert g.tolist() == np.asarray(w).tolist()


def test_run_flash_attention_check_on_cpu():
    report = tfa.run_flash_attention_check(seq_len=64, head_dim=16, block_q=32, block_k=16,
                                           device="cpu")
    assert report["ok"] and report["max_abs_err"] <= BF16_TOL
    assert report["segment_max_abs_err"] <= BF16_TOL


def test_cpu_tensors_take_the_plain_version_and_backward_is_not_ported():
    """CPU tensors reach no kernel: the forward and the backward (both
    pairs) run their plain versions, and no launch is counted."""
    _, (tq, tk, tv) = _both(_qkv(10, 1, 16, 2, 16))
    wrappers = [flash_fwd.flash_fwd_tri, flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_tri,
                flash_bwd.flash_bwd_dkv_tri, flash_bwd.flash_bwd_dq_rect,
                flash_bwd.flash_bwd_dkv_rect]
    before = [w.launches for w in wrappers]
    for x in (tq, tk, tv):
        x.requires_grad_(True)
    for causal in (True, False):
        out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=16, block_k=16)
        grads = torch.autograd.grad(out.sum(), (tq, tk, tv))
        qb, kb, vb, h, h_kv = tfa._collapse_heads(tq.detach(), tk.detach(), tv.detach())
        o, lse = flash_fwd.attention_plain(qb, kb, vb, h, h_kv, causal)
        want = flash_bwd.attention_bwd_plain(qb, kb, vb, o, lse, torch.ones_like(o), h, h_kv,
                                             causal)
        for g, w in zip(grads, want):
            assert torch.equal(tfa._collapse_heads(g, g, g)[0], w)
    assert [w.launches for w in wrappers] == before
