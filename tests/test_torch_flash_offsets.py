"""bf16 ``flash_attention_with_lse`` at global offsets and sq != sk: the
port against the JAX package on the same numpy inputs.

These are the calls a ring hop (``q_start = k_start + S``: every key lies
before every row) and a chunked prefill (sq < sk, the causal edge inside
the chunk) make of the general forward. On the CPU the port runs the
kernel's plain version; the JAX function runs its Pallas kernel in
interpret mode, as the JAX package's own tests do. On the card the bf16
general kernel is held to the same plain version
(``tests/test_torch_kernels.py``), so these cases pin the contract it
meets there. Tolerances: O within the reference's bf16 bar (2e-2); lse
within 1e-2, since the reference rounds the pre-scaled q to bf16 and the
port keeps the scale in f32 (ROADMAP Queue 3, "Scoring").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import flashattention as jfa
from tpu_operator_torch.workloads import flashattention as tfa

O_TOL = 2e-2
LSE_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once and
    these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((1, sq, h, d)), rng.standard_normal((1, sk, h_kv, d)),
              rng.standard_normal((1, sk, h_kv, d)))
    arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _err(want, got):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape
    assert np.array_equal(np.isneginf(want), np.isneginf(got))
    inf = np.isneginf(want)
    return float(np.max(np.abs(np.where(inf, 0.0, want) - np.where(inf, 0.0, got))))


def _both(seed, sq, sk, h, h_kv, d, q_start, k_start, block):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed, sq, sk, h, h_kv, d)
    kwargs = dict(causal=True, block_q=block, block_k=block, q_start=q_start, k_start=k_start)
    return (jfa.flash_attention_with_lse(jq, jk, jv, **kwargs),
            tfa.flash_attention_with_lse(tq, tk, tv, **kwargs))


@pytest.mark.parametrize("s, k_start, h_kv", [
    (32, 0, 2),    # the first hop behind the local block
    (32, 64, 1),   # further along the ring, a GQA group of 2
    (48, 16, 2),   # a block that is not a power of two
])
def test_ring_hop(s, k_start, h_kv):
    """q_start = k_start + S: every key of the hop lies before every row."""
    (jo, jl), (to, tl) = _both(0, s, s, 2, h_kv, 16, k_start + s, k_start, 16)
    assert to.dtype == torch.bfloat16 and tl.shape == (1, s, 2)
    assert _err(jo, to) <= O_TOL and _err(jl, tl) <= LSE_TOL
    assert torch.all(torch.isfinite(tl))


@pytest.mark.parametrize("sq, sk, q_start, h_kv", [
    (16, 64, 48, 2),   # the last chunk: the causal edge on the last key block
    (16, 64, 24, 2),   # a middle chunk: keys past its rows are masked
    (32, 96, 64, 1),   # a GQA group of 2
])
def test_chunk_shorter_than_its_keys(sq, sk, q_start, h_kv):
    (jo, jl), (to, tl) = _both(1, sq, sk, 2, h_kv, 16, q_start, 0, 16)
    assert tl.shape == (1, sq, 2)
    assert _err(jo, to) <= O_TOL and _err(jl, tl) <= LSE_TOL


def test_a_future_hop_sees_no_key():
    """k_start past every row: every row gets O = 0 and lse = -inf, in the
    reference and the port alike."""
    (jo, jl), (to, tl) = _both(2, 32, 32, 2, 2, 16, 0, 32, 16)
    assert _err(jo, to) == 0.0 and _err(jl, tl) == 0.0
    assert torch.all(to == 0) and torch.all(torch.isneginf(tl))
