"""The port's ring attention (``workloads/ringattention.py``) on 2- and
4-rank gloo worlds against the JAX package's dense attention: the twins
of its ``TestRingAttention``.

The inputs are global numpy arrays cut into sequence chunks, one per
rank of the ring; one 4-rank world runs every case as a ring of 4 and as
two rings of 2 (a (rep, sp) mesh) and returns each rank's output chunk,
its q/k/v gradients of sum(out²) and how many times it passed K/V on.
The tests only assert on those results. Causal and full attention,
segment ids whose documents span the ring, a banded window (and the hop
count it implies), grouped-query attention, and the flash body (its plain
version on the CPU) all match the reference within 2e-4, gradients
included, as the reference's own tests hold its ring.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_operator_torch.workloads import ringattention as tr
from tpu_operator_torch.workloads.spmd import named_mesh
from tpu_operator_torch.workloads.distributed import spawn_world

# JAX and the JAX package are imported inside the reference-side
# functions: a world's ranks import this module to find their function,
# and JAX there nearly doubles the world's start (8 ranks: ~27 against
# ~50 CPU-seconds), load that starves the suite's wall-clock tests.

TOL = 2e-4
RINGS = (2, 4)
B, S, D = 2, 32, 8
SEG = np.where(np.arange(S) < 5, 0, np.where(np.arange(S) < 19, 1, 2)).astype(np.int32)
# name: (q heads, kv heads, causal, segments, window, local_impl)
CASES = {
    "causal": (2, 2, True, False, None, "dense"),
    "full": (2, 2, False, False, None, "dense"),
    "segments_causal": (2, 2, True, True, None, "dense"),
    "segments_full": (2, 2, False, True, None, "dense"),
    "window": (2, 2, True, False, 6, "dense"),
    "window_segments": (2, 2, True, True, 6, "dense"),
    "gqa": (4, 2, True, False, None, "dense"),
    "gqa_window_segments": (4, 2, True, True, 6, "dense"),
    "flash_causal": (2, 2, True, False, None, "flash"),
    "flash_full": (2, 2, False, False, None, "flash"),
}


def _inputs(name):
    h, h_kv = CASES[name][:2]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return tuple(rng.standard_normal((B, S, heads, D)).astype(np.float32)
                 for heads in (h, h_kv, h_kv))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(out, (dq, dk, dv)) of the reference's dense attention over
    repeated KV with the case's masks, and the gradients of sum(out²)."""
    import jax
    import jax.numpy as jnp

    from tpu_operator.workloads import ringattention as jr

    h, h_kv, causal, segments, window, _ = CASES[name]
    q, k, v = (jnp.asarray(a) for a in _inputs(name))
    seg = jnp.broadcast_to(jnp.asarray(SEG), (B, S)) if segments else None

    def attend(qq, kk, vv):
        kk, vv = (jnp.repeat(a, h // h_kv, axis=2) for a in (kk, vv))
        if window is None:
            return jr.dense_attention(qq, kk, vv, causal=causal, segment_ids=seg)
        pos = jnp.arange(S)
        keep = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        if seg is not None:
            keep = keep & (seg[0][:, None] == seg[0][None, :])
        sc = jnp.einsum("bqhd,bkhd->bhqk", qq, kk) / np.sqrt(float(D))
        sc = jnp.where(keep[None, None], sc, -jnp.inf)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(sc, axis=-1), vv)

    out = np.asarray(attend(q, k, v))
    grads = jax.grad(lambda *a: jnp.sum(attend(*a) ** 2), argnums=(0, 1, 2))(q, k, v)
    return out, tuple(np.asarray(g) for g in grads)


def _rank_cases():
    """Every case as a ring of 2 and of 4, then the validator check."""
    shifts = []
    shift = tr.ring_shift

    def counting(tensors, group):
        shifts.append(len(tensors))
        return shift(tensors, group)

    tr.ring_shift = counting
    out = {"cases": {}, "checks": {}}
    for n in RINGS:
        mesh = named_mesh(rep=dist.get_world_size() // n, sp=n)
        idx, s_local = mesh.get_local_rank("sp"), S // n
        for name, (_, _, causal, segments, window, impl) in CASES.items():
            q, k, v = (torch.from_numpy(a[:, idx * s_local:(idx + 1) * s_local]).requires_grad_(True)
                       for a in _inputs(name))
            seg = (torch.from_numpy(np.broadcast_to(SEG, (B, S))[:, idx * s_local:][:, :s_local]
                                    .copy()) if segments else None)
            shifts.clear()
            got = tr.ring_attention(q, k, v, mesh, causal=causal, local_impl=impl,
                                    segment_ids=seg, window=window)
            kv_shifts = sum(1 for c in shifts if c == 2)
            grads = None
            if impl == "dense":
                grads = [g.numpy() for g in torch.autograd.grad(got.square().sum(), (q, k, v))]
            out["cases"][(n, name)] = (idx, got.detach().numpy(), grads, kv_shifts)
        ring = named_mesh(sp=n, rep=dist.get_world_size() // n)
        for impl in ("dense", "flash"):
            for causal in (True, False):
                out["checks"][(n, impl, causal)] = tr.run_ring_attention_check(
                    ring, seq_len=64, causal=causal, local_impl=impl)
    try:
        tr.run_ring_attention_check(seq_len=30)
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


@pytest.fixture(scope="module")
def world():
    return spawn_world(4, _rank_cases, device="cpu", timeout=240)


def _assembled(world, n, name):
    """The ring's chunks joined back along the sequence."""
    chunks = {}
    for rank in world:
        idx, out, grads, shifts = rank["cases"][(n, name)]
        chunks[idx] = (out, grads, shifts)
    order = [chunks[i] for i in range(n)]
    out = np.concatenate([c[0] for c in order], axis=1)
    grads = None
    if order[0][1] is not None:
        grads = [np.concatenate([c[1][j] for c in order], axis=1) for j in range(3)]
    return out, grads, {c[2] for c in order}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n", RINGS)
def test_ring_matches_reference(world, n, name):
    want, want_grads = _reference(name)
    got, grads, shifts = _assembled(world, n, name)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < TOL
    window = CASES[name][4]
    assert shifts == {tr._ring_hops(n, S // n, window) - 1}  # the last chunk stays put
    if grads is not None:
        for label, g, w in zip("qkv", grads, want_grads):
            assert g.shape == w.shape
            assert float(np.max(np.abs(g - w))) < TOL, f"d{label} diverges"


def test_banded_window_stops_the_ring_early(world):
    """A window of 6 over 8-row chunks reaches one chunk back: a ring of 4
    passes K/V on once, not three times."""
    assert _assembled(world, 4, "window")[2] == {1}
    assert _assembled(world, 4, "causal")[2] == {3}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("n", RINGS)
def test_validator_check(world, n, impl, causal):
    for rank in world:
        report = rank["checks"][(n, impl, causal)]
        assert report["ok"] and report["devices"] == n and report["max_abs_err"] < TOL
        assert report["seq_per_device"] == 64 // n and report["causal"] is causal


def test_indivisible_seq_rejected(world):
    assert "not divisible" in world[0]["indivisible"]


def test_ring_hops_match_reference():
    from tpu_operator.workloads import ringattention as jr

    assert tr._ring_hops(8, 8, 12) == 3
    assert tr._ring_hops(8, 8, 64) == 8
    assert tr._ring_hops(8, 8, None) == 8
    assert tr._ring_hops(8, 8, 1) == 1
    for n in (1, 2, 4, 8):
        for s_local in (1, 8, 16):
            for window in (None, 1, 5, 8, 9, 17, 100):
                assert tr._ring_hops(n, s_local, window) == jr._ring_hops(n, s_local, window)


@pytest.mark.parametrize("kwargs, match", [
    (dict(causal=False, window=4), "causal"),
    (dict(window=0), "causal"),
    (dict(local_impl="flash", window=4), "dense"),
    (dict(local_impl="flash", segment_ids=torch.zeros((1, 16), dtype=torch.int32)), "dense"),
    (dict(segment_ids=torch.zeros((1, 8), dtype=torch.int32)), "segment_ids must be"),
], ids=["window_full", "window_zero", "flash_window", "flash_segments", "segments_shape"])
def test_rejections(kwargs, match):
    x = torch.zeros((1, 16, 2, 8))
    with pytest.raises(ValueError, match=match):
        tr.ring_attention(x, x, x, None, **kwargs)


def test_rejects_heads_and_shapes():
    q = torch.zeros((1, 16, 4, 8))
    k3 = torch.zeros((1, 16, 3, 8))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tr.ring_attention(q, k3, k3, None)
    with pytest.raises(ValueError, match="must match"):
        tr.ring_attention(q, torch.zeros((1, 16, 2, 8)), q, None)
