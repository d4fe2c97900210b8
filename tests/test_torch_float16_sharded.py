"""One sharded float16 train step of the port on a 4-rank gloo mesh (data
2, model 2) against the JAX package's step on the same mesh shape.

gloo takes fp16 collectives, so the Megatron activations' all-reduces run
in fp16 as on the card. Two steps: the second loss reads the first update;
then every parameter, gathered to the reference's global layout, as the
distance to the reference's over the length of the reference's change.
Bars: 2e-2 (the reference's 16-bit bar) for both; the CPU reads 8.4e-4 to
3.5e-3 on the parameters. JAX is imported inside the test only: the ranks
import this module to find their function, and skip it.
"""

import numpy as np
import torch

from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads.distributed import spawn_world

TOL = 2e-2
MESH = dict(data=2, model=2)
SHARDED = dict(d_model=64, n_heads=4, d_ff=128, seq_len=64, batch=4, n_layers=2,
               dtype="float16", use_flash_attention=True, kv_heads=2)


def _sharded_steps(arrays, batch):
    """Two fp16 steps on this rank's shards of a (data 2, model 2) gloo
    mesh: the losses, and (rank 0) the params after them, gathered."""
    cfg = tb.BurninConfig(**SHARDED)
    mesh = tb.make_mesh(**MESH)
    step, params, data = tb.build_train_step(cfg, "cpu", arrays, batch, mesh=mesh)
    assert data[0].dtype == torch.float16
    losses = []
    for _ in range(2):
        params, loss = step(params, data)
        losses.append(float(loss))
    gathered = tb.gather_burnin_params(params, cfg, mesh)
    return losses, gathered if torch.distributed.get_rank() == 0 else None


def test_sharded_step_matches_reference():
    import jax
    import jax.numpy as jnp

    from tpu_operator.workloads import burnin as jb

    cfg = jb.BurninConfig(**SHARDED)
    jstep, jparams, jbatch = jb.build_train_step(jb.make_mesh(jax.devices("cpu")[:4], **MESH),
                                                 cfg)
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tuple(np.asarray(a.astype(jnp.float32)) for a in jbatch)
    want = []
    for _ in range(2):
        jparams, loss = jstep(jparams, jbatch)
        want.append(float(loss))
    ranks = spawn_world(4, _sharded_steps, (arrays, batch), device="cpu", timeout=180)
    assert all(r[0] == ranks[0][0] for r in ranks)  # every rank holds the global losses
    got = ranks[0][0]
    assert max(abs(w - g) / abs(w) for w, g in zip(want, got)) <= TOL, (want, got)
    gaps = {}
    for name, value in jparams.items():
        value = np.asarray(value)
        assert ranks[0][1][name].shape == value.shape
        gaps[name] = float(np.linalg.norm(ranks[0][1][name] - value)
                           / np.linalg.norm(value - arrays[name]))
    assert max(gaps.values()) <= TOL, gaps
