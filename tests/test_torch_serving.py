"""Serving engine of the port (tpu_operator_torch.workloads.serving)
against the JAX package's DecodeEngine on the CPU: bit-identical weights,
the same pool bookkeeping, and identical greedy tokens for a seeded
request mix, with flash prefill on and off and the int8 MLP on and off.
Prompts are longer than one prefill chunk, so the chunked prefill runs at
q_start > 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_operator.workloads import serving as js
from tpu_operator_torch.weights import serving_params
from tpu_operator_torch.workloads import serving as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny; torch's default of one thread per core would
    crowd the wall-clock-sensitive tests running beside this file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny(mod, **over):
    """tests/test_serving.py's tiny_cfg geometry."""
    base = dict(
        d_model=16, n_heads=2, head_dim=8, d_ff=32, vocab=64,
        page_tokens=4, max_pages=32, max_batch=4, max_seq=32,
        prefill_chunk=4,
    )
    base.update(over)
    return mod.ServingModelConfig(**base)


def _run(engine, requests):
    for r in requests:
        engine.submit(r)
    engine.run_until_drained()
    return {r.rid: list(r.output) for r in engine.completed}


def _requests(mod, count=6, prompt_len=10):
    return mod.make_requests(count, seed=11, prompt_len=prompt_len, decode_min=3,
                             decode_max=12, vocab=64)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_mlp", "int8_mlp"])
def test_build_params_bit_identical(int8):
    cfg_kw = dict(int8_mlp=int8)
    want = js._build_params(tiny(js, **cfg_kw), seed=5)
    got = ts._build_params(tiny(ts, **cfg_kw), seed=5, device="cpu")
    assert set(got) == set(want)
    for name, value in want.items():
        ref = np.asarray(value)
        mine = got[name].numpy()
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        assert mine.tobytes() == ref.tobytes(), name


def test_weights_loader_carries_reference_params():
    cfg = tiny(ts)
    arrays = {k: np.asarray(v) for k, v in js._build_params(tiny(js), seed=2).items()}
    loaded = serving_params(arrays, cfg, "cpu")
    built = ts._build_params(cfg, seed=2, device="cpu")
    assert all(torch.equal(loaded[k], built[k]) for k in built)
    with pytest.raises(ValueError):
        serving_params(arrays, tiny(ts, int8_mlp=False), "cpu")


def test_paged_pool_behaves_the_same():
    pools = [mod.PagedKVPool(tiny(mod, max_pages=6, max_batch=3)) for mod in (js, ts)]
    script = [("alloc",), ("ensure", 0, 5), ("alloc",), ("ensure", 1, 9), ("ensure", 0, 12),
              ("ensure", 1, 20), ("free", 0), ("alloc",), ("ensure", 0, 3), ("free", 1),
              ("ensure", 0, 16)]
    for op in script:
        results = []
        for pool in pools:
            if op[0] == "alloc":
                results.append(pool.alloc_slot())
            elif op[0] == "ensure":
                results.append(pool.ensure(op[1], op[2]))
            else:
                results.append(pool.free_slot(op[1]))
        assert results[0] == results[1], op
        assert np.array_equal(pools[0].table, pools[1].table), op
        assert pools[0].pages == pools[1].pages and pools[0].free_pages == pools[1].free_pages


@pytest.mark.parametrize("int8", [False, True], ids=["f32_mlp", "int8_mlp"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense_prefill", "flash_prefill"])
def test_greedy_tokens_identical_to_reference(flash, int8):
    over = dict(use_flash_prefill=flash, int8_mlp=int8)
    want = _run(js.DecodeEngine(tiny(js, **over), seed=3), _requests(js))
    got = _run(ts.DecodeEngine(tiny(ts, **over), seed=3, device="cpu"), _requests(ts))
    assert got == want
    assert all(len(tokens) > 0 for tokens in got.values())


def test_flash_prefill_matches_dense_tokens():
    outs = []
    for flash in (False, True):
        engine = ts.DecodeEngine(tiny(ts, head_dim=16, use_flash_prefill=flash), seed=5,
                                 device="cpu")
        outs.append(_run(engine, _requests(ts, count=3, prompt_len=9)))
    assert outs[0] == outs[1]


def test_batched_decode_matches_single_request():
    cfg = tiny(ts)
    reqs = _requests(ts, count=4, prompt_len=6)
    alone = _run(ts.DecodeEngine(cfg, seed=7, device="cpu"),
                 [dataclasses.replace(reqs[0], output=[])])
    together = _run(ts.DecodeEngine(cfg, seed=7, device="cpu"), reqs)
    assert together[reqs[0].rid] == alone[reqs[0].rid]


def test_report_has_the_reference_keys():
    reports = []
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        engine = mod.DecodeEngine(tiny(mod, use_flash_prefill=True), seed=1, **kw)
        engine.warmup(8)
        _run(engine, _requests(mod, count=3, prompt_len=8))
        reports.append(engine.report())
    assert set(reports[1]) == set(reports[0])
    for key in ("steps", "requests_completed", "decoded_tokens", "flash_blocks",
                "occupancy_mean", "session_hits", "prefix_hits"):
        assert reports[1][key] == reports[0][key], key


def test_sessions_prefix_cache_and_kv_handoff_match_reference():
    """Session resume, prefix-cache import and the prefill->decode handoff
    give the reference's tokens and byte counts."""
    results = []
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        rng = np.random.default_rng(4)
        system = rng.integers(0, 64, size=8).astype(np.int32)
        first = mod.ServingRequest("t1", np.concatenate([system, [5, 6]]).astype(np.int32), 4,
                                   session="s")
        engine = mod.DecodeEngine(tiny(mod), seed=9, retain_sessions=True, **kw)
        out = _run(engine, [first])
        follow = mod.ServingRequest(
            "t2", np.concatenate([first.prompt, first.output[:3], [7]]).astype(np.int32), 3,
            session="s")
        shared = mod.ServingRequest("t3", np.concatenate([system, [9, 9, 9]]).astype(np.int32), 3)
        out.update(_run(engine, [follow, shared]))
        prefill = mod.DecodeEngine(tiny(mod), seed=9, prefill_only=True, **kw)
        decode = mod.DecodeEngine(tiny(mod), seed=9, **kw)
        _run(prefill, [mod.ServingRequest("h", system.copy(), 5)])
        for done in prefill.prefilled_done:
            decode.submit_prefilled(done["request"], done["kv"])
        decode.run_until_drained()
        out["h"] = list(decode.completed[0].output)
        results.append((out, engine.session_hits, engine.prefix_hits,
                        prefill.handoff_bytes, decode.imported_bytes))
    assert results[1] == results[0]
    assert results[1][1] == 1 and results[1][3] > 0


def test_decode_bench_runs_both_policies():
    out = ts.serving_decode_bench(tiny(ts), requests=8, arrival_ticks=3, trials=1, device="cpu")
    assert out["continuous"]["requests_completed"] == out["static"]["requests_completed"] == 8
    assert out["continuous"]["decoded_tokens"] == out["static"]["decoded_tokens"]
    assert out["continuous"]["occupancy_mean"] >= out["static"]["occupancy_mean"]
    assert out["continuous_vs_static_speedup"] > 0


def test_unset_device_never_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ts.DecodeEngine(tiny(ts))
