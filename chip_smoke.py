#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``tpu_operator_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):

1. device — CUDA must be present; prints the card's name and power limit;
2. build — compiles the CUDA kernels from the repository's sources;
3. kernels — each hand-written kernel against its plain PyTorch version
   at the shapes the main paths give it (and at the validator and timing
   shapes), with per-launch times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
   — device time from CUDA-graph replay, and eager time as a caller sees
   it — and the least time the card could take (bytes or FLOPs at peak);
   then the validator payload ``run_flash_attention_check()``;
4. burn-in — the flagship forward (``entry(use_flash_attention=True)``)
   through the triangle kernel, against the port's dense path;
5. serving — the default-geometry ``DecodeEngine`` with flash prefill
   answers 16 requests through the general kernel, with the same greedy
   tokens as dense prefill.

Launch counts are zeroed just before each main path and read just after.
The line before last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes the full
results (every shape's timings, the compiler's register report) there.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # f32 outside the tensor cores
BF16_TOL, F32_TOL, LSE_TOL = 2e-2, 1e-4, 1e-3
SOURCE = "tpu_operator_torch/kernels/flash_fwd.cu"
REPLACES = {"flash_fwd_tri": "tpu_operator/workloads/flashattention.py:301",
            "flash_fwd_rect": "tpu_operator/workloads/flashattention.py:341"}


def log(msg: str) -> None:
    print(msg, flush=True)


def _event_ms(run, calls: int, reps: int) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cuda_ms(fn, inner: int, reps: int = 7) -> float:
    """Median per-call time in ms of ``inner`` eager calls back to back,
    from CUDA events (after one warm-up call): what a caller pays,
    host-side overhead between launches included."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _event_ms(run, inner, reps)


def device_ms(fn, inner: int, reps: int = 7) -> float:
    """Median device time per call in ms: ``inner`` calls captured in one
    CUDA graph and replayed between CUDA events, so the host's overhead
    between launches drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(graph.replay, inner, reps)
    del graph
    return ms


def err(a, b) -> float:
    a, b = a.float(), b.float()
    both_inf = torch.isneginf(a) & torch.isneginf(b)
    if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
        return math.inf
    return float((torch.where(both_inf, 0.0, a) - torch.where(both_inf, 0.0, b)).abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    # the f32 parity paths must run full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> dict:
    from tpu_operator_torch.kernels import build

    start = time.perf_counter()
    built = build.build(["flash_fwd"])
    seconds = time.perf_counter() - start
    lib, _ = built["flash_fwd"]
    report = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: flash_fwd.cu for sm_90a in {seconds:.1f} s")
    return {"seconds": seconds, "ptxas": report}


def _case_inputs(case, gen):
    b, sq, h, d = case["q"]
    sk, h_kv = case.get("sk", sq), case.get("h_kv", h)
    dtype = case["dtype"]
    q = torch.randn((b * h, sq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b * h_kv, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b * h_kv, sk, d), generator=gen, device="cuda").to(dtype)
    seg = None
    if case.get("cut") is not None:
        seg = (torch.arange(sk, device="cuda") >= case["cut"]).to(torch.int32).expand(b, sk).contiguous()
    return q, k, v, seg


def _bound(case, live_pairs: int, d: int) -> tuple:
    """(bound ms, what bounds it): each input read once and each output
    written once over HBM bandwidth, against the live (q, k) pairs' two
    matmuls (4·D FLOPs per pair) at the dtype's peak."""
    b, sq, h, _ = case["q"]
    sk, h_kv = case.get("sk", sq), case.get("h_kv", h)
    item = torch.tensor([], dtype=case["dtype"]).element_size()
    nbytes = item * (2 * b * h * sq * d + 2 * b * h_kv * sk * d) + 4 * b * h * sq
    if case.get("cut") is not None:
        nbytes += 4 * b * sk
    flops = 4.0 * d * live_pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    return (t_flops, "operations") if t_flops >= t_bytes else (t_bytes, "bytes")


def _library_call(case, q, k, v, seg):
    """One F.scaled_dot_product_attention call on the same work, as a
    yardstick (never on the port's path)."""
    from tpu_operator_torch.kernels.flash_fwd import keep_mask

    b, sq, h, d = case["q"]
    sk, h_kv = case.get("sk", sq), case.get("h_kv", h)
    qs, ks, vs = (x.reshape(b, -1, x.shape[1], d) for x in (q, k, v))
    gqa = {"enable_gqa": True} if h_kv != h else {}
    if case["kernel"] == "flash_fwd_tri":
        return lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, **gqa)
    mask = keep_mask(b * h, sq, sk, h, case["causal"], case.get("q_start", 0),
                     case.get("k_start", 0), case.get("window"), seg, "cuda")
    mask = mask.reshape(b, -1, sq, sk) if mask.shape[0] > 1 else mask.reshape(1, 1, sq, sk)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, **gqa)


KERNEL_CASES = [
    # the triangle: burn-in forward shape (main path), validator, timing
    dict(kernel="flash_fwd_tri", label="burnin bf16 (8,128,4,64)", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, main=True),
    dict(kernel="flash_fwd_tri", label="validator bf16 (1,512,2,128)", q=(1, 512, 2, 128),
         dtype=torch.bfloat16),
    dict(kernel="flash_fwd_tri", label="timing bf16 (1,4096,8,128)", q=(1, 4096, 8, 128),
         dtype=torch.bfloat16, inner=2),
] + [
    # the general kernel: serving chunked prefill (main path), f32
    dict(kernel="flash_fwd_rect", label=f"serving f32 q(1,8,2,16) kv 64 q_start={qs}",
         q=(1, 8, 2, 16), sk=64, dtype=torch.float32, causal=True, q_start=qs, main=qs == 16)
    for qs in (0, 8, 16, 56)
] + [
    dict(kernel="flash_fwd_rect", label=f"bf16 (1,512,4,128) {name}", q=(1, 512, 4, 128),
         dtype=torch.bfloat16, **extra)
    for name, extra in (
        ("full", dict(causal=False)),
        ("window 128", dict(causal=True, window=128)),
        ("segments cut 288", dict(causal=True, cut=288)),
        ("gqa h_kv 2", dict(causal=True, h_kv=2)),
        ("fully masked rows (k_start 256)", dict(causal=True, k_start=256)),
    )
]


def phase_kernels() -> list:
    from tpu_operator_torch.kernels import flash_fwd
    from tpu_operator_torch.kernels.flash_fwd import attention_plain, keep_mask

    gen = torch.Generator(device="cuda").manual_seed(20260818)
    results = []
    for case in KERNEL_CASES:
        q, k, v, seg = _case_inputs(case, gen)
        b, sq, h, d = case["q"]
        h_kv = case.get("h_kv", h)
        if case["kernel"] == "flash_fwd_tri":
            def kern():
                return flash_fwd.flash_fwd_tri(q, k, v, h, h_kv)
            plain_args = dict(causal=True)
        else:
            plain_args = dict(causal=case["causal"], q_start=case.get("q_start", 0),
                              k_start=case.get("k_start", 0), window=case.get("window"), seg=seg)

            def kern():
                return flash_fwd.flash_fwd_rect(q, k, v, h, h_kv, **plain_args)

        def plain():
            return attention_plain(q, k, v, h, h_kv, **plain_args)

        out, lse = kern()
        want, want_lse = plain()
        torch.cuda.synchronize()
        o_err, lse_err = err(out, want), err(lse, want_lse)
        o_tol = BF16_TOL if case["dtype"] == torch.bfloat16 else F32_TOL
        if not (o_err <= o_tol and lse_err <= LSE_TOL):
            raise RuntimeError(f"{case['kernel']} [{case['label']}] disagrees with its plain "
                               f"version: O err {o_err} (tol {o_tol}), lse err {lse_err}")
        mask = keep_mask(b * h, sq, case.get("sk", sq), h, plain_args["causal"],
                         plain_args.get("q_start", 0), plain_args.get("k_start", 0),
                         plain_args.get("window"), plain_args.get("seg"), "cuda")
        live = int(mask.sum()) * (b * h // mask.shape[0])
        bound_ms, bound_by = _bound(case, live, d)
        inner = case.get("inner", 20)
        library = _library_call(case, q, k, v, seg)
        row = {
            "kernel": case["kernel"], "label": case["label"], "main_path": bool(case.get("main")),
            "max_abs_err": o_err, "lse_err": lse_err,
            "ms": device_ms(kern, inner), "plain_ms": device_ms(plain, inner),
            "library_ms": device_ms(library, inner),
            "eager_ms": cuda_ms(kern, inner), "eager_plain_ms": cuda_ms(plain, inner),
            "eager_library_ms": cuda_ms(library, inner),
            "bound_ms": bound_ms, "bound_by": bound_by, "live_pairs": live,
        }
        results.append(row)
        log(f"kernel {row['kernel']} [{row['label']}]: O err {o_err:.3g}, lse err {lse_err:.3g}; "
            f"device ms: kernel {row['ms']:.5f}, plain {row['plain_ms']:.5f}, "
            f"sdpa {row['library_ms']:.5f}, bound {bound_ms:.5f} by {bound_by}; eager ms: kernel "
            f"{row['eager_ms']:.4f}, plain {row['eager_plain_ms']:.4f}, "
            f"sdpa {row['eager_library_ms']:.4f}")
    from tpu_operator_torch.workloads.flashattention import run_flash_attention_check

    check = run_flash_attention_check(device="cuda")
    log(f"validator: run_flash_attention_check() max_abs_err {check['max_abs_err']:.3g}, "
        f"segments {check['segment_max_abs_err']:.3g}")
    return results


def phase_burnin() -> dict:
    from tpu_operator_torch.entry import entry
    from tpu_operator_torch.kernels import flash_fwd

    fn, (params, x) = entry(use_flash_attention=True)
    dense_fn, (dense_params, dense_x) = entry(use_flash_attention=False)
    want = dense_fn(dense_params, dense_x)
    flash_fwd.flash_fwd_tri.launches = flash_fwd.flash_fwd_rect.launches = 0
    got = fn(params, x)
    torch.cuda.synchronize()
    launches = {"flash_fwd_tri": flash_fwd.flash_fwd_tri.launches,
                "flash_fwd_rect": flash_fwd.flash_fwd_rect.launches}
    if launches["flash_fwd_tri"] == 0:
        raise RuntimeError(f"burn-in forward never launched the triangle kernel: {launches}")
    if not bool(torch.isfinite(got).all()) or got.shape != x.shape:
        raise RuntimeError(f"burn-in forward output not finite or misshapen: {tuple(got.shape)}")
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    if rel > BF16_TOL:
        raise RuntimeError(f"flash burn-in forward differs from dense by {rel} (rel. to max |out|)")
    times = {
        "forward_ms": cuda_ms(lambda: fn(params, x), inner=10),
        "dense_forward_ms": cuda_ms(lambda: dense_fn(dense_params, dense_x), inner=10),
        "forward_device_ms": device_ms(lambda: fn(params, x), inner=10),
        "dense_forward_device_ms": device_ms(lambda: dense_fn(dense_params, dense_x), inner=10),
    }
    log(f"burnin: entry(use_flash_attention=True) {tuple(got.shape)} rel err vs dense {rel:.3g}, "
        f"launches {launches}; forward ms eager {times['forward_ms']:.4f} (dense path "
        f"{times['dense_forward_ms']:.4f}), device {times['forward_device_ms']:.4f} "
        f"(dense path {times['dense_forward_device_ms']:.4f})")
    return {"rel_err_vs_dense": rel, "launches": launches, **times}


def _int8_check() -> None:
    """The decode MLP's int8 product (torch._int_mm, padded) is exact."""
    from tpu_operator_torch.workloads.serving import _int_matmul

    gen = torch.Generator().manual_seed(3)
    for m, kdim, n in ((8, 32, 64), (1, 64, 32), (40, 24, 16)):
        a = torch.randint(-127, 128, (m, kdim), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (kdim, n), generator=gen, dtype=torch.int8)
        got = _int_matmul(a.cuda(), b.cuda()).cpu()
        if not torch.equal(got, a.to(torch.int32) @ b.to(torch.int32)):
            raise RuntimeError(f"int8 matmul on the card is not exact at {(m, kdim, n)}")


def phase_serving() -> dict:
    from tpu_operator_torch.kernels import flash_fwd
    from tpu_operator_torch.workloads.serving import DecodeEngine, ServingModelConfig, make_requests

    _int8_check()
    requests = make_requests(16, seed=20260818, prompt_len=24, decode_max=32)
    runs = {}
    for flash in (False, True):
        engine = DecodeEngine(ServingModelConfig(use_flash_prefill=flash))
        engine.warmup(24)
        batch = copy.deepcopy(requests)
        flash_fwd.flash_fwd_tri.launches = flash_fwd.flash_fwd_rect.launches = 0
        for r in batch:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        runs[flash] = {
            "tokens": {r.rid: list(r.output) for r in engine.completed},
            "launches": {"flash_fwd_tri": flash_fwd.flash_fwd_tri.launches,
                         "flash_fwd_rect": flash_fwd.flash_fwd_rect.launches},
            "report": engine.report(),
        }
    flash, dense = runs[True], runs[False]
    if len(flash["tokens"]) != 16 or any(not t for t in flash["tokens"].values()):
        raise RuntimeError(f"serving answered {len(flash['tokens'])} of 16 requests")
    if flash["tokens"] != dense["tokens"]:
        raise RuntimeError("flash-prefill greedy tokens differ from dense prefill")
    if flash["launches"]["flash_fwd_rect"] == 0:
        raise RuntimeError(f"serving prefill never launched the general kernel: {flash['launches']}")
    rep = flash["report"]
    log(f"serving: 16 requests, tokens identical to dense prefill, launches {flash['launches']}, "
        f"{rep['tokens_per_s']} tok/s, ttft p50 {rep['ttft_p50_s']} s p99 {rep['ttft_p99_s']} s, "
        f"step p50 {rep.get('step_p50_s')} s p99 {rep.get('step_p99_s')} s "
        f"(dense prefill: {dense['report']['tokens_per_s']} tok/s)")
    return {"launches": flash["launches"], "report": rep, "dense_report": dense["report"]}


def kernels_line(rows: list, burnin: dict, serving: dict) -> dict:
    launches = {"flash_fwd_tri": burnin["launches"]["flash_fwd_tri"],
                "flash_fwd_rect": serving["launches"]["flash_fwd_rect"]}
    out = []
    for name in ("flash_fwd_tri", "flash_fwd_rect"):
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["main_path"])
        out.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "eager_ms": main["eager_ms"],
            "shapes": [{k: r[k] for k in ("label", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "eager_ms")} for r in mine],
        })
    return {"kernels": out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=pathlib.Path, default=None,
                        help="also write the full results as JSON to this path")
    args = parser.parse_args(argv)
    smi = phase_device()
    results = {"device": smi, "build": phase_build()}
    results["kernels"] = phase_kernels()
    results["burnin"] = phase_burnin()
    results["serving"] = phase_serving()
    line = kernels_line(results["kernels"], results["burnin"], results["serving"])
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
