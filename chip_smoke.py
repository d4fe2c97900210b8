#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``tpu_operator_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):

1. device — CUDA must be present; prints the card's name and power limit;
2. build — compiles every CUDA source of the ``KERNELS`` table
   (``flash_fwd.cu``, ``flash_bwd.cu``, ``triad.cu``) from the repository,
   one ``nvcc`` each, started together; prints each library's ptxas
   report (registers, spills) and, from ``cuobjdump --dump-sass``, the
   ``HGMMA`` (tensor-core) instructions of every bf16 instantiation of
   both forward kernels (16: the triangle's 8 and the general kernel's 8)
   and of both backward pairs (32), failing when one has none, spills
   registers, or ptxas serialized its ``wgmma`` or ignored its
   ``setmaxnreg``;
3. kernels — each hand-written kernel against its plain PyTorch version
   at the shapes the main paths give it (and at validator and timing
   shapes): the forward kernels against ``attention_plain``, the backward
   pairs (dQ and dK/dV) against ``attention_bwd_plain``, the triad against
   ``triad_plain`` bit for bit (at the HBM probe's two sizes, in place and
   not). Per launch: the kernel's device time (CUDA-graph replay) and
   eager time (as a caller sees it), the plain version's, a PyTorch call on
   the same work as a yardstick the port never calls
   (``F.scaled_dot_product_attention``; for the backward pairs its
   backward, timed as fwd+bwd less fwd; ``torch.add`` for the triad), and
   the least time the card could take (bytes or FLOPs at peak); for both
   forward kernels and both backward pairs also TFLOP/s (live pairs) and
   the ratio to SDPA, and for their bf16 rows the time at the tile height
   the launch plan did not pick; the general forward also at the packed
   train step's and the validator's packed shapes, a ring hop and a
   chunked prefill (global offsets, sq != sk), and the slice component's
   shapes (phase 9); then the validator payload
   ``run_flash_attention_check()``;
4. burn-in — the flagship forward (``entry(use_flash_attention=True)``)
   through the triangle kernel, against the port's dense path;
5. serving — the default-geometry ``DecodeEngine`` with flash prefill
   answers 16 requests through the general kernel, with the same greedy
   tokens as dense prefill;
6. train — ``run_burnin(steps=3)`` at ``entry()`` widths with flash
   attention: plain causal (the triangle pairs, 2 launches of each kernel
   per step), ``kv_heads=2`` (a GQA group inside the dK/dV kernel) and
   ``packed_segments=2`` (the general pairs). Each loss curve must fall
   and stay within bf16 tolerance of the dense path's from the same
   params (the packed one of the same run on the CPU, where attention
   takes the plain versions: the dense path has no segment ids); an f32
   gradient check of ``flash_attention`` against autograd through dense
   attention; the train step's eager and device ms;
   ``flash_attention_bench()`` (fwd and fwd+bwd at 4096 tokens against
   dense and checkpointed dense attention); and one ``flash_attention``
   fwd+bwd at (1,4096,8,128) bf16, device (CUDA graph) and eager ms;
7. self-test — the node's single-card self-test: the metrics exporter's
   ``hbm_bandwidth_probe(size_mb=64, iters=25)`` (exactly 1226 triad
   launches: 1 check, 2 warm-up chains, 6 timed pairs of 25 and 150) and
   the probe at its defaults (2451), ``run_smoke(size=512)``, the bf16 and
   int8 matmul rates at 8192 against the data-sheet peaks of the card's
   generation, the validator's ``smoke`` component with a floor every
   working card passes, and ``python -m
   tpu_operator_torch.validator.workload_entry`` in a process of its own.
   A reading above 105% of its data-sheet peak, or an unstable timing,
   fails the phase;
8. sharded — (a) the mixture of experts on the card at ``entry()``
   widths (``moe_experts=4``, flash attention): ``run_burnin(steps=3)``
   plain, ``kv_heads=2`` and ``packed_segments=2``, each curve falling
   and within bf16 tolerance of the CPU plain versions' curve from the
   same params; the forward output and every parameter's first update
   held to the CPU's (``STEP_OUT_TOL``, ``STEP_UPDATE_TOL``); 2 launches
   per step of each kernel on the path, the step's eager and device ms;
   (b) a one-rank NCCL world (``distributed.init_local_world``, a
   1x1x1x1 ``make_mesh_4d``, where every group has one rank and no
   collective runs): the MoE + GQA + packed step through the sharded
   code must give the no-mesh step's 3 losses within 1e-6 relative and
   its output and first update the CPU's, as in (a); a
   ``sequence_parallel`` step (the dense ring body, sp = 1) held the same
   way; ``run_ring_attention_check(seq_len=256)``
   with the dense and the flash body, causal and full; (c)
   ``dryrun_multichip(8, device="cpu")`` in a process of its own: eight
   gloo ranks on the CPU, since the machine has one card;
9. slice — (a) the validator's ``slice`` component in this process
   (``run_component("slice")``, a one-rank NCCL world it builds and
   leaves): ``slice-ready`` written, the all-reduce at 1, 4, 16 and 64 MiB
   (``correctness_only``: one rank copies locally, so no rate is held to
   the link), the collectives within 1e-5, the rings within 2e-4, the
   flash check within 2e-2, the pipeline ok, and exactly
   ``SLICE_LAUNCHES``; ``run_fabric_probe("1x1x1")`` (numerics, no
   edges); (b) ``COMPONENT=slice python -m
   tpu_operator_torch.validator.main`` in a process of its own, under a
   timeout (the component retries forever); (c) the gang check: one
   worker on the card (TCP rendezvous, NCCL), then 2 workers x 2 ranks
   and 2 slices x 1 host x 2 ranks on gloo (one card cannot hold two
   NCCL ranks);
10. trainer — (a) the elastic trainer (``ResumableTrainer``) at
   ``entry()`` widths with flash attention, bf16, in a temporary store:
   24 steps, a checkpoint every 5, an injected fault at 13, a resume to
   10, then to the end. ``verify_continuity`` must hold with one rewind
   and 2 lost steps, the re-executed steps must give their first run's
   losses bit for bit, and the first 3 losses stay within bf16 tolerance
   of the dense path's from the same params; with the newest checkpoint
   torn, a new trainer resumes at 20 and finishes. (b) ``JobWorkerMain``
   under ``_DictClient`` (a TPUJob of 12 steps, its slice Scheduled on
   one node): a ``grow-`` barrier acked with a checkpoint, a
   ``defrag-`` barrier that holds the generation, and a fresh main of
   the next generation that resumes there and reaches ``complete``.
   Every run launches each triangle kernel exactly twice per executed
   step (once per layer) and nothing else.

Launch counts are zeroed just before each main path and read just after.
The line before last is ``{"kernels": [...]}`` (from the ``KERNELS``
table); the last line is ``{"ok": true, "device": {...}}``. ``--json
PATH`` also writes the full results (every shape's timings, the
compiler's register report) there.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # f32 outside the tensor cores
BF16_TOL, F32_TOL, LSE_TOL = 2e-2, 1e-4, 1e-3
FLASH_REFERENCE = "tpu_operator/workloads/flashattention.py"
# wrapper (and kernel) name: (its module and CUDA source under
# tpu_operator_torch/kernels/, the file and line of the Pallas kernel it
# replaces)
KERNELS = {
    "flash_fwd_tri": ("flash_fwd", FLASH_REFERENCE, 301),
    "flash_fwd_rect": ("flash_fwd", FLASH_REFERENCE, 341),
    "flash_bwd_dq_tri": ("flash_bwd", FLASH_REFERENCE, 599),
    "flash_bwd_dkv_tri": ("flash_bwd", FLASH_REFERENCE, 657),
    "flash_bwd_dq_rect": ("flash_bwd", FLASH_REFERENCE, 434),
    "flash_bwd_dkv_rect": ("flash_bwd", FLASH_REFERENCE, 496),
    "triad_kernel": ("triad", "tpu_operator/workloads/kernels.py", 29),
}
# data-sheet HBM rate per generation key of matmul_bench.chip_generation()
# (NVIDIA H100 Tensor Core GPU data sheet), GB/s
HBM_GBPS = {"h100-sxm": 3350.0, "h100-nvl": 3900.0, "h100-pcie": 2000.0}
PEAK_MARGIN = 1.05  # a reading above peak by more than this is a timing fault


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers() -> dict:
    return {name: getattr(importlib.import_module(f"tpu_operator_torch.kernels.{module}"), name)
            for name, (module, _, _) in KERNELS.items()}


def zero_launches() -> None:
    for wrapper in wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in wrappers().items()}


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


def hgmma_counts(sass: str) -> dict:
    """HGMMA (wgmma) instructions per function of a ``cuobjdump
    --dump-sass`` listing, keyed by the function's mangled name."""
    counts, name = {}, None
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            name = header.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bHGMMA\.", line):
            counts[name] += 1
    return counts


def fwd_bf16_label(mangled: str):
    """A label for a bf16 tensor-core instantiation of a forward kernel:
    ``d<D>_wg<WG>`` for the triangle (``flash_fwd_tri_kernel<__nv_bfloat16,
    D, WG>``), ``rect_d<D>_wg<WG>`` for the general kernel
    (``flash_fwd_rect_kernel<...>``); else None."""
    found = re.search(r"flash_fwd_(tri|rect)_kernelI13__nv_bfloat16Li(\d+)ELi(\d+)E", mangled)
    if not found:
        return None
    kind, d, wg = found.groups()
    return f"{'rect_' if kind == 'rect' else ''}d{d}_wg{wg}"


def tri_bf16_label(mangled: str):
    """``d<D>_wg<WG>`` for a bf16 instantiation of the triangle forward
    (``flash_fwd_tri_kernel<__nv_bfloat16, D, WG>``), else None."""
    label = fwd_bf16_label(mangled)
    return None if label is None or label.startswith("rect_") else label


def tri_bwd_bf16_label(mangled: str):
    """A label for a bf16 tensor-core instantiation of a backward pair:
    ``dq_d<D>_wg<WG>`` or ``dkv_d<D>_wg<WG>`` for the triangle pair
    (``flash_bwd_{dq,dkv}_tri_kernel<__nv_bfloat16, D, WG>``),
    ``dq_rect_d<D>_wg<WG>`` or ``dkv_rect_d<D>_wg<WG>`` for the general
    pair (``flash_bwd_{dq,dkv}_rect_kernel<...>``); else None."""
    found = re.search(r"flash_bwd_(dq|dkv)_(tri|rect)_kernelI13__nv_bfloat16Li(\d+)ELi(\d+)E",
                      mangled)
    if not found:
        return None
    kind, pair, d, wg = found.groups()
    return f"{kind}{'_rect' if pair == 'rect' else ''}_d{d}_wg{wg}"


# library: (label of a tensor-core instantiation, how many it must have)
TENSOR_CORE_KERNELS = {
    "flash_fwd": (fwd_bf16_label, 16),      # both kernels: d 16/32/64/128 x 1/2 warpgroups
    "flash_bwd": (tri_bwd_bf16_label, 32),  # dq and dkv of both pairs, the same 8 each
}


def ptxas_by_function(report: str) -> dict:
    """Registers and spill bytes per kernel from an ``-Xptxas=-v`` report."""
    out = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None}
    return out


def phase_build() -> dict:
    from tpu_operator_torch.kernels import build

    sources = sorted({module for module, _, _ in KERNELS.values()})
    start = time.perf_counter()
    built = build.build(sources)
    seconds = time.perf_counter() - start
    reports = {}
    for name in sources:
        lib, _ = built[name]
        report = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", report)]
        log(f"  ptxas {name}.cu: {len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")
        for line in report.splitlines():
            if "wgmma" in line.lower() or "setmaxnreg" in line:
                log(f"  ptxas {name}.cu: {line.strip()}")
        reports[name] = report
    log(f"build: {', '.join(f'{n}.cu' for n in sources)} for sm_90a in {seconds:.1f} s (in parallel)")
    # the bf16 tensor-core kernels must run on the tensor cores: HGMMA in
    # every instantiation, and no register spills
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    out = {"seconds": seconds, "ptxas": reports}
    for name, (label_of, expected) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(built[name][0])],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        per_function = ptxas_by_function(reports[name])
        hgmma, ptxas = {}, {}
        for mangled, count in hgmma_counts(sass).items():
            label = label_of(mangled)
            if label is not None:
                hgmma[label] = count
                ptxas[label] = per_function.get(mangled, {})
        log(f"  {name}.cu bf16 tensor-core HGMMA per instantiation {hgmma}; ptxas {ptxas}")
        if len(hgmma) != expected or not all(hgmma.values()):
            raise RuntimeError(f"{name}.cu: a bf16 kernel is not on the tensor cores: "
                               f"HGMMA {hgmma} (expected {expected} instantiations)")
        spilled = {k: v for k, v in ptxas.items() if v.get("spill_stores") or v.get("spill_loads")}
        if spilled:
            raise RuntimeError(f"{name}.cu: bf16 tensor-core instantiations spill registers: "
                               f"{spilled}")
        # ptxas serializes wgmma when registers run short, and ignores a
        # setmaxnreg it cannot place: either undoes the design
        labelled = [m for m in per_function if label_of(m)]
        faults = [line.strip() for line in reports[name].splitlines()
                  if "setmaxnreg ignored" in line
                  or ("serialized" in line and any(m in line for m in labelled))]
        if faults:
            raise RuntimeError(f"{name}.cu: ptxas undid the tensor-core design: {faults}")
        out[f"{name}_hgmma"], out[f"{name}_tc_ptxas"] = hgmma, ptxas
    return out


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
    if case.get("packed"):
        from tpu_operator_torch.workloads.burnin import _packed_ids

        seg = _packed_ids(b, sk, case["packed"], "cuda")
    return q, k, v, seg


def _bound(case, live_pairs: int, d: int) -> tuple:
    """(bound ms, what bounds it): each input read once and each output
    written once over HBM bandwidth, against the live (q, k) pairs' two
    matmuls (4·D FLOPs per pair) at the dtype's peak."""
    b, sq, h, _ = case["q"]
    sk, h_kv = case.get("sk", sq), case.get("h_kv", h)
    item = torch.tensor([], dtype=case["dtype"]).element_size()
    nbytes = item * (2 * b * h * sq * d + 2 * b * h_kv * sk * d) + 4 * b * h * sq
    if case.get("cut") is not None or case.get("packed"):
        nbytes += 4 * b * sk
    flops = 4.0 * d * live_pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    return (t_flops, "operations") if t_flops >= t_bytes else (t_bytes, "bytes")


def _sdpa_kwargs(case, seg, tri: bool, device="cuda") -> dict:
    """Arguments of F.scaled_dot_product_attention for the case's masking:
    is_causal for the triangle's work (the triangle, or plain causal
    attention with no window, segment ids or offsets), no mask where every
    pair is live (full attention without segment ids, or a ring hop whose
    keys all lie before its rows: an explicit mask, all-true or causal,
    would send SDPA to a slower masked backend), else the kernels'
    keep_mask."""
    from tpu_operator_torch.kernels.flash_fwd import keep_mask

    b, sq, h, d = case["q"]
    sk, h_kv = case.get("sk", sq), case.get("h_kv", h)
    kwargs = {"enable_gqa": True} if h_kv != h else {}
    plain = seg is None and case.get("window") is None and sq == sk and not (
        case.get("q_start") or case.get("k_start"))
    if tri or (plain and case["causal"]):
        return dict(kwargs, is_causal=True)
    if plain:
        return kwargs
    mask = keep_mask(b * h, sq, sk, h, case["causal"], case.get("q_start", 0),
                     case.get("k_start", 0), case.get("window"), seg, device)
    if bool(mask.all()):
        return kwargs
    mask = mask.reshape(b, -1, sq, sk) if mask.shape[0] > 1 else mask.reshape(1, 1, sq, sk)
    return dict(kwargs, attn_mask=mask)


def _heads_layout(case, *tensors):
    """(B·H, S, D) rows as (B, H, S, D) views, SDPA's layout."""
    b, d = case["q"][0], case["q"][3]
    return [x.reshape(b, -1, x.shape[1], d) for x in tensors]


def _library_call(case, q, k, v, seg):
    """One F.scaled_dot_product_attention call on the same work, as a
    yardstick (never on the port's path)."""
    qs, ks, vs = _heads_layout(case, q, k, v)
    kwargs = _sdpa_kwargs(case, seg, case["kernel"] == "flash_fwd_tri")
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, **kwargs)


def _library_backward_ms(case, q, k, v, seg, dout, inner: int) -> tuple:
    """(device ms, eager ms) of F.scaled_dot_product_attention's backward
    on the same work (a yardstick, never on the port's path), as fwd+bwd
    less fwd: autograd runs a backward on its forward's stream, so the
    backward alone cannot be captured in a graph of its own."""
    qs, ks, vs = (x.detach().requires_grad_(True) for x in _heads_layout(case, q, k, v))
    (g,) = _heads_layout(case, dout)
    kwargs = _sdpa_kwargs(case, seg, case["pair"] == "tri")

    def fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, **kwargs)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qs, ks, vs), g)

    return (device_ms(fwd_bwd, inner) - device_ms(fwd, inner),
            cuda_ms(fwd_bwd, inner) - cuda_ms(fwd, inner))


def _bwd_bound(case, live_pairs: int, d: int, dq: bool) -> tuple:
    """(bound ms, what bounds it) of one backward launch: the inputs read
    once (q, dO, k, v, lse, delta, segment ids) and the outputs written once
    (dq, or dk and dv) over HBM bandwidth, against 6·D FLOPs per live (q, k)
    pair for dQ (S, dP, dQ) or 8·D for dK/dV (S, dP, dV, dK), every q head
    of a GQA group counted, at the dtype's peak."""
    b, s, h, _ = case["q"]
    h_kv = case.get("h_kv", h)
    item = torch.tensor([], dtype=case["dtype"]).element_size()
    q_side, kv_side = b * h * s * d, b * h_kv * s * d
    nbytes = item * (3 * q_side + 2 * kv_side if dq else 2 * q_side + 4 * kv_side) + 8 * b * h * s
    if case.get("cut") is not None or case.get("packed"):
        nbytes += 4 * b * s
    flops = (6.0 if dq else 8.0) * d * live_pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    return (t_flops, "operations") if t_flops >= t_bytes else (t_bytes, "bytes")


KERNEL_CASES = [
    # the triangle: burn-in forward shape (main path) and its GQA config,
    # validator, a ragged length, timing, and the f32 CUDA-core kernel
    dict(kernel="flash_fwd_tri", label="burnin bf16 (8,128,4,64)", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, main=True),
    dict(kernel="flash_fwd_tri", label="burnin gqa bf16 (8,128,4,64) h_kv 2", q=(8, 128, 4, 64),
         h_kv=2, dtype=torch.bfloat16),
    dict(kernel="flash_fwd_tri", label="validator bf16 (1,512,2,128)", q=(1, 512, 2, 128),
         dtype=torch.bfloat16),
    dict(kernel="flash_fwd_tri", label="ragged bf16 (2,1000,4,128)", q=(2, 1000, 4, 128),
         dtype=torch.bfloat16),
    dict(kernel="flash_fwd_tri", label="timing bf16 (1,4096,8,128)", q=(1, 4096, 8, 128),
         dtype=torch.bfloat16, inner=2),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,64)", q=(2, 128, 4, 64),
         dtype=torch.float32),
] + [
    # the general kernel: serving chunked prefill (main path), f32
    dict(kernel="flash_fwd_rect", label=f"serving f32 q(1,8,2,16) kv 64 q_start={qs}",
         q=(1, 8, 2, 16), sk=64, dtype=torch.float32, causal=True, q_start=qs, main=qs == 16)
    for qs in (0, 8, 16, 56)
] + [
    # bf16 on the tensor cores: the packed train step (main path), the
    # validator's packed check, then the general masks at (1,512,4,128)
    dict(kernel="flash_fwd_rect", label="burnin packed bf16 (8,128,4,64) 2 segments",
         q=(8, 128, 4, 64), dtype=torch.bfloat16, causal=True, packed=2, main=True),
    dict(kernel="flash_fwd_rect", label="validator packed bf16 (1,512,2,128) cut 320",
         q=(1, 512, 2, 128), dtype=torch.bfloat16, causal=True, cut=320),
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
] + [
    # long context (operations-bound); a ring hop (q_start = k_start + S:
    # every key lies before every row, so every tile is fast); a chunked
    # prefill (sq != sk, the causal edge on the last key tile)
    dict(kernel="flash_fwd_rect", label="timing bf16 (1,4096,8,128) full", q=(1, 4096, 8, 128),
         dtype=torch.bfloat16, causal=False, inner=2),
    dict(kernel="flash_fwd_rect", label="ring hop bf16 (1,512,4,128) q_start 512",
         q=(1, 512, 4, 128), dtype=torch.bfloat16, causal=True, q_start=512),
    dict(kernel="flash_fwd_rect", label="chunked prefill bf16 q(1,128,4,128) kv 1024 q_start 896",
         q=(1, 128, 4, 128), sk=1024, dtype=torch.bfloat16, causal=True, q_start=896),
] + [
    # the validator's slice component on one card (phase 9): the flash
    # check at seq 256 (plain and packed, cut 160) and the flash ring's
    # one hop (f32, seq 128)
    dict(kernel="flash_fwd_tri", label="slice flash check bf16 (1,256,2,128)",
         q=(1, 256, 2, 128), dtype=torch.bfloat16),
    dict(kernel="flash_fwd_tri", label="slice flash ring f32 (2,128,2,32)", q=(2, 128, 2, 32),
         dtype=torch.float32),
    dict(kernel="flash_fwd_rect", label="slice flash check packed bf16 (1,256,2,128) cut 160",
         q=(1, 256, 2, 128), dtype=torch.bfloat16, causal=True, cut=160),
]


BWD_CASES = [
    # the triangle pair: the burn-in train step (main path) and its GQA
    # config, f32, GQA at the validator width, a ragged length, long context
    dict(pair="tri", label="burnin bf16 (8,128,4,64)", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, main=True),
    dict(pair="tri", label="burnin gqa bf16 (8,128,4,64) h_kv 2", q=(8, 128, 4, 64), h_kv=2,
         dtype=torch.bfloat16),
    dict(pair="tri", label="f32 (2,128,4,64)", q=(2, 128, 4, 64), dtype=torch.float32),
    dict(pair="tri", label="gqa bf16 (1,512,4,128) h_kv 2", q=(1, 512, 4, 128), h_kv=2,
         dtype=torch.bfloat16),
    dict(pair="tri", label="ragged bf16 (2,1000,4,128)", q=(2, 1000, 4, 128),
         dtype=torch.bfloat16),
    dict(pair="tri", label="timing bf16 (1,4096,8,128)", q=(1, 4096, 8, 128),
         dtype=torch.bfloat16, inner=2),
] + [
    # the general pair: the packed burn-in train step (main path), a
    # segment boundary inside a tile, full attention, the window band
    dict(pair="rect", label="burnin packed bf16 (8,128,4,64) 2 segments", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, causal=True, packed=2, main=True),
    dict(pair="rect", label="bf16 (8,128,4,64) segments cut 88", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, causal=True, cut=88),
    dict(pair="rect", label="f32 (2,128,4,64) full", q=(2, 128, 4, 64), dtype=torch.float32,
         causal=False),
] + [
    dict(pair="rect", label=f"bf16 (1,512,4,128) {name}", q=(1, 512, 4, 128),
         dtype=torch.bfloat16, **extra)
    for name, extra in (
        ("full", dict(causal=False)),
        ("window 128", dict(causal=True, window=128)),
        ("gqa h_kv 2, window 128, segments cut 288", dict(causal=True, h_kv=2, window=128,
                                                          cut=288)),
    )
] + [
    # long context: full attention, and the triangle's own work through the
    # general pair (its time beside the triangle pair's shows what the
    # general masks cost)
    dict(pair="rect", label="timing bf16 (1,4096,8,128) full", q=(1, 4096, 8, 128),
         dtype=torch.bfloat16, causal=False, inner=2),
    dict(pair="rect", label="timing bf16 (1,4096,8,128) causal", q=(1, 4096, 8, 128),
         dtype=torch.bfloat16, causal=True, inner=2),
]


def _backward_rows(gen) -> list:
    """Each backward pair against attention_bwd_plain on the forward
    kernel's out and lse, with times; one row per kernel and case."""
    from tpu_operator_torch.kernels import flash_bwd, flash_fwd
    from tpu_operator_torch.kernels.flash_fwd import keep_mask

    rows = []
    for case in BWD_CASES:
        q, k, v, seg = _case_inputs(case, gen)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(case["dtype"])
        b, s, h, d = case["q"]
        h_kv = case.get("h_kv", h)
        tri = case["pair"] == "tri"
        causal, window = case.get("causal", True), case.get("window")
        if tri:
            out, lse = flash_fwd.flash_fwd_tri(q, k, v, h, h_kv)
        else:
            out, lse = flash_fwd.flash_fwd_rect(q, k, v, h, h_kv, causal, window=window, seg=seg)
        delta = (dout.float() * out.float()).sum(-1)
        extra = () if tri else (causal, window, seg)
        dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{case['pair']}")
        dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{case['pair']}")

        def dq():
            return dq_fn(q, k, v, out, dout, lse, delta, h, h_kv, *extra)

        def dkv():
            return dkv_fn(q, k, v, out, dout, lse, delta, h, h_kv, *extra)

        def plain():
            return flash_bwd.attention_bwd_plain(q, k, v, out, lse, dout, h, h_kv, causal,
                                                 window, seg)

        want = plain()
        got = (dq(), *dkv())
        torch.cuda.synchronize()
        errs = [err(w, g) for w, g in zip(want, got)]
        scale = max(float(w.float().abs().max()) for w in want)
        ok = (max(errs) <= F32_TOL if case["dtype"] == torch.float32
              else max(errs) <= BF16_TOL * scale)
        if not ok:
            raise RuntimeError(f"backward pair [{case['label']}] disagrees with "
                               f"attention_bwd_plain: dq/dk/dv err {errs}, max |grad| {scale}")
        mask = keep_mask(b * h, s, s, h, causal, window=window, seg=seg, device="cuda")
        live = int(mask.sum()) * (b * h // mask.shape[0])
        inner = case.get("inner", 20)
        plain_ms = device_ms(plain, inner)
        library_ms, eager_library_ms = _library_backward_ms(case, q, k, v, seg, dout, inner)
        pair = []
        for fn, kernel_errs, is_dq in ((dq, errs[:1], True), (dkv, errs[1:], False)):
            bound_ms, bound_by = _bwd_bound(case, live, d, is_dq)
            pair.append({
                "kernel": (dq_fn if is_dq else dkv_fn).__name__, "label": case["label"],
                "main_path": bool(case.get("main")), "max_abs_err": max(kernel_errs),
                "rel_err": max(kernel_errs) / scale, "ms": device_ms(fn, inner),
                "plain_ms": plain_ms, "library_ms": library_ms, "eager_ms": cuda_ms(fn, inner),
                "eager_library_ms": eager_library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "live_pairs": live,
            })
        pair_ms = pair[0]["ms"] + pair[1]["ms"]
        # 14·D FLOPs per live pair: S, dP, dQ (6·D) and S, dP, dV, dK (8·D)
        stats = {"pair_tflops": 14.0 * d * live / pair_ms / 1e9,
                 "pair_ratio_to_library": pair_ms / library_ms}
        rate = (f", {stats['pair_tflops']:.1f} TFLOP/s, {stats['pair_ratio_to_library']:.2f}x "
                f"sdpa backward")
        if case["dtype"] == torch.bfloat16:
            stats.update(_other_bwd_plans(case["pair"], q, k, v, dout, lse, delta, h, h_kv,
                                          extra, want, scale, inner))
            rate += (f", dq/dkv blocks {stats['blocks']} (at {stats['other_blocks']}: dq "
                     f"{stats['other_dq_ms']:.5f}, dkv {stats['other_dkv_ms']:.5f} ms)")
        for row in pair:
            row.update(stats, pair_ms=pair_ms)
        rows += pair
        log(f"backward {case['pair']} [{case['label']}]: dq/dk/dv err {errs[0]:.3g}/{errs[1]:.3g}/"
            f"{errs[2]:.3g} (max |grad| {scale:.3g}); device ms: dq {pair[0]['ms']:.5f} (bound "
            f"{pair[0]['bound_ms']:.5f} by {pair[0]['bound_by']}), dkv {pair[1]['ms']:.5f} (bound "
            f"{pair[1]['bound_ms']:.5f} by {pair[1]['bound_by']}), pair {pair_ms:.5f}, plain "
            f"{plain_ms:.5f}, sdpa backward {library_ms:.5f}{rate}; eager ms: dq "
            f"{pair[0]['eager_ms']:.4f}, dkv {pair[1]['eager_ms']:.4f}, sdpa backward "
            f"{eager_library_ms:.4f}")
    return rows


def _other_bwd_plans(pair: str, q, k, v, dout, lse, delta, h: int, h_kv: int, extra: tuple,
                     want, scale: float, inner: int) -> dict:
    """A bf16 pair ("tri" or "rect", whose masks ``extra`` = (causal,
    window, seg) holds) launched with the tile heights its plan did not
    pick (a plan for a card with 1 SM takes 128, one with very many takes
    64), straight through the library (no launch is counted), held to the
    same tolerance, and timed: what the plan's choice is worth."""
    from tpu_operator_torch.kernels import flash_bwd

    bh, s, d = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plans(sms):
        if pair == "tri":
            return flash_bwd.tri_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms)
        return flash_bwd.rect_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, *extra[:2])

    picked = plans(sms)
    other = [plans(1 if mine.block == 64 else 10**9)[i] for i, mine in enumerate(picked)]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = flash_bwd._lib()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    seg = () if pair == "tri" else (None if extra[2] is None else extra[2].data_ptr(),)
    masks = () if pair == "tri" else (int(extra[0]), 0 if extra[1] is None else int(extra[1]))
    scales = (flash_bwd.LOG2E / math.sqrt(d), 1.0 / math.sqrt(d))

    def run(kernel: str, outputs, rows: int, plan):
        # on the current stream, which a graph capture switches
        code = getattr(lib, f"flash_bwd_{kernel}_{pair}")(
            *common, *seg, *outputs, 1, rows, s, d, h, h_kv, *masks, *scales, plan.block,
            plan.smem_bytes, plan.swizzle, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"flash_bwd_{kernel}_{pair} at block {plan.block}: error {code}")

    def run_dq():
        run("dq", (dq.data_ptr(),), bh, other[0])

    def run_dkv():
        run("dkv", (dk.data_ptr(), dv.data_ptr()), k.shape[0], other[1])

    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    errs = [err(w, g) for w, g in zip(want, (dq, dk, dv))]
    if not max(errs) <= BF16_TOL * scale:
        raise RuntimeError(f"the bf16 {pair} pair at blocks {[p.block for p in other]} "
                           f"disagrees: dq/dk/dv err {errs}, max |grad| {scale}")
    return {"blocks": [p.block for p in picked], "other_blocks": [p.block for p in other],
            "other_dq_ms": device_ms(run_dq, inner), "other_dkv_ms": device_ms(run_dkv, inner),
            "other_max_abs_err": max(errs)}


TRIAD_ALPHA = 0.3  # not a power of two, so every product rounds
TRIAD_CASES = [
    # the metrics exporter's probe (main path), the probe's default size
    dict(label="exporter probe f32 (16384, 1024) in place", shape=(16384, 1024), inplace=True,
         main=True),
    dict(label="default probe f32 (32768, 1024) in place", shape=(32768, 1024), inplace=True),
    dict(label="default probe f32 (32768, 1024) non-aliased", shape=(32768, 1024), inplace=False),
]


def _triad_rows(gen) -> list:
    """The triad kernel against triad_plain, bit for bit, with times; the
    bound is its three streams (x and y read, out written) over HBM."""
    from tpu_operator_torch.kernels.triad import triad_kernel, triad_plain

    rows = []
    for case in TRIAD_CASES:
        x = torch.randn(case["shape"], generator=gen, device="cuda")
        y = torch.randn(case["shape"], generator=gen, device="cuda")
        want = triad_plain(x, y, TRIAD_ALPHA)
        dst = x.clone() if case["inplace"] else torch.empty_like(x)
        got = triad_kernel(dst if case["inplace"] else x, y, TRIAD_ALPHA, dst)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if differ:
            raise RuntimeError(f"triad_kernel [{case['label']}] differs from triad_plain in "
                               f"{differ} elements (max abs {err(got, want)})")
        out = x if case["inplace"] else torch.empty_like(x)

        def kern():
            return triad_kernel(x, y, TRIAD_ALPHA, out)

        def plain():
            return triad_plain(x, y, TRIAD_ALPHA, out)

        def library():
            return torch.add(y, x, alpha=TRIAD_ALPHA, out=out)

        nbytes = 3 * 4 * x.numel()
        row = {
            "kernel": "triad_kernel", "label": case["label"], "main_path": bool(case.get("main")),
            "max_abs_err": 0.0, "bitwise_equal": True,
            "ms": device_ms(kern, 20), "plain_ms": device_ms(plain, 20),
            "library_ms": device_ms(library, 20), "eager_ms": cuda_ms(kern, 20),
            "eager_library_ms": cuda_ms(library, 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes,
        }
        row["gbps"] = nbytes / row["ms"] / 1e6
        rows.append(row)
        log(f"kernel triad_kernel [{case['label']}]: bitwise equal to triad_plain; device ms: "
            f"kernel {row['ms']:.5f} ({row['gbps']:.1f} GB/s), plain {row['plain_ms']:.5f}, "
            f"torch.add {row['library_ms']:.5f}, bound {row['bound_ms']:.5f} by bytes; eager ms: "
            f"kernel {row['eager_ms']:.5f}, torch.add {row['eager_library_ms']:.5f}")
    return rows


def _other_tile_height(case, q, k, v, h: int, h_kv: int, masks: dict, want, want_lse,
                       inner: int) -> dict:
    """A bf16 forward kernel (``case["kernel"]``; the general one with the
    ``masks`` of attention_plain) launched with the q-tile height its plan
    did not pick (a plan for a card with 1 SM takes 128 rows, one with very
    many takes 64), straight through the library (no launch is counted),
    held to the same tolerances, and timed: what the plan's choice is
    worth."""
    from tpu_operator_torch.kernels import flash_fwd

    bh, sq, d = q.shape
    sk = k.shape[1]
    tri = case["kernel"] == "flash_fwd_tri"

    def plan_for(sms):
        if tri:
            return flash_fwd.tri_plan(q.dtype, bh, sq, d, sms)
        return flash_fwd.rect_plan(q.dtype, bh, sq, sk, d, sms, masks["causal"],
                                   masks["window"], masks["q_start"], masks["k_start"])

    picked = plan_for(torch.cuda.get_device_properties(0).multi_processor_count).block_m
    plan = plan_for(1 if picked == 64 else 10**9)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device="cuda")
    lib = flash_fwd._lib()
    qscale = flash_fwd.LOG2E / math.sqrt(d)
    seg = None if tri or masks["seg"] is None else masks["seg"].data_ptr()

    def run():
        # on the current stream, which a graph capture switches
        stream = torch.cuda.current_stream().cuda_stream
        if tri:
            code = lib.flash_fwd_tri(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     lse.data_ptr(), 1, bh, sq, d, h, h_kv, qscale, plan.block_m,
                                     plan.smem_bytes, plan.swizzle, stream)
        else:
            code = lib.flash_fwd_rect(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, out.data_ptr(), lse.data_ptr(), 1,
                bh, sq, sk, d, h, h_kv, int(masks["causal"]), masks["q_start"],
                masks["k_start"], masks["window"] or 0, qscale, plan.block_m, plan.smem_bytes,
                plan.swizzle, stream)
        if code != 0:
            raise RuntimeError(f"{case['kernel']} at block_m {plan.block_m}: error {code}")

    run()
    torch.cuda.synchronize()
    o_err, lse_err = err(out, want), err(lse, want_lse)
    if not (o_err <= BF16_TOL and lse_err <= LSE_TOL):
        raise RuntimeError(f"{case['kernel']} [{case['label']}] at block_m {plan.block_m} "
                           f"disagrees: O err {o_err}, lse err {lse_err}")
    return {"block_m": picked, "other_block_m": plan.block_m, "other_ms": device_ms(run, inner),
            "other_max_abs_err": o_err}


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
            plain_args = dict(causal=True, q_start=0, k_start=0, window=None, seg=None)
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
        mask = keep_mask(b * h, sq, case.get("sk", sq), h, **plain_args, device="cuda")
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
        row["tflops"] = 4.0 * d * live / row["ms"] / 1e9
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        rate = f", {row['tflops']:.1f} TFLOP/s, {row['ratio_to_library']:.2f}x sdpa"
        if case["dtype"] == torch.bfloat16:
            row.update(_other_tile_height(case, q, k, v, h, h_kv, plain_args, want, want_lse,
                                          inner))
            rate += (f", {row['block_m']}-row q tiles (at {row['other_block_m']} rows: "
                     f"{row['other_ms']:.5f} ms)")
        results.append(row)
        log(f"kernel {row['kernel']} [{row['label']}]: O err {o_err:.3g}, lse err {lse_err:.3g}; "
            f"device ms: kernel {row['ms']:.5f}, plain {row['plain_ms']:.5f}, "
            f"sdpa {row['library_ms']:.5f}, bound {bound_ms:.5f} by {bound_by}{rate}; eager ms: "
            f"kernel {row['eager_ms']:.4f}, plain {row['eager_plain_ms']:.4f}, "
            f"sdpa {row['eager_library_ms']:.4f}")
    results += _backward_rows(gen)
    results += _triad_rows(gen)
    from tpu_operator_torch.workloads.flashattention import run_flash_attention_check

    check = run_flash_attention_check(device="cuda")
    log(f"validator: run_flash_attention_check() max_abs_err {check['max_abs_err']:.3g}, "
        f"segments {check['segment_max_abs_err']:.3g}")
    return results


def phase_burnin() -> dict:
    from tpu_operator_torch.entry import entry

    fn, (params, x) = entry(use_flash_attention=True)
    dense_fn, (dense_params, dense_x) = entry(use_flash_attention=False)
    want = dense_fn(dense_params, dense_x)
    zero_launches()
    got = fn(params, x)
    torch.cuda.synchronize()
    launches = read_launches()
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
    from tpu_operator_torch.workloads.serving import DecodeEngine, ServingModelConfig, make_requests

    _int8_check()
    requests = make_requests(16, seed=20260818, prompt_len=24, decode_max=32)
    runs = {}
    for flash in (False, True):
        engine = DecodeEngine(ServingModelConfig(use_flash_prefill=flash))
        engine.warmup(24)
        batch = copy.deepcopy(requests)
        zero_launches()
        for r in batch:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        runs[flash] = {
            "tokens": {r.rid: list(r.output) for r in engine.completed},
            "launches": read_launches(),
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


TRAIN_CONFIGS = {"plain": {}, "gqa": {"kv_heads": 2}, "packed": {"packed_segments": 2}}


def _flash_grad_check() -> float:
    """autograd through flash_attention against autograd through dense
    attention, f32, (1, 256, 2, 64): the reference's gradient test."""
    from tpu_operator_torch.workloads.flashattention import flash_attention
    from tpu_operator_torch.workloads.ringattention import dense_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, w = (torch.randn((1, 256, 2, 64), generator=gen, device="cuda") for _ in range(4))
    grads = {}
    for name, attn in (("flash", flash_attention), ("dense", dense_attention)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        grads[name] = torch.autograd.grad((attn(*leaves, causal=True) * w).sum(), leaves)
    worst = max(float((f - d).abs().max()) for f, d in zip(grads["flash"], grads["dense"]))
    if not worst <= F32_TOL:
        raise RuntimeError(f"f32 flash gradients differ from dense by {worst} (tol {F32_TOL})")
    return worst


def phase_train() -> dict:
    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.workloads.burnin import build_train_step, run_burnin
    from tpu_operator_torch.workloads.flashattention import flash_attention_bench

    out = {"paths": {}, "configs": {}}
    for name, over in TRAIN_CONFIGS.items():
        cfg = dataclasses.replace(ENTRY_CONFIG, use_flash_attention=True, **over)
        steps = 3
        zero_launches()
        got = run_burnin(steps=steps, cfg=cfg, record_telemetry=True, device="cuda")
        torch.cuda.synchronize()
        counts = read_launches()
        pair = "rect" if cfg.packed_segments else "tri"
        on_path = {f"flash_fwd_{pair}", f"flash_bwd_dq_{pair}", f"flash_bwd_dkv_{pair}"}
        # each kernel of the pair once per layer and step, no other kernel
        expected = {k: cfg.n_layers * steps if k in on_path else 0 for k in counts}
        if counts != expected:
            raise RuntimeError(f"train {name}: launches {counts}, expected {expected}")
        if cfg.packed_segments:
            ref_name, ref = "CPU plain versions", run_burnin(steps=steps, cfg=cfg, device="cpu")
        else:
            ref_name = "dense path"
            ref = run_burnin(steps=steps, cfg=dataclasses.replace(cfg, use_flash_attention=False),
                             device="cuda")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        if not rel <= BF16_TOL:
            raise RuntimeError(f"train {name}: losses {got['losses']} differ from the {ref_name}'s "
                               f"{ref['losses']} by {rel} (relative, tol {BF16_TOL})")
        step, params, batch = build_train_step(cfg, "cuda")
        times = {"step_ms": cuda_ms(lambda: step(params, batch), inner=10),
                 "step_device_ms": device_ms(lambda: step(params, batch), inner=10)}
        if name == "plain":
            dense_step, dense_params, dense_batch = build_train_step(
                dataclasses.replace(cfg, use_flash_attention=False), "cuda")
            times["dense_step_ms"] = cuda_ms(lambda: dense_step(dense_params, dense_batch), inner=10)
            times["dense_step_device_ms"] = device_ms(
                lambda: dense_step(dense_params, dense_batch), inner=10)
        out["paths"][f"train {name}"] = counts
        out["configs"][name] = {"losses": got["losses"], "reference": ref_name,
                                "reference_losses": ref["losses"], "rel_err": rel,
                                "telemetry": got["telemetry"], **times}
        per_step = {k: v / steps for k, v in counts.items() if v}
        log(f"train {name}: run_burnin(steps={steps}) losses {[round(x, 5) for x in got['losses']]}, "
            f"{ref_name} {[round(x, 5) for x in ref['losses']]} (rel err {rel:.3g}); launches per "
            f"step {per_step}; step ms eager {times['step_ms']:.4f}, device "
            f"{times['step_device_ms']:.4f}"
            + (f" (dense path: eager {times['dense_step_ms']:.4f}, device "
               f"{times['dense_step_device_ms']:.4f})" if name == "plain" else ""))
    out["grad_check_max_abs_err"] = _flash_grad_check()
    log(f"train: f32 flash_attention gradients vs dense, max abs err "
        f"{out['grad_check_max_abs_err']:.3g}")
    bench = flash_attention_bench(device="cuda")
    out["flash_attention_bench"] = bench
    log("train: flash_attention_bench() " + ", ".join(
        f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}" for k, v in bench.items()))
    out["flash_fwd_bwd_4096"] = _flash_fwd_bwd_ms()
    log(f"train: one flash_attention fwd+bwd at (1,4096,8,128) bf16: device ms "
        f"{out['flash_fwd_bwd_4096']['device_ms']:.5f}, eager ms "
        f"{out['flash_fwd_bwd_4096']['eager_ms']:.5f}")
    return out


def _flash_fwd_bwd_ms() -> dict:
    """Device and eager ms of one autograd fwd+bwd through flash_attention
    at the bench's shape, (1,4096,8,128) bf16: the kernels, the head
    collapse copies and delta, without the host's launch overhead (device)
    and with it (eager). The forward is captured with the backward: autograd
    runs a backward on its forward's stream."""
    from tpu_operator_torch.workloads.flashattention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, g = (torch.randn((1, 4096, 8, 128), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))

    def fwd_bwd():
        return torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), g)

    return {"device_ms": device_ms(fwd_bwd, 5), "eager_ms": cuda_ms(fwd_bwd, 5)}


def _hold_to_peak(report: dict, keys: tuple, peak: float, what: str) -> None:
    """A rate above PEAK_MARGIN of its data-sheet peak, or a timing whose
    median slope was not positive, is a timing fault."""
    if report.get("unstable_timing"):
        raise RuntimeError(f"{what}: unstable timing: {report}")
    for key in keys:
        if not 0 < report[key] <= PEAK_MARGIN * peak:
            raise RuntimeError(f"{what}: {key} {report[key]} outside (0, {PEAK_MARGIN} x the "
                               f"data-sheet peak {peak}]: {report}")


def _int_mm_layouts(size: int) -> dict:
    """Device ms of one torch._int_mm (size³, int8) with its second operand
    row-major and column-major: the int8 chain keeps it column-major."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    a, b = (torch.randint(-4, 5, (size, size), generator=gen, device="cuda", dtype=torch.int8)
            for _ in range(2))
    col = b.t().contiguous().t()
    if not torch.equal(torch._int_mm(a, b), torch._int_mm(a, col)):
        raise RuntimeError("torch._int_mm differs between the layouts of its second operand")
    return {"row-major": device_ms(lambda: torch._int_mm(a, b), 5),
            "column-major": device_ms(lambda: torch._int_mm(a, col), 5)}


PROBES = {
    # path name: (hbm_bandwidth_probe arguments, triad launches: the check,
    # then a warm-up chain of each length and `reps` timed pairs)
    "self-test exporter probe": (dict(size_mb=64, iters=25), 1 + 7 * (25 + 150)),
    "self-test default probe": ({}, 1 + 7 * (50 + 300)),
}


def phase_selftest() -> dict:
    from tpu_operator_torch.validator.main import Context, run_component
    from tpu_operator_torch.workloads import matmul_bench
    from tpu_operator_torch.workloads.kernels import hbm_bandwidth_probe
    from tpu_operator_torch.workloads.smoke import run_smoke

    gen = matmul_bench.chip_generation()
    if not gen:
        raise RuntimeError(f"{torch.cuda.get_device_name()} is not a card with data-sheet peaks "
                           f"here ({sorted(HBM_GBPS)})")
    out = {"generation": gen, "paths": {}}
    for path, (kwargs, launches) in PROBES.items():
        zero_launches()
        report = hbm_bandwidth_probe(**kwargs)
        torch.cuda.synchronize()
        counts = read_launches()
        expected = {k: launches if k == "triad_kernel" else 0 for k in counts}
        if counts != expected:
            raise RuntimeError(f"{path}: launches {counts}, expected {expected}")
        _hold_to_peak(report, ("bandwidth_gbps", "inclusive_gbps"), HBM_GBPS[gen], path)
        out["paths"][path] = counts
        out[path] = report
        log(f"{path}: hbm_bandwidth_probe({', '.join(f'{k}={v}' for k, v in kwargs.items())}) "
            f"{report['kernel']} {report['size_mb']} MiB: {report['bandwidth_gbps']:.1f} GB/s "
            f"({100 * report['bandwidth_gbps'] / HBM_GBPS[gen]:.1f}% of {HBM_GBPS[gen]}), "
            f"inclusive {report['inclusive_gbps']:.1f}, {report['time_ms']:.5f} ms per triad, "
            f"overhead per call {report['dispatch_overhead_ms_est']:.3f} ms; launches {launches}")

    smoke = run_smoke(size=512)
    if not smoke["ok"] or smoke["device_count"] != torch.cuda.device_count():
        raise RuntimeError(f"run_smoke: {smoke}")
    out["smoke"] = smoke
    mm = matmul_bench.matmul_tflops(size=8192, iters=16)
    _hold_to_peak(mm, ("tflops", "inclusive_tflops"), matmul_bench.PEAK_TFLOPS[gen], "bf16 matmul")
    i8 = matmul_bench.int8_matmul_tops(size=8192, iters=16)
    _hold_to_peak(i8, ("tops", "inclusive_tops"), matmul_bench.PEAK_INT8_TOPS[gen], "int8 matmul")
    out["matmul_tflops"], out["int8_matmul_tops"] = mm, i8
    out["int_mm_layout_ms"] = _int_mm_layouts(8192)
    log(f"self-test: run_smoke(size=512) on {smoke['devices']}; {gen}: bf16 matmul 8192 "
        f"{mm['tflops']:.1f} TFLOP/s ({100 * mm['tflops'] / matmul_bench.PEAK_TFLOPS[gen]:.1f}% "
        f"of {matmul_bench.PEAK_TFLOPS[gen]}), int8 {i8['tops']:.1f} TOP/s "
        f"({100 * i8['tops'] / matmul_bench.PEAK_INT8_TOPS[gen]:.1f}% of "
        f"{matmul_bench.PEAK_INT8_TOPS[gen]}); one torch._int_mm at 8192 with its second "
        f"operand row-major {out['int_mm_layout_ms']['row-major']:.4f} ms, column-major "
        f"{out['int_mm_layout_ms']['column-major']:.4f} ms")

    with tempfile.TemporaryDirectory() as tmp:
        component = run_component("smoke", Context(min_tflops=1.0, validation_dir=tmp),
                                  max_attempts=1)
    _hold_to_peak(component, ("matmul_bf16_tflops",), matmul_bench.PEAK_TFLOPS[gen],
                  "validator smoke")
    out["validator_smoke"] = component
    entry = subprocess.run([sys.executable, "-m", "tpu_operator_torch.validator.workload_entry"],
                           cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
                           text=True, timeout=300)
    lines = entry.stdout.strip().splitlines()
    if entry.returncode != 0 or not lines or json.loads(lines[-1]).get("ok") is not True:
        raise RuntimeError(f"workload_entry exited {entry.returncode}: {entry.stdout[-2000:]}"
                           f"{entry.stderr[-2000:]}")
    out["workload_entry"] = json.loads(lines[-1])
    log(f"self-test: validator smoke component {component['matmul_bf16_tflops']} TFLOP/s "
        f"(floor 1.0) per card {component['matmul_bf16_tflops_per_chip']}; workload_entry "
        f"{lines[-1]}")
    return out


MOE_CONFIGS = {"plain": {}, "gqa": {"kv_heads": 2}, "packed": {"packed_segments": 2}}
MESH_REL_TOL = 1e-6  # the sharded code on a one-rank mesh adds no arithmetic
# the card's step against the CPU's plain versions from the same seeded
# params and batch, bf16: the forward output and every parameter's first
# SGD update, each as the norm of the difference over the norm of the
# CPU's. The loss of this RMS-normalised output against an N(0, 1) target
# is ~2.0 for any output, so the losses alone cannot tell a wrong path
# from a right one. Norms, not largest errors: a token whose top two
# gates nearly tie may pick another expert on the card. The bars stand
# ~2.5x above the gaps measured on the H100 and well below those of a
# broken step (PERF.md section 2).
STEP_OUT_TOL, STEP_UPDATE_TOL = 0.05, 0.25


def _expected_launches(counts: dict, cfg, steps: int) -> dict:
    """Each kernel of the step's flash pair once per layer and step, no other."""
    pair = "rect" if cfg.packed_segments else "tri"
    on_path = {f"flash_fwd_{pair}", f"flash_bwd_dq_{pair}", f"flash_bwd_dkv_{pair}"}
    return {k: cfg.n_layers * steps if k in on_path else 0 for k in counts}


def _curve_rel(got: list, ref: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, ref))


def _step_losses(step, params, batch, steps: int) -> list:
    losses = []
    for _ in range(steps):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return losses


def _first_step(cfg, device: str, mesh=None) -> tuple:
    """The seeded step's forward output and each parameter's first SGD
    update, float32 on the CPU."""
    from tpu_operator_torch.workloads.burnin import build_train_step, forward

    step, params, batch = build_train_step(cfg, device, mesh=mesh)
    with torch.no_grad():
        out = forward(params, batch[0], cfg, mesh)
    new, _ = step(params, batch)
    return out.float().cpu(), {k: (new[k] - params[k]).float().cpu() for k in params}


def _step_gaps(name: str, got: tuple, ref: tuple) -> dict:
    """Holds ``got`` (a ``_first_step``) to ``ref`` within STEP_OUT_TOL and
    STEP_UPDATE_TOL; returns the gaps."""
    (out, upd), (ref_out, ref_upd) = got, ref
    out_rel = float((out - ref_out).norm() / ref_out.norm())
    upd_rel = {k: float((upd[k] - ref_upd[k]).norm() / ref_upd[k].norm()) for k in ref_upd}
    worst = max(upd_rel, key=upd_rel.get)
    if not (out_rel <= STEP_OUT_TOL and upd_rel[worst] <= STEP_UPDATE_TOL):
        raise RuntimeError(f"{name}: output {out_rel} (tol {STEP_OUT_TOL}), update of {worst} "
                           f"{upd_rel[worst]} (tol {STEP_UPDATE_TOL}) from the CPU's; every "
                           f"update: {upd_rel}")
    return {"out_rel": out_rel, "update_rel": upd_rel[worst], "update_rel_worst": worst,
            "update_rel_by_param": upd_rel}


def _moe_on_one_card(out: dict) -> None:
    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.workloads.burnin import build_train_step, run_burnin

    steps = 3
    for name, over in MOE_CONFIGS.items():
        cfg = dataclasses.replace(ENTRY_CONFIG, use_flash_attention=True, moe_experts=4, **over)
        zero_launches()
        got = run_burnin(steps=steps, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        counts = read_launches()
        expected = _expected_launches(counts, cfg, steps)
        if counts != expected:
            raise RuntimeError(f"moe {name}: launches {counts}, expected {expected}")
        ref = run_burnin(steps=steps, cfg=cfg, device="cpu")
        rel = _curve_rel(got["losses"], ref["losses"])
        if not rel <= BF16_TOL:
            raise RuntimeError(f"moe {name}: losses {got['losses']} differ from the CPU plain "
                               f"versions' {ref['losses']} by {rel} (relative, tol {BF16_TOL})")
        reference = _first_step(cfg, "cpu")
        gaps = _step_gaps(f"moe {name}", _first_step(cfg, "cuda"), reference)
        step, params, batch = build_train_step(cfg, "cuda")
        times = {"step_ms": cuda_ms(lambda: step(params, batch), inner=10),
                 "step_device_ms": device_ms(lambda: step(params, batch), inner=10)}
        out["paths"][f"moe {name}"] = counts
        out["moe"][name] = {"losses": got["losses"], "reference": "CPU plain versions",
                            "reference_losses": ref["losses"], "rel_err": rel, **gaps, **times}
        log(f"sharded: moe {name} run_burnin(steps={steps}) losses "
            f"{[round(x, 5) for x in got['losses']]}, CPU plain versions "
            f"{[round(x, 5) for x in ref['losses']]} (rel err {rel:.3g}); output {gaps['out_rel']:.3g}"
            f", worst update {gaps['update_rel']:.3g} ({gaps['update_rel_worst']}) from the CPU's; "
            f"launches per step {({k: v / steps for k, v in counts.items() if v})}; step ms eager "
            f"{times['step_ms']:.4f}, device {times['step_device_ms']:.4f}")


def _one_rank_world(out: dict) -> None:
    import torch.distributed as dist

    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.workloads.burnin import build_train_step, make_mesh_4d
    from tpu_operator_torch.workloads.distributed import init_local_world
    from tpu_operator_torch.workloads.ringattention import run_ring_attention_check

    steps = 3
    # the packed MoE configuration of _moe_on_one_card, with GQA
    cfg = dataclasses.replace(ENTRY_CONFIG, use_flash_attention=True, moe_experts=4, kv_heads=2,
                              packed_segments=2)
    reference = _first_step(cfg, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        init_local_world(0, 1, os.path.join(tmp, "store"), "cuda")
        try:
            mesh = make_mesh_4d(data=1, sp=1, model=1, ep=1)
            plain_step, plain_params, plain_batch = build_train_step(cfg, "cuda")
            step, params, batch = build_train_step(cfg, "cuda", mesh=mesh)
            zero_launches()
            sharded = _step_losses(step, params, batch, steps)
            torch.cuda.synchronize()
            counts = read_launches()
            expected = _expected_launches(counts, cfg, steps)
            if counts != expected:
                raise RuntimeError(f"one-rank mesh: launches {counts}, expected {expected}")
            plain = _step_losses(plain_step, plain_params, plain_batch, steps)
            rel = _curve_rel(sharded, plain)
            if not rel <= MESH_REL_TOL:
                raise RuntimeError(f"one-rank mesh: losses {sharded} differ from the no-mesh "
                                   f"step's {plain} by {rel} (relative, tol {MESH_REL_TOL})")
            mesh_gaps = _step_gaps("one-rank mesh", _first_step(cfg, "cuda", mesh), reference)
            mesh_ms = cuda_ms(lambda: step(params, batch), inner=10)
            ring_cfg = dataclasses.replace(cfg, use_flash_attention=False, sequence_parallel=True)
            ring = _step_losses(*build_train_step(ring_cfg, "cuda", mesh=mesh), steps)
            ring_rel = _curve_rel(ring, plain)
            if not (ring_rel <= BF16_TOL and ring[-1] < ring[0]):
                raise RuntimeError(f"one-rank ring step: losses {ring} against the flash step's "
                                   f"{plain} (rel {ring_rel}, tol {BF16_TOL})")
            ring_gaps = _step_gaps("one-rank ring step", _first_step(ring_cfg, "cuda", mesh),
                                   reference)
            checks = {}
            for impl in ("dense", "flash"):
                zero_launches()
                for causal in (True, False):
                    checks[f"{impl} {'causal' if causal else 'full'}"] = run_ring_attention_check(
                        seq_len=256, causal=causal, local_impl=impl)
                torch.cuda.synchronize()
                if impl == "flash":
                    out["paths"]["ring check flash"] = read_launches()
            flash_counts = out["paths"]["ring check flash"]
            if not (flash_counts["flash_fwd_tri"] == 1 and flash_counts["flash_fwd_rect"] == 1):
                raise RuntimeError(f"ring flash check launches {flash_counts}: expected the "
                                   f"triangle (causal) and the general kernel (full) once each")
        finally:
            dist.destroy_process_group()
    out["paths"]["one-rank mesh moe gqa packed"] = counts
    out["one_rank"] = {"losses": sharded, "no_mesh_losses": plain, "rel_err": rel,
                       "step_ms": mesh_ms, "gaps": mesh_gaps, "ring_losses": ring,
                       "ring_rel_err": ring_rel, "ring_gaps": ring_gaps, "ring_checks": checks}
    log(f"sharded: one-rank NCCL mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} (no "
        f"collective runs on one rank): MoE + GQA + packed losses {sharded} vs no mesh {plain} "
        f"(rel {rel:.3g}); output {mesh_gaps['out_rel']:.3g}, worst update "
        f"{mesh_gaps['update_rel']:.3g} ({mesh_gaps['update_rel_worst']}) from the CPU's; launches "
        f"{counts}, eager step ms {mesh_ms:.4f}; ring step (sp=1) {[round(x, 5) for x in ring]} "
        f"(rel {ring_rel:.3g}; output {ring_gaps['out_rel']:.3g}, worst update "
        f"{ring_gaps['update_rel']:.3g} ({ring_gaps['update_rel_worst']})); ring checks "
        + ", ".join(
            f"{k} {v['max_abs_err']:.3g}" for k, v in checks.items()))


def _dryrun_on_cpu(out: dict) -> None:
    code = "from tpu_operator_torch.entry import dryrun_multichip as d; d(8, device='cpu')"
    start = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=pathlib.Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    seconds = time.monotonic() - start
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip: ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"dryrun_multichip(8, device='cpu') exited {proc.returncode}: "
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    if "mesh={'data': 1, 'sp': 2, 'model': 2, 'ep': 2}" not in lines[-1] or "pp=8" not in lines[-1]:
        raise RuntimeError(f"dryrun_multichip(8) line: {lines[-1]}")
    out["dryrun_cpu"] = {"line": lines[-1], "seconds": seconds}
    log(f"sharded: (8 gloo ranks on the CPU, one card here, {seconds:.1f} s with the "
        f"interpreter's start) {lines[-1]}")


def phase_sharded() -> dict:
    out = {"paths": {}, "moe": {}}
    _moe_on_one_card(out)
    _one_rank_world(out)
    _dryrun_on_cpu(out)
    return out


# the validator's slice component on one card (a world of one rank): the
# flash check's plain causal pass (the triangle, bf16) and packed pass
# (the general kernel, bf16), and the flash ring's one hop (the triangle,
# f32: q_start = k_start = 0 at one rank); the dense ring, the pipeline
# and the collectives launch no kernel of the table
SLICE_LAUNCHES = {"flash_fwd_tri": 2, "flash_fwd_rect": 1}
SLICE_BARS = {"collectives": 1e-5, "ring_attention": 2e-4, "ring_flash_attention": 2e-4,
              "flash_attention": BF16_TOL}


def _check_slice_report(report: dict) -> None:
    sizes = [r["size_mb"] for r in report["results"]]
    if sizes != [1, 4, 16, 64] or report["correctness_only"] is not True or not report["ok"]:
        raise RuntimeError(f"slice allreduce: sizes {sizes}, correctness_only "
                           f"{report['correctness_only']}, ok {report['ok']}")
    errors = {"collectives": max(report["collectives"]["errors"].values()),
              "ring_attention": report["ring_attention"]["max_abs_err"],
              "ring_flash_attention": report["ring_flash_attention"]["max_abs_err"],
              "flash_attention": max(report["flash_attention"]["max_abs_err"],
                                     report["flash_attention"]["segment_max_abs_err"])}
    over = {k: v for k, v in errors.items() if not v <= SLICE_BARS[k]}
    if over or not report["pipeline"]["ok"]:
        raise RuntimeError(f"slice checks over their bars {SLICE_BARS}: {errors}, pipeline "
                           f"{report['pipeline']}")


def _slice_in_process(out: dict) -> None:
    from tpu_operator_torch.validator import status as status_files
    from tpu_operator_torch.validator.main import Context, run_component
    from tpu_operator_torch.workloads.distributed import gang_world
    from tpu_operator_torch.workloads.fabric import run_fabric_probe

    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        start = time.monotonic()
        report = run_component("slice", Context(validation_dir=tmp), max_attempts=1)
        torch.cuda.synchronize()
        seconds = time.monotonic() - start
        counts = read_launches()
        written = status_files.read_status("slice-ready", tmp)
    if written != report:
        raise RuntimeError(f"slice-ready holds {written}, the component returned {report}")
    expected = {k: SLICE_LAUNCHES.get(k, 0) for k in counts}
    if counts != expected:
        raise RuntimeError(f"validator slice: launches {counts}, expected {expected}")
    _check_slice_report(report)
    with gang_world():
        probe = run_fabric_probe("1x1x1")
    if not (probe["ok"] and probe["edges"] == {} and probe["axis_allreduce_us"] == {}):
        raise RuntimeError(f"run_fabric_probe('1x1x1'): {probe}")
    out["paths"]["validator slice"] = counts
    out["component"], out["component_s"], out["fabric_1x1x1"] = report, seconds, probe
    log(f"slice: run_component('slice') in process, one-rank NCCL world, {seconds:.1f} s: "
        f"slice-ready written; allreduce (a local copy, no link) " + ", ".join(
            f"{r['size_mb']} MiB {r['time_ms']:.4f} ms {r['busbw_gbps']:.1f} GB/s"
            for r in report["results"])
        + f"; collectives {report['collectives']['errors']}; rings "
        f"{report['ring_attention']['max_abs_err']:.3g} / "
        f"{report['ring_flash_attention']['max_abs_err']:.3g} (flash); flash check "
        f"{report['flash_attention']['max_abs_err']:.3g} / "
        f"{report['flash_attention']['segment_max_abs_err']:.3g} (packed); pipeline losses "
        f"{report['pipeline']['losses']}; launches {counts}; fabric 1x1x1 numerics ok, no edges")


def _slice_from_a_shell(out: dict) -> None:
    from tpu_operator_torch.validator import status as status_files

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, COMPONENT="slice", VALIDATION_DIR=tmp)
        start = time.monotonic()
        # the component retries forever: the timeout counts as a failure
        proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.validator.main"],
                              cwd=pathlib.Path(__file__).resolve().parent, env=env,
                              capture_output=True, text=True, timeout=300)
        seconds = time.monotonic() - start
        written = status_files.read_status("slice-ready", tmp)
    if proc.returncode != 0 or written is None:
        raise RuntimeError(f"COMPONENT=slice exited {proc.returncode}, slice-ready {written}: "
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    _check_slice_report(written)
    out["shell"] = {"seconds": seconds, "report": written}
    log(f"slice: COMPONENT=slice python -m tpu_operator_torch.validator.main exited 0 in "
        f"{seconds:.1f} s (the interpreter's start included), slice-ready written")


def _gang_checks(out: dict) -> None:
    from tpu_operator_torch.workloads.multiproc import run_multiprocess_check, run_multislice_check

    runs = {
        "1 worker x 1 card, NCCL": lambda: run_multiprocess_check(
            num_workers=1, devices_per_worker=1, timeout=300),
        "2 workers x 2 ranks, gloo": lambda: run_multiprocess_check(
            num_workers=2, devices_per_worker=2, timeout=300, device="cpu"),
        "2 slices x 1 host x 2 ranks, gloo": lambda: run_multislice_check(
            num_slices=2, hosts_per_slice=1, devices_per_worker=2, timeout=300, device="cpu"),
    }
    out["gang"] = {}
    for name, run in runs.items():
        start = time.monotonic()
        report = run()
        seconds = time.monotonic() - start
        platforms = {w["platform"] for w in report["workers"]}
        want = {"cuda"} if "NCCL" in name else {"cpu"}
        if not (report["ok"] and report["psum_ok"] and platforms == want
                and report["ring_attention_max_err"] < 1e-4):
            raise RuntimeError(f"gang check {name}: {report}")
        out["gang"][name] = dict(report, seconds=seconds)
        log(f"slice: gang check {name}: {report['global_devices']} ranks, psum ok, chain "
            f"{report['psum_chain_ms']:.4f} ms per all-reduce, ring err "
            f"{report['ring_attention_max_err']:.3g}, {seconds:.1f} s with the workers' start")


def phase_slice() -> dict:
    out = {"paths": {}}
    start = time.monotonic()
    _slice_in_process(out)
    _slice_from_a_shell(out)
    _gang_checks(out)
    out["seconds"] = time.monotonic() - start
    log(f"slice: phase 9 in {out['seconds']:.1f} s")
    return out


# phase 10: the elastic trainer at the flagship's widths, bf16, flash
TRAINER_OVERRIDES = {"d_model": 256, "n_heads": 4, "d_ff": 1024, "seq_len": 128, "batch": 8,
                     "n_layers": 2, "use_flash_attention": True}
TRAINER_RUN = {"total_steps": 24, "checkpoint_every": 5, "fail_at_steps": (13,)}
# The trainer against another path from the same seeded start (here a
# plain loop of the step, in scripts/multicard_check.py a one-card run):
# its losses, relative, and its final params, as the norm of the
# difference over the norm of the other path's change from the start. A
# loss of ~2.0 moves only ~1.6e-2 over 24 steps, so the losses alone
# cannot tell a trainer that never updates (its params read 1 here).
TRAINER_LOSS_TOL, TRAINER_PARAMS_TOL = 1e-3, 2e-2


def host_arrays(params: dict) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


def params_gap(got: dict, ref: dict, start: dict) -> float:
    """||got - ref|| / ||ref - start|| over every parameter."""
    diff = sum(float(np.sum(np.square(got[k].astype(np.float64) - ref[k]))) for k in ref)
    moved = sum(float(np.sum(np.square(ref[k].astype(np.float64) - start[k]))) for k in ref)
    return math.sqrt(diff / moved)


def _trainer_launches(counts: dict, cfg, steps: int, what: str) -> None:
    """Each triangle kernel once per layer and executed step, no other."""
    expected = _expected_launches(counts, cfg, steps)
    if counts != expected:
        raise RuntimeError(f"{what}: launches {counts}, expected {expected} for {steps} steps")


def _timed_checkpoints(trainer) -> list:
    """Wall seconds of each of the trainer's checkpoint() calls (gather,
    serialize, hash, write), appended to the returned list."""
    seconds, checkpoint = [], trainer.checkpoint

    def timed():
        start = time.perf_counter()
        epoch = checkpoint()
        seconds.append(time.perf_counter() - start)
        return epoch
    trainer.checkpoint = timed
    return seconds


def _trainer_on_the_card(out: dict, device: str) -> None:
    from tpu_operator_torch.workloads.burnin import build_train_step
    from tpu_operator_torch.workloads.checkpoint import CheckpointStore
    from tpu_operator_torch.workloads.training import (
        ResumableTrainer,
        TrainerError,
        trainer_config,
        verify_continuity,
    )

    cfg = trainer_config(TRAINER_OVERRIDES)
    total = TRAINER_RUN["total_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        trainer = ResumableTrainer(store, cfg, device=device, **TRAINER_RUN)
        saves = _timed_checkpoints(trainer)
        zero_launches()
        trainer.resume(1)
        try:
            trainer.run(total)
            raise RuntimeError("trainer: the injected fault at step 13 did not fire")
        except TrainerError as e:
            log(f"trainer: {e} (at step {trainer.step}, checkpoint {trainer.checkpoint_step})")
        trainer.resume(1)
        trainer.run(total)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_launches()
        executed = len(trainer.history)
        _trainer_launches(counts, cfg, executed, "trainer")
        report = verify_continuity(trainer.history, trainer.checkpoints, total)
        if not (trainer.done and report["ok"] and report["rewinds"] == 1
                and report["max_lost_steps"] == 2):
            raise RuntimeError(f"trainer: continuity {report}")
        first = {}
        reruns = {}
        for h in trainer.history:
            if h["step"] in first:
                reruns[h["step"]] = (first[h["step"]], h["loss"])
            else:
                first[h["step"]] = h["loss"]
        if sorted(reruns) != [11, 12] or any(a != b for a, b in reruns.values()):
            raise RuntimeError(f"trainer: re-executed losses differ from their first run: {reruns}")
        dense_cfg = dataclasses.replace(cfg, use_flash_attention=False)
        dense = _step_losses(*build_train_step(dense_cfg, device), 3)
        head = [first[s] for s in (1, 2, 3)]
        rel = _curve_rel(head, dense)
        if not (rel <= TRAINER_LOSS_TOL and first[total] < first[1]):
            raise RuntimeError(f"trainer: first losses {head} differ from the dense path's {dense} "
                               f"by {rel} (relative, tol {TRAINER_LOSS_TOL}), or the curve "
                               f"{first[1]} -> {first[total]} does not fall")
        # the trainer's params at the end against the same step looped plainly
        step, params, batch = build_train_step(cfg, device)
        start = host_arrays(params)
        for _ in range(total):
            params, _ = step(params, batch)
        plain = host_arrays(params)
        gap = params_gap(store.latest_good().arrays, plain, start)
        if not gap <= TRAINER_PARAMS_TOL:
            raise RuntimeError(f"trainer: params at step {total} differ from a plain loop's by "
                               f"{gap} of its change (tol {TRAINER_PARAMS_TOL})")
        # tear the newest blob (step 24): a new trainer falls back to step 20
        newest = store.manifest()[-1]
        path = os.path.join(tmp, newest["file"])
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        zero_launches()
        second = ResumableTrainer(store, cfg, device=device, total_steps=total,
                                  checkpoint_every=TRAINER_RUN["checkpoint_every"])
        torn = second.resume(1)
        second.run(total)
        if device == "cuda":
            torch.cuda.synchronize()
        torn_counts = read_launches()
        _trainer_launches(torn_counts, cfg, len(second.history), "trainer torn-blob resume")
        torn_gap = max(abs(h["loss"] - first[h["step"]]) for h in second.history)
        torn_params = params_gap(store.latest_good().arrays, plain, start)
        if not (newest["step"] == total and torn.step == 20 and second.done
                and [h["step"] for h in second.history] == [21, 22, 23, 24]
                and torn_gap <= 1e-3 * (1 + abs(first[21]))
                and torn_params <= TRAINER_PARAMS_TOL):
            raise RuntimeError(f"trainer: torn-blob resume {torn}, history {second.history}, "
                               f"params {torn_params} of the plain loop's change")
    step_s = trainer.step_times[1][1:]
    out["paths"]["trainer"] = counts
    out["paths"]["trainer torn-blob resume"] = torn_counts
    out["trainer"] = {
        "config": dataclasses.asdict(cfg), **{k: list(v) if isinstance(v, tuple) else v
                                              for k, v in TRAINER_RUN.items()},
        "executed_steps": executed, "continuity": report, "losses": trainer.history,
        "reruns": reruns, "dense_losses": dense, "head_rel_err": rel, "params_gap": gap,
        "step_ms_median": 1e3 * statistics.median(step_s), "step_ms_min": 1e3 * min(step_s),
        "resume_ms": [1e3 * r.latency_s for r in trainer.resumes],
        "checkpoint_ms": [1e3 * s for s in saves],
        "torn_blob_resume": {"newest_torn": newest["file"], "resumed_at": torn.step,
                             "resume_ms": 1e3 * torn.latency_s, "max_loss_gap": torn_gap,
                             "params_gap": torn_params},
    }
    log(f"trainer: {executed} executed steps of {total} (fault at 13, resumed at "
        f"{trainer.resumes[1].step}), continuity ok, rewinds {report['rewinds']}, lost "
        f"{report['max_lost_steps']}; re-executed losses equal {reruns}; first losses {head} vs "
        f"dense {dense} (rel {rel:.3g}); params at step {total} {gap:.3g} of a plain loop's "
        f"change; launches {counts}; step ms median "
        f"{out['trainer']['step_ms_median']:.4f} (min {out['trainer']['step_ms_min']:.4f}); resume "
        f"ms {[round(x, 3) for x in out['trainer']['resume_ms']]}; checkpoint ms "
        f"{[round(x, 3) for x in out['trainer']['checkpoint_ms']]}")
    log(f"trainer: torn {newest['file']} (step {total}) -> resumed at step {torn.step} in "
        f"{1e3 * torn.latency_s:.3f} ms, finished, largest loss gap to the first run "
        f"{torn_gap:.3g}, params {torn_params:.3g} of a plain loop's change; launches "
        f"{torn_counts}")


class NotFound(Exception):
    """An apiserver's 404 (the port matches a client's errors by class name)."""


class AlreadyExists(Exception):
    """An apiserver's 409 on create."""


class _DictClient:
    """The smallest apiserver client the job worker needs: objects as
    dicts, ``get_or_none``, a merge ``patch`` and ``create``."""

    def __init__(self):
        self.objects = {}

    @staticmethod
    def _key(api_version, kind, name, namespace):
        return api_version, kind, namespace or "", name

    def create(self, obj):
        md = obj["metadata"]
        key = self._key(obj["apiVersion"], obj["kind"], md["name"], md.get("namespace"))
        if key in self.objects:
            raise AlreadyExists(key)
        self.objects[key] = copy.deepcopy(obj)
        return copy.deepcopy(obj)

    def get_or_none(self, api_version, kind, name, namespace=None):
        obj = self.objects.get(self._key(api_version, kind, name, namespace))
        return copy.deepcopy(obj) if obj is not None else None

    def patch(self, api_version, kind, name, patch, namespace=None):
        key = self._key(api_version, kind, name, namespace)
        if key not in self.objects:
            raise NotFound(key)

        def merge(into, update):
            for k, v in update.items():
                if isinstance(v, dict) and isinstance(into.get(k), dict):
                    merge(into[k], v)
                elif v is None:
                    into.pop(k, None)
                else:
                    into[k] = copy.deepcopy(v)
        merge(self.objects[key], patch)
        return copy.deepcopy(self.objects[key])


def _job_worker(out: dict, device: str) -> None:
    """JobWorkerMain beating under _DictClient: a checkpoint barrier acked,
    a defrag barrier that holds this generation, and a fresh main of the
    next generation resuming from the shared store to the end."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.dataplane.worker import JobWorkerMain
    from tpu_operator_torch.workloads.training import trainer_config, verify_continuity

    ns, job, steps = "smoke", "smoke-job", 12
    progress_name = job + consts.JOB_PROGRESS_SUFFIX
    client = _DictClient()
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "h100-0"}})
    with tempfile.TemporaryDirectory() as tmp:
        client.create({"apiVersion": consts.TPU_JOB_API_VERSION, "kind": consts.TPU_JOB_KIND,
                       "metadata": {"name": job},
                       "spec": {"workload": {"steps": steps, "config": TRAINER_OVERRIDES},
                                "checkpoint": {"everySteps": 4, "dir": tmp}}})
        client.create({"apiVersion": consts.TPU_SLICE_API_VERSION, "kind": consts.TPU_SLICE_KIND,
                       "metadata": {"name": job + consts.JOB_SLICE_SUFFIX},
                       "status": {"placement": {"phase": "Scheduled", "nodes": ["h100-0"]}}})

        def env(gang_hash):
            return {consts.WORKER_ENV_JOB_NAME: job, consts.WORKER_ENV_GANG_HASH: gang_hash,
                    consts.WORKER_ENV_CHECKPOINT_DIR: tmp, consts.WORKER_ENV_STEPS_PER_SYNC: "2"}

        def progress():
            return client.get_or_none("v1", "ConfigMap", progress_name, ns)["data"]

        def request(token):
            client.patch("v1", "ConfigMap", progress_name,
                         {"data": {consts.JOB_CHECKPOINT_REQUEST: token}}, ns)

        def beat_to(main, step):
            for _ in range(20):
                if main.trainer is not None and main.trainer.step >= step:
                    return
                main.step()
            raise RuntimeError(f"job worker: no step {step} in 20 beats: {progress()}")

        zero_launches()
        first = JobWorkerMain(client, ns, env("g1"), device=device)
        beat_to(first, 2)
        request("grow-1")  # a barrier off the cadence (4): a checkpoint at step 2
        first.step()
        acked = progress().get(consts.JOB_PROGRESS_CHECKPOINT_ACK)
        beat_to(first, 6)
        request("defrag-1-0")
        first.step()
        held_at = first.trainer.step
        for _ in range(3):
            first.step()
        data = progress()
        if not (acked == "grow-1" and first.trainer.checkpoints[0]["step"] == 2
                and data[consts.JOB_PROGRESS_CHECKPOINT_ACK] == "defrag-1-0"
                and first.trainer.step == held_at and first.trainer.checkpoint_step == held_at):
            raise RuntimeError(f"job worker: barrier ack {acked}, hold at {held_at}, trainer at "
                               f"{first.trainer.step}, progress {data}")
        request("")  # the controller clears the barrier for the next generation
        second = JobWorkerMain(client, ns, env("g2"), device=device)
        for _ in range(20):
            if second.step():
                break
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_launches()
        data = progress()
    trainers = [first.trainer, second.trainer]
    history = [h for t in trainers for h in t.history]
    report = verify_continuity(history, [c for t in trainers for c in t.checkpoints], steps)
    if not (second.trainer.done and data[consts.JOB_PROGRESS_STATUS] == consts.JOB_PROGRESS_COMPLETE
            and data[consts.JOB_PROGRESS_STEP] == str(steps) and report["ok"]
            and report["max_lost_steps"] == 0 and second.trainer.resumes[0].step == held_at):
        raise RuntimeError(f"job worker: progress {data}, continuity {report}")
    _trainer_launches(counts, trainer_config(TRAINER_OVERRIDES), len(history), "job worker")
    out["paths"]["job worker"] = counts
    out["job_worker"] = {"progress": data, "continuity": report, "held_at": held_at,
                         "executed_steps": len(history),
                         "resume_ms": [1e3 * r.latency_s for t in trainers for r in t.resumes]}
    log(f"trainer: JobWorkerMain to {data[consts.JOB_PROGRESS_STATUS]} at step "
        f"{data[consts.JOB_PROGRESS_STEP]}: barrier 'grow-1' acked, 'defrag-1-0' held generation "
        f"g1 at step {held_at}, generation g2 resumed there; continuity ok, lost "
        f"{report['max_lost_steps']}; launches {counts}")


def phase_trainer(device: str = "cuda") -> dict:
    out = {"paths": {}}
    start = time.monotonic()
    _trainer_on_the_card(out, device)
    _job_worker(out, device)
    out["seconds"] = time.monotonic() - start
    log(f"trainer: phase 10 in {out['seconds']:.1f} s")
    return out


def kernels_line(rows: list, paths: dict, extra: dict) -> dict:
    """One entry per kernel of ``KERNELS``; ``launches`` sums its launches
    over the main-path runs (``paths``: run name -> counts); the timings
    are the kernel's first main-path row's (``main_shapes`` has them all);
    ``extra`` adds keys to a kernel's entry (kernel name -> dict)."""
    keys = ("label", "max_abs_err", "rel_err", "ms", "pair_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "eager_ms", "tflops", "ratio_to_library", "block_m",
            "other_block_m", "other_ms", "pair_tflops", "pair_ratio_to_library", "blocks",
            "other_blocks", "other_dq_ms", "other_dkv_ms")
    headline = ("label", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms")
    out = []
    for name, (module, reference, line) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["main_path"])
        by_path = {path: counts[name] for path, counts in paths.items() if counts[name]}
        if not by_path:
            raise RuntimeError(f"{name} was never launched on a main path: {paths}")
        out.append({
            "name": name, "route": "cuda", "source": f"tpu_operator_torch/kernels/{module}.cu",
            "replaces": f"{reference}:{line}", "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "eager_ms": main["eager_ms"],
            # every main-path shape (the general forward has two: f32 serving, bf16 training)
            "main_shapes": [{k: r[k] for k in headline} for r in mine if r["main_path"]],
            "shapes": [{k: r[k] for k in keys if k in r} for r in mine],
            **extra.get(name, {}),
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
    results["train"] = phase_train()
    results["selftest"] = phase_selftest()
    results["sharded"] = phase_sharded()
    results["slice"] = phase_slice()
    results["trainer"] = phase_trainer()
    paths = {"burnin forward": results["burnin"]["launches"],
             "serving": results["serving"]["launches"], **results["train"]["paths"],
             **results["selftest"]["paths"], **results["sharded"]["paths"],
             **results["slice"]["paths"], **results["trainer"]["paths"]}
    fwd = results["build"]["flash_fwd_hgmma"]
    hgmma = {"flash_fwd_tri": {k: v for k, v in fwd.items() if not k.startswith("rect_")},
             "flash_fwd_rect": {k: v for k, v in fwd.items() if k.startswith("rect_")}}
    for kind in ("dq", "dkv"):
        for pair, prefix in (("tri", f"{kind}_d"), ("rect", f"{kind}_rect_d")):
            hgmma[f"flash_bwd_{kind}_{pair}"] = {
                k: v for k, v in results["build"]["flash_bwd_hgmma"].items() if k.startswith(prefix)}
    line = kernels_line(results["kernels"], paths, {k: {"hgmma": v} for k, v in hgmma.items()})
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
