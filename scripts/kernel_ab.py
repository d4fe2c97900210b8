#!/usr/bin/env python3
"""Device time of a family of kernels in this tree and in another checkout
of the repository, on one card, in turns.

    python3 scripts/kernel_ab.py OTHER_TREE
        --family fwd_rect|fwd_16|fwd_wide|fwd_f32|bwd_f32|bwd_16|bwd_wide
        [--match REGEX] [--json PATH]

OTHER_TREE is another checkout (for example an earlier commit unpacked with
``git archive``). The families:

- ``fwd_rect``: the general forward (``flash_fwd_rect``) at every bf16 case
  of this tree's ``chip_smoke.KERNEL_CASES``, held to ``attention_plain``
  (O 2e-2, lse 1e-3);
- ``fwd_16``: both 16-bit forwards (``flash_fwd_tri``, ``flash_fwd_rect``)
  at every bf16 and fp16 case of head dim 256 and below (padded) in this
  tree's ``chip_smoke`` forward tables (``KERNEL_CASES``,
  ``HEAD_DIM_KERNEL_CASES``, ``FLOAT16_KERNEL_CASES``), held to
  ``attention_plain`` at phase 3's bars (O 2e-2, lse 1e-3);
- ``fwd_wide``: both 16-bit forwards (``flash_fwd_tri``, ``flash_fwd_rect``)
  at every bf16 and fp16 case above head dim 576 (padded) in this tree's
  ``chip_smoke`` (``WIDE_KERNEL_CASES``, ``WIDE_CLUSTER_FWD_CASES``), held
  as ``fwd_16``'s;
- ``fwd_f32``: both f32 forwards (``flash_fwd_tri``, ``flash_fwd_rect``) at
  every f32 case in this tree's ``chip_smoke`` forward tables
  (``KERNEL_CASES``, ``HEAD_DIM_KERNEL_CASES``,
  ``HEAD_DIM_512_KERNEL_CASES``, ``HEAD_DIM_576_KERNEL_CASES``,
  ``WIDE_KERNEL_CASES``, ``F32_TILE_KERNEL_CASES``): head dim 16 (the whole-row kernels), 32-128
  (padded; the tile kernels, one CTA a tile) and from 256 on (the cluster
  kernels), held to ``attention_plain`` (O 1e-4, lse 1e-3);
- ``bwd_f32``: both f32 backward pairs (``flash_bwd_dq_*``,
  ``flash_bwd_dkv_*``) at every f32 case in this tree's ``chip_smoke``
  backward tables (``BWD_CASES``, ``HEAD_DIM_BWD_CASES``,
  ``HEAD_DIM_512_BWD_CASES``, ``HEAD_DIM_576_BWD_CASES``,
  ``WIDE_BWD_CASES``): head dims up to 128 (padded; the pair at one CTA a
  tile) and from 256 on (the cluster pair), dQ, dK and dV held to
  ``attention_bwd_plain`` (1e-4 absolute), each kernel timed;
- ``bwd_16``: both bf16 and fp16 backward pairs at every 16-bit case of
  head dim 256 and below (padded) in this tree's ``chip_smoke`` backward
  tables (``BWD_CASES``, ``HEAD_DIM_BWD_CASES``, ``FLOAT16_BWD_CASES``),
  held to ``attention_bwd_plain`` at phase 3's bars (2e-2 of max |grad|;
  fp16 subnormal rows also by its subnormal steps), dQ and dK/dV timed;
- ``bwd_wide``: both bf16 and fp16 backward pairs at every 16-bit case above
  head dim 576 (padded) in this tree's ``chip_smoke`` (``WIDE_BWD_CASES``,
  ``WIDE_CLUSTER_BWD_CASES``), held and timed as ``bwd_16``'s.

``--match`` keeps the cases whose label the regular expression finds.

A process of its own imports ``tpu_operator_torch`` from one tree (building
that tree's kernels there), checks each case on the same seeded inputs and
times it with ``chip_smoke.device_ms`` (CUDA-graph replay, median of 7).
The processes run in the order other, this, this, other, so that drift
over the run falls on both sides alike. Prints the card's name and power
limit, one line per case, and as the last line one JSON object with every
time. A case that a tree's kernels get wrong is reported and not timed,
and the script then exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED = 20260818


def _smoke():
    """This tree's chip_smoke.py, whatever tree ``tpu_operator_torch``
    comes from (it imports the package only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fwd(smoke, cases, tol: float) -> dict:
    """Forward ``cases`` (rows of this tree's chip_smoke forward tables)
    held to attention_plain (O ``tol``, lse ``LSE_TOL``): {label: {ok,
    errs, ms}}."""
    import torch

    results = {}
    for case in cases:
        q, k, v, seg = smoke._case_inputs(case, torch.Generator(device="cuda").manual_seed(SEED))
        kern, plain, _ = smoke._fwd_setup(case, q, k, v, seg)
        _, _, o_err, lse_err = smoke._fwd_errors(kern, plain, case["q"][3])
        ok = o_err <= tol and lse_err <= smoke.LSE_TOL
        results[case["label"]] = {
            "ok": ok, "errs": [o_err, lse_err],
            "ms": smoke.device_ms(kern, case.get("inner", 20)) if ok else None}
    return results


def _fwd_rect(smoke) -> dict:
    """The bf16 general forward's cases of ``KERNEL_CASES``."""
    import torch

    return _fwd(smoke, [c for c in smoke.KERNEL_CASES if c["kernel"] == "flash_fwd_rect"
                        and c["dtype"] == torch.bfloat16], smoke.BF16_TOL)


def _fwd_16(smoke) -> dict:
    """Both 16-bit forwards' cases at head dims up to 256 (padded)."""
    import torch

    from tpu_operator_torch.kernels import flash_fwd

    tables = smoke.KERNEL_CASES + smoke.HEAD_DIM_KERNEL_CASES + smoke.FLOAT16_KERNEL_CASES
    return _fwd(smoke, [c for c in tables if c["dtype"] != torch.float32
                        and flash_fwd.padded_head_dim(c["q"][3]) <= 256], smoke.BF16_TOL)


def _fwd_wide(smoke) -> dict:
    """Both 16-bit forwards' cases above head dim 576 (padded)."""
    import torch

    tables = smoke.WIDE_KERNEL_CASES + smoke.WIDE_CLUSTER_FWD_CASES
    return _fwd(smoke, [c for c in tables if c["dtype"] != torch.float32], smoke.BF16_TOL)


def _fwd_f32(smoke) -> dict:
    """Both f32 forwards' cases at every head dim."""
    import torch

    tables = (smoke.KERNEL_CASES + smoke.HEAD_DIM_KERNEL_CASES + smoke.HEAD_DIM_512_KERNEL_CASES
              + smoke.HEAD_DIM_576_KERNEL_CASES + smoke.WIDE_KERNEL_CASES
              + smoke.F32_TILE_KERNEL_CASES)
    return _fwd(smoke, [c for c in tables if c["dtype"] == torch.float32], smoke.F32_TOL)


def _bwd_f32(smoke) -> dict:
    """Both f32 backward pairs' cases at every head dim: {label: {ok, errs,
    dq_ms, dkv_ms}}."""
    import torch

    tables = (smoke.BWD_CASES + smoke.HEAD_DIM_BWD_CASES + smoke.HEAD_DIM_512_BWD_CASES
              + smoke.HEAD_DIM_576_BWD_CASES + smoke.WIDE_BWD_CASES)
    results = {}
    for case in tables:
        if case["dtype"] != torch.float32:
            continue
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, seg = smoke._case_inputs(case, gen)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        run = smoke._bwd_setup(case, q, k, v, seg, dout)
        _, errs, _, _ = smoke._bwd_errors(run, case["q"][3])
        ok = max(errs) <= smoke.F32_TOL
        inner = case.get("inner", 20)
        results[case["label"]] = {
            "ok": ok, "errs": errs,
            "dq_ms": smoke.device_ms(run["dq"], inner) if ok else None,
            "dkv_ms": smoke.device_ms(run["dkv"], inner) if ok else None}
        del run
    return results


def _bwd_half(smoke, cases) -> dict:
    """Backward ``cases`` of a 16-bit type, held as phase 3 holds them:
    {label pair: {ok, errs, dq_ms, dkv_ms}}."""
    import torch

    results = {}
    for case in cases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, seg = smoke._case_inputs(case, gen)
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        dout = (dout * case.get("dout_scale", 1.0)).to(case["dtype"])
        run = smoke._bwd_setup(case, q, k, v, seg, dout)
        _, errs, grad_scale, _ = smoke._bwd_errors(run, case["q"][3])
        tol = smoke.BF16_TOL * grad_scale
        if case["dtype"] == torch.float16:
            tol = max(tol, smoke.FP16_SUBNORMAL_STEP * (1.0 + max(
                float(x.float().abs().max()) for x in (q, k))))
        ok = max(errs) <= tol
        inner = case.get("inner", 20)
        results[case["label"] + f" {case['pair']}"] = {
            "ok": ok, "errs": errs,
            "dq_ms": smoke.device_ms(run["dq"], inner) if ok else None,
            "dkv_ms": smoke.device_ms(run["dkv"], inner) if ok else None}
        del run
    return results


def _bwd_16(smoke) -> dict:
    """Both 16-bit backward pairs' cases at head dims up to 256 (padded)."""
    import torch

    from tpu_operator_torch.kernels import flash_fwd

    tables = smoke.BWD_CASES + smoke.HEAD_DIM_BWD_CASES + smoke.FLOAT16_BWD_CASES
    return _bwd_half(smoke, [c for c in tables if c["dtype"] != torch.float32
                             and flash_fwd.padded_head_dim(c["q"][3]) <= 256])


def _bwd_wide(smoke) -> dict:
    """Both 16-bit backward pairs' cases above head dim 576 (padded)."""
    import torch

    tables = smoke.WIDE_BWD_CASES + smoke.WIDE_CLUSTER_BWD_CASES
    return _bwd_half(smoke, [c for c in tables if c["dtype"] != torch.float32])


# family: (its cases' runner, the timed keys of a case, the module that must
# come from the tree under test)
FAMILIES = {
    "fwd_rect": (_fwd_rect, ("ms",), "flash_fwd"),
    "fwd_16": (_fwd_16, ("ms",), "flash_fwd"),
    "fwd_wide": (_fwd_wide, ("ms",), "flash_fwd"),
    "fwd_f32": (_fwd_f32, ("ms",), "flash_fwd"),
    "bwd_f32": (_bwd_f32, ("dq_ms", "dkv_ms"), "flash_bwd"),
    "bwd_16": (_bwd_16, ("dq_ms", "dkv_ms"), "flash_bwd"),
    "bwd_wide": (_bwd_wide, ("dq_ms", "dkv_ms"), "flash_bwd"),
}


def _worker(tree: Path, family: str, out: Path, match: str) -> None:
    sys.path.insert(0, str(tree))
    import importlib

    runner, _, module = FAMILIES[family]
    mod = importlib.import_module(f"tpu_operator_torch.kernels.{module}")
    if not Path(mod.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{module} came from {mod.__file__}, not {tree}")
    smoke = _smoke()
    if match:
        # keep only the matching rows of every case table
        for name in dir(smoke):
            table = getattr(smoke, name)
            if name.endswith("_CASES") and isinstance(table, list):
                setattr(smoke, name, [c for c in table if not isinstance(c, dict)
                                      or "label" not in c or re.search(match, c["label"])])
    out.write_text(json.dumps(runner(smoke)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another checkout of the repository")
    parser.add_argument("--family", choices=sorted(FAMILIES), required=True,
                        help="the kernels to compare")
    parser.add_argument("--match", default="", help="time only the cases whose label this "
                        "regular expression finds")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    parser.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker.resolve(), args.family, args.out, args.match)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    keys = FAMILIES[args.family][1]
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("other", "this", "this", "other")):
            out = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, str(Path(__file__).resolve()), str(trees[name]),
                            "--family", args.family, "--match", args.match, "--worker",
                            str(trees[name]), "--out", str(out)], check=True, timeout=1800)
            runs[name].append(json.loads(out.read_text()))
    summary, wrong = {}, []
    for label in runs["this"][0]:
        entry = {}
        for name in ("other", "this"):
            got = [r[label] for r in runs[name]]
            if not all(g["ok"] for g in got):
                wrong.append((name, label, got))
            entry[name] = {key: [g[key] for g in got] for key in keys}
            entry[name]["max_errs"] = [max(g["errs"][i] for g in got)
                                       for i in range(len(got[0]["errs"]))]
        if all(None not in entry[n][key] for n in ("other", "this") for key in keys):
            total = {n: sum(statistics.median(entry[n][key]) for key in keys)
                     for n in ("other", "this")}
            entry["ms"] = total
            entry["other_over_this"] = total["other"] / total["this"]
        summary[label] = entry
        print(f"{label}: " + "; ".join(f"{n} " + " ".join(f"{key} {entry[n][key]}" for key in keys)
                                       for n in ("other", "this"))
              + f"; other/this {entry.get('other_over_this')}", flush=True)
    result = {"device": smi, "other": str(trees["other"]), "family": args.family,
              "cases": summary, "wrong": wrong}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
