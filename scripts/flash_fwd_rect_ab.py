#!/usr/bin/env python3
"""Device time of the general forward (``flash_fwd_rect``) in bf16 in this
tree and in another checkout of the repository, on one card, in turns.

    python3 scripts/flash_fwd_rect_ab.py OTHER_TREE [--json PATH]

OTHER_TREE is another checkout (for example an earlier commit unpacked with
``git archive``). For every bf16 ``flash_fwd_rect`` case of this tree's
``chip_smoke.KERNEL_CASES``, a process of its own imports
``tpu_operator_torch`` from one tree (building that tree's kernels there),
holds its kernel to ``attention_plain`` (O 2e-2, lse 1e-3) on the same
seeded inputs and times it with ``chip_smoke.device_ms`` (CUDA-graph
replay, median of 7). The processes run in the order other, this, this,
other, so that drift over the run falls on both sides alike. Prints the
card's name and power limit, one line per case, and as the last line one
JSON object with every time. A case that a tree's kernel gets wrong is
reported and not timed, and the script then exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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


def _worker(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from tpu_operator_torch.kernels import flash_fwd

    if not Path(flash_fwd.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"flash_fwd came from {flash_fwd.__file__}, not {tree}")
    smoke = _smoke()
    results = {}
    for case in smoke.KERNEL_CASES:
        if case["kernel"] != "flash_fwd_rect" or case["dtype"] != torch.bfloat16:
            continue
        q, k, v, seg = smoke._case_inputs(case, torch.Generator(device="cuda").manual_seed(SEED))
        _, _, h, _ = case["q"]
        h_kv = case.get("h_kv", h)
        masks = dict(causal=case["causal"], q_start=case.get("q_start", 0),
                     k_start=case.get("k_start", 0), window=case.get("window"), seg=seg)

        def kern():
            return flash_fwd.flash_fwd_rect(q, k, v, h, h_kv, **masks)

        out_, lse = kern()
        want, want_lse = flash_fwd.attention_plain(q, k, v, h, h_kv, **masks)
        torch.cuda.synchronize()
        o_err, lse_err = smoke.err(out_, want), smoke.err(lse, want_lse)
        ok = o_err <= smoke.BF16_TOL and lse_err <= smoke.LSE_TOL
        results[case["label"]] = {"ok": ok, "o_err": o_err, "lse_err": lse_err,
                                  "ms": smoke.device_ms(kern, case.get("inner", 20)) if ok else None}
    out.write_text(json.dumps(results))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another checkout of the repository")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    parser.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker.resolve(), args.out)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("other", "this", "this", "other")):
            out = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, str(Path(__file__).resolve()), str(trees[name]),
                            "--worker", str(trees[name]), "--out", str(out)],
                           check=True, timeout=900)
            runs[name].append(json.loads(out.read_text()))
    summary, wrong = {}, []
    for label in runs["this"][0]:
        entry = {}
        for name in ("other", "this"):
            got = [r[label] for r in runs[name]]
            if not all(g["ok"] for g in got):
                wrong.append((name, label, got))
            entry[name] = {"ms": [g["ms"] for g in got],
                           "o_err": max(g["o_err"] for g in got),
                           "lse_err": max(g["lse_err"] for g in got)}
        if all(None not in entry[n]["ms"] for n in entry):
            entry["other_over_this"] = (statistics.median(entry["other"]["ms"])
                                        / statistics.median(entry["this"]["ms"]))
        summary[label] = entry
        print(f"{label}: other {entry['other']['ms']} ms, this {entry['this']['ms']} ms, "
              f"other/this {entry.get('other_over_this')}", flush=True)
    result = {"device": smi, "other": str(trees["other"]), "cases": summary, "wrong": wrong}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
