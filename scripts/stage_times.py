#!/usr/bin/env python3
"""Device time of the 16-bit forwards above head dim 576 in several
checkouts of the repository, on one card, with no check of their results.

    python3 scripts/stage_times.py TREE [TREE ...] [--order 0,1,1,0]
        [--json PATH]

Each TREE is a checkout (for example a copy of this one with part of a
kernel removed, to see what that part costs: such a copy computes nothing
right, so ``scripts/kernel_ab.py``, which holds every case to its plain
version, cannot time it). Every tree builds its ``flash_fwd_wide`` library,
all at once; then, in the order ``--order`` gives (indices into the trees;
default each once, in turn), a process of its own imports
``tpu_operator_torch`` from that tree and times the triangle at
(1,8192,8,1024) and (1,8192,8,640) with one kv head and at (1,1024,4,2048),
and the general kernel at (1,4096,8,1024) full attention, in bf16 on random
inputs, with ``chip_smoke.device_ms`` (CUDA-graph replay, median of 5).
Prints the card's name and power limit, one line per run, and as the last
line one JSON object with every time.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = [  # (label, kernel, b, s, h, h_kv, d)
    ("tri 1024 h_kv 1", "tri", 1, 8192, 8, 1, 1024),
    ("full 1024", "rect", 1, 4096, 8, 8, 1024),
    ("tri 640 h_kv 1", "tri", 1, 8192, 8, 1, 640),
    ("tri 2048", "tri", 1, 1024, 4, 4, 2048),
]


def _worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from tpu_operator_torch.kernels import flash_fwd

    if not Path(flash_fwd.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"flash_fwd came from {flash_fwd.__file__}, not {tree}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    out = {}
    for label, kernel, b, s, h, h_kv, d in CASES:
        gen = torch.Generator(device="cuda").manual_seed(1)

        def make(rows):
            return torch.randn((rows, s, d), generator=gen, device="cuda").to(torch.bfloat16)

        q, k, v = make(b * h), make(b * h_kv), make(b * h_kv)
        if kernel == "tri":
            def run():
                return flash_fwd.flash_fwd_tri(q, k, v, h, h_kv)
        else:
            def run():
                return flash_fwd.flash_fwd_rect(q, k, v, h, h_kv, False)
        out[label] = chip_smoke.device_ms(run, 2, 5)
    return out


def _build(tree: Path) -> subprocess.CompletedProcess:
    code = (f"import sys; sys.path.insert(0, {str(tree)!r}); "
            "from tpu_operator_torch.kernels import build; build.build(['flash_fwd_wide'])")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", type=Path, nargs="+", help="checkouts of the repository")
    parser.add_argument("--order", default="", help="indices of the trees to time, in order")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    parser.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(_worker(args.worker.resolve())))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    trees = [t.resolve() for t in args.trees]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for tree, built in zip(trees, pool.map(_build, trees)):
            if built.returncode:
                raise RuntimeError(f"{tree}: build failed\n{built.stderr[-3000:]}")
    order = [int(i) for i in args.order.split(",")] if args.order else range(len(trees))
    runs = []
    for i in order:
        got = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(trees[i]),
                              "--worker", str(trees[i])], capture_output=True, text=True,
                             timeout=1800)
        if got.returncode:
            print(f"{trees[i]}: failed\n{got.stderr[-2000:]}", flush=True)
            runs.append({"tree": str(trees[i]), "ms": None})
            continue
        ms = json.loads(got.stdout.strip().splitlines()[-1])
        runs.append({"tree": str(trees[i]), "ms": ms})
        print(f"{trees[i]}: {json.dumps(ms)}", flush=True)
    result = {"device": smi, "cases": [c[0] for c in CASES], "runs": runs}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
