#!/usr/bin/env python3
"""Compile time of the port's CUDA libraries in this tree and in another
checkout of the repository, one ``nvcc`` at a time, in turns.

    python3 scripts/build_times.py OTHER_TREE [--libraries NAME ...] [--json PATH]

OTHER_TREE is another checkout (for example an earlier commit unpacked with
``git archive``). For each library (``flash_fwd``, ``flash_bwd``, and the
fp16 builds of the same sources, ``flash_fwd_f16`` and ``flash_bwd_f16``,
in a tree that has them; or the ``--libraries`` named, such as
``flash_bwd_wide``), a process
of its own imports ``tpu_operator_torch.kernels.build`` from one tree and
builds that tree's library into an empty temporary directory
(``build.bind_build_dir``), alone, so the seconds ``build.build`` reports are
that one ``nvcc``'s. Trees run in the order other, this, this, other, so
that drift over the run falls on both sides alike. Prints the card's name
and power limit, one line per build, and as the last line one JSON object
with every time (null where a tree has no such library).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LIBRARIES = ("flash_fwd", "flash_bwd", "flash_fwd_f16", "flash_bwd_f16")

_BUILD_ONE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from tpu_operator_torch.kernels import build
assert build.__file__.startswith(sys.argv[1]), build.__file__
build.bind_build_dir(sys.argv[3])
name = sys.argv[2]
known = (build.KERNEL_DIR / f"{name}.cu").is_file() or name in getattr(build, "VARIANTS", {})
print(json.dumps(build.build([name])[name][1] if known else None))
"""


def build_seconds(tree: Path, name: str):
    """Seconds of one ``nvcc`` of ``tree``'s library ``name`` into a fresh
    directory; None where the tree has no such library."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([sys.executable, "-c", _BUILD_ONE, str(tree), name, tmp], cwd=tree,
                             capture_output=True, text=True, check=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other checkout")
    parser.add_argument("--libraries", nargs="+", default=list(LIBRARIES),
                        help="the libraries to build (default: %(default)s)")
    parser.add_argument("--json", type=Path, default=None, help="also write the times here")
    args = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    times = {side: {name: [] for name in args.libraries} for side in trees}
    for side in ("other", "this", "this", "other"):
        for name in args.libraries:
            seconds = build_seconds(trees[side], name)
            times[side][name].append(seconds)
            print(f"{side} {name}: " + ("none" if seconds is None else f"{seconds:.2f} s"),
                  flush=True)
    result = {"device": smi, "times_s": times}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
