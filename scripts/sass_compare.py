#!/usr/bin/env python3
"""Whether the port's flash kernels compile to the same machine code in
this tree and in another checkout of the repository.

    python3 scripts/sass_compare.py OTHER_TREE [--wide] [--json PATH]

OTHER_TREE is another checkout (for example an earlier commit unpacked with
``git archive``). Each tree builds its ``flash_fwd`` and ``flash_bwd``
libraries (bf16 and f32), their fp16 builds and the head dim 512 and 576
builds of all four into an empty temporary directory, in a process of its
own (the D-streaming ``*_wide`` libraries of head dims above 576 only with
``--wide``: an earlier tree may not have them);
``cuobjdump --dump-sass`` lists each library's kernels, and every kernel
found in both trees is compared instruction by instruction (addresses,
encodings and comments dropped).
Prints the card's name and power limit, one line per library, and as the
last line one JSON object: per library the kernels that are the same, the
ones that differ (with their instruction counts in the other tree and in
this one, and how many of this tree's instructions the other tree lacks
as a multiset: 0 where the two only order them differently), the ones
only one tree has, and among those the renamed ones: a kernel only this
tree has whose instructions are exactly those of one only the other tree
has (a template argument or a parameter type changes the mangled name, not
the code).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LIBRARIES = ("flash_fwd", "flash_bwd", "flash_fwd_f16", "flash_bwd_f16", "flash_fwd_d512",
             "flash_bwd_d512", "flash_fwd_f16_d512", "flash_bwd_f16_d512", "flash_fwd_d576",
             "flash_bwd_d576", "flash_fwd_f16_d576", "flash_bwd_f16_d576")
WIDE_LIBRARIES = ("flash_fwd_wide", "flash_bwd_wide", "flash_fwd_f16_wide", "flash_bwd_f16_wide")

_BUILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from tpu_operator_torch.kernels import build
assert build.__file__.startswith(sys.argv[1]), build.__file__
build.bind_build_dir(sys.argv[2])
built = build.build(sys.argv[3:])
print(json.dumps({name: str(path) for name, (path, _) in built.items()}))
"""


def _kernels(sass: str) -> dict:
    """Kernel name -> its instructions, from a ``cuobjdump --dump-sass``
    listing, without addresses, encodings or comments."""
    out, name = {}, None
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            name = header.group(1)
            out[name] = []
            continue
        code = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name is not None and code:
            out[name].append(code.group(1))
    return out


def sass_by_library(tree: Path, tmp: str, libraries=LIBRARIES) -> dict:
    """Library -> kernel -> instructions, for ``tree``'s ``libraries``
    built into ``tmp``."""
    out = subprocess.run([sys.executable, "-c", _BUILD, str(tree), tmp, *libraries], cwd=tree,
                         capture_output=True, text=True, check=True, timeout=1200)
    paths = json.loads(out.stdout.strip().splitlines()[-1])
    sys.path.insert(0, str(ROOT))
    from tpu_operator_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    return {name: _kernels(subprocess.run([str(cuobjdump), "--dump-sass", path],
                                          capture_output=True, text=True, check=True,
                                          timeout=600).stdout)
            for name, path in paths.items()}


def _short(mangled: str) -> str:
    """A kernel's name without the translation unit's anonymous-namespace
    hash, which differs between trees."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", mangled)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other checkout")
    parser.add_argument("--wide", action="store_true",
                        help="also compare the D-streaming libraries of head dims above 576")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    args = parser.parse_args(argv)
    libraries = LIBRARIES + (WIDE_LIBRARIES if args.wide else ())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        other = sass_by_library(args.other.resolve(), a, libraries)
        this = sass_by_library(ROOT, b, libraries)
    result = {"device": smi, "libraries": {}}
    for name in libraries:
        mine = {_short(k): v for k, v in this[name].items()}
        theirs = {_short(k): v for k, v in other[name].items()}
        same = sorted(k for k in mine.keys() & theirs.keys() if mine[k] == theirs[k])
        differ = {k: [len(theirs[k]), len(mine[k]),
                      sum((Counter(mine[k]) - Counter(theirs[k])).values())]
                  for k in sorted(mine.keys() & theirs.keys()) if mine[k] != theirs[k]}
        only_this = sorted(mine.keys() - theirs.keys())
        only_other = sorted(theirs.keys() - mine.keys())
        renamed = {}
        for new in only_this:
            old = next((o for o in only_other if o not in renamed.values()
                        and theirs[o] == mine[new]), None)
            if old is not None:
                renamed[new] = old
        result["libraries"][name] = {
            "same": len(same), "differ": differ, "renamed": renamed,
            "only_this": [k for k in only_this if k not in renamed],
            "only_other": [k for k in only_other if k not in renamed.values()]}
        print(f"{name}: {len(same)} kernels the same, {len(differ)} differ, {len(renamed)} "
              f"renamed with the same instructions, {len(only_this) - len(renamed)} only here, "
              f"{len(only_other) - len(renamed)} only in the other tree", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
