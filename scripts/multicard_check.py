#!/usr/bin/env python3
"""The slice's multi-card payloads on the cards of one machine (four H100s
joined by NVLink), where ``chip_smoke.py`` has one card:

    python3 scripts/multicard_check.py [--ranks 4] [--json PATH]

1. a world of ``--ranks`` ranks, one per card (NCCL), runs
   ``run_allreduce()`` at the reference's sizes, ``run_collectives_check()``,
   ``run_fabric_probe("2x2x1")`` and ``run_fabric_probe("4x1x1", wrap=True)``;
2. ``COMPONENT=slice python -m tpu_operator_torch.validator.main``: one
   pod whose local cards are all of the machine's (``--ranks`` local ranks);
3. ``run_multiprocess_check(num_workers=2, devices_per_worker=ranks // 2)``
   on NCCL: two loopback workers, each with its own half of the cards.

Every rate (all-reduce busbw per size, each edge's GB/s) is held to at
most 105% of NVLink 4's 450 GB/s per direction (H100 SXM data sheet: 900
GB/s both ways); a higher reading is a timing fault. Prints each card's
name and power limit, one line per measurement, and last a JSON line.
``--device cpu`` rehearses steps 1 and 3 on gloo ranks (no rate bar;
step 2 needs the cards).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NVLINK_GBPS = 450.0  # NVLink 4 per direction, H100 SXM (NVIDIA data sheet)
PEAK_MARGIN = 1.05


def _world_payloads(device: str) -> dict:
    """One rank's reports (every rank gets the same)."""
    from tpu_operator_torch.workloads.allreduce import run_allreduce
    from tpu_operator_torch.workloads.collectives import run_collectives_check
    from tpu_operator_torch.workloads.fabric import run_fabric_probe

    return {
        "allreduce": run_allreduce(device=device),
        "collectives": run_collectives_check(device=device),
        "fabric 2x2x1": run_fabric_probe("2x2x1", device=device),
        "fabric 4x1x1 wrap": run_fabric_probe("4x1x1", wrap=True, device=device),
    }


def _rates(out: dict) -> dict:
    rates = {f"allreduce {r['size_mb']} MiB busbw": r["busbw_gbps"]
             for r in out["allreduce"]["results"]}
    for probe in ("fabric 2x2x1", "fabric 4x1x1 wrap"):
        rates.update({f"{probe} edge {k}": v["bw_gbps"] for k, v in out[probe]["edges"].items()})
    return rates


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--json", type=pathlib.Path, default=None)
    args = parser.parse_args(argv)
    import torch

    from tpu_operator_torch.workloads.distributed import spawn_world
    from tpu_operator_torch.workloads.multiproc import run_multiprocess_check

    out = {"ranks": args.ranks, "device": args.device}
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"needs {args.ranks} cards, have {torch.cuda.device_count()}")
        cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.strip().splitlines()
        out["cards"] = cards
        for line in cards:
            print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    start = time.monotonic()
    out["world"] = spawn_world(args.ranks, _world_payloads, (args.device,), device=args.device,
                               timeout=600)[0]
    out["world_s"] = time.monotonic() - start
    world = out["world"]
    for r in world["allreduce"]["results"]:
        print(f"allreduce {r['size_mb']} MiB over {world['allreduce']['devices']} ranks: "
              f"{r['time_ms']:.5f} ms, algbw {r['algbw_gbps']:.2f} GB/s, busbw "
              f"{r['busbw_gbps']:.2f} GB/s", flush=True)
    print(f"collectives {world['collectives']['errors']}", flush=True)
    for probe in ("fabric 2x2x1", "fabric 4x1x1 wrap"):
        print(f"{probe}: edges " + ", ".join(f"{k} {v['bw_gbps']} GB/s"
                                           for k, v in world[probe]["edges"].items())
              + f"; axis all-reduce us {world[probe]['axis_allreduce_us']}", flush=True)
    print(f"world payloads in {out['world_s']:.1f} s with the ranks' start", flush=True)

    if args.device == "cuda":
        from tpu_operator_torch.validator import status as status_files

        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, COMPONENT="slice", VALIDATION_DIR=tmp)
            start = time.monotonic()
            # the component retries forever: the timeout counts as a failure
            proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.validator.main"],
                                  cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
            written = status_files.read_status("slice-ready", tmp)
        if proc.returncode != 0 or written is None:
            raise SystemExit(f"COMPONENT=slice exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        out["slice"] = dict(written, seconds=time.monotonic() - start)
        print(f"COMPONENT=slice with {written['devices']} local ranks: slice-ready in "
              f"{out['slice']['seconds']:.1f} s; busbw " + ", ".join(
                  f"{r['size_mb']} MiB {r['busbw_gbps']:.2f}" for r in written["results"])
              + f" GB/s; collectives {written['collectives']['errors']}; rings "
              f"{written['ring_attention']['max_abs_err']:.3g} / "
              f"{written['ring_flash_attention']['max_abs_err']:.3g}; flash "
              f"{written['flash_attention']['max_abs_err']:.3g}; pipeline "
              f"{written['pipeline']['losses']}", flush=True)

    start = time.monotonic()
    gang = run_multiprocess_check(num_workers=2, devices_per_worker=args.ranks // 2,
                                  timeout=600, device=args.device)
    out["gang"] = dict(gang, seconds=time.monotonic() - start)
    if not (gang["ok"] and gang["psum_ok"] and gang["ring_attention_max_err"] < 1e-4):
        raise SystemExit(f"gang check: {gang}")
    print(f"gang check 2 workers x {args.ranks // 2}: {gang['global_devices']} ranks on "
          f"{sorted({w['platform'] for w in gang['workers']})}, chain "
          f"{gang['psum_chain_ms']:.4f} ms per all-reduce, ring err "
          f"{gang['ring_attention_max_err']:.3g}, {out['gang']['seconds']:.1f} s", flush=True)

    rates = _rates(world)
    if "slice" in out:
        rates.update({f"slice allreduce {r['size_mb']} MiB busbw": r["busbw_gbps"]
                      for r in out["slice"]["results"]})
    out["rates"] = rates
    bar = PEAK_MARGIN * NVLINK_GBPS
    over = {k: v for k, v in rates.items() if v > bar}
    if args.device == "cuda" and over:
        raise SystemExit(f"rates above {bar} GB/s (105% of NVLink's {NVLINK_GBPS}): {over}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": True, "ranks": args.ranks, "rates_gbps": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
