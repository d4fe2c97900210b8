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
   on NCCL: two loopback workers, each with its own half of the cards;
4. the elastic trainer (``workloads/training.py``) at the flagship's
   widths with flash attention, bf16: ``resume(4)``, a shrink
   ``resume(2)`` and a grow ``resume(4)``, each past a checkpoint so that
   steps are lost and re-executed, against one run on one card from the
   same seeded params: continuity (re-executed steps within 1e-3 of their
   first run), every loss within ``chip_smoke.TRAINER_LOSS_TOL`` of the
   one-card run's, a falling curve, and the params at the last step
   within ``chip_smoke.TRAINER_PARAMS_TOL`` of the one-card run's (the
   norm of the difference over the norm of the one-card run's change).
   Prints the losses, each resume's latency and the step ms of each world.
   ``--trainer-only`` runs this step alone;
5. the metrics exporter's ``probe_ici`` (``agents/metrics_exporter_agent.py``:
   the all-reduce at 16 MiB over every card, one rank per card, rank 0's
   bus rate) ``ICI_RUNS`` times in turn, each reading of
   ``tpu_exporter_ici_bandwidth_gbps`` printed. ``--ici-only`` runs this
   step alone.

Every rate (all-reduce busbw per size, each edge's GB/s) is held to at
most 105% of NVLink 4's 450 GB/s per direction (H100 SXM data sheet: 900
GB/s both ways); a higher reading is a timing fault. Prints each card's
name and power limit, one line per measurement, and last a JSON line.
``--device cpu`` rehearses steps 1, 3 and 4 on gloo ranks (no rate bar;
step 2 needs the cards).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import statistics
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


# step 5: how many worlds the exporter's probe_ici runs in turn
ICI_RUNS = 5


def _ici(device: str, ranks: int) -> dict:
    """Step 5: one exporter's ``probe_ici`` ``ICI_RUNS`` times in turn;
    each run starts its own world of one rank per card."""
    import prometheus_client

    from tpu_operator_torch.agents.metrics_exporter_agent import MetricsExporterAgent

    registry = prometheus_client.CollectorRegistry()
    exp = MetricsExporterAgent("multicard", registry=registry, active_probes="on",
                               device=device, cpu_ranks=ranks)
    readings, seconds = [], []
    for _ in range(ICI_RUNS):
        start = time.monotonic()
        exp.probe_ici()
        seconds.append(time.monotonic() - start)
        value = registry.get_sample_value("tpu_exporter_ici_bandwidth_gbps", {"node": "multicard"})
        errors = registry.get_sample_value("tpu_exporter_collect_errors_total",
                                           {"node": "multicard"})
        if value is None or errors:
            raise SystemExit(f"probe_ici: reading {value}, collect errors {errors}")
        readings.append(value)
        print(f"exporter probe_ici over {ranks} ranks: tpu_exporter_ici_bandwidth_gbps "
              f"{value:.2f} (16 MiB) in {seconds[-1]:.1f} s with the ranks' start", flush=True)
    return {"readings_gbps": readings, "seconds": seconds,
            "median_gbps": statistics.median(readings)}


# step 4: the schedule of worlds (hosts to resume at, steps to run) and the run
TRAINER_TOTAL, TRAINER_EVERY = 24, 5
TRAINER_WORLDS = ((4, 7), (2, 7), (4, TRAINER_TOTAL))  # lose 6-7, then 11-12


def _trainer(device: str, ranks: int, card: str) -> dict:
    """The elastic trainer on ``ranks`` cards: shrink and grow against a
    one-card run."""
    from chip_smoke import (
        TRAINER_LOSS_TOL,
        TRAINER_OVERRIDES,
        TRAINER_PARAMS_TOL,
        host_arrays,
        params_gap,
    )
    from tpu_operator_torch.workloads.burnin import build_train_step
    from tpu_operator_torch.workloads.checkpoint import CheckpointStore
    from tpu_operator_torch.workloads.training import (
        ResumableTrainer,
        trainer_config,
        verify_continuity,
    )

    cfg = trainer_config(TRAINER_OVERRIDES)
    start = host_arrays(build_train_step(cfg, "cpu")[1])  # both trainers' seeded params
    with tempfile.TemporaryDirectory() as tmp:
        one_store = CheckpointStore(os.path.join(tmp, "one"))
        one = ResumableTrainer(one_store, cfg, total_steps=TRAINER_TOTAL,
                               checkpoint_every=TRAINER_EVERY, device=device)
        one.resume(1)
        one.run(TRAINER_TOTAL)
        one.close()
        elastic_store = CheckpointStore(os.path.join(tmp, "elastic"))
        elastic = ResumableTrainer(elastic_store, cfg, total_steps=TRAINER_TOTAL,
                                   checkpoint_every=TRAINER_EVERY, device=device,
                                   cpu_ranks=ranks)
        segments = []
        try:
            for hosts, steps in TRAINER_WORLDS:
                info = elastic.resume(hosts)
                done_before = len(elastic.history)
                elastic.run(steps)
                times = elastic.step_times[info.world][-(len(elastic.history) - done_before):]
                segments.append({"world": info.world, "resumed_at": info.step,
                                 "resume_s": info.latency_s, "steps": len(times),
                                 # the first step of a world warms its kernels and caches
                                 "step_ms_median": 1e3 * statistics.median(times[1:]),
                                 "step_ms_min": 1e3 * min(times[1:])})
        finally:
            elastic.close()
        gap = params_gap(elastic_store.latest_good().arrays, one_store.latest_good().arrays,
                         start)
    report = verify_continuity(elastic.history, elastic.checkpoints, TRAINER_TOTAL)
    want = {h["step"]: h["loss"] for h in one.history}
    rel = max(abs(h["loss"] - want[h["step"]]) / abs(want[h["step"]]) for h in elastic.history)
    out = {"card": card, "segments": segments, "continuity": report, "rel_to_one_card": rel,
           "params_gap_to_one_card": gap, "losses": elastic.history,
           "one_card_losses": one.history}
    for s in segments:
        print(f"trainer world {s['world']}: resumed at step {s['resumed_at']} in "
              f"{s['resume_s']:.3f} s, {s['steps']} steps, step ms median "
              f"{s['step_ms_median']:.4f} (min {s['step_ms_min']:.4f}) ({card})", flush=True)
    print(f"trainer losses {[(h['step'], h['world'], round(h['loss'], 6)) for h in elastic.history]}"
          f"; one card {[round(h['loss'], 6) for h in one.history]}; largest gap {rel:.3g} "
          f"relative (tol {TRAINER_LOSS_TOL}); params at step {TRAINER_TOTAL} {gap:.3g} of the "
          f"one-card run's change (tol {TRAINER_PARAMS_TOL}); continuity {report} ({card})",
          flush=True)
    curve = {h["step"]: h["loss"] for h in elastic.history}
    if not (elastic.done and report["ok"] and report["rewinds"] == 2
            and [s["world"] for s in segments] == [4, 2, 4] and rel <= TRAINER_LOSS_TOL
            and curve[TRAINER_TOTAL] < curve[1] and gap <= TRAINER_PARAMS_TOL):
        raise SystemExit(f"trainer: {out}")
    return out


def _write(path, out: dict) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1, default=str))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--json", type=pathlib.Path, default=None)
    parser.add_argument("--trainer-only", action="store_true",
                        help="run step 4 (the elastic trainer) alone")
    parser.add_argument("--ici-only", action="store_true",
                        help="run step 5 (the exporter's probe_ici) alone")
    args = parser.parse_args(argv)
    import torch

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
    card = out["cards"][0].split(", ", 1)[1] if args.device == "cuda" else "CPU, gloo"
    if not args.ici_only:
        _steps_1_to_4(args, out, card)
        if args.trainer_only:
            return 0

    out["ici"] = _ici(args.device, args.ranks)
    rates = _rates(out["world"]) if "world" in out else {}
    if "slice" in out:
        rates.update({f"slice allreduce {r['size_mb']} MiB busbw": r["busbw_gbps"]
                      for r in out["slice"]["results"]})
    rates.update({f"probe_ici run {i}": v for i, v in enumerate(out["ici"]["readings_gbps"])})
    out["rates"] = rates
    bar = PEAK_MARGIN * NVLINK_GBPS
    over = {k: v for k, v in rates.items() if v > bar}
    if args.device == "cuda" and over:
        raise SystemExit(f"rates above {bar} GB/s (105% of NVLink's {NVLINK_GBPS}): {over}")
    _write(args.json, out)
    print(json.dumps({"ok": True, "ranks": args.ranks, "rates_gbps": rates}), flush=True)
    return 0


def _steps_1_to_4(args, out: dict, card: str) -> None:
    """Step 4 (the elastic trainer) then steps 1-3, into ``out``; with
    ``--trainer-only`` step 4 alone, its result line printed."""
    from tpu_operator_torch.workloads.distributed import spawn_world
    from tpu_operator_torch.workloads.multiproc import run_multiprocess_check

    out["trainer"] = _trainer(args.device, args.ranks, card)
    if args.trainer_only:
        _write(args.json, out)
        print(json.dumps({"ok": True, "ranks": args.ranks, "trainer": {
            "continuity": out["trainer"]["continuity"]["ok"],
            "rel_to_one_card": out["trainer"]["rel_to_one_card"],
            "params_gap_to_one_card": out["trainer"]["params_gap_to_one_card"]}}), flush=True)
        return

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


if __name__ == "__main__":
    sys.exit(main())
