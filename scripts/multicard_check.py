#!/usr/bin/env python3
"""The slice's multi-card payloads on the cards of one machine (four H100s
joined by NVLink), where ``chip_smoke.py`` has one card:

    python3 scripts/multicard_check.py [--ranks 4] [--json PATH]

0. the sharded burn-in step at the flagship's widths, bf16, as each rank's
   CUDA graph replay with the NCCL collectives captured inside it, against
   the same step run op by op (``step.eager``), ``GRAPH_STEPS`` calls each
   from the same params, on a (data 2, model 2) mesh with flash attention,
   a (data 1, sp 2, model 2) mesh with the ring over ``sp`` (its
   point-to-point transfers), packed documents and GQA, and a (model 2, ep
   2) mixture of experts with flash attention: losses within
   ``chip_smoke.GRAPH_REL_TOL`` relative (bit for bit is reported), the
   flash kernels launched as ``chip_smoke._expected_launches`` says, and
   the step's eager, replayed and device ms and device operations.
   ``--graphs-only`` runs this step alone;
1. a world of ``--ranks`` ranks, one per card (NCCL), runs
   ``run_allreduce()`` at the reference's sizes (each timed chain a graph
   replay; the same chains run op by op, ``allreduce._loop_seconds``,
   printed beside them), ``run_collectives_check()``,
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

Every rate (all-reduce busbw per size, replayed and op by op, each edge's
GB/s) is held to at most 105% of NVLink 4's 450 GB/s per direction (H100
SXM data sheet: 900 GB/s both ways); a higher reading is a timing fault.
Prints each card's name and power limit, one line per measurement, and
last a JSON line. ``--device cpu`` rehearses steps 0, 1, 3 and 4 on gloo
ranks (no rate bar, no graph: the CPU runs the eager code; step 2 needs
the cards).
"""

from __future__ import annotations

import argparse
import json
import math
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


# step 0: (mesh axes, config over the flagship's) of the graphed sharded steps
GRAPH_CONFIGS = {
    "flash data2 model2": (dict(data=2, model=2), dict(use_flash_attention=True)),
    "ring packed gqa sp2 model2": (dict(data=1, sp=2, model=2), dict(
        sequence_parallel=True, packed_segments=2, kv_heads=2)),
    "moe flash model2 ep2": (dict(data=1, sp=1, model=2, ep=2), dict(
        use_flash_attention=True, moe_experts=4)),
}


def _graphed_steps(device: str) -> dict:
    """Step 0 on one rank: each config's graphed step against its eager
    step (every rank gets the same losses)."""
    import dataclasses

    import torch

    from chip_smoke import (
        GRAPH_REL_TOL,
        GRAPH_STEPS,
        _curve_rel,
        _expected_launches,
        _step_losses,
        _step_times,
        read_launches,
        zero_launches,
    )
    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.workloads.burnin import build_train_step
    from tpu_operator_torch.workloads.spmd import named_mesh

    out = {}
    for name, (axes, over) in GRAPH_CONFIGS.items():
        cfg = dataclasses.replace(ENTRY_CONFIG, **over)
        step, params, batch = build_train_step(cfg, device, mesh=named_mesh(**axes))
        eager = getattr(step, "eager", step)  # the CPU's step is the eager one
        zero_launches()
        graphed = _step_losses(step, params, batch, GRAPH_STEPS)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_launches()
        # the CPU runs the kernels' plain versions, which launch nothing
        expected = (_expected_launches(counts, cfg, GRAPH_STEPS)
                    if cfg.use_flash_attention and device == "cuda" else {k: 0 for k in counts})
        losses = _step_losses(eager, params, batch, GRAPH_STEPS)
        rel = _curve_rel(graphed, losses)
        out[name] = {"graphed_losses": graphed, "eager_losses": losses, "rel_err": rel,
                     "bitwise": graphed == losses, "launches": counts,
                     "graphed": eager is not step}
        if device == "cuda":
            out[name].update(_step_times(step, params, batch))
        if not (rel <= GRAPH_REL_TOL and counts == expected and all(map(math.isfinite, graphed))
                and (device != "cuda" or out[name]["graphed"])):
            raise RuntimeError(f"graphed sharded step {name}: {out[name]}, launches expected "
                               f"{expected} (tol {GRAPH_REL_TOL})")
    return out


def _eager_allreduce(device: str, iters: int = 10) -> list:
    """``run_allreduce``'s sizes with each chain run op by op
    (``allreduce._loop_seconds``): the slowest rank's busbw per size."""
    import torch
    import torch.distributed as dist

    from tpu_operator_torch.workloads.allreduce import _loop_seconds, _slowest

    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device(device))
    n = dist.get_world_size()
    results = []
    for size_mb in (1, 4, 16, 64):
        per_chip = size_mb * 1024 * 1024 // 4
        _loop_seconds(torch.ones(per_chip, device=dev), n, iters)  # warm-up
        x = torch.full((per_chip,), 1.5, device=dev)
        dt = _slowest(_loop_seconds(x, n, iters), dev) / iters
        algbw = per_chip * 4 / dt / 1e9
        results.append({"size_mb": size_mb, "time_ms": dt * 1e3,
                        "busbw_gbps": algbw * 2 * (n - 1) / n})
    return results


def _world_payloads(device: str) -> dict:
    """One rank's reports (every rank gets the same)."""
    import torch

    from chip_smoke import graph_node_types
    from tpu_operator_torch.workloads.allreduce import _chain, run_allreduce
    from tpu_operator_torch.workloads.collectives import run_collectives_check
    from tpu_operator_torch.workloads.fabric import run_fabric_probe

    out = {
        "allreduce": run_allreduce(device=device),
        "allreduce eager loop": _eager_allreduce(device),
        "collectives": run_collectives_check(device=device),
        "fabric 2x2x1": run_fabric_probe("2x2x1", device=device),
        "fabric 4x1x1 wrap": run_fabric_probe("4x1x1", wrap=True, device=device),
    }
    if device == "cuda":
        n = torch.distributed.get_world_size()
        x = torch.ones(1 << 18, device="cuda")
        out["chain graph nodes"] = graph_node_types(lambda: _chain(x, n, 10))
    return out


def _rates(out: dict) -> dict:
    rates = {f"allreduce {r['size_mb']} MiB busbw": r["busbw_gbps"]
             for r in out["allreduce"]["results"]}
    rates.update({f"allreduce eager loop {r['size_mb']} MiB busbw": r["busbw_gbps"]
                  for r in out["allreduce eager loop"]})
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
    parser.add_argument("--graphs-only", action="store_true",
                        help="run step 0 (the graphed sharded steps) alone")
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
    if not (args.ici_only or args.trainer_only):
        out["graphs"] = _step_0(args, card)
        if args.graphs_only:
            _write(args.json, out)
            print(json.dumps({"ok": True, "ranks": args.ranks, "graphs": {
                k: {"rel_err": v["rel_err"], "bitwise": v["bitwise"]}
                for k, v in out["graphs"].items()}}), flush=True)
            return 0
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


def _step_0(args, card: str) -> dict:
    """The graphed sharded steps in one world of ``--ranks`` ranks."""
    from tpu_operator_torch.workloads.distributed import spawn_world

    start = time.monotonic()
    got = spawn_world(args.ranks, _graphed_steps, (args.device,), device=args.device,
                      timeout=600)[0]
    for name, r in got.items():
        times = (f"; step ms eager {r['step_ms']:.4f}, replay {r['step_replay_ms']:.4f}, "
                 f"device {r['step_device_ms']:.4f}, {r['step_graph_nodes']} device operations"
                 if "step_ms" in r else "")
        print(f"graphed sharded step {name} over {args.ranks} ranks: {len(r['graphed_losses'])} graphed "
              f"calls {[round(x, 6) for x in r['graphed_losses']]} vs eager "
              f"{[round(x, 6) for x in r['eager_losses']]}, rel {r['rel_err']:.3g}"
              f"{' (bit for bit)' if r['bitwise'] else ''}; launches "
              f"{({k: v for k, v in r['launches'].items() if v})}{times} ({card})", flush=True)
    print(f"graphed sharded steps in {time.monotonic() - start:.1f} s with the ranks' start",
          flush=True)
    return got


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
    how = "as a graph replay" if args.device == "cuda" else "(the CPU runs no graph)"
    for r, e in zip(world["allreduce"]["results"], world["allreduce eager loop"]):
        print(f"allreduce {r['size_mb']} MiB over {world['allreduce']['devices']} ranks: "
              f"{r['time_ms']:.5f} ms, algbw {r['algbw_gbps']:.2f} GB/s, busbw "
              f"{r['busbw_gbps']:.2f} GB/s {how}; op by op {e['time_ms']:.5f} ms, "
              f"busbw {e['busbw_gbps']:.2f} GB/s ({card})", flush=True)
    if "chain graph nodes" in world:
        print(f"a 10-all-reduce chain's graph over {args.ranks} ranks: "
              f"{world['chain graph nodes']}", flush=True)
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
