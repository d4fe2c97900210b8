#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``tpu_operator_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):

1. device — CUDA must be present; prints the card's name and power limit;
2. build — compiles every CUDA source of the ``KERNELS`` table
   (``flash_fwd.cu``, ``flash_bwd.cu``, ``triad.cu``) from the repository,
   and the two flash sources again for fp16 (``build.VARIANTS``:
   ``flash_fwd_f16``, ``flash_bwd_f16``) and for head dims 512 and 576 in
   bf16 with f32 and in fp16 (``flash_fwd_d512``, ``flash_bwd_d512``,
   ``flash_fwd_f16_d512``, ``flash_bwd_f16_d512`` and the same four
   ``*_d576``) and the D-streaming kernels of head dims above 576
   (``flash_fwd_wide``, ``flash_bwd_wide``, ``flash_fwd_f16_wide``,
   ``flash_bwd_f16_wide``), one ``nvcc`` each, all seventeen started
   together; prints
   each library's ptxas report (registers,
   spills) and, from ``cuobjdump --dump-sass``, the ``HGMMA`` (tensor-core)
   instructions of every bf16 instantiation of both forward kernels (18:
   the triangle's 9 and the general kernel's 9, head dims 16-128 at one and
   two warpgroups and 256 at one) and of both backward pairs (36), of
   the same 18 + 36 in fp16 (54), and of the D 512 and D 576 libraries' 6
   each (one warpgroup, ``HEAD_DIM_512_INSTANTIATIONS``,
   ``HEAD_DIM_576_INSTANTIATIONS``) and the wide libraries' 2 forward and 4
   backward each (``WIDE_HEAD_INSTANTIATIONS``: both forwards, both pairs),
   failing when one has none, when an instantiation spills registers (a D
   576 or wide library's f32 kernels too: ``flash_fwd_wide`` must hold
   the f32 forward's four cluster instantiations, the triangle and the
   general masks at 64- and 16-row q tiles, ``F32_CLUSTER_INSTANTIATIONS``,
   and its twelve tile kernels at head dims 32-128 (slab widths 32, 64 and
   128, 64- and 16-row q tiles, ``F32_FWD_TILE_KERNELS``; at 32 and 64
   columns at most 128 registers),
   and ``flash_bwd_wide`` the backward pair's four cluster kernels and the
   split dK/dV walk's sum, ``F32_BWD_CLUSTER_KERNELS``, each at most 255
   registers, and its eight kernels at head dims 32-128 at slab widths 64
   and 128, ``F32_BWD_TILE_KERNELS``, dQ's at 64 at most 128; the D 512
   and 576 libraries no f32 kernel; ``flash_fwd`` and ``flash_bwd`` the
   whole-row f32 kernels at head dim 16 alone and ``flash_fwd_f16`` and
   ``flash_bwd_f16`` no f32 kernel, and the backward's one split sum
   of their 16-bit type each,
   ``SPLIT_SUM_LIBRARIES``, at 0 spill bytes), or
   when ptxas serialized its ``wgmma`` or ignored its ``setmaxnreg``;
   the D 256 forwards must be the 128-row CTAs' instantiations
   (``HEAD_DIM_256_FORWARDS``) in both 16-bit libraries;
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
   shapes (phase 9); at head dim 256 (Gemma-2B's (1,8192,8,256) with one kv
   head, plain causal and packed, the forwards and both pairs; full
   attention at (1,4096,8,256) in bf16 and fp16; packed in three
   documents out of order, ids 0, 1, 0; f32 (2,128,4,256) and serving's f32
   prefill chunk) and on the zero-padded route (Phi-3-mini's (1,4096,32,96), and
   head dims 80 and 112, each run at 128 with its own scale and held to the
   plain version at its own head dim); 16-bit rows at head dim 256 have one
   tile height only, so they time no other; fp16 rows of all six flash
   kernels (``FLOAT16_KERNEL_CASES``, ``FLOAT16_BWD_CASES``) at the burn-in's
   (8,128,4,64) plain and packed, (1,4096,8,128), Phi-3-mini's padded
   (1,4096,32,96) plain and packed and Gemma-2B's (1,8192,8,256) with one kv
   head, SDPA timed in fp16, each also run in bf16 on its inputs rounded to
   bf16, whose error it must stay below, and one backward row whose dO is
   scaled by 2^-22 (Phi-3-mini's full-width cotangent, fp16 subnormals),
   held to the plain version within 2e-2 of max |grad| or the subnormal
   steps a differently rounded dS can move (``FP16_SUBNORMAL_STEP``); rows
   at head dim 512 (``HEAD_DIM_512_KERNEL_CASES``, ``HEAD_DIM_512_BWD_CASES``:
   DeepSeek-V4-Flash's (1,8192,8,512) with one kv head, plain causal and
   packed in bf16 and fp16, window 128 in bf16; full attention at
   (1,4096,8,512); f32 (2,128,4,512) and serving's f32 prefill chunk; ragged
   lengths 100 and 1000 at GQA 2; the zero-padded route at 384); rows at
   head dim 576 (``HEAD_DIM_576_KERNEL_CASES``, ``HEAD_DIM_576_BWD_CASES``:
   sarvam-105b's absorbed-MLA attention (1,8192,8,576) with one kv head,
   plain causal, window 128 and packed, in bf16 and fp16; full attention
   at (1,4096,8,576); f32 (2,128,4,576) and serving's f32 prefill chunk;
   ragged lengths 100 and 1000 at GQA 2; the zero-padded route at 544 and
   520; the general f32 forward at (2,128,4,576) with a window of 33 and
   segments); the f32 forwards and backward pairs at head dims 256 and
   above run in thread-block clusters, at 32-128 a CTA a tile (each such
   row also logs its q tile height or dK/dV's GQA
   split, its slab width and the clusters, or CTAs, resident; a backward row
   runs each kernel twice for the same bits and, where the plan splits
   the walk, times dK/dV at split 1 too, ``_split_check``; every bf16 and
   fp16 backward row up to head dim 256 does the same at its plan's split
   of dK/dV's GQA walk, from the card's resident dK/dV CTAs), with rows
   past launch-bound sizes, the forward at (1,2048,8,512) and
   (1,2048,8,1024) and the backward pair at (1,2048,8,256) and
   (1,2048,8,512), each with one kv head; the f32 pairs up to 128 at
   (2,128,4,16) (the whole-row pair), (2,128,4,32) full, the entry() widths' (8,128,4,64),
   (1,2048,8,{64,128}) with one kv head and the ragged general pair at
   (2,1000,4,128) with GQA 2 and segments cut at 333; the f32 forwards up
   to 128 (``F32_TILE_KERNEL_CASES``, their inputs from a generator of their
   own, ``F32_TILE_SEED``, so that no other row's inputs moved with them;
   and ``KERNEL_CASES``' older f32 rows): the triangle at (2,128,4,{16,64,128}) (16: the whole-row
   kernel), the entry() widths' (8,128,4,64) and (1,2048,8,{64,128}) with
   one kv head, the general kernel at the entry() widths packed in two
   documents, (2,128,4,64) full and with a window of 33 and segments cut at
   88, the ragged (2,1000,4,128) with GQA 2 and segments cut at 333 and
   serving's chunk at head dim 64 (16-row q tiles); rows above 576
   on the D-streaming kernels (``WIDE_KERNEL_CASES``,
   ``WIDE_BWD_CASES``: phase 19's (1,8192,8,1024) with one kv head in bf16
   and fp16, (1,8192,8,640) and the zero-padded (1,4096,8,700) in bf16, f32
   (2,128,4,1024) and ragged (2,100,4,640) at GQA 2, both forwards and the
   triangle pair; the f32 triangle pair at (1,2048,8,1024) with one kv head
   and at (1,128,2,2048), two clusters a tile; the general forward at full attention (1,4096,8,1024) and
   serving's f32 chunk at 1024; the general pair at phase 19's shape packed
   in two documents (bf16 and fp16) and under a window of 128, at full
   attention (1,4096,8,1024), at (2,1000,4,700) padded to 704 with GQA 2, a
   window and segments, and in f32 at (2,128,4,1024) with a window and
   segments and ragged (2,100,4,640) at GQA 2 with segments; a
   (1,1024,4,2048) triangle forward; ``WIDE_CLUSTER_BWD_CASES``, from a
   generator of their own: the bf16 triangle pair at (1,1024,4,2048), two
   clusters a tile, and at (1,4096,8,1024) with 8 kv heads, each 16-bit row
   above 576 with its clusters resident; ``WIDE_CLUSTER_FWD_CASES``, from a
   generator of their own: the bf16 general forward at phase 19's packed
   step's shapes, (1,8192,8,1024) with one kv head in two documents and
   under a window of 128; each 16-bit forward above 576 with its slab
   clusters and how many the card holds at once, held to the same bits in
   two runs), each
   row naming the SDPA backend that answered its library call; then
   the validator payload ``run_flash_attention_check()``;
4. burn-in — the flagship forward (``entry(use_flash_attention=True)``)
   through the triangle kernel, against the port's dense path;
5. serving — the default-geometry ``DecodeEngine`` with flash prefill
   answers 16 requests through the general kernel, its decode and each
   prefill offset as CUDA graph replays, with the same greedy tokens as
   dense prefill and as the same engine run op by op (``eager_engine``),
   and as many launches, and as the same engine with its int8 MLP weights
   row-major (``row_major_engine``; the engine lays them out
   column-major); one decode's and one prefill's eager, replayed and
   device ms and device operations (``graph_nodes``), with both layouts;
6. train — ``run_burnin(steps=3)`` at ``entry()`` widths with flash
   attention: plain causal (the triangle pairs, 2 launches of each kernel
   per step), ``kv_heads=2`` (a GQA group inside the dK/dV kernel) and
   ``packed_segments=2`` (the general pairs). Each loss curve must fall
   and stay within bf16 tolerance of the dense path's from the same
   params (the packed one of the same run on the CPU, where attention
   takes the plain versions: the dense path has no segment ids); an f32
   gradient check of ``flash_attention`` against autograd through dense
   attention; an f32 TPUJob's trainer at ``entry()`` widths
   (``trainer_config`` with dtype float32, ``F32_TPUJOB_CONFIGS``: plain
   and packed in two documents) through ``run_burnin(steps=3)``, within
   1e-4 relative of the f32 dense path (packed: the CPU plain versions),
   with exactly the f32 pair's launches and split sums per step
   (``_f32_tpujob``); ``GRAPH_STEPS`` calls of the train step (a CUDA graph replay:
   the first call eager, then captured) against its eager step from the
   same params, within ``GRAPH_REL_TOL``; the step's eager, replayed and
   device ms and device operations;
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
   fails the phase. Each timed chain is a graph replay per timed call
   (``kernels/graph.GraphedChain``): every probe's captures (one per
   chain length) and timed replays are counted and held to its timing's
   pattern. Then every timed chain of the port (``chain_rows``: the triad
   at 64 and 128 MiB, bf16 at 8192, 4096 and 256, int8 at 8192,
   ``flash_attention_bench()``'s flash forward and fwd+bwd, the sweep's
   flash forward at (1,8192,8,128), the gang's telemetry chain) runs in
   turns as the eager
   loop (``eager_chains``: the chain function called in a Python loop) and
   as graph replays, with each run's rates, captures and replays and peak
   memory;
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
   worker on the card (TCP rendezvous, NCCL), its telemetry chain three
   timed replays, then 2 workers x 2 ranks and 2 slices x 1 host x 2
   ranks on gloo (one card cannot hold two NCCL ranks), their telemetry
   chains eager;
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
   step (once per layer) and nothing else. (c) The same trainer run as (a)
   with ``packed_segments=2``: the general kernels, exactly twice each per
   executed step and no triangle launch, with (a)'s bars; its first losses
   are held to the CPU plain versions' (the dense path takes no segment
   ids), as phase 6 holds its packed curve;
11. replicas — serving replicas (``ServingWorkerMain``, flash prefill)
   warm-started through the fleet compile cache: (a) a process of its own
   over an empty ``TPU_COMPILE_CACHE_DIR`` misses, builds ``flash_fwd``
   (and no fp16 library) into it and publishes its measured warm-up; (b)
   a second process over that directory and ConfigMap hits and creates or
   rewrites no file there; (c) an aggregated replica and (d) a prefill-pool and a
   decode-pool replica with the router's hand-off loop answer phase 5's
   16 requests with phase 5's greedy tokens (48 ``flash_fwd_rect``
   launches each, nothing else); tok/s and TTFT of both;
12. autotune — ``run_generation_sweep`` at the "cuda" profile: both tile
   heights of both flash families and the matmul and int8 chains at 8192,
   no error, every rate within 105% of the data-sheet peak, the winner the
   best stable rate, the triangle kernels launched at both heights and no
   other kernel; the winners published through ``TPU_AUTOTUNE_JSON`` and
   run by an untuned ``flash_attention`` at (1,8192,8,128), within 2e-2 of
   ``attention_plain``; the variable unset again;
13. agents — the node agents on node "h100-0" (GPU feature discovery's
   product and count labels, the card resource allocatable) under
   ``_DictClient``, every probe in ``on`` mode: (a) the autotune agent,
   elected, sweeps ("swept": the "cuda" profile, phase 12's bars, an entry
   under ``h100-sxm.json`` that ``entry_valid`` takes, the triangle kernels
   at both heights and no other), then "cache-hit" with 0 writes; (b)
   ``merge_winner_floors`` folds its matmul and int8 winners at 0.7 into
   the floors ConfigMap; (c) the metrics exporter held to those floors:
   one card, the HBM limit within 1% of the card's memory and some in use,
   ``probe_bandwidth`` through exactly 1226 triad launches within 105% of
   the data sheet, ``probe_utilization`` likewise and its share of the
   peak, no interconnect series on one card, no perf label at the folded
   floor; then a floor of twice the peak hot-reloaded flips
   ``tpu_exporter_perf_degraded`` and the node's perf label after 3
   samples, the folded floor back clears it on the next; 0 collect
   errors; the exposition on one line; (d) one health pass over the real
   ``/dev`` ("healthy", the matmul burst, the verdicts file, label,
   annotations and condition); (e) the compile-cache agent in a fresh
   process over an empty cache directory ("prewarmed" the default serving
   config, a record of the measured warm-up, an ack), again ("cache-hit",
   0 writes), and a default-config ``ServingWorkerMain`` over the record
   ("hit"); (f) the validator's ``plugin`` component (``nvidia.com/gpu``,
   ``plugin-ready``) and ``workload`` component, whose pod's container a
   kubelet thread runs as a child process with exactly the spec's command
   and env (exit 0, the smoke report), the pod's phase following the exit
   (``workload-ready``, no pod left);
14. device layer — the node's device layer on node "h100-0", first
   unlabelled, under ``_DictClient`` and temporary host paths: (a) the card
   probe (``native/gpuinfo``, built with ``g++``) answers natively, the
   Python scan of the same paths equals it, and it finds exactly the
   cards CUDA sees, with their UUIDs and models and ``nvidia-smi``'s driver
   version; (b) the driver installer copies the loader's ``libcuda.so.1``
   into a temporary install dir (the versioned file, the symlink, the
   version file, the ready marker), and a rerun changes nothing; (c) the
   validator's ``driver`` component: the installed library, loaded in a
   process of its own, counts the probe's cards and ``driver-ready`` is
   written; without the marker the component fails and clears it; (d)
   node discovery then feature discovery stamp NFD's presence, GFD's count
   and product, so ``node_generation`` is ``"h100-sxm"`` and
   ``expected_cards`` the card count; (e) the device plugin serves, registers
   ``nvidia.com/gpu`` with a kubelet stand-in (the Registration service on a
   unix socket), whose ``ListAndWatch`` follower writes the node's
   allocatable: every card Healthy, then the validator's ``plugin``
   component writes ``plugin-ready`` with nothing written by hand; a
   verdicts file marking the cards Unhealthy, then cleared, is published
   both ways; ``Allocate`` of one card gives a child process, run under
   exactly the response's env, one card with the allocated UUID, the
   installed driver library and a passing ``run_smoke``; the health monitor
   over the plugin's socket and the installer's dir reads "healthy" with no
   reasons; (f) ``NodeMetrics``: the ready files of (c) and (e), the card
   gauge at the card count, one successful revalidation, then without the
   marker a failed one that clears ``driver-ready``;
15. head dims — what a head dim other than 16-128 runs through: (a)
   Gemma-2B's widths as a TPUJob's ``spec.workload.config``
   (``GEMMA_2B``: d_model 2048, 8 heads, 1 kv head, head dim 256, d_ff
   16384, seq 8192, batch 1; depth cut 18 -> 1) through
   ``training.trainer_config``: ``run_burnin(steps=3)`` with flash
   attention (a launch per step of each triangle kernel) held to the
   dense path from the same params within 2e-2 relative, falling, and the
   seeded forward output to the dense path's within ``FORWARD_GAP_TOL``
   (as are (d)'s and the packed run's, whose loss curves cannot tell a
   wrong attention from a right one);
   ``GRAPH_STEPS`` graphed steps against the eager step within
   ``GRAPH_REL_TOL``, the step's eager, replayed and device ms; the
   elastic trainer for 6 steps, a checkpoint every 3, a fault at 5 and a
   resume (``verify_continuity`` ok, step 4 re-executed bit for bit, the
   first losses run_burnin's); the same config with ``packed_segments=2``
   (the general pairs, not cut) held to the dense path under the
   documents' mask on the card; (b) f32 ``flash_attention`` gradients at
   (1,256,2,256) against autograd through dense attention within 1e-4,
   plain causal and with a window and two segments, each f32 cluster
   kernel launched exactly once per case (``_f32_pair_launches``); (c) serving at head
   dim 256 (``ServingModelConfig(head_dim=256, use_flash_prefill=True)``,
   f32): phase 5's 16 requests with dense prefill's greedy tokens, 48
   ``flash_fwd_rect`` launches; (d) Phi-3-mini's widths (``PHI3_MINI``:
   d_model 3072, 32 heads, head dim 96, d_ff 8192, seq 4096; depth cut 32
   -> 1), the zero-padded route, ``run_burnin(steps=3)`` against the dense
   path with (a)'s bars and exact launches;
16. float16 — a TPUJob config that asks for ``dtype: float16``: (a) at
   ``entry()`` widths with flash attention, ``run_burnin(steps=3)`` plain,
   ``kv_heads=2``, ``packed_segments=2`` and ``moe_experts=4``, each with
   its exact launches (every launch of this phase is an fp16 one), held to
   the fp16 dense path within 2e-2 relative (packed: the CPU plain
   versions), ``GRAPH_STEPS`` graphed steps against the eager step within
   ``GRAPH_REL_TOL``, the step's eager, replayed and device ms; (b)
   Phi-3-mini's widths (``PHI3_MINI_F16``, depth cut 32 -> 1) through
   ``training.trainer_config``: phase 15 (a)'s bars (flash against dense,
   the seeded forward output within ``FORWARD_GAP_TOL``, the graphed steps,
   the elastic trainer for 6 steps with a fault at 5 and a resume, the
   packed run against the dense path under the documents' mask); and at
   both widths the cotangent that reaches attention's backward (its share
   of exact zeros and of subnormals, rms and max) beside the magnitude the
   loss reckons, 2·√loss/N; the card's name and power limit on every
   line of numbers;
17. head dim 512 — (a) DeepSeek-V4-Flash's attention widths as a TPUJob's
   config (``DEEPSEEK_V4_FLASH``: d_model 4096, 8 heads of 512, 1 kv head,
   d_ff 2048, seq 8192, 1 layer; cut from 64 heads, 43 layers and a 1M
   context)
   through ``training.trainer_config``: phase 15 (a)'s bars (flash against
   dense within 2e-2 relative and falling, the seeded forward output within
   ``FORWARD_GAP_TOL``, exact launches, ``GRAPH_STEPS`` graphed steps
   against the eager step, the elastic trainer with a fault and a resume,
   shallower than phase 15's: ``WIDE_TRAINER_RUN``, a checkpoint every 2
   steps and a fault at 4), ``packed_segments=2`` against the dense path
   under the documents' mask, and ``dtype: float16`` against the fp16 dense path;
   (b) f32 ``flash_attention`` gradients at (1,256,2,512) against autograd
   through dense attention within 1e-4, plain causal and with a window of
   128 and two segments, exact launches as phase 15's; (c) serving at head dim 512
   (``ServingModelConfig(head_dim=512, use_flash_prefill=True)``, f32):
   phase 5's 16 requests with dense prefill's greedy tokens, 48
   ``flash_fwd_rect`` launches; (d) the zero-padded route at 384 is phase
   3's rows at its true scale; the phase's seconds;
18. head dim 576 — (a) sarvam-105b's attention widths as a TPUJob's config
   (``SARVAM_105B``: d_model 4608, 8 heads of 576 on 1 kv head, d_ff 2048,
   seq 8192; cut from 64 heads, 32 layers and a 128K context; MLA's
   absorbed attention shape through the burn-in's GQA block) through
   ``training.trainer_config``: phase 17 (a)'s bars (flash against dense,
   the seeded forward output, exact launches, the graphed steps, the
   elastic trainer through a fault and a resume), ``packed_segments=2``
   against the dense path under the documents' mask, and ``dtype:
   float16`` against the fp16 dense path; (b) f32 ``flash_attention``
   gradients at (1,256,2,576) against autograd through dense attention
   within 1e-4, plain causal and with a window of 128 and two segments; (c)
   serving at head dim 576 (f32): phase 5's 16 requests with dense
   prefill's greedy tokens, 48 ``flash_fwd_rect`` launches; (d) the
   phase's seconds;
19. head dim above 576 — (a) a burn-in configuration of the repo's own
   (``WIDE_HEAD_1024``: d_model 8192, 8 heads of 1024 on 1 kv head, d_ff
   2048, seq 8192, 1 layer; not a published model: no model in the catalog
   has heads wider than 576) through ``training.trainer_config``, on the
   D-streaming kernels: flash against the dense path within 2e-2 relative
   and falling, the seeded forward output within ``FORWARD_GAP_TOL``, exact
   launches, ``GRAPH_STEPS`` graphed steps bit for bit equal to the eager
   step, the step's eager, replayed and device ms, the elastic trainer
   through a fault and a resume (phase 17's); (b) ``packed_segments=2``
   through the general pair: against the dense path under the documents'
   mask within 2e-2 relative and falling, the forward output's gap,
   exactly 3 launches of each general kernel and none of the triangle's,
   ``GRAPH_STEPS`` graphed steps bit for bit; (c) f32 ``flash_attention``
   gradients at (1,256,2,1024) against autograd through dense attention
   within 1e-4: plain causal, a window of 128 with two segments, full
   attention; (d) serving at head dim 1024 (f32): phase
   5's 16 requests with dense prefill's greedy tokens, 48
   ``flash_fwd_rect`` launches; (e) the phase's seconds.

Launch counts are zeroed just before each main path and read just after.
The line before last is ``{"kernels": [...]}`` (from the ``KERNELS``
table); the last line is ``{"ok": true, "device": {...}}``. ``--json
PATH`` also writes the full results (every shape's timings, the
compiler's register report) there.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
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
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float16: 989e12,            # dense tensor-core fp16
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


def capture(graph):
    """The port's capture guard (``kernels/graph.capture``): no graph that a
    dead reference cycle holds is destroyed during the capture."""
    from tpu_operator_torch.kernels.graph import capture as guarded

    return guarded(graph)


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
    with capture(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(graph.replay, inner, reps)
    del graph
    return ms


# libcuda's CUgraphNodeType values, in order
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child graph", "empty", "event wait",
                    "event record", "semaphore signal", "semaphore wait", "alloc", "free",
                    "batch memop", "conditional")


def graph_node_types(fn) -> dict:
    """The device operations (kernels, copies, memsets, ...) of one call of
    ``fn`` by kind: the nodes of a CUDA graph that captures it, from
    libcuda's ``cuGraphGetNodes``: what one replay launches, and an eager
    call launches one by one."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with capture(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    code = cuda.cuGraphGetNodes(raw, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if not code:
        code = cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    kinds = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        code = code or cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        name = (GRAPH_NODE_TYPES[kind.value] if 0 <= kind.value < len(GRAPH_NODE_TYPES)
                else f"type {kind.value}")
        kinds[name] = kinds.get(name, 0) + 1
    if code:
        raise RuntimeError(f"cuGraphGetNodes/cuGraphNodeGetType failed with CUresult {code}")
    del graph
    return kinds


def graph_nodes(fn) -> int:
    """The number of device operations of one call of ``fn``
    (:func:`graph_node_types`)."""
    return sum(graph_node_types(fn).values())


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


# the tensor-core kernels' element types as the mangled names spell them
BF16_MANGLED, F16_MANGLED = "13__nv_bfloat16", "6__half"


def _fwd_label(mangled: str, elem: str):
    found = re.search(rf"flash_fwd_(tri|rect)_kernelI{elem}Li(\d+)ELi(\d+)E", mangled)
    if not found:
        return None
    kind, d, wg = found.groups()
    return f"{'rect_' if kind == 'rect' else ''}d{d}_wg{wg}"


def fwd_bf16_label(mangled: str):
    """A label for a bf16 tensor-core instantiation of a forward kernel:
    ``d<D>_wg<WG>`` for the triangle (``flash_fwd_tri_kernel<__nv_bfloat16,
    D, WG>``), ``rect_d<D>_wg<WG>`` for the general kernel
    (``flash_fwd_rect_kernel<...>``); else None."""
    return _fwd_label(mangled, BF16_MANGLED)


def fwd_f16_label(mangled: str):
    """:func:`fwd_bf16_label` for the fp16 instantiations
    (``flash_fwd_{tri,rect}_kernel<__half, D, WG>``)."""
    return _fwd_label(mangled, F16_MANGLED)


def tri_bf16_label(mangled: str):
    """``d<D>_wg<WG>`` for a bf16 instantiation of the triangle forward
    (``flash_fwd_tri_kernel<__nv_bfloat16, D, WG>``), else None."""
    label = fwd_bf16_label(mangled)
    return None if label is None or label.startswith("rect_") else label


def _bwd_label(mangled: str, elem: str):
    found = re.search(rf"flash_bwd_(dq|dkv)_(tri|rect)_kernelI{elem}Li(\d+)ELi(\d+)E", mangled)
    if not found:
        return None
    kind, pair, d, wg = found.groups()
    return f"{kind}{'_rect' if pair == 'rect' else ''}_d{d}_wg{wg}"


def wide_label(mangled: str, elem: str = BF16_MANGLED):
    """A label for a 16-bit instantiation of a D-streaming kernel
    (``flash_fwd_wide_kernel<T, TRI>``,
    ``flash_bwd_{dq,dkv}_{tri,rect}_wide_kernel<T>``): ``wide_tri``,
    ``wide_rect``, ``dq_wide``, ``dkv_wide``, ``dq_rect_wide`` or
    ``dkv_rect_wide``; else None."""
    found = re.search(rf"flash_fwd_wide_kernelI{elem}Lb([01])E", mangled)
    if found:
        return "wide_tri" if found.group(1) == "1" else "wide_rect"
    found = re.search(rf"flash_bwd_(dq|dkv)_(tri|rect)_wide_kernelI{elem}E", mangled)
    if not found:
        return None
    return f"{found.group(1)}{'_rect' if found.group(2) == 'rect' else ''}_wide"


def wide_f16_label(mangled: str):
    """:func:`wide_label` for the fp16 instantiations."""
    return wide_label(mangled, F16_MANGLED)


# the f32 forward's cluster kernels in the flash_fwd_wide library: the triangle
# and the general masks at 64- and 16-row q tiles
F32_CLUSTER_INSTANTIATIONS = ("fwd_tri_64", "fwd_tri_16", "fwd_rect_64", "fwd_rect_16")
# and at head dims 32-128, one CTA a tile, at slab widths 32, 64 and 128 (the
# head dim) and 64- and 16-row q tiles; at 16 the base library's whole-row
# kernels (whole_row_f32)
F32_FWD_TILE_KERNELS = tuple(
    f"flash_fwd_{pair}_tile_f32_kernel<{width}, {rows}>" for pair in ("tri", "rect")
    for width in (32, 64, 128) for rows in (64, 16))


# and the backward pair's in flash_bwd_wide: at head dims 256 and above dQ and
# dK/dV under both masks, and the kernel that adds a split dK/dV walk's parts
F32_BWD_CLUSTER_KERNELS = tuple(
    f"flash_bwd_{kind}_{pair}_wide_f32_kernel" for kind in ("dq", "dkv") for pair in ("tri", "rect")
) + ("flash_bwd_dkv_split_sum_kernel",)
# and at 32-128, one CTA a tile, at the slab widths 64 (d 32, 64) and 128; at 16
# the base library's whole-row pair (whole_row_f32)
F32_BWD_TILE_KERNELS = tuple(
    f"flash_bwd_{kind}_{pair}_tile_f32_kernel<{width}>" for kind in ("dq", "dkv")
    for pair in ("tri", "rect") for width in (64, 128))


def f32_label(mangled: str):
    """A label for an f32 CUDA-core kernel of a wide library: the forward's
    ``flash_fwd_f32_cluster_kernel<TRI, BM>`` as ``fwd_tri_<BM>`` or
    ``fwd_rect_<BM>`` and up to head dim 128 with its slab width and q rows
    (``flash_fwd_{tri,rect}_tile_f32_kernel<W, BM>``), the backward pair's by
    name (``flash_bwd_{dq,dkv}_{tri,rect}_wide_f32_kernel``,
    ``flash_bwd_dkv_split_sum_kernel``) and up to head dim 128 with its slab
    width (``flash_bwd_{dq,dkv}_{tri,rect}_tile_f32_kernel<W>``); else
    None."""
    found = re.search(r"flash_fwd_f32_cluster_kernelILb([01])ELi(\d+)E", mangled)
    if found:
        return f"fwd_{'tri' if found.group(1) == '1' else 'rect'}_{found.group(2)}"
    found = re.search(r"(flash_fwd_(?:tri|rect)_tile_f32_kernel)ILi(\d+)ELi(\d+)E", mangled)
    if found:
        return f"{found.group(1)}<{found.group(2)}, {found.group(3)}>"
    found = re.search(r"(flash_bwd_(?:dq|dkv)_(?:tri|rect)_tile_f32_kernel)ILi(\d+)E", mangled)
    if found:
        return f"{found.group(1)}<{found.group(2)}>"
    found = re.search(r"(flash_bwd_(?:(?:dq|dkv)_(?:tri|rect)_wide_f32|dkv_split_sum)_kernel)",
                      mangled)
    return found.group(1) if found and split_sum_label(mangled) in (None, "f32") else None


# the split dK/dV walk's sum in the 16-bit libraries up to head dim 256 (its
# output type's), beside the f32 one of flash_bwd_wide
SPLIT_SUM_LIBRARIES = {"flash_bwd": "bf16", "flash_bwd_f16": "fp16"}


def split_sum_label(mangled: str):
    """The output type of an instantiation of
    ``flash_bwd_dkv_split_sum_kernel<O>``: "f32", "bf16" or "fp16"; else
    None."""
    found = re.search(r"flash_bwd_dkv_split_sum_kernelI(f|13__nv_bfloat16|6__half)E", mangled)
    return {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}[found.group(1)] \
        if found else None


def whole_row_f32(mangled: str) -> bool:
    """Whether a kernel is an instantiation of the whole-row f32 CUDA-core
    kernels (``flash_{fwd,bwd}_*_kernel<float, D>``), which only the base
    libraries hold (D 16)."""
    return re.search(r"flash_(?:fwd|bwd)_\w+_kernelIfLi\d+E", mangled) is not None


def tri_bwd_bf16_label(mangled: str):
    """A label for a bf16 tensor-core instantiation of a backward pair:
    ``dq_d<D>_wg<WG>`` or ``dkv_d<D>_wg<WG>`` for the triangle pair
    (``flash_bwd_{dq,dkv}_tri_kernel<__nv_bfloat16, D, WG>``),
    ``dq_rect_d<D>_wg<WG>`` or ``dkv_rect_d<D>_wg<WG>`` for the general
    pair (``flash_bwd_{dq,dkv}_rect_kernel<...>``); else None."""
    return _bwd_label(mangled, BF16_MANGLED)


def bwd_f16_label(mangled: str):
    """:func:`tri_bwd_bf16_label` for the fp16 instantiations
    (``flash_bwd_{dq,dkv}_{tri,rect}_kernel<__half, D, WG>``)."""
    return _bwd_label(mangled, F16_MANGLED)


# library: (label of a tensor-core instantiation, how many it must have)
TENSOR_CORE_KERNELS = {
    "flash_fwd": (fwd_bf16_label, 16),      # both kernels: d 16/32/64/128 x 1/2 warpgroups
    "flash_bwd": (tri_bwd_bf16_label, 32),  # dq and dkv of both pairs, the same 8 each
}
# and at head dim 256: per library, how many more (the backward pairs one
# warpgroup's; the forwards the 128-row CTA's, two consumer warpgroups
# under setmaxnreg, labelled so in both 16-bit libraries)
HEAD_DIM_256_INSTANTIATIONS = {"flash_fwd": 2, "flash_bwd": 4}
HEAD_DIM_256_FORWARDS = ("d256_wg2", "rect_d256_wg2")
# the head dim 512 libraries (kernels/build.py VARIANTS: both flash sources
# built with -DFLASH_HEAD_DIM_512, bf16 and fp16; f32 at 512 runs in the wide
# libraries' cluster kernels): one warpgroup's instantiation of each
# tensor-core kernel, and no other
HEAD_DIM_512_INSTANTIATIONS = {"flash_fwd_d512": 2, "flash_bwd_d512": 4,
                               "flash_fwd_f16_d512": 2, "flash_bwd_f16_d512": 4}
# and the head dim 576 libraries (-DFLASH_HEAD_DIM_576), likewise; every
# kernel of these (the f32 ones too) is held to 0 spill bytes
HEAD_DIM_576_INSTANTIATIONS = {"flash_fwd_d576": 2, "flash_bwd_d576": 4,
                               "flash_fwd_f16_d576": 2, "flash_bwd_f16_d576": 4}
# and the D-streaming libraries of head dims above 576 (-DFLASH_HEAD_DIM_WIDE):
# both forwards (the triangle and the general kernel) and both backward
# pairs, in the library's 16-bit type; every kernel (the f32 ones too) held
# to 0 spill bytes
WIDE_HEAD_INSTANTIATIONS = {"flash_fwd_wide": 2, "flash_bwd_wide": 4, "flash_fwd_f16_wide": 2,
                            "flash_bwd_f16_wide": 4}
WIDE_INSTANTIATIONS = {**HEAD_DIM_512_INSTANTIATIONS, **HEAD_DIM_576_INSTANTIATIONS}
# the fp16 libraries (kernels/build.py VARIANTS: the same sources built with
# -DFLASH_ELEM_F16) hold the same instantiations in fp16, and no other
FLOAT16_TENSOR_CORE_KERNELS = {
    "flash_fwd_f16": (fwd_f16_label, 16 + 2),
    "flash_bwd_f16": (bwd_f16_label, 32 + 4),
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
    # the fp16 builds and the head dim 512 and 576 ones too
    libraries = (sources + sorted(FLOAT16_TENSOR_CORE_KERNELS)
                 + sorted(WIDE_INSTANTIATIONS) + sorted(WIDE_HEAD_INSTANTIATIONS))
    start = time.perf_counter()
    built = build.build(libraries)
    seconds = time.perf_counter() - start
    reports = {}
    for name in libraries:
        lib, _ = built[name]
        report = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", report)]
        log(f"  ptxas {name}: {len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")
        for line in report.splitlines():
            if "wgmma" in line.lower() or "setmaxnreg" in line:
                log(f"  ptxas {name}: {line.strip()}")
        reports[name] = report
    nvcc = {name: round(built[name][1], 2) for name in libraries}
    log(f"build: {', '.join(libraries)} for sm_90a in {seconds:.1f} s (one nvcc each, in "
        f"parallel: {nvcc} s)")
    # the 16-bit kernels must run on the tensor cores: HGMMA in every
    # instantiation, and no register spills
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    out = {"seconds": seconds, "nvcc_seconds": nvcc, "ptxas": reports}
    tables = {name: (label_of, expected + HEAD_DIM_256_INSTANTIATIONS[name], "bf16")
              for name, (label_of, expected) in TENSOR_CORE_KERNELS.items()}
    tables.update({name: (label_of, expected, "fp16")
                   for name, (label_of, expected) in FLOAT16_TENSOR_CORE_KERNELS.items()})
    for name, expected in WIDE_INSTANTIATIONS.items():
        fp16, fwd = "_f16" in name, name.startswith("flash_fwd")
        label_of = ((fwd_f16_label if fwd else bwd_f16_label) if fp16
                    else (fwd_bf16_label if fwd else tri_bwd_bf16_label))
        tables[name] = (label_of, expected, f"{'fp16' if fp16 else 'bf16'} {name[-4:]}")
    for name, expected in WIDE_HEAD_INSTANTIATIONS.items():
        fp16 = "_f16" in name
        tables[name] = (wide_f16_label if fp16 else wide_label, expected,
                        f"{'fp16' if fp16 else 'bf16'} wide")
    for name, (label_of, expected, dtype) in tables.items():
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(built[name][0])],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        per_function = ptxas_by_function(reports[name])
        hgmma, ptxas = {}, {}
        for mangled, count in hgmma_counts(sass).items():
            label = label_of(mangled)
            if label is not None:
                hgmma[label] = count
                ptxas[label] = per_function.get(mangled, {})
        log(f"  {name} {dtype} tensor-core HGMMA per instantiation {hgmma}; ptxas {ptxas}")
        if len(hgmma) != expected or not all(hgmma.values()):
            raise RuntimeError(f"{name}: a {dtype} kernel is not on the tensor cores: "
                               f"HGMMA {hgmma} (expected {expected} instantiations)")
        if name in ("flash_fwd", "flash_fwd_f16"):
            at_256 = sorted(label for label in hgmma if "d256_" in label)
            if at_256 != sorted(HEAD_DIM_256_FORWARDS):
                raise RuntimeError(f"{name}: the D 256 forwards are {at_256}, expected the "
                                   f"128-row CTAs {sorted(HEAD_DIM_256_FORWARDS)}")
        held = dict(ptxas)
        if name in SPLIT_SUM_LIBRARIES:
            # the 16-bit dK/dV's split sum, held to 0 spills with the rest
            sums = {k: v for k, v in per_function.items()
                    if split_sum_label(k) == SPLIT_SUM_LIBRARIES[name]}
            if len(sums) != 1:
                raise RuntimeError(f"{name}: {len(sums)} {SPLIT_SUM_LIBRARIES[name]} split sums, "
                                   f"expected 1: {sorted(sums)}")
            held.update(sums)
            out[f"{name}_split_sum_ptxas"] = next(iter(sums.values()))
            log(f"  {name} split sum: ptxas {out[f'{name}_split_sum_ptxas']}")
        if name in HEAD_DIM_576_INSTANTIATIONS or name in WIDE_HEAD_INSTANTIATIONS:
            # every kernel, the f32 ones too
            held.update(per_function)
        if name in WIDE_HEAD_INSTANTIATIONS:
            f32 = {f32_label(k): v for k, v in per_function.items() if f32_label(k)}
            log(f"  {name} f32 kernels: ptxas {f32}")
            out[f"{name}_f32_ptxas"] = f32
            want = {"flash_fwd_wide": F32_CLUSTER_INSTANTIATIONS + F32_FWD_TILE_KERNELS,
                    "flash_bwd_wide": F32_BWD_CLUSTER_KERNELS + F32_BWD_TILE_KERNELS}.get(name, ())
            if sorted(f32) != sorted(want):
                raise RuntimeError(f"{name}: f32 cluster kernels {sorted(f32)}, expected "
                                   f"{sorted(want)}")
            # every f32 kernel at most 255 registers a thread (one CTA an SM),
            # the backward's dQ and both forwards at a 64-column slab 128 (two
            # CTAs an SM)
            wide_regs = {k: v for k, v in f32.items() if (v.get("registers") or 256) > (
                128 if (k.startswith("flash_bwd_dq_") and k.endswith("tile_f32_kernel<64>"))
                or k.startswith(tuple(f"flash_fwd_{p}_tile_f32_kernel<{w}," for p in ("tri", "rect")
                                      for w in (32, 64)))
                else 255)}
            if wide_regs:
                raise RuntimeError(f"{name}: f32 kernels past their registers: {wide_regs}")
        if name in ("flash_fwd", "flash_fwd_f16", "flash_bwd", "flash_bwd_f16"):
            # f32 lives in the wide libraries from head dim 32 on; flash_fwd
            # and flash_bwd keep the whole-row kernels at 16 alone
            kept = sorted(k for k in per_function if whole_row_f32(k))
            want_kept = {"flash_fwd": 2, "flash_bwd": 4}.get(name, 0)
            if len(kept) != want_kept or not all("IfLi16E" in k for k in kept):
                raise RuntimeError(f"{name}: holds f32 kernels {kept}; expected the whole-row "
                                   f"kernels at head dim 16 alone ({want_kept} kernels)")
        if name in WIDE_INSTANTIATIONS:
            # f32 at 512 and 576 runs in the wide library: no f32 kernel here
            stray = sorted(k for k in per_function if whole_row_f32(k))
            if stray:
                raise RuntimeError(f"{name}: holds f32 kernels {stray}; f32 at head dims 256 "
                                   f"and above is the wide library's cluster pair")
        spilled = {k: v for k, v in held.items() if v.get("spill_stores") or v.get("spill_loads")}
        if spilled:
            raise RuntimeError(f"{name}: {dtype} instantiations spill registers: {spilled}")
        # ptxas serializes wgmma when registers run short, and ignores a
        # setmaxnreg it cannot place: either undoes the design
        labelled = [m for m in per_function if label_of(m)]
        faults = [line.strip() for line in reports[name].splitlines()
                  if "setmaxnreg ignored" in line
                  or ("serialized" in line and any(m in line for m in labelled))]
        if faults:
            raise RuntimeError(f"{name}: ptxas undid the tensor-core design: {faults}")
        out[f"{name}_hgmma"], out[f"{name}_tc_ptxas"] = hgmma, ptxas
    return out


def _padded(case, *tensors):
    """The kernels' inputs of a case: its tensors zero-padded from the
    case's head dim to ``padded_head_dim`` (the same tensors at a native
    head dim), and the softmax scale to pass (None: the kernels' 1/√D)."""
    from tpu_operator_torch.kernels.flash_fwd import padded_head_dim

    d = case["q"][3]
    width = padded_head_dim(d)
    if width == d:
        return tensors, None
    return tuple(F.pad(x, (0, width - d)) for x in tensors), 1.0 / math.sqrt(d)


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
    if case.get("docs"):
        # documents out of order: equal runs of the sequence holding these ids
        docs = torch.tensor(case["docs"], dtype=torch.int32, device="cuda")
        seg = docs[torch.arange(sk, device="cuda") * len(docs) // sk].expand(b, sk).contiguous()
    return q, k, v, seg


def _bound(case, live_pairs: int, d: int) -> tuple:
    """(bound ms, what bounds it): each input read once and each output
    written once over HBM bandwidth, against the live (q, k) pairs' two
    matmuls (4·D FLOPs per pair) at the dtype's peak."""
    b, sq, h, _ = case["q"]
    sk, h_kv = case.get("sk", sq), case.get("h_kv", h)
    item = torch.tensor([], dtype=case["dtype"]).element_size()
    nbytes = item * (2 * b * h * sq * d + 2 * b * h_kv * sk * d) + 4 * b * h * sq
    if case.get("cut") is not None or case.get("packed") or case.get("docs"):
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


def sdpa_backend(case, q, k, v, seg, tri: bool, grad: bool = False) -> str:
    """The backend F.scaled_dot_product_attention dispatches the case's
    library call to (its flash backend stops at head dim 256); ``grad``:
    with inputs that need gradients, as the backward rows' call has."""
    from torch.nn.attention import SDPBackend

    qs, ks, vs = (x.detach().requires_grad_(grad) for x in _heads_layout(case, q, k, v))
    kwargs = _sdpa_kwargs(case, seg, tri)
    choice = torch._fused_sdp_choice(qs, ks, vs, attn_mask=kwargs.get("attn_mask"),
                                     is_causal=kwargs.get("is_causal", False),
                                     enable_gqa=kwargs.get("enable_gqa", False))
    return SDPBackend(choice).name.lower()


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
    if case.get("cut") is not None or case.get("packed") or case.get("docs"):
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
    # the autotune sweep's flash shape (phase 12)
    dict(kernel="flash_fwd_tri", label="autotune sweep bf16 (1,8192,8,128)",
         q=(1, 8192, 8, 128), dtype=torch.bfloat16, inner=2),
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
# phase 3's forward rows at the head dims of phase 15, after KERNEL_CASES
HEAD_DIM_KERNEL_CASES = [
    # head dim 256 (phase 15): Gemma-2B's attention at its context, plain
    # causal (the triangle) and packed (the general kernel), GQA group 8;
    # full attention; f32 on the CUDA cores; serving's f32 prefill chunk
    dict(kernel="flash_fwd_tri", label="gemma-2b bf16 (1,8192,8,256) h_kv 1",
         q=(1, 8192, 8, 256), h_kv=1, dtype=torch.bfloat16, inner=2, main=True),
    dict(kernel="flash_fwd_rect", label="gemma-2b packed bf16 (1,8192,8,256) h_kv 1 2 segments",
         q=(1, 8192, 8, 256), h_kv=1, dtype=torch.bfloat16, causal=True, packed=2, inner=2,
         main=True),
    dict(kernel="flash_fwd_rect", label="bf16 (1,4096,8,256) full", q=(1, 4096, 8, 256),
         dtype=torch.bfloat16, causal=False, inner=2),
    dict(kernel="flash_fwd_rect", label="fp16 (1,4096,8,256) full", q=(1, 4096, 8, 256),
         dtype=torch.float16, causal=False, inner=2),
    # documents out of order (ids 0, 1, 0): the CTA-level dead-tile skip may
    # pass over no tile a later document shares with an earlier one
    dict(kernel="flash_fwd_rect", label="packed bf16 (1,8192,8,256) h_kv 1 documents 0,1,0",
         q=(1, 8192, 8, 256), h_kv=1, dtype=torch.bfloat16, causal=True, docs=(0, 1, 0),
         inner=2),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,256)", q=(2, 128, 4, 256),
         dtype=torch.float32),
    dict(kernel="flash_fwd_rect", label="f32 (2,128,4,256) full", q=(2, 128, 4, 256),
         dtype=torch.float32, causal=False),
    dict(kernel="flash_fwd_rect", label="serving d256 f32 q(1,8,2,256) kv 64 q_start=16",
         q=(1, 8, 2, 256), sk=64, dtype=torch.float32, causal=True, q_start=16, main=True),
] + [
    # the zero-padded route: Phi-3-mini's attention at its context (96 ->
    # 128), and head dims 80 and 112 (-> 128)
    dict(kernel="flash_fwd_tri", label="phi-3-mini bf16 (1,4096,32,96) padded to 128",
         q=(1, 4096, 32, 96), dtype=torch.bfloat16, inner=2, main=True),
    dict(kernel="flash_fwd_tri", label="bf16 (1,512,4,80) padded to 128", q=(1, 512, 4, 80),
         dtype=torch.bfloat16),
    dict(kernel="flash_fwd_rect", label="bf16 (1,512,4,112) full, padded to 128",
         q=(1, 512, 4, 112), dtype=torch.bfloat16, causal=False),
]


# phase 3's f32 forward rows up to head dim 128 beside KERNEL_CASES' (the tile
# kernels, one CTA a tile; D 16 the whole-row kernel). Their inputs come from a
# generator of their own (F32_TILE_SEED), so every other row of phase 3 keeps
# the inputs it had before them.
F32_TILE_SEED = 20260829
F32_TILE_KERNEL_CASES = [
    # the triangle at an f32 TPUJob's entry() widths, D 128, D 16, and with one
    # kv head at 2048 tokens
    dict(kernel="flash_fwd_tri", label="entry widths f32 (8,128,4,64)", q=(8, 128, 4, 64),
         dtype=torch.float32),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,128)", q=(2, 128, 4, 128),
         dtype=torch.float32),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,16)", q=(2, 128, 4, 16),
         dtype=torch.float32),
    dict(kernel="flash_fwd_tri", label="f32 (1,2048,8,64) h_kv 1", q=(1, 2048, 8, 64), h_kv=1,
         dtype=torch.float32, inner=2),
    dict(kernel="flash_fwd_tri", label="f32 (1,2048,8,128) h_kv 1", q=(1, 2048, 8, 128), h_kv=1,
         dtype=torch.float32, inner=2),
    # the general masks: the packed f32 TPUJob at entry() widths, full
    # attention, a window with a segment cut, a ragged length with GQA,
    # serving's chunk at head dim 64 (16-row tiles)
    dict(kernel="flash_fwd_rect", label="entry widths packed f32 (8,128,4,64) 2 segments",
         q=(8, 128, 4, 64), dtype=torch.float32, causal=True, packed=2),
    dict(kernel="flash_fwd_rect", label="f32 (2,128,4,64) full", q=(2, 128, 4, 64),
         dtype=torch.float32, causal=False),
    dict(kernel="flash_fwd_rect", label="f32 (2,128,4,64) window 33, segments cut 88",
         q=(2, 128, 4, 64), dtype=torch.float32, causal=True, window=33, cut=88),
    dict(kernel="flash_fwd_rect", label="ragged f32 (2,1000,4,128) h_kv 2, segments cut 333",
         q=(2, 1000, 4, 128), h_kv=2, dtype=torch.float32, causal=True, cut=333),
    dict(kernel="flash_fwd_rect", label="serving d64 f32 q(1,8,2,64) kv 64 q_start=16",
         q=(1, 8, 2, 64), sk=64, dtype=torch.float32, causal=True, q_start=16),
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
    dict(pair="tri", label="autotune sweep bf16 (1,8192,8,128)", q=(1, 8192, 8, 128),
         dtype=torch.bfloat16, inner=2),
] + [
    # the f32 pair up to head dim 128 (one CTA a tile): an f32 TPUJob at entry()
    # widths, and with one kv head at 2048 tokens, where dK/dV's GQA split decides
    dict(pair="tri", label="entry widths f32 (8,128,4,64)", q=(8, 128, 4, 64),
         dtype=torch.float32),
    dict(pair="tri", label="f32 (2,128,4,16)", q=(2, 128, 4, 16), dtype=torch.float32),
    dict(pair="rect", label="f32 (2,128,4,32) full", q=(2, 128, 4, 32), dtype=torch.float32,
         causal=False),
    dict(pair="tri", label="f32 (1,2048,8,64) h_kv 1", q=(1, 2048, 8, 64), h_kv=1,
         dtype=torch.float32, inner=2),
    dict(pair="tri", label="f32 (1,2048,8,128) h_kv 1", q=(1, 2048, 8, 128), h_kv=1,
         dtype=torch.float32, inner=2),
] + [
    # the general pair: the packed burn-in train step (main path), a
    # segment boundary inside a tile, full attention, the window band
    dict(pair="rect", label="burnin packed bf16 (8,128,4,64) 2 segments", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, causal=True, packed=2, main=True),
    dict(pair="rect", label="bf16 (8,128,4,64) segments cut 88", q=(8, 128, 4, 64),
         dtype=torch.bfloat16, causal=True, cut=88),
    dict(pair="rect", label="f32 (2,128,4,64) full", q=(2, 128, 4, 64), dtype=torch.float32,
         causal=False),
    dict(pair="rect", label="ragged f32 (2,1000,4,128) h_kv 2, segments cut 333",
         q=(2, 1000, 4, 128), h_kv=2, dtype=torch.float32, causal=True, cut=333),
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
# phase 3's backward rows at the head dims of phase 15, after BWD_CASES
HEAD_DIM_BWD_CASES = [
    # head dim 256 (phase 15): Gemma-2B's train step at its context, plain
    # causal and packed, GQA group 8 (dK/dV: two warpgroups on the two
    # halves of the head dim); full attention; f32 (the cluster pair: two
    # slab CTAs a tile), at (1,2048,8,256) with one kv head its GQA split
    dict(pair="tri", label="gemma-2b bf16 (1,8192,8,256) h_kv 1", q=(1, 8192, 8, 256),
         h_kv=1, dtype=torch.bfloat16, inner=1, main=True),
    dict(pair="rect", label="gemma-2b packed bf16 (1,8192,8,256) h_kv 1 2 segments",
         q=(1, 8192, 8, 256), h_kv=1, dtype=torch.bfloat16, causal=True, packed=2, inner=1,
         main=True),
    dict(pair="rect", label="bf16 (1,4096,8,256) full", q=(1, 4096, 8, 256),
         dtype=torch.bfloat16, causal=False, inner=1),
    dict(pair="tri", label="f32 (2,128,4,256)", q=(2, 128, 4, 256), dtype=torch.float32),
    dict(pair="rect", label="f32 (2,128,4,256) window 33, segments cut 88", q=(2, 128, 4, 256),
         dtype=torch.float32, causal=True, window=33, cut=88),
    dict(pair="tri", label="f32 (1,2048,8,256) h_kv 1", q=(1, 2048, 8, 256), h_kv=1,
         dtype=torch.float32, inner=2),
] + [
    # the zero-padded route: Phi-3-mini's train step (96 -> 128), 80 and 112
    dict(pair="tri", label="phi-3-mini bf16 (1,4096,32,96) padded to 128",
         q=(1, 4096, 32, 96), dtype=torch.bfloat16, inner=1, main=True),
    dict(pair="tri", label="bf16 (1,512,4,80) padded to 128", q=(1, 512, 4, 80),
         dtype=torch.bfloat16),
    dict(pair="rect", label="bf16 (1,512,4,112) full, padded to 128", q=(1, 512, 4, 112),
         dtype=torch.bfloat16, causal=False),
]


# phase 3's fp16 rows, after the head-dim rows: the shapes phase 16 trains
# at (the burn-in's plain and packed, Phi-3-mini's padded head and its
# packed run) and the long-context ones (D 128 at 4096, Gemma-2B's D 256),
# each also run in bf16 on the same inputs rounded to bf16, whose error it
# must stay below (an fp16 path that rounded through bf16 would not)
FLOAT16_KERNEL_CASES = [
    dict(kernel="flash_fwd_tri", label="burnin fp16 (8,128,4,64)", q=(8, 128, 4, 64),
         dtype=torch.float16, main=True),
    dict(kernel="flash_fwd_rect", label="burnin packed fp16 (8,128,4,64) 2 segments",
         q=(8, 128, 4, 64), dtype=torch.float16, causal=True, packed=2, main=True),
    dict(kernel="flash_fwd_tri", label="timing fp16 (1,4096,8,128)", q=(1, 4096, 8, 128),
         dtype=torch.float16, inner=2),
    dict(kernel="flash_fwd_tri", label="phi-3-mini fp16 (1,4096,32,96) padded to 128",
         q=(1, 4096, 32, 96), dtype=torch.float16, inner=2, main=True),
    dict(kernel="flash_fwd_rect", label="phi-3-mini packed fp16 (1,4096,32,96) 2 segments, "
         "padded to 128", q=(1, 4096, 32, 96), dtype=torch.float16, causal=True, packed=2,
         inner=2, main=True),
    dict(kernel="flash_fwd_tri", label="gemma-2b fp16 (1,8192,8,256) h_kv 1",
         q=(1, 8192, 8, 256), h_kv=1, dtype=torch.float16, inner=2),
]
# fp16's smallest subnormal, the spacing of every fp16 value below 2^-14
FP16_SUBNORMAL_STEP = 2.0 ** -24
# the output cotangent at Phi-3-mini's full width: the reference's loss
# gradient 2·(out − t)/N with N = 4096·3072 is ~2.2e-7 a value, which fp16
# holds as a subnormal with about 2 bits (PERF.md §6)
SUBNORMAL_DOUT_SCALE = 2.0 ** -22
FLOAT16_BWD_CASES = [
    dict(pair="tri", label="burnin fp16 (8,128,4,64)", q=(8, 128, 4, 64), dtype=torch.float16,
         main=True),
    dict(pair="rect", label="burnin packed fp16 (8,128,4,64) 2 segments", q=(8, 128, 4, 64),
         dtype=torch.float16, causal=True, packed=2, main=True),
    dict(pair="tri", label="timing fp16 (1,4096,8,128)", q=(1, 4096, 8, 128),
         dtype=torch.float16, inner=2),
    dict(pair="tri", label="phi-3-mini fp16 (1,4096,32,96) padded to 128", q=(1, 4096, 32, 96),
         dtype=torch.float16, inner=1, main=True),
    dict(pair="rect", label="phi-3-mini packed fp16 (1,4096,32,96) 2 segments, padded to 128",
         q=(1, 4096, 32, 96), dtype=torch.float16, causal=True, packed=2, inner=1, main=True),
    dict(pair="tri", label="gemma-2b fp16 (1,8192,8,256) h_kv 1", q=(1, 8192, 8, 256), h_kv=1,
         dtype=torch.float16, inner=1),
    # Phi-3-mini's full-width cotangent: subnormal dO, and dS and dQ/dK that
    # round mostly to 0 (kernels and plain version alike)
    dict(pair="tri", label="phi-3-mini fp16 (1,4096,32,96) padded to 128, dO x 2^-22 "
         "(subnormal)", q=(1, 4096, 32, 96), dtype=torch.float16, inner=1,
         dout_scale=SUBNORMAL_DOUT_SCALE),
]

# phase 3's rows at head dim 512 (phase 17), after the fp16 rows: the six
# kernels at DeepSeek-V4-Flash's attention (8 q heads of 512 on one kv head,
# 8192 tokens; its sliding window of 128, in bf16 only, for the run's time;
# packed) in bf16 and fp16, full attention, f32 on the CUDA cores, serving's
# f32 prefill chunk, ragged lengths at GQA 2, and the zero-padded route at
# 384 (at its own scale)
DEEPSEEK_Q = (1, 8192, 8, 512)
HEAD_DIM_512_KERNEL_CASES = [
    dict(kernel=kernel, label=f"deepseek-v4-flash {name} {t} (1,8192,8,512) h_kv 1",
         q=DEEPSEEK_Q, h_kv=1, dtype=dtype, inner=2, main=main, **extra)
    for t, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
    for kernel, name, main, extra in (
        ("flash_fwd_tri", "plain", True, {}),
        ("flash_fwd_rect", "window 128", False, dict(causal=True, window=128)),
        ("flash_fwd_rect", "packed 2 segments", True, dict(causal=True, packed=2)),
    ) if not (t == "fp16" and "window" in name)
] + [
    dict(kernel="flash_fwd_rect", label="bf16 (1,4096,8,512) full", q=(1, 4096, 8, 512),
         dtype=torch.bfloat16, causal=False, inner=2),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,512)", q=(2, 128, 4, 512),
         dtype=torch.float32),
    dict(kernel="flash_fwd_rect", label="f32 (2,128,4,512) full", q=(2, 128, 4, 512),
         dtype=torch.float32, causal=False),
    dict(kernel="flash_fwd_rect", label="serving d512 f32 q(1,8,2,512) kv 64 q_start=16",
         q=(1, 8, 2, 512), sk=64, dtype=torch.float32, causal=True, q_start=16, main=True),
    # past launch-bound sizes: DeepSeek-V4-Flash's head layout in f32
    dict(kernel="flash_fwd_tri", label="f32 (1,2048,8,512) h_kv 1", q=(1, 2048, 8, 512), h_kv=1,
         dtype=torch.float32, inner=2),
    dict(kernel="flash_fwd_tri", label="ragged bf16 (2,100,4,512) h_kv 2", q=(2, 100, 4, 512),
         h_kv=2, dtype=torch.bfloat16),
    dict(kernel="flash_fwd_rect", label="ragged bf16 (2,1000,4,512) h_kv 2, segments cut 333",
         q=(2, 1000, 4, 512), h_kv=2, dtype=torch.bfloat16, causal=True, cut=333),
    dict(kernel="flash_fwd_tri", label="bf16 (1,4096,8,384) padded to 512", q=(1, 4096, 8, 384),
         dtype=torch.bfloat16, inner=2),
]
HEAD_DIM_512_BWD_CASES = [
    dict(pair=pair, label=f"deepseek-v4-flash {name} {t} (1,8192,8,512) h_kv 1", q=DEEPSEEK_Q,
         h_kv=1, dtype=dtype, inner=1, main=main, **extra)
    for t, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
    for pair, name, main, extra in (
        ("tri", "plain", True, {}),
        ("rect", "window 128", False, dict(causal=True, window=128)),
        ("rect", "packed 2 segments", True, dict(causal=True, packed=2)),
    ) if not (t == "fp16" and "window" in name)
] + [
    dict(pair="rect", label="bf16 (1,4096,8,512) full", q=(1, 4096, 8, 512),
         dtype=torch.bfloat16, causal=False, inner=1),
    dict(pair="tri", label="f32 (2,128,4,512)", q=(2, 128, 4, 512), dtype=torch.float32),
    dict(pair="rect", label="f32 (2,128,4,512) window 33, segments cut 88", q=(2, 128, 4, 512),
         dtype=torch.float32, causal=True, window=33, cut=88),
    # DeepSeek-V4-Flash's head layout in f32, where dK/dV's GQA walk splits
    dict(pair="tri", label="f32 (1,2048,8,512) h_kv 1", q=(1, 2048, 8, 512), h_kv=1,
         dtype=torch.float32, inner=2),
    dict(pair="tri", label="ragged bf16 (2,100,4,512) h_kv 2", q=(2, 100, 4, 512), h_kv=2,
         dtype=torch.bfloat16),
    dict(pair="rect", label="ragged bf16 (2,1000,4,512) h_kv 2, segments cut 333",
         q=(2, 1000, 4, 512), h_kv=2, dtype=torch.bfloat16, causal=True, cut=333),
    dict(pair="tri", label="bf16 (1,4096,8,384) padded to 512", q=(1, 4096, 8, 384),
         dtype=torch.bfloat16, inner=1),
]

# phase 3's rows at head dim 576 (phase 18), after the D 512 rows: the six
# kernels at sarvam-105b's absorbed-MLA attention (8 q heads of 576 on one
# shared latent kv head, 8192 tokens; a window of 128, as at D 512; packed)
# in bf16 and fp16, full attention, f32 on the CUDA cores, serving's f32
# prefill chunk, ragged lengths at GQA 2, and the zero-padded route at 544
# and 520 (at their own scales)
SARVAM_Q = (1, 8192, 8, 576)
HEAD_DIM_576_KERNEL_CASES = [
    dict(kernel=kernel, label=f"sarvam-105b {name} {t} (1,8192,8,576) h_kv 1",
         q=SARVAM_Q, h_kv=1, dtype=dtype, inner=2, main=main, **extra)
    for t, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
    for kernel, name, main, extra in (
        ("flash_fwd_tri", "plain", True, {}),
        ("flash_fwd_rect", "window 128", False, dict(causal=True, window=128)),
        ("flash_fwd_rect", "packed 2 segments", True, dict(causal=True, packed=2)),
    )
] + [
    dict(kernel="flash_fwd_rect", label="bf16 (1,4096,8,576) full", q=(1, 4096, 8, 576),
         dtype=torch.bfloat16, causal=False, inner=2),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,576)", q=(2, 128, 4, 576),
         dtype=torch.float32),
    dict(kernel="flash_fwd_rect", label="f32 (2,128,4,576) full", q=(2, 128, 4, 576),
         dtype=torch.float32, causal=False),
    dict(kernel="flash_fwd_rect", label="serving d576 f32 q(1,8,2,576) kv 64 q_start=16",
         q=(1, 8, 2, 576), sk=64, dtype=torch.float32, causal=True, q_start=16, main=True),
    # the general f32 forward where the 5-CTA cluster and the overlapping last
    # slab meet a window and a segment boundary
    dict(kernel="flash_fwd_rect", label="f32 (2,128,4,576) window 33, segments cut 88",
         q=(2, 128, 4, 576), dtype=torch.float32, causal=True, window=33, cut=88),
    dict(kernel="flash_fwd_tri", label="ragged bf16 (2,100,4,576) h_kv 2", q=(2, 100, 4, 576),
         h_kv=2, dtype=torch.bfloat16),
    dict(kernel="flash_fwd_rect", label="ragged bf16 (2,1000,4,576) h_kv 2, segments cut 333",
         q=(2, 1000, 4, 576), h_kv=2, dtype=torch.bfloat16, causal=True, cut=333),
    dict(kernel="flash_fwd_tri", label="bf16 (1,4096,8,544) padded to 576", q=(1, 4096, 8, 544),
         dtype=torch.bfloat16, inner=2),
    dict(kernel="flash_fwd_rect", label="bf16 (2,1000,4,520) h_kv 2, window 33, padded to 576",
         q=(2, 1000, 4, 520), h_kv=2, dtype=torch.bfloat16, causal=True, window=33),
]
HEAD_DIM_576_BWD_CASES = [
    dict(pair=pair, label=f"sarvam-105b {name} {t} (1,8192,8,576) h_kv 1", q=SARVAM_Q,
         h_kv=1, dtype=dtype, inner=1, main=main, **extra)
    for t, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
    for pair, name, main, extra in (
        ("tri", "plain", True, {}),
        ("rect", "window 128", False, dict(causal=True, window=128)),
        ("rect", "packed 2 segments", True, dict(causal=True, packed=2)),
    )
] + [
    dict(pair="rect", label="bf16 (1,4096,8,576) full", q=(1, 4096, 8, 576),
         dtype=torch.bfloat16, causal=False, inner=1),
    dict(pair="tri", label="f32 (2,128,4,576)", q=(2, 128, 4, 576), dtype=torch.float32),
    dict(pair="rect", label="f32 (2,128,4,576) window 33, segments cut 88", q=(2, 128, 4, 576),
         dtype=torch.float32, causal=True, window=33, cut=88),
    dict(pair="tri", label="ragged bf16 (2,100,4,576) h_kv 2", q=(2, 100, 4, 576), h_kv=2,
         dtype=torch.bfloat16),
    dict(pair="rect", label="ragged bf16 (2,1000,4,576) h_kv 2, segments cut 333",
         q=(2, 1000, 4, 576), h_kv=2, dtype=torch.bfloat16, causal=True, cut=333),
    dict(pair="tri", label="bf16 (1,4096,8,544) padded to 576", q=(1, 4096, 8, 544),
         dtype=torch.bfloat16, inner=1),
    dict(pair="rect", label="bf16 (2,1000,4,520) h_kv 2, window 33, padded to 576",
         q=(2, 1000, 4, 520), h_kv=2, dtype=torch.bfloat16, causal=True, window=33),
]


# phase 3's rows above head dim 576 (phase 19), on the D-streaming kernels:
# phase 19's (1,8192,8,1024) with one kv head in bf16 and fp16, 640 and the
# zero-padded 700 (-> 704) in bf16, f32 on the CUDA cores (ragged at GQA 2);
# the general forward at full attention and serving's f32 chunk; the general
# pair at phase 19's packed documents (bf16 and fp16), a window, full
# attention, the padded 700 with a window and segments at GQA 2, and f32
# (ragged at GQA 2); one forward at head dim 2048
WIDE_Q = (1, 8192, 8, 1024)
WIDE_KERNEL_CASES = [
    dict(kernel="flash_fwd_tri", label="head dim 1024 bf16 (1,8192,8,1024) h_kv 1", q=WIDE_Q,
         h_kv=1, dtype=torch.bfloat16, inner=2, main=True),
    dict(kernel="flash_fwd_tri", label="head dim 1024 fp16 (1,8192,8,1024) h_kv 1", q=WIDE_Q,
         h_kv=1, dtype=torch.float16, inner=2),
    dict(kernel="flash_fwd_tri", label="head dim 640 bf16 (1,8192,8,640) h_kv 1",
         q=(1, 8192, 8, 640), h_kv=1, dtype=torch.bfloat16, inner=2),
    dict(kernel="flash_fwd_tri", label="bf16 (1,4096,8,700) padded to 704", q=(1, 4096, 8, 700),
         dtype=torch.bfloat16, inner=2),
    dict(kernel="flash_fwd_tri", label="f32 (2,128,4,1024)", q=(2, 128, 4, 1024),
         dtype=torch.float32),
    dict(kernel="flash_fwd_tri", label="ragged f32 (2,100,4,640) h_kv 2", q=(2, 100, 4, 640),
         h_kv=2, dtype=torch.float32),
    dict(kernel="flash_fwd_rect", label="bf16 (1,4096,8,1024) full", q=(1, 4096, 8, 1024),
         dtype=torch.bfloat16, causal=False, inner=2),
    dict(kernel="flash_fwd_rect", label="serving d1024 f32 q(1,8,2,1024) kv 64 q_start=16",
         q=(1, 8, 2, 1024), sk=64, dtype=torch.float32, causal=True, q_start=16, main=True),
    dict(kernel="flash_fwd_tri", label="f32 (1,2048,8,1024) h_kv 1", q=(1, 2048, 8, 1024),
         h_kv=1, dtype=torch.float32, inner=2),
    dict(kernel="flash_fwd_tri", label="head dim 2048 bf16 (1,1024,4,2048)",
         q=(1, 1024, 4, 2048), dtype=torch.bfloat16, inner=2),
]
WIDE_BWD_CASES = [
    dict(pair="tri", label="head dim 1024 bf16 (1,8192,8,1024) h_kv 1", q=WIDE_Q, h_kv=1,
         dtype=torch.bfloat16, inner=1, main=True),
    dict(pair="tri", label="head dim 1024 fp16 (1,8192,8,1024) h_kv 1", q=WIDE_Q, h_kv=1,
         dtype=torch.float16, inner=1),
    dict(pair="tri", label="head dim 640 bf16 (1,8192,8,640) h_kv 1", q=(1, 8192, 8, 640),
         h_kv=1, dtype=torch.bfloat16, inner=1),
    dict(pair="tri", label="bf16 (1,4096,8,700) padded to 704", q=(1, 4096, 8, 700),
         dtype=torch.bfloat16, inner=1),
    dict(pair="tri", label="f32 (2,128,4,1024)", q=(2, 128, 4, 1024), dtype=torch.float32),
    dict(pair="tri", label="ragged f32 (2,100,4,640) h_kv 2", q=(2, 100, 4, 640), h_kv=2,
         dtype=torch.float32),
    dict(pair="tri", label="f32 (1,2048,8,1024) h_kv 1", q=(1, 2048, 8, 1024), h_kv=1,
         dtype=torch.float32, inner=2),
    dict(pair="tri", label="head dim 2048 f32 (1,128,2,2048)", q=(1, 128, 2, 2048),
         dtype=torch.float32),
] + [
    dict(pair="rect", label=f"head dim 1024 packed 2 segments {t} (1,8192,8,1024) h_kv 1",
         q=WIDE_Q, h_kv=1, dtype=dtype, causal=True, packed=2, inner=1, main=main)
    for t, dtype, main in (("bf16", torch.bfloat16, True), ("fp16", torch.float16, False))
] + [
    dict(pair="rect", label="head dim 1024 window 128 bf16 (1,8192,8,1024) h_kv 1", q=WIDE_Q,
         h_kv=1, dtype=torch.bfloat16, causal=True, window=128, inner=1),
    dict(pair="rect", label="bf16 (1,4096,8,1024) full", q=(1, 4096, 8, 1024),
         dtype=torch.bfloat16, causal=False, inner=1),
    dict(pair="rect", label="bf16 (2,1000,4,700) h_kv 2, window 33, segments cut 333, padded "
         "to 704", q=(2, 1000, 4, 700), h_kv=2, dtype=torch.bfloat16, causal=True, window=33,
         cut=333),
    dict(pair="rect", label="f32 (2,128,4,1024) window 33, segments cut 88", q=(2, 128, 4, 1024),
         dtype=torch.float32, causal=True, window=33, cut=88),
    dict(pair="rect", label="ragged f32 (2,100,4,640) h_kv 2, segments cut 37",
         q=(2, 100, 4, 640), h_kv=2, dtype=torch.float32, causal=True, cut=37),
]

# and the 16-bit pair's clusters past 8 slabs (head dim 2048: two clusters a
# tile) and at phase 19's head dim with 8 kv heads beside the full row, from a
# generator of their own (WIDE_CLUSTER_BWD_SEED), so every other row of phase 3
# keeps the inputs it had before them
WIDE_CLUSTER_BWD_SEED = 20261019
WIDE_CLUSTER_BWD_CASES = [
    dict(pair="tri", label="head dim 2048 bf16 (1,1024,4,2048)", q=(1, 1024, 4, 2048),
         dtype=torch.bfloat16, inner=2),
    dict(pair="tri", label="bf16 (1,4096,8,1024)", q=(1, 4096, 8, 1024), dtype=torch.bfloat16,
         inner=1),
]

# and the general forward at phase 19's packed step's shapes ((1,8192,8,1024)
# with one kv head, two documents, and under a window of 128), from a
# generator of their own (WIDE_CLUSTER_FWD_SEED), so every other row of phase
# 3 keeps the inputs it had before them
WIDE_CLUSTER_FWD_SEED = 20261020
WIDE_CLUSTER_FWD_CASES = [
    dict(kernel="flash_fwd_rect",
         label="head dim 1024 packed 2 segments bf16 (1,8192,8,1024) h_kv 1", q=WIDE_Q, h_kv=1,
         dtype=torch.bfloat16, causal=True, packed=2, inner=2),
    dict(kernel="flash_fwd_rect", label="head dim 1024 window 128 bf16 (1,8192,8,1024) h_kv 1",
         q=WIDE_Q, h_kv=1, dtype=torch.bfloat16, causal=True, window=128, inner=2),
]


def _bwd_setup(case, q, k, v, seg, dout) -> dict:
    """A backward case's launches on (q, k, v, dout) in their dtype: the
    forward kernel's out and lse on the kernels' (padded) inputs, delta,
    and closures ``dq``, ``dkv`` (the pair) and ``plain``
    (attention_bwd_plain at the case's own head dim)."""
    from tpu_operator_torch.kernels import flash_bwd, flash_fwd

    h = case["q"][2]
    d = case["q"][3]
    h_kv = case.get("h_kv", h)
    tri = case["pair"] == "tri"
    causal, window = case.get("causal", True), case.get("window")
    # a head dim the kernels do not take runs zero-padded, at its own scale
    (qp, kp, vp, doutp), scale = _padded(case, q, k, v, dout)
    if tri:
        outp, lse = flash_fwd.flash_fwd_tri(qp, kp, vp, h, h_kv, sm_scale=scale)
    else:
        outp, lse = flash_fwd.flash_fwd_rect(qp, kp, vp, h, h_kv, causal, window=window,
                                             seg=seg, sm_scale=scale)
    out = outp[..., :d]
    delta = (dout.float() * out.float()).sum(-1)
    extra = () if tri else (causal, window, seg)
    dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{case['pair']}")
    dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{case['pair']}")
    return {
        "kernels": (qp, kp, vp, doutp, lse, delta, extra, scale), "dq_fn": dq_fn,
        "dkv_fn": dkv_fn,
        "dq": lambda: dq_fn(qp, kp, vp, outp, doutp, lse, delta, h, h_kv, *extra,
                            sm_scale=scale),
        "dkv": lambda: dkv_fn(qp, kp, vp, outp, doutp, lse, delta, h, h_kv, *extra,
                              sm_scale=scale),
        "plain": lambda: flash_bwd.attention_bwd_plain(q, k, v, out, lse, dout, h, h_kv, causal,
                                                       window, seg),
    }


# a gradient's values below this share of its largest |value| are measured in
# the steps of the grid there: far below the largest, a sum's f32 rounding of
# its large terms outweighs the grid, in the plain version and a kernel alike
GRID_FLOOR = 2.0 ** -10


def grid_steps(want, got) -> float:
    """The largest, over the gradients, of the root-mean-square over all
    elements of the error of ``got`` against ``want`` in steps of the grid
    of ``want``'s dtype at the value where it falls (the spacing of that
    dtype's values there: eps times its binade, at least at GRID_FLOOR of
    the gradient's largest |value|): each dtype's error in its own terms and
    over every element, where a maximum turns on one element and two right
    results may differ there by one step."""
    out = 0.0
    for w, g in zip(want, got):
        info = torch.finfo(w.dtype)
        low = int(math.log2(info.smallest_normal))
        w64, g64 = w.double(), g.double()
        at = w64.abs().clamp(min=float(w64.abs().max()) * GRID_FLOOR)
        _, exp = torch.frexp(at)
        binade = torch.exp2(torch.where(at == 0, low, exp - 1).clamp(min=low).double())
        out = max(out, float(((g64 - w64) / (info.eps * binade)).square().mean().sqrt()))
    return out


# fp16 keeps 3 bits more than bf16: one step of bf16's grid is 8 of fp16's
FP16_STEPS_IN_A_BF16_STEP = 8.0


def fp16_below_bf16(fp16_steps: float) -> bool:
    """Phase 3's hold on an fp16 backward row: its error (grid_steps, in
    fp16's steps) below one step of bf16's grid over all elements, as a path
    that keeps fp16's precision does. One that rounds P or dS through bf16
    errs by bf16's steps on every element, far above it; a bf16 twin's own
    error against its plain version, a few one-step differences where the
    two round the same sum differently, says nothing of fp16's."""
    return fp16_steps < FP16_STEPS_IN_A_BF16_STEP


def _bwd_errors(run: dict, d: int) -> tuple:
    """(want, dq/dk/dv errors of the pair against the plain version, max
    |grad|, grid_steps) of a ``_bwd_setup``."""
    want = run["plain"]()
    got = [x[..., :d] for x in (run["dq"](), *run["dkv"]())]
    torch.cuda.synchronize()
    return want, [err(w, g) for w, g in zip(want, got)], max(
        float(w.float().abs().max()) for w in want), grid_steps(want, got)


def _backward_rows(gen) -> list:
    """Each backward pair against attention_bwd_plain on the forward
    kernel's out and lse, with times; one row per kernel and case. An fp16
    case is also run in bf16 (its inputs rounded to bf16), and its relative
    error must stay below that twin's; not so where the gradients are fp16
    subnormals (``dout_scale``): there fp16 keeps fewer bits than bf16."""
    from tpu_operator_torch.kernels import flash_bwd
    from tpu_operator_torch.kernels.flash_fwd import (F32_CLUSTER_MIN_D, F32_SLAB,
                                                      TENSOR_CORE_DTYPES, f32_wide_geometry,
                                                      is_wide, keep_mask, padded_head_dim)

    rows = []
    cluster_gen = torch.Generator(device="cuda").manual_seed(WIDE_CLUSTER_BWD_SEED)
    for case in (BWD_CASES + HEAD_DIM_BWD_CASES + FLOAT16_BWD_CASES + HEAD_DIM_512_BWD_CASES
                 + HEAD_DIM_576_BWD_CASES + WIDE_BWD_CASES + WIDE_CLUSTER_BWD_CASES):
        rows_gen = cluster_gen if case in WIDE_CLUSTER_BWD_CASES else gen
        q, k, v, seg = _case_inputs(case, rows_gen)
        dout = torch.randn(q.shape, generator=rows_gen, device="cuda")
        dout = (dout * case.get("dout_scale", 1.0)).to(case["dtype"])
        b, s, h, d = case["q"]
        h_kv = case.get("h_kv", h)
        causal, window = case.get("causal", True), case.get("window")
        run = _bwd_setup(case, q, k, v, seg, dout)
        want, errs, grad_scale, steps = _bwd_errors(run, d)
        if case["dtype"] == torch.float32:
            tol = F32_TOL
        else:
            # two fp16 results that round the same sum differently differ by
            # one step of its grid, 2^-24 below 2^-14; a dS that rounds to
            # the other subnormal moves dQ (dK) by a step times |K| (|Q|)
            tol = BF16_TOL * grad_scale
            if case["dtype"] == torch.float16:
                tol = max(tol, FP16_SUBNORMAL_STEP * (1.0 + max(
                    float(x.float().abs().max()) for x in (q, k))))
        if not max(errs) <= tol:
            raise RuntimeError(f"backward pair [{case['label']}] disagrees with "
                               f"attention_bwd_plain: dq/dk/dv err {errs}, max |grad| "
                               f"{grad_scale}, tol {tol}")
        twin = {}
        if case["dtype"] == torch.float16:
            twin_run = _bwd_setup(case, *(x.to(torch.bfloat16) for x in (q, k, v)), seg,
                                  dout.to(torch.bfloat16))
            _, twin_errs, twin_scale, twin_steps = _bwd_errors(twin_run, d)
            del twin_run
            twin = {"bf16_twin_rel_err": max(twin_errs) / twin_scale, "grid_steps": steps,
                    "bf16_twin_grid_steps": twin_steps,
                    "grad_zero_share": [float((w == 0).float().mean()) for w in want],
                    "err_in_subnormal_steps": max(errs) / FP16_SUBNORMAL_STEP}
            # over every element in fp16's own steps, not one maximum against
            # the twin's: the two largest errors may tie at one step of each grid
            if "dout_scale" not in case and not fp16_below_bf16(steps):
                raise RuntimeError(f"fp16 backward pair [{case['label']}]: RMS error {steps} "
                                   f"steps of fp16's grid, not below one step of bf16's "
                                   f"({FP16_STEPS_IN_A_BF16_STEP} of fp16's)")
        mask = keep_mask(b * h, s, s, h, causal, window=window, seg=seg, device="cuda")
        live = int(mask.sum()) * (b * h // mask.shape[0])
        inner = case.get("inner", 20)
        plain_ms = device_ms(run["plain"], inner)
        library_ms, eager_library_ms = _library_backward_ms(case, q, k, v, seg, dout, inner)
        backend = sdpa_backend(case, q, k, v, seg, case["pair"] == "tri", grad=True)
        pair = []
        for fn, kernel_errs, is_dq in ((run["dq"], errs[:1], True), (run["dkv"], errs[1:], False)):
            bound_ms, bound_by = _bwd_bound(case, live, d, is_dq)
            pair.append({
                "kernel": (run["dq_fn"] if is_dq else run["dkv_fn"]).__name__,
                "label": case["label"], "dtype": str(case["dtype"]).replace("torch.", ""),
                "main_path": bool(case.get("main")), "max_abs_err": max(kernel_errs),
                "rel_err": max(kernel_errs) / grad_scale, "ms": device_ms(fn, inner),
                "plain_ms": plain_ms, "library_ms": library_ms, "eager_ms": cuda_ms(fn, inner),
                "eager_library_ms": eager_library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "live_pairs": live, "library_backend": backend, **twin,
            })
        pair_ms = pair[0]["ms"] + pair[1]["ms"]
        # 14·D FLOPs per live pair: S, dP, dQ (6·D) and S, dP, dV, dK (8·D)
        stats = {"pair_tflops": 14.0 * d * live / pair_ms / 1e9,
                 "pair_ratio_to_library": pair_ms / library_ms}
        rate = (f", {stats['pair_tflops']:.1f} TFLOP/s, {stats['pair_ratio_to_library']:.2f}x "
                f"sdpa backward")
        if case["dtype"] in TENSOR_CORE_DTYPES:
            qp, kp, vp, doutp, lse, delta, extra, scale = run["kernels"]
            stats.update(_other_bwd_plans(case["pair"], qp, kp, vp, doutp, lse, delta, h, h_kv,
                                          extra, want, tol, inner, d, scale))
            rate += f", dq/dkv blocks {stats['blocks']}" + (
                f" (at {stats['other_blocks']}: dq {stats['other_dq_ms']:.5f}, dkv "
                f"{stats['other_dkv_ms']:.5f} ms)" if "other_blocks" in stats else
                " (no other tile height at this head dim)")
        width = padded_head_dim(d)
        if case["dtype"] in TENSOR_CORE_DTYPES and width <= 256:
            # dK/dV's GQA split at the card's resident CTAs, and the split's bits and worth
            qp, kp, vp, doutp, lse, delta, extra, scale = run["kernels"]
            stats.update(_split_check(case["pair"], qp, kp, vp, doutp, lse, delta, h, h_kv,
                                      extra, want, inner, d, None, scale, tol))
            rate += f", dkv split {stats['split']}"
            if "split_1_dkv_ms" in stats:
                rate += f" (at split 1: dkv {stats['split_1_dkv_ms']:.5f} ms)"
        if case["dtype"] in TENSOR_CORE_DTYPES and is_wide(width):
            # the slab clusters of the 16-bit pair above 576 resident on the card at once
            tri = case["pair"] == "tri"
            stats["active_clusters"] = {
                k: flash_bwd.wide16_active_clusters(case["dtype"], width, k, tri)
                for k in ("dq", "dkv")}
            stats["clusters"] = {k: f32_wide_geometry(width, slab)[2] for k, slab in (
                ("dq", flash_bwd.WIDE_DQ_SLAB), ("dkv", flash_bwd.WIDE_DKV_SLAB))}
            rate += (f", clusters of {stats['clusters']} resident {stats['active_clusters']}")
        if case["dtype"] == torch.float32 and width != flash_bwd.F32_WHOLE_ROW_D:
            # the f32 pair's thread-block clusters (at head dims 32-128: CTAs, a
            # cluster of one) resident on the card at once, dK/dV's GQA split,
            # and the split's bits and worth
            tri = case["pair"] == "tri"
            stats["active_clusters"] = {k: flash_bwd.f32_wide_active_clusters(width, k, tri)
                                        for k in ("dq", "dkv")}
            qp, kp, vp, doutp, lse, delta, extra, scale = run["kernels"]
            stats.update(_split_check(case["pair"], qp, kp, vp, doutp, lse, delta, h, h_kv,
                                      extra, want, inner, d, stats["active_clusters"]["dkv"],
                                      scale))
            stats["slab"] = (flash_bwd.f32_tile_width(width) if width < F32_CLUSTER_MIN_D
                             else F32_SLAB)
            rate += (f", clusters of {f32_wide_geometry(width)[2]} on {stats['slab']}-column "
                     f"slabs resident {stats['active_clusters']}, dkv split {stats['split']}")
            if "split_1_dkv_ms" in stats:
                rate += f" (at split 1: dkv {stats['split_1_dkv_ms']:.5f} ms)"
        if twin:
            rate += (f"; RMS err {steps:.3g} steps of fp16's grid (bf16 on the same inputs "
                     f"{twin['bf16_twin_grid_steps']:.3g} of its own); bf16 rel err "
                     f"{twin['bf16_twin_rel_err']:.3g} (fp16 "
                     f"{max(errs) / grad_scale:.3g}, {twin['err_in_subnormal_steps']:.3g} "
                     f"subnormal steps); exact zeros in dq/dk/dv "
                     f"{[round(z, 4) for z in twin['grad_zero_share']]}")
        for row in pair:
            row.update(stats, pair_ms=pair_ms)
        rows += pair
        del run
        log(f"backward {case['pair']} [{case['label']}]: dq/dk/dv err {errs[0]:.3g}/{errs[1]:.3g}/"
            f"{errs[2]:.3g} (max |grad| {grad_scale:.3g}); device ms: dq {pair[0]['ms']:.5f} (bound "
            f"{pair[0]['bound_ms']:.5f} by {pair[0]['bound_by']}), dkv {pair[1]['ms']:.5f} (bound "
            f"{pair[1]['bound_ms']:.5f} by {pair[1]['bound_by']}), pair {pair_ms:.5f}, plain "
            f"{plain_ms:.5f}, sdpa backward {library_ms:.5f} ({backend}){rate}; eager ms: dq "
            f"{pair[0]['eager_ms']:.4f}, dkv {pair[1]['eager_ms']:.4f}, sdpa backward "
            f"{eager_library_ms:.4f}")
    return rows


def _other_bwd_plans(pair: str, q, k, v, dout, lse, delta, h: int, h_kv: int, extra: tuple,
                     want, tol: float, inner: int, d_true: int,
                     sm_scale: float = None) -> dict:
    """A bf16 or fp16 pair ("tri" or "rect", whose masks ``extra`` =
    (causal, window, seg) holds) launched with the tile heights its plan
    did not pick (the plans' ``block_m`` knob), straight through the
    library (no launch is counted), held to the same tolerance ``tol``, and
    timed: what the plan's choice is worth. ``q`` ... ``dout`` are the kernels' (padded)
    inputs, ``d_true`` the head dim ``want`` has, ``sm_scale`` the softmax
    scale (None: 1/√D). A head dim with one tile height (256) has no other
    plan: only the picked heights come back."""
    from tpu_operator_torch.kernels import flash_bwd, flash_fwd

    bh, s, d = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plans(block_m=None):
        if pair == "tri":
            return flash_bwd.tri_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, block_m)
        return flash_bwd.rect_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, *extra[:2],
                                       block_m=block_m)

    picked = plans()
    if len(flash_fwd.tile_heights(q.dtype, d)) < 2:
        return {"blocks": [p.block for p in picked]}
    other = [plans(192 - mine.block)[i] for i, mine in enumerate(picked)]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, dtype = flash_bwd._lib(q.dtype, d), flash_fwd._DTYPES[q.dtype]
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    seg = () if pair == "tri" else (None if extra[2] is None else extra[2].data_ptr(),)
    masks = () if pair == "tri" else (int(extra[0]), 0 if extra[1] is None else int(extra[1]))
    softmax = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    scales = (flash_fwd.LOG2E * softmax, softmax)

    def run(kernel: str, outputs, rows: int, plan):
        # on the current stream, which a graph capture switches
        split = (None, 1) if kernel == "dkv" else ()
        code = getattr(lib, f"flash_bwd_{kernel}_{pair}")(
            *common, *seg, *outputs, dtype, rows, s, d, h, h_kv, *masks, *scales, plan.block,
            plan.smem_bytes, plan.swizzle, *split, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"flash_bwd_{kernel}_{pair} at block {plan.block}: error {code}")

    def run_dq():
        run("dq", (dq.data_ptr(),), bh, other[0])

    def run_dkv():
        run("dkv", (dk.data_ptr(), dv.data_ptr()), k.shape[0], other[1])

    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    errs = [err(w, g[..., :d_true]) for w, g in zip(want, (dq, dk, dv))]
    if not max(errs) <= tol:
        raise RuntimeError(f"the {q.dtype} {pair} pair at blocks {[p.block for p in other]} "
                           f"disagrees: dq/dk/dv err {errs}, tol {tol}")
    return {"blocks": [p.block for p in picked], "other_blocks": [p.block for p in other],
            "other_dq_ms": device_ms(run_dq, inner), "other_dkv_ms": device_ms(run_dkv, inner),
            "other_max_abs_err": max(errs)}


def dkv_at_split(pair: str, split: int, q, k, v, dout, lse, delta, h: int, h_kv: int,
                 extra: tuple = (), sm_scale: float = None) -> tuple:
    """dK/dV (``pair`` "tri" or "rect", masks ``extra`` = (causal, window,
    seg)) of the f32 cluster pair, or of the 16-bit pair up to head dim
    256, with its GQA walk in ``split`` parts, through the library with a
    plan made by hand (the wrappers take the card's split; no launch is
    counted): (run, dk, dv), ``run()`` launching on the current stream into
    dk and dv and raising on a refused launch."""
    from tpu_operator_torch.kernels import flash_bwd, flash_fwd

    bh, s, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if pair == "tri":
        _, plan = flash_bwd.tri_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms)
    else:
        _, plan = flash_bwd.rect_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, *extra[:2])
    plan = plan.with_split(split)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    shape = plan.workspace(s, d)
    parts = None if shape is None else torch.empty(shape, dtype=torch.float32, device=q.device)
    lib = flash_bwd._lib(q.dtype, d)
    seg = () if pair == "tri" else (None if extra[2] is None else extra[2].data_ptr(),)
    masks = () if pair == "tri" else (int(extra[0]), 0 if extra[1] is None else int(extra[1]))
    softmax = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale

    def run():
        code = getattr(lib, f"flash_bwd_dkv_{pair}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *seg, dk.data_ptr(), dv.data_ptr(),
            flash_fwd._DTYPES[q.dtype], k.shape[0], s, d, h, h_kv,
            *masks, flash_fwd.LOG2E * softmax, softmax, plan.block, plan.smem_bytes,
            plan.swizzle, None if parts is None else parts.data_ptr(), split,
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"flash_bwd_dkv_{pair} at split {split}: error {code}")

    return run, dk, dv


# the name the f32 cluster pair's card tests call it by
f32_dkv_at_split = dkv_at_split


def _split_check(pair: str, q, k, v, dout, lse, delta, h: int, h_kv: int, extra: tuple,
                 want, inner: int, d_true: int, clusters, sm_scale: float = None,
                 tol: float = F32_TOL) -> dict:
    """dK/dV's GQA split (``pair`` "tri" or "rect", masks ``extra`` =
    (causal, window, seg)) at the plan's split for the card's resident
    dK/dV ``clusters`` (the f32 cluster pair; None: the 16-bit pair's
    resident CTAs, ``flash_bwd.dkv_resident_ctas``): both kernels run twice
    through their wrappers give the same bits (no atomics, the partials
    added in part order); where the plan splits the walk, dK/dV at split 1
    too (:func:`dkv_at_split`), held to ``want`` at ``tol`` and timed beside
    it. ``q`` ... ``dout`` are the kernels' (padded) inputs, ``d_true`` the
    head dim ``want`` has."""
    from tpu_operator_torch.kernels import flash_bwd

    bh, s, d = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if clusters is None:
        unsplit = (flash_bwd.tri_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms) if pair == "tri"
                   else flash_bwd.rect_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, *extra[:2]))
        clusters = flash_bwd.dkv_resident_ctas(q.dtype, d, pair == "tri", unsplit[1])
    if pair == "tri":
        _, plan = flash_bwd.tri_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, clusters=clusters)
    else:
        _, plan = flash_bwd.rect_bwd_plan(q.dtype, bh, k.shape[0], s, d, sms, *extra[:2],
                                          clusters=clusters)
    dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{pair}")
    dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
    args = (q, k, v, None, dout, lse, delta, h, h_kv, *extra)
    first = (dq_fn(*args, sm_scale=sm_scale), *dkv_fn(*args, sm_scale=sm_scale))
    second = (dq_fn(*args, sm_scale=sm_scale), *dkv_fn(*args, sm_scale=sm_scale))
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    if not all(same):
        raise RuntimeError(f"{q.dtype} {pair} pair at split {plan.split}: two runs differ in "
                           f"dq/dk/dv {same}")
    out = {"split": plan.split, "same_bits": True, "resident": clusters}
    if plan.split == 1:
        return out
    run_dkv, dk, dv = dkv_at_split(pair, 1, q, k, v, dout, lse, delta, h, h_kv, extra, sm_scale)
    run_dkv()
    torch.cuda.synchronize()
    errs = [err(w, g[..., :d_true]) for w, g in zip(want[1:], (dk, dv))]
    if not max(errs) <= tol:
        raise RuntimeError(f"{q.dtype} {pair} dK/dV at split 1 disagrees: dk/dv err {errs}")
    out.update(split_1_dkv_ms=device_ms(run_dkv, inner), split_1_max_abs_err=max(errs))
    return out


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
                       inner: int, sm_scale: float = None) -> dict:
    """A bf16 or fp16 forward kernel (``case["kernel"]``; the general one
    with the ``masks`` of attention_plain) launched with the q-tile height its plan
    did not pick (the plans' ``block_m`` knob), straight through the
    library (no launch is counted), held to the same tolerances, and timed:
    what the plan's choice is worth. ``q``, ``k``, ``v`` are the kernel's
    (padded) inputs, ``sm_scale`` the softmax scale (None: 1/√D). A head
    dim with one tile height (256) has no other plan: only the picked
    height comes back."""
    from tpu_operator_torch.kernels import flash_fwd

    bh, sq, d = q.shape
    sk = k.shape[1]
    tri = case["kernel"] == "flash_fwd_tri"
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_for(block_m=None):
        if tri:
            return flash_fwd.tri_plan(q.dtype, bh, sq, d, sms, block_m)
        return flash_fwd.rect_plan(q.dtype, bh, sq, sk, d, sms, masks["causal"],
                                   masks["window"], masks["q_start"], masks["k_start"], block_m)

    picked = plan_for().block_m
    if len(flash_fwd.tile_heights(q.dtype, d)) < 2:
        return {"block_m": picked}
    plan = plan_for(192 - picked)  # the other of 64 and 128
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device="cuda")
    lib, dtype = flash_fwd._lib(q.dtype, d), flash_fwd._DTYPES[q.dtype]
    qscale = flash_fwd._qscale(d, sm_scale)
    seg = None if tri or masks["seg"] is None else masks["seg"].data_ptr()

    def run():
        # on the current stream, which a graph capture switches
        stream = torch.cuda.current_stream().cuda_stream
        if tri:
            code = lib.flash_fwd_tri(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     lse.data_ptr(), dtype, bh, sq, d, h, h_kv, qscale,
                                     plan.block_m, plan.smem_bytes, plan.swizzle, stream)
        else:
            code = lib.flash_fwd_rect(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, out.data_ptr(), lse.data_ptr(),
                dtype, bh, sq, sk, d, h, h_kv, int(masks["causal"]), masks["q_start"],
                masks["k_start"], masks["window"] or 0, qscale, plan.block_m, plan.smem_bytes,
                plan.swizzle, stream)
        if code != 0:
            raise RuntimeError(f"{case['kernel']} at block_m {plan.block_m}: error {code}")

    run()
    torch.cuda.synchronize()
    o_err, lse_err = err(out[..., :want.shape[-1]], want), err(lse, want_lse)
    if not (o_err <= BF16_TOL and lse_err <= LSE_TOL):
        raise RuntimeError(f"{case['kernel']} [{case['label']}] at block_m {plan.block_m} "
                           f"disagrees: O err {o_err}, lse err {lse_err}")
    return {"block_m": picked, "other_block_m": plan.block_m, "other_ms": device_ms(run, inner),
            "other_max_abs_err": o_err}


def _fwd_setup(case, q, k, v, seg) -> tuple:
    """(kern, plain, plain_args) of a forward case on (q, k, v) in their
    dtype: the case's kernel on the kernels' (padded) inputs, and
    attention_plain at the case's own head dim."""
    from tpu_operator_torch.kernels import flash_fwd

    h = case["q"][2]
    h_kv = case.get("h_kv", h)
    # a head dim the kernels do not take runs zero-padded, at its own scale
    (qp, kp, vp), scale = _padded(case, q, k, v)
    if case["kernel"] == "flash_fwd_tri":
        plain_args = dict(causal=True, q_start=0, k_start=0, window=None, seg=None)

        def kern():
            return flash_fwd.flash_fwd_tri(qp, kp, vp, h, h_kv, sm_scale=scale)
    else:
        plain_args = dict(causal=case["causal"], q_start=case.get("q_start", 0),
                          k_start=case.get("k_start", 0), window=case.get("window"), seg=seg)

        def kern():
            return flash_fwd.flash_fwd_rect(qp, kp, vp, h, h_kv, **plain_args, sm_scale=scale)

    def plain():
        return flash_fwd.attention_plain(q, k, v, h, h_kv, **plain_args)

    return kern, plain, plain_args


def _fwd_errors(kern, plain, d: int) -> tuple:
    """(O, lse, O err, lse err) of a forward kernel against its plain version."""
    out, lse = kern()
    want, want_lse = plain()
    torch.cuda.synchronize()
    return want, want_lse, err(out[..., :d], want), err(lse, want_lse)


def phase_kernels() -> list:
    from tpu_operator_torch.kernels import flash_fwd
    from tpu_operator_torch.kernels.flash_fwd import TENSOR_CORE_DTYPES, keep_mask

    gen = torch.Generator(device="cuda").manual_seed(20260818)
    tile_gen = torch.Generator(device="cuda").manual_seed(F32_TILE_SEED)
    cluster_gen = torch.Generator(device="cuda").manual_seed(WIDE_CLUSTER_FWD_SEED)
    results = []
    for case in (KERNEL_CASES + HEAD_DIM_KERNEL_CASES + FLOAT16_KERNEL_CASES
                 + HEAD_DIM_512_KERNEL_CASES + HEAD_DIM_576_KERNEL_CASES + WIDE_KERNEL_CASES
                 + WIDE_CLUSTER_FWD_CASES + F32_TILE_KERNEL_CASES):
        rows_gen = tile_gen if case in F32_TILE_KERNEL_CASES else gen
        if case in WIDE_CLUSTER_FWD_CASES:
            rows_gen = cluster_gen
        q, k, v, seg = _case_inputs(case, rows_gen)
        b, sq, h, d = case["q"]
        h_kv = case.get("h_kv", h)
        kern, plain, plain_args = _fwd_setup(case, q, k, v, seg)
        want, want_lse, o_err, lse_err = _fwd_errors(kern, plain, d)
        o_tol = F32_TOL if case["dtype"] == torch.float32 else BF16_TOL
        if not (o_err <= o_tol and lse_err <= LSE_TOL):
            raise RuntimeError(f"{case['kernel']} [{case['label']}] disagrees with its plain "
                               f"version: O err {o_err} (tol {o_tol}), lse err {lse_err}")
        twin = {}
        if case["dtype"] == torch.float16:
            # the same case in bf16, on these inputs rounded to bf16
            _, _, twin_err, _ = _fwd_errors(*_fwd_setup(
                case, *(x.to(torch.bfloat16) for x in (q, k, v)), seg)[:2], d)
            twin = {"bf16_twin_err": twin_err}
            if not o_err < twin_err:
                raise RuntimeError(f"fp16 {case['kernel']} [{case['label']}]: O err {o_err} not "
                                   f"below bf16's {twin_err} on the same inputs")
        mask = keep_mask(b * h, sq, case.get("sk", sq), h, **plain_args, device="cuda")
        live = int(mask.sum()) * (b * h // mask.shape[0])
        bound_ms, bound_by = _bound(case, live, d)
        inner = case.get("inner", 20)
        library = _library_call(case, q, k, v, seg)
        row = {
            "kernel": case["kernel"], "label": case["label"],
            "dtype": str(case["dtype"]).replace("torch.", ""), "main_path": bool(case.get("main")),
            "max_abs_err": o_err, "lse_err": lse_err,
            "ms": device_ms(kern, inner), "plain_ms": device_ms(plain, inner),
            "library_ms": device_ms(library, inner),
            "eager_ms": cuda_ms(kern, inner), "eager_plain_ms": cuda_ms(plain, inner),
            "eager_library_ms": cuda_ms(library, inner),
            "bound_ms": bound_ms, "bound_by": bound_by, "live_pairs": live,
            "library_backend": sdpa_backend(case, q, k, v, seg, case["kernel"] == "flash_fwd_tri"),
            **twin,
        }
        row["tflops"] = 4.0 * d * live / row["ms"] / 1e9
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        rate = f", {row['tflops']:.1f} TFLOP/s, {row['ratio_to_library']:.2f}x sdpa"
        if case["dtype"] in TENSOR_CORE_DTYPES:
            (qp, kp, vp), scale = _padded(case, q, k, v)
            row.update(_other_tile_height(case, qp, kp, vp, h, h_kv, plain_args, want, want_lse,
                                          inner, scale))
            rate += f", {row['block_m']}-row q tiles" + (
                f" (at {row['other_block_m']} rows: {row['other_ms']:.5f} ms)"
                if "other_block_m" in row else " (no other tile height at this head dim)")
        width = flash_fwd.padded_head_dim(d)
        if case["dtype"] in TENSOR_CORE_DTYPES and flash_fwd.is_wide(width):
            # the slab clusters of the 16-bit forward above 576 resident on the card at once
            row["clusters"] = flash_fwd.f32_wide_geometry(width, flash_fwd.WIDE_SLAB)[2]
            row["active_clusters"] = flash_fwd.wide_active_clusters(
                case["dtype"], width, case["kernel"] == "flash_fwd_tri")
            rate += f", clusters of {row['clusters']} resident {row['active_clusters']}"
            # every rank adds the partials in rank order: two runs give the same bits
            (out_a, lse_a), (out_b, lse_b) = kern(), kern()
            torch.cuda.synchronize()
            if not (torch.equal(out_a, out_b) and torch.equal(lse_a, lse_b)):
                raise RuntimeError(f"{case['kernel']} [{case['label']}]: two runs differ")
            del out_a, lse_a, out_b, lse_b
            rate += ", two runs bit for bit"
        if case["dtype"] == torch.float32 and width > flash_fwd.F32_WHOLE_ROW_D:
            # the f32 forward's thread-block clusters (at 32-128: CTAs, a
            # cluster of one) resident on the card at once
            tri = case["kernel"] == "flash_fwd_tri"
            rows_per_cta = flash_fwd.f32_rows(sq)
            row["block_m"] = rows_per_cta
            row["active_clusters"] = flash_fwd.f32_active_clusters(width, tri, rows_per_cta)
            row["slab"] = (flash_fwd.f32_tile_fwd_width(width)
                           if width < flash_fwd.F32_CLUSTER_MIN_D else flash_fwd.F32_SLAB)
            rate += (f", {rows_per_cta}-row q tiles, clusters of "
                     f"{flash_fwd.f32_wide_geometry(width)[2]} on {row['slab']}-column slabs "
                     f"resident {row['active_clusters']}")
        if twin:
            rate += f"; bf16 on the same inputs: O err {twin['bf16_twin_err']:.3g}"
        results.append(row)
        log(f"kernel {row['kernel']} [{row['label']}]: O err {o_err:.3g}, lse err {lse_err:.3g}; "
            f"device ms: kernel {row['ms']:.5f}, plain {row['plain_ms']:.5f}, "
            f"sdpa {row['library_ms']:.5f} ({row['library_backend']}), bound {bound_ms:.5f} by "
            f"{bound_by}{rate}; eager ms: "
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


def eager_engine(*args, **kwargs):
    """A ``DecodeEngine`` whose decode and prefill run op by op on the card,
    as the engine ran before its CUDA graphs: the reference the graphed
    engine's tokens are held to."""
    from tpu_operator_torch.workloads.serving import DecodeEngine

    class EagerEngine(DecodeEngine):
        def _compiled(self, body, *inputs):
            device = self.device
            return lambda *a: body(*(t.to(device) for t in a))

    return EagerEngine(*args, **kwargs)


def row_major_engine(*args, **kwargs):
    """A graphed ``DecodeEngine`` whose int8 MLP weights are row-major, as
    the engine built them before ``serving.int8_weight`` laid them out
    column-major; its tokens must be the same."""
    from tpu_operator_torch.workloads.serving import DecodeEngine

    engine = DecodeEngine(*args, **kwargs)
    for name in ("w1_q", "w2_q"):  # the step state holds this dict
        engine.params[name] = engine.params[name].contiguous()
    return engine


def _engine_times(engine) -> dict:
    """Eager, replayed and device ms of one decode and one prefill at offset
    0 (flash or dense as the engine's config says), every lane masked so
    that every write lands on the scratch page, and the device operations
    of each (``graph_nodes``)."""
    import functools

    from tpu_operator_torch.workloads.serving import _decode_step, _prefill_step

    c = engine.cfg
    table = torch.full((c.max_batch, c.pages_per_slot), c.max_pages, dtype=torch.int32,
                       device="cuda")
    zeros = torch.zeros((c.max_batch,), dtype=torch.int64, device="cuda")
    masked = torch.zeros((c.max_batch,), dtype=torch.bool, device="cuda")
    chunk = torch.zeros((c.prefill_chunk,), dtype=torch.int64, device="cuda")
    valid = torch.tensor([c.prefill_chunk], device="cuda")
    steps = {"decode": (functools.partial(_decode_step, engine._state), engine._decode,
                        (table, zeros, masked, zeros)),
             "prefill": (functools.partial(_prefill_step, engine._state, 0), engine._prefill_fn(0),
                         (table[0], chunk, valid))}
    out = {}
    for name, (body, compiled, args) in steps.items():
        out[name] = {"eager_ms": cuda_ms(lambda: body(*args), 20),
                     "replay_ms": cuda_ms(lambda: compiled(*args), 20),
                     "device_ms": device_ms(lambda: body(*args), 20),
                     "graph_nodes": graph_nodes(lambda: body(*args))}
    return out


def phase_serving() -> dict:
    from tpu_operator_torch.workloads.serving import DecodeEngine, ServingModelConfig, make_requests

    _int8_check()
    requests = make_requests(16, seed=20260818, prompt_len=24, decode_max=32)
    runs = {}
    for name, flash, make in (("dense", False, DecodeEngine), ("flash", True, DecodeEngine),
                              ("flash eager", True, eager_engine),
                              ("flash row-major int8", True, row_major_engine)):
        engine = make(ServingModelConfig(use_flash_prefill=flash))
        engine.warmup(24)
        batch = copy.deepcopy(requests)
        zero_launches()
        for r in batch:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        runs[name] = {
            "tokens": {r.rid: list(r.output) for r in engine.completed},
            "launches": read_launches(),
            "report": engine.report(),
        }
        if name == "flash":
            times = _engine_times(engine)
        if name == "flash row-major int8":
            row_major_times = _engine_times(engine)
    flash, dense, eager = runs["flash"], runs["dense"], runs["flash eager"]
    if flash["tokens"] != runs["flash row-major int8"]["tokens"]:
        raise RuntimeError("the column-major int8 weights change the greedy tokens")
    if len(flash["tokens"]) != 16 or any(not t for t in flash["tokens"].values()):
        raise RuntimeError(f"serving answered {len(flash['tokens'])} of 16 requests")
    if flash["tokens"] != dense["tokens"]:
        raise RuntimeError("flash-prefill greedy tokens differ from dense prefill")
    if flash["tokens"] != eager["tokens"]:
        raise RuntimeError("the graphed engine's greedy tokens differ from the eager engine's")
    if flash["launches"]["flash_fwd_rect"] == 0 or flash["launches"] != eager["launches"]:
        raise RuntimeError(f"serving prefill launches {flash['launches']} (the eager engine: "
                           f"{eager['launches']}): expected the general kernel, as often as eager")
    rep = flash["report"]
    log(f"serving: 16 requests, tokens identical to dense prefill and to the eager engine, "
        f"launches {flash['launches']}, {rep['tokens_per_s']} tok/s, ttft p50 "
        f"{rep['ttft_p50_s']} s p99 {rep['ttft_p99_s']} s, step p50 {rep.get('step_p50_s')} s "
        f"p99 {rep.get('step_p99_s')} s (dense prefill: {dense['report']['tokens_per_s']} tok/s; "
        f"eager engine: {eager['report']['tokens_per_s']} tok/s, step p50 "
        f"{eager['report'].get('step_p50_s')} s)")
    log("serving: " + "; ".join(
        f"{name} ms eager {t['eager_ms']:.5f}, replay {t['replay_ms']:.5f}, device "
        f"{t['device_ms']:.5f}, {t['graph_nodes']} device operations" for name, t in times.items()))
    log("serving: the int8 MLP's weights row-major, as before they were laid out column-major: "
        "the same tokens; " + "; ".join(
            f"{name} ms replay {t['replay_ms']:.5f}, device {t['device_ms']:.5f} (column-major "
            f"{times[name]['replay_ms']:.5f}, {times[name]['device_ms']:.5f})"
            for name, t in row_major_times.items()))
    return {"launches": flash["launches"], "report": rep, "dense_report": dense["report"],
            "eager_report": eager["report"], "graph_times": times,
            "row_major_int8_graph_times": row_major_times, "tokens": flash["tokens"]}


TRAIN_CONFIGS = {"plain": {}, "gqa": {"kv_heads": 2}, "packed": {"packed_segments": 2}}
# the graphed step's calls held to the eager step's: the first runs eagerly
# (the warm-up), the next three replay the graph
GRAPH_STEPS = 4
# the same kernels on the same inputs in the same order: expected bit for
# bit; the bar leaves room for a library that picks another algorithm
# under capture
GRAPH_REL_TOL = 1e-6


def _replays_vs_eager(step, params, batch) -> dict:
    """GRAPH_STEPS calls of a graphed train step against as many of its
    eager step from the same params."""
    graphed = _step_losses(step, params, batch, GRAPH_STEPS)
    eager = _step_losses(step.eager, params, batch, GRAPH_STEPS)
    rel = _curve_rel(graphed, eager)
    if not rel <= GRAPH_REL_TOL:
        raise RuntimeError(f"graphed step losses {graphed} differ from the eager step's {eager} "
                           f"by {rel} (relative, tol {GRAPH_REL_TOL})")
    return {"graphed_losses": graphed, "eager_losses": eager, "rel_err": rel,
            "bitwise": graphed == eager}


def _step_times(step, params, batch, inner: int = 10) -> dict:
    """A graphed train step's ms: eager (``step.eager`` as a caller pays
    it), replayed (the graphed step on its own params, as a loop calls it)
    and device (the eager step captured: no host between launches), each
    the median of 7 timings of ``inner`` calls; and the device operations
    of one step."""
    static, _ = step(params, batch)
    static, _ = step(static, batch)  # captured by now
    return {"step_ms": cuda_ms(lambda: step.eager(params, batch), inner=inner),
            "step_replay_ms": cuda_ms(lambda: step(static, batch), inner=inner),
            "step_device_ms": device_ms(lambda: step.eager(params, batch), inner=inner),
            "step_graph_nodes": graph_nodes(lambda: step.eager(params, batch))}


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
        replays = _replays_vs_eager(step, params, batch)
        times = _step_times(step, params, batch)
        if name == "plain":
            dense = build_train_step(dataclasses.replace(cfg, use_flash_attention=False), "cuda")
            times.update({f"dense_{k}": v for k, v in _step_times(*dense).items()})
        out["paths"][f"train {name}"] = counts
        out["configs"][name] = {"losses": got["losses"], "reference": ref_name,
                                "reference_losses": ref["losses"], "rel_err": rel,
                                "replays": replays, "telemetry": got["telemetry"], **times}
        per_step = {k: v / steps for k, v in counts.items() if v}
        log(f"train {name}: run_burnin(steps={steps}) losses {[round(x, 5) for x in got['losses']]}, "
            f"{ref_name} {[round(x, 5) for x in ref['losses']]} (rel err {rel:.3g}); launches per "
            f"step {per_step}; {GRAPH_STEPS} graphed steps vs eager: rel {replays['rel_err']:.3g}"
            f"{' (bit for bit)' if replays['bitwise'] else ''}; step ms eager "
            f"{times['step_ms']:.4f}, replay {times['step_replay_ms']:.4f}, device "
            f"{times['step_device_ms']:.4f}, {times['step_graph_nodes']} device operations"
            + (f" (dense path: eager {times['dense_step_ms']:.4f}, replay "
               f"{times['dense_step_replay_ms']:.4f}, device {times['dense_step_device_ms']:.4f}, "
               f"{times['dense_step_graph_nodes']} operations)" if name == "plain" else ""))
    out["grad_check_max_abs_err"] = _flash_grad_check()
    log(f"train: f32 flash_attention gradients vs dense, max abs err "
        f"{out['grad_check_max_abs_err']:.3g}")
    _f32_tpujob(out)
    run = _run_row(lambda: flash_attention_bench(device="cuda"))
    bench = out["flash_attention_bench"] = run["rates"]
    out["flash_attention_bench_peak_mib"] = run["peak_mib"]
    log("train: flash_attention_bench() " + ", ".join(
        f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}" for k, v in bench.items())
        + f"; peak memory {run['peak_mib']:.1f} MiB above its start (graph replays)")
    out["flash_fwd_bwd_4096"] = _flash_fwd_bwd_ms()
    log(f"train: one flash_attention fwd+bwd at (1,4096,8,128) bf16: device ms "
        f"{out['flash_fwd_bwd_4096']['device_ms']:.5f}, eager ms "
        f"{out['flash_fwd_bwd_4096']['eager_ms']:.5f}")
    return out


# an f32 TPUJob at entry() widths (head dim 64): the f32 backward pair's first
# end-to-end path, plain (the triangle pair) and packed in two documents (the
# general pair)
F32_TPUJOB_CONFIGS = {"plain": {}, "packed": {"packed_segments": 2}}


def _f32_tpujob(out: dict) -> None:
    """An f32 TPUJob's trainer at entry() widths: ``trainer_config`` with
    ``dtype`` float32 through ``run_burnin(steps=3)`` (its losses finite and
    falling), plain and packed. Each step's loss within F32_TOL relative of
    the f32 dense path (packed: of the CPU plain versions, as the packed
    run above), and exactly the f32 pair's launches: each kernel of the
    step's pair once per layer and step, the split sum once more per dK/dV
    launch where the plan splits its GQA walk, no other kernel (none of the
    16-bit libraries is loaded by it)."""
    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.kernels import flash_bwd
    from tpu_operator_torch.workloads.burnin import run_burnin
    from tpu_operator_torch.workloads.training import trainer_config

    steps = 3
    widths = {f.name: getattr(ENTRY_CONFIG, f.name) for f in dataclasses.fields(ENTRY_CONFIG)
              if f.name in ("d_model", "n_heads", "kv_heads", "d_ff", "seq_len", "batch",
                            "n_layers")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, over in F32_TPUJOB_CONFIGS.items():
        cfg = trainer_config({**widths, "dtype": "float32", "use_flash_attention": True, **over})
        pair = "rect" if cfg.packed_segments else "tri"
        dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
        zero_launches()
        sums_before = dkv_fn.split_sums
        got = run_burnin(steps=steps, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        counts, sums = read_launches(), dkv_fn.split_sums - sums_before
        expected = _expected_launches(counts, cfg, steps)
        h, h_kv, d = cfg.n_heads, cfg.resolved_kv_heads, cfg.d_model // cfg.n_heads
        planner = flash_bwd.tri_bwd_plan if pair == "tri" else (
            lambda *a, clusters: flash_bwd.rect_bwd_plan(*a, True, clusters=clusters))
        _, plan = planner(torch.float32, cfg.batch * h, cfg.batch * h_kv, cfg.seq_len, d, sms,
                          clusters=flash_bwd.f32_wide_active_clusters(d, "dkv", pair == "tri"))
        want_sums = cfg.n_layers * steps * (plan.split > 1)
        if counts != expected or sums != want_sums:
            raise RuntimeError(f"f32 TPUJob {name}: launches {counts}, split sums {sums}, "
                               f"expected {expected} and {want_sums}")
        if cfg.packed_segments:
            ref_name, ref = "CPU plain versions", run_burnin(steps=steps, cfg=cfg, device="cpu")
        else:
            ref_name = "f32 dense path"
            ref = run_burnin(steps=steps, cfg=dataclasses.replace(cfg, use_flash_attention=False),
                             device="cuda")
        rel = _curve_rel(got["losses"], ref["losses"])
        if not rel <= F32_TOL:
            raise RuntimeError(f"f32 TPUJob {name}: losses {got['losses']} differ from the "
                               f"{ref_name}'s {ref['losses']} by {rel} (relative, tol {F32_TOL})")
        out["paths"][f"train f32 TPUJob {name}"] = counts
        out["configs"][f"f32 TPUJob {name}"] = {
            "losses": got["losses"], "reference": ref_name, "reference_losses": ref["losses"],
            "rel_err": rel, "split": plan.split, "split_sums": sums}
        log(f"train f32 TPUJob {name} (head dim {d}): run_burnin(steps={steps}) losses "
            f"{got['losses']}, {ref_name} {ref['losses']} (rel err {rel:.3g}); launches per step "
            f"{ {k: v / steps for k, v in counts.items() if v} }, dK/dV split {plan.split}, "
            f"split sums {sums}")


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


def chain_counts() -> dict:
    """A copy of ``kernels/graph.chain_counts``: captures and replays by
    timed chain."""
    from tpu_operator_torch.kernels import graph

    return {name: dict(c) for name, c in graph.chain_counts.items()}


def counts_since(before: dict) -> dict:
    """The captures and replays of each timed chain since ``before``."""
    return {name: {k: v - before.get(name, {}).get(k, 0) for k, v in c.items()}
            for name, c in chain_counts().items()
            if c != before.get(name, {"captures": 0, "replays": 0})}


def _two_point_counts(name: str, reps: int) -> dict:
    """What one two-point timing of a graphed chain does: each of its two
    lengths captured once, each of ``reps`` pairs two replays."""
    return {name: {"captures": 2, "replays": 2 * reps}}


@contextlib.contextmanager
def eager_chains():
    """Every timed chain made inside runs eagerly, as the port's chains ran
    before they were graphed: the chain function called in a Python loop,
    every launch from the host, the seed a Python float."""
    from tpu_operator_torch.kernels import graph

    replays_on = graph.replays_on
    graph.replays_on = lambda device: False
    try:
        yield
    finally:
        graph.replays_on = replays_on


def _sweep_rates(fwd_bwd: bool) -> dict:
    """The generation sweep's flash family at its "cuda" shape: each
    height's ms a step, whether pass 1 pruned it, the winner's height."""
    from tpu_operator_torch.workloads import autotune

    f = autotune.SWEEP_PROFILES["cuda"]["flash"]
    records, winner = autotune.sweep_flash(seq_len=f["seq_len"], heads=f["heads"],
                                           head_dim=f["head_dim"], iters=f["iters"],
                                           reps=f["reps"], fwd_bwd=fwd_bwd, device="cuda")
    out = {f"block_m {r.config['block_m']} ms": r.time_ms for r in records}
    out.update({f"block_m {r.config['block_m']} pruned": r.pruned for r in records})
    out["winner"] = winner.config["block_m"]
    return out


def _sweep_counts(name: str, rates: dict, reps: int) -> dict:
    """A sweep's chains: per height a capture and a replay in pass 1; an
    unpruned height then captures its long chain and replays the short one
    once more and every timed pair."""
    heights = [k.split()[1] for k in rates if k.endswith(" ms")]
    pruned = sum(rates[f"block_m {h} pruned"] for h in heights)
    full = len(heights) - pruned
    return {name: {"captures": len(heights) + full, "replays": len(heights) + full * (1 + 2 * reps)}}


def chain_rows() -> dict:
    """Phase 7's table: each timed chain the port runs, as its caller calls
    it: row name -> (a function returning its rates, the unit, what one
    call does to ``chain_counts`` when graphed)."""
    from tpu_operator_torch.workloads import matmul_bench
    from tpu_operator_torch.workloads.flashattention import (
        bench_forward_s,
        bench_fwd_bwd_s,
        flash_attention,
    )
    from tpu_operator_torch.workloads.kernels import hbm_bandwidth_probe
    from tpu_operator_torch.workloads.multiproc import step_telemetry

    def probe(**kw):
        r = hbm_bandwidth_probe(**kw)
        return {"GB/s": r["bandwidth_gbps"], "inclusive GB/s": r["inclusive_gbps"],
                "overhead ms": r.get("dispatch_overhead_ms_est"),
                "unstable": bool(r.get("unstable_timing"))}

    def matmul(fn, key, size, iters):
        r = fn(size=size, iters=iters)
        return {key: r[key], f"inclusive {key}": r[f"inclusive_{key}"],
                "overhead ms": r.get("dispatch_overhead_ms_est"),
                "unstable": bool(r.get("unstable_timing"))}

    gen = torch.Generator().manual_seed(1)  # flash_attention_bench()'s inputs
    q, k, v = (torch.randn((1, 4096, 8, 128), generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))

    def flash(a, kk, vv):
        return flash_attention(a, kk, vv, causal=True)

    def bench():
        return {"fwd ms": bench_forward_s(flash, q, k, v) * 1e3,
                "fwd+bwd ms": bench_fwd_bwd_s(flash, q, k, v) * 1e3}

    def telemetry():
        report, _ = step_telemetry("h100-0", torch.device("cuda"))
        return {"step p50 ms": report.step_p50_s * 1e3, "step max ms": report.step_max_s * 1e3}

    bench_counts = {"bench forward": {"captures": 2, "replays": 8},
                    "bench fwd+bwd": {"captures": 2, "replays": 8}}
    return {
        "triad 64 MiB": (lambda: probe(size_mb=64, iters=25), "GB/s", _two_point_counts("triad", 6)),
        "triad 128 MiB": (lambda: probe(), "GB/s", _two_point_counts("triad", 6)),
        "bf16 8192": (lambda: matmul(matmul_bench.matmul_tflops, "tflops", 8192, 16), "TFLOP/s",
                      _two_point_counts("matmul", 5)),
        "int8 8192": (lambda: matmul(matmul_bench.int8_matmul_tops, "tops", 8192, 16), "TOP/s",
                      _two_point_counts("int8", 5)),
        "bf16 4096": (lambda: matmul(matmul_bench.matmul_tflops, "tflops", 4096, 8), "TFLOP/s",
                      _two_point_counts("matmul", 5)),
        "bf16 256": (lambda: matmul(matmul_bench.matmul_tflops, "tflops", 256, 2), "TFLOP/s",
                     _two_point_counts("matmul", 5)),
        "flash bench (1,4096,8,128)": (bench, "ms", bench_counts),
        "sweep forward (1,8192,8,128)": (lambda: _sweep_rates(False), "ms", "sweep forward"),
        "telemetry 32 x 256²": (telemetry, "ms", {"telemetry": {"captures": 1, "replays": 3}}),
    }


def _run_row(fn) -> dict:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = time.perf_counter()
    rates = fn()
    torch.cuda.synchronize()
    return {"rates": rates, "seconds": time.perf_counter() - start,
            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}


def eager_against_replayed() -> dict:
    """Each timed chain run in turns on this card: the eager loop, the
    graph replays, the replays again, the eager loop again. Holds every
    graphed run's captures and replays to what its timing makes (one
    capture per length, one replay per timed call) and the eager runs to
    none; records the rates and each run's peak memory above what was
    allocated before it."""
    out = {}
    for row, (fn, unit, counts) in chain_rows().items():
        runs = []
        for graphed in (False, True, True, False):
            before = chain_counts()
            with contextlib.nullcontext() if graphed else eager_chains():
                run = _run_row(fn)
            did = counts_since(before)
            want = {}
            if graphed:
                want = _sweep_counts(counts, run["rates"], 4) if isinstance(counts, str) else counts
            if did != want:
                raise RuntimeError(f"chains {row} ({'graphed' if graphed else 'eager'}): "
                                   f"captures and replays {did}, expected {want}")
            runs.append(dict(run, graphed=graphed, chain_counts=did))
        out[row] = {"unit": unit, "runs": runs}

        def both(key, runs=runs):
            def fmt(v):
                return f"{v:.5g}" if isinstance(v, float) else str(v)
            eager = " / ".join(fmt(r.get(key)) for r in runs if not r["graphed"])
            replay = " / ".join(fmt(r.get(key)) for r in runs if r["graphed"])
            return f"eager {eager}, replayed {replay}"

        for r in runs:
            r.update({k: v for k, v in r["rates"].items() if isinstance(v, float)})
        keys = [k for k, v in runs[0]["rates"].items() if isinstance(v, float)]
        log(f"chains: {row}: " + "; ".join(f"{k} {both(k)}" for k in keys)
            + f"; peak MiB {both('peak_mib')}; a graphed run {runs[1]['chain_counts']}"
            + "".join(f"; {k} {[r['rates'][k] for r in runs]}"
                      for k, v in runs[0]["rates"].items() if not isinstance(v, float)))
    return out


def _seed_rounding() -> dict:
    """A graphed chain's seed is a 0-dim f32 tensor on the card; bf16 times
    it as ``timing.seeded`` takes it must equal bf16 times the Python
    float, the eager chain's product, at the timing's seed and at one that
    bf16 cannot hold (1.3, which bf16 rounds to 1.296875). Also records
    whether the plain product ``x * s`` rounds the seed to bf16 first."""
    from tpu_operator_torch.workloads.timing import seeded

    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((256, 256), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for seed in (1.001, 1.3):
        s = torch.tensor(seed, device="cuda")
        rounded = float(torch.tensor(seed).to(torch.bfloat16))
        out[seed] = {"seeded_equals_float_seed": torch.equal(seeded(x, s), x * seed),
                     "plain_product_equals_float_seed": torch.equal(x * s, x * seed),
                     "plain_product_equals_bf16_seed": torch.equal(x * s, x * rounded)}
    if not all(v["seeded_equals_float_seed"] for v in out.values()):
        raise RuntimeError(f"a tensor seed rounds otherwise than a float seed: {out}")
    return out


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
        before = chain_counts()
        zero_launches()
        report = hbm_bandwidth_probe(**kwargs)
        torch.cuda.synchronize()
        counts = read_launches()
        expected = {k: launches if k == "triad_kernel" else 0 for k in counts}
        if counts != expected:
            raise RuntimeError(f"{path}: launches {counts}, expected {expected}")
        replays = counts_since(before)
        if replays != _two_point_counts("triad", 6):
            raise RuntimeError(f"{path}: chain captures and replays {replays}, expected "
                               f"{_two_point_counts('triad', 6)}")
        _hold_to_peak(report, ("bandwidth_gbps", "inclusive_gbps"), HBM_GBPS[gen], path)
        out["paths"][path] = counts
        out[path] = report
        log(f"{path}: hbm_bandwidth_probe({', '.join(f'{k}={v}' for k, v in kwargs.items())}) "
            f"{report['kernel']} {report['size_mb']} MiB: {report['bandwidth_gbps']:.1f} GB/s "
            f"({100 * report['bandwidth_gbps'] / HBM_GBPS[gen]:.1f}% of {HBM_GBPS[gen]}), "
            f"inclusive {report['inclusive_gbps']:.1f}, {report['time_ms']:.5f} ms per triad, "
            f"overhead per call {report['dispatch_overhead_ms_est']:.3f} ms; launches {launches} "
            f"through {replays['triad']['replays']} timed replays of {replays['triad']['captures']} "
            f"captured chains")

    smoke = run_smoke(size=512)
    if not smoke["ok"] or smoke["device_count"] != torch.cuda.device_count():
        raise RuntimeError(f"run_smoke: {smoke}")
    out["smoke"] = smoke
    before = chain_counts()
    mm = matmul_bench.matmul_tflops(size=8192, iters=16)
    _hold_to_peak(mm, ("tflops", "inclusive_tflops"), matmul_bench.PEAK_TFLOPS[gen], "bf16 matmul")
    i8 = matmul_bench.int8_matmul_tops(size=8192, iters=16)
    _hold_to_peak(i8, ("tops", "inclusive_tops"), matmul_bench.PEAK_INT8_TOPS[gen], "int8 matmul")
    want = {**_two_point_counts("matmul", 5), **_two_point_counts("int8", 5)}
    if counts_since(before) != want:
        raise RuntimeError(f"matmul chains: captures and replays {counts_since(before)}, "
                           f"expected {want}")
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
    out["seed_rounding"] = _seed_rounding()
    log(f"self-test: the graphed chains' seed on the card {out['seed_rounding']}")
    start = time.monotonic()
    out["chains"] = eager_against_replayed()
    log(f"self-test: eager against replayed chains in {time.monotonic() - start:.1f} s")
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
        times = _step_times(*build_train_step(cfg, "cuda"))
        out["paths"][f"moe {name}"] = counts
        out["moe"][name] = {"losses": got["losses"], "reference": "CPU plain versions",
                            "reference_losses": ref["losses"], "rel_err": rel, **gaps, **times}
        log(f"sharded: moe {name} run_burnin(steps={steps}) losses "
            f"{[round(x, 5) for x in got['losses']]}, CPU plain versions "
            f"{[round(x, 5) for x in ref['losses']]} (rel err {rel:.3g}); output {gaps['out_rel']:.3g}"
            f", worst update {gaps['update_rel']:.3g} ({gaps['update_rel_worst']}) from the CPU's; "
            f"launches per step {({k: v / steps for k, v in counts.items() if v})}; step ms eager "
            f"{times['step_ms']:.4f}, replay {times['step_replay_ms']:.4f}, device "
            f"{times['step_device_ms']:.4f}")


def _one_rank_world(out: dict) -> None:
    import torch.distributed as dist

    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.workloads.burnin import _GraphedStep, build_train_step, make_mesh_4d
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
            if not isinstance(step, _GraphedStep):
                raise RuntimeError(f"one-rank mesh: build_train_step returned {step}, not a "
                                   f"graphed step")
            zero_launches()
            sharded = _step_losses(step, params, batch, steps)  # eager, captured, replayed
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
            replays = _replays_vs_eager(step, params, batch)
            zero_launches()
            step(params, batch)  # one replay
            torch.cuda.synchronize()
            replay_counts = read_launches()
            if replay_counts != _expected_launches(replay_counts, cfg, 1):
                raise RuntimeError(f"one-rank mesh: one replay launched {replay_counts}, expected "
                                   f"{_expected_launches(replay_counts, cfg, 1)}")
            times = _step_times(step, params, batch)
            mesh_gaps = _step_gaps("one-rank mesh", _first_step(cfg, "cuda", mesh), reference)
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
                       "replays": replays, "replay_launches": replay_counts, **times,
                       "gaps": mesh_gaps, "ring_losses": ring,
                       "ring_rel_err": ring_rel, "ring_gaps": ring_gaps, "ring_checks": checks}
    log(f"sharded: one-rank NCCL mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} (no "
        f"collective runs on one rank): MoE + GQA + packed losses {sharded} vs no mesh {plain} "
        f"(rel {rel:.3g}); output {mesh_gaps['out_rel']:.3g}, worst update "
        f"{mesh_gaps['update_rel']:.3g} ({mesh_gaps['update_rel_worst']}) from the CPU's; launches "
        f"{counts}; {GRAPH_STEPS} graphed steps vs eager: rel {replays['rel_err']:.3g}"
        f"{' (bit for bit)' if replays['bitwise'] else ''}; one replay launches "
        f"{({k: v for k, v in replay_counts.items() if v})}; step ms eager {times['step_ms']:.4f}, "
        f"replay {times['step_replay_ms']:.4f}, device {times['step_device_ms']:.4f}, "
        f"{times['step_graph_nodes']} device operations; ring step (sp=1) "
        f"{[round(x, 5) for x in ring]} "
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
# the slice's all-reduce chains (run_allreduce's defaults): one warm-up and
# one timed _chain_seconds per size, each a captured chain of ITERS
# all-reduces and one timed replay
SLICE_CHAIN_CALLS, SLICE_CHAIN_ITERS = 2 * 4, 10


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
    from tpu_operator_torch.workloads import allreduce
    from tpu_operator_torch.workloads.distributed import gang_world
    from tpu_operator_torch.workloads.fabric import run_fabric_probe

    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        allreduce.chain_counts.update(captured_all_reduces=0, timed_replays=0)
        start = time.monotonic()
        report = run_component("slice", Context(validation_dir=tmp), max_attempts=1)
        torch.cuda.synchronize()
        seconds = time.monotonic() - start
        counts = read_launches()
        chains = dict(allreduce.chain_counts)
        written = status_files.read_status("slice-ready", tmp)
    if written != report:
        raise RuntimeError(f"slice-ready holds {written}, the component returned {report}")
    expected = {k: SLICE_LAUNCHES.get(k, 0) for k in counts}
    if counts != expected:
        raise RuntimeError(f"validator slice: launches {counts}, expected {expected}")
    want_chains = {"captured_all_reduces": SLICE_CHAIN_CALLS * SLICE_CHAIN_ITERS,
                   "timed_replays": SLICE_CHAIN_CALLS}
    if chains != want_chains:
        raise RuntimeError(f"validator slice: all-reduce chains {chains}, expected {want_chains}: "
                           f"each timed chain is one replay of {SLICE_CHAIN_ITERS} captured "
                           f"all-reduces")
    _check_slice_report(report)
    with gang_world():
        probe = run_fabric_probe("1x1x1")
        x = torch.ones(1 << 18, device="cuda")
        chain_nodes = graph_node_types(lambda: allreduce._chain(x, 1, SLICE_CHAIN_ITERS))
    if not (probe["ok"] and probe["edges"] == {} and probe["axis_allreduce_us"] == {}):
        raise RuntimeError(f"run_fabric_probe('1x1x1'): {probe}")
    out["paths"]["validator slice"] = counts
    out["component"], out["component_s"], out["fabric_1x1x1"] = report, seconds, probe
    out["chains"], out["chain_graph_nodes"] = chains, chain_nodes
    log(f"slice: run_component('slice') in process, one-rank NCCL world, {seconds:.1f} s: "
        f"slice-ready written; allreduce (a local copy, no link) " + ", ".join(
            f"{r['size_mb']} MiB {r['time_ms']:.4f} ms {r['busbw_gbps']:.1f} GB/s"
            for r in report["results"])
        + f"; collectives {report['collectives']['errors']}; rings "
        f"{report['ring_attention']['max_abs_err']:.3g} / "
        f"{report['ring_flash_attention']['max_abs_err']:.3g} (flash); flash check "
        f"{report['flash_attention']['max_abs_err']:.3g} / "
        f"{report['flash_attention']['segment_max_abs_err']:.3g} (packed); pipeline losses "
        f"{report['pipeline']['losses']}; launches {counts}; all-reduce chains {chains} (each "
        f"timed chain one graph replay; a {SLICE_CHAIN_ITERS}-all-reduce chain's graph holds "
        f"{chain_nodes} on one rank); fabric 1x1x1 numerics ok, no edges")


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
        # the telemetry chain: 4 steps, the first captures, 3 replay (on the card)
        replays = [w["step_telemetry_replays"] for w in report["workers"]]
        if not (report["ok"] and report["psum_ok"] and platforms == want
                and report["ring_attention_max_err"] < 1e-4
                and replays == [3 if "NCCL" in name else 0] * len(replays)):
            raise RuntimeError(f"gang check {name}: {report}")
        out["gang"][name] = dict(report, seconds=seconds)
        log(f"slice: gang check {name}: {report['global_devices']} ranks, psum ok, chain "
            f"{report['psum_chain_ms']:.4f} ms per all-reduce, ring err "
            f"{report['ring_attention_max_err']:.3g}, telemetry step p50 "
            f"{[w['step_telemetry']['step_p50_s'] for w in report['workers']]} s through "
            f"{replays} timed replays, {seconds:.1f} s with the workers' start")


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
# the trainer runs of phase 10: path name -> config overrides beside
# TRAINER_OVERRIDES (plain causal: the triangle kernels; packed documents:
# the general ones)
TRAINER_PATHS = {"trainer": {}, "trainer packed": {"packed_segments": 2}}
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


def _trainer_on_the_card(out: dict, device: str, name: str = "trainer") -> None:
    """One ResumableTrainer run of TRAINER_PATHS[name]. Its first losses
    are held to the dense path's, or with packed documents (which the dense
    path does not take) to the CPU plain versions', as phase 6 does."""
    from tpu_operator_torch.workloads.burnin import build_train_step
    from tpu_operator_torch.workloads.checkpoint import CheckpointStore
    from tpu_operator_torch.workloads.training import (
        ResumableTrainer,
        TrainerError,
        trainer_config,
        verify_continuity,
    )

    cfg = trainer_config(dict(TRAINER_OVERRIDES, **TRAINER_PATHS[name]))
    total = TRAINER_RUN["total_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        trainer = ResumableTrainer(store, cfg, device=device, **TRAINER_RUN)
        saves = _timed_checkpoints(trainer)
        zero_launches()
        trainer.resume(1)
        try:
            trainer.run(total)
            raise RuntimeError(f"{name}: the injected fault at step 13 did not fire")
        except TrainerError as e:
            log(f"{name}: {e} (at step {trainer.step}, checkpoint {trainer.checkpoint_step})")
        trainer.resume(1)
        trainer.run(total)
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_launches()
        executed = len(trainer.history)
        _trainer_launches(counts, cfg, executed, name)
        report = verify_continuity(trainer.history, trainer.checkpoints, total)
        if not (trainer.done and report["ok"] and report["rewinds"] == 1
                and report["max_lost_steps"] == 2):
            raise RuntimeError(f"{name}: continuity {report}")
        first = {}
        reruns = {}
        for h in trainer.history:
            if h["step"] in first:
                reruns[h["step"]] = (first[h["step"]], h["loss"])
            else:
                first[h["step"]] = h["loss"]
        if sorted(reruns) != [11, 12] or any(a != b for a, b in reruns.values()):
            raise RuntimeError(f"{name}: re-executed losses differ from their first run: {reruns}")
        if cfg.packed_segments:
            ref_name, dense = "CPU plain versions", _step_losses(*build_train_step(cfg, "cpu"), 3)
        else:
            dense_cfg = dataclasses.replace(cfg, use_flash_attention=False)
            ref_name, dense = "dense path", _step_losses(*build_train_step(dense_cfg, device), 3)
        head = [first[s] for s in (1, 2, 3)]
        rel = _curve_rel(head, dense)
        if not (rel <= TRAINER_LOSS_TOL and first[total] < first[1]):
            raise RuntimeError(f"{name}: first losses {head} differ from those of the {ref_name} "
                               f"{dense} by {rel} (relative, tol {TRAINER_LOSS_TOL}), or the curve "
                               f"{first[1]} -> {first[total]} does not fall")
        # the trainer's params at the end against the same step looped plainly
        step, params, batch = build_train_step(cfg, device)
        start = host_arrays(params)
        for _ in range(total):
            params, _ = step(params, batch)
        plain = host_arrays(params)
        gap = params_gap(store.latest_good().arrays, plain, start)
        if not gap <= TRAINER_PARAMS_TOL:
            raise RuntimeError(f"{name}: params at step {total} differ from a plain loop's by "
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
        _trainer_launches(torn_counts, cfg, len(second.history), f"{name} torn-blob resume")
        torn_gap = max(abs(h["loss"] - first[h["step"]]) for h in second.history)
        torn_params = params_gap(store.latest_good().arrays, plain, start)
        if not (newest["step"] == total and torn.step == 20 and second.done
                and [h["step"] for h in second.history] == [21, 22, 23, 24]
                and torn_gap <= 1e-3 * (1 + abs(first[21]))
                and torn_params <= TRAINER_PARAMS_TOL):
            raise RuntimeError(f"{name}: torn-blob resume {torn}, history {second.history}, "
                               f"params {torn_params} of the plain loop's change")
    step_s = trainer.step_times[1][1:]
    out["paths"][name] = counts
    out["paths"][f"{name} torn-blob resume"] = torn_counts
    key = name.replace(" ", "_")
    out[key] = {
        "config": dataclasses.asdict(cfg), **{k: list(v) if isinstance(v, tuple) else v
                                              for k, v in TRAINER_RUN.items()},
        "executed_steps": executed, "continuity": report, "losses": trainer.history,
        "reruns": reruns, "reference": ref_name, "dense_losses": dense, "head_rel_err": rel,
        "params_gap": gap,
        "step_ms_median": 1e3 * statistics.median(step_s), "step_ms_min": 1e3 * min(step_s),
        "resume_ms": [1e3 * r.latency_s for r in trainer.resumes],
        "checkpoint_ms": [1e3 * s for s in saves],
        "torn_blob_resume": {"newest_torn": newest["file"], "resumed_at": torn.step,
                             "resume_ms": 1e3 * torn.latency_s, "max_loss_gap": torn_gap,
                             "params_gap": torn_params},
    }
    log(f"{name}: {executed} executed steps of {total} (fault at 13, resumed at "
        f"{trainer.resumes[1].step}), continuity ok, rewinds {report['rewinds']}, lost "
        f"{report['max_lost_steps']}; re-executed losses equal {reruns}; first losses {head} vs "
        f"the {ref_name} {dense} (rel {rel:.3g}); params at step {total} {gap:.3g} of a plain "
        f"loop's change; launches {counts}; step ms median "
        f"{out[key]['step_ms_median']:.4f} (min {out[key]['step_ms_min']:.4f}); resume "
        f"ms {[round(x, 3) for x in out[key]['resume_ms']]}; checkpoint ms "
        f"{[round(x, 3) for x in out[key]['checkpoint_ms']]}")
    log(f"{name}: torn {newest['file']} (step {total}) -> resumed at step {torn.step} in "
        f"{1e3 * torn.latency_s:.3f} ms, finished, largest loss gap to the first run "
        f"{torn_gap:.3g}, params {torn_params:.3g} of a plain loop's change; launches "
        f"{torn_counts}")


class NotFound(Exception):
    """An apiserver's 404 (the port matches a client's errors by class name)."""


class AlreadyExists(Exception):
    """An apiserver's 409 on create."""


class _DictClient:
    """The smallest apiserver client the data plane and the node agents
    need: objects as dicts, ``get_or_none``, a merge ``patch``, ``create``,
    ``update``, ``update_status`` and ``delete``; ``writes`` counts the
    writes. A lock keeps it whole under a kubelet thread."""

    def __init__(self):
        self.objects = {}
        self.writes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _key(api_version, kind, name, namespace):
        return api_version, kind, namespace or "", name

    def _obj_key(self, obj):
        md = obj["metadata"]
        return self._key(obj["apiVersion"], obj["kind"], md["name"], md.get("namespace"))

    def create(self, obj):
        key = self._obj_key(obj)
        with self._lock:
            self.writes += 1
            if key in self.objects:
                raise AlreadyExists(key)
            self.objects[key] = copy.deepcopy(obj)
            return copy.deepcopy(obj)

    def get_or_none(self, api_version, kind, name, namespace=None):
        with self._lock:
            obj = self.objects.get(self._key(api_version, kind, name, namespace))
            return copy.deepcopy(obj) if obj is not None else None

    def patch(self, api_version, kind, name, patch, namespace=None):
        key = self._key(api_version, kind, name, namespace)

        def merge(into, update):
            for k, v in update.items():
                if isinstance(v, dict) and isinstance(into.get(k), dict):
                    merge(into[k], v)
                elif v is None:
                    into.pop(k, None)
                else:
                    into[k] = copy.deepcopy(v)
        with self._lock:
            self.writes += 1
            if key not in self.objects:
                raise NotFound(key)
            merge(self.objects[key], patch)
            return copy.deepcopy(self.objects[key])

    def update(self, obj):
        key = self._obj_key(obj)
        with self._lock:
            self.writes += 1
            if key not in self.objects:
                raise NotFound(key)
            self.objects[key] = copy.deepcopy(obj)
            return copy.deepcopy(obj)

    def update_status(self, obj):
        key = self._obj_key(obj)
        with self._lock:
            self.writes += 1
            if key not in self.objects:
                raise NotFound(key)
            self.objects[key]["status"] = copy.deepcopy(obj.get("status") or {})
            return copy.deepcopy(self.objects[key])

    def delete(self, api_version, kind, name, namespace=None):
        with self._lock:
            self.writes += 1
            if self.objects.pop(self._key(api_version, kind, name, namespace), None) is None:
                raise NotFound(name)


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
    for name in TRAINER_PATHS:
        _trainer_on_the_card(out, device, name)
    _job_worker(out, device)
    out["seconds"] = time.monotonic() - start
    log(f"trainer: phase 10 in {out['seconds']:.1f} s")
    return out


# phase 11: serving replicas warm-started through the fleet compile cache
REPLICA_NS, REPLICA_SERVING, REPLICA_TOPOLOGY = "smoke", "smoke-serving", "1x1x1"
REPLICA_REQUESTS = dict(count=16, seed=20260818, prompt_len=24, decode_max=32)  # phase 5's
# flash_fwd_rect launches of one replica path: 16 requests x 3 prefill chunks of 8
REPLICA_LAUNCHES = 16 * 3


def _replica_env(replica: str, pool: str = "") -> dict:
    """A serving replica's pod env: the card's generation and a topology
    key it into the compile cache."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.workloads.matmul_bench import chip_generation

    return {consts.WORKER_ENV_SERVING_NAME: REPLICA_SERVING,
            consts.WORKER_ENV_REPLICA_NAME: replica, consts.WORKER_ENV_POOL: pool,
            consts.WORKER_ENV_GENERATION: chip_generation(),
            consts.WORKER_ENV_TOPOLOGY: REPLICA_TOPOLOGY}


def _cache_client(cm_data: dict) -> "_DictClient":
    from tpu_operator_torch import consts

    client = _DictClient()
    if cm_data:
        client.create({"apiVersion": "v1", "kind": "ConfigMap",
                       "metadata": {"name": consts.COMPILE_CACHE_CONFIGMAP,
                                    "namespace": REPLICA_NS},
                       "data": dict(cm_data)})
    return client


def _files(path) -> dict:
    """name -> (bytes, mtime in ns) of every file in ``path``."""
    return {p.name: [p.stat().st_size, p.stat().st_mtime_ns]
            for p in sorted(pathlib.Path(path).iterdir())}


def replica_warm_start(spec_path: str) -> None:
    """Phase 11's child process: one ``ServingWorkerMain`` (flash prefill)
    on the card, its compile cache the directory ``TPU_COMPILE_CACHE_DIR``
    names and the ConfigMap data in ``spec_path``; writes its outcome,
    warm-up seconds, the ConfigMap data after and the directory's files
    before and after back to ``spec_path``. A process of its own, because
    loaded kernel libraries stay loaded in a process."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.dataplane.worker import ServingWorkerMain
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.workloads.serving import ServingModelConfig

    spec = json.loads(pathlib.Path(spec_path).read_text())
    client = _cache_client(spec["cm_data"])
    cache = os.environ[consts.COMPILE_CACHE_DIR_ENV]
    before = _files(cache)
    main = ServingWorkerMain(client, REPLICA_NS, _replica_env(f"{REPLICA_SERVING}-replica-0"),
                             cfg=ServingModelConfig(use_flash_prefill=True))
    cm = client.get_or_none("v1", "ConfigMap", consts.COMPILE_CACHE_CONFIGMAP, REPLICA_NS)
    pathlib.Path(spec_path).write_text(json.dumps({
        "outcome": main.compile_outcome, "warmup_seconds": main.warmup_seconds,
        "build_dir": str(build.build_dir()),
        "flash_fwd_library": str(build.library_path("flash_fwd")),
        "before": before, "after": _files(cache), "cm_data": (cm or {}).get("data") or {},
    }))


def _child_process(entry: str, cache: str, spec: pathlib.Path, payload: dict) -> dict:
    """Run ``chip_smoke.<entry>(spec)`` in a process of its own over the
    compile cache directory ``cache``, ``payload`` in the spec file; returns
    what it wrote back there and the process's seconds."""
    from tpu_operator_torch import consts

    spec.write_text(json.dumps(payload))
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, chip_smoke; chip_smoke.{entry}(sys.argv[1])",
         str(spec)], cwd=pathlib.Path(__file__).resolve().parent, capture_output=True, text=True,
        env=dict(os.environ, **{consts.COMPILE_CACHE_DIR_ENV: cache}), timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{entry} exited {proc.returncode}: {proc.stdout[-2000:]}"
                           f"{proc.stderr[-3000:]}")
    return dict(json.loads(spec.read_text()), process_seconds=time.perf_counter() - start)


def _replica_process(cache: str, cm_data: dict, spec: pathlib.Path) -> dict:
    return _child_process("replica_warm_start", cache, spec, {"cm_data": cm_data})


def _cold_and_warm(tmp: str) -> tuple:
    """(a) a replica over an empty cache directory misses, builds flash_fwd
    there (and no fp16 library: serving computes in f32) and publishes its
    measured warm-up; (b) a second replica over that directory and
    ConfigMap hits and writes no file."""
    from tpu_operator_torch.workloads import compilecache
    from tpu_operator_torch.workloads.matmul_bench import chip_generation
    from tpu_operator_torch.workloads.serving import ServingModelConfig

    cache = os.path.join(tmp, "compile-cache")
    os.makedirs(cache)
    miss = _replica_process(cache, {}, pathlib.Path(tmp, "miss.json"))
    library = pathlib.Path(miss["flash_fwd_library"])
    entry = compilecache.parse_entry(miss["cm_data"].get(compilecache.entry_key(chip_generation())))
    record = compilecache.cache_record(
        entry, REPLICA_TOPOLOGY, compilecache.model_descriptor_hash(
            ServingModelConfig(use_flash_prefill=True)), compilecache.runtime_fingerprint())
    if not (miss["outcome"] == "miss" and miss["before"] == {} and miss["build_dir"] == cache
            and library.parent == pathlib.Path(cache) and library.name in miss["after"]
            and not any("_f16-" in name for name in miss["after"])
            and record is not None
            and record["seconds"] == round(miss["warmup_seconds"], 4)):
        raise RuntimeError(f"replica miss: {miss}, record {record}")
    hit = _replica_process(cache, miss["cm_data"], pathlib.Path(tmp, "hit.json"))
    if not (hit["outcome"] == "hit" and library.name in hit["before"]
            and hit["after"] == hit["before"] and hit["cm_data"] == miss["cm_data"]):
        raise RuntimeError(f"replica hit: {hit}")
    return cache, miss, hit


def _drive(mains: list, requests: list) -> tuple:
    """The router's loop over one aggregated replica, or a prefill and a
    decode replica with the paged-KV hand-off (``prefilled_done`` ->
    ``submit_prefilled``); returns (tokens by request, hand-off bytes, wall
    seconds)."""
    first, last = mains[0], mains[-1]
    handoff = 0
    for r in requests:
        first.submit(r)
    start = time.perf_counter()
    for _ in range(10000):
        for main in mains:
            main.step()
        while len(mains) > 1 and first.engine.prefilled_done:
            entry = first.engine.prefilled_done.pop(0)
            last.submit_prefilled(entry["request"], entry["kv"])
            handoff += entry["kv"]["k"].nbytes + entry["kv"]["v"].nbytes
        if all(m.engine.idle and not m.engine.prefilled_done for m in mains):
            break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return {r.rid: list(r.output) for r in last.engine.completed}, handoff, seconds


def phase_replicas(want_tokens: dict) -> dict:
    """Phase 11: (a)/(b) the cold and the warm replica in processes of
    their own; (c) an aggregated and (d) a prefill + decode replica pair in
    this process over the same cache, each answering phase 5's requests
    with phase 5's greedy tokens, through the general forward only."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.dataplane.worker import ServingWorkerMain
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.workloads.serving import ServingModelConfig, make_requests

    out = {"paths": {}}
    start = time.monotonic()
    cfg = ServingModelConfig(use_flash_prefill=True)
    requests = make_requests(REPLICA_REQUESTS["count"], seed=REPLICA_REQUESTS["seed"],
                             prompt_len=REPLICA_REQUESTS["prompt_len"],
                             decode_max=REPLICA_REQUESTS["decode_max"])
    saved_env = os.environ.get(consts.COMPILE_CACHE_DIR_ENV)
    with tempfile.TemporaryDirectory() as tmp:
        cache, miss, hit = _cold_and_warm(tmp)
        os.environ[consts.COMPILE_CACHE_DIR_ENV] = cache
        try:
            layouts = {"aggregated": [("0", "")],
                       "disaggregated": [("1", consts.SERVING_POOL_PREFILL),
                                         ("2", consts.SERVING_POOL_DECODE)]}
            for layout, replicas in layouts.items():
                client = _cache_client(hit["cm_data"])
                mains = [ServingWorkerMain(client, REPLICA_NS,
                                           _replica_env(f"{REPLICA_SERVING}-replica-{i}", pool),
                                           cfg=cfg) for i, pool in replicas]
                zero_launches()
                tokens, handoff, seconds = _drive(mains, copy.deepcopy(requests))
                counts = read_launches()
                expected = {k: REPLICA_LAUNCHES if k == "flash_fwd_rect" else 0 for k in counts}
                reports = [m.engine.report() for m in mains]
                if not (tokens == want_tokens and counts == expected
                        and all(m.compile_outcome == "hit" for m in mains)
                        and (handoff > 0) == (layout == "disaggregated")):
                    raise RuntimeError(
                        f"replica {layout}: outcomes {[m.compile_outcome for m in mains]}, "
                        f"launches {counts} (expected {expected}), hand-off {handoff} bytes, "
                        f"tokens equal to phase 5's: {tokens == want_tokens}")
                rep = reports[-1]
                decoded = sum(len(t) for t in tokens.values())
                out["paths"][f"replica {layout}"] = counts
                out[layout] = {"reports": reports, "handoff_bytes": handoff,
                               "wall_s": seconds, "wall_tokens_per_s": decoded / seconds,
                               "outcomes": [m.compile_outcome for m in mains],
                               "warmup_seconds": [m.warmup_seconds for m in mains]}
                log(f"replicas: {layout} ({', '.join(m.pool or 'aggregated' for m in mains)}): "
                    f"16 requests, phase 5's tokens, warm starts "
                    f"{[(m.compile_outcome, round(m.warmup_seconds, 4)) for m in mains]}, "
                    f"launches {counts}; {rep['tokens_per_s']} tok/s in decode steps, "
                    f"{decoded / seconds:.2f} tok/s wall, ttft p50 {rep['ttft_p50_s']} s p99 "
                    f"{rep['ttft_p99_s']} s; hand-off {handoff} bytes")
        finally:
            build.bind_build_dir(build.BUILD_DIR)  # the default directory again
            if saved_env is None:
                os.environ.pop(consts.COMPILE_CACHE_DIR_ENV, None)
            else:
                os.environ[consts.COMPILE_CACHE_DIR_ENV] = saved_env
    out["miss"], out["hit"] = miss, hit
    out["seconds"] = time.monotonic() - start
    log(f"replicas: cold replica 'miss' (built {pathlib.Path(miss['flash_fwd_library']).name} "
        f"into an empty cache): warm-up {miss['warmup_seconds']:.4f} s, published "
        f"{miss['warmup_seconds']:.4f}, process {miss['process_seconds']:.1f} s; warm replica "
        f"'hit' (no file written): warm-up {hit['warmup_seconds']:.4f} s, process "
        f"{hit['process_seconds']:.1f} s; phase 11 in {out['seconds']:.1f} s")
    return out


def _spy_block_m(seen: dict) -> dict:
    """Wrap the triangle wrappers as flash_attention calls them, recording
    the tile height each call asks for (its last positional argument; the
    softmax scale comes by keyword); returns the originals to put back."""
    from tpu_operator_torch.workloads import flashattention

    originals = {}
    for name in ("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri"):
        fn = originals[name] = getattr(flashattention, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            seen.setdefault(_name, set()).add(args[-1])
            return _fn(*args, **kwargs)
        setattr(flashattention, name, spy)
    return originals


def _check_sweep_entry(entry: dict, what: str) -> None:
    """Every config of a generation sweep measured without error and within
    PEAK_MARGIN of its family's data-sheet peak, the winner the best stable
    rate; logs each family's configs."""
    from tpu_operator_torch.workloads import matmul_bench

    gen = entry["generation"]
    peaks = {"flash_fwd": PEAK_FLOPS[torch.bfloat16] / 1e12,
             "flash_fwd_bwd": PEAK_FLOPS[torch.bfloat16] / 1e12,
             "matmul": matmul_bench.PEAK_TFLOPS[gen], "int8": matmul_bench.PEAK_INT8_TOPS[gen]}
    for family, classes in entry["results"].items():
        for shape_class, packed in classes.items():
            configs, winner = packed["configs"], packed["winner"]
            bad = [c for c in configs
                   if "error" in c or not 0 < c["rate"] <= PEAK_MARGIN * peaks[family]]
            measured = [c for c in configs if not c.get("pruned")]
            best = max(c["rate"] for c in ([c for c in measured if c["stable"]] or measured))
            if bad or winner is None or winner["rate"] != best:
                raise RuntimeError(f"{what} {family} {shape_class}: configs {configs} "
                                   f"(peak {peaks[family]}), winner {winner}")
            log(f"{what}: {family} {shape_class}: " + "; ".join(
                f"{ {k: v for k, v in c.items() if k in ('block_m', 'unroll')} } "
                f"{c['time_ms']} ms {c['rate']} {'TOP/s' if family == 'int8' else 'TFLOP/s'}"
                f"{' pruned' if c.get('pruned') else '' if c['stable'] else ' unstable'}"
                for c in configs)
                + f"; winner {winner}")


def phase_autotune(device: str = "cuda") -> dict:
    """Phase 12: the generation sweep at the "cuda" profile, every rate held
    to the data sheet, the winners published through TPU_AUTOTUNE_JSON and
    read back by an untuned flash_attention call at the profile's flash
    shape."""
    from tpu_operator_torch.kernels.flash_fwd import attention_plain
    from tpu_operator_torch.workloads import autotune, flashattention, matmul_bench

    gen = matmul_bench.chip_generation()
    seen: dict = {}
    originals = _spy_block_m(seen)
    start = time.monotonic()
    try:
        zero_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        entry = autotune.run_generation_sweep(gen, profile="cuda", device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        counts = read_launches()
        sweep_s = time.monotonic() - start
        tri = ("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri")
        if not (entry["platform"] == device and entry["profile"] == "cuda"
                and all(counts[k] > 0 for k in tri)
                and all(v == 0 for k, v in counts.items() if k not in tri)
                and all(seen.get(k) == {64, 128} for k in tri)):
            raise RuntimeError(f"autotune: platform {entry['platform']}, launches {counts}, "
                               f"heights asked {seen}")
        _check_sweep_entry(entry, "autotune")
        shape = autotune.SWEEP_PROFILES["cuda"]["flash"]
        s, h, d = shape["seq_len"], shape["heads"], shape["head_dim"]
        want_tile = entry["results"]["flash_fwd"][autotune.flash_shape_class(s, h, d)]["winner"]
        want_tile = want_tile["block_m"]
        os.environ[autotune.AUTOTUNE_ENV] = json.dumps(autotune.winners_blob({gen: entry}))
        tile = autotune.tuned_flash_tile(s, h, d)
        gen_q = torch.Generator(device=device).manual_seed(12)
        q, k, v = (torch.randn((1, s, h, d), generator=gen_q, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        seen.clear()
        with torch.no_grad():
            got = flashattention.flash_attention(q, k, v, causal=True)
            qb, kb, vb, h, h_kv = flashattention._collapse_heads(q, k, v)
            want, _ = attention_plain(qb, kb, vb, h, h_kv, causal=True)
        got_err = err(got.transpose(1, 2).reshape(want.shape), want)
        if not (tile == want_tile and seen == {"flash_fwd_tri": {want_tile}}
                and got_err <= BF16_TOL):
            raise RuntimeError(f"autotune: tuned_flash_tile {tile} (winner {want_tile}), heights "
                               f"asked {seen}, tuned call err {got_err} (tol {BF16_TOL})")
    finally:
        os.environ.pop(autotune.AUTOTUNE_ENV, None)  # later flash calls choose by plan again
        from tpu_operator_torch.workloads import flashattention as fa

        for name, fn in originals.items():
            setattr(fa, name, fn)
    out = {"paths": {"autotune sweep": counts}, "entry": entry, "sweep_seconds": sweep_s,
           "sweep_peak_mib": peak_mib if device == "cuda" else None,
           "tuned_tile": tile, "tuned_call_max_abs_err": got_err,
           "seconds": time.monotonic() - start}
    log(f"autotune: run_generation_sweep({gen!r}) in {sweep_s:.1f} s, peak memory "
        f"{out['sweep_peak_mib']} MiB above its start, launches {counts}; "
        f"tuned_flash_tile({s}, {h}, {d}) = {tile}, the untuned flash_attention at (1,{s},{h},{d}) "
        f"bf16 ran it, err {got_err:.3g} from attention_plain; phase 12 in {out['seconds']:.1f} s")
    return out


# phase 13: the node agents, on a node "h100-0" labelled as GPU feature
# discovery labels it, under _DictClient
AGENT_NS, AGENT_NODE = "smoke", "h100-0"
# the exporter's probe_bandwidth: hbm_bandwidth_probe(size_mb=64, iters=25)
EXPORTER_TRIAD_LAUNCHES = PROBES["self-test exporter probe"][1]


def _agent_node(labels: dict) -> dict:
    """Node h100-0: GFD's product (the CUDA device name, spaces as dashes)
    and count labels, the card resource allocatable, and ``labels``."""
    from tpu_operator_torch import consts

    count = str(torch.cuda.device_count())
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": AGENT_NODE, "labels": {
                consts.GFD_PRODUCT_LABEL: torch.cuda.get_device_name(0).replace(" ", "-"),
                consts.GFD_COUNT_LABEL: count, "kubernetes.io/hostname": AGENT_NODE, **labels}},
            "status": {"allocatable": {consts.GPU_RESOURCE_NAME: count}}}


def _autotune_agent(out: dict) -> tuple:
    """(a) the elected node's sweep through the agent, (b) its fold into
    perf floors; returns (client, generation, floors)."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.agents.autotune_agent import AutotuneAgent
    from tpu_operator_torch.workloads import autotune, matmul_bench
    from tpu_operator_torch.workloads import flashattention as fa

    gen = matmul_bench.chip_generation()
    client = _DictClient()
    client.create(_agent_node({consts.AUTOTUNE_ELECTED_LABEL: consts.AUTOTUNE_ELECTED}))
    agent = AutotuneAgent(client, AGENT_NODE, AGENT_NS)
    seen: dict = {}
    originals = _spy_block_m(seen)
    try:
        zero_launches()
        start = time.monotonic()
        outcome = agent.reconcile_once()
        torch.cuda.synchronize()
        sweep_s = time.monotonic() - start
        counts = read_launches()
    finally:
        for name, fn in originals.items():
            setattr(fa, name, fn)
    cm = client.get_or_none("v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP, AGENT_NS)
    entry = autotune.parse_entry(cm["data"].get(autotune.entry_key(gen)))
    tri = ("flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri")
    if not (outcome == "swept" and set(cm["data"]) == {autotune.entry_key(gen)}
            and entry["platform"] == "cuda" and entry["swept_by"] == AGENT_NODE
            and autotune.entry_valid(entry, autotune.runtime_fingerprint())
            and all(counts[k] > 0 for k in tri)
            and all(v == 0 for k, v in counts.items() if k not in tri)
            and all(seen.get(k) == {64, 128} for k in tri)):
        raise RuntimeError(f"autotune agent: outcome {outcome}, keys {sorted(cm['data'])}, "
                           f"platform {entry and entry['platform']}, launches {counts}, "
                           f"heights asked {seen}")
    _check_sweep_entry(entry, "autotune agent")
    writes = client.writes
    again = agent.reconcile_once()
    if again != "cache-hit" or client.writes != writes:
        raise RuntimeError(f"autotune agent: second pass {again}, {client.writes - writes} writes")
    out["paths"]["autotune agent"] = counts
    out["autotune"] = {"outcomes": [outcome, again], "sweep_seconds": sweep_s,
                       "entry_sweep_seconds": entry["sweep_seconds"], "entry": entry}
    log(f"agents: (a) autotune agent on {AGENT_NODE} ({gen}): 'swept' in {sweep_s:.2f} s, "
        f"{autotune.entry_key(gen)} platform cuda, launches {counts}, both heights of the "
        f"triangle kernels; second pass 'cache-hit' with 0 writes")

    start = time.perf_counter()
    floors = autotune.merge_winner_floors({gen: entry})[gen]
    fold_s = time.perf_counter() - start
    roofs = {"matmul_tflops": entry["results"]["matmul"], "int8_tops": entry["results"]["int8"]}
    want = {probe: round(next(iter(classes.values()))["winner"]["rate"] * 0.7, 1)
            for probe, classes in roofs.items()}
    if not (floors == want and all(v > 0 for v in floors.values())):
        raise RuntimeError(f"fold: floors {floors}, want 0.7 x the winners {want}")
    client.create({"apiVersion": "v1", "kind": "ConfigMap",
                   "metadata": {"name": consts.PERF_FLOORS_CONFIGMAP, "namespace": AGENT_NS},
                   "data": {consts.PERF_FLOORS_KEY: json.dumps({gen: floors})}})
    out["floors"], out["fold_ms"] = floors, 1e3 * fold_s
    log(f"agents: (b) merge_winner_floors -> {gen} floors {floors} (0.7 x the sweep's winners) "
        f"in {1e3 * fold_s:.3f} ms, published as {consts.PERF_FLOORS_CONFIGMAP}")
    return client, gen, floors


def _set_floors(client, gen: str, floors: dict) -> None:
    from tpu_operator_torch import consts

    client.patch("v1", "ConfigMap", consts.PERF_FLOORS_CONFIGMAP,
                 {"data": {consts.PERF_FLOORS_KEY: json.dumps({gen: floors})}}, AGENT_NS)


def _exporter(out: dict, client, gen: str, floors: dict) -> None:
    """(c) the exporter on the card, its probes held to the folded floors,
    and the grey-failure drill."""
    import prometheus_client

    from tpu_operator_torch import consts
    from tpu_operator_torch.agents.metrics_exporter_agent import MetricsExporterAgent
    from tpu_operator_torch.perf import floors_for
    from tpu_operator_torch.workloads import matmul_bench

    registry = prometheus_client.CollectorRegistry()
    blob = client.get_or_none("v1", "ConfigMap", consts.PERF_FLOORS_CONFIGMAP,
                              AGENT_NS)["data"][consts.PERF_FLOORS_KEY]
    exp = MetricsExporterAgent(AGENT_NODE, registry=registry, client=client, namespace=AGENT_NS,
                               generation=gen, floors=floors_for(gen, blob), active_probes="on")

    def value(name, **labels):
        return registry.get_sample_value(name, dict(node=AGENT_NODE, **labels))

    def perf_label():
        labels = client.get_or_none("v1", "Node", AGENT_NODE)["metadata"]["labels"]
        return labels.get(consts.TPU_PERF_LABEL)

    exp.collect_device_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    chips, limit, used = (value("tpu_exporter_chips"), value("tpu_exporter_hbm_limit_bytes", chip="0"),
                          value("tpu_exporter_hbm_used_bytes", chip="0"))
    if not (chips == 1 and abs(limit - total) <= 0.01 * total and used > 0):
        raise RuntimeError(f"exporter: chips {chips}, hbm limit {limit} (card {total}), used {used}")

    zero_launches()
    start = time.perf_counter()
    exp.probe_bandwidth()
    torch.cuda.synchronize()
    bandwidth_s = time.perf_counter() - start
    counts = read_launches()
    gbps = value("tpu_exporter_hbm_bandwidth_gbps")
    expected = {k: EXPORTER_TRIAD_LAUNCHES if k == "triad_kernel" else 0 for k in counts}
    if counts != expected or not 0 < gbps <= PEAK_MARGIN * HBM_GBPS[gen]:
        raise RuntimeError(f"exporter probe_bandwidth: launches {counts} (expected {expected}), "
                           f"{gbps} GB/s (data sheet {HBM_GBPS[gen]})")
    out["paths"]["exporter probe"] = counts

    peak = matmul_bench.PEAK_TFLOPS[gen]
    start = time.perf_counter()
    exp.probe_utilization()
    utilization_s = time.perf_counter() - start
    tflops, util = value("tpu_exporter_matmul_tflops"), value("tpu_exporter_mxu_utilization_pct")
    if not (0 < tflops <= PEAK_MARGIN * peak and util is not None
            and math.isclose(util, 100.0 * tflops / peak, rel_tol=1e-9)):
        raise RuntimeError(f"exporter probe_utilization: {tflops} TFLOP/s (peak {peak}), "
                           f"utilization {util}%")
    exp.probe_ici()
    ici = value("tpu_exporter_ici_bandwidth_gbps")
    label_at_floor = perf_label()
    if ici is not None or label_at_floor is not None:
        raise RuntimeError(f"exporter: ici series {ici} on one card, perf label {label_at_floor} "
                           f"at the folded floor {floors}")
    out["exporter"] = {"chips": chips, "hbm_limit_bytes": limit, "hbm_used_bytes": used,
                       "card_total_memory": total, "hbm_bandwidth_gbps": gbps,
                       "bandwidth_probe_s": bandwidth_s, "matmul_tflops": tflops,
                       "utilization_pct": util, "utilization_probe_s": utilization_s}
    log(f"agents: (c) exporter: {chips:.0f} card, hbm limit {limit:.0f} B (card {total}), used "
        f"{used:.0f} B device-wide; probe_bandwidth {gbps:.1f} GB/s "
        f"({100 * gbps / HBM_GBPS[gen]:.1f}% of {HBM_GBPS[gen]}) in {bandwidth_s:.2f} s, "
        f"launches {counts}; probe_utilization {tflops:.1f} TFLOP/s = {util:.2f}% of {peak} in "
        f"{utilization_s:.2f} s; probe_ici: no series on one card; perf label unset at the "
        f"folded floor")

    # the grey-failure drill: a floor no card reaches, then the folded one
    _set_floors(client, gen, dict(floors, matmul_tflops=2 * peak))
    reloaded = exp.refresh_floors()
    labels_seen = []
    for _ in range(consts.PERF_BREACH_SAMPLES):
        labels_seen.append(perf_label())
        exp.probe_utilization()
    degraded = value("tpu_exporter_perf_degraded", probe="matmul_tflops")
    label = perf_label()
    _set_floors(client, gen, floors)
    restored = exp.refresh_floors()
    exp.probe_utilization()
    cleared = (perf_label(), value("tpu_exporter_perf_degraded", probe="matmul_tflops"))
    # the counter's series exists from its first failure on: absent is 0
    errors = value("tpu_exporter_collect_errors_total") or 0.0
    if not (reloaded and restored and labels_seen == [None] * consts.PERF_BREACH_SAMPLES
            and degraded == 1 and label == consts.PERF_DEGRADED and cleared == (None, 0)
            and errors == 0):
        raise RuntimeError(f"exporter drill: reloads {reloaded}/{restored}, labels before the "
                           f"breach {labels_seen}, degraded {degraded}, label {label}, after the "
                           f"floor came back {cleared}, collect errors {errors}")
    text = prometheus_client.generate_latest(registry).decode()
    out["exporter"].update({"breach_label": label, "cleared": list(cleared),
                            "collect_errors": errors, "exposition": text})
    log(f"agents: (c) grey failure: floor {2 * peak} TFLOP/s hot-reloaded, after "
        f"{consts.PERF_BREACH_SAMPLES} samples perf_degraded 1 and {consts.TPU_PERF_LABEL}="
        f"{label} on {AGENT_NODE}; the folded floor back: label cleared on the next sample; "
        f"collect errors {errors:.0f}")
    log(f"agents: exposition {json.dumps(text)}")


def _health(out: dict) -> None:
    """(d) one health pass over the real /dev, the marker and the socket
    files in a temporary directory, the matmul burst on the card."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.agents.health_monitor_agent import PLUGIN_SOCKET_NAME, HealthMonitorAgent

    client = _DictClient()
    client.create(_agent_node({}))
    with tempfile.TemporaryDirectory() as tmp:
        install, sockets = pathlib.Path(tmp, "install"), pathlib.Path(tmp, "sockets")
        install.mkdir()
        sockets.mkdir()
        (install / consts.LIBTPU_CTR_READY_FILE).touch()
        (sockets / PLUGIN_SOCKET_NAME).touch()
        agent = HealthMonitorAgent(client, AGENT_NODE, install_dir=str(install),
                                   socket_dir=str(sockets), health_dir=str(pathlib.Path(tmp, "h")),
                                   active_probes="on", expected_chips=torch.cuda.device_count())
        matmul = agent.probe_matmul()
        start = time.perf_counter()
        changed = agent.apply_once()
        apply_s = time.perf_counter() - start
        verdicts = json.loads(pathlib.Path(tmp, "h", consts.HEALTH_VERDICTS_FILE).read_text())
    node = client.get_or_none("v1", "Node", AGENT_NODE)
    md = node["metadata"]
    cond = [c for c in node["status"].get("conditions", [])
            if c["type"] == consts.TPU_HEALTH_CONDITION]
    chips = json.loads(md["annotations"][consts.TPU_HEALTH_CHIPS_ANNOTATION])
    if not (matmul is True and changed and md["labels"][consts.TPU_HEALTH_LABEL]
            == consts.HEALTH_HEALTHY and verdicts["verdict"] == consts.HEALTH_HEALTHY
            and chips == verdicts["chips"] and len(chips) == torch.cuda.device_count()
            and set(chips.values()) == {"Healthy"} and len(cond) == 1
            and cond[0]["status"] == "True" and consts.TPU_HEALTH_SINCE_ANNOTATION in md["annotations"]):
        raise RuntimeError(f"health: matmul {matmul}, changed {changed}, node {md}, "
                           f"conditions {cond}, verdicts {verdicts}")
    out["health"] = {"verdicts": verdicts, "apply_s": apply_s, "probe_matmul": matmul}
    log(f"agents: (d) health monitor: apply_once {apply_s:.3f} s -> {verdicts['verdict']}, "
        f"cards {chips} (expected {torch.cuda.device_count()}), probe_matmul {matmul}, verdicts "
        f"file, label, annotations and condition {cond[0]['status']} on {AGENT_NODE}")


def agent_prewarm(spec_path: str) -> None:
    """Phase 13's child process: one compile-cache agent pass (``mode``
    "agent") or one default-config ServingWorkerMain (``mode`` "replica") on
    the card, over the ConfigMap data in ``spec_path`` and the directory
    ``TPU_COMPILE_CACHE_DIR`` names; writes its outcome back there."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.agents import compilecache_agent
    from tpu_operator_torch.dataplane.worker import ServingWorkerMain

    spec = json.loads(pathlib.Path(spec_path).read_text())
    client = _cache_client(spec["cm_data"])
    client.create(_agent_node({consts.COMPILE_CACHE_ELECTED_LABEL: consts.COMPILE_CACHE_ELECTED}))
    writes = client.writes
    cache = os.environ[consts.COMPILE_CACHE_DIR_ENV]
    before = _files(cache)
    warmed = []
    if spec["mode"] == "agent":
        def warm_fn(request, version):
            warmed.append(compilecache_agent.default_warm_fn(request, version))
            return warmed[-1]

        outcome = compilecache_agent.CompileCacheAgent(
            client, AGENT_NODE, REPLICA_NS, warm_fn=warm_fn).reconcile_once()
    else:
        main = ServingWorkerMain(client, REPLICA_NS, _replica_env(f"{REPLICA_SERVING}-replica-9"))
        outcome, warmed = main.compile_outcome, [main.warmup_seconds]
    cm = client.get_or_none("v1", "ConfigMap", consts.COMPILE_CACHE_CONFIGMAP, REPLICA_NS)
    pathlib.Path(spec_path).write_text(json.dumps({
        "outcome": outcome, "warmup_seconds": warmed, "writes": client.writes - writes,
        "before": before, "after": _files(cache), "cm_data": (cm or {}).get("data") or {}}))


def _compile_cache_agent(out: dict, gen: str) -> None:
    """(e) the prewarm handshake in fresh processes over one empty cache
    directory: the agent prewarms, a second agent hits with no write, and
    a default-config replica resolves the record."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.workloads import compilecache

    model = compilecache.model_descriptor_hash()
    rid = compilecache.request_id(gen, REPLICA_TOPOLOGY, model)
    requests = {consts.COMPILE_PREWARM_REQUEST_KEY: json.dumps({"requests": {rid: {
        "generation": gen, "topology": REPLICA_TOPOLOGY, "model": model,
        "serving": REPLICA_SERVING}}})}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "compile-cache")
        os.makedirs(cache)
        first = _child_process("agent_prewarm", cache, pathlib.Path(tmp, "a.json"),
                               {"mode": "agent", "cm_data": requests})
        data = first["cm_data"]
        record = compilecache.cache_record(
            compilecache.parse_entry(data.get(compilecache.entry_key(gen))), REPLICA_TOPOLOGY,
            model, compilecache.runtime_fingerprint())
        acks = json.loads(data.get(consts.COMPILE_PREWARM_ACK_KEY, "{}")).get("acks", {})
        warmed = first["warmup_seconds"]
        if not (first["outcome"] == "prewarmed" and len(warmed) == 1 and record is not None
                and record["seconds"] == round(warmed[0], 4) and record["source"] == "prewarm"
                and acks.get(rid, {}).get("outcome") == "prewarmed"):
            raise RuntimeError(f"compile-cache agent: {first}, record {record}, acks {acks}")
        second = _child_process("agent_prewarm", cache, pathlib.Path(tmp, "b.json"),
                                {"mode": "agent", "cm_data": data})
        if not (second["outcome"] == "cache-hit" and second["writes"] == 0
                and second["cm_data"] == data):
            raise RuntimeError(f"compile-cache agent rerun: {second}")
        replica = _child_process("agent_prewarm", cache, pathlib.Path(tmp, "c.json"),
                                 {"mode": "replica", "cm_data": data})
        if replica["outcome"] != "hit" or replica["after"] != replica["before"]:
            raise RuntimeError(f"default-config replica over the prewarmed record: {replica}")
    out["compile_cache"] = {"prewarm": first, "rerun": second, "replica": replica,
                            "record": record}
    log(f"agents: (e) compile-cache agent (fresh processes, empty cache): 'prewarmed' "
        f"({gen}, {REPLICA_TOPOLOGY}, {model[:12]}...) warm-up {warmed[0]:.4f} s, record "
        f"{record['seconds']} s, acked, cache files {sorted(first['after'])}, process "
        f"{first['process_seconds']:.1f} s; rerun 'cache-hit' with 0 writes "
        f"({second['process_seconds']:.1f} s); default-config replica '{replica['outcome']}', "
        f"warm-up {replica['warmup_seconds'][0]:.4f} s ({replica['process_seconds']:.1f} s)")


class _Kubelet(threading.Thread):
    """Runs the workload pod's container once it exists in ``client``: its
    command and env exactly, in a process of its own; the pod's phase then
    follows the exit code."""

    def __init__(self, client, name: str):
        super().__init__(daemon=True)
        self.client, self.name = client, name
        self.proc = None
        self.error = None
        self.done = threading.Event()

    def run(self):
        try:
            while not self.done.is_set():
                pod = self.client.get_or_none("v1", "Pod", self.name, AGENT_NS)
                if pod is not None:
                    break
                time.sleep(0.05)
            else:
                return
            container = pod["spec"]["containers"][0]
            env = dict(os.environ, **{e["name"]: e["value"] for e in container["env"]})
            self.proc = subprocess.run(container["command"], env=env, capture_output=True,
                                       text=True, timeout=300,
                                       cwd=pathlib.Path(__file__).resolve().parent)
            phase = "Succeeded" if self.proc.returncode == 0 else "Failed"
            self.client.patch("v1", "Pod", self.name, {"status": {"phase": phase}}, AGENT_NS)
        except Exception as e:  # noqa: BLE001 — reported by the phase
            self.error = e


def _validator(out: dict) -> None:
    """(f) the plugin and workload components under _DictClient, the pod's
    container run by a kubelet thread."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.validator import main as vmain
    from tpu_operator_torch.validator import status as status_files

    client = _DictClient()
    client.create(_agent_node({}))
    with tempfile.TemporaryDirectory() as tmp:
        ctx = vmain.Context(client=client, node_name=AGENT_NODE, namespace=AGENT_NS,
                            validation_dir=tmp, retry_interval=0.25, resource_poll_retries=4,
                            pod_wait_retries=1200)
        start = time.perf_counter()
        plugin = vmain.run_component("plugin", ctx, max_attempts=1)
        plugin_s = time.perf_counter() - start
        plugin_ready = status_files.read_status(consts.PLUGIN_READY_FILE, tmp)
        pod = vmain.workload_pod(ctx)
        kubelet = _Kubelet(client, pod["metadata"]["name"])
        kubelet.start()
        start = time.perf_counter()
        try:
            workload = vmain.run_component("workload", ctx, max_attempts=1)
        finally:
            kubelet.done.set()
            kubelet.join(330)
        workload_s = time.perf_counter() - start
        workload_ready = status_files.read_status(consts.WORKLOAD_READY_FILE, tmp)
    proc = kubelet.proc
    lines = proc.stdout.strip().splitlines() if proc else []
    report = json.loads(lines[-1]) if lines else {}
    left = client.get_or_none("v1", "Pod", pod["metadata"]["name"], AGENT_NS)
    container = pod["spec"]["containers"][0]
    if not (plugin == {"resource": consts.GPU_RESOURCE_NAME, "chips": torch.cuda.device_count()}
            and plugin_ready == plugin and kubelet.error is None and proc.returncode == 0
            and report.get("ok") is True and workload["phase"] == "Succeeded"
            and workload_ready == workload and left is None
            and container["resources"]["limits"] == {consts.GPU_RESOURCE_NAME: "1"}):
        raise RuntimeError(f"validator: plugin {plugin} ({plugin_ready}), kubelet error "
                           f"{kubelet.error}, container exit {proc and proc.returncode} "
                           f"{proc and proc.stderr[-2000:]}, report {report}, workload "
                           f"{workload} ({workload_ready}), pod left {left}")
    out["validator"] = {"plugin": plugin, "plugin_s": plugin_s, "workload": workload,
                        "workload_s": workload_s, "smoke_report": report,
                        "command": container["command"]}
    log(f"agents: (f) validator: plugin {plugin} in {plugin_s:.3f} s, plugin-ready written; "
        f"workload pod {container['command']} under {container['resources']['limits']} exited 0: "
        f"{lines[-1]}; validate_workload {workload['phase']} in {workload_s:.1f} s, "
        f"workload-ready written, pod deleted")


def phase_agents() -> dict:
    """Phase 13: the node agents on the card (see the module docstring)."""
    out = {"paths": {}}
    start = time.monotonic()
    client, gen, floors = _autotune_agent(out)
    _exporter(out, client, gen, floors)
    _health(out)
    _compile_cache_agent(out, gen)
    _validator(out)
    out["seconds"] = time.monotonic() - start
    log(f"agents: phase 13 in {out['seconds']:.1f} s")
    return out


# -- phase 14: the node's device layer ----------------------------------------


def allocated_child() -> None:
    """Phase 14's child: the container the device plugin's ``Allocate``
    describes, run under exactly its env. Prints its card count, its card's
    UUID, the driver library it loaded and ``run_smoke``'s report."""
    from tpu_operator_torch.workloads.smoke import run_smoke

    report = run_smoke()
    with open("/proc/self/maps") as maps:
        loaded = sorted({line.split()[-1] for line in maps if "libcuda.so" in line})
    print(json.dumps({"count": torch.cuda.device_count(),
                      "uuid": f"GPU-{torch.cuda.get_device_properties(0).uuid}",
                      "libcuda": loaded, "smoke": report}), flush=True)


class _KubeletStandIn:
    """The kubelet's half of the device plugin API: the Registration service
    on ``kubelet.sock`` in ``socket_dir``; on ``Register`` it dials the
    plugin's endpoint and follows its ``ListAndWatch`` stream, writing the
    node's capacity (every device) and allocatable (the Healthy ones) from
    each response, as the kubelet does."""

    def __init__(self, client, socket_dir: str):
        from concurrent import futures

        import grpc

        from tpu_operator_torch.agents.dpapi import deviceplugin_pb2 as pb

        self.grpc, self.pb = grpc, pb
        self.client, self.socket_dir = client, socket_dir
        self.socket = os.path.join(socket_dir, "kubelet.sock")
        self.requests, self.responses = [], []  # responses: (perf_counter, [(id, health)])
        self.changed = threading.Condition()
        self.channel = self.watch = None
        self.pool = futures.ThreadPoolExecutor(max_workers=2)
        self.server = grpc.server(thread_pool=self.pool)
        self.server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "v1beta1.Registration", {"Register": grpc.unary_unary_rpc_method_handler(
                self._register, request_deserializer=pb.RegisterRequest.FromString,
                response_serializer=lambda m: m.SerializeToString())}),))
        self.server.add_insecure_port(f"unix://{self.socket}")
        self.server.start()

    def _register(self, request, context):
        self.requests.append(request)
        self.channel = self.grpc.insecure_channel(
            f"unix://{os.path.join(self.socket_dir, request.endpoint)}")
        stream = self.channel.unary_stream(
            "/v1beta1.DevicePlugin/ListAndWatch",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=self.pb.ListAndWatchResponse.FromString)(self.pb.Empty())
        self.watch = threading.Thread(target=self._follow, args=(stream, request.resource_name),
                                      daemon=True)
        self.watch.start()
        return self.pb.Empty()

    def _follow(self, stream, resource: str) -> None:
        try:
            for response in stream:
                devices = [(d.ID, d.health) for d in response.devices]
                healthy = sum(health == "Healthy" for _, health in devices)
                self.client.patch("v1", "Node", AGENT_NODE, {"status": {
                    "capacity": {resource: str(len(devices))},
                    "allocatable": {resource: str(healthy)}}})
                with self.changed:
                    self.responses.append((time.perf_counter(), devices))
                    self.changed.notify_all()
        except self.grpc.RpcError:
            pass  # the stream ends when the plugin stops

    def wait_for(self, count: int, timeout: float = 15.0) -> list:
        """The ``count``-th ListAndWatch response's devices."""
        with self.changed:
            if not self.changed.wait_for(lambda: len(self.responses) >= count, timeout):
                raise RuntimeError(f"kubelet stand-in: {len(self.responses)} ListAndWatch "
                                   f"responses after {timeout} s, waited for {count}")
            return self.responses[count - 1][1]

    def allocate(self, ids: list):
        call = self.channel.unary_unary(
            "/v1beta1.DevicePlugin/Allocate", request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=self.pb.AllocateResponse.FromString)
        return call(self.pb.AllocateRequest(container_requests=[
            self.pb.ContainerAllocateRequest(devicesIDs=ids)]), timeout=30)

    def stop(self) -> None:
        if self.channel is not None:
            self.channel.close()
        self.server.stop(0).wait(5)
        self.pool.shutdown(wait=False)
        if self.watch is not None:
            self.watch.join(5)


def _card_probe(out: dict) -> dict:
    """(a) the native probe against the card's own view."""
    from tpu_operator_torch.native import gpuinfo

    start = time.perf_counter()
    inventory = gpuinfo.probe()
    probe_ms = 1e3 * (time.perf_counter() - start)
    dev, driver = gpuinfo.scan_dirs()
    native, plain = gpuinfo.native_scan(dev, driver), gpuinfo.python_scan(dev, driver)
    count = torch.cuda.device_count()
    uuids = {f"GPU-{torch.cuda.get_device_properties(i).uuid}" for i in range(count)}
    models = {torch.cuda.get_device_name(i) for i in range(count)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.split()
    cards = inventory["cards"]
    if not (inventory["source"] == "native" and native == plain
            and inventory["chip_count"] == len(cards) == count
            and {c["uuid"] for c in cards} == uuids and {c["model"] for c in cards} == models
            and set(smi) == {inventory["driver_version"]}):
        raise RuntimeError(f"card probe: {inventory}; native scan {native}, python scan {plain}; "
                           f"torch {count} card(s) {uuids} {models}; nvidia-smi driver {smi}")
    out["probe"] = {"inventory": inventory, "probe_ms": probe_ms, "scan": native}
    log(f"device layer: (a) card probe (native, {gpuinfo.library_path().name}) in "
        f"{probe_ms:.3f} ms: {count} card(s) {[(c['device'], c['model'], c['uuid'], c['bus_id'], c['memory_mib']) for c in cards]}, "
        f"refused {inventory['refused']}, driver {inventory['driver_version']} (nvidia-smi "
        f"{smi[0]}); UUIDs and models equal torch's; the Python scan equals the native one "
        f"({native})")
    return inventory


def _driver(out: dict, tmp: str, client, inventory: dict) -> tuple:
    """(b) the installer into a temporary install dir, (c) the driver check
    and its negative case."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.agents import driver_installer
    from tpu_operator_torch.validator import main as vmain
    from tpu_operator_torch.validator import status as status_files

    install = os.path.join(tmp, "install")
    source = driver_installer.find_driver_library()
    version = driver_installer.driver_version()
    start = time.perf_counter()
    first = driver_installer.install(source, install, version)
    install_s = time.perf_counter() - start
    start = time.perf_counter()
    again = driver_installer.install(source, install, version)
    rerun_s = time.perf_counter() - start
    link = os.path.join(install, consts.DRIVER_LIBRARY)
    with open(os.path.join(install, "version")) as f:
        version_file = f.read().strip()
    if not (first["changed"] and not again["changed"] and version == inventory["driver_version"]
            and os.readlink(link) == f"{consts.DRIVER_LIBRARY}-{version}"
            and version_file == version
            and os.path.exists(os.path.join(install, consts.LIBTPU_CTR_READY_FILE))):
        raise RuntimeError(f"driver installer: {first}, rerun {again}, link {os.readlink(link)}, "
                           f"version file {version_file!r}, probed {inventory['driver_version']}")
    out["installer"] = {"source": source, "report": first, "rerun": again,
                        "install_s": install_s, "rerun_s": rerun_s,
                        "bytes": os.path.getsize(source)}
    log(f"device layer: (b) driver installer: {source} ({os.path.getsize(source)} B) -> "
        f"{link} -> {os.readlink(link)} in {install_s:.3f} s, version file {version_file}, "
        f"marker written; rerun changed {again['changed']} in {rerun_s:.3f} s")

    validation = os.path.join(tmp, "validations")
    ctx = vmain.Context(client=client, node_name=AGENT_NODE, namespace=AGENT_NS,
                        validation_dir=validation, install_dir=install, retry_interval=0.25,
                        resource_poll_retries=40)
    start = time.perf_counter()
    payload = vmain.run_component("driver", ctx, max_attempts=1)
    check_s = time.perf_counter() - start
    ready = status_files.read_status(consts.DRIVER_READY_FILE, validation)
    marker = os.path.join(install, consts.LIBTPU_CTR_READY_FILE)
    os.rename(marker, marker + ".away")
    try:
        vmain.run_component("driver", ctx, max_attempts=1)
        negative = "passed"
    except RuntimeError as e:
        negative = str(e)
        cleared = status_files.read_status(consts.DRIVER_READY_FILE, validation)
    finally:
        os.rename(marker + ".away", marker)
    restored = vmain.run_component("driver", ctx, max_attempts=1)
    if not (payload["cards"] == inventory["chip_count"] == torch.cuda.device_count()
            and payload["driver_version"] == version and ready == payload
            and "marker missing" in negative and cleared is None and restored == payload
            and status_files.read_status(consts.DRIVER_READY_FILE, validation) == payload):
        raise RuntimeError(f"driver check: {payload} (ready file {ready}); without the marker: "
                           f"{negative}, ready file then {cleared}; the marker back: {restored}")
    out["driver_check"] = {"payload": payload, "seconds": check_s, "without_marker": negative}
    log(f"device layer: (c) driver check: the installed library answered {payload['cards']} "
        f"card(s) = the probe's, in {check_s:.3f} s, driver-ready written; without the marker: "
        f"'{negative}', driver-ready cleared; the marker back, it passes again")
    return install, ctx


def _discovery(out: dict, client) -> None:
    """(d) discovery then feature discovery on an unlabelled node."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.agents.node_discovery_agent import NodeDiscoveryAgent
    from tpu_operator_torch.agents.tfd_agent import TFDAgent
    from tpu_operator_torch.nodeinfo import expected_cards, is_gpu_node, node_generation
    from tpu_operator_torch.workloads import matmul_bench

    changed = [NodeDiscoveryAgent(client, AGENT_NODE).apply_once(),
               TFDAgent(client, AGENT_NODE).apply_once()]
    node = client.get_or_none("v1", "Node", AGENT_NODE)
    labels = node["metadata"]["labels"]
    count = torch.cuda.device_count()
    again = [NodeDiscoveryAgent(client, AGENT_NODE).apply_once(),
             TFDAgent(client, AGENT_NODE).apply_once()]
    if not (changed == [True, True] and again == [False, False] and is_gpu_node(node)
            and labels[consts.NFD_PRESENT_LABEL] == "true"
            and labels[consts.GFD_COUNT_LABEL] == str(count)
            and labels[consts.GFD_PRODUCT_LABEL] == torch.cuda.get_device_name(0).replace(" ", "-")
            and node_generation(node) == matmul_bench.chip_generation() == "h100-sxm"
            and expected_cards(node) == count):
        raise RuntimeError(f"discovery: passes {changed} then {again}, labels {labels}, "
                           f"generation {node_generation(node)!r}")
    out["discovery"] = {"labels": labels}
    log(f"device layer: (d) discovery and feature discovery on an unlabelled {AGENT_NODE}: "
        f"{labels}; node_generation {node_generation(node)}, expected_cards "
        f"{expected_cards(node)}; a second pass changes nothing")


def _device_plugin(out: dict, tmp: str, client, install: str, ctx, inventory: dict) -> None:
    """(e) the device plugin through the kubelet stand-in, its health
    updates, an allocated card's child process, and the health monitor over
    the plugin's socket and the installer's dir."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.agents.device_plugin_agent import GPUDevicePlugin
    from tpu_operator_torch.agents.health_monitor_agent import HealthMonitorAgent
    from tpu_operator_torch.validator import main as vmain
    from tpu_operator_torch.validator import status as status_files

    sockets, health = os.path.join(tmp, "dp"), os.path.join(tmp, "health")
    os.makedirs(sockets)
    if len(os.path.join(sockets, consts.PLUGIN_SOCKET_NAME)) > 100:
        raise RuntimeError(f"socket directory {sockets} too long for a unix socket")
    count = torch.cuda.device_count()
    ids = [os.path.basename(c["device"]) for c in inventory["cards"]]
    uuid = {os.path.basename(c["device"]): c["uuid"] for c in inventory["cards"]}
    plugin = GPUDevicePlugin(socket_dir=sockets, install_dir=install, health_dir=health)
    kubelet = _KubeletStandIn(client, sockets)

    def allocatable():
        node = client.get_or_none("v1", "Node", AGENT_NODE)
        return node["status"]["allocatable"][consts.GPU_RESOURCE_NAME]

    try:
        plugin._last_health = plugin.current_health()  # as run_forever starts
        plugin.serve()
        start = time.perf_counter()
        plugin.register(kubelet.socket)
        first = kubelet.wait_for(1)
        register_ms = 1e3 * (kubelet.responses[0][0] - start)
        after_first = allocatable()
        plugin_payload = vmain.run_component("plugin", ctx, max_attempts=1)
        plugin_ready = status_files.read_status(consts.PLUGIN_READY_FILE, ctx.validation_dir)

        os.makedirs(health, exist_ok=True)
        verdicts = os.path.join(health, consts.HEALTH_VERDICTS_FILE)
        with open(verdicts, "w") as f:
            json.dump({"verdict": consts.HEALTH_DEGRADED,
                       "chips": {i: "Unhealthy" for i in ids}, "reasons": ["drill"]}, f)
        marked = plugin.health_tick()
        unhealthy = kubelet.wait_for(2)
        while_unhealthy = allocatable()
        os.remove(verdicts)
        cleared = plugin.health_tick()
        healthy = kubelet.wait_for(3)
        after_clear = allocatable()

        response = kubelet.allocate(ids[:1]).container_responses[0]
        start = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.allocated_child()"],
            cwd=pathlib.Path(__file__).resolve().parent, env=dict(os.environ, **dict(response.envs)),
            capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - start
        monitor = HealthMonitorAgent(client, AGENT_NODE, install_dir=install, socket_dir=sockets,
                                     health_dir=os.path.join(tmp, "monitor"), active_probes="on")
        verdict = monitor.probe(client.get_or_none("v1", "Node", AGENT_NODE))
    finally:
        plugin.stop()
        kubelet.stop()
    request = kubelet.requests[0]
    lines = child.stdout.strip().splitlines()
    report = json.loads(lines[-1]) if child.returncode == 0 and lines else {}
    paths = [d.host_path for d in response.devices]
    if not (request.resource_name == consts.GPU_RESOURCE_NAME
            and request.endpoint == consts.PLUGIN_SOCKET_NAME and len(kubelet.requests) == 1
            and first == [(i, "Healthy") for i in ids] and len(first) == count
            and after_first == str(count)
            and plugin_payload == {"resource": consts.GPU_RESOURCE_NAME, "chips": count}
            and plugin_ready == plugin_payload
            and marked and unhealthy == [(i, "Unhealthy") for i in ids] and while_unhealthy == "0"
            and cleared and healthy == first and after_clear == str(count)):
        raise RuntimeError(f"device plugin: register {request}, ListAndWatch {kubelet.responses}, "
                           f"allocatable {after_first}/{while_unhealthy}/{after_clear}, plugin "
                           f"component {plugin_payload} ({plugin_ready}), ticks {marked}/{cleared}")
    if not (dict(response.envs) == {"CUDA_VISIBLE_DEVICES": uuid[ids[0]],
                                    "NVIDIA_VISIBLE_DEVICES": uuid[ids[0]],
                                    "LD_LIBRARY_PATH": install}
            and paths == [f"/dev/{ids[0]}", "/dev/nvidiactl", "/dev/nvidia-uvm"]
            and all(os.path.exists(p) for p in paths)
            and [(m.host_path, m.read_only) for m in response.mounts] == [(install, True)]
            and child.returncode == 0 and report.get("count") == 1
            and report.get("uuid") == uuid[ids[0]] and report["smoke"].get("ok") is True
            and report["libcuda"] and all(p.startswith(os.path.realpath(install))
                                          for p in report["libcuda"])):
        raise RuntimeError(f"Allocate: {response}; child exit {child.returncode}: "
                           f"{child.stdout[-2000:]} {child.stderr[-3000:]}")

    if not (verdict["verdict"] == consts.HEALTH_HEALTHY and verdict["reasons"] == []
            and verdict["chips"] == {i: "Healthy" for i in ids}):
        raise RuntimeError(f"health monitor over the plugin's socket and the installer's dir: "
                           f"{verdict}")
    out["device_plugin"] = {"register_to_first_list_ms": register_ms, "child_s": child_s,
                            "child": report, "envs": dict(response.envs), "devices": paths,
                            "list_and_watch": [d for _, d in kubelet.responses],
                            "health_monitor": verdict}
    log(f"device layer: (e) device plugin: registered {request.resource_name} at "
        f"{request.endpoint}; register -> first ListAndWatch {register_ms:.3f} ms: {first}, "
        f"allocatable {after_first}; the plugin component wrote plugin-ready ({plugin_payload}); "
        f"verdicts Unhealthy -> {unhealthy} (allocatable {while_unhealthy}), cleared -> "
        f"{healthy} (allocatable {after_clear})")
    log(f"device layer: (e) Allocate {ids[:1]} -> devices {paths}, envs {dict(response.envs)}, "
        f"install dir read-only; the child under that env in {child_s:.2f} s saw "
        f"{report['count']} card {report['uuid']}, loaded {report['libcuda']}, run_smoke ok; "
        f"the health monitor over the plugin's socket and the installer's dir: "
        f"{verdict['verdict']}, reasons {verdict['reasons']}")


def _node_metrics(out: dict, ctx) -> None:
    """(f) the exporter over (c)'s and (e)'s status files, the probe's
    count and the driver revalidation, then a failed revalidation."""
    import prometheus_client

    from tpu_operator_torch import consts
    from tpu_operator_torch.validator import status as status_files
    from tpu_operator_torch.validator.metrics import NodeMetrics

    metrics = NodeMetrics(ctx)
    start = time.perf_counter()
    metrics.collect_status_files()
    metrics.collect_device_count()
    metrics.revalidate_driver()
    pass_s = time.perf_counter() - start
    node = {"node": AGENT_NODE}

    def value(name, **labels):
        return metrics.registry.get_sample_value(name, dict(node, **labels))

    text = prometheus_client.generate_latest(metrics.registry).decode()
    samples = [line for line in text.splitlines() if line and not line.startswith("#")]
    ready = {c: value("tpu_operator_node_component_ready", component=c)
             for c in (consts.DRIVER_READY_FILE, consts.PLUGIN_READY_FILE)}
    counted = (value("tpu_operator_node_gpus"),
               value("tpu_operator_node_driver_revalidations_total", result="success"))
    marker = os.path.join(ctx.install_dir, consts.LIBTPU_CTR_READY_FILE)
    os.rename(marker, marker + ".away")
    try:
        metrics.revalidate_driver()
    finally:
        os.rename(marker + ".away", marker)
    failed = (value("tpu_operator_node_driver_revalidations_total", result="failure"),
              status_files.read_status(consts.DRIVER_READY_FILE, ctx.validation_dir))
    if not (ready == {consts.DRIVER_READY_FILE: 1, consts.PLUGIN_READY_FILE: 1}
            and counted == (torch.cuda.device_count(), 1) and failed == (1, None)):
        raise RuntimeError(f"node metrics: ready {ready}, cards and revalidations {counted}, "
                           f"after a failed revalidation {failed}")
    out["node_metrics"] = {"series": len(samples), "pass_s": pass_s, "exposition": text}
    log(f"device layer: (f) node metrics: {len(samples)} series in one pass of {pass_s:.3f} s; "
        f"ready {ready}, tpu_operator_node_gpus {counted[0]:.0f}, driver revalidations "
        f"{counted[1]:.0f}; without the marker the next revalidation counts a failure and "
        f"clears driver-ready")
    log(f"device layer: exposition {json.dumps(text)}")


def phase_device_layer() -> dict:
    """Phase 14: the node's device layer on the card (see the module docstring)."""
    out = {}
    start = time.monotonic()
    zero_launches()
    client = _DictClient()
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": AGENT_NODE, "labels": {"kubernetes.io/hostname": AGENT_NODE}}, "status": {}})
    inventory = _card_probe(out)
    with tempfile.TemporaryDirectory(prefix="dl-") as tmp:
        install, ctx = _driver(out, tmp, client, inventory)
        _discovery(out, client)
        _device_plugin(out, tmp, client, install, ctx, inventory)
        _node_metrics(out, ctx)
    out["launches"] = read_launches()
    out["seconds"] = time.monotonic() - start
    log(f"device layer: phase 14 in {out['seconds']:.1f} s (kernel launches in this process "
        f"{out['launches']})")
    return out


# -- phase 15: every head dim the reference's flash attention takes -----------

# Gemma-2B's widths (huggingface.co/google/gemma-2b config.json: hidden 2048,
# 8 heads, 1 KV head, head dim 256, intermediate 16384, 8192 context) as a
# TPUJob's spec.workload.config, the burn-in's own block, depth cut 18 -> 1,
# for the run's time
GEMMA_2B = {"d_model": 2048, "n_heads": 8, "kv_heads": 1, "d_ff": 16384, "seq_len": 8192,
            "batch": 1, "n_layers": 1, "use_flash_attention": True}
# Phi-3-mini's (huggingface.co/microsoft/Phi-3-mini-4k-instruct config.json:
# hidden 3072, 32 heads, head dim 96, intermediate 8192, 4096 context), depth
# cut 32 -> 1: the zero-padded route (96 -> 128)
PHI3_MINI = {"d_model": 3072, "n_heads": 32, "d_ff": 8192, "seq_len": 4096, "batch": 1,
             "n_layers": 1, "use_flash_attention": True}
# the elastic trainer at Gemma-2B's widths: a checkpoint every 3 steps, a
# fault at 5 (step 4 is lost and run again)
HEAD_DIM_TRAINER_RUN = {"total_steps": 6, "checkpoint_every": 3, "fail_at_steps": (5,)}
# and at the wide heads of phases 17-19, shallower for the run's time: a
# checkpoint every 2 steps, a fault at 4 (step 3 is lost and run again), 5
# executed steps in place of 7
WIDE_TRAINER_RUN = {"total_steps": 4, "checkpoint_every": 2, "fail_at_steps": (4,)}
# calls per timing of a wide-head step (phases 17-19; the others take 10):
# their steps take 48-113 ms of device time, so the median of 7 timings of 3
# calls reads as steady as of 10, and the run sheds ~50 s
WIDE_STEP_INNER = 3
# a flash forward output against its reference's, as the norm of the
# difference over the reference's norm: ~2.5x the readings on the H100
# (0.00259-0.00407) and ~3x below the padded route with the padded width's
# scale in place of the true head dim's (0.034, on the CPU at Phi-3-mini's
# head dim and small widths), which moves the 3-step losses by only 3e-4
FORWARD_GAP_TOL = 1e-2


def _free_card() -> None:
    """Drop what the last sub-phase left (graphs, their pools, params)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _seeded_once():
    """The burn-in's seeded weights and batch drawn once per shape while the
    block runs: a full-width phase draws them again for every run from the
    same seeds (the flash run, its reference, the forward gap, the graphed
    step, the trainer), ~2 s of host time a draw at DeepSeek-V4-Flash's
    widths. The same seeds give the same arrays, and every caller copies
    them before use (``weights._load``, ``.to`` the card), so only the time
    changes. Also a decorator."""
    from tpu_operator_torch.workloads import burnin, training

    real_params, real_batch = burnin.seeded_params, burnin._seeded_batch
    drawn = {}

    def params(cfg):
        key = ("params", cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.qkv_width, cfg.moe_experts)
        if key not in drawn:
            drawn[key] = real_params(cfg)
        return dict(drawn[key])

    def batch(cfg):
        key = ("batch", cfg.batch, cfg.seq_len, cfg.d_model)
        if key not in drawn:
            drawn[key] = real_batch(cfg)
        return drawn[key]

    burnin.seeded_params, burnin._seeded_batch, training.seeded_params = params, batch, params
    try:
        yield
    finally:
        burnin.seeded_params, burnin._seeded_batch = real_params, real_batch
        training.seeded_params = real_params


@contextlib.contextmanager
def _dense_packed_attention():
    """The burn-in's flash attention swapped for dense attention under the
    packed documents' mask (``ringattention.dense_attention``, plain
    PyTorch autograd, GQA by repeated kv heads): the reference of a packed
    run where the dense path takes no segment ids."""
    from tpu_operator_torch.workloads import burnin
    from tpu_operator_torch.workloads.ringattention import dense_attention

    def ctx(q, k, v, packed=0):
        group = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
        seg = burnin._packed_ids(q.shape[0], q.shape[1], packed, q.device) if packed else None
        return dense_attention(q, k, v, causal=True, segment_ids=seg)

    real = burnin._flash_ctx
    burnin._flash_ctx = ctx
    try:
        yield
    finally:
        burnin._flash_ctx = real


def _curve_against(name: str, cfg, ref_name: str, reference, phase: str = "head dims") -> dict:
    """run_burnin(steps=3) of ``cfg`` on the card (flash) with its exact
    launches, held to ``reference()``'s curve within BF16_TOL relative;
    logged under ``phase``."""
    from tpu_operator_torch.workloads.burnin import run_burnin

    steps = 3
    zero_launches()
    got = run_burnin(steps=steps, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    counts = read_launches()
    expected = _expected_launches(counts, cfg, steps)
    if counts != expected:
        raise RuntimeError(f"{name}: launches {counts}, expected {expected}")
    _free_card()
    ref = reference()
    rel = _curve_rel(got["losses"], ref["losses"])
    if not rel <= BF16_TOL:
        raise RuntimeError(f"{name}: losses {got['losses']} differ from the {ref_name}'s "
                           f"{ref['losses']} by {rel} (relative, tol {BF16_TOL})")
    _free_card()
    log(f"{phase} {name}: run_burnin(steps={steps}) losses "
        f"{[round(x, 5) for x in got['losses']]}, {ref_name} "
        f"{[round(x, 5) for x in ref['losses']]} (rel err {rel:.3g}); launches per step "
        f"{ {k: v / steps for k, v in counts.items() if v} }")
    return {"losses": got["losses"], "reference": ref_name, "reference_losses": ref["losses"],
            "rel_err": rel, "launches": counts}


def _forward_gap(cfg, reference_cfg, reference_ctx=contextlib.nullcontext) -> float:
    """The seeded model's forward output with ``cfg`` (flash) against
    ``reference_cfg``'s under ``reference_ctx``, as the norm of the
    difference over the reference's norm: the losses of an RMS-normalised
    output against an N(0, 1) target read ~2.0 for any output, so this is
    what tells a wrong attention from a right one."""
    from tpu_operator_torch.weights import burnin_params
    from tpu_operator_torch.workloads.burnin import _seeded_batch, forward, seeded_params

    params = burnin_params(seeded_params(cfg), cfg, "cuda")
    x = _seeded_batch(cfg)[0].to("cuda", cfg.tdtype)
    with torch.no_grad():
        got = forward(params, x, cfg).float()
        with reference_ctx():
            want = forward(params, x, reference_cfg).float()
    gap = float((got - want).norm() / want.norm())
    if not gap <= FORWARD_GAP_TOL:
        raise RuntimeError(f"{cfg}: the forward output differs from the reference's by {gap} "
                           f"(tol {FORWARD_GAP_TOL})")
    return gap


def _trainer_with_a_fault(out: dict, cfg, flash_losses: list, name: str = "gemma-2b",
                          phase: str = "head dims", key: str = "gemma_trainer",
                          run: dict = HEAD_DIM_TRAINER_RUN) -> None:
    """ResumableTrainer at ``cfg``'s widths, as ``run`` sets it (total
    steps, checkpoint interval, one fault): a fault, a resume, continuity,
    the steps since the last checkpoint re-executed bit for bit, the first
    3 losses the flash run's; recorded as ``out[key]`` and the path
    ``f"{phase} {name} trainer"``."""
    from tpu_operator_torch.workloads.checkpoint import CheckpointStore
    from tpu_operator_torch.workloads.training import (
        ResumableTrainer,
        TrainerError,
        verify_continuity,
    )

    total = run["total_steps"]
    (fault,) = run["fail_at_steps"]
    every = run["checkpoint_every"]
    lost = list(range((fault - 1) // every * every + 1, fault))
    if not lost or total < 4:
        raise ValueError(f"{run}: no step is lost to the fault, or too few steps to compare")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = ResumableTrainer(CheckpointStore(tmp), cfg, device="cuda", **run)
        saves = _timed_checkpoints(trainer)
        zero_launches()
        trainer.resume(1)
        try:
            trainer.run(total)
            raise RuntimeError(f"{name} trainer: the injected fault at step {fault} did not fire")
        except TrainerError as e:
            log(f"{phase} {name} trainer: {e} (at step {trainer.step}, checkpoint "
                f"{trainer.checkpoint_step})")
        trainer.resume(1)
        trainer.run(total)
        torch.cuda.synchronize()
        counts = read_launches()
        _trainer_launches(counts, cfg, len(trainer.history), f"{name} trainer")
        report = verify_continuity(trainer.history, trainer.checkpoints, total)
        if not (trainer.done and report["ok"] and report["rewinds"] == 1
                and report["max_lost_steps"] == len(lost)):
            raise RuntimeError(f"{name} trainer: continuity {report}")
        first, reruns = {}, {}
        for h in trainer.history:
            if h["step"] in first:
                reruns[h["step"]] = (first[h["step"]], h["loss"])
            else:
                first[h["step"]] = h["loss"]
        if sorted(reruns) != lost or any(a != b for a, b in reruns.values()):
            raise RuntimeError(f"{name} trainer: re-executed losses differ: {reruns}")
        head = [first[s] for s in (1, 2, 3)]
        rel = _curve_rel(head, flash_losses)
        if not (rel <= GRAPH_REL_TOL and first[total] < first[1]):
            raise RuntimeError(f"{name} trainer: first losses {head} differ from run_burnin's "
                               f"{flash_losses} by {rel} (tol {GRAPH_REL_TOL}), or the curve "
                               f"{first[1]} -> {first[total]} does not fall")
        step_s = trainer.step_times[1][1:]
        out["paths"][f"{phase} {name} trainer"] = counts
        out[key] = {
            **{k: list(v) if isinstance(v, tuple) else v for k, v in run.items()},
            "executed_steps": len(trainer.history), "continuity": report,
            "losses": trainer.history, "reruns": reruns, "head_rel_err": rel,
            "step_ms_median": 1e3 * statistics.median(step_s),
            "resume_ms": [1e3 * r.latency_s for r in trainer.resumes],
            "checkpoint_ms": [1e3 * s for s in saves]}
    log(f"{phase} {name} trainer: {len(trainer.history)} executed steps of {total} (fault "
        f"at {fault}, resumed at {trainer.resumes[1].step}), continuity ok, lost "
        f"{report['max_lost_steps']}; re-executed losses equal {reruns}; first losses equal to "
        f"run_burnin's (rel {rel:.3g}); launches {counts}; step ms median "
        f"{out[key]['step_ms_median']:.3f}; checkpoint ms "
        f"{[round(x, 1) for x in out[key]['checkpoint_ms']]}")


def _masked_dense(q, k, v, causal: bool, window=None, seg=None):
    """Dense softmax attention in (B, S, H, D) under the kernels' masks
    (``keep_mask``): autograd's reference for the f32 gradient checks."""
    from tpu_operator_torch.kernels.flash_fwd import keep_mask

    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    keep = keep_mask(b * h, s, s, h, causal, window=window, seg=seg, device=q.device)
    scores = scores.masked_fill(~keep.expand(b * h, s, s).reshape(b, h, s, s), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _f32_grads_at(d: int, window, device: str = "cuda", full: bool = False) -> dict:
    """autograd through flash_attention against autograd through dense
    attention, f32, (1, 256, 2, d): the triangle pair, (unless ``window``
    is None) the general pair under a window and two segments, and (with
    ``full``) the general pair under full attention."""
    from tpu_operator_torch.workloads.flashattention import flash_attention

    gen = torch.Generator(device=device).manual_seed(17)
    q, k, v, w = (torch.randn((1, 256, 2, d), generator=gen, device=device) for _ in range(4))
    seg = (torch.arange(256, device=device) >= 100).to(torch.int32)[None]
    out = {}
    cases = [("triangle", {})]
    if window is not None:
        cases.append((f"window {window}, segments", {"window": window, "seg": seg}))
    if full:
        cases.append(("full attention", {"causal": False}))
    for name, kwargs in cases:
        grads = {}
        causal = kwargs.pop("causal", True)
        for impl in ("flash", "dense"):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            if impl == "flash":
                got = flash_attention(*leaves, causal=causal, window=kwargs.get("window"),
                                      segment_ids=kwargs.get("seg"))
            else:
                got = _masked_dense(*leaves, causal, **kwargs)
            grads[impl] = torch.autograd.grad((got * w).sum(), leaves)
        worst = max(float((f - d).abs().max()) for f, d in zip(grads["flash"], grads["dense"]))
        if not worst <= F32_TOL:
            raise RuntimeError(f"f32 flash gradients at head dim {d} ({name}) differ from dense "
                               f"by {worst} (tol {F32_TOL})")
        out[name] = worst
    return out


def _f32_pair_launches(phase: str) -> dict:
    """The launches since ``zero_launches`` of an ``_f32_grads_at`` run with
    a window (the triangle pair and the general pair, one launch of each
    kernel), raising on any other count."""
    counts = read_launches()
    want = {"flash_bwd_dq_tri": 1, "flash_bwd_dkv_tri": 1, "flash_bwd_dq_rect": 1,
            "flash_bwd_dkv_rect": 1}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"{phase} f32 gradients: backward launches {counts}, want {want}")
    return counts


def _serving_at(out: dict, head_dim: int, phase: str) -> None:
    """The default serving geometry at ``head_dim`` (f32): flash prefill
    (the general kernel) against dense prefill, phase 5's 16 requests;
    recorded as the path ``f"{phase} serving d{head_dim}"``."""
    from tpu_operator_torch.workloads.serving import DecodeEngine, ServingModelConfig, make_requests

    requests = make_requests(16, seed=20260818, prompt_len=24, decode_max=32)
    runs = {}
    for name, flash in (("dense", False), ("flash", True)):
        engine = DecodeEngine(ServingModelConfig(head_dim=head_dim, use_flash_prefill=flash))
        engine.warmup(24)
        batch = copy.deepcopy(requests)
        zero_launches()
        for r in batch:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        runs[name] = {"tokens": {r.rid: list(r.output) for r in engine.completed},
                      "launches": read_launches(), "report": engine.report()}
    flash, dense = runs["flash"], runs["dense"]
    if len(flash["tokens"]) != 16 or flash["tokens"] != dense["tokens"]:
        raise RuntimeError(f"serving at head dim {head_dim}: flash-prefill greedy tokens differ "
                           f"from dense prefill")
    expected = {k: REPLICA_LAUNCHES if k == "flash_fwd_rect" else 0 for k in flash["launches"]}
    if flash["launches"] != expected:
        raise RuntimeError(f"serving at head dim {head_dim}: launches {flash['launches']}, "
                           f"expected {expected}")
    out["paths"][f"{phase} serving d{head_dim}"] = flash["launches"]
    out["serving"] = {"report": flash["report"], "dense_report": dense["report"]}
    log(f"{phase} serving d{head_dim}: 16 requests, tokens identical to dense prefill, launches "
        f"{flash['launches']}, {flash['report']['tokens_per_s']} tok/s")


@_seeded_once()
def phase_head_dims() -> dict:
    """Phase 15 (see the module's docstring)."""
    from tpu_operator_torch.workloads.burnin import build_train_step, run_burnin
    from tpu_operator_torch.workloads.training import trainer_config

    start = time.perf_counter()
    out = {"paths": {}}
    gemma = trainer_config(GEMMA_2B)
    if gemma.d_model // gemma.n_heads != 256:
        raise RuntimeError(f"gemma-2b config: head dim {gemma.d_model // gemma.n_heads}")
    # (a) Gemma-2B's widths: flash against dense, the graphed step, the trainer
    dense = dataclasses.replace(gemma, use_flash_attention=False)
    out["gemma"] = _curve_against("gemma-2b", gemma, "dense path",
                                  lambda: run_burnin(steps=3, cfg=dense, device="cuda"))
    out["paths"]["head dims gemma-2b"] = out["gemma"].pop("launches")
    out["gemma"]["forward_gap"] = _forward_gap(gemma, dense)
    _free_card()
    step, params, batch = build_train_step(gemma, "cuda")
    out["gemma"]["replays"] = _replays_vs_eager(step, params, batch)
    out["gemma"].update(_step_times(step, params, batch))
    del step, params, batch
    _free_card()
    g = out["gemma"]
    log(f"head dims gemma-2b: {GRAPH_STEPS} graphed steps vs eager: rel "
        f"{g['replays']['rel_err']:.3g}{' (bit for bit)' if g['replays']['bitwise'] else ''}; "
        f"step ms eager {g['step_ms']:.3f}, replay {g['step_replay_ms']:.3f}, device "
        f"{g['step_device_ms']:.3f}, {g['step_graph_nodes']} device operations; forward output "
        f"{g['forward_gap']:.3g} from the dense path's (norm of the difference over its norm)")
    _trainer_with_a_fault(out, gemma, out["gemma"]["losses"])
    _free_card()
    packed = dataclasses.replace(gemma, packed_segments=2)

    def packed_reference():
        with _dense_packed_attention():
            return run_burnin(steps=3, cfg=packed, device="cuda")

    out["gemma_packed"] = _curve_against("gemma-2b packed", packed,
                                         "dense path under the documents' mask",
                                         packed_reference)
    out["paths"]["head dims gemma-2b packed"] = out["gemma_packed"].pop("launches")
    out["gemma_packed"]["forward_gap"] = _forward_gap(packed, packed, _dense_packed_attention)
    _free_card()
    # (b) f32 gradients at head dim 256: the cluster pairs, once per case
    zero_launches()
    out["f32_grads_256"] = _f32_grads_at(256, 40)
    out["paths"]["head dims f32 grads d256"] = _f32_pair_launches("head dims")
    log(f"head dims f32 (1,256,2,256) flash_attention gradients vs dense, max abs err "
        f"{out['f32_grads_256']}")
    # (c) serving at head dim 256
    _serving_at(out, 256, "head dims")
    _free_card()
    # (d) the zero-padded route at Phi-3-mini's widths
    phi = trainer_config(PHI3_MINI)
    phi_dense = dataclasses.replace(phi, use_flash_attention=False)
    out["phi3"] = _curve_against("phi-3-mini (head dim 96, padded to 128)", phi, "dense path",
                                 lambda: run_burnin(steps=3, cfg=phi_dense, device="cuda"))
    out["paths"]["head dims phi-3-mini"] = out["phi3"].pop("launches")
    out["phi3"]["forward_gap"] = _forward_gap(phi, phi_dense)
    _free_card()
    log(f"head dims: forward output against the reference's (norm of the difference over its "
        f"norm): gemma-2b packed {out['gemma_packed']['forward_gap']:.3g}, phi-3-mini "
        f"{out['phi3']['forward_gap']:.3g}")
    out["seconds"] = time.perf_counter() - start
    log(f"head dims: phase 15 in {out['seconds']:.1f} s")
    return out


# -- phase 16: float16 -----------------------------------------------------

# (a) entry() widths in fp16 with flash attention: the triangle pairs, a GQA
# group inside dK/dV, the general pairs, the mixture of experts
FLOAT16_CONFIGS = {"plain": {}, "gqa": {"kv_heads": 2}, "packed": {"packed_segments": 2},
                   "moe": {"moe_experts": 4}}
# (b) Phi-3-mini's widths (PHI3_MINI: depth cut 32 -> 1, the padded head) as a
# TPUJob's spec.workload.config that asks for float16
PHI3_MINI_F16 = dict(PHI3_MINI, dtype="float16")


@contextlib.contextmanager
def _cotangents(seen: list, d: int):
    """Record the output cotangent that reaches flash attention's backward
    (its first ``d`` columns: a padded head's others are the pad's zeros)
    as device tensors in ``seen``, without a host sync."""
    from tpu_operator_torch.workloads import flashattention

    real = flashattention._flash_bwd_impl

    def spy(qb, kb, vb, out, lse, g, *args, **kwargs):
        seen.append(g[..., :d].detach().float())
        return real(qb, kb, vb, out, lse, g, *args, **kwargs)

    flashattention._flash_bwd_impl = spy
    try:
        yield
    finally:
        flashattention._flash_bwd_impl = real


def _dout_stats(cfg) -> dict:
    """The seeded eager step's output cotangent at attention's backward in
    the last layer: the share of exact zeros and of fp16 subnormals, its rms
    and largest value, against the magnitude the loss reckons for the
    cotangent entering the model's output, 2·rms(out − t)/N = 2·√loss/N with
    N = batch·seq·d_model."""
    from tpu_operator_torch.workloads.burnin import build_train_step

    step, params, batch = build_train_step(cfg, "cuda")
    seen: list = []
    with _cotangents(seen, cfg.d_model // cfg.n_heads):
        _, loss = step.eager(params, batch)
    g = seen[0]  # the backward walks the layers from the last
    n = cfg.batch * cfg.seq_len * cfg.d_model
    tiny = 2.0 ** -14  # fp16's smallest normal
    stats = {"zero_share": float((g == 0).float().mean()),
             "subnormal_share": float(((g != 0) & (g.abs() < tiny)).float().mean()),
             "rms": float(g.square().mean().sqrt()), "max_abs": float(g.abs().max()),
             "loss": float(loss), "reckoned_output_cotangent": 2.0 * math.sqrt(float(loss)) / n,
             "elements": n}
    del step, params, batch, seen, g
    return stats


def _float16_at_entry_widths(out: dict, smi: str) -> None:
    """(a): run_burnin(steps=3) in fp16 at entry() widths, each config with
    its exact launches, held to the fp16 dense path (packed: the CPU plain
    versions, as phase 6), then GRAPH_STEPS graphed steps against the eager
    step, and the step's eager, replayed and device ms."""
    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.workloads.burnin import build_train_step, run_burnin

    steps = 3
    for name, over in FLOAT16_CONFIGS.items():
        cfg = dataclasses.replace(ENTRY_CONFIG, dtype="float16", use_flash_attention=True, **over)
        zero_launches()
        got = run_burnin(steps=steps, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        counts = read_launches()
        expected = _expected_launches(counts, cfg, steps)
        if counts != expected:
            raise RuntimeError(f"float16 {name}: launches {counts}, expected {expected}")
        if cfg.packed_segments:
            ref_name, ref = "CPU plain versions", run_burnin(steps=steps, cfg=cfg, device="cpu")
        else:
            ref_name = "dense path"
            ref = run_burnin(steps=steps, cfg=dataclasses.replace(cfg, use_flash_attention=False),
                             device="cuda")
        rel = _curve_rel(got["losses"], ref["losses"])
        if not rel <= BF16_TOL:
            raise RuntimeError(f"float16 {name}: losses {got['losses']} differ from the "
                               f"{ref_name}'s {ref['losses']} by {rel} (relative, tol {BF16_TOL})")
        step, params, batch = build_train_step(cfg, "cuda")
        if params["l0/qkv"].dtype != torch.float32 or batch[0].dtype != torch.float16:
            raise RuntimeError(f"float16 {name}: params {params['l0/qkv'].dtype}, batch "
                               f"{batch[0].dtype}")
        replays = _replays_vs_eager(step, params, batch)
        times = _step_times(step, params, batch)
        del step, params, batch
        out["paths"][f"float16 {name}"] = counts
        out["entry"][name] = {"losses": got["losses"], "reference": ref_name,
                              "reference_losses": ref["losses"], "rel_err": rel,
                              "replays": replays, **times}
        log(f"float16 {name}: run_burnin(steps={steps}) losses "
            f"{[round(x, 5) for x in got['losses']]}, {ref_name} "
            f"{[round(x, 5) for x in ref['losses']]} (rel err {rel:.3g}); launches per step "
            f"{ {k: v / steps for k, v in counts.items() if v} }; {GRAPH_STEPS} graphed steps vs "
            f"eager: rel {replays['rel_err']:.3g}{' (bit for bit)' if replays['bitwise'] else ''}; "
            f"step ms eager {times['step_ms']:.4f}, replay {times['step_replay_ms']:.4f}, device "
            f"{times['step_device_ms']:.4f} [{smi}]")
    cfg = dataclasses.replace(ENTRY_CONFIG, dtype="float16", use_flash_attention=True)
    out["entry_dout"] = _dout_stats(cfg)
    _free_card()


def _float16_at_full_width(out: dict, smi: str) -> None:
    """(b): Phi-3-mini's widths with dtype float16 through
    training.trainer_config: flash against dense, the forward output, the
    graphed steps, the elastic trainer with a fault, the packed run, and the
    cotangent that reaches attention's backward."""
    from tpu_operator_torch.workloads.burnin import build_train_step, run_burnin
    from tpu_operator_torch.workloads.training import trainer_config

    phi = trainer_config(PHI3_MINI_F16)
    if phi.tdtype != torch.float16:
        raise RuntimeError(f"float16: trainer_config gave {phi.tdtype}")
    dense = dataclasses.replace(phi, use_flash_attention=False)
    out["phi3"] = _curve_against("phi-3-mini", phi, "dense path",
                                 lambda: run_burnin(steps=3, cfg=dense, device="cuda"),
                                 phase="float16")
    out["paths"]["float16 phi-3-mini"] = out["phi3"].pop("launches")
    out["phi3"]["forward_gap"] = _forward_gap(phi, dense)
    _free_card()
    step, params, batch = build_train_step(phi, "cuda")
    out["phi3"]["replays"] = _replays_vs_eager(step, params, batch)
    out["phi3"].update(_step_times(step, params, batch))
    del step, params, batch
    _free_card()
    p = out["phi3"]
    log(f"float16 phi-3-mini: {GRAPH_STEPS} graphed steps vs eager: rel "
        f"{p['replays']['rel_err']:.3g}{' (bit for bit)' if p['replays']['bitwise'] else ''}; "
        f"step ms eager {p['step_ms']:.3f}, replay {p['step_replay_ms']:.3f}, device "
        f"{p['step_device_ms']:.3f}, {p['step_graph_nodes']} device operations; forward output "
        f"{p['forward_gap']:.3g} from the dense path's [{smi}]")
    _trainer_with_a_fault(out, phi, p["losses"], name="phi-3-mini", phase="float16",
                          key="phi3_trainer")
    _free_card()
    packed = dataclasses.replace(phi, packed_segments=2)

    def packed_reference():
        with _dense_packed_attention():
            return run_burnin(steps=3, cfg=packed, device="cuda")

    out["phi3_packed"] = _curve_against("phi-3-mini packed", packed,
                                        "dense path under the documents' mask",
                                        packed_reference, phase="float16")
    out["paths"]["float16 phi-3-mini packed"] = out["phi3_packed"].pop("launches")
    out["phi3_packed"]["forward_gap"] = _forward_gap(packed, packed, _dense_packed_attention)
    _free_card()
    out["phi3_dout"] = _dout_stats(phi)
    _free_card()


@_seeded_once()
def phase_float16(smi: str) -> dict:
    """Phase 16 (see the module's docstring)."""
    start = time.perf_counter()
    out = {"paths": {}, "entry": {}}
    _float16_at_entry_widths(out, smi)
    _float16_at_full_width(out, smi)
    for where, key in (("entry() widths", "entry_dout"), ("phi-3-mini", "phi3_dout")):
        st = out[key]
        log(f"float16 {where}: the cotangent at attention's backward: {st['zero_share']:.4g} "
            f"exact zeros, {st['subnormal_share']:.4g} subnormal, rms {st['rms']:.4g}, max "
            f"{st['max_abs']:.4g}; the loss {st['loss']:.6g} reckons 2·√loss/N = "
            f"{st['reckoned_output_cotangent']:.4g} at the output (N = {st['elements']}) [{smi}]")
    log(f"float16: forward output against the reference's (norm of the difference over its "
        f"norm): phi-3-mini {out['phi3']['forward_gap']:.3g}, packed "
        f"{out['phi3_packed']['forward_gap']:.3g}")
    out["seconds"] = time.perf_counter() - start
    log(f"float16: phase 16 in {out['seconds']:.1f} s")
    return out


# -- phase 17: head dim 512 ------------------------------------------------

# DeepSeek-V4-Flash's attention widths (huggingface.co/deepseek-ai/
# DeepSeek-V4-Flash config.json: hidden_size 4096, 64 attention heads of
# head_dim 512 on num_key_value_heads 1, moe_intermediate_size 2048,
# num_hidden_layers 43, sliding_window 128) as a TPUJob's
# spec.workload.config. Cut to size: heads 64 -> 8, one card's share under
# 8-way tensor parallelism (the burn-in's head dim is d_model // n_heads, so
# 8 x 512 keeps the model's hidden size of 4096); depth 43 -> 1, for the
# run's time; the burn-in's dense FFN at the shared expert's width, 2048;
# 8192 tokens of a 1M context. The routed experts, CSA/HCA
# compression, mHC, MTP and the low-rank q/o projections are not part of
# the reference's burn-in block.
DEEPSEEK_V4_FLASH = {"d_model": 4096, "n_heads": 8, "kv_heads": 1, "d_ff": 2048, "seq_len": 8192,
                     "batch": 1, "n_layers": 1, "use_flash_attention": True}


# -- phase 18: head dim 576 ------------------------------------------------

# sarvam-105b's attention widths (huggingface.co/sarvamai/sarvam-105b
# config.json: head_dim 576, kv_lora_rank 512 + qk_rope_head_dim 64, over 64
# query heads; moe_intermediate_size 2048; num_hidden_layers 32; a 131072
# context) as a TPUJob's spec.workload.config. This runs MLA's absorbed
# attention shape (every query head of 576 columns on one shared latent key
# of 576 columns, its prefill and decode attention) through the burn-in's
# GQA block: there are no latent projections and no rope split, and V is 576
# wide too, since the reference's API takes one head dim for q, k and v.
# Cut to size: heads 64 -> 8, one card's share under 8-way tensor
# parallelism (the burn-in's head dim is d_model // n_heads, so d_model is
# 8 x 576 = 4608); kv heads 1, the shared latent; depth 32 -> 2; the
# burn-in's dense FFN at the experts' width, 2048; 8192 tokens of 131072.
SARVAM_105B = {"d_model": 4608, "n_heads": 8, "kv_heads": 1, "d_ff": 2048, "seq_len": 8192,
               "batch": 1, "n_layers": 2, "use_flash_attention": True}


def _flash_against_dense(smi: str, out: dict, cfg, name: str, key: str, phase: str,
                         packed: bool = False) -> dict:
    """Section (a) of phases 17-19: ``cfg``'s run_burnin (flash) against
    its dense path (``packed``: the dense path under the documents' mask,
    ``_dense_packed_attention``), the seeded forward output, ``GRAPH_STEPS``
    graphed steps against the eager step and the step's times; recorded as
    ``out[key]`` (returned) and the path ``f"{phase} {name}"``."""
    from tpu_operator_torch.workloads.burnin import build_train_step, run_burnin

    dense = cfg if packed else dataclasses.replace(cfg, use_flash_attention=False)
    ctx = _dense_packed_attention if packed else contextlib.nullcontext

    def reference():
        with ctx():
            return run_burnin(steps=3, cfg=dense, device="cuda")

    out[key] = _curve_against(name, cfg, "dense path under the documents' mask" if packed
                              else "dense path", reference, phase)
    out["paths"][f"{phase} {name}"] = out[key].pop("launches")
    out[key]["forward_gap"] = _forward_gap(cfg, dense, ctx)
    _free_card()
    step, params, batch = build_train_step(cfg, "cuda")
    out[key]["replays"] = _replays_vs_eager(step, params, batch)
    out[key].update(_step_times(step, params, batch, WIDE_STEP_INNER))
    del step, params, batch
    _free_card()
    g = out[key]
    log(f"{phase} {name}: {GRAPH_STEPS} graphed steps vs eager: rel "
        f"{g['replays']['rel_err']:.3g}{' (bit for bit)' if g['replays']['bitwise'] else ''}; "
        f"step ms eager {g['step_ms']:.3f}, replay {g['step_replay_ms']:.3f}, device "
        f"{g['step_device_ms']:.3f}, {g['step_graph_nodes']} device operations; forward output "
        f"{g['forward_gap']:.3g} from the dense path's [{smi}]")
    return g


@_seeded_once()
def _wide_head_phase(smi: str, config: dict, name: str, key: str, d: int, number: int) -> dict:
    """Phases 17 and 18 (see the module's docstring): ``config``'s widths
    (the model ``name``, results under ``key``) at head dim ``d``, the f32
    gradients at ``d`` under a window of 128 too, and serving at ``d``."""
    from tpu_operator_torch.workloads.burnin import run_burnin
    from tpu_operator_torch.workloads.training import trainer_config

    start = time.perf_counter()
    out = {"paths": {}}
    cfg = trainer_config(config)
    if cfg.d_model // cfg.n_heads != d:
        raise RuntimeError(f"{name} config: head dim {cfg.d_model // cfg.n_heads}, not {d}")
    phase = f"head dim {d}"
    # (a) flash against dense, the graphed step, the trainer (shallower
    # than phase 15's, for the run's time), packed, fp16
    g = _flash_against_dense(smi, out, cfg, name, key, phase)
    _trainer_with_a_fault(out, cfg, g["losses"], name=name, phase=phase, key=f"{key}_trainer",
                          run=WIDE_TRAINER_RUN)
    _free_card()
    packed = dataclasses.replace(cfg, packed_segments=2)

    def packed_reference():
        with _dense_packed_attention():
            return run_burnin(steps=3, cfg=packed, device="cuda")

    out[f"{key}_packed"] = _curve_against(f"{name} packed", packed,
                                          "dense path under the documents' mask",
                                          packed_reference, phase)
    out["paths"][f"{phase} {name} packed"] = out[f"{key}_packed"].pop("launches")
    out[f"{key}_packed"]["forward_gap"] = _forward_gap(packed, packed, _dense_packed_attention)
    _free_card()
    f16 = trainer_config(dict(config, dtype="float16"))
    if f16.tdtype != torch.float16:
        raise RuntimeError(f"{phase}: trainer_config gave {f16.tdtype}")
    f16_dense = dataclasses.replace(f16, use_flash_attention=False)
    out[f"{key}_f16"] = _curve_against(f"{name} fp16", f16, "fp16 dense path",
                                       lambda: run_burnin(steps=3, cfg=f16_dense,
                                                          device="cuda"), phase)
    out["paths"][f"{phase} {name} fp16"] = out[f"{key}_f16"].pop("launches")
    out[f"{key}_f16"]["forward_gap"] = _forward_gap(f16, f16_dense)
    _free_card()
    # (b) f32 gradients at the head dim: the cluster pairs, once per case
    zero_launches()
    out[f"f32_grads_{d}"] = _f32_grads_at(d, 128)
    out["paths"][f"{phase} {name} f32 grads"] = _f32_pair_launches(phase)
    log(f"{phase} f32 (1,256,2,{d}) flash_attention gradients vs dense, max abs err "
        f"{out[f'f32_grads_{d}']}")
    # (c) serving at the head dim
    _serving_at(out, d, phase)
    _free_card()
    log(f"{phase}: forward output against the reference's (norm of the difference over its "
        f"norm): {name} {g['forward_gap']:.3g}, packed "
        f"{out[f'{key}_packed']['forward_gap']:.3g}, fp16 "
        f"{out[f'{key}_f16']['forward_gap']:.3g} [{smi}]")
    out["seconds"] = time.perf_counter() - start
    log(f"{phase}: phase {number} in {out['seconds']:.1f} s")
    return out


def phase_head_dim_512(smi: str) -> dict:
    """Phase 17 (see the module's docstring)."""
    return _wide_head_phase(smi, DEEPSEEK_V4_FLASH, "deepseek-v4-flash", "deepseek", 512, 17)


def phase_head_dim_576(smi: str) -> dict:
    """Phase 18 (see the module's docstring)."""
    return _wide_head_phase(smi, SARVAM_105B, "sarvam-105b", "sarvam", 576, 18)


# -- phase 19: head dims above 576 ------------------------------------------

# A burn-in configuration of the repo's own, NOT a published model: no model
# in the catalog has heads wider than 576 (the widest are the absorbed-MLA
# heads of sarvam-105b, DeepSeek-V3 and Kimi-K2, phase 18's shape). It holds
# the reference's "any head dim" contract (its flash_attention and burn-in
# take any d_model // n_heads) at full sequence length on the D-streaming
# kernels: 8 heads of 1024 on one kv head (d_model 8192), the burn-in's dense
# FFN at 2048 (as phases 17 and 18), 8192 tokens, one layer.
WIDE_HEAD_1024 = {"d_model": 8192, "n_heads": 8, "kv_heads": 1, "d_ff": 2048, "seq_len": 8192,
                  "batch": 1, "n_layers": 1, "use_flash_attention": True}


@_seeded_once()
def phase_head_dim_wide(smi: str) -> dict:
    """Phase 19 (see the module's docstring)."""
    from tpu_operator_torch.workloads.training import trainer_config

    start = time.perf_counter()
    out = {"paths": {}}
    cfg = trainer_config(WIDE_HEAD_1024)
    d = cfg.d_model // cfg.n_heads
    if d != 1024:
        raise RuntimeError(f"WIDE_HEAD_1024: head dim {d}, not 1024")
    phase, name = "head dim 1024", "own burn-in config"
    # (a) flash against dense, the graphed step bit for bit, its times, the
    # trainer
    g = _flash_against_dense(smi, out, cfg, name, "wide", phase)
    if not g["replays"]["bitwise"]:
        raise RuntimeError(f"{phase}: graphed steps {g['replays']['graphed_losses']} are not bit "
                           f"for bit the eager step's {g['replays']['eager_losses']}")
    _trainer_with_a_fault(out, cfg, g["losses"], name=name, phase=phase, key="wide_trainer",
                          run=WIDE_TRAINER_RUN)
    _free_card()
    # (b) packed documents through the general pair: against the dense path
    # under the documents' mask, the graphed steps bit for bit
    packed = _flash_against_dense(smi, out, dataclasses.replace(cfg, packed_segments=2),
                                  f"{name} packed", "wide_packed", phase, packed=True)
    if not packed["losses"][-1] < packed["losses"][0]:
        raise RuntimeError(f"{phase} packed: losses {packed['losses']} do not fall")
    if not packed["replays"]["bitwise"]:
        raise RuntimeError(f"{phase} packed: graphed steps {packed['replays']['graphed_losses']} "
                           f"are not bit for bit the eager step's "
                           f"{packed['replays']['eager_losses']}")
    _free_card()
    # (c) f32 gradients at the head dim: the triangle, a window and
    # segments, full attention; each pair's f32 kernels launched once per
    # case (the triangle's once, the general pair's twice)
    zero_launches()
    out[f"f32_grads_{d}"] = _f32_grads_at(d, 128, full=True)
    out["paths"][f"{name} f32 grads"] = counts = read_launches()
    log(f"{phase} f32 (1,256,2,{d}) flash_attention gradients vs dense, max abs err "
        f"{out[f'f32_grads_{d}']}; launches {counts}")
    want = {"flash_bwd_dq_tri": 1, "flash_bwd_dkv_tri": 1, "flash_bwd_dq_rect": 2,
            "flash_bwd_dkv_rect": 2}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"{phase} f32 gradients: backward launches {counts}, want {want}")
    # (d) serving at the head dim
    _serving_at(out, d, phase)
    _free_card()
    out["seconds"] = time.perf_counter() - start
    log(f"{phase}: phase 19 in {out['seconds']:.1f} s")
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
    start = time.perf_counter()
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
    results["replicas"] = phase_replicas(results["serving"]["tokens"])
    results["autotune"] = phase_autotune()
    results["agents"] = phase_agents()
    results["device_layer"] = phase_device_layer()
    results["head_dims"] = phase_head_dims()
    results["float16"] = phase_float16(smi)
    results["head_dim_512"] = phase_head_dim_512(smi)
    results["head_dim_576"] = phase_head_dim_576(smi)
    results["head_dim_wide"] = phase_head_dim_wide(smi)
    paths = {"burnin forward": results["burnin"]["launches"],
             "serving": results["serving"]["launches"], **results["train"]["paths"],
             **results["selftest"]["paths"], **results["sharded"]["paths"],
             **results["slice"]["paths"], **results["trainer"]["paths"],
             **results["replicas"]["paths"], **results["autotune"]["paths"],
             **results["agents"]["paths"], **results["head_dims"]["paths"],
             **results["float16"]["paths"], **results["head_dim_512"]["paths"],
             **results["head_dim_576"]["paths"], **results["head_dim_wide"]["paths"]}
    fwd = results["build"]["flash_fwd_hgmma"]
    hgmma = {"flash_fwd_tri": {k: v for k, v in fwd.items() if not k.startswith("rect_")},
             "flash_fwd_rect": {k: v for k, v in fwd.items() if k.startswith("rect_")}}
    for kind in ("dq", "dkv"):
        for pair, prefix in (("tri", f"{kind}_d"), ("rect", f"{kind}_rect_d")):
            hgmma[f"flash_bwd_{kind}_{pair}"] = {
                k: v for k, v in results["build"]["flash_bwd_hgmma"].items() if k.startswith(prefix)}
    fwd16 = results["build"]["flash_fwd_f16_hgmma"]
    hgmma16 = {"flash_fwd_tri": {k: v for k, v in fwd16.items() if not k.startswith("rect_")},
               "flash_fwd_rect": {k: v for k, v in fwd16.items() if k.startswith("rect_")}}
    for kind in ("dq", "dkv"):
        for pair, prefix in (("tri", f"{kind}_d"), ("rect", f"{kind}_rect_d")):
            hgmma16[f"flash_bwd_{kind}_{pair}"] = {
                k: v for k, v in results["build"]["flash_bwd_f16_hgmma"].items()
                if k.startswith(prefix)}
    wide = {}  # the D 512 and 576 libraries' instantiations, bf16 and fp16 per kernel
    for name in WIDE_INSTANTIATIONS:
        fp16 = "_f16" in name
        for label, count in results["build"][f"{name}_hgmma"].items():
            pair = "rect" if label.startswith("rect_") or "_rect_" in label else "tri"
            kind = (f"flash_fwd_{pair}" if name.startswith("flash_fwd")
                    else f"flash_bwd_{label.split('_')[0]}_{pair}")
            wide.setdefault((name[-4:], kind), {})[f"{'fp16' if fp16 else 'bf16'} {label}"] = count
    # the D-streaming libraries' instantiation of each kernel they hold
    streamed = {"wide_tri": "flash_fwd_tri", "wide_rect": "flash_fwd_rect",
                "dq_wide": "flash_bwd_dq_tri", "dkv_wide": "flash_bwd_dkv_tri",
                "dq_rect_wide": "flash_bwd_dq_rect", "dkv_rect_wide": "flash_bwd_dkv_rect"}
    for name in WIDE_HEAD_INSTANTIATIONS:
        fp16 = "_f16" in name
        for label, count in results["build"][f"{name}_hgmma"].items():
            wide.setdefault(("wide", streamed[label]), {})[
                f"{'fp16' if fp16 else 'bf16'} {label}"] = count
    # the f32 forward at head dims 256 and above: the cluster kernels, by mask;
    # at 32-128 the tile kernels
    f32_fwd = results["build"]["flash_fwd_wide_f32_ptxas"]
    cluster = {f"flash_fwd_{pair}": {
        **{f"flash_fwd_f32_cluster_kernel<{pair == 'tri'}, {rows}>".lower():
           f32_fwd[f"fwd_{pair}_{rows}"] for rows in (64, 16)},
        **{k: f32_fwd[k] for k in F32_FWD_TILE_KERNELS if k.startswith(f"flash_fwd_{pair}_")}}
        for pair in ("tri", "rect")}
    # and the backward pairs' (up to head dim 128 one CTA a tile, at 256 and above
    # in clusters; dK/dV with its split's sum)
    f32_bwd = results["build"]["flash_bwd_wide_f32_ptxas"]
    for kind in ("dq", "dkv"):
        for pair in ("tri", "rect"):
            names = [f"flash_bwd_{kind}_{pair}_wide_f32_kernel"] + [
                f"flash_bwd_{kind}_{pair}_tile_f32_kernel<{width}>" for width in (64, 128)] + (
                ["flash_bwd_dkv_split_sum_kernel"] if kind == "dkv" else [])
            cluster[f"flash_bwd_{kind}_{pair}"] = {k: f32_bwd[k] for k in names}
    # the 16-bit dK/dV's split sums (up to head dim 256), one per library
    split_sums = {"flash_bwd_dkv_split_sum_kernel<" + ("__nv_bfloat16>" if lib == "flash_bwd"
                                                       else "__half>"):
                  results["build"][f"{lib}_split_sum_ptxas"] for lib in SPLIT_SUM_LIBRARIES}
    line = kernels_line(results["kernels"], paths,
                        {k: {"hgmma": v, "hgmma_fp16": hgmma16[k],
                             **({"split_sum_kernels": split_sums} if "_dkv_" in k else {}),
                             "hgmma_d512": wide.get(("d512", k), {}),
                             "hgmma_d576": wide.get(("d576", k), {}),
                             "hgmma_wide": wide.get(("wide", k), {}),
                             **({"f32_cluster_kernels": cluster[k]} if k in cluster else {})}
                         for k, v in hgmma.items()})
    results["seconds"] = time.perf_counter() - start
    log(f"chip_smoke: every phase in {results['seconds']:.1f} s")
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
