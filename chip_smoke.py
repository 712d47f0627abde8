#!/usr/bin/env python3
"""Drive horovod_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels, from ``horovod_tpu_torch/csrc`` (nvcc), and
   a resource report of each kernel's bf16 D=32, D=64 and D=128
   instantiations:
   registers and spills (``-Xptxas -v``), static and dynamic shared
   memory, and resident blocks per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
3. kernels: each flash-attention kernel against its plain PyTorch version
   on the card, at the training shape, at the 8b shape (D=128) and at
   edges (non-causal, GQA groups 1 and 8, S not a multiple of 128, fp32,
   D=32: the MoE Llama's head dim),
   dq's and dk/dv's bitwise determinism, with kernel, plain and library
   times at the training shape, the 8b shape, MoE ``mini``'s and
   BERT-Large's (q/k/v ``[8, 512, 16, 64]``, non-causal; the library
   backward, SDPA's, covers dq and dk/dv together);
4. model: the ``mini`` Llama loss in bf16 with the kernels as ``attn_fn``
   against the same loss with the plain ``causal_attention``;
5. train: the ``1b`` Llama at full width and depth, data-parallel through
   ``DistributedOptimizer`` on a one-rank NCCL group, AdamW, flash attention
   and ``ce_chunks=8``: 2 warm-up, 5 timed and 1 profiled step, with the
   kernels' launch counts;
6. serve: the ``1b`` Llama at full width and depth behind
   ``serve.ServeEngine`` with the default ``ServeConfig`` (8 slots, chunk
   64, prefix cache and speculative decoding on): 16 requests submitted at
   once, half sharing a 256-token prefix, 64 new tokens each, timed in
   bf16 (TTFT, TPOT, decode tokens/s, tick ms, prefix hits, CoW copies,
   accept rate, peak memory), with none of the attention kernels
   launched; one profiled prefill tick and one decode tick; the decode
   forward's time at the static tick width against narrower ones; every
   emitted token held against one full bf16 forward over prompt + output
   (its logit within 0.1 of the position's maximum); and, in fp32, four
   requests whose tokens must equal greedy through the full forward;
7. eager: Horovod's eager torch API (``horovod_tpu_torch.torch``) with
   ``HOROVOD_CONTROLLER=tcp`` on a free port, so the port's native
   controller (built with g++ beside the kernels, from
   ``horovod_tpu_torch/csrc/core``) negotiates every op: each eager op on
   bf16 and fp32 tensors against its plain result (allreduce with every
   op and with scale factors, grouped, allgather, broadcast, alltoall
   with splits, reducescatter, async handles and in-place variants), then
   the ``1b`` Llama for 5 steps (1 warm-up, 4 timed) and one profiled
   step through the hook-driven ``DistributedOptimizer(AdamW)`` on phase
   5's weights and batches: each step's loss against phase 5's, the
   controller's responses and fused buckets per step and the host's wait
   for them, step ms and tokens/s beside phase 5's, the profiled step's
   device time against phase 5's, and the kernels' launches in this
   phase;
8. wire: the wire and overlap planes (``ops/wire.py``,
   ``ops/overlap.py``): (a) the ``1b`` model's fp32 gradients (seeded)
   packed into the fusion plan's buckets, each checked bucket's (every
   ``CODEC_BUCKET_STRIDE``-th and the last) int8 codes and scale,
   ``int8_roundtrip``, ``local_error`` of every lossy format and
   bf16/fp16 casts on the card bitwise equal to the CPU's; (b) the ``1b``
   step over k=2 microbatches of 2 x 2048 (phase 5's batches, 4 steps)
   through ``DistributedOptimizer(AdamW, wire_policy="auto",
   error_feedback=True, overlap=True, overlap_depth=1)`` beside the same
   with wire ``none`` and overlap off: at one rank every bucket is
   ``none`` and the sync a copy, so losses and final parameters must be
   bitwise equal; step times, buckets per format, ``wire.stats()`` and
   the kernels' launches;
10. zero: ZeRO and the input pipeline (``parallel/zero.py``, ``data/``):
   ``1b`` with fp32 master weights and bf16 compute, AdamW, 4 steps of
   4 x 2048, phase 5's batches through ``NumpyDataLoader`` and
   ``prefetch`` (each device batch equal to its host array), at levels 1,
   2 and 3 (k=1; bitwise equal losses and final parameters, level 3's
   gathered) and levels 1 and 2 at k=2 (bitwise equal), and level 1
   against ``DistributedOptimizer(AdamW)`` (losses within 1e-4,
   parameters within 1e-6); step ms, peak memory, bytes resident between
   steps beside ``zero_memory_bytes``, and 16 x 4 x k launches per kernel;
11. layout: the 3D layout plane (``parallel/layout.py``) at one rank:
   ``resolve_layout`` of ``1,1,1``, ``dp-only`` and ``auto``, then phase
   10's ``1b`` configuration through ``make_llama_layout_train_step`` at
   layout (1, 1, 1), levels 1 and 3, each bitwise equal (losses and final
   parameters) to phase 10's chain at its level, with step ms beside
   phase 10's;
12. sequence: sequence and expert parallelism and Adasum at one rank:
   ``ring_attention(kernel="flash")`` on a one-rank NCCL group bitwise
   equal to ``flash_attention`` at one ring block's shape of the ``1b``
   model at 32,768 tokens over four ranks (q ``[1, 8192, 32, 64]``, k/v
   ``[1, 8192, 8, 64]``, bf16; output and the three gradients), Ulysses
   equal to ``causal_attention``; each kernel at that shape, causal (the
   diagonal block) and non-causal (a block in the past), against its
   plain version (run one kv-head group at a time) with kernel, plain,
   SDPA and bound times; dq and dk/dv of both blocks fed the global
   ``lse`` and ``delta`` over their union, as the ring's backward feeds
   them; the MoE ``mini`` loss in bf16 with the kernels (head dim 32)
   against the plain attention; Adasum at one rank the identity;
13. launch: phase 5's step started through the port's launcher, ``python
   -m horovod_tpu_torch.runner.launch -np 1 --gpu --coordinator-port P
   --controller-port Q --output-filename DIR --scenario SPEC python3
   chip_smoke.py --launched DIR`` (free ports, the parent's cached memory
   released and ``check_build()`` printed first): the worker trains
   ``1b`` for 3 steps on phase 5's weights and batches, each loss within
   1e-4 of phase 5's (bitwise equality printed), each kernel launched 16
   x 3 times, its step ms beside phase 5's and its start-up on the
   launch's clock; SPEC (``LAUNCH_SCENARIO``) is a scenario whose storm
   lies past the 3 steps: the worker reads it at KV scope ``scenario``
   and regenerates the parent's event digest, its chaos injector holds
   the storm's events as ``to_chaos_spec`` makes them, and the spec's
   rule is in the set at KV scope ``alerts``; then
   ``horovod_tpu_torch.run`` of a one-rank NCCL allreduce of a CUDA
   tensor;
14. fleet: the serving fleet as a user starts it, ``python -m
   horovod_tpu_torch.runner.launch -np 1 --gpu --serve DIR --serve-port P
   --serve-ttl T`` (free ports, the parent's cached memory released),
   over two ``1b`` servables written by ``serve.save_servable`` from
   phase 6's weights, fp32 and bf16; the parent is the client: it waits
   for the fleet's stats key, posts phase 6's 16 requests at once to
   ``/generate`` and reads the ndjson streams.  Each token must arrive
   exactly once and in order, the fp32 streams must equal full-forward
   greedy and all 16 bf16 requests must finish their 64 tokens;
   ``/serve/stats`` must show the router's and the engine's views with a
   prefix hit; ``POST /admin/drain`` must answer the drained ack and the
   launcher exit 0; no attention kernel may launch.  After its streams
   end each fleet's ``GET /metrics`` must be lint-clean, count 16 TTFT
   samples and 16 requests, a prefix hit, and decode tokens equal to the
   tokens the client read less one a request (a request's first token
   comes off its last prefill chunk and, as in the JAX engine, counts
   under neither phase); the fp32 fleet traces (``--timeline-filename``)
   and its ``GET /timeline`` must hold the ROUTE, PREFILL and DECODE
   spans of every request; the memory plane's ``kv_pool`` plane
   (``hvd_mem_plane_bytes``) must equal the engine's ``kv_pool()``
   ``pool_bytes`` in ``/serve/stats``, and ``launch doctor --serve URL``
   and ``doctor --request RID URL`` must render the live fleet and exit
   0.  Printed: TTFT
   p50/p99, TPOT p50 and decode tokens/s as the client measured them
   over HTTP beside phase 6's in-process figures, and the fleet's first
   ready seconds on the launch's clock;
15. measure: the measurement plane as a user starts it, ``python -m
   horovod_tpu_torch.runner.launch -np 1 --gpu --timeline-filename F
   --timeline-mark-cycles --autotune --autotune-log-file L
   --autotune-warmup-samples 1 --autotune-steps-per-sample 2
   --metrics-port P python3 chip_smoke.py --measured DIR`` with
   ``HOROVOD_CONTROLLER=tcp`` and ``HOROVOD_PERF=1`` (free ports): (a)
   phase 7's hook-driven
   ``1b`` step for phase 5's 8 steps on its weights and batches, each
   loss within 1e-4 of phase 5's; the trace file loads, every gradient
   bucket's name has NEGOTIATE, QUEUE and an EXEC span of positive width
   (measured on the card by the start and done events of its collective)
   in that order at every step; cycle marks and the native core's spans
   are on it, and the native tuner moved off its start; (b) phase 5's
   direct ``DistributedOptimizer`` step under
   ``hvd.autotuner().measure(nbytes=...)``: the tuned threshold takes at
   least two values, each in the autotune log, the fused sync re-plans
   for each, and every loss is within 1e-4 of phase 5's (bitwise
   equality printed: at one rank the sync is a copy).  While the worker
   waits the parent reads ``GET /metrics``: lint-clean, a ``rank="0"``
   and a ``rank="driver"`` series, controller cycles above 0, the
   ``hvd_perf_*`` and ``hvd_mem_*`` families; and ``GET /perf`` (rank 0's
   report of the steps, each in ``hvd.perf.timed_step()``) and ``launch
   doctor --perf URL``, which must exit 0 with the verdict.  Printed:
   each path's step ms with the plane beside phase 7's and phase 5's
   without it, the ratio (the plane's cost), and the kernels' launches
   (16 a step each, both paths);
16. perf: the perf plane on phase 5's step, in process: phase 5's model,
   optimizer and 8 batches, the batches as host arrays through
   ``hvd.prefetch``, each step in ``hvd.perf.timed_step()`` with the
   ledger priced on 6N FLOPs a token and the chip it resolves (``h100``
   required): losses bitwise phase 5's, each row's four components
   summing to its step (within 1e-12 s), host input on some step, the
   ledger's mean step over steps 3-8 (the ledger is reset after the 2
   warm-up steps, as phase 5's timing leaves them out) within 10% of
   phase 5's; a memory sample of source
   ``device`` whose bytes in use and peak equal
   ``torch.cuda.memory_allocated``/``max_memory_allocated`` read at the
   same point and whose cap is the card's total, its planes against
   ``zero_memory_bytes`` at level 0; one more step under
   ``hvd.profiler.trace`` whose Chrome trace holds ``fwd_mma_kernel``,
   ``dq_mma_kernel`` and ``dkv_mma_kernel`` 16 times each; and
   ``compiled_flops`` of one forward and backward against 6N x tokens and
   against 6N plus attention.  Printed: the rows, the ledger's mean step
   beside phase 5's, the four means, the verdict, the drift ratio;
17. forensics (``phase_forensics``): phase 5's step with its forward and
   backward under ``hvd.sentinel.wrap`` (this rank's gradients before the
   sync, one packed all_reduce), launched with ``launch -np 1 --gpu
   --postmortem DIR --alerts RULES --metrics-port P`` and
   ``HOROVOD_MEM_HIGH_WATERMARK=0.05``: losses within 1e-4 of phase 5's
   (bitwise printed), the step beside phase 5's, ``GET /health`` showing
   the rank's step advance with a ``device`` memory row, the ``.mem``
   dump of the pressure path and the ``.nan`` dump of step 5 (where the
   sentinel is handed a gradient copy holding a NaN) parsed complete,
   ``sentinel-nonfinite`` firing at ``GET /alerts`` with step 5 as its
   context and ``launch doctor --watch --once`` rendering it, the
   kernels' launches; then ``--chaos`` killing rank 0 at step 2 of ``1b``
   cut to 2 layers: postmortem.json names rank 0, ``kill``, and ``launch
   doctor DIR`` prints the root cause; then a SIGABRT while the host
   waits in ``torch.cuda.synchronize``, the recorder armed over Python's
   faulthandler: a complete record with native spans and the chained
   handler's report.  Phase 14's fleets read ``GET /health`` while idle:
   every rank's step must advance;
18. elastic (``phase_elastic``): ``launch --min-np 1 --max-np 1
   --host-discovery-script S --chaos SPEC`` over ``chip_smoke.py --elastic
   DIR`` (S prints ``localhost:1`` and ``127.0.0.1:1``; the spec has a
   ``state_dir``, so its kill fires once): phase 5's ``1b`` step (its
   seed, batches and AdamW, through ``DistributedOptimizer`` and
   ``flash_attention``) for its first 6 steps under ``hvd.elastic.run``
   with a ``TreeState`` in the fast store, committing after every second
   step; the chaos kill after step 4, two steps after the commit of step
   2.  The driver blacklists the first alias and resets; round 1 runs on
   the other, restores the commit of step 2 and trains to step 6.  Every loss of
   both rounds must be bitwise phase 5's at its step, each kernel
   launched 16 times a step in each round, the rank's and the launcher's
   exits 0 after one reset; before it, the store's filesystem must have
   room for its commits, and the store is deleted after it.  Printed: the
   bytes a commit writes, each commit's ms, the restore's ms, the seconds
   from the kill to the launcher's reset and from the reset to round 1's
   first finished step (with the new process's start-up split);
19. zoo (``phase_zoo``): the model zoo on one rank, each run through
   ``DistributedOptimizer`` on a one-rank NCCL group: (a) ResNet-50,
   ResNet-101, VGG-16 and Inception V3 at the CNN recipe
   (``models/zoo.py``: SGD with momentum 0.9 at lr 0.1, VGG 0.01; 224 px,
   Inception 299; 64 images, VGG 32; weights bf16, BN fp32), 2 warm-up
   and 3 timed steps each (ResNet-50: 2 more timed and 1 profiled, its
   device time split into convolutions, BN and elementwise, and SGD):
   images/s per card, step ms, peak GiB, finite losses that move; (b)
   ResNet-50 in fp32 at 64 px, 8 images, TF32 off: the card's first step
   against the port's on the CPU from the same weights (loss within 1e-4
   relative, BN statistics within 1e-4 of each tensor's largest magnitude,
   each parameter's update within 0.1 of its norm; ``ZOO_UPDATE_TOL``
   says why); (c) BERT-Large, 8 x 512, bf16, Adam, with
   ``flash_attention(causal=False)`` as ``attn_fn``: its loss against the
   plain attention's on one batch (2e-2), then 2 warm-up, 3 timed and 1
   profiled step, tokens/s per card, 24 launches of each kernel a step;
   (d) ``examples/torch_port/pytorch_mnist.py`` launched with ``-np 1
   --gpu`` must exit 0 having learned;
20. scenario and tune (``phase_scenario``): (a) the committed
   ``scenarios/storm-under-load.yaml`` (a preemption race of two kills
   merged into one outage, an admission blackout, a completion stall)
   replayed twice by ``ScenarioHarness`` with an ``engine_factory`` that
   builds ``ServeEngine`` over ``1b`` at full width and depth in bf16
   (phase 6's weights, made once and kept on the card, so a kill
   window's rebuild is an engine, not a load) with the spec's
   ``engine_config`` mapped as ``make_engine_factory`` maps it: the
   event digest equal to the CPU's virtual replay's, the two runs'
   ``rows_jsonl`` byte-identical, ``scenario-engine-down`` fired, every
   request finished with its tokens, each redriven request's regenerated
   stream holding the tokens delivered before the kill (printed), the
   memory after the rebuild within the pool's size of the first build's,
   and no attention kernel launched; printed: the rows, TTFT/TPOT
   percentiles in ticks, the storms' recovery, each replay's wall seconds,
   ms a tick and peak memory; (b) ``tune.run`` with ``grid_search`` over
   ``TUNE_LRS``, each trial 3 steps of phase 5's step from phase 5's
   weights and batches: the 3e-4 trial's losses bitwise phase 5's first
   three, ``best_config`` the lower loss, 16 launches a kernel a step,
   the memory back to its level after each trial; a ``loguniform`` run of
   3 trials on ``mini`` through the native GP; one
   ``distributed_trainable(num_proc=1)`` trial on ``mini`` over NCCL whose
   ``tune.report`` reaches the driver; (c) ``probe_backend()`` returns
   ``''``, and a reason with the cards hidden from its child; the
   phase's seconds;
21. cluster (``phase_cluster``): phase 5's ``1b`` step placed by the
   cluster layer, each task a fresh process (``cluster_task``): (a)
   ``spark.run(num_proc=1)`` through ``LocalTaskExecutor`` and (b)
   ``RayExecutor(num_workers=1)`` on ``LocalWorkerPool``, phase 5's 8
   steps, losses and parameter checksums bitwise phase 5's; (c)
   ``spark.run_elastic`` whose first task dies after step 2: one reset,
   both attempts' losses bitwise phase 5's; (d) ``ElasticRayExecutor``
   over ``FixedHosts(localhost:1)``: one round, the result back through
   the driver's KV; (e) ``hvd.run(np=1)`` and a
   ``tune.distributed_trainable(num_proc=1,
   executor_factory=LocalTaskExecutor)`` trial; (c)-(e) 3 steps, bitwise
   phase 5's; 16 launches a kernel a step in every part; printed: each
   part's wall seconds, its task's start-up on the caller's clock, the
   first step and the median of the rest beside phase 5's, the phase's
   seconds;
22. estimator (``phase_estimator``): the Spark estimator workflow, each
   fit's task a fresh process placed by ``spark.run``: (a) the MNIST
   example's configuration (``examples/torch_port/pytorch_spark_mnist.py``:
   4096 x 784, an MLP 784-128-10, Adam at 0.05, batch 128, 4 epochs,
   ``validation=0.2``) through ``TorchEstimator(num_proc=1)``: its holdout
   accuracy above 0.8, the history complete, and a second estimator on the
   same Store at 6 epochs resuming through ``fit_on_parquet``, its first 4
   epochs bitwise the first fit's; (b) ``spark_estimator.py``'s
   ``LinearEstimator`` (``fit(elastic=True)``, then ``fit_on_parquet`` to 5
   epochs), float64 on the card: ``w`` and ``b`` within 1e-10 relative of a
   float64 numpy replay of the same SGD over the rows read back from the
   Store; (c) ``TorchEstimator`` fitting ``1b`` at full width and depth in
   bf16 from phase 5's first 4 batches, written to the Store by
   ``prepare_data`` (``features`` the 2048 input ids, ``label`` the next
   ids, float32): AdamW, batch 4, 2 epochs of 4 steps, the flash kernels
   as ``attn_fn``, 16 launches of each a step, epoch 0's mean loss within
   ``ESTIMATOR_LOSS_TOL`` of phase 5's first 4 steps' mean, the initial
   weights' loss on the Store's first batch within ``ESTIMATOR_FIRST_TOL``
   of phase 5's first loss (the 4 batches' initial losses printed: what a
   wrong batch moves), and the driver's ``EstimatorModel`` loading the envelope onto
   the card and transforming one row to finite logits; printed: each fit's
   wall seconds, its task's model ready on the caller's clock, the first
   step and the median of the rest, the epoch checkpoints' bytes and write
   seconds, the parquet dataset's bytes, the peak GiB;
23. lightning (``phase_lightning``): the Lightning estimator, each fit's
   task a fresh process placed by ``spark.run``: (a) the Lightning MNIST
   example's configuration (``examples/torch_port/lightning_spark_mnist.py``:
   a protocol module with no ``.to``, Adam at 0.05 with ``StepLR`` in the
   dict form, ``StopWhenGoodEnough(0.95)``, a ``JsonlLogger``,
   ``gradient_clip_val=5``, batch 128, 4 epochs, ``validation=0.2``)
   through ``LightningEstimator(num_proc=1)``: its holdout accuracy above
   0.8, the logger's file with the flushed metrics and the ``finalized``
   record, ``val_acc`` in the history, each step's applied gradient norm
   min(its norm, the clip); (b) ``1b`` at full width and depth as a LightningModule (an
   ``nn.Module``: ``configure_optimizers`` AdamW at 3e-4, weight decay 0.01;
   ``training_step`` phase 5's loss, ``ce_chunks=8``, the flash kernels)
   over phase 22 (c)'s Store rows, batch 4, 2 epochs: 16 launches of each
   kernel a step, the initial loss on the Store's first batch within
   ``ESTIMATOR_FIRST_TOL`` of phase 5's first, epoch 0 within
   ``ESTIMATOR_LOSS_TOL`` of phase 5's first 4 steps' mean, ``transform``
   to finite logits on the driver's card; (c) the Keras example through
   ``KerasEstimator`` on keras's torch backend, or, where keras cannot be
   imported, a line saying it was not run; printed: each fit's wall
   seconds, its task's model ready, the first step and the median of the
   rest (beside phase 5's step for (b));
9. printed last, after phase 23: a ``{"kernels": [...]}`` JSON line (the
   rows at the training shape, each with its 8b-shape ``d128``, MoE
   ``mini``-shape ``d32`` and BERT-Large ``bert_large`` numbers, D=128
   resources, its ring-shape ``ring`` numbers and the launches of each
   phase, ``launches_fleet`` the fleets', ``launches_measure`` phase
   15's, ``launches_perf`` phase 16's, ``launches_watch`` phase 17's,
   ``launches_elastic`` phase 18's two rounds', ``launches_zoo`` phase
   19's BERT-Large steps, ``launches_tune`` phase 20's grid trials,
   ``launches_scenario`` its replays, which must be 0, ``launches_cluster``
   phase 21's parts, ``launches_estimator`` phase 22 (c)'s fit,
   ``launches_lightning`` phase 23 (b)'s), then the
   ``{"ok": true, "device": {...}}`` JSON line.

The processes that phases 13-16 and 18-23 start, and those of ``--parts
cluster`` and ``estimator``, write and reuse compiled bytecode under
``build/pycache`` (``keep_bytecode``); phase 17's keep the machine's env.

    python3 chip_smoke.py --ranks 4 [--parts dp,sequence,expert,adasum,serve,measure,perf,postmortem,elastic,zoo,cluster,estimator]

runs, after the device and build phases, the eager path across 4 ranks
(one process and one card each, started by the port's launcher as
``chip_smoke.py --rank-worker <json>``; NCCL, the controller negotiating
over TCP)
instead of phases 3-8: each eager op against an oracle of every rank's
inputs, then the ``1b`` step data-parallel at batch 4 x 2048 per rank,
first through the root package's ``DistributedOptimizer`` (one fused
allreduce per bucket at ``step()``) and then through the eager API's
hook-driven one, on the same weights and batches: losses, step ms,
tokens/s per card, and one profiled step of each on rank 0 (NCCL time,
idle share).  Then one 128 MiB fp32 bucket through the int8 ring under
``torch.cuda.set_sync_debug_mode("error")``, and the wire configurations
(``WIRE_CONFIGS``): ``1b`` with fp32 master weights and bf16 compute, 8
steps of 4 x 2048 per card, under wire ``none``, ``bf16``, ``fp16``,
``int8_ring`` and ``auto`` with error feedback, the pipeline at k=4
(1 x 2048 per card) depth 0 and 1, and, on a second process group laid
out as two hosts of two ranks, hierarchical ``none`` and ``dcn_int8``:
step ms, one profiled step's NCCL time, modeled wire bytes per step,
losses against ``none``'s, and parameters bitwise equal on every rank.
Then ZeRO (``rank_zero``): ``1b`` under ``ZERO_CONFIGS`` (levels 1/2/3,
k=2, level-3 prefetch depths 1 and 2, bf16 wire with error feedback), 8
steps of 4 x 2048 per card from ``NumpyDataLoader`` (``shard_indices``)
through ``prefetch``, bitwise equal across ranks and within each group of
``ZERO_SAME``, losses within 1e-3 of the ``none`` wire configuration's;
``8b`` cut to 2 layers at levels 1 and 3 (bitwise equal); and Llama-3-8B
(32 layers, 8,030,261,248 parameters, bf16) at level 3, 2 warm-up, 4
timed and 1 profiled step of 1 x 2048 per card: step ms, tokens/s per
card, MFU(6N), NCCL ms, peak and resident memory against
``zero_memory_bytes``.  Last, with N = 4, the 3D layouts
(``rank_layout``), on a flat group of their own: (a) ``8b`` cut to 2
layers in fp32 (AdamW eps 1e-3, level 1, 3 steps of 4 x 2048 global)
under (4,1,1), (2,2,1), (2,1,2), (1,2,2) and (1,4,1): losses within 2e-5
and gathered parameters within 1e-4 of (4,1,1)'s, (4,1,1) bitwise equal
to the ZeRO chain, dp peers bitwise equal, (2,2,1) level 3 bitwise equal
to its level 1; (c) FSDP (DTensor) on the same cut model in fp32, mesh
(dp, fsdp, tp) = (1, 2, 2), one SGD step against the plain step (loss
rtol 1e-5, parameters 1e-5); (b) ``8b`` at 32 layers, bf16 with fp32
master shards, level 3, 4 x 2048 global, ``n_micro=4``, under every
layout of (a) that ``layout_memory_bytes`` fits into the free memory and
the one ``HOROVOD_LAYOUT=auto`` picks (priced on the H100 and NVLink):
step ms, tokens/s per card, MFU(6N), NCCL and compute ms, peak memory and
launches beside ``layout_step_time``, ``layout_memory_bytes`` and the
solver's rank, losses within 0.05 of (4,1,1)'s.  All of this is the
``dp`` part.  Then, on a flat group of their own: (d) sequence
parallelism on ``1b`` with max_seq 32,768: the flash ring over one
sequence of 32,768 tokens (8,192 a card), and Ulysses and the plain ring
over 8,192 (where Ulysses' [S, S] scores fit), the model cut to 2 layers
in fp32, each rank's share of the loss and the gradients summed over the
ranks against one card's ``flash_attention`` step over the whole
sequence (loss atol 2e-4 rtol 1e-3, gradients atol 5e-4 rtol 2e-3); then
the flash ring at full depth in bf16, AdamW, ``ce_chunks=8``, gradients
summed, 2 warm-up, 4 timed and 1 profiled step (ranks 0 and 3): step ms,
tokens/s per card, MFU(6N), peak memory, NCCL and compute ms, launches
16 (r + 1) per kernel a step on rank r, the first loss within 0.02 of one
card's no-grad forward over the 32,768 tokens, parameters bitwise equal;
(e) expert parallelism on ``moe_llama`` ``mini`` and ``mixtral-tiny`` in
fp32: the ep = 4 logits, loss and every gradient against the dense path
on one card routed shard by shard (rtol 5e-4 atol 5e-5), then 3 AdamW
steps (losses falling, replicated leaves bitwise equal, step ms); (f)
Adasum: ``spmd.allreduce(op=Adasum)`` on each fp32 bucket of ``1b``'s
seeded gradients against the float64 numpy model (rtol 1e-4 of |model|
plus the largest input at each element) and bitwise equal across ranks,
timed beside ``op=Average``; the ``1b`` step through
``DistributedOptimizer(AdamW, op=Adasum)`` and the eager
``DistributedOptimizer(op=Adasum)`` (parameters bitwise equal, step ms);
and on two hosts of two, ``adasum_hierarchical`` against the numpy model
and the routed ``op=Adasum`` bitwise equal to the flat recursion.
The ``serve`` part is not a rank worker: the parent serves phase 14's
16 requests on one card in process (fp32 ``1b``, held to full-forward
greedy), writes the servable, and starts ``launch -np N --gpu --serve``
with ``HOROVOD_SERVE_PREFILL_RANKS=2`` (ranks 0-1 prefill, the rest
decode; each prompt's KV crosses between cards through ``serve_kv``) as
the client: the streams must equal the one-card tokens byte for byte,
with one handoff per request and every follower's scheduling digest its
sub-fleet rank 0's; it prints the handoff's seconds (p50/p99) and the
bytes a handoff record carries.  Then two replica fleets of N/2 ranks
behind one router (``--replicas 2 --replica-id 0|1``, replica 1 joining
replica 0's router), replica 1 killed once a stream it serves has carried
8 tokens: every stream must still equal the one-card tokens byte for
byte, the router's re-dispatches counted in ``/serve/stats``, replica 0
drained to exit 0.  The ``measure`` part is not a rank worker either:
the parent starts ``launch -np N --gpu --timeline-merge M --autotune
--autotune-warmup-samples 1 --autotune-steps-per-sample 2
--metrics-port P`` over the hook-driven ``1b`` step under
``hvd.autotuner().measure`` (8 steps of 4 x 2048 per card): the merged
trace must have N rank lanes with their clock offsets, the tuned
threshold must be equal on every rank at every step (and move), the
parameters bitwise equal across ranks (checksum allgather), ``GET
/metrics`` lint-clean with N rank labels and the driver's, and the
launcher must print its straggler report.  The ``perf`` part (the parent
again) starts ``launch -np N --gpu --metrics-port P`` with
``HOROVOD_PERF=1`` over ``chip_smoke.py --perfed DIR``: ``1b`` at ZeRO
level 3 (fp32 master shards, bf16 compute, 8 steps of 4 x 2048 a card,
each in ``hvd.perf.timed_step()``), every rank's
``hvd_zero_sharded_bytes`` equal to the plan's exact bytes and, but for
the plan's padding and AdamW's step counts, to ``zero_memory_bytes``'s
split, ``GET /perf`` merging N ranks, ``launch doctor --perf`` rendering
it, and the parameters bitwise equal across ranks.  The ``postmortem``
part (``rank_postmortem``, the parent again) makes one launch an
experiment of ``launch -np N --gpu --postmortem DIR --alerts RULES
--chaos SPEC`` over ``chip_smoke.py --watched DIR``, ``1b`` at 4 x 2048 a
card: (a) a kill of rank 2 (the suspect rank 2, ``kill``, the others
``terminated``), (b) a stall of rank 1 on the hook-driven step (rank 1,
``stall``, its flight record complete with native spans), (c) a 70 ms
stall at ``complete`` (``straggler-suspect`` on rank 1 while the job
runs), (d) (b)'s stall on the direct step (the verdicts printed, not
required), with the seconds from the fault to the launcher's exit and to
each survivor's end (at most 10.5 s); then phase 17's sentinel launch
across the N ranks on the direct (e) and the hook-driven (f) step: the
scalars reduced over the ranks, rank 1's NaN every rank's verdict, the
wrapped step against the same step unwrapped.  The ``elastic`` part
(``rank_elastic``, the parent again) makes one elastic launch an
experiment (``launch --min-np N --max-np N --host-discovery-script S``,
S printing ``localhost:N`` and ``127.0.0.1:N``) over ``chip_smoke.py
--elastic DIR``, ``1b`` at 4 x 2048 a card: (a) an unfaulted launch, then
a chaos kill of rank 2 after step 6, round 1's losses bitwise the
unfaulted launch's and the parameters bitwise equal across ranks
(checksum allgather) and to the unfaulted run's; (b) rank 0 crashing
between the data and the marker of its second commit (``crash_commit``,
``pre_marker``): every rank restores the first commit, none reads the
torn one, commits go on past it, the losses from there bitwise (a)'s
unfaulted ones; (c) elastic serving (``rank_elastic_serve``): ``launch
--serve`` with ``--min-np 2 --max-np 2`` over the fp32 ``1b`` servable
of phase 14, serving phase 14's requests, rank 1 chaos-killed at an engine
tick while tokens stream: every stream byte-identical to one card's
tokens, the journal's redrives counted, ``POST /admin/drain`` ending the
launcher with exit 0.  Printed: commit ms and bytes per rank, restore ms,
the seconds from the fault to the reset and from the reset to the first
step, and from the kill to the first redriven token.  The ``zoo`` part
(``rank_zoo``, on a flat group of its own, after the parent has run
phase 19 (a)'s ResNet-50 on one card as the reference): (a) ResNet-50 at
the recipe, 64 images a card with sync-BN: images/s per card, the
scaling efficiency against the one card, NCCL ms of rank 0's profiled
step, weights and BN statistics bitwise equal on every rank; (b)
ResNet-50 in fp32 at 64 px, 8 a card with sync-BN, TF32 off and cuDNN
deterministic, against one card's plain step over the 8N images on rank
0 (phase 19 (b)'s limits; the BN statistics are the global batch's, so
the ranks' local variances would miss them); (c) BERT-Large under
Ulysses over the 512 positions: the fp32 loss of 2 layers against one
card's over the whole sequence (atol 2e-4, rtol 1e-3), then bf16 at
full depth with Adam, gradients summed: tokens/s per card, parameters
bitwise equal on every rank.  The ``cluster`` part (``rank_cluster``,
the parent again) places phase 5's step over N cards: the dp part's
direct step launched as the reference, then ``spark.run(num_proc=N)``
and ``RayExecutor(num_workers=N)`` (losses bitwise the reference's,
parameters bitwise equal across the ranks and the two placements), then
``spark.run_elastic`` with rank N-1's task killed after step 2, placed
again at N-1 and finished.  The ``estimator`` part (``rank_estimator``,
the parent again) fits across N cards: (a) the MNIST example's
``TorchEstimator`` at ``num_proc=N`` (its holdout check); (b)
``LinearEstimator`` at ``num_proc=N``, ``w_sum`` bitwise equal on every
rank; (c) ``fit(elastic=True)`` with ``HOROVOD_SPARK_FAULT`` killing rank
N-1 after epoch 0: placed again at N-1 tasks, resumed from the epoch-0
envelope, the history complete; (d) the Lightning MNIST example at N
tasks: its holdout check, the synced stop alike on every rank, every
rank's final ``state_dict`` bitwise equal (a checksum allgather), the
logger written by rank 0 only.  ``--parts`` runs a subset (default:
all).

TF32 is off for matrix products and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so fp32 references are fp32.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import math
import os
import pickle
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
KERNEL_SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
# kernel name -> the Pallas kernel it replaces (file:line of its definition)
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:47",
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:113",
    "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:163",
}
# kernel name -> its bf16 D=64 instantiation's mangled-name fragment
INSTANCES = {
    "flash_fwd": "fwd_mma_kernelILi64E",
    "flash_bwd_dq": "dq_mma_kernelILi64E",
    "flash_bwd_dkv": "dkv_mma_kernelILi64E",
}
# the CUDA kernels of flash_attention.cu, bf16 and fp32, by function name
ATTENTION_KERNELS = ("fwd_mma_kernel", "fwd_kernel", "dq_mma_kernel",
                     "dq_kernel", "dkv_mma_kernel", "dkv_kernel")
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
WARMUP_STEPS, TIMED_STEPS = 2, 5
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 64
SERVE_PREFIX, SERVE_TAIL = 256, (64, 768)  # shared prefix, tail lengths
BF16_LOGIT_TOL = 0.1  # the port's bf16 logit tolerance (mini, CPU tests)
# phase 7 against phase 5 on the same weights and batches, step for step:
# the same kernels and products, and a one-rank allreduce that copies, so
# every run so far gave phase 5's losses to the last printed digit (and
# the 4-card --ranks run gave the root optimizer's).  A step that skips or
# misplaces an update moves a loss by more than this, and a parameter by
# about the learning rate (3e-4)
EAGER_LOSS_TOL = 1e-4
EAGER_PARAM_TOL = 1e-6
# the operators a serving tick's device time is booked under
SERVE_OPS = ("aten::linear", "aten::einsum", "aten::index", "aten::index_put_",
             "aten::masked_fill", "aten::_softmax", "aten::argmax")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of ``n`` timed launches, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[n // 2]


def attention_cost(kind: str, B, S, H, HK, D, causal, itemsize):
    """(matrix-product flops, bytes) that one call must do and move: each
    input read once, each output written once; causal counts only the
    (q, k) pairs at or below the diagonal."""
    pairs = S * (S + 1) // 2 if causal else S * S
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[kind]
    flops = 2 * D * products * pairs * B * H
    q_bytes = B * S * H * D * itemsize
    kv_bytes = B * S * HK * D * itemsize
    row_bytes = B * H * S * 4
    if kind == "flash_fwd":   # q, k, v -> out, lse
        nbytes = 2 * q_bytes + 2 * kv_bytes + row_bytes
    elif kind == "flash_bwd_dq":  # q, k, v, dO, lse, delta -> dq
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    else:                     # q, k, v, dO, lse, delta -> dk, dv
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    return flops, nbytes


def bound(kind, shape, causal, dtype):
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops, nbytes = attention_cost(kind, causal=causal, itemsize=itemsize,
                                   **shape)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def parse_ptxas(text: str) -> dict:
    """``{mangled kernel name: {"registers", "spill_bytes"}}`` from the
    ``ptxas info`` lines of ``nvcc -Xptxas -v``; spill bytes are the spill
    stores plus the spill loads."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
    return out


def phase_resources(_kernels, lib_path: str) -> dict:
    """Registers, shared memory, spills and blocks per SM of each kernel's
    bf16 instantiations at D=64 and D=128.  Each is designed for Hopper
    (register accumulators, pipelined loads), so at D=64 it must not spill
    and must fit two or more blocks on an SM; D=128 (the 8b model's head
    dim) and D=32 (the MoE Llama's) are reported.  Returns the D=128
    reports by kernel name."""
    with open(lib_path + ".log") as f:
        ptxas = parse_ptxas(f.read())
    d128 = {}
    for D in (32, 64, 128):
        for name, fragment in INSTANCES.items():
            fragment = fragment.replace("ILi64E", f"ILi{D}E")
            found = [v for k, v in ptxas.items() if fragment in k]
            require(len(found) == 1, f"ptxas output has {len(found)} "
                                     f"entries for {fragment}")
            info = found[0]
            res = _kernels.resources(name, D, True)
            print(f"resources [{name} bf16 D={D}]: {info['registers']} "
                  f"registers, shared memory {res['static_smem']} static + "
                  f"{res['dynamic_smem']} dynamic bytes, spills "
                  f"{info['spill_bytes']} bytes, {res['threads']} threads, "
                  f"{res['blocks_per_sm']} blocks per SM", flush=True)
            if D == 128:
                d128[name] = dict(res, registers=info["registers"],
                                  spill_bytes=info["spill_bytes"])
            if D != 64:
                continue
            require(info["spill_bytes"] == 0, f"{name} spills registers")
            require(res["blocks_per_sm"] >= 2,
                    f"{name} fits {res['blocks_per_sm']} block per SM")
    return d128


def kernel_kind(key: str) -> str:
    """The kind a profiled CUDA kernel's name books its time under."""
    if any(k in key for k in ATTENTION_KERNELS):
        return "flash attention"
    low = key.lower()
    if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "matrix products"
    return "nccl" if "nccl" in low else "other"


def tile_rel_err(got, ref, tile: int = 64) -> float:
    """Worst relative Frobenius error ``|got - ref| / |ref|`` over the
    blocks of ``tile`` sequence positions of one head of one batch entry
    (``[B, S, H, D]`` tensors).  Causal outputs shrink along the sequence,
    so a max error scaled by the largest value (near position 0) would hide
    a tile that is dropped or mis-masked further on; this does not."""
    B, S, H, D = ref.shape
    r = ref.float().reshape(B, S // tile, tile, H, D)
    d = got.float().reshape(B, S // tile, tile, H, D) - r
    return (d.norm(dim=(2, 4)) / r.norm(dim=(2, 4)).clamp_min(1e-30)
            ).max().item()


# Limits against the plain version on the same inputs (which rounds p and
# ds to bf16 as the kernels do): (max abs err / max|ref|, tile_rel_err).
BF16_LIMITS = (1e-2, 1e-2)
FP32_LIMITS = (1e-5, 1e-5)


def check_output(name: str, got, ref, dtype) -> tuple:
    """``(max abs err, tile_rel_err or None, within limits, limits)`` of one
    kernel output against its plain version.  lse is fp32 from fp32 scores
    on both sides, so it is held to an absolute limit."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    if name == "lse":
        tol = 1e-4 if dtype == torch.float32 else 1e-3
        return err, None, err <= tol, f"atol {tol}"
    rel_max, rel_tile = BF16_LIMITS if dtype == torch.bfloat16 else FP32_LIMITS
    tile = tile_rel_err(got, ref)
    ok = err <= rel_max * ref.float().abs().max().item() and tile <= rel_tile
    return err, tile, ok, (f"max abs err <= {rel_max} * max|ref|, "
                           f"tile_rel_err <= {rel_tile}")


def check_case(heading: str, label: str, outputs, dtype) -> dict:
    """Each ``(name, got, ref)`` of one case held to the limits above;
    prints one line under ``heading`` and returns the max abs errors by
    name."""
    errs, failed, readings = {}, [], []
    for name, got, ref in outputs:
        err, tile, ok, tol = check_output(name, got, ref, dtype)
        errs[name] = err
        scale = ref.float().abs().max().item()
        readings.append(f"{name} {err:.3g} ({err / scale:.2e} of max|ref|"
                        + (f", tile {tile:.2e})" if tile is not None
                           else ")"))
        if not ok:
            failed.append(f"{name} ({tol})")
    print(f"{heading}: max abs err " + ", ".join(readings), flush=True)
    require(not failed, f"kernels disagree with their plain versions "
                        f"[{label}]: {', '.join(failed)}")
    return errs


# the cases of phase 3 that are timed, and the key of the kernels line's
# rows their numbers go under ("train" is the rows' own): D=128 at the 8b
# shape, D=32 at the shape phase 12 runs the MoE mini loss at, and phase
# 19's BERT-Large (non-causal, MHA, S=512, D=64)
TIMED_CASES = {"train": None, "8b D=128": "d128", "MoE mini D=32": "d32",
               "BERT-Large": "bert_large"}


def phase_kernels(F, torch, card: str):
    """Each kernel against its plain version; returns the kernels' rows at
    the training shape."""
    cases = [  # (label, B, S, H, HK, D, dtype, causal)
        ("train", 4, 2048, 32, 8, 64, torch.bfloat16, True),
        ("8b D=128", 1, 2048, 32, 8, 128, torch.bfloat16, True),
        ("D=128", 2, 1024, 16, 4, 128, torch.bfloat16, True),
        ("non-causal", 2, 1024, 32, 8, 64, torch.bfloat16, False),
        ("H=HK", 2, 1024, 8, 8, 64, torch.bfloat16, True),
        ("GQA group 8", 2, 1024, 32, 4, 64, torch.bfloat16, True),
        ("S=192", 2, 192, 8, 2, 64, torch.bfloat16, True),
        ("S=320", 1, 320, 8, 4, 64, torch.bfloat16, True),
        ("S=192 D=128 non-causal", 1, 192, 4, 2, 128, torch.bfloat16,
         False),
        ("fp32", 2, 256, 8, 2, 64, torch.float32, True),
        ("fp32 D=128 non-causal", 1, 256, 4, 2, 128, torch.float32, False),
        ("MoE mini D=32", 2, 256, 8, 4, 32, torch.bfloat16, True),
        ("D=32 non-causal", 1, 512, 8, 2, 32, torch.bfloat16, False),
        ("fp32 D=32", 1, 256, 8, 4, 32, torch.float32, True),
        ("BERT-Large", BERT_BATCH, BERT_SEQ, 16, 16, 64, torch.bfloat16,
         False),
    ]
    rows = {}
    for label, B, S, H, HK, D, dtype, causal in cases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        q, k, v, do = mk(B, S, H, D), mk(B, S, HK, D), mk(B, S, HK, D), \
            mk(B, S, H, D)
        out, lse = F.flash_forward_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        dk, dv = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        # references: the plain versions on the same tensors
        r_out, r_lse = F.attention_forward_plain(q, k, v, causal)
        r_dq = F.attention_dq_plain(q, k, v, do, lse, delta, causal)
        r_dk, r_dv = F.attention_dkv_plain(q, k, v, do, lse, delta, causal)
        errs = check_case(
            f"kernels [{label}] B={B} S={S} H={H} HK={HK} D={D} "
            f"{str(dtype)[6:]} causal={causal}", label,
            (("out", out, r_out), ("lse", lse, r_lse), ("dq", dq, r_dq),
             ("dk", dk, r_dk), ("dv", dv, r_dv)), dtype)
        if label not in TIMED_CASES:
            continue
        shape = dict(B=B, S=S, H=H, HK=HK, D=D)
        timed = kernel_rows(F, torch, card, label, q, k, v, do, lse, delta,
                            causal, errs, shape, dtype)
        if label != "train":  # the 8b path's, the MoE Llama's, BERT's
            for name, r in timed.items():
                rows[name][TIMED_CASES[label]] = {key: r[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")}
            del q, k, v, do, out, lse, delta, dq, dk, dv
            continue
        rows.update(timed)
        dq2 = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        dk2, dv2 = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        require(torch.equal(dq, dq2),
                "dq differs between two launches on the same inputs")
        require(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                "dk/dv differ between two launches on the same inputs")
        print("kernels [train]: dq and dk/dv bitwise equal across two "
              "launches", flush=True)
        del dq2, dk2, dv2, q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows


def kernel_rows(F, torch, card, label, q, k, v, do, lse, delta, causal,
                errs, shape, dtype) -> dict:
    """Kernel, plain and library times and the bound of each kernel on one
    case's tensors, printed; the kernels JSON line's rows."""
    calls = {
        "flash_fwd": (lambda: F.flash_forward_cuda(q, k, v, causal),
                      lambda: F.attention_forward_plain(q, k, v, causal),
                      max(errs["out"], errs["lse"])),
        "flash_bwd_dq": (
            lambda: F.flash_dq_cuda(q, k, v, do, lse, delta, causal),
            lambda: F.attention_dq_plain(q, k, v, do, lse, delta, causal),
            errs["dq"]),
        "flash_bwd_dkv": (
            lambda: F.flash_dkv_cuda(q, k, v, do, lse, delta, causal),
            lambda: F.attention_dkv_plain(q, k, v, do, lse, delta, causal),
            max(errs["dk"], errs["dv"])),
    }
    rows = {}
    for name, (kernel, plain, err) in calls.items():
        b_ms, b_by = bound(name, shape, causal, dtype)
        rows[name] = {"name": name, "route": "cuda",
                      "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                      "max_abs_err": err, "ms": median_ms(kernel),
                      "plain_ms": median_ms(plain), "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None,
                      "shape": dict(shape, causal=causal)}
    # yardsticks only: one PyTorch call computing the forward, and the
    # same call's backward (dq, dk and dv together) on an output made
    # once, outside the timed region
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows["flash_fwd"]["library_ms"] = median_ms(
        lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True))
    lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    dkv = rows["flash_bwd_dkv"]
    dkv["library_ms"] = median_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    dkv["library_covers"] = "dq+dkv"
    dkv["kernel_sum_ms"] = rows["flash_bwd_dq"]["ms"] + dkv["ms"]
    for r in rows.values():
        lib = r["library_ms"]
        vs = (f"library {lib:.4f} ms, kernel/library {r['ms'] / lib:.3f}"
              if lib is not None else "library none")
        if "library_covers" in r:
            vs = (f"library dq+dkv {lib:.4f} ms, kernels dq+dkv "
                  f"{r['kernel_sum_ms']:.4f} ms, kernel/library "
                  f"{r['kernel_sum_ms'] / lib:.3f}")
        print(f"kernel {r['name']} [{label}] [{card}]: kernel_ms "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it), " + vs, flush=True)
    return rows


def phase_model(torch, hvd, llama, L):
    """mini Llama loss with the kernels against the plain attention."""
    cfg = llama.CONFIGS["mini"]
    model = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    ids = torch.randint(0, cfg.vocab, (2, 257), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        flash = llama.loss_fn(model, ids, attn_fn=hvd.flash_attention).item()
        plain = llama.loss_fn(model, ids, attn_fn=L.causal_attention).item()
    print(f"model [mini bf16]: loss with kernels {flash:.6f}, with plain "
          f"attention {plain:.6f}", flush=True)
    require(math.isfinite(flash) and abs(flash - plain) <= 2e-2,
            f"mini loss with kernels {flash} vs plain {plain} (tol 2e-2)")


def phase_train(torch, np, hvd, llama, F):
    """The main path: 1b data-parallel training steps."""
    hvd.init()
    cfg = llama.CONFIGS["1b"]
    dev = torch.device("cuda", hvd.local_rank())
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == llama.param_count(cfg),
            f"1b has {n_params} parameters, param_count says "
            f"{llama.param_count(cfg)}")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    remat = False
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            remat=remat, ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    n_steps = WARMUP_STEPS + TIMED_STEPS + 1
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH * hvd.size(), TRAIN_SEQ + 1),
        dtype=np.int32)).to(dev) for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    F.reset_launches()
    losses = [step(b) for b in batches[:WARMUP_STEPS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]:
        losses.append(step(b))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        losses.append(step(batches[-1]))
        torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)

    losses = [float(x) for x in losses]
    print("train [1b] losses " + " ".join(f"{x:.5f}" for x in losses),
          flush=True)
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    timed = losses[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]
    require(max(timed) - min(timed) > 0.0,
            "loss constant across steps: parameters not updating")
    per_step = {"flash_fwd": (2 if remat else 1) * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}
    for name, n in per_step.items():
        require(launches[name] == n * n_steps,
                f"{name} launched {launches[name]} times in {n_steps} steps,"
                f" expected {n} per step")

    tokens = TIMED_STEPS * TRAIN_BATCH * hvd.size() * TRAIN_SEQ
    tok_s = tokens / dt
    mfu = 6 * n_params * tok_s / (PEAK_BF16_FLOPS * hvd.size())
    print(f"train [1b] {n_params} params, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, remat={remat}: step {dt / TIMED_STEPS * 1e3:.1f} ms, "
          f"{tok_s:.0f} tokens/s, MFU(6N) {mfu:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("train [1b] launches " + json.dumps(launches), flush=True)

    step_ms = dt / TIMED_STEPS * 1e3
    busy = report_profile(prof, "train [1b]", step_ms)
    # kept on the host, so later phases' peak memory does not count them
    params = [p.detach().cpu() for p in model.parameters()]
    hvd.shutdown()
    return launches, losses, step_ms, tok_s, busy, params


def report_profile(prof, label: str, step_ms: float) -> float:
    """Print where a profiled step's device time goes, CUDA kernels by
    kind and per attention kernel, with the idle share against the timed
    step; return the device busy ms."""
    from torch.autograd import DeviceType
    kinds = {"flash attention": 0.0, "matrix products": 0.0, "nccl": 0.0,
             "other": 0.0}
    top, attention = [], []
    for evt in prof.key_averages():
        # CUDA kernels only: record_function ranges (the optimizer's step)
        # also show on the device timeline, as user annotations
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = evt.self_device_time_total
        kind = kernel_kind(evt.key)
        kinds[kind] += us
        top.append((us, evt.count, evt.key))
        if kind == "flash attention":
            fn = next(k for k in ATTENTION_KERNELS if k in evt.key)
            attention.append(f"{fn} {us / 1e3:.2f} ms x{evt.count}")
    busy = sum(kinds.values())
    require(busy > 0, f"{label}: the profiled step shows no device time")
    print(f"{label} profiled step: device busy {busy / 1e3:.1f} ms "
          f"(timed step {step_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / 1e3 / step_ms):.3f}); by kind: "
          + ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in kinds.items()), flush=True)
    print(f"{label} profiled step, flash attention by kernel: "
          + ", ".join(sorted(attention)), flush=True)
    for us, count, key in sorted(top, reverse=True)[:10]:
        print(f"  {us / 1e3:8.2f} ms x{count:<4} {key[:90]}", flush=True)
    # the host's CUDA runtime calls: a synchronizing one (a stream or
    # device synchronize, an allocation) stalls the host's run-ahead
    api = sorted(((evt.cpu_time_total, evt.count, evt.key)
                  for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CPU
                  and evt.key.startswith("cuda")), reverse=True)
    print(f"{label} profiled step, host CUDA runtime calls: "
          + ", ".join(f"{key} {us / 1e3:.2f} ms x{count}"
                      for us, count, key in api[:8]), flush=True)
    return busy / 1e3



def serve_traffic(rng, vocab: int) -> list:
    """Prompts of the timed serving run: every other one opens with the
    shared system prefix; tails of SERVE_TAIL tokens."""
    system = rng.randint(0, vocab, SERVE_PREFIX).tolist()
    prompts = []
    for i in range(SERVE_REQUESTS):
        tail = rng.randint(0, vocab, rng.randint(SERVE_TAIL[0],
                                                 SERVE_TAIL[1] + 1)).tolist()
        prompts.append(system + tail if i % 2 == 0 else tail)
    return prompts


def logit_gaps(torch, model, prompt: list, out: list) -> tuple:
    """One full forward over prompt + output: at each emitted position, the
    gap between the largest logit and the emitted token's, and whether the
    emitted token is the forward's argmax."""
    dev = model.embed.table.device
    with torch.no_grad():
        ids = torch.tensor([prompt + out[:-1]], device=dev)
        h = model(ids, return_hidden=True)[0, len(prompt) - 1:]
        logits = model.lm_head(h).float()
    tok = torch.tensor(out, device=dev)
    gaps = logits.max(-1).values - logits.gather(1, tok[:, None])[:, 0]
    return gaps.max().item(), (logits.argmax(-1) == tok).sum().item()


def device_profile(torch, fn, label: str, top: int = 8) -> float:
    """Profile one call of ``fn`` between two synchronizations (for an
    engine step, the window holds exactly the tick it dispatches): prints
    its device time by operator, its kernel launches, the window's host
    time and its longest kernels; returns the device busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    ops, kernels = {}, []
    for evt in prof.key_averages():
        if evt.key in SERVE_OPS:
            ops[evt.key] = evt.device_time_total / 1e3
        if (evt.device_type == DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((evt.self_device_time_total / 1e3, evt.count,
                            evt.key))
    busy = sum(k[0] for k in kernels)
    require(busy > 0, f"the profiled {label} shows no device time")
    rest = busy - sum(ops.values())
    print(f"serve [1b] profiled {label}: device busy {busy:.3f} ms in "
          f"{sum(k[1] for k in kernels)} kernels, window {host_ms:.3f} ms "
          "on the host clock; by operator: "
          + ", ".join(f"{k[6:]} {v:.3f} ms" for k, v in
                      sorted(ops.items(), key=lambda x: -x[1]))
          + f", rest {rest:.3f} ms", flush=True)
    for ms, count, key in sorted(kernels, reverse=True)[:top]:
        print(f"  {ms:8.3f} ms x{count:<4} {key[:90]}", flush=True)
    return busy


def phase_serve(torch, np, hvd, llama, serve, F, card: str) -> dict:
    """The serving path: 1b behind ServeEngine, timed in bf16, its tokens
    held against the full forward, and exact in fp32.  Returns the timed
    run's TTFT/TPOT/tokens-per-second figures for phase 14."""
    import dataclasses
    hvd.init()
    dev = torch.device("cuda", hvd.local_rank())
    cfg = llama.CONFIGS["1b"]
    scfg = serve.ServeConfig()
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
    # warm-up: one short request on its own engine (cuBLAS handles, the
    # caching allocator), closed before the timed run
    warm = serve.ServeEngine(model, scfg)
    warm.submit(list(range(1, 97)), 4)
    warm.flush()
    warm.close()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    prompts = serve_traffic(np.random.RandomState(0), cfg.vocab)
    engine = serve.ServeEngine(model, scfg)
    F.reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, SERVE_NEW_TOKENS, req_id=f"r{i}")
            for i, p in enumerate(prompts)]
    tick_ms = []
    while engine.has_work():
        t = time.perf_counter()
        engine.step()
        tick_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_ticks = engine.tick
    launches = dict(F.LAUNCHES)
    print(f"serve [1b] attention-kernel launches {json.dumps(launches)}",
          flush=True)
    require(not any(launches.values()),
            "the serving path launched a flash-attention kernel")
    require(all(r.state == "done" and len(r.out_tokens) == SERVE_NEW_TOKENS
                for r in reqs), "a request did not finish its 64 tokens")
    st = engine.stats()
    ttft = [r.ttft() * 1e3 for r in reqs]
    tpot = [r.tpot() * 1e3 for r in reqs]
    pc, spec = st["prefix_cache"], st["spec"]
    print(card, flush=True)
    print(f"serve [1b bf16] {len(reqs)} requests, {engine_ticks} ticks in "
          f"{wall:.3f} s: prefill {st['tokens_prefill']} tokens in "
          f"{st['prefill_chunks']} chunks, decode {st['tokens_decode']} "
          f"tokens; TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 "
          f"{np.percentile(ttft, 99):.1f} ms; TPOT p50 "
          f"{np.percentile(tpot, 50):.2f} ms; decode "
          f"{st['tokens_decode'] / wall:.1f} tokens/s; median tick "
          f"{np.median(tick_ms):.2f} ms; prefix hits {pc['hits']} "
          f"({pc['hit_tokens']} tokens), CoW copies {pc['cow_copies']}; spec "
          f"drafted {spec['drafted_tokens']}, accepted "
          f"{spec['accepted_tokens']}, accept rate {spec['accept_rate']}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    require(pc["hits"] >= 1 and st["prefill_chunks"] > len(reqs),
            "the timed run saw no prefix hit or no chunked prefill")
    figures = {"ttft_p50": float(np.percentile(ttft, 50)),
               "ttft_p99": float(np.percentile(ttft, 99)),
               "tpot_p50": float(np.percentile(tpot, 50)),
               "tok_s": st["tokens_decode"] / wall}
    S = scfg.max_slots

    rng = np.random.RandomState(2)
    for p in (rng.randint(0, cfg.vocab, 64).tolist() for _ in range(S)):
        engine.submit(p, 8)
    device_profile(torch, engine.step, "prefill tick (8 x 64 tokens)")
    engine.step()
    engine.step()
    busy = device_profile(torch, engine.step, "decode tick (8 slots)")
    engine.flush()
    print(f"serve [1b bf16] {card}: every tick has the static shape, so the "
          f"timed run kept the card busy about {engine_ticks} x {busy:.3f} "
          f"ms of its {wall * 1e3:.1f} ms: idle share about "
          f"{max(0.0, 1 - engine_ticks * busy / (wall * 1e3)):.3f}",
          flush=True)

    # what the static [max_slots, prefill_chunk] tick costs decode: the
    # forward alone at the tick's width and at narrower ones (n_new = 0,
    # so every write lands in the trash block): between CUDA events, the
    # host's time to enqueue it, and the device's busy time
    bt = torch.arange(S * scfg.max_blocks_per_seq, dtype=torch.int32,
                      device=dev).view(S, -1)
    zeros = torch.zeros(S, dtype=torch.int32, device=dev)
    for width in (scfg.prefill_chunk, 1 + scfg.spec_k, 1):
        toks = torch.zeros((S, width), dtype=torch.int32, device=dev)
        fwd = lambda: model.apply_cached(toks, engine.cache, bt, zeros, zeros)
        ms = median_ms(fwd, n=10, warmup=2)
        enqueue = []
        for _ in range(5):
            t = time.perf_counter()
            fwd()
            enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        busy = device_profile(torch, fwd, f"forward at width {width}",
                              top=0)
        print(f"serve [1b bf16] {card}: forward over {S} slots at width "
              f"{width}: {ms:.3f} ms between CUDA events, host enqueue "
              f"{np.median(enqueue):.3f} ms, device busy {busy:.3f} ms",
              flush=True)

    worst, agree, total = 0.0, 0, 0
    for p, r in zip(prompts, reqs):
        gap, same = logit_gaps(torch, model, p, r.out_tokens)
        worst, agree, total = max(worst, gap), agree + same, \
            total + len(r.out_tokens)
    print(f"serve [1b bf16] plausibility: largest gap between an emitted "
          f"token's logit and its position's maximum {worst:.4f} (limit "
          f"{BF16_LOGIT_TOL}); full-forward argmax agrees at {agree} of "
          f"{total} positions", flush=True)
    require(worst <= BF16_LOGIT_TOL,
            f"an emitted token's logit is {worst} below its position's max")
    engine.close()
    del engine, model, reqs
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = llama.init(cfg32, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(1)
    shared = rng.randint(0, cfg.vocab, 64).tolist()
    prompts = [shared + rng.randint(0, cfg.vocab,
                                    rng.randint(64, 193)).tolist()
               for _ in range(2)]
    prompts += [rng.randint(0, cfg.vocab, rng.randint(128, 257)).tolist()
                for _ in range(2)]
    engine = serve.ServeEngine(model, scfg)
    reqs = [engine.submit(p, 16, req_id=f"x{i}") for i, p in
            enumerate(prompts)]
    engine.flush()
    same = 0
    for p, r in zip(prompts, reqs):
        ids = list(p)
        with torch.no_grad():
            for _ in range(16):
                h = model(torch.tensor([ids], device=dev),
                          return_hidden=True)
                ids.append(int(model.lm_head(h[0, -1]).argmax()))
        same += ids[len(p):] == r.out_tokens
    st = engine.stats()
    print(f"serve [1b fp32] exactness: {same} of {len(reqs)} requests "
          f"byte-identical to full-forward greedy over 16 tokens (prefix "
          f"hits {st['prefix_cache']['hits']}, spec drafted "
          f"{st['spec']['drafted_tokens']}, accepted "
          f"{st['spec']['accepted_tokens']})", flush=True)
    require(same == len(reqs), "fp32 engine tokens differ from greedy")
    engine.close()
    del engine, model
    torch.cuda.empty_cache()
    hvd.shutdown()
    return figures


@contextlib.contextmanager
def keep_bytecode(on: bool = True):
    """Within, with ``on``: the processes started from here write and
    reuse compiled bytecode under ``build/pycache``.  The card's machine
    sets ``PYTHONDONTWRITEBYTECODE=1`` and ships no ``.pyc``, so each
    fresh process compiled torch from source: ``import torch`` and
    ``import torch._dynamo`` (which the first ``AdamW.step`` runs) took
    22.6-23.5 s a process there, and 10.5-12.4 s once a first process had
    written the cache (``scripts/torch_import_probe.py`` on the H100's
    machine).  Phases 13-16 and 18-23, ``--parts cluster`` and
    ``estimator`` start fresh processes under it; phase 17 keeps the
    machine's env (with the reuse on there, a rank once took 11.3 s of its
    10 s to exit after a failure)."""
    keys = ("PYTHONDONTWRITEBYTECODE", "PYTHONPYCACHEPREFIX")
    saved = {k: os.environ.get(k) for k in keys}
    if on:
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, whole or not at all: a reader that
    polls for the file never finds it half written."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def free_port() -> int:
    """A free port below the kernel's ephemeral range, which it hands to
    outgoing connections: released here, a probed port stays free until
    the listener it is meant for binds it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            high = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        high = 32768
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(20000, max(high, 21000))
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def eager_op_checks(torch, ht, dev) -> None:
    """Each eager op on bf16 and fp32 tensors on the card against its plain
    result.  One rank: every result is the input, scaled by powers of two,
    so each must be exact."""
    gen = torch.Generator(device=dev).manual_seed(3)
    n_checks, worst = 0, 0.0
    for dtype, shape in ((torch.bfloat16, (8192, 1024)),
                         (torch.float32, (4096, 1024))):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        cases = {f"allreduce {op.name}": (ht.allreduce(x, op=op), x)
                 for op in (ht.Average, ht.Sum, ht.Min, ht.Max, ht.Product)}
        cases["allreduce scaled"] = (ht.allreduce(
            x, op=ht.Sum, prescale_factor=4.0, postscale_factor=0.125),
            x * 0.5)
        grouped = ht.grouped_allreduce([x, x[:77].float(), x[5]],
                                       op=ht.Average)
        cases["grouped_allreduce"] = (torch.cat(
            [grouped[0].flatten().float(), grouped[1].flatten(),
             grouped[2].flatten().float()]), torch.cat(
            [x.flatten().float(), x[:77].flatten().float(),
             x[5].flatten().float()]))
        cases["allgather"] = (ht.allgather(x), x)
        cases["broadcast"] = (ht.broadcast(x, root_rank=0), x)
        out, recv = ht.alltoall(x, torch.tensor([shape[0]]))
        require(recv.tolist() == [shape[0]], f"alltoall splits {recv}")
        cases["alltoall splits"] = (out, x)
        cases["reducescatter"] = (ht.reducescatter(x, op=ht.Sum), x)
        handles = [ht.allreduce_async(x * (i + 1), op=ht.Sum,
                                      name=f"smoke.async.{dtype}.{i}")
                   for i in range(4)]
        require(all(isinstance(ht.poll(h), bool) for h in handles),
                "poll did not answer")
        for i, h in enumerate(handles):
            cases[f"allreduce_async {i}"] = (ht.synchronize(h), x * (i + 1))
        y = x.clone()
        require(ht.allreduce_(y, op=ht.Sum, prescale_factor=2.0) is y,
                "allreduce_ did not return its input")
        cases["allreduce_"] = (y, x * 2)
        z = x.clone()
        ht.synchronize(ht.broadcast_async_(z, root_rank=0))
        cases["broadcast_async_"] = (z, x)
        g = [x.clone(), x[:9].clone()]
        ht.grouped_allreduce_(g, op=ht.Sum, postscale_factor=2.0)
        cases["grouped_allreduce_"] = (torch.cat([g[0].flatten(),
                                                  g[1].flatten()]),
                                       torch.cat([x.flatten(),
                                                  x[:9].flatten()]) * 2)
        for name, (got, want) in cases.items():
            require(got.dtype == want.dtype and got.device == want.device
                    and got.shape == want.shape,
                    f"eager {name} {dtype}: {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            n_checks += 1
            require(err == 0.0, f"eager {name} {dtype}: max abs err {err}")
    ht.barrier()
    print(f"eager ops: {n_checks} checks on bf16 and fp32 tensors on the "
          f"card, every result exact (max abs err {worst})", flush=True)


def max_param_diff(params, ref_params) -> float:
    """The largest elementwise difference between two parameter lists (the
    second may lie on another device)."""
    return max((a.detach().float() - b.to(a.device).float()).abs().max()
               .item() for a, b in zip(params, ref_params))


def phase_eager(torch, np, hvd, llama, F, card: str, ref_losses,
                ref_step_ms: float, ref_tok_s: float, ref_busy: float,
                ref_params) -> dict:
    """Horovod's eager torch API, negotiated through the native controller
    on the card; the 1b step through the hook-driven optimizer."""
    os.environ.update(HOROVOD_CONTROLLER="tcp",
                      HOROVOD_CONTROLLER_PORT=str(free_port()))
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.torch import mpi_ops
    ht.init()
    require(mpi_ops.engine().core is not None,
            "no native controller under HOROVOD_CONTROLLER=tcp")
    dev = torch.device("cuda", ht.local_rank())
    eager_op_checks(torch, ht, dev)

    cfg = llama.CONFIGS["1b"]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = ht.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    ht.broadcast_parameters(model.state_dict(), root_rank=0)
    ht.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            ce_chunks=8), opt)
    rng = np.random.RandomState(0)  # phase 5's batches and steps
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)).to(dev)
        for _ in range(WARMUP_STEPS + TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    F.reset_launches()
    losses, per_step = [], []
    # warm-up, timed and profiled steps, as in phase 5
    for i, b in enumerate(batches[:-1]):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = mpi_ops.stats()
        losses.append(step(b))
        after = mpi_ops.stats()
        per_step.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        losses.append(step(batches[-1]))
        torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    launches = dict(F.LAUNCHES)
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    param_err = max_param_diff(list(model.parameters()), ref_params)
    print("eager [1b] losses " + " ".join(f"{x:.5f}" for x in losses)
          + "; phase 5 " + " ".join(f"{x:.5f}" for x in ref_losses)
          + f"; max |loss diff| {loss_err!r} (tol {EAGER_LOSS_TOL}), "
          f"max |parameter diff| after step {len(losses)} {param_err!r} "
          f"(tol {EAGER_PARAM_TOL})", flush=True)
    require(len(losses) == len(ref_losses)
            and all(math.isfinite(x) for x in losses)
            and loss_err <= EAGER_LOSS_TOL,
            f"eager losses {losses} vs phase 5's {ref_losses} "
            f"(tol {EAGER_LOSS_TOL})")
    require(param_err <= EAGER_PARAM_TOL,
            f"eager parameters differ from phase 5's by {param_err} after "
            f"{len(losses)} steps (tol {EAGER_PARAM_TOL})")
    print("eager [1b] per step: " + "; ".join(
        f"{p['responses']} responses, {p['names']} names, "
        f"{p['collectives']} collectives, host waited {p['wait_ms']:.2f} ms"
        for p in per_step), flush=True)
    require(all(p["responses"] > 0 for p in per_step),
            "a step made no negotiated collective")
    per = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
           "flash_bwd_dkv": cfg.n_layers}
    for name, n in per.items():
        require(launches[name] == n * len(losses),
                f"{name} launched {launches[name]} times in the eager phase,"
                f" expected {n} per step")
    step_ms = dt / TIMED_STEPS * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"eager [1b] {card}: step {step_ms:.1f} ms, {tok_s:.0f} tokens/s "
          f"(steps {WARMUP_STEPS + 1}-{WARMUP_STEPS + TIMED_STEPS}, host "
          "clock between two synchronizations)"
          f"; phase 5: step {ref_step_ms:.1f} ms, {ref_tok_s:.0f} "
          f"tokens/s; ratio {step_ms / ref_step_ms:.3f}; launches "
          + json.dumps(launches), flush=True)
    busy = report_profile(prof, "eager [1b]", step_ms)
    print(f"eager [1b]: device busy {busy:.1f} ms a step against phase 5's "
          f"{ref_busy:.1f} ms: {busy - ref_busy:+.1f} ms", flush=True)
    del step, opt, model, batches
    torch.cuda.empty_cache()
    ht.shutdown()
    return launches, step_ms


# phase 8a: the buckets checked, every CODEC_BUCKET_STRIDE-th and the last
# (the remainder's length).  All 35 took 76.0-91.9 s of the script's
# 1200 s, nearly all of it the CPU's side; every bucket holds leaves of
# every scale, so the subset sees every magnitude and both lengths.
CODEC_BUCKET_STRIDE = 4


def codec_checks(torch, llama, dev) -> None:
    """Phase 8a: the 1b model's fp32 gradients (seeded, made per leaf on
    the card), packed into the fusion plan's 128 MiB buckets; per checked
    bucket (``CODEC_BUCKET_STRIDE``) the int8 codes and scale,
    ``int8_roundtrip``, ``local_error`` of each lossy format and the
    bf16/fp16 casts on the card and on the CPU must be bitwise equal."""
    from horovod_tpu_torch.ops import fusion, quantized, wire
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.runtime import get as hvd_runtime
    cfg = llama.CONFIGS["1b"]
    shapes = [tuple(p.shape) for p in llama.Llama(cfg, "meta").parameters()]
    plan = fusion.make_plan(shapes, [torch.float32] * len(shapes),
                            hvd_runtime().fusion_threshold())
    gen = torch.Generator(device=dev).manual_seed(8)

    def codec(buf):
        q, scale = quantized._quantize(buf)
        out = {"codes": q, "scale": scale,
               "int8_roundtrip": quantized.int8_roundtrip(buf)}
        for fmt in ("bf16", "fp16"):
            out[fmt] = Compression.by_name(fmt).compress(buf)[0]
        for fmt in wire.LOSSY_FORMATS:
            out[f"local_error {fmt}"] = wire.local_error(buf, fmt)
        return out

    t0 = time.perf_counter()
    elems, checks = 0, 0
    last = len(plan.buckets) - 1
    checked = [b for j, b in enumerate(plan.buckets)
               if j % CODEC_BUCKET_STRIDE == 0 or j == last]
    for b in checked:
        leaves = [None] * len(shapes)
        for i in b.indices:  # gradient-sized entries, a scale per leaf
            leaves[i] = torch.randn(shapes[i], generator=gen, device=dev) \
                * (10.0 ** (i % 5 - 4))
        buf = fusion.pack_bucket(leaves, b)
        card, host = codec(buf), codec(buf.cpu())
        for name, got in card.items():
            want = host[name]
            require(got.dtype == want.dtype and torch.equal(
                got.cpu().reshape(-1).view(torch.uint8),
                want.reshape(-1).view(torch.uint8)),
                f"codec {name} on the card differs from the CPU's in a "
                f"bucket of {buf.numel()} elements")
            checks += 1
        elems += buf.numel()
        del leaves, buf, card, host
    print(f"wire [1b codec]: {len(checked)} of {len(plan.buckets)} fp32 "
          f"buckets, {elems} elements; {checks} card results (int8 codes "
          "and scales, "
          "int8_roundtrip, local_error of bf16/fp16/int8_ring/dcn_int8, "
          "bf16 and fp16 casts) bitwise equal to the CPU's "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_wire(torch, np, hvd, llama, F) -> dict:
    """Phase 8: the wire and overlap planes on one card: the codec against
    the CPU, then the 1b step over k=2 microbatches through
    DistributedOptimizer(AdamW, wire_policy='auto', error_feedback=True,
    overlap=True, overlap_depth=1) beside the same with wire 'none' and
    overlap off.  At one rank plan_formats forces 'none' and the sync is a
    copy, so losses and parameters must be bitwise equal."""
    from horovod_tpu_torch.ops import wire
    dev = hvd.init().device
    codec_checks(torch, llama, dev)
    torch.cuda.empty_cache()

    cfg = llama.CONFIGS["1b"]
    k, steps = 2, 4
    rng = np.random.RandomState(0)  # phase 5's batches, 2 x 2048 each half
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)).to(dev)
        .view(k, TRAIN_BATCH // k, TRAIN_SEQ + 1) for _ in range(steps)]
    runs = {}
    for label, kw in (("auto+EF+overlap", dict(
            wire_policy="auto", error_feedback=True, overlap=True,
            overlap_depth=1)), ("none", dict(wire_policy="none",
                                             overlap=False))):
        model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=k, **kw)
        step = hvd.make_microbatched_train_step(
            model, lambda m, ids: llama.loss_fn(
                m, ids, attn_fn=hvd.flash_attention, ce_chunks=8), opt, k)
        before = wire.stats()["buckets"]
        F.reset_launches()
        losses = [step(batches[0])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(b) for b in batches[1:]]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
        after = wire.stats()["buckets"]
        runs[label] = {
            "losses": [float(x) for x in losses], "step_ms": step_ms,
            "launches": dict(F.LAUNCHES),
            "buckets": {f: n - before.get(f, 0) for f, n in after.items()
                        if n - before.get(f, 0)},
            "params": [p.detach().cpu() for p in model.parameters()],
            "pipelined": opt._hvd_pipeline is not None}
        del step, opt, model
        torch.cuda.empty_cache()
    a, b = runs["auto+EF+overlap"], runs["none"]
    for label, r in runs.items():
        print(f"wire [1b {label}] k={k} x {TRAIN_BATCH // k} x {TRAIN_SEQ}: "
              f"losses " + " ".join(f"{x:.5f}" for x in r["losses"])
              + f"; step {r['step_ms']:.1f} ms (steps 2-{steps}); buckets "
              f"synced by format {json.dumps(r['buckets'])}; pipelined "
              f"{r['pipelined']}; launches {json.dumps(r['launches'])}",
              flush=True)
        require(all(v > 0 for v in r["launches"].values()),
                f"wire [{label}]: an attention kernel was not launched")
    print(f"wire [1b]: wire.stats() {json.dumps(wire.stats())}", flush=True)
    require(a["pipelined"] and not b["pipelined"],
            "the overlap run did not take the pipeline")
    require(set(a["buckets"]) == {"none"},
            f"one rank must force every bucket to 'none': {a['buckets']}")
    same = a["losses"] == b["losses"] and all(
        torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    print(f"wire [1b]: auto+EF+overlap against none, losses and "
          f"parameters after step {steps} bitwise equal: {same}; step ratio "
          f"{a['step_ms'] / b['step_ms']:.3f}", flush=True)
    require(same, "the pipelined auto+EF step differs from the plain one "
            "at one rank, where both must be bitwise equal")
    hvd.shutdown()
    return a["launches"]


# phase 10 and --ranks N's ZeRO configurations
ZERO_LR, ZERO_WD = 3e-4, 0.01
ZERO_STEPS = 4           # phase 10: 1 warm-up and 3 timed steps
N_8B = 8030261248        # llama.param_count(CONFIGS["8b"])
# --ranks N, the 1b ZeRO configurations: (label, level, k, ag_prefetch,
# wire format); error feedback is on for the lossy formats
ZERO_CONFIGS = (
    ("L1", 1, 1, None, "none"), ("L2", 2, 1, None, "none"),
    ("L3", 3, 1, 2, "none"), ("L3 prefetch 1", 3, 1, 1, "none"),
    ("L2 k=2", 2, 2, None, "none"), ("L3 k=2", 3, 2, None, "none"),
    ("L1 bf16+EF", 1, 1, None, "bf16"), ("L3 bf16+EF", 3, 1, None, "bf16"),
)
# configurations that must be bitwise equal (same wire format and k)
ZERO_SAME = (("L1", "L2", "L3", "L3 prefetch 1"), ("L2 k=2", "L3 k=2"),
             ("L1 bf16+EF", "L3 bf16+EF"))
ZERO_LOSS_TOL = 1e-3     # --ranks N: losses against the none configuration's
ZERO_FP32_K_TOL = 1e-5   # the CPU rehearsal: fp32 level 2, k=2 against k=1


def zero_tokens(np, vocab: int, rows: int, seq: int, steps: int,
                n: int = 1):
    """``steps`` global batches of ``rows`` x ``seq + 1`` token ids from
    ``RandomState(0)``, drawn as phase 5 and the wire configurations draw
    theirs, stacked into one array for the loader.  Each batch's rows are
    laid out in the order ``shard_indices`` deals them to ``n`` ranks
    (rank r takes rows r, r + n, ...), so that rank r's batch i holds the
    rows ``make_microbatched_train_step`` gives it from the wire
    configurations' batch i (rows r * rows/n onward)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        g = rng.randint(0, vocab, (rows, seq + 1), dtype=np.int32)
        out.append(g.reshape(n, rows // n, seq + 1).transpose(1, 0, 2)
                   .reshape(rows, seq + 1))
    return np.concatenate(out)


def zero_run(torch, np, hvd, llama, F, dev, rank: int, n: int, cfg,
             tokens, rows: int, level: int, k: int = 1, wire: str = "none",
             ag_prefetch=None, master_fp32: bool = True, warmup: int = 1,
             profile: bool = False, dp: bool = False, keep: bool = False,
             layout=None, n_micro: int = 4, eps: float = 1e-8,
             gather: bool = True, timed: bool = False) -> dict:
    """One ZeRO configuration (or, with ``dp``, the data-parallel
    ``DistributedOptimizer(AdamW)`` step on the same inputs): the model
    from seed 0 on the card (fp32 master weights and bf16 compute, or with
    ``master_fp32=False`` the config's dtype), AdamW, flash attention and
    ``ce_chunks=8``; this rank's ``rows`` x seq rows of each step from
    ``NumpyDataLoader`` over ``tokens`` (``shard_indices(rank, n)``) through
    ``prefetch(depth=2)``, ``k`` microbatches a step.  ``warmup`` steps,
    the rest timed, and with ``profile`` one more step under the profiler
    on rank 0.  Returns the losses, parameter checksums, step ms, NCCL ms,
    peak and resident memory, the cost models and the launches.

    With ``layout=(dp, tp, pp)`` the same run goes through the 3D layout
    plane instead: this rank's ``LayoutLlama`` sliced from the seeded model,
    ``make_llama_layout_train_step`` with ``n_micro`` microbatches under
    pp, the loader dealing rows to the dp index; ``sums`` are then the
    checksums of the whole model's gathered parameters (none with
    ``gather=False``) and ``local_sums`` those of this rank's slice.
    With ``timed`` each step runs in ``hvd.perf.timed_step()``."""
    import dataclasses
    import gc as _gc
    from horovod_tpu_torch.data import NumpyDataLoader, prefetch
    from horovod_tpu_torch.parallel import zero as Z
    from horovod_tpu_torch.perf import costmodel
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    _gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    if master_fp32:  # activations in bf16, as the wire configurations run
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    if master_fp32:
        model = model.float()
    n_params = sum(p.numel() for p in model.parameters())
    lay = None
    if layout is not None:
        from horovod_tpu_torch.parallel import layout as Lay
        lay = Lay.build_layout(*layout)
        model = Lay.slice_llama(model, lay.coord, layout)
        rank, n = lay.coord[0], layout[0]
    compute = torch.bfloat16 if master_fp32 else None
    loss_fn = lambda m, ids: llama.loss_fn(  # noqa: E731
        m, ids, attn_fn=hvd.flash_attention, ce_chunks=8)
    ef = wire != "none"
    padded = None  # (padded elements, buckets) of the ZeRO chain's plan
    if lay is not None:
        state = Lay.init_layout_state(
            torch.optim.AdamW, model, zero_level=level, wire_policy=wire,
            error_feedback=ef, layout=lay, lr=ZERO_LR, weight_decay=ZERO_WD,
            eps=eps)
        step = Lay.make_llama_layout_train_step(
            model, state, n_micro=n_micro, layout=lay, zero_level=level,
            wire_policy=wire, error_feedback=ef, backward_passes_per_step=k,
            ag_prefetch=ag_prefetch, compute_dtype=compute,
            attn_fn=hvd.flash_attention, ce_chunks=8)
        modeled = None
    elif dp:
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=ZERO_LR,
                              weight_decay=ZERO_WD),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=k, wire_policy=wire)
        step = hvd.make_microbatched_train_step(model, loss_fn, opt, k,
                                                compute_dtype=compute)
        modeled, state = None, None
    else:
        state = Z.init_zero_state(torch.optim.AdamW, model, zero_level=level,
                                  wire_policy=wire, error_feedback=ef,
                                  lr=ZERO_LR, weight_decay=ZERO_WD, eps=eps)
        leaves = list(model.parameters())
        plan = Z._bucket_plan(leaves, None)
        formats = Z._zero_formats(plan, wire, n)
        modeled = sum(costmodel.zero_comm_bytes(
            Z._padded_len(sum(b.sizes), n), n, level, k=k,
            wire_format=f)["total_bytes"]
            for b, f in zip(plan.buckets, formats))
        padded = (sum(Z._padded_len(sum(b.sizes), n) for b in plan.buckets),
                  len(plan.buckets))
        step = Z.make_zero_train_step(
            model, loss_fn, state, zero_level=level, wire_policy=wire,
            error_feedback=ef, backward_passes_per_step=k,
            ag_prefetch=ag_prefetch, compute_dtype=compute)
    loader = NumpyDataLoader([tokens], batch_size=rows, rank=rank,
                             num_workers=n)
    host = [b[0] for b in NumpyDataLoader([tokens], batch_size=rows,
                                          rank=rank, num_workers=n)]
    steps = len(host) - (1 if profile else 0)
    F.reset_launches()
    losses, seen, prof, t0 = [], [], None, None
    import contextlib
    timer = hvd.perf.timed_step if timed else contextlib.nullcontext
    for i, (ids,) in enumerate(prefetch(loader, depth=2, device=dev)):
        seen.append(ids)
        mb = (ids if k == 1 and not dp
              else ids.view(k, rows // k, ids.shape[-1]))
        if i == warmup:
            sync()
            t0 = time.perf_counter()
        if i == steps:
            sync()
            dt = time.perf_counter() - t0
            if rank == 0 and cuda:
                from torch.profiler import ProfilerActivity, profile as prf
                with prf(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                    losses.append(step(mb))
                    sync()
                continue
        with timer():
            losses.append(step(mb))
    sync()
    if not profile:
        dt = time.perf_counter() - t0
    resident = (torch.cuda.memory_allocated() - base) if cuda else 0
    for got, want in zip(seen, host):
        require(torch.equal(got.cpu(), torch.from_numpy(want)),
                "a prefetched batch differs from its host array")
    require(len(seen) == len(host), "prefetch dropped a batch")
    if lay is not None:
        local = (Z.gather_zero3_params(state.shards, model,
                                       group=lay.groups["dp"])
                 if level == 3 else list(model.parameters()))
        local_sums = param_checksums(torch, local)
        del local
        params = (list(Lay.gather_layout_params(
            model, state.shards if level == 3 else None, layout=lay).values())
            if gather else [])
    else:
        params = (Z.gather_zero3_params(state.shards, model) if level == 3
                  and not dp else list(model.parameters()))
        local_sums = None
    out = {"losses": [float(x) for x in losses],
           "sums": param_checksums(torch, params) if params else None,
           "local_sums": local_sums,
           "step_ms": dt / (steps - warmup) * 1e3,
           "nccl_ms": None if prof is None else kernel_ms(prof)[1],
           "busy_ms": None if prof is None else kernel_ms(prof)[0],
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if cuda else 0.0),
           "base_gib": base / 2**30,
           "resident": resident, "modeled": modeled, "n_params": n_params,
           "memory_model": costmodel.zero_memory_bytes(
               0 if dp else level, n_params, n, ef=ef)["total_bytes"],
           "launches": dict(F.LAUNCHES), "steps": len(losses),
           "padded": padded}
    if keep:
        out["params"] = [p.detach().clone() for p in params]
    del step, state, model, params, seen
    _gc.collect()
    if lay is not None:
        Lay.release_layout(lay)
    if cuda:
        torch.cuda.empty_cache()
    return out


def zero_line(r: dict) -> str:
    """The printed numbers of one ZeRO run."""
    nccl = ("not profiled" if r["nccl_ms"] is None else
            f"profiled step: kernels {r['busy_ms']:.1f} ms, NCCL "
            f"{r['nccl_ms']:.1f} ms")
    modeled = ("" if r["modeled"] is None else
               f"; modeled wire bytes/step (zero_comm_bytes) "
               f"{r['modeled']:.0f}")
    return (f"step {r['step_ms']:.1f} ms; {nccl}{modeled}; peak memory "
            f"{r['peak_gib']:.2f} GiB ({r['base_gib']:.2f} GiB held before "
            f"the run); resident between steps "
            f"{r['resident']} bytes against zero_memory_bytes "
            f"{r['memory_model']}; losses "
            + " ".join(f"{x:.5f}" for x in r["losses"]))


def check_zero_launches(r: dict, layers: int, k: int, label: str) -> None:
    """Each attention kernel ran ``layers`` times per microbatch."""
    want = layers * k * r["steps"]
    for name, got in r["launches"].items():
        require(got == want, f"zero [{label}]: {name} launched {got} times, "
                             f"expected {want}")


def phase_zero(torch, np, hvd, llama, F, card: str) -> dict:
    """Phase 10: ZeRO and the input pipeline on one card.  1b with fp32
    master weights and bf16 compute, AdamW, 4 steps of 4 x 2048 (phase 5's
    batches through NumpyDataLoader and prefetch): levels 1, 2 and 3 at
    k=1 bitwise equal, levels 1 and 2 at k=2 bitwise equal, and level 1
    against ``DistributedOptimizer(AdamW)`` within EAGER_LOSS_TOL and
    EAGER_PARAM_TOL."""
    dev = hvd.init().device
    cfg = llama.CONFIGS["1b"]
    tokens = zero_tokens(np, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, ZERO_STEPS)
    runs = {}
    for label, level, k in (("L1", 1, 1), ("L2", 2, 1), ("L3", 3, 1),
                            ("L1 k=2", 1, 2), ("L2 k=2", 2, 2)):
        r = runs[label] = zero_run(torch, np, hvd, llama, F, dev, 0, 1, cfg,
                                   tokens, TRAIN_BATCH, level, k=k,
                                   keep=label == "L1")
        check_zero_launches(r, cfg.n_layers, k, label)
        print(f"zero [1b {label}] {card}, fp32 master weights, bf16 compute, "
              f"k={k} x {TRAIN_BATCH // k} x {TRAIN_SEQ}: " + zero_line(r)
              + "; launches " + json.dumps(r["launches"]), flush=True)
    ref = runs["L1"]
    dp = zero_run(torch, np, hvd, llama, F, dev, 0, 1, cfg, tokens,
                  TRAIN_BATCH, 1, dp=True, keep=True)
    print(f"zero [1b DistributedOptimizer(AdamW)] {card}: " + zero_line(dp),
          flush=True)
    for group in (("L1", "L2", "L3"), ("L1 k=2", "L2 k=2")):
        for label in group[1:]:
            same = (runs[label]["losses"] == runs[group[0]]["losses"]
                    and torch.equal(runs[label]["sums"],
                                    runs[group[0]]["sums"]))
            require(same, f"zero [1b]: {label} differs from {group[0]}")
    gap = max(abs(a - b) for a, b in zip(ref["losses"], dp["losses"]))
    pgap = max_param_diff(ref["params"], dp["params"])
    bitwise = (ref["losses"] == dp["losses"] and all(
        torch.equal(a, b) for a, b in zip(ref["params"], dp["params"])))
    print(f"zero [1b]: levels 1, 2 and 3 at k=1 bitwise equal (losses and "
          f"final parameters), levels 1 and 2 at k=2 bitwise equal; level 1 "
          f"against DistributedOptimizer(AdamW): max loss gap {gap:.3g}, max "
          f"parameter gap {pgap:.3g}, bitwise equal {bitwise}", flush=True)
    require(gap <= EAGER_LOSS_TOL and pgap <= EAGER_PARAM_TOL,
            f"zero level 1 against DistributedOptimizer: loss gap {gap}, "
            f"parameter gap {pgap}")
    del ref["params"], dp["params"]
    hvd.shutdown()
    launches = {name: sum(r["launches"][name] for r in runs.values())
                for name in F.LAUNCHES}
    return launches, runs


def phase_layout(torch, np, hvd, llama, F, card: str, zero_runs) -> dict:
    """Phase 11: the 3D layout plane on one card.  ``resolve_layout`` of
    ``1,1,1``, ``dp-only`` and ``auto`` at one rank, then
    ``make_llama_layout_train_step`` at (1, 1, 1) on phase 10's
    configuration (1b, fp32 master weights, bf16 compute, flash attention,
    4 steps of 4 x 2048 of phase 5's batches) at levels 1 and 3: losses and
    final parameters bitwise equal to phase 10's chain at the same level
    (at tp = pp = 1 the composed chain is the ZeRO chain)."""
    from horovod_tpu_torch.parallel import layout as Lay
    knobs = {"HOROVOD_TP": 0, "HOROVOD_PP": 0, "HOROVOD_ZERO_LEVEL": 1}
    for value in ("1,1,1", "dp-only", "auto"):
        got = Lay.resolve_layout(1, dict(knobs, HOROVOD_LAYOUT=value))
        require(got == (1, 1, 1), f"layout {value!r} resolved to {got}")
    print("layout: HOROVOD_LAYOUT 1,1,1, dp-only and auto resolve to "
          "(1, 1, 1) at one rank", flush=True)
    dev = hvd.init().device
    cfg = llama.CONFIGS["1b"]
    tokens = zero_tokens(np, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, ZERO_STEPS)
    launches = {name: 0 for name in F.LAUNCHES}
    for level in (1, 3):
        r = zero_run(torch, np, hvd, llama, F, dev, 0, 1, cfg, tokens,
                     TRAIN_BATCH, level, layout=(1, 1, 1))
        check_zero_launches(r, cfg.n_layers, 1, f"layout L{level}")
        ref = zero_runs[f"L{level}"]
        same = (r["losses"] == ref["losses"]
                and torch.equal(r["sums"], ref["sums"]))
        print(f"layout [1b (1, 1, 1) L{level}] {card}, fp32 master weights, "
              f"bf16 compute: step {r['step_ms']:.1f} ms against phase 10's "
              f"{ref['step_ms']:.1f} ms; peak memory {r['peak_gib']:.2f} GiB; "
              f"losses " + " ".join(f"{x:.5f}" for x in r["losses"])
              + f"; bitwise equal to phase 10's level {level}: {same}; "
              f"launches {json.dumps(r['launches'])}", flush=True)
        require(same, f"layout (1, 1, 1) level {level} differs from the "
                      "zero chain")
        for name in F.LAUNCHES:
            launches[name] += r["launches"][name]
    hvd.shutdown()
    return launches


# phase 12 and --ranks N (d): one ring block of the 1b model at 32,768
# tokens over four ranks (its own max_seq, 8,192, a rank)
RING_SHAPE = dict(B=1, S=8192, H=32, HK=8, D=64)
SEQ_LEN = 32768          # (d): one sequence, sharded over the ranks
SEQ_EQ_LAYERS = 2        # (d) equivalence: 1b cut to 2 layers, fp32
SEQ_SHORT = 8192         # (d): Ulysses and the plain ring, [S, S] scores
SEQ_STEPS = (2, 4)       # (d) timed: warm-up and timed steps, then 1 profiled
# tests/test_sequence_parallel.py's tolerances
SEQ_LOSS_TOL = dict(atol=2e-4, rtol=1e-3)
SEQ_GRAD_TOL = dict(atol=5e-4, rtol=2e-3)
SEQ_FIRST_LOSS_TOL = 0.02
# (e): tests/test_expert.py's tolerances; an ample capacity factor, so
# that per-shard routing and the dense path's global routing drop nothing
MOE_TOL = dict(rtol=5e-4, atol=5e-5)
MOE_EQ_CF = 8.0
MOE_STEPS = 3
MOE_ROWS = 8             # global rows, MOE_ROWS / N a rank
ADASUM_RTOL = 1e-4       # tests/test_adasum.py


def chunked_plain(F):
    """The plain versions of the three kernels, run one kv-head group at a
    time and concatenated: the same function on the same inputs, with a
    [S, S] score block of one group live instead of all eight (at S = 8,192
    the unchunked dk/dv version would hold about 55 GB)."""
    import types
    import torch

    def groups(q, k, *rows):
        H, HK = q.shape[2], k.shape[2]
        G = H // HK
        for h in range(HK):
            yield h, G, [r[:, h * G:(h + 1) * G] for r in rows]

    def fwd(q, k, v, causal=True):
        outs, lses = [], []
        for h, G, _ in groups(q, k):
            o, l = F.attention_forward_plain(
                q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1],
                v[:, :, h:h + 1], causal)
            outs.append(o)
            lses.append(l)
        return torch.cat(outs, 2), torch.cat(lses, 1)

    def dq(q, k, v, do, lse, delta, causal=True):
        return torch.cat([F.attention_dq_plain(
            q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1],
            do[:, :, h * G:(h + 1) * G], rl, rd, causal)
            for h, G, (rl, rd) in groups(q, k, lse, delta)], 2)

    def dkv(q, k, v, do, lse, delta, causal=True):
        parts = [F.attention_dkv_plain(
            q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1],
            do[:, :, h * G:(h + 1) * G], rl, rd, causal)
            for h, G, (rl, rd) in groups(q, k, lse, delta)]
        return (torch.cat([a for a, _ in parts], 2),
                torch.cat([b for _, b in parts], 2))

    return types.SimpleNamespace(
        flash_forward_cuda=F.flash_forward_cuda, flash_dq_cuda=F.flash_dq_cuda,
        flash_dkv_cuda=F.flash_dkv_cuda, attention_forward_plain=fwd,
        attention_dq_plain=dq, attention_dkv_plain=dkv)


def ring_kernel_rows(F, torch, card: str) -> dict:
    """Phase 12's kernels at one ring block's shapes, bf16: causal (the
    diagonal block) and non-causal (a block wholly in the past), each
    against its plain version with kernel, plain, SDPA and bound times;
    then dq and dk/dv of both blocks fed the ring's global ``lse`` and
    ``delta`` over the union of the two blocks' keys."""
    from horovod_tpu_torch.parallel import sequence as SP
    P = chunked_plain(F)
    B, S, H, HK, D = (RING_SHAPE[k] for k in ("B", "S", "H", "HK", "D"))
    gen = torch.Generator(device="cuda").manual_seed(12)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, do = mk(B, S, H, D), mk(B, S, H, D)
    blocks = [(mk(B, S, HK, D), mk(B, S, HK, D)) for _ in range(2)]
    rows = {}
    for causal, (k, v) in ((True, blocks[0]), (False, blocks[1])):
        label = "ring block causal" if causal else "ring block non-causal"
        out, lse = F.flash_forward_cuda(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        dk, dv = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        r_out, r_lse = P.attention_forward_plain(q, k, v, causal)
        r_dk, r_dv = P.attention_dkv_plain(q, k, v, do, lse, delta, causal)
        errs = check_case(f"ring kernels [{label}]", label, (
            ("out", out, r_out), ("lse", lse, r_lse),
            ("dq", dq, P.attention_dq_plain(q, k, v, do, lse, delta, causal)),
            ("dk", dk, r_dk), ("dv", dv, r_dv)), torch.bfloat16)
        del r_out, r_lse, r_dk, r_dv, dq, dk, dv
        timed = kernel_rows(P, torch, card, label, q, k, v, do, lse, delta,
                            causal, errs, RING_SHAPE, torch.bfloat16)
        for name, r in timed.items():
            rows.setdefault(name, {})["causal" if causal else "non-causal"] \
                = {key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "shape")}
    # the global-statistics case: the diagonal block and one past block
    (k0, v0), (k1, v1) = blocks
    o_d, l_d = F.flash_forward_cuda(q, k0, v0, True)
    o_p, l_p = F.flash_forward_cuda(q, k1, v1, False)
    o, lse = SP._lse_merge(o_d, l_d, o_p, l_p)
    out = o.to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for causal, (k, v) in ((True, (k0, v0)), (False, (k1, v1))):
        label = (f"global lse/delta, {'diagonal' if causal else 'past'} "
                 "block")
        dq = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        dk, dv = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        r_dk, r_dv = P.attention_dkv_plain(q, k, v, do, lse, delta, causal)
        errs = check_case(f"ring kernels [{label}]", label, (
            ("dq", dq, P.attention_dq_plain(q, k, v, do, lse, delta, causal)),
            ("dk", dk, r_dk), ("dv", dv, r_dv)), torch.bfloat16)
        rows["flash_bwd_dq"].setdefault("global_stats", {})[
            "causal" if causal else "non-causal"] = errs["dq"]
        rows["flash_bwd_dkv"].setdefault("global_stats", {})[
            "causal" if causal else "non-causal"] = max(errs["dk"],
                                                        errs["dv"])
        del dq, dk, dv, r_dk, r_dv
    torch.cuda.empty_cache()
    return rows


def phase_sequence(torch, np, hvd, llama, F, L, card: str) -> tuple:
    """Phase 12: sequence and expert parallelism and Adasum on one card.
    On a one-rank NCCL group: ``ring_attention(kernel="flash")`` bitwise
    equal to ``flash_attention`` at one ring block's shape (forward and the
    three gradients), Ulysses equal to ``causal_attention``; the kernels at
    the ring's shapes (``ring_kernel_rows``); the MoE ``mini`` loss in bf16
    with the kernels (head dim 32) against the plain attention; Adasum at
    one rank the identity.  Returns the ring rows and the launches of the
    n = 1 ring and of the MoE check."""
    import dataclasses
    from horovod_tpu_torch.models import moe_llama as M
    from horovod_tpu_torch.parallel import adasum as A
    from horovod_tpu_torch.parallel import sequence as SP
    dev = hvd.init().device
    B, S, H, HK, D = (RING_SHAPE[k] for k in ("B", "S", "H", "HK", "D"))
    gen = torch.Generator(device=dev).manual_seed(13)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v, do = mk(B, S, H, D), mk(B, S, HK, D), mk(B, S, HK, D), \
        mk(B, S, H, D)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    F.reset_launches()
    out = SP.ring_attention(q, k, v, kernel="flash")
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    ring_launches = dict(F.LAUNCHES)
    ref = hvd.flash_attention(q, k, v)
    ref_grads = torch.autograd.grad(ref, (q, k, v), do)
    same = torch.equal(out, ref) and all(
        torch.equal(a, b) for a, b in zip(grads, ref_grads))
    print(f"sequence [n=1 flash ring] q {list(q.shape)}, k/v "
          f"{list(k.shape)} bf16: out, dq, dk, dv bitwise equal to "
          f"flash_attention: {same}; launches {json.dumps(ring_launches)}",
          flush=True)
    require(same, "the one-rank flash ring differs from flash_attention")
    require(all(n == 1 for n in ring_launches.values()),
            f"the one-rank ring launched {ring_launches}")
    del q, k, v, do, out, grads, ref, ref_grads
    q2, k2, v2 = mk(1, 2048, H, D), mk(1, 2048, HK, D), mk(1, 2048, HK, D)
    same = torch.equal(SP.ulysses_attention(q2, k2, v2),
                       L.causal_attention(q2, k2, v2))
    print(f"sequence [n=1 Ulysses] q {list(q2.shape)}: equal to "
          f"causal_attention: {same}", flush=True)
    require(same, "one-rank Ulysses differs from causal_attention")
    torch.cuda.empty_cache()
    rows = ring_kernel_rows(F, torch, card)

    cfg = dataclasses.replace(M.CONFIGS["mini"], dtype=torch.bfloat16)
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ids = torch.randint(0, cfg.vocab, (2, 257), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    F.reset_launches()
    with torch.no_grad():
        flash = M.loss_fn(model, ids, attn_fn=hvd.flash_attention).item()
        moe_launches = dict(F.LAUNCHES)
        plain = M.loss_fn(model, ids, attn_fn=L.causal_attention).item()
    print(f"expert [MoE mini bf16, dense, head dim {cfg.head_dim}]: loss "
          f"with kernels {flash:.6f}, with plain attention {plain:.6f}; "
          f"launches {json.dumps(moe_launches)}", flush=True)
    require(math.isfinite(flash) and abs(flash - plain) <= 2e-2,
            f"MoE mini loss with kernels {flash} vs plain {plain} (tol 2e-2)")
    require(moe_launches["flash_fwd"] == cfg.n_layers,
            f"MoE mini launched {moe_launches}")
    del model

    x = torch.randn(1 << 20, generator=gen, device=dev)
    y = hvd.spmd.allreduce(x.clone(), op=hvd.Adasum)
    same = torch.equal(y, x) and A.adasum_allreduce(x) is x
    print(f"adasum [one rank]: the identity: {same}", flush=True)
    require(same, "Adasum at one rank is not the identity")
    hvd.shutdown()
    return rows, ring_launches, moe_launches


def seq_model(torch, llama, dev, cfg_name: str, layers, dtype,
              max_seq: int, **overrides):
    """``cfg_name`` with ``max_seq``, cut to ``layers`` (None: all of
    them), in ``dtype``, seeded 0."""
    import dataclasses
    base = llama.CONFIGS[cfg_name]
    cfg = dataclasses.replace(base, max_seq=max_seq, dtype=dtype,
                              n_layers=layers or base.n_layers, **overrides)
    return llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)


def seq_tokens(np, vocab: int, length: int):
    return np.random.RandomState(0).randint(0, vocab, (1, length + 1))


def seq_grads_close(got, want, label: str) -> tuple:
    """Every gradient of ``got`` against ``want`` (rank 0's one-card
    reference, broadcast), at SEQ_GRAD_TOL; returns the worst (abs err,
    relative to the limit)."""
    worst = (0.0, 0.0)
    for (name, a), b in zip(got, want):
        err = (a - b).abs()
        limit = SEQ_GRAD_TOL["atol"] + SEQ_GRAD_TOL["rtol"] * b.abs()
        ratio = (err / limit).max().item()
        worst = max(worst, (err.max().item(), ratio), key=lambda t: t[1])
        require(ratio <= 1.0, f"{label}: gradient {name} off by "
                              f"{err.max().item():.3g} ({ratio:.2f} of its "
                              "limit)")
    return worst


def seq_step(torch, hvd, SP, model, inp, tgt, attn, ce_chunks: int):
    """One rank's share of the loss and its gradients, summed over the
    ranks: the global loss and the global gradients on every rank."""
    import torch.distributed as dist
    model.zero_grad(set_to_none=True)
    loss = SP.sequence_loss_fn(model, inp, tgt, attn_fn=attn,
                               ce_chunks=ce_chunks)
    loss.backward()
    hvd.sync_gradients(model.parameters(), op=hvd.Sum)
    total = loss.detach().clone()
    dist.all_reduce(total)
    return total


def rank_sequence(torch, np, hvd, llama, F, rank: int, n: int, dev,
                  cfg_name: str, cfg_layers, seq_len: int, short_len: int,
                  **overrides) -> None:
    """--ranks N (d), sequence parallelism on ``cfg_name`` (``1b``) with
    max_seq ``seq_len`` (32,768).
    Equivalence (fp32, the model cut to ``cfg_layers[0]`` layers): the
    flash ring over ``seq_len`` tokens, and Ulysses and the plain ring
    over ``short_len``, against one card's ``flash_attention`` step over
    the whole sequence (rank 0's, broadcast).  Timed (bf16, full depth,
    ``cfg_layers[1]`` layers): the flash ring step over ``seq_len`` tokens
    through ``DistributedOptimizer(AdamW, op=Sum)``; first loss against one
    card's no-grad forward; launches 16 (r + 1) per kernel a step on rank
    r; parameters bitwise equal across ranks."""
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import sequence as SP
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    eq_layers, timed_layers = cfg_layers
    # (d) equivalence in fp32
    model = seq_model(torch, llama, dev, cfg_name, eq_layers, torch.float32,
                      seq_len, **overrides)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.named_parameters())
    for label, length, attn in (
            ("flash ring", seq_len, SP.make_ring_attn_fn(kernel="flash")),
            ("Ulysses", short_len, SP.make_ulysses_attn_fn()),
            ("plain ring", short_len, SP.make_ring_attn_fn(kernel="xla"))):
        ids = torch.from_numpy(seq_tokens(np, model.cfg.vocab, length)).to(dev)
        shard = length // n
        inp = ids[:, :-1][:, rank * shard:(rank + 1) * shard]
        tgt = ids[:, 1:][:, rank * shard:(rank + 1) * shard]
        t0 = time.perf_counter()
        loss = seq_step(torch, hvd, SP, model, inp, tgt, attn, 8).item()
        sync()
        ring_s = time.perf_counter() - t0
        got = [(name, p.grad.detach().clone()) for name, p in params]
        model.zero_grad(set_to_none=True)
        ref_loss = torch.zeros((), device=dev)
        t0 = time.perf_counter()
        if rank == 0:  # one card, the whole sequence
            ref_loss = llama.loss_fn(model, ids, attn_fn=hvd.flash_attention,
                                     ce_chunks=8)
            ref_loss.backward()
        sync()
        ref_s = time.perf_counter() - t0
        dist.broadcast(ref_loss.detach(), 0)
        want = [p.grad if rank == 0 else torch.empty_like(p)
                for _, p in params]
        for w in want:
            dist.broadcast(w, 0)
        lim = SEQ_LOSS_TOL["atol"] + SEQ_LOSS_TOL["rtol"] * abs(
            ref_loss.item())
        require(abs(loss - ref_loss.item()) <= lim,
                f"sequence [{label}]: loss {loss} vs one card's "
                f"{ref_loss.item()}")
        worst = seq_grads_close(got, want, f"sequence [{label}]")
        if rank == 0:
            print(f"ranks [{n}] sequence [{label}, {cfg_name} cut to "
                  f"{model.cfg.n_layers} layers, fp32, {length} tokens, "
                  f"{shard} a rank]: loss "
                  f"{loss:.6f} vs one card's {ref_loss.item():.6f}; every "
                  f"gradient within atol {SEQ_GRAD_TOL['atol']} rtol "
                  f"{SEQ_GRAD_TOL['rtol']} (worst abs err {worst[0]:.3g}, "
                  f"{worst[1]:.2f} of its limit); step {ring_s:.2f} s, "
                  f"one card's {ref_s:.2f} s", flush=True)
        model.zero_grad(set_to_none=True)
        del got, want
        if cuda:
            torch.cuda.empty_cache()
    del model, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (d) timed: full depth, bf16
    model = seq_model(torch, llama, dev, cfg_name, timed_layers,
                      torch.bfloat16, seq_len, **overrides)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters(), op=hvd.Sum)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    ids = torch.from_numpy(seq_tokens(np, cfg.vocab, seq_len)).to(dev)
    shard = seq_len // n
    inp = ids[:, :-1][:, rank * shard:(rank + 1) * shard].contiguous()
    tgt = ids[:, 1:][:, rank * shard:(rank + 1) * shard].contiguous()
    ref_first = torch.zeros((), device=dev)
    if rank == 0:
        with torch.no_grad():
            ref_first = llama.loss_fn(model, ids, attn_fn=hvd.flash_attention,
                                      ce_chunks=8).float()
    dist.broadcast(ref_first, 0)
    attn = SP.make_ring_attn_fn(kernel="flash")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = SP.sequence_loss_fn(model, inp, tgt, attn_fn=attn,
                                   ce_chunks=8)
        loss.backward()
        opt.step()
        total = loss.detach().float()
        dist.all_reduce(total)
        return total

    warm, timed = SEQ_STEPS
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    losses = [step() for _ in range(warm)]
    sync()
    t0 = time.perf_counter()
    losses += [step() for _ in range(timed)]
    sync()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    prof_ms = None
    if cuda and rank in (0, n - 1):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.append(step())
            sync()
        prof_ms = kernel_ms(prof)
    else:
        losses.append(step())
    sync()
    n_steps = len(losses)
    launches = {k: v / n_steps for k, v in F.LAUNCHES.items()}
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"sequence losses {losses}")
    require(abs(losses[0] - ref_first.item()) <= SEQ_FIRST_LOSS_TOL,
            f"sequence: first loss {losses[0]} vs one card's no-grad "
            f"forward {ref_first.item()}")
    if cuda:
        want = cfg.n_layers * (rank + 1)
        require(all(v == want for v in launches.values()),
                f"rank {rank}: launches a step {launches}, expected {want} "
                "per kernel")
    sums = param_checksums(torch, model.parameters())
    every = [torch.empty_like(sums) for _ in range(n)]
    dist.all_gather(every, sums)
    equal = all(torch.equal(e, every[0]) for e in every)
    require(equal, "sequence: parameters differ across the ranks")
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    report = torch.tensor([step_ms, peak] + list(prof_ms or (0.0, 0.0))
                          + [launches[k] for k in sorted(launches)],
                          dtype=torch.float64, device=dev)
    reports = [torch.empty_like(report) for _ in range(n)]
    dist.all_gather(reports, report)
    if rank == 0:
        tok_s = shard / step_ms * 1e3
        mfu = 6 * n_params * tok_s / PEAK_BF16_FLOPS
        print(f"ranks [{n}] sequence [flash ring, {cfg_name} {cfg.n_layers} "
              f"layers, "
              f"bf16, 1 x {seq_len} tokens a step, {shard} a rank, AdamW, "
              f"ce_chunks=8, gradients summed]: step {step_ms:.1f} ms, "
              f"{tok_s:.0f} tokens/s per card, MFU(6N) {mfu:.4f}; losses "
              + " ".join(f"{x:.5f}" for x in losses)
              + f"; one card's no-grad forward {ref_first.item():.5f}; "
              f"parameters bitwise equal on all {n} ranks: {equal}",
              flush=True)
        for r, rep in enumerate(reports):
            rep = rep.tolist()
            per = dict(zip(sorted(launches), rep[4:]))
            prof_txt = (f"NCCL {rep[3]:.1f} ms, compute {rep[2] - rep[3]:.1f}"
                        f" ms (profiled)" if rep[2] > 0 else "not profiled")
            print(f"ranks [{n}] sequence rank {r}: step {rep[0]:.1f} ms, "
                  f"peak {rep[1]:.2f} GiB, {prof_txt}; launches a step "
                  f"{json.dumps(per)}", flush=True)
    del opt, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def moe_close(got, want, label: str) -> float:
    err = (got - want).abs()
    limit = MOE_TOL["atol"] + MOE_TOL["rtol"] * want.abs()
    ratio = (err / limit).max().item()
    require(ratio <= 1.0, f"{label}: off by {err.max().item():.3g} "
                          f"({ratio:.2f} of its limit)")
    return ratio


def shard_routed_moe_fn(torch, X, cfg, n: int):
    """The dense MoE path on one card with expert parallelism's routing:
    the tokens cut into the ``n`` ranks' shards, each routed on its own
    (its capacity, its drops, its aux; tests/test_expert.py's
    ``_sharded_reference``), the aux averaged."""
    def fn(params, tokens):
        ys, auxes = [], []
        for shard in tokens.chunk(n):
            capacity = int(math.ceil(shard.shape[0] * cfg.experts_per_token
                                     * cfg.capacity_factor / cfg.n_experts))
            y, aux = X.moe_dense_reference(params, shard, cfg.n_experts,
                                           capacity, cfg.experts_per_token)
            ys.append(y)
            auxes.append(aux)
        return torch.cat(ys), torch.stack(auxes).mean()
    return fn


def rank_expert(torch, np, hvd, rank: int, n: int, dev) -> None:
    """--ranks N (e): expert parallelism on ``moe_llama`` ``mini`` (8
    experts, 8 / N a rank) and ``mixtral-tiny`` (top-2), fp32.  The ep = N
    forward, loss and every gradient against the dense path on this card
    with the same weights and the whole batch, routed shard by shard as
    the ranks route (``shard_routed_moe_fn``); then MOE_STEPS AdamW steps
    with the default capacity factor: losses falling, replicated leaves
    bitwise equal across ranks, step ms."""
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.models import moe_llama as M
    from horovod_tpu_torch.parallel import expert as X
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for name in ("mini", "mixtral-tiny"):
        base = M.CONFIGS[name]
        cfg = dataclasses.replace(base, capacity_factor=MOE_EQ_CF)
        full = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        hvd.broadcast_parameters(full.state_dict(), root_rank=0)
        seq = min(cfg.max_seq, 128)
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab, (MOE_ROWS, seq + 1))).to(dev)
        rows = MOE_ROWS // n
        mine = ids[rank * rows:(rank + 1) * rows]
        dense = shard_routed_moe_fn(torch, X, cfg, n)
        logits_d, _ = full(ids[:, :-1], moe_fn=dense)
        loss_d = M.loss_fn(full, ids, moe_fn=dense)
        loss_d.backward()
        model = M.shard_experts(full)
        fn = X.make_moe_fn(n_experts=cfg.n_experts, capacity_factor=MOE_EQ_CF,
                           experts_per_token=cfg.experts_per_token)
        logits, _ = model(mine[:, :-1], moe_fn=fn)
        loss = M.loss_fn(model, mine, moe_fn=fn) / n
        loss.backward()
        replicated = [p for k, p in model.named_parameters()
                      if not k.endswith(("moe.wi", "moe.wo"))]
        hvd.sync_gradients(replicated, op=hvd.Sum)
        total = loss.detach().clone()
        dist.all_reduce(total)
        worst = moe_close(logits.detach(),
                          logits_d.detach()[rank * rows:(rank + 1) * rows],
                          f"expert [{name}] logits")
        worst = max(worst, moe_close(total, loss_d.detach(),
                                     f"expert [{name}] loss"))
        e_local = cfg.n_experts // n
        dense_params = dict(full.named_parameters())
        for k, p in model.named_parameters():
            want = dense_params[k].grad
            if k.endswith(("moe.wi", "moe.wo")):
                want = want[rank * e_local:(rank + 1) * e_local]
            worst = max(worst, moe_close(p.grad, want,
                                         f"expert [{name}] gradient {k}"))
        if rank == 0:
            print(f"ranks [{n}] expert [{name}, fp32, ep={n}, "
                  f"{cfg.n_experts // n} experts a rank, top-"
                  f"{cfg.experts_per_token}, capacity factor {MOE_EQ_CF}]: "
                  f"logits, loss {total.item():.6f} (dense "
                  f"{loss_d.item():.6f}) and every gradient within rtol "
                  f"{MOE_TOL['rtol']} atol {MOE_TOL['atol']} of the dense "
                  f"path on one card (worst {worst:.2f} of the limit)",
                  flush=True)
        del full, logits_d, loss_d
        # training at the configuration's own capacity factor
        fn = X.make_moe_fn(n_experts=cfg.n_experts,
                           capacity_factor=base.capacity_factor,
                           experts_per_token=cfg.experts_per_token)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        losses, times = [], []
        for _ in range(MOE_STEPS):
            sync()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = M.loss_fn(model, mine, moe_fn=fn) / n
            loss.backward()
            hvd.sync_gradients(replicated, op=hvd.Sum)
            opt.step()
            total = loss.detach().clone()
            dist.all_reduce(total)
            losses.append(total.item())
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        require(losses[-1] < losses[0], f"expert [{name}]: losses {losses}")
        sums = param_checksums(torch, replicated)
        every = [torch.empty_like(sums) for _ in range(n)]
        dist.all_gather(every, sums)
        equal = all(torch.equal(e, every[0]) for e in every)
        require(equal, f"expert [{name}]: replicated leaves differ across "
                       "the ranks")
        if rank == 0:
            print(f"ranks [{n}] expert [{name}] training, capacity factor "
                  f"{base.capacity_factor}: losses "
                  + " ".join(f"{x:.5f}" for x in losses)
                  + f"; step ms " + " ".join(f"{t:.1f}" for t in times)
                  + f"; replicated leaves bitwise equal on all {n} ranks: "
                  f"{equal}", flush=True)
        del model, opt, replicated
        if cuda:
            torch.cuda.empty_cache()


def adasum_np(np, vectors):
    """tests/test_adasum.py's float64 model of the XOR recursion."""
    vs = [np.asarray(v, dtype=np.float64) for v in vectors]
    k = 1
    while k < len(vs):
        out = []
        for i in range(len(vs)):
            a, b = vs[i], vs[i ^ k]
            dot, na, nb = float(a @ b), float(a @ a), float(b @ b)
            ca = 1.0 - dot / (2 * na) if na > 0 else 1.0
            cb = 1.0 - dot / (2 * nb) if nb > 0 else 1.0
            out.append(ca * a + cb * b)
        vs = out
        k *= 2
    return vs[0]


def adasum_err(np, got, want, inputs) -> float:
    """The worst error of ``got`` against the float64 model ``want``
    relative to ``|want|`` plus the largest input at that element: an
    element where the combine's two terms cancel keeps fp32's error
    relative to the terms, not to their small result."""
    scale = np.abs(want)
    for x in inputs:
        scale = np.maximum(scale, np.abs(x))
    return float((np.abs(got.astype(np.float64) - want)
                  / np.maximum(np.abs(want) + scale, 1e-30)).max())


def adasum_bucket(torch, fusion, shapes, bucket, rank: int, dev):
    """Rank ``rank``'s seeded gradients of ``bucket``'s leaves (a scale per
    leaf), made on ``dev`` and packed: every rank can make any rank's."""
    leaves = [None] * len(shapes)
    for i in bucket.indices:
        gen = torch.Generator(device=dev).manual_seed(100000 * (rank + 1) + i)
        leaves[i] = torch.randn(shapes[i], generator=gen, device=dev) * (
            10.0 ** (i % 5 - 4))
    return fusion.pack_bucket(leaves, bucket).clone()


def rank_adasum(torch, np, hvd, ht, llama, F, rank: int, n: int, dev,
                cfg_name: str, batch: int, seq: int) -> None:
    """--ranks N (f), flat: ``spmd.allreduce(op=Adasum)`` on each fp32
    bucket of ``cfg_name``'s seeded gradients against the float64 numpy
    model (each rank checks every N-th bucket, making every rank's inputs
    itself), timed beside ``op=Average``; then the step through
    ``DistributedOptimizer(AdamW, op=Adasum)`` and through the eager
    ``DistributedOptimizer(op=Adasum)`` (the delta optimizer): step ms,
    parameters bitwise equal across ranks."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import fusion
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = llama.CONFIGS[cfg_name]
    shapes = [tuple(p.shape) for p in llama.Llama(cfg, "meta").parameters()]
    plan = fusion.make_plan(shapes, [torch.float32] * len(shapes),
                            hvd.runtime.get().fusion_threshold())
    bufs, worst, elems = [], 0.0, 0
    for j, b in enumerate(plan.buckets):
        buf = adasum_bucket(torch, fusion, shapes, b, rank, dev)
        bufs.append(buf)
        out = hvd.spmd.allreduce(buf.clone(), op=hvd.Adasum)
        sums = param_checksums(torch, [out])
        every = [torch.empty_like(sums) for _ in range(n)]
        dist.all_gather(every, sums)
        require(all(torch.equal(e, every[0]) for e in every),
                f"adasum: bucket {j} differs across the ranks")
        if j % n == rank:
            ins = [adasum_bucket(torch, fusion, shapes, b, r, dev).cpu()
                   .numpy() for r in range(n)]
            want = adasum_np(np, ins)
            err = adasum_err(np, out.cpu().numpy(), want, ins)
            require(err <= ADASUM_RTOL, f"adasum: bucket {j} off the numpy "
                                        f"model by {err:.3g} (rtol)")
            worst = max(worst, err)
            del ins, want
        elems += buf.numel()
        del out
    every = [torch.zeros(1, dtype=torch.float64, device=dev)
             for _ in range(n)]
    dist.all_gather(every, torch.tensor([worst], dtype=torch.float64,
                                        device=dev))
    worst = max(float(e.item()) for e in every)
    times = {}
    for op in (hvd.Average, hvd.Adasum, hvd.Adasum, hvd.Average):
        work = [b.clone() for b in bufs]
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for w in work:
            hvd.spmd.allreduce(w, op=op)
        sync()
        times.setdefault(op.name, []).append(
            (time.perf_counter() - t0) * 1e3)
        del work
    if rank == 0:
        print(f"ranks [{n}] adasum [{cfg_name} fp32 gradients, "
              f"{len(plan.buckets)} buckets, {elems} elements]: every bucket "
              f"bitwise equal on all {n} ranks and within rtol {ADASUM_RTOL} "
              f"of the float64 numpy model (of |model| + the largest input "
              f"at each element; worst {worst:.3g}); all buckets through "
              f"spmd.allreduce: "
              + ", ".join(f"{k} " + " / ".join(f"{t:.1f}" for t in v)
                          + " ms" for k, v in times.items()), flush=True)
    del bufs
    if cuda:
        torch.cuda.empty_cache()
    # the 1b step through the root optimizer and the eager delta optimizer
    from horovod_tpu_torch.torch import mpi_ops
    for label, api in (("DistributedOptimizer(AdamW, op=Adasum)", hvd),
                       ("eager DistributedOptimizer(op=Adasum)", ht)):
        model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=0.01)
        opt = api.DistributedOptimizer(
            adamw, named_parameters=model.named_parameters(), op=hvd.Adasum)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        step = hvd.make_train_step(
            model, lambda m, ids: llama.loss_fn(
                m, ids, attn_fn=hvd.flash_attention, ce_chunks=8), opt)
        rng = np.random.RandomState(0)
        batches = [torch.from_numpy(rng.randint(
            0, cfg.vocab, (batch * n, seq + 1), dtype=np.int32))
            for _ in range(WARMUP_STEPS + 3)]
        losses = [step(b) for b in batches[:WARMUP_STEPS]]
        sync()
        t0 = time.perf_counter()
        losses += [step(b) for b in batches[WARMUP_STEPS:]]
        sync()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        losses = [float(x) for x in losses]
        require(all(math.isfinite(x) for x in losses),
                f"adasum {label}: losses {losses}")
        sums = param_checksums(torch, model.parameters())
        every = [torch.empty_like(sums) for _ in range(n)]
        dist.all_gather(every, sums)
        equal = all(torch.equal(e, every[0]) for e in every)
        require(equal, f"adasum {label}: parameters differ across the ranks")
        if rank == 0:
            print(f"ranks [{n}] adasum [{cfg_name} {label}, {batch} x {seq} "
                  f"a rank]: step {step_ms:.1f} ms; losses "
                  + " ".join(f"{x:.5f}" for x in losses)
                  + f"; parameters bitwise equal on all {n} ranks: {equal}",
                  flush=True)
        del step, opt, adamw, model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def rank_adasum_two_level(torch, np, hvd, rank: int, n: int, dev) -> None:
    """--ranks N (f) on two hosts of N/2 ranks, as the wire part lays them
    out: ``adasum_hierarchical`` against the numpy model (the mean inside
    each host, Adasum across), and ``spmd.allreduce(op=Adasum)`` under
    HOROVOD_HIERARCHICAL_ALLREDUCE bitwise equal to the flat recursion."""
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import adasum as A
    cross, local = hvd.runtime.get().hierarchy
    size = 1 << 22 if dev.type == "cuda" else 1 << 12
    xs = [torch.randn(size, device=dev, generator=torch.Generator(
        device=dev).manual_seed(500 + r)) for r in range(n)]
    got = A.adasum_hierarchical(xs[rank], local, cross)
    ici = n // 2
    means = [np.mean([xs[h * ici + i].cpu().numpy().astype(np.float64)
                      for i in range(ici)], axis=0) for h in range(n // ici)]
    err = adasum_err(np, got.cpu().numpy(), adasum_np(np, means), means)
    require(err <= ADASUM_RTOL, f"adasum_hierarchical off the numpy model "
                                f"by {err:.3g} (rtol)")
    flat = hvd.spmd.allreduce(xs[rank].clone(), op=hvd.Adasum)
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    try:
        routed = hvd.spmd.allreduce(xs[rank].clone(), op=hvd.Adasum)
    finally:
        os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE")
    require(torch.equal(flat, routed), "two-level Adasum differs from the "
                                       "flat recursion")
    sums = param_checksums(torch, [got, routed])
    every = [torch.empty_like(sums) for _ in range(n)]
    dist.all_gather(every, sums)
    equal = all(torch.equal(e, every[0]) for e in every)
    require(equal, "two-level Adasum differs across the ranks")
    if rank == 0:
        print(f"ranks [{n}] adasum [two hosts of {ici}]: adasum_hierarchical "
              f"of {size} fp32 elements within rtol {ADASUM_RTOL} of the "
              f"numpy model (worst {err:.3g}); spmd.allreduce(op=Adasum) under "
              "HOROVOD_HIERARCHICAL_ALLREDUCE bitwise equal to the flat "
              f"recursion; bitwise equal on all {n} ranks: {equal}",
              flush=True)


def zero_gaps(label: str, losses, ref_losses, tol: float) -> list:
    """Each step's loss less the none wire configuration's; raises when
    one is off by more than ``tol``."""
    gaps = [a - b for a, b in zip(losses, ref_losses)]
    require(len(losses) == len(ref_losses)
            and max(abs(g) for g in gaps) <= tol,
            f"zero [{label}]: losses {losses} against the none wire "
            f"configuration's {ref_losses} (bound {tol:.2e})")
    return gaps


def zero_cpu_bound(torch, np, hvd, llama, F, dev, rank: int, n: int, cfg,
                   tokens, rows: int, ref_losses) -> float:
    """The CPU rehearsal's bound on a microbatched configuration's losses
    against the none wire configuration's (k=1), and the check that holds
    the k=2 path in fp32.

    Both compute in bf16, and splitting a step's rows into microbatches
    rounds its products otherwise; on the card the gap stays within
    ``ZERO_LOSS_TOL``, on a CPU's bf16 path it need not (level 2 at k=2
    read 1.17e-3 at step 7 of the tiny rehearsal, bitwise equal all the
    while to ``DistributedOptimizer`` at k=2).  So (1) level 2 in fp32
    compute at k=2 must stay within ``ZERO_FP32_K_TOL`` of k=1, which a
    microbatch dropped or counted twice misses by far; (2) the bound is
    2 delta, delta the largest gap of the none configuration's bf16
    losses from level 2's fp32 losses at k=1: each bf16 run is a rounding
    of the fp32 one, so two of them lie about 2 delta apart at most; and
    never below ``ZERO_LOSS_TOL``."""
    fp32 = {k: zero_run(torch, np, hvd, llama, F, dev, rank, n, cfg, tokens,
                        rows, 2, k=k, master_fp32=False, warmup=WARMUP_STEPS,
                        profile=True)["losses"] for k in (1, 2)}
    k_gap = max(abs(a - b) for a, b in zip(fp32[2], fp32[1]))
    delta = max(abs(a - b) for a, b in zip(ref_losses, fp32[1]))
    tol = max(ZERO_LOSS_TOL, 2 * delta)
    if rank == 0:
        print(f"ranks [{n}] zero, CPU bound: level 2 in fp32, k=2 - k=1: "
              + " ".join(f"{a - b:+.2e}" for a, b in zip(fp32[2], fp32[1]))
              + f" (bound {ZERO_FP32_K_TOL:.0e}); none's bf16 - fp32: "
              + " ".join(f"{a - b:+.2e}" for a, b in zip(ref_losses,
                                                        fp32[1]))
              + f"; microbatched configurations held to 2 x "
              f"{delta:.2e} = {tol:.2e}", flush=True)
    require(k_gap <= ZERO_FP32_K_TOL,
            f"zero [L2 k=2 fp32]: losses {fp32[2]} against k=1's "
            f"{fp32[1]} (bound {ZERO_FP32_K_TOL:.0e})")
    return tol


def rank_zero(torch, np, hvd, llama, F, rank: int, n: int, dev,
              cfg_name: str, batch: int, seq: int, ref_losses,
              big_name: str) -> None:
    """--ranks N, after the wire configurations: (a) ``cfg_name`` through
    ``ZERO_CONFIGS``, 8 steps of ``batch`` x ``seq`` per rank, bitwise
    equal across the ranks and within each group of ``ZERO_SAME``, and
    within ``ZERO_LOSS_TOL`` of the ``none`` wire configuration's losses
    (on a CPU rehearsal the microbatched ones within ``zero_cpu_bound``);
    (b)
    ``big_name`` cut to 2 layers, fp32 master weights, levels 1 and 3
    bitwise equal; (c) ``big_name`` at full depth in its own dtype (bf16),
    level 3, 2 warm-up, 4 timed and 1 profiled step of 1 x ``seq``."""
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.perf import costmodel
    cuda = dev.type == "cuda"

    def everywhere(r, label):
        every = [torch.empty_like(r["sums"]) for _ in range(n)]
        dist.all_gather(every, r["sums"])
        require(all(torch.equal(e, every[0]) for e in every),
                f"zero [{label}]: parameters differ across the {n} ranks")
        require(all(math.isfinite(x) for x in r["losses"]),
                f"zero [{label}]: loss {r['losses']}")

    cfg = llama.CONFIGS[cfg_name]
    tokens = zero_tokens(np, cfg.vocab, batch * n, seq,
                         WARMUP_STEPS + TIMED_STEPS + 1, n)
    # microbatched configurations: the card's bound, or on a CPU the
    # bound measured from bf16 rounding at this depth
    k_tol = ZERO_LOSS_TOL if cuda else zero_cpu_bound(
        torch, np, hvd, llama, F, dev, rank, n, cfg, tokens, batch,
        ref_losses)
    runs = {}
    for label, level, k, pre, wire in ZERO_CONFIGS:
        r = runs[label] = zero_run(
            torch, np, hvd, llama, F, dev, rank, n, cfg, tokens, batch,
            level, k=k, wire=wire, ag_prefetch=pre, warmup=WARMUP_STEPS,
            profile=True)
        everywhere(r, label)
        if cuda:
            check_zero_launches(r, cfg.n_layers, k, label)
        tol = ZERO_LOSS_TOL if k == 1 else k_tol
        gaps = zero_gaps(label, r["losses"], ref_losses, tol)
        if rank == 0:
            print(f"ranks [{n}] zero {label} ({cfg_name}, fp32 master "
                  f"weights, bf16 compute, k={k} x {batch // k} x {seq} per "
                  f"rank): " + zero_line(r) + "; loss - none's: "
                  + " ".join(f"{g:+.2e}" for g in gaps)
                  + f" (bound {tol:.2e}); parameters bitwise equal on all "
                  f"{n} ranks", flush=True)
    for group in ZERO_SAME:
        for label in group[1:]:
            require(runs[label]["losses"] == runs[group[0]]["losses"]
                    and torch.equal(runs[label]["sums"],
                                    runs[group[0]]["sums"]),
                    f"zero [{cfg_name}]: {label} differs from {group[0]}")
    if rank == 0:
        print(f"ranks [{n}] zero ({cfg_name}): bitwise equal within each of "
              + "; ".join(", ".join(g) for g in ZERO_SAME), flush=True)

    big = llama.CONFIGS[big_name]
    cut = dataclasses.replace(big, n_layers=2)
    tokens = zero_tokens(np, big.vocab, n, seq, ZERO_STEPS, n)
    two = {}
    for level in (1, 3):
        r = two[level] = zero_run(torch, np, hvd, llama, F, dev, rank, n,
                                  cut, tokens, 1, level)
        everywhere(r, f"{big_name} 2 layers L{level}")
        if rank == 0:
            print(f"ranks [{n}] zero {big_name} 2 layers L{level} (full "
                  f"width, {r['n_params']} params, fp32 master weights, "
                  f"bf16 compute, 1 x {seq} per rank): " + zero_line(r),
                  flush=True)
    require(two[1]["losses"] == two[3]["losses"]
            and torch.equal(two[1]["sums"], two[3]["sums"]),
            f"zero [{big_name} 2 layers]: level 3 differs from level 1")
    if rank == 0:
        print(f"ranks [{n}] zero {big_name} 2 layers: levels 1 and 3 bitwise "
              "equal, and on every rank", flush=True)

    tokens = zero_tokens(np, big.vocab, n, seq, WARMUP_STEPS + 4 + 1, n)
    r = zero_run(torch, np, hvd, llama, F, dev, rank, n, big, tokens, 1, 3,
                 ag_prefetch=2, master_fp32=False, warmup=WARMUP_STEPS,
                 profile=True)
    everywhere(r, f"{big_name} L3")
    if cuda:
        check_zero_launches(r, big.n_layers, 1, f"{big_name} L3")
    if rank == 0:
        tok_s = seq / (r["step_ms"] / 1e3)
        mfu = 6 * r["n_params"] * tok_s / PEAK_BF16_FLOPS
        plain = costmodel.zero_memory_bytes(0, r["n_params"], 1)
        print(f"ranks [{n}] zero {big_name} L3 ({r['n_params']} params, "
              f"{big.n_layers} layers, bf16 parameters, fp32 master shards, "
              f"ag_prefetch 2, 1 x {seq} per rank): {tok_s:.0f} tokens/s per "
              f"card, MFU(6N) {mfu:.4f}; " + zero_line(r)
              + f"; plain data parallelism would hold "
              f"{plain['total_bytes']} bytes per rank "
              f"(zero_memory_bytes(0, N, 1)); launches "
              + json.dumps(r["launches"]), flush=True)


# --ranks N, the 3D layout plane: the (dp, tp, pp) layouts of (a) and (b)
LAYOUTS = ((4, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2), (1, 4, 1))
LAYOUT_ROWS = 4          # global rows a step, at every layout
LAYOUT_STEPS = 3         # (a): 1 warm-up and 2 timed steps
LAYOUT_N_MICRO = 4
LAYOUT_EPS = 1e-3        # AdamW's eps in (a), as the CPU parity tests
LAYOUT_LOSS_TOL, LAYOUT_PARAM_TOL = 2e-5, 1e-4   # tests/test_layout.py
LAYOUT_BF16_LOSS_TOL = 0.05
FSDP_MESH = (1, 2, 2)
FSDP_LR = 1e-2


def layout_fits(cfg, dims, rows: int) -> bool:
    """Whether ``cfg`` and ``rows`` global rows take layout ``dims``."""
    dp, tp, pp = dims
    return not (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.ffn_dim % tp
                or cfg.n_layers % pp or rows % dp)


def layout_launches(cfg, dims, rows: int) -> int:
    """Launches of each attention kernel in a step of a layout run: each
    rank's stage runs its ``n_layers / pp`` layers once, or once a
    microbatch under pp."""
    from horovod_tpu_torch.perf.costmodel import _effective_microbatches
    dp, _, pp = dims
    micro = _effective_microbatches(rows // dp, LAYOUT_N_MICRO) if pp > 1 \
        else 1
    return cfg.n_layers // pp * micro


def dp_bitwise(torch, dist, r, dims, n: int, label: str) -> None:
    """Every rank's slice checksums gathered: the ranks of one (tp, pp)
    coordinate (its dp group) hold bitwise equal parameters."""
    every = [torch.empty_like(r["local_sums"]) for _ in range(n)]
    dist.all_gather(every, r["local_sums"])
    _, tp, pp = dims
    for q in range(n):
        peer = q % (tp * pp)  # the coordinate's dp index 0
        require(torch.equal(every[q], every[peer]),
                f"layout [{label}]: rank {q}'s parameters differ from its "
                f"dp peer rank {peer}'s")


def rank_layout(torch, np, hvd, llama, F, rank: int, n: int, dev,
                big_name: str, seq: int) -> None:
    """--ranks N, after ``rank_zero``: the 3D layout plane.  (a) ``big_name``
    cut to 2 layers in fp32, AdamW at eps 1e-3, level 1, 3 steps of
    ``LAYOUT_ROWS`` x ``seq`` global, under each of ``LAYOUTS`` the config
    takes: losses within 2e-5 and gathered parameters within 1e-4 of
    (n, 1, 1)'s, which is bitwise equal to the ZeRO chain on the default
    group; parameters bitwise equal across each coordinate's dp ranks;
    level 3 at (2, 2, 1) bitwise equal to its level 1.  (b) ``big_name`` at
    full depth, bf16 with fp32 master shards, level 3, under every layout of
    (a) that ``layout_memory_bytes`` fits into the card's free memory and
    the one ``HOROVOD_LAYOUT=auto`` picks (``llama_layout_model`` priced on
    the H100 and NVLink): step ms, tokens/s per card, MFU(6N), one
    profiled step's NCCL and compute ms, peak memory, the cost model's
    prediction beside each, and losses within 0.05 of (n, 1, 1)'s."""
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import layout as Lay
    from horovod_tpu_torch.perf import costmodel
    cuda = dev.type == "cuda"
    if cuda:  # the full model's layouts run close to the card's memory
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    big = llama.CONFIGS[big_name]
    rows = LAYOUT_ROWS
    dims_list = [d for d in LAYOUTS if d[0] * d[1] * d[2] == n
                 and layout_fits(big, d, rows)]
    anchor = (n, 1, 1)

    # (a) equivalence in fp32
    cut = dataclasses.replace(big, n_layers=2, dtype=torch.float32)
    tokens = zero_tokens(np, cut.vocab, rows, seq, LAYOUT_STEPS)
    kw = dict(master_fp32=False, eps=LAYOUT_EPS, keep=True)
    chain = zero_run(torch, np, hvd, llama, F, dev, rank, n, cut, tokens,
                     rows // n, 1, **kw)
    ref, level1 = None, {}
    for dims in dims_list + [(2, 2, 1, 3)]:
        level = dims[3] if len(dims) == 4 else 1
        dims = dims[:3]
        if dims not in dims_list:
            continue
        r = zero_run(torch, np, hvd, llama, F, dev, rank, n, cut, tokens,
                     rows // dims[0], level, layout=dims,
                     n_micro=LAYOUT_N_MICRO, **kw)
        label = f"{big_name} 2 layers fp32 {dims} L{level}"
        dp_bitwise(torch, dist, r, dims, n, label)
        if cuda:
            check_zero_launches(r, layout_launches(cut, dims, rows), 1,
                                label)
        if ref is None:
            require(dims == anchor, f"layout (a) starts at {anchor}")
            ref = r
            same = chain["losses"] == r["losses"] and all(
                torch.equal(a, b) for a, b in zip(chain["params"],
                                                  r["params"]))
            require(same, f"layout [{label}] differs from the zero chain")
            del chain["params"]
        gap = max(abs(a - b) for a, b in zip(r["losses"], ref["losses"]))
        pgap = max_param_diff(r["params"], ref["params"])
        if level == 3:
            one = level1[dims]
            require(one["losses"] == r["losses"]
                    and torch.equal(one["sums"], r["sums"]),
                    f"layout [{label}]: level 3 differs from level 1")
        else:
            level1[dims] = r
        if r is not ref:
            del r["params"]
        if rank == 0:
            print(f"ranks [{n}] layout {label} ("
                  f"{cut.n_layers} layers, width {cut.dim}, "
                  f"{rows} x {seq} global): losses "
                  + " ".join(f"{x:.6f}" for x in r["losses"])
                  + f"; against {anchor}: max loss gap {gap:.3g}, max "
                  f"parameter gap {pgap:.3g}; step {r['step_ms']:.1f} ms; "
                  f"peak {r['peak_gib']:.2f} GiB; launches "
                  + json.dumps(r["launches"]), flush=True)
        require(gap <= LAYOUT_LOSS_TOL and pgap <= LAYOUT_PARAM_TOL,
                 f"layout [{label}]: loss gap {gap}, parameter gap {pgap}")
    del ref["params"]
    if rank == 0:
        print(f"ranks [{n}] layout (a): every layout within "
              f"{LAYOUT_LOSS_TOL} (losses) and {LAYOUT_PARAM_TOL} "
              f"(parameters) of {anchor}, which is bitwise equal to the "
              "zero chain; parameters bitwise equal across each "
              "coordinate's dp ranks; (2, 2, 1) level 3 bitwise equal to "
              "its level 1", flush=True)

    rank_fsdp(torch, np, hvd, llama, rank, n, dev, big_name, seq)

    # (b) the full model
    desc = costmodel.llama_layout_model(
        vocab=big.vocab, dim=big.dim, n_layers=big.n_layers,
        n_heads=big.n_heads, n_kv_heads=big.n_kv_heads,
        ffn_dim=big.ffn_dim, batch=rows, seq=seq)
    cap = None
    if cuda:
        free = torch.tensor([float(torch.cuda.mem_get_info()[0])],
                            device=dev)
        dist.all_reduce(free, op=dist.ReduceOp.MIN)
        cap = float(free.item())
    price = dict(chip="h100", link="nvlink")
    auto = Lay.resolve_layout(n, {"HOROVOD_LAYOUT": "auto", "HOROVOD_TP": 0,
                                  "HOROVOD_PP": 0, "HOROVOD_ZERO_LEVEL": 3},
                              model=desc, mem_cap_bytes=cap, **price)
    sol = costmodel.solve_layout(desc, n, mem_cap_bytes=cap, levels=(3,),
                                 n_micro=LAYOUT_N_MICRO, **price)
    ranked = {tuple(row["layout"][a] for a in ("dp", "tp", "pp")): row
              for row in sol["candidates"]}
    runs = [d for d in dims_list if ranked[d]["fits"]]
    if auto not in runs and layout_fits(big, auto, rows):
        runs.append(auto)
    if rank == 0:
        print(f"ranks [{n}] layout (b): HOROVOD_LAYOUT=auto picks {auto} "
              f"(solve_layout on llama_layout_model, h100 and nvlink, cap "
              f"{cap} B free); running {runs}", flush=True)
    tokens = zero_tokens(np, big.vocab, rows, seq,
                         WARMUP_STEPS + TIMED_STEPS + 1)
    measured = {}
    anchor_losses = None
    for dims in runs:
        if cuda and rank == 0:
            free, total = torch.cuda.mem_get_info()
            print(f"ranks [{n}] layout {dims}: before the run "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated, {free / 2**30:.2f} of {total / 2**30:.2f} "
                  "GiB free", flush=True)
        r = zero_run(torch, np, hvd, llama, F, dev, rank, n, big, tokens,
                     rows // dims[0], 3, ag_prefetch=2, master_fp32=False,
                     warmup=WARMUP_STEPS, profile=True, layout=dims,
                     n_micro=LAYOUT_N_MICRO, gather=False)
        label = f"{big_name} {dims} L3"
        dp_bitwise(torch, dist, r, dims, n, label)
        if cuda:
            check_zero_launches(r, layout_launches(big, dims, rows), 1,
                                label)
        require(all(math.isfinite(x) for x in r["losses"]),
                f"layout [{label}]: loss {r['losses']}")
        if anchor_losses is None:
            anchor_losses = r["losses"]
        gap = max(abs(a - b) for a, b in zip(r["losses"], anchor_losses))
        require(gap <= LAYOUT_BF16_LOSS_TOL,
                f"layout [{label}]: losses {r['losses']} against {anchor}'s "
                f"{anchor_losses}")
        measured[dims] = r["step_ms"]
        if rank == 0:
            pred = costmodel.layout_step_time(
                desc, *dims, zero_level=3, n_micro=LAYOUT_N_MICRO, **price)
            tok_s = rows * seq / n / (r["step_ms"] / 1e3)
            mfu = 6 * r["n_params"] * tok_s / PEAK_BF16_FLOPS
            busy = r["busy_ms"] or 0.0
            nccl = r["nccl_ms"] or 0.0
            dtype = str(big.dtype).replace("torch.", "")
            print(f"ranks [{n}] layout {label} ({r['n_params']} params, "
                  f"{dtype} parameters, fp32 master shards, {rows} x {seq} global, "
                  f"n_micro {LAYOUT_N_MICRO}): step {r['step_ms']:.1f} ms, "
                  f"{tok_s:.0f} tokens/s per card, MFU(6N) {mfu:.4f}; "
                  f"profiled step (rank 0): kernels {busy:.1f} ms, NCCL "
                  f"{nccl:.1f} ms, compute {busy - nccl:.1f} ms, idle share "
                  f"{max(0.0, 1 - busy / r['step_ms']):.3f}; peak "
                  f"{r['peak_gib']:.2f} GiB; predicted step "
                  f"{pred['step_s'] * 1e3:.1f} ms (compute "
                  f"{pred['compute_s'] * 1e3:.1f}, tp "
                  f"{pred['tp_comm_s'] * 1e3:.1f}, pp "
                  f"{pred['pp_comm_s'] * 1e3:.1f}, zero "
                  f"{pred['zero_comm_s'] * 1e3:.1f}, bubble "
                  f"{pred['bubble_fraction']:.3f}), predicted memory "
                  f"{pred['memory']['total_bytes']} B, solver rank "
                  f"{ranked[dims]['rank']}; losses "
                  + " ".join(f"{x:.4f}" for x in r["losses"])
                  + f" (max gap to {anchor} {gap:.3g}); launches "
                  + json.dumps(r["launches"]), flush=True)
    if rank == 0:
        order = sorted(measured, key=measured.get)
        print(f"ranks [{n}] layout (b): measured order "
              + ", ".join(f"{d} {measured[d]:.1f} ms" for d in order)
              + "; solver order "
              + ", ".join(f"{d} #{ranked[d]['rank']}" for d in sorted(
                  measured, key=lambda d: ranked[d]["rank"])), flush=True)


def rank_fsdp(torch, np, hvd, llama, rank: int, n: int, dev,
              big_name: str, seq: int) -> None:
    """--ranks N, (c): ``make_fsdp_train_step`` (DTensor) on ``big_name``
    cut to 2 layers in fp32, SGD, one step of ``LAYOUT_ROWS`` x ``seq`` on
    the device mesh (dp, fsdp, tp) = ``FSDP_MESH``, against the same step
    of the plain model on rank 0 (tests/test_fsdp.py's tolerances: loss
    rtol 1e-5, parameters atol 1e-5); each rank holds a quarter of wq."""
    import dataclasses
    import gc as _gc
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from horovod_tpu_torch.parallel import fsdp as FS
    cfg = dataclasses.replace(llama.CONFIGS[big_name], n_layers=2,
                              dtype=torch.float32)
    mesh = init_device_mesh(dev.type, FSDP_MESH, mesh_dim_names=FS.MESH_AXES)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (LAYOUT_ROWS, seq + 1)))

    def seeded():
        return llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    model = seeded()
    FS.shard_params(model, mesh, FS.llama_param_specs(model, mesh=mesh))
    opt = FS.init_opt_state(torch.optim.SGD, model, lr=FSDP_LR)
    step = FS.make_fsdp_train_step(model, FS.llama_loss_fn, opt, mesh,
                                   batch_spec=(("dp", "fsdp"),))
    t0 = time.perf_counter()
    loss = float(step(ids))
    dt = time.perf_counter() - t0
    wq = model.layers[0].wq.weight
    require(wq.to_local().numel() * 4 == wq.numel(),
            f"fsdp: rank {rank} holds {wq.to_local().numel()} of "
            f"{wq.numel()} wq entries")
    plain = plain_loss = None
    if rank == 0:
        plain = seeded()
        popt = torch.optim.SGD(plain.parameters(), lr=FSDP_LR)
        pl = llama.loss_fn(plain, ids.to(dev))
        pl.backward()
        popt.step()
        plain_loss = float(pl.detach())
        del popt, pl
    pgap = 0.0
    for name, p in model.named_parameters():
        full = p.full_tensor()
        if rank == 0:
            want = plain.get_parameter(name)
            pgap = max(pgap, float((full - want).abs().max()))
        del full
    if rank == 0:
        print(f"ranks [{n}] fsdp (c) {big_name} 2 layers fp32 on mesh "
              f"(dp, fsdp, tp) = {FSDP_MESH}, SGD, {LAYOUT_ROWS} x {seq}: "
              f"loss {loss:.6f} against the plain step's {plain_loss:.6f}; "
              f"max parameter gap {pgap:.3g}; each rank holds 1/4 of wq; "
              f"the step took {dt:.1f} s (its first: sharding propagation "
              "included)", flush=True)
        require(abs(loss - plain_loss) <= 1e-5 * abs(plain_loss)
                and pgap <= 1e-5,
                f"fsdp: loss {loss} vs {plain_loss}, parameter gap {pgap}")
    del model, opt, step, plain
    _gc.collect()
    for dim in range(len(FSDP_MESH)):  # the mesh's own subgroups
        group = mesh.get_group(dim)
        if dist.get_world_size(group) < n:
            dist.destroy_process_group(group)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sum_bound(xs, eps: float):
    """Rounding bound of a sum of ``xs`` (one tensor per rank) taken in
    any order: (n + 1) * eps * sum |x| elementwise."""
    return (len(xs) + 1) * eps * sum(x.abs() for x in xs)


def rank_op_checks(torch, ht, rank: int, n: int, dev) -> int:
    """Every eager op across the ranks against an oracle the rank computes
    from every rank's inputs (seeded per rank, rebuilt here).  Copies must
    be exact; reductions within their rounding bound in the tensor's
    dtype."""
    checks = 0
    for dtype, eps in ((torch.float32, 2.0 ** -24), (torch.bfloat16, 2.0 ** -8)):
        xs = [torch.randn(64, 257, generator=torch.Generator().manual_seed(
            100 + r)).to(dtype).double() for r in range(n)]
        x = xs[rank].to(dev, dtype)
        prod = xs[0].clone()
        for t in xs[1:]:
            prod = prod * t
        oracle = {
            ht.Sum: (sum(xs), sum_bound(xs, eps)),
            ht.Average: (sum(xs) / n, sum_bound(xs, eps) / n),
            ht.Min: (torch.stack(xs).min(0).values, 0.0),
            ht.Max: (torch.stack(xs).max(0).values, 0.0),
            ht.Product: (prod, (n + 1) * eps * prod.abs())}

        def close(name, got, want, bound):
            nonlocal checks
            err = (got.double().cpu() - want).abs()
            over = (err > bound).sum().item()
            require(got.dtype == dtype and got.device == x.device
                    and got.shape == want.shape and over == 0,
                    f"rank {rank} {name} {dtype}: {over} entries off, max "
                    f"err {err.max().item()}")
            checks += 1
        for op, (want, bound) in oracle.items():
            close(f"allreduce {op.name}", ht.allreduce(x, op=op), want, bound)
        want, bound = oracle[ht.Sum]
        close("allreduce scaled", ht.allreduce(
            x, op=ht.Sum, prescale_factor=2.0, postscale_factor=0.25),
            want * 0.5, bound * 0.5)
        y = x.clone()
        require(ht.allreduce_(y, op=ht.Sum) is y, "allreduce_")
        close("allreduce_", y, want, bound)
        handles = [ht.allreduce_async(x, op=ht.Average,
                                      name=f"ranks.async.{dtype}.{i}")
                   for i in range(3)]
        for h in reversed(handles):  # waited in another order
            close("allreduce_async", ht.synchronize(h), *oracle[ht.Average])
        g = ht.grouped_allreduce([x, x[:5].float()], op=ht.Sum)
        close("grouped_allreduce", g[0], want, bound)
        require(g[1].dtype == torch.float32, "grouped dtype")
        close("allgather", ht.allgather(x), torch.cat(xs), 0.0)
        close("broadcast", ht.broadcast(x, root_rank=n - 1), xs[n - 1], 0.0)
        # rank r sends (r + j) % 3 + 1 rows to rank j
        send = [(rank + j) % 3 + 1 for j in range(n)]
        rows = torch.arange(sum(send), dtype=torch.float64)[:, None] \
            + 1000 * rank
        out, recv = ht.alltoall(rows.to(dev, dtype).expand(-1, 8).contiguous(),
                                torch.tensor(send))
        theirs = [(r + rank) % 3 + 1 for r in range(n)]
        expect = torch.cat([
            (torch.arange(sum((r + j) % 3 + 1 for j in range(rank)),
                          sum((r + j) % 3 + 1 for j in range(rank + 1)),
                          dtype=torch.float64) + 1000 * r)[:, None]
            for r in range(n)]).expand(-1, 8).to(dtype).double()
        require(recv.tolist() == theirs, f"alltoall splits {recv.tolist()}")
        close("alltoall", out, expect, 0.0)
        rs = ht.reducescatter(x, op=ht.Sum)
        rows_per = 64 // n
        sl = slice(rank * rows_per, (rank + 1) * rows_per)
        close("reducescatter", rs, want[sl], bound[sl])
    ht.barrier()
    return checks


def rank_train(torch, np, hvd, ht, llama, F, mpi_ops, rank, n, dev,
               cfg_name: str, batch: int, seq: int, eager: bool) -> dict:
    """The 1b data-parallel step across the ranks through the root
    package's optimizer or the eager API's hook-driven one: losses, step
    ms and, on rank 0, one profiled step."""
    cfg = llama.CONFIGS[cfg_name]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    api = ht if eager else hvd
    opt = api.DistributedOptimizer(adamw,
                                   named_parameters=model.named_parameters())
    api.broadcast_parameters(model.state_dict(), root_rank=0)
    api.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (batch * n, seq + 1), dtype=np.int32))
        for _ in range(WARMUP_STEPS + TIMED_STEPS + 1)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    F.reset_launches()
    before = mpi_ops.stats() if eager else None
    losses = [step(b) for b in batches[:WARMUP_STEPS]]
    sync()
    t0 = time.perf_counter()
    for b in batches[WARMUP_STEPS:-1]:
        losses.append(step(b))
    sync()
    dt = time.perf_counter() - t0
    prof = None
    if rank == 0 and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.append(step(batches[-1]))
            sync()
    else:
        losses.append(step(batches[-1]))
    sync()
    out = {"losses": [float(x) for x in losses],
           "step_ms": dt / TIMED_STEPS * 1e3,
           "launches": dict(F.LAUNCHES), "prof": prof}
    if eager:
        after = mpi_ops.stats()
        out["per_step"] = {k: (after[k] - before[k]) / len(batches)
                           for k in after}
    del step, opt, adamw, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# --ranks N, the wire and overlap planes: (label, ranks per host as a
# divisor of N (1: flat), microbatches k, optimizer arguments, env knobs)
WIRE_CONFIGS = (
    ("none", 1, 1, dict(wire_policy="none", error_feedback=True), {}),
    ("bf16", 1, 1, dict(wire_policy="bf16", error_feedback=True), {}),
    ("fp16", 1, 1, dict(wire_policy="fp16", error_feedback=True), {}),
    ("int8_ring", 1, 1, dict(wire_policy="int8_ring", error_feedback=True),
     {}),
    ("auto", 1, 1, dict(wire_policy="auto", error_feedback=True), {}),
    ("overlap k=4 depth 0", 1, 4, dict(wire_policy="none", overlap=True,
                                       overlap_depth=0), {}),
    ("overlap k=4 depth 1", 1, 4, dict(wire_policy="none", overlap=True,
                                       overlap_depth=1), {}),
    ("2x2 hierarchical none", 2, 1, dict(wire_policy="none"),
     {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}),
    ("2x2 dcn_int8", 2, 1, dict(wire_policy="dcn_int8", error_feedback=True),
     {}),
)


def param_checksums(torch, params):
    """Two int64 sums of each parameter's bits (plain and position
    weighted): equal rows on two ranks mean bitwise equal parameters, to
    a collision's chance."""
    rows = []
    for p in params:
        bits = p.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        rows.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return torch.stack(rows)


def kernel_ms(prof) -> tuple:
    """(all CUDA kernels' ms, NCCL kernels' ms) of a profiled step."""
    from torch.autograd import DeviceType
    busy = nccl = 0.0
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        busy += evt.self_device_time_total / 1e3
        if kernel_kind(evt.key) == "nccl":
            nccl += evt.self_device_time_total / 1e3
    return busy, nccl


def ring_sync_free(torch, dev, rank: int) -> None:
    """One 128 MiB fp32 bucket through the int8 ring under
    ``torch.cuda.set_sync_debug_mode("error")``: no host wait (no
    ``.item()``, no branch on the scale); the result equals the warm-up
    call's and every rank's."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops.quantized import quantized_ring_allreduce
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    x = torch.randn(32 * 1024 * 1024, generator=gen, device=dev)
    warm = quantized_ring_allreduce(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = quantized_ring_allreduce(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(torch.equal(out, warm), "int8 ring not deterministic")
    sums = param_checksums(torch, [out])
    every = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(every, sums)
    require(all(torch.equal(e, every[0]) for e in every),
            "int8 ring results differ across ranks")
    if rank == 0:
        print(f"ranks [{dist.get_world_size()}] int8 ring: one 128 MiB fp32 "
              "bucket under set_sync_debug_mode('error') made no host "
              "wait; bitwise equal across ranks", flush=True)


def rank_wire(torch, np, hvd, llama, F, rank, n, dev, cfg_name, batch, seq,
              label, k, kw, ref_losses):
    """One wire configuration of --ranks N: the model with fp32 master
    weights and bf16 compute (``cast_params``), 8 steps of batch x seq per
    rank through ``make_microbatched_train_step``; losses, step ms,
    modeled wire bytes per step, parameters bitwise equal across ranks
    (checksum allgather), and on rank 0 one profiled step's NCCL time."""
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.ops import fusion, wire
    cfg = dataclasses.replace(llama.CONFIGS[cfg_name], dtype=torch.bfloat16)
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev).float()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=k, **kw)
    step = hvd.make_microbatched_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            ce_chunks=8), opt, k,
        compute_dtype=torch.bfloat16)
    params = list(model.parameters())
    plan = fusion.make_plan([tuple(p.shape) for p in params],
                            [p.dtype for p in params],
                            hvd.runtime.get().fusion_threshold())
    formats = wire.plan_formats(plan, wire.get_policy(kw["wire_policy"]),
                                hvd.Average)
    syncs = k if kw.get("overlap") else 1
    modeled = syncs * sum(wire.modeled_wire_bytes(
        sum(b.sizes), b.dtype.itemsize, f, wire._axis_sizes())["bottleneck"]
        for b, f in zip(plan.buckets, formats))
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (batch * n, seq + 1), dtype=np.int32)).view(
            k, batch * n // k, seq + 1)
        for _ in range(WARMUP_STEPS + TIMED_STEPS + 1)]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    losses = [step(b) for b in batches[:WARMUP_STEPS]]
    sync()
    t0 = time.perf_counter()
    losses += [step(b) for b in batches[WARMUP_STEPS:-1]]
    sync()
    step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    prof_ms = None
    if rank == 0 and cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.append(step(batches[-1]))
            sync()
        prof_ms = kernel_ms(prof)
    else:
        losses.append(step(batches[-1]))
    sync()
    losses = [float(x) for x in losses]
    sums = param_checksums(torch, params)
    every = [torch.empty_like(sums) for _ in range(n)]
    dist.all_gather(every, sums)
    equal = all(torch.equal(e, every[0]) for e in every)
    require(all(math.isfinite(x) for x in losses), f"{label}: loss {losses}")
    require(equal, f"{label}: parameters differ across the {n} ranks after "
            f"step {len(losses)}")
    if cuda:
        require(all(v > 0 for v in F.LAUNCHES.values()),
                f"{label}: an attention kernel was not launched")
    if rank == 0:
        fmts = {f: formats.count(f) for f in sorted(set(formats))}
        gaps = ("" if ref_losses is None else "; loss - none's: " + " ".join(
            f"{a - b:+.2e}" for a, b in zip(losses, ref_losses)))
        print(f"ranks [{n}] wire {label} ({cfg_name}, fp32 master weights, "
              f"bf16 compute, k={k} x {batch * n // k} x {seq}): step "
              f"{step_ms:.1f} ms; "
              + ("not profiled" if prof_ms is None else
                 f"profiled step: kernels {prof_ms[0]:.1f} ms (idle share "
                 f"{max(0.0, 1 - prof_ms[0] / step_ms):.3f}), NCCL "
                 f"{prof_ms[1]:.1f} ms")
              + f"; modeled wire bytes/step "
              f"{modeled:.0f} (buckets by format {json.dumps(fmts)}); "
              f"losses " + " ".join(f"{x:.5f}" for x in losses) + gaps
              + f"; parameters bitwise equal on all {n} ranks: {equal}"
              + (f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
                 " GiB" if cuda else ""), flush=True)
    del step, opt, model, params
    gc.collect()  # every configuration starts from the same free memory
    if cuda:
        torch.cuda.empty_cache()
    return losses


def rank_wires(torch, np, hvd, llama, F, rank, n, dev, cfg_name, batch, seq,
               local: int, ref_losses):
    """The WIRE_CONFIGS of one layout (``local`` ranks per host)."""
    for label, div, k, kw, env in WIRE_CONFIGS:
        if n // div != local:
            continue
        os.environ.update(env)
        try:
            losses = rank_wire(torch, np, hvd, llama, F, rank, n, dev,
                               cfg_name, batch, seq, label, k, kw,
                               ref_losses)
        finally:
            for key in env:
                os.environ.pop(key)
        if ref_losses is None:
            ref_losses = losses
    return ref_losses


# --ranks N's parts: "dp" is the data-parallel planes of PRs 6-9 (the eager
# path, the wire configurations, ZeRO and the layouts), then (d), (e), (f)
RANK_PARTS = ("dp", "sequence", "expert", "adasum", "serve", "measure",
              "perf", "postmortem", "elastic", "zoo", "cluster", "estimator")


def rank_worker(spec: dict) -> None:
    """One rank of ``--ranks N`` (``--rank-worker <json>``): one process,
    one card, started by the port's launcher, whose env gives its rank and
    the job's size.  ``spec``: the free ports for the process groups and
    controllers of the parts, by name (``store``, ``ctrl``, ``wire``,
    ``layout``, ``seq``, ``ctrl2``, ``hier``; the launcher was given
    ``store`` and ``ctrl`` as its coordinator and controller ports), and
    ``cfg``, ``device``, ``batch``, ``seq`` and ``parts``.  With N >= 4
    and even, the two-level wire configurations and Adasum run on process
    groups laid out as two hosts of N/2 ranks.  A rank that fails prints
    its traceback and exits at once: the launcher then ends its peers,
    waiting in a collective, instead of their waiting out NCCL's timeout.
    With N = 4 the layout plane (``rank_layout``) runs after the ZeRO
    chain, on a flat group of its own; sequence and expert parallelism and
    Adasum run last, on another."""
    try:
        rank_run(int(os.environ["HOROVOD_RANK"]),
                 int(os.environ["HOROVOD_SIZE"]), spec["ports"], spec["cfg"],
                 spec["device"], spec["batch"], spec["seq"],
                 tuple(spec["parts"]), spec.get("zoo_ref"),
                 spec.get("out_dir"))
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def rank_env(rank: int, local: int, port: int, **extra) -> None:
    os.environ.update(HOROVOD_RANK=str(rank),
                      HOROVOD_LOCAL_RANK=str(rank % local),
                      HOROVOD_LOCAL_SIZE=str(local),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}", **extra)


def rank_run(rank, n, ports, cfg_name, device_type, batch, seq,
             parts, zoo_ref=None, out_dir=None) -> None:
    os.environ["HOROVOD_SIZE"] = str(n)
    rank_env(rank, n, ports["store"],
             HOROVOD_CONTROLLER_PORT=str(ports["ctrl"]))
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    from horovod_tpu_torch.torch import mpi_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device_type == "cuda"
    if not cuda:  # a rehearsal on gloo ranks
        torch.set_num_threads(1)
    big_name = "8b" if cuda else cfg_name
    dev = ht.init(device=None if cuda else device_type).device
    if "cluster" in parts:
        # --parts cluster's reference: the dp part's direct step
        r = rank_train(torch, np, hvd, ht, llama, F, mpi_ops, rank, n, dev,
                       cfg_name, batch, seq, eager=False)
        if rank == 0:
            with open(os.path.join(out_dir, "reference.json"), "w") as f:
                json.dump(r["losses"], f)
    if "dp" in parts:
        rank_dp(torch, np, hvd, ht, llama, F, mpi_ops, rank, n, dev, cfg_name,
                device_type, batch, seq, big_name, ports)
    ht.shutdown()
    if "zoo" in parts:
        # the model zoo on a flat group of its own
        rank_env(rank, n, ports["zoo"], HOROVOD_CONTROLLER="none")
        hvd.init(device=dev)
        rank_zoo(torch, np, hvd, rank, n, dev, device_type, zoo_ref)
        hvd.shutdown()
    if not {"sequence", "expert", "adasum"} & set(parts):
        return
    # a flat group of their own, after the layouts have released theirs;
    # the eager delta optimizer negotiates through a controller of its own
    rank_env(rank, n, ports["seq"], HOROVOD_CONTROLLER="auto",
             HOROVOD_CONTROLLER_PORT=str(ports["ctrl2"]))
    hvd.init(device=dev)
    if "sequence" in parts:
        if cuda:
            rank_sequence(torch, np, hvd, llama, F, rank, n, dev, "1b",
                          (SEQ_EQ_LAYERS, None), SEQ_LEN, SEQ_SHORT)
        else:  # the rehearsal: tiny with a kv head a rank for Ulysses,
            # 64 and 32 tokens
            rank_sequence(torch, np, hvd, llama, F, rank, n, dev, cfg_name,
                          (None, None), 64, 32, n_kv_heads=n)
    if "expert" in parts:
        rank_expert(torch, np, hvd, rank, n, dev)
    if "adasum" in parts:
        rank_adasum(torch, np, hvd, ht, llama, F, rank, n, dev, cfg_name,
                    batch, seq)
    hvd.shutdown()
    if "adasum" in parts and n >= 4 and n % 2 == 0:
        rank_env(rank, n // 2, ports["hier"], HOROVOD_CONTROLLER="none")
        hvd.init(device=dev)
        require(hvd.runtime.get().hierarchy is not None,
                "no two-level layout")
        rank_adasum_two_level(torch, np, hvd, rank, n, dev)
        hvd.shutdown()


def rank_dp(torch, np, hvd, ht, llama, F, mpi_ops, rank, n, dev, cfg_name,
            device_type, batch, seq, big_name, ports) -> None:
    """The data-parallel planes of --ranks N: every eager op, the root and
    hook-driven optimizers, the wire configurations (flat and two-level),
    the ZeRO chain and, at N = 4, the layouts."""
    checks = rank_op_checks(torch, ht, rank, n, dev)
    require(mpi_ops.engine().core is not None, "no native controller")
    if rank == 0:
        print(f"ranks [{n}] eager ops: {checks} checks per rank across "
              f"{n} ranks within their bounds; negotiated "
              f"{mpi_ops.stats()['responses']} responses", flush=True)
    runs = {}
    for eager in (False, True):
        runs[eager] = rank_train(torch, np, hvd, ht, llama, F, mpi_ops, rank,
                                 n, dev, cfg_name, batch, seq, eager)
    direct, hook = runs[False], runs[True]
    for i, (a, b) in enumerate(zip(direct["losses"], hook["losses"])):
        require(math.isfinite(a) and abs(a - b) <= EAGER_LOSS_TOL,
                f"rank {rank} step {i}: hook-path loss {b} vs direct {a}")
    if device_type == "cuda":
        for r in runs.values():
            require(all(v > 0 for v in r["launches"].values()),
                    f"an attention kernel was not launched: {r['launches']}")
    if rank == 0:
        tok = batch * seq
        for label, r in (("direct", direct), ("eager hook", hook)):
            print(f"ranks [{n}] {cfg_name} {label}: losses "
                  + " ".join(f"{x:.5f}" for x in r["losses"])
                  + f"; step {r['step_ms']:.1f} ms, "
                  f"{tok / r['step_ms'] * 1e3:.0f} tokens/s per card; "
                  f"launches {json.dumps(r['launches'])}", flush=True)
            if r["prof"] is not None:
                report_profile(r["prof"], f"ranks [{n}] {label}",
                               r["step_ms"])
        print(f"ranks [{n}] eager hook path per step: "
              + ", ".join(f"{v:.1f} {k}" for k, v in
                          hook["per_step"].items())
              + f"; step ratio hook / direct "
              f"{hook['step_ms'] / direct['step_ms']:.3f}", flush=True)
    if device_type == "cuda":
        ring_sync_free(torch, dev, rank)
    ref = rank_wires(torch, np, hvd, llama, F, rank, n, dev, cfg_name, batch,
                     seq, n, None)
    two_level = n >= 4 and n % 2 == 0
    if not two_level:
        rank_zero(torch, np, hvd, llama, F, rank, n, dev, cfg_name, batch,
                  seq, ref, big_name)
    ht.shutdown()
    if not two_level:
        if rank == 0:
            print(f"ranks [{n}] two-level wire configurations need 4 or "
                  "more ranks, an even number: not run", flush=True)
    else:
        # two "hosts" on this one: each process keeps its own card
        rank_env(rank, n // 2, ports["wire"], HOROVOD_CONTROLLER="none")
        hvd.init(device=dev)
        require(hvd.runtime.get().hierarchy is not None,
                "no two-level layout")
        rank_wires(torch, np, hvd, llama, F, rank, n, dev, cfg_name, batch,
                   seq, n // 2, ref)
        # the zero chain reduces over the whole group, flat
        rank_zero(torch, np, hvd, llama, F, rank, n, dev, cfg_name, batch,
                  seq, ref, big_name)
        hvd.shutdown()
    if n != 4:
        if rank == 0:
            print(f"ranks [{n}] the layouts are four-rank layouts: not run",
                  flush=True)
        return
    # a flat group of its own, so that no earlier communicator holds
    # device memory beside the full model's layouts
    rank_env(rank, n, ports["layout"], HOROVOD_CONTROLLER="none")
    hvd.init(device=dev)
    rank_layout(torch, np, hvd, llama, F, rank, n, dev, big_name, seq)
    hvd.shutdown()


RANK_PORTS = ("store", "ctrl", "wire", "layout", "seq", "ctrl2", "hier",
              "zoo")


def ranks_argv(n: int, parts, cfg_name: str = "1b",
               device_type: str = "cuda", batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, zoo_ref=None, out_dir=None) -> list:
    """The port launcher's arguments for ``--ranks N``: ``-np N`` (with
    ``--gpu`` on the card) and free coordinator and controller ports, each
    rank ``chip_smoke.py --rank-worker <json>``; ``zoo_ref`` is one card's
    ResNet-50 images/s, which ``--parts zoo`` scales against; ``out_dir``
    is where the ``cluster`` part's reference lands."""
    ports = {}
    while len(set(ports.values())) < len(RANK_PORTS):  # distinct ports
        ports = {name: free_port() for name in RANK_PORTS}
    spec = {"ports": ports, "cfg": cfg_name, "device": device_type,
            "batch": batch, "seq": seq, "parts": list(parts),
            "zoo_ref": zoo_ref, "out_dir": out_dir}
    return (["-np", str(n)] + (["--gpu"] if device_type == "cuda" else [])
            + ["--coordinator-port", str(ports["store"]),
               "--controller-port", str(ports["ctrl"]), sys.executable,
               os.path.abspath(__file__), "--rank-worker",
               json.dumps(spec)])


def phase_ranks(torch, n: int, parts) -> None:
    """``--ranks N``: the paths across N cards, one process each, started
    by the port's launcher (``runner/launch.py``)."""
    from horovod_tpu_torch.runner import launch
    require(torch.cuda.device_count() >= n,
            f"--ranks {n} needs {n} cards, {torch.cuda.device_count()} seen")
    worker_parts = [p for p in parts
                    if p not in ("serve", "measure", "perf", "postmortem",
                                 "elastic", "cluster", "estimator")]
    zoo_ref = None
    if "zoo" in parts:
        # one card's ResNet-50 at the recipe, the ranks' scaling reference
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import zoo
        dev = hvd.init().device
        zoo_ref = zoo_cnn_run(torch, hvd, zoo, "resnet50", dev,
                              more=ZOO_R50_MORE,
                              label="ranks [1] zoo")["img_s_card"]
        hvd.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    if worker_parts:
        rc = launch.run_commandline(ranks_argv(n, worker_parts,
                                               zoo_ref=zoo_ref))
        require(rc == 0, f"--ranks {n}: the launcher returned {rc}")
    if "serve" in parts:
        # the serving fleet: the parent starts the launcher in --serve
        # mode and is the client (no --rank-worker)
        import numpy as np
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_serve(torch, np, n, card)
    if "measure" in parts:
        # the measurement plane: the parent starts the launcher with the
        # plane's flags and reads what the ranks report
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_measure(torch, n, card)
    if "perf" in parts:
        # the perf plane at ZeRO level 3: the parent starts the launcher
        # with HOROVOD_PERF and reads GET /perf
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_perf(torch, n, card)
    if "postmortem" in parts:
        # the forensics planes: the parent starts one launch an experiment
        # under --postmortem --alerts --chaos and reads what it leaves
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_postmortem(torch, n, card)
    if "elastic" in parts:
        # elastic training and serving: the parent starts one elastic
        # launch an experiment and reads what the rounds leave
        import numpy as np
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_elastic(torch, np, n, card)
    if "cluster" in parts:
        # placement through the cluster layer: the parent places the tasks
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_cluster(torch, n, card)
    if "estimator" in parts:
        # the estimators: the parent fits them, their tasks on the cards
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        rank_estimator(torch, n, card)


LAUNCH_STEPS = 3         # phase 13: 1 warm-up and 2 timed steps


def launched_worker(out_dir: str) -> int:
    """``--launched DIR``: phase 13's worker, started by the port's
    launcher (``-np 1 --gpu``).  Phase 5's configuration (``1b`` at full
    width and depth, bf16, AdamW, the flash kernels, ``ce_chunks=8``, the
    same seeded weights and the first ``LAUNCH_STEPS`` of its batches)
    through ``DistributedOptimizer`` on ``cuda:<local rank>``; its losses,
    step times, the kernels' launches and its clock readings land in
    ``DIR/launched.json``."""
    t_main = time.time()
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = hvd.init().device
    require(dev.type == "cuda", f"the launched worker runs on {dev}")
    t_init = time.time()
    cfg = llama.CONFIGS["1b"]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH * hvd.size(), TRAIN_SEQ + 1),
        dtype=np.int32)).to(dev) for _ in range(LAUNCH_STEPS)]
    torch.cuda.synchronize()
    t_ready = time.time()
    F.reset_launches()
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(step(b)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    report = {"losses": losses, "step_ms": step_ms,
              "launches": dict(F.LAUNCHES), "device": str(dev),
              "rank": hvd.rank(), "size": hvd.size(), "t_main": t_main,
              "t_init": t_init, "t_ready": t_ready,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "scenario": launched_scenario(hvd)}
    hvd.shutdown()
    with open(os.path.join(out_dir, "launched.json"), "w") as f:
        json.dump(report, f)
    return 0


def launched_scenario(hvd) -> dict:
    """What phase 13's worker finds of the launch's ``--scenario``: the
    spec at KV scope ``scenario`` and the digest of the trace regenerated
    from it, the events of the merged chaos plan its injector holds, and
    the rules published at KV scope ``alerts``."""
    from horovod_tpu_torch.runner.http_client import get_kv
    from horovod_tpu_torch.scenario import (KV_KEY, KV_SCOPE, events_digest,
                                            generate_events, loads_scenario)
    addr = os.environ["HOROVOD_RENDEZVOUS_ADDR"]
    port = int(os.environ["HOROVOD_RENDEZVOUS_PORT"])
    raw = get_kv(addr, port, KV_SCOPE, KV_KEY, timeout=30)
    require(raw is not None, "no scenario spec at KV scope 'scenario'")
    spec = loads_scenario(raw.decode())
    injector = hvd.chaos.active()
    require(injector is not None, "no chaos injector from the storm")
    rules = json.loads(get_kv(addr, port, "alerts", "rules", timeout=30))
    return {"name": spec.name,
            "digest": events_digest(generate_events(spec.seed, spec.phases,
                                                    spec.vocab)),
            "chaos": [[e.kind, e.rank, e.step] for e in
                      injector.spec.events],
            "rules": sorted(r["name"] for r in rules["rules"])}


def launched_allreduce(n: int) -> dict:
    """``run()``'s function in phase 13: a one-rank NCCL allreduce of a
    CUDA tensor of ``n`` elements."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    dev = hvd.init().device
    t = torch.arange(n, dtype=torch.float32, device=dev)
    dist.all_reduce(t)
    out = {"device": t.device.type, "backend": dist.get_backend(),
           "sum": float(t.double().sum()), "size": hvd.size()}
    hvd.shutdown()
    return out


def phase_launch(torch, card: str, ref_losses, ref_step_ms: float) -> dict:
    """Phase 13: phase 5's step started through the port's launcher as a
    user starts it, ``python -m horovod_tpu_torch.runner.launch -np 1 --gpu
    ... python3 chip_smoke.py --launched DIR``, with free coordinator and
    controller ports (never the defaults), then ``horovod_tpu_torch.run``
    of a one-rank NCCL allreduce on the card.  Returns the launched
    worker's kernel launches."""
    import shutil
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner import launch
    torch.cuda.empty_cache()
    print(f"launch: parent holds {torch.cuda.memory_reserved()} bytes "
          "reserved after empty_cache", flush=True)
    print(launch.check_build(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    ports = [free_port(), free_port()]
    require(not {29500, 29499} & set(ports), f"ports {ports}")
    scen_path = os.path.join(out_dir, "scenario.json")
    with open(scen_path, "w") as f:
        json.dump(LAUNCH_SCENARIO, f)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "1", "--gpu", "--coordinator-port", str(ports[0]),
           "--controller-port", str(ports[1]), "--output-filename", out_dir,
           "--scenario", scen_path,
           sys.executable, os.path.abspath(__file__), "--launched", out_dir]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=here, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        rc = "killed at 600 s"
    wall = time.time() - t0
    if rc != 0:
        for stream in ("stdout", "stderr"):
            fp = os.path.join(out_dir, "rank.0", stream)
            if os.path.exists(fp):
                with open(fp, errors="replace") as f:
                    print(f"launch: worker {stream} tail:\n"
                          + f.read()[-4000:], flush=True)
    require(rc == 0, f"the launched 1b worker: launcher returned {rc}")
    with open(os.path.join(out_dir, "launched.json")) as f:
        r = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    ref = ref_losses[:LAUNCH_STEPS]
    diffs = [abs(a - b) for a, b in zip(r["losses"], ref)]
    bitwise = r["losses"] == ref
    timed = r["step_ms"][1:]
    ms = sum(timed) / len(timed)
    print(f"launch [1b -np 1 --gpu] {r['device']} rank {r['rank']} of "
          f"{r['size']}: losses " + " ".join(f"{x:.5f}" for x in r["losses"])
          + " (phase 5: " + " ".join(f"{x:.5f}" for x in ref)
          + f"), max |diff| {max(diffs):.3g}, bitwise equal: {bitwise}",
          flush=True)
    print(f"launch [1b] [{card}]: step {ms:.1f} ms (steps 2-{LAUNCH_STEPS}, "
          f"each {', '.join(f'{x:.1f}' for x in timed)}; phase 5 "
          f"{ref_step_ms:.1f} ms); first step {r['step_ms'][0]:.1f} ms; "
          f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB; worker's python "
          f"up {r['t_main'] - t0:.2f} s after the launch, hvd.init done at "
          f"{r['t_init'] - t0:.2f} s, model and optimizer ready at "
          f"{r['t_ready'] - t0:.2f} s; launcher exited at {wall:.2f} s",
          flush=True)
    print("launch [1b] launches " + json.dumps(r["launches"]), flush=True)
    require(r["device"].startswith("cuda"), f"worker device {r['device']}")
    for i, d in enumerate(diffs):
        require(d <= EAGER_LOSS_TOL, f"launched step {i}: loss "
                f"{r['losses'][i]} vs phase 5's {ref[i]}")
    from horovod_tpu_torch.models import llama
    layers = llama.CONFIGS["1b"].n_layers
    for name in REPLACES:
        require(r["launches"].get(name) == layers * LAUNCH_STEPS,
                f"{name} launched {r['launches'].get(name)} times in the "
                f"launched worker, expected {layers * LAUNCH_STEPS}")

    from horovod_tpu_torch import scenario
    spec = scenario.parse_scenario(LAUNCH_SCENARIO)
    want = {"name": spec.name,
            "digest": scenario.events_digest(scenario.generate_events(
                spec.seed, spec.phases, spec.vocab)),
            "chaos": [[e.kind, e.rank, e.step] for e in scenario.to_chaos_spec(
                spec.storm, spec.tick_s, seed=spec.seed).events]}
    got = r["scenario"]
    print(f"launch [--scenario {spec.name}]: the worker's digest "
          f"{got['digest']}, chaos events {got['chaos']}, rules "
          f"{got['rules']}", flush=True)
    require({k: got[k] for k in want} == want,
            f"launch --scenario: the worker found {got}, want {want}")
    require({"chip-smoke-scenario-rule", "straggler-suspect"}
            <= set(got["rules"]), f"launch --scenario: rules {got['rules']}")

    import chip_smoke as this  # importable by name in the run() workers
    n = 1 << 20
    t0 = time.time()
    res = hvd.run(this.launched_allreduce, args=(n,), np=1,
                  coordinator_port=free_port())
    print(f"launch [run(fn, np=1)]: {json.dumps(res)} in "
          f"{time.time() - t0:.2f} s", flush=True)
    require(len(res) == 1 and res[0]["device"] == "cuda"
            and res[0]["backend"] == "nccl"
            and res[0]["sum"] == float(n * (n - 1) // 2),
            f"run(): {res}")
    return r["launches"]


FLEET_TTL = 900          # the fleets' --serve-ttl: a backstop, the drain ends them
FLEET_DEADLINE = 600     # seconds a fleet launch may take from start to exit
FLEET_PREFILL_RANKS = 2  # --parts serve: ranks 0-1 prefill, 2-3 decode
# seconds a fleet's reads may wait for what they count: the engines' stats
# after the streams, the scrape (and, as long again, the merged timeline),
# and the idle heartbeats; a CPU rehearsal beside a loaded run waits longer
FLEET_SETTLE_S, FLEET_SCRAPE_S, FLEET_HEALTH_S = 10.0, 30.0, 30.0


def http_json(port: int, method: str, path: str, body=None,
              timeout: float = 60.0):
    """``(status, decoded JSON or None)`` of one request to the router."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw) if raw else None
        except ValueError:
            return resp.status, None
    finally:
        conn.close()


def start_fleet_clients(port: int, prompts: list, new_tokens: int):
    """``POST /generate`` of every prompt at once, one thread each, reading
    each ndjson stream as it arrives: per request the send time, the
    replica that serves it, each part's arrival time and tokens, and the
    done record, filled in place.  Returns the records and the threads."""
    out = [{"parts": [], "done": None, "error": None} for _ in prompts]

    def client(i: int) -> None:
        rec = out[i]
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=FLEET_DEADLINE)
            body = json.dumps({"tokens": prompts[i],
                               "max_new_tokens": new_tokens}).encode()
            rec["t_send"] = time.perf_counter()
            conn.request("POST", "/generate", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            rec["status"] = resp.status
            rec["rid"] = resp.getheader("X-Serve-Request-Id")
            rec["replica"] = resp.getheader("X-Serve-Replica")
            while True:
                line = resp.readline()
                if not line:
                    break
                t = time.perf_counter()
                msg = json.loads(line)
                if "done" in msg:
                    rec["done"] = msg
                elif "tokens" in msg:
                    rec["parts"].append((t, [int(x) for x in msg["tokens"]]))
                else:
                    rec["error"] = msg
            conn.close()
        except Exception as e:  # surfaced by the caller's checks
            rec["error"] = repr(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return out, threads


def fleet_clients(port: int, prompts: list, new_tokens: int) -> list:
    out, threads = start_fleet_clients(port, prompts, new_tokens)
    for t in threads:
        t.join()
    return out


def fleet_worker_reports(out_dir: str, n: int) -> list:
    """Each worker's ``SERVE-DONE`` line (rank, role, ticks, scheduling
    digest, attention-kernel launches, final engine stats)."""
    reps = []
    for rank in range(n):
        with open(os.path.join(out_dir, f"rank.{rank}", "stdout"),
                  errors="replace") as f:
            lines = [ln for ln in f if ln.startswith("SERVE-DONE")]
        require(len(lines) == 1, f"fleet rank {rank}: no SERVE-DONE line")
        m = re.match(r"SERVE-DONE rank (\d+) role (\w+) sub_rank (\d+) "
                     r"ticks (\d+) sched_digest (\w*) launches (\{.*?\}) "
                     r"stats (\{.*\})$", lines[0].strip())
        require(m is not None, f"fleet rank {rank}: {lines[0][:200]}")
        reps.append({"rank": int(m[1]), "role": m[2], "sub_rank": int(m[3]),
                     "ticks": int(m[4]), "digest": m[5],
                     "launches": json.loads(m[6]),
                     "stats": json.loads(m[7])})
    return reps


def launch_fleet(servable: str, n: int, port: int, env_extra: dict,
                 device_type: str, extra_args=()) -> tuple:
    """Start ``python -m horovod_tpu_torch.runner.launch -np n --gpu
    --serve servable --serve-port port`` (``--serve-device cpu`` in place
    of ``--gpu`` off the card) in a session of its own, with free
    coordinator and controller ports, each rank's output under a fresh
    directory.  Returns the launcher's process and that directory."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_out_")
    ports = [port, free_port(), free_port()]
    require(not {29500, 29499} & set(ports), f"ports {ports}")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           str(n)] + (["--gpu"] if device_type == "cuda" else
                      ["--serve-device", device_type]) + [
           "--serve", servable, "--serve-port", str(port),
           "--serve-ttl", str(FLEET_TTL), "--coordinator-port",
           str(ports[1]), "--controller-port", str(ports[2]),
           "--output-filename", out_dir] + list(extra_args)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), **env_extra)
    return subprocess.Popen(cmd, cwd=here, env=env,
                            start_new_session=True), out_dir


def end_fleet(label: str, proc, out_dir: str, n: int) -> None:
    """Kill a launch that failed, with its workers, and print the tails
    of their output."""
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()
    for rank in range(n):
        for stream in ("stdout", "stderr"):
            fp = os.path.join(out_dir, f"rank.{rank}", stream)
            if os.path.exists(fp):
                with open(fp, errors="replace") as f:
                    print(f"{label}: rank {rank} {stream} tail:\n"
                          + f.read()[-3000:], flush=True)


def metric_value(text: str, name: str, **labels: str) -> float:
    """The sum of the samples of ``name`` in a Prometheus exposition whose
    labels include ``labels``."""
    total = 0.0
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for line in text.splitlines():
        head, _, value = line.rpartition(" ")
        if head.split("{", 1)[0] == name and all(w in head for w in want):
            total += float(value)
    return total


def http_text(port: int, path: str, timeout: float = 30.0) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        require(resp.status == 200, f"GET {path}: {resp.status}")
        return body
    finally:
        conn.close()


def fleet_spans(merged: dict) -> dict:
    """rid -> the span names the merged timeline holds for it."""
    spans: dict = {}
    for e in merged["traceEvents"]:
        rid = (e.get("args") or {}).get("rid")
        if e.get("ph") == "X" and rid:
            spans.setdefault(rid, set()).add(e["name"])
    return spans


def run_doctor(args: list, timeout: float = 60.0) -> tuple:
    """``python -m horovod_tpu_torch.runner.launch doctor ARGS``:
    (exit code, stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    p = subprocess.run([sys.executable, "-m",
                        "horovod_tpu_torch.runner.launch", "doctor"] + args,
                       cwd=here, env=env, capture_output=True, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def run_fleet(label: str, servable: str, n: int, prompts: list,
              env_extra: dict, ready_keys=("stats",),
              device_type: str = "cuda", scrape: bool = False,
              timeline: bool = False) -> dict:
    """``python -m horovod_tpu_torch.runner.launch -np n --gpu --serve
    servable`` on free ports (``--serve-device cpu`` in place of ``--gpu``
    off the card, for rehearsals); waits for the ready stats keys, posts every
    prompt at once to ``/generate`` and reads the streams, reads
    ``/serve/stats``, drains (``POST /admin/drain``) and requires the
    drained ack and the launcher's exit code 0.  A launch that fails, or
    does not end within FLEET_DEADLINE, fails the run.  With ``scrape``
    it also reads ``GET /metrics`` once rank 0's snapshot counts every
    request finished (the workers publish every second); with ``timeline`` the
    workers trace (``--timeline-filename``) and ``GET /timeline`` is read
    once it holds the ROUTE, PREFILL and DECODE spans of every request."""
    import shutil
    import tempfile
    port = free_port()
    t0 = time.time()
    env_extra = dict(env_extra, HOROVOD_METRICS_INTERVAL="1",
                     HOROVOD_TIMELINE_MERGE_INTERVAL="1")
    extra_args = []
    if timeline:
        extra_args = ["--timeline-filename", os.path.join(
            tempfile.mkdtemp(prefix="chip_smoke_fleet_tl_"), "trace.json")]
    proc, out_dir = launch_fleet(servable, n, port, env_extra, device_type,
                                 extra_args)
    r = {"out_dir": out_dir}
    try:
        while True:
            require(proc.poll() is None,
                    f"{label}: the launcher exited {proc.returncode} before "
                    "the fleet was ready")
            require(time.time() - t0 < FLEET_DEADLINE,
                    f"{label}: not ready after {FLEET_DEADLINE} s")
            ready = True
            for key in ready_keys:
                try:
                    code, body = http_json(port, "GET", f"/serve/{key}",
                                           timeout=5)
                except OSError:
                    code, body = None, None
                ok = code == 200 and body is not None and (
                    "engine" in body if key == "stats" else True)
                ready = ready and ok
            if ready:
                break
            time.sleep(0.1)
        r["ready_s"] = time.time() - t0
        r["health"] = idle_health(label, port, n)
        t_start = time.perf_counter()
        r["results"] = fleet_clients(port, prompts, SERVE_NEW_TOKENS)
        r["wall"] = time.perf_counter() - t_start
        # the engines' stats publishes are at most a second old: wait for
        # the ones that count every request
        deadline = time.time() + FLEET_SETTLE_S
        while True:
            _, st = http_json(port, "GET", "/serve/stats")
            extra = {key: http_json(port, "GET", f"/serve/{key}")[1]
                     for key in ready_keys if key != "stats"}
            counted = st.get("engine", {}).get("completed") == len(
                prompts) and all(e.get("handoffs") == len(prompts)
                                 for e in extra.values())
            if counted or time.time() > deadline:
                break
            time.sleep(0.2)
        r["stats"], r["extra"] = st, extra
        deadline = time.time() + FLEET_SCRAPE_S
        while scrape:
            text = http_text(port, "/metrics")
            counted = metric_value(text, "hvd_serve_requests_total",
                                   rank="0") == len(prompts)
            if counted or time.time() > deadline:
                r["metrics"] = text
                break
            time.sleep(0.5)
        if scrape:
            url = f"http://127.0.0.1:{port}"
            rid = r["results"][0]["rid"]
            r["doctor"] = {"serve": run_doctor(["--serve", url]),
                           "request": run_doctor(["--request", rid, url]),
                           "rid": rid}
        deadline = time.time() + FLEET_SCRAPE_S
        while timeline:
            merged = json.loads(http_text(port, "/timeline"))
            spans = fleet_spans(merged)
            whole = all({"ROUTE", "PREFILL", "DECODE"} <= spans.get(
                rec.get("rid"), set()) for rec in r["results"])
            if whole or time.time() > deadline:
                r["timeline"] = merged
                break
            time.sleep(0.5)
        r["handoff_bytes"] = []
        if "stats.prefill" in ready_keys:
            for i in range(len(prompts)):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=30)
                conn.request("GET", f"/serve_kv/handoff.{i:06d}")
                resp = conn.getresponse()
                raw = resp.read()
                conn.close()
                require(resp.status == 200, f"{label}: no handoff {i}")
                r["handoff_bytes"].append(len(raw))
        code, ack = http_json(port, "POST", "/admin/drain", {},
                              timeout=120)
        r["drain"] = (code, ack)
        rc = proc.wait(timeout=max(10.0, FLEET_DEADLINE
                                   - (time.time() - t0)))
        r["exit_s"] = time.time() - t0
    except BaseException:
        end_fleet(label, proc, out_dir, n)
        raise
    require(rc == 0, f"{label}: the launcher returned {rc}")
    require(r["drain"][0] == 200 and r["drain"][1].get("drained") is True,
            f"{label}: drain answered {r['drain']}")
    r["workers"] = fleet_worker_reports(out_dir, n)
    shutil.rmtree(out_dir, ignore_errors=True)
    return r


def idle_health(label: str, port: int, n: int) -> dict:
    """``GET /health`` of an idle serving fleet, read until every rank's
    heartbeat shows a step past the first reading's (each worker loop
    stamps ``postmortem.record_step`` on every tick, idle ones too), at
    most ``FLEET_HEALTH_S``.  Returns rank -> (first step, later step)."""
    def steps():
        return {r: info["heartbeat"].get("step") for r, info in
                http_get_json(port, "/health")["ranks"].items()}
    deadline = time.time() + FLEET_HEALTH_S
    while True:  # the first heartbeats may predate the loop's first tick
        first = steps()
        if sorted(first) == sorted(str(r) for r in range(n)) and all(
                v is not None for v in first.values()):
            break
        require(time.time() < deadline, f"{label}: GET /health {first}")
        time.sleep(0.25)
    while True:
        later = steps()
        if all(later[r] > first[r] for r in first):
            break
        require(time.time() < deadline,
                f"{label}: idle steps did not advance: {first} -> {later}")
        time.sleep(0.25)
    steps = {r: (first[r], later[r]) for r in sorted(first, key=int)}
    print(f"{label}: GET /health while idle: each rank's step "
          + ", ".join(f"rank {r} {a} -> {b}" for r, (a, b) in steps.items()),
          flush=True)
    return steps


def fleet_streams(label: str, r: dict, n_req: int) -> list:
    """Each request's streamed tokens, required complete (64 tokens, each
    exactly once and in order: the parts' concatenation is the done
    record's token list)."""
    outs = []
    for i, rec in enumerate(r["results"]):
        require(rec is not None and rec.get("status") == 200
                and rec["error"] is None and rec["done"] is not None,
                f"{label}: request {i}: {str(rec)[:300]}")
        streamed = [t for _, toks in rec["parts"] for t in toks]
        require(streamed == rec["done"]["tokens"]
                and len(streamed) == SERVE_NEW_TOKENS,
                f"{label}: request {i} streamed {len(streamed)} tokens, "
                f"done record {len(rec['done']['tokens'])}, equal "
                f"{streamed == rec['done']['tokens']}")
        outs.append(streamed)
    require(len(outs) == n_req, f"{label}: {len(outs)} streams")
    return outs


def fleet_timing(np, label: str, r: dict, card: str,
                 ref: "dict | None") -> dict:
    """TTFT p50/p99, TPOT p50 and decode tokens/s as the client measured
    them over HTTP, printed beside phase 6's in-process figures."""
    ttft, tpot = [], []
    for rec in r["results"]:
        t_first, t_last = rec["parts"][0][0], rec["parts"][-1][0]
        ttft.append((t_first - rec["t_send"]) * 1e3)
        tpot.append((t_last - t_first) * 1e3 / (SERVE_NEW_TOKENS - 1))
    st = r["stats"]["engine"]
    fig = {"ttft_p50": float(np.percentile(ttft, 50)),
           "ttft_p99": float(np.percentile(ttft, 99)),
           "tpot_p50": float(np.percentile(tpot, 50)),
           "tok_s": st["tokens_decode"] / r["wall"]}
    vs = (lambda k, f: f" (phase 6 in-process {ref[k]:{f}})") if ref else \
        (lambda k, f: "")
    print(card, flush=True)
    print(f"{label} over HTTP: {len(r['results'])} requests in "
          f"{r['wall']:.3f} s; TTFT p50 {fig['ttft_p50']:.1f} ms"
          f"{vs('ttft_p50', '.1f')}, p99 {fig['ttft_p99']:.1f} ms"
          f"{vs('ttft_p99', '.1f')}; TPOT p50 {fig['tpot_p50']:.2f} ms"
          f"{vs('tpot_p50', '.2f')}; decode {fig['tok_s']:.1f} tokens/s"
          f"{vs('tok_s', '.1f')}; prefix hits "
          f"{st['prefix_cache'].get('hits')}, spec accepted "
          f"{st['spec']['accepted_tokens']}; first ready {r['ready_s']:.2f} "
          f"s after the launch, launcher gone at {r['exit_s']:.2f} s",
          flush=True)
    return fig


def fleet_launches(label: str, r: dict) -> dict:
    launches = {name: sum(w["launches"].get(name, 0) for w in r["workers"])
                for name in REPLACES}
    print(f"{label} attention-kernel launches {json.dumps(launches)}",
          flush=True)
    require(not any(launches.values()),
            f"{label}: the fleet launched a flash-attention kernel")
    return launches


def greedy_check(torch, model, label: str, prompts: list,
                 outs: list) -> None:
    """Each request's tokens against full-forward greedy: one fp32 forward
    over prompt + output, whose argmax at every emitted position must be
    the emitted token."""
    same = 0
    for p, out in zip(prompts, outs):
        gap, agree = logit_gaps(torch, model, p, out)
        same += agree == len(out)
        if agree != len(out):
            print(f"{label}: a request agrees with greedy at {agree} of "
                  f"{len(out)} positions (largest gap {gap:.3g})",
                  flush=True)
    print(f"{label}: {same} of {len(outs)} requests byte-identical to "
          f"full-forward greedy over {SERVE_NEW_TOKENS} tokens", flush=True)
    require(same == len(outs), f"{label}: tokens differ from greedy")


def phase_fleet(torch, np, serve, card: str, ref: dict,
                device_type: str = "cuda") -> dict:
    """Phase 14: the serving fleet as a user starts it, ``python -m
    horovod_tpu_torch.runner.launch -np 1 --gpu --serve DIR --serve-port P
    --serve-ttl T``, once over an fp32 and once over a bf16 ``1b``
    servable written with ``serve.save_servable`` from phase 6's weights;
    the parent is the client.  Returns the fleets' kernel launches."""
    import dataclasses
    import shutil
    import tempfile
    from horovod_tpu_torch.models import llama
    torch.cuda.empty_cache()
    print(f"fleet: parent holds {torch.cuda.memory_reserved()} bytes "
          "reserved after empty_cache", flush=True)
    dev = torch.device(device_type, 0)
    cfg = llama.CONFIGS["1b"]
    prompts = serve_traffic(np.random.RandomState(0), cfg.vocab)
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    launches = {name: 0 for name in REPLACES}
    try:
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            label = f"fleet [1b {tag} -np 1]"
            cfg_d = dataclasses.replace(cfg, dtype=dtype)
            model = llama.init(cfg_d, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
            d = os.path.join(root, tag)
            t0 = time.time()
            serve.save_servable(d, "llama", cfg_d, model)
            size = sum(os.path.getsize(os.path.join(dp, f))
                       for dp, _, fs in os.walk(d) for f in fs)
            print(f"{label}: save_servable wrote {size} bytes in "
                  f"{time.time() - t0:.2f} s", flush=True)
            if tag == "bf16":
                del model
                model = None
            torch.cuda.empty_cache()
            r = run_fleet(label, d, 1, prompts, {},
                          device_type=device_type, scrape=True,
                          timeline=tag == "fp32")
            outs = fleet_streams(label, r, len(prompts))
            fleet_measure_checks(label, r, outs, prompts)
            st = r["stats"]
            require("router" in st and "engine" in st
                    and st["engine"]["prefix_cache"]["hits"] >= 1,
                    f"{label}: /serve/stats {str(st)[:300]}")
            print(f"{label}: /serve/stats router {json.dumps(st['router'])}"
                  f"; engine completed {st['engine']['completed']}, "
                  f"prefix hits {st['engine']['prefix_cache']['hits']}; "
                  f"drain ack engine_final completed "
                  f"{r['drain'][1].get('engine_final', {}).get('completed')}",
                  flush=True)
            fleet_timing(np, label, r, card, ref if tag == "bf16" else None)
            for k, v in fleet_launches(label, r).items():
                launches[k] += v
            if tag == "fp32":
                greedy_check(torch, model, label, prompts, outs)
                del model
                torch.cuda.empty_cache()
            shutil.rmtree(d, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def fleet_measure_checks(label: str, r: dict, outs: list,
                         prompts: list) -> None:
    """Phase 14's scrape of the fleet's ``/metrics`` after its streams
    ended, and of ``/timeline`` where the fleet traced: a lint-clean
    exposition, one TTFT sample a request, the decode tokens the client
    read, a prefix hit; the ROUTE, PREFILL and DECODE spans of every
    request.  As in the JAX engine, a request's first token comes off its
    last prefill chunk and counts under neither phase, so the decode
    counter holds the tokens streamed less one a request."""
    from horovod_tpu_torch.utils import metrics as M
    text = r["metrics"]
    lint = M.lint_exposition(text)
    ttft = metric_value(text, "hvd_serve_ttft_seconds_count", rank="0")
    decode = metric_value(text, "hvd_serve_tokens_total", phase="decode",
                          rank="0")
    hits = metric_value(text, "hvd_serve_prefix_hits_total", rank="0")
    done = metric_value(text, "hvd_serve_requests_total", rank="0")
    streamed = sum(len(o) for o in outs)
    direct = metric_value(text, "hvd_serve_stream_direct_tokens_total",
                          rank="driver")
    print(f"{label}: GET /metrics {len(text)} bytes, lint "
          f"{'clean' if not lint else lint[:3]}; rank 0: TTFT samples "
          f"{ttft:.0f}, requests {done:.0f}, decode tokens {decode:.0f} "
          f"(streamed {streamed}, less one first token a request: "
          f"{streamed - len(prompts)}), prefix hits {hits:.0f}; driver: "
          f"direct-stream tokens {direct:.0f}", flush=True)
    require(not lint, f"{label}: /metrics lint: {lint[:5]}")
    require(ttft == len(prompts) == done,
            f"{label}: {ttft} TTFT samples, {done} requests counted")
    require(decode == streamed - len(prompts),
            f"{label}: decode tokens {decode}, streamed {streamed}")
    require(hits >= 1, f"{label}: no prefix hit counted")
    # the memory plane's kv_pool plane is the engine's pool, as it reports
    plane = metric_value(text, "hvd_mem_plane_bytes", plane="kv_pool",
                         rank="0")
    pool = r["stats"]["engine"]["kv_pool"]["pool_bytes"]
    print(f"{label}: hvd_mem_plane_bytes{{plane=kv_pool}} {plane:.0f}, the "
          f"engine's kv_pool() pool_bytes {pool}", flush=True)
    require(plane == pool, f"{label}: kv_pool plane {plane}, pool {pool}")
    for view in ("serve", "request"):
        rc, out, err = r["doctor"][view]
        head = out.strip().splitlines()[:1]
        print(f"{label}: launch doctor --{view} exit {rc}, "
              f"{len(out.splitlines())} lines, first {head}", flush=True)
        require(rc == 0 and out.strip(),
                f"{label}: doctor --{view} exit {rc}: {err[-1000:]}")
    require(f"--request {r['doctor']['rid']}" in r["doctor"]["request"][1]
            and "STATUS: done" in r["doctor"]["request"][1],
            f"{label}: doctor --request: {r['doctor']['request'][1][:500]}")
    if "timeline" in r:
        spans = fleet_spans(r["timeline"])
        missing = [rec.get("rid") for rec in r["results"]
                   if not {"ROUTE", "PREFILL", "DECODE"} <= spans.get(
                       rec.get("rid"), set())]
        lanes = sorted({e["args"]["name"] for e in r["timeline"][
            "traceEvents"] if e.get("name") == "process_name"})
        print(f"{label}: GET /timeline {len(r['timeline']['traceEvents'])} "
              f"events, lanes {lanes}; ROUTE, PREFILL and DECODE spans for "
              f"{len(prompts) - len(missing)} of {len(prompts)} requests",
              flush=True)
        require(not missing, f"{label}: requests without their spans "
                f"{missing}")


def rank_serve(torch, np, n: int, card: str,
               device_type: str = "cuda") -> None:
    """``--ranks N --parts serve``: the disaggregated fleet across N cards,
    ``launch -np N --gpu --serve DIR`` with ``HOROVOD_SERVE_PREFILL_RANKS``
    = 2 (ranks 0-1 prefill, the rest decode; each prompt's KV crosses
    between cards through ``serve_kv``), over an fp32 ``1b`` servable of
    phase 6's weights; the parent is the client.  The tokens must equal
    one card's in-process engine's byte for byte (themselves held to
    full-forward greedy), with one handoff per request and every
    follower's scheduling digest its sub-fleet rank 0's."""
    import dataclasses
    import shutil
    import tempfile
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import llama
    dev = torch.device(device_type, 0)
    cfg = dataclasses.replace(llama.CONFIGS["1b"], dtype=torch.float32)
    prompts = serve_traffic(np.random.RandomState(0), cfg.vocab)
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    # the fleet's configuration: the knobs' defaults, max_seq_len clamped
    # to the model's as the worker clamps it
    scfg = serve.ServeConfig()
    scfg = dataclasses.replace(scfg, max_seq_len=min(scfg.max_seq_len,
                                                     cfg.max_seq))
    engine = serve.ServeEngine(model, scfg, device=dev)
    reqs = [engine.submit(p, SERVE_NEW_TOKENS, req_id=f"r{i}")
            for i, p in enumerate(prompts)]
    engine.flush()
    engine.close()
    ref = [r.out_tokens for r in reqs]
    label = f"serve [1b fp32 -np {n}, {FLEET_PREFILL_RANKS} prefill]"
    greedy_check(torch, model, "serve [1b fp32 one card, in-process]",
                 prompts, ref)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        d = os.path.join(root, "fp32")
        serve.save_servable(d, "llama", cfg, model)
        del model, engine
        torch.cuda.empty_cache()
        r = run_fleet(label, d, n, prompts,
                      {"HOROVOD_SERVE_PREFILL_RANKS":
                       str(FLEET_PREFILL_RANKS)},
                      ready_keys=("stats", "stats.prefill"),
                      device_type=device_type)
        disaggregated_checks(np, label, r, prompts, ref, card)
        replica_kill(np, d, n, prompts, ref, card, device_type)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def disaggregated_checks(np, label: str, r: dict, prompts: list, ref: list,
                         card: str) -> None:
    """The disaggregated run's contract and numbers (``rank_serve``)."""
    from horovod_tpu_torch import serve
    outs = fleet_streams(label, r, len(prompts))
    same = sum(a == b for a, b in zip(outs, ref))
    print(f"{label}: {same} of {len(ref)} streams byte-identical to one "
          "card's tokens", flush=True)
    require(same == len(ref), f"{label}: tokens differ from one card's")
    pre, dec = r["extra"]["stats.prefill"], r["stats"]["engine"]
    print(f"{label}: handoffs {pre['handoffs']} (prefill rank 0), imports "
          f"{dec['imports']} (decode rank 0), requests {len(prompts)}",
          flush=True)
    require(pre["handoffs"] == len(prompts) == dec["imports"],
            f"{label}: {pre['handoffs']} handoffs, {dec['imports']} imports")
    by_rank = {w["rank"]: w for w in r["workers"]}
    for w in r["workers"]:
        lead = by_rank[w["rank"] - w["sub_rank"]]
        print(f"{label}: rank {w['rank']} ({w['role']}) {w['ticks']} ticks, "
              f"sched_digest {w['digest']} (its rank 0: {lead['digest']})",
              flush=True)
        require(w["digest"] == lead["digest"] and w["ticks"] == lead["ticks"],
                f"{label}: rank {w['rank']} left lockstep")
    hand = [rec["done"]["timing"].get("handoff", 0.0) * 1e3
            for rec in r["results"]]
    nbytes = r["handoff_bytes"]
    blocks = [-(-len(p) // serve.ServeConfig().block_size) for p in prompts]
    block_bytes = dec["kv_pool"]["block_bytes"]
    print(card, flush=True)
    print(f"{label}: handoff (export to decode admission, the done "
          f"records' timing) p50 {np.percentile(hand, 50):.1f} ms, p99 "
          f"{np.percentile(hand, 99):.1f} ms; a handoff record carries "
          f"{int(np.median(nbytes))} bytes at the median ({min(nbytes)}-"
          f"{max(nbytes)}; prompts of {min(blocks)}-{max(blocks)} blocks of "
          f"{block_bytes} bytes, hex doubles them)", flush=True)
    fleet_timing(np, label, r, card, None)
    fleet_launches(label, r)


REPLICA_KILL_AFTER = 8   # tokens streamed from replica 1 before it dies


def replica_kill(np, servable: str, n: int, prompts: list, ref: list,
                 card: str, device_type: str = "cuda") -> None:
    """Two replica fleets of n/2 ranks behind one router: ``launch --serve
    --replicas 2 --replica-id 0`` hosts the router on cards 0..n/2-1,
    ``--replica-id 1`` joins it on the others.  The parent posts the 16
    requests, kills replica 1's launch (its workers too) once a stream it
    serves has carried REPLICA_KILL_AFTER tokens, and requires every
    stream to finish byte-identical to one card's tokens, the router's
    re-dispatches counted in ``/serve/stats``, and replica 0 to drain to
    exit 0 with its ranks in lockstep.  The drain's answer may not come:
    the router lives in replica 0's launcher, which exits with its
    drained workers while the drain still waits for replica 1's ack."""
    import shutil
    label = f"serve [1b fp32, 2 replicas x {n // 2} ranks]"
    port = free_port()
    half = n // 2
    cards = [",".join(str(c) for c in range(k * half, (k + 1) * half))
             for k in range(2)]
    t0 = time.time()
    procs = []
    try:
        for k in range(2):
            env = {"HOROVOD_SERVE_DRAIN_TIMEOUT": "15"}
            if device_type == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = cards[k]
            procs.append(launch_fleet(
                servable, half, port, env, device_type,
                ("--replicas", "2", "--replica-id", str(k))))
            if k == 0:  # replica 0's launch hosts the router: up first
                while True:
                    require(procs[0][0].poll() is None and
                            time.time() - t0 < FLEET_DEADLINE,
                            f"{label}: replica 0's router did not start")
                    try:
                        http_json(port, "GET", "/serve/stats", timeout=5)
                        break
                    except OSError:
                        time.sleep(0.1)
        while True:
            require(all(p.poll() is None for p, _ in procs)
                    and time.time() - t0 < FLEET_DEADLINE,
                    f"{label}: the replicas were not both up")
            _, st = http_json(port, "GET", "/serve/stats", timeout=5)
            if (st or {}).get("replicas", {}).get("live") == [0, 1]:
                break
            time.sleep(0.2)
        ready_s = time.time() - t0
        out, threads = start_fleet_clients(port, prompts, SERVE_NEW_TOKENS)
        while not any(rec.get("replica") == "1" and
                      sum(len(t) for _, t in rec["parts"])
                      >= REPLICA_KILL_AFTER for rec in out):
            require(time.time() - t0 < FLEET_DEADLINE and
                    any(t.is_alive() for t in threads),
                    f"{label}: replica 1 never streamed "
                    f"{REPLICA_KILL_AFTER} tokens")
            time.sleep(0.01)
        on_1 = [i for i, rec in enumerate(out) if rec.get("replica") == "1"
                and rec["done"] is None]
        os.killpg(procs[1][0].pid, 9)
        procs[1][0].wait()
        t_kill = time.time()
        for t in threads:
            t.join(timeout=FLEET_DEADLINE)
        wall = time.time() - t_kill
        _, st = http_json(port, "GET", "/serve/stats")
        try:
            code, ack = http_json(port, "POST", "/admin/drain", {},
                                  timeout=120)
        except (http.client.RemoteDisconnected, ConnectionError):
            code, ack = "no answer (the router's launcher exited)", {}
        rc = procs[0][0].wait(timeout=120)
    except BaseException:
        for k, (p, out_dir) in enumerate(procs):
            end_fleet(f"{label} replica {k}", p, out_dir, half)
        raise
    require(rc == 0, f"{label}: replica 0's launcher returned {rc}")
    workers = fleet_worker_reports(procs[0][1], half)
    require(len({w["digest"] for w in workers}) == 1,
            f"{label}: replica 0's ranks left lockstep")
    outs = fleet_streams(label, {"results": out}, len(prompts))
    same = sum(a == b for a, b in zip(outs, ref))
    redispatched = st["replicas"]["redispatches"]
    served = [sum(rec.get("replica") == str(k) for rec in out)
              for k in range(2)]
    print(f"{label}: ready {ready_s:.2f} s after the first launch; "
          f"requests placed {served[0]} / {served[1]}; replica 1 killed "
          f"with {len(on_1)} of its streams in flight; the router "
          f"re-dispatched {redispatched}; every stream done {wall:.2f} s "
          f"after the kill; {same} of {len(ref)} streams byte-identical to "
          f"one card's tokens; replica 0 completed "
          f"{workers[0]['stats']['completed']} requests and exited 0; "
          f"drain: {code}, replicas drained {ack.get('replicas_drained')}",
          flush=True)
    require(same == len(ref), f"{label}: tokens differ from one card's")
    # (a replica whose stats heartbeat is late is dark to the router even
    # alive, so re-dispatches may exceed the streams in flight at the kill)
    require(len(on_1) >= 1 and redispatched >= 1,
            f"{label}: {redispatched} re-dispatches for {len(on_1)} "
            "streams in flight on the dead replica")
    require(ack.get("replicas_drained") in (None, [0]),
            f"{label}: drain ack {ack}")
    for _, out_dir in procs:
        shutil.rmtree(out_dir, ignore_errors=True)

MEASURE_STEPS = WARMUP_STEPS + TIMED_STEPS + 1  # phase 15: phase 5's batches
MEASURE_DEADLINE = 900   # seconds a measured launch may take to exit
MEASURE_PHASES = ("NEGOTIATE", "QUEUE", "EXEC")


def measured_worker(out_dir: str) -> int:
    """``--measured DIR``: the worker of phase 15 and of ``--ranks N
    --parts measure``, started by the port's launcher with the measurement
    plane on (``--timeline-*``, ``--autotune*``, ``--metrics-port``).
    ``DIR/spec.json`` gives the model, device, batch, sequence and steps,
    and ``mode``:

    * ``one``: (a) phase 7's hook-driven step (``horovod_tpu_torch.torch``
      ``DistributedOptimizer``, negotiated through the native controller)
      on phase 5's weights and batches, each step timed; (b) phase 5's
      direct ``DistributedOptimizer`` step under
      ``hvd.autotuner().measure(nbytes=...)``, the tuned threshold read
      before each step;
    * ``ranks``: the hook-driven step under ``measure`` on every rank,
      the tuned threshold and cycle read after each step, then each
      rank's parameter checksums.

    Each rank writes ``DIR/measured.<rank>.json`` after a final metrics
    publish and waits (at most 300 s) for ``DIR/scraped``, so the parent
    reads ``GET /metrics`` while every rank's last snapshot is in."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    cuda = spec["device"] == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    rt = ht.init(device=None if cuda else spec["device"])
    dev, rank, n = rt.device, ht.rank(), ht.size()
    require(rt.timeline is not None and rt.autotuner is not None
            and rt.core is not None and rt.metrics_publisher is not None
            and rt.perf_publisher is not None,
            "the measurement plane is not on")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = llama.CONFIGS[spec["cfg"]]
    from horovod_tpu_torch.perf import costmodel
    hvd.perf.configure(flops_per_step=costmodel.train_flops_per_token(
        llama.param_count(cfg)) * spec["batch"] * n * spec["seq"])
    rng = np.random.RandomState(0)  # phase 5's batches
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (spec["batch"] * n, spec["seq"] + 1),
        dtype=np.int32)).to(dev) for _ in range(spec["steps"])]

    def loss(m, ids):
        return llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                             ce_chunks=8)

    def build(api):
        model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        opt = api.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=0.01),
            named_parameters=model.named_parameters())
        api.broadcast_parameters(model.state_dict(), root_rank=0)
        api.broadcast_optimizer_state(opt, root_rank=0)
        return model, opt, hvd.make_train_step(model, loss, opt)

    out = {"rank": rank, "size": n, "device": str(dev),
           "autotune_start": rt.core.autotune_state()}
    tuner = hvd.autotuner()
    model, opt, step = build(ht)
    # the names the hook optimizer negotiates, one a bucket
    out["groups"] = [f"group.{gid}." + opt._names.get(b[0], "noname")
                     for gid, b in enumerate(opt._buckets)]
    out["covered"] = (sum(len(b) for b in opt._buckets)
                      == len(list(model.parameters())))
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    F.reset_launches()
    losses, ms, thresholds, cycles = [], [], [], []
    for b in batches:
        t0 = time.perf_counter()
        if spec["mode"] == "ranks":
            with tuner.measure(nbytes=nbytes):
                losses.append(float(step(b)))
                sync()
            thresholds.append(rt.fusion_threshold())
            cycles.append(tuner.cycle_ms)
        else:
            with hvd.perf.timed_step():
                losses.append(float(step(b)))
                sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    out.update(losses_a=losses, ms_a=ms, launches_a=dict(F.LAUNCHES),
               autotune_end=rt.core.autotune_state(),
               thresholds=thresholds, cycles=cycles)
    if spec["mode"] == "ranks":
        import torch.distributed as dist
        sums = param_checksums(torch, list(model.parameters()))
        rows = [torch.empty_like(sums) for _ in range(n)]
        dist.all_gather(rows, sums)
        out["checksums_equal"] = all(torch.equal(rows[0], x) for x in rows)
    del step, opt, model
    if cuda:
        torch.cuda.empty_cache()
    if spec["mode"] == "one":
        model, opt, step = build(hvd)
        misses0 = rt.plan_cache.misses
        F.reset_launches()
        losses, ms, thresholds = [], [], []
        for b in batches:
            thresholds.append(rt.fusion_threshold())
            t0 = time.perf_counter()
            with hvd.perf.timed_step(), tuner.measure(nbytes=nbytes):
                losses.append(float(step(b)))
                sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        out.update(losses_b=losses, ms_b=ms, launches_b=dict(F.LAUNCHES),
                   thresholds=thresholds, nbytes=nbytes,
                   replans=rt.plan_cache.misses - misses0)
        del step, opt, model
    require(rt.metrics_publisher.publish_now(), "the metrics publish failed")
    require(rt.perf_publisher.publish_now(), "the perf publish failed")
    write_json(os.path.join(out_dir, f"measured.{rank}.json"), out)
    deadline = time.time() + 300
    while not os.path.exists(os.path.join(out_dir, "scraped")):
        require(time.time() < deadline, "the parent never scraped")
        time.sleep(0.1)
    ht.shutdown()
    return 0


def start_measured(out_dir: str, n: int, device_type: str, flags: list,
                   worker: str = "--measured"):
    """``python -m horovod_tpu_torch.runner.launch -np n [--gpu] <flags>
    ... python3 chip_smoke.py --measured DIR`` (or ``worker``'s flag) in a
    session of its own, with free coordinator and controller ports and the
    workers' output under ``DIR/logs``; the native controller negotiates
    over TCP and the workers publish their metrics, trace and perf report
    every second (``HOROVOD_PERF=1``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    ports = [free_port(), free_port()]
    require(not {29500, 29499} & set(ports), f"ports {ports}")
    cmd = ([sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
            str(n)] + (["--gpu"] if device_type == "cuda" else [])
           + ["--coordinator-port", str(ports[0]), "--controller-port",
              str(ports[1]), "--output-filename",
              os.path.join(out_dir, "logs")] + flags
           + [sys.executable, os.path.abspath(__file__), worker, out_dir])
    env = dict(os.environ, HOROVOD_CONTROLLER="tcp",
               HOROVOD_METRICS_INTERVAL="1",
               HOROVOD_TIMELINE_MERGE_INTERVAL="1",
               HOROVOD_PERF="1", HOROVOD_PERF_INTERVAL="1",
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen(cmd, cwd=here, env=env, stderr=subprocess.PIPE,
                            start_new_session=True)


def finish_measured(label: str, proc, out_dir: str, n: int,
                    metrics_port: int) -> tuple:
    """Wait for every rank's ``measured.<rank>.json``, read ``GET
    /metrics`` and ``GET /perf`` and run ``launch doctor --perf`` on it
    while the ranks wait, release them and wait for the launcher.
    Returns (each rank's report, the exposition, the launcher's stderr,
    the /perf view, the doctor's (exit code, stdout, stderr)).  A launch
    that fails or outlives MEASURE_DEADLINE fails the run, with the
    workers' output tails."""
    t0 = time.time()
    files = [os.path.join(out_dir, f"measured.{r}.json") for r in range(n)]
    err = b""
    try:
        while not all(os.path.exists(f) for f in files):
            require(proc.poll() is None, f"{label}: the launcher exited "
                    f"{proc.returncode} before every rank reported")
            require(time.time() - t0 < MEASURE_DEADLINE,
                    f"{label}: no report after {MEASURE_DEADLINE} s")
            time.sleep(0.2)
        text = http_text(metrics_port, "/metrics")
        perf_view = json.loads(http_text(metrics_port, "/perf"))
        doctor = run_doctor(["--perf",
                             f"http://127.0.0.1:{metrics_port}/perf"])
        with open(os.path.join(out_dir, "scraped"), "w"):
            pass
        _, err = proc.communicate(timeout=max(
            10.0, MEASURE_DEADLINE - (time.time() - t0)))
    except BaseException:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
        err = err or proc.communicate()[1]
        print(f"{label}: launcher stderr tail:\n"
              + err.decode(errors="replace")[-3000:], flush=True)
        end_fleet(label, proc, os.path.join(out_dir, "logs"), n)
        raise
    require(proc.returncode == 0,
            f"{label}: the launcher returned {proc.returncode}: "
            + err.decode(errors="replace")[-2000:])
    reports = []
    for f in files:
        with open(f) as fh:
            reports.append(json.load(fh))
    return reports, text, err.decode(errors="replace"), perf_view, doctor


def lifecycle_checks(label: str, events: list, names: list,
                     steps: int) -> int:
    """Every name's lane holds ``steps`` NEGOTIATE, QUEUE and EXEC phases,
    in that order step by step, each EXEC of positive width.  Returns the
    EXEC spans checked."""
    lanes = {e["args"]["name"]: e["pid"] for e in events
             if e.get("name") == "process_name"}
    checked = 0
    for name in names:
        require(name in lanes, f"{label}: no lane for {name}")
        own = [e for e in events if e.get("pid") == lanes[name]
               and e.get("name") in MEASURE_PHASES]
        by = {(ph, kind): sorted(e["ts"] for e in own
                                 if e["name"] == ph and e["ph"] == kind)
              for ph in ("NEGOTIATE", "QUEUE") for kind in ("B", "E")}
        exe = sorted((e for e in own if e["name"] == "EXEC"),
                     key=lambda e: e["ts"])
        require(all(len(v) == steps for v in by.values())
                and len(exe) == steps,
                f"{label}: {name}: {[(k, len(v)) for k, v in by.items()]},"
                f" {len(exe)} EXEC spans in {steps} steps")
        for k in range(steps):
            chain = [by[("NEGOTIATE", "B")][k], by[("NEGOTIATE", "E")][k],
                     by[("QUEUE", "B")][k], by[("QUEUE", "E")][k],
                     exe[k]["ts"]]
            require(chain == sorted(chain) and exe[k]["dur"] > 0,
                    f"{label}: {name} step {k}: phases {chain}, EXEC "
                    f"{exe[k]['dur']} us")
            checked += 1
    return checked


def phase_measure(torch, card: str, ref_losses, ref_step_ms: float,
                  eager_step_ms: float, device_type: str = "cuda",
                  cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                  seq: int = TRAIN_SEQ) -> dict:
    """Phase 15: the measurement plane on the 1b step, started as a user
    starts it, ``launch -np 1 --gpu --timeline-filename F
    --timeline-mark-cycles --autotune --autotune-log-file L
    --autotune-warmup-samples 1 --autotune-steps-per-sample 2
    --metrics-port P ... chip_smoke.py --measured DIR`` with
    HOROVOD_CONTROLLER=tcp (``measured_worker``, mode ``one``).  Returns
    the kernels' launches of the phase."""
    import shutil
    import tempfile
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.utils import metrics as M
    from horovod_tpu_torch.utils.timeline import load_trace_events
    label = f"measure [{cfg_name} -np 1]"
    if device_type == "cuda":
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_measure_")
    steps = len(ref_losses)
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump({"cfg": cfg_name, "device": device_type, "batch": batch,
                   "seq": seq, "steps": steps, "mode": "one"}, f)
    trace = os.path.join(out_dir, "trace.json")
    log = os.path.join(out_dir, "autotune.csv")
    mport = free_port()
    proc = start_measured(out_dir, 1, device_type, [
        "--timeline-filename", trace, "--timeline-mark-cycles",
        "--autotune", "--autotune-log-file", log,
        "--autotune-warmup-samples", "1", "--autotune-steps-per-sample", "2",
        "--metrics-port", str(mport)])
    (r,), text, _, perf_view, doctor = finish_measured(label, proc, out_dir,
                                                      1, mport)
    events = load_trace_events(trace)
    with open(log) as f:
        rows = [ln.strip().split(",") for ln in f if ln.strip()]
    shutil.rmtree(out_dir, ignore_errors=True)

    for part in ("a", "b"):
        got = r[f"losses_{part}"]
        diffs = [abs(a - b) for a, b in zip(got, ref_losses)]
        print(f"{label} ({part}) losses " + " ".join(f"{x:.5f}" for x in got)
              + f"; phase 5's max |diff| {max(diffs):.3g}, bitwise equal: "
              f"{got == list(ref_losses)}", flush=True)
        require(len(got) == steps and max(diffs) <= EAGER_LOSS_TOL,
                f"{label} ({part}): losses {got} vs phase 5's {ref_losses}")
    # (a): the lifecycle of every gradient bucket, the cycle marks, the
    # native spans, the native tuner
    require(r["covered"], f"{label}: the buckets miss a parameter")
    spans = lifecycle_checks(label, events, r["groups"], steps)
    cycles = sum(e.get("name") == "CYCLE" for e in events)
    native = sum(str(e.get("name", "")).startswith("cycle.")
                 for e in events)
    exec_ms = [e["dur"] / 1e3 for e in events if e.get("name") == "EXEC"]
    print(f"{label} (a) trace: {len(events)} events; {len(r['groups'])} "
          f"gradient buckets x {steps} steps with NEGOTIATE, QUEUE and "
          f"EXEC ({spans} EXEC spans, width median "
          f"{sorted(exec_ms)[len(exec_ms) // 2]:.3f} ms); {cycles} cycle "
          f"marks; {native} native core spans", flush=True)
    require(cycles > 0 and native > 0,
            f"{label}: {cycles} cycle marks, {native} native spans")
    a0, a1 = r["autotune_start"], r["autotune_end"]
    print(f"{label} (a) native autotune: {a0} -> {a1}", flush=True)
    require(a0 is not None and a1 is not None and (
        a1["threshold"], a1["cycle_ms"]) != (a0["threshold"],
                                             a0["cycle_ms"]),
            f"{label}: the native tuner did not move: {a0} -> {a1}")
    # (b): the Python tuner re-plans the fused sync
    tuned = sorted(set(r["thresholds"]))
    logged = {int(row[0]) for row in rows[1:]}
    print(f"{label} (b) tuned threshold by step {r['thresholds']} "
          f"({len(tuned)} values, {r['replans']} bucket plans made); log "
          f"rows {rows[1:]}", flush=True)
    require(rows and rows[0] == ["threshold_bytes", "cycle_ms",
                                 "best_score_bytes_per_s"],
            f"{label}: autotune log {rows[:1]}")
    require(len(tuned) >= 2 and set(r["thresholds"][1:]) - {
        r["thresholds"][0]} <= logged,
            f"{label}: thresholds {r['thresholds']}, logged {logged}")
    require(r["replans"] >= len(tuned),
            f"{label}: {r['replans']} plans for {len(tuned)} thresholds")
    # the scrape
    lint = M.lint_exposition(text)
    cyc = metric_value(text, "hvd_controller_cycles_total", rank="0")
    print(f"{label}: GET /metrics {len(text)} bytes, lint "
          f"{'clean' if not lint else lint[:3]}, rank 0 controller cycles "
          f"{cyc:.0f}, collective ops "
          f"{metric_value(text, 'hvd_collective_ops_total', rank='0'):.0f}"
          f", negotiation ages "
          f"{metric_value(text, 'hvd_negotiation_age_seconds_count', rank='0'):.0f}",
          flush=True)
    require(not lint, f"{label}: /metrics lint: {lint[:5]}")
    require('rank="0"' in text and 'rank="driver"' in text and cyc > 0,
            f"{label}: the scrape lacks rank 0, the driver or cycles")
    # the perf plane: the ledger's families, the memory sampler's, GET
    # /perf with rank 0's report and the doctor's rendering of it
    perf_steps = metric_value(text, "hvd_perf_steps_total", rank="0")
    mem_bytes = metric_value(text, "hvd_mem_bytes_in_use", rank="0")
    rep = perf_view.get("ranks", {}).get("0", {})
    rc, out, err = doctor
    verdict = [ln for ln in out.splitlines() if ln.startswith("BOTTLENECK")]
    print(f"{label}: hvd_perf_steps_total {perf_steps:.0f}, "
          f"hvd_mem_bytes_in_use {mem_bytes:.0f} (rank 0); GET /perf "
          f"{perf_view['fleet']['ranks']} rank(s), rank 0 {rep.get('steps')}"
          f" steps, mean step {rep.get('step_time_s', {}).get('mean')} s, "
          f"verdict {rep.get('verdict')}; launch doctor --perf exit {rc}: "
          f"{verdict}", flush=True)
    require(perf_steps >= steps and mem_bytes > 0,
            f"{label}: perf steps {perf_steps}, mem bytes {mem_bytes}")
    require(perf_view["fleet"]["ranks"] == 1 and rep.get("steps", 0) >= steps
            and rep.get("verdict") in (
                "compute-bound", "comm-bound", "input-bound", "stall-bound"),
            f"{label}: GET /perf {str(perf_view)[:500]}")
    require(rc == 0 and verdict, f"{label}: doctor --perf exit {rc}: "
            f"{out[-1000:]} {err[-1000:]}")
    # the kernels and the cost
    per_step = llama.CONFIGS[cfg_name].n_layers if device_type == "cuda" \
        else 0
    launches = {}
    for name in REPLACES:
        for part in ("a", "b"):
            got = r[f"launches_{part}"].get(name, 0)
            require(got == per_step * steps,
                    f"{label} ({part}): {name} launched {got} times, "
                    f"expected {per_step} a step")
        launches[name] = r["launches_a"].get(name, 0) + \
            r["launches_b"].get(name, 0)
    ms_a = sum(r["ms_a"][WARMUP_STEPS:]) / (steps - WARMUP_STEPS)
    ms_b = sum(r["ms_b"][WARMUP_STEPS:]) / (steps - WARMUP_STEPS)
    print(card, flush=True)
    print(f"{label} [{card}]: step with the plane (steps "
          f"{WARMUP_STEPS + 1}-{steps}, each synchronized): (a) hook-driven "
          f"{ms_a:.1f} ms against phase 7's {eager_step_ms:.1f} ms, ratio "
          f"{ms_a / eager_step_ms:.3f}; (b) direct under measure() "
          f"{ms_b:.1f} ms against phase 5's {ref_step_ms:.1f} ms, ratio "
          f"{ms_b / ref_step_ms:.3f}; launches {json.dumps(launches)}",
          flush=True)
    return launches


def rank_measure(torch, n: int, card: str, device_type: str = "cuda",
                 cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> None:
    """``--ranks N --parts measure``: the plane's parts that exist only
    across ranks.  ``launch -np N --gpu --timeline-merge M --autotune
    --autotune-warmup-samples 1 --autotune-steps-per-sample 2
    --metrics-port P`` over the hook-driven 1b step under
    ``hvd.autotuner().measure`` (``measured_worker``, mode ``ranks``;
    each rank its own trace file beside M, as ``--timeline-merge`` makes
    them): the merged trace's N rank lanes with their clock offsets, the
    tuned threshold equal on all ranks at every step, the parameters
    bitwise equal across ranks, N rank labels on ``/metrics`` and the
    launcher's straggler report."""
    import shutil
    import tempfile
    from horovod_tpu_torch.utils import metrics as M
    label = f"measure [{cfg_name} -np {n}]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_measure_")
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump({"cfg": cfg_name, "device": device_type, "batch": batch,
                   "seq": seq, "steps": MEASURE_STEPS, "mode": "ranks"}, f)
    merged_path = os.path.join(out_dir, "merged.json")
    mport = free_port()
    proc = start_measured(out_dir, n, device_type, [
        "--timeline-merge", merged_path, "--autotune",
        "--autotune-warmup-samples", "1", "--autotune-steps-per-sample", "2",
        "--metrics-port", str(mport)])
    reports, text, err, _, _ = finish_measured(label, proc, out_dir, n,
                                               mport)
    with open(merged_path) as f:
        merged = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    lanes = sorted(e["args"]["name"] for e in merged["traceEvents"]
                   if e.get("name") == "process_name")
    clocks = merged["metadata"]["clock_sync"]
    print(f"{label}: merged trace {len(merged['traceEvents'])} events, "
          f"lanes {lanes}, clock offsets "
          + ", ".join(f"rank {k}: {v['offset']:.6f} s (+/- "
                      f"{v['uncertainty']})" for k, v in sorted(
                          clocks.items())), flush=True)
    require(lanes == [f"rank {i}" for i in range(n)]
            and sorted(clocks) == sorted(str(i) for i in range(n))
            and all(c["synced"] for c in clocks.values()),
            f"{label}: lanes {lanes}, clocks {clocks}")
    by_rank = sorted(reports, key=lambda x: x["rank"])
    for r in by_rank:
        require(r["thresholds"] == by_rank[0]["thresholds"]
                and r["cycles"] == by_rank[0]["cycles"],
                f"{label}: rank {r['rank']} tuned {r['thresholds']}, rank "
                f"0 {by_rank[0]['thresholds']}")
        require(r["checksums_equal"], f"{label}: parameters differ across "
                "ranks")
        require(r["groups"] == by_rank[0]["groups"]
                and len(r["losses_a"]) == MEASURE_STEPS,
                f"{label}: rank {r['rank']} report {str(r)[:200]}")
    print(f"{label}: tuned threshold by step (every rank) "
          f"{by_rank[0]['thresholds']}, cycle ms {by_rank[0]['cycles']}; "
          "parameters bitwise equal across ranks (checksum allgather)",
          flush=True)
    require(len(set(by_rank[0]["thresholds"])) >= 2,
            f"{label}: the threshold never moved")
    lint = M.lint_exposition(text)
    ranks_seen = sorted({m for m in re.findall(r'rank="(\w+)"', text)})
    print(f"{label}: GET /metrics lint {'clean' if not lint else lint[:3]},"
          f" rank labels {ranks_seen}", flush=True)
    require(not lint and ranks_seen == sorted(
        [str(i) for i in range(n)] + ["driver"]),
        f"{label}: /metrics lint {lint[:3]}, ranks {ranks_seen}")
    report = err[err.find("[hvd] straggler report"):]
    require("[hvd] straggler report" in err and "slowest: rank" in report,
            f"{label}: no straggler report in the launcher's stderr")
    print(f"{label}: the launcher's {report.strip()}", flush=True)
    ms = [sum(r["ms_a"][WARMUP_STEPS:]) / (MEASURE_STEPS - WARMUP_STEPS)
          for r in by_rank]
    print(card, flush=True)
    print(f"{label} [{card}]: hook-driven step under measure() "
          f"{max(ms):.1f} ms (slowest rank; steps {WARMUP_STEPS + 1}-"
          f"{MEASURE_STEPS}, each synchronized)", flush=True)


PERF_RANK_STEPS = 8      # --parts perf: 1 warm-up and 7 timed steps


def perfed_worker(out_dir: str) -> int:
    """``--perfed DIR``: a rank of ``--ranks N --parts perf``, started by
    the port's launcher with ``--metrics-port`` and ``HOROVOD_PERF=1``.
    ``DIR/spec.json`` gives the model, device, batch, sequence and steps.
    The model at ZeRO level 3 (``zero_run``: fp32 master shards, bf16
    compute, phase 10's loader and prefetch), each step in
    ``hvd.perf.timed_step()``, the ledger given the ZeRO model; then the
    ``hvd_zero_sharded_bytes`` gauges against the plan's exact bytes and
    ``zero_memory_bytes``, the parameters' checksums gathered from every
    rank, a perf and a metrics publish.  Writes
    ``DIR/measured.<rank>.json`` and waits (at most 300 s) for
    ``DIR/scraped``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    from horovod_tpu_torch.perf import costmodel
    from horovod_tpu_torch.utils import metrics as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    cuda = spec["device"] == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    rt = hvd.init(device=None if cuda else spec["device"])
    require(rt.perf_publisher is not None
            and rt.metrics_publisher is not None, "the perf plane is not on")
    dev, rank, n = rt.device, hvd.rank(), hvd.size()
    cfg = llama.CONFIGS[spec["cfg"]]
    n_params = llama.param_count(cfg)
    rows = spec["batch"] * n
    hvd.perf.configure(
        flops_per_step=costmodel.train_flops_per_token(n_params)
        * spec["batch"] * spec["seq"],
        zero_model={"n_params": n_params, "world": n, "level": 3})
    tokens = zero_tokens(np, cfg.vocab, rows, spec["seq"], spec["steps"], n)
    r = zero_run(torch, np, hvd, llama, F, dev, rank, n, cfg, tokens,
                 spec["batch"], 3, timed=True)
    padded, buckets = r["padded"]
    gauges = {kind: M.ZERO_SHARDED_BYTES.value(kind=kind)
              for kind in ("params", "grads", "opt_state", "ef_residual")}
    # the chain's exact bytes: fp32 master parameters, the plan's padded
    # buckets, AdamW's two moments and its float32 step count a shard
    exact = {"params": n_params * 4 // n, "grads": padded * 4 // n,
             "opt_state": 2 * padded * 4 // n + 4 * buckets,
             "ef_residual": 0}
    model = costmodel.zero_memory_bytes(3, n_params, n)
    rows_sums = [torch.empty_like(r["sums"]) for _ in range(n)]
    dist.all_gather(rows_sums, r["sums"])
    require(rt.perf_publisher.publish_now(), "the perf publish failed")
    require(rt.metrics_publisher.publish_now(), "the metrics publish failed")
    out = {"rank": rank, "size": n, "losses": r["losses"],
           "step_ms": r["step_ms"], "launches": r["launches"],
           "sums_equal": all(torch.equal(rows_sums[0], x)
                             for x in rows_sums),
           "gauges": gauges, "exact": exact,
           "model": {k: model[f"{k}_bytes"] for k in exact},
           "level": M.ZERO_LEVEL.value(), "padded": padded,
           "buckets": buckets, "n_params": n_params,
           "report": hvd.perf_report()}
    write_json(os.path.join(out_dir, f"measured.{rank}.json"), out)
    deadline = time.time() + 300
    while not os.path.exists(os.path.join(out_dir, "scraped")):
        require(time.time() < deadline, "the parent never scraped")
        time.sleep(0.1)
    hvd.shutdown()
    return 0


def rank_perf(torch, n: int, card: str, device_type: str = "cuda",
              cfg_name: str = "1b", batch: int = TRAIN_BATCH,
              seq: int = TRAIN_SEQ) -> None:
    """``--ranks N --parts perf``: the perf plane across ranks, started as
    a user starts it, ``launch -np N --gpu --metrics-port P`` with
    ``HOROVOD_PERF=1`` over ``chip_smoke.py --perfed DIR``
    (``perfed_worker``): the model at ZeRO level 3, every rank's
    ``hvd_zero_sharded_bytes`` equal to the plan's exact bytes and, but for
    the plan's padding and AdamW's step counts, to ``zero_memory_bytes``'s
    split; ``GET /perf`` merging N ranks and ``launch doctor --perf``
    rendering it; the parameters bitwise equal across ranks."""
    import shutil
    import tempfile
    label = f"perf [{cfg_name} -np {n}, ZeRO level 3]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_perf_")
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump({"cfg": cfg_name, "device": device_type, "batch": batch,
                   "seq": seq, "steps": PERF_RANK_STEPS}, f)
    mport = free_port()
    proc = start_measured(out_dir, n, device_type,
                          ["--metrics-port", str(mport)], worker="--perfed")
    reports, text, _, view, doctor = finish_measured(label, proc, out_dir, n,
                                                     mport)
    shutil.rmtree(out_dir, ignore_errors=True)
    by_rank = sorted(reports, key=lambda x: x["rank"])
    for r in by_rank:
        g, e, m = r["gauges"], r["exact"], r["model"]
        print(f"{label} rank {r['rank']}: hvd_zero_level {r['level']:.0f}; "
              "hvd_zero_sharded_bytes " + ", ".join(
                  f"{k} {g[k]:.0f} (exact {e[k]}, zero_memory_bytes {m[k]},"
                  f" diff {g[k] - m[k]:+.0f})" for k in e)
              + f"; {r['buckets']} buckets, {r['padded'] - r['n_params']} "
              "padding elements", flush=True)
        require(r["level"] == 3 and all(g[k] == e[k] for k in e)
                and g["params"] == m["params"],
                f"{label}: rank {r['rank']} gauges {g}, exact {e}")
        pad = (r["padded"] - r["n_params"]) * 4
        require(0 <= g["grads"] - m["grads"] <= pad
                and 0 <= g["opt_state"] - m["opt_state"]
                <= 2 * pad + 4 * r["buckets"],
                f"{label}: rank {r['rank']}: {g} against {m}")
        require(r["sums_equal"], f"{label}: parameters differ across ranks")
        require(r["losses"] == by_rank[0]["losses"]
                and len(r["losses"]) == PERF_RANK_STEPS,
                f"{label}: rank {r['rank']} losses {r['losses']}")
    ranks = view.get("ranks", {})
    fleet = view.get("fleet", {})
    print(f"{label}: GET /perf {fleet.get('ranks')} ranks, fleet verdict "
          f"{fleet.get('verdict')}, step by rank " + json.dumps(
              fleet.get("step_time_by_rank")), flush=True)
    require(fleet.get("ranks") == n and sorted(ranks) == [
        str(i) for i in range(n)] and all(
        rep.get("steps") == PERF_RANK_STEPS for rep in ranks.values()),
        f"{label}: GET /perf {str(view)[:500]}")
    for k in sorted(ranks):
        rep = ranks[k]
        d = rep["decomposition"]
        print(f"{label} rank {k}: mean step "
              f"{rep['step_time_s']['mean'] * 1e3:.2f} ms = compute "
              f"{d['compute_s'] * 1e3:.2f} + comm "
              f"{d['exposed_comm_s'] * 1e3:.2f} + input "
              f"{d['host_input_s'] * 1e3:.3f} + stall "
              f"{d['stall_s'] * 1e3:.2f}; verdict {rep['verdict']}, "
              f"drift {rep['model_drift_ratio']:.4f}, chip "
              f"{rep['model']['chip']}, link {rep['model']['link']}; "
              f"memory {rep.get('memory', {}).get('source')} in use "
              f"{rep.get('memory', {}).get('measured', {}).get('bytes_in_use')}",
              flush=True)
    rc, out, err = doctor
    verdict = [ln for ln in out.splitlines() if ln.startswith("BOTTLENECK")]
    print(f"{label}: launch doctor --perf exit {rc}: {verdict}", flush=True)
    require(rc == 0 and verdict, f"{label}: doctor --perf exit {rc}: "
            f"{err[-1000:]}")
    ms = [r["step_ms"] for r in by_rank]
    print(card, flush=True)
    print(f"{label} [{card}]: step {max(ms):.1f} ms (slowest rank; steps "
          f"2-{PERF_RANK_STEPS}, each in timed_step)", flush=True)


PERF_ROW_TOL = 1e-12     # phase 16: |sum of a row's components - its step| (s)
PERF_STEP_RATIO = 1.10   # phase 16's ledger step against phase 5's, at most


def phase_perf(torch, np, hvd, llama, F, card: str, ref_losses,
               ref_step_ms: float, device_type: str = "cuda",
               cfg_name: str = "1b", batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ) -> dict:
    """Phase 16: the perf plane on phase 5's step, in process.  Phase 5's
    model, optimizer and batches, the batches as host arrays through
    ``hvd.prefetch``, each of the 8 steps in ``hvd.perf.timed_step()``
    with the ledger priced on 6N FLOPs a token and the chip it resolves;
    then a memory sample, one more step under ``hvd.profiler.trace`` and
    ``compiled_flops`` of one forward and backward.  Returns the kernels'
    launches of the 8 steps."""
    import shutil
    import tempfile
    from horovod_tpu_torch.perf import costmodel, memstats
    from horovod_tpu_torch.utils import profiler
    cuda = device_type == "cuda"
    label = f"perf [{cfg_name}]"
    if cuda:
        torch.cuda.empty_cache()
        hvd.init()
    else:
        hvd.init(device="cpu")
    cfg = llama.CONFIGS[cfg_name]
    dev = hvd.runtime.get().device
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    def loss_fn(m, ids):
        return llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                             ce_chunks=8)
    step = hvd.make_train_step(model, loss_fn, opt)
    rng = np.random.RandomState(0)  # phase 5's batches, on the host
    host = [rng.randint(0, cfg.vocab, (batch * hvd.size(), seq + 1),
                        dtype=np.int32) for _ in range(len(ref_losses))]
    tokens = batch * hvd.size() * seq
    flops = costmodel.train_flops_per_token(n_params) * tokens
    memstats.reset()

    def configure():
        hvd.perf.reset()
        hvd.perf.configure(flops_per_step=flops, zero_model={
            "n_params": n_params, "world": hvd.size(), "level": 0})
    configure()
    chip = hvd.perf.GLOBAL.chip()
    require(chip == ("h100" if cuda else "cpu"),
            f"{label}: the ledger resolved the chip {chip!r}")
    if cuda:
        torch.cuda.synchronize()
    F.reset_launches()
    losses, rows = [], []
    for i, ids in enumerate(hvd.prefetch(iter(host), device=dev)):
        if i == WARMUP_STEPS:
            # the report covers the steps phase 5 times: its warm-up
            # steps leave the ledger (their rows are checked below)
            configure()
        with hvd.perf.timed_step() as t:
            losses.append(step(ids))
        rows.append(t.row)
    launches = dict(F.LAUNCHES)
    losses = [float(x) for x in losses]
    print(f"{label} losses " + " ".join(f"{x:.5f}" for x in losses)
          + f"; bitwise phase 5's: {losses == list(ref_losses)}", flush=True)
    require(losses == list(ref_losses),
            f"{label}: losses {losses} vs phase 5's {ref_losses}")
    per_step = cfg.n_layers if cuda else 0
    for name in REPLACES:
        require(launches[name] == per_step * len(host),
                f"{label}: {name} launched {launches[name]} times in "
                f"{len(host)} steps")
    # the ledger's rows: four components summing to the measured step
    worst = max(abs(r["compute_s"] + r["exposed_comm_s"] + r["host_input_s"]
                    + r["stall_s"] - r["step_time_s"]) for r in rows)
    inputs = [r["host_input_s"] for r in rows]
    print(f"{label} rows (ms): " + "; ".join(
        f"step {r['step_time_s'] * 1e3:.2f} = compute "
        f"{r['compute_s'] * 1e3:.2f} + comm {r['exposed_comm_s'] * 1e3:.2f}"
        f" + input {r['host_input_s'] * 1e3:.3f} + stall "
        f"{r['stall_s'] * 1e3:.2f}" for r in rows)
        + f"; largest |sum - step| {worst:.3g} s", flush=True)
    require(len(rows) == len(host) and worst <= PERF_ROW_TOL,
            f"{label}: a row's components miss its step by {worst} s")
    require(max(inputs) > 0, f"{label}: no host input time on any step")
    rep = hvd.perf_report()
    mean_ms = rep["step_time_s"]["mean"] * 1e3
    steady_ms = sum(r["step_time_s"] for r in rows[WARMUP_STEPS:]) / (
        len(rows) - WARMUP_STEPS) * 1e3
    d = rep["decomposition"]
    print(card, flush=True)
    all_ms = sum(r["step_time_s"] for r in rows) / len(rows) * 1e3
    require(rep["steps"] == len(rows) - WARMUP_STEPS
            and abs(mean_ms - steady_ms) <= 1e-9,
            f"{label}: the report covers {rep['steps']} steps")
    print(f"{label} [{card}]: ledger mean step {mean_ms:.2f} ms over "
          f"steps {WARMUP_STEPS + 1}-{len(rows)} (all {len(rows)} steps: "
          f"{all_ms:.2f} ms) against phase 5's {ref_step_ms:.2f} ms, "
          f"ratio {mean_ms / ref_step_ms:.4f}; means compute "
          f"{d['compute_s'] * 1e3:.2f} ms, exposed comm "
          f"{d['exposed_comm_s'] * 1e3:.2f} ms, host input "
          f"{d['host_input_s'] * 1e3:.3f} ms, stall {d['stall_s'] * 1e3:.2f}"
          f" ms; verdict {rep['verdict']}, model_drift_ratio "
          f"{rep['model_drift_ratio']:.4f}; chip {rep['model']['chip']}, "
          f"link {rep['model']['link']}", flush=True)
    if cuda:
        require(mean_ms <= PERF_STEP_RATIO * ref_step_ms,
                f"{label}: ledger step {mean_ms:.1f} ms against phase 5's "
                f"{ref_step_ms:.1f} ms")
    # the memory sample, read against the allocator at the same point
    before = torch.cuda.memory_allocated(dev) if cuda else None
    sample = memstats.sample(force=True)
    if cuda:
        alloc = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        total = torch.cuda.mem_get_info(dev)[1]
        require(sample["source"] == "device"
                and sample["bytes_in_use"] == alloc == before
                and sample["peak_bytes_in_use"] == peak
                and sample["cap_bytes"] == total,
                f"{label}: memory sample {str(sample)[:400]} against "
                f"allocated {alloc}, peak {peak}, total {total}")
    else:
        require(sample["source"] == "live_buffers"
                and sample["bytes_in_use"] > 0,
                f"{label}: memory sample {str(sample)[:400]}")
    model0 = costmodel.zero_memory_bytes(0, n_params, hvd.size())
    planes = sample["planes"]
    print(f"{label} memory: source {sample['source']}, in use "
          f"{sample['bytes_in_use']} bytes, peak "
          f"{sample['peak_bytes_in_use']}, cap {sample['cap_bytes']}, "
          f"watermark {sample['watermark']:.4f}; planes " + ", ".join(
              f"{k} {v}" for k, v in planes.items())
          + f"; zero_memory_bytes(level 0, world {hvd.size()}) "
          + ", ".join(f"{k} {v}" for k, v in model0.items())
          + f"; drift (in use / predicted) "
          f"{sample['model_drift_ratio']:.4f}", flush=True)
    require(all(planes[k] == model0[f"{k}_bytes"] for k in (
        "params", "grads", "opt_state", "ef_residual")),
            f"{label}: planes {planes} against {model0}")
    # one more step under the profiler: a Chrome trace with the kernels
    logdir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        F.reset_launches()
        ids = torch.from_numpy(host[0]).to(dev)
        with profiler.trace(logdir):
            step(ids)
        kernels = profiler.trace_kernels(profiler.last_trace_path)
        counts = {fn: sum(fn in e.get("name", "") for e in kernels)
                  for fn in ("fwd_mma_kernel", "dq_mma_kernel",
                             "dkv_mma_kernel")}
        print(f"{label} profiler trace {profiler.last_trace_path}: "
              f"{len(kernels)} kernel events, {counts}", flush=True)
        if cuda:
            require(all(v == cfg.n_layers for v in counts.values()),
                    f"{label}: the trace holds {counts}, expected "
                    f"{cfg.n_layers} each")
        else:
            require(not kernels, f"{label}: CUDA kernels on the CPU")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    # the counted FLOPs of one forward and backward
    ids = torch.from_numpy(host[0]).to(dev)
    counted = costmodel.compiled_flops(lambda: loss_fn(model, ids).backward())
    require(counted is not None, f"{label}: compiled_flops counted nothing")
    attn = costmodel.train_flops_per_token(n_params, attention={
        "n_layers": cfg.n_layers, "dim": cfg.dim, "seq": seq}) * tokens
    print(f"{label} compiled_flops {counted:.6g} against 6N x tokens "
          f"{flops:.6g} (ratio {counted / flops:.4f}) and 6N + attention "
          f"{attn:.6g} (ratio {counted / attn:.4f})", flush=True)
    require(counted is not None and counted > 0,
            f"{label}: compiled_flops {counted}")
    opt.zero_grad(set_to_none=True)
    del step, opt, model
    hvd.shutdown()
    if cuda:
        torch.cuda.empty_cache()
    return launches


WATCH_NAN_STEP = 5       # phase 17: the step whose gradient the sentinel sees NaN in
WATCH_DEADLINE = 600     # seconds a forensics launch may take to exit
WATCH_KILL_LAYERS = 2    # phase 17's kill launch: 1b cut to 2 layers
WATCH_WATERMARK = "0.05"  # phase 17: the memory sampler's high watermark
POSTMORTEM_TIMEOUT = "20"  # --parts postmortem: HOROVOD_HEARTBEAT_TIMEOUT
SENTINEL_VIEW_S = 60     # (e), (f): seconds to wait for every rank's alert
STRAGGLER_TICKS = 5      # --parts postmortem (c): negotiated ticks after each step
STRAGGLER_TICK_S = 0.2   # --parts postmortem (c): seconds between tick starts
# --parts postmortem (c): the stall at `complete`.  70 ms puts rank 1's
# ages two power-of-two buckets above its peers' (131 against 32.8 ms),
# so one slow tick of a peer still leaves the ratio at the rule's 4
STRAGGLER_STALL_MS = 70
SENTINEL_PLAIN_STEPS = 4  # --parts postmortem (e), (f): unwrapped steps timed
WATCH_RULES = {"rules": [{"name": "chip-smoke-user-rule",
                          "family": "hvd_controller_cycles_total",
                          "kind": "threshold", "op": ">=", "value": 1e18,
                          "severity": "info"}]}


def http_get_json(port: int, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return json.loads(resp.read())


def watched_worker(out_dir: str) -> int:
    """``--watched DIR``: the worker of phase 17 and of ``--ranks N --parts
    postmortem``, started by the port's launcher with ``--postmortem`` (and
    ``--alerts``/``--chaos``) and ``HOROVOD_CONTROLLER=tcp``, so the native
    core is up and its flight recorder armed.  ``DIR/spec.json`` gives the
    model (``cfg``, ``layers``), device, batch, sequence, steps, ``opt``
    (``direct``: phase 5's ``DistributedOptimizer``; ``hook``: phase 7's,
    negotiated through the controller) and ``mode``:

    * ``sentinel``: phase 5's step with the forward and backward wrapped by
      ``hvd.sentinel.wrap`` over the runtime's group: on the direct step
      this rank's gradients before the sync, on the hook-driven one those
      of ``opt.synchronize()``.  At step 0 the rank also reports its own
      packed scalars and their reduction (``check``); at step
      ``WATCH_NAN_STEP`` rank 1 (rank 0 alone) hands the sentinel a copy
      of one gradient with a NaN in it (the update and the later losses
      stay phase 5's), which the reduction makes every rank's verdict.
      Each step is timed (synchronized) and its launches counted; after
      step ``WARMUP_STEPS - 1`` and the last the rank reads ``GET
      /health`` until its own step shows there; ``plain_steps`` more
      steps run unwrapped, timed alike.  Then it waits for the ``.nan``
      and (on a card) ``.mem`` flight dumps;
    * ``fault``: each step stamped (``postmortem.record_step``, a
      ``step.<rank>.<i>`` file holding the wall time) and clocked into the
      chaos injector (``chaos.step``), which ends or freezes the rank the
      ``--chaos`` spec names.  With ``ticks`` each step is followed by a
      barrier and that many negotiated allreduces of its loss, their
      starts paced ``tick_s`` apart on every rank (the controller's only
      traffic: a stall at ``complete`` then inflates the stalled rank's
      own negotiation ages, and no peer ever waits for it), after which
      the rank polls ``GET /alerts`` (at most 120 s) for
      ``straggler-suspect`` firing on rank 1 and records it, with every
      rank it fired on at that moment.

    Each rank that finishes writes ``DIR/watched.<rank>.json`` and waits
    (at most 300 s) for ``DIR/scraped``, stamping its last step while it
    waits, so the supervision sees it alive."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    from horovod_tpu_torch.parallel.data_parallel import (_rank_mean,
                                                          local_shard)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    cuda = spec["device"] == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    rt = ht.init(device=None if cuda else spec["device"])
    dev, rank, n = rt.device, ht.rank(), ht.size()
    require(rt.core is not None and rt.heartbeat is not None,
            "the controller or the heartbeats are off")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = llama.CONFIGS[spec["cfg"]]
    if spec.get("layers"):
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    rng = np.random.RandomState(0)  # phase 5's batches
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (spec["batch"] * n, spec["seq"] + 1),
        dtype=np.int32)).to(dev) for _ in range(spec["steps"])]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)

    def loss_fn(m, ids):
        return llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                             ce_chunks=8)

    api = ht if spec["opt"] == "hook" else hvd
    opt = api.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    api.broadcast_parameters(model.state_dict(), root_rank=0)
    api.broadcast_optimizer_state(opt, root_rank=0)
    out = {"rank": rank, "size": n, "device": str(dev)}
    port = int(os.environ["HOROVOD_RENDEZVOUS_PORT"])
    if spec["mode"] == "sentinel":
        params = list(model.parameters())
        hook = spec["opt"] == "hook"
        poison_rank = min(1, n - 1)
        seen = {"step": -1}

        def fwd_bwd(ids):
            local = local_shard(ids, rank, n).to(dev, non_blocking=True)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, local)
            loss.backward()
            if hook:  # the engine reduces the gradients in place
                opt.synchronize()
            return loss, [p.grad for p in params]

        def extract(res):
            loss, grads = res
            if seen["step"] == 0:  # the reduction against this rank's own
                seen["check"] = {
                    "local": hvd.sentinel.packed_stats(loss, grads).tolist(),
                    "reduced": hvd.sentinel.packed_stats(
                        loss, grads, axis_name="hvd").tolist()}
            if seen["step"] == WATCH_NAN_STEP and rank == poison_rank:
                bad = grads[0].clone()
                bad.view(-1)[0] = float("nan")
                grads = [bad] + grads[1:]
            return loss, grads

        def update():
            if hook:
                with opt.skip_synchronize():
                    opt.step()
            else:
                opt.step()

        wrapped = hvd.sentinel.wrap(fwd_bwd, axis_name="hvd",
                                    extract=extract)
        F.reset_launches()
        losses, ms, health, plain_ms = [], [], [], []
        for i, b in enumerate(batches):
            hvd.postmortem.record_step(i)
            seen["step"] = i
            t0 = time.perf_counter()
            loss, _ = wrapped(b)
            update()
            losses.append(float(_rank_mean(loss, n)))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i in (WARMUP_STEPS - 1, len(batches) - 1):
                deadline = time.time() + 30
                while True:  # the heartbeat publishes every 0.5 s
                    hb = http_get_json(port, "/health")["ranks"].get(
                        str(rank), {}).get("heartbeat", {})
                    if hb.get("step") == i:
                        break
                    require(time.time() < deadline,
                            f"GET /health never showed step {i}: {hb}")
                    time.sleep(0.1)
                health.append(hb)
                if n > 1:  # each rank's wait ends at its own time
                    import torch.distributed as dist
                    dist.barrier()
        for b in batches[:spec.get("plain_steps", 0)]:
            # the same step unwrapped, for the sentinel's cost in this run
            t0 = time.perf_counter()
            loss, _ = fwd_bwd(b)
            update()
            float(_rank_mean(loss, n))
            sync()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        hvd.sentinel.drain()
        out.update(losses=losses, ms=ms, plain_ms=plain_ms,
                   launches=dict(F.LAUNCHES), health=health,
                   check=seen["check"])
        flight = os.environ["HOROVOD_FLIGHT_RECORD"]
        want = [flight + ".nan"] + ([flight + ".mem"] if cuda else [])
        deadline = time.time() + 60
        while not all(os.path.exists(p) for p in want):
            require(time.time() < deadline, f"no flight dumps at {want}")
            hvd.postmortem.record_step(len(batches) - 1)  # alive, waiting
            time.sleep(0.1)
        require(rt.metrics_publisher.publish_now(),
                "the metrics publish failed")
    else:
        import torch.distributed as dist
        step = hvd.make_train_step(model, loss_fn, opt)
        losses = []
        for i, b in enumerate(batches):
            with open(os.path.join(out_dir, f"step.{rank}.{i}"), "w") as f:
                f.write(repr(time.time()))
            hvd.postmortem.record_step(i)
            hvd.chaos.step(i)  # the spec's kill or stall fires here
            losses.append(float(step(b)))
            if spec.get("ticks"):
                sync()
                dist.barrier()  # the ticks' starts line up across ranks
                gc.disable()  # no collector pause makes a rank late
                start = time.time()
                for k in range(spec["ticks"]):
                    time.sleep(max(0.0, start + k * spec["tick_s"]
                                   - time.time()))
                    ht.allreduce(torch.tensor([losses[-1]], device=dev),
                                 name=f"tick.{i}.{k}")
                gc.enable()
        out["losses"] = losses
        if spec.get("ticks"):
            require(rt.metrics_publisher.publish_now(),
                    "the metrics publish failed")
            verdict, hits, deadline = None, [], time.time() + 120
            while verdict is None and time.time() < deadline:
                hits = [f for f in http_get_json(port, "/alerts")["firing"]
                        if f["rule"] == "straggler-suspect"]
                verdict = next((f for f in hits if f["rank"] == 1), None)
                if verdict is None:
                    hvd.postmortem.record_step(len(batches) - 1)
                    time.sleep(0.5)
            from horovod_tpu_torch.utils import metrics as M
            fam = M.NEGOTIATION_AGE.to_family()
            ages = {b: c for b, c in zip(fam["bounds"], fam["samples"][0][
                "counts"]) if c} if fam["samples"] else {}
            out.update(straggler=verdict, straggler_firing=hits,
                       age_p99=M.NEGOTIATION_AGE.quantile(0.99), ages=ages)
    write_json(os.path.join(out_dir, f"watched.{rank}.json"), out)
    deadline = time.time() + 300
    while not os.path.exists(os.path.join(out_dir, "scraped")):
        require(time.time() < deadline, "the parent never scraped")
        # a rank waiting here is alive: its heartbeat says so, or the
        # launcher's supervision would end it as stalled
        hvd.postmortem.record_step(len(batches) - 1)
        time.sleep(0.1)
    ht.shutdown()
    return 0


def start_watched(out_dir: str, n: int, device_type: str, flags: list,
                  env_extra: dict):
    """``python -m horovod_tpu_torch.runner.launch -np n [--gpu] <flags>
    python3 chip_smoke.py --watched DIR`` in a session of its own, free
    coordinator and controller ports, the native controller over TCP;
    the launcher's own output goes to ``DIR/launcher.{out,err}``."""
    here = os.path.dirname(os.path.abspath(__file__))
    ports = [free_port(), free_port()]
    cmd = ([sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
            str(n)] + (["--gpu"] if device_type == "cuda" else [])
           + ["--coordinator-port", str(ports[0]), "--controller-port",
              str(ports[1])] + flags
           + [sys.executable, os.path.abspath(__file__), "--watched",
              out_dir])
    env = dict(os.environ, HOROVOD_CONTROLLER="tcp",
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]),
               **env_extra)
    for name in ("HOROVOD_POSTMORTEM_DIR", "HOROVOD_ALERTS",
                 "HOROVOD_CHAOS_SPEC"):
        env.pop(name, None)
    return subprocess.Popen(
        cmd, cwd=here, env=env, start_new_session=True,
        stdout=open(os.path.join(out_dir, "launcher.out"), "wb"),
        stderr=open(os.path.join(out_dir, "launcher.err"), "wb"))


def launcher_err(out_dir: str) -> str:
    with open(os.path.join(out_dir, "launcher.err"), errors="replace") as f:
        return f.read()


def worker_tails(label: str, logs: str, n: int) -> None:
    for r in range(n):
        for stream in ("stdout", "stderr"):
            fp = os.path.join(logs, f"rank.{r}", stream)
            if os.path.exists(fp):
                with open(fp, errors="replace") as f:
                    tail = f.read()[-3000:]
                if tail.strip():
                    print(f"{label}: rank {r} {stream} tail:\n{tail}",
                          flush=True)


def run_watched(label: str, out_dir: str, n: int, device_type: str,
                flags: list, env_extra: dict, reports: bool,
                during=None) -> tuple:
    """Start a forensics launch and wait for it: with ``reports``, for
    every rank's ``watched.<rank>.json`` (then ``during()`` runs while the
    ranks wait, ``scraped`` releases them); always for the launcher's
    exit, at most WATCH_DEADLINE seconds in all, after which its session
    is killed and the run fails.  Returns (the launcher's exit code, the
    seconds from the start to its exit, the ranks' reports, ``during``'s
    result)."""
    t0 = time.time()
    proc = start_watched(out_dir, n, device_type, flags, env_extra)
    got, seen = [], None
    try:
        if reports:
            files = [os.path.join(out_dir, f"watched.{r}.json")
                     for r in range(n)]
            while not all(os.path.exists(f) for f in files):
                require(proc.poll() is None, f"{label}: the launcher exited "
                        f"{proc.returncode} before every rank reported")
                require(time.time() - t0 < WATCH_DEADLINE,
                        f"{label}: no report after {WATCH_DEADLINE} s")
                time.sleep(0.2)
            for f in files:
                with open(f) as fh:
                    got.append(json.load(fh))
            seen = during() if during is not None else None
            with open(os.path.join(out_dir, "scraped"), "w"):
                pass
    except BaseException:
        finish_watched(label, out_dir, n, proc, t0, kill=True)
        raise
    rc, wall = finish_watched(label, out_dir, n, proc, t0)
    return rc, wall, got, seen


def finish_watched(label: str, out_dir: str, n: int, proc, t0: float,
                   kill: bool = False):
    """Wait for a forensics launch started at ``t0`` to exit, at most
    WATCH_DEADLINE seconds from its start, and return (its exit code, the
    seconds from its start to its exit).  Past the deadline, on an error,
    or at once with ``kill``, its session is killed and the tails of its
    logs are printed."""
    try:
        if not kill:
            rc = proc.wait(timeout=max(10.0, WATCH_DEADLINE - (time.time()
                                                               - t0)))
            return rc, time.time() - t0
    except BaseException:
        kill = True
        raise
    finally:
        if kill:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            print(f"{label}: launcher stderr tail:\n"
                  + launcher_err(out_dir)[-3000:], flush=True)
            worker_tails(label, os.path.join(out_dir, "pm", "logs"), n)


def flight_summary(fr: dict, path: str) -> str:
    return (f"{os.path.basename(path)} {os.path.getsize(path)} bytes, "
            f"reason {fr['reason']!r}, complete {fr['complete']}, "
            f"{len(fr['trace'])} native spans")


def phase_forensics(torch, card: str, ref_losses, ref_step_ms: float,
                    device_type: str = "cuda", cfg_name: str = "1b",
                    batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                    kill_layers=WATCH_KILL_LAYERS) -> dict:
    """Phase 17: the forensics planes on phase 5's step, started as a user
    starts them.  (1) ``launch -np 1 --gpu --postmortem DIR --alerts RULES
    --metrics-port P`` over ``chip_smoke.py --watched DIR`` (mode
    ``sentinel``) with ``HOROVOD_MEM_HIGH_WATERMARK`` at WATCH_WATERMARK:
    losses within 1e-4 of phase 5's (bitwise equality printed), the step
    beside phase 5's, ``GET /health`` showing the rank's step advance with
    a ``device`` memory row, the pressure path's ``.mem`` dump and the NaN
    step's ``.nan`` dump parsed complete, ``sentinel-nonfinite`` firing at
    ``GET /alerts`` with the step as context, ``launch doctor --watch URL
    --once`` rendering it, the launcher exiting 0 with no postmortem.
    (2) ``--chaos`` killing rank 0 at step 2 (the model cut to
    ``kill_layers`` layers): postmortem.json names rank 0, ``kill``, and
    ``launch doctor DIR`` prints the root cause.  (3) on a card, a SIGABRT
    delivered while the host waits in ``torch.cuda.synchronize`` with the
    recorder armed over Python's faulthandler (``--abort-sync``): a
    complete record with native spans, and the faulthandler's report.
    Returns the kernels' launches of (1)."""
    import shutil
    import tempfile
    from horovod_tpu_torch import postmortem as PM
    from horovod_tpu_torch.models import llama
    label = f"forensics [{cfg_name} -np 1]"
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_forensics_")
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump({"cfg": cfg_name, "device": device_type, "batch": batch,
                   "seq": seq, "steps": len(ref_losses), "mode": "sentinel",
                   "opt": "direct"}, f)
    rules = os.path.join(out_dir, "rules.json")
    with open(rules, "w") as f:
        json.dump(WATCH_RULES, f)
    mport = free_port()
    # (2)'s launch: a chaos kill, started while (1)'s rank waits to be
    # released, so its start-up overlaps (1)'s wind-down
    kill_label = f"forensics [{cfg_name} cut to {kill_layers} layers, kill]"
    kill_dir = tempfile.mkdtemp(prefix="chip_smoke_forensics_")
    kill_pm = os.path.join(kill_dir, "pm")
    with open(os.path.join(kill_dir, "spec.json"), "w") as f:
        json.dump({"cfg": cfg_name, "layers": kill_layers,
                   "device": device_type, "batch": batch, "seq": seq,
                   "steps": 4, "mode": "fault", "opt": "direct"}, f)
    kill_spec = os.path.join(kill_dir, "chaos.json")
    with open(kill_spec, "w") as f:
        json.dump({"seed": 23, "events": [
            {"kill": {"rank": 0, "step": 2, "exit_code": 1}}]}, f)
    kill = {}

    def read_views():
        kill["t0"] = time.time()
        kill["proc"] = start_watched(kill_dir, 1, device_type,
                                     ["--postmortem", kill_pm, "--chaos",
                                      kill_spec], {})
        return sentinel_views(mport, 1)

    try:
        launches = forensics_sentinel(
            label, out_dir, 1, "direct", card, device_type, cfg_name, mport,
            rules, {}, read_views, ref_losses, ref_step_ms)
        if cuda:
            abort_in_sync(card)  # while (2) runs
    except BaseException:
        if "proc" in kill:
            finish_watched(kill_label, kill_dir, 1, kill["proc"], kill["t0"],
                           kill=True)
        raise

    # (2): the chaos kill, attributed
    rc, wall = finish_watched(kill_label, kill_dir, 1, kill["proc"],
                              kill["t0"])
    got = PM.load_postmortem(kill_pm)
    sus = got["suspect"]
    drc, dout, derr = run_doctor([kill_pm])
    print(f"{kill_label}: launcher exit {rc} after {wall:.1f} s; suspect "
          f"{json.dumps(sus)}; postmortem.json "
          f"{os.path.getsize(os.path.join(kill_pm, 'postmortem.json'))} "
          f"bytes; launch doctor exit {drc}: {dout.splitlines()[1:2]}",
          flush=True)
    require(rc == 1 and (sus["rank"], sus["classification"]) == (0, "kill"),
            f"{kill_label}: exit {rc}, suspect {sus}")
    require(drc == 0 and "ROOT CAUSE: rank 0 — kill" in dout,
            f"{kill_label}: doctor: {dout[-1000:]} {derr[-1000:]}")
    shutil.rmtree(kill_dir, ignore_errors=True)
    return launches


def sentinel_views(mport: int, n: int) -> dict:
    """What the parent reads while a sentinel launch's ranks wait to be
    released: ``sentinel-nonfinite`` firing at ``GET /alerts`` (polled
    until it names all ``n`` ranks, at most ``SENTINEL_VIEW_S``), ``GET
    /health`` and a ``launch doctor --watch --once`` frame."""
    t0, firing = time.time(), []
    while time.time() < t0 + SENTINEL_VIEW_S:
        firing = [a for a in http_get_json(mport, "/alerts")["firing"]
                  if a["rule"] == "sentinel-nonfinite"]
        if {a["rank"] for a in firing} == set(range(n)):
            break
        time.sleep(0.25)
    views = {"firing": firing, "health": http_get_json(mport, "/health"),
             "doctor": run_doctor(["--watch", f"127.0.0.1:{mport}",
                                   "--once"]), "reported": t0}
    views["released"] = time.time()
    return views


def forensics_sentinel(label: str, out_dir: str, n: int, opt: str,
                       card: str, device_type: str, cfg_name: str,
                       mport: int, rules: str, env: dict, read_views,
                       ref_losses=None, ref_step_ms=None) -> dict:
    """A sentinel launch (``--watched`` mode ``sentinel``, its spec in
    ``out_dir``) of ``n`` ranks under ``--postmortem --alerts
    --metrics-port`` and its checks: the losses (within 1e-4 of
    ``ref_losses``, or alike on every rank), ``GET /health`` advancing
    with a ``device`` memory row, every rank's ``.nan`` (and on a card
    ``.mem``) dump complete, ``sentinel-nonfinite`` firing on every rank
    with the NaN's step, the doctor's frame, each kernel launched once a
    layer a step, and the reduction: every rank's reduced scalars alike,
    the sums of their own square-sums and counts and the mean of their
    losses.  Prints the wrapped step against ``ref_step_ms`` or the plain
    steps of the same run.  Returns rank 0's kernel launches."""
    import shutil
    from horovod_tpu_torch import postmortem as PM
    from horovod_tpu_torch.models import llama
    cuda = device_type == "cuda"
    pm = os.path.join(out_dir, "pm")
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    steps, plain = spec["steps"], spec.get("plain_steps", 0)
    t0 = time.time()
    rc, wall, reports, views = run_watched(
        label, out_dir, n, device_type,
        ["--postmortem", pm, "--alerts", rules, "--metrics-port",
         str(mport)],
        dict({"HOROVOD_MEM_HIGH_WATERMARK": WATCH_WATERMARK,
              "HOROVOD_METRICS_INTERVAL": "0.5",
              "HOROVOD_SERIES_RESOLUTION": "0.25",
              "HOROVOD_HEARTBEAT_INTERVAL": "0.5"}, **env), True,
        read_views)
    print(f"{label}: launch to every rank's report "
          f"{views['reported'] - t0:.1f} s, the views read in "
          f"{views['released'] - views['reported']:.1f} s, release to exit "
          f"{t0 + wall - views['released']:.1f} s", flush=True)
    require(rc == 0, f"{label}: the launcher returned {rc}: "
            + launcher_err(out_dir)[-2000:])
    require(not os.path.exists(os.path.join(pm, "postmortem.json")),
            f"{label}: a clean run wrote a postmortem")
    r = reports[0]
    if ref_losses is not None:
        diffs = [abs(a - b) for a, b in zip(r["losses"], ref_losses)]
        print(f"{label} losses " + " ".join(f"{x:.5f}" for x in r["losses"])
              + f"; phase 5's max |diff| {max(diffs):.3g}, bitwise equal: "
              f"{r['losses'] == list(ref_losses)}", flush=True)
        require(len(r["losses"]) == steps and max(diffs) <= EAGER_LOSS_TOL,
                f"{label}: losses {r['losses']} vs phase 5's {ref_losses}")
    else:
        print(f"{label} losses " + " ".join(f"{x:.5f}" for x in r["losses"]),
              flush=True)
        require(all(math.isfinite(x) for x in r["losses"])
                and all(o["losses"] == r["losses"] for o in reports),
                f"{label}: losses {[o['losses'] for o in reports]}")
    for o in reports:
        hb0, hb1 = o["health"]
        mem = hb1.get("mem") or {}
        print(f"{label}: GET /health rank {o['rank']} step {hb0['step']} "
              f"then {hb1['step']}, pending "
              f"{hb1.get('pending_collectives')}, core cycles "
              f"{hb1.get('core', {}).get('cycles')}, mem {json.dumps(mem)}",
              flush=True)
        require(hb1["step"] > hb0["step"] and hb1.get("core"),
                f"{label}: heartbeats {hb0} -> {hb1}")
        require(mem.get("source") == ("device" if cuda else "live_buffers"),
                f"{label}: the heartbeat's memory row is {mem}")
        fleet = views["health"]["ranks"][str(o["rank"])]
        require(fleet["heartbeat"]["step"] == steps - 1
                and not fleet["stale"],
                f"{label}: the parent's GET /health: {fleet}")
        flight = os.path.join(pm, f"flight.rank.{o['rank']}")
        dumps = [".nan"] + ([".mem"] if cuda else [])
        for ext in dumps:
            fr = PM.parse_flight_record(flight + ext)
            print(f"{label}: {flight_summary(fr, flight + ext)}", flush=True)
            require(fr["complete"] and fr["reason"].startswith(
                f"explicit:nan step={WATCH_NAN_STEP}" if ext == ".nan"
                else "explicit:mem watermark="),
                f"{label}: {flight}{ext}: {fr['reason']} {fr['complete']}")
    firing = views["firing"]
    print(f"{label}: GET /alerts sentinel-nonfinite "
          f"{json.dumps(firing)}", flush=True)
    require(sorted(a["rank"] for a in firing) == list(range(n))
            and all(a["severity"] == "critical" and a.get(
                "context", {}).get("hvd_sentinel_last_nonfinite_step")
                == WATCH_NAN_STEP for a in firing),
            f"{label}: GET /alerts: {firing}")
    drc, dout, derr = views["doctor"]
    print(f"{label}: launch doctor --watch --once exit {drc}:\n"
          + "\n".join(dout.splitlines()[:4]), flush=True)
    require(drc == 0 and "sentinel-nonfinite rank 0" in dout,
            f"{label}: doctor --watch: {dout[-1000:]} {derr[-1000:]}")
    local = [o["check"]["local"] for o in reports]
    reduced = [o["check"]["reduced"] for o in reports]
    want = [sum(x[0] for x in local), sum(x[1] for x in local),
            sum(x[2] for x in local) / n]
    print(f"{label}: step 0's [sq, nonfinite, loss] over {n} ranks "
          f"{reduced[0]}, the ranks' own {local}", flush=True)
    require(all(x == reduced[0] for x in reduced)
            and reduced[0][1] == want[1]
            and all(math.isclose(reduced[0][k], want[k], rel_tol=1e-6)
                    for k in (0, 2)),
            f"{label}: reduced {reduced}, the ranks' own {local}")
    per_step = llama.CONFIGS[cfg_name].n_layers if cuda else 0
    for o in reports:
        for name in REPLACES:
            got = o["launches"].get(name, 0)
            require(got == per_step * (steps + plain),
                    f"{label}: rank {o['rank']}'s {name} launched {got} "
                    f"times, expected {per_step} a step")
    ms = sum(r["ms"][WARMUP_STEPS:]) / (steps - WARMUP_STEPS)
    if ref_step_ms is None:  # the plain steps' first is left out
        ref_step_ms = sum(r["plain_ms"][1:]) / (plain - 1)
        against = f"the same step unwrapped (steps 2-{plain} of {plain})"
    else:
        against = "phase 5's"
    print(card, flush=True)
    print(f"{label} [{card}]: sentinel-wrapped step {ms:.1f} ms (steps "
          f"{WARMUP_STEPS + 1}-{steps}, each synchronized) against "
          f"{against} {ref_step_ms:.1f} ms, ratio {ms / ref_step_ms:.3f}; "
          f"launches {json.dumps({k: r['launches'].get(k, 0) for k in REPLACES})}"
          f"; launch to exit {wall:.1f} s", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {name: r["launches"].get(name, 0) for name in REPLACES}


ABORT_SLEEP_CYCLES = 1 << 36  # torch.cuda._sleep: far longer than the wait


def abort_sync_worker(path: str) -> int:
    """``--abort-sync PATH``: arm the flight recorder at PATH over Python's
    faulthandler, negotiate one op, queue a kernel that spins for a long
    time, print ``WAITING`` and wait in ``torch.cuda.synchronize``; the
    parent's SIGABRT ends it there."""
    import faulthandler
    import torch
    faulthandler.enable(file=sys.stderr)
    import horovod_tpu_torch.torch as ht
    rt = ht.init()
    require(rt.core is not None, "no native core")
    ht.allreduce(torch.ones(4, device=rt.device), name="probe")
    torch.cuda._sleep(ABORT_SLEEP_CYCLES)
    print("WAITING", flush=True)
    torch.cuda.synchronize()
    return 3  # not reached: the SIGABRT ends the process


def abort_in_sync(card: str) -> None:
    """Phase 17 (3): a SIGABRT while the host waits in
    ``cudaStreamSynchronize``, with the recorder armed after Python's
    faulthandler: the record is complete with native spans, and the
    process dies of SIGABRT through the faulthandler's report (the chained
    handler)."""
    import tempfile
    from horovod_tpu_torch import postmortem as PM
    label = "forensics [SIGABRT in cudaStreamSynchronize]"
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_abort_"),
                        "flight.rank.0")
    env = dict(os.environ, HOROVOD_CONTROLLER="tcp",
               HOROVOD_CONTROLLER_PORT=str(free_port()),
               HOROVOD_FLIGHT_RECORD=path, PYTHONPATH=here)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--abort-sync", path], cwd=here, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        line = proc.stdout.readline()
        require(line.strip() == b"WAITING", f"{label}: {line!r}")
        time.sleep(2.0)
        t0 = time.time()
        proc.send_signal(signal.SIGABRT)
        _, err = proc.communicate(timeout=60)
    except BaseException:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
        raise
    fr = PM.parse_flight_record(path)
    print(f"{label}: exit {proc.returncode} {time.time() - t0:.2f} s after "
          f"the signal; {flight_summary(fr, path)}; faulthandler's report: "
          f"{'Fatal Python error: Aborted' in err.decode()}", flush=True)
    require(proc.returncode == -signal.SIGABRT and fr["complete"]
            and fr["reason"] == "signal:SIGABRT" and fr["trace"]
            and "Fatal Python error: Aborted" in err.decode(errors="replace"),
            f"{label}: exit {proc.returncode}, {fr['reason']}, "
            f"{fr['complete']}, {len(fr['trace'])} spans: "
            + err.decode(errors="replace")[-2000:])


def fault_times(out_dir: str, rank: int, step: int) -> float:
    with open(os.path.join(out_dir, f"step.{rank}.{step}")) as f:
        return float(f.read())


def rank_postmortem(torch, n: int, card: str, device_type: str = "cuda",
                    cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                    seq: int = TRAIN_SEQ, timeout_s: str = POSTMORTEM_TIMEOUT,
                    tick_s: float = STRAGGLER_TICK_S,
                    stall_ms: int = STRAGGLER_STALL_MS,
                    tags: str = "abcdef",
                    ticks: int = STRAGGLER_TICKS) -> None:
    """``--ranks N --parts postmortem``: ``launch -np N --gpu --postmortem
    DIR --alerts RULES --chaos SPEC`` over ``chip_smoke.py --watched DIR``
    (mode ``fault``), ``1b`` at 4 x 2048 a card, one launch an experiment:
    (a) a kill of rank 2 at step 2 on the direct step: postmortem.json
    names rank 2, ``kill``, every other rank ``terminated``; (b) a stall of
    rank 1 at step 3 on the hook-driven step: the supervision names rank 1,
    ``stall``, and its flight record is complete, ``signal:SIGABRT``, with
    native spans; (c) a 70 ms stall at ``complete`` on rank 1, the direct
    step followed each time by STRAGGLER_TICKS paced negotiated ticks:
    ``straggler-suspect`` names rank 1 at ``GET /alerts`` while the job
    runs; (d) (b)'s stall on the direct step,
    whose verdicts are printed, not required.  Printed for each: the
    seconds from the fault to the launcher's exit and each survivor's
    seconds from the first failure's exit to its own (``tags`` picks the
    experiments; ``stall_ms``, ``tick_s`` and ``ticks`` set (c)'s pace;
    each rank prints its own negotiation-age p99 and histogram).  Then phase
    17's
    sentinel launch across the N ranks, (e) on the direct step (the
    scalars take one NCCL all_reduce) and (f) on the hook-driven one
    (negotiated through the engine), with rank 1's NaN every rank's
    verdict and the wrapped step against the same step unwrapped
    (``forensics_sentinel``)."""
    import shutil
    import tempfile
    from horovod_tpu_torch import postmortem as PM
    cases = (
        ("a", "direct", {"kill": {"rank": 2, "step": 2, "exit_code": 1}},
         2, 4, {}),
        ("b", "hook", {"stall": {"rank": 1, "step": 3,
                                 "duration_ms": 3600000}}, 1, 5, {}),
        ("c", "direct", {"stall": {"rank": 1, "point": "complete",
                                   "duration_ms": stall_ms}},
         None, 6, {"ticks": ticks, "tick_s": tick_s}),
        ("d", "direct", {"stall": {"rank": 1, "step": 3,
                                   "duration_ms": 3600000}}, 1, 5, {}),
    )
    for tag, opt, event, fault_rank, steps, extra in cases:
        if tag not in tags:
            continue
        label = f"postmortem [{cfg_name} -np {n}] ({tag}) {opt} step"
        if device_type == "cuda":
            torch.cuda.empty_cache()
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_postmortem_")
        pm = os.path.join(out_dir, "pm")
        with open(os.path.join(out_dir, "spec.json"), "w") as f:
            json.dump(dict({"cfg": cfg_name, "device": device_type,
                            "batch": batch, "seq": seq, "steps": steps,
                            "mode": "fault", "opt": opt}, **extra), f)
        rules = os.path.join(out_dir, "rules.json")
        with open(rules, "w") as f:
            json.dump(WATCH_RULES, f)
        spec = os.path.join(out_dir, "chaos.json")
        with open(spec, "w") as f:
            json.dump({"seed": 29, "events": [event]}, f)
        env = {"HOROVOD_HEARTBEAT_TIMEOUT": timeout_s,
               "HOROVOD_HEARTBEAT_INTERVAL": "0.5"}
        if tag == "c":
            env.update(HOROVOD_METRICS="1", HOROVOD_METRICS_INTERVAL="0.5",
                       HOROVOD_SERIES_RESOLUTION="0.25")
            if device_type != "cuda":
                # the CPU's memory sampler walks the collector's objects
                # under the GIL, long enough to make a rank late for a tick
                env["HOROVOD_MEM"] = "0"
        rc, wall, reports, _ = run_watched(
            label, out_dir, n, device_type,
            ["--postmortem", pm, "--alerts", rules, "--chaos", spec], env,
            tag == "c")
        t_exit = time.time()
        if tag == "c":
            print(f"{label}: launcher exit {rc} after {wall:.1f} s",
                  flush=True)
            require(rc == 0, f"{label}: the launcher returned {rc}: "
                    + launcher_err(out_dir)[-2000:])
            for r in sorted(reports, key=lambda x: x["rank"]):
                v = r["straggler"]
                print(f"{label}: rank {r['rank']} read GET /alerts: "
                      f"{json.dumps(v)}; straggler-suspect firing on ranks "
                      f"{[f['rank'] for f in r['straggler_firing']]}; its "
                      f"negotiation-age p99 {r['age_p99']} s (ops by "
                      f"bucket bound: {json.dumps(r['ages'])})", flush=True)
                require(v is not None and v["rank"] == 1
                        and v["value"] >= 4.0,
                        f"{label}: rank {r['rank']} saw {v}")
            shutil.rmtree(out_dir, ignore_errors=True)
            continue
        got = PM.load_postmortem(pm)
        sus, ranks = got["suspect"], got["ranks"]
        t_fault = fault_times(out_dir, fault_rank, event.get(
            "kill", event.get("stall"))["step"])
        first = got["first_failure"] or {}
        survivors = {r: info["exit"]["time"] - first.get("time", 0.0)
                     for r, info in ranks.items()
                     if info["exit"]["classification"] == "terminated"}
        print(f"{label}: launcher exit {rc}; suspect {json.dumps(sus)}; "
              "exits " + ", ".join(
                  f"rank {r}: {info['exit']['classification']} (rc "
                  f"{info['exit']['rc']})" for r, info in sorted(
                      ranks.items(), key=lambda kv: int(kv[0]))), flush=True)
        print(f"{label}: {t_exit - t_fault:.2f} s from the fault to the "
              f"launcher's exit; survivors ended "
              + ", ".join(f"rank {r} {s:.2f} s" for r, s in sorted(
                  survivors.items())) + " after the first failure's exit",
              flush=True)
        require(rc != 0, f"{label}: the launcher returned 0")
        require(all(s <= 10.5 for s in survivors.values()),
                f"{label}: survivors took {survivors}")
        if tag in ("a", "b"):
            want = (fault_rank, "kill" if tag == "a" else "stall")
            require((sus["rank"], sus["classification"]) == want,
                    f"{label}: suspect {sus}, want {want}")
            require(sorted(survivors) == sorted(
                str(r) for r in range(n) if r != fault_rank),
                f"{label}: survivors {sorted(survivors)}")
        fr = ranks[str(fault_rank)]["flight_record"]
        if fr:
            print(f"{label}: rank {fault_rank} flight record reason "
                  f"{fr['reason']!r}, complete {fr['complete']}, "
                  f"{len(fr['trace'])} native spans, "
                  f"{os.path.getsize(os.path.join(pm, f'flight.rank.{fault_rank}'))}"
                  " bytes", flush=True)
        if tag == "b":
            require(fr and fr["complete"] and fr["reason"] ==
                    "signal:SIGABRT" and fr["trace"],
                    f"{label}: rank 1's flight record {fr}")
            hb = ranks["1"]["heartbeat"]
            require(hb["step"] == 3 and hb["pending_collectives"] == 0,
                    f"{label}: rank 1's last heartbeat {hb}")
        if tag == "d":
            print(f"{label}: the monitor's verdicts (recorded, not "
                  "required): " + ", ".join(
                      f"rank {r}: {info['exit']['classification']}, "
                      f"pending {(info['heartbeat'] or {}).get('pending_collectives')}"
                      for r, info in sorted(ranks.items(),
                                            key=lambda kv: int(kv[0]))),
                  flush=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    for tag, opt in (("e", "direct"), ("f", "hook")):
        if tag not in tags:
            continue
        label = f"postmortem [{cfg_name} -np {n}] ({tag}) {opt} step, sentinel"
        if device_type == "cuda":
            torch.cuda.empty_cache()
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_postmortem_")
        with open(os.path.join(out_dir, "spec.json"), "w") as f:
            json.dump({"cfg": cfg_name, "device": device_type,
                       "batch": batch, "seq": seq,
                       "steps": WARMUP_STEPS + TIMED_STEPS + 1,
                       "plain_steps": SENTINEL_PLAIN_STEPS,
                       "mode": "sentinel", "opt": opt}, f)
        rules = os.path.join(out_dir, "rules.json")
        with open(rules, "w") as f:
            json.dump(WATCH_RULES, f)
        mport = free_port()
        forensics_sentinel(label, out_dir, n, opt, card, device_type,
                           cfg_name, mport, rules,
                           {"HOROVOD_HEARTBEAT_TIMEOUT": timeout_s},
                           lambda: sentinel_views(mport, n))
    print(card, flush=True)


ELASTIC_STEPS = WARMUP_STEPS + TIMED_STEPS + 1  # phase 5's 8 steps and batches
ELASTIC_KILL_STEP = 6    # --parts elastic (a): after step 6, two after the commit of step 4
ELASTIC_PHASE_STEPS = 6  # phase 18: phase 5's first 6 steps, two commits
ELASTIC_PHASE_KILL = 4   # phase 18: the kill after step 4, two after the commit of step 2
ELASTIC_TORN_COMMIT = 1  # (b): the store step rank 0 tears (the commit of step 4)
ELASTIC_MAX_TO_KEEP = 2  # the commits TreeState keeps, as JaxState
ELASTIC_DEADLINE = 900   # seconds an elastic launch may take to exit


def elastic_worker(out_dir: str) -> int:
    """``--elastic DIR``: one rank of phase 18 and ``--parts elastic``
    (a)-(b), started by the elastic driver (``launch --min-np --max-np
    --host-discovery-script``).  Phase 5's configuration (``1b`` at full
    width and depth, bf16, AdamW through ``DistributedOptimizer``, the
    flash kernels, ``ce_chunks=8``, the same seeded weights and its
    first ``steps`` batches of ``DIR/elastic.json``, ``TRAIN_BATCH`` rows a
    rank) under
    ``hvd.elastic.run`` with a ``TreeState`` in the fast store at
    ``DIR/elastic.json``'s ``store``.  A reset round restores the last
    commit (``load_from_disk``; a round that finds commits and restores
    none fails), a fresh start broadcasts rank 0's parameters and
    optimizer state as phase 5 does; then the rank trains to the last
    step.  After step ``i`` the rank
    calls ``hvd.chaos.step(i + 1)`` and commits after every second step
    but the last.  Every step's loss and the kernels' launches so far,
    each commit's ms and bytes, the restore's ms and the parameters'
    checksums gathered from every rank land in ``DIR/elastic.rank<r>.jsonl``
    with the host clock.  A rank that fails prints its traceback and exits
    at once."""
    t_main = time.time()
    try:
        return elastic_rank(out_dir, t_main)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def elastic_rank(out_dir: str, t_main: float) -> int:
    with open(os.path.join(out_dir, "elastic.json")) as f:
        spec = json.load(f)
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_type = spec.get("device", "cuda")
    t_import = time.time()
    dev = hvd.init(device=None if device_type == "cuda"
                   else device_type).device
    t_init = time.time()
    require(dev.type == device_type, f"the elastic worker runs on {dev}")
    rank, n = hvd.rank(), hvd.size()
    rnd = int(os.environ.get("HOROVOD_ELASTIC_ROUND", "0"))
    log = os.path.join(out_dir, f"elastic.rank{rank}.jsonl")

    def record(**rec):
        rec.update(round=rnd, t=time.time())
        with open(log, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = llama.CONFIGS[spec.get("cfg", "1b")]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    sync()
    t_model = time.time()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            ce_chunks=8), opt)
    rows, seq = spec.get("batch", TRAIN_BATCH), spec.get("seq", TRAIN_SEQ)
    steps = spec.get("steps", ELASTIC_STEPS)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab, (rows * n, seq + 1),
                           dtype=np.int32) for _ in range(steps)]
    t_batches = time.time()
    state = hvd.elastic.TreeState(params=model, opt_state=opt, step=0,
                                  sharded_commit_dir=spec["store"])
    own = sorted(state._fast().steps())
    sync()
    t_ready = time.time()
    t0 = time.perf_counter()
    restored = state.load_from_disk()
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    require(restored or not own, f"rank {rank}: commits {own} on disk, "
            "none restored (a quiet cold start)")
    if not restored:
        # a fresh start, as phase 5 starts
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        sync()
    record(kind="start", restored=state.last_restore, step=state.step,
           restore_ms=restore_ms if restored else None, own_steps=own,
           t_main=t_main, t_import=t_import, t_init=t_init,
           t_model=t_model, t_batches=t_batches, t_ready=t_ready)
    F.reset_launches()

    @hvd.elastic.run
    def loop(state):
        for i in range(state.step, steps):
            loss = float(step(torch.from_numpy(batches[i]).to(dev)))
            record(kind="step", step=i, loss=loss, launches=dict(F.LAUNCHES))
            state.step = i + 1
            record(kind="tick", chaos_step=state.step)
            hvd.chaos.step(state.step)
            if state.step % 2 == 0 and state.step < steps:
                sync()
                t = time.perf_counter()
                state.commit()
                sync()
                record(kind="commit", step=state.step,
                       ms=(time.perf_counter() - t) * 1e3,
                       bytes=state.last_commit_bytes)

    loop(state)
    sums = param_checksums(torch, list(model.parameters())).cpu().tolist()
    every = hvd.allgather_object(sums)
    record(kind="end", launches=dict(F.LAUNCHES), checksums=sums,
           same_params=all(s == every[0] for s in every),
           commits=sorted(state._fast().steps()))
    hvd.shutdown()
    return 0


def commit_room(label: str, store_dir: str, n: int, cfg) -> int:
    """The bytes one rank's commit writes (bf16 parameters and AdamW's two
    bf16 moments), after checking that the store's filesystem has room
    for ``ELASTIC_MAX_TO_KEEP`` commits of every rank plus the one being
    written."""
    import shutil
    from horovod_tpu_torch.models import llama
    per_rank = 3 * llama.param_count(cfg) * 2
    need = (ELASTIC_MAX_TO_KEEP + 1) * n * per_rank
    free = shutil.disk_usage(store_dir).free
    require(free >= need, f"{label}: the commit store's filesystem "
            f"({store_dir}) has {free / 1e9:.1f} GB free; {n} rank(s) "
            f"keeping {ELASTIC_MAX_TO_KEEP} commits of {per_rank / 1e9:.2f} "
            f"GB while writing one more need {need / 1e9:.1f} GB")
    return per_rank


def write_discovery(out_dir: str, n: int) -> str:
    """A discovery script printing ``localhost:n`` and ``127.0.0.1:n``:
    two aliases of this machine, one round on each (the first round's
    failure blacklists the alias it ran on)."""
    path = os.path.join(out_dir, "discover.sh")
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\necho localhost:{n}\necho 127.0.0.1:{n}\n")
    os.chmod(path, 0o755)
    return path


def write_chaos(out_dir: str, event: dict, seed: int) -> str:
    path = os.path.join(out_dir, "chaos.json")
    with open(path, "w") as f:
        json.dump({"seed": seed, "state_dir": os.path.join(
            out_dir, "chaos_state"), "events": [event]}, f)
    return path


def start_stamped(cmd: list, out_dir: str, env_extra: dict):
    """Start a launch in a session of its own, its stdout to
    ``DIR/launcher.out``, its stderr read line by line and stamped with
    the host clock on arrival (``proc.stamped``: ``(time, line)``), also
    kept in ``DIR/launcher.err``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), **env_extra)
    for name in ("HOROVOD_POSTMORTEM_DIR", "HOROVOD_ALERTS",
                 "HOROVOD_CHAOS_SPEC"):
        env.pop(name, None)
    proc = subprocess.Popen(
        cmd, cwd=here, env=env, start_new_session=True,
        stdout=open(os.path.join(out_dir, "launcher.out"), "wb"),
        stderr=subprocess.PIPE)
    proc.stamped = []

    def pump():
        with open(os.path.join(out_dir, "launcher.err"), "wb") as f:
            for raw in iter(proc.stderr.readline, b""):
                proc.stamped.append((time.time(), raw.decode(
                    errors="replace").rstrip("\n")))
                f.write(raw)
                f.flush()
    proc.pump = threading.Thread(target=pump, daemon=True)
    proc.pump.start()
    return proc


def end_stamped(label: str, proc, t0: float, out_dir: str, n: int,
                deadline: float = ELASTIC_DEADLINE, kill: bool = False):
    """Wait for a stamped launch, at most ``deadline`` seconds from
    ``t0``; past it, on an error, or at once with ``kill``, its session is
    killed (workers too) and the launcher's and the ranks' tails are
    printed."""
    ok = False
    try:
        if kill:
            return "killed"
        rc = proc.wait(timeout=max(10.0, deadline - (time.time() - t0)))
        ok = True
        return rc
    except subprocess.TimeoutExpired:
        return f"killed at {deadline:.0f} s"
    finally:
        if not ok and proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
        proc.pump.join(timeout=10)
        if not ok:
            print(f"{label}: launcher stderr tail:\n" + "\n".join(
                ln for _, ln in proc.stamped)[-3000:], flush=True)
            worker_tails(label, os.path.join(out_dir, "logs"), n)


def run_elastic(label: str, out_dir: str, n: int, event=None,
                device_type: str = "cuda", cfg_name: str = "1b",
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                steps: int = ELASTIC_STEPS) -> dict:
    """One elastic launch of ``n`` ranks over ``chip_smoke.py --elastic
    DIR``: ``python -m horovod_tpu_torch.runner.launch --min-np n --max-np
    n --host-discovery-script S [--chaos SPEC]`` with free ports, the
    ranks' output under ``DIR/logs``, the store under ``DIR/store``; with
    ``event``, the chaos spec holds that one event and a ``state_dir``, so
    it fires once.  Returns the launcher's exit code, its stamped stderr,
    each rank's records and the launch's seconds."""
    from horovod_tpu_torch.models import llama
    os.makedirs(out_dir, exist_ok=True)
    per_rank = commit_room(label, out_dir, n, llama.CONFIGS[cfg_name]) \
        if device_type == "cuda" else 0
    with open(os.path.join(out_dir, "elastic.json"), "w") as f:
        json.dump({"store": os.path.join(out_dir, "store"),
                   "device": device_type,
                   "cfg": cfg_name, "batch": batch, "seq": seq,
                   "steps": steps}, f)
    ports = [free_port(), free_port()]
    cmd = ([sys.executable, "-m", "horovod_tpu_torch.runner.launch",
            "--min-np", str(n), "--max-np", str(n),
            "--host-discovery-script", write_discovery(out_dir, n),
            "--elastic-timeout", "60", "--coordinator-port", str(ports[0]),
            "--controller-port", str(ports[1]), "--output-filename",
            os.path.join(out_dir, "logs")]
           + (["--chaos", write_chaos(out_dir, event, 18)] if event else [])
           + [sys.executable, os.path.abspath(__file__), "--elastic",
              out_dir])
    env = {} if device_type == "cuda" else {"CUDA_VISIBLE_DEVICES": ""}
    t0 = time.time()
    proc = start_stamped(cmd, out_dir, env)
    rc = end_stamped(label, proc, t0, out_dir, n)
    wall = time.time() - t0
    recs = {}
    for r in range(n):
        fp = os.path.join(out_dir, f"elastic.rank{r}.jsonl")
        if os.path.exists(fp):
            with open(fp) as f:
                recs[r] = [json.loads(ln) for ln in f]
    if isinstance(rc, int) and rc != 0:
        worker_tails(label, os.path.join(out_dir, "logs"), n)
        print(f"{label}: launcher stderr:\n" + "\n".join(
            ln for _, ln in proc.stamped)[-3000:], flush=True)
    require(rc == 0, f"{label}: the launcher returned {rc}")
    require(sorted(recs) == list(range(n)), f"{label}: records of ranks "
            f"{sorted(recs)}")
    # the chaos injector writes its fired marker right before the fault
    fired = [os.path.join(dp, f) for dp, _, fs in os.walk(os.path.join(
        out_dir, "chaos_state")) for f in fs if f.startswith("chaos_fired")]
    return {"rc": rc, "lines": proc.stamped, "recs": recs, "wall": wall,
            "per_rank": per_rank,
            "t_fault": os.path.getmtime(fired[0]) if fired else None}


def round_lines(r: dict) -> list:
    return [(t, ln) for t, ln in r["lines"] if "elastic round " in ln]


def elastic_losses(recs: list, rnd: int) -> dict:
    return {x["step"]: x["loss"] for x in recs
            if x["kind"] == "step" and x["round"] == rnd}


def elastic_report(label: str, r: dict, n: int, rounds: int,
                   fault_rank: int, card: str) -> dict:
    """The numbers of one elastic launch: commit ms and bytes per rank,
    the restore's ms, the seconds from the fault to the launcher's reset
    and from the reset to round 1's first finished step; requires one
    reset round (``rounds`` = 2) or none, every rank's end and the
    parameters bitwise equal across ranks."""
    lines = round_lines(r)
    require(len(lines) == rounds, f"{label}: rounds {[ln for _, ln in lines]}")
    for rank in range(n):
        end = r["recs"][rank][-1]
        require(end["kind"] == "end" and end["round"] == rounds - 1,
                f"{label}: rank {rank} did not end round {rounds - 1}")
        require(end["same_params"], f"{label}: parameters differ across "
                "ranks at the end")
    commits = {rank: [(x["ms"], x["bytes"]) for x in r["recs"][rank]
                      if x["kind"] == "commit"] for rank in range(n)}
    out = {"commits": commits}
    msg = (f"{label} [{card}]: launcher exit 0 after {rounds - 1} reset(s), "
           f"{r['wall']:.1f} s; commits per rank (ms / bytes): "
           + "; ".join(f"rank {k}: " + ", ".join(f"{ms:.0f} / {b}"
                                                 for ms, b in v)
                       for k, v in commits.items()))
    if rounds == 2:
        t_fault = r["t_fault"]
        t_reset = lines[1][0]
        firsts = [next(x["t"] for x in r["recs"][k] if x["round"] == 1
                       and x["kind"] == "step") for k in range(n)]
        restores = [next(x["restore_ms"] for x in r["recs"][k]
                         if x["round"] == 1 and x["kind"] == "start")
                    for k in range(n)]
        out.update(kill_to_reset=t_reset - t_fault,
                   reset_to_step=max(firsts) - t_reset,
                   restore_ms=restores)
        st = next(x for x in r["recs"][0] if x["round"] == 1
                  and x["kind"] == "start")
        msg += (f"; restore ms " + ", ".join(f"{x:.0f}" for x in restores)
                + f"; fault (rank {fault_rank}) to the launcher's reset "
                f"{t_reset - t_fault:.2f} s; reset to round 1's first "
                f"finished step {max(firsts) - t_reset:.2f} s (rank 0: "
                f"python up {st['t_main'] - t_reset:.2f} s after the reset, "
                f"imports {st['t_import'] - st['t_main']:.2f} s, hvd.init "
                f"{st['t_init'] - st['t_import']:.2f} s, model "
                f"{st['t_model'] - st['t_init']:.2f} s, optimizer, step and "
                f"batches {st['t_batches'] - st['t_model']:.2f} s, store "
                f"{st['t_ready'] - st['t_batches']:.2f} s, restore "
                f"{st['restore_ms'] / 1e3:.2f} s, first step done "
                f"{firsts[0] - st['t'] :.2f} s later)")
    print(msg, flush=True)
    return out


def kernel_launches(recs: list, rnd: int) -> dict:
    steps = [x for x in recs if x["kind"] == "step" and x["round"] == rnd]
    return steps[-1]["launches"], len(steps)


def check_round_launches(label: str, recs: list, rnd: int, layers: int,
                         device_type: str) -> dict:
    launches, n_steps = kernel_launches(recs, rnd)
    if device_type == "cuda":
        for name in REPLACES:
            require(launches.get(name) == layers * n_steps,
                    f"{label}: {name} launched {launches.get(name)} times in "
                    f"round {rnd}'s {n_steps} steps, expected {layers} a step")
    return launches


def phase_elastic(torch, card: str, ref_losses, device_type: str = "cuda",
                  cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                  seq: int = TRAIN_SEQ) -> dict:
    """Phase 18: elastic training on one card.  ``launch --min-np 1
    --max-np 1 --host-discovery-script S --chaos SPEC`` over ``chip_smoke.py
    --elastic DIR`` (S prints ``localhost:1`` and ``127.0.0.1:1``), phase
    5's step for its first ``ELASTIC_PHASE_STEPS`` steps, committing to
    the fast store after every second step, the chaos kill after step 4
    (two steps after the commit of step 2, once: the spec has a
    ``state_dir``).  The driver blacklists the first alias and resets;
    round 1 runs on the other, restores the commit of step 2 and trains to
    step 6.  Every loss of both rounds must be bitwise phase
    5's at its step, the kernels launched 16 times a step in each round,
    the rank's and the launcher's exits 0 after one reset.  Returns the
    kernels' launches of both rounds."""
    import shutil
    import tempfile
    from horovod_tpu_torch.models import llama
    if device_type == "cuda":
        torch.cuda.empty_cache()
    label = f"elastic [{cfg_name} -np 1, kill after step {ELASTIC_PHASE_KILL}]"
    layers = llama.CONFIGS[cfg_name].n_layers
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    t0 = time.time()
    try:
        r = run_elastic(label, out_dir, 1, {"kill": {
            "rank": 0, "step": ELASTIC_PHASE_KILL}}, device_type, cfg_name,
            batch, seq, ELASTIC_PHASE_STEPS)
        require(os.path.exists(os.path.join(
            out_dir, "chaos_state", "chaos_fired_0_rank0")),
            f"{label}: the chaos kill never fired")
        recs = r["recs"][0]
        start = [x for x in recs if x["kind"] == "start"]
        require([s["round"] for s in start] == [0, 1],
                f"{label}: starts {start}")
        last = ELASTIC_PHASE_KILL - 2  # the last commit before the kill
        require(start[1]["restored"] == {"format": "fast",
                                         "step": last // 2 - 1}
                and start[1]["step"] == last,
                f"{label}: round 1 restored {start[1]['restored']} at step "
                f"{start[1]['step']}, expected the commit of step {last}")
        got = {}
        for rnd, want in ((0, range(ELASTIC_PHASE_KILL)),
                          (1, range(last, ELASTIC_PHASE_STEPS))):
            losses = elastic_losses(recs, rnd)
            require(sorted(losses) == list(want),
                    f"{label}: round {rnd} ran steps {sorted(losses)}")
            got[rnd] = losses
        same = all(got[k][i] == ref_losses[i] for k in got for i in got[k])
        print(f"{label}: round 0 losses " + " ".join(
            f"{got[0][i]:.5f}" for i in sorted(got[0])) + "; round 1 "
            + " ".join(f"{got[1][i]:.5f}" for i in sorted(got[1]))
            + f"; bitwise phase 5's at every step: {same}", flush=True)
        require(same, f"{label}: a loss differs from phase 5's")
        launches = {}
        for rnd in (0, 1):
            lr = check_round_launches(label, recs, rnd, layers, device_type)
            for k, v in lr.items():
                launches[k] = launches.get(k, 0) + v
        rep = elastic_report(label, r, 1, 2, 0, card)
        print(f"{label}: commit bytes {rep['commits'][0][0][1]} "
              f"({rep['commits'][0][0][1] / 1e9:.3f} GB: bf16 parameters "
              "and AdamW's two bf16 moments, with the step counts); "
              f"launches {json.dumps(launches)}; phase "
              f"{time.time() - t0:.1f} s", flush=True)
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def rank_elastic(torch, np, n: int, card: str, device_type: str = "cuda",
                 cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> None:
    """``--ranks N --parts elastic``: the parent starts one elastic launch
    an experiment, ``1b`` at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` a card, S
    printing ``localhost:N`` and ``127.0.0.1:N``, ``--min-np N --max-np
    N``: (a) an unfaulted launch, then a chaos kill of rank 2 after step 6
    (two after the commit of step 4): round 1's losses bitwise the
    unfaulted launch's, the parameters bitwise equal across ranks and to
    the unfaulted run's; (b) rank 0 crashing between the data and the
    marker of its second commit (``crash_commit``, ``pre_marker``): every
    rank restores the first, none reads the torn one, commits go on past
    it, the losses from there bitwise (a)'s unfaulted ones; (c) elastic
    serving (``rank_elastic_serve``)."""
    import shutil
    import tempfile
    from horovod_tpu_torch.models import llama
    layers = llama.CONFIGS[cfg_name].n_layers
    root = tempfile.mkdtemp(prefix="chip_smoke_ranks_elastic_")
    kw = dict(device_type=device_type, cfg_name=cfg_name, batch=batch,
              seq=seq)
    try:
        lbl = f"elastic [{cfg_name} -np {n}]"
        clean = run_elastic(f"{lbl} (a) unfaulted", os.path.join(
            root, "clean"), n, **kw)
        elastic_report(f"{lbl} (a) unfaulted", clean, n, 1, 0, card)
        check_round_launches(f"{lbl} (a) unfaulted", clean["recs"][0], 0,
                             layers, device_type)
        ref = elastic_losses(clean["recs"][0], 0)
        require(sorted(ref) == list(range(ELASTIC_STEPS)),
                f"{lbl} (a): unfaulted steps {sorted(ref)}")
        shutil.rmtree(os.path.join(root, "clean", "store"),
                      ignore_errors=True)

        for tag, event, fault_rank, restored_step, from_step in (
                (f"(a) kill of rank {2 % n}", {"kill": {
                    "rank": 2 % n, "step": ELASTIC_KILL_STEP}}, 2 % n, 1, 4),
                ("(b) torn commit of rank 0", {"crash_commit": {
                    "rank": 0, "step": ELASTIC_TORN_COMMIT,
                    "point": "pre_marker"}}, 0, ELASTIC_TORN_COMMIT - 1, 2)):
            label = f"{lbl} {tag}"
            d = os.path.join(root, tag.split()[0].strip("()"))
            r = run_elastic(label, d, n, event, **kw)
            fired = os.path.join(d, "chaos_state",
                                 f"chaos_fired_0_rank{fault_rank}")
            require(os.path.exists(fired), f"{label}: the fault never fired")
            rep = elastic_report(label, r, n, 2, fault_rank, card)
            for rank in range(n):
                recs = r["recs"][rank]
                start = [x for x in recs if x["kind"] == "start"
                         and x["round"] == 1][0]
                require(start["restored"] == {"format": "fast",
                                              "step": restored_step}
                        and start["step"] == from_step,
                        f"{label}: rank {rank} restored {start['restored']} "
                        f"at step {start['step']}")
                if event.get("crash_commit") and rank == 0:
                    # the torn step never became durable on rank 0
                    require(ELASTIC_TORN_COMMIT not in start["own_steps"],
                            f"{label}: rank 0 holds the torn step: "
                            f"{start['own_steps']}")
                after = elastic_losses(recs, 1)
                require(sorted(after) == list(range(from_step,
                                                    ELASTIC_STEPS))
                        and all(after[i] == ref[i] for i in after),
                        f"{label}: rank {rank} round 1 losses {after} vs "
                        f"unfaulted {ref}")
                check_round_launches(label, recs, 1, layers, device_type)
                end = recs[-1]
                require(end["checksums"] == clean["recs"][rank][-1][
                    "checksums"], f"{label}: rank {rank}'s final parameters "
                    "differ from the unfaulted run's")
                if event.get("crash_commit"):
                    require(max(end["commits"]) > ELASTIC_TORN_COMMIT,
                            f"{label}: commits stopped at {end['commits']}")
            print(f"{label}: round 1 restored store step {restored_step} "
                  f"(step {from_step}) on every rank; losses from step "
                  f"{from_step} bitwise the unfaulted launch's; final "
                  f"parameters bitwise equal across ranks and to the "
                  f"unfaulted run's; kill to reset "
                  f"{rep['kill_to_reset']:.2f} s", flush=True)
            shutil.rmtree(os.path.join(d, "store"), ignore_errors=True)
        rank_elastic_serve(torch, np, min(n, 2), card, device_type)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def rank_elastic_serve(torch, np, n: int, card: str,
                       device_type: str = "cuda", cfg_name: str = "1b",
                       new_tokens: int = SERVE_NEW_TOKENS,
                       prompts=None, kill_tick=None) -> None:
    """``--parts elastic`` (c): ``launch --serve DIR --min-np n --max-np n
    --host-discovery-script S --chaos SPEC`` (S printing ``localhost:n``
    and ``127.0.0.1:n``) over phase 14's fp32 ``1b`` servable, the parent
    the client of phase 14's requests; the chaos kill of rank 1 lands at
    the engine work tick a quarter of the way through the one-card
    engine's run of the same requests, while tokens stream (rank 0 leads
    the plan stream and runs ahead of rank 1 by a few ticks).  The driver
    resets the fleet, whose rank 0 redrives the journaled requests past
    their streamed prefix; every stream must equal one card's in-process
    engine's tokens byte for byte, the redrives be counted, and ``POST
    /admin/drain`` end the launcher with exit 0."""
    import dataclasses
    import shutil
    import tempfile
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import llama
    dev = torch.device(device_type, 0)
    cfg = dataclasses.replace(llama.CONFIGS[cfg_name], dtype=torch.float32)
    if prompts is None:
        prompts = serve_traffic(np.random.RandomState(0), cfg.vocab)
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    scfg = serve.ServeConfig()
    scfg = dataclasses.replace(scfg, max_seq_len=min(scfg.max_seq_len,
                                                     cfg.max_seq))
    engine = serve.ServeEngine(model, scfg, device=dev)
    reqs = [engine.submit(p, new_tokens, req_id=f"r{i}")
            for i, p in enumerate(prompts)]
    engine.flush()
    if kill_tick is None:
        kill_tick = max(2, engine.tick // 4)
    engine.close()
    ref = [r.out_tokens for r in reqs]
    label = f"elastic serve [{cfg_name} fp32 --min-np {n} --max-np {n}]"
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_serve_")
    proc = None
    try:
        d = os.path.join(root, "servable")
        serve.save_servable(d, "llama", cfg, model)
        del model, engine
        if device_type == "cuda":
            torch.cuda.empty_cache()
        port = free_port()
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "--min-np", str(n), "--max-np", str(n),
               "--host-discovery-script", write_discovery(root, n),
               "--elastic-timeout", "60", "--chaos", write_chaos(
                   root, {"kill": {"rank": 1, "step": kill_tick}}, 23),
               "--serve", d, "--serve-port", str(port), "--serve-ttl",
               str(FLEET_TTL), "--coordinator-port", str(free_port()),
               "--controller-port", str(free_port()), "--output-filename",
               os.path.join(root, "logs")]
        if device_type != "cuda":
            cmd += ["--serve-device", device_type]
        env = {} if device_type == "cuda" else {"CUDA_VISIBLE_DEVICES": ""}
        t0 = time.time()
        proc = start_stamped(cmd, root, env)
        while True:
            require(proc.poll() is None and time.time() - t0 < FLEET_DEADLINE,
                    f"{label}: the fleet never came up")
            try:
                _, st = http_json(port, "GET", "/serve/stats", timeout=5)
                if "engine" in (st or {}):
                    break
            except OSError:
                pass
            time.sleep(0.2)
        ready_s = time.time() - t0
        offset = time.time() - time.perf_counter()
        out = fleet_clients(port, prompts, new_tokens)
        _, st = http_json(port, "GET", "/serve/stats")
        code, ack = http_json(port, "POST", "/admin/drain", {}, timeout=120)
        rc = end_stamped(label, proc, t0, root, n, FLEET_DEADLINE)
    except BaseException:
        if proc is not None:
            end_stamped(label, proc, t0, root, n, kill=True)
        shutil.rmtree(root, ignore_errors=True)
        raise
    try:
        fired = os.path.join(root, "chaos_state", "chaos_fired_0_rank1")
        require(os.path.exists(fired), f"{label}: the chaos kill never fired")
        require(rc == 0, f"{label}: the launcher returned {rc}")
        require(code == 200 and (ack or {}).get("drained") is True,
                f"{label}: drain {code} {ack}")
        lines = round_lines({"lines": proc.stamped})
        require(len(lines) == 2, f"{label}: rounds {lines}")
        outs = []
        for i, rec in enumerate(out):
            require(rec.get("status") == 200 and rec["error"] is None
                    and rec["done"] is not None,
                    f"{label}: request {i}: {str(rec)[:300]}")
            streamed = [t for _, toks in rec["parts"] for t in toks]
            require(streamed == rec["done"]["tokens"],
                    f"{label}: request {i}'s stream differs from its done "
                    "record")
            outs.append(streamed)
        same = sum(a == b for a, b in zip(outs, ref))
        with open(os.path.join(root, "logs", "rank.0", "stdout"),
                  errors="replace") as f:
            log0 = f.read()
        redriven = [int(x) for x in re.findall(
            r"redriving (\d+) journaled request", log0)]
        t_kill = os.path.getmtime(fired)
        t_reset = lines[1][0]
        after = [t + offset for rec in out for t, _ in rec["parts"]
                 if t + offset > t_reset]
        print(f"{label} [{card}]: ready {ready_s:.2f} s; rank 1 killed at "
              f"its engine tick {kill_tick}; the driver's reset "
              f"{t_reset - t_kill:.2f} s after the kill; journal redrives "
              f"{sum(redriven)} ({redriven}); first redriven token "
              + (f"{min(after) - t_kill:.2f} s" if after else "none")
              + f" after the kill; {same} of {len(ref)} streams "
              "byte-identical to one card's tokens; drained, launcher exit "
              f"{rc}", flush=True)
        require(same == len(ref), f"{label}: tokens differ from one card's")
        require(sum(redriven) >= 1 and after,
                f"{label}: no journal redrive after the reset")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ the zoo
ZOO_STEPS = (2, 3)       # phase 19 (a): warm-up and timed steps a family
ZOO_R50_MORE = 2         # ResNet-50: more timed steps, then 1 profiled
ZOO_FP32 = (64, 8)       # (b): image size, images (a card in --parts zoo)
ZOO_LOSS_RTOL = 1e-4     # (b): the first step's loss, relative
ZOO_STATS_TOL = 1e-4     # (b): BN running statistics, of each tensor's max
# (b): each parameter's update |u - u_ref| / |u_ref| (Frobenius).  A ReLU
# CNN at initialization with BN in training mode is chaotic in fp32: a
# 1e-6 relative change of the input moves a ResNet-50 update by up to 3.3%
# of its norm (and a weight by 2% of the largest weight) on the CPU, so
# the card's convolutions against the CPU's cannot meet 1e-4 there; a
# missing, doubled or half-rate update reads 0.5 or more
ZOO_UPDATE_TOL = 0.1
BERT_BATCH, BERT_SEQ = 8, 512  # (c): BERT-Large's batch
BERT_LR = 1e-4
ZOO_BERT_LOSS_TOL = 2e-2  # (c): kernels against the plain attention (phase 4's)
ZOO_SEQ_TOL = dict(atol=2e-4, rtol=1e-3)  # --parts zoo (c), fp32 2 layers
ZOO_MNIST_DEADLINE = 300  # (d): seconds the MNIST launch may take
ZOO_CPU = dict(batch=2, fp32=(32, 2), bert="tiny", bert_batch=2,
               bert_seq=64, steps=(1, 1), more=0)  # the CPU rehearsals


def zoo_kind(key: str) -> str:
    """The kind a profiled CNN step's CUDA kernel books its time under."""
    low = key.lower()
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in ("multi_tensor_apply", "sgd", "foreach")):
        return "sgd"
    if any(k in low for k in ("conv", "xmma", "implicit", "dgrad", "wgrad",
                              "fprop", "cudnn", "gemm", "nvjet", "cutlass",
                              "winograd", "nhwc", "nchw")):
        return "convolutions"
    return "bn and elementwise"


def zoo_profile(prof, label: str, step_ms: float) -> dict:
    """A profiled CNN step's device time by kind (convolutions with the
    head's matrix product and their layout transforms, BN and other
    elementwise kernels, the SGD update, NCCL), printed with the idle share
    against the timed step."""
    from torch.autograd import DeviceType
    kinds = dict.fromkeys(("convolutions", "bn and elementwise", "sgd",
                           "nccl"), 0.0)
    top = []
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        kinds[zoo_kind(evt.key)] += evt.self_device_time_total / 1e3
        top.append((evt.self_device_time_total / 1e3, evt.count, evt.key))
    busy = sum(kinds.values())
    require(busy > 0, f"{label}: the profiled step shows no device time")
    idle = max(0.0, 1 - busy / step_ms)
    print(f"{label} profiled step: device busy {busy:.2f} ms (timed step "
          f"{step_ms:.2f} ms, idle share {idle:.3f}); "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f}%)"
                      for k, v in kinds.items()), flush=True)
    for ms, count, key in sorted(top, reverse=True)[:6]:
        print(f"  {ms:8.2f} ms x{count:<4} {key[:90]}", flush=True)
    return dict(kinds, busy_ms=busy, idle=idle)


def zoo_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def zoo_cnn_run(torch, hvd, zoo, family: str, dev, size=None, batch=None,
                steps=ZOO_STEPS, more: int = 0, profile: bool = False,
                label: str = "zoo") -> dict:
    """One family at its recipe (bf16 on the card; fp32 on the CPU), batch
    a card ``batch`` (default the recipe's) of ``size`` px (default the
    canonical), through ``DistributedOptimizer(SGD(lr, momentum=0.9))``
    and the recipe's step (sync-BN over every rank): warm-up and timed
    steps, ``more`` timed steps after them, and a profiled step.  The
    batch is made once on the device (bench.py's protocol); every rank
    makes the same global batch and trains on its rows."""
    fam = zoo.CNN_FAMILIES[family]
    size, batch = size or fam.size, batch or fam.batch
    n = hvd.size()
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    model = zoo.cnn_init(family, 1000, dtype, gen, dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=fam.lr, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    step = zoo.make_cnn_train_step(family, model, opt)
    x = torch.randn(batch * n, size, size, 3, generator=gen,
                    device=dev).to(dtype)
    y = torch.randint(0, 1000, (batch * n,), generator=gen, device=dev)
    zoo_sync(torch, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    warm, timed = steps
    losses = [step(x, y) for _ in range(warm)]
    zoo_sync(torch, dev)
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(timed + more)]
    zoo_sync(torch, dev)
    dt = time.perf_counter() - t0
    step_ms = dt / (timed + more) * 1e3
    out = {"family": family, "size": size, "batch": batch, "ranks": n,
           "step_ms": step_ms, "img_s_card": batch * (timed + more) / dt,
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if cuda else None), "model": model}
    if profile:  # every rank steps; rank 0 reports
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            losses.append(step(x, y))
            zoo_sync(torch, dev)
        if hvd.rank() == 0:
            out["profile"] = zoo_profile(prof, f"{label} [{family}]",
                                         step_ms)
    out["losses"] = [float(v) for v in losses]
    require(all(math.isfinite(v) for v in out["losses"]),
            f"{family}: non-finite loss {out['losses']}")
    require(max(out["losses"]) - min(out["losses"]) > 0.0,
            f"{family}: loss constant across steps, parameters not updating")
    if hvd.rank() == 0:
        gflop = 3 * fam.fwd_flops * (size / fam.size) ** 2 * batch / 1e9
        print(f"{label} [{family}] {size} px, {batch} a card x {n}: step "
              f"{step_ms:.2f} ms, {out['img_s_card']:.1f} images/s per card, "
              f"{gflop / step_ms:.1f} TFLOP/s a card (3 x forward FLOPs), "
              f"peak {out['peak_gib'] or 0:.2f} GiB; losses "
              + " ".join(f"{v:.4f}" for v in out["losses"]), flush=True)
    return out


def zoo_state_diff(torch, got: dict, ref: dict, before: dict) -> dict:
    """The first-step checks of (b): BN statistics against each tensor's
    largest magnitude, every parameter's update against its norm
    (Frobenius), and the updated weights against the largest weight."""
    stats = upd = wmax = werr = 0.0
    for name, r in ref.items():
        g = got[name].detach().to("cpu", torch.float64)
        r = r.detach().to("cpu", torch.float64)
        if name.endswith((".mean", ".var")):
            stats = max(stats, ((g - r).abs().max()
                                / r.abs().max().clamp_min(1e-30)).item())
            continue
        b = before[name].to(torch.float64)
        upd = max(upd, ((g - b) - (r - b)).norm().item()
                  / max((r - b).norm().item(), 1e-30))
        werr = max(werr, (g - r).abs().max().item())
        wmax = max(wmax, r.abs().max().item())
    return {"stats": stats, "update": upd, "weights": werr / wmax}


def zoo_check_first_step(label: str, loss: float, ref_loss: float,
                         diff: dict) -> None:
    rel = abs(loss - ref_loss) / abs(ref_loss)
    print(f"{label}: loss {loss:.6f} against {ref_loss:.6f} (rel "
          f"{rel:.2e}, limit {ZOO_LOSS_RTOL}); BN statistics max err "
          f"{diff['stats']:.2e} of each tensor's max (limit "
          f"{ZOO_STATS_TOL}); updates max rel err {diff['update']:.2e} "
          f"(Frobenius, limit {ZOO_UPDATE_TOL}); updated weights max err "
          f"{diff['weights']:.2e} of the largest weight (recorded)",
          flush=True)
    require(rel <= ZOO_LOSS_RTOL, f"{label}: loss {loss} vs {ref_loss}")
    require(diff["stats"] <= ZOO_STATS_TOL,
            f"{label}: BN statistics differ by {diff['stats']:.3g}")
    require(diff["update"] <= ZOO_UPDATE_TOL,
            f"{label}: updates differ by {diff['update']:.3g}")


def zoo_fp32_step(torch, resnet, model, x, y, group=None) -> float:
    """One plain SGD step (lr 0.1, momentum 0.9) in training mode."""
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loss = resnet.loss_fn(model, x, y, training=True, group=group)
    loss.backward()
    opt.step()
    return loss.item()


def zoo_bert_batch(np, torch, vocab: int, batch: int, seq: int, dev,
                   seed: int = 0):
    """examples/jax/bert_ulysses_sp.py's batch: repeated tokens, 15%
    masked."""
    rng = np.random.RandomState(seed)
    base = rng.randint(1, vocab, (batch, seq // 2))
    ids = np.repeat(base, 2, axis=1)[:, :seq]
    labels = ids.copy()
    mask = rng.rand(batch, seq) < 0.15
    ids = np.where(mask, 0, ids)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(mask.astype(np.float32)).to(dev))


def phase_zoo(torch, np, hvd, F, L, card: str, device_type: str = "cuda",
              sizes=None) -> dict:
    """Phase 19: the model zoo on one rank.  (a) ResNet-50, ResNet-101,
    VGG-16 and Inception V3 at their recipes, bf16; (b) ResNet-50 in fp32
    on the card against the port on the CPU; (c) BERT-Large with Adam and
    the flash kernels; (d) examples/torch_port/pytorch_mnist.py launched
    with ``-np 1 --gpu``.  ``device_type="cpu"`` with ``ZOO_CPU`` sizes is
    the rehearsal.  Returns the kernels' launches in (c) and the numbers
    the kernels line and PERF.md carry."""
    from horovod_tpu_torch.models import bert, resnet, zoo
    t_phase = time.perf_counter()
    cuda = device_type == "cuda"
    sz = sizes or {}
    dev = hvd.init(device=None if cuda else device_type).device
    out = {"families": {}}
    # (a)
    for family in zoo.CNN_FAMILIES:
        fam = zoo.CNN_FAMILIES[family]
        r50 = family == "resnet50"
        r = zoo_cnn_run(torch, hvd, zoo, family, dev,
                        size=None if cuda else fam.cpu_size,
                        batch=sz.get("batch"), steps=sz.get("steps",
                                                           ZOO_STEPS),
                        more=sz.get("more", ZOO_R50_MORE) if r50 else 0,
                        profile=r50 and cuda, label=f"zoo [{card}]")
        del r["model"]
        out["families"][family] = r
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    # (b)
    size, batch = sz.get("fp32", ZOO_FP32)
    gen = torch.Generator().manual_seed(1)
    ref = resnet.init(50, 1000, torch.float32, gen, "cpu")
    before = {k: v.clone() for k, v in ref.state_dict().items()}
    got = resnet.ResNet(50, 1000, torch.float32, dev)
    got.load_state_dict(before)
    x = torch.randn(batch, size, size, 3, generator=gen)
    y = torch.randint(0, 1000, (batch,), generator=gen)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(got.parameters(), lr=0.1, momentum=0.9),
        named_parameters=got.named_parameters())
    loss = float(zoo.make_cnn_train_step("resnet50", got, opt)(x, y))
    ref_loss = zoo_fp32_step(torch, resnet, ref, x, y)
    zoo_check_first_step(
        f"zoo fp32 [resnet50 {size} px x {batch}, card against CPU, TF32 "
        "off]", loss, ref_loss,
        zoo_state_diff(torch, got.state_dict(), ref.state_dict(), before))
    del ref, got, opt
    # (c)
    cfg = bert.CONFIGS[sz.get("bert", "large")]
    B, S = sz.get("bert_batch", BERT_BATCH), sz.get("bert_seq", BERT_SEQ)
    model = bert.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    flash = lambda q, k, v: hvd.flash_attention(q, k, v, causal=False)
    plain = lambda q, k, v: L.causal_attention(q, k, v, causal=False)
    batches = [zoo_bert_batch(np, torch, cfg.vocab, B, S, dev, seed)
               for seed in range(sum(sz.get("steps", ZOO_STEPS)) + 1)]
    with torch.no_grad():
        with_kernels = bert.loss_fn(model, *batches[0][:2],
                                    mask=batches[0][2], attn_fn=flash).item()
        with_plain = bert.loss_fn(model, *batches[0][:2],
                                  mask=batches[0][2], attn_fn=plain).item()
    print(f"zoo [bert {sz.get('bert', 'large')}] loss with kernels "
          f"{with_kernels:.6f}, with plain attention {with_plain:.6f} (tol "
          f"{ZOO_BERT_LOSS_TOL})", flush=True)
    require(math.isfinite(with_kernels)
            and abs(with_kernels - with_plain) <= ZOO_BERT_LOSS_TOL,
            f"BERT loss with kernels {with_kernels} vs plain {with_plain}")
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=BERT_LR),
        named_parameters=model.named_parameters())
    step = hvd.make_train_step(
        model, lambda m, ids, labels, mask: bert.loss_fn(
            m, ids, labels, mask=mask, attn_fn=flash), opt)
    warm, timed = sz.get("steps", ZOO_STEPS)
    zoo_sync(torch, dev)
    F.reset_launches()
    losses = [step(*b) for b in batches[:warm]]
    zoo_sync(torch, dev)
    t0 = time.perf_counter()
    losses += [step(*b) for b in batches[warm:warm + timed]]
    zoo_sync(torch, dev)
    dt = time.perf_counter() - t0
    if cuda:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            losses.append(step(*batches[-1]))
            zoo_sync(torch, dev)
    launches = dict(F.LAUNCHES)
    losses = [float(v) for v in losses]
    n_steps = len(losses)
    step_ms = dt / timed * 1e3
    n_params = sum(p.numel() for p in model.parameters())
    tok_s = B * S * timed / dt
    print(f"zoo [bert {sz.get('bert', 'large')} {B} x {S}, {card}] step "
          f"{step_ms:.2f} ms, {tok_s:.0f} tokens/s per card, MFU(6N) "
          f"{6 * n_params * tok_s / PEAK_BF16_FLOPS:.4f}; losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; launches {json.dumps(launches)}", flush=True)
    require(all(math.isfinite(v) for v in losses), "BERT: non-finite loss")
    require(max(losses) - min(losses) > 0.0, "BERT: loss constant")
    if cuda:
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            require(launches[name] == cfg.n_layers * n_steps,
                    f"{name} launched {launches[name]} times in {n_steps} "
                    f"BERT steps, expected {cfg.n_layers} a step")
        report_profile(prof, "zoo [bert large]", step_ms)
    out.update(bert_step_ms=step_ms, bert_tok_s=tok_s, launches=launches)
    del model, opt, step, batches
    gc.collect()
    hvd.shutdown()
    if cuda:
        torch.cuda.empty_cache()
    # (d)
    out["mnist"] = zoo_mnist(cuda)
    print(f"zoo: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def zoo_mnist(cuda: bool, epochs: int = 3) -> float:
    """examples/torch_port/pytorch_mnist.py as a user launches it (``-np 1
    --gpu``; ``--cpu`` without a card); returns its seconds."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = ([sys.executable, "-m", "horovod_tpu_torch.runner.launch",
                "-np", "1"] + (["--gpu"] if cuda else [])
               + ["--coordinator-port", str(free_port()),
                  "--controller-port", str(free_port()), sys.executable,
                  os.path.join(root, "examples", "torch_port",
                               "pytorch_mnist.py"), "--epochs", str(epochs),
                  "--ckpt", os.path.join(tmp, "mnist.pt")]
               + ([] if cuda else ["--cpu"]))
        res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                             text=True, timeout=ZOO_MNIST_DEADLINE)
    dt = time.perf_counter() - t0
    tail = [l for l in res.stdout.splitlines() if "epoch" in l or
            "done" in l]
    print(f"zoo [mnist example] exit {res.returncode} in {dt:.1f} s: "
          + "; ".join(tail[-2:]), flush=True)
    require(res.returncode == 0 and "done" in res.stdout,
            f"the MNIST example exited {res.returncode}: "
            f"{res.stderr[-2000:]}")
    return dt


def zoo_checksums(torch, model):
    """Two int64 sums of the bits of every parameter and buffer (plain and
    position weighted), 16-bit dtypes as int16."""
    rows = []
    for t in model.state_dict().values():
        it = torch.int16 if t.element_size() == 2 else torch.int32
        bits = t.detach().reshape(-1).contiguous().view(it).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        rows.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return torch.stack(rows)


def zoo_bitwise(torch, dist, model, label: str, rank: int,
                what: str = "weights and BN statistics") -> None:
    sums = zoo_checksums(torch, model)
    every = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(every, sums)
    require(all(torch.equal(every[0], s) for s in every),
            f"{label}: {what} differ across ranks")
    if rank == 0:
        print(f"{label}: {what} bitwise equal on every rank", flush=True)


def rank_zoo(torch, np, hvd, rank: int, n: int, dev, device_type: str,
             ref_img_s=None) -> None:
    """``--parts zoo`` on one of N ranks: (a) ResNet-50 at its recipe with
    sync-BN (images/s per card, scaling efficiency against the one card's
    ``ref_img_s``, NCCL ms of rank 0's profiled step, weights and BN
    statistics bitwise equal across ranks); (b) ResNet-50 in fp32 at 64
    px, 8 a card with sync-BN, against one card's plain step over the
    global batch of 8N on rank 0 (TF32 off, cuDNN deterministic): the
    loss, BN statistics (the global batch's) and updates; (c) BERT-Large
    under Ulysses over the N ranks: the fp32 loss of 2 layers against one
    card's over the whole sequence, then bf16 at full depth with Adam
    (tokens/s per card)."""
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.models import bert, resnet, zoo
    cuda = device_type == "cuda"
    sz = {} if cuda else ZOO_CPU
    # (a)
    r = zoo_cnn_run(torch, hvd, zoo, "resnet50", dev,
                    size=None if cuda else 32, batch=sz.get("batch"),
                    steps=sz.get("steps", ZOO_STEPS),
                    more=sz.get("more", ZOO_R50_MORE), profile=cuda,
                    label=f"ranks [{n}] zoo")
    zoo_bitwise(torch, dist, r.pop("model"), f"ranks [{n}] zoo [resnet50]",
                rank)
    if rank == 0:
        eff = (f"{r['img_s_card'] / ref_img_s:.3f} of one card's "
               f"{ref_img_s:.1f} images/s" if ref_img_s else "no one-card "
               "reference")
        nccl = (f"; NCCL {r['profile']['nccl']:.2f} ms of the profiled step"
                if "profile" in r else "")
        print(f"ranks [{n}] zoo [resnet50] scaling efficiency {eff}{nccl}",
              flush=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # (b)
    size, batch = sz.get("fp32", ZOO_FP32)
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(1)
    cpu_model = resnet.init(50, 1000, torch.float32, gen, "cpu")
    before = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    x = torch.randn(batch * n, size, size, 3, generator=gen)
    y = torch.randint(0, 1000, (batch * n,), generator=gen)
    model = resnet.ResNet(50, 1000, torch.float32, dev)
    model.load_state_dict(before)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    loss = float(zoo.make_cnn_train_step("resnet50", model, opt)(x, y))
    if rank == 0:
        one = resnet.ResNet(50, 1000, torch.float32, dev)
        one.load_state_dict(before)
        ref_loss = zoo_fp32_step(torch, resnet, one, x.to(dev), y.to(dev))
        zoo_check_first_step(
            f"ranks [{n}] zoo fp32 [resnet50 {size} px, {batch} a card "
            f"with sync-BN against one card's {batch * n}]", loss, ref_loss,
            zoo_state_diff(torch, model.state_dict(), one.state_dict(),
                           before))
        del one
    zoo_bitwise(torch, dist, model, f"ranks [{n}] zoo fp32 [resnet50]", rank)
    torch.backends.cudnn.deterministic = False
    del model, opt, cpu_model
    gc.collect()
    # (c)
    name = sz.get("bert", "large")
    S, B = sz.get("bert_seq", BERT_SEQ), sz.get("bert_batch", BERT_BATCH)
    cut = slice(rank * (S // n), (rank + 1) * (S // n))
    cfg = dataclasses.replace(bert.CONFIGS[name], n_layers=2,
                              dtype=torch.float32)
    model = bert.init(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    ids, labels, mask = zoo_bert_batch(np, torch, cfg.vocab, B, S, dev)
    with torch.no_grad():
        share = bert.sp_loss_fn(model, ids[:, cut], labels[:, cut],
                                mask[:, cut])
        total = hvd.spmd.allreduce(share.clone(), op=hvd.Sum).item()
        if rank == 0:
            one = bert.loss_fn(model, ids, labels, mask=mask).item()
            print(f"ranks [{n}] zoo [bert {name} 2 layers fp32, Ulysses over "
                  f"{S} positions]: loss {total:.6f} against one card's "
                  f"{one:.6f}", flush=True)
            require(abs(total - one) <= ZOO_SEQ_TOL["atol"]
                    + ZOO_SEQ_TOL["rtol"] * abs(one),
                    f"Ulysses loss {total} vs one card's {one}")
    del model
    cfg = bert.CONFIGS[name]
    model = bert.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=BERT_LR),
        named_parameters=model.named_parameters(), op=hvd.Sum)
    warm, timed = sz.get("steps", ZOO_STEPS)
    batches = [zoo_bert_batch(np, torch, cfg.vocab, B, S, dev, seed)
               for seed in range(warm + timed)]

    def step(ids, labels, mask):
        opt.zero_grad(set_to_none=True)
        share = bert.sp_loss_fn(model, ids[:, cut], labels[:, cut],
                                mask[:, cut])
        share.backward()
        opt.step()
        return hvd.spmd.allreduce(share.detach().float().clone(), op=hvd.Sum)

    losses = [step(*b) for b in batches[:warm]]
    zoo_sync(torch, dev)
    t0 = time.perf_counter()
    losses += [step(*b) for b in batches[warm:]]
    zoo_sync(torch, dev)
    dt = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    require(all(math.isfinite(v) for v in losses), "BERT: non-finite loss")
    zoo_bitwise(torch, dist, model, f"ranks [{n}] zoo [bert {name}]", rank,
                "parameters")
    if rank == 0:
        print(f"ranks [{n}] zoo [bert {name} {B} x {S}, Ulysses, "
              f"{str(cfg.dtype)[6:]}]: "
              f"step {dt / timed * 1e3:.2f} ms, "
              f"{B * (S // n) * timed / dt:.0f} tokens/s per card; losses "
              + " ".join(f"{v:.4f}" for v in losses), flush=True)


SCENARIO_SPEC = "scenarios/storm-under-load.yaml"  # phase 20 (a): replayed
SCENARIO_ALERT = "scenario-engine-down"  # (a): the rule the kill must fire
TUNE_STEPS = 3           # phase 20 (b): phase 5's first steps a trial
TUNE_LRS = (3e-4, 1e-4)  # (b): the grid; 3e-4 is phase 5's rate
TUNE_BAYES_TRIALS = 3    # (b): the loguniform run's trials
TUNE_MINI_STEPS = 2      # (b): steps of a ``mini`` trial
TUNE_MINI_SHAPE = (2, 128)  # (b): a ``mini`` trial's rows and positions
TUNE_CPU = dict(cfg="tiny", mini="tiny", batch=2, seq=64,
                mini_shape=(2, 32))  # the rehearsal's sizes
# phase 13's --scenario: its storm lies far past the launched 3 steps
# (ticks of 10 ms: the kill at step 90, the stall at 80), so it only
# travels: the spec, the merged chaos plan and the rule are checked
LAUNCH_SCENARIO = {
    "name": "chip-smoke-launch", "seed": 23, "tick_ms": 10,
    "phases": [{"name": "steady", "kind": "serve", "duration_s": 1.0,
                "arrivals": {"process": "poisson", "rate": 15},
                "shapes": {"prompt_mean": 8, "prompt_max": 24,
                           "output_mean": 4}}],
    "storm": [{"kill": {"at_s": 0.9, "rank": 0}},
              {"stall": {"at_s": 0.8, "duration_s": 0.05}}],
    "alert_rules": [{"name": "chip-smoke-scenario-rule",
                     "family": "hvd_scenario_queue_depth",
                     "kind": "threshold", "op": ">=", "value": 1e18,
                     "severity": "info"}]}


class RecordedEngine:
    """Phase 20's engine as the replay harness sees it: the serving
    engine, with every token it emits kept by request (``log``), so a
    redriven request's regenerated prefix can be held to what the killed
    engine delivered."""

    def __init__(self, engine, log: dict):
        self.engine, self.log = engine, log

    def submit(self, tokens, max_new_tokens, req_id=None, eos_id=None):
        return self.engine.submit(tokens, max_new_tokens, req_id=req_id,
                                  eos_id=eos_id)

    def has_work(self) -> bool:
        return self.engine.has_work()

    def step(self) -> dict:
        rep = self.engine.step()
        for rid, toks in rep["emitted"].items():
            self.log.setdefault(rid, []).extend(toks)
        return rep

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self) -> None:
        self.engine.close()


def scenario_replay(torch, serve, scenario, spec, model, dev, label: str
                    ) -> dict:
    """One replay of ``spec`` on ``ServeEngine`` over ``model`` (kept on
    the device across the storm's rebuilds), the spec's ``engine_config``
    mapped onto ``ServeConfig`` as ``make_engine_factory`` maps it.
    Returns the report, its rows' bytes, each incarnation's emitted
    tokens and the memory after each build, the wall seconds."""
    ec = spec.engine_config
    scfg = serve.ServeConfig(
        max_slots=ec.get("max_slots", 4),
        block_size=ec.get("block_size", 4),
        cache_blocks=ec.get("cache_blocks", 64),
        max_seq_len=ec.get("max_seq_len", 96),
        max_batch_tokens=ec.get("max_batch_tokens", 32),
        prefill_chunk=ec.get("prefill_chunk", 16))
    cuda = dev.type == "cuda"
    builds = []

    def factory():
        log: dict = {}
        engine = serve.ServeEngine(model, scfg, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        builds.append({"log": log, "pool": engine.kv_pool()["pool_bytes"],
                       "mem": torch.cuda.memory_allocated(dev)
                       if cuda else 0})
        return RecordedEngine(engine, log)

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    report = scenario.ScenarioHarness(spec, engine_factory=factory).run()
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rows = scenario.rows_jsonl(scenario.canonical_rows(report))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    print(f"{label}: {report['ticks']} ticks in {wall:.2f} s "
          f"({wall / report['ticks'] * 1e3:.2f} ms a tick), "
          f"{len(builds)} engines built, peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    return {"report": report, "rows": rows, "builds": builds,
            "wall": wall, "peak": peak}


def scenario_checks(scenario, spec, r: dict, virtual: dict, label: str
                    ) -> dict:
    """Phase 20 (a)'s checks of one replay: the CPU's digest, the expected
    alert, every request finished, and each redriven request's tokens
    neither lost nor repeated: the new engine's first ``k`` tokens (``k``
    delivered before the kill, which the harness suppresses) against the
    ``k`` the killed engine delivered.  Returns the redrive's counts."""
    rep = r["report"]
    req = rep["requests"]
    require(rep["digest"] == virtual["digest"],
            f"{label}: event digest {rep['digest']} is not the CPU's "
            f"{virtual['digest']}")
    require(rep["alerts"]["ok"] and SCENARIO_ALERT in rep["alerts"]["fired"],
            f"{label}: alerts {rep['alerts']}")
    require(req["completed"] == req["arrived"] - req["shed"]
            and req["backlog"] == 0 and rep["restarts"] == 1,
            f"{label}: requests {req}, restarts {rep['restarts']}")
    first, second = r["builds"][0]["log"], r["builds"][1]["log"]
    redriven = sorted(set(first) & set(second))
    same = [rid for rid in redriven
            if second[rid][:len(first[rid])] == first[rid]]
    want = {e["req"]: e["max_new"] for e in scenario.generate_events(
        spec.seed, spec.phases, spec.vocab) if e["kind"] == "arrive"}
    require(req["delivered_tokens"] == sum(want.values()),
            f"{label}: {req['delivered_tokens']} tokens delivered, the "
            f"requests asked for {sum(want.values())}")
    for rid in redriven:
        require(len(second[rid]) == want[rid],
                f"{label}: redriven {rid} regenerated {len(second[rid])} "
                f"of its {want[rid]} tokens")
    return {"redriven": len(redriven), "prefix_equal": len(same),
            "prefix_tokens": sum(len(first[rid]) for rid in redriven)}


def tune_mini_trial(config: dict) -> None:
    """Phase 20 (b)'s ``distributed_trainable`` trial, one rank over NCCL
    (or gloo in the rehearsal): ``mini`` (``config["cfg"]``) for
    ``TUNE_MINI_STEPS`` AdamW steps at ``config["lr"]``; reports its last
    loss through ``tune.report`` from the worker process."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import tune
    from horovod_tpu_torch.models import llama
    cuda = config["device"] == "cuda"
    dev = hvd.init(device=None if cuda else "cpu").device
    losses = tune_steps(torch, np, hvd, llama, dev, config["cfg"],
                        config["lr"], config["batch"], config["seq"],
                        TUNE_MINI_STEPS)
    tune.report(loss=losses[-1], device=float(dev.type == "cuda"),
                backend=float(torch.distributed.get_backend() == "nccl"))
    hvd.shutdown()


def tune_steps(torch, np, hvd, llama, dev, cfg_name: str, lr: float,
               batch: int, seq: int, steps: int, times=None) -> list:
    """Phase 5's step (its seeded weights, AdamW through
    ``DistributedOptimizer``, the flash kernels, ``ce_chunks=8``) at
    learning rate ``lr`` over phase 5's first ``steps`` batches; the
    model and optimizer are dropped before it returns.  With a ``times``
    list, each step's ms (host clock, the device synchronized) is
    appended to it."""
    cfg = llama.CONFIGS[cfg_name]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(model, lambda m, ids: llama.loss_fn(
        m, ids, attn_fn=hvd.flash_attention, ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (batch * hvd.size(), seq + 1),
        dtype=np.int32)).to(dev) for _ in range(steps)]
    losses = []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(step(b)))
        if times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
    del step, opt, model, batches
    gc.collect()
    return losses


def phase_scenario(torch, np, hvd, llama, serve, F, card: str, ref_losses,
                   ref_step_ms: float, device_type: str = "cuda",
                   sizes=None) -> dict:
    """Phase 20: the scenario plane and the tuner on the card.  (a) the
    committed ``storm-under-load`` spec replayed twice by
    ``ScenarioHarness`` on ``ServeEngine`` over ``1b`` in bf16 (phase 6's
    weights, built once and kept on the card; each storm rebuild is an
    engine); (b) ``tune.run`` over phase 5's step (a ``grid_search`` of
    ``TUNE_LRS``, 3 steps a trial), a ``loguniform`` run of 3 trials on
    ``mini`` through the native GP, and one ``distributed_trainable``
    trial on ``mini`` over NCCL; (c) ``probe_backend``.
    ``device_type="cpu"`` with ``TUNE_CPU`` sizes is the rehearsal.
    Returns the kernels' launches in the replays and in the tuner's
    trials, and the numbers PERF.md carries."""
    import horovod_tpu_torch.scenario as scenario
    from horovod_tpu_torch import tune
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    cuda = device_type == "cuda"
    sz = dict(dict(cfg="1b", mini="mini", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   mini_shape=TUNE_MINI_SHAPE), **(sizes or {}))
    dev = hvd.init(device=None if cuda else device_type).device
    out = {}

    # (a) the storm on the real engine, twice
    spec = scenario.load_scenario(os.path.join(here, SCENARIO_SPEC))
    virtual = scenario.ScenarioHarness(spec).run()
    print(f"scenario [{spec.name}] on the CPU's virtual engine: digest "
          f"{virtual['digest']}, {virtual['events']} events, rows:\n"
          + scenario.rows_jsonl(scenario.canonical_rows(virtual)).strip(),
          flush=True)
    cfg = llama.CONFIGS[sz["cfg"]]
    require(spec.vocab <= cfg.vocab, f"spec vocab {spec.vocab}")
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    F.reset_launches()
    runs = [scenario_replay(torch, serve, scenario, spec, model, dev,
                            f"scenario [{spec.name}] [{sz['cfg']} "
                            f"{str(cfg.dtype).split('.')[-1]}] run {i}")
            for i in (1, 2)]
    launches = dict(F.LAUNCHES)
    out["launches_scenario"] = launches
    require(not any(launches.values()),
            f"the replay launched an attention kernel: {launches}")
    rep = runs[0]["report"]
    tick_s = spec.tick_s
    slo = rep["slo"]
    print(card, flush=True)
    print(f"scenario [{spec.name}] on ServeEngine: digest {rep['digest']} "
          f"(the CPU's: {rep['digest'] == virtual['digest']}); requests "
          f"{json.dumps(rep['requests'])}; restarts {rep['restarts']}; "
          f"TTFT p50 {slo['ttft_p50_s'] / tick_s:.1f} ticks, p99 "
          f"{slo['ttft_p99_s'] / tick_s:.1f}; TPOT p50 "
          f"{slo['tpot_p50_s'] / tick_s:.2f} ticks, p99 "
          f"{slo['tpot_p99_s'] / tick_s:.2f}; storms "
          + json.dumps([{k: s[k] for k in ("kind", "window", "at_s",
                                           "down_s", "recovery_s")}
                        for s in rep["storms"]])
          + f"; alerts fired {rep['alerts']['fired']}", flush=True)
    print(f"scenario [{spec.name}] rows:\n" + runs[0]["rows"].strip(),
          flush=True)
    same_rows = runs[0]["rows"] == runs[1]["rows"]
    print(f"scenario [{spec.name}]: rows of the two runs byte-identical: "
          f"{same_rows}; reports equal: "
          f"{runs[0]['report'] == runs[1]['report']}", flush=True)
    require(same_rows, "the two replays' rows differ:\n" + runs[0]["rows"]
            + "\n" + runs[1]["rows"])
    for i, r in enumerate(runs, 1):
        red = scenario_checks(scenario, spec, r, virtual,
                              f"scenario run {i}")
        mems = [b["mem"] for b in r["builds"]]
        pool = r["builds"][0]["pool"]
        print(f"scenario run {i}: {red['redriven']} requests redriven "
              f"across the kill, {red['prefix_tokens']} tokens delivered "
              f"before it; {red['prefix_equal']} regenerated their "
              f"delivered prefix token for token; memory after each build "
              f"{mems} bytes (pool {pool} bytes)", flush=True)
        require(abs(mems[-1] - mems[0]) <= pool,
                f"scenario run {i}: memory after the last build {mems[-1]} "
                f"against the first's {mems[0]}, pool {pool}")
    out.update(ticks=rep["ticks"], wall=[r["wall"] for r in runs],
               ms_tick=[r["wall"] / rep["ticks"] * 1e3 for r in runs],
               peak=max(r["peak"] for r in runs),
               recovery=[s["recovery_s"] for s in rep["storms"]])
    del model, runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (b) the tuner: a grid over phase 5's step, in process
    trials_losses, trial_ms, trial_launches, mem = {}, {}, {}, []

    def trainable(config):
        if cuda:
            torch.cuda.synchronize(dev)
            mem.append(torch.cuda.memory_allocated(dev))
        F.reset_launches()
        t0 = time.perf_counter()
        step_ms = []
        losses = tune_steps(torch, np, hvd, llama, dev, sz["cfg"],
                            config["lr"], sz["batch"], sz["seq"], TUNE_STEPS,
                            step_ms)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            mem.append(torch.cuda.memory_allocated(dev))
        trial_ms[config["lr"]] = {"wall_s": time.perf_counter() - t0,
                                  "step_ms": step_ms}
        trials_losses[config["lr"]] = losses
        trial_launches[config["lr"]] = dict(F.LAUNCHES)
        tune.report(loss=losses[-1])

    res = tune.run(trainable, config={"lr": tune.grid_search(
        list(TUNE_LRS))}, metric="loss", mode="min")
    for t in res.trials:
        require(t.error is None, f"tune trial {t.config}: {t.error}")
        tm = trial_ms[t.config["lr"]]
        print(f"tune [{sz['cfg']}] lr {t.config['lr']:g}: losses "
              + " ".join(f"{x:.5f}" for x in trials_losses[t.config["lr"]])
              + "; steps " + ", ".join(f"{x:.1f}" for x in tm["step_ms"])
              + f" ms (phase 5: {ref_step_ms:.1f} ms a step); the trial "
              f"{tm['wall_s']:.2f} s with its model and optimizer",
              flush=True)
    ref = [float(x) for x in ref_losses[:TUNE_STEPS]]
    bitwise = trials_losses[TUNE_LRS[0]] == ref
    print(f"tune [{sz['cfg']}]: lr {TUNE_LRS[0]:g} losses bitwise phase "
          f"5's: {bitwise}; best {res.best_config} at {res.best_metric:.5f};"
          f" memory before and after each trial {mem} bytes", flush=True)
    require(bitwise, f"tune lr {TUNE_LRS[0]}: {trials_losses[TUNE_LRS[0]]}"
            f" against phase 5's {ref}")
    lowest = min(TUNE_LRS, key=lambda lr: trials_losses[lr][-1])
    require(res.best_config == {"lr": lowest}
            and res.best_metric == trials_losses[lowest][-1],
            f"tune best {res.best_config}, the lowest loss is lr {lowest}")
    per_step = cfg.n_layers if cuda else 0  # the CPU runs the plain versions
    for lr, got in trial_launches.items():
        for name in REPLACES:
            require(got.get(name, 0) == per_step * TUNE_STEPS,
                    f"tune lr {lr}: {name} launched {got.get(name)} times, "
                    f"expected {per_step} a step")
    require(mem[0::2] == mem[1::2],
            f"the memory does not return between trials: {mem}")
    out["launches_tune"] = {name: sum(t.get(name, 0) for t in
                                      trial_launches.values())
                            for name in REPLACES}
    out["trial_ms"] = trial_ms

    # a loguniform run through the native GP, on mini
    proposals = []

    def mini(config):
        proposals.append(config["lr"])
        return tune_steps(torch, np, hvd, llama, dev, sz["mini"],
                          config["lr"], *sz["mini_shape"],
                          TUNE_MINI_STEPS)[-1]

    bayes = tune.run(mini, config={"lr": tune.loguniform(1e-4, 1e-2)},
                     metric="loss", mode="min",
                     num_trials=TUNE_BAYES_TRIALS, seed=0)
    print(f"tune [{sz['mini']} loguniform, native GP]: lr proposed "
          + ", ".join(f"{x:.3g}" for x in proposals) + " -> losses "
          + ", ".join(f"{t.metrics.get('loss', float('nan')):.5f}"
                      for t in bayes.trials)
          + f"; best {bayes.best_config}", flush=True)
    require(len(bayes.trials) == TUNE_BAYES_TRIALS
            and all(t.error is None for t in bayes.trials)
            and len(set(proposals)) == TUNE_BAYES_TRIALS,
            "the loguniform run: "
            f"{[(t.config, t.error) for t in bayes.trials]}")
    hvd.shutdown()

    # one distributed trial, its worker started by the launcher
    import chip_smoke as this  # importable by name in the workers
    t0 = time.perf_counter()
    trial = tune.distributed_trainable(this.tune_mini_trial, num_proc=1,
                                       coordinator_port=free_port())
    dist_res = tune.run(trial, config={
        "lr": tune.grid_search([1e-3]), "cfg": sz["mini"],
        "device": device_type, "batch": sz["mini_shape"][0],
        "seq": sz["mini_shape"][1]}, metric="loss", mode="min")
    t = dist_res.trials[0]
    print(f"tune [{sz['mini']} distributed_trainable(num_proc=1)]: "
          f"{json.dumps(t.metrics)}, error {t.error}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(t.error is None and math.isfinite(t.metrics.get("loss", math.nan))
            and t.metrics.get("device") == float(cuda)
            and t.metrics.get("backend") == float(cuda),
            f"the distributed trial: {t}")

    # (c) the probe, and the probe with the cards hidden, side by side
    from horovod_tpu_torch.utils.probe import probe_backend
    t0 = time.perf_counter()
    probes = {}
    hider = threading.Thread(target=lambda: probes.update(
        hidden=probe_backend(env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))))
    hider.start()
    why = hvd.probe_backend()
    hider.join()
    hidden = probes["hidden"]
    print(f"probe_backend(): {why!r}; with CUDA_VISIBLE_DEVICES='': "
          f"{hidden!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
    require(why == "" if cuda else why.startswith("CUDA expected"),
            f"probe_backend() on {device_type}: {why!r}")
    require(hidden.startswith("CUDA expected but torch sees no device"),
            f"probe_backend() with the cards hidden: {hidden!r}")
    out["s"] = time.perf_counter() - t_phase
    print(f"scenario and tune [{card}]: phase 20 took {out['s']:.1f} s",
          flush=True)
    return out


# phase 21 and --parts cluster: placement through the cluster layer
CLUSTER_STEPS = 3        # (c)-(e): phase 5's first steps
CLUSTER_KILL_AFTER = 2   # (c) and --parts cluster: a task dies after step 2
CLUSTER_CPU = dict(cfg_name="tiny", batch=2, seq=32)  # the CPU rehearsal


def cluster_task(spec: dict) -> dict:
    """Phase 21's and ``--parts cluster``'s task function, imported by name
    in the tasks: phase 5's step (``spec["cfg"]`` from seed 0, AdamW at
    ``spec["lr"]`` through ``DistributedOptimizer``, the flash kernels,
    ``ce_chunks=8``) for ``spec["steps"]`` of phase 5's batches, ``batch``
    x ``seq`` a rank, on ``cuda:<local rank>`` (or the CPU for
    ``device="cpu"``).  With ``kill_after``, rank ``kill_rank`` writes its
    losses to ``marker`` and dies after that step unless ``marker``
    exists.  Returns the losses, each step's ms, the parameters'
    checksums, the kernels' launches and the start-up's clock readings."""
    t_main = time.time()
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = spec["device"] == "cuda"
    if not cuda:  # gloo tasks beside each other on a few cores
        torch.set_num_threads(1)
    dev = hvd.init(device=None if cuda else spec["device"]).device
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_init = time.time()
    cfg = llama.CONFIGS[spec["cfg"]]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=spec.get("lr", 3e-4),
                          weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (spec["batch"] * hvd.size(), spec["seq"] + 1),
        dtype=np.int32)).to(dev) for _ in range(spec["steps"])]
    sync()
    t_ready = time.time()
    F.reset_launches()
    losses, step_ms = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(step(b)))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if (i + 1 == spec.get("kill_after")
                and hvd.rank() == spec.get("kill_rank", 0)
                and not os.path.exists(spec["marker"])):
            with open(spec["marker"], "w") as f:
                json.dump(losses, f)
            os._exit(1)  # the task dies, as a lost card or host takes it
    out = {"losses": losses, "step_ms": step_ms,
           "sums": param_checksums(torch, list(model.parameters())).cpu(),
           "launches": dict(F.LAUNCHES), "device": str(dev),
           "rank": hvd.rank(), "size": hvd.size(), "t_main": t_main,
           "t_init": t_init, "t_ready": t_ready,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    hvd.shutdown()
    return out


def cluster_trial(config: dict) -> dict:
    """Phase 21 (e)'s ``tune`` trial: ``cluster_task`` at the trial's lr;
    every step's loss and the kernels' launches as the trial's metrics."""
    r = cluster_task(dict(config["spec"], lr=config["lr"]))
    out = {f"loss{i}": x for i, x in enumerate(r["losses"])}
    out.update({f"launches_{k}": float(v) for k, v in r["launches"].items()})
    out["loss"] = r["losses"][-1]
    out["cuda"] = float(r["device"].startswith("cuda"))
    return out


def cluster_line(label: str, r: dict, t0: float, wall: float,
                 ref_step_ms: float) -> str:
    """A part's times: the wall seconds, the task's start-up on the
    caller's clock, the first step and the median of the rest."""
    rest = sorted(r["step_ms"][1:])
    med = rest[len(rest) // 2] if rest else float("nan")
    return (f"cluster [{label}] {r['device']} rank {r['rank']} of "
            f"{r['size']}: {wall:.2f} s wall; the task's python up at "
            f"{r['t_main'] - t0:.2f} s, hvd.init done at "
            f"{r['t_init'] - t0:.2f} s, model ready at "
            f"{r['t_ready'] - t0:.2f} s; first step {r['step_ms'][0]:.1f} "
            f"ms, median of steps 2-{len(r['step_ms'])} {med:.1f} ms "
            f"(phase 5: {ref_step_ms:.1f} ms); peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")


def check_cluster_launches(label: str, r: dict, layers: int,
                           steps: int) -> None:
    for name in REPLACES:
        require(r["launches"].get(name) == layers * steps,
                f"cluster [{label}]: {name} launched "
                f"{r['launches'].get(name)} times, expected "
                f"{layers * steps}")


def phase_cluster(torch, card: str, ref_losses, ref_sums,
                  ref_step_ms: float, device_type: str = "cuda",
                  cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                  seq: int = TRAIN_SEQ) -> dict:
    """Phase 21: phase 5's step placed by the cluster layer on one card,
    each task a fresh process: (a) ``spark.run(num_proc=1)`` through
    ``LocalTaskExecutor``; (b) ``RayExecutor(num_workers=1)`` on
    ``LocalWorkerPool``: both phase 5's 8 steps, losses and parameter
    checksums bitwise phase 5's; (c) ``spark.run_elastic`` whose first
    attempt's task dies after step ``CLUSTER_KILL_AFTER``: one reset, the
    first attempt's and the second's losses bitwise phase 5's first
    steps; (d) ``ElasticRayExecutor(min_np=1, max_np=1)`` over
    ``FixedHosts(localhost:1)``: one round, the result back through the
    driver's KV; (e) ``hvd.run(np=1)`` and one
    ``tune.distributed_trainable(num_proc=1,
    executor_factory=LocalTaskExecutor)`` trial.  (c)-(e) run
    ``CLUSTER_STEPS`` steps, each bitwise phase 5's; each kernel launched
    16 times a step in every part.  Returns the launches summed over the
    parts, and the phase's seconds."""
    import shutil
    import tempfile
    import chip_smoke as this  # importable by name in the tasks
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spark, tune
    from horovod_tpu_torch.elastic.discovery import FixedHosts
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ray import (ElasticRayExecutor, LocalWorkerPool,
                                       RayExecutor)
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.utils import metrics
    cuda = device_type == "cuda"
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
    layers = llama.CONFIGS[cfg_name].n_layers
    spec = dict(device=device_type, cfg=cfg_name, batch=batch, seq=seq,
                steps=len(ref_losses))
    short = dict(spec, steps=CLUSTER_STEPS)
    total = {name: 0 for name in REPLACES}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cluster_")

    def part(label, run, steps, full=False):
        t0 = time.time()
        results = run()
        wall = time.time() - t0
        require(len(results) == 1, f"cluster [{label}]: {len(results)} "
                                   "results for one task")
        r = results[0]
        ref = ref_losses[:steps]
        print(cluster_line(label, r, t0, wall, ref_step_ms), flush=True)
        print(f"cluster [{label}]: losses "
              + " ".join(f"{x:.5f}" for x in r["losses"])
              + f"; bitwise phase 5's: {r['losses'] == ref}"
              + (f"; parameter checksums bitwise phase 5's: "
                 f"{torch.equal(r['sums'], ref_sums)}" if full else ""),
              flush=True)
        require(r["device"].startswith(device_type),
                f"cluster [{label}]: the task ran on {r['device']}")
        require(r["losses"] == ref, f"cluster [{label}]: losses "
                                    f"{r['losses']} vs phase 5's {ref}")
        if full:
            require(torch.equal(r["sums"], ref_sums),
                    f"cluster [{label}]: parameters differ from phase 5's")
        if cuda:
            check_cluster_launches(label, r, layers, steps)
        for name in REPLACES:
            total[name] += r["launches"].get(name, 0)
        return r

    try:
        with keep_bytecode(cuda):
            # (a) spark.run on one local task
            part("spark.run num_proc=1", lambda: spark.run(
                this.cluster_task, args=(spec,), num_proc=1,
                executor=spark.LocalTaskExecutor(1),
                coordinator_port=free_port()), len(ref_losses), full=True)
            # (b) RayExecutor on one local worker
            ex = RayExecutor(num_workers=1, pool=LocalWorkerPool(),
                             coordinator_port=free_port())
            try:  # the pool's start inside the part's wall time
                part("RayExecutor num_workers=1", lambda: (
                    ex.start(), ex.run(this.cluster_task, args=(spec,)))[1],
                    len(ref_losses), full=True)
            finally:
                ex.shutdown()
            # (c) run_elastic: the first attempt's task dies after step 2
            marker = os.path.join(out_dir, "killed")
            sizes = []

            def factory(n):
                sizes.append(n)
                return spark.LocalTaskExecutor(n)
            part("spark.run_elastic, second attempt",
                 lambda: spark.run_elastic(
                     this.cluster_task, args=(dict(
                         short, kill_after=CLUSTER_KILL_AFTER, kill_rank=0,
                         marker=marker),), num_proc=1, min_np=1, reset_limit=1,
                     executor_factory=factory, coordinator_port=free_port()),
                 CLUSTER_STEPS)
            with open(marker) as f:
                first = json.load(f)
            print(f"cluster [spark.run_elastic]: attempts at np {sizes}; the "
                  "first attempt's losses before its task died "
                  + " ".join(f"{x:.5f}" for x in first)
                  + f", bitwise phase 5's: "
                  f"{first == ref_losses[:CLUSTER_KILL_AFTER]}", flush=True)
            require(sizes == [1, 1], f"run_elastic: attempts at np {sizes}, "
                                     "expected one reset")
            require(first == ref_losses[:CLUSTER_KILL_AFTER],
                    f"run_elastic: the first attempt's losses {first}")
            # (d) ElasticRayExecutor over FixedHosts(localhost:1)
            resets = metrics.ELASTIC_RESETS.value()
            ex = ElasticRayExecutor(
                min_np=1, max_np=1, discovery=FixedHosts([HostInfo(
                    "localhost", 1)]), elastic_timeout=120,
                coordinator_port=free_port(), controller_port=free_port())
            ex.start()
            part("ElasticRayExecutor min_np=max_np=1",
                 lambda: ex.run(this.cluster_task, args=(short,)),
                 CLUSTER_STEPS)
            ex.shutdown()
            rounds = 1 + metrics.ELASTIC_RESETS.value() - resets
            require(rounds == 1, f"ElasticRayExecutor: {rounds} rounds")
            # (e) hvd.run and a tune trial, both through the placement
            part("hvd.run np=1", lambda: hvd.run(
                this.cluster_task, args=(short,), np=1,
                coordinator_port=free_port()), CLUSTER_STEPS)
            t0 = time.time()
            trial = tune.distributed_trainable(
                this.cluster_trial, num_proc=1,
                executor_factory=spark.LocalTaskExecutor,
                coordinator_port=free_port())
            res = tune.run(trial, config={"lr": 3e-4, "spec": short},
                           metric="loss", mode="min")
            t = res.trials[0]
            got = [t.metrics.get(f"loss{i}") for i in range(CLUSTER_STEPS)]
            print(f"cluster [tune.distributed_trainable num_proc=1]: "
                  f"{time.time() - t0:.2f} s wall; losses {got}; error "
                  f"{t.error}; bitwise phase 5's: "
                  f"{got == ref_losses[:CLUSTER_STEPS]}", flush=True)
            require(t.error is None and got == ref_losses[:CLUSTER_STEPS]
                    and t.metrics.get("cuda") == float(cuda),
                    f"the tune trial: {t}")
            for name in REPLACES:
                n = int(t.metrics.get(f"launches_{name}", 0))
                if cuda:
                    require(n == layers * CLUSTER_STEPS,
                            f"the tune trial: {name} launched {n} times")
                total[name] += n
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    s = time.perf_counter() - t_phase
    print(f"cluster [{card}]: phase 21 took {s:.1f} s; launches "
          + json.dumps(total), flush=True)
    return {"launches": total, "s": s}


def rank_cluster(torch, n: int, card: str, device_type: str = "cuda",
                 cfg_name: str = "1b", batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> None:
    """``--parts cluster``: phase 5's step data-parallel over N cards
    placed by the cluster layer.  The reference is the dp part's direct
    step (``rank_train``) on ranks the launcher starts; then
    ``spark.run(num_proc=N)`` and ``RayExecutor(num_workers=N)`` place
    ``cluster_task`` for phase 5's 8 steps: every rank's losses bitwise
    the reference's, the parameters bitwise equal across the ranks and
    between the two placements; then ``spark.run_elastic`` with rank N-1's
    task killed after step 2: one reset, the job placed again at N-1 and
    finished, its parameters bitwise equal across its ranks."""
    import shutil
    import tempfile
    import chip_smoke as this  # importable by name in the tasks
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ray import LocalWorkerPool, RayExecutor
    from horovod_tpu_torch.runner import launch
    cuda = device_type == "cuda"
    layers = llama.CONFIGS[cfg_name].n_layers
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    steps = WARMUP_STEPS + TIMED_STEPS + 1
    spec = dict(device=device_type, cfg=cfg_name, batch=batch, seq=seq,
                steps=steps)
    try:
        with keep_bytecode(device_type == "cuda"):
            t0 = time.time()
            rc = launch.run_commandline(ranks_argv(
                n, ("cluster",), cfg_name, device_type, batch, seq,
                out_dir=out_dir))
            require(rc == 0, f"--parts cluster: the reference launch "
                             f"returned {rc}")
            with open(os.path.join(out_dir, "reference.json")) as f:
                ref = json.load(f)
            print(f"ranks [{n}] cluster reference (the dp part's direct step, "
                  f"launched): losses " + " ".join(f"{x:.5f}" for x in ref)
                  + f"; {time.time() - t0:.2f} s wall", flush=True)
            placed = {}
            t0 = time.time()
            placed["spark.run"] = spark.run(
                this.cluster_task, args=(spec,), num_proc=n,
                executor=spark.LocalTaskExecutor(n),
                coordinator_port=free_port())
            walls = {"spark.run": time.time() - t0}
            ex = RayExecutor(num_workers=n, pool=LocalWorkerPool(),
                             coordinator_port=free_port())
            t0 = time.time()
            try:
                ex.start()
                placed["RayExecutor"] = ex.run(this.cluster_task, args=(spec,))
            finally:
                ex.shutdown()
            walls["RayExecutor"] = time.time() - t0
            for label, rs in placed.items():
                require([r["rank"] for r in rs] == list(range(n))
                        and all(r["size"] == n for r in rs),
                        f"--parts cluster [{label}]: ranks "
                        f"{[(r['rank'], r['size']) for r in rs]}")
                devices = [r["device"] for r in rs]
                if cuda:
                    require(devices == [f"cuda:{i}" for i in range(n)],
                            f"--parts cluster [{label}]: devices {devices}")
                    for r in rs:
                        check_cluster_launches(f"{label} rank {r['rank']}", r,
                                               layers, steps)
                same = all(torch.equal(r["sums"], rs[0]["sums"]) for r in rs)
                rest = sorted(rs[0]["step_ms"][1:])
                print(f"ranks [{n}] cluster [{label}]: {walls[label]:.2f} s "
                      f"wall on {devices}; first step "
                      f"{rs[0]['step_ms'][0]:.1f} "
                      f"ms, median of steps 2-{steps} "
                      f"{rest[len(rest) // 2]:.1f} ms; losses "
                      + " ".join(f"{x:.5f}" for x in rs[0]["losses"])
                      + f"; bitwise the reference's: "
                      f"{all(r['losses'] == ref for r in rs)}; parameters "
                      f"bitwise equal on all {n} ranks: {same}; launches a "
                      f"rank {json.dumps(rs[0]['launches'])}", flush=True)
                require(all(r["losses"] == ref for r in rs),
                        f"--parts cluster [{label}]: losses "
                        f"{[r['losses'] for r in rs]} vs the reference's "
                        f"{ref}")
                require(same, f"--parts cluster [{label}]: parameters differ "
                              "across the ranks")
            require(all(torch.equal(a["sums"], b["sums"]) for a, b in zip(
                placed["spark.run"], placed["RayExecutor"])),
                "--parts cluster: spark.run and RayExecutor trained apart")
            marker = os.path.join(out_dir, "killed")
            sizes = []

            def factory(k):
                sizes.append(k)
                return spark.LocalTaskExecutor(k)
            t0 = time.time()
            rs = spark.run_elastic(
                this.cluster_task, args=(dict(
                    spec, steps=CLUSTER_STEPS, kill_after=CLUSTER_KILL_AFTER,
                    kill_rank=n - 1, marker=marker),), num_proc=n, min_np=1,
                reset_limit=1, executor_factory=factory,
                coordinator_port=free_port())
            same = all(torch.equal(r["sums"], rs[0]["sums"]) for r in rs)
            print(f"ranks [{n}] cluster [spark.run_elastic]: rank {n - 1}'s "
                  "task "
                  f"killed after step {CLUSTER_KILL_AFTER}; attempts at np "
                  f"{sizes}; {time.time() - t0:.2f} s wall; the second "
                  f"attempt's losses " + " ".join(f"{x:.5f}" for x in
                                                   rs[0]["losses"])
                  + f"; parameters bitwise equal on all {len(rs)} ranks: "
                  f"{same}; launches a rank {json.dumps(rs[0]['launches'])}",
                  flush=True)
            require(os.path.exists(marker) and sizes == [n, n - 1]
                    and len(rs) == n - 1,
                    f"--parts cluster [run_elastic]: attempts at np {sizes}, "
                    f"{len(rs)} results")
            require(same and all(math.isfinite(x) for r in rs
                                 for x in r["losses"]),
                    "--parts cluster [run_elastic]: the second attempt "
                    f"{[r['losses'] for r in rs]}")
            if cuda:
                for r in rs:
                    check_cluster_launches(f"run_elastic rank {r['rank']}", r,
                                           layers, CLUSTER_STEPS)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


ESTIMATOR_MNIST = dict(epochs=4, batch=128, lr=0.05)  # the example's config
ESTIMATOR_RESUME = 2     # (a): the second estimator's epochs past the first's
ESTIMATOR_LINEAR = dict(epochs=3, resume=2)  # (b): spark_estimator.py's
ESTIMATOR_LINEAR_RTOL = 1e-10  # (b): w, b against the float64 numpy replay
ESTIMATOR_LLAMA_BATCHES = 4  # (c): phase 5's first batches, in the Store
ESTIMATOR_LLAMA_EPOCHS = 2   # (c): epochs over them, a step a batch
# (c): epoch 0's mean loss against the mean of phase 5's first 4 losses.
# The same weights, batches and AdamW; the CE runs over whole fp32 logits
# where phase 5 runs ce_chunks=8, so step 1 agrees to rounding and steps 2-4
# carry what that rounding moved through three bf16 AdamW updates
ESTIMATOR_LOSS_TOL = 2e-3
# (c): the initial weights' loss on the Store's first batch, whole fp32
# logits, against phase 5's first loss (ce_chunks=8): rounding only
ESTIMATOR_FIRST_TOL = 1e-4
ESTIMATOR_KILL_EPOCH = 0  # --parts estimator (c): rank N-1 dies after epoch 0
ESTIMATOR_CPU = dict(cfg_name="tiny", batch=2, seq=32)  # the CPU rehearsal


class TimedStore:
    """A Store that appends each checkpoint write's bytes and seconds to a
    JSON-lines log; everything else is the wrapped store's.  Picklable, so
    it rides into the train tasks."""

    def __init__(self, inner, log_path: str):
        self.inner = inner
        self.log_path = log_path

    def __getattr__(self, name):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def save_checkpoint(self, run_id, payload, name="checkpoint.bin"):
        t0 = time.perf_counter()
        out = self.inner.save_checkpoint(run_id, payload, name)
        s = time.perf_counter() - t0
        with open(self.log_path, "a") as f:
            f.write(json.dumps({"bytes": len(payload), "s": s}) + "\n")
        return out


class Stamps:
    """Phase 22's clock in a train task, written to
    ``<report>.rank<r>.json``: the first :meth:`stamp` is the task's model
    ready, each later one a step's end (the card synchronized), beside the
    kernels' launches in this process, the device and its peak memory.
    Picklable: each task gets its own copy, and so its own readings."""

    def __init__(self, report: str):
        self.report = report
        self.readings = None

    def stamp(self, dev, **extra) -> None:
        """A reading; ``extra``'s values are appended to lists of their
        names in the report."""
        import torch
        from horovod_tpu_torch.ops import flash_attention as F
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
        rank = int(os.environ.get("HOROVOD_RANK", "0") or 0)
        path = f"{self.report}.rank{rank}.json"
        if self.readings is None:
            self.readings = {"t_ready": time.time(), "stamps": [],
                             "rank": rank, "device": str(dev)}
        else:
            self.readings["stamps"].append(time.time())
        r = self.readings
        for k, v in extra.items():
            r.setdefault(k, []).append(v)
        r["launches"] = dict(F.LAUNCHES)
        r["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda \
            else 0
        write_json(path, r)

    def __call__(self, batch):
        """Phase 22 (b)'s ``transformation_fn``: the batch unchanged, each
        stamped: the first, which sizes the model, as the task's model
        ready, the others as the previous step's end."""
        from horovod_tpu_torch import runtime
        self.stamp(runtime.get().device)
        return batch


def timed_optimizer(make, report: str, params):
    """Phase 22's ``optimizer_fn``: ``make(params)``, stamped when made
    (the task's model ready) and after each ``step`` (:class:`Stamps`)."""
    opt = make(params)
    dev = opt.param_groups[0]["params"][0].device
    stamps = Stamps(report)
    stamps.stamp(dev)
    inner = opt.step

    def step(*args, **kwargs):
        out = inner(*args, **kwargs)
        stamps.stamp(dev)
        return out
    opt.step = step
    return opt


def estimator_llama(cfg_name: str):
    """Phase 22 (c)'s ``model_fn``: phase 5's model (``cfg_name`` from a
    generator seeded 0, on the runtime's device) whose forward takes the
    float32 token ids of a Store row, casts them back with ``.long()``,
    runs with the flash kernels as ``attn_fn`` and returns fp32 logits as
    ``[rows * seq, vocab]``, so ``loss="cross_entropy"`` applies."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runtime
    from horovod_tpu_torch.models import llama

    class LlamaLogits(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            logits = self.model(x.long(), attn_fn=hvd.flash_attention)
            return logits.float().reshape(-1, logits.shape[-1])
    dev = runtime.resolve_device()
    return LlamaLogits(llama.init(
        llama.CONFIGS[cfg_name], torch.Generator(device=dev).manual_seed(0),
        device=dev))


def estimator_rows(np, vocab: int, batch: int, seq: int):
    """Phase 5's first ``ESTIMATOR_LLAMA_BATCHES`` batches as Store rows,
    in phase 5's order: ``features`` the ``seq`` input ids, ``label`` the
    ``seq`` next ids, both float32 (exact below 2**24)."""
    rng = np.random.RandomState(0)
    ids = np.concatenate([rng.randint(0, vocab, (batch, seq + 1),
                                      dtype=np.int32)
                          for _ in range(ESTIMATOR_LLAMA_BATCHES)])
    return {"features": ids[:, :-1].astype(np.float32),
            "label": ids[:, 1:].astype(np.float32)}


def estimator_report(out_dir: str, label: str) -> dict:
    """Rank 0's clock readings of a phase 22 fit (:class:`Stamps`)."""
    with open(os.path.join(out_dir, f"{label}.rank0.json")) as f:
        return json.load(f)


def estimator_line(label: str, r: dict, t0: float, wall: float,
                   ckpts: list, data_bytes: int) -> str:
    """A fit's times: its wall seconds, the task's model ready on the
    caller's clock, the first step and the median of the others, the epoch
    checkpoints' bytes and write seconds, the parquet dataset's bytes."""
    steps = [b - a for a, b in zip([r["t_ready"]] + r["stamps"],
                                   r["stamps"])]
    rest = sorted(steps[1:])
    med = rest[len(rest) // 2] * 1e3 if rest else float("nan")
    ck = (f"{len(ckpts)} epoch checkpoints of {ckpts[-1]['bytes']} bytes, "
          f"written in " + "/".join(f"{c['s']:.3f}" for c in ckpts) + " s"
          if ckpts else "no checkpoint written")
    return (f"estimator [{label}] {r['device']}: {wall:.2f} s wall; the "
            f"task's model ready at {r['t_ready'] - t0:.2f} s; "
            f"{len(steps)} steps: first {steps[0] * 1e3:.1f} ms, median of "
            f"the rest {med:.1f} ms; {ck}; parquet dataset {data_bytes} "
            f"bytes; peak {r['peak_bytes'] / 2**30:.2f} GiB")


def dataset_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.endswith(".parquet"))


def read_ckpts(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def linear_replay(np, store, epochs: int, batch: int, lr: float):
    """``LinearEstimator``'s SGD replayed in float64 numpy over the train
    rows read back from the Store, in the one-task loader's batches: the
    final ``w`` and ``b`` and each epoch's mean loss."""
    data = store.read_parquet(store.get_train_data_path("run0"))
    x = data["features"].reshape(len(data["features"]), -1).astype(np.float64)
    y = data["label"].reshape(len(x), -1).astype(np.float64)
    w = np.zeros((x.shape[1], y.shape[1]))
    b = np.zeros((y.shape[1],))
    losses = []
    for _ in range(epochs):
        total, nb = 0.0, 0
        for i in range(0, len(x), batch):
            xb, yb = x[i:i + batch], y[i:i + batch]
            diff = xb @ w + b - yb
            w = w - lr * (xb.T @ diff / len(xb))
            b = b - lr * diff.mean(axis=0)
            total += float(np.mean(diff ** 2))
            nb += 1
        losses.append(total / nb)
    return w, b, losses


def phase_estimator(torch, np, card: str, ref_losses,
                    device_type: str = "cuda", cfg_name: str = "1b",
                    batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                    mnist=None) -> dict:
    """Phase 22: the Spark estimator workflow on one card, each fit's task
    a fresh process (``spark.run`` through ``LocalTaskExecutor``): (a)
    ``examples/torch_port/pytorch_spark_mnist.py``'s configuration through
    ``TorchEstimator`` at ``num_proc=1``: the example's holdout check (acc
    > 0.8), a complete history, and a second estimator on the same Store at
    ``epochs + 2`` resuming through ``fit_on_parquet``, its first
    ``epochs`` entries bitwise the first fit's; (b) ``LinearEstimator`` at
    ``examples/torch_port/spark_estimator.py``'s configuration
    (``fit(elastic=True)``, then ``fit_on_parquet`` to ``epochs + 2``),
    float64 on the card: ``w`` and ``b`` within 1e-10 relative of a float64
    numpy replay of the same SGD over the rows read back from the Store;
    (c) ``TorchEstimator`` fitting ``cfg_name`` (``1b``) at full width and
    depth in bf16 over phase 5's first 4 batches written to the Store by
    ``prepare_data``: AdamW, batch 4, 2 epochs of 4 steps, 16 launches of
    each kernel a step, epoch 0's mean loss within ``ESTIMATOR_LOSS_TOL`` of
    the mean of phase 5's first 4 losses, and the driver's
    ``EstimatorModel`` loading the envelope onto the card and transforming
    one row to finite logits.  Returns (c)'s launches and the phase's
    seconds."""
    import functools
    import shutil
    import tempfile
    import chip_smoke as this  # importable by name in the tasks
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples", "torch_port"))
    import pytorch_spark_mnist as MN
    import spark_estimator as SE
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    cuda = device_type == "cuda"
    mnist = dict(ESTIMATOR_MNIST, **(mnist or {}))
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_estimator_")

    def store(name):
        return this.TimedStore(spark.FilesystemStore(
            os.path.join(out_dir, name)), os.path.join(out_dir,
                                                       name + ".ckpt"))

    def timed(label, make):
        return functools.partial(this.timed_optimizer, make,
                                 os.path.join(out_dir, label))

    def fit(label, est, run):
        t0 = time.time()
        model = run(est)
        wall = time.time() - t0
        r = estimator_report(out_dir, label)
        require(r["device"].startswith(device_type),
                f"estimator [{label}]: the task ran on {r['device']}")
        print(estimator_line(label, r, t0, wall, read_ckpts(
            est.store.log_path), dataset_bytes(est.store.get_train_data_path(
                est.run_id))), flush=True)
        return model, r

    try:
        with keep_bytecode(cuda):
            # (a) the MNIST example's configuration, then its resume
            x, y = MN.make_mnist_like()
            sa = store("mnist")

            def mnist_est(epochs, label):
                return spark.TorchEstimator(
                    store=sa, model_fn=MN.model_fn, num_proc=1,
                    feature_cols=["features"], label_cols=["label"],
                    batch_size=mnist["batch"], epochs=epochs,
                    loss="cross_entropy", metrics=["accuracy"],
                    validation=0.2, executor=spark.LocalTaskExecutor(1),
                    optimizer_fn=timed(label, functools.partial(
                        MN.adam_fn, lr=mnist["lr"])),
                    coordinator_port=free_port())
            first, _ = fit("mnist", mnist_est(mnist["epochs"], "mnist"),
                           lambda e: e.fit({"features": x, "label": y}))
            xt, yt = MN.make_mnist_like(n=1024, seed=1)
            pred = first.transform({"features": xt})["predict"]
            acc = float(np.mean(np.argmax(pred, axis=1) == yt.ravel()))
            h = first.history
            print(f"estimator [mnist]: history " + json.dumps(h)
                  + f"; holdout accuracy {acc:.4f}", flush=True)
            require(acc > 0.8, f"estimator [mnist]: holdout accuracy {acc}")
            require(sorted(h) == ["train_loss", "val_accuracy"]
                    and all(len(v) == mnist["epochs"] for v in h.values()),
                    f"estimator [mnist]: history {h}")
            est2 = mnist_est(mnist["epochs"] + ESTIMATOR_RESUME,
                             "mnist-resume")
            require(est2.has_checkpoint(), "estimator [mnist]: no envelope")
            second, _ = fit("mnist-resume", est2, lambda e: e.fit_on_parquet())
            h2 = second.history
            same = all(h2[k][:mnist["epochs"]] == h[k] for k in h)
            print(f"estimator [mnist-resume]: history " + json.dumps(h2)
                  + f"; its first {mnist['epochs']} epochs bitwise the first "
                  f"fit's: {same}", flush=True)
            require(same and all(len(v) == mnist["epochs"] + ESTIMATOR_RESUME
                                 for v in h2.values()),
                    f"estimator [mnist-resume]: history {h2}")

            # (b) spark_estimator.py's workflow, float64 on the card
            sb = store("linear")
            port = free_port()

            def linear_est(epochs, label):
                est = SE.estimator(sb, 1, epochs, port)
                est.executor = spark.LocalTaskExecutor(1)
                est.transformation_fn = this.Stamps(
                    os.path.join(out_dir, label))
                return est
            xl, yl = SE.make_data()
            lin1, _ = fit("linear", linear_est(ESTIMATOR_LINEAR["epochs"],
                                               "linear"),
                          lambda e: e.fit({"features": xl, "label": yl},
                                          elastic=True, min_np=1))
            lin2, _ = fit("linear-resume", linear_est(
                ESTIMATOR_LINEAR["epochs"] + ESTIMATOR_LINEAR["resume"],
                "linear-resume"), lambda e: e.fit_on_parquet())
            epochs = ESTIMATOR_LINEAR["epochs"] + ESTIMATOR_LINEAR["resume"]
            env = pickle.loads(sb.read_checkpoint("run0"))
            state = pickle.loads(env["model"])
            w, b, losses = linear_replay(np, sb, epochs, 64, 0.1)
            err = max(float(np.max(np.abs(state[k] - ref) / np.abs(ref)))
                      for k, ref in (("w", w), ("b", b)))
            lerr = max(abs(a - c) / abs(c) for a, c in zip(
                lin2.history["train_loss"], losses))
            print(f"estimator [linear]: fit(elastic=True) to "
                  f"{len(lin1.history['train_loss'])} epochs and "
                  f"fit_on_parquet to {len(lin2.history['train_loss'])}; "
                  f"w, b dtype "
                  f"{state['w'].dtype}; largest relative gap to the float64 "
                  f"numpy replay: w, b {err:.3e}, epoch losses {lerr:.3e} "
                  f"(limit {ESTIMATOR_LINEAR_RTOL})", flush=True)
            require(state["w"].dtype == np.float64
                    and err <= ESTIMATOR_LINEAR_RTOL
                    and lerr <= ESTIMATOR_LINEAR_RTOL,
                    f"estimator [linear]: gap {err}, losses {lerr}")
            require(len(lin2.history["val_mse"]) == epochs,
                    f"estimator [linear]: history {lin2.history}")

            # (c) cfg_name (1b) at full width and depth from parquet
            cfg = llama.CONFIGS[cfg_name]
            sc = store("llama")
            rows = estimator_rows(np, cfg.vocab, batch, seq)
            t0 = time.time()
            spark.prepare_data(sc, rows, ["features"], ["label"])
            t_prep = time.time() - t0
            est = spark.TorchEstimator(
                store=sc, model_fn=functools.partial(this.estimator_llama,
                                                     cfg_name),
                num_proc=1, feature_cols=["features"], label_cols=["label"],
                batch_size=batch, epochs=ESTIMATOR_LLAMA_EPOCHS,
                loss="cross_entropy", executor=spark.LocalTaskExecutor(1),
                optimizer_fn=timed("llama", functools.partial(
                    torch.optim.AdamW, lr=3e-4, weight_decay=0.01)),
                coordinator_port=free_port())
            F.reset_launches()
            model, r = fit("llama", est, lambda e: e.fit_on_parquet())
            launches = r["launches"]
            steps = ESTIMATOR_LLAMA_BATCHES * ESTIMATOR_LLAMA_EPOCHS
            h = model.history["train_loss"]
            ref = sum(ref_losses[:ESTIMATOR_LLAMA_BATCHES]) / \
                ESTIMATOR_LLAMA_BATCHES
            # what a wrong batch moves: phase 5's initial weights' loss on
            # each of the 4 batches, no grad, whole fp32 logits
            m0 = estimator_llama(cfg_name)
            with torch.no_grad():
                l0 = [float(torch.nn.functional.cross_entropy(
                    m0(torch.from_numpy(rows["features"][i:i + batch])
                       .to(next(m0.parameters()).device)),
                    torch.from_numpy(rows["label"][i:i + batch].ravel()
                                     .astype(np.int64))
                    .to(next(m0.parameters()).device)))
                    for i in range(0, len(rows["label"]), batch)]
            del m0
            wrong = min(abs(a - c) for i, a in enumerate(l0)
                        for c in l0[i + 1:])
            print(f"estimator [llama {cfg_name}]: prepare_data of "
                  f"{len(rows['label'])} rows in {t_prep:.2f} s; epoch mean "
                  f"losses {h}; epoch 0 {h[0]:.6f} against phase 5's first "
                  f"{ESTIMATOR_LLAMA_BATCHES} steps' mean {ref:.6f}: gap "
                  f"{abs(h[0] - ref):.3e} (limit {ESTIMATOR_LOSS_TOL}); the "
                  f"initial weights' losses on the {len(l0)} batches "
                  + " ".join(f"{v:.6f}" for v in l0)
                  + f", closest two {wrong:.3e} apart, the first "
                  f"{abs(l0[0] - ref_losses[0]):.3e} from phase 5's first "
                  f"loss (limit {ESTIMATOR_FIRST_TOL}); launches "
                  + json.dumps(launches), flush=True)
            require(len(h) == ESTIMATOR_LLAMA_EPOCHS
                    and all(math.isfinite(v) for v in h),
                    f"estimator [llama]: history {h}")
            require(abs(h[0] - ref) <= ESTIMATOR_LOSS_TOL,
                    f"estimator [llama]: epoch 0 {h[0]} vs phase 5's {ref}")
            # model_fn's weights and the Store's first rows are phase 5's
            require(abs(l0[0] - ref_losses[0]) <= ESTIMATOR_FIRST_TOL,
                    f"estimator [llama]: the initial loss on the first "
                    f"batch {l0[0]} vs phase 5's first {ref_losses[0]}")
            if cuda:
                for name in REPLACES:
                    require(launches.get(name) == cfg.n_layers * steps,
                            f"estimator [llama]: {name} launched "
                            f"{launches.get(name)} times, expected "
                            f"{cfg.n_layers * steps}")
            t0 = time.time()
            out = model.transform({"features": rows["features"][:1]})
            logits = out["predict"]
            print(f"estimator [llama {cfg_name}]: the driver's "
                  f"EstimatorModel on {device_type}: one row to logits "
                  f"{list(logits.shape)} {logits.dtype} in "
                  f"{time.time() - t0:.2f} s, finite: "
                  f"{bool(np.isfinite(logits).all())}", flush=True)
            require(logits.shape == (seq, cfg.vocab)
                    and bool(np.isfinite(logits).all()),
                    f"estimator [llama]: logits {logits.shape}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    s = time.perf_counter() - t_phase
    print(f"estimator [{card}]: phase 22 took {s:.1f} s; launches "
          + json.dumps(launches), flush=True)
    return {"launches": launches, "s": s}


class CountingExecutor:
    """``--parts estimator`` (c)'s placement: ``LocalTaskExecutor`` whose
    resizes are recorded, so the elastic shrink shows."""

    def __init__(self, n: int, sizes: list):
        from horovod_tpu_torch.spark import LocalTaskExecutor
        self._ex = LocalTaskExecutor(n)
        self.sizes = sizes
        sizes.append(n)

    def num_tasks(self) -> int:
        return self._ex.num_tasks()

    def run_tasks(self, task_fn):
        return self._ex.run_tasks(task_fn)

    def with_num_tasks(self, n: int) -> "CountingExecutor":
        return CountingExecutor(n, self.sizes)


def rank_estimator(torch, n: int, card: str, device_type: str = "cuda",
                   mnist=None) -> None:
    """``--parts estimator``: the estimators across N cards, the tasks
    placed by ``spark.run`` (the parent places them): (a) the MNIST
    example's ``TorchEstimator`` at ``num_proc=N``, the example's holdout
    check; (b) ``LinearEstimator`` at ``num_proc=N`` (spark_estimator.py's
    data): ``w_sum`` bitwise equal on all N ranks; (c) ``fit(elastic=True)``
    with ``HOROVOD_SPARK_FAULT`` killing rank N-1 after epoch 0: placed
    again at N-1 tasks, resumed from the epoch-0 envelope, the history
    complete; (d) the Lightning MNIST example's ``LightningEstimator`` at
    ``num_proc=N``: its checks, the synced stop alike on every rank, every
    rank's final ``state_dict`` bitwise equal (:class:`RankProbe`), the
    logger's rows all rank 0's."""
    import shutil
    import tempfile
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples", "torch_port"))
    import pytorch_spark_mnist as MN
    import spark_estimator as SE
    from horovod_tpu_torch import spark
    mnist = dict(ESTIMATOR_MNIST, **(mnist or {}))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_estimator_")
    try:
        with keep_bytecode(device_type == "cuda"):
            t0 = time.time()
            model, acc = MN.fit(
                spark.FilesystemStore(os.path.join(out_dir, "mnist")),
                num_proc=n, epochs=mnist["epochs"], batch=mnist["batch"],
                lr=mnist["lr"], coordinator_port=free_port(),
                executor=spark.LocalTaskExecutor(n))
            print(f"ranks [{n}] estimator [mnist]: {time.time() - t0:.2f} s "
                  f"wall; history {json.dumps(model.history)}; holdout "
                  f"accuracy {acc:.4f}", flush=True)
            require(acc > 0.8, f"--parts estimator [mnist]: accuracy {acc}")
            require(all(len(v) == mnist["epochs"]
                        for v in model.history.values()),
                    f"--parts estimator [mnist]: {model.history}")

            x, y = SE.make_data()
            df = {"features": x, "label": y}
            s = spark.FilesystemStore(os.path.join(out_dir, "linear"))
            est = SE.estimator(s, n, ESTIMATOR_LINEAR["epochs"], free_port())
            train, val = spark.prepare_data(
                s, df, est.feature_cols, est.label_cols,
                validation=est.validation, seed=est.seed)
            t0 = time.time()
            rs = spark.run(est._make_train_task(), args=(train, val),
                           num_proc=n, executor=spark.LocalTaskExecutor(n),
                           coordinator_port=est.coordinator_port)
            sums = [r["w_sum"] for r in rs]
            devices = [r["device"] for r in rs]
            print(f"ranks [{n}] estimator [linear]: {time.time() - t0:.2f} s "
                  f"wall on {devices}; w_sum {sums}; bitwise equal on all "
                  f"{n} ranks: {len(set(sums)) == 1}", flush=True)
            require(len(rs) == n and len(set(sums)) == 1,
                    f"--parts estimator [linear]: w_sum {sums}")
            if device_type == "cuda":
                require(devices == [f"cuda:{i}" for i in range(n)],
                        f"--parts estimator [linear]: devices {devices}")

            marker = os.path.join(out_dir, "killed")
            sizes = []
            s = spark.FilesystemStore(os.path.join(out_dir, "elastic"))
            est = SE.estimator(s, n, ESTIMATOR_LINEAR["epochs"], free_port())
            est.executor = CountingExecutor(n, sizes)
            os.environ["HOROVOD_SPARK_FAULT"] = \
                f"{n - 1},{ESTIMATOR_KILL_EPOCH},{marker}"
            t0 = time.time()
            try:
                model = est.fit(df, elastic=True, min_np=1, reset_limit=1)
            finally:
                del os.environ["HOROVOD_SPARK_FAULT"]
            env = pickle.loads(s.read_checkpoint("run0"))
            h = model.history
            print(f"ranks [{n}] estimator [elastic]: rank {n - 1} killed "
                  f"after epoch {ESTIMATOR_KILL_EPOCH}; placements at np "
                  f"{sizes}; {time.time() - t0:.2f} s wall; last envelope "
                  f"epoch {env['epoch']}; history {json.dumps(h)}",
                  flush=True)
            require(os.path.exists(marker) and sizes[-2:] == [n, n - 1],
                    f"--parts estimator [elastic]: placements {sizes}")
            require(env["epoch"] == ESTIMATOR_LINEAR["epochs"] - 1
                    and all(len(v) == ESTIMATOR_LINEAR["epochs"]
                            for v in h.values()),
                    f"--parts estimator [elastic]: {env['epoch']}, {h}")

            # (d) the Lightning MNIST example at N tasks
            import chip_smoke as this  # importable by name in the tasks
            import lightning_spark_mnist as LM
            log_path = os.path.join(out_dir, "lightning.jsonl")
            probe = os.path.join(out_dir, "lightning.ranks.json")
            t0 = time.time()
            model, acc, rows = LM.fit(
                spark.FilesystemStore(os.path.join(out_dir, "lightning")),
                log_path, num_proc=n, epochs=LIGHTNING_MNIST["epochs"],
                batch=LIGHTNING_MNIST["batch"], coordinator_port=free_port(),
                executor=spark.LocalTaskExecutor(n),
                logger=this.RankLogger(log_path),
                callbacks=[this.RankProbe(probe)])
            wall = time.time() - t0
            label = f"ranks [{n}] estimator [lightning]"
            lightning_mnist_checks(label, model, acc, rows)
            with open(probe) as f:
                every = json.load(f)
            stops = [(e["should_stop"], e["epoch"]) for e in every]
            same = all(e["sums"] == every[0]["sums"] for e in every)
            writers = sorted({r["rank"] for r in rows})
            print(f"{label}: {wall:.2f} s wall; stop and epoch by rank "
                  f"{stops}; state_dict bitwise equal on all {n} ranks: "
                  f"{same}; the logger written by ranks {writers}",
                  flush=True)
            require(len(every) == n and len(set(stops)) == 1,
                    f"{label}: stops {stops}")
            require(same, f"{label}: state_dicts differ across ranks")
            require(writers == ["0"], f"{label}: logger rows from {writers}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# phase 23 and --parts estimator (d): the Lightning and Keras estimators
LIGHTNING_MNIST = dict(epochs=4, batch=128, clip=5.0)  # the example's config
# (a): the norm a step applies against min(its norm, the clip), relative to
# the clip: clip_grad_norm_ scales by clip / (norm + 1e-6) in float32
LIGHTNING_CLIP_RTOL = 1e-5


def module_device(module):
    return next(iter(module.parameters())).device


def grad_norm(torch, grads) -> float:
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads])))


class LightningStamps(Stamps):
    """Phase 23's clock as a Lightning callback (:class:`Stamps`): the
    task's model ready at ``on_train_start``, each step's end at
    ``on_train_batch_end``.  With ``norms``, each step's gradient norm as
    the backward left it (``pre_clip``, from each parameter's
    post-accumulate hook) and as the step applied it (``grad_norm``)."""

    def __init__(self, report: str, norms: bool = False):
        super().__init__(report)
        self.norms = norms
        self.grads = []

    def on_train_start(self, trainer, module):
        if self.norms:
            for p in module.parameters():
                p.register_post_accumulate_grad_hook(
                    lambda q: self.grads.append(q.grad.detach().clone()))
        self.stamp(module_device(module))

    def on_train_batch_end(self, trainer, module, out, batch, i):
        extra = {}
        if self.norms:
            import torch
            extra = {"pre_clip": grad_norm(torch, self.grads),
                     "grad_norm": grad_norm(torch, [
                         p.grad for p in module.parameters()
                         if p.grad is not None])}
            self.grads.clear()
        self.stamp(module_device(module), **extra)


class RankProbe:
    """``--parts estimator`` (d)'s callback: at the fit's end, every rank's
    stop flag, epoch and ``state_dict`` checksums (:func:`zoo_checksums`),
    allgathered; rank 0 writes them to ``path``."""

    def __init__(self, path: str):
        self.path = path

    def on_train_end(self, trainer, module):
        import torch
        import horovod_tpu_torch as hvd
        mine = {"rank": hvd.rank(), "should_stop": trainer.should_stop,
                "epoch": trainer.current_epoch,
                "sums": zoo_checksums(torch, module).cpu().tolist()}
        every = hvd.allgather_object(mine)
        if hvd.rank() == 0:
            with open(self.path, "w") as f:
                json.dump(every, f)


class RankLogger:
    """A ``JsonlLogger`` whose rows name the rank that wrote them."""

    def __init__(self, path: str):
        self.path = path

    def log_metrics(self, metrics, step=None):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "rank": os.environ.get(
                "HOROVOD_RANK"), **metrics}) + "\n")

    def finalize(self, status):
        with open(self.path, "a") as f:
            f.write(json.dumps({"finalized": status, "rank": os.environ.get(
                "HOROVOD_RANK")}) + "\n")


def lightning_llama(cfg_name: str):
    """Phase 23 (b)'s ``model_fn``: phase 5's model (``cfg_name`` from a
    generator seeded 0, on the runtime's device) as a LightningModule, an
    ``nn.Module`` that speaks the protocol: ``configure_optimizers`` phase
    5's AdamW, ``training_step`` phase 5's loss (``ce_chunks=8``, the flash
    kernels) over the ids the Store's float32 row and the last of its
    next ids give back, ``forward`` fp32 logits as ``[rows * seq, vocab]``
    for ``transform``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import runtime
    from horovod_tpu_torch.models import llama

    class LlamaModule(torch.nn.Module):
        def __init__(self):
            super().__init__()
            dev = runtime.resolve_device()
            self.model = llama.init(
                llama.CONFIGS[cfg_name],
                torch.Generator(device=dev).manual_seed(0), device=dev)

        def forward(self, x):
            logits = self.model(x.long(), attn_fn=hvd.flash_attention)
            return logits.float().reshape(-1, logits.shape[-1])

        def configure_optimizers(self):
            return torch.optim.AdamW(self.parameters(), lr=3e-4,
                                     weight_decay=0.01)

        def training_step(self, batch, batch_idx):
            x, y = batch
            ids = torch.cat([x, y[:, -1:]], dim=1).long()
            return llama.loss_fn(self.model, ids,
                                 attn_fn=hvd.flash_attention, ce_chunks=8)
    return LlamaModule()


def lightning_mnist_checks(label: str, model, acc: float, rows: list) -> None:
    """The Lightning MNIST example's own checks: holdout accuracy above
    0.8, ``val_loss`` and ``val_acc`` in the history, the logger's rows
    with the flushed metrics and, last, the ``finalized`` record."""
    h = model.history
    logged = sorted({k for r in rows for k in r
                     if k not in ("step", "finalized", "rank")})
    print(f"{label}: history " + json.dumps(h) + f"; holdout accuracy "
          f"{acc:.4f}; the logger's {len(rows)} rows, metrics {logged}, "
          f"last {json.dumps(rows[-1])}", flush=True)
    require(acc > 0.8, f"{label}: holdout accuracy {acc}")
    require({"val_loss", "val_acc", "train_loss"} <= set(h),
            f"{label}: history {h}")
    require({"train_ce", "val_acc", "val_loss"} <= set(logged),
            f"{label}: logged {logged}")
    require(rows[-1].get("finalized") == "success",
            f"{label}: the logger's last row {rows[-1]}")


def phase_lightning(torch, np, card: str, ref_losses, ref_step_ms: float,
                    device_type: str = "cuda", cfg_name: str = "1b",
                    batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                    keras: bool = True) -> dict:
    """Phase 23: the Lightning estimator on one card, each fit's task a
    fresh process (``spark.run`` through ``LocalTaskExecutor``): (a)
    ``examples/torch_port/lightning_spark_mnist.py``'s configuration at
    ``num_proc=1``: the example's checks and each step's applied gradient
    norm min(its norm, the clip); (b) ``cfg_name`` (``1b``) at full width
    and depth as a LightningModule (:func:`lightning_llama`) over phase 22
    (c)'s Store rows, batch 4, 2 epochs: 16 launches of each kernel a step,
    the initial loss on the Store's first batch within ``ESTIMATOR_FIRST_TOL``
    of phase 5's first, epoch 0 within ``ESTIMATOR_LOSS_TOL`` of phase 5's
    first 4 steps' mean, the driver's ``transform`` to finite logits; (c)
    with ``keras``, ``examples/torch_port/keras_spark_mnist.py`` in a
    process of its own under ``KERAS_BACKEND=torch`` (its accuracy check),
    or a line saying it was not run where keras cannot be imported.
    Returns (b)'s launches and the phase's seconds."""
    import functools
    import importlib.util
    import shutil
    import tempfile
    import chip_smoke as this  # importable by name in the tasks
    examples = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples", "torch_port")
    sys.path.insert(0, examples)
    import lightning_spark_mnist as LM
    from horovod_tpu_torch import spark
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.ops import flash_attention as F
    cuda = device_type == "cuda"
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_lightning_")

    def fit(label, store, run):
        """``run()``'s result and the task's clock readings; printed: the
        fit's times (:func:`estimator_line`)."""
        t0 = time.time()
        out = run()
        wall = time.time() - t0
        r = estimator_report(out_dir, label)
        require(r["device"].startswith(device_type),
                f"lightning [{label}]: the task ran on {r['device']}")
        print(estimator_line(f"lightning {label}", r, t0, wall,
                             read_ckpts(store.log_path), dataset_bytes(
                                 store.get_train_data_path("run0"))),
              flush=True)
        return out, r

    def store(name):
        return this.TimedStore(spark.FilesystemStore(
            os.path.join(out_dir, name)), os.path.join(out_dir,
                                                       name + ".ckpt"))

    try:
        with keep_bytecode(cuda):
            # (a) the Lightning MNIST example's configuration
            clip = LIGHTNING_MNIST["clip"]
            sa = store("mnist-store")
            (model, acc, rows), r = fit("mnist", sa, lambda: LM.fit(
                sa, os.path.join(out_dir, "mnist.jsonl"), num_proc=1,
                epochs=LIGHTNING_MNIST["epochs"],
                batch=LIGHTNING_MNIST["batch"], coordinator_port=free_port(),
                executor=spark.LocalTaskExecutor(1),
                callbacks=[this.LightningStamps(
                    os.path.join(out_dir, "mnist"), norms=True)]))
            lightning_mnist_checks("lightning [mnist]", model, acc, rows)
            # clip_grad_norm_: the norm the step applies is min(pre, clip)
            pre, post = r["pre_clip"], r["grad_norm"]
            gap = max(abs(b - min(a, clip)) for a, b in zip(pre, post)) / clip
            print(f"lightning [mnist]: gradient norms {min(pre):.4f}-"
                  f"{max(pre):.4f} before the clip at {clip} over "
                  f"{len(pre)} steps, {sum(a > clip for a in pre)} above it; "
                  f"applied min(norm, clip) within {gap:.3e} of the clip "
                  f"(limit {LIGHTNING_CLIP_RTOL})", flush=True)
            require(len(pre) == len(r["stamps"])
                    and gap <= LIGHTNING_CLIP_RTOL,
                    f"lightning [mnist]: the clip: {pre} -> {post}")

            # (b) cfg_name (1b) at full width and depth as a LightningModule
            cfg = llama.CONFIGS[cfg_name]
            sb = store("llama-store")
            rows = estimator_rows(np, cfg.vocab, batch, seq)
            spark.prepare_data(sb, rows, ["features"], ["label"])
            est = spark.LightningEstimator(
                store=sb, model_fn=functools.partial(
                    this.lightning_llama, cfg_name),
                num_proc=1, feature_cols=["features"], label_cols=["label"],
                batch_size=batch, epochs=ESTIMATOR_LLAMA_EPOCHS,
                executor=spark.LocalTaskExecutor(1),
                callbacks=[this.LightningStamps(
                    os.path.join(out_dir, "llama"))],
                coordinator_port=free_port())
            F.reset_launches()
            model, r = fit("llama", sb, est.fit_on_parquet)
            launches = dict(r["launches"])
            steps = ESTIMATOR_LLAMA_BATCHES * ESTIMATOR_LLAMA_EPOCHS
            h = model.history["train_loss"]
            ref = sum(ref_losses[:ESTIMATOR_LLAMA_BATCHES]) / \
                ESTIMATOR_LLAMA_BATCHES
            first = sb.read_parquet(sb.get_train_data_path("run0"))
            m0 = lightning_llama(cfg_name)
            dev = module_device(m0)
            with torch.no_grad():
                l0 = float(m0.training_step(tuple(
                    torch.from_numpy(np.ascontiguousarray(
                        first[c][:batch], np.float32)).to(dev)
                    for c in ("features", "label")), 0))
            del m0
            print(f"lightning [llama {cfg_name}]: phase 5's step "
                  f"{ref_step_ms:.1f} ms; epoch mean losses {h}; "
                  f"epoch 0 {h[0]:.6f} against phase 5's first "
                  f"{ESTIMATOR_LLAMA_BATCHES} steps' mean {ref:.6f}: gap "
                  f"{abs(h[0] - ref):.3e} (limit {ESTIMATOR_LOSS_TOL}); the "
                  f"initial loss on the Store's first batch {l0:.6f}, "
                  f"{abs(l0 - ref_losses[0]):.3e} from phase 5's first "
                  f"(limit {ESTIMATOR_FIRST_TOL}); launches "
                  + json.dumps(launches), flush=True)
            require(len(h) == ESTIMATOR_LLAMA_EPOCHS
                    and all(math.isfinite(v) for v in h),
                    f"lightning [llama]: history {h}")
            require(abs(l0 - ref_losses[0]) <= ESTIMATOR_FIRST_TOL,
                    f"lightning [llama]: the initial loss on the first "
                    f"batch {l0} vs phase 5's first {ref_losses[0]}")
            require(abs(h[0] - ref) <= ESTIMATOR_LOSS_TOL,
                    f"lightning [llama]: epoch 0 {h[0]} vs phase 5's {ref}")
            if cuda:
                for name in REPLACES:
                    require(launches.get(name) == cfg.n_layers * steps,
                            f"lightning [llama]: {name} launched "
                            f"{launches.get(name)} times, expected "
                            f"{cfg.n_layers * steps}")
            t0 = time.time()
            logits = model.transform({"features": rows["features"][:1]})[
                "predict"]
            print(f"lightning [llama {cfg_name}]: transform on "
                  f"{device_type}: one row to logits {list(logits.shape)} "
                  f"{logits.dtype} in {time.time() - t0:.2f} s, finite: "
                  f"{bool(np.isfinite(logits).all())}", flush=True)
            require(logits.shape == (seq, cfg.vocab)
                    and bool(np.isfinite(logits).all()),
                    f"lightning [llama]: logits {logits.shape}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # (c) the Keras estimator, where keras is installed
    if not keras:
        print("lightning [keras]: the Keras estimator was not run: not "
              "asked for", flush=True)
    elif importlib.util.find_spec("keras") is None:
        print("lightning [keras]: the Keras estimator was not run: keras "
              "cannot be imported on this machine", flush=True)
    else:
        env = dict(os.environ, KERAS_BACKEND="torch", JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, os.path.join(examples, "keras_spark_mnist.py"),
             "--np", "1", "--coordinator-port", str(free_port())]
            + ([] if cuda else ["--cpu"]), env=env, capture_output=True,
            text=True, timeout=600)
        acc_line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith("holdout accuracy")]
        print(f"lightning [keras]: keras_spark_mnist.py on keras's torch "
              f"backend: exit {res.returncode} in {time.time() - t0:.2f} s; "
              f"{acc_line[-1] if acc_line else 'no accuracy line'}",
              flush=True)
        require(res.returncode == 0 and "OK" in res.stdout,
                f"lightning [keras]: {res.stdout[-2000:]} "
                f"{res.stderr[-3000:]}")
    s = time.perf_counter() - t_phase
    print(f"lightning [{card}]: phase 23 took {s:.1f} s; launches "
          + json.dumps(launches), flush=True)
    return {"launches": launches, "s": s}


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] in ("--rank-worker", "--launched",
                                      "--measured", "--perfed",
                                      "--watched", "--abort-sync",
                                      "--elastic"):
        # a worker the port's launcher started (--ranks N, phases 13, 15)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        if args[0] == "--launched":
            return launched_worker(args[1])
        if args[0] == "--measured":
            return measured_worker(args[1])
        if args[0] == "--perfed":
            return perfed_worker(args[1])
        if args[0] == "--watched":
            return watched_worker(args[1])
        if args[0] == "--abort-sync":
            return abort_sync_worker(args[1])
        if args[0] == "--elastic":
            return elastic_worker(args[1])
        rank_worker(json.loads(args[1]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ranks, parts = 1, RANK_PARTS
    if args[:1] == ["--ranks"] and len(args) in (2, 4):
        ranks = int(args[1])
        if len(args) == 4 and args[2] == "--parts":
            parts = tuple(args[3].split(","))
        elif len(args) == 4:
            parts = ()
    if (args and ranks == 1) or not parts or not set(parts) <= set(
            RANK_PARTS):
        print("usage: chip_smoke.py [--ranks N [--parts "
              + ",".join(RANK_PARTS) + "]]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import layers as L, llama
    from horovod_tpu_torch.ops import _kernels, _native, flash_attention as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN", flush=True)
    card = smi.splitlines()[0]
    print(card, flush=True)

    # the native controller (g++) builds while nvcc builds the kernels
    t0 = time.perf_counter()
    core = {}

    def build_core():
        try:
            core["lib"] = _native.build()
        except Exception as e:  # surfaced below, after the kernels' build
            core["error"] = e
        core["s"] = time.perf_counter() - t0
    builder = threading.Thread(target=build_core)
    builder.start()
    lib = _kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib})", flush=True)
    builder.join()
    if "error" in core:
        raise core["error"]
    print(f"build: native controller {core['s']:.1f} s ({core['lib']})",
          flush=True)
    d128 = phase_resources(_kernels, lib)
    if ranks > 1:
        phase_ranks(torch, ranks, parts)
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    marks = [("start", time.perf_counter())]  # each phase's end
    rows = phase_kernels(F, torch, card)
    marks.append(("kernels", time.perf_counter()))
    phase_model(torch, hvd, llama, L)
    marks.append(("model", time.perf_counter()))
    launches, losses, step_ms, tok_s, busy, params = phase_train(
        torch, np, hvd, llama, F)
    marks.append(("train", time.perf_counter()))
    serve_ref = phase_serve(torch, np, hvd, llama, serve, F, card)
    marks.append(("serve", time.perf_counter()))
    eager, eager_ms = phase_eager(torch, np, hvd, llama, F, card, losses,
                                  step_ms, tok_s, busy, params)
    marks.append(("eager", time.perf_counter()))
    sums = param_checksums(torch, params)  # phase 21's reference
    del params
    wire = phase_wire(torch, np, hvd, llama, F)
    marks.append(("wire", time.perf_counter()))
    zero, zero_runs = phase_zero(torch, np, hvd, llama, F, card)
    marks.append(("zero", time.perf_counter()))
    layout = phase_layout(torch, np, hvd, llama, F, card, zero_runs)
    marks.append(("layout", time.perf_counter()))
    ring_rows, ring_launches, moe_launches = phase_sequence(
        torch, np, hvd, llama, F, L, card)
    marks.append(("sequence", time.perf_counter()))
    # the launches of phases 13-20 reuse compiled bytecode (keep_bytecode),
    # but phase 17's, whose ranks must exit within 10 s of a failure
    with keep_bytecode():
        launched = phase_launch(torch, card, losses, step_ms)
        marks.append(("launch", time.perf_counter()))
        fleet = phase_fleet(torch, np, serve, card, serve_ref)
        marks.append(("fleet", time.perf_counter()))
        measure = phase_measure(torch, card, losses, step_ms, eager_ms)
        marks.append(("measure", time.perf_counter()))
        perf = phase_perf(torch, np, hvd, llama, F, card, losses, step_ms)
        marks.append(("perf", time.perf_counter()))
    watch = phase_forensics(torch, card, losses, step_ms)
    marks.append(("forensics", time.perf_counter()))
    with keep_bytecode():
        elastic = phase_elastic(torch, card, losses)
        marks.append(("elastic", time.perf_counter()))
        zoo = phase_zoo(torch, np, hvd, F, L, card)
        marks.append(("zoo", time.perf_counter()))
        scen = phase_scenario(torch, np, hvd, llama, serve, F, card,
                              losses, step_ms)
        marks.append(("scenario", time.perf_counter()))
    cluster = phase_cluster(torch, card, losses, sums, step_ms)
    marks.append(("cluster", time.perf_counter()))
    estimator = phase_estimator(torch, np, card, losses)
    marks.append(("estimator", time.perf_counter()))
    lightning = phase_lightning(torch, np, card, losses, step_ms)
    marks.append(("lightning", time.perf_counter()))
    for row in rows.values():
        row["launches"] = launches[row["name"]]
        row["launches_eager"] = eager[row["name"]]
        row["launches_wire"] = wire[row["name"]]
        row["launches_zero"] = zero[row["name"]]
        row["launches_layout"] = layout[row["name"]]
        row["launches_ring_n1"] = ring_launches[row["name"]]
        row["launches_moe_mini"] = moe_launches[row["name"]]
        row["launches_launch"] = launched[row["name"]]
        row["launches_fleet"] = fleet[row["name"]]
        row["launches_measure"] = measure[row["name"]]
        row["launches_perf"] = perf[row["name"]]
        row["launches_watch"] = watch[row["name"]]
        row["launches_elastic"] = elastic[row["name"]]
        row["launches_zoo"] = zoo["launches"][row["name"]]
        row["launches_tune"] = scen["launches_tune"][row["name"]]
        row["launches_scenario"] = scen["launches_scenario"][row["name"]]
        row["launches_cluster"] = cluster["launches"][row["name"]]
        row["launches_estimator"] = estimator["launches"][row["name"]]
        row["launches_lightning"] = lightning["launches"][row["name"]]
        row["ring"] = ring_rows[row["name"]]
        row["d128"]["resources"] = d128[row["name"]]
    print("phases (s): " + ", ".join(
        f"{name} {t - t0:.1f}"
        for (_, t0), (name, t) in zip(marks, marks[1:])), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
