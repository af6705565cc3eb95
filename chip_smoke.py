#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU
(phase 15 also over every card of the machine when it has several).

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--iters N] [--out results.json]

(``--phases 4c,13,19,20,21,22,23`` runs only those phases, with no
result line; ``--phases 22f`` and ``--phases 23f`` run phases 22's and
23's four-card parts on a machine with four cards; ``17cupti`` the
profiler probe below.)

It imports nothing of JAX or of the JAX package ``mxnet_tpu``.  Phases,
in order; any failure ends the run with a non-zero exit and no result
line:

1. the device, ``nvidia-smi``'s name and power limit, its card count
   (``nvidia-smi -L`` beside ``torch.cuda.device_count()``), and the build of
   every CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together), with each kernel's registers
   and spills from ``ptxas`` (the float32 flash forward at D=64 must not
   spill);
2. flash-decode, kernel vs its plain PyTorch version, on the card, at the
   slice's shapes (the decode buckets B in {1, 2, 4, 8} and a ragged B=3,
   H=8, D=64, 32-token blocks, a 256-block pool, 32 table slots), in
   float32, bfloat16 and float32 q over a bfloat16 pool, at mixed
   positions and at every edge of the kernel's split (each case run twice
   and required to repeat bit for bit), and with a row at pos < 0 (the
   mean of v over its table, as the plain version), with the plan
   (splits, thread blocks) and times of the kernel, the plain version,
   ``F.scaled_dot_product_attention`` on the gathered cache (a yardstick
   only) and the bandwidth bound;
3. the int8 weight-only matmul, kernel vs plain, at M in {1, 8, 16, 17,
   33, 240, 960} and the three (K, N) of the model: M <= 16 runs the
   split-K GEMV body, larger M the wgmma body (float32 x as three
   bfloat16 pieces), each within 1e-4; with the same four times
   (``torch.matmul`` against the dequantized float32 weight is the
   yardstick; the wgmma rows' bound counts their bfloat16 tensor work);
   then with fp8 e4m3 weights at K=512, N=8192 and M in {8, 17, 960}
   (the GEMV, then the wgmma body); every row the same bits on a second
   call;
4. the slice end to end at full width: ``GenerationEngine(ctx=gpu(0))``
   for the transformer LM the repo benchmarks (vocab 8192, 8 layers, 8
   heads, dim 512, max_seq_len 1024, seeded random weights) generates 64
   tokens for 8 prompts of 17 to 900 tokens, in float32 and then with
   ``quantize="int8"``.  It checks that both kernels ran on that path
   (launch counts reset just before each run), the int8 run through
   both int8 bodies (prefill: wgmma, decode: GEMV; counted by body),
   that the float32 logits agree with a plain full-sequence forward
   written here, and that the int8 logits keep a cosine >= 0.999 against
   float32 at every step.
4b. the in-process ``ModelServer`` at the same full width: one server
   holds ``lm-f32`` and ``lm-fp8`` (``quantize="fp8_e4m3"``), both at
   the engine's defaults, and ``mlp`` (``models.mlp``, 128 inputs,
   buckets 1, 2, 4, 8).  Four client threads send 16 prompts to each LM
   (phase 4's 8 and 8 more, 64 new tokens, two with an ``eos_id``,
   retrying after a 429) and 200 MLP requests of sizes 1:60, 2:25,
   4:10, 8:5.  Gates: every generated token's logit within 1e-3 of its
   row's maximum in a plain float32 forward over prompt and tokens
   (``lm-fp8``: over its dequantized weights); MLP results equal to a
   serial ``Predictor`` (rtol 1e-5, atol 1e-6); no lowering after
   warmup; flash-decode once a layer on every decode step; the fp8
   model through both fp8 bodies; a second server with a 40-block pool
   answers a second 900-token request with a 429 carrying
   ``blocks_free`` while the first finishes.  Printed: tokens/s, TTFT
   and ITL p50/p99, decode ms a step (``serve`` telemetry), the MLP's
   req/s and p50/p99 latency, ``engine.generate()`` of the same prompts,
   the fp8 logits' cosine against float32 (a report, not a gate).
4c. the serving fleet on the same card: ``launch_fleet`` spawns two
   ``python -m mxnet_tpu_torch.tools.mxfleet replica`` processes on
   free ports serving ``lm-fp8``, the LM through
   ``models.transformer.get_symbol(seq_len=512)`` (its softmax output
   reshaped to (batch, 512, 8192)) from a seeded 0x112 checkpoint with
   ``MXTPU_QUANTIZE=fp8_e4m3`` at buckets 1, 2, 4.  Four client threads
   send 48 requests of 1 or 2 sequences through a ``FleetClient`` and
   the ``mxfleet serve`` front door.  Gates: every response bit for bit
   an in-process ``Predictor``'s on the same checkpoint and quantization
   at a bucket the request fits (that Predictor and each replica must
   have run the fp8 ``wgmma`` body and the float32 flash forward, by
   their own launch counts); SIGKILL of replica 1 with requests in
   flight: each completes (bitwise) or fails with ``ReplicaDead``, none
   hangs, the ledger shows generation 1 with the death verdict, and the
   respawned replica is healthy within 60 s and answers bitwise; a
   rolling swap to a second checkpoint with zero lowerings a replica and
   the skew map at ``v2``, then bitwise outputs of the new weights; a
   1-replica fleet with a queue bound of 2 answers a burst of 8 with at
   least one 429 carrying ``Retry-After``; ``drain()`` turns the front
   door to 503; no replica process is left.  Printed: the router's
   req/s and p50/p99 latency against the same requests through one
   in-process ``ModelServer`` (a yardstick), failovers, respawn
   seconds, swap pause ms, GPU memory by process.
5. the flash-attention forward of training, kernel vs plain (``o`` and
   ``lse``), at B=8, H=8, S=1024, D=64, causal and not, float32 (the FMA
   body, also required to repeat bit for bit) and bfloat16 (the wgmma
   body), each also at a ragged S=1000, at D=32 and D=128 and at S=77,
   and (checked, not timed) at Sq != Sk (200 and 77 queries against 77
   and 200 keys), with times of the kernel, the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only) and the bound
   (operations at 67 TFLOP/s float32 or 989 TFLOP/s bfloat16, or bytes at
   3.35 TB/s, whichever is larger);
6. the fused optimizer sweep, kernel vs plain, for every body (SGD with
   and without momentum, NAG, Adam, AdamW, AdaGrad, RMSProp, AdaDelta,
   Test): bit for bit and bitwise on repeat at 16 M elements and at 4099
   elements one element into their arrays (the scalar path), with and
   without ``clip_gradient``, at t = 1 and t = 3; each body timed at 16 M
   elements, and SGD with momentum on each bucket of the full-width LM,
   with times of the kernel, the plain version, ``torch.optim``'s fused
   step where PyTorch has one (a yardstick only) and the bytes bound;
7. training at full width: ``ShardedTrainer(ctx=gpu(0))`` on the
   transformer LM (vocab 8192, 8 layers, 8 heads, dim 512, seq_len
   1024, batch 8, SGD lr 0.1 momentum 0.9, rescale_grad 1/8192, seeded
   numpy weights) with ``MXTPU_FUSED_OPT=kernel``: 3 float32 steps (TF32
   off), each step and the three together no further from a plain
   training step written here, run in float64, than twice as far as the
   same plain step in float32 is; bit for bit equal to the same steps
   with the leafwise update; then bfloat16 compute.  It checks the flash
   forward ran once a layer a step (the FMA body in float32, the wgmma
   body in bfloat16, counted by dtype) and the sweep once a bucket a
   step, and prints ms a step and tokens/s;
8. the imperative surface and runtime-compiled kernels: NDArrays made
   under ``with mx.gpu(0):`` with no ``ctx`` at (4096, 4096) float32,
   arithmetic, views that write through, in-place operators, registered
   functions, ``random.uniform(out=)``, and five CUDA C kernel bodies
   (``kernels/rtc_kernels.py``) pushed through ``mx.rtc.Rtc`` (NVRTC),
   each against numpy, with the Rtc launch count reset just before;
   then each kernel against its plain PyTorch version on the card (saxpy
   also at 2^24 + 3 elements and on views offset by one element), the
   error paths (an NVRTC compile error, a 2048-thread block, a CPU
   tensor), and times (kernel, plain, one-call library, the bytes
   bound, NVRTC's compile time per key, the host time of a cached push).
9. ResNet-50 through ``ShardedTrainer(ctx=gpu(0))`` at ``bench.py``'s
   configuration (224 x 224, 1000 classes, batch 64, SGD lr 0.1,
   momentum 0.9, wd 1e-4, rescale_grad 1/64, seeded numpy weights and
   images) with ``MXTPU_FUSED_OPT=kernel`` and cuDNN deterministic: the
   sweep once a bucket a step and no other hand kernel; 3 float32 steps
   bit for bit (parameters and aux) equal to the same steps leafwise;
   one float32 step at batch 8 no further from a plain step written here
   in float64 than twice the plain float32 step; bfloat16 compute
   (softmax outputs within 5e-2 of float32's, finite parameters after 3
   steps); one step each with NAG and RMSProp through their bodies; ms
   a step and images/s beside the float32 (bfloat16) operations bound;
10. ``Module.fit`` of ResNet-50 on the current context (``gpu(0)``) as
   ``example/image-classification/common.py`` drives it: Xavier (in,
   2.34), a ``KVStore("local")`` object (the update on the store), a
   Speedometer, ``eval_metric="acc"``, 8 training and 2 validation
   batches of 64 made by ``synthetic_iters``' formula a batch at a time:
   finite training accuracy, no hand kernel launched (neither update
   route runs the sweep, as in the JAX package), a checkpoint that
   round-trips bit for bit, and the fused step (``kvstore=None``) within
   1e-5 of the store's route after 2 steps; images/s.
11. the image feed: 64 x 12 raw-pixel records of 3 x 224 x 224 uint8
   (seeded, labels i % 1000, 115.6 MB) written under ``build/`` with the
   port's ``recordio``; ``io.ImageRecordIter`` alone (4 decode threads
   of the native engine, ``lib/libmxtpu.so`` built from ``src/`` by
   ``make``, which must succeed; prefetch 3), uint8 and float32 with
   mean and scale, images/s after a warm epoch, its first batch bitwise
   a numpy read of the records; 256 JPEG records of 256 x 256 decoded
   with ``rand_crop`` and ``rand_mirror`` to 224 at 1, 4 and
   ``os.cpu_count()`` threads (the native libjpeg route where ``make``
   linked libjpeg, else the Python route, said so), 1 and 4 threads
   bitwise equal; ResNet-50 (phase 9's configuration) through
   ``ShardedTrainer.prefetch_feed`` over the uint8 records, float32 and
   bfloat16, 12 steps (one epoch), steps 3-12 timed with one
   synchronize, beside phase 9's device-resident rate, with the
   consumer's ``data_wait`` share and the sweep once a bucket a step;
   under deterministic cuDNN 3 steps with prefetch on equal to off bit
   for bit, the first batch on the card the host's uint8 batch and its
   widening bitwise the float32 iterator's output, every tensor on
   ``cuda:0``; then ``example/image-classification-torch/
   train_imagenet.py`` (``Module.fit`` with ``MXTPU_PREFETCH=1``,
   ``--data-dtype uint8``, batch 64, one epoch) on the records:
   images/s over batches 2-12 beside phase 10's, on ``cuda:0``, no hand
   kernel launched, and 2 batches with prefetch on equal to off bit for
   bit under deterministic cuDNN.

12. the rest of image classification: Inception-BN (``models.
   inception_bn``, phase 9's configuration: 224 x 224, 1000 classes,
   batch 64, SGD lr 0.1, momentum 0.9, wd 1e-4) through ``ShardedTrainer``
   with the sweep, float32 and bfloat16, timed under cuDNN's defaults
   beside phase 9's ResNet-50, the sweep once a bucket a step and no
   other hand kernel; under deterministic cuDNN two steps at batch 2 no
   further from the port on the CPU in float64 than twice the CPU's
   float32 steps; 3 steps through the sweep bit for bit equal to 3
   leafwise (parameters, aux, states); mirroring on Inception-BN at
   batch 64: 3 steps of ``ShardedTrainer(remat=True)`` and of a
   ``Module`` bound with ``MXNET_BACKWARD_DO_MIRROR=1`` bit for bit
   equal to the unmirrored runs, the mirrored Module's peak memory below
   the unmirrored one's (both peaks, the segment count and the times of
   10 more steps printed), and the peak of one forward and backward
   unmirrored, mirrored and with a per-segment ``torch.utils.checkpoint``
   (the JAX package's design; gradients bit for bit equal); AlexNet,
   VGG-16 and GoogLeNet at 224 x 224 and batch 64, Inception-v3 at
   299 x 299 and batch 32, each one inference forward at batch 2 on the
   card no further from a plain float64 forward written here (a walk of
   the graph in plain PyTorch, which the port on the CPU in float64 must
   match to 1e-10) than twice the same plain forward in float32, one
   step through the sweep bit for bit equal to one leafwise, and 5
   timed float32 steps (the sweep's launches and bucket sizes);
   ``train_imagenet.py --network inception-bn`` (``Module.fit`` with
   ``MXTPU_PREFETCH=1``) on phase 11's records, on ``cuda:0`` with no
   hand kernel; and the Module family on LeNet at batch 16:
   ``FeedForward.fit`` on the card no further from the port's same
   training on the CPU in float64 than twice the larger of the CPU's
   float32 fit and a plain float32 LeNet on the card, a ``Monitor``
   through ``fit(monitor=...)`` and on a monitored forward (every op
   output, all finite), a ``SequentialModule`` of the trunk and the head
   within 1e-5 of one ``Module`` of the whole.

13. the bucketing LSTM language model at ``example/rnn/
   lstm_bucketing.py``'s defaults (2 layers, hidden and embedding 200,
   batch 32, buckets 10, 20, 30 and 40, SGD lr 0.01 with wd 1e-5,
   Xavier(in, 2.34), ``Perplexity``, ``kvstore="local"``) at PTB's
   vocabulary of 10,001 on the example's seeded synthetic corpus:
   ``BucketingModule.fit`` on ``gpu(0)`` for one epoch of about 40
   batches (every bucket's executor on the default bucket's parameter
   and gradient tensors with one optimizer; one program a bucket, bound
   on its first visit only; no hand kernel; the parameters after every
   batch and the last batch's outputs no further from a plain float64
   run of the same batches written here than twice the plain float32
   run; perplexity falls), with ms a step by bucket, tokens/s, a traced
   step of the 40-bucket (the device's busy share, kernels a step) and
   peak memory; ``ShardedTrainer`` on the 40-bucket graph (the initial
   states as data), 3 steps through the sweep bit for bit the leafwise
   update, and the sweep timed at its bucket; ``LSTMInferenceModel``
   stepping 32 tokens within 1e-5 of the unrolled 32-step graph; the
   fused RNN op against its plain loop on the card (lstm and gru on
   cuDNN, rnn_tanh and rnn_relu on the loop; 2 layers, both
   directions, at the sort example's shapes and, but for rnn_relu, at
   hidden 200, seq 40, batch 32): the op's float32 outputs and
   gradients within 1e-5 of the loop in float64, cuDNN's own distance
   reported in every mode, and
   ``example/bi-lstm-sort-torch/sort_io.py`` to an accuracy over 0.85;
   ``gru_bucketing`` at the same widths over every bucket with the
   witness gate.

14. CustomOp and Faster R-CNN: ``example/rcnn-torch`` (the graph of
   ``example/rcnn/symbol.py``: the VGG-style backbone at its own 32-128
   channels, the RPN's two losses, the Proposal Custom op on the host,
   ROIPooling and the heads) at the published scale, 600 x 600 (feature
   map 37 x 37, 12,321 anchors), 21 classes, 300 rois (1200 before NMS),
   on ``gpu(0)``: 2 warm and 10 timed steps of the example's step (the
   forward, the backward with the executor's head gradients, the
   example's SGD through host arrays, lr ``RCNN_LR``) with (a) each
   step's rois bit for bit the example's numpy ProposalOp on that step's
   own inputs copied to the host; (b) the first and last steps held to
   the same step in float64 on the card with the rois fixed to the
   float32 step's: the four outputs within 1e-4 and every parameter's
   gradient within 1e-2 of each tensor's max-abs; (c) ROIPooling on the
   card against the CPU at the step's shapes (with a bin of tied zeros):
   forward bit for bit, gradient within 1e-6 of its max-abs, each tied
   zero a quarter of its bin's gradient; (d) ``example/numpy-ops-torch/
   custom_softmax.py`` (``Module.fit`` with a CustomOp loss) on the card
   within 1e-6 of the CPU's accuracy; (e) each of the 51 op names the
   slice registers once on the card, float32 within 1e-5 (forward) and
   1e-4 (vjp) of float64 on the card (the samplers and rrelu by bounds
   and moments); no hand kernel launched.  Printed: ms a step, the
   Custom op's host ms and copies, ROIPooling's forward and backward ms
   and peak memory, the phase's peak, the busy share of traced steps.

15. data parallelism.  On the first card: (a) ``Module`` of phase 9's
   ResNet-50 on ``[gpu(0), gpu(0)]`` with kvstore ``device`` (the
   slicing mode: two executors of 32, the store summing their
   gradients), under deterministic cuDNN the summed gradient bit for
   bit the sum of two one-context executors' gradients on the two
   halves and the parameters after 3 steps bit for bit that hand-summed
   run's, then 2 warm and 5 timed steps; (b) ``ShardedTrainer`` on
   ``make_mesh([gpu(0), gpu(0)], dp=2)`` at batch 64 with and without
   ZeRO-1 (the sweep on every replica; ZeRO-1 bit for bit plain dp over
   3 steps), timed, peak memory by device, the sweep's launches and
   route by device, and the float64 witness at batch 8 (one dp step
   within twice the plain float32 step's distance from the plain
   float64 step on the whole batch: outputs, parameters and BatchNorm
   moving statistics); (c) the transformer LM's dp=2 step at phase 7's
   width, 4 a replica (the flash forward on every replica, every layer
   and step), with phase 7's witness against the plain steps at batch
   8; (d) ``tools/launch.py -n <cards> python example/image-
   classification-torch/train_imagenet.py --kvstore dist_sync
   --synthetic``: one worker a card, every worker's parameters after
   the epoch bit for bit rank 0's; with one card, the worker's
   parameters and aux states bit for bit the same run's under
   ``--kvstore local`` in a plain process (both ``--deterministic``).
   With several cards, (a)-(c) also run
   over the distinct cards (the sharded ``Module``, ``make_mesh(dp=n)``,
   NCCL between them) with the witness gates; with one, the phase says
   that the NCCL path between cards was not exercised.

16. the flat C ABI: ``make capi-torch`` builds ``lib/
   libmxtpu_torch_capi.so`` (``mxnet_tpu_torch/csrc/c_api.cc`` over the
   unchanged ``include/mxtpu/c_api.h``) and the C programs against it
   under ``lib/torch/``, each run as a C host process with a ``jax``
   that raises on import first on its path: (a) the unchanged
   ``example/cpp/image-classification`` predictor on ResNet-50 at batch
   64, 224 x 224, 1000 classes (seeded weights saved by the port) prints
   the class and probability that the port's ``Predictor`` gives in this
   process; (b) ``example/cpp-torch/train_lm.c`` takes 3 steps of the
   LM at phase 7's width (SGD lr 0.1, momentum 0.9) through
   ``MXExecutorSimpleBindTrain``, ``MXExecutorForward``/``Backward`` and
   ``MXOptimizerUpdate``, its saved parameters bit for bit a Python twin's
   (the same bind, backward and leafwise ``Optimizer.update`` here), the
   flash forward launched 8 times a step by the twin and by the C
   process (which writes its counts at ``MXNotifyShutdown``); (c)
   ``example/cpp-torch/rtc_saxpy.c``: a CUDA C body through
   ``MXRtcCreate``/``MXRtcPush`` at 2^24 float32 within phase 8's ulp
   bound of the plain version, one launch; (d) the unchanged
   ``tests/capi`` consumers ``capi_smoke`` and ``capi_threads`` on
   ``gpu(0)`` and ``capi_parity`` with ``MXNET_CAPI_CONTEXT=cpu``, 3 runs
   each.  Every C process must exit 0 with its OK line and no abort.

17. resilience: (a) ``ShardedTrainer(sentinel=True)`` on phase 7's LM
   (SGD momentum, ``MXTPU_FUSED_OPT=kernel``), 6 steps, step 3's batch
   holding a token outside the vocabulary (the LM's NaN ids would be id
   0, a finite step, in both packages): step 3's parameters and momentum
   bit for bit unchanged, ``skipped`` 1 and the scale halved, steps 1-2
   bit for bit a sentinel-off trainer's, every sweep gated (the skipped
   step's wrote nothing), the flash forward 8 times a step, and as many
   synchronising calls a step as with the sentinel off
   (``torch.cuda.set_sync_debug_mode("warn")``); ms a step on and off,
   alternating; (b) in a child process, ``step_timeout_s=2`` with
   ``step=2:kind=hang``: a ``ResilienceError`` and a flight dump naming
   (``train_step``, 2) as pending; (c) Adam on the LM saved at step 3
   (``save_checkpoint_versioned``), ``auto_resume`` in a new trainer and
   3 more steps, bit for bit 6 uninterrupted steps, with the save and
   restore times; (d) the sweep body generated from a user's
   ``update_fn`` (sign, sqrt, clamp; NVRTC) at each of the LM's buckets
   and at 16 M elements, bit for bit its plain version (a skip flag of
   0 writes nothing), timed beside the bytes bound and NVRTC's compile
   time, then 2 LM steps through the trainer with it bit for bit the
   leafwise update; (e) ``Module.fit`` with ``MXTPU_SENTINEL=1`` over a
   NaN batch: that step skipped, the parameters after it bit for bit
   those before.

18. observability: phase 7's LM with telemetry on (MFU, the report,
   ``mxtrace``, ``mxtop``), the profiler's trace, serving under the
   sanitizers and the SLO engine.

19. the graph analyzer (``mxnet_tpu_torch/analysis``): (a) phase 7's LM
   and phase 9's ResNet-50, float32 and bfloat16, bound on ``gpu(0)``
   with ``validate="error"``: no error finding, the warnings by rule,
   the bind time with ``validate="off"`` against ``"warn"`` (medians of
   5, alternating) and no lowering after warm-up; (b) every kernel
   launch the port registers (MXL-K), at the main paths' shapes, clean
   against the card's properties, its register budget and static shared
   memory agreeing with ptxas's report of its entry function and its
   dynamic shared memory and CTAs an SM with the built library's, and an
   Rtc block of 2,048 threads flagged MXL-K004 by the lint, refused by
   the CUDA driver (CUDA_ERROR_INVALID_VALUE) and, with
   ``MXTPU_RTC_LINT=error``, before the launch; (c) the static roofline
   (MXL-R, the card's peaks) of the four steps against their measured
   medians (phases 7 and 9's; timed here when the phase runs alone):
   every static bound no longer than its step, the roofline's FLOPs
   beside ``parallel/flops.py``'s, and the ``static_roofline`` counter
   read back beside ``trainer_cost`` by the telemetry report; (d)
   ``hbm_capacity_bytes`` equal to the card's ``total_memory``, the
   analytic peaks beside ``max_memory_allocated``; (e) ``python -m
   mxnet_tpu_torch.tools.mxlint --all-models --roofline --device-kind
   <the card>`` exits 0 with no error finding.

20. MoE and pipeline parallelism: (a) the MoE LM (phase 7's widths, 8
   experts, top-1, capacity 1.25; token ids of a Zipf law, s=1.1, so
   some experts overflow) through ``ShardedTrainer`` on one card: 3
   float32 steps whose parameters stay within rtol 2e-4, atol 2e-5 of a
   plain MoE LM written here, with tokens dropped on every step; then
   bfloat16 steps timed (ms a step, the device's busy share of a traced
   step, the drops a step), the sweep and the flash forward counted; (b)
   ``ep=2`` on ``[gpu(0), gpu(0)]`` (and ``ep=4`` over four cards where
   the machine has them): each member holds ``8/ep`` experts, the
   parameters after 3 steps within the same bounds of (a)'s; (c) ``dp=2``
   with the capacity binding within them too, with every step's drops
   equal to ``dp=1``'s, and both within them of the plain MoE LM in
   float64; and the op's queues over two replicas against the
   whole batch on gate products exact in float32: the same drops, every
   token's output within the bounds; (d) ``expert_parallel_moe`` over
   two replicas within 1e-5 of the dense op on each shard; (e)
   ``ShardedPredictor`` on the MoE LM from a checkpoint, ``dp=2 x
   ep=2``, within 1e-5 of ``predictor.Predictor``; (f)
   ``GPipeTrainer.from_block_symbol`` on the LM's transformer block, 8
   layers, ``pp=2`` on one card (``pp=4`` over four cards), M=4: the
   first step's ``gpipe`` loss within 1e-5 of ``sequential_loss`` and
   ``1f1b``'s of ``sequential_loss_microbatched``, the parameters after
   3 steps within rtol 2e-4, atol 2e-5 of a plain full-batch float64 run
   written here, the step's ms beside ``schedule_occupancy``'s bubble; (g) ``mxlint --schedule`` on
   ``transformer_moe`` at ``dp=1,ep=4`` and the LM at ``pp=2``, priced at
   the card's ``PEAKS`` row.  It prints its own kernels line (rows 3 and
   4, their launches on these paths).

21. the source lints (``mxnet_tpu_torch/analysis``' source half): (a)
   ``python -m mxnet_tpu_torch.tools.mxlint --distributed --concurrency
   --retrace mxnet_tpu_torch --fail-on=warning`` exits 0, with each
   family's seconds and counts in this process beside it; (b) a CustomOp
   host op forward and backward on ``gpu(0)``, ``threading.get_ident()``
   in the user's forward, its backward and the caller (whether autograd
   ran the backward off the caller's thread, the MXL-Q005 shape); (c) the
   retrace sentry armed after 2 warm-up steps, then 10 steps of phase 7's
   LM through ``ShardedTrainer`` with the sweep body generated from a
   user's ``update_fn`` (phase 17's) and 20 pushes of ``Rtc``'s saxpy
   (phase 8's (b)): no program build, no NVRTC compile, no registry
   lowering after the boundary (counted at ``executor.build_program``,
   ``nvrtc.compile_cubin`` and in the modules' caches); (d) the repaired
   kvstore path under ``MXTPU_LOCKCHECK=1``: ``push_async`` of the LM's
   gradients summed over a one-rank NCCL group on the store's worker
   thread, ``set_updater`` while the first bucket is in flight, no
   lock-order error and the parameters bit for bit the synchronous
   ``push``'s under the same updaters, with the ms a round.  It launches
   no new kernel.

22. tensor parallelism and FSDP (``parallel/tensor_parallel.py``):
   (a) phase 7's LM (vocab 8192, 8 layers, 8 heads, dim 512, sequence
   1024, batch 8, SGD with momentum) through ``ShardedTrainer`` at
   ``tp=2`` and at ``dp=2 x tp=2``, every member on ``gpu(0)``, float32
   and bfloat16, 3 steps each: each member's flash forward over its 4
   heads once a layer a step and its own sweeps counted, no whole weight
   gathered, the float32 runs held to phase 7's float64 witness (and
   set beside the one-device trainer's run), then 3 timed steps and the
   peak memory; (b) the same LM under ``fsdp=True`` at ``dp=2`` on one
   card: parameters and momentum bit for bit ZeRO-1's and plain dp's,
   each member's persistent bytes beside plain dp's; (c)
   ``GenerationEngine(mesh=make_mesh([gpu(0)] * 2, tp=2))`` on phase 4's
   8 prompts, float32 and fp8: tokens equal to the one-device engine's,
   logits within 1e-3 of a plain forward (fp8: of the one-device fp8
   engine's), each member's flash-decode launches over 4 heads and
   weight-only launches by route and rows; (d) ``ShardedPredictor`` at
   ``dp=2 x tp=2`` from a saved checkpoint of the LM within 1e-5 of
   ``predictor.Predictor``; (e) each kernel at its member shape against
   its plain version and timed: flash-decode with 4 heads (2e-5,
   bitwise on repeat), the flash forward with 4 heads (phase 5's
   bounds), the weight-only kernel on half of lm_head's rows (1e-4, and
   a cosine of at least 0.999 against the unquantized product), the
   sweep on a member's buckets (bit for bit), with the MXL-K specs at
   those shapes clean and the built libraries' shared memory.  It prints
   its own kernels line (rows 1-4 at the member shapes).  (f), alone
   with ``--phases 22f`` on a machine with four cards: the LM at
   ``tp=4`` over the four (NCCL) within the float64 witness, and
   ``fsdp=True`` at ``dp=4`` bit for bit ZeRO-1's, with each card's
   peak memory.

23. sequence parallelism (``parallel/sequence_parallel.py``, ring
   attention in ``parallel/ring_attention.py``): phase 7's LM widths at
   sequence 4096, batch 2, through ``ShardedTrainer(seq_axis=1)`` on a
   dp=1 x sp=2 mesh of two members on the first card: (a) float32, 3
   steps, against the one-card step from the same weights and the plain
   float64 step (the first step's outputs and the parameters after it
   within twice the plain float32 step's distance from float64, every
   loss within 1e-5 relative of one card's), each member's ring hops
   (its own chunk, causal,
   and the earlier ones), one flash forward a hop and its own sweeps
   counted; (b) bfloat16, 3 steps against the one-card bfloat16 step
   (the first step's outputs and the parameters after it within twice
   one card's own distance from float64, in all and parameter by
   parameter, every loss within 1e-2 relative), two runs with a fault of the bfloat16 ring read beside
   them (a dropped hop must exceed the bound), and timed steps of both;
   (c) the mirrored step (``mirror_blocks``) bit
   for bit the unmirrored one, every hop run twice, with the peak memory
   of each; (d) ``ShardedPredictor(seq_axis=1)`` within 1e-5 of one
   card's; (e) the flash forward at the hop shapes (2, 8, 2048, 64) and
   (2, 8, 1024, 64), causal and not, float32 and bfloat16, and the sweep
   on a member's largest bucket, each against its plain version and
   timed; the ring alone forward and backward; and
   ``example/long-context-torch/train_lm_long.py`` on the card.  Per
   member: ring hops, bytes sent, its card's launches and peak memory.
   (f), alone with ``--phases 23f`` on four cards: sp=4 at sequence 8192
   and dp=2 x sp=2 at 4096, each in float32 against the one-card step on
   the first card (a), with each card's peak memory beside the one
   card's.

``--phases 13,4c,17cupti`` checks the profiler's CUPTI records inside
this process after the phases listed before it: 30 sessions each of five
kernels, of the profiler's probe, and of ``mx.profiler`` around five
kernels of the caller's, which must keep all five.

It exits 2 when CUDA is unavailable or when the package is not beside
this script.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is ``nvidia-smi``'s
name and power limit, and the one before that the per-kernel JSON.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

#: the card's peaks (NVIDIA data sheet, at the full power limit): HBM
#: bytes/s, float32 FMA-pipe operations/s (no tensor cores) and dense
#: bfloat16 tensor-core operations/s, read by load_peaks from the port's
#: one peak table (mxnet_tpu_torch.observability.counters.PEAKS), which
#: the trainer's MFU reads too: a kernel's bound and a step's MFU price
#: work at the same rates
HBM_BYTES_PER_S = F32_OPS_PER_S = BF16_OPS_PER_S = None

#: where every tensor of the run lives (a CPU rehearsal of the control
#: flow may set "cpu"; the kernels then take their plain versions)
DEVICE = "cuda"

MODEL = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
             max_seq_len=1024, ffn_mult=4)
N_PROMPTS = 8
MAX_NEW = 64

#: the training slice's full width: bench.py's chip configuration
#: (bench.py:913-930) of the same LM, batch 8 of 1024 tokens
TRAIN = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
             seq_len=1024, ffn_mult=4)
TRAIN_BATCH = 8
TRAIN_SGD = dict(learning_rate=0.1, momentum=0.9)


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_cards():
    """``nvidia-smi -L``: one line for each card the machine has."""
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi -L failed: %s" % out.stderr.strip())
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


class Timer(object):
    """Median of per-launch CUDA-event times, with the 50 MB L2 flushed
    (a 128 MB buffer overwritten) before every launch: the serving loop
    streams every layer's weights and cache between two calls of one
    kernel, so each call finds its inputs cold."""

    def __init__(self, torch, iters, lead_cycles=0):
        self.torch = torch
        self.iters = iters
        #: a spin of this many clock cycles after the flush keeps the
        #: card busy while the host enqueues a launch whose Python path
        #: is slower than the flush (a wrapper's checks, plan and
        #: allocations; phase 8's ``Rtc.push``), so the host's time stays
        #: out of the events' interval
        self.lead_cycles = lead_cycles
        self.flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                                 device=DEVICE)

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        starts = [torch.cuda.Event(enable_timing=True)
                  for _ in range(self.iters)]
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(self.iters)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            if self.lead_cycles:
                torch.cuda._sleep(self.lead_cycles)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e)
                                for s, e in zip(starts, ends)]))


def ptxas_functions(text):
    """(entry function, registers, spill store bytes, spill load bytes,
    static shared memory bytes) of each kernel in an ``nvcc -Xptxas -v``
    log."""
    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1))) + spills
                       + (int(smem.group(1)) if smem else 0,))
            name = None
    return out


#: kernels that must build without spills: the float32 flash forward at
#: the training head dim (``flash_forward_fma<64>``)
NO_SPILL = {"flash_attention": "flash_forward_fmaILi64E"}


def check_no_spills(info):
    """Fail when a kernel of NO_SPILL spills, or its build log (kept
    beside a cached library) does not say."""
    for lib, marker in NO_SPILL.items():
        found = [f for f in ptxas_functions(info[lib]["log"])
                 if marker in f[0]]
        if not found:
            raise AssertionError("ptxas log of %s has no %s" % (lib, marker))
        for fn, regs, st, ld, _smem in found:
            if st or ld:
                raise AssertionError("%s spills: %d bytes stored, %d loaded"
                                     % (fn, st, ld))
            log("  no spills: %s, %d registers" % (fn, regs))


def load_peaks(card=None):
    """Set the three peaks from the port's table at ``card``'s row (the
    H100 SXM's when the name is not in the table); returns the row's
    name."""
    global HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S
    from mxnet_tpu_torch.observability.counters import DEFAULT_CARD, PEAKS
    name = card if card in PEAKS else DEFAULT_CARD
    row = PEAKS[name]
    HBM_BYTES_PER_S = row["bytes_per_s"]
    F32_OPS_PER_S = row["tflops"]["float32"] * 1e12
    BF16_OPS_PER_S = row["tflops"]["bfloat16"] * 1e12
    return name


def ops_rate(dtype):
    """Peak operations/s for products in ``dtype``: the FMA pipes for
    float32, the tensor cores' dense bfloat16 rate otherwise."""
    if F32_OPS_PER_S is None:
        load_peaks()
    return F32_OPS_PER_S if str(dtype).replace("torch.", "") == "float32" \
        else BF16_OPS_PER_S


def bound_ms(n_bytes, n_ops, ops_per_s=None):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``ops_per_s`` (float32's
    when None)."""
    if ops_per_s is None:
        ops_per_s = ops_rate("float32")
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ----------------------------------------------------------------------
# phase 2: flash-decode
# ----------------------------------------------------------------------
def flash_decode_case(torch, rng, pos, dtype, kv_dtype=None, NB=256, BS=32,
                      H=8, D=64, MB=32):
    """One row a position of ``pos``, each row's live blocks distinct
    random pool blocks, trailing slots on trash block 0; the whole pool
    (block 0 included) holds random values.  ``kv_dtype``: the pools'
    type (q's by default)."""
    pos = np.asarray(pos, np.int32)
    B = len(pos)
    free = list(rng.permutation(np.arange(1, NB)))
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        n = int(pos[b]) // BS + 1
        table[b, :n] = [free.pop() for _ in range(n)]
    dev = DEVICE
    kv_dtype = kv_dtype or dtype
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(NB, BS, H, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(NB, BS, H, D).astype(np.float32))
    return (q.to(dev, dtype), k.to(dev, kv_dtype), v.to(dev, kv_dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


#: phase 2's positions: the decode batch of 8 (0, 31, 32 and 1023 among
#: them) and, at B=1, one deep row
FD_POSITIONS = [0, 31, 32, 1023, 17, 300, 640, 900]
FD_POS_B1 = [700]
#: a row with pos < 0, which the engine never passes: the kernel must give
#: the mean of v over the row's table, as the plain version does
FD_POS_NEGATIVE = [-1, 700, 0]


def _fd_check(torch, fd, case, scale, tol, what):
    """Kernel vs plain on one case, twice: the two kernel results must be
    equal bit for bit.  Returns max |kernel - plain|."""
    q, k, v, table, pos = case
    got = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
    again = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
    want = fd.decode_attention_reference(q, k, v, table, pos, scale=scale)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        raise AssertionError("flash_decode %s: max |kernel - plain| = %g > %g"
                             % (what, err, tol))
    if not torch.equal(got, again):
        raise AssertionError("flash_decode %s: two runs differ" % what)
    return err


def phase_flash_decode(torch, timer, seed):
    """The decode buckets B in {1, 2, 4, 8} and a ragged B=3, float32,
    bfloat16 and float32 q over a bfloat16 pool: kernel vs plain (and a
    bitwise repeat) at phase 2's positions, timed, and at every split edge
    of the B's plan (0, BS-1, BS, blocks_per_split*BS - 1,
    blocks_per_split*BS, MB*BS - 1), B rows at a time."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    rows = []
    rng = np.random.RandomState(seed)
    #: float32: same arithmetic, other summation order (a float32 q over
    #: a bfloat16 pool too: the plain version widens the pool); bfloat16:
    #: the plain version rounds scores and probabilities to bfloat16
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    BS, H, D, MB = 32, 8, 64, 32
    for B in (1, 2, 3, 4, 8):
        plan = fd.plan_flash_decode(B, H, MB, BS, D, sms)
        span = plan["blocks_per_split"] * BS
        edges = [0, BS - 1, BS, span - 1, span, MB * BS - 1]
        pos_main = FD_POSITIONS[:B] if B > 1 else FD_POS_B1
        for dtype, kv_dtype in ((torch.float32, torch.float32),
                                (torch.bfloat16, torch.bfloat16),
                                (torch.float32, torch.bfloat16)):
            tol = tols[dtype]
            what = "B=%d q %s pool %s" % (B, dtype, kv_dtype)
            scale = 1.0 / math.sqrt(D)
            edge_err = 0.0
            for i in range(0, len(edges), B):
                chunk = (edges[i:i + B] + pos_main)[:B]
                edge_err = max(edge_err, _fd_check(
                    torch, fd, flash_decode_case(torch, rng, chunk, dtype,
                                                 kv_dtype), scale, tol,
                    what + " at positions %s" % chunk))
            case = flash_decode_case(torch, rng, pos_main, dtype, kv_dtype)
            rows.append(_fd_timed_row(torch, fd, timer, plan, case, scale,
                                      tol, what, edge_err, edges))
    # a row with pos < 0 (outside the engine's use): every slot of its
    # table weighs alike, as in the plain version and the JAX package
    for dtype, kv_dtype in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16)):
        pos_neg = FD_POS_NEGATIVE
        plan = fd.plan_flash_decode(len(pos_neg), H, MB, BS, D, sms)
        case = flash_decode_case(torch, rng, pos_neg, dtype, kv_dtype)
        q, k, v, table, pos = case
        scale = 1.0 / math.sqrt(D)
        what = "B=%d q %s pool %s at positions %s" % (
            len(pos_neg), dtype, kv_dtype, pos_neg)
        got = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
        mean = v[table[0].long()].float().reshape(MB * BS, H, D).mean(0)
        mean_err = float((got[0].float() - mean).abs().max())
        if not mean_err <= tols[dtype]:
            raise AssertionError("flash_decode %s: row 0 is %g from the mean "
                                 "of v over its table" % (what, mean_err))
        row = _fd_timed_row(torch, fd, timer, plan, case, scale, tols[dtype],
                            what, 0.0, [])
        row["mean_max_abs_err"] = mean_err
        rows.append(row)
    return rows


def _fd_timed_row(torch, fd, timer, plan, case, scale, tol, what, edge_err,
                  edges):
    """Kernel vs plain on ``case`` (twice, bitwise), then the times of the
    kernel, the plain version, SDPA on the gathered cache and the bytes
    bound.  A row with pos < 0 reads its whole table; SDPA gets -1e30
    additive masks there so that it weighs every slot alike too."""
    import torch.nn.functional as F
    q, k, v, table, pos = case
    B, H, D = q.shape
    NB, BS = k.shape[:2]
    MB = table.shape[1]
    err = _fd_check(torch, fd, case, scale, tol, what)
    # yardstick: SDPA on the gathered cache (gather not timed)
    kk = k[table.long()].reshape(B, MB * BS, H, D).transpose(1, 2)
    vv = v[table.long()].reshape(B, MB * BS, H, D).transpose(1, 2)
    kk, vv = kk.to(q.dtype).contiguous(), vv.to(q.dtype).contiguous()
    mask = (torch.arange(MB * BS, device=DEVICE)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    if bool((pos < 0).any()):
        mask = torch.where(mask | (pos < 0)[:, None, None, None],
                           torch.zeros((), device=DEVICE),
                           torch.full((), -1e30, device=DEVICE)).to(q.dtype)
    q4 = q[:, :, None, :]
    want = fd.decode_attention_reference(q, k, v, table, pos, scale=scale)
    lib = F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask,
                                         scale=scale)[:, :, 0]
    lib_err = float((lib.float() - want.float()).abs().max())
    n_tok = int(torch.where(pos < 0, MB * BS, pos.long() + 1).sum())
    n_bytes = (2 * n_tok * H * D * k.element_size()
               + 2 * q.numel() * q.element_size()
               + table.numel() * 4 + pos.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * n_tok * H * D)
    row = {
        "B": B, "dtype": str(q.dtype).replace("torch.", ""),
        "kv_dtype": str(k.dtype).replace("torch.", ""),
        "pos": pos.tolist(), "edges": edges,
        "plan": {key: plan[key] for key in (
            "splits", "blocks_per_split", "ctas")},
        "max_abs_err": max(err, edge_err), "edge_max_abs_err": edge_err,
        "tol": tol, "repeat_bitwise": True,
        "library_max_abs_err": lib_err,
        "ms": timer(lambda: fd.flash_decode_attention(
            q, k, v, table, pos, scale=scale)),
        "plain_ms": timer(lambda: fd.decode_attention_reference(
            q, k, v, table, pos, scale=scale)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=mask, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
    log("flash_decode B=%d q %-8s pool %-8s pos %s splits=%d ctas=%d "
        "err=%.3g edges err=%.3g (tol %g) repeat bitwise "
        "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
        % (B, row["dtype"], row["kv_dtype"], row["pos"] if B <= 3 else "...",
           plan["splits"], plan["ctas"], err, edge_err, tol, row["ms"],
           row["plain_ms"], row["library_ms"], b_ms, b_by))
    return row


# ----------------------------------------------------------------------
# phase 3: int8 weight-only matmul
# ----------------------------------------------------------------------
def phase_quantized_matmul(torch, timer, seed):
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(seed + 1)
    rows = []
    #: float32 sums over K <= 16384 in another order (the wgmma body: x as
    #: three bfloat16 pieces holding all 24 bits, exact products summed
    #: in float32); bfloat16 output rounding (8 mantissa bits) of values
    #: of order 1
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    #: M <= 16 takes the GEMV body (one instance per M rounded up to a
    #: power of two: 1, 2, 4 and 8 are the decode buckets, 3 is ragged),
    #: larger M the wgmma body: 16 and 17 straddle the threshold, 33 is
    #: ragged, 240 and 960 are prompt buckets
    cases = [(m, k, n, torch.float32, "int8")
             for m in (1, 2, 3, 4, 8, 16, 17, 33, 240, 960)
             for k, n in ((512, 2048), (2048, 512), (512, 8192))]
    # a wider model's ffn2 and lm_head at decode: K that the GEMV splits
    # so x fits its shared memory
    cases += [(8, 16384, 4096, torch.float32, "int8"),
              (16, 4096, 8192, torch.float32, "int8")]
    cases += [(8, 512, 8192, torch.bfloat16, "int8"),
              (240, 512, 2048, torch.bfloat16, "int8")]
    # fp8 e4m3 weights at the lm_head shape: decode (the GEMV), just past
    # the GEMV's 16 rows and the largest prompt bucket (wgmma)
    cases += [(m, 512, 8192, torch.float32, "fp8_e4m3") for m in (8, 17, 960)]
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    for m, k, n, dtype, qdtype in cases:
        q, scale = qz.quantize_array(
            (rng.randn(n, k) * 0.02).astype(np.float32), qdtype=qdtype)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
            DEVICE, dtype)
        wq = torch.as_tensor(q).to(DEVICE)
        sc = torch.from_numpy(scale).to(DEVICE)
        plan = qz.plan_quantized_matmul(m, n, k, sms)
        got = qz.quantized_matmul(x, wq, sc)
        again = qz.quantized_matmul(x, wq, sc)
        want = qz.quantized_matmul_reference(x, wq, sc)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tols[dtype]:
            raise AssertionError(
                "quantized_matmul M=%d K=%d N=%d %s %s (%s): max |kernel - "
                "plain| = %g > %g" % (m, k, n, dtype, qdtype, plan["route"],
                                      err, tols[dtype]))
        if not torch.equal(got, again):
            raise AssertionError(
                "quantized_matmul M=%d K=%d N=%d %s %s (%s): a second call "
                "gave other bits" % (m, k, n, dtype, qdtype, plan["route"]))
        w_deq = (wq.float() * sc[:, None]).to(dtype)
        n_bytes = (m * k * x.element_size() + n * k + n * 4
                   + m * n * x.element_size())
        if plan["route"] == "gemv":
            # float32 FMAs on the CUDA cores
            pieces = 0
            b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k)
        else:
            # the function's 2 M N K operations at the bfloat16 tensor
            # rate; the three products a float32 x takes are the kernel's
            # design, not work the function needs (row's "tensor_ops")
            pieces = 3 if dtype == torch.float32 else 1
            b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k,
                                  ops_rate("bfloat16"))
        row = {"M": m, "K": k, "N": n,
               "dtype": str(dtype).replace("torch.", ""), "qdtype": qdtype,
               "route": plan["route"], "splits": plan["splits"],
               "bf16_pieces": pieces,
               "max_abs_err": err, "tol": tols[dtype],
               "ms": timer(lambda: qz.quantized_matmul(x, wq, sc)),
               "plain_ms": timer(lambda: qz.quantized_matmul_reference(
                   x, wq, sc)),
               "library_ms": timer(lambda: torch.matmul(x, w_deq.t())),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "ops": 2 * m * n * k,
               "tensor_ops": pieces * 2 * m * n * k}
        rows.append(row)
        log("quantized_matmul M=%-4d K=%-4d N=%-4d %-8s %-8s %-5s "
            "splits=%-2d err=%.3g (tol %g, bitwise on repeat) kernel_ms=%.4f "
            "plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
            % (m, k, n, row["dtype"], qdtype, plan["route"], plan["splits"],
               err, tols[dtype], row["ms"], row["plain_ms"],
               row["library_ms"], b_ms, b_by))
    return rows


# ----------------------------------------------------------------------
# phase 4: the slice at full width
# ----------------------------------------------------------------------
def seeded_params(seed):
    """Random weights of the decode graph, from ``seed`` with numpy:
    N(0, 0.02) matrices and embeddings, zero biases, unit LayerNorm."""
    from mxnet_tpu_torch.models import transformer as tf
    sym = tf.get_decode_symbol(**MODEL)
    E, H = MODEL["dim"], MODEL["num_heads"]
    caches = {"layer%d_att_%s_cache" % (i, c): (2, 32, H, E // H)
              for i in range(MODEL["num_layers"]) for c in "kv"}
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1), seq_pos=(1,),
                                   block_table=(1, 1), **caches)
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "pos_ids", "seq_pos", "block_table") \
                or name in caches:
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def plain_lm_logits(torch, params, tokens):
    """Logits of every position of ``tokens`` from a plain full-sequence
    float32 forward of the same LM: no cache, no kernels, causal softmax
    attention over the whole sequence."""
    F = torch.nn.functional
    p = {k: torch.from_numpy(v).to(DEVICE) for k, v in params.items()}
    E, H = MODEL["dim"], MODEL["num_heads"]
    D = E // H
    S = len(tokens)
    ids = torch.tensor(tokens, device=DEVICE)
    x = p["tok_embed_weight"][ids] + p["pos_embed_weight"][:S]
    causal = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
    for i in range(MODEL["num_layers"]):
        n = "layer%d_" % i
        h = F.layer_norm(x, (E,), p[n + "ln1_gamma"], p[n + "ln1_beta"])
        qkv = h @ p[n + "att_qkv_weight"].t() + p[n + "att_qkv_bias"]
        q, k, v = (t.reshape(S, H, D).transpose(0, 1)
                   for t in qkv.split(E, dim=-1))
        s = (q @ k.transpose(1, 2)) / math.sqrt(D)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
        x = x + a.transpose(0, 1).reshape(S, E) @ p[n + "att_out_weight"].t() \
            + p[n + "att_out_bias"]
        h = F.layer_norm(x, (E,), p[n + "ln2_gamma"], p[n + "ln2_beta"])
        h = torch.relu(h @ p[n + "ffn1_weight"].t() + p[n + "ffn1_bias"])
        x = x + h @ p[n + "ffn2_weight"].t() + p[n + "ffn2_bias"]
    x = F.layer_norm(x, (E,), p["final_ln_gamma"], p["final_ln_beta"])
    return (x @ p["lm_head_weight"].t() + p["lm_head_bias"]).cpu().numpy()


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def run_engine(torch, params, prompts, quantize):
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.serving import GenerationEngine
    t0 = time.perf_counter()
    eng = GenerationEngine(params, ctx=torch.device(DEVICE), quantize=quantize,
                           **MODEL)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng.collect_logits = True
    # launch counts cover the generate() run only
    fd.flash_decode_attention.launches = 0
    qz.quantized_matmul.launches = 0
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    t0 = time.perf_counter()
    tokens = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    n_tok = sum(len(t) for t in tokens)
    res = {"quantize": quantize or "float32",
           "prompt_buckets": st["prompt_buckets"],
           "decode_buckets": st["decode_buckets"],
           "engine_build_s": build_s, "generate_s": wall,
           "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "prefill_ms_per_prompt": st["prefill_s"] * 1e3 / st["prefills"],
           "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
           "decode_steps": st["decode_steps"],
           "launches": {"flash_decode": fd.flash_decode_attention.launches,
                        "quantized_matmul": qz.quantized_matmul.launches},
           "quantized_matmul_by_route":
               dict(qz.quantized_matmul.launches_by_route)}
    log("engine %-7s buckets prompt=%s decode=%s: prefill %.3f ms/prompt, "
        "decode %.3f ms/step over %d steps, %.1f tokens/s, launches %s, "
        "int8 matmul by body %s"
        % (res["quantize"], res["prompt_buckets"], res["decode_buckets"],
           res["prefill_ms_per_prompt"], res["decode_ms_per_step"],
           res["decode_steps"], res["tokens_per_s"], res["launches"],
           res["quantized_matmul_by_route"]))
    for toks, rows in zip(tokens, eng.last_logits):
        if len(toks) != MAX_NEW or len(rows) != MAX_NEW:
            raise AssertionError("%s: %d tokens / %d logit rows, want %d"
                                 % (res["quantize"], len(toks), len(rows),
                                    MAX_NEW))
        for r in rows:
            if r.shape != (MODEL["vocab_size"],) or not np.isfinite(r).all():
                raise AssertionError("%s: bad logits row" % res["quantize"])
    return res, tokens, eng.last_logits


def make_prompts(seed, n_more=0):
    """Phase 4's prompts (17 to 900 tokens), then ``n_more`` drawn after
    them from the same generator."""
    rng = np.random.RandomState(seed + 2)
    lengths = [17, 900] + sorted(int(n) for n in
                                 rng.randint(18, 900, size=N_PROMPTS - 2))
    prompts = [rng.randint(0, MODEL["vocab_size"], size=n).tolist()
               for n in lengths]
    for n in rng.randint(17, 901, size=n_more):
        prompts.append(rng.randint(0, MODEL["vocab_size"], size=n).tolist())
    return prompts


def phase_engine(torch, seed):
    params = seeded_params(seed)
    prompts = make_prompts(seed)
    lengths = [len(p) for p in prompts]
    f32, f_tok, f_logits = run_engine(torch, params, prompts, None)
    i8, q_tok, q_logits = run_engine(torch, params, prompts, "int8")
    if f32["launches"]["flash_decode"] < 1 or i8["launches"]["flash_decode"] < 1:
        raise AssertionError("flash_decode kernel did not run on the path")
    if i8["launches"]["quantized_matmul"] < 1:
        raise AssertionError("int8 kernel did not run on the path")
    if min(i8["quantized_matmul_by_route"].values()) < 1:
        raise AssertionError("generate() did not run both int8 bodies "
                             "(decode GEMV, prefill wgmma): %s"
                             % i8["quantized_matmul_by_route"])

    # float32 engine vs a plain full-sequence forward, shortest prompt:
    # logits rows n_prompt-1 .. end come from the paged cache + kernel
    seq = prompts[0] + f_tok[0]
    plain = plain_lm_logits(torch, params, seq[:-1])[len(prompts[0]) - 1:]
    ref_err = float(np.abs(np.stack(f_logits[0]) - plain).max())
    if not ref_err <= 1e-3:
        raise AssertionError("float32 engine vs plain forward: max |diff| "
                             "= %g > 1e-3" % ref_err)

    # int8 vs float32, per step, up to the first step whose tokens
    # differ (after it the two runs condition on different prefixes)
    worst, steps, same = 1.0, 0, 0
    for ft, qt, fr, qr in zip(f_tok, q_tok, f_logits, q_logits):
        for i in range(MAX_NEW):
            worst = min(worst, _cosine(fr[i], qr[i]))
            steps += 1
            if ft[i] != qt[i]:
                break
            same += 1
    if not worst >= 0.999:
        raise AssertionError("int8 logits cosine %.6f < 0.999" % worst)
    log("engine checks: float32 vs plain forward max|diff|=%.3g (tol 1e-3); "
        "int8 vs float32 min cosine %.6f over %d steps (%d with identical "
        "tokens)" % (ref_err, worst, steps, same))
    return {"float32": f32, "int8": i8, "prompt_lengths": lengths,
            "float32_vs_plain_max_abs_diff": ref_err,
            "int8_min_cosine": worst, "cosine_steps": steps,
            "identical_token_steps": same, "float32_tokens": f_tok}


# ----------------------------------------------------------------------
# phase 4b: the in-process ModelServer at full width
# ----------------------------------------------------------------------
#: phase 4's 8 prompts and 8 more, to each LM of the server
SERVE_PROMPTS = 16
#: the MLP's traffic: request sizes by weight (tools/serve_bench.py's
#: histogram for its toy MLP) and the number of requests
MLP_HIST = {1: 60, 2: 25, 4: 10, 8: 5}
MLP_REQUESTS = 200
CLIENTS = 4


def dequantized_params(params, qdtype):
    """The float32 weights that the quantized model computes with:
    each quantized weight replaced by float(q) * scale."""
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.models import transformer as tf
    names = qz.quantizable_weights(tf.get_decode_symbol(**MODEL).tojson())
    out = dict(params)
    for name in names:
        q, scale = qz.quantize_array(params[name], qdtype=qdtype)
        out[name] = qz.dequantize_array(q, scale)
    return out


def _telemetry_records(directory):
    records = []
    for path in sorted(os.listdir(directory)):
        if path.startswith("events-rank") and path.endswith(".jsonl"):
            with open(os.path.join(directory, path)) as f:
                records.extend(json.loads(line) for line in f)
    return records


def _client_threads(jobs):
    """Run ``jobs`` (callables) on CLIENTS threads, round robin; returns
    each job's result in order.  A job's exception fails the phase."""
    import threading
    results, errors = [None] * len(jobs), []

    def worker(idx):
        try:
            for i in range(idx, len(jobs), CLIENTS):
                results[i] = jobs[i]()
        except Exception as exc:             # raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _submit_generation(srv, model, prompt, eos_id, busy):
    """Admit one generation, retrying after a 429 (KV-cache pressure) as
    its ``retry_after_ms`` says; returns the request's future."""
    from mxnet_tpu_torch.serving import ServerBusy
    while True:
        try:
            future, _stream = srv.generate(model, prompt, eos_id=eos_id)
            return future
        except ServerBusy as exc:
            if exc.code != 429:
                raise
            busy[model] = busy.get(model, 0) + 1
            time.sleep(exc.retry_after_ms / 1e3)


def check_generated(torch, model, params, prompts, results):
    """Gate (a): every generated token's logit within 1e-3 of the
    maximum of its row of a plain full-sequence float32 forward over
    prompt + generated tokens (``params``: the weights the model
    computes with).  Returns the worst gap."""
    worst = 0.0
    for prompt, res in zip(prompts, results):
        toks = res["tokens"]
        if not toks or len(toks) > MAX_NEW:
            raise AssertionError("%s: %d tokens generated" % (model,
                                                               len(toks)))
        logits = plain_lm_logits(torch, params, prompt + toks[:-1])[
            len(prompt) - 1:]
        if logits.shape != (len(toks), MODEL["vocab_size"]) \
                or not np.isfinite(logits).all():
            raise AssertionError("%s: bad plain logits" % model)
        gap = float((logits.max(axis=1) - logits[np.arange(len(toks)),
                                                 toks]).max())
        worst = max(worst, gap)
    if not worst <= 1e-3:
        raise AssertionError("%s: a generated token's logit is %g below "
                             "its row's maximum (> 1e-3)" % (model, worst))
    return worst


def phase_serve(torch, seed, smi, phase4_tokens):
    """The in-process ModelServer at full width: two LMs (float32 and
    fp8 e4m3 weights) and the MLP on one server, CLIENTS client threads,
    then a small-pool server for the 429 path."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import program_registry_stats
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.observability import events, percentile
    from mxnet_tpu_torch.serving import ModelServer, ServerBusy, serve_report
    here = os.path.dirname(os.path.abspath(__file__))
    tel_dir = os.path.join(here, "build", "chip_smoke_telemetry")
    if os.path.isdir(tel_dir):
        for f in os.listdir(tel_dir):
            os.remove(os.path.join(tel_dir, f))
    os.environ["MXTPU_TELEMETRY"] = "1"
    os.environ["MXTPU_TELEMETRY_DIR"] = tel_dir
    events.refresh()
    # ctx=None: the server's default, the current context (gpu(0))
    ctx = None if DEVICE == "cuda" else torch.device(DEVICE)
    params = seeded_params(seed)
    prompts = make_prompts(seed, SERVE_PROMPTS - N_PROMPTS)
    # two requests stop at an eos_id: the token phase 4's float32 engine
    # generated 20th for the same prompt
    eos = {0: phase4_tokens[0][19], 1: phase4_tokens[1][19]}
    rng = np.random.RandomState(seed + 5)
    net = mx.models.get_mlp(num_classes=10, hidden=(128, 64))
    arg_shapes = net.infer_shape(data=(1, 128))[0]
    mlp_params = {"arg:" + n: (rng.randn(*sh) * 0.1).astype(np.float32)
                  for n, sh in zip(net.list_arguments(), arg_shapes)
                  if n not in ("data", "softmax_label")}
    sizes = rng.choice(sorted(MLP_HIST), size=MLP_REQUESTS,
                       p=np.array([MLP_HIST[k] for k in sorted(MLP_HIST)],
                                  np.float64) / sum(MLP_HIST.values()))
    mlp_inputs = [rng.rand(int(n), 128).astype(np.float32) for n in sizes]

    t0 = time.perf_counter()
    srv = ModelServer()
    engines = {
        "lm-f32": srv.add_generative_model("lm-f32", params, ctx=ctx,
                                           **MODEL),
        "lm-fp8": srv.add_generative_model("lm-fp8", params, ctx=ctx,
                                           quantize="fp8_e4m3", **MODEL)}
    srv.add_model("mlp", net.tojson(), mlp_params, {"data": (128,)},
                  buckets=(1, 2, 4, 8), ctx=ctx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for name, eng in engines.items():
        st = eng.stats()
        if (st["block_size"], st["blocks_total"] + 1, eng.max_new) \
                != (32, 256, MAX_NEW):
            raise AssertionError("%s: not the engine's defaults: %s"
                                 % (name, st))
    lowerings = program_registry_stats()["lowerings"]
    fd.flash_decode_attention.launches = 0
    qz.quantized_matmul.launches = 0
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    qz.quantized_matmul.launches_by_qdtype.update(int8=0, fp8_e4m3=0)
    busy = {}
    gen_jobs = [(model, i) for i in range(SERVE_PROMPTS)
                for model in engines]
    mlp_lat = []

    def gen_job(model, i):
        return lambda: _submit_generation(srv, model, prompts[i],
                                          eos.get(i), busy)

    def mlp_job(x):
        def run():
            t = time.perf_counter()
            out = srv.submit("mlp", x).result(timeout=600)
            mlp_lat.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    t_start = time.perf_counter()
    futures = _client_threads([gen_job(m, i) for m, i in gen_jobs])
    mlp_out = _client_threads([mlp_job(x) for x in mlp_inputs])
    t_mlp = time.perf_counter() - t_start
    gen_res = [f.result(timeout=900) for f in futures]
    t_window = time.perf_counter() - t_start
    srv.drain(timeout=600)
    torch.cuda.synchronize()
    launches = {"flash_decode": fd.flash_decode_attention.launches,
                "quantized_matmul": qz.quantized_matmul.launches,
                "quantized_matmul_by_route":
                    dict(qz.quantized_matmul.launches_by_route),
                "quantized_matmul_by_qdtype":
                    dict(qz.quantized_matmul.launches_by_qdtype)}
    stats = srv.stats()
    events.flush()
    records = _telemetry_records(tel_dir)

    # (c) zero lowerings after warmup (each model's lowerings_since_warmup
    # counts from its own add_*, so only the last added reads 0 here)
    if program_registry_stats()["lowerings"] != lowerings \
            or stats["models"]["mlp"]["lowerings_since_warmup"]:
        raise AssertionError("lowerings after warmup: %d -> %d"
                             % (lowerings,
                                program_registry_stats()["lowerings"]))
    if stats["failed"]:
        raise AssertionError("%d requests failed" % stats["failed"])
    # (e) flash-decode once a layer on every decode step of either LM;
    # the fp8 model through both bodies of the weight-only kernel
    decode_steps = sum(1 for r in records if r.get("kind") == "serve"
                       and r.get("phase") == "decode")
    if launches["flash_decode"] != decode_steps * MODEL["num_layers"]:
        raise AssertionError(
            "flash_decode launched %d times over %d decode steps of %d "
            "layers" % (launches["flash_decode"], decode_steps,
                        MODEL["num_layers"]))
    if launches["quantized_matmul_by_qdtype"]["fp8_e4m3"] < 1 \
            or launches["quantized_matmul_by_qdtype"]["int8"] \
            or min(launches["quantized_matmul_by_route"].values()) < 1:
        raise AssertionError("the fp8 model did not run both fp8 bodies: "
                             "%s" % launches)
    # (a) generated tokens against a plain forward
    by_model = {m: [r for (mm, _i), r in zip(gen_jobs, gen_res) if mm == m]
                for m in engines}
    gaps = {}
    gaps["lm-f32"] = check_generated(
        torch, "lm-f32", params, prompts, by_model["lm-f32"])
    fp8_params = dequantized_params(params, "fp8_e4m3")
    gaps["lm-fp8"] = check_generated(
        torch, "lm-fp8", fp8_params, prompts, by_model["lm-fp8"])
    finish = {m: [r["finish_reason"] for r in by_model[m]] for m in engines}
    for m in engines:
        for i, r in enumerate(by_model[m]):
            stop = eos.get(i)
            if r["finish_reason"] == "eos" and r["tokens"][-1] != stop \
                    or r["finish_reason"] == "length" \
                    and len(r["tokens"]) != MAX_NEW:
                raise AssertionError("%s request %d: finished %s with %d "
                                     "tokens" % (m, i, r["finish_reason"],
                                                 len(r["tokens"])))
    # (f) report: the fp8 model's plain logits against float32's plain
    # logits over the same (fp8-generated) sequences
    cos = 1.0
    for prompt, res in zip(prompts, by_model["lm-fp8"]):
        f32 = plain_lm_logits(torch, params, prompt + res["tokens"][:-1])[
            len(prompt) - 1:]
        f8 = plain_lm_logits(torch, fp8_params,
                             prompt + res["tokens"][:-1])[len(prompt) - 1:]
        cos = min(cos, min(_cosine(a, b) for a, b in zip(f32, f8)))
    # (b) MLP against a serial Predictor
    mlp_err = 0.0
    preds = {}
    for x, out in zip(mlp_inputs, mlp_out):
        pred = preds.get(x.shape[0])
        if pred is None:
            pred = preds[x.shape[0]] = mx.Predictor(
                net.tojson(), mlp_params, {"data": x.shape}, ctx=ctx)
        ref = pred.forward(data=x)[0]
        np.testing.assert_allclose(out[0], ref, rtol=1e-5, atol=1e-6)
        mlp_err = max(mlp_err, float(np.abs(out[0] - ref).max()))

    rep = serve_report(records)
    res = {"build_s": build_s, "window_s": t_window, "retries_429": busy,
           "finish_reasons": finish,
           "launches": launches, "decode_steps": decode_steps,
           "token_logit_gap": gaps, "fp8_min_cosine": cos,
           "mlp_max_abs_err": mlp_err, "models": {}}
    for name in engines:
        recs = [r for r in records if r.get("kind") == "serve"
                and r.get("model") == name]
        ttft = [v for r in recs for v in r.get("ttft_ms") or ()]
        itl = [v for r in recs for v in r.get("itl_ms") or ()]
        dec = [r["device_ms"] for r in recs if r.get("phase") == "decode"]
        n_tok = sum(len(r["tokens"]) for r in by_model[name])
        m = {"tokens": n_tok, "tokens_per_s": n_tok / t_window,
             "ttft_ms": {"p50": percentile(ttft, 50),
                         "p99": percentile(ttft, 99)},
             "itl_ms": {"p50": percentile(itl, 50),
                        "p99": percentile(itl, 99)},
             "decode_ms_per_step": float(np.mean(dec)),
             "decode_steps": len(dec),
             "decode_batch_mean": float(np.mean(
                 [r["n_samples"] for r in recs
                  if r.get("phase") == "decode"])),
             "serve_report": rep["models"].get(name)}
        res["models"][name] = m
        log("serve %-7s %d tokens in %.3f s: %.1f tokens/s; TTFT p50 %.1f "
            "p99 %.1f ms; ITL p50 %.2f p99 %.2f ms; decode %.3f ms a step "
            "over %d steps (mean batch %.2f); logit gap <= %.3g (%s)"
            % (name, n_tok, t_window, m["tokens_per_s"], m["ttft_ms"]["p50"],
               m["ttft_ms"]["p99"], m["itl_ms"]["p50"], m["itl_ms"]["p99"],
               m["decode_ms_per_step"], m["decode_steps"],
               m["decode_batch_mean"], gaps[name], smi))
    mrep = rep["models"]["mlp"]
    res["models"]["mlp"] = {
        "requests": len(mlp_inputs), "req_per_s": len(mlp_inputs) / t_mlp,
        "latency_ms": {"p50": percentile(mlp_lat, 50),
                       "p99": percentile(mlp_lat, 99)},
        "serve_report": mrep}
    log("serve mlp     %d requests in %.3f s: %.1f req/s; client latency "
        "p50 %.3f p99 %.3f ms (batcher: p50 %s p99 %s ms, occupancy %s); "
        "max |server - Predictor| %.3g (%s)"
        % (len(mlp_inputs), t_mlp, res["models"]["mlp"]["req_per_s"],
           res["models"]["mlp"]["latency_ms"]["p50"],
           res["models"]["mlp"]["latency_ms"]["p99"],
           mrep["latency_ms"]["p50"], mrep["latency_ms"]["p99"],
           mrep["occupancy"], mlp_err, smi))
    log("serve checks: lowerings after warmup 0; flash_decode %d launches "
        "= %d decode steps x %d layers; weight-only matmul %s by body %s "
        "by type %s; 429 retries %s; fp8 vs float32 plain logits min "
        "cosine %.6f (reported, not gated)"
        % (launches["flash_decode"], decode_steps, MODEL["num_layers"],
           launches["quantized_matmul"],
           launches["quantized_matmul_by_route"],
           launches["quantized_matmul_by_qdtype"], busy, cos))

    # the same prompts through engine.generate() on the same engines, the
    # server closed first (its scheduler would step the engine's active
    # sequences); eight prompts a call, as phase 4 (sixteen outgrow the
    # 255-block pool at admission)
    srv.close()
    for name, eng in engines.items():
        t = time.perf_counter()
        toks = (eng.generate(prompts[:N_PROMPTS])
                + eng.generate(prompts[N_PROMPTS:]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_tok = sum(len(x) for x in toks)
        same = sum(a == b["tokens"] for a, b, i in zip(
            toks, by_model[name], range(SERVE_PROMPTS)) if i not in eos)
        res["models"][name]["generate_s"] = wall
        res["models"][name]["generate_tokens_per_s"] = n_tok / wall
        res["models"][name]["same_tokens_as_generate"] = same
        log("serve %-7s engine.generate() of the same prompts: %.3f s, "
            "%.1f tokens/s; %d of %d requests without eos_id gave the "
            "same tokens through the server (printed, not gated)"
            % (name, wall, n_tok / wall, same, SERVE_PROMPTS - len(eos)))

    # (d) KV-cache pressure: a pool of 40 blocks holds one 900-token
    # request (31 blocks) and not a second
    small = ModelServer()
    small.add_generative_model("lm-small", params, ctx=ctx, kv_blocks=40,
                               prompt_buckets=(960,), decode_buckets=(1,),
                               **MODEL)
    first, _s = small.generate("lm-small", prompts[1])
    try:
        small.generate("lm-small", prompts[1])
    except ServerBusy as exc:
        doc = exc.to_dict()
        if exc.code != 429 or "blocks_free" not in doc:
            raise AssertionError("429 without blocks_free: %s" % doc)
        res["busy_429"] = doc
    else:
        raise AssertionError("a second 900-token request was admitted "
                             "into a 39-block pool")
    done = first.result(timeout=300)
    if len(done["tokens"]) != MAX_NEW:
        raise AssertionError("the admitted request did not finish: %s"
                             % done)
    small.close()
    log("serve 429 under KV-cache pressure: %s; the admitted request "
        "finished with %d tokens" % (res["busy_429"], len(done["tokens"])))
    del os.environ["MXTPU_TELEMETRY"], os.environ["MXTPU_TELEMETRY_DIR"]
    events.refresh()
    return res


# ----------------------------------------------------------------------
# phase 4c: the serving fleet at full width
# ----------------------------------------------------------------------
#: the LM the fleet serves: phase 4's model (vocab 8192, 8 layers, 8
#: heads, dim 512) through ``models.transformer.get_symbol`` at a
#: 512-token window
FLEET_LM = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
                seq_len=512, ffn_mult=4)
FLEET_BUCKETS = (1, 2, 4)
FLEET_REQUESTS = 48
FLEET_DRILL_REQUESTS = 16
FLEET_SWAP_REQUESTS = 8
FLEET_QUANTIZE = "fp8_e4m3"
#: heartbeat staleness bound of the drill, seconds
FLEET_HB_TIMEOUT_S = 3.0
#: the respawned replica must answer within this many seconds of the kill
FLEET_RESPAWN_LIMIT_S = 60.0
FLEET_TIMEOUT_S = 120.0


def fleet_symbol():
    """The served graph: ``get_symbol``'s LM with its softmax output
    reshaped to (batch, seq_len, vocab), so the batch axis leads as the
    server slices results by rows."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer as tf
    S, V = FLEET_LM["seq_len"], FLEET_LM["vocab_size"]
    return mx.sym.Reshape(tf.get_symbol(**FLEET_LM), shape=(-1, S, V),
                          name="lm_out")


def fleet_params(sym, seed):
    """Seeded weights of the served LM (phase 4's rules: N(0, 0.02)
    matrices and embeddings, zero biases, unit LayerNorm)."""
    S = FLEET_LM["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def fleet_requests(seed, count):
    """``count`` requests of 1 or 2 sequences of seq_len token ids."""
    S, V = FLEET_LM["seq_len"], FLEET_LM["vocab_size"]
    rng = np.random.RandomState(seed)
    out = []
    for n in rng.choice([1, 2], size=count):
        ids = rng.randint(0, V, (int(n), S)).astype(np.float32)
        out.append({"data": ids, "softmax_label": np.zeros_like(ids)})
    return out


def _digest(arr):
    import hashlib
    arr = np.ascontiguousarray(arr)
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest() \
        + str(arr.shape) + arr.dtype.str


class FleetReference(object):
    """In-process Predictors of the served LM, one per bucket, on the
    same checkpoint and quantization as the replicas: the digest of each
    request's output at every bucket it can have run at (a request of n
    rows padded with zero rows to the bucket, as the server packs it).
    Each bucket's Predictor is built afresh from the checkpoint, not by
    ``reshape`` as the server binds its later buckets, so a bucket bound
    wrong there cannot agree with its reference here."""

    def __init__(self, torch, sym_json, params_path, ctx):
        from mxnet_tpu_torch.predictor import Predictor
        S = FLEET_LM["seq_len"]
        self.preds = {
            b: Predictor(sym_json, params_path,
                         {"data": (b, S), "softmax_label": (b, S)},
                         ctx=ctx, quantize=FLEET_QUANTIZE)
            for b in FLEET_BUCKETS}

    def outputs(self, req):
        """{bucket: output rows of the request}."""
        n = req["data"].shape[0]
        out = {}
        for b, pred in self.preds.items():
            if b < n:
                continue
            feed = {k: np.zeros((b,) + v.shape[1:], v.dtype)
                    for k, v in req.items()}
            for k, v in req.items():
                feed[k][:n] = v
            out[b] = pred.forward(**feed)[0][:n]
        return out

    def digests(self, reqs):
        return [{b: _digest(o) for b, o in self.outputs(r).items()}
                for r in reqs]


def check_fleet_outputs(what, reqs, refs, got, reference):
    """Gate: each response bit for bit equal to the in-process Predictor
    at one of the buckets it can have run at.  Returns the count of
    matches by bucket."""
    by_bucket = {}
    for i, digest in got:
        hit = [b for b, d in refs[i].items() if d == digest]
        if not hit:
            outs = reference.outputs(reqs[i])
            raise AssertionError(
                "%s: request %d (n=%d) is not bit for bit the in-process "
                "Predictor's output at any bucket it fits (digest %s; "
                "buckets %s)" % (what, i, reqs[i]["data"].shape[0], digest,
                                 sorted(outs)))
        by_bucket[hit[0]] = by_bucket.get(hit[0], 0) + 1
    return by_bucket


def check_fleet_launches(what, launches):
    """Gate: the path ran the fp8 weight-only matmul's wgmma body and the
    float32 (FMA) flash-attention forward."""
    qmm = launches.get("quantized_matmul", {})
    fa = launches.get("flash_attention", {})
    if not (qmm.get("by_qdtype", {}).get("fp8_e4m3", 0) > 0
            and qmm.get("by_route", {}).get("wgmma", 0) > 0
            and fa.get("by_dtype", {}).get("float32", 0) > 0):
        raise AssertionError("%s did not run the fp8 wgmma body and the "
                             "float32 flash forward: %s" % (what, launches))


def gpu_memory_by_pid():
    """``nvidia-smi``'s compute processes: [(pid, used memory), ...]."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return [tuple(p.strip() for p in line.split(",", 1))
            for line in out.stdout.strip().splitlines() if line.strip()]


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _timed_jobs(call, reqs, idx):
    """CLIENTS threads send ``reqs[i]`` for i in ``idx`` through
    ``call``; returns (wall seconds, [(i, digest)], [latency ms])."""
    got, lat = [None] * len(idx), [None] * len(idx)

    def job(j):
        def run():
            t = time.perf_counter()
            out = call(reqs[idx[j]])
            lat[j] = (time.perf_counter() - t) * 1e3
            got[j] = (idx[j], _digest(out))
        return run

    t0 = time.perf_counter()
    _client_threads([job(j) for j in range(len(idx))])
    return time.perf_counter() - t0, got, lat


def _front_door(router):
    import threading
    from http.server import ThreadingHTTPServer
    from mxnet_tpu_torch.tools.mxfleet import make_front_handler
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_front_handler(router))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, "http://127.0.0.1:%d" % httpd.server_port


def _raw_predict(url, model, req):
    """One npz POST to a front door: (status, headers, body)."""
    import http.client
    from mxnet_tpu_torch.serving.fleet import encode_arrays
    host, port = url.split("://", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=FLEET_TIMEOUT_S)
    try:
        conn.request("POST", "/v1/predict", body=encode_arrays(req),
                     headers={"Content-Type": "application/x-npz",
                              "X-MXTPU-Model": model})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def phase_fleet(torch, seed, smi):
    """The serving fleet on one card: ``launch_fleet`` spawns two
    ``mxfleet replica`` processes serving the full-width LM with fp8
    weights; traffic through the ``mxfleet serve`` front door, held bit
    for bit to in-process Predictors; a SIGKILL drill, a rolling swap,
    admission (429) and drain (503)."""
    import shutil
    import signal
    import threading
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.observability import percentile
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.serving import ModelServer, ServerBusy
    from mxnet_tpu_torch.serving.fleet import (FleetClient, ReplicaDead,
                                               fleet_ledger_path,
                                               launch_fleet)
    from mxnet_tpu_torch.observability.metrics import kernel_counters
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "chip_smoke_fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx_name = "gpu" if DEVICE == "cuda" else "cpu"
    ctx = mx.Context(ctx_name)
    model = "lm-fp8"
    S = FLEET_LM["seq_len"]

    # the checkpoint: symbol JSON and two seeded 0x112 params files
    sym = fleet_symbol()
    sym_path = os.path.join(work, "lm-symbol.json")
    sym.save(sym_path)
    paths = {}
    for tag, s in (("v1", seed + 31), ("v2", seed + 32)):
        paths[tag] = os.path.join(work, "lm-%s.params" % tag)
        mx.nd.save(paths[tag], {"arg:" + k: torch.from_numpy(v) for k, v
                                in fleet_params(sym, s).items()})
    spec_path = os.path.join(work, "fleet.json")
    with open(spec_path, "w") as f:
        json.dump({"models": [{"name": model, "symbol": sym_path,
                               "params": paths["v1"],
                               "input_shapes": {"data": [S],
                                                "softmax_label": [S]},
                               "buckets": list(FLEET_BUCKETS)}],
                   "version": "v1", "ctx": ctx_name}, f)
    reqs = fleet_requests(seed + 33, FLEET_REQUESTS)
    res = {"model": dict(FLEET_LM, quantize=FLEET_QUANTIZE,
                         buckets=list(FLEET_BUCKETS)),
           "requests": FLEET_REQUESTS,
           "sizes": [int(r["data"].shape[0]) for r in reqs]}

    # (1) the reference: in-process Predictors, their launches counted
    for c in (fa.flash_attention_forward, qz.quantized_matmul):
        c.launches = 0
    fa.flash_attention_forward.launches_by_dtype.update(float32=0,
                                                        bfloat16=0)
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    qz.quantized_matmul.launches_by_qdtype.update(int8=0, fp8_e4m3=0)
    t0 = time.perf_counter()
    ref1 = FleetReference(torch, sym_path, paths["v1"], ctx)
    refs1 = ref1.digests(reqs)
    res["reference_launches"] = kernel_counters()
    check_fleet_launches("the in-process Predictor",
                         res["reference_launches"])
    log("fleet reference: %d requests at every bucket they fit in %.2f s; "
        "launches %s" % (len(reqs), time.perf_counter() - t0,
                         json.dumps(res["reference_launches"])))

    # (2) yardstick: the same requests through one in-process ModelServer
    prev_q = os.environ.get("MXTPU_QUANTIZE")
    os.environ["MXTPU_QUANTIZE"] = FLEET_QUANTIZE
    try:
        srv = ModelServer()
        srv.add_model(model, sym_path, paths["v1"],
                      {"data": (S,), "softmax_label": (S,)},
                      buckets=FLEET_BUCKETS, ctx=ctx)
        wall, got, lat = _timed_jobs(
            lambda r: srv.predict(model, r, timeout=FLEET_TIMEOUT_S)[0],
            reqs, list(range(len(reqs))))
        srv.close()
    finally:
        if prev_q is None:
            del os.environ["MXTPU_QUANTIZE"]
        else:
            os.environ["MXTPU_QUANTIZE"] = prev_q
    check_fleet_outputs("in-process server", reqs, refs1, got, ref1)
    res["in_process"] = {"req_per_s": len(reqs) / wall,
                         "p50_ms": percentile(lat, 50),
                         "p99_ms": percentile(lat, 99)}
    log("fleet yardstick, one in-process ModelServer: %s"
        % json.dumps(res["in_process"]))

    # (3) the fleet: two replica processes, the front door, traffic;
    # the routers read the heartbeat bound from the environment
    env = {"MXTPU_QUANTIZE": FLEET_QUANTIZE}
    prev_hb = os.environ.get("MXTPU_FLEET_HB_TIMEOUT_S")
    os.environ["MXTPU_FLEET_HB_TIMEOUT_S"] = str(FLEET_HB_TIMEOUT_S)
    procs, routers, doors = [], [], []
    t0 = time.perf_counter()
    router = launch_fleet(spec_path, n_replicas=2,
                          directory=os.path.join(work, "fleet"),
                          ports=[_free_port(), _free_port()],
                          startup_timeout_s=300.0, extra_env=env)
    routers.append(router)
    procs.extend(r.proc for r in router._replicas.values())
    res["startup_s"] = time.perf_counter() - t0
    try:
        httpd, url = _front_door(router)
        doors.append(httpd)
        client = FleetClient([url], timeout=FLEET_TIMEOUT_S)
        wall, got, lat = _timed_jobs(
            lambda r: client.predict(model, r, n=r["data"].shape[0])[0],
            reqs, list(range(len(reqs))))
        res["matched_buckets"] = check_fleet_outputs(
            "fleet", reqs, refs1, got, ref1)
        res["fleet"] = {"req_per_s": len(reqs) / wall,
                        "p50_ms": percentile(lat, 50),
                        "p99_ms": percentile(lat, 99)}
        rstats = router.replica_stats()
        res["replica_launches"] = {i: st["kernel_launches"]
                                   for i, st in rstats.items()}
        # the caching allocator's bytes by process (nvidia-smi's per-
        # process rows may not name processes inside a container)
        res["cuda_memory"] = dict(
            {"chip_smoke": {"reserved": torch.cuda.memory_reserved(),
                            "max_allocated":
                                torch.cuda.max_memory_allocated()}
             if DEVICE == "cuda" else None},
            **{"replica%s" % i: st["cuda_memory"]
               for i, st in rstats.items()})
        for i, launches in res["replica_launches"].items():
            check_fleet_launches("replica %s" % i, launches)
        res["gpu_memory"] = [
            {"pid": pid, "used_memory": used,
             "role": "chip_smoke" if pid == str(os.getpid())
             else "replica" if pid in {str(p.pid) for p in procs}
             else "other"} for pid, used in gpu_memory_by_pid()]
        log("fleet: 2 replicas up in %.2f s; %s; outputs bitwise the "
            "in-process Predictor's (by bucket %s); replica launches %s"
            % (res["startup_s"], json.dumps(res["fleet"]),
               res["matched_buckets"], json.dumps(res["replica_launches"])))
        log("fleet GPU memory by process (nvidia-smi): %s; CUDA allocator "
            "bytes: %s" % (json.dumps(res["gpu_memory"]),
                           json.dumps(res["cuda_memory"])))

        # (4) failover: SIGKILL replica 1 while requests are in flight
        drill = list(range(FLEET_DRILL_REQUESTS))
        outcomes = [None] * len(drill)

        def drill_job(j):
            def run():
                r = reqs[drill[j]]
                try:
                    out = router.predict(model, r, n=r["data"].shape[0],
                                         timeout=FLEET_TIMEOUT_S)[0]
                    outcomes[j] = ("ok", _digest(out))
                except ReplicaDead as exc:
                    outcomes[j] = ("replica_dead", exc.to_dict())
            return run

        jobs = [drill_job(j) for j in range(len(drill))]
        threads = [threading.Thread(
            target=lambda k=k: [jobs[j]() for j in range(k, len(jobs),
                                                         CLIENTS)])
            for k in range(CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60.0
        while router.stats()["replicas"]["1"]["inflight"] == 0:
            if time.monotonic() > deadline:
                raise AssertionError("replica 1 never had a request in "
                                     "flight")
            time.sleep(0.005)
        victim = router._replicas[1].proc
        t_kill = time.perf_counter()
        os.kill(victim.pid, signal.SIGKILL)
        ledger_path = fleet_ledger_path(os.path.join(work, "fleet"))
        first_verdict = None
        while first_verdict is None:
            led = elastic.read_ledger(path=ledger_path)
            if led and int(led.get("generation", 0)) >= 1:
                first_verdict = led
            elif time.perf_counter() - t_kill > 30.0:
                raise AssertionError("no death verdict in the ledger")
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=2 * FLEET_TIMEOUT_S)
            if t.is_alive():
                raise AssertionError("a request hung past its timeout")
        if (first_verdict.get("generation"), first_verdict.get("reason"),
                first_verdict.get("members")) != (1, "replica_death", [0]):
            raise AssertionError("ledger after the kill: %s"
                                 % first_verdict)
        ok = [(drill[j], o[1]) for j, o in enumerate(outcomes)
              if o[0] == "ok"]
        dead = [o[1] for o in outcomes if o[0] == "replica_dead"]
        if len(ok) + len(dead) != len(drill):
            raise AssertionError("drill outcomes: %s" % outcomes)
        check_fleet_outputs("failover", reqs, refs1, ok, ref1)
        while router.stats()["replicas"]["1"]["state"] != "ready":
            if time.perf_counter() - t_kill > FLEET_RESPAWN_LIMIT_S:
                raise AssertionError("replica 1 not healthy %.0f s after "
                                     "the kill" % FLEET_RESPAWN_LIMIT_S)
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_kill
        procs.append(router._replicas[1].proc)
        rep1 = router._replicas[1].client
        st1 = rep1.stats()
        if st1["generation"] != 1 or st1["pid"] == victim.pid:
            raise AssertionError("respawned replica: generation %s pid %s"
                                 % (st1["generation"], st1["pid"]))
        again = [(i, _digest(rep1.predict(model, reqs[i],
                                          n=reqs[i]["data"].shape[0])[0]))
                 for i in range(4)]
        check_fleet_outputs("respawned replica", reqs, refs1, again, ref1)
        rs = router.stats()
        res["failover"] = {"completed": len(ok), "replica_dead": len(dead),
                           "router_retries": rs["retries"],
                           "deaths": rs["replicas"]["1"]["deaths"],
                           "verdict": first_verdict,
                           "generation_now": rs["generation"],
                           "respawn_s": respawn_s}
        log("fleet failover: %s" % json.dumps(res["failover"]))

        # (5) rolling swap to the second checkpoint
        swap_idx = list(range(FLEET_SWAP_REQUESTS))
        ref2 = FleetReference(torch, sym_path, paths["v2"], ctx)
        refs2 = {i: d for i, d in zip(swap_idx, ref2.digests(
            [reqs[i] for i in swap_idx]))}
        sw = client.swap(paths["v2"], version="v2")
        for i, r in sorted(sw["replicas"].items()):
            if "error" in r or r.get("lowerings") != 0 \
                    or r.get("version") != "v2":
                raise AssertionError("swap on replica %s: %s" % (i, r))
        skew = router.stats()["version_skew"]
        if skew != {"v2": [0, 1]}:
            raise AssertionError("version skew after the swap: %s" % skew)
        _, got, _ = _timed_jobs(
            lambda r: client.predict(model, r, n=r["data"].shape[0])[0],
            reqs, swap_idx)
        check_fleet_outputs("after the swap", reqs, refs2, got, ref2)
        res["swap"] = {"swap_pause_ms": sw["swap_pause_ms"],
                       "lowerings": {i: r["lowerings"] for i, r
                                     in sorted(sw["replicas"].items())},
                       "version_skew": skew}
        log("fleet swap: %s" % json.dumps(res["swap"]))

        # (6) admission: a 1-replica fleet with a queue bound of 2
        small = launch_fleet(spec_path, n_replicas=1,
                             directory=os.path.join(work, "fleet-small"),
                             ports=[_free_port()], max_queue=2,
                             startup_timeout_s=300.0, extra_env=env)
        routers.append(small)
        procs.extend(r.proc for r in small._replicas.values())
        small_door, small_url = _front_door(small)
        doors.append(small_door)
        burst = [None] * 8
        bthreads = [threading.Thread(target=lambda k=k: burst.__setitem__(
            k, _raw_predict(small_url, model, reqs[k]))) for k in range(8)]
        for t in bthreads:
            t.start()
        for t in bthreads:
            t.join(timeout=2 * FLEET_TIMEOUT_S)
            if t.is_alive():
                raise AssertionError("a burst request hung")
        codes = [b[0] for b in burst]
        busy = [b for b in burst if b[0] == 429]
        if not busy or set(codes) - {200, 429}:
            raise AssertionError("burst of 8 at queue bound 2: codes %s"
                                 % codes)
        for _status, headers, body in busy:
            doc = json.loads(body.decode())
            if "Retry-After" not in headers \
                    or doc.get("error") != "server_busy" \
                    or doc.get("limit") != 2:
                raise AssertionError("429 without Retry-After or a "
                                     "structured body: %s %s"
                                     % (headers, doc))
        res["admission"] = {"codes": codes,
                            "retry_after": busy[0][1]["Retry-After"],
                            "body": json.loads(busy[0][2].decode())}
        log("fleet admission: %s" % json.dumps(res["admission"]))

        # (7) drain: the front door answers 503
        router.drain(timeout=FLEET_TIMEOUT_S)
        try:
            client.predict(model, reqs[0], n=reqs[0]["data"].shape[0])
        except ServerBusy as exc:
            if exc.code != 503:
                raise
            res["drain"] = exc.to_dict()
        else:
            raise AssertionError("a drained fleet answered a request")
        log("fleet drain: %s" % json.dumps(res["drain"]))
    finally:
        for door in doors:
            door.shutdown()
            door.server_close()
        for r in routers:
            r.close(drain=False)
        if prev_hb is None:
            del os.environ["MXTPU_FLEET_HB_TIMEOUT_S"]
        else:
            os.environ["MXTPU_FLEET_HB_TIMEOUT_S"] = prev_hb
    left = []
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            left.append(p.pid)
    if left:
        raise AssertionError("replica processes left running: %s" % left)
    res["replica_pids"] = [p.pid for p in procs]
    log("fleet closed: no replica left of pids %s" % res["replica_pids"])
    log("fleet on %s: router %.2f req/s (p50 %.1f ms, p99 %.1f ms) "
        "against %.2f req/s in one in-process server; failovers %d "
        "(retries), respawn %.2f s, swap pause ms %s"
        % (smi, res["fleet"]["req_per_s"], res["fleet"]["p50_ms"],
           res["fleet"]["p99_ms"], res["in_process"]["req_per_s"],
           res["failover"]["router_retries"], res["failover"]["respawn_s"],
           res["swap"]["swap_pause_ms"]))
    return res


# ----------------------------------------------------------------------
# phase 5: flash-attention forward
# ----------------------------------------------------------------------
def _bf16_close(torch, got, want):
    """Max |got - want| and whether every element is within one
    bfloat16 ulp of ``want`` (2**-7 |want|, plus 1e-5 near zero): the
    kernel and the plain version both compute in float32 and round the
    output once, so a float32 difference can flip that rounding by one
    ulp, no more."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= want.float().abs() * 2.0 ** -7 + 1e-5).all())
    return float(d.max()), ok


def phase_flash_attention(torch, timer, seed):
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(seed + 3)
    B, H, D = TRAIN_BATCH, TRAIN["num_heads"], \
        TRAIN["dim"] // TRAIN["num_heads"]
    S = TRAIN["seq_len"]
    #: float32 o: the same float32 online softmax as the plain version,
    #: summed over 1024 keys in another order; lse (about 7 to 12) to
    #: float32 rounding of exp/log sums; bfloat16 o: one bfloat16 ulp
    tol_o, tol_lse = 2e-5, 1e-4
    cases = [(S, D, causal, dt) for dt in (torch.float32, torch.bfloat16)
             for causal in (True, False)]
    # both bodies at a ragged S, at their other head dims and at a short,
    # ragged, non-causal S
    for dt in (torch.float32, torch.bfloat16):
        cases += [(1000, D, True, dt), (S, 32, True, dt), (S, 128, True, dt),
                  (77, D, False, dt)]
    rows = []
    for s_len, D, causal, dtype in cases:
        q, k, v = [torch.from_numpy(rng.randn(B, H, s_len, D).astype(
            np.float32)).to(DEVICE, dtype) for _ in range(3)]
        scale = 1.0 / math.sqrt(D)
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                            scale=scale)
        ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal,
                                                      scale=scale)
        torch.cuda.synchronize()
        lse_err = float((lse - rl).abs().max())
        if dtype == torch.float32:
            err = float((o - ro).abs().max())
            ok = err <= tol_o
            # the FMA body has no atomics and a fixed order of every sum
            o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal,
                                                  scale=scale)
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(
                    "flash_attention S=%d D=%d causal=%s float32: two runs "
                    "differ" % (s_len, D, causal))
        else:
            err, ok = _bf16_close(torch, o, ro)
        if not (ok and lse_err <= tol_lse):
            raise AssertionError(
                "flash_attention S=%d D=%d causal=%s %s: max |kernel - "
                "plain| o %g, lse %g" % (s_len, D, causal, dtype, err,
                                         lse_err))
        pairs = s_len * (s_len + 1) // 2 if causal else s_len * s_len
        n_ops = 4 * B * H * pairs * D
        item = q.element_size()
        n_bytes = 4 * B * H * s_len * D * item + B * H * s_len * 4
        b_ms, b_by = bound_ms(n_bytes, n_ops, ops_rate(dtype))
        row = {"B": B, "H": H, "S": s_len, "D": D, "causal": causal,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tol": tol_o if dtype == torch.float32 else "1 bf16 ulp",
               "repeat_bitwise": dtype == torch.float32,
               "ms": timer(lambda: fa.flash_attention_forward(
                   q, k, v, causal=causal, scale=scale)),
               "plain_ms": timer(lambda: fa.flash_attention_forward_reference(
                   q, k, v, causal=causal, scale=scale)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, scale=scale)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "ops": n_ops}
        rows.append(row)
        log("flash_attention S=%-4d D=%-3d causal=%-5s %-8s err o=%.3g "
            "lse=%.3g kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f "
            "bound_ms=%.5f (%s)"
            % (s_len, D, causal, row["dtype"], err, lse_err, row["ms"],
               row["plain_ms"], row["library_ms"], b_ms, b_by))
    # Sq != Sk: q and k tiles that do not line up (checked, not timed)
    D = TRAIN["dim"] // TRAIN["num_heads"]
    for (sq, sk), causal, dtype in itertools.product(
            ((200, 77), (77, 200)), (True, False),
            (torch.float32, torch.bfloat16)):
        q = torch.from_numpy(rng.randn(B, H, sq, D).astype(np.float32)).to(
            DEVICE, dtype)
        k, v = [torch.from_numpy(rng.randn(B, H, sk, D).astype(
            np.float32)).to(DEVICE, dtype) for _ in range(2)]
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal)
        o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        lse_err = float((lse - rl).abs().max())
        if dtype == torch.float32:
            err = float((o - ro).abs().max())
            ok = err <= tol_o and torch.equal(o, o2) \
                and torch.equal(lse, lse2)
        else:
            err, ok = _bf16_close(torch, o, ro)
        if not (ok and lse_err <= tol_lse):
            raise AssertionError(
                "flash_attention Sq=%d Sk=%d D=%d causal=%s %s: max |kernel "
                "- plain| o %g, lse %g (or float32 runs differ)"
                % (sq, sk, D, causal, dtype, err, lse_err))
        log("flash_attention Sq=%d Sk=%d D=%d causal=%-5s %-8s err o=%.3g "
            "lse=%.3g" % (sq, sk, D, causal, str(dtype).replace("torch.", ""),
                          err, lse_err))
    return rows


# ----------------------------------------------------------------------
# phase 6: the fused optimizer sweep
# ----------------------------------------------------------------------
def train_param_shapes():
    from mxnet_tpu_torch.models import transformer as tf
    sym = tf.get_symbol(**TRAIN)
    S = TRAIN["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(TRAIN_BATCH, S),
                                   softmax_label=(TRAIN_BATCH, S))
    return {n: s for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


#: every body of the sweep, as phase 6 holds and times it: (row name,
#: optimizer, its arguments, buffers moved an element: every buffer the
#: body reads once, the weight and the states it changes written once)
SWEEP_BODIES = [
    ("sgd", "sgd", {}, 3),
    ("sgd_momentum", "sgd", {"momentum": 0.9}, 5),
    ("adam", "adam", {}, 7),
    ("nag", "nag", {"momentum": 0.9}, 5),
    ("adamw", "adamw", {}, 7),
    ("adagrad", "adagrad", {}, 5),
    ("rmsprop", "rmsprop", {}, 9),
    ("adadelta", "adadelta", {}, 7),
    ("test", "test", {}, 3),
]
SWEEP_N = 16 * 1024 * 1024


def _library_optimizer(torch, row, w, g):
    """One PyTorch optimizer step on the same buffer, fused where PyTorch
    has a fused kernel, else ``foreach`` (a timing yardstick: its formula
    may differ, its bytes do not; centered RMSprop with momentum keeps
    Graves' three states but adds eps after the square root).
    ``(step, name)``, or ``(None, None)`` where PyTorch has no
    counterpart (Test)."""
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    table = {
        "sgd": ("SGD", dict(lr=0.1)),
        "sgd_momentum": ("SGD", dict(lr=0.1, momentum=0.9)),
        "nag": ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
        "adam": ("Adam", dict(lr=0.01)),
        "adamw": ("AdamW", dict(lr=0.01)),
        "adagrad": ("Adagrad", dict(lr=0.01)),
        "rmsprop": ("RMSprop", dict(lr=0.002, alpha=0.95, eps=1e-4,
                                    momentum=0.9, centered=True)),
        "adadelta": ("Adadelta", dict(lr=1.0, rho=0.9, eps=1e-5)),
    }
    if row not in table:
        return None, None
    cls, kw = table[row]
    try:
        opt = getattr(torch.optim, cls)([p], fused=True, **kw)
        name = "torch.optim.%s(fused=True)" % cls
        opt.step()          # creates the state
    except (RuntimeError, TypeError, ValueError):
        opt = getattr(torch.optim, cls)([p], foreach=True, **kw)
        name = "torch.optim.%s(foreach=True)" % cls
        opt.step()
    return opt.step, name


def _sweep_inputs(torch, gen, kind, kw, n, offset=0, clip=None):
    """An optimizer and w, g and state vectors of ``n`` elements drawn on
    the card from the seeded generator ``gen`` (``offset`` > 0: views that
    start that many elements in, so the kernel takes its scalar path),
    states of the sizes each formula keeps (variances positive,
    RMSProp's n >= g^2)."""
    from mxnet_tpu_torch import optimizer as opt_mod
    opt = opt_mod.create(kind, rescale_grad=1.0 / (TRAIN_BATCH *
                                                    TRAIN["seq_len"]),
                         clip_gradient=clip, **kw)

    def vec(scale, positive=False):
        a = torch.randn(n + offset, generator=gen, device=DEVICE) * scale
        return (a.abs() if positive else a)[offset:]

    proto = opt.create_state_arrays((1,))
    n_state = 0 if proto is None else (
        len(proto) if isinstance(proto, tuple) else 1)
    w, g = vec(0.02), vec(1e-3 * TRAIN_BATCH * TRAIN["seq_len"])
    states = [vec(1e-4, positive=(i > 0 or kind in ("adagrad", "adadelta")))
              for i in range(n_state)]
    if kind == "rmsprop":
        states[0] = states[1] * states[1] + states[0].abs()
    return opt, w, g, states


def _sweep_check(torch, fo, opt, w, g, states, lr, wd, t):
    """The kernel twice from the same inputs against the plain version:
    ``(max |kernel - plain|, ulps, bitwise on repeat)``."""
    want_w, want_s = fo.sweep_reference(opt, w, g, states, lr, wd, t)
    runs = []
    for _ in range(2):
        ww, ss = w.clone(), [s.clone() for s in states]
        fo.sweep(opt, ww, g, ss, lr, wd, t)
        runs.append([ww] + ss)
    torch.cuda.synchronize()
    errs, ulps = [], []
    for got, want in zip(runs[0], [want_w] + want_s):
        if not bool(torch.isfinite(want).all()):
            raise AssertionError("fused sweep %s: non-finite plain result"
                                 % type(opt).__name__)
        errs.append(float((got - want).abs().max()))
        ulps.append(float(((got - want).abs()
                           / (want.abs() * 2.0 ** -23 + 1e-38)).max()))
    repeat = all(torch.equal(a, b) for a, b in zip(*runs))
    return max(errs), max(ulps), repeat


def phase_fused_opt(torch, timer, seed):
    """Every body of the sweep against its plain version, bit for bit and
    bitwise on repeat: at 16 M elements, at 4099 elements one element
    into their arrays (the scalar path), with and without clip_gradient
    (1e-3 clips about a third of the rescaled gradients), at t = 1 and
    t = 3; each body timed at 16 M elements; SGD with momentum on each
    bucket of the transformer LM."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 4)
    shapes = train_param_shapes()
    metas = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    sizes = [sum(int(np.prod(shapes[n])) for n in b)
             for b in fo.plan_buckets(metas)]
    checks = 0
    for row, kind, kw, _bufs in SWEEP_BODIES:
        for n, offset in ((SWEEP_N, 0), (4099, 1)):
            for clip in (None, 1e-3):
                for t in (1, 3):
                    opt, w, g, st = _sweep_inputs(torch, gen, kind, kw, n,
                                                  offset, clip)
                    err, ulp, repeat = _sweep_check(torch, fo, opt, w, g, st,
                                                    opt.lr, 1e-4, t)
                    if err != 0.0 or not repeat:
                        raise AssertionError(
                            "fused sweep %s n=%d offset=%d clip=%s t=%d: "
                            "max err %g (%g ulp) against the plain version, "
                            "repeat bitwise %s" % (row, n, offset, clip, t,
                                                   err, ulp, repeat))
                    checks += 1
    log("fused_opt: %d bodies x (16 M, 4099 at offset 1) x clip "
        "(None, 1e-3) x t (1, 3): %d cases bit for bit against the plain "
        "version and on repeat" % (len(SWEEP_BODIES), checks))
    cases = [(r, SWEEP_N) for r in SWEEP_BODIES]
    cases += [(SWEEP_BODIES[1], n) for n in sizes]
    rows = []
    for (row, kind, kw, bufs), n in cases:
        opt, w, g, states = _sweep_inputs(torch, gen, kind, kw, n)
        body = fo.sweep_body(opt)
        lr = opt.lr
        err, ulp, repeat = _sweep_check(torch, fo, opt, w, g, states, lr,
                                        0.0, 3)
        if err != 0.0 or not repeat:
            raise AssertionError("fused sweep %s n=%d: max err %g, repeat "
                                 "bitwise %s" % (row, n, err, repeat))
        n_bytes = bufs * 4 * n
        b_ms, b_by = bound_ms(n_bytes, 0)
        lib_step, lib_name = _library_optimizer(torch, row, w, g)
        r = {"optimizer": row, "body": body, "n": n, "mbytes": 4 * n / 2 ** 20,
             "max_abs_err": err, "max_ulp": ulp, "tol": "bitwise",
             "ms": timer(lambda: fo.sweep(opt, w, g, states, lr, 0.0, 3)),
             "plain_ms": timer(lambda: fo.sweep_reference(
                 opt, w, g, states, lr, 0.0, 3)),
             "library_ms": timer(lib_step) if lib_step else None,
             "library": lib_name,
             "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        rows.append(r)
        log("fused_opt %-12s n=%-9d (%.1f MB) bitwise; kernel_ms=%.4f "
            "plain_ms=%.4f library_ms=%s (%s) bound_ms=%.5f (%s)"
            % (row, n, r["mbytes"], r["ms"], r["plain_ms"],
               "%.4f" % r["library_ms"] if lib_step else "none", lib_name,
               b_ms, b_by))
    return rows, sizes


# ----------------------------------------------------------------------
# phase 7: training at full width
# ----------------------------------------------------------------------
def seeded_train_params(seed):
    """Random weights of the training graph, from ``seed`` with numpy:
    N(0, 0.02) matrices and embeddings, zero biases, unit LayerNorm."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in train_param_shapes().items():
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def train_batch(seed, batch=TRAIN_BATCH):
    rng = np.random.RandomState(seed + 5)
    shape = (batch, TRAIN["seq_len"])
    return {"data": rng.randint(0, TRAIN["vocab_size"], shape)
            .astype(np.float32),
            "softmax_label": rng.randint(0, TRAIN["vocab_size"], shape)
            .astype(np.float32)}


def plain_train(torch, params, batch, steps, momentum=None,
                checkpoint=False):
    """``steps`` plain training steps of the same LM, written here with
    no module of the port: autograd through softmax attention (scores
    masked with -1e30), a summed cross entropy, whose gradient is
    SoftmaxOutput's p - onehot, and a leafwise SGD with momentum, at the
    batch's sequence length.  ``params`` and ``momentum`` (None: zeros)
    are numpy arrays or tensors, left unchanged.  ``checkpoint``: each
    layer under ``torch.utils.checkpoint`` (the same operations again in
    the backward, so the same values; the memory of one layer's scores,
    for the long sequences of phase 23).  Returns the last step's softmax
    outputs, the parameters and the momentum."""
    F = torch.nn.functional
    E, H = TRAIN["dim"], TRAIN["num_heads"]
    D, S = E // H, batch["data"].shape[1]
    B = batch["data"].shape[0]
    rescale = 1.0 / (B * S)
    lr, mom = TRAIN_SGD["learning_rate"], TRAIN_SGD["momentum"]
    p = {k: torch.as_tensor(v, device=DEVICE).clone().requires_grad_()
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) if momentum is None
         else torch.as_tensor(momentum[k], device=DEVICE).clone()
         for k, v in p.items()}
    ids = torch.from_numpy(batch["data"]).to(DEVICE).long()
    label = torch.from_numpy(batch["softmax_label"]).to(DEVICE).long()
    keep = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()

    def layer(x, i):
        n = "layer%d_" % i
        h = F.layer_norm(x, (E,), p[n + "ln1_gamma"], p[n + "ln1_beta"])
        qkv = h @ p[n + "att_qkv_weight"].t() + p[n + "att_qkv_bias"]
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
                   for t in qkv.split(E, dim=-1))
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
        s = torch.where(keep, s, torch.full_like(s, -1e30))
        a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2) \
            .reshape(B, S, E)
        x = x + a @ p[n + "att_out_weight"].t() + p[n + "att_out_bias"]
        h = F.layer_norm(x, (E,), p[n + "ln2_gamma"], p[n + "ln2_beta"])
        h = torch.relu(h @ p[n + "ffn1_weight"].t() + p[n + "ffn1_bias"])
        return x + h @ p[n + "ffn2_weight"].t() + p[n + "ffn2_bias"]
    for _ in range(steps):
        x = p["tok_embed_weight"][ids] + p["pos_embed_weight"][None]
        for i in range(TRAIN["num_layers"]):
            if checkpoint:
                x = torch.utils.checkpoint.checkpoint(layer, x, i,
                                                      use_reentrant=False)
            else:
                x = layer(x, i)
        x = F.layer_norm(x, (E,), p["final_ln_gamma"], p["final_ln_beta"])
        logits = (x @ p["lm_head_weight"].t() + p["lm_head_bias"]) \
            .reshape(-1, TRAIN["vocab_size"])
        loss = F.cross_entropy(logits, label.reshape(-1), reduction="sum")
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k] = mom * m[k] - lr * (g * rescale)
                w += m[k]
    with torch.no_grad():
        probs = torch.softmax(logits, dim=-1)
    return probs.detach(), {k: v.detach() for k, v in p.items()}, m


def _f64(torch, state):
    """A numpy or tensor state dict (or None) in float64 on the card."""
    if state is None:
        return None
    return {k: torch.as_tensor(v, device=DEVICE).double()
            for k, v in state.items()}


def _diff(torch, o_a, p_a, o_b, p_b, before):
    """[max |o_a - o_b|, max |p_a - p_b| over every parameter]."""
    return [float((o_a.double() - o_b.double()).abs().max()),
            _param_err(torch, p_a, p_b, before)[0]]


def ulp_witness(torch, params, batch, steps):
    """How far the plain float32 trajectory moves from itself when every
    starting weight moves by one ulp: ``{steps: [outputs, parameters]}``
    after 1 step and after ``steps``.  Logged, not gated: it shows how
    much the trajectory amplifies a rounding-sized difference."""
    ulp = {k: np.nextafter(v, np.float32(np.inf)) for k, v in params.items()}
    got = {}
    for n in sorted({1, steps}):
        o, p, _m = plain_train(torch, params, batch, n)
        o_u, p_u, _m = plain_train(torch, ulp, batch, n)
        got[n] = _diff(torch, o_u, p_u, o, p, params)
    return got


def _param_err(torch, got, want, before):
    """Max |got - want| over every parameter, and the largest update
    ``want - before`` made (the scale the difference is judged on)."""
    err, upd = 0.0, 0.0
    for n, w in want.items():
        err = max(err, float((got[n] - w).abs().max()))
        upd = max(upd, float((w - torch.as_tensor(before[n], device=DEVICE))
                             .abs().max()))
    return err, upd


def run_trainer(torch, params, batch, steps, mode, compute_dtype=None,
                timed_steps=0, snapshots=False):
    """``steps`` steps of the port's ShardedTrainer on the GPU with
    ``MXTPU_FUSED_OPT=mode``; launch counts cover exactly these steps.
    Then ``timed_steps`` more, each ended by a synchronize, for the step
    time.  Returns the outputs of the last counted step, the parameters
    after it, a dict of counts and times, and (with ``snapshots``) each
    counted step's outputs, parameters and momentum."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.models import transformer as tf
    os.environ["MXTPU_FUSED_OPT"] = mode
    S = TRAIN["seq_len"]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (TRAIN_BATCH * S),
                              **TRAIN_SGD)
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**TRAIN), opt,
                                    ctx=torch.device(DEVICE),
                                    compute_dtype=compute_dtype)
    p = tf.params_from_numpy(params, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    aux = {}
    b = tr.shard_batch(batch)
    torch.cuda.synchronize()
    fa.flash_attention_forward.launches = 0
    fa.flash_attention_forward.launches_by_dtype.update(float32=0, bfloat16=0)
    fo.sweep.launches = 0
    t0 = time.perf_counter()
    trail = []          # (outputs, params after, momentum after) a step
    for _ in range(steps):
        p, st, aux, outs = tr.step(p, st, aux, b)
        if snapshots:
            trail.append((outs[0], {n: w.clone() for n, w in p.items()},
                          {n: m.clone() for n, m in st.items()}))
    torch.cuda.synchronize()
    info = {"mode": mode, "compute_dtype": str(compute_dtype or "float32"),
            "steps": steps, "first_steps_s": time.perf_counter() - t0,
            "launches": {"flash_attention": fa.flash_attention_forward.launches,
                         "fused_opt": fo.sweep.launches},
            "flash_attention_by_dtype":
                dict(fa.flash_attention_forward.launches_by_dtype),
            "buckets": len(fo.plan_buckets({n: p[n]
                                            for n in tr.param_names}))}
    out = outs[0]
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("trainer %s: non-finite outputs" % info)
    counted = {n: w.clone() for n, w in p.items()}
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            p, st, aux, _o = tr.step(p, st, aux, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        info["step_ms"] = float(np.median(times)) * 1e3
        info["step_ms_all"] = [t * 1e3 for t in times]
        info["tokens_per_s"] = TRAIN_BATCH * S / (info["step_ms"] / 1e3)
    return out, counted, info, trail


#: phase 7's precision gate: the port may come at most this many times as
#: far from the float64 steps as the plain float32 step does
PRECISION_FACTOR = 2.0


def precision_check(torch, what, batch, steps, before, mom, outs, p_after):
    """The port's outputs ``outs`` and parameters ``p_after`` after
    ``steps`` steps from ``before``/``mom``, against the plain steps from
    the same state in float32 and in float64.  Each reading is
    ``[max |diff| outputs, max |diff| parameters]``; ``ok`` when the
    port's distance from float64 is within ``PRECISION_FACTOR`` times
    the plain float32 step's, in both."""
    o32, p32, _m = plain_train(torch, before, batch, steps, mom)
    o64, p64, _m = plain_train(torch, _f64(torch, before), batch, steps,
                               _f64(torch, mom))
    got = {"what": what,
           "port_vs_plain32": _diff(torch, outs, p_after, o32, p32, before),
           "port_vs_plain64": _diff(torch, outs, p_after, o64, p64, before),
           "plain32_vs_plain64": _diff(torch, o32, p32, o64, p64, before),
           "largest_update": _param_err(torch, p_after, p64, before)[1]}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    return got


def phase_train(torch, seed, smi):
    log("train: float32 products in full float32: "
        "torch.backends.cuda.matmul.allow_tf32=%s, "
        "torch.backends.cudnn.allow_tf32=%s"
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    params = seeded_train_params(seed)
    batch = train_batch(seed, TRAIN_BATCH)
    steps = 3
    out_k, p_k, kern, trail = run_trainer(torch, params, batch, steps,
                                          "kernel", timed_steps=5,
                                          snapshots=True)
    n_layers = TRAIN["num_layers"]
    want = {"flash_attention": n_layers * steps,
            "fused_opt": kern["buckets"] * steps}
    if kern["launches"] != want or kern["flash_attention_by_dtype"] != {
            "float32": n_layers * steps, "bfloat16": 0}:
        raise AssertionError("float32 training launches %s (flash forward "
                             "by dtype %s), want %s (flash forward once a "
                             "layer a step, the FMA body; the sweep once a "
                             "bucket a step)" % (kern["launches"],
                                                 kern["flash_attention_by_dtype"],
                                                 want))
    # the same steps leafwise: bit for bit the same parameters
    _o, p_l, leaf, _t = run_trainer(torch, params, batch, steps, "")
    if leaf["launches"]["fused_opt"] != 0:
        raise AssertionError("leafwise run launched the sweep")
    diff = [n for n in p_k if not torch.equal(p_k[n], p_l[n])]
    if diff:
        raise AssertionError("fused-kernel and leafwise parameters differ "
                             "after %d steps: %s" % (steps, diff[:5]))
    del p_l, _o
    # Precision, against the same steps in float64: each step from the
    # port's state before it, and the three steps free-running from the
    # same weights.  The port must come no further from float64 than
    # PRECISION_FACTOR times the plain float32 step does, in the outputs
    # and in every parameter.  A fixed bound does not fit: SGD at lr 0.1
    # with momentum 0.9 amplifies rounding along the trajectory (a
    # one-ulp start grows about 1000x in the outputs over 3 steps; see
    # ulp_witness), and bias gradients that sum 8192 tokens with heavy
    # cancellation leave the plain float32 step itself about 1e-3 of the
    # largest update away from float64 after one step.
    checks = []
    before, mom = params, None
    for k, (outs, p_after, m_after) in enumerate(trail):
        checks.append(precision_check(torch, "step %d" % (k + 1), batch, 1,
                                      before, mom, outs, p_after))
        before, mom = p_after, m_after
    del trail
    checks.append(precision_check(torch, "%d free-running steps" % steps,
                                  batch, steps, params, None, out_k, p_k))
    del out_k, p_k
    ulp = ulp_witness(torch, params, batch, steps)
    torch.cuda.empty_cache()
    for c in checks:
        log("train precision %s: %s" % (c["what"], json.dumps(c)))
    log("train one-ulp start, plain float32 against itself [outputs, "
        "parameters] by steps: %s" % json.dumps(ulp))
    bad = [c["what"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(
            "float32 training %s: the port is more than %g times as far "
            "from the float64 steps as the plain float32 step (readings "
            "above)" % (", ".join(bad), PRECISION_FACTOR))
    out_b, _p, bf16, _t = run_trainer(torch, params, batch, steps, "kernel",
                                      compute_dtype="bfloat16", timed_steps=5)
    want_b = {"flash_attention": n_layers * steps,
              "fused_opt": bf16["buckets"] * steps}
    if bf16["launches"] != want_b or bf16["flash_attention_by_dtype"] != {
            "float32": 0, "bfloat16": n_layers * steps}:
        raise AssertionError("bfloat16 training launches %s (flash forward "
                             "by dtype %s), want %s, every flash forward "
                             "on the tensor-core body"
                             % (bf16["launches"],
                                bf16["flash_attention_by_dtype"], want_b))
    if out_b.dtype != torch.bfloat16:
        raise AssertionError("bfloat16 outputs came back %s" % out_b.dtype)
    del _p, out_b
    torch.cuda.empty_cache()
    for r in (kern, bf16):
        log("train %-8s MXTPU_FUSED_OPT=%s: %.3f ms/step (median of %d), "
            "%.1f tokens/s, launches in %d steps %s (%d buckets), flash "
            "forward by dtype %s; on %s"
            % (r["compute_dtype"], r["mode"], r["step_ms"],
               len(r["step_ms_all"]), r["tokens_per_s"], r["steps"],
               r["launches"], r["buckets"], r["flash_attention_by_dtype"],
               smi))
    log("train checks: fused kernel == leafwise bitwise over %d steps; "
        "precision within %g times the plain float32 step's, per step and "
        "free-running" % (steps, PRECISION_FACTOR))
    return {"float32": kern, "bfloat16": bf16, "leafwise": leaf,
            "precision": checks, "ulp_witness": ulp}


# ----------------------------------------------------------------------
# phase 9: ResNet-50 through ShardedTrainer at full width
# ----------------------------------------------------------------------
#: bench.py's image-classification configuration (bench.py:469-510):
#: ResNet-50 at 224 x 224, 1000 classes, 64 images, SGD lr 0.1,
#: momentum 0.9, wd 1e-4, rescale_grad 1/64
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_BATCH = 64
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
#: the batch of phase 9's float64 witness (float64 doubles the memory)
RESNET_WITNESS_BATCH = 8
#: phase 9's bfloat16 gates on the first step's softmax outputs, against
#: float32's: max |diff| (the outputs are about 1/1000 each), and the
#: norm of the difference over the norm of float32's own departure from
#: the uniform 1/1000 (a bfloat16 forward that lost its input, and gave
#: near-uniform outputs, reads about 1)
BF16_SOFTMAX_TOL = 1e-3
BF16_SOFTMAX_REL = 0.5
#: ResNet's BatchNorm epsilon (models/resnet.py)
RESNET_EPS = 2e-5


def resnet_symbol():
    import mxnet_tpu_torch as mx
    return mx.models.resnet.get_symbol(**RESNET)


def seeded_resnet(seed, batch):
    """Weights, aux and a batch of ResNet-50 from numpy: He-scaled
    convolutions, N(0, 0.01) classifier, zero biases and betas, unit
    gammas, zero moving means and unit moving variances; images N(0, 1),
    labels uniform over the classes."""
    sym = resnet_symbol()
    shape = (batch,) + RESNET["image_shape"]
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.RandomState(seed)
    params = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(s, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(s, np.float32)
        elif name == "fc1_weight":
            params[name] = (rng.randn(*s) * 0.01).astype(np.float32)
        else:
            params[name] = (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:])))\
                .astype(np.float32)
    aux = {n: (np.ones if n.endswith("moving_var") else np.zeros)(
        s, np.float32) for n, s in zip(sym.list_auxiliary_states(),
                                       aux_shapes)}
    data = {"data": rng.randn(*shape).astype(np.float32),
            "softmax_label": rng.randint(0, RESNET["num_classes"], batch)
            .astype(np.float32)}
    return params, aux, data


def op_shapes(sym, data_shape):
    """``{node id: [output shapes]}`` and ``{argument: shape}``, inferred
    op by op in graph order from the data's shape."""
    shapes, outs = {}, {}
    for node in sym._topo():
        if node.is_variable:
            if node.name == "data":
                shapes[(id(node), 0)] = tuple(data_shape)
            elif node.name == "softmax_label":
                shapes[(id(node), 0)] = (data_shape[0],)
            continue
        full, o, _aux = node.op.infer_shape(
            [shapes.get((id(c), ci)) for c, ci in node.inputs])
        for (c, ci), sh in zip(node.inputs, full):
            shapes[(id(c), ci)] = tuple(sh)
        outs[id(node)] = [tuple(sh) for sh in o]
        for i, sh in enumerate(o):
            shapes[(id(node), i)] = tuple(sh)
    args = {n.name: shapes[(id(n), 0)] for n in sym._topo() if n.is_variable}
    return outs, args


def step_flops(sym, data_shape):
    """Operations of one training step: 3 x the forward's convolutions
    and fully connected layers (2 a multiply-add; the backward computes
    the data and the weight gradients, each as many), from the graph's
    shapes."""
    outs, wshape = op_shapes(sym, data_shape)
    fwd = 0
    for node in sym._topo():
        if node.is_variable:
            continue
        w = node.inputs[1][0].name if len(node.inputs) > 1 else None
        if node.op.op_name == "Convolution":
            fwd += 2 * int(np.prod(outs[id(node)][0])) \
                * int(np.prod(wshape[w][1:]))
        elif node.op.op_name == "FullyConnected":
            fwd += 2 * data_shape[0] * int(np.prod(wshape[w]))
    return 3 * fwd


def resnet_step_flops(batch):
    """:func:`step_flops` of phase 9's ResNet-50 at ``batch``."""
    return step_flops(resnet_symbol(), (batch,) + RESNET["image_shape"])


def peak_reset(torch):
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(torch):
    """The most device memory allocated since :func:`peak_reset`."""
    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


def _five_counters():
    """Every hand kernel's launch counter (the five Pallas sites)."""
    from mxnet_tpu_torch import rtc as rtc_mod
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.kernels import quantize as qz
    return {"flash_decode": (fd.flash_decode_attention, "launches"),
            "quantized_matmul": (qz.quantized_matmul, "launches"),
            "flash_attention": (fa.flash_attention_forward, "launches"),
            "fused_opt": (fo.sweep, "launches"),
            "rtc": (rtc_mod, "launches")}


def reset_counts():
    from mxnet_tpu_torch.kernels import fused_opt as fo
    for obj, attr in _five_counters().values():
        setattr(obj, attr, 0)
    fo.sweep.launches_by_body.clear()


def read_counts():
    from mxnet_tpu_torch.kernels import fused_opt as fo
    out = {k: getattr(obj, attr) for k, (obj, attr) in
           _five_counters().items()}
    out["fused_opt_by_body"] = dict(fo.sweep.launches_by_body)
    return out


def run_resnet(torch, params, aux, data, steps, mode, opt_name="sgd",
               opt_kw=RESNET_SGD, compute_dtype=None, timed_steps=0,
               sym=None, remat=False, data_names=("data",)):
    """``steps`` steps of the port's ShardedTrainer on ``sym`` (default
    ResNet-50; inputs ``data_names`` and ``softmax_label``) with
    ``MXTPU_FUSED_OPT=mode``; the five kernels' launch
    counts, and the peak device memory, cover exactly these steps.  Then
    ``timed_steps`` more, each ended by a synchronize.  Returns the first
    step's softmax outputs, the parameters, aux and optimizer states
    after the counted steps (copies), and a dict of counts and times."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.model import params_from_numpy
    os.environ["MXTPU_FUSED_OPT"] = mode
    batch = data["data"].shape[0]
    opt = mx.optimizer.create(opt_name, rescale_grad=1.0 / batch, **opt_kw)
    tr = mx.parallel.ShardedTrainer(sym or resnet_symbol(), opt,
                                    ctx=torch.device(DEVICE),
                                    data_names=data_names,
                                    compute_dtype=compute_dtype, remat=remat)
    p, a = params_from_numpy(params, aux, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    b = tr.shard_batch(data)
    torch.cuda.synchronize()
    reset_counts()
    peak_reset(torch)
    first = None
    for _ in range(steps):
        p, st, a, outs = tr.step(p, st, a, b)
        if first is None:
            first = outs[0].float().clone()
    torch.cuda.synchronize()
    buckets = fo.plan_buckets({n: p[n] for n in tr.param_names})
    info = {"optimizer": opt_name, "mode": mode, "batch": batch,
            "compute_dtype": str(compute_dtype or "float32"),
            "steps": steps, "launches": read_counts(),
            "buckets": len(buckets), "remat": remat,
            "bucket_sizes": sorted((sum(p[n].numel() for n in bk)
                                    for bk in buckets), reverse=True),
            "peak_bytes": peak_bytes(torch)}
    p_out = {n: w.clone() for n, w in p.items()}
    a_out = {n: v.clone() for n, v in a.items()}
    s_out = {"%s/%d" % (n, i): v.clone() for n, s in st.items()
             for i, v in enumerate(s if isinstance(s, tuple) else (s,))}
    info["devices"] = sorted({str(v.device) for d in (p_out, a_out, s_out)
                              for v in d.values()} | {str(first.device)})
    for what, d in (("parameters", p_out), ("aux", a_out)):
        bad = [n for n, v in d.items() if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError("resnet %s: non-finite %s %s"
                                 % (info, what, bad[:5]))
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            p, st, a, _o = tr.step(p, st, a, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        info["step_ms"] = float(np.median(times)) * 1e3
        info["step_ms_all"] = [t * 1e3 for t in times]
        info["images_per_s"] = batch / (info["step_ms"] / 1e3)
    return first, p_out, a_out, s_out, info


def _want_sweep_only(info, body):
    """The counts of a run whose only hand kernel is the sweep: once a
    bucket a step, all on ``body``."""
    n = info["buckets"] * info["steps"]
    want = {"flash_decode": 0, "quantized_matmul": 0, "flash_attention": 0,
            "fused_opt": n, "rtc": 0, "fused_opt_by_body": {body: n}}
    if info["launches"] != want:
        raise AssertionError("resnet %s %s launches %s, want %s (the sweep "
                             "once a bucket a step, on body %d, and no "
                             "other kernel of the port)"
                             % (info["optimizer"], info["compute_dtype"],
                                info["launches"], want, body))


def plain_resnet_step(torch, params, data, dtype, stats=None):
    """One plain training step of the same ResNet-50, written here with
    no module of the port: F.conv2d, BatchNorm's formula on the batch's
    mean and biased variance, max and mean pooling, a summed cross
    entropy (whose gradient is SoftmaxOutput's p - onehot), and SGD with
    momentum from zero and weight decay on every parameter.  Returns the
    softmax outputs and the parameters after the step, in ``dtype``;
    ``stats`` (a dict) takes each BatchNorm's batch mean and biased
    variance by name."""
    F = torch.nn.functional
    batch = data["data"].shape[0]
    rescale = 1.0 / batch
    lr, mom, wd = (RESNET_SGD["learning_rate"], RESNET_SGD["momentum"],
                   RESNET_SGD["wd"])
    p = {k: torch.as_tensor(v, device=DEVICE, dtype=dtype).clone()
         .requires_grad_() for k, v in params.items()}
    x = torch.as_tensor(data["data"], device=DEVICE, dtype=dtype)
    label = torch.as_tensor(data["softmax_label"], device=DEVICE).long()

    def bn(h, name, fix_gamma=False):
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        if stats is not None:
            stats[name] = (mean.detach().reshape(-1),
                           var.detach().reshape(-1))
        y = (h - mean) / torch.sqrt(var + RESNET_EPS)
        if not fix_gamma:
            y = y * p[name + "_gamma"].reshape(1, -1, 1, 1)
        return y + p[name + "_beta"].reshape(1, -1, 1, 1)

    def conv(h, name, stride=1, pad=0):
        return F.conv2d(h, p[name + "_weight"], None, stride, pad)

    h = conv(bn(x, "bn_data", fix_gamma=True), "conv0", 2, 3)
    h = F.max_pool2d(torch.relu(bn(h, "bn0")), 3, 2, 1)
    for i, units in enumerate([3, 4, 6, 3]):
        for j in range(units):
            name = "stage%d_unit%d" % (i + 1, j + 1)
            stride = 2 if i > 0 and j == 0 else 1
            a1 = torch.relu(bn(h, name + "_bn1"))
            c = conv(a1, name + "_conv1")
            c = conv(torch.relu(bn(c, name + "_bn2")), name + "_conv2",
                     stride, 1)
            c = conv(torch.relu(bn(c, name + "_bn3")), name + "_conv3")
            h = c + (h if j > 0 else conv(a1, name + "_sc", stride))
    h = torch.relu(bn(h, "bn1")).mean(dim=(2, 3))
    logits = h @ p["fc1_weight"].t() + p["fc1_bias"]
    loss = F.cross_entropy(logits, label, reduction="sum")
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    with torch.no_grad():
        for w, g in zip(p.values(), grads):
            g = torch.zeros_like(w) if g is None else g
            w += mom * 0.0 - lr * (g * rescale + wd * w)
        probs = torch.softmax(logits, dim=-1)
    return probs.detach(), {k: v.detach() for k, v in p.items()}


def resnet_witness(torch, seed):
    """Phase 7's precision witness at a batch of 8: one float32 step of
    the port (the sweep) and one of the plain step, each against the
    plain step in float64: [max |diff| softmax outputs, max |diff| over
    every parameter]."""
    params, aux, data = seeded_resnet(seed + 9, RESNET_WITNESS_BATCH)
    outs, p_port, _a, _s, info = run_resnet(torch, params, aux, data, 1,
                                            "kernel")
    _want_sweep_only(info, 1)
    o32, p32 = plain_resnet_step(torch, params, data, torch.float32)
    o64, p64 = plain_resnet_step(torch, params, data, torch.float64)

    def diff(o, p):
        return [float((o.double() - o64).abs().max()),
                max(float((p[n].double() - p64[n]).abs().max())
                    for n in p64)]
    got = {"port_vs_plain64": diff(outs, p_port),
           "plain32_vs_plain64": diff(o32, p32),
           "port_vs_plain32": [float((outs - o32).abs().max()),
                               max(float((p_port[n] - p32[n]).abs().max())
                                   for n in p32)],
           "largest_update": max(float((p64[n] - torch.as_tensor(
               params[n], device=DEVICE, dtype=torch.float64)).abs().max())
               for n in p64)}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    got["launches"] = info["launches"]
    return got


class cudnn_deterministic:
    """cuDNN's deterministic algorithms and no autotuning inside the
    block (a bitwise gate between two runs needs them: cuDNN's default
    backward algorithms are not deterministic); the settings before it
    come back after."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = (self.cudnn.deterministic, self.cudnn.benchmark)
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.saved


def _cudnn_settings(torch):
    c = torch.backends.cudnn
    return ("cuDNN deterministic=%s benchmark=%s allow_tf32=%s; "
            "torch.backends.cuda.matmul.allow_tf32=%s"
            % (c.deterministic, c.benchmark, c.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32))


#: phase 9's gates of fused == leafwise: (optimizer, its arguments,
#: steps, timed steps); SGD is the main path's, NAG and RMSProp launch
#: two of the new bodies at full width
RESNET_GATES = (("sgd", RESNET_SGD, 3, 5),
                ("nag", RESNET_SGD, 1, 0),
                ("rmsprop", {"learning_rate": 0.002, "wd": 1e-4}, 1, 0))


def phase_resnet(torch, seed, smi):
    """ResNet-50 through ShardedTrainer at bench.py's full width: the
    main path (float32 and bfloat16) timed under cuDNN's defaults; then,
    under deterministic cuDNN, the sweep against leafwise updates bit for
    bit for SGD, NAG and RMSProp, and the float64 witness."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    params, aux, data = seeded_resnet(seed, RESNET_BATCH)
    steps = 3
    log("resnet main path: " + _cudnn_settings(torch))
    o_k, _p, _a, _s, kern = run_resnet(torch, params, aux, data, steps,
                                       "kernel", timed_steps=5)
    _want_sweep_only(kern, 1)
    del _p, _a, _s
    o_b, _p, _a, _s, bf16 = run_resnet(torch, params, aux, data, steps,
                                       "kernel", compute_dtype="bfloat16",
                                       timed_steps=5)
    _want_sweep_only(bf16, 1)
    del _p, _a, _s
    bf16_err = float((o_b - o_k).abs().max())
    spread = o_k - 1.0 / RESNET["num_classes"]
    bf16_rel = float((o_b - o_k).norm() / spread.norm())
    log("resnet bfloat16 compute: first-step softmax outputs within %.3g "
        "of float32's (gate %g), relative to float32's departure from "
        "uniform %.3g (gate %g); parameters finite after %d steps"
        % (bf16_err, BF16_SOFTMAX_TOL, bf16_rel, BF16_SOFTMAX_REL, steps))
    if not (bf16_err <= BF16_SOFTMAX_TOL and bf16_rel <= BF16_SOFTMAX_REL):
        raise AssertionError("resnet bfloat16 softmax outputs %g (relative "
                             "%g) from float32's" % (bf16_err, bf16_rel))
    gates = {}
    with cudnn_deterministic(torch):
        log("resnet gates: " + _cudnn_settings(torch))
        for name, kw, n_steps, timed in RESNET_GATES:
            got = {}
            for mode in ("kernel", ""):
                _o, p, a, st, info = run_resnet(
                    torch, params, aux, data, n_steps, mode, opt_name=name,
                    opt_kw=kw, timed_steps=timed if mode else 0)
                got[mode] = (p, a, st, info)
            info = got["kernel"][3]
            body = fo.sweep_body(mx.optimizer.create(name, **kw))
            _want_sweep_only(info, body)
            if got[""][3]["launches"]["fused_opt"] != 0:
                raise AssertionError("leafwise resnet %s run launched the "
                                     "sweep" % name)
            diff = [n for i in range(3) for n in got["kernel"][i]
                    if not torch.equal(got["kernel"][i][n], got[""][i][n])]
            if diff:
                raise AssertionError(
                    "resnet %s: fused-kernel and leafwise parameters, aux or "
                    "states differ after %d steps: %s"
                    % (name, n_steps, diff[:5]))
            gates[name] = info
            log("resnet %s: %d step(s) through the sweep (body %d) == "
                "leafwise bitwise (parameters, aux, states); launches %s"
                % (name, n_steps, body, info["launches"]))
            del got
        witness = resnet_witness(torch, seed)
    log("resnet precision, one float32 step at batch %d [softmax outputs, "
        "parameters]: %s" % (RESNET_WITNESS_BATCH, json.dumps(witness)))
    if not witness["ok"]:
        raise AssertionError("resnet float32 step: the port is more than %g "
                             "times as far from the float64 step as the "
                             "plain float32 step (readings above)"
                             % PRECISION_FACTOR)
    torch.cuda.empty_cache()
    flops = resnet_step_flops(RESNET_BATCH)
    for label, r in (("float32", kern), ("bfloat16", bf16),
                     ("float32, deterministic cuDNN", gates["sgd"])):
        rate = ops_rate(r["compute_dtype"])
        r["bound_ms"], r["bound_by"] = bound_ms(0, flops, rate)
        r["step_flops"] = flops
        log("resnet %s batch %d: %.3f ms/step (median of %d: %s), %.1f "
            "images/s; bound %.3f ms (%.3g TFLOP a step at %g TFLOP/s); "
            "sweep launches in %d steps %s (%d buckets); on %s"
            % (label, RESNET_BATCH, r["step_ms"], len(r["step_ms_all"]),
               ", ".join("%.2f" % t for t in r["step_ms_all"]),
               r["images_per_s"], r["bound_ms"], flops / 1e12, rate / 1e12,
               r["steps"], r["launches"]["fused_opt"], r["buckets"], smi))
    log("resnet checks: fused kernel == leafwise bitwise (parameters, aux "
        "and states) for %s; float64 witness within %g times the plain "
        "float32 step's"
        % (", ".join(g[0] for g in RESNET_GATES), PRECISION_FACTOR))
    return {"float32": kern, "bfloat16": bf16, "gates": gates,
            "witness": witness, "bf16_softmax_err": bf16_err,
            "bf16_softmax_rel": bf16_rel}


# ----------------------------------------------------------------------
# phase 10: Module.fit, as the image-classification example drives it
# ----------------------------------------------------------------------
MODULE_TRAIN_BATCHES = 8
MODULE_VAL_BATCHES = 2


def synthetic_image_batches(seed, n_batches, batch):
    """``example/image-classification/common.py:synthetic_iters``'
    formula, a batch at a time (its 1000 class prototypes of 3 x 224 x
    224 would take 1.2 GB): labels uniform over the classes, each image
    its class's prototype, U(-1, 1) drawn from a generator seeded by the
    class, plus 0.3 N(0, 1) noise; float32."""
    shape = RESNET["image_shape"]
    out = []
    for i in range(n_batches):
        rng = np.random.default_rng(seed * 1000 + i)
        y = rng.integers(0, RESNET["num_classes"], batch)
        protos = np.stack([np.random.default_rng(seed * 100003 + int(c))
                           .uniform(-1, 1, shape).astype(np.float32)
                           for c in y])
        x = protos + np.float32(0.3) * rng.standard_normal(
            (batch,) + shape, dtype=np.float32)
        out.append((x, y.astype(np.float32)))
    return out


def batch_iter(batches):
    """A DataIter over host batches made beforehand."""
    import mxnet_tpu_torch as mx
    batch = batches[0][0].shape[0]

    class _Iter(mx.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = batch
            self.cur = 0

        @property
        def provide_data(self):
            return [mx.io.DataDesc("data", batches[0][0].shape)]

        @property
        def provide_label(self):
            return [mx.io.DataDesc("softmax_label", (batch,))]

        def reset(self):
            self.cur = 0

        def next(self):
            if self.cur >= len(batches):
                raise StopIteration
            x, y = batches[self.cur]
            self.cur += 1
            return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                   [mx.nd.array(y, ctx=mx.cpu())], pad=0)
    return _Iter()


def module_fit(torch, seed, train, val, kvstore):
    """``Module.fit`` of ResNet-50 as ``common.fit`` drives it: Xavier
    (in, 2.34), SGD lr 0.1, momentum 0.9, wd 1e-4, ``eval_metric="acc"``,
    a Speedometer; the weights drawn after ``random.seed(seed)``.
    Returns the module and each batch's end time and training accuracy."""
    import mxnet_tpu_torch as mx
    kv = mx.kvstore.KVStore("local") if kvstore == "local" else kvstore
    mx.random.seed(seed)
    mod = mx.mod.Module(resnet_symbol())
    seen = []

    def clock(param):
        seen.append((time.perf_counter(), param.eval_metric.get()[1]))
    mod.fit(batch_iter(train), eval_data=batch_iter(val) if val else None,
            eval_metric="acc", kvstore=kv, optimizer="sgd",
            optimizer_params=RESNET_SGD,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=1,
            batch_end_callback=[clock,
                                mx.callback.Speedometer(RESNET_BATCH, 50)])
    torch.cuda.synchronize()
    return mod, seen


def phase_module(torch, seed, smi):
    """Module.fit on ResNet-50 at batch 64 on the current context, timed
    under cuDNN's defaults; the two update routes compared under
    deterministic cuDNN."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import model as model_mod
    log("module fit: " + _cudnn_settings(torch))
    t0 = time.perf_counter()
    train = synthetic_image_batches(seed, MODULE_TRAIN_BATCHES, RESNET_BATCH)
    val = synthetic_image_batches(seed + 1, MODULE_VAL_BATCHES,
                                  RESNET_BATCH)
    data_s = time.perf_counter() - t0
    reset_counts()
    mod, seen = module_fit(torch, seed, train, val, "local")
    counts = read_counts()
    ex = mod._exec_group.execs[0]
    arg, aux = mod.get_params()
    want_dev = torch.device("cuda", 0) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    if ex._device != want_dev or any(v.data.device != want_dev
                                     for v in arg.values()):
        raise AssertionError("Module.fit ran on %s, not %s"
                             % (ex._device, want_dev))
    if not mod._update_on_kvstore:
        raise AssertionError("a KVStore object must update on the store")
    accs = [a for _t, a in seen]
    if len(seen) != MODULE_TRAIN_BATCHES or not all(
            math.isfinite(a) for a in accs):
        raise AssertionError("Module.fit training accuracy %s" % accs)
    (vname, vacc), = mod.score(batch_iter(val), "acc")
    span = seen[-1][0] - seen[0][0]
    ips = (len(seen) - 1) * RESNET_BATCH / span
    if any(counts[k] for k in counts if k != "fused_opt_by_body") \
            or counts["fused_opt_by_body"]:
        raise AssertionError("Module.fit launched hand kernels %s: neither "
                             "of its update routes runs the sweep" % counts)
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_ckpt", "resnet50")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mod.save_checkpoint(prefix, 1)
    _sym, arg2, aux2 = model_mod.load_checkpoint(prefix, 1)
    for want, got in ((arg, arg2), (aux, aux2)):
        if set(want) != set(got) or any(
                not torch.equal(want[n].data.cpu(), got[n].data.cpu())
                for n in want):
            raise AssertionError("checkpoint round trip changed arrays")
    for f in (prefix + "-symbol.json", prefix + "-0001.params"):
        os.remove(f)
    # the two update routes from the same weights over the same 2 batches
    routes = {}
    with cudnn_deterministic(torch):
        for kv in ("local", None):
            m, _s = module_fit(torch, seed, train[:2], None, kv)
            routes[kv] = {n: v.data.clone()
                          for n, v in m.get_params()[0].items()}
            del m
    route_err = max(float((routes["local"][n] - routes[None][n]).abs().max())
                    for n in routes[None])
    if not route_err <= 1e-5:
        raise AssertionError("Module.fit: the fused step (kvstore=None) is "
                             "%g from the kvstore route after 2 steps"
                             % route_err)
    info = {"images_per_s": ips, "batches": len(seen),
            "batch": RESNET_BATCH, "train_accuracy": accs[-1],
            "val_" + vname: vacc, "device": str(ex._device),
            "update_on_kvstore": True, "launches": counts,
            "route_max_abs_diff": route_err, "data_s": data_s}
    log("module: Module.fit ResNet-50 on %s, kvstore local (update on the "
        "store), %d batches of %d: %.1f images/s (batches 2-%d); train "
        "accuracy %.4f, validation %.4f; checkpoint round trip bitwise; "
        "fused step (kvstore=None) within %.3g of the store's route after "
        "2 steps; hand-kernel launches %s; data made in %.2f s; on %s"
        % (ex._device, len(seen), RESNET_BATCH, ips, len(seen), accs[-1],
           vacc, route_err, counts, data_s, smi))
    torch.cuda.empty_cache()
    return info


# ----------------------------------------------------------------------
# phase 11: the image feed
# ----------------------------------------------------------------------
#: phase 11's records: 64 x 12 raw-pixel images of 3 x 224 x 224 uint8
#: (115.6 MB), labels i % 1000, written as bench.py:837-845 writes them
FEED_BATCHES = 12
FEED_THREADS = 4
FEED_PREFETCH = 3
#: ShardedTrainer steps over one epoch of the records; steps 3-12 timed
FEED_STEPS = 12
FEED_TIMED_FROM = 2
#: the gates' steps (prefetch on == off) and Module.fit's gate batches
FEED_GATE_STEPS = 3
FIT_GATE_BATCHES = 2
#: phase 11's JPEG records: 256 images of 256 x 256, cropped to 224
JPEG_RECORDS = 256
JPEG_SIZE = 256
#: ImageNet's per-channel mean and a scale for the float32 feed
FEED_MEAN = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939)
FEED_SCALE = 1.0 / 58.4


def feed_dir(*parts):
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_feed", *parts)
    os.makedirs(d, exist_ok=True)
    return d


def write_raw_records(path, n, seed):
    """``n`` raw-pixel records (``im2rec --pack-raw``'s layout), each its
    own seeded 3 x 224 x 224 uint8 image, label ``i % 1000``, with the
    port's recordio."""
    from mxnet_tpu_torch import recordio as rio
    rng = np.random.RandomState(seed)
    w = rio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.randint(0, 256, RESNET["image_shape"], np.uint8)
        w.write(rio.pack(rio.IRHeader(0, float(i % 1000), i, 0),
                         img.tobytes()))
    w.close()


_MAGIC = 0xced7230a


def numpy_read_records(path, n):
    """The first ``n`` records of a raw-pixel file read with numpy and
    struct alone (no module of the port): the dmlc framing (continuation
    parts joined by the magic), the 24-byte image-record header, CHW
    uint8 pixels.  Returns (images, labels)."""
    import struct
    imgs, labels = [], []
    with open(path, "rb") as f:
        while len(imgs) < n:
            parts = []
            while True:
                magic, lrec = struct.unpack("<II", f.read(8))
                if magic != _MAGIC:
                    raise AssertionError("bad RecordIO magic in %s" % path)
                length = lrec & ((1 << 29) - 1)
                parts.append(f.read(length))
                f.read((4 - (length & 3)) & 3)
                if lrec >> 29 in (0, 3):
                    break
            rec = struct.pack("<I", _MAGIC).join(parts)
            flag, label = struct.unpack("<If", rec[:8])
            if flag:
                raise AssertionError("a raw record with a label array")
            imgs.append(np.frombuffer(rec[24:], np.uint8)
                        .reshape(RESNET["image_shape"]))
            labels.append(label)
    return np.stack(imgs), np.asarray(labels, np.float32)


def record_iter(path, **kw):
    import mxnet_tpu_torch as mx
    args = dict(path_imgrec=path, data_shape=RESNET["image_shape"],
                batch_size=RESNET_BATCH, preprocess_threads=FEED_THREADS,
                prefetch_buffer=FEED_PREFETCH)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def time_feed(it):
    """Images/s of one epoch of ``it`` after a warm epoch (host clock)."""
    for _ in it:
        pass
    it.reset()
    t0 = time.perf_counter()
    n = 0
    for b in it:
        n += RESNET_BATCH - (b.pad or 0)
    return n / (time.perf_counter() - t0)


def phase_feed_alone(torch, path, seed):
    """The feed without the card: the first uint8 batch against a numpy
    read of the records; uint8 and float32 (mean, scale) images/s."""
    from mxnet_tpu_torch import libinfo
    lib = libinfo.find_lib()
    if lib is None:
        raise AssertionError("lib/libmxtpu.so did not build from src/ "
                             "(make, g++): the native reader and the "
                             "decode pool are the feed's")
    want_x, want_y = numpy_read_records(path, RESNET_BATCH)
    it = record_iter(path, dtype="uint8")
    b = next(it)
    if not (np.array_equal(b.data[0].asnumpy(), want_x)
            and np.array_equal(b.label[0].asnumpy(), want_y)):
        raise AssertionError("the first uint8 batch differs from a numpy "
                             "read of the same records")
    it.reset()
    u8 = time_feed(it)
    routes = dict(it.decode_routes)
    f32 = time_feed(record_iter(path, scale=FEED_SCALE, **FEED_MEAN))
    info = {"uint8_images_per_s": u8, "float32_images_per_s": f32,
            "cpu_count": os.cpu_count(), "threads": FEED_THREADS,
            "prefetch_buffer": FEED_PREFETCH, "reader": "native "
            "(lib/libmxtpu.so)", "decode_routes": routes,
            "engine": type(it._engine).__name__}
    log("feed alone: %d records of %s uint8 (%.1f MB), %s reader, %s "
        "decode pool of %d threads, routes %s, os.cpu_count() %d: uint8 "
        "%.1f images/s, float32 (mean, scale) %.1f images/s; first batch "
        "bitwise a numpy read of the records"
        % (RESNET_BATCH * FEED_BATCHES, "x".join(map(str,
                                                     RESNET["image_shape"])),
           os.path.getsize(path) / 1e6, info["reader"], info["engine"],
           FEED_THREADS, routes, os.cpu_count(), u8, f32))
    return info


def _jpeg_encoder():
    """The name of the encoder the port's ``image.imencode`` uses, or
    None."""
    from mxnet_tpu_torch import image
    if image._cv2 is not None:
        return "cv2"
    if image._PILImage is not None:
        return "PIL"
    return None


def _native_jpeg(lib, enc):
    """Does the library decode JPEG (the Makefile links libjpeg only where
    jpeglib.h is found; otherwise MXTPUDecodeAugment is a stub)?"""
    import ctypes
    out = np.empty((3, 8, 8), np.uint8)
    return lib.MXTPUDecodeAugment(
        enc, len(enc), 3, 8, 8, 0, 0, 1.0, 1.0, 0, None,
        out.ctypes.data_as(ctypes.c_void_p), None, 1.0) == 0


def phase_feed_jpeg(torch, seed):
    """JPEG records decoded with rand_crop and rand_mirror to 224: images/s
    at 1, 4 and os.cpu_count() threads; 1 and 4 threads bitwise equal."""
    from mxnet_tpu_torch import image, libinfo
    from mxnet_tpu_torch import recordio as rio
    enc_name = _jpeg_encoder()
    if enc_name is None:
        log("feed JPEG: not run: no JPEG encoder is installed (neither cv2 "
            "nor PIL)")
        return {"skipped": "no encoder (cv2, PIL)"}
    native = _native_jpeg(libinfo.find_lib(),
                          image.imencode(np.zeros((8, 8, 3), np.uint8)))
    if not native:
        log("feed JPEG: lib/libmxtpu.so has no libjpeg decoder (make found "
            "no jpeglib.h and built its stub), so "
            "the records go through the Python route (%s decode + "
            "image.augment), timed below" % enc_name)
    path = os.path.join(feed_dir(), "jpeg.rec")
    rng = np.random.RandomState(seed + 11)
    w = rio.MXRecordIO(path, "w")
    cells = JPEG_SIZE // 8
    for i in range(JPEG_RECORDS):
        base = rng.randint(0, 256, (cells, cells, 3)).astype(np.float32)
        img = np.repeat(np.repeat(base, 8, 0), 8, 1) \
            + rng.randn(JPEG_SIZE, JPEG_SIZE, 3) * 8
        img = np.clip(img, 0, 255).astype(np.uint8)
        w.write(rio.pack(rio.IRHeader(0, float(i % 1000), i, 0),
                         image.imencode(img, quality=90)))
    w.close()
    kw = dict(dtype="uint8", rand_crop=True, rand_mirror=True, seed=seed)
    rates, epochs = {}, {}
    for threads in sorted({1, 4, os.cpu_count() or 1}):
        it = record_iter(path, preprocess_threads=threads, **kw)
        epochs[threads] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                           for b in it]
        it.reset()
        rates[threads] = time_feed(it)
        route = {k: v for k, v in it.decode_routes.items() if v}
    for (a, la), (b, lb) in zip(epochs[1], epochs[4]):
        if not (np.array_equal(a, b) and np.array_equal(la, lb)):
            raise AssertionError("JPEG batches at 1 and 4 decode threads "
                                 "differ")
    if len(epochs[1]) != len(epochs[4]):
        raise AssertionError("JPEG epochs at 1 and 4 threads differ in "
                             "length")
    info = {"route": "native" if native else "python (%s)" % enc_name,
            "decode_routes": route, "encoder": enc_name,
            "images_per_s_by_threads": rates, "records": JPEG_RECORDS,
            "size": JPEG_SIZE, "mb": os.path.getsize(path) / 1e6}
    log("feed JPEG: %d records of %dx%d (%.1f MB, encoded by %s), decoded "
        "by the %s route with rand_crop and rand_mirror to 224: %s "
        "images/s by decode threads; 1 and 4 threads bitwise equal"
        % (JPEG_RECORDS, JPEG_SIZE, JPEG_SIZE, info["mb"], enc_name,
           info["route"], ", ".join("%d: %.1f" % kv
                                    for kv in sorted(rates.items()))))
    return info


def run_feed(torch, path, params, aux, steps, prefetch, compute_dtype=None,
             timed_from=None):
    """``steps`` ShardedTrainer steps of ResNet-50 over the records'
    uint8 batches, through ``prefetch_feed`` (or, with ``prefetch``
    False, ``shard_batch`` on the loop); launch counts cover exactly
    these steps.  Returns the parameters, aux and states after them, the
    first batch as placed, and a dict of counts, times and devices."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.model import params_from_numpy
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / RESNET_BATCH,
                              **RESNET_SGD)
    tr = mx.parallel.ShardedTrainer(resnet_symbol(), opt,
                                    ctx=torch.device(DEVICE),
                                    compute_dtype=compute_dtype)
    p, a = params_from_numpy(params, aux, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    it = record_iter(path, dtype="uint8")
    host = ({"data": b.data[0], "softmax_label": b.label[0]} for b in it)
    torch.cuda.synchronize()
    reset_counts()
    if prefetch:
        feed = tr.prefetch_feed(host, prefetch=True)
    else:
        feed = (tr.shard_batch(b) for b in host)
    first, wait, t0 = None, 0.0, None
    for step in range(steps):
        tw = time.perf_counter()
        batch = next(feed)
        if t0 is not None:
            wait += time.perf_counter() - tw
        if first is None:
            first = {k: v.clone() for k, v in batch.items()}
            first["widened"] = tr._batch_to_compute(batch, p)["data"]
        p, st, a, _o = tr.step(p, st, a, batch)
        if timed_from is not None and step + 1 == timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 if t0 is not None else None
    if prefetch:
        feed.close()
    info = {"compute_dtype": str(compute_dtype or "float32"),
            "prefetch": prefetch, "steps": steps,
            "launches": read_counts(), "optimizer": "sgd",
            "buckets": len(fo.plan_buckets({n: p[n]
                                            for n in tr.param_names})),
            "devices": sorted({str(v.device) for d in (p, a, first)
                               for v in d.values()}
                              | {str(v.device) for s in st.values()
                                 for v in (s if isinstance(s, tuple)
                                           else (s,))})}
    if wall is not None:
        n = steps - timed_from
        info.update(images_per_s=n * RESNET_BATCH / wall,
                    step_ms=wall / n * 1e3, timed_steps=n,
                    data_wait_ms=wait * 1e3, data_wait_share=wait / wall)
    s_out = {"%s/%d" % (n, i): v.clone() for n, s in st.items()
             for i, v in enumerate(s if isinstance(s, tuple) else (s,))}
    return ({n: w.clone() for n, w in p.items()},
            {n: v.clone() for n, v in a.items()}, s_out, first, info)


def run_beside_feed(torch, path, params, aux, compute_dtype, steps=10):
    """Images/s of the device-resident step (one batch placed once, as
    phase 9 trains) alone, then while an ``ImageRecordIter`` decodes
    epochs of the records on its threads and its batches are dropped:
    what the feed's host work costs the step when nothing waits for
    data.  Returns (alone, beside)."""
    import threading
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import params_from_numpy
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / RESNET_BATCH,
                              **RESNET_SGD)
    tr = mx.parallel.ShardedTrainer(resnet_symbol(), opt,
                                    ctx=torch.device(DEVICE),
                                    compute_dtype=compute_dtype)
    p, a = params_from_numpy(params, aux, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    x, y = numpy_read_records(path, RESNET_BATCH)
    b = tr.shard_batch({"data": x, "softmax_label": y})
    stop = threading.Event()

    def drain():
        it = record_iter(path, dtype="uint8")
        while not stop.is_set():
            for _ in it:
                if stop.is_set():
                    break
            it.reset()
    rates = []
    for beside in (False, True):
        thread = threading.Thread(target=drain, daemon=True) if beside \
            else None
        if thread is not None:
            thread.start()
        for _ in range(2):
            p, st, a, _o = tr.step(p, st, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            p, st, a, _o = tr.step(p, st, a, b)
        torch.cuda.synchronize()
        rates.append(steps * RESNET_BATCH / (time.perf_counter() - t0))
        if thread is not None:
            stop.set()
            thread.join(timeout=60)
    return tuple(rates)


def _want_cuda0(torch, what, devices):
    want = "cuda:0" if DEVICE == "cuda" else DEVICE
    if devices != [want]:
        raise AssertionError("%s: tensors on %s, not %s"
                             % (what, devices, want))


def phase_feed_trainer(torch, path, seed, smi, yardstick):
    """ResNet-50 through ShardedTrainer fed by prefetch_feed over the
    records, float32 and bfloat16 (cuDNN's defaults), beside phase 9's
    device-resident rate; then, under deterministic cuDNN, prefetch on ==
    off bitwise and the first batch widened bitwise."""
    params, aux, _ = seeded_resnet(seed, RESNET_BATCH)
    runs = {}
    for cdt in (None, "bfloat16"):
        _p, _a, _s, _f, info = run_feed(torch, path, params, aux,
                                        FEED_STEPS, True, cdt,
                                        timed_from=FEED_TIMED_FROM)
        del _p, _a, _s, _f
        _want_sweep_only(info, 1)
        _want_cuda0(torch, "feed %s" % info["compute_dtype"],
                    info["devices"])
        runs[info["compute_dtype"]] = info
        ys = yardstick[info["compute_dtype"]]
        log("feed trainer %s: ResNet-50 batch %d from the records, steps "
            "%d-%d: %.3f ms/step, %.1f images/s against phase 9's "
            "device-resident %.1f (%.1f%%); data_wait %.2f ms of %.1f "
            "(%.2f%% of the steps' wall); sweep launches %s in %d steps "
            "(%d buckets); on %s"
            % (info["compute_dtype"], RESNET_BATCH, FEED_TIMED_FROM + 1,
               FEED_STEPS, info["step_ms"], info["images_per_s"], ys,
               100.0 * info["images_per_s"] / ys, info["data_wait_ms"],
               info["step_ms"] * info["timed_steps"],
               100.0 * info["data_wait_share"],
               info["launches"]["fused_opt_by_body"], FEED_STEPS,
               info["buckets"], smi))
        alone, beside = run_beside_feed(torch, path, params, aux, cdt)
        info.update(resident_images_per_s=alone,
                    resident_beside_feed_images_per_s=beside)
        log("feed trainer %s: the device-resident step %.1f images/s "
            "alone, %.1f (%.1f%%) while the feed decodes beside it and its "
            "batches are dropped"
            % (info["compute_dtype"], alone, beside, 100.0 * beside / alone))
    with cudnn_deterministic(torch):
        got = {}
        for prefetch in (True, False):
            got[prefetch] = run_feed(torch, path, params, aux,
                                     FEED_GATE_STEPS, prefetch)
        on, off = got[True], got[False]
        _want_sweep_only(on[4], 1)
        diff = [n for i in range(3) for n in on[i]
                if not torch.equal(on[i][n], off[i][n])]
        if diff:
            raise AssertionError("feed: %d steps with prefetch on and off "
                                 "differ in %s" % (FEED_GATE_STEPS, diff[:5]))
        want_x, want_y = numpy_read_records(path, RESNET_BATCH)
        first = on[3]
        host_f32 = next(record_iter(path)).data[0].asnumpy()
        if not (np.array_equal(first["data"].cpu().numpy(), want_x)
                and np.array_equal(first["softmax_label"].cpu().numpy(),
                                   want_y)
                and first["data"].dtype == torch.uint8
                and np.array_equal(host_f32, want_x.astype(np.float32))
                and first["widened"].dtype == torch.float32
                and torch.equal(first["widened"].cpu(),
                                torch.from_numpy(host_f32))):
            raise AssertionError("feed: the first batch on the card is not "
                                 "the host batch (uint8), widened bitwise "
                                 "to the float32 iterator's output")
        _want_cuda0(torch, "feed gate", on[4]["devices"])
        gate = on[4]
        del got, on, off
    log("feed trainer gates (deterministic cuDNN): %d steps with prefetch "
        "on == off bitwise (parameters, aux, states); the first batch on "
        "the card is the host's uint8 batch, its widening bitwise the "
        "float32 iterator's output; every tensor on %s"
        % (FEED_GATE_STEPS, gate["devices"][0]))
    torch.cuda.empty_cache()
    return {"float32": runs["float32"], "bfloat16": runs["bfloat16"],
            "gate": gate}


def _subset_records(src, dst, n):
    from mxnet_tpu_torch import recordio as rio
    r, w = rio.MXRecordIO(src, "r"), rio.MXRecordIO(dst, "w")
    for _ in range(n):
        w.write(r.read())
    w.close()
    r.close()


def run_train_imagenet(torch, seed, data_dir, prefix, prefetch,
                       network="resnet-50"):
    """The port's ``example/image-classification-torch/train_imagenet.py``
    on the records (``--network network --data-dtype uint8 --batch-size
    64``, one epoch, ``MXTPU_PREFETCH`` on or off), in this process; its
    Speedometer is wrapped to note each batch's end and the module.
    Returns (module, batch end times)."""
    import runpy
    import mxnet_tpu_torch as mx
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "example", "image-classification-torch",
                          "train_imagenet.py")
    ends, mods = [], []
    speedometer = mx.callback.Speedometer

    class Clock(speedometer):
        def __call__(self, param):
            ends.append(time.perf_counter())
            mods.append(param.locals["self"])
            super().__call__(param)
    argv, path = sys.argv, list(sys.path)
    env = os.environ.get("MXTPU_PREFETCH")
    os.environ["MXTPU_PREFETCH"] = "1" if prefetch else "0"
    sys.argv = [script, "--network", network,
                "--data-dir", data_dir, "--data-dtype", "uint8",
                "--batch-size", str(RESNET_BATCH), "--num-epochs", "1",
                "--data-nthreads", str(FEED_THREADS),
                "--model-prefix", prefix]
    sys.path.insert(0, os.path.dirname(script))
    sys.modules.pop("common", None)
    mx.callback.Speedometer = Clock
    mx.random.seed(seed)
    try:
        runpy.run_path(script, run_name="__main__")
        torch.cuda.synchronize()
    finally:
        mx.callback.Speedometer = speedometer
        sys.argv, sys.path[:] = argv, path
        sys.modules.pop("common", None)
        if env is None:
            os.environ.pop("MXTPU_PREFETCH", None)
        else:
            os.environ["MXTPU_PREFETCH"] = env
    return mods[-1], ends


def phase_feed_module(torch, path, seed, smi, yardstick):
    """Module.fit(prefetch=True) through the port's train_imagenet.py on
    the records (cuDNN's defaults), beside phase 10's rate; then, under
    deterministic cuDNN, 2 batches with prefetch on == off bitwise."""
    from mxnet_tpu_torch import model as model_mod
    ckpt = os.path.join(feed_dir("ckpt"), "resnet50")
    reset_counts()
    mod, ends = run_train_imagenet(torch, seed, os.path.dirname(path),
                                   ckpt, True)
    counts = read_counts()
    ex = mod._exec_group.execs[0]
    want_dev = torch.device("cuda", 0) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    arg, _aux = mod.get_params()
    if ex._device != want_dev or any(v.data.device != want_dev
                                     for v in arg.values()):
        raise AssertionError("train_imagenet.py ran on %s, not %s"
                             % (ex._device, want_dev))
    if len(ends) != FEED_BATCHES:
        raise AssertionError("train_imagenet.py ran %d batches, not %d"
                             % (len(ends), FEED_BATCHES))
    if any(counts[k] for k in counts if k != "fused_opt_by_body") \
            or counts["fused_opt_by_body"]:
        raise AssertionError("Module.fit launched hand kernels %s: neither "
                             "of its update routes runs the sweep" % counts)
    ips = (len(ends) - 1) * RESNET_BATCH / (ends[-1] - ends[0])
    gate_dir = feed_dir("gate")
    _subset_records(path, os.path.join(gate_dir, "train.rec"),
                    FIT_GATE_BATCHES * RESNET_BATCH)
    params = {}
    with cudnn_deterministic(torch):
        for prefetch in (True, False):
            prefix = os.path.join(gate_dir, "p%d" % prefetch)
            run_train_imagenet(torch, seed, gate_dir, prefix, prefetch)
            _s, a, x = model_mod.load_checkpoint(prefix, 1)
            params[prefetch] = dict(a, **{"aux:" + k: v
                                          for k, v in x.items()})
    diff = [n for n in params[True] if not torch.equal(
        params[True][n].data.cpu(), params[False][n].data.cpu())]
    if diff or set(params[True]) != set(params[False]):
        raise AssertionError("train_imagenet.py: %d batches with prefetch "
                             "on and off differ in %s"
                             % (FIT_GATE_BATCHES, diff[:5]))
    info = {"images_per_s": ips, "batches": len(ends),
            "batch": RESNET_BATCH, "device": str(ex._device),
            "launches": counts, "prefetch": True,
            "update_on_kvstore": bool(mod._update_on_kvstore)}
    log("feed module: train_imagenet.py (Module.fit, MXTPU_PREFETCH=1, "
        "--data-dtype uint8) on %s, %d batches of %d from the records: "
        "%.1f images/s (batches 2-%d) against phase 10's %.1f from host "
        "arrays made beforehand; no hand kernel launched; %d batches with "
        "prefetch on == off bitwise (deterministic cuDNN); on %s"
        % (ex._device, len(ends), RESNET_BATCH, ips, len(ends), yardstick,
           FIT_GATE_BATCHES, smi))
    torch.cuda.empty_cache()
    return info


def phase_feed(torch, seed, smi, resnet, module):
    """Phase 11: the records written, the feed alone, JPEG, then the two
    training routes on the records."""
    t0 = time.perf_counter()
    path = os.path.join(feed_dir("imagenet"), "train.rec")
    write_raw_records(path, RESNET_BATCH * FEED_BATCHES, seed + 23)
    write_s = time.perf_counter() - t0
    log("feed records: %s, %.1f MB in %.2f s"
        % (os.path.relpath(path), os.path.getsize(path) / 1e6, write_s))
    alone = phase_feed_alone(torch, path, seed)
    jpeg = phase_feed_jpeg(torch, seed)
    trainer = phase_feed_trainer(
        torch, path, seed, smi,
        {d: resnet[d]["images_per_s"] for d in ("float32", "bfloat16")})
    fit = phase_feed_module(torch, path, seed, smi, module["images_per_s"])
    return {"alone": alone, "jpeg": jpeg, "trainer": trainer,
            "module": fit, "write_s": write_s}


# ----------------------------------------------------------------------
# phase 12: the model zoo, mirroring and the Module family
# ----------------------------------------------------------------------
ZOO_BATCH = 64
ZOO_SIZE = 224
#: the other four networks at full width: (network, get_symbol arguments,
#: input size, batch)
ZOO_NETS = (("alexnet", {}, 224, 64), ("vgg", {"num_layers": 16}, 224, 64),
            ("googlenet", {}, 224, 64), ("inception_v3", {}, 299, 32))
ZOO_TIMED_STEPS = 5
#: the float64 witnesses' batch (Inception-BN's two training steps and
#: the other networks' forwards); the steps of the mirroring runs that
#: the bitwise gates compare, and the timed steps after them
ZOO_WITNESS_BATCH = 2
MIRROR_STEPS = 3
MIRROR_TIMED_STEPS = 10
#: the Module family on the card: LeNet (train_mnist.py's) at batch 16
#: on 1 x 28 x 28 images, 4 batches of SGD (lr 0.1, momentum 0.9);
#: the SequentialModule gate is the CPU tests' 1e-5
FAMILY_BATCH = 16
FAMILY_BATCHES = 4
FAMILY_SHAPE = (1, 28, 28)
FAMILY_SGD = dict(learning_rate=0.1, momentum=0.9)
FAMILY_TOL = 1e-5


def zoo_symbol(name, **kw):
    """``models.<name>.get_symbol(1000, **kw)`` under a fresh
    NameManager (the automatic names do not depend on earlier builds)."""
    import mxnet_tpu_torch as mx
    with mx.name.NameManager():
        return getattr(mx.models, name).get_symbol(1000, **kw)


def seeded_zoo(sym, batch, size, seed):
    """Weights, aux and a batch for ``sym`` from numpy, as
    :func:`seeded_resnet` makes them: He-scaled convolutions, N(0, 0.01)
    fully connected weights, zero biases and betas, unit gammas, zero
    moving means and unit moving variances; images N(0, 1), labels
    uniform over 1000 classes."""
    shape = (batch, 3, size, size)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    fc = {n.inputs[1][0].name for n in sym._topo()
          if not n.is_variable and n.op.op_name == "FullyConnected"}
    rng = np.random.RandomState(seed)
    params = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(s, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(s, np.float32)
        elif name in fc:
            params[name] = (rng.randn(*s) * 0.01).astype(np.float32)
        else:
            params[name] = (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:])))\
                .astype(np.float32)
    aux = {n: (np.ones if n.endswith("moving_var") else np.zeros)(
        s, np.float32) for n, s in zip(sym.list_auxiliary_states(),
                                       aux_shapes)}
    data = {"data": rng.randn(*shape).astype(np.float32),
            "softmax_label": rng.randint(0, 1000, batch).astype(np.float32)}
    return params, aux, data


def cpu_trainer(torch, sym, params, aux, data, dtype):
    """The port's ShardedTrainer on the CPU with the leafwise update, and
    its parameters, states, aux and batch as ``dtype`` tensors: the
    reference of the card's runs."""
    import mxnet_tpu_torch as mx
    os.environ["MXTPU_FUSED_OPT"] = ""
    batch = data["data"].shape[0]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / batch, **RESNET_SGD)
    tr = mx.parallel.ShardedTrainer(sym, opt, ctx=mx.cpu())

    def cast(d):
        return {k: torch.as_tensor(v, dtype=dtype).clone()
                for k, v in d.items()}
    p, a, b = cast(params), cast(aux), cast(data)
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    return tr, p, {n: v for n, v in st.items() if v is not None}, a, b


def zoo_train_witness(torch, sym, seed, steps=2):
    """Two training steps of ``sym`` at batch 2 on the card (float32,
    the sweep) and of the port on the CPU in float64 and float32
    (leafwise): [max |diff| first-step softmax outputs, max |diff| over
    every parameter after the steps] of the card and of the CPU's
    float32 against float64; phase 9's gate holds the card within
    PRECISION_FACTOR times the CPU's float32."""
    params, aux, data = seeded_zoo(sym, ZOO_WITNESS_BATCH, ZOO_SIZE,
                                   seed + 31)
    outs, p_dev, _a, _s, info = run_resnet(torch, params, aux, data, steps,
                                           "kernel", sym=sym)
    _want_sweep_only(info, 1)
    ref = {}
    for dt in (torch.float64, torch.float32):
        tr, p, st, a, b = cpu_trainer(torch, sym, params, aux, data, dt)
        first = None
        for _ in range(steps):
            p, st, a, o = tr.step(p, st, a, b)
            if first is None:
                first = o[0].clone()
        ref[dt] = (first, p)
    o64, p64 = ref[torch.float64]

    def diff(o, p):
        return [float((o.double().cpu() - o64).abs().max()),
                max(float((p[n].double().cpu() - p64[n]).abs().max())
                    for n in p64)]
    got = {"device_vs_cpu64": diff(outs, p_dev),
           "cpu32_vs_cpu64": diff(*ref[torch.float32]),
           "steps": steps, "batch": ZOO_WITNESS_BATCH,
           "launches": info["launches"]}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["device_vs_cpu64"], got["cpu32_vs_cpu64"]))
    return got


def plain_forward(torch, sym, params, aux, data, dtype, device):
    """The softmax outputs of ``sym`` in inference mode, computed here
    with no module of the port: a walk over the graph's nodes with plain
    PyTorch for each op of the zoo (convolution, BatchNorm on the moving
    statistics, max and average pooling over explicitly padded inputs
    with the kernel's area as divisor, LRN, Concat, Flatten, fully
    connected, ReLU, Dropout as the identity, softmax)."""
    F = torch.nn.functional

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)
    vals = {}
    for node in sym._topo():
        if node.is_variable:
            src = params if node.name in params else data
            vals[(id(node), 0)] = t(src[node.name])
            continue
        p, op = node.op.param, node.op.op_name
        x = [vals[(id(c), ci)] for c, ci in node.inputs]
        if op == "Convolution":
            y = F.conv2d(x[0], x[1], None if p.no_bias else x[2],
                         tuple(p.stride or (1, 1)), tuple(p.pad or (0, 0)))
        elif op == "BatchNorm":
            mean = t(aux[node.name + "_moving_mean"]).reshape(1, -1, 1, 1)
            var = t(aux[node.name + "_moving_var"]).reshape(1, -1, 1, 1)
            y = (x[0] - mean) / torch.sqrt(var + p.eps)
            if not p.fix_gamma:
                y = y * x[1].reshape(1, -1, 1, 1)
            y = y + x[2].reshape(1, -1, 1, 1)
        elif op == "Activation":
            y = torch.relu(x[0])
        elif op == "Pooling":
            h, w = x[0].shape[2:]
            if p.global_pool:
                k, st, pad = (h, w), (1, 1), (0, 0)
            else:
                k, st = tuple(p.kernel), tuple(p.stride or (1, 1))
                pad = tuple(p.pad or (0, 0))
            oh = (h + 2 * pad[0] - k[0]) // st[0] + 1
            ow = (w + 2 * pad[1] - k[1]) // st[1] + 1
            hi = (max((oh - 1) * st[0] + k[0] - h - pad[0], pad[0]),
                  max((ow - 1) * st[1] + k[1] - w - pad[1], pad[1]))
            fill = float("-inf") if p.pool_type == "max" else 0.0
            xp = F.pad(x[0], (pad[1], hi[1], pad[0], hi[0]), value=fill)
            win = xp.unfold(2, k[0], st[0]).unfold(3, k[1], st[1])
            y = win.amax(dim=(-2, -1)) if p.pool_type == "max" \
                else win.sum(dim=(-2, -1)) / (k[0] * k[1])
        elif op == "LRN":
            half = p.nsize // 2
            sq = F.pad(x[0] * x[0], (0, 0, 0, 0, half, p.nsize - 1 - half))
            ssum = sum(sq[:, i:i + x[0].shape[1]] for i in range(p.nsize))
            y = x[0] * (p.knorm + p.alpha / p.nsize * ssum) ** -p.beta
        elif op == "Concat":
            y = torch.cat(x, dim=p.dim)
        elif op == "Flatten":
            y = x[0].reshape(x[0].shape[0], -1)
        elif op == "FullyConnected":
            y = x[0].reshape(x[0].shape[0], -1) @ x[1].t() + x[2]
        elif op == "Dropout":
            y = x[0]
        elif op == "SoftmaxOutput":
            y = torch.softmax(x[0], dim=-1)
        else:
            raise AssertionError("plain_forward: no plain %s" % op)
        vals[(id(node), 0)] = y
    (head, idx), = sym._heads
    return vals[(id(head), idx)]


def zoo_forward_witness(torch, sym, size, seed):
    """One forward in inference mode (Dropout off, the moving statistics)
    of ``sym`` at batch 2, max |diff| of the softmax outputs: the port on
    the card in float32 and :func:`plain_forward` on the card in float32,
    each against ``plain_forward`` in float64 (phase 9's gate: the port
    within PRECISION_FACTOR times the plain float32); and the port on
    the CPU in float64 against ``plain_forward`` in float64, which must
    agree to 1e-10 (the plain walk computes the port's function)."""
    import mxnet_tpu_torch as mx
    params, aux, data = seeded_zoo(sym, ZOO_WITNESS_BATCH, size, seed + 37)
    opt = mx.optimizer.create("sgd", **RESNET_SGD)
    port = {}
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        tr = mx.parallel.ShardedTrainer(sym, opt, ctx=torch.device(dev))

        def cast(d):
            return {k: torch.as_tensor(v, dtype=dt, device=dev)
                    for k, v in d.items()}
        port[dev, dt] = tr.eval(cast(params), cast(aux),
                                cast(data))[0].double().cpu()
    plain = {dt: plain_forward(torch, sym, params, aux, data, dt,
                               torch.device(DEVICE)).double().cpu()
             for dt in (torch.float32, torch.float64)}
    want = plain[torch.float64]
    res = {"port_vs_plain64": float((port[DEVICE, torch.float32]
                                     - want).abs().max()),
           "plain32_vs_plain64": float((plain[torch.float32]
                                        - want).abs().max()),
           "port_cpu64_vs_plain64": float((port["cpu", torch.float64]
                                           - want).abs().max())}
    res["ok"] = res["port_vs_plain64"] \
        <= PRECISION_FACTOR * res["plain32_vs_plain64"] \
        and res["port_cpu64_vs_plain64"] <= 1e-10
    return res


def _equal_runs(torch, what, a, b):
    """Parameters, aux and optimizer states of two runs bit for bit."""
    diff = [n for i in range(3) for n in a[i]
            if not torch.equal(a[i][n], b[i][n])]
    if diff or any(set(a[i]) != set(b[i]) for i in range(3)):
        raise AssertionError("%s: parameters, aux or states differ: %s"
                             % (what, diff[:5]))


def module_mirror_steps(torch, sym, params, aux, data, steps, mirror):
    """``steps`` forward-backward-update steps of a ``Module`` on
    ``gpu(0)`` (the fused step: no kvstore) with
    ``MXNET_BACKWARD_DO_MIRROR`` set to 1 or unset at bind, then
    ``MIRROR_TIMED_STEPS`` more, each timed; returns the parameters, aux
    and states after the first ``steps`` (copies) and a dict of the
    mirrored segments, the peak device memory over those steps and the
    step times."""
    import mxnet_tpu_torch as mx
    env = os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
    if mirror:
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    try:
        ctx = mx.Context.from_device(torch.device(DEVICE))
        batch = data["data"].shape[0]
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", data["data"].shape)],
                 label_shapes=[("softmax_label", (batch,))])
    finally:
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
        if env is not None:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = env
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in params.items()},
                    aux_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params=dict(RESNET_SGD))
    b = mx.io.DataBatch([mx.nd.array(data["data"], ctx=ctx)],
                        [mx.nd.array(data["softmax_label"], ctx=ctx)])
    ex = mod._exec_group.execs[0]
    torch.cuda.synchronize()
    peak_reset(torch)
    for _ in range(steps):
        mod.forward_backward(b)
        mod.update()
    torch.cuda.synchronize()
    peak = peak_bytes(torch)
    arg, auxp = mod.get_params()
    states = {"%s/%d" % (n, i): v.clone()
              for n, s in mod._fused_holder["states"].items()
              for i, v in enumerate(s if isinstance(s, tuple) else (s,))}
    out = ({k: v.data.clone() for k, v in arg.items()},
           {k: v.data.clone() for k, v in auxp.items()}, states)
    times = []
    for _ in range(MIRROR_TIMED_STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    info = {"mirror": bool(mirror), "steps": steps,
            "devices": sorted({str(v.data.device) for d in (arg, auxp)
                               for v in d.values()}
                              | {str(v.device) for v in states.values()}),
            "mirrored_segments": ex._program.n_mirrored,
            "fused_step": mod._fused_step_ok(),
            "peak_bytes": peak,
            "step_ms": float(np.median(times)) * 1e3,
            "step_ms_all": [t * 1e3 for t in times]}
    return out + (info,)


def phase_zoo_mirror(torch, sym, params, aux, data):
    """Mirroring on Inception-BN under deterministic cuDNN: ShardedTrainer
    with and without ``remat=True``, a Module with and without
    ``MXNET_BACKWARD_DO_MIRROR=1``, each 3 steps; bitwise gates and the
    peaks."""
    out = {}
    for remat in (False, True):
        _o, p, a, st, info = run_resnet(torch, params, aux, data,
                                        MIRROR_STEPS, "kernel", sym=sym,
                                        remat=remat,
                                        timed_steps=MIRROR_TIMED_STEPS)
        _want_sweep_only(info, 1)
        _want_cuda0(torch, "zoo remat=%s" % remat, info["devices"])
        out["remat" if remat else "trainer"] = ((p, a, st), info)
    _equal_runs(torch, "ShardedTrainer remat=True against remat=False",
                out["remat"][0], out["trainer"][0])
    # phase 9's gate: the sweep against the leafwise update, bit for bit
    _o, p, a, st, info = run_resnet(torch, params, aux, data, MIRROR_STEPS,
                                    "", sym=sym)
    if info["launches"]["fused_opt"]:
        raise AssertionError("leafwise inception-bn run launched the sweep")
    _equal_runs(torch, "inception-bn: the sweep (MXTPU_FUSED_OPT=kernel) "
                "against the leafwise update", out["trainer"][0], (p, a, st))
    del _o, p, a, st
    for mirror in (False, True):
        p, a, st, info = module_mirror_steps(torch, sym, params, aux, data,
                                             MIRROR_STEPS, mirror)
        _want_cuda0(torch, "zoo Module mirror=%s" % mirror, info["devices"])
        out["module_mirror" if mirror else "module"] = ((p, a, st), info)
    _equal_runs(torch, "Module with MXNET_BACKWARD_DO_MIRROR=1 against "
                "without", out["module_mirror"][0], out["module"][0])
    plain, mirr = out["module"][1], out["module_mirror"][1]
    if not mirr["mirrored_segments"] or plain["mirrored_segments"]:
        raise AssertionError("Module programs: %d mirrored segments with "
                             "MXNET_BACKWARD_DO_MIRROR=1, %d without"
                             % (mirr["mirrored_segments"],
                                plain["mirrored_segments"]))
    if not mirr["fused_step"]:
        raise AssertionError("the mirrored Module did not take the fused "
                             "step")
    if DEVICE == "cuda" and not mirr["peak_bytes"] < plain["peak_bytes"]:
        raise AssertionError("MXNET_BACKWARD_DO_MIRROR=1 peak %d bytes, "
                             "not below the unmirrored %d"
                             % (mirr["peak_bytes"], plain["peak_bytes"]))
    return {k: v[1] for k, v in out.items()}


def segment_checkpoint_trace(torch, sym):
    """The walk of ``sym`` with each segment that
    ``MXNET_BACKWARD_DO_MIRROR=1`` mirrors run under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the JAX
    package's design (``jax.checkpoint`` a segment, its outputs kept),
    written here only to measure its peak beside the port's hooks.
    Values are dropped after their last consumer, as the port's walk
    drops them.  Returns ``trace(args, aux) -> head tensors``."""
    from torch.utils.checkpoint import checkpoint
    from mxnet_tpu_torch.executor import _mirror_segments
    topo = sym._topo()
    op_nodes = [n for n in topo if not n.is_variable]
    env = os.environ.get("MXNET_BACKWARD_DO_MIRROR")
    os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    try:
        segments = _mirror_segments(op_nodes)
    finally:
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR")
        if env is not None:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = env
    heads = [(id(n), i) for n, i in sym._heads]
    last_use = {}
    for pos, node in enumerate(op_nodes):
        for c, ci in node.inputs:
            last_use[(id(c), ci)] = pos
    plan, pos = [], 0
    for mirrored, nodes in segments:
        end = pos + len(nodes)
        inside = {id(n) for n in nodes}
        ext = []
        for n in nodes:
            for c, ci in n.inputs:
                if id(c) not in inside and (id(c), ci) not in ext:
                    ext.append((id(c), ci))
        outk = [(id(n), i) for n in nodes for i in range(n.num_outputs)
                if last_use.get((id(n), i), -1) >= end
                or (id(n), i) in heads]
        plan.append((mirrored, nodes, ext, outk, end))
        pos = end

    def run(nodes, values, aux):
        for node in nodes:
            ins = [values[(id(c), ci)] for c, ci in node.inputs]
            aux_in = [aux["%s_%s" % (node.name, a)]
                      for a in node.op.list_auxiliary_states()]
            outs, _upd = node.op.forward(ins, aux_in, True, None)
            for i, o in enumerate(outs):
                values[(id(node), i)] = o

    def trace(args, aux):
        values = {(id(n), 0): args[n.name] for n in topo if n.is_variable}
        for mirrored, nodes, ext, outk, end in plan:
            if not mirrored:
                run(nodes, values, aux)
            else:
                def seg(*xs, nodes=nodes, ext=ext, outk=outk):
                    local = dict(zip(ext, xs))
                    run(nodes, local, aux)
                    return tuple(local[k] for k in outk)
                values.update(zip(outk, checkpoint(
                    seg, *[values[k] for k in ext], use_reentrant=False)))
            for k in [k for k in values if k not in heads
                      and last_use.get(k, -1) < end]:
                del values[k]
        return [values[k] for k in heads]
    return trace


def mirror_design_peaks(torch, sym, params, aux, data):
    """One forward and backward of ``sym`` on the card (no update), the
    peak device memory over it above what was allocated before, for
    three walks: the port's unmirrored program, the port's mirrored one
    (``MXNET_BACKWARD_DO_MIRROR=1``: saved-tensor hooks that recompute
    the segments' outputs too), and :func:`segment_checkpoint_trace`.
    Their gradients must be equal bit for bit (deterministic cuDNN)."""
    from mxnet_tpu_torch.executor import build_program
    dev = torch.device(DEVICE)
    env = os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
    try:
        plain = build_program(sym)
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
        mirrored = build_program(sym)
    finally:
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
        if env is not None:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = env
    walks = (("unmirrored", lambda a, x: plain.trace(a, x, None, True)[0]),
             ("hooks", lambda a, x: mirrored.trace(a, x, None, True)[0]),
             ("segment_checkpoint", segment_checkpoint_trace(torch, sym)))
    p = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    a = {k: torch.as_tensor(v, device=dev) for k, v in aux.items()}
    b = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    res, first = {}, None
    for name, walk in walks:
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        peak_reset(torch)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        outs = walk(dict(b, **leaves), a)
        grads = torch.autograd.grad(outs, list(leaves.values()),
                                    [torch.ones_like(o) for o in outs])
        torch.cuda.synchronize()
        res[name] = {"peak_bytes": peak_bytes(torch),
                     "peak_over_start_bytes": peak_bytes(torch) - start}
        grads = [g.cpu() for g in grads]
        del outs, leaves
        if first is None:
            first = grads
        elif not all(torch.equal(g, f) for g, f in zip(grads, first)):
            raise AssertionError("mirror designs: the %s walk's gradients "
                                 "differ from the unmirrored walk's" % name)
    res["mirrored_segments"] = mirrored.n_mirrored
    return res


def zoo_sweep_gate(torch, sym, params, aux, data, seed):
    """Phase 9's gate on another network at full width, under
    deterministic cuDNN: one step through the sweep and one leafwise,
    each from ``mx.random.seed(seed)`` (Dropout draws the same masks),
    parameters, aux and states bit for bit; returns the sweep run's
    info."""
    import mxnet_tpu_torch as mx
    got = {}
    for mode in ("kernel", ""):
        mx.random.seed(seed)
        _o, p, a, st, info = run_resnet(torch, params, aux, data, 1, mode,
                                        sym=sym)
        got[mode] = ((p, a, st), info)
        del _o, p, a, st
    if got[""][1]["launches"]["fused_opt"]:
        raise AssertionError("a leafwise zoo run launched the sweep")
    _want_sweep_only(got["kernel"][1], 1)
    _equal_runs(torch, "the sweep against the leafwise update",
                got["kernel"][0], got[""][0])
    return got["kernel"][1]


def zoo_timed(torch, name, kw, size, batch, seed):
    """A network at full width: first, under deterministic cuDNN, one
    step through the sweep against one leafwise, bit for bit
    (:func:`zoo_sweep_gate`); then ``ZOO_TIMED_STEPS`` float32
    ShardedTrainer steps under cuDNN's defaults after 2 counted ones
    (the sweep once a bucket a step)."""
    sym = zoo_symbol(name, **kw)
    params, aux, data = seeded_zoo(sym, batch, size, seed)
    with cudnn_deterministic(torch):
        gate = zoo_sweep_gate(torch, sym, params, aux, data, seed)
    torch.cuda.empty_cache()
    _o, _p, _a, _s, info = run_resnet(torch, params, aux, data, 2, "kernel",
                                      sym=sym, timed_steps=ZOO_TIMED_STEPS)
    _want_sweep_only(info, 1)
    _want_cuda0(torch, "zoo %s" % name, info["devices"])
    info["network"], info["size"] = name, size
    info["step_flops"] = step_flops(sym, (batch, 3, size, size))
    info["bound_ms"], info["bound_by"] = bound_ms(0, info["step_flops"])
    info["gate"] = gate
    return info


def lenet_parts(mx):
    """LeNet (``models/lenet.py``: two 5 x 5 convolutions with tanh and
    2 x 2 max pooling, a 500-wide tanh layer, 10 classes) as one symbol
    and as its trunk (up to the 500-wide layer) and head (the
    classifier), with the same names."""
    def trunk(x):
        for i, nf in enumerate((20, 50)):
            x = mx.sym.Convolution(x, kernel=(5, 5), num_filter=nf,
                                   name="conv%d" % i)
            x = mx.sym.Activation(x, act_type="tanh", name="tanh%d" % i)
            x = mx.sym.Pooling(x, pool_type="max", kernel=(2, 2),
                               stride=(2, 2), name="pool%d" % i)
        x = mx.sym.FullyConnected(mx.sym.Flatten(x, name="flatten"),
                                  num_hidden=500, name="fc0")
        return mx.sym.Activation(x, act_type="tanh", name="tanh2")

    def head(x):
        x = mx.sym.FullyConnected(x, num_hidden=10, name="fc1")
        return mx.sym.SoftmaxOutput(x, name="softmax")
    data = mx.sym.Variable("data")
    return head(trunk(data)), trunk(data), head(data)


def family_data(seed):
    """LeNet's weights (uniform, Xavier's scale, numpy), zero biases, and
    FAMILY_BATCHES batches of 1 x 28 x 28 images with labels in 10
    classes."""
    import mxnet_tpu_torch as mx
    whole, _t, _h = lenet_parts(mx)
    _outs, shapes = op_shapes(whole, (FAMILY_BATCH,) + FAMILY_SHAPE)
    rng = np.random.RandomState(seed)
    params = {n: (rng.uniform(-1, 1, s) * np.sqrt(3.0 / np.prod(s[1:])))
              .astype(np.float32) if n.endswith("_weight")
              else np.zeros(s, np.float32)
              for n, s in shapes.items() if n not in ("data", "softmax_label")}
    x = rng.randn(FAMILY_BATCHES * FAMILY_BATCH, *FAMILY_SHAPE)\
        .astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.float32)
    return params, x, y


def family_batches(torch, x, y, dtype, device):
    return [{"data": torch.as_tensor(x[i:i + FAMILY_BATCH], dtype=dtype,
                                     device=device),
             "softmax_label": torch.as_tensor(y[i:i + FAMILY_BATCH],
                                              dtype=dtype, device=device)}
            for i in range(0, len(x), FAMILY_BATCH)]


def trainer_fit(torch, sym, params, x, y, dtype):
    """FeedForward.fit's training (SGD with FAMILY_SGD, rescale 1/batch,
    the batches in order) through the port's ShardedTrainer on the CPU
    in ``dtype``, leafwise: the float64 reference (FeedForward allocates
    float32 parameters)."""
    import mxnet_tpu_torch as mx
    os.environ["MXTPU_FUSED_OPT"] = ""
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / FAMILY_BATCH,
                              **FAMILY_SGD)
    tr = mx.parallel.ShardedTrainer(sym, opt, ctx=mx.cpu())
    p = {k: torch.as_tensor(v, dtype=dtype).clone()
         for k, v in params.items()}
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    for b in family_batches(torch, x, y, dtype, "cpu"):
        p, st, _a, _o = tr.step(p, st, {}, b)
    return p


def plain_lenet_fit(torch, params, x, y, dtype, device):
    """The same training written here with no module of the port:
    F.conv2d, tanh, max pooling, F.linear, a summed cross entropy (whose
    gradient is SoftmaxOutput's p - onehot) and SGD with momentum."""
    F = torch.nn.functional
    lr, mom = FAMILY_SGD["learning_rate"], FAMILY_SGD["momentum"]
    p = {k: torch.as_tensor(v, dtype=dtype, device=device).clone()
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    for b in family_batches(torch, x, y, dtype, device):
        w = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        h = b["data"]
        for i in range(2):
            h = F.conv2d(h, w["conv%d_weight" % i], w["conv%d_bias" % i])
            h = F.max_pool2d(torch.tanh(h), 2, 2)
        h = torch.tanh(F.linear(h.flatten(1), w["fc0_weight"],
                                w["fc0_bias"]))
        logits = F.linear(h, w["fc1_weight"], w["fc1_bias"])
        loss = F.cross_entropy(logits, b["softmax_label"].long(),
                               reduction="sum")
        grads = torch.autograd.grad(loss, list(w.values()))
        with torch.no_grad():
            for k, g in zip(w, grads):
                m[k] = mom * m[k] - lr * (g * (1.0 / FAMILY_BATCH))
                p[k] = p[k] + m[k]
    return p


def cpu_float32_settings(torch):
    """What decides how the CPU rounds float32 products: the matmul
    precision, oneDNN's float32 modes where this PyTorch has them, the
    threads, the vector ISA and the oneDNN environment."""
    out = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
           "threads": torch.get_num_threads(),
           "cpu_capability": torch.backends.cpu.get_cpu_capability(),
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith(("ONEDNN", "DNNL", "MKL", "OMP"))}}
    mk = torch.backends.mkldnn
    for name, obj in (("mkldnn", mk), ("mkldnn.matmul", getattr(
            mk, "matmul", None)), ("mkldnn.conv", getattr(mk, "conv", None))):
        if hasattr(obj, "fp32_precision"):
            out[name + ".fp32_precision"] = obj.fp32_precision
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln.split(":", 1)[1].split() for ln in f
                          if ln.startswith("flags")), [])
        out["amx"] = sorted(fl for fl in flags if fl.startswith("amx"))
    except OSError:
        out["amx"] = None
    return out


def feedforward_witness(torch, seed):
    """FeedForward.fit of LeNet for FAMILY_BATCHES batches on ``gpu(0)``
    and on the CPU (float32), against the port's same training on the
    CPU in float64 (:func:`trainer_fit`): max |diff| over every
    parameter.  The gate, as phase 9's: the card within PRECISION_FACTOR
    times the larger float32 distance, of the CPU's fit and of
    :func:`plain_lenet_fit` on the card (cuDNN's algorithms and the
    CPU's round differently); the CPU's float32 fit within FAMILY_TOL of
    the float64 reference, or within PRECISION_FACTOR times the plain
    float32 training on the same CPU where that is further (a CPU whose
    oneDNN rounds float32 products coarser moves both alike), and the
    plain float64 training within 1e-10 of it (all three compute the
    same training).  The port's trainer in float32 on the CPU is
    reported beside them."""
    import mxnet_tpu_torch as mx
    params, x, y = family_data(seed)
    whole, _t, _h = lenet_parts(mx)
    dev = mx.Context.from_device(torch.device(DEVICE))
    fits = {}
    for ctx in (dev, mx.cpu()):
        model = mx.FeedForward(whole, ctx=ctx, num_epoch=1,
                               optimizer="sgd", arg_params={
                                   k: mx.nd.array(v, ctx=ctx)
                                   for k, v in params.items()},
                               **FAMILY_SGD)
        model.fit(mx.io.NDArrayIter(x, y, batch_size=FAMILY_BATCH))
        if ctx is dev and any(v.data.device.type != DEVICE
                              for v in model.arg_params.values()):
            raise AssertionError("FeedForward.fit on %s left parameters "
                                 "elsewhere" % ctx)
        fits[str(ctx)] = {k: v.data.double().cpu()
                          for k, v in model.arg_params.items()}
    ref = trainer_fit(torch, whole, params, x, y, torch.float64)
    trainer32 = trainer_fit(torch, whole, params, x, y, torch.float32)
    plain = {(dt, d): plain_lenet_fit(torch, params, x, y, dt, d)
             for dt, d in ((torch.float32, DEVICE), (torch.float32, "cpu"),
                           (torch.float64, "cpu"))}

    def dist(p):
        return max(float((p[k].double().cpu() - ref[k]).abs().max())
                   for k in params)
    got = {"device_vs_cpu64": dist(fits[str(dev)]),
           "cpu32_vs_cpu64": dist(fits["cpu(0)"]),
           "plain_device32_vs_cpu64": dist(plain[torch.float32, DEVICE]),
           "plain_cpu32_vs_cpu64": dist(plain[torch.float32, "cpu"]),
           "trainer_cpu32_vs_cpu64": dist(trainer32),
           "plain64_vs_cpu64": dist(plain[torch.float64, "cpu"]),
           "largest_update": max(float((ref[k] - torch.as_tensor(
               params[k], dtype=torch.float64)).abs().max()) for k in params)}
    got["cpu32_gate"] = max(FAMILY_TOL, PRECISION_FACTOR
                            * got["plain_cpu32_vs_cpu64"])
    got["ok"] = (got["device_vs_cpu64"] <= PRECISION_FACTOR * max(
        got["cpu32_vs_cpu64"], got["plain_device32_vs_cpu64"])
        and got["cpu32_vs_cpu64"] <= got["cpu32_gate"]
        and got["plain64_vs_cpu64"] <= 1e-10)
    return got


def phase_family(torch, seed):
    """The Module family on the card, LeNet at batch 16 (the point is
    the API): FeedForward.fit on ``gpu(0)`` against the port's same
    training on the CPU in float64 (:func:`feedforward_witness`, under
    deterministic cuDNN); a Monitor through ``fit(monitor=...)`` and on a
    monitored forward; a SequentialModule of the trunk and the head
    against one Module of the whole."""
    import mxnet_tpu_torch as mx
    with cudnn_deterministic(torch):
        ff = feedforward_witness(torch, seed)
    if not ff["ok"]:
        raise AssertionError("FeedForward.fit on the card: %s (gates: the "
                             "card within %g times the larger float32 "
                             "distance, the CPU's float32 within %g or "
                             "%g times the plain float32 on the CPU, the "
                             "plain float64 within 1e-10); the CPU's "
                             "float32 settings: %s"
                             % (json.dumps(ff), PRECISION_FACTOR,
                                FAMILY_TOL, PRECISION_FACTOR,
                                json.dumps(cpu_float32_settings(torch))))
    params, x, y = family_data(seed)
    whole, trunk, head = lenet_parts(mx)
    dev = mx.Context.from_device(torch.device(DEVICE))
    # the Monitor: through fit (its forward_backward reports the
    # arguments at toc, as in the JAX package), then a monitored forward
    mon = mx.Monitor(interval=1, pattern=".*weight")
    records = []
    mon.toc_print = lambda: records.extend(mon.toc())
    mod = mx.mod.Module(whole, context=dev)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=FAMILY_BATCH), num_epoch=1,
            monitor=mon, optimizer_params={"learning_rate": 0.1},
            arg_params={k: mx.nd.array(v, ctx=dev)
                        for k, v in params.items()})
    weights = [n for n in whole.list_arguments() if n.endswith("weight")]
    if sorted(n for _s, n, _v in records) \
            != sorted(weights * FAMILY_BATCHES):
        raise AssertionError("fit(monitor=...) recorded %s"
                             % [n for _s, n, _v in records])
    op_mon = mx.Monitor(interval=1, pattern=".*_output")
    mod.install_monitor(op_mon)
    op_mon.tic()
    mod.forward(mx.io.DataBatch([mx.nd.array(x[:FAMILY_BATCH], ctx=dev)],
                                [mx.nd.array(y[:FAMILY_BATCH], ctx=dev)]),
                is_train=False)
    op_records = op_mon.toc()
    want = ["%s_%s" % (n.name, o) for n in whole._topo()
            if not n.is_variable for o in n.op.list_outputs()]
    stats = [float(v.split("\t")[0]) for _s, _n, v in records + op_records]
    if [n for _s, n, _v in op_records] != want \
            or not all(np.isfinite(stats)):
        raise AssertionError("the monitored forward recorded %s (want "
                             "%s), finite %s"
                             % ([n for _s, n, _v in op_records], want,
                                all(np.isfinite(stats))))
    # SequentialModule of the trunk and the head, one batch
    seq_params = {}
    for kind in ("sequential", "module"):
        if kind == "sequential":
            m = mx.mod.SequentialModule()
            m.add(mx.mod.Module(trunk, label_names=None, context=dev))
            m.add(mx.mod.Module(head, context=dev), take_labels=True,
                  auto_wiring=True)
        else:
            m = mx.mod.Module(whole, context=dev)
        m.bind(data_shapes=[("data", (FAMILY_BATCH,) + FAMILY_SHAPE)],
               label_shapes=[("softmax_label", (FAMILY_BATCH,))])
        m.init_params(arg_params={k: mx.nd.array(v, ctx=dev)
                                  for k, v in params.items()},
                      aux_params={}, allow_missing=False)
        m.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        m.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x[:FAMILY_BATCH], ctx=dev)],
            [mx.nd.array(y[:FAMILY_BATCH], ctx=dev)]))
        m.update()
        seq_params[kind] = {k: v.asnumpy()
                            for k, v in m.get_params()[0].items()}
    seq_err = max(float(np.abs(seq_params["sequential"][k]
                               - seq_params["module"][k]).max())
                  for k in params)
    if not seq_err <= FAMILY_TOL:
        raise AssertionError("SequentialModule(trunk, head): parameters %g "
                             "from the one Module's (gate %g)"
                             % (seq_err, FAMILY_TOL))
    return {"feedforward": ff, "sequential_vs_module": seq_err,
            "monitor_fit_records": len(records),
            "monitor_forward_records": len(op_records),
            "tolerance": FAMILY_TOL}


def phase_zoo(torch, seed, smi, resnet):
    """Phase 12: Inception-BN at full width (the slice's main path)
    through ShardedTrainer in float32 and bfloat16 under cuDNN's
    defaults, beside phase 9's ResNet-50; under deterministic cuDNN its
    float64 witness, the sweep against the leafwise update bit for bit,
    mirroring on it and the peaks of the two mirroring designs; the
    other four networks (each one step through the sweep against one
    leafwise, bit for bit, then timed); train_imagenet.py --network
    inception-bn on phase 11's records; the Module family."""
    t_phase = time.perf_counter()
    sym = zoo_symbol("inception_bn")
    params, aux, data = seeded_zoo(sym, ZOO_BATCH, ZOO_SIZE, seed + 29)
    log("zoo main path: " + _cudnn_settings(torch))
    main = {}
    for dt in (None, "bfloat16"):
        _o, _p, _a, _s, info = run_resnet(torch, params, aux, data, 3,
                                          "kernel", compute_dtype=dt,
                                          sym=sym, timed_steps=5)
        _want_sweep_only(info, 1)
        _want_cuda0(torch, "zoo inception-bn %s" % info["compute_dtype"],
                    info["devices"])
        main[info["compute_dtype"]] = info
        del _p, _a, _s
    flops = step_flops(sym, (ZOO_BATCH, 3, ZOO_SIZE, ZOO_SIZE))
    for dt, r in main.items():
        rate = ops_rate(dt)
        r["step_flops"] = flops
        r["bound_ms"], r["bound_by"] = bound_ms(0, flops, rate)
        log("zoo inception-bn %s batch %d: %.3f ms/step (median of %d: %s), "
            "%.1f images/s, against phase 9's ResNet-50 %.3f ms/step, %.1f "
            "images/s; bound %.3f ms (%.3g TFLOP a step); sweep launches in "
            "%d steps %s (%d buckets, elements %s); on %s"
            % (dt, ZOO_BATCH, r["step_ms"], len(r["step_ms_all"]),
               ", ".join("%.2f" % t for t in r["step_ms_all"]),
               r["images_per_s"], resnet[dt]["step_ms"],
               resnet[dt]["images_per_s"], r["bound_ms"], flops / 1e12,
               r["steps"], r["launches"]["fused_opt"], r["buckets"],
               r["bucket_sizes"], smi))
    torch.cuda.empty_cache()
    with cudnn_deterministic(torch):
        log("zoo gates: " + _cudnn_settings(torch))
        witness = zoo_train_witness(torch, sym, seed)
        log("zoo inception-bn precision, %d steps at batch %d [softmax "
            "outputs, parameters]: %s"
            % (witness["steps"], witness["batch"], json.dumps(witness)))
        if not witness["ok"]:
            raise AssertionError("inception-bn: the card is more than %g "
                                 "times as far from the CPU's float64 "
                                 "steps as the CPU's float32 steps"
                                 % PRECISION_FACTOR)
        mirror = phase_zoo_mirror(torch, sym, params, aux, data)
        for k, r in mirror.items():
            log("zoo mirror %s: %d steps at batch %d, peak %.1f MB, %.3f "
                "ms/step (%s)%s"
                % (k, MIRROR_STEPS, ZOO_BATCH, r["peak_bytes"] / 1e6,
                   r["step_ms"], ", ".join("%.2f" % t
                                           for t in r["step_ms_all"]),
                   "; %d mirrored segments" % r["mirrored_segments"]
                   if "mirrored_segments" in r else ""))
        log("zoo mirror gates: the sweep == leafwise, remat=True == "
            "remat=False and MXNET_BACKWARD_DO_MIRROR=1 == unset, bitwise "
            "(parameters, aux, states); mirrored peak %.1f MB below %.1f "
            "MB; on %s"
            % (mirror["module_mirror"]["peak_bytes"] / 1e6,
               mirror["module"]["peak_bytes"] / 1e6, smi))
        designs = mirror_design_peaks(torch, sym, params, aux, data)
        log("zoo mirror designs, one forward and backward at batch %d, "
            "peak above the start (absolute): %s; gradients equal bit for "
            "bit; on %s"
            % (ZOO_BATCH, ", ".join(
                "%s %.1f MB (%.1f MB)" % (k, designs[k]
                                          ["peak_over_start_bytes"] / 1e6,
                                          designs[k]["peak_bytes"] / 1e6)
                for k in ("unmirrored", "hooks", "segment_checkpoint")),
               smi))
        forwards = {}
        for name, kw, size, _batch in ZOO_NETS:
            forwards[name] = zoo_forward_witness(torch, zoo_symbol(name, **kw),
                                                 size, seed)
            log("zoo %s forward at batch %d, softmax outputs: %s"
                % (name, ZOO_WITNESS_BATCH, json.dumps(forwards[name])))
            if not forwards[name]["ok"]:
                raise AssertionError("%s forward: the port on the card is "
                                     "more than %g times as far from the "
                                     "plain float64 forward as the plain "
                                     "float32 one, or the port's float64 "
                                     "on the CPU is not the plain float64"
                                     % (name, PRECISION_FACTOR))
    torch.cuda.empty_cache()
    others = {}
    for name, kw, size, batch in ZOO_NETS:
        r = others[name] = zoo_timed(torch, name, kw, size, batch, seed)
        log("zoo %s float32 batch %d at %d x %d: %.3f ms/step (median of "
            "%d: %s), %.1f images/s; bound %.3f ms; sweep launches in %d "
            "steps %d, buckets of %s elements; one step through the sweep "
            "== leafwise bitwise (deterministic cuDNN); on %s"
            % (name, batch, size, size, r["step_ms"], len(r["step_ms_all"]),
               ", ".join("%.2f" % t for t in r["step_ms_all"]),
               r["images_per_s"], r["bound_ms"], r["steps"],
               r["launches"]["fused_opt"], r["bucket_sizes"], smi))
        torch.cuda.empty_cache()
    # train_imagenet.py --network inception-bn over phase 11's records
    path = os.path.join(feed_dir("imagenet"), "train.rec")
    reset_counts()
    fit_mod, ends = run_train_imagenet(
        torch, seed, os.path.dirname(path),
        os.path.join(feed_dir("ckpt"), "inception-bn"), True,
        network="inception-bn")
    counts = read_counts()
    ex = fit_mod._exec_group.execs[0]
    want_dev = torch.device("cuda", 0) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    if ex._device != want_dev or any(
            v.data.device != want_dev for v in fit_mod.get_params()[0]
            .values()):
        raise AssertionError("train_imagenet.py --network inception-bn ran "
                             "on %s, not %s" % (ex._device, want_dev))
    if any(counts[k] for k in counts if k != "fused_opt_by_body") \
            or counts["fused_opt_by_body"]:
        raise AssertionError("Module.fit launched hand kernels %s" % counts)
    fit = {"images_per_s": (len(ends) - 1) * RESNET_BATCH
           / (ends[-1] - ends[0]), "batches": len(ends),
           "device": str(ex._device), "launches": counts}
    log("zoo train_imagenet.py --network inception-bn (Module.fit, "
        "MXTPU_PREFETCH=1, --data-dtype uint8) on %s, %d batches of %d: "
        "%.1f images/s (batches 2-%d); no hand kernel launched; on %s"
        % (ex._device, len(ends), RESNET_BATCH, fit["images_per_s"],
           len(ends), smi))
    del fit_mod
    torch.cuda.empty_cache()
    family = phase_family(torch, seed)
    log("zoo module family on %s: %s" % (DEVICE, json.dumps(family)))
    log("zoo phase: %.1f s" % (time.perf_counter() - t_phase))
    return {"main": main, "witness": witness, "mirror": mirror,
            "mirror_designs": designs, "forwards": forwards,
            "others": others, "train_imagenet": fit, "family": family}


# ----------------------------------------------------------------------
# phase 13: the bucketing LSTM language model
# ----------------------------------------------------------------------
#: example/rnn/lstm_bucketing.py's defaults (those of the reference's
#: example) at PTB's vocabulary, 10,000 words + the padding id 0
LSTM_LM = dict(num_layers=2, num_hidden=200, num_embed=200, vocab=10001,
               batch=32, buckets=(10, 20, 30, 40))
LSTM_SGD = dict(learning_rate=0.01, momentum=0.0, wd=1e-5)
#: the seeded synthetic corpus of (a): about 10 batches a bucket
LSTM_SENTENCES = 1300
#: (e)'s corpus for gru_bucketing: a few batches over every bucket
GRU_SENTENCES = 300
LSTM_TRAINER_STEPS = 3
LSTM_TRACED_STEPS = 3
LSTM_INFER_TOKENS = 32
#: (d): the fused RNN op at the bi-LSTM sort example's shapes and at the
#: LM's widths: ((seq_len, batch, input size, hidden), modes).  rnn_relu
#: only at the former: over 40 steps at hidden 200 from these weights
#: its activations grow without bound, and the float32 loop itself lies
#: 8e-2 from float64 there
RNN_OP_CASES = (((5, 32, 16, 48), ("lstm", "gru", "rnn_tanh", "rnn_relu")),
                ((40, 32, 200, 200), ("lstm", "gru", "rnn_tanh")))
RNN_OP_TOL = 1e-5


def _example_module(path, name):
    """A module of the repo's ``example/`` tree, imported by path with
    its directory on ``sys.path`` (the examples import their siblings)."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    full = os.path.join(here, path)
    spec = importlib.util.spec_from_file_location(name, full)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(full))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


def _lm_ctx(mx):
    return mx.gpu(0) if DEVICE == "cuda" else mx.cpu()


def lm_parts(mx, cell, seed, n_sentences):
    """``(make_iter, sym_gen, init_states, initial numpy parameters)``
    of ``example/rnn-torch/{cell}_bucketing.py`` at ``LSTM_LM``: the
    example's seeded synthetic corpus, a maker of its BucketSentenceIter
    (each new one yields the same batches in the same order on its first
    pass) and sym_gen, and Xavier(in, 2.34) drawn from a seeded
    generator."""
    import torch
    c = LSTM_LM
    bucket_io = _example_module("example/rnn-torch/bucket_io.py",
                                "chip_smoke_bucket_io")
    model = getattr(mx.models, cell)
    unroll = getattr(model, cell + "_unroll")
    states = model.init_state_shapes(c["num_layers"], c["batch"],
                                     c["num_hidden"])
    sents = bucket_io.synthetic_corpus(num_sentences=n_sentences,
                                       vocab_size=c["vocab"], seed=seed + 41,
                                       lengths=c["buckets"])

    def make_iter():
        return bucket_io.BucketSentenceIter(sents, c["batch"],
                                            buckets=list(c["buckets"]),
                                            init_states=states,
                                            seed=seed + 43)
    it = make_iter()

    def sym_gen(seq_len):
        s = unroll(c["num_layers"], seq_len, c["vocab"],
                   num_hidden=c["num_hidden"], num_embed=c["num_embed"],
                   num_label=c["vocab"])
        return s, ["data"] + [n for n, _ in states], ["softmax_label"]

    sym, data_names, _ = sym_gen(it.default_bucket_key)
    shapes = dict(states, data=(c["batch"], it.default_bucket_key),
                  softmax_label=(c["batch"], it.default_bucket_key))
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    init = mx.init.Xavier(factor_type="in", magnitude=2.34,
                          generator=torch.Generator().manual_seed(seed + 47))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        arr = mx.nd.zeros(shape, ctx=mx.cpu())
        init(name, arr)
        params[name] = arr.asnumpy()
    return make_iter, sym_gen, states, params


def lm_batches(it):
    """A new iterator's first pass as numpy ``(tokens, labels, bucket
    key)`` batches."""
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.bucket_key)
            for b in it]


def plain_lm_step(torch, cell, p, tokens, labels, lr, wd, rescale):
    """One training step of the unrolled LM of ``models/{cell}.py``
    written here with no module of the port: the embedding, the
    FullyConnected pairs of each cell and step from zero initial states,
    the classifier over the time-major concatenation, the summed cross
    entropy against the transposed labels (whose gradient is
    SoftmaxOutput's p - onehot) and SGD without momentum,
    ``w - lr * (g * rescale + wd * w)``.  ``p``: name -> tensor in the
    dtype to run in.  Returns the softmax outputs and the new weights."""
    F = torch.nn.functional
    L, H = LSTM_LM["num_layers"], LSTM_LM["num_hidden"]
    w = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    dt = w["cls_weight"].dtype
    tok = torch.as_tensor(tokens, device=DEVICE).long()
    B, S = tok.shape
    emb = F.embedding(tok, w["embed_weight"])

    def fc(x, name):
        return torch.matmul(x, w[name + "_weight"].t()) + w[name + "_bias"]

    h = [torch.zeros(B, H, dtype=dt, device=DEVICE) for _ in range(L)]
    c = [torch.zeros(B, H, dtype=dt, device=DEVICE) for _ in range(L)]
    tops = []
    for t in range(S):
        x = emb[:, t]
        for i in range(L):
            if cell == "lstm":
                g = fc(x, "l%d_i2h" % i) + fc(h[i], "l%d_h2h" % i)
                gi, gt, gf, go = torch.chunk(g, 4, dim=1)
                c[i] = torch.sigmoid(gf) * c[i] \
                    + torch.sigmoid(gi) * torch.tanh(gt)
                h[i] = torch.sigmoid(go) * torch.tanh(c[i])
            else:
                both = fc(x, "l%d_i2h_gates" % i) + fc(h[i],
                                                       "l%d_h2h_gates" % i)
                z, r = torch.chunk(both, 2, dim=1)
                z, r = torch.sigmoid(z), torch.sigmoid(r)
                cand = torch.tanh(fc(x, "l%d_i2h_trans" % i)
                                  + fc(r * h[i], "l%d_h2h_trans" % i))
                h[i] = h[i] + z * (cand - h[i])
            x = h[i]
        tops.append(x)
    logits = fc(torch.cat(tops, 0), "cls")
    lab = torch.as_tensor(labels, device=DEVICE).t().reshape(-1).long()
    loss = F.cross_entropy(logits, lab, reduction="sum")
    names = list(w)
    grads = torch.autograd.grad(loss, [w[n] for n in names])
    with torch.no_grad():
        new = {n: w[n] - lr * (g * rescale + wd * w[n])
               for n, g in zip(names, grads)}
    return torch.softmax(logits.detach(), dim=1), new


def plain_lm_train(torch, cell, params, batches, dtype):
    """The batches' steps of :func:`plain_lm_step` from the numpy
    ``params`` in ``dtype``: the last step's softmax outputs and the
    weights after every step."""
    p = {k: torch.as_tensor(v, device=DEVICE).to(dtype)
         for k, v in params.items()}
    out = None
    for tokens, labels, _key in batches:
        out, p = plain_lm_step(torch, cell, p, tokens, labels,
                               LSTM_SGD["learning_rate"], LSTM_SGD["wd"],
                               1.0 / LSTM_LM["batch"])
    return out, p


def lm_witness(torch, cell, params, batches, outs, p_after):
    """Phase 7's witness rule on the bucketing run: the port's float32
    softmax outputs of the last batch and its parameters after every
    batch, against the plain steps in float64 on the same batch
    sequence, within PRECISION_FACTOR times the plain float32 steps'
    distance from float64."""
    o32, p32 = plain_lm_train(torch, cell, params, batches, torch.float32)
    o64, p64 = plain_lm_train(torch, cell, params, batches, torch.float64)

    def dist(o, p):
        return [float((o.double() - o64).abs().max()),
                max(float((p[n].double() - p64[n]).abs().max())
                    for n in p64)]
    got = {"steps": len(batches),
           "port_vs_plain64": dist(outs, p_after),
           "plain32_vs_plain64": dist(o32, p32),
           "largest_update": max(float(
               (p64[n] - torch.as_tensor(params[n], device=DEVICE).double())
               .abs().max()) for n in p64)}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    return got


class _KeyedIter(object):
    """A bucket iterator that records the bucket key of every batch it
    hands out (``keys``), for the step times by bucket."""

    def __init__(self, it):
        self.it = it
        self.keys = []
        self.batch_size = it.batch_size
        self.default_bucket_key = it.default_bucket_key

    @property
    def provide_data(self):
        return self.it.provide_data

    @property
    def provide_label(self):
        return self.it.provide_label

    def reset(self):
        self.it.reset()

    def __iter__(self):
        return self

    def __next__(self):
        b = self.it.next()
        self.keys.append(b.bucket_key)
        return b

    next = __next__


def lm_fit(torch, mx, cell, seed, n_sentences):
    """``BucketingModule.fit`` of ``{cell}_bucketing.py`` on the card at
    ``LSTM_LM`` for one epoch of the corpus, as the example calls it.
    Returns the module, the numpy batches, the initial parameters and a
    dict of gates and measurements (ms a step by bucket over each
    bucket's visits after its first, tokens/s over the same steps, the
    per-batch perplexity, the programs bound, the hand kernels launched,
    peak memory)."""
    from mxnet_tpu_torch import executor as ex_mod
    make_iter, sym_gen, states, params = lm_parts(mx, cell, seed,
                                                  n_sentences)
    batches = lm_batches(make_iter())
    it = make_iter()
    keyed = _KeyedIter(it)
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=_lm_ctx(mx))
    stamps, sums = [], []

    def on_batch(param):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        m = param.eval_metric
        sums.append((float(m.sum_metric), float(m.num_inst)))

    before = ex_mod.program_registry_stats()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    peak_reset(torch)
    reset_counts()
    t0 = time.perf_counter()
    mod.fit(keyed, eval_metric=mx.metric.Perplexity(ignore_label=None),
            kvstore="local", optimizer="sgd",
            optimizer_params=dict(LSTM_SGD),
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in params.items()},
            num_epoch=1, batch_end_callback=on_batch)
    counts = read_counts()
    after = ex_mod.program_registry_stats()
    keys = keyed.keys
    if keys != [k for _t, _l, k in batches]:
        raise AssertionError("%s fit saw buckets %s, the corpus %s"
                             % (cell, keys, [k for _t, _l, k in batches]))
    # the step of batch i ends at stamps[i]; each bucket's first visit
    # binds it (and the first batch binds the default bucket and sets
    # up the optimizer), so it is left out of the times
    first = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)
    by_bucket, tokens, secs = {}, 0, 0.0
    for i in range(1, len(keys)):
        if first[keys[i]] == i:
            continue
        dt = stamps[i] - stamps[i - 1]
        by_bucket.setdefault(keys[i], []).append(dt)
        tokens += LSTM_LM["batch"] * keys[i]
        secs += dt
    ppl = []
    prev = (0.0, 0.0)
    for s, n in sums:
        ppl.append((s - prev[0]) / (n - prev[1]))
        prev = (s, n)
    info = {"cell": cell, "batches": len(keys), "keys": keys,
            "fit_s": time.perf_counter() - t0,
            "ms_by_bucket": {k: float(np.median(v)) * 1e3
                             for k, v in sorted(by_bucket.items())},
            "steps_timed_by_bucket": {k: len(v) for k, v in
                                      sorted(by_bucket.items())},
            "tokens_per_s": tokens / secs if secs else None,
            "perplexity_by_batch": ppl,
            "programs_built": after["misses"] - before["misses"],
            "program_lookups": (after["misses"] + after["hits"]
                                - before["misses"] - before["hits"]),
            "launches": counts, "peak_bytes": peak_bytes(torch)}
    return mod, batches, params, info


def check_bucket_sharing(mod, what):
    """Every bucket's executor holds the default bucket's parameter and
    gradient tensors, its inputs view the default bucket's input
    buffers, and the buckets share one optimizer, updater and fused-step
    state."""
    base = mod._buckets[mod.default_bucket_key]
    bex = base._exec_group.execs[0]
    names = base._exec_group.param_names
    for key, child in mod._buckets.items():
        ex = child._exec_group.execs[0]
        for n in names:
            if ex.arg_dict[n].data.data_ptr() != \
                    bex.arg_dict[n].data.data_ptr() \
                    or ex.grad_dict[n].data.data_ptr() != \
                    bex.grad_dict[n].data.data_ptr():
                raise AssertionError("%s bucket %s: %s is not the default "
                                     "bucket's tensor" % (what, key, n))
        for n in child._exec_group.data_names:
            if ex.arg_dict[n].data.data_ptr() != \
                    bex.arg_dict[n].data.data_ptr():
                raise AssertionError("%s bucket %s: input %s does not view "
                                     "the default bucket's buffer"
                                     % (what, key, n))
        if child._optimizer is not base._optimizer \
                or child._updater is not base._updater \
                or child._fused_holder is not base._fused_holder:
            raise AssertionError("%s bucket %s: its own optimizer"
                                 % (what, key))
    return {"buckets": sorted(mod._buckets), "parameters": len(names),
            "parameter_elements": sum(bex.arg_dict[n].size for n in names),
            "device": str(bex._device)}


def trace_lm_step(torch, mod, batch, metric, steps):
    """``steps`` steps of the default bucket as ``fit`` runs one
    (``forward_backward``, ``update``, ``update_metric``), through
    :func:`trace_calls`."""
    def one():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
    return trace_calls(torch, one, steps)


def trace_calls(torch, one, steps):
    """``steps`` calls of ``one`` under ``torch.profiler``: the device's
    busy share of the traced wall (kernel time over wall time) and the
    CUDA kernels launched a call; the same calls untraced first, each
    ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    untraced = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        untraced.append(time.perf_counter() - t0)
    PROFILER_SESSIONS[0] += 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    busy_us, kernels, top = 0.0, 0, []
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":
            continue
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                us = float(getattr(evt, attr))
                break
        busy_us += us
        kernels += evt.count
        top.append((us / steps, evt.count / steps, evt.key))
    top.sort(reverse=True)
    return {"step_ms_untraced": float(np.median(untraced)) * 1e3,
            "step_ms_traced": wall * 1e3,
            "device_busy_ms": busy_us / steps / 1e3,
            "device_busy_share": busy_us / 1e6 / steps / wall,
            "kernels_a_step": kernels / steps,
            "top_kernels": [{"device_ms": us / 1e3, "per_step": n,
                             "name": k[:80]} for us, n, k in top[:6]]}


def lstm_inference_check(torch, mx, arg_params, batches):
    """(c): ``LSTMInferenceModel`` of ``example/rnn-torch/rnn_model.py``
    from (a)'s parameters steps ``LSTM_INFER_TOKENS`` tokens one at a
    time; each step's distribution against the unrolled graph of that
    many steps at batch 1 on the card."""
    c = LSTM_LM
    rnn_model = _example_module("example/rnn-torch/rnn_model.py",
                                "chip_smoke_rnn_model")
    n = LSTM_INFER_TOKENS
    toks = np.concatenate([t[0] for t, _l, _k in batches])[:n]
    sym = mx.models.lstm.lstm_unroll(c["num_layers"], n, c["vocab"],
                                     num_hidden=c["num_hidden"],
                                     num_embed=c["num_embed"],
                                     num_label=c["vocab"])
    shapes = {"data": (1, n), "softmax_label": (1, n)}
    shapes.update({name: (1, c["num_hidden"]) for name, _s in
                   mx.models.lstm.init_state_shapes(c["num_layers"], 1,
                                                    c["num_hidden"])})
    exe = sym.simple_bind(_lm_ctx(mx), grad_req="null", **shapes)
    exe.copy_params_from(arg_params, allow_extra_params=True)
    exe.arg_dict["data"][:] = toks[None, :]
    want = exe.forward()[0].asnumpy()
    model = rnn_model.LSTMInferenceModel(c["num_layers"], c["vocab"],
                                         c["num_hidden"], c["num_embed"],
                                         c["vocab"], arg_params=arg_params,
                                         ctx=_lm_ctx(mx))
    err, rel, times = 0.0, 0.0, []
    for t in range(n):
        t0 = time.perf_counter()
        got = model.forward(np.array([toks[t]], np.float32),
                            new_seq=(t == 0))[0]
        times.append(time.perf_counter() - t0)
        d = np.abs(got.astype(np.float64) - want[t])
        err = max(err, float(d.max()))
        rel = max(rel, float((d / np.maximum(want[t], 1e-30)).max()))
    out = {"tokens": n, "max_abs_err": err, "max_rel_err": rel,
           "tol": 1e-5, "ms_a_token": float(np.median(times)) * 1e3,
           "device": str(model.executor._device)}
    if not err <= 1e-5:
        raise AssertionError("LSTMInferenceModel: %s, want max abs err <= "
                             "1e-5 against the unrolled %d-step graph"
                             % (out, n))
    return out


def rnn_op_check(torch, timer):
    """(d): the fused RNN op on CUDA tensors against its plain loop on
    the same card (TF32 off): the modes and shapes of ``RNN_OP_CASES``,
    2 layers, both directions, ``state_outputs``.
    The op's float32 outputs, final states and the gradients of data,
    flat parameters and initial states (cuDNN for lstm and gru, the
    loop for the vanilla modes) within RNN_OP_TOL (of the larger of 1
    and each tensor's max-abs) of the plain loop run in float64 on the
    same inputs; beside it, the float32 loop's and cuDNN's own distance
    from float64 in every mode (``ops.rnn.rnn_cudnn`` called directly:
    the op does not take cuDNN's vanilla modes), and the forward and
    backward of the op and of the float32 loop timed."""
    from mxnet_tpu_torch.ops.registry import create_operator
    from mxnet_tpu_torch.ops.rnn import (CUDNN_MODES, rnn_cudnn,
                                         rnn_param_size, rnn_reference)
    gen = torch.Generator().manual_seed(13)

    def err(got, want):
        e = 0.0
        for a, b in zip(got, want):
            a, b = a.detach().double(), b.detach().double()
            e = max(e, float((a - b).abs().max())
                    / max(1.0, float(b.abs().max())))
        return e
    rows = []
    for (seq, batch, in_size, hidden), modes in RNN_OP_CASES:
        for mode in modes:
            for bidir in (False, True):
                ndir = 2 if bidir else 1
                n = rnn_param_size(2, in_size, hidden, bidir, mode)
                host = [torch.randn(seq, batch, in_size, generator=gen),
                        torch.randn(n, generator=gen) * 0.1,
                        torch.randn(ndir * 2, batch, hidden, generator=gen)]
                if mode == "lstm":
                    host.append(torch.randn(ndir * 2, batch, hidden,
                                            generator=gen))
                op = create_operator("RNN", state_size=hidden, num_layers=2,
                                     mode=mode, bidirectional=bidir,
                                     state_outputs=True)

                def leaves(dtype):
                    return [t.to(DEVICE, dtype).requires_grad_(True)
                            for t in host]
                l32, l64 = leaves(torch.float32), leaves(torch.float64)

                def cell(ls):
                    return ls[3] if mode == "lstm" else None

                def the_op():
                    return op.forward(l32, [], True, None)[0]

                def plain(ls):
                    return [t for t in rnn_reference(
                        mode, ls[0], ls[1], ls[2], cell(ls), 2, bidir)
                        if t is not None]
                routes = {"op": the_op(), "plain32": plain(l32),
                          "plain64": plain(l64)}
                if DEVICE == "cuda":
                    routes["cudnn"] = [t for t in rnn_cudnn(
                        mode, l32[0], l32[1], l32[2], cell(l32), 2, bidir)
                        if t is not None]
                cots = [torch.randn(o.shape, generator=gen).to(DEVICE)
                        for o in routes["plain64"]]
                res = {}
                for key, outs in routes.items():
                    ls = l64 if key == "plain64" else l32
                    res[key] = list(outs) + list(torch.autograd.grad(
                        outs, ls, [c.to(ls[0].dtype) for c in cots]))
                row = {"mode": mode, "bidirectional": bidir, "layers": 2,
                       "seq": seq, "batch": batch, "input": in_size,
                       "hidden": hidden,
                       "route": "cudnn" if DEVICE == "cuda"
                       and mode in CUDNN_MODES else "plain loop",
                       "op_vs_plain64": err(res["op"], res["plain64"]),
                       "plain32_vs_plain64": err(res["plain32"],
                                                 res["plain64"]),
                       "tol": RNN_OP_TOL}
                if DEVICE == "cuda":
                    row["cudnn_vs_plain64"] = err(res["cudnn"],
                                                  res["plain64"])
                    row["op_fwd_bwd_ms"] = timer(
                        lambda: torch.autograd.grad(the_op(), l32, cots))
                    row["plain_fwd_bwd_ms"] = timer(
                        lambda: torch.autograd.grad(plain(l32), l32, cots))
                rows.append(row)
                if not row["op_vs_plain64"] <= RNN_OP_TOL:
                    raise AssertionError("RNN op on the card: %s" % row)
    return rows


def phase_lstm(torch, timer, seed, smi):
    """Phase 13: the bucketing LSTM language model on the card at
    ``example/rnn/lstm_bucketing.py``'s defaults and PTB's vocabulary:
    (a) ``BucketingModule.fit`` (the example's route: the fused step,
    leafwise, no hand kernel) with its sharing, binding, witness and
    perplexity gates, step times by bucket, tokens/s, a traced step of
    the 40-bucket, peak memory; (b) ``ShardedTrainer`` on the 40-bucket's
    unrolled graph through the sweep, bit for bit the leafwise update;
    (c) ``LSTMInferenceModel`` against the unrolled graph; (d) the fused
    RNN op against its plain loop, and the bi-LSTM sort example;
    (e) ``gru_bucketing`` with the witness gate."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    t_phase = time.perf_counter()
    c = LSTM_LM
    log("lstm: %s, SGD %s, Xavier(in, 2.34), Perplexity, kvstore local; "
        "%s" % (json.dumps(c), json.dumps(LSTM_SGD),
                "TF32 off (matmul %s, cudnn %s)"
                % (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)))
    # (a) BucketingModule.fit
    mod, batches, params, fit = lm_fit(torch, mx, "lstm", seed,
                                       LSTM_SENTENCES)
    sharing = check_bucket_sharing(mod, "lstm")
    if fit["programs_built"] != len(c["buckets"]) \
            or fit["program_lookups"] != len(c["buckets"]):
        raise AssertionError("lstm fit built %d programs in %d lookups, "
                             "want one a bucket, bound on its first visit "
                             "only (%d)" % (fit["programs_built"],
                                            fit["program_lookups"],
                                            len(c["buckets"])))
    if any(v for k, v in fit["launches"].items() if k != "fused_opt_by_body") \
            or fit["launches"]["fused_opt_by_body"]:
        raise AssertionError("BucketingModule.fit launched hand kernels %s "
                             "(its fused step is leafwise, as in the JAX "
                             "package)" % fit["launches"])
    arg_params = dict(mod.get_params()[0])
    p_after = {n: a.data.clone() for n, a in arg_params.items()}
    outs = mod.get_outputs()[0].data
    witness = lm_witness(torch, "lstm", params, batches, outs, p_after)
    log("lstm witness after %d batches: %s" % (len(batches),
                                                json.dumps(witness)))
    if not witness["ok"]:
        raise AssertionError("lstm fit: float32 further from the plain "
                             "float64 steps than %gx the plain float32 "
                             "steps: %s" % (PRECISION_FACTOR, witness))
    ppl = fit["perplexity_by_batch"]
    head, tail = float(np.mean(ppl[:5])), float(np.mean(ppl[-5:]))
    fit["perplexity_first5"], fit["perplexity_last5"] = head, tail
    if not (np.isfinite(ppl).all() and tail < head):
        raise AssertionError("lstm fit: perplexity did not fall: first "
                             "batches %.2f, last %.2f" % (head, tail))
    log("lstm BucketingModule.fit on %s: %d batches over buckets %s "
        "(%d parameters, %d elements, one tensor each across buckets); "
        "%d programs, each bound on its bucket's first visit; ms a step "
        "by bucket (median) %s; %.1f tokens/s; perplexity %.2f -> %.2f; "
        "peak %.1f MB; no hand kernel; on %s"
        % (sharing["device"], fit["batches"], sharing["buckets"],
           sharing["parameters"], sharing["parameter_elements"],
           fit["programs_built"],
           json.dumps({k: round(v, 3) for k, v in
                       fit["ms_by_bucket"].items()}),
           fit["tokens_per_s"] or 0.0, head, tail,
           fit["peak_bytes"] / 2 ** 20, smi))
    trace = None
    if DEVICE == "cuda":
        base = mod._buckets[mod.default_bucket_key]
        tok, lab, key = next(b for b in batches
                             if b[2] == mod.default_bucket_key)
        states = [(n, (c["batch"], c["num_hidden"]))
                  for n in base._exec_group.data_names[1:]]
        batch = mx.io.DataBatch(
            [mx.nd.array(tok, ctx=mx.cpu())]
            + [mx.nd.zeros(s, ctx=mx.cpu()) for _n, s in states],
            [mx.nd.array(lab, ctx=mx.cpu())], bucket_key=key,
            provide_data=[("data", tok.shape)] + states,
            provide_label=[("softmax_label", lab.shape)])
        trace = trace_lm_step(torch, mod, batch,
                              mx.metric.Perplexity(ignore_label=None),
                              LSTM_TRACED_STEPS)
        log("lstm traced step of the %d-bucket (forward_backward, update, "
            "update_metric): %s" % (key, json.dumps(trace)))
    # (b) ShardedTrainer on the largest bucket's graph, through the sweep
    sym40, data_names, _ = mod._sym_gen(mod.default_bucket_key)
    tok, lab, _key = next(b for b in batches
                          if b[2] == mod.default_bucket_key)
    data = {"data": tok, "softmax_label": lab}
    data.update({n: np.zeros((c["batch"], c["num_hidden"]), np.float32)
                 for n in data_names[1:]})
    runs = {}
    for mode in ("kernel", ""):
        runs[mode] = run_resnet(torch, params, {}, data, LSTM_TRAINER_STEPS,
                                mode, opt_kw=LSTM_SGD, sym=sym40,
                                data_names=tuple(data_names),
                                timed_steps=5 if mode else 0)
    o_k, p_k, _a, s_k, info_k = runs["kernel"]
    o_l, p_l, _a, s_l, info_l = runs[""]
    _want_sweep_only(info_k, 0)
    if any(v for k, v in info_l["launches"].items()
           if k != "fused_opt_by_body") or info_l["launches"][
               "fused_opt_by_body"]:
        raise AssertionError("lstm leafwise trainer launched %s"
                             % info_l["launches"])
    _want_cuda0(torch, "lstm trainer", info_k["devices"])
    same = torch.equal(o_k, o_l) and all(torch.equal(p_k[n], p_l[n])
                                         for n in p_l)
    if not same:
        raise AssertionError("lstm trainer: the sweep's %d steps differ "
                             "from the leafwise update's" % info_k["steps"])
    n_sweep = info_k["bucket_sizes"][0]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / c["batch"],
                              **LSTM_SGD)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 53)
    w = torch.randn(n_sweep, generator=gen, device=DEVICE) * 0.05
    g = torch.randn(n_sweep, generator=gen, device=DEVICE)
    sweep = {"n": n_sweep, "body": fo.sweep_body(opt),
             "mbytes": 4 * n_sweep / 2 ** 20}
    if DEVICE == "cuda":
        lib_step, lib_name = _library_optimizer(torch, "sgd", w, g)
        sweep.update(
            ms=timer(lambda: fo.sweep(opt, w, g, [], 0.01, 1e-5, 1)),
            plain_ms=timer(lambda: fo.sweep_reference(opt, w, g, [], 0.01,
                                                      1e-5, 1)),
            library_ms=timer(lib_step), library=lib_name)
        sweep["bound_ms"], sweep["bound_by"] = bound_ms(3 * 4 * n_sweep, 0)
    trainer = {"kernel": info_k, "leafwise": info_l, "sweep": sweep,
               "bitwise": same}
    log("lstm ShardedTrainer on the %d-bucket graph (data_names %s): "
        "%d steps through the sweep (%d launches, buckets %s, body %d) "
        "bit for bit the leafwise update; %.3f ms a step; the sweep at "
        "%d elements: %s"
        % (mod.default_bucket_key, list(data_names), info_k["steps"],
           info_k["launches"]["fused_opt"], info_k["bucket_sizes"],
           sweep["body"], info_k.get("step_ms", 0.0), n_sweep,
           json.dumps({k: v for k, v in sweep.items()
                       if k.endswith("ms") or k == "library"})))
    del runs
    # (c) stateful inference from (a)'s parameters
    infer = lstm_inference_check(torch, mx, arg_params, batches)
    log("lstm LSTMInferenceModel, %d tokens one at a time on %s: max abs "
        "err %.3g (relative %.3g) against the unrolled graph; %.3f ms a "
        "token" % (infer["tokens"], infer["device"], infer["max_abs_err"],
                   infer["max_rel_err"], infer["ms_a_token"]))
    del mod
    # (d) the fused RNN op, and the bi-LSTM sort example
    rnn_rows = rnn_op_check(torch, timer)
    for r in rnn_rows:
        log("lstm RNN op %(mode)s bidirectional=%(bidirectional)s "
            "(seq %(seq)d, batch %(batch)d, input %(input)d, hidden "
            "%(hidden)d) through %(route)s: %(op_vs_plain64).3g from the "
            "plain loop in float64 (the float32 loop "
            "%(plain32_vs_plain64).3g)" % r
            + ("; cuDNN %.3g; the op %.4f ms, the float32 loop %.4f ms "
               "(forward + backward)"
               % (r["cudnn_vs_plain64"], r["op_fwd_bwd_ms"],
                  r["plain_fwd_bwd_ms"]) if "op_fwd_bwd_ms" in r else ""))
    sort_io = _example_module("example/bi-lstm-sort-torch/sort_io.py",
                              "chip_smoke_sort_io")
    t0 = time.perf_counter()
    acc = float(sort_io.main(ctx=_lm_ctx(mx)))
    sort = {"accuracy": acc, "seconds": time.perf_counter() - t0}
    if not acc > 0.85:
        raise AssertionError("bi-lstm sort on the card: accuracy %.3f"
                             % acc)
    log("lstm bi-lstm-sort example on %s: last-batch per-token accuracy "
        "%.3f in %.1f s" % (DEVICE, acc, sort["seconds"]))
    # (e) gru_bucketing
    gmod, gbatches, gparams, gfit = lm_fit(torch, mx, "gru", seed,
                                           GRU_SENTENCES)
    gshare = check_bucket_sharing(gmod, "gru")
    garg, _ = gmod.get_params()
    gwit = lm_witness(torch, "gru", gparams, gbatches,
                      gmod.get_outputs()[0].data,
                      {n: a.data.clone() for n, a in garg.items()})
    if not gwit["ok"] or sorted(set(gfit["keys"])) != list(c["buckets"]):
        raise AssertionError("gru_bucketing: buckets %s, witness %s"
                             % (sorted(set(gfit["keys"])), gwit))
    log("lstm gru_bucketing on %s: %d batches over buckets %s; ms a step "
        "by bucket %s; witness %s"
        % (gshare["device"], gfit["batches"], gshare["buckets"],
           json.dumps({k: round(v, 3) for k, v in
                       gfit["ms_by_bucket"].items()}), json.dumps(gwit)))
    del gmod
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    log("lstm phase: %.1f s" % (time.perf_counter() - t_phase))
    return {"fit": fit, "sharing": sharing, "witness": witness,
            "trace": trace, "trainer": trainer, "inference": infer,
            "rnn_op": rnn_rows, "sort": sort,
            "gru": {"fit": gfit, "sharing": gshare, "witness": gwit}}


# ----------------------------------------------------------------------
# phase 14: CustomOp and Faster R-CNN
# ----------------------------------------------------------------------
#: the published Faster R-CNN scale: py-faster-rcnn's 600-pixel short
#: side (square, as the example takes: feat 37, 12,321 anchors), PASCAL
#: VOC's 20 classes and background, ProposalProp's default 300 rois
#: after NMS (the symbol asks 4 x 300 before it); the backbone's widths
#: are the symbol's own (32-128 channels)
RCNN = dict(image_size=600, num_classes=21, rois=300)
RCNN_WARM_STEPS = 2
RCNN_TIMED_STEPS = 10
RCNN_TRACED_STEPS = 2
#: the example's plain SGD through host arrays, at a rate under which
#: its unnormalized losses (the RPN's over 12,321 anchors, the
#: regression head's ones as head gradients) stay finite over the run;
#: the example's own 0.01 diverges within a few steps at this scale, and
#: 1e-5 by the sixth
RCNN_LR = 1e-7
#: (b): the steps whose float32 step is held to float64 on the card
#: (rois fixed to the float32 step's), and the tolerances, each of the
#: float64 tensor's max-abs.  conv1's weight gradient sums the products
#: of positive pixels and gradients of both signs over every position
#: (360,000 at 600 x 600) and cancels: the port's float32 step on the
#: CPU already lies 1.1e-3 from float64 there at 320 x 320, where every
#: other tensor lies under 1e-6
RCNN_F64_STEPS = (0, RCNN_WARM_STEPS + RCNN_TIMED_STEPS - 1)
RCNN_OUT_TOL = 1e-4
RCNN_GRAD_TOL = 1e-2
#: (c): ROIPooling's gradient on the card against the CPU, of its
#: max-abs (the forward must be bitwise)
ROI_GRAD_TOL = 1e-6
#: (d): custom_softmax's accuracy on the card against the CPU
SOFTMAX_ACC_TOL = 1e-6
#: (e): each new op in float32 on the card against float64 on the card,
#: of the larger of 1 and the float64 tensor's max-abs
NEW_OP_FWD_TOL = 1e-5
NEW_OP_GRAD_TOL = 1e-4


def _entry_name(entry):
    node, i = entry
    if node.is_variable:
        return node.name
    return "%s_%s" % (node.name, node.op.list_outputs()[i])


def _rel_err(torch, got, want, floor=0.0):
    """max |got - want| over the larger of ``floor`` and want's max-abs
    (0 when both are zero)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if not want.numel():
        return 0.0
    err = float((got - want).abs().max())
    scale = max(floor, float(want.abs().max()))
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / scale


def _register_fixed_rois(mx, holder):
    """A Custom op with the proposal's arguments that outputs
    ``holder["rois"]`` and hands zeros back: (b)'s float64 step runs the
    graph with the float32 step's rois."""
    class FixedRois(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], holder["rois"])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for g in in_grad:
                g[...] = 0.0

    @mx.operator.register("chip_smoke_fixed_rois")
    class FixedRoisProp(mx.operator.CustomOpProp):
        def __init__(self, rpn_post_nms_top_n="300"):
            super().__init__(need_top_grad=False)
            self._post = int(rpn_post_nms_top_n)

        def list_arguments(self):
            return ["cls_prob", "bbox_pred", "im_info"]

        def infer_shape(self, in_shape):
            return in_shape, [[self._post, 5]], []

        def create_operator(self, ctx, shapes, dtypes):
            return FixedRois()


def rcnn_f64_step(torch, mx, sym_json, args32, rois, holder):
    """(b): the graph in float64 on the card from the float32 step's
    arguments, the proposal node swapped for one that outputs that
    step's rois (the JSON's ``op_type``; ``load_json`` drops the
    proposal's other kwargs): its outputs and gradients."""
    holder["rois"] = rois
    sym = mx.sym.load_json(sym_json.replace('"op_type": "proposal"',
                                            '"op_type": '
                                            '"chip_smoke_fixed_rois"'))
    ctx = _lm_ctx(mx)
    args = {n: mx.nd.NDArray(t.double()) for n, t in args32.items()}
    grads = {n: mx.nd.zeros(tuple(t.shape), ctx=ctx, dtype="float64")
             for n, t in args32.items()}
    ex = sym.bind(ctx, args, args_grad=grads, grad_req="write")
    outs = [o.data for o in ex.forward(is_train=True)]
    ex.backward()
    return outs, {n: g.data for n, g in ex.grad_dict.items()}


def rcnn_roipool_check(torch, timer, feat, rois, seed):
    """(c): ROIPooling at the step's shapes, its feature map with a
    14 x 14 patch zeroed and its last roi over that patch (7 x 7 bins of
    four tied zeros each): forward bit for bit the CPU's, gradient within
    ``ROI_GRAD_TOL``; the patch's roi alone gives each tied zero a
    quarter of its bin's gradient, on both; times and peak memory."""
    from mxnet_tpu_torch.ops.vision import _ROIPoolingFn
    ph = pw = 7
    scale = 1.0 / 16
    data = feat.detach().float().clone()
    data[:, :, 4:18, 4:18] = 0.0
    rois = rois.detach().float().clone()
    rois[-1] = torch.tensor([0.0, 64.0, 64.0, 272.0, 272.0])
    gen = torch.Generator().manual_seed(seed + 71)
    cot = torch.randn((rois.shape[0], data.shape[1], ph, pw), generator=gen)

    def run(dev, rr, cc):
        d = data.to(dev).requires_grad_()
        out = _ROIPoolingFn.apply(d, rr.to(dev), ph, pw, scale)
        g, = torch.autograd.grad(out, d, cc.to(dev))
        return out.detach().cpu(), g.cpu()
    out_d, g_d = run(DEVICE, rois, cot)
    out_c, g_c = run("cpu", rois, cot)
    res = {"shapes": {"data": list(data.shape), "rois": list(rois.shape),
                      "pooled": [ph, pw]},
           "forward_bitwise": bool(torch.equal(out_d, out_c)),
           "grad_rel_err": _rel_err(torch, g_d, g_c),
           "grad_max_abs": float(g_c.abs().max())}
    want = (cot[-1] / 4.0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    for label, dev in (("card", DEVICE), ("cpu", "cpu")):
        _o, g = run(dev, rois[-1:], cot[-1:])
        res["tied_quarters_" + label] = bool(
            torch.equal(g[0, :, 4:18, 4:18], want))
    if DEVICE == "cuda":
        d = data.to(DEVICE)
        dg = d.clone().requires_grad_()
        r = rois.to(DEVICE)
        cd = cot.to(DEVICE)
        with torch.no_grad():
            res["forward_ms"] = timer(
                lambda: _ROIPoolingFn.apply(d, r, ph, pw, scale))
        res["forward_backward_ms"] = timer(
            lambda: torch.autograd.grad(
                _ROIPoolingFn.apply(dg, r, ph, pw, scale), dg, cd))
        res["backward_ms"] = res["forward_backward_ms"] - res["forward_ms"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(_ROIPoolingFn.apply(dg, r, ph, pw, scale), dg,
                            cd)
        torch.cuda.synchronize()
        res["forward_backward_peak_mb"] = (
            torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return res


def _u32(*shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def _n32(*shape):
    return lambda r: r.randn(*shape).astype(np.float32)


def _labels(n, hi):
    return lambda r: r.randint(0, hi, (n,)).astype(np.float32)


def _fixed(a):
    return lambda r: np.asarray(a, np.float32)


#: (e): every op name this slice registers, at a small shape: (name,
#: attrs, input makers, aux makers); the samplers, rrelu and the legacy
#: ``_Native``/``_NDArray`` are checked apart
NEW_OP_CASES = [
    ("abs", {}, [_u32(3, 4)], []), ("ceil", {}, [_u32(3, 4)], []),
    ("cos", {}, [_u32(3, 4)], []), ("exp", {}, [_u32(3, 4)], []),
    ("floor", {}, [_u32(3, 4)], []),
    ("log", {}, [_u32(3, 4, lo=0.1, hi=3.0)], []),
    ("negative", {}, [_n32(3, 4)], []), ("_Negative", {}, [_n32(3, 4)], []),
    ("round", {}, [_fixed([[0.5, 1.5, 2.5, -0.5], [-1.5, 0.4, 2.6, 3.0]])],
     []),
    ("rsqrt", {}, [_u32(3, 4, lo=0.1, hi=3.0)], []),
    ("sign", {}, [_u32(3, 4)], []), ("sin", {}, [_u32(3, 4)], []),
    ("sqrt", {}, [_u32(3, 4, lo=0.1, hi=3.0)], []),
    ("square", {}, [_n32(3, 4)], []), ("identity", {}, [_n32(3, 4)], []),
    ("_copy", {}, [_n32(3, 4)], []), ("_CrossDeviceCopy", {}, [_n32(3, 4)],
                                      []),
    ("dot", dict(transpose_b=True), [_n32(3, 4), _n32(5, 4)], []),
    ("batch_dot", {}, [_n32(2, 3, 4), _n32(2, 4, 5)], []),
    ("broadcast_axis", dict(axis=(1,), size=(5,)), [_n32(3, 1, 4)], []),
    ("broadcast_to", dict(shape=(0, 5, 0)), [_n32(3, 1, 4)], []),
    ("norm", {}, [_n32(3, 4)], []),
    ("argmax_channel", {}, [_n32(4, 5)], []),
    ("flip", dict(axis=1), [_n32(2, 3, 4)], []),
    ("slice_axis", dict(axis=1, begin=1, end=3), [_n32(2, 5, 3)], []),
    ("smooth_l1", {}, [_u32(3, 5, lo=-3.0, hi=3.0)], []),
    ("softmax_cross_entropy", {}, [_n32(4, 5), _labels(4, 5)], []),
    ("element_mask", {}, [_n32(4, 3, 2), _fixed([1, 0, 1, 1])], []),
    ("LeakyReLU", dict(act_type="prelu"), [_n32(2, 3, 4, 4),
                                           _u32(3, lo=0.0, hi=0.5)], []),
    ("Deconvolution", dict(kernel=(4, 4), num_filter=3, stride=(2, 2),
                           pad=(1, 1)),
     [_n32(2, 4, 5, 5), _n32(4, 3, 4, 4), _n32(3)], []),
    ("UpSampling", dict(scale=2, sample_type="bilinear"), [_n32(1, 2, 3, 4)],
     []),
    ("Crop", dict(num_args=2, center_crop=True),
     [_n32(2, 3, 7, 6), _n32(2, 1, 4, 3)], []),
    ("L2Normalization", dict(mode="channel"), [_n32(2, 3, 4)], []),
    ("BlockGrad", {}, [_n32(3, 4)], []),
    ("SoftmaxActivation", dict(mode="channel"), [_n32(2, 3, 4, 2)], []),
    ("LinearRegressionOutput", {}, [_n32(4, 3), _n32(4, 3)], []),
    ("LogisticRegressionOutput", {}, [_n32(4, 3), _u32(4, 3, lo=0.0, hi=1.0)],
     []),
    ("MAERegressionOutput", {}, [_n32(4, 3), _n32(4, 3)], []),
    ("MakeLoss", dict(normalization="batch"), [_n32(3, 4)], []),
    ("SVMOutput", {}, [_n32(4, 5), _labels(4, 5)], []),
    ("IdentityAttachKLSparseReg", {}, [_u32(4, 3, 2, 2, lo=0.05, hi=0.95)],
     [_u32(3, lo=0.1, hi=0.5)]),
    ("ROIPooling", dict(pooled_size=(2, 2), spatial_scale=0.5),
     [lambda r: np.maximum(r.randn(2, 3, 6, 6), 0).astype(np.float32),
      _fixed([[0, 0, 0, 9, 9], [1, 2, 1, 11, 7], [0, 4, 4, 5, 5]])], []),
    ("SpatialTransformer", dict(transform_type="affine",
                                sampler_type="bilinear"),
     [_n32(2, 3, 5, 6),
      lambda r: (np.array([0.9, 0.1, 0.05, -0.1, 1.1, 0.0])
                 + 0.05 * r.randn(2, 6)).astype(np.float32)], []),
    ("Correlation", dict(kernel_size=3, max_displacement=2, pad_size=2),
     [_n32(1, 2, 6, 6), _n32(1, 2, 6, 6)], []),
    ("Custom", dict(op_type="chip_smoke_sigmoid"), [_n32(3, 4)], []),
]
NEW_SAMPLERS = (("_sample_uniform", dict(low=-1.0, high=3.0)),
                ("uniform", {}), ("_sample_normal", dict(loc=2.0, scale=0.5)),
                ("normal", {}))


def _register_sigmoid(mx):
    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + np.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @mx.operator.register("chip_smoke_sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class Cube(mx.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][...] = in_data[0] ** 3

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][...] = 3.0 * in_data[0] ** 2 * out_grad[0]
    return Cube


def _op_on_card(torch, op, inputs, aux, cot, dtype):
    ins = [torch.from_numpy(x).to(DEVICE, dtype).requires_grad_()
           for x in inputs]
    outs, upd = op.forward(ins, [torch.from_numpy(a).to(DEVICE, dtype)
                                 for a in aux], True, None)
    live = [(o, torch.from_numpy(c).to(DEVICE, dtype))
            for o, c in zip(outs, cot) if o.requires_grad]
    grads = [None] * len(ins)
    if live:
        grads = torch.autograd.grad([o for o, _ in live], ins,
                                    [c for _, c in live], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, ins)]
    return ([o.detach() for o in outs], [u.detach() for u in upd or []],
            grads)


def new_ops_check(torch, mx, seed):
    """(e): every op name this slice registers, once on the card: the
    forward and the vjp of a seeded cotangent in float32 against the same
    in float64 (the samplers and rrelu: bounds and moments of their
    draws; ``_Native``/``_NDArray`` through a bound symbol)."""
    from mxnet_tpu_torch.ops.registry import create_operator
    cube = _register_sigmoid(mx)
    rows, names = [], set()
    for i, (name, attrs, makers, aux_makers) in enumerate(NEW_OP_CASES):
        rng = np.random.RandomState(seed + 1000 + i)
        inputs = [m(rng) for m in makers]
        aux = [m(rng) for m in aux_makers]
        op = create_operator(name, **attrs)
        out_shapes = op.infer_shape([x.shape for x in inputs])[1]
        cot = [rng.randn(*s).astype(np.float32) for s in out_shapes]
        o32, u32, g32 = _op_on_card(torch, op, inputs, aux, cot,
                                    torch.float32)
        o64, u64, g64 = _op_on_card(torch, op, inputs, aux, cot,
                                    torch.float64)
        fwd = max(_rel_err(torch, a, b, 1.0) for a, b in zip(o32 + u32, o64 + u64))
        grad = max([_rel_err(torch, a, b, 1.0) for a, b in zip(g32, g64)] or [0])
        devices = {str(t.device) for t in o32 + list(g32)}
        ok = fwd <= NEW_OP_FWD_TOL and grad <= NEW_OP_GRAD_TOL and \
            devices == {str(torch.device(DEVICE, 0) if DEVICE == "cuda"
                            else torch.device("cpu"))}
        rows.append({"op": name, "attrs": attrs, "forward_err": fwd,
                     "grad_err": grad, "ok": ok})
        names.add(name)
    n = 100000
    for name, attrs in NEW_SAMPLERS:
        s = getattr(mx.sym, name)(shape=(n,), **attrs)
        d = s.simple_bind(_lm_ctx(mx)).forward(is_train=False)[0].data
        d = d.double()
        if "uniform" in name:
            lo, hi = attrs.get("low", 0.0), attrs.get("high", 1.0)
            mean, std = (lo + hi) / 2, (hi - lo) / math.sqrt(12)
            inside = bool(d.min() >= lo and d.max() < hi)
        else:
            mean, std = attrs.get("loc", 0.0), attrs.get("scale", 1.0)
            inside = True
        m_err = abs(float(d.mean()) - mean) / (std / math.sqrt(n))
        s_err = abs(float(d.std()) - std) / (std / math.sqrt(2 * n))
        rows.append({"op": name, "attrs": attrs, "mean_in_se": m_err,
                     "std_in_se": s_err, "device": str(d.device),
                     "ok": inside and m_err < 5 and s_err < 5})
        names.add(name)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 2)
    x = -torch.rand(n, device=DEVICE) - 0.01
    rr = create_operator("LeakyReLU", act_type="rrelu", lower_bound=0.1,
                         upper_bound=0.3)
    slope = (rr.forward([x], [], True, gen)[0][0] / x).double()
    rows.append({"op": "LeakyReLU", "attrs": {"act_type": "rrelu"},
                 "slope_min": float(slope.min()),
                 "slope_max": float(slope.max()),
                 "ok": bool(slope.min() >= 0.1 and slope.max() < 0.3)})
    a = np.random.RandomState(seed + 3).randn(3, 4)
    for name in ("_Native", "_NDArray"):
        got = {}
        for dt in ("float32", "float64"):
            s = cube().get_symbol(data=mx.sym.Variable("x"))
            ex = s.simple_bind(_lm_ctx(mx), grad_req="write",
                               type_dict={"x": dt}, x=a.shape)
            ex.arg_dict["x"][:] = a.astype(dt)
            out = ex.forward(is_train=True)[0].data
            ex.backward([mx.nd.NDArray(torch.ones_like(out))])
            got[dt] = (out, ex.grad_dict["x"].data)
        fwd = _rel_err(torch, got["float32"][0], got["float64"][0], 1.0)
        grad = _rel_err(torch, got["float32"][1], got["float64"][1], 1.0)
        rows.append({"op": name, "forward_err": fwd, "grad_err": grad,
                     "ok": fwd <= NEW_OP_FWD_TOL and grad <= NEW_OP_GRAD_TOL})
        names.add(name)
    return rows, sorted(names)


def rcnn_proposal_rois(prop, cls_prob, bbox_pred, im_info):
    """(a): the example's numpy ProposalOp (the graph node's own prop) on
    host copies of one step's inputs."""
    shapes = [tuple(x.shape) for x in (cls_prob, bbox_pred, im_info)]
    op = prop.create_operator(None, shapes, [np.float32] * 3)
    out = [np.zeros(tuple(s), np.float32)
           for s in prop.infer_shape([list(s) for s in shapes])[1]]
    op.forward(False, ["write"] * len(out), [cls_prob, bbox_pred, im_info],
               out, [])
    return out[0]


def phase_rcnn(torch, timer, seed, smi):
    """Phase 14: ``example/rcnn-torch`` at the published Faster R-CNN
    scale (600 x 600, 21 classes, 300 rois) on the card, 2 warm and 10
    timed steps of the example's step (forward, backward with its head
    gradients, its host SGD), with gates: (a) each step's rois bit for
    bit the example's numpy ProposalOp on that step's inputs copied to
    the host; (b) the first and last steps in float32 held to the same
    step in float64 on the card with the rois fixed (the four outputs and
    every parameter's gradient); (c) ROIPooling on the card against the
    CPU at the step's shapes; (d) ``example/numpy-ops-torch/
    custom_softmax.py`` through ``Module.fit`` on the card against the
    CPU; (e) every new op name once on the card against float64.  It
    prints ms a step, the Custom op's host time and copies, ROIPooling's
    times, the phase's peak memory and the busy share of traced steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import operator as op_mod
    t_phase = time.perf_counter()
    counts0 = read_counts()
    peak_reset(torch)
    c = RCNN
    te = _example_module("example/rcnn-torch/train_end2end.py",
                         "chip_smoke_rcnn")
    ctx = _lm_ctx(mx)
    mx.random.seed(seed)
    exe, shapes = te.bind(ctx, c["image_size"], c["num_classes"], c["rois"])
    te.init_params(exe, shapes)
    te.fill_inputs(exe, c["image_size"], c["num_classes"], c["rois"], seed)
    topo = exe._symbol._topo()
    prop_node = next(n for n in topo if n.op is not None
                     and n.op.op_name == "Custom")
    roi_node = next(n for n in topo if n.op is not None
                    and n.op.op_name == "ROIPooling")
    want = {_entry_name(prop_node.inputs[0]): "cls_prob",
            _entry_name(prop_node.inputs[1]): "bbox_pred",
            _entry_name(roi_node.inputs[0]): "conv_feat"}
    captured = {}

    def monitor(name, arr):
        if name in want:
            captured[want[name]] = arr.data
    exe.set_monitor_callback(monitor)
    im_info = exe.arg_dict["im_info"].asnumpy()
    params = [n for n in exe._arg_names if n.endswith(("weight", "bias"))]
    holder = {}
    _register_fixed_rois(mx, holder)
    sym_json = exe._symbol.tojson()
    log("rcnn: %s, %d parameters (%d elements), SGD lr %g through host "
        "arrays; %d + %d steps, the monitor on (it keeps the proposal's and "
        "ROIPooling's inputs); %s"
        % (json.dumps(c), len(params),
           sum(exe.arg_dict[n].data.numel() for n in params), RCNN_LR,
           RCNN_WARM_STEPS, RCNN_TIMED_STEPS, _cudnn_settings(torch)))
    fb_ms, upd_ms, f64, n_rois = [], [], [], []
    steps = RCNN_WARM_STEPS + RCNN_TIMED_STEPS
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    host = dict.fromkeys(op_mod.host_stats(), 0)
    for step in range(steps):
        args32 = {n: a.data.clone() for n, a in exe.arg_dict.items()} \
            if step in RCNN_F64_STEPS else None
        sync()
        op_mod.host_stats(reset=True)
        t0 = time.perf_counter()
        outs = exe.forward(is_train=True)
        exe.backward()
        sync()
        t1 = time.perf_counter()
        if args32 is not None:
            outs32 = [o.data.clone() for o in outs]
            grads32 = {n: exe.grad_dict[n].data.clone() for n in params}
        te.sgd_step(exe, RCNN_LR)
        sync()
        t2 = time.perf_counter()
        if step >= RCNN_WARM_STEPS:
            fb_ms.append((t1 - t0) * 1e3)
            upd_ms.append((t2 - t1) * 1e3)
            for k, v in op_mod.host_stats().items():
                host[k] += v
        rois = outs[3].asnumpy()
        ref = rcnn_proposal_rois(prop_node.op.prop,
                                 captured["cls_prob"].cpu().numpy(),
                                 captured["bbox_pred"].cpu().numpy(),
                                 im_info)
        if not np.array_equal(rois, ref):
            raise AssertionError("rcnn step %d: the rois differ from the "
                                 "example's ProposalOp on the step's own "
                                 "inputs (%d rows)" % (
                                     step, int((rois != ref).any(1).sum())))
        if not all(bool(torch.isfinite(o.data).all()) for o in outs):
            raise AssertionError("rcnn step %d: non-finite outputs" % step)
        widths = rois[:, 3] - rois[:, 1] + 1
        n_rois.append(int(len(np.unique(rois, axis=0))))
        if args32 is not None:
            o64, g64 = rcnn_f64_step(torch, mx, sym_json, args32,
                                     rois.astype(np.float64), holder)
            row = {"step": step,
                   "outputs": {n: _rel_err(torch, a, b) for n, a, b in
                               zip(exe._out_names, outs32, o64)},
                   "grads": {n: _rel_err(torch, grads32[n], g64[n])
                             for n in params}}
            row["max_output_err"] = max(row["outputs"].values())
            row["max_grad_err"] = max(row["grads"].values())
            row["worst_grad"] = max(row["grads"], key=row["grads"].get)
            f64.append(row)
            if row["max_output_err"] > RCNN_OUT_TOL or \
                    row["max_grad_err"] > RCNN_GRAD_TOL:
                raise AssertionError("rcnn step %d: float32 against float64 "
                                     "on the card: %s" % (step,
                                                          json.dumps(row)))
            del args32, outs32, grads32
        log("rcnn step %d: %.3f ms forward+backward, %.3f ms update; rois "
            "bit for bit the ProposalOp's (%d distinct, widths %.1f-%.1f)"
            % (step, (t1 - t0) * 1e3, (t2 - t1) * 1e3, n_rois[-1],
               float(widths.min()), float(widths.max())))
    exe.set_monitor_callback(None)
    step_ms = [a + b for a, b in zip(fb_ms, upd_ms)]
    fit = {"steps": steps, "timed": RCNN_TIMED_STEPS,
           "ms_a_step": float(np.median(step_ms)),
           "ms_a_step_all": step_ms,
           "forward_backward_ms": float(np.median(fb_ms)),
           "update_ms": float(np.median(upd_ms)),
           "distinct_rois": n_rois,
           "custom_op": {
               "forward_calls": host["forward_calls"],
               "backward_calls": host["backward_calls"],
               "forward_ms": host["forward_s"] * 1e3
               / max(1, host["forward_calls"]),
               "backward_ms": host["backward_s"] * 1e3
               / max(1, host["backward_calls"]),
               "forward_user_ms": host["forward_user_s"] * 1e3
               / max(1, host["forward_calls"]),
               "backward_user_ms": host["backward_user_s"] * 1e3
               / max(1, host["backward_calls"]),
               "to_host_bytes_a_step": host["to_host_bytes"]
               / RCNN_TIMED_STEPS,
               "to_device_bytes_a_step": host["to_device_bytes"]
               / RCNN_TIMED_STEPS}}
    log("rcnn on %s: %.3f ms a step (median of %d; forward+backward %.3f, "
        "host SGD %.3f); the Custom op a step: forward %.3f ms (user %.3f), "
        "backward %.3f ms (user %.3f), %d bytes to the host and %d back; "
        "float32 against float64 %s; on %s"
        % (DEVICE, fit["ms_a_step"], RCNN_TIMED_STEPS,
           fit["forward_backward_ms"], fit["update_ms"],
           fit["custom_op"]["forward_ms"], fit["custom_op"]["forward_user_ms"],
           fit["custom_op"]["backward_ms"],
           fit["custom_op"]["backward_user_ms"],
           fit["custom_op"]["to_host_bytes_a_step"],
           fit["custom_op"]["to_device_bytes_a_step"],
           json.dumps([{k: r[k] for k in ("step", "max_output_err",
                                          "max_grad_err", "worst_grad")}
                       for r in f64]), smi))
    # (c) ROIPooling against the CPU
    roi = rcnn_roipool_check(torch, timer, captured["conv_feat"],
                             outs[3].data, seed)
    log("rcnn ROIPooling %s on %s against the CPU: %s; on %s"
        % (json.dumps(roi["shapes"]), DEVICE,
           json.dumps({k: v for k, v in roi.items() if k != "shapes"}), smi))
    if not (roi["forward_bitwise"] and roi["grad_rel_err"] <= ROI_GRAD_TOL
            and roi["tied_quarters_card"] and roi["tied_quarters_cpu"]):
        raise AssertionError("rcnn ROIPooling on the card: %s" % roi)
    # (d) custom_softmax through Module.fit, card against CPU
    cs = _example_module("example/numpy-ops-torch/custom_softmax.py",
                         "chip_smoke_custom_softmax")
    t0 = time.perf_counter()
    acc_cpu = float(cs.main(ctx=mx.cpu(), seed=seed))
    t1 = time.perf_counter()
    acc_dev = float(cs.main(ctx=ctx, seed=seed))
    t2 = time.perf_counter()
    softmax = {"accuracy_cpu": acc_cpu, "accuracy_card": acc_dev,
               "seconds_cpu": t1 - t0, "seconds_card": t2 - t1}
    log("rcnn custom_softmax Module.fit: accuracy %.6f on %s, %.6f on the "
        "CPU (%.2f s, %.2f s)" % (acc_dev, DEVICE, acc_cpu,
                                  softmax["seconds_card"],
                                  softmax["seconds_cpu"]))
    if abs(acc_dev - acc_cpu) > SOFTMAX_ACC_TOL:
        raise AssertionError("custom_softmax: accuracy %.6f on the card, "
                             "%.6f on the CPU" % (acc_dev, acc_cpu))
    # (e) every new op once on the card
    op_rows, op_names = new_ops_check(torch, mx, seed)
    bad = [r for r in op_rows if not r["ok"]]
    log("rcnn new ops on %s: %d names, %d checks, worst forward %.3g, "
        "worst gradient %.3g (float32 against float64)"
        % (DEVICE, len(op_names), len(op_rows),
           max(r.get("forward_err", 0.0) for r in op_rows),
           max(r.get("grad_err", 0.0) for r in op_rows)))
    if bad or len(op_names) != 51:
        raise AssertionError("new ops on the card: %d names; failing %s"
                             % (len(op_names), json.dumps(bad)))
    # the device's busy share over traced steps, the monitor off
    trace = None
    if DEVICE == "cuda":
        def one():
            exe.forward(is_train=True)
            exe.backward()
            te.sgd_step(exe, RCNN_LR)
        trace = trace_calls(torch, one, RCNN_TRACED_STEPS)
        log("rcnn traced step (forward, backward, host SGD): %s"
            % json.dumps(trace))
    counts = read_counts()
    launched = {k: counts[k] - counts0[k] for k in counts0
                if k != "fused_opt_by_body" and counts[k] != counts0[k]}
    if launched:
        raise AssertionError("phase 14 launched hand kernels %s (no Pallas "
                             "kernel lies on this path)" % launched)
    fit["peak_mb"] = peak_bytes(torch) / 2 ** 20
    log("rcnn phase: %.1f s, peak %.1f MB; no hand kernel; on %s"
        % (time.perf_counter() - t_phase, fit["peak_mb"], smi))
    del exe
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"fit": fit, "float64": f64, "roipooling": roi,
            "custom_softmax": softmax, "new_ops": op_rows, "trace": trace}


# ----------------------------------------------------------------------
# phase 8: the imperative NDArray surface and runtime-compiled kernels
# ----------------------------------------------------------------------
#: phase 8's arrays, and the element count its elementwise kernels are
#: timed at (2^24 float32: 64 MiB an array)
IMPERATIVE_SHAPE = (4096, 4096)
RTC_TIMED_N = 1 << 24
#: the spin before each timed launch (about 100 us at the H100's 1.98 GHz
#: boost clock): every phase's timer has it
LEAD_CYCLES = 200000


def _ulps(torch, got, want):
    """Largest |got - want| in units of the float32 spacing at want."""
    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return float(((got - want).abs() / spacing).max())


def _np_ulps(got, want):
    a = np.abs(want)
    spacing = np.nextafter(a, np.float32(np.inf)) - a
    return float(np.max(np.abs(got - want) / spacing))


def _gelu_torch(x):
    """tanh-GELU on tensors (``example/rtc/pallas_kernel.py``'s)."""
    c = 0.7978845608
    return 0.5 * x * (1.0 + (c * (x + 0.044715 * x ** 3)).tanh())


def phase_imperative(torch, seed):
    """The user's path of the imperative surface, at (4096, 4096) float32:
    NDArrays made under ``with mx.gpu(0):`` with no ``ctx``, arithmetic,
    views that write through, in-place operators, registered functions,
    a sampler with ``out=`` into a view, the kernels (a)-(e) pushed
    through ``mx.rtc.Rtc`` with their grid and block, and a function
    pushed with ``pallas=False``; each result is held against numpy.
    Returns the Rtc launches of this run (the counter is reset first)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc as rtc_mod
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    rng = np.random.default_rng(seed + 8)
    rows, cols = IMPERATIVE_SHAPE
    xn = rng.random((rows, cols), dtype=np.float32)
    yn = rng.random((rows, cols), dtype=np.float32)
    vn = rng.random((cols, 256), dtype=np.float32)
    idx_n = rng.integers(0, cols, rows).astype(np.float32)
    xb_n, yb_n = (torch.from_numpy(a * 4 - 2).bfloat16().float().numpy()
                  for a in (xn, yn))
    errs = {}

    def check(what, got, want, tol, how="abs"):
        """``how``: 'abs' max |diff|, 'rel' max |diff| / max |want|,
        'ulp' float32 ulps at want; tol 0 means bit for bit."""
        got = got.asnumpy() if hasattr(got, "asnumpy") else got
        want = np.asarray(want, dtype=np.float32)
        if got.shape != want.shape:
            raise AssertionError("imperative %s: shape %s, want %s"
                                 % (what, got.shape, want.shape))
        if how == "ulp":
            err = _np_ulps(got, want)
        else:
            err = float(np.max(np.abs(got - want)))
            if how == "rel":
                err /= float(np.max(np.abs(want)))
        errs[what] = err
        if not err <= tol:
            raise AssertionError("imperative %s: error %g > %g (%s)"
                                 % (what, err, tol, how))

    grid = ((rows * cols + 255) // 256, 1, 1)
    rtc_mod.launches = 0
    t0 = time.perf_counter()
    with mx.gpu(0):
        x, y, v, idx = (mx.nd.array(a) for a in (xn, yn, vn, idx_n))
        if x.context != mx.gpu(0) or x.data.device.type != DEVICE:
            raise AssertionError("an array made under gpu(0) with no ctx "
                                 "lies on %s" % x.context)
        # arithmetic and comparisons: the same IEEE float32 operations
        # as numpy, bit for bit
        check("arithmetic", (x * y + 1) / (y + 0.5) - x,
              (xn * yn + 1) / (yn + 0.5) - xn, 0)
        check("comparisons", (x > y) * 3 - (x <= 0.25),
              (xn > yn) * 3.0 - (xn <= 0.25), 0)
        # views write through; in-place operators
        w, wn = mx.nd.array(xn), xn.copy()
        w[1:3][:] = 7.0
        wn[1:3] = 7.0
        w.reshape((rows * 2, cols // 2))[5][:] = -1.0
        wn.reshape(rows * 2, cols // 2)[5] = -1.0
        part = w[10:20]
        part += y[10:20]
        wn[10:20] += yn[10:20]
        w *= 2
        w -= 1
        w /= 4
        wn = (wn * 2 - 1) / 4
        check("views and in-place", w, wn, 0)
        # registered functions: products and sums in another order than
        # numpy's float64 (relative to the largest value), the rest exact
        check("dot", mx.nd.dot(x, v), xn.astype(np.float64) @ vn, 1e-5,
              "rel")
        check("sum", mx.nd.sum(x, axis=1), xn.astype(np.float64).sum(1),
              1e-5, "rel")
        check("argmax", mx.nd.argmax(x, axis=1), np.argmax(xn, axis=1), 0)
        oh = mx.nd.zeros((rows, cols))
        mx.nd.onehot_encode(idx, oh)
        check("onehot_encode", oh, np.eye(cols, dtype=np.float32)[
            idx_n.astype(np.int64)], 0)
        check("choose_element_0index", mx.nd.choose_element_0index(x, idx),
              xn[np.arange(rows), idx_n.astype(np.int64)], 0)
        u = mx.nd.zeros((rows, cols))
        mx.random.uniform(-1.0, 2.0, out=u[100:200])
        un = u.asnumpy()
        drawn = un[100:200]
        if not (drawn.min() >= -1.0 and drawn.max() < 2.0
                and abs(drawn.mean() - 0.5) < 0.01
                and not un[:100].any() and not un[200:].any()):
            raise AssertionError("random.uniform(out=view): range [%g, %g], "
                                 "mean %g" % (drawn.min(), drawn.max(),
                                              drawn.mean()))
        # the kernels, pushed as a user would: one element a thread at
        # [0, 1) inputs (NVRTC's FMA against numpy's two roundings:
        # 1 ulp), expf (2 ulp from exact, 2.5 from the rounded float64
        # value), and the bfloat16 and transpose kernels bit for bit
        (a_out,) = mx.rtc.Rtc(rk.XY_PLUS_ONE, pallas=True).push(
            [x, y], grid, (256, 1, 1))
        check("rtc x*y+1", a_out, xn * yn + 1, 1.0, "ulp")
        (b_out,) = mx.rtc.Rtc(rk.SAXPY, pallas=True).push(
            [x, y], grid, (256, 1, 1))
        check("rtc 2.5x+y", b_out, 2.5 * xn + yn, 1.0, "ulp")
        e = x[0].slice(0, 10) * 2 - 1
        en = xn[0, :10] * 2 - 1
        (c_out,) = mx.rtc.Rtc(rk.EXP_SHARED, pallas=True).push(
            [e], (1, 1, 1), (10, 1, 1))
        check("rtc exp(5x) shared", c_out,
              np.exp((en * np.float32(5)).astype(np.float64)), 2.5, "ulp")
        xb = mx.nd.array(xb_n, dtype=torch.bfloat16)
        yb = mx.nd.array(yb_n, dtype=torch.bfloat16)
        d0, d1 = mx.rtc.Rtc(rk.ADD_MUL_BF16, n_outputs=2, pallas=True,
                            out_dtypes=["float32", "float32"]).push(
            [xb, yb], grid, (256, 1, 1))
        check("rtc bf16 x+y", d0, xb_n + yb_n, 0)
        check("rtc bf16 x*y", d1, xb_n * yb_n, 0)
        (e_out,) = mx.rtc.Rtc(rk.TRANSPOSE, pallas=True,
                              out_shapes=[(cols, rows)]).push(
            [x], ((cols + 31) // 32, (rows + 31) // 32, 1), (32, 8, 1))
        check("rtc transpose", e_out, xn.T, 0)
        (g_out,) = mx.rtc.Rtc(_gelu_torch).push([x])
        xd = xn.astype(np.float64)
        check("rtc pallas=False gelu", g_out, 0.5 * xd * (1 + np.tanh(
            0.7978845608 * (xd + 0.044715 * xd ** 3))), 2e-6)
        mx.nd.waitall()
    seconds = time.perf_counter() - t0
    launches = rtc_mod.launches
    if launches != 5:
        raise AssertionError("the imperative path launched %d Rtc kernels, "
                             "want 5 (one each of (a)-(e))" % launches)
    log("imperative (4096, 4096) float32 on gpu(0): %.2f s, Rtc launches "
        "%d; errors %s" % (seconds, launches, ", ".join(
            "%s %.3g" % kv for kv in errs.items())))
    return {"launches": launches, "seconds": seconds, "errors": errs}


#: a one-input body for the error path of a block over the kernel's limit
ONE_INPUT_BODY = r"""
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < out0_size) out0[i] = 2.5f * in0[i] + 0.0f;
"""


def phase_rtc_kernels(torch, timer, seed):
    """Kernels (a)-(e) against their plain versions on the card (these
    launches are not the main path's), the error paths, and the times:
    kernel, plain and one-call library time, the bound, NVRTC's compile
    time of each key, and the host time of a cached push."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    gpu = mx.gpu(0)

    def arr(shape, dtype=torch.float32, lo=0.0, hi=1.0):
        t = torch.rand(shape, generator=gen, device=DEVICE)
        return mx.nd.array((t * (hi - lo) + lo).to(dtype), ctx=gpu)

    def view(shape, offset):
        """A 1-D view that starts ``offset`` elements into a larger array
        (not 16-byte aligned for offset 1: saxpy's scalar path)."""
        return arr((shape[0] + offset,))[offset:offset + shape[0]]

    one = torch.ones((), device=DEVICE)
    #: (kernel, shape, offset of the inputs into a larger array)
    cases = [("xy_plus_one", (8, 8), 0), ("xy_plus_one", IMPERATIVE_SHAPE, 0),
             ("saxpy", (128, 128), 0), ("saxpy", (RTC_TIMED_N,), 0),
             ("saxpy", (RTC_TIMED_N + 3,), 0), ("saxpy", (RTC_TIMED_N,), 1),
             ("exp_shared", (10,), 0), ("add_mul_bf16", IMPERATIVE_SHAPE, 0),
             ("transpose", IMPERATIVE_SHAPE, 0)]
    #: (check, tolerance): 'ulp' float32 ulps at the plain value, or
    #: 'bitwise'
    tols = {"xy_plus_one": ("ulp", 1.0), "saxpy": ("ulp", 1.0),
            "exp_shared": ("ulp", 2.0), "add_mul_bf16": ("bitwise", 0.0),
            "transpose": ("bitwise", 0.0)}
    rows = []
    for name, shape, offset in cases:
        if offset:
            ins = [view(shape, offset), view(shape, offset)]
        elif name == "exp_shared":
            ins = [arr(shape, lo=-1.0)]
        elif name == "add_mul_bf16":
            ins = [arr(shape, torch.bfloat16, -2.0, 2.0) for _ in range(2)]
        elif name == "transpose":
            ins = [arr(shape)]
        else:
            ins = [arr(shape), arr(shape)]
        kernel = getattr(rk, name)
        plain = getattr(rk, name + "_reference")
        ts = [a.data for a in ins]
        got = [o.data for o in kernel(*ins)]
        want = plain(*ts)
        want = list(want) if isinstance(want, tuple) else [want]
        torch.cuda.synchronize()
        how, tol = tols[name]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if how == "ulp":
            meas = max(_ulps(torch, g, w) for g, w in zip(got, want))
        else:
            meas = err
        if not meas <= tol:
            raise AssertionError("rtc %s %s: %g %s > %g from the plain "
                                 "version" % (name, shape, meas, how, tol))
        n_bytes = (sum(t.numel() * t.element_size() for t in ts)
                   + sum(t.numel() * t.element_size() for t in want))
        b_ms, b_by = bound_ms(n_bytes, 0)
        x = ts[0]
        library = {"xy_plus_one": lambda: torch.addcmul(one, ts[0], ts[1]),
                   "saxpy": lambda: torch.add(ts[1], ts[0], alpha=2.5),
                   "transpose": lambda: x.t().contiguous()}.get(name)
        row = {"kernel": name, "shape": list(shape), "offset": offset,
               "n": x.numel(),
               "dtype": str(x.dtype).replace("torch.", ""),
               "max_abs_err": err, "check": how, "measured": meas,
               "tol": tol,
               "ms": timer(lambda: kernel(*ins)),
               "plain_ms": timer(lambda: plain(*ts)),
               "library_ms": timer(library) if library else None,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        rows.append(row)
        log("rtc %-12s %-13s %-8s err=%.3g (%s %g, tol %g) kernel_ms=%.4f "
            "plain_ms=%.4f library_ms=%s bound_ms=%.5f (%s)"
            % (name, "x".join(str(d) for d in shape)
               + ("+%d" % offset if offset else ""), row["dtype"], err,
               how, meas, tol, row["ms"], row["plain_ms"],
               "%.4f" % row["library_ms"] if library else "null", b_ms,
               b_by))

    # the error paths: each must raise MXNetError, with the reason
    x = arr((64,))
    errors = {}
    for what, call, needle in (
            ("syntax error",
             lambda: mx.rtc.Rtc("out0[threadIdx.x] = in0[threadIdx.x] +;",
                                pallas=True).push([x], (1, 1, 1),
                                                  (64, 1, 1)),
             "NVRTC could not compile"),
            ("block of 2048 threads",
             lambda: mx.rtc.Rtc(ONE_INPUT_BODY, pallas=True).push(
                 [x], (1, 1, 1), (2048, 1, 1)),
             "more than the kernel's limit"),
            ("CPU tensor",
             lambda: mx.rtc.Rtc(rk.SAXPY, pallas=True).push(
                 [x.copyto(mx.cpu()), x.copyto(mx.cpu())], (1, 1, 1),
                 (64, 1, 1)),
             "cannot run on the CPU")):
        try:
            call()
        except mx.MXNetError as err:
            if needle not in str(err):
                raise AssertionError("rtc %s raised without %r: %s"
                                     % (what, needle, err))
            errors[what] = str(err).splitlines()[0]
            if what == "syntax error" and "error" not in str(err).split(
                    "--- source ---")[0].split("\n", 1)[1]:
                raise AssertionError("rtc syntax error: no NVRTC log in %s"
                                     % err)
        else:
            raise AssertionError("rtc %s did not raise" % what)
    log("rtc error paths raise: %s" % "; ".join(
        "%s -> %s" % kv for kv in errors.items()))

    # the host time of a cached push against one torch.add of the size
    a, b = arr((128, 128)), arr((128, 128))
    r = mx.rtc.Rtc(rk.SAXPY, pallas=True)
    dims = ((128 * 128 + 255) // 256, 1, 1), (256, 1, 1)
    host = {}
    for what, fn in (("push", lambda: r.push([a, b], *dims)),
                     ("torch_add", lambda: torch.add(b.data, a.data,
                                                     alpha=2.5))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        n = 500
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host[what + "_us"] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    compile_s = sorted(
        k.compile_seconds for rt in list(rk._RTCS.values()) + [r]
        for k in rt._compiled.values())
    log("rtc host time of a cached push at 128x128: %.2f us; torch.add: "
        "%.2f us; NVRTC compile per key: %s s"
        % (host["push_us"], host["torch_add_us"],
           ", ".join("%.3f" % c for c in compile_s)))
    return {"rows": rows, "errors": errors, "host": host,
            "compile_s": compile_s}


# ----------------------------------------------------------------------
# phase 15: data parallelism (several replicas, and several processes)
# ----------------------------------------------------------------------
#: the data-parallel phase's steps: warm and timed (ms a step), and the
#: steps of its bitwise gates
DP_WARM_STEPS = 2
DP_TIMED_STEPS = 5
DP_GATE_STEPS = 3
#: the transformer LM's batch on each replica (phase 7's is 8 on one)
DP_LM_BATCH = 4
#: train_imagenet.py under tools/launch.py: each worker's batch and the
#: seconds the launch may take
DIST_BATCH = 32
DIST_EPOCHS = 2
DIST_TIMEOUT_S = 420


def _dp_contexts(mx, n, distinct):
    """``n`` replicas: each its own card, or all on the first."""
    make = mx.gpu if DEVICE == "cuda" else mx.cpu
    return [make(i if distinct else 0) for i in range(n)]


def _peaks_by_device(torch, devices):
    if DEVICE != "cuda":
        return {str(d): 0 for d in devices}
    return {str(d): torch.cuda.max_memory_allocated(d) for d in devices}


def _peak_reset_all(torch, devices):
    if DEVICE == "cuda":
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)


def _sync_all(torch, devices):
    if DEVICE == "cuda":
        for d in set(devices):
            torch.cuda.synchronize(d)
    else:
        torch.cuda.synchronize()


def _sweep_counts():
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.kernels import flash_attention as fa
    return {"fused_opt": fo.sweep.launches,
            "fused_opt_by_device": dict(fo.sweep.launches_by_device),
            "fused_opt_by_route": {d: dict(r) for d, r in
                                   fo.sweep.launches_by_route.items()},
            "fused_opt_by_body": dict(fo.sweep.launches_by_body),
            "flash_attention": fa.flash_attention_forward.launches,
            "flash_attention_by_device":
                dict(fa.flash_attention_forward.launches_by_device)}


def _reset_dp_counts():
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.kernels import flash_attention as fa
    reset_counts()
    fo.sweep.launches_by_device.clear()
    fo.sweep.launches_by_route.clear()
    fa.flash_attention_forward.launches_by_device.clear()
    fa.flash_attention_forward.launches_by_dtype.update(float32=0,
                                                        bfloat16=0)


def _resnet_module(mx, ctx, params, aux, batch, for_training=True):
    """A Module of phase 9's ResNet-50 bound at ``batch`` on ``ctx``
    from the numpy weights (no optimizer yet)."""
    mod = mx.mod.Module(resnet_symbol(), context=ctx)
    mod.bind([("data", (batch,) + RESNET["image_shape"])],
             [("softmax_label", (batch,))], for_training=for_training)
    cpu = mx.cpu()
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in params.items()},
                    aux_params={k: mx.nd.array(v, ctx=cpu)
                                for k, v in aux.items()})
    return mod


def _data_batch(mx, data, lo, hi):
    cpu = mx.cpu()
    return mx.io.DataBatch(
        [mx.nd.array(data["data"][lo:hi], ctx=cpu)],
        [mx.nd.array(data["softmax_label"][lo:hi], ctx=cpu)], pad=0)


def _time_module(torch, mod, mx, data, devices):
    """DP_WARM_STEPS then DP_TIMED_STEPS steps of ``forward_backward`` and
    ``update`` on the whole batch, each ended by a synchronize."""
    b = data["data"].shape[0]
    batch = _data_batch(mx, data, 0, b)
    times = []
    for i in range(DP_WARM_STEPS + DP_TIMED_STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        _sync_all(torch, devices)
        if i >= DP_WARM_STEPS:
            times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    return {"step_ms": ms, "step_ms_all": [t * 1e3 for t in times],
            "images_per_s": b / (ms / 1e3)}


def dp_module_slicing(torch, seed):
    """(a) on one card: ``Module`` on ``[gpu(0), gpu(0)]`` with kvstore
    ``device``: the slicing mode, two executors of half the batch.
    Gates, under deterministic cuDNN: the store's summed gradient is bit
    for bit the sum of two one-context executors' gradients on the two
    halves; the parameters after DP_GATE_STEPS steps are bit for bit
    those of that hand-summed run (the same optimizer's updater on the
    sum).  Then timed under cuDNN's defaults."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as opt_mod
    params, aux, data = seeded_resnet(seed + 15, RESNET_BATCH)
    half = RESNET_BATCH // 2
    ctxs = _dp_contexts(mx, 2, distinct=False)
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" \
        else torch.device("cpu")
    with cudnn_deterministic(torch):
        mod = _resnet_module(mx, ctxs, params, aux, RESNET_BATCH)
        mod.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params=RESNET_SGD)
        group = mod._exec_group
        if group.sharded or len(group.execs) != 2 \
                or not mod._update_on_kvstore:
            raise AssertionError("Module on %s: sharded=%s, %d executors, "
                                 "update on the store %s; want the slicing "
                                 "mode, 2 executors, the store's update"
                                 % (ctxs, group.sharded, len(group.execs),
                                    mod._update_on_kvstore))
        names = group.param_names
        halves = [_resnet_module(mx, ctxs[0], params, aux, half)
                  for _ in range(2)]
        opt = opt_mod.create("sgd", param_idx2name=dict(enumerate(names)),
                             rescale_grad=1.0 / RESNET_BATCH, **RESNET_SGD)
        updater = opt_mod.get_updater(opt)
        master = [mx.nd.array(params[n], ctx=ctxs[0]) for n in names]
        for step in range(DP_GATE_STEPS):
            mod.forward_backward(_data_batch(mx, data, 0, RESNET_BATCH))
            for i, h in enumerate(halves):
                for w, n in zip(master, names):
                    h._exec_group.execs[0].arg_dict[n]._set_data(w)
                h.forward_backward(_data_batch(mx, data, i * half,
                                               (i + 1) * half))
            sums = []
            for k, n in enumerate(names):
                g0 = group.grad_arrays[k][0].data
                g1 = group.grad_arrays[k][1].data
                h0 = halves[0]._exec_group.grad_arrays[k][0].data
                h1 = halves[1]._exec_group.grad_arrays[k][0].data
                if step == 0 and not (
                        torch.equal(g0, h0) and torch.equal(g1, h1)
                        and torch.equal(g0 + g1, h0 + h1)):
                    raise AssertionError(
                        "Module on [gpu(0), gpu(0)]: %s's gradient sum "
                        "differs from two one-context executors' on the "
                        "halves" % n)
                sums.append(h0 + h1)
            mod.update()
            for k, (w, g) in enumerate(zip(master, sums)):
                updater(k, mx.nd.NDArray(g), w)
        got = mod.get_params()[0]
        diff = [n for n, w in zip(names, master)
                if not torch.equal(got[n].data.to(w.data.device), w.data)]
        if diff:
            raise AssertionError("Module on [gpu(0), gpu(0)]: parameters "
                                 "after %d steps differ from the hand-summed "
                                 "run's: %s" % (DP_GATE_STEPS, diff[:5]))
        del halves, master, mod
    mod = _resnet_module(mx, ctxs, params, aux, RESNET_BATCH)
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=RESNET_SGD)
    _reset_dp_counts()
    timed = _time_module(torch, mod, mx, data, [dev])
    counts = read_counts()
    del mod
    timed.update({"contexts": [str(c) for c in ctxs], "mode": "slicing",
                  "executors": 2, "gate_steps": DP_GATE_STEPS,
                  "grad_sum_bitwise": True, "params_bitwise": True,
                  "launches": counts, "cards": 1})
    return timed


def dp_module_sharded(torch, seed, n):
    """(a) over ``n`` distinct cards: ``Module`` on ``[gpu(0..n-1)]`` with
    kvstore ``device`` takes the sharded mode (one executor, the
    gradients summed over the cards by NCCL inside the step); the
    witness: one step at phase 9's witness batch within twice the plain
    float32 step's distance from the plain float64 step; then timed at
    batch 64."""
    import mxnet_tpu_torch as mx
    ctxs = _dp_contexts(mx, n, distinct=True)
    devices = [torch.device(DEVICE, i) for i in range(n)]
    params, aux, data = seeded_resnet(seed + 9, RESNET_WITNESS_BATCH)
    mod = _resnet_module(mx, ctxs, params, aux, RESNET_WITNESS_BATCH)
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=RESNET_SGD)
    if not (mod._exec_group.sharded and mod._kv_inline):
        raise AssertionError("Module on %d cards: not the sharded mode"
                             % n)
    mod.forward_backward(_data_batch(mx, data, 0, RESNET_WITNESS_BATCH))
    mod.update()
    outs = mod.get_outputs()[0].data
    p_port = {k: v.data for k, v in mod.get_params()[0].items()}
    o32, p32 = plain_resnet_step(torch, params, data, torch.float32)
    o64, p64 = plain_resnet_step(torch, params, data, torch.float64)
    wit = _dp_witness(torch, outs, p_port, o32, p32, o64, p64)
    if not wit["ok"]:
        raise AssertionError("Module on %d cards: the witness %s" % (n, wit))
    del mod
    params, aux, data = seeded_resnet(seed + 15, RESNET_BATCH)
    mod = _resnet_module(mx, ctxs, params, aux, RESNET_BATCH)
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=RESNET_SGD)
    _reset_dp_counts()
    timed = _time_module(torch, mod, mx, data, devices)
    del mod
    timed.update({"contexts": [str(c) for c in ctxs], "mode": "sharded",
                  "executors": 1, "witness": wit, "cards": n})
    return timed


def _dp_witness(torch, outs, p_port, o32, p32, o64, p64, a_port=None,
                a32=None, a64=None):
    def diff(o, p, a=None, want_a=None):
        got = [float((o.double().to(o64.device) - o64).abs().max()),
               max(float((p[k].double().to(p64[k].device) - p64[k])
                         .abs().max()) for k in p64)]
        if a is not None:
            got.append(max(float((a[k].double().to(want_a[k].device)
                                  - want_a[k]).abs().max())
                           for k in want_a))
        return got
    got = {"port_vs_plain64": diff(outs, p_port, a_port, a64),
           "plain32_vs_plain64": diff(o32, p32, a32, a64)}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    return got


def _plain_aux(torch, params, aux, data, dtype):
    """The plain step's outputs, parameters and BatchNorm moving
    statistics (momentum 0.9, biased variance, as the port's)."""
    stats = {}
    o, p = plain_resnet_step(torch, params, data, dtype, stats=stats)
    m = 0.9
    a = {}
    for name, (mean, var) in stats.items():
        mm = torch.as_tensor(aux[name + "_moving_mean"], device=DEVICE,
                             dtype=dtype)
        mv = torch.as_tensor(aux[name + "_moving_var"], device=DEVICE,
                             dtype=dtype)
        a[name + "_moving_mean"] = m * mm + (1 - m) * mean
        a[name + "_moving_var"] = m * mv + (1 - m) * var
    return o, p, a


def _dp_trainer(torch, mx, mesh, params, aux, data, zero1, steps,
                timed_steps=0, timed_warm=0):
    """ShardedTrainer on ``mesh`` (SGD, the CUDA sweep) from the numpy
    weights: ``steps`` counted steps, then ``timed_warm`` + ``timed_steps``
    more each ended by a synchronize.  Returns the first step's outputs
    (global), the first replica's parameters and aux (copies), and the
    counts, times and peaks."""
    from mxnet_tpu_torch.model import params_from_numpy
    from mxnet_tpu_torch.parallel.sharding import place
    from mxnet_tpu_torch.kernels import fused_opt as fo
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    batch = data["data"].shape[0]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / batch, **RESNET_SGD)
    tr = mx.parallel.ShardedTrainer(resnet_symbol(), opt, mesh, zero1=zero1)
    p, a = params_from_numpy(params, aux, mesh=mesh)
    st = {n: place(np.zeros(v.shape, np.float32), mesh,
                   tr.opt_state_sharding(n, v.shape).spec)
          for n, v in params.items()}
    b = tr.shard_batch(data)
    devices = mesh.devices
    _sync_all(torch, devices)
    _reset_dp_counts()
    _peak_reset_all(torch, devices)
    first = None
    for _ in range(steps):
        p, st, a, outs = tr.step(p, st, a, b)
        if first is None:
            first = outs[0].global_tensor().float().clone()
    _sync_all(torch, devices)
    info = {"zero1": zero1, "batch": batch, "steps": steps,
            "replicas": len(devices),
            "cards": len(set(devices)), "launches": _sweep_counts(),
            "buckets": len(fo.plan_buckets({n: p[n].shards[0]
                                            for n in tr.param_names})),
            "peak_bytes_by_device": _peaks_by_device(torch, devices),
            "collectives": mesh.replica_group().route(),
            "state_shard_rows": {n: int(st[n].shards[0].shape[0])
                                 for n in ("fc1_weight", "conv0_weight",
                                           "fc1_bias")}}
    p_out = {n: w.shards[0].clone() for n, w in p.items()}
    a_out = {n: v.shards[0].clone() for n, v in a.items()}
    if timed_steps:
        _peak_reset_all(torch, devices)
        times = []
        for i in range(timed_warm + timed_steps):
            t0 = time.perf_counter()
            p, st, a, _o = tr.step(p, st, a, b)
            _sync_all(torch, devices)
            if i >= timed_warm:
                times.append(time.perf_counter() - t0)
        info["step_ms"] = float(np.median(times)) * 1e3
        info["step_ms_all"] = [t * 1e3 for t in times]
        info["images_per_s"] = batch / (info["step_ms"] / 1e3)
        info["peak_bytes_by_device"] = _peaks_by_device(torch, devices)
    return first, p_out, a_out, info


def _want_dp_sweeps(info):
    """The sweep once a bucket a replica a step (ZeRO-1: once a replica
    a step, over its slices), all on SGD-momentum's body, and no flash
    forward."""
    n = info["replicas"] * info["steps"] * (1 if info["zero1"]
                                             else info["buckets"])
    got = info["launches"]
    if got["fused_opt"] != n or got["fused_opt_by_body"] != {1: n} \
            or got["flash_attention"] != 0:
        raise AssertionError("dp trainer %s: sweep launches %s, want %d "
                             "on body 1" % ({k: info[k] for k in (
                                 "zero1", "replicas", "buckets", "steps")},
                                 got, n))


def dp_trainer_phase(torch, seed, n, distinct):
    """(b) ShardedTrainer on ``make_mesh(n contexts, dp=n)``: with and
    without ZeRO-1 at batch 64 (gates under deterministic cuDNN: on one
    card ZeRO-1 bit for bit plain dp; across cards both within the
    witness), timed under cuDNN's defaults, peaks per device; the
    witness at batch 8: one dp step within twice the plain float32
    step's distance from the plain float64 step on the global batch,
    outputs, parameters and BatchNorm moving statistics."""
    import mxnet_tpu_torch as mx
    ctxs = _dp_contexts(mx, n, distinct)
    mesh = mx.parallel.make_mesh(ctxs, dp=n)
    params, aux, data = seeded_resnet(seed + 15, RESNET_BATCH)
    runs = {}
    with cudnn_deterministic(torch):
        for zero1 in (False, True):
            _f, p, a, info = _dp_trainer(torch, mx, mesh, params, aux,
                                         data, zero1, DP_GATE_STEPS)
            _want_dp_sweeps(info)
            runs[zero1] = (p, a, info)
    diff = max(float((runs[True][0][k] - runs[False][0][k]).abs().max())
               for k in runs[False][0])
    if not distinct and diff != 0.0:
        raise AssertionError("dp=%d on one card: ZeRO-1 differs from plain "
                             "dp by %g after %d steps (want bit for bit)"
                             % (n, diff, DP_GATE_STEPS))
    gate = {z: runs[z][2] for z in runs}
    del runs
    timed = {}
    for zero1 in (False, True):
        _f, _p, _a, info = _dp_trainer(
            torch, mx, mesh, params, aux, data, zero1, 1,
            timed_steps=DP_TIMED_STEPS, timed_warm=DP_WARM_STEPS - 1)
        timed[zero1] = info
        del _f, _p, _a
    # the witness at batch 8
    w_params, w_aux, w_data = seeded_resnet(seed + 9, RESNET_WITNESS_BATCH)
    o32, p32, a32 = _plain_aux(torch, w_params, w_aux, w_data,
                               torch.float32)
    o64, p64, a64 = _plain_aux(torch, w_params, w_aux, w_data,
                               torch.float64)
    wits = {}
    for zero1 in (False, True):
        outs, p, a, info = _dp_trainer(torch, mx, mesh, w_params, w_aux,
                                       w_data, zero1, 1)
        wits[zero1] = _dp_witness(torch, outs, p, o32, p32, o64, p64,
                                  a, a32, a64)
        wits[zero1]["launches"] = info["launches"]
        if not wits[zero1]["ok"]:
            raise AssertionError("dp=%d zero1=%s: the witness %s"
                                 % (n, zero1, wits[zero1]))
    return {"contexts": [str(c) for c in ctxs], "cards": len(set(
        mesh.devices)), "zero1_vs_dp_max_abs": diff, "gate": {
            str(z).lower(): g for z, g in gate.items()},
        "timed": {str(z).lower(): t for z, t in timed.items()},
        "witness": {str(z).lower(): w for z, w in wits.items()}}


def dp_lm_phase(torch, seed, n, distinct):
    """(c) the transformer LM's ShardedTrainer step on ``make_mesh(n
    contexts, dp=n)`` at phase 7's full width, DP_LM_BATCH a replica:
    the flash forward on every replica (each layer's, each step's), the
    sweep once a bucket a replica; the witness after 3 steps against the
    plain float32 and float64 steps on the global batch; timed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.model import params_from_numpy
    from mxnet_tpu_torch.parallel.sharding import place
    ctxs = _dp_contexts(mx, n, distinct)
    mesh = mx.parallel.make_mesh(ctxs, dp=n)
    params = seeded_train_params(seed)
    batch = train_batch(seed, DP_LM_BATCH * n)
    S = TRAIN["seq_len"]
    B = DP_LM_BATCH * n
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (B * S),
                              **TRAIN_SGD)
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**TRAIN), opt, mesh)
    p, _a = params_from_numpy(params, {}, mesh=mesh)
    st = {k: place(np.zeros(v.shape, np.float32), mesh,
                   tr.opt_state_sharding(k, v.shape).spec)
          for k, v in params.items()}
    aux = {}
    b = tr.shard_batch(batch)
    steps = 3
    _sync_all(torch, mesh.devices)
    _reset_dp_counts()
    for _ in range(steps):
        p, st, aux, outs = tr.step(p, st, aux, b)
    _sync_all(torch, mesh.devices)
    counts = _sweep_counts()
    buckets = len(fo.plan_buckets({k: p[k].shards[0]
                                   for k in tr.param_names}))
    want_fa = TRAIN["num_layers"] * steps * n
    want_fo = buckets * steps * n
    if counts["flash_attention"] != want_fa \
            or counts["fused_opt"] != want_fo:
        raise AssertionError("LM dp=%d: launches %s, want the flash "
                             "forward %d times (every layer, step and "
                             "replica) and the sweep %d"
                             % (n, counts, want_fa, want_fo))
    per_dev = {}
    for d in mesh.devices:
        per_dev[str(d)] = per_dev.get(str(d), 0) \
            + TRAIN["num_layers"] * steps
    if counts["flash_attention_by_device"] != per_dev:
        raise AssertionError("LM dp=%d: flash forward by device %s, want %s"
                             % (n, counts["flash_attention_by_device"],
                                per_dev))
    outs0 = outs[0].global_tensor(torch.device(mesh.devices[0]))
    p_after = {k: v.shards[0] for k, v in p.items()}
    wit = precision_check(torch, "LM dp=%d" % n, batch, steps, params,
                          None, outs0, p_after)
    if not wit["ok"]:
        raise AssertionError("LM dp=%d: the witness %s" % (n, wit))
    times = []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        p, st, aux, _o = tr.step(p, st, aux, b)
        _sync_all(torch, mesh.devices)
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    return {"contexts": [str(c) for c in ctxs],
            "cards": len(set(mesh.devices)), "batch_per_replica":
            DP_LM_BATCH, "steps": steps, "launches": counts,
            "buckets": buckets, "witness": wit, "step_ms": ms,
            "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": B * S / (ms / 1e3)}


def _train_imagenet(here, prefix, kvstore, extra=()):
    """``train_imagenet.py``'s arguments for (d): ResNet-50 on the
    synthetic set, DIST_EPOCHS epochs of DIST_BATCH a worker."""
    return [sys.executable,
            os.path.join(here, "example", "image-classification-torch",
                         "train_imagenet.py"),
            "--kvstore", kvstore, "--synthetic", "--network", "resnet-50",
            "--batch-size", str(DIST_BATCH), "--num-epochs",
            str(DIST_EPOCHS), "--model-prefix", prefix] + list(extra) + (
                ["--devices", "cpu"] if DEVICE != "cuda" else [])


def _run_logged(cmd, env, here, log_path, what):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT_S, cwd=here)
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError("%s exited %d: %s"
                             % (what, proc.returncode, proc.stderr[-3000:]))
    return proc, seconds


def _saved_arrays(mx, path):
    return {k: v.asnumpy() for k, v in mx.nd.load(path).items()}


def dist_sync_phase(torch, seed, n):
    """(d) ``python tools/launch.py -n n python example/image-classification
    -torch/train_imagenet.py --kvstore dist_sync --synthetic``: one worker
    a card (``gpu(rank)``), ResNet-50, DIST_EPOCHS epochs of 8 batches
    of DIST_BATCH a worker.  Gate with several workers: every worker's
    parameters after the last epoch bit for bit rank 0's (the aux states
    stay each worker's own, as in the reference).  Gate with one: its
    parameters and aux states bit for bit those of the same run under
    ``--kvstore local`` in a process of its own, no launch and no
    process group (both with ``--deterministic``).  Returns the workers,
    the backend, the workers' last epoch times and images/s (from the
    fit's "Time cost" lines) and the launch's seconds."""
    import socket
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke_dist")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    prefix = os.path.join(out_dir, "resnet50")
    extra = ["--deterministic"] if n == 1 else []
    cmd = [sys.executable, os.path.join(here, "tools", "launch.py"),
           "-n", str(n), "--launcher", "local", "--port", str(port),
           "--workdir", here] + _train_imagenet(here, prefix, "dist_sync",
                                                extra)
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    proc, seconds = _run_logged(cmd, env, here,
                                os.path.join(out_dir, "launch.log"),
                                "dist_sync launch")
    import mxnet_tpu_torch as mx
    files = [prefix + "-%04d.params" % DIST_EPOCHS] + [
        "%s-%d-%04d.params" % (prefix, r, DIST_EPOCHS) for r in range(1, n)]
    got = [_saved_arrays(mx, f) for f in files]
    if n > 1:
        against = "rank 0's"
        bad = [(r, k) for r in range(1, n) for k in got[0]
               if k.startswith("arg:")
               and not np.array_equal(got[r][k], got[0][k])]
    else:
        # one worker: the launch, the process group and the dist store
        # must change nothing against a plain local run
        against = "the local run's"
        local = prefix + "_local"
        _run_logged(_train_imagenet(here, local, "local", extra), env, here,
                    os.path.join(out_dir, "local.log"), "local run")
        want = _saved_arrays(mx, local + "-%04d.params" % DIST_EPOCHS)
        bad = [k for k in sorted(set(want) | set(got[0]))
               if k not in want or k not in got[0]
               or not np.array_equal(got[0][k], want[k])]
    n_args = sum(k.startswith("arg:") for k in got[0])
    if bad or not n_args:
        raise AssertionError("dist_sync: parameters differ from %s: %s"
                             % (against, bad[:5]))
    text = proc.stderr + proc.stdout
    backends = re.findall(r"torch\.distributed backend (\S+)", text)
    workers = re.findall(r"worker (\d+) of (\d+)", text)
    # each worker's epochs of 8 batches (common.synthetic_iters'
    # train_n); the last one's time, warm, gives its images/s
    costs = [float(x) for x in re.findall(r"Epoch\[%d\] Time cost=([0-9.]+)"
                                          % (DIST_EPOCHS - 1), text)]
    speeds = [8 * DIST_BATCH / c for c in costs if c > 0]
    if len(workers) != n or any(int(w) != n for _r, w in workers):
        raise AssertionError("dist_sync: worker lines %s, want %d workers"
                             % (workers, n))
    for f in os.listdir(out_dir):
        if f.endswith(".params") or f.endswith(".json"):
            os.remove(os.path.join(out_dir, f))
    return {"workers": n, "backend": sorted(set(backends)),
            "parameters_bitwise": True, "against": against,
            "arrays": len(got[0]), "parameters": n_args,
            "deterministic": bool(extra), "epoch_s": costs,
            "images_per_s": speeds, "seconds": seconds,
            "batch_per_worker": DIST_BATCH}


def phase_dp(torch, seed, smi):
    """Phase 15: data parallelism.  On one card, (a) ``Module`` on two
    contexts of one card (the slicing mode), (b) ``ShardedTrainer`` dp=2
    on one card with and without ZeRO-1, (c) the LM's dp=2 step, (d)
    ``dist_sync`` through ``tools/launch.py`` with one worker a card.
    With several cards, (a)-(c) also over the distinct cards (NCCL) and
    (d) with a worker on each."""
    import mxnet_tpu_torch as mx
    n = torch.cuda.device_count() if DEVICE == "cuda" else 1
    log("dp: %d card(s); %s" % (n, _cudnn_settings(torch)))
    out = {"cards": n}
    out["module_one_card"] = dp_module_slicing(torch, seed)
    r = out["module_one_card"]
    log("dp (a) Module on %s (slicing, kvstore device), ResNet-50 batch "
        "%d: gradient sum and %d steps bit for bit the hand-summed run of "
        "two one-context executors; %.2f ms a step (median of %d: %s), "
        "%.1f images/s; hand-kernel launches %s; on %s"
        % (r["contexts"], RESNET_BATCH, DP_GATE_STEPS, r["step_ms"],
           len(r["step_ms_all"]), ", ".join("%.2f" % t
                                             for t in r["step_ms_all"]),
           r["images_per_s"], r["launches"], smi))
    torch.cuda.empty_cache()
    out["trainer_one_card"] = dp_trainer_phase(torch, seed, 2, False)
    _log_dp_trainer(out["trainer_one_card"], smi)
    torch.cuda.empty_cache()
    out["lm_one_card"] = dp_lm_phase(torch, seed, 2, False)
    _log_dp_lm(out["lm_one_card"], smi)
    torch.cuda.empty_cache()
    if n > 1:
        out["module_cards"] = dp_module_sharded(torch, seed, n)
        r = out["module_cards"]
        log("dp (a) Module on %d cards %s (sharded, NCCL): witness %s; "
            "%.2f ms a step (median of %d), %.1f images/s; on %s"
            % (n, r["contexts"], json.dumps(r["witness"]), r["step_ms"],
               len(r["step_ms_all"]), r["images_per_s"], smi))
        torch.cuda.empty_cache()
        out["trainer_cards"] = dp_trainer_phase(torch, seed, n, True)
        _log_dp_trainer(out["trainer_cards"], smi)
        torch.cuda.empty_cache()
        out["lm_cards"] = dp_lm_phase(torch, seed, n, True)
        _log_dp_lm(out["lm_cards"], smi)
        torch.cuda.empty_cache()
    else:
        log("dp: one card: the NCCL path between cards was not exercised "
            "(replicas on one card sum with plain adds)")
    out["dist_sync"] = dist_sync_phase(torch, seed, n)
    r = out["dist_sync"]
    log("dp (d) train_imagenet.py --kvstore dist_sync through "
        "tools/launch.py: %d worker(s), torch.distributed backend %s, "
        "cuDNN deterministic %s; parameters bit for bit %s (%d arrays "
        "compared); each worker's last epoch of 8 batches of %d (s) %s, "
        "images/s %s; the launch %.1f s; on %s"
        % (r["workers"], r["backend"], r["deterministic"], r["against"],
           r["parameters"] if r["workers"] > 1 else r["arrays"],
           DIST_BATCH, r["epoch_s"], ["%.1f" % v for v in r["images_per_s"]],
           r["seconds"], smi))
    return out


def _log_dp_trainer(r, smi):
    for z in ("false", "true"):
        t, g, w = r["timed"][z], r["gate"][z], r["witness"][z]
        log("dp (b) ShardedTrainer %s dp=%d zero1=%s ResNet-50 batch %d: "
            "%.2f ms a step (median of %d: %s), %.1f images/s; peak MB by "
            "device %s; sweep launches by device %s, route by device %s "
            "(%d steps; %d buckets); collectives %s; state rows on a "
            "replica %s; witness %s; on %s"
            % (r["contexts"], t["replicas"], z, t["batch"], t["step_ms"],
               len(t["step_ms_all"]), ", ".join("%.2f" % x for x in
                                                t["step_ms_all"]),
               t["images_per_s"], {d: round(b / 2 ** 20, 1) for d, b in
                                   t["peak_bytes_by_device"].items()},
               g["launches"]["fused_opt_by_device"],
               g["launches"]["fused_opt_by_route"], g["steps"],
               g["buckets"], g["collectives"], g["state_shard_rows"],
               json.dumps({k: w[k] for k in ("port_vs_plain64",
                                             "plain32_vs_plain64")}), smi))
    log("dp (b) ZeRO-1 against plain dp after %d steps: max |diff| %g"
        % (DP_GATE_STEPS, r["zero1_vs_dp_max_abs"]))


def _log_dp_lm(r, smi):
    log("dp (c) LM ShardedTrainer %s, %d a replica: flash forward by "
        "device %s, sweep by device %s (%d buckets); witness %s; %.2f ms a "
        "step (median of %d), %.0f tokens/s; on %s"
        % (r["contexts"], r["batch_per_replica"],
           r["launches"]["flash_attention_by_device"],
           r["launches"]["fused_opt_by_device"], r["buckets"],
           json.dumps({k: r["witness"][k] for k in (
               "port_vs_plain64", "plain32_vs_plain64")}),
           r["step_ms"], len(r["step_ms_all"]), r["tokens_per_s"], smi))


# ----------------------------------------------------------------------
# phase 16: the flat C ABI (include/mxtpu/c_api.h over the port)
# ----------------------------------------------------------------------
#: runs of each unchanged C consumer (an abort at a C host's exit would
#: show in some runs only)
CAPI_RUNS = 3
#: the C-driven LM's steps (phase 7's full width, TRAIN and TRAIN_BATCH),
#: held bit for bit to the twin's; then a second C run and the twin
#: each take CAPI_TIMED_STEPS steps for the step time (the first of
#: them, which builds the program, not counted)
CAPI_TRAIN_STEPS = 3
CAPI_TIMED_STEPS = 10
#: ResNet-50 predict through image-classification-predict
CAPI_PREDICT_BATCH = 64
#: rtc_saxpy's element count (phase 8's timed size)
CAPI_RTC_N = RTC_TIMED_N
#: phase 8's bound for saxpy against its plain version, float32 ulps
CAPI_RTC_ULPS = 1.0
CAPI_TIMEOUT_S = 600


def capi_dir(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_capi", *parts)


def capi_env(here, **extra):
    """The C programs' environment: a ``jax`` that raises on import first
    on ``PYTHONPATH`` (the port's library must never reach it), the repo,
    then this interpreter's package directories (the interpreter a C
    host embeds is found from ``python3-config``'s libpython and may not
    see them by itself); ``gpu(0)`` for the calls that name no device,
    the CPU in a rehearsal with ``DEVICE = "cpu"``."""
    poison = capi_dir("poison")
    os.makedirs(os.path.join(poison, "jax"), exist_ok=True)
    with open(os.path.join(poison, "jax", "__init__.py"), "w") as f:
        f.write("raise ImportError('jax is blocked for the port')\n")
    pkgs = [p for p in sys.path if p.endswith(("site-packages",
                                               "dist-packages"))]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([poison, here] + pkgs)
    env.pop("MXNET_CAPI_CONTEXT", None)
    if DEVICE != "cuda":
        env["MXNET_CAPI_CONTEXT"] = "cpu"
    env.update(extra)
    return env


def run_c(cmd, env, what, ok_line, cwd=None):
    """One C process: its exit code must be 0, its OK line printed and
    nothing aborted (``terminate called``, a signal) at its exit.
    Returns the process and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([str(c) for c in cmd], env=env, cwd=cwd,
                          capture_output=True, text=True,
                          timeout=CAPI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or ok_line not in proc.stdout \
            or "terminate called" in proc.stderr:
        raise AssertionError("%s: exit %d, OK line %s: stdout %s stderr %s"
                             % (what, proc.returncode,
                                ok_line in proc.stdout, proc.stdout[-1500:],
                                proc.stderr[-3000:]))
    return proc, seconds


def run_c_together(jobs):
    """C processes started together, ``{what: (cmd, env, ok_line)}``;
    each is checked as :func:`run_c` checks one.  Returns ``{what:
    seconds}``, each process's own."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {what: pool.submit(run_c, cmd, env, what, ok)
                   for what, (cmd, env, ok) in jobs.items()}
        return {what: f.result()[1] for what, f in futures.items()}


def capi_predict(torch, mx, bindir, env, seed):
    """(a) ResNet-50 at batch 64 through the unchanged
    ``image-classification-predict``, against the port's ``Predictor`` on
    the same checkpoint and input in this process: the printed class and
    probability (6 digits) must be the same."""
    d = capi_dir("resnet")
    os.makedirs(d, exist_ok=True)
    sym = resnet_symbol()
    params, aux, data = seeded_resnet(seed + 16, CAPI_PREDICT_BATCH)
    prefix = os.path.join(d, "resnet50")
    with mx.cpu():
        mx.model.save_checkpoint(
            prefix, 0, sym, {k: mx.nd.array(v) for k, v in params.items()},
            {k: mx.nd.array(v) for k, v in aux.items()})
    shape = (CAPI_PREDICT_BATCH,) + RESNET["image_shape"]
    with open(os.path.join(d, "shapes.json"), "w") as f:
        json.dump({"data": list(shape)}, f)
    data["data"].tofile(os.path.join(d, "input.f32"))
    proc, seconds = run_c(
        [os.path.join(bindir, "image-classification-predict"),
         prefix + "-symbol.json", prefix + "-0000.params",
         os.path.join(d, "shapes.json"), os.path.join(d, "input.f32")],
        env, "image-classification-predict", "CPP PREDICT OK")
    c_line = next(ln for ln in proc.stdout.splitlines()
                  if ln.startswith("predicted class"))
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    # the C process runs PyTorch's defaults, under which cuDNN may use
    # TF32 (torch.backends.cudnn.allow_tf32 defaults to True); the
    # Predictor here takes the same setting for the comparison
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pred = mx.Predictor(prefix + "-symbol.json",
                            prefix + "-0000.params", {"data": shape},
                            ctx=ctx)
        probs = pred.forward(data=data["data"])[0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    best = int(np.argmax(probs[0]))
    twin = "predicted class: %d  prob: %f" % (best, float(probs[0][best]))
    if c_line != twin:
        raise AssertionError("C predict %r != Predictor %r" % (c_line, twin))
    del pred
    return {"line": c_line, "seconds": seconds, "batch": CAPI_PREDICT_BATCH,
            "finite": bool(np.isfinite(probs).all())}


def _step_ms(stdout):
    return [float(ln.split()[3]) for ln in stdout.splitlines()
            if ln.startswith("step ")]


def capi_train_lm(torch, mx, bindir, env, seed):
    """(b) The LM's training graph at phase 7's full width, 3 steps through
    ``train_lm``, against a twin in this process doing the same
    ``simple_bind``, backward and ``Optimizer.update`` leaf by leaf: the
    saved parameters must be bit for bit the twin's.  The twin counts the
    flash forward's launches (8 a step), and the C process writes its own
    counts at ``MXNotifyShutdown``."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.models import transformer as tf
    d = capi_dir("lm")
    os.makedirs(d, exist_ok=True)
    B, S = TRAIN_BATCH, TRAIN["seq_len"]
    sym_path = os.path.join(d, "lm-symbol.json")
    tf.get_symbol(**TRAIN).save(sym_path)
    params = seeded_train_params(seed)
    batch = train_batch(seed, TRAIN_BATCH)
    with mx.cpu():
        mx.nd.save(os.path.join(d, "lm.params"),
                   {"arg:" + k: mx.nd.array(v) for k, v in params.items()})
    batch["data"].tofile(os.path.join(d, "tokens.f32"))
    batch["softmax_label"].tofile(os.path.join(d, "labels.f32"))
    counts_path = os.path.join(d, "counts.json")
    lr, mom = TRAIN_SGD["learning_rate"], TRAIN_SGD["momentum"]
    torch.cuda.empty_cache()
    proc, seconds = run_c(
        [os.path.join(bindir, "train_lm"), "--symbol", sym_path,
         "--params", "lm.params", "--data", "tokens.f32",
         "--label", "labels.f32", "--batch", B, "--seq-len", S,
         "--steps", CAPI_TRAIN_STEPS, "--lr", lr, "--momentum", mom,
         "--out", "trained.params"],
        dict(env, MXTPU_CAPI_COUNTS=counts_path), "train_lm", "TRAIN_LM OK",
        cwd=d)
    c_ms = _step_ms(proc.stdout)
    with open(counts_path) as f:
        c_counts = json.load(f)

    # the twin: the same calls through the port's Python surface
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    sym = mx.sym.load(sym_path)
    ex = sym.simple_bind(ctx, grad_req="write", data=(B, S),
                         softmax_label=(B, S))
    for name, value in list(params.items()) + [
            ("data", batch["data"]), ("softmax_label",
                                      batch["softmax_label"])]:
        ex.arg_dict[name]._set_data(torch.from_numpy(value))
    opt = mx.optimizer.create("sgd", learning_rate=lr, momentum=mom, wd=0.0,
                              rescale_grad=1.0 / (B * S))
    names = sym.list_arguments()
    states = {}
    torch.cuda.synchronize()
    fa.flash_attention_forward.launches = 0
    twin_ms = []
    for _ in range(CAPI_TRAIN_STEPS):
        t0 = time.perf_counter()
        ex.forward(is_train=True)
        ex.backward()
        for i, name in enumerate(names):
            if name in ("data", "softmax_label"):
                continue
            if i not in states:
                states[i] = opt.create_state(i, ex.arg_dict[name])
            opt.update(i, ex.arg_dict[name], ex.grad_dict[name], states[i])
        torch.cuda.synchronize()
        twin_ms.append((time.perf_counter() - t0) * 1e3)
    twin_launches = fa.flash_attention_forward.launches
    want = TRAIN["num_layers"] * CAPI_TRAIN_STEPS
    # (on the CPU of a rehearsal the plain versions count nothing)
    if DEVICE == "cuda" and (twin_launches != want
                             or c_counts["flash_attention"] != want):
        raise AssertionError("flash forward launches: twin %d, C process "
                             "%d, want %d" % (twin_launches,
                                              c_counts["flash_attention"],
                                              want))
    with mx.cpu():
        saved = {k: v.asnumpy() for k, v in
                 mx.nd.load(os.path.join(d, "trained.params")).items()}
    differ = {}
    for name in params:
        mine = ex.arg_dict[name].asnumpy()
        if not np.array_equal(saved[name], mine):
            differ[name] = float(np.abs(saved[name] - mine).max())
    finite = all(np.isfinite(v).all() for v in saved.values())
    if differ or not finite or sorted(saved) != sorted(params):
        raise AssertionError("train_lm's parameters are not the twin's bit "
                             "for bit: %s (finite %s)" % (differ, finite))
    moved = max(float(np.abs(saved[k] - params[k]).max()) for k in params)

    # the step time: the twin goes on, then a second C run from the start
    for _ in range(CAPI_TIMED_STEPS - CAPI_TRAIN_STEPS):
        t0 = time.perf_counter()
        ex.forward(is_train=True)
        ex.backward()
        for i, name in enumerate(names):
            if name not in ("data", "softmax_label"):
                opt.update(i, ex.arg_dict[name], ex.grad_dict[name],
                           states[i])
        torch.cuda.synchronize()
        twin_ms.append((time.perf_counter() - t0) * 1e3)
    del ex, states
    torch.cuda.empty_cache()
    timed, _s = run_c(
        [os.path.join(bindir, "train_lm"), "--symbol", sym_path,
         "--params", "lm.params", "--data", "tokens.f32",
         "--label", "labels.f32", "--batch", B, "--seq-len", S,
         "--steps", CAPI_TIMED_STEPS, "--lr", lr, "--momentum", mom,
         "--out", "timed.params"], env, "train_lm (timed)", "TRAIN_LM OK",
        cwd=d)
    c_timed = _step_ms(timed.stdout)
    return {"c_step_ms": c_ms, "twin_step_ms": twin_ms,
            "c_timed_step_ms": c_timed,
            "c_median_ms": float(np.median(c_timed[1:])),
            "twin_median_ms": float(np.median(twin_ms[1:])),
            "c_launches": c_counts, "twin_flash_launches": twin_launches,
            "bitwise": True, "arrays": len(saved), "max_update": moved,
            "seconds": seconds}


def capi_rtc(torch, bindir, env, seed):
    """(c) ``rtc_saxpy``: a CUDA C body through ``MXRtcCreate`` and
    ``MXRtcPush`` at 2^24 float32, within phase 8's ulp bound of the
    plain version."""
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    d = capi_dir("rtc")
    os.makedirs(d, exist_ok=True)
    n = CAPI_RTC_N
    # phase 8's inputs, uniform in [0, 1): its ulp bound is for these
    # (with signed inputs, 2.5*x + y cancels, and the body's contracted
    # FMA and the plain version's two roundings differ by more ulps of
    # the small result than 1)
    rng = np.random.default_rng(seed + 16)
    x = rng.random(n, dtype=np.float32)
    y = rng.random(n, dtype=np.float32)
    x.tofile(os.path.join(d, "x.f32"))
    y.tofile(os.path.join(d, "y.f32"))
    counts_path = os.path.join(d, "counts.json")
    proc, seconds = run_c(
        [os.path.join(bindir, "rtc_saxpy"), n, "x.f32", "y.f32", "out.f32"],
        dict(env, MXTPU_CAPI_COUNTS=counts_path), "rtc_saxpy",
        "RTC SAXPY OK", cwd=d)
    with open(counts_path) as f:
        c_counts = json.load(f)
    got = torch.from_numpy(np.fromfile(os.path.join(d, "out.f32"),
                                       dtype=np.float32)).to(DEVICE)
    want = rk.saxpy_reference(torch.from_numpy(x).to(DEVICE),
                              torch.from_numpy(y).to(DEVICE))
    ulps = _ulps(torch, got, want)
    if got.numel() != n or not ulps <= CAPI_RTC_ULPS:
        raise AssertionError("rtc_saxpy: %d values, %g ulps (bound %g)"
                             % (got.numel(), ulps, CAPI_RTC_ULPS))
    if DEVICE == "cuda" and c_counts["rtc"] != 1:
        raise AssertionError("rtc_saxpy launched %d kernels, want 1"
                             % c_counts["rtc"])
    return {"n": n, "ulps": ulps,
            "max_abs_err": float((got - want).abs().max()),
            "c_launches": c_counts, "seconds": seconds,
            "line": proc.stdout.splitlines()[0]}


def capi_consumers(mx, bindir, env):
    """(d) The unchanged ``capi_smoke`` and ``capi_threads`` on ``gpu(0)``
    and ``capi_parity`` with ``MXNET_CAPI_CONTEXT=cpu`` (it binds on
    ``dev_type`` 1 itself), each ``CAPI_RUNS`` times, the three at once.
    Returns each one's seconds a run."""
    d = capi_dir("consumers")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "mlp")
    with mx.cpu():
        mod = mx.mod.Module(mx.models.get_mlp(num_classes=2, hidden=(8,)),
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", (2, 10))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params(mx.init.Uniform(0.1))
        mod.save_checkpoint(prefix, 0)
    files = dict(MXTPU_SYMBOL_JSON=prefix + "-symbol.json",
                 MXTPU_PARAMS_FILE=prefix + "-0000.params", MXTPU_SCRATCH=d)
    jobs = {prog: ([os.path.join(bindir, prog)],
                   dict(env, **dict(files, **extra)), ok)
            for prog, ok, extra in (("capi_smoke", "CAPI SMOKE OK", {}),
                                    ("capi_threads", "CAPI THREADS OK", {}),
                                    ("capi_parity", "capi_parity OK",
                                     {"MXNET_CAPI_CONTEXT": "cpu"}))}
    runs = {prog: [] for prog in jobs}
    for _ in range(CAPI_RUNS):
        # the three together (each writes only its own files)
        for prog, secs in run_c_together(jobs).items():
            runs[prog].append(round(secs, 2))
    return runs


def phase_capi(torch, seed, smi):
    """Phase 16: the flat C ABI.  ``make capi-torch`` builds the port's
    library (``mxnet_tpu_torch/csrc/c_api.cc`` over the unchanged
    ``include/mxtpu/c_api.h``) and the C programs against it, then (a)
    ResNet-50 predict, (b) the full-width LM's training, (c) an NVRTC
    kernel, (d) the unchanged consumers, each a C host process."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import libinfo
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = subprocess.run(["python3-config", "--includes", "--ldflags",
                          "--embed"], capture_output=True, text=True)
    log("capi: python3-config --includes --ldflags --embed (rc %d): %s"
        % (cfg.returncode, " ".join(cfg.stdout.split())))
    t0 = time.perf_counter()
    bindir = libinfo.build_capi()
    build_s = time.perf_counter() - t0
    log("capi: make capi-torch %.2f s" % build_s)
    env = capi_env(here)
    out = {"build_s": build_s}
    out["predict"] = capi_predict(torch, mx, bindir, env, seed)
    r = out["predict"]
    log("capi (a) image-classification-predict, ResNet-50 batch %d: %r, "
        "the same line as the port's Predictor; the C process %.2f s"
        % (r["batch"], r["line"], r["seconds"]))
    torch.cuda.empty_cache()
    out["lm"] = capi_train_lm(torch, mx, bindir, env, seed)
    r = out["lm"]
    log("capi (b) train_lm, the LM at %s batch %d, %d steps: parameters "
        "bit for bit the Python twin's (%d arrays, largest update %g); "
        "flash forward launches: C process %d, twin %d; step ms C %s, twin "
        "%s; the C process %.2f s; on %s"
        % (json.dumps(TRAIN), TRAIN_BATCH, CAPI_TRAIN_STEPS, r["arrays"],
           r["max_update"], r["c_launches"]["flash_attention"],
           r["twin_flash_launches"],
           ["%.2f" % t for t in r["c_step_ms"]],
           ["%.2f" % t for t in r["twin_step_ms"][:CAPI_TRAIN_STEPS]],
           r["seconds"], smi))
    log("capi (b) step time over %d steps, the first not counted: C "
        "median %.2f ms (%s), twin median %.2f ms (%s); C / twin %.4f; on %s"
        % (CAPI_TIMED_STEPS, r["c_median_ms"],
           ", ".join("%.2f" % t for t in r["c_timed_step_ms"]),
           r["twin_median_ms"],
           ", ".join("%.2f" % t for t in r["twin_step_ms"]),
           r["c_median_ms"] / r["twin_median_ms"], smi))
    torch.cuda.empty_cache()
    out["rtc"] = capi_rtc(torch, bindir, env, seed)
    r = out["rtc"]
    log("capi (c) rtc_saxpy n=%d: %g ulps (bound %g), max |diff| %g, "
        "launches in the C process %s; the C process %.2f s"
        % (r["n"], r["ulps"], CAPI_RTC_ULPS, r["max_abs_err"],
           r["c_launches"]["rtc"], r["seconds"]))
    out["consumers"] = capi_consumers(mx, bindir, env)
    log("capi (d) the unchanged consumers, %d runs each, every one exit 0 "
        "with its OK line: seconds %s" % (CAPI_RUNS,
                                          json.dumps(out["consumers"])))
    out["seconds"] = time.perf_counter() - t_phase
    log("capi: phase 16 %.2f s" % out["seconds"])
    shutil.rmtree(capi_dir(), ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 17: resilience
# ----------------------------------------------------------------------
RES_STEPS = 6
RES_BAD_STEP = 3
RES_TIMED_ROUNDS = 3
RES_TIMED_STEPS = 3
RES_ADAM = dict(learning_rate=1e-3)
RES_WATCHDOG_TIMEOUT_S = 2.0
RES_CHILD_TIMEOUT_S = 240
RES_MODULE_BATCH = 64
RES_MODULE_FEATURES = 128
SWEEP_GEN_BOUND = 0.05


def res_dir(*parts):
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "build", "chip_smoke_resilience", *parts)


def sign_clip_class(mx):
    """A user's optimizer whose ``update_fn`` is its own (one state
    vector, a sign and a clamp in its formula): the sweep runs it through
    the body generated from that formula."""
    if getattr(sign_clip_class, "cls", None) is None:
        class SignClip(mx.optimizer.Optimizer):
            elementwise = True

            def __init__(self, momentum=0.9, bound=SWEEP_GEN_BOUND, **kw):
                super().__init__(**kw)
                self.momentum = momentum
                self.bound = bound

            def create_state_arrays(self, shape, dtype=None, device=None):
                import torch
                return torch.zeros(tuple(shape), device=device,
                                   dtype=dtype or torch.float32)

            def update_fn(self, weight, grad, state, lr, wd, t):
                import torch
                m = self.momentum * state + (1.0 - self.momentum) * grad
                step = torch.clamp(torch.sign(m) * torch.sqrt(torch.abs(m)),
                                   -self.bound, self.bound)
                return weight - lr * (step + wd * weight), m
        sign_clip_class.cls = SignClip
    return sign_clip_class.cls


def res_trainer(torch, params, opt, mode="kernel", **kw):
    """The full-width LM's ShardedTrainer on the card from numpy weights,
    its parameters, optimizer state and aux."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer as tf
    os.environ["MXTPU_FUSED_OPT"] = mode
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**TRAIN), opt,
                                    ctx=torch.device(DEVICE), **kw)
    p = tf.params_from_numpy(params, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    return tr, p, st, {}


def _snap(tree):
    out = {}
    for n, v in tree.items():
        out[n] = tuple(x.clone() for x in v) if isinstance(v, tuple) \
            else v.clone()
    return out


def _same(a, b):
    """Names whose tensors (or tuple states) differ bit for bit."""
    import torch
    bad = []
    for n in a:
        x = a[n] if isinstance(a[n], tuple) else (a[n],)
        y = b[n] if isinstance(b[n], tuple) else (b[n],)
        if not all(torch.equal(u, v) for u, v in zip(x, y)):
            bad.append(n)
    return bad


def res_sentinel_lm(torch, seed, smi):
    """(a) The sentinel on the full-width LM: 6 steps, step 3's batch
    holding a token outside the vocabulary (the LM's ids are cast to
    integers, so kind=nan's NaN ids would be id 0, a finite step in both
    packages; an out-of-vocabulary id embeds as a row of NaN in both)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    S = TRAIN["seq_len"]
    params = seeded_train_params(seed)
    clean = train_batch(seed)
    bad = {k: v.copy() for k, v in clean.items()}
    bad["data"][1, 3] = TRAIN["vocab_size"]

    def opt():
        return mx.optimizer.create("sgd", rescale_grad=1.0 / (TRAIN_BATCH * S),
                                   **TRAIN_SGD)
    tr, p, st, aux = res_trainer(torch, params, opt(), sentinel=True)
    off, po, so, ao = res_trainer(torch, params, opt())
    b_clean, b_bad = tr.shard_batch(clean), tr.shard_batch(bad)
    n_buckets = len(fo.plan_buckets(p))
    torch.cuda.synchronize()
    reset_counts()
    fo.sweep.launches_gated = 0
    fa.flash_attention_forward.launches_by_dtype.update(float32=0,
                                                        bfloat16=0)
    trail = []
    for step in range(1, RES_STEPS + 1):
        b = b_bad if step == RES_BAD_STEP else b_clean
        gated0 = fo.sweep.launches_gated
        p, st, aux, outs = tr.step(p, st, aux, b)
        trail.append((_snap(p), _snap(st), tr.sentinel_stats(),
                      fo.sweep.launches_gated - gated0))
    torch.cuda.synchronize()
    counts = read_counts()
    counts["fused_opt_gated"] = fo.sweep.launches_gated
    counts["flash_attention_by_dtype"] = dict(
        fa.flash_attention_forward.launches_by_dtype)
    want = {"flash_attention": TRAIN["num_layers"] * RES_STEPS,
            "fused_opt": n_buckets * RES_STEPS}
    if {k: counts[k] for k in want} != want \
            or counts["fused_opt_gated"] != n_buckets * RES_STEPS:
        raise AssertionError("sentinel LM launches %s, want %s, every sweep "
                             "gated" % (counts, want))
    stats = [t[2] for t in trail]
    if [s["skipped"] for s in stats] != [0, 0, 1, 1, 1, 1] \
            or stats[2]["scale"] != stats[1]["scale"] / 2 \
            or stats[-1]["last_good"] != RES_STEPS:
        raise AssertionError("sentinel counters %s: want step %d skipped, "
                             "the scale halved" % (stats, RES_BAD_STEP))
    unchanged = _same(trail[1][0], trail[2][0]) + _same(trail[1][1],
                                                        trail[2][1])
    if unchanged:
        raise AssertionError("the skipped step changed %s" % unchanged[:5])
    if trail[2][3] != n_buckets:
        raise AssertionError("the skipped step launched %d gated sweeps, "
                             "want %d" % (trail[2][3], n_buckets))
    moved = [n for n in p if torch.equal(p[n], trail[2][0][n])]
    if len(moved) == len(p):
        raise AssertionError("the steps after the skip moved nothing")
    if not all(bool(torch.isfinite(v).all()) for v in p.values()):
        raise AssertionError("non-finite parameters after the skip")
    # steps 1-2 bit for bit a sentinel-off trainer's
    for _ in range(2):
        po, so, ao, _o = off.step(po, so, ao, b_clean)
    diff = _same(trail[1][0], po) + _same(trail[1][1], so)
    if diff:
        raise AssertionError("sentinel on and off differ after 2 clean "
                             "steps: %s" % diff[:5])
    del trail
    # synchronising calls a step, on and off
    syncs = {}
    for name, t, (pp, ss, aa) in (("on", tr, (p, st, aux)),
                                  ("off", off, (po, so, ao))):
        import warnings
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if DEVICE == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(2):
                    pp, ss, aa, _o = t.step(pp, ss, aa, b_clean)
            finally:
                if DEVICE == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
        where = ["%s:%d" % (os.path.relpath(w.filename), w.lineno)
                 for w in caught if "called a synchronizing" in str(w.message)]
        syncs[name] = len(where)
        syncs[name + "_at"] = sorted(set(where))
        if name == "on":
            p, st, aux = pp, ss, aa
        else:
            po, so, ao = pp, ss, aa
    if syncs["on"] != syncs["off"]:
        raise AssertionError("the sentinel adds synchronising calls: %s "
                             "over 2 steps" % syncs)
    # step time, sentinel on and off alternating
    times = {"on": [], "off": []}
    for _r in range(RES_TIMED_ROUNDS):
        for name in ("on", "off"):
            for _ in range(RES_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "on":
                    p, st, aux, _o = tr.step(p, st, aux, b_clean)
                else:
                    po, so, ao, _o = off.step(po, so, ao, b_clean)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    out = {"launches": counts, "stats": stats, "buckets": n_buckets,
           "syncs_two_steps": syncs,
           "step_ms_on": float(np.median(times["on"])),
           "step_ms_off": float(np.median(times["off"])),
           "step_ms_on_all": times["on"], "step_ms_off_all": times["off"]}
    log("resilience (a) sentinel on the LM at %s batch %d, SGD momentum "
        "0.9, MXTPU_FUSED_OPT=kernel: step %d (a token outside the "
        "vocabulary) skipped, parameters and momentum bit for bit "
        "unchanged, scale %g -> %g; steps 1-2 bit for bit sentinel off; "
        "launches %s (%d buckets, every sweep gated); synchronising calls "
        "over 2 steps %s; ms a step sentinel on %.3f, off %.3f (median of "
        "%d, alternating); on %s"
        % (json.dumps(TRAIN), TRAIN_BATCH, RES_BAD_STEP, stats[1]["scale"],
           stats[2]["scale"], json.dumps(counts), n_buckets,
           json.dumps(syncs), out["step_ms_on"], out["step_ms_off"],
           len(times["on"]), smi))
    return out


RES_WATCHDOG_CHILD = r"""
import json, os, sys, time
import chip_smoke as cs
cs.DEVICE = sys.argv[1]
cs.TRAIN = json.loads(sys.argv[3])
cs.TRAIN_BATCH = int(sys.argv[4])
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.resilience import ResilienceError
from mxnet_tpu_torch.kernels import _build
if cs.DEVICE == "cuda":
    _build.build_all()
params = cs.seeded_train_params(0)
# a first step on the card initialises CUDA's libraries: take it on an
# unwatched trainer, so the watched step 1 is a warm one
warm, p, st, aux = cs.res_trainer(torch, params, mx.optimizer.create(
    "sgd", learning_rate=0.1, momentum=0.9))
warm.step(p, st, aux, warm.shard_batch(cs.train_batch(0)))
del warm, p, st, aux
opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
tr, p, st, aux = cs.res_trainer(torch, params, opt,
                                step_timeout_s=float(sys.argv[2]))
b = tr.shard_batch(cs.train_batch(0))
p, st, aux, _ = tr.step(p, st, aux, b)
torch.cuda.synchronize() if cs.DEVICE == "cuda" else None
os.environ["MXTPU_FAULT_SPEC"] = "step=2:kind=hang:seconds=600"
t0 = time.perf_counter()
try:
    tr.step(p, st, aux, b)
    got = {"raised": False}
except ResilienceError as err:
    got = {"raised": True, "kind": err.kind, "phase": err.phase,
           "step": err.step, "rank": err.rank}
got["seconds"] = time.perf_counter() - t0
print("WATCHDOG " + json.dumps(got), flush=True)
os._exit(0)
"""


def res_watchdog(torch, smi):
    """(b) The step watchdog in a child process: the LM's step 2 hangs
    (``step=2:kind=hang``) under ``step_timeout_s=2``: a ResilienceError,
    and a flight dump naming (train_step, 2) as pending."""
    here = os.path.dirname(os.path.abspath(__file__))
    flight_dir = res_dir("flight")
    shutil.rmtree(flight_dir, ignore_errors=True)
    os.makedirs(flight_dir)
    env = dict(os.environ, MXTPU_TELEMETRY_DIR=flight_dir,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("MXTPU_FAULT_SPEC", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", RES_WATCHDOG_CHILD, DEVICE,
         str(RES_WATCHDOG_TIMEOUT_S), json.dumps(TRAIN), str(TRAIN_BATCH)],
        cwd=here, env=env,
        capture_output=True, text=True, timeout=RES_CHILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("WATCHDOG ")]
    if proc.returncode != 0 or not line:
        raise AssertionError("watchdog child: exit %d, stdout %r, stderr "
                             "%s" % (proc.returncode, proc.stdout[-2000:],
                                     proc.stderr[-4000:]))
    got = json.loads(line[-1][len("WATCHDOG "):])
    want = {"raised": True, "kind": "timeout", "phase": "train_step",
            "step": 2, "rank": 0}
    if {k: got.get(k) for k in want} != want \
            or got["seconds"] > RES_WATCHDOG_TIMEOUT_S + 10:
        raise AssertionError("watchdog child %s, want %s within %g s"
                             % (got, want, RES_WATCHDOG_TIMEOUT_S + 10))
    dumps = []
    for path in sorted(os.listdir(flight_dir)):
        if path.startswith("flight-rank") and path.endswith(".json"):
            with open(os.path.join(flight_dir, path)) as f:
                dumps.append(json.load(f))
    named = [d for d in dumps if d.get("reason") == "watchdog_timeout"
             and ("train_step", 2) in [(e["op"], e["seq"]) for e in
                                       d["pending_collectives"]]]
    if not named:
        raise AssertionError("no flight dump names (train_step, 2) as "
                             "pending: %s" % [
                                 (d.get("reason"), d["pending_collectives"])
                                 for d in dumps])
    out = {"error": got, "dumps": len(dumps), "child_s": seconds,
           "pending": named[0]["pending_collectives"],
           "events_in_ring": len(named[0]["events"])}
    log("resilience (b) watchdog: the child's step 2 hung, ResilienceError "
        "%s after %.2f s (timeout %g s); flight dump pending %s, %d events "
        "in its ring; the child process %.2f s; on %s"
        % (json.dumps(got), got["seconds"], RES_WATCHDOG_TIMEOUT_S,
           json.dumps(out["pending"]), out["events_in_ring"], seconds, smi))
    shutil.rmtree(flight_dir, ignore_errors=True)
    return out


def res_checkpoints(torch, seed, smi):
    """(c) Adam on the full-width LM: save at step 3, auto_resume in a new
    trainer, 3 more steps: bit for bit 6 uninterrupted steps."""
    import mxnet_tpu_torch as mx
    S = TRAIN["seq_len"]
    params = seeded_train_params(seed)

    def opt():
        return mx.optimizer.create("adam", rescale_grad=1.0 / (TRAIN_BATCH
                                                               * S),
                                   **RES_ADAM)
    ckdir = res_dir("ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    data = {"data": (TRAIN_BATCH, S)}
    label = {"softmax_label": (TRAIN_BATCH, S)}
    tr, p, st, aux = res_trainer(torch, params, opt())
    b = tr.shard_batch(train_batch(seed))
    for _ in range(RES_STEPS):
        p, st, aux, _o = tr.step(p, st, aux, b)
    torch.cuda.synchronize()
    want_p, want_s = _snap(p), _snap(st)
    del tr, p, st
    tr1, p, st, aux = res_trainer(torch, params, opt())
    for _ in range(RES_STEPS // 2):
        p, st, aux, _o = tr1.step(p, st, aux, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr1.save_checkpoint_versioned(ckdir, p, st, aux)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _d, fs in os.walk(ckdir) for f in fs)
    del tr1, p, st
    tr2, _p, _s, _a = res_trainer(torch, params, opt())
    del _p, _s
    t0 = time.perf_counter()
    p, st, aux, step = tr2.auto_resume(ckdir, data, label_shapes=label)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != RES_STEPS // 2 or tr2.num_update != step:
        raise AssertionError("auto_resume step %s, num_update %d"
                             % (step, tr2.num_update))
    where = {str(v.device) for v in p.values()}
    if where != {str(tr2.device)}:
        raise AssertionError("restored parameters on %s, the trainer on %s"
                             % (where, tr2.device))
    for _ in range(RES_STEPS - step):
        p, st, aux, _o = tr2.step(p, st, aux, b)
    torch.cuda.synchronize()
    diff = _same(want_p, p) + _same(want_s, st)
    if diff:
        raise AssertionError("resumed run differs from the uninterrupted "
                             "one: %s" % diff[:5])
    out = {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes,
           "path": os.path.relpath(path, res_dir())}
    log("resilience (c) checkpoints, Adam on the LM: saved at step %d "
        "(%.1f MB, host format) in %.3f s, auto_resume in a new trainer in "
        "%.3f s (on %s), %d more steps bit for bit %d uninterrupted steps "
        "(%d arrays and their two states); on %s"
        % (step, nbytes / 2 ** 20, save_s, restore_s, tr2.device,
           RES_STEPS - step, RES_STEPS, len(want_p), smi))
    shutil.rmtree(ckdir, ignore_errors=True)
    return out


def res_generated_sweep(torch, timer, seed, smi):
    """(d) The sweep body generated from a user's update_fn: at every
    bucket of the LM and at 16 M elements, bit for bit its plain version
    on the card (and a skip flag of 0 writes nothing), timed beside the
    bytes bound and NVRTC's compile time; then 2 LM steps through the
    trainer with it, bit for bit the leafwise update."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.kernels import sweep_codegen as cg
    SignClip = sign_clip_class(mx)
    S = TRAIN["seq_len"]
    opt = SignClip(learning_rate=0.01, rescale_grad=1.0 / (TRAIN_BATCH * S),
                   clip_gradient=10.0)
    if fo.sweep_body(opt) != fo.GENERATED:
        raise AssertionError("the user's optimizer did not take the "
                             "generated body")
    prog = cg.program(opt, preprocess=True)
    shapes = train_param_shapes()
    metas = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    sizes = [sum(int(np.prod(shapes[n])) for n in bk)
             for bk in fo.plan_buckets(metas)]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 17)
    rows = []
    for n in sorted(set(sizes)) + [SWEEP_N]:
        w = torch.randn(n, generator=gen, device=DEVICE) * 0.02
        g = torch.randn(n, generator=gen, device=DEVICE) * (TRAIN_BATCH * S
                                                             * 1e-3)
        m = torch.randn(n, generator=gen, device=DEVICE) * 1e-4
        err, ulp, repeat = _sweep_check(torch, fo, opt, w, g, [m], 0.01,
                                        1e-4, 3)
        if err != 0.0 or not repeat:
            raise AssertionError("generated sweep n=%d: max err %g (%g ulp) "
                                 "against the plain version, repeat bitwise "
                                 "%s" % (n, err, ulp, repeat))
        ww, mm = w.clone(), m.clone()
        fo.sweep(opt, ww, g, [mm], 0.01, 1e-4, 3,
                 ok=torch.zeros((), dtype=torch.int32, device=DEVICE))
        if not (torch.equal(ww, w) and torch.equal(mm, m)):
            raise AssertionError("generated sweep n=%d wrote under a skip "
                                 "flag of 0" % n)
        n_bytes = 5 * 4 * n          # w, m read and written, g read
        b_ms, b_by = bound_ms(n_bytes, 0)
        one = torch.ones((), dtype=torch.int32, device=DEVICE)
        r = {"n": n, "mbytes": 4 * n / 2 ** 20, "max_abs_err": err,
             "max_ulp": ulp, "tol": "bitwise",
             "ms": timer(lambda: fo.sweep(opt, w, g, [m], 0.01, 1e-4, 3)),
             "ms_gated": timer(lambda: fo.sweep(opt, w, g, [m], 0.01, 1e-4,
                                                3, ok=one)),
             "plain_ms": timer(lambda: fo.sweep_reference(
                 opt, w, g, [m], 0.01, 1e-4, 3)),
             "library_ms": None, "library": "none (no one PyTorch call "
                                             "computes this formula)",
             "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        rows.append(r)
        log("resilience (d) generated sweep n=%-9d (%.1f MB) bitwise; "
            "kernel_ms=%.4f (skip flag 1: %.4f) plain_ms=%.4f library_ms="
            "none bound_ms=%.5f (%s)" % (n, r["mbytes"], r["ms"],
                                         r["ms_gated"], r["plain_ms"], b_ms,
                                         b_by))
    compile_s = cg.compile_seconds(prog)
    # the trainer with the user's optimizer: kernel == leafwise, bitwise
    params = seeded_train_params(seed)
    batch = train_batch(seed)
    runs = {}
    for mode in ("kernel", ""):
        o = SignClip(learning_rate=0.01, rescale_grad=1.0 / (TRAIN_BATCH * S),
                     clip_gradient=10.0)
        tr, p, st, aux = res_trainer(torch, params, o, mode=mode)
        b = tr.shard_batch(batch)
        torch.cuda.synchronize()
        reset_counts()
        for _ in range(2):
            p, st, aux, _o = tr.step(p, st, aux, b)
        torch.cuda.synchronize()
        runs[mode] = (_snap(p), _snap(st), read_counts(),
                      len(fo.plan_buckets(p)))
    diff = _same(runs["kernel"][0], runs[""][0]) + _same(runs["kernel"][1],
                                                         runs[""][1])
    if diff:
        raise AssertionError("generated sweep in the trainer differs from "
                             "leafwise: %s" % diff[:5])
    counts, n_buckets = runs["kernel"][2], runs["kernel"][3]
    if counts["fused_opt_by_body"] != {fo.GENERATED: 2 * n_buckets}:
        raise AssertionError("trainer sweeps by body %s, want %d generated"
                             % (counts["fused_opt_by_body"], 2 * n_buckets))
    out = {"rows": rows, "compile_s": compile_s, "ops": prog.ops(),
           "trainer_launches": counts, "buckets": n_buckets}
    log("resilience (d) generated body of %s (ops %s): NVRTC compile %.3f s "
        "(--fmad=false); 2 LM steps through ShardedTrainer bit for bit the "
        "leafwise update, sweeps %s; on %s"
        % (prog.name, ", ".join(prog.ops()), compile_s or 0.0,
           json.dumps(counts["fused_opt_by_body"]), smi))
    return out


def res_module_fit(torch, seed, smi):
    """(e) Module.fit with MXTPU_SENTINEL=1 on the card: three batches of
    an MLP, the second NaN: that step skipped, the parameters after it
    bit for bit those before it, finite after the third."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed + 23)
    n, f = RES_MODULE_BATCH, RES_MODULE_FEATURES
    x = rng.randn(3 * n, f).astype(np.float32)
    y = rng.randint(0, 10, 3 * n).astype(np.float32)
    x[n:2 * n] = np.nan
    after = []

    def grab(param):
        after.append({k: v.asnumpy() for k, v in
                      mod.get_params()[0].items()})
    os.environ["MXTPU_SENTINEL"] = "1"
    try:
        mx.random.seed(seed)
        mod = mx.mod.Module(mx.models.mlp.get_symbol(num_classes=10),
                            context=mx.gpu(0) if DEVICE == "cuda"
                            else mx.cpu())
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=n), num_epoch=1,
                optimizer_params=(("learning_rate", 0.1),),
                batch_end_callback=grab)
    finally:
        os.environ.pop("MXTPU_SENTINEL", None)
    if len(after) != 3:
        raise AssertionError("Module.fit ran %d batches" % len(after))
    same = [k for k in after[0] if np.array_equal(after[0][k], after[1][k])]
    moved = [k for k in after[0]
             if not np.array_equal(after[1][k], after[2][k])]
    finite = all(np.isfinite(v).all() for v in after[2].values())
    if len(same) != len(after[0]) or not moved or not finite:
        raise AssertionError("Module.fit sentinel: unchanged over the NaN "
                             "batch %s of %d, moved after it %s, finite %s"
                             % (same, len(after[0]), moved, finite))
    log("resilience (e) Module.fit with MXTPU_SENTINEL=1 on %s: batch 2 of "
        "3 NaN, skipped (its %d parameters bit for bit those after batch "
        "1), batch 3 moved %d, all finite; on %s"
        % (DEVICE, len(same), len(moved), smi))
    return {"unchanged": len(same), "moved": len(moved)}


def phase_resilience(torch, timer, seed, smi):
    """Phase 17: the resilience slice on the card: (a) the in-step
    sentinel on the LM, (b) the step watchdog in a child process, (c) the
    trainer's checkpoints, (d) the generated sweep body, (e) Module.fit's
    sentinel."""
    t_phase = time.perf_counter()
    out = {"sentinel": res_sentinel_lm(torch, seed, smi)}
    torch.cuda.empty_cache()
    out["watchdog"] = res_watchdog(torch, smi)
    out["checkpoints"] = res_checkpoints(torch, seed, smi)
    torch.cuda.empty_cache()
    out["generated"] = res_generated_sweep(torch, timer, seed, smi)
    torch.cuda.empty_cache()
    out["module"] = res_module_fit(torch, seed, smi)
    os.environ.pop("MXTPU_FUSED_OPT", None)
    out["seconds"] = time.perf_counter() - t_phase
    log("resilience: phase 17 %.2f s" % out["seconds"])
    shutil.rmtree(res_dir(), ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 18: observability
# ----------------------------------------------------------------------
OBS_STEPS = 6
OBS_ONOFF_ROUNDS = 4
OBS_PROFILED_STEPS = 2
OBS_REQUESTS = 32
#: the report's step p50 against the host clock around the same calls
OBS_P50_REL = 0.05
#: the live engine's objective from MXTPU_SLO_SPEC (ms, far above any
#: request's latency) and the windows of the held-out checks (s; wide
#: enough to cover the whole run)
OBS_SLO_TARGET_MS = 600000.0
OBS_SLO_WINDOWS = "fast=600:slow=1200:tfast=600:tslow=1200"


def obs_dir(*parts):
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "build", "chip_smoke_observability", *parts)


def lm_step_flops(batch, seq_len, vocab_size, num_layers, dim, ffn_mult=4,
                  **_unused):
    """The LM's model FLOPs a training step, written out: per layer the
    qkv, output and two FFN projections and attention's q k^T and p v
    over the full S x S scores, then the head; a multiply-add is 2, and
    the step is 3 forwards."""
    tokens = batch * seq_len
    layer = 2 * tokens * dim * (3 * dim + dim + 2 * ffn_mult * dim) \
        + 2 * 2 * batch * seq_len * seq_len * dim
    return 3 * (num_layers * layer + 2 * tokens * dim * vocab_size)


def _set_telemetry(directory):
    """Telemetry into ``directory`` (None: off), the process step
    statistics started afresh."""
    from mxnet_tpu_torch.observability import counters, events
    if directory is None:
        os.environ.pop("MXTPU_TELEMETRY", None)
        os.environ.pop("MXTPU_TELEMETRY_DIR", None)
    else:
        os.makedirs(directory, exist_ok=True)
        os.environ["MXTPU_TELEMETRY"] = "1"
        os.environ["MXTPU_TELEMETRY_DIR"] = directory
    events.refresh()
    counters.reset()


def obs_train(torch, dtype, seed, smi):
    """(a) OBS_STEPS steps of phase 7's LM with telemetry on and
    ``emit_telemetry_counters`` after each, then the same trainer with
    telemetry on and off alternating; returns the readings and the
    launch counts of the counted steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.observability import aggregate, events, percentile
    from mxnet_tpu_torch.tools import mxtrace
    S = TRAIN["seq_len"]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (TRAIN_BATCH * S),
                              **TRAIN_SGD)
    tr, p, st, aux = res_trainer(torch, seeded_train_params(seed), opt,
                                 compute_dtype=None if dtype == "float32"
                                 else dtype)
    b = tr.shard_batch(train_batch(seed, TRAIN_BATCH))
    tel = obs_dir("train_" + dtype)
    shutil.rmtree(tel, ignore_errors=True)
    _set_telemetry(tel)
    torch.cuda.synchronize()
    reset_counts()
    dispatch_ms, step_s, emitted = [], [], []
    for _ in range(OBS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, st, aux, outs = tr.step(p, st, aux, b)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dispatch_ms.append((t1 - t0) * 1e3)
        step_s.append(t2 - t0)
        emitted.append(tr.emit_telemetry_counters(step_time_s=t2 - t0))
    counts = read_counts()
    if not bool(torch.isfinite(outs[0].float()).all()):
        raise AssertionError("telemetry %s: non-finite outputs" % dtype)
    events.flush()
    n_buckets = len(fo.plan_buckets({n: p[n] for n in tr.param_names}))
    want = {"flash_attention": TRAIN["num_layers"] * OBS_STEPS,
            "fused_opt": n_buckets * OBS_STEPS}
    if {k: counts[k] for k in want} != want:
        raise AssertionError("telemetry %s launches %s, want %s"
                             % (dtype, counts, want))
    flops = lm_step_flops(TRAIN_BATCH, **TRAIN)
    mfus = [e.get("mfu") for e in emitted]
    bad = [e for e in emitted if e.get("flops_per_step") != float(flops)]
    if bad:
        raise AssertionError("telemetry %s: flops_per_step %s, want the "
                             "analytic %d" % (dtype, bad[0], flops))
    if not all(m is not None and 0.0 < m <= 1.0 for m in mfus):
        raise AssertionError("telemetry %s: mfu %s not in (0, 1]"
                             % (dtype, mfus))
    records = aggregate.read_events(tel)
    report = aggregate.build_report(records)
    pod = report["pod"]
    host_p50 = percentile(dispatch_ms, 50)
    if pod["steps"] != OBS_STEPS or report["per_rank"]["0"]["steps"] \
            != OBS_STEPS:
        raise AssertionError("telemetry %s: the report shows %s steps, "
                             "want %d" % (dtype, pod["steps"], OBS_STEPS))
    if abs(pod["step_ms_p50"] - host_p50) > OBS_P50_REL * host_p50:
        raise AssertionError("telemetry %s: report p50 %.3f ms, host clock "
                             "%.3f ms (more than %g apart)"
                             % (dtype, pod["step_ms_p50"], host_p50,
                                OBS_P50_REL))
    if pod["mfu"] is None:
        raise AssertionError("telemetry %s: the report has no MFU" % dtype)
    trace = mxtrace.build_trace(records)
    slices = [e for e in trace["traceEvents"]
              if e["ph"] == "X" and e.get("tid") == mxtrace.TID_STEP]
    if sorted(e["args"]["step"] for e in slices) != list(range(1, OBS_STEPS
                                                               + 1)):
        raise AssertionError("mxtrace %s: step slices %s, want one a step"
                             % (dtype, [e["args"].get("step")
                                        for e in slices]))
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.mxtop", tel, "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or json.loads(proc.stdout)["pod"]["steps"] \
            != OBS_STEPS:
        raise AssertionError("mxtop --json %s: rc %d: %s"
                             % (dtype, proc.returncode, proc.stderr[-500:]))
    # telemetry on and off, alternating, on the same trainer (the on
    # steps log into a directory of their own)
    onoff = {"on": [], "off": []}
    for _r in range(OBS_ONOFF_ROUNDS):
        for mode in ("on", "off"):
            _set_telemetry(obs_dir("onoff_" + dtype) if mode == "on"
                           else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, aux, _o = tr.step(p, st, aux, b)
            torch.cuda.synchronize()
            onoff[mode].append((time.perf_counter() - t0) * 1e3)
    _set_telemetry(None)
    out = {"launches": counts, "buckets": n_buckets, "flops_per_step": flops,
           "mfu": mfus, "mfu_median": float(np.median(mfus)),
           "step_ms": [t * 1e3 for t in step_s],
           "step_ms_median": float(np.median(step_s)) * 1e3,
           "dispatch_ms": dispatch_ms, "host_dispatch_p50_ms": host_p50,
           "report_step_ms_p50": pod["step_ms_p50"],
           "report_mfu": pod["mfu"], "trace_step_slices": len(slices),
           "onoff_ms": onoff,
           "telemetry_on_ms_median": float(np.median(onoff["on"])),
           "telemetry_off_ms_median": float(np.median(onoff["off"]))}
    log("observability (a) %s LM %s batch %d, MXTPU_FUSED_OPT=kernel, "
        "telemetry on: %d steps, %.6g FLOP a step (the analytic count), "
        "MFU at the %s peak %s (median %.4f; the report's %s), ms a step "
        "%.3f (median, synchronised); report p50 %.3f ms against the host "
        "clock's %.3f ms around the same calls (dispatch, the trainer does "
        "not synchronise); mxtrace %d step slices; mxtop --json rc 0; "
        "launches %s; telemetry on %.3f ms, off %.3f ms a step (median of "
        "%d each, alternating); on %s"
        % (dtype, json.dumps(TRAIN), TRAIN_BATCH, OBS_STEPS, flops, dtype,
           ["%.4f" % m for m in mfus], out["mfu_median"], pod["mfu"],
           out["step_ms_median"], pod["step_ms_p50"], host_p50, len(slices),
           json.dumps(counts), out["telemetry_on_ms_median"],
           out["telemetry_off_ms_median"], OBS_ONOFF_ROUNDS, smi))
    return out, tr, p, st, aux, b


def lead_in_kernels(doc, kernels):
    """The kernels of a trace's ``mx.profiler.lead_in`` range that kept
    their records: those launched by a CPU op inside the range."""
    events = doc.get("traceEvents", [])
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == "mx.profiler.lead_in"]
    ids = {e.get("args", {}).get("External id") for e in events
           if e.get("cat") == "cpu_op" and any(
               a <= e.get("ts", -1) <= b for a, b in spans)}
    return sum(1 for k in kernels
               if k.get("args", {}).get("External id") in ids - {None})


def obs_profile(torch, tr, p, st, aux, b, smi):
    """(b) ``mx.profiler`` around OBS_PROFILED_STEPS float32 steps: the
    written Chrome trace must name the hand flash-attention and sweep
    kernels among its CUDA kernels."""
    import mxnet_tpu_torch as mx
    mx.profiler.profiler_set_config(filename=obs_dir("profile"))
    torch.cuda.synchronize()
    mx.profiler.profiler_set_state("run")
    try:
        for _ in range(OBS_PROFILED_STEPS):
            p, st, aux, _o = tr.step(p, st, aux, b)
    finally:
        path = mx.profiler.profiler_set_state("stop")
    with open(path) as f:
        doc = json.load(f)
    kernels = [e for e in doc.get("traceEvents", [])
               if e.get("cat") == "kernel"]
    names = {"flash_attention": "flash_forward_", "fused_opt": "sweep_"}
    found = {k: sum(1 for e in kernels if marker in e.get("name", ""))
             for k, marker in names.items()}
    if DEVICE != "cuda":        # a CPU rehearsal: host events only
        found = {k: len(doc.get("traceEvents", [])) for k in names}
    if not all(found.values()):
        raise AssertionError("profiler trace %s: hand kernels %s among %d "
                             "CUDA kernels (names %s)"
                             % (path, found, len(kernels),
                                sorted({e.get("name", "")[:60]
                                        for e in kernels})[:20]))
    out = {"trace_bytes": os.path.getsize(path), "kernels": len(kernels),
           "hand_kernels": found,
           "probe_device_events": list(mx.profiler._state["probe"]),
           "lead_in_kernels": lead_in_kernels(doc, kernels),
           "kernel_names": sorted({
               m.group(0) for e in kernels for m in [re.search(
                   r"(flash_forward_|sweep_)\w+(<\d+>)?", e["name"])]
               if m})}
    log("observability (b) mx.profiler over %d float32 steps: %d CUDA "
        "kernels in the trace (%d bytes), hand kernels %s: %s; the probe's "
        "device events of %d kernels a try %s; the lead-in's kernels kept "
        "%d of %d; on %s"
        % (OBS_PROFILED_STEPS, len(kernels), out["trace_bytes"],
           json.dumps(found), out["kernel_names"],
           mx.profiler.PROBE_KERNELS, out["probe_device_events"],
           out["lead_in_kernels"], mx.profiler.LEAD_IN, smi))
    return out


def obs_serve(torch, seed, smi):
    """(c) A ModelServer over phase 4b's fp8 LM under the retrace sentry,
    the lock sanitizer and the live SLO engine, OBS_REQUESTS requests."""
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.observability import (locktrace, metrics, retrace,
                                               sloengine)
    from mxnet_tpu_torch.serving import ModelServer
    metrics.reset_registry()
    sloengine.reset_engine()
    os.environ["MXTPU_SLO_SPEC"] = \
        "metric=mxtpu_serve_latency_ms:target=%r:%s" % (OBS_SLO_TARGET_MS,
                                                        OBS_SLO_WINDOWS)
    os.environ["MXTPU_SLO_INTERVAL_S"] = "0.5"
    locktrace.install()
    locktrace.reset_order_graph()
    retrace.install()
    retrace.reset()
    try:
        live = sloengine.maybe_start(source="chip_smoke")
        if live is None:
            raise AssertionError("MXTPU_SLO_SPEC started no SLO engine")
        ctx = None if DEVICE == "cuda" else torch.device(DEVICE)
        params = seeded_params(seed)
        srv = ModelServer()
        srv.add_generative_model("lm-fp8", params, ctx=ctx,
                                 quantize="fp8_e4m3", **MODEL)
        prompts = make_prompts(seed, OBS_REQUESTS - N_PROMPTS)
        torch.cuda.synchronize()
        reset_counts()
        qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
        busy = {}
        t0 = time.perf_counter()
        futures = _client_threads([
            (lambda i=i: _submit_generation(srv, "lm-fp8", prompts[i], None,
                                            busy))
            for i in range(OBS_REQUESTS)])
        results = [f.result(timeout=600) for f in futures]
        srv.drain(timeout=600)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        counts["quantized_matmul_by_route"] = dict(
            qz.quantized_matmul.launches_by_route)
        stats = srv.stats()
        srv.close()
        sentry = retrace.stats()
        edges = len(locktrace.order_edges())
        time.sleep(1.2)                 # one more pass of the live engine
        live_state = live.state()
        live.stop()
    finally:
        retrace.uninstall()
        locktrace.uninstall()
        sloengine.reset_engine()
        os.environ.pop("MXTPU_SLO_SPEC", None)
        os.environ.pop("MXTPU_SLO_INTERVAL_S", None)
    if stats["failed"]:
        raise AssertionError("%d requests failed under the sanitizers"
                             % stats["failed"])
    if sentry["retraces_after_warmup"] or not sentry["lowerings_seen"]:
        raise AssertionError("retrace sentry: %s (want 0 after warmup, "
                             "and the warmup's lowerings seen)" % sentry)
    if counts["flash_decode"] < 1 or counts["quantized_matmul"] < 1:
        raise AssertionError("serving under the sanitizers launched %s"
                             % counts)
    check_generated(torch, "lm-fp8", dequantized_params(params, "fp8_e4m3"),
                    prompts[:2], results[:2])
    hist = next(iter(metrics.registry().histograms("mxtpu_serve_latency_ms")))
    p50 = hist.cumulative.percentile(50)
    if hist.cumulative.count < OBS_REQUESTS:
        raise AssertionError("latency histogram holds %d samples, want %d"
                             % (hist.cumulative.count, OBS_REQUESTS))
    if live_state["evals"] < 1 or live_state["last_alert"] is not None:
        raise AssertionError("live SLO engine %s: want evaluations and no "
                             "alert at a %g ms target"
                             % (live_state, OBS_SLO_TARGET_MS))
    alerts = {}
    now = time.time()
    for name, target in (("below_p50", p50 / 2.0),
                         ("far_above", p50 * 1000.0)):
        eng = sloengine.SloEngine(specs=sloengine.parse_specs(
            "metric=mxtpu_serve_latency_ms:target=%r:%s"
            % (target, OBS_SLO_WINDOWS)), source="chip_smoke")
        alerts[name] = eng.evaluate(now=now)
    pages = [a for a in alerts["below_p50"]
             if a["tier"] == "page" and a["edge"] == "fire"]
    if not pages or alerts["far_above"]:
        raise AssertionError("SLO alerts %s: want a page at a target below "
                             "p50 %.3f ms and none far above it"
                             % (alerts, p50))
    out = {"launches": counts, "requests": OBS_REQUESTS, "wall_s": wall_s,
           "latency_ms_p50": p50, "retrace": sentry,
           "lock_order_edges": edges, "busy_429": busy,
           "slo_live": {"evals": live_state["evals"],
                        "target_ms": OBS_SLO_TARGET_MS},
           "slo_page_burns": pages[0]["burns"]}
    log("observability (c) ModelServer lm-fp8 at %s, %d requests under the "
        "retrace sentry, the lock sanitizer and MXTPU_SLO_SPEC: %.2f s, "
        "latency p50 %.3f ms; retraces after warmup %d (lowerings seen %d); "
        "lock-order errors 0 over %d order edges; live engine %d "
        "evaluations, no alert at %g ms; a target of p50/2 pages (burns "
        "%s), p50*1000 is quiet; launches %s; on %s"
        % (json.dumps(MODEL), OBS_REQUESTS, wall_s, p50,
           sentry["retraces_after_warmup"], sentry["lowerings_seen"], edges,
           live_state["evals"], OBS_SLO_TARGET_MS,
           json.dumps(pages[0]["burns"]), json.dumps(counts), smi))
    return out


def phase_observability(torch, seed, smi):
    """Phase 18: the observability slice on the card: (a) the LM's steps
    with telemetry on, float32 and bfloat16, (b) the profiler's trace,
    (c) serving under the sanitizers and the SLO engine."""
    t_phase = time.perf_counter()
    shutil.rmtree(obs_dir(), ignore_errors=True)
    out = {}
    for dtype in ("float32", "bfloat16"):
        res = obs_train(torch, dtype, seed, smi)
        out[dtype] = res[0]
        if dtype == "float32":
            out["profile"] = obs_profile(torch, *res[1:], smi)
        del res
        torch.cuda.empty_cache()
    out["serve"] = obs_serve(torch, seed, smi)
    os.environ.pop("MXTPU_FUSED_OPT", None)
    out["seconds"] = time.perf_counter() - t_phase
    log("observability: phase 18 %.2f s" % out["seconds"])
    shutil.rmtree(obs_dir(), ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 19: the graph analyzer (bind-time lint, MXL-K, MXL-R, MXL-M)
# ----------------------------------------------------------------------
#: binds a mode is timed (medians, off and warn alternating)
ANA_BIND_ROUNDS = 5
#: steps timed for (c) when the phase runs alone (the whole run reuses
#: phases 7 and 9's medians)
ANA_TIMED_STEPS = 5
#: steps of the LM trainer whose counters (c) writes, and whose peak
#: memory (d) reads
ANA_COUNTER_STEPS = 2


def ana_dir(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_analysis", *parts)


def ana_configs():
    """The main paths' training graphs of phases 7 and 9: ``{name: (sym,
    input shapes)}``."""
    from mxnet_tpu_torch.models import transformer as tf
    S = TRAIN["seq_len"]
    return {"lm": (tf.get_symbol(**TRAIN),
                   {"data": (TRAIN_BATCH, S),
                    "softmax_label": (TRAIN_BATCH, S)}),
            "resnet50": (resnet_symbol(),
                         {"data": (RESNET_BATCH,) + RESNET["image_shape"],
                          "softmax_label": (RESNET_BATCH,)})}


def ana_bind(torch, smi):
    """(a) Each main-path graph bound on ``gpu(0)`` with
    ``validate="error"`` in float32 and bfloat16 (every argument but the
    inputs in that type): no error finding; the warnings by rule; the
    bind time with ``validate="off"`` against ``"warn"`` (medians of
    ANA_BIND_ROUNDS, alternating, over the same arrays); no lowering
    after the first bind of each mode."""
    import warnings
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import program_registry_stats
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    before = program_registry_stats()
    out = {"registry_before": before}
    for name, (sym, shapes) in ana_configs().items():
        for dtype in ("float32", "bfloat16"):
            types = {n: dtype for n in sym.list_arguments()
                     if n not in shapes}
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                exe = sym.simple_bind(ctx, grad_req="write",
                                      type_dict=types, validate="error",
                                      **shapes)
            issues = exe.bind_issues
            if any(i.severity == "error" for i in issues):
                raise AssertionError("analysis (a) %s %s: error findings %s"
                                     % (name, dtype, issues))
            by_rule = {}
            for i in issues:
                key = "%s %s" % (i.rule_id, i.severity)
                by_rule[key] = by_rule.get(key, 0) + 1
            # the roofline prices the products at the bound weights' dtype:
            # float32 products run on the FMA pipes (R003), bfloat16 ones
            # on the tensor cores
            r003 = any(i.rule_id == "MXL-R003" for i in issues)
            if r003 != (dtype == "float32"):
                raise AssertionError(
                    "analysis (a) %s %s: MXL-R003 %s" % (
                        name, dtype, "reported" if r003 else "missing"))
            kw = dict(args=exe.arg_dict, args_grad=exe.grad_dict,
                      grad_req="write", aux_states=exe.aux_dict)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for mode in ("off", "warn"):          # each mode's program
                    sym.bind(ctx, validate=mode, **kw)
                warm = program_registry_stats()
                times = {"off": [], "warn": []}
                for _r in range(ANA_BIND_ROUNDS):
                    for mode in ("off", "warn"):
                        t0 = time.perf_counter()
                        sym.bind(ctx, validate=mode, **kw)
                        times[mode].append((time.perf_counter() - t0) * 1e3)
            after = program_registry_stats()
            if after["lowerings"] != warm["lowerings"]:
                raise AssertionError(
                    "analysis (a) %s %s: %d lowerings after warm-up"
                    % (name, dtype, after["lowerings"] - warm["lowerings"]))
            row = {"findings_by_rule": by_rule,
                   "bind_ms_off": float(np.median(times["off"])),
                   "bind_ms_warn": float(np.median(times["warn"])),
                   "bind_ms_all": times}
            row["lint_ms"] = row["bind_ms_warn"] - row["bind_ms_off"]
            out["%s_%s" % (name, dtype)] = row
            log("analysis (a) %s %s bound on %s with validate=\"error\": no "
                "error finding; findings by rule %s; bind %.3f ms off, "
                "%.3f ms warn (medians of %d, alternating): the lint's host "
                "cost %.3f ms a bind; on %s"
                % (name, dtype, ctx, json.dumps(by_rule), row["bind_ms_off"],
                   row["bind_ms_warn"], ANA_BIND_ROUNDS, row["lint_ms"], smi))
            del exe, kw
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    out["registry_after"] = program_registry_stats()
    log("analysis (a) program_registry_stats before %s, after %s"
        % (json.dumps(before), json.dumps(out["registry_after"])))
    return out


def ana_specs(torch, compiled=False):
    """Every registered launch at the shapes the main paths launch: rows
    1-4 of the kernel table, both bodies of the int8/fp8 matmul and of
    the flash forward, the sweep on the LM's buckets and the LSTM's.
    ``compiled``: with the shared memory the built libraries report (the
    sweep's launches pass none)."""
    from mxnet_tpu_torch.kernels import (flash_attention, flash_decode,
                                         fused_opt, quantize)
    from mxnet_tpu_torch.observability.counters import launch_limits
    sms = launch_limits()["sms"]
    specs = []
    for q, kv in (("float32", "float32"), ("bfloat16", "bfloat16"),
                  ("float32", "bfloat16")):
        specs.append(flash_decode.launch_spec(q_dtype=q, kv_dtype=kv,
                                              sms=sms, compiled=compiled,
                                              **flash_decode.MAIN_SHAPES))
    for k, n in ((512, 2048), (2048, 512), (512, 8192)):
        for m in (8, 960):
            for qd in ("int8", "fp8_e4m3"):
                specs += quantize.launch_specs(m, n, k, "float32", qd, sms,
                                               compiled=compiled)
    D = TRAIN["dim"] // TRAIN["num_heads"]
    for dtype in ("float32", "bfloat16"):
        specs.append(flash_attention.launch_spec(
            TRAIN_BATCH, TRAIN["num_heads"], TRAIN["seq_len"],
            TRAIN["seq_len"], D, dtype, sms=sms, compiled=compiled))
    params = {n: torch.empty(s) for n, s in train_param_shapes().items()}
    buckets = [sum(params[n].numel() for n in bk)
               for bk in fused_opt.plan_buckets(params)]
    for n in buckets:
        for gated in (False, True):
            specs.append(fused_opt.launch_spec(n, 1, "vec4", gated))
    specs.append(fused_opt.launch_spec(fused_opt.MAIN_BUCKETS[1][0], 0,
                                       "vec4"))
    return specs, buckets


def ana_kernels(torch, info, smi):
    """(b) MXL-K against the compiled kernels: each spec of
    :func:`ana_specs` lints clean against the card's properties, and its
    register budget and static shared memory agree with ``nvcc -Xptxas
    -v``'s report of its entry function (registers at most the budget,
    shared memory the static declaration in ptxas's 16-byte grain), and
    its dynamic shared memory and CTAs an SM are what the built library
    launches with (``launch_spec(..., compiled=True)``); then
    an Rtc launch of 2,048 threads: the lint reports MXL-K004 and the
    CUDA driver refuses the launch with CUDA_ERROR_INVALID_VALUE."""
    import ctypes
    import warnings
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc as rtc_mod
    from mxnet_tpu_torch.analysis import GraphLintWarning, tiling
    from mxnet_tpu_torch.observability.counters import launch_limits
    lim = launch_limits(0 if DEVICE == "cuda" else None)
    specs, buckets = ana_specs(torch)
    built, _ = ana_specs(torch, compiled=True)
    ptxas = {lib: ptxas_functions(i["log"]) for lib, i in info.items()}
    rows = []
    for spec, lib_spec in zip(specs, built):
        if spec != lib_spec:
            raise AssertionError(
                "analysis (b) %s: the spec's launch differs from the built "
                "library's: %s" % (spec["name"], {
                    key: (spec.get(key), lib_spec.get(key))
                    for key in sorted(set(spec) | set(lib_spec))
                    if spec.get(key) != lib_spec.get(key)}))
        found = tiling.spec_findings(spec, limits=lim)
        if found:
            raise AssertionError("analysis (b) %s: %s" % (spec["name"],
                                                          found))
        lib = os.path.splitext(os.path.basename(spec["origin"]))[0]
        threads = int(np.prod(spec["block"]))
        budget = tiling.register_budget(threads, spec.get("min_blocks"),
                                        lim)
        static = -(-int(spec.get("static_smem", 0)) // 16) * 16
        match = [f for f in ptxas.get(lib, ())
                 if re.search(spec["entry"], f[0])]
        if not match:
            raise AssertionError("analysis (b) %s: no entry function %r in "
                                 "the ptxas log of %s"
                                 % (spec["name"], spec["entry"], lib))
        for fn, regs, _st, _ld, smem in match:
            if regs > budget or smem != static:
                raise AssertionError(
                    "analysis (b) %s (%s): ptxas %d registers, %d bytes "
                    "static shared memory; the spec's budget %d registers, "
                    "%d bytes" % (spec["name"], fn, regs, smem, budget,
                                  static))
        rows.append({"name": spec["name"], "grid": list(spec["grid"]),
                     "block": list(spec["block"]),
                     "smem": spec.get("dynamic_smem", 0)
                     + spec.get("static_smem", 0),
                     "register_budget": budget,
                     "ptxas_registers": sorted({f[1] for f in match}),
                     "ptxas_smem": sorted({f[4] for f in match})})
        log("analysis (b) %s: grid %s block %s, %d bytes shared memory, "
            "register budget %d; ptxas %s registers, %s bytes static: "
            "clean" % (spec["name"], tuple(spec["grid"]),
                       tuple(spec["block"]), rows[-1]["smem"], budget,
                       rows[-1]["ptxas_registers"], rows[-1]["ptxas_smem"]))
    log("analysis (b) %d registered launches lint clean against %s (%d "
        "SMs, %d bytes of shared memory a block, %d an SM) and agree with "
        "ptxas and with the built libraries' shared memory; on %s" % (len(rows), torch.cuda.get_device_name(0),
                          lim["sms"], lim["smem_per_block_optin"],
                          lim["smem_per_sm"], smi))
    return {"specs": rows, "lm_buckets": buckets, "limits": lim}


def ana_rtc_launch(torch, smi):
    """(b) an Rtc launch of 2,048 threads: the lint reports MXL-K004, the
    CUDA driver refuses the launch with CUDA_ERROR_INVALID_VALUE, and
    ``MXTPU_RTC_LINT=error`` refuses it before the launch."""
    import ctypes
    import warnings
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc as rtc_mod
    from mxnet_tpu_torch.analysis import GraphLintWarning
    # the flagged Rtc launch: the lint and the card agree
    x = torch.ones(64, device=DEVICE)
    rtc = mx.rtc.Rtc(ONE_INPUT_BODY, pallas=True)
    device = x.device
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        found = rtc_mod._launch_lint((1, 1, 1), (2048, 1, 1), device,
                                     "warn")
    flagged = [str(w.message) for w in rec
               if issubclass(w.category, GraphLintWarning)]
    if [r for r, _s, _m in found] != ["MXL-K004"] or not flagged:
        raise AssertionError("analysis (b): the lint did not flag a block "
                             "of 2048 threads: %s" % (found,))
    kernel = rtc.compile([x.shape], [x.dtype])
    fn = kernel.function(device.index)
    out = torch.empty_like(x)
    vals = [ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr())]
    argv = (ctypes.c_void_p * 2)(*[ctypes.addressof(v) for v in vals])
    lib = fn.module._lib
    code = lib.cuLaunchKernel(
        fn._handle, 1, 1, 1, 2048, 1, 1, 0,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        argv, None)
    if code != 1:                       # CUDA_ERROR_INVALID_VALUE
        raise AssertionError("analysis (b): the CUDA driver answered %d to a "
                             "block of 2048 threads, want 1 "
                             "(CUDA_ERROR_INVALID_VALUE)" % code)
    os.environ["MXTPU_RTC_LINT"] = "error"
    try:
        rtc.push([x], (1, 1, 1), (2048, 1, 1))
    except mx.MXNetError as err:
        if "MXL-K004" not in str(err):
            raise
        refused = str(err).splitlines()[0]
    else:
        raise AssertionError("analysis (b): MXTPU_RTC_LINT=error pushed a "
                             "block of 2048 threads")
    finally:
        os.environ.pop("MXTPU_RTC_LINT", None)
    if rtc.launches:
        raise AssertionError("analysis (b): the refused push launched")
    log("analysis (b) Rtc block of 2048 threads: the lint says %r, the "
        "CUDA driver answers %d (CUDA_ERROR_INVALID_VALUE), "
        "MXTPU_RTC_LINT=error refuses before the launch: %r; on %s"
        % (flagged[0], code, refused, smi))
    return {"rtc_lint": flagged[0], "rtc_driver_code": code,
            "rtc_refused": refused}


def ana_lm_steps(torch, seed, dtype, steps, tel=None):
    """``steps`` steps of phase 7's LM trainer (kernel sweep): ms a step
    (median, each synchronised), the peak device memory of the steps,
    and, with ``tel``, the ``trainer_cost`` counters into it."""
    import mxnet_tpu_torch as mx
    S = TRAIN["seq_len"]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (TRAIN_BATCH * S),
                              **TRAIN_SGD)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    peak_reset(torch)
    tr, p, st, aux = res_trainer(torch, seeded_train_params(seed), opt,
                                 compute_dtype=None if dtype == "float32"
                                 else dtype)
    b = tr.shard_batch(train_batch(seed, TRAIN_BATCH))
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        p, st, aux, outs = tr.step(p, st, aux, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if tel is not None:
            tr.emit_telemetry_counters(step_time_s=times[-1])
    if not bool(torch.isfinite(outs[0].float()).all()):
        raise AssertionError("analysis LM %s: non-finite outputs" % dtype)
    # the first step builds the program: time the others
    ms = float(np.median(times[1:] if len(times) > 1 else times)) * 1e3
    return ms, peak_bytes(torch)


def ana_roofline(torch, seed, smi, steps):
    """(c) The static roofline of each main path's training step against
    its measured median step (phases 7 and 9's when given in ``steps``,
    else ANA_TIMED_STEPS timed here), at the card's peaks; (d) the
    analytic peak memory beside ``torch.cuda.max_memory_allocated``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.analysis import AnalysisContext, peak_hbm_report
    from mxnet_tpu_torch.observability import aggregate, counters, events
    from mxnet_tpu_torch.parallel import flops as pflops
    kind = torch.cuda.get_device_name(0)
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else None
    cap = analysis.hbm_capacity_bytes(dev) if dev is not None else None
    total = torch.cuda.get_device_properties(0).total_memory \
        if DEVICE == "cuda" else None
    if cap != total:
        raise AssertionError("analysis (d): hbm_capacity_bytes %s, the "
                             "device's total_memory %s" % (cap, total))
    out = {"hbm_capacity_bytes": cap}
    tel = ana_dir("telemetry")
    shutil.rmtree(tel, ignore_errors=True)
    configs = ana_configs()
    measured, peaks, reps = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        # the LM's float32 steps write their trainer_cost counters, and
        # the static_roofline counter beside them, into one dir
        _set_telemetry(tel if dtype == "float32" else None)
        n = ANA_COUNTER_STEPS if steps else ANA_TIMED_STEPS + 1
        ms, peaks[("lm", dtype)] = ana_lm_steps(torch, seed, dtype, n,
                                                tel if dtype == "float32"
                                                else None)
        if dtype == "float32":
            sym, shapes = configs["lm"]
            reps[("lm", dtype)] = counters.emit_static_roofline(
                sym, shapes, device_kind=kind, compute_dtype=dtype)
            events.flush()
            _set_telemetry(None)
        measured[("lm", dtype)] = steps["lm"][dtype]["step_ms"] if steps \
            else ms
        if steps:
            res = steps["resnet50"][dtype]
        else:
            params, aux, data = seeded_resnet(seed, RESNET_BATCH)
            res = run_resnet(
                torch, params, aux, data, 1, "kernel",
                compute_dtype=None if dtype == "float32" else dtype,
                timed_steps=ANA_TIMED_STEPS)[-1]
            del params, aux, data
        measured[("resnet50", dtype)] = res["step_ms"]
        peaks[("resnet50", dtype)] = res["peak_bytes"]
        torch.cuda.empty_cache()
    for name, (sym, shapes) in configs.items():
        model = pflops.step_flops(sym, shapes)
        for dtype in ("float32", "bfloat16"):
            rep = reps.get((name, dtype)) or analysis.static_mfu_ceiling(
                sym, shapes, device_kind=kind, compute_dtype=dtype)
            if not rep or rep["peak_tflops"] is None:
                raise AssertionError("analysis (c): no roofline at the peaks "
                                     "of %r: %s" % (kind, rep))
            t_ops = rep["flops_per_step"] / (rep["peak_tflops"] * 1e12)
            t_bytes = rep["hbm_bytes_per_step"] / (rep["peak_hbm_gbps"]
                                                   * 1e9)
            bound = max(t_ops, t_bytes) * 1e3
            step = measured[(name, dtype)]
            if bound > step:
                raise AssertionError(
                    "analysis (c) %s %s: static bound %.3f ms is longer than "
                    "the measured step %.3f ms" % (name, dtype, bound, step))
            mem = peak_hbm_report(AnalysisContext(
                sym, shapes=shapes, grad_req="write",
                type_dict={n: dtype for n in sym.list_arguments()
                           if n not in shapes}))
            row = {"flops_per_step": rep["flops_per_step"],
                   "hbm_bytes_per_step": rep["hbm_bytes_per_step"],
                   "intensity": rep["intensity"], "ridge": rep["ridge"],
                   "mfu_ceiling": rep["mfu_ceiling"], "bound": rep["bound"],
                   "static_bound_ms": bound,
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes",
                   "step_ms": step, "bound_over_step": bound / step,
                   "model_flops_parallel_flops": model,
                   "analytic_peak_bytes": mem["peak_bytes"],
                   "max_memory_allocated": peaks[(name, dtype)],
                   "peak_tflops": rep["peak_tflops"],
                   "peak_hbm_gbps": rep["peak_hbm_gbps"]}
            out["%s_%s" % (name, dtype)] = row
            log("analysis (c) %s %s static roofline at %s's peaks (%g "
                "TFLOP/s, %g GB/s): %.6g FLOP and %.6g bytes a step, "
                "intensity %.2f against the ridge %.2f, MFU ceiling %.4f "
                "(%s-bound); static bound %.3f ms (%s) against the measured "
                "median step %.3f ms: ratio %.4f; parallel/flops.py's model "
                "FLOPs %.6g; (d) analytic peak %.1f MB against "
                "max_memory_allocated %.1f MB; on %s"
                % (name, dtype, kind, rep["peak_tflops"],
                   rep["peak_hbm_gbps"], rep["flops_per_step"],
                   rep["hbm_bytes_per_step"], rep["intensity"], rep["ridge"],
                   rep["mfu_ceiling"], rep["bound"], bound, row["bound_by"],
                   step, bound / step, model, mem["peak_bytes"] / 1e6,
                   peaks[(name, dtype)] / 1e6, smi))
    report = aggregate.build_report(aggregate.read_events(tel))
    pod = report["pod"]
    if pod.get("mfu") is None or not pod.get("static_roofline"):
        raise AssertionError("analysis (c): the report of %s lacks the "
                             "trainer_cost MFU or the static_roofline: %s"
                             % (tel, json.dumps(pod)[:400]))
    out["report"] = {"mfu": pod["mfu"],
                     "static_roofline": pod["static_roofline"]}
    log("analysis (c) telemetry report: trainer_cost MFU %.4f beside "
        "static_roofline %s" % (pod["mfu"],
                                json.dumps(pod["static_roofline"])))
    shutil.rmtree(tel, ignore_errors=True)
    log("analysis (d) hbm_capacity_bytes(cuda:0) = %s = total_memory"
        % cap)
    return out


def ana_mxlint(kind, smi):
    """(e) ``mxlint --all-models --roofline --device-kind <the card>``:
    exit 0, no error finding."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.mxlint",
           "--all-models", "--roofline", "--device-kind", kind]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    errors = [ln for ln in proc.stdout.splitlines() if "] error " in ln]
    if proc.returncode != 0 or errors:
        raise AssertionError("analysis (e): mxlint rc %d, errors %s: %s"
                             % (proc.returncode, errors[:3],
                                proc.stderr[-800:]))
    graphs = proc.stdout.count("== model:")
    log("analysis (e) %s: rc 0, %d graphs, no error finding, %.2f s; on %s"
        % (" ".join(cmd[2:]), graphs, seconds, smi))
    return {"rc": 0, "graphs": graphs, "seconds": seconds}


def phase_analysis(torch, seed, smi, steps=None):
    """Phase 19: the graph analyzer on the card: (a) bind-time validation
    of the main paths' graphs, (b) MXL-K against the compiled kernels and
    the card, (c) the static roofline against the measured steps and (d)
    the analytic peak memory, (e) ``mxlint`` over the zoo.  ``steps``:
    phases 7 and 9's results ``{"lm": ..., "resnet50": ...}`` (their step
    medians and ResNet-50's peaks are reused), None when the phase runs
    alone (it then times ANA_TIMED_STEPS steps of each)."""
    from mxnet_tpu_torch.kernels import _build
    t_phase = time.perf_counter()
    shutil.rmtree(ana_dir(), ignore_errors=True)
    out = {"bind": ana_bind(torch, smi)}
    out["kernels"] = ana_kernels(torch, _build.build_all(), smi)
    out["rtc"] = ana_rtc_launch(torch, smi)
    out["roofline"] = ana_roofline(torch, seed, smi, steps)
    out["mxlint"] = ana_mxlint(torch.cuda.get_device_name(0), smi)
    os.environ.pop("MXTPU_FUSED_OPT", None)
    out["seconds"] = time.perf_counter() - t_phase
    log("analysis: phase 19 %.2f s" % out["seconds"])
    shutil.rmtree(ana_dir(), ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 20: MoE and pipeline parallelism
# ----------------------------------------------------------------------
#: the MoE LM: phase 7's widths with 8 experts, top-1, capacity 1.25
#: (``models.transformer_moe``'s defaults)
MOE = dict(TRAIN, num_experts=8, moe_top_k=1, moe_capacity_factor=1.25)
MOE_STEPS = 3
MOE_TIMED_STEPS = 5
MOE_TRACED_STEPS = 2
#: the bounds of ``tests/test_parallel.py``'s expert-parallel test
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5
#: (d) one layer's tokens split over two replicas
EP_MOE_TOKENS = 8192
#: (e) the predictor's bound
MOE_PREDICT_TOL = 1e-5
#: (f) the LM's transformer block through GPipeTrainer
PIPE_MICROBATCHES = 4
PIPE_TIMED_STEPS = 3
PIPE_TRACED_STEPS = 2
#: the token ids' Zipf exponent: text-like frequencies, whose frequent
#: tokens load some experts past the capacity (with uniform ids layer
#: 0's loads sit within 15% of the mean, under the 25% headroom)
ZIPF_S = 1.1


def moe_dir(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_moe", *parts)


def moe_symbol(mx):
    return mx.models.transformer_moe.get_symbol(**MOE)


def seeded_moe_params(mx, seed):
    """Random weights of the MoE LM from ``seed`` with numpy: N(0, 0.02)
    matrices, embeddings and gates, zero biases, unit LayerNorm."""
    sym = moe_symbol(mx)
    S = MOE["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(TRAIN_BATCH, S),
                                   softmax_label=(TRAIN_BATCH, S))
    rng = np.random.RandomState(seed + 20)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def zipf_batch(seed, batch=None):
    """A next-token batch (``TRAIN_BATCH`` rows by default) whose ids
    follow a Zipf law (``ZIPF_S``) over the vocabulary."""
    V, S = MOE["vocab_size"], MOE["seq_len"]
    batch = batch or TRAIN_BATCH
    p = 1.0 / np.arange(1, V + 1) ** ZIPF_S
    rng = np.random.RandomState(seed + 21)
    ids = rng.choice(V, size=(batch, S + 1), p=p / p.sum())
    return {"data": ids[:, :-1].astype(np.float32),
            "softmax_label": ids[:, 1:].astype(np.float32)}


def plain_moe_train(torch, params, batch, steps):
    """``steps`` plain training steps of the MoE LM, written here with no
    module of the port: masked softmax attention, the dense MoE FFN
    (softmax gate, top-1 by argmax, each expert's first ``ceil(1.25 * T
    / K)`` tokens in token order kept), a summed cross entropy and a
    leafwise SGD with momentum, in the dtype of ``params`` (numpy
    arrays).  Returns the parameters after the last step and each step's
    dropped assignments."""
    F = torch.nn.functional
    E, H = MOE["dim"], MOE["num_heads"]
    D, S = E // H, MOE["seq_len"]
    K = MOE["num_experts"]
    B = batch["data"].shape[0]
    T = B * S
    cap = int(math.ceil(MOE["moe_capacity_factor"] * T / K))
    rescale = 1.0 / T
    lr, mom = TRAIN_SGD["learning_rate"], TRAIN_SGD["momentum"]
    p = {k: torch.as_tensor(v, device=DEVICE).clone().requires_grad_()
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    ids = torch.from_numpy(batch["data"]).to(DEVICE).long()
    label = torch.from_numpy(batch["softmax_label"]).to(DEVICE).long()
    keep = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
    drops = []
    for _ in range(steps):
        dropped = 0
        x = p["tok_embed_weight"][ids] + p["pos_embed_weight"][None]
        for i in range(MOE["num_layers"]):
            n = "layer%d_" % i
            h = F.layer_norm(x, (E,), p[n + "ln1_gamma"], p[n + "ln1_beta"])
            qkv = h @ p[n + "att_qkv_weight"].t() + p[n + "att_qkv_bias"]
            q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
                       for t in qkv.split(E, dim=-1))
            s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
            s = torch.where(keep, s, torch.full_like(s, -1e30))
            a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2) \
                .reshape(B, S, E)
            x = x + a @ p[n + "att_out_weight"].t() + p[n + "att_out_bias"]
            t = F.layer_norm(x, (E,), p[n + "ln2_gamma"],
                             p[n + "ln2_beta"]).reshape(T, E)
            probs = torch.softmax(t @ p[n + "moe_gate_weight"].t(), dim=-1)
            with torch.no_grad():
                first = F.one_hot(probs.argmax(-1), K)
                queue = torch.cumsum(first, 0) - first
                kept = first * (queue < cap)
                dropped += int(first.sum() - kept.sum())
            w1, b1 = p[n + "moe_expert_fc1_weight"], \
                p[n + "moe_expert_fc1_bias"]
            w2, b2 = p[n + "moe_expert_fc2_weight"], \
                p[n + "moe_expert_fc2_bias"]
            ffn = torch.zeros_like(t)
            for e in range(K):
                he = torch.relu(t @ w1[e].t() + b1[e])
                ye = he @ w2[e].t() + b2[e]
                ffn = ffn + ye * (probs[:, e] * kept[:, e].to(t.dtype))[:,
                                                                        None]
            x = x + ffn.reshape(B, S, E)
        x = F.layer_norm(x, (E,), p["final_ln_gamma"], p["final_ln_beta"])
        logits = (x @ p["lm_head_weight"].t() + p["lm_head_bias"]) \
            .reshape(-1, MOE["vocab_size"])
        loss = F.cross_entropy(logits, label.reshape(-1), reduction="sum")
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k] = mom * m[k] - lr * (g * rescale)
                w += m[k]
        drops.append(dropped)
    return {k: v.detach() for k, v in p.items()}, drops


def _moe_dropped(tr):
    """The assignments every MoE node of ``tr`` dropped in its last
    forward (summed over the layers)."""
    return sum(int(n.op.dropped) for n in tr.symbol._topo()
               if n.op is not None and n.op.op_name == "MoE")


def moe_trainer(torch, mx, params, batch, mesh, steps, compute_dtype=None):
    """``steps`` ShardedTrainer steps of the MoE LM on ``mesh`` in kernel
    mode, the launch counts reset just before them.  Returns the trainer,
    its state, the counts, and each step's dropped assignments."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    S = MOE["seq_len"]
    B = batch["data"].shape[0]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (B * S),
                              **TRAIN_SGD)
    tr = mx.parallel.ShardedTrainer(moe_symbol(mx), opt, mesh,
                                    compute_dtype=compute_dtype)
    p = tr.place_params(params)
    st = {}
    for k, v in params.items():
        z = np.zeros(v.shape, np.float32)
        st[k] = tr.place_params({k: z})[k] if mesh.size > 1 else \
            torch.zeros(v.shape, device=mesh.device)
    b = tr.shard_batch(batch)
    _sync_all(torch, mesh.devices)
    _reset_dp_counts()
    drops = []
    for _ in range(steps):
        p, st, aux, outs = tr.step(p, st, {}, b)
        drops.append(_moe_dropped(tr))
    _sync_all(torch, mesh.devices)
    counts = _sweep_counts()
    one = {k: p[k] for k in tr.param_names}
    buckets = len(fo.plan_buckets(
        {k: (v.shards[0] if hasattr(v, "shards") else v)
         for k, v in one.items()}))
    return tr, (p, st, b), counts, drops, buckets


def _host_params(p):
    return {k: (v.global_tensor() if hasattr(v, "global_tensor") else v)
            .detach().float() for k, v in p.items()}


def _moe_err(torch, got, want):
    """The largest ``|got - want| / (MOE_ATOL + MOE_RTOL * |want|)`` over
    every parameter (at most 1 passes), and its parameter."""
    worst, name = 0.0, None
    for k, w in want.items():
        g = got[k].to(w.device)
        r = float(((g - w).abs() / (MOE_ATOL + MOE_RTOL * w.abs())).max())
        if r > worst:
            worst, name = r, k
    return worst, name


def moe_lm_gate(torch, mx, seed, smi):
    """(a) the MoE LM at full width through ShardedTrainer on one card."""
    params = seeded_moe_params(mx, seed)
    batch = zipf_batch(seed)
    mesh = mx.parallel.make_mesh([mx.gpu(0) if DEVICE == "cuda"
                                  else mx.cpu()], dp=1)
    tr, (p, st, b), counts, drops, buckets = moe_trainer(
        torch, mx, params, batch, mesh, MOE_STEPS)
    port = _host_params(p)
    want_fa = MOE["num_layers"] * MOE_STEPS
    want_fo = buckets * MOE_STEPS
    if counts["flash_attention"] != want_fa or \
            counts["fused_opt"] != want_fo:
        raise AssertionError("moe (a): launches %s, want the flash forward "
                             "%d times and the sweep %d"
                             % (counts, want_fa, want_fo))
    del tr, p, st, b
    plain, plain_drops = plain_moe_train(torch, params, batch, MOE_STEPS)
    err, where = _moe_err(torch, port, plain)
    if err > 1.0 or min(drops) <= 0:
        raise AssertionError("moe (a): parameters after %d float32 steps "
                             "%.3g of the bound from the plain MoE LM's "
                             "(at %s); dropped %s (plain %s), want > 0"
                             % (MOE_STEPS, err, where, drops, plain_drops))
    log("moe (a) float32 MoE LM (8 experts, top-1, capacity 1.25), %d "
        "steps: parameters within rtol %g atol %g of the plain MoE LM "
        "(worst %.3f of the bound, %s); dropped a step %s (plain %s); "
        "launches %s; on %s" % (MOE_STEPS, MOE_RTOL, MOE_ATOL, err, where,
                                drops, plain_drops,
                                {k: counts[k] for k in ("flash_attention",
                                                        "fused_opt")}, smi))
    del plain
    torch.cuda.empty_cache()
    # timed bfloat16 steps
    tr, (p, st, b), bf_counts, bf_drops, _bk = moe_trainer(
        torch, mx, params, batch, mesh, MOE_STEPS,
        compute_dtype="bfloat16")
    state = {"p": p, "st": st}

    def one():
        state["p"], state["st"], _a, _o = tr.step(state["p"], state["st"],
                                                  {}, b)
    times = []
    for _ in range(MOE_TIMED_STEPS):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    traced = trace_calls(torch, one, MOE_TRACED_STEPS)
    ms = float(np.median(times)) * 1e3
    tokens = TRAIN_BATCH * MOE["seq_len"]
    log("moe (a) bfloat16: %.2f ms a step (median of %d; %s), %.0f "
        "tokens/s, device busy %.1f%% of a traced step, %d kernels a "
        "step, dropped a step %s, launches %s; on %s"
        % (ms, MOE_TIMED_STEPS, ", ".join("%.2f" % (t * 1e3)
                                         for t in times),
           tokens / (ms / 1e3), 100 * traced["device_busy_share"],
           traced["kernels_a_step"], bf_drops,
           {k: bf_counts[k] for k in ("flash_attention", "fused_opt")},
           smi))
    del tr, state, b
    torch.cuda.empty_cache()
    return {"float32": {"err_of_bound": err, "worst": where,
                        "dropped": drops, "plain_dropped": plain_drops,
                        "launches": counts, "buckets": buckets},
            "bfloat16": {"step_ms": ms, "step_ms_all":
                         [t * 1e3 for t in times],
                         "tokens_per_s": tokens / (ms / 1e3),
                         "dropped": bf_drops, "launches": bf_counts,
                         "traced": traced},
            "params": port, "init": params, "batch": batch}


def moe_ep_gate(torch, mx, ref, distinct):
    """(b) expert parallelism: ep=2 on [gpu(0), gpu(0)] (ep=4 over four
    cards with ``distinct``) against (a)'s ep=1 parameters."""
    n = 4 if distinct else 2
    ctxs = _dp_contexts(mx, n, distinct)
    mesh = mx.parallel.make_mesh(ctxs, ep=n)
    tr, (p, st, b), counts, drops, buckets = moe_trainer(
        torch, mx, ref["init"], ref["batch"], mesh, MOE_STEPS)
    held = {tuple(s.shape) for s in
            p["layer0_moe_expert_fc1_weight"].shards}
    K = MOE["num_experts"]
    want_held = {(K // n, 4 * MOE["dim"], MOE["dim"])}
    got = _host_params(p)
    err, where = _moe_err(torch, got, ref["params"])
    want_fo = buckets * MOE_STEPS * n
    if err > 1.0 or held != want_held or counts["fused_opt"] != want_fo \
            or counts["flash_attention"] != MOE["num_layers"] * MOE_STEPS:
        raise AssertionError(
            "moe (b) ep=%d: %.3g of the bound from ep=1 (at %s), each "
            "member holds %s (want %s), launches %s (want the sweep %d)"
            % (n, err, where, held, want_held, counts, want_fo))
    form = "%d cards (peer copies)" % n if distinct \
        else "one card, %d members (index copies)" % n
    log("moe (b) ep=%d on %s: parameters after %d steps within rtol %g "
        "atol %g of ep=1's (worst %.3f of the bound, %s); each member "
        "holds %d of %d experts; dropped a step %s; launches %s"
        % (n, form, MOE_STEPS, MOE_RTOL, MOE_ATOL, err, where, K // n, K,
           drops, {k: counts[k] for k in ("flash_attention", "fused_opt",
                                          "fused_opt_by_device")}))
    del tr, p, st, b
    torch.cuda.empty_cache()
    return {"ep": n, "form": form, "err_of_bound": err, "dropped": drops,
            "launches": counts}


def moe_dp_gate(torch, mx, ref):
    """(c) dp=2 on one card with the capacity binding, against dp=1 on
    the same global batch: the parameters within the bounds and every
    step's drops equal; and both runs within the bounds of the plain MoE
    LM in float64 (the witness of how far float32 alone moves them)."""
    ctxs = _dp_contexts(mx, 2, False)
    mesh = mx.parallel.make_mesh(ctxs, dp=2)
    tr, (p, st, b), counts, drops, _bk = moe_trainer(
        torch, mx, ref["init"], ref["batch"], mesh, MOE_STEPS)
    got = _host_params(p)
    del tr, p, st, b
    torch.cuda.empty_cache()
    err, where = _moe_err(torch, got, ref["params"])
    want = ref["float32"]["dropped"]
    witness, w_drops = plain_moe_train(
        torch, {k: v.astype(np.float64) for k, v in ref["init"].items()},
        ref["batch"], MOE_STEPS)
    err1, where1 = _moe_err(torch, ref["params"], witness)
    err2, where2 = _moe_err(torch, got, witness)
    del witness
    torch.cuda.empty_cache()
    if err > 1.0 or drops != want or min(drops) <= 0 or err1 > 1.0 \
            or err2 > 1.0 or w_drops != want:
        raise AssertionError("moe (c) dp=2: %.3g of the bound from dp=1 "
                             "(at %s); dropped %s, dp=1 %s, float64 %s; "
                             "from the float64 run dp=1 %.3g, dp=2 %.3g"
                             % (err, where, drops, want, w_drops, err1,
                                err2))
    log("moe (c) dp=2 with the capacity binding: parameters within rtol %g "
        "atol %g of dp=1's (worst %.3f of the bound, %s); dropped a step "
        "%s, equal to dp=1's; launches %s"
        % (MOE_RTOL, MOE_ATOL, err, where, drops,
           {k: counts[k] for k in ("flash_attention", "fused_opt")}))
    log("moe (c) the plain MoE LM in float64, %d steps (dropped a step %s): "
        "dp=1 %.3f of the bound from it (%s), dp=2 %.3f (%s)"
        % (MOE_STEPS, w_drops, err1, where1, err2, where2))
    return {"err_of_bound": err, "dropped": drops, "launches": counts,
            "dp1_vs_float64_err_of_bound": err1,
            "dp2_vs_float64_err_of_bound": err2}


def moe_prefix_gate(torch, mx, seed):
    """(c) the op's queues across replicas at the MoE LM's batch:
    ``MoE.forward_replicas`` over two replicas against ``forward`` on the
    whole ``TRAIN_BATCH * seq_len`` tokens, on gate products exact in
    float32 (small integers, the first experts preferred so they
    overflow), so no rounding can flip an assignment.  The drops and the
    aux loss equal, and every token's output within the bounds: a token
    queued at the wrong place is dropped or kept wrongly, and its output
    is off by an expert's whole output."""
    from mxnet_tpu_torch.ops.registry import create_operator
    from mxnet_tpu_torch.parallel import collectives as coll
    E, K = MOE["dim"], MOE["num_experts"]
    H = 4 * E
    T = TRAIN_BATCH * MOE["seq_len"]
    rng = np.random.RandomState(seed + 24)
    x = rng.randint(-2, 3, size=(T, E)).astype(np.float32)
    wg = rng.randint(-2, 3, size=(K, E)).astype(np.float32)
    x[:, 0] = 1.0
    wg[:, 0] = np.linspace(48.0, 0.0, K)
    ws = [(rng.randn(*shape) * 0.02).astype(np.float32)
          for shape in ((K, H, E), (K, H), (K, E, H), (K, E))]
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device("cpu")
    ins = [torch.from_numpy(a).to(dev) for a in [x, wg] + ws]
    op = create_operator("MoE", num_experts=K, hidden_size=H, top_k=1,
                         capacity_factor=MOE["moe_capacity_factor"])
    group = coll.ReplicaGroup([dev, dev])
    with torch.no_grad():
        whole, _ = op.forward(ins, [], False, None)
        dropped = int(op.dropped)
        parts, _aux, _rep = op.forward_replicas(
            [[ins[0][r * T // 2:(r + 1) * T // 2]] + ins[1:]
             for r in range(2)], None, False, [None, None], group)
        dropped2 = int(op.dropped)
    out = torch.cat([o[0] for o in parts])
    off = ((out - whole[0]).abs()
           > MOE_ATOL + MOE_RTOL * whole[0].abs()).any(1)
    wrong = int(off.sum())
    aux_err = max(float((o[1] - whole[1]).abs().max()) for o in parts)
    aux_ok = aux_err <= MOE_ATOL + MOE_RTOL * float(whole[1].abs().max())
    if dropped2 != dropped or dropped <= 0 or wrong or not aux_ok:
        raise AssertionError("moe (c) queues: dp=2 dropped %d, whole batch "
                             "%d; %d tokens off; aux loss %.3g off"
                             % (dropped2, dropped, wrong, aux_err))
    log("moe (c) the op's queues over 2 replicas, %d tokens, exact gate "
        "products: dropped %d of %d, as on the whole batch; every token's "
        "output within rtol %g atol %g (max diff %.3g), the aux loss %.3g "
        "off" % (T, dropped2, T, MOE_RTOL, MOE_ATOL,
                 float((out - whole[0]).abs().max()), aux_err))
    del whole, parts, out, ins
    torch.cuda.empty_cache()
    return {"dropped": dropped2, "tokens": T, "aux_err": aux_err}


def moe_explicit_gate(torch, mx, seed, distinct):
    """(d) ``expert_parallel_moe`` over two replicas against the dense op
    on each replica's shard."""
    from mxnet_tpu_torch.ops import moe as moe_mod
    from mxnet_tpu_torch.ops.registry import create_operator
    from mxnet_tpu_torch.parallel import collectives as coll
    E, K = MOE["dim"], MOE["num_experts"]
    H = 4 * E
    rng = np.random.RandomState(seed + 22)
    devs = [torch.device(DEVICE, i if distinct else 0) if DEVICE == "cuda"
            else torch.device("cpu") for i in range(2)]
    x = [torch.from_numpy(rng.randn(EP_MOE_TOKENS // 2, E)
                          .astype(np.float32)).to(d) for d in devs]
    w = [(rng.randn(*s) * sc).astype(np.float32) for s, sc in
         (((K, E), 0.5), ((K, H, E), 0.02), ((K, H), 0.02),
          ((K, E, H), 0.02), ((K, E), 0.02))]
    kl = K // 2

    def part(a, r):
        return torch.from_numpy(a[r * kl:(r + 1) * kl]).to(devs[r])
    group = coll.ReplicaGroup(devs)
    outs, auxes = moe_mod.expert_parallel_moe(
        group, x, [torch.from_numpy(w[0]).to(d) for d in devs],
        [part(w[1], r) for r in range(2)], [part(w[2], r) for r in range(2)],
        [part(w[3], r) for r in range(2)], [part(w[4], r) for r in range(2)],
        top_k=1, capacity_factor=MOE["moe_capacity_factor"])
    dense = create_operator("MoE", num_experts=K, hidden_size=H, top_k=1,
                            capacity_factor=MOE["moe_capacity_factor"])
    err, drops = 0.0, []
    for r in range(2):
        want, _ = dense.forward([x[r]] + [torch.from_numpy(a).to(devs[r])
                                          for a in w], [], False, None)
        drops.append(int(dense.dropped))
        err = max(err, float((outs[r] - want[0]).abs().max()),
                  float((auxes[r] - want[1][0]).abs()))
    if err > 1e-5:
        raise AssertionError("moe (d): expert_parallel_moe %.3g from the "
                             "dense op" % err)
    log("moe (d) expert_parallel_moe over 2 replicas (%s), %d tokens each: "
        "within %.3g of the dense op on each shard (bound 1e-5); the dense "
        "op dropped %s" % ("2 cards" if distinct else "one card",
                           EP_MOE_TOKENS // 2, err, drops))
    return {"max_abs_err": err, "dropped": drops}


def moe_predictor_gate(torch, mx, seed, distinct):
    """(e) ShardedPredictor on the MoE LM from a checkpoint, dp=2 x ep=2,
    against ``predictor.Predictor``."""
    params = seeded_moe_params(mx, seed)
    batch = zipf_batch(seed)
    sym = moe_symbol(mx)
    prefix = moe_dir("moe_lm")
    os.makedirs(moe_dir(), exist_ok=True)
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    mx.model.save_checkpoint(prefix, 1, sym,
                             {k: mx.nd.array(v, ctx=ctx)
                              for k, v in params.items()}, {})
    S = MOE["seq_len"]
    pred = mx.predictor.Predictor(
        sym.tojson(), params, {"data": (TRAIN_BATCH, S),
                               "softmax_label": (TRAIN_BATCH, S)}, ctx=ctx)
    pred.forward(data=batch["data"])
    want = pred.get_output(0)
    want = torch.as_tensor(want.asnumpy() if hasattr(want, "asnumpy")
                           else want)
    mesh = mx.parallel.make_mesh(_dp_contexts(mx, 4, distinct), dp=2, ep=2)
    with ctx:
        sp = mx.parallel.ShardedPredictor.from_checkpoint(prefix, 1, mesh)
    zeros = np.zeros_like(batch["softmax_label"])
    got = torch.as_tensor(sp.predict({"data": batch["data"],
                                      "softmax_label": zeros})[0])
    err = float((got - want).abs().max())
    if err > MOE_PREDICT_TOL or not bool(torch.isfinite(got).all()):
        raise AssertionError("moe (e): ShardedPredictor %.3g from the "
                             "Predictor" % err)
    log("moe (e) ShardedPredictor dp=2 x ep=2 (%s) from %s-0001.params "
        "(%d layers): outputs %s within %.3g of predictor.Predictor's "
        "(bound %g float32)" % ("4 cards" if distinct else "one card",
                                os.path.basename(prefix),
                                MOE["num_layers"], tuple(got.shape), err,
                                MOE_PREDICT_TOL))
    shutil.rmtree(moe_dir(), ignore_errors=True)
    del pred, sp
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "shape": list(got.shape)}


def _pipe_fns(torch):
    """The LM's embedding and head around the block: token and position
    embeddings; the final LayerNorm, the head and the mean cross
    entropy."""
    F = torch.nn.functional
    E = MOE["dim"]

    def embed(ep, batch):
        return ep["tok"][batch["data"].long()] + ep["pos"][None]

    def head_loss(hp, h, batch):
        x = F.layer_norm(h, (E,), hp["gamma"], hp["beta"])
        logits = x.reshape(-1, E) @ hp["w"].t() + hp["b"]
        return F.cross_entropy(logits, batch["softmax_label"].reshape(-1)
                               .long())
    return embed, head_loss


def plain_pipe_train(torch, params, batch, steps):
    """``steps`` plain full-batch training steps of (f)'s model, written
    here with no module of the port: the token and position embeddings,
    the LM's block once a layer (masked softmax attention, the ReLU
    FFN), the final LayerNorm, the head, the mean cross entropy over the
    whole batch, and a leafwise SGD with momentum, in the dtype of
    ``params``: numpy arrays in the pipeline's layout (each block
    parameter stacked over the layers).  Returns the parameters after
    the last step, keyed ``part/name``."""
    F = torch.nn.functional
    E, H = MOE["dim"], MOE["num_heads"]
    D, S = E // H, MOE["seq_len"]
    B = batch["data"].shape[0]
    lr, mom = TRAIN_SGD["learning_rate"], TRAIN_SGD["momentum"]
    p = {"%s/%s" % (part, k): torch.as_tensor(np.asarray(v),
                                              device=DEVICE)
         .clone().requires_grad_()
         for part, tree in params.items() for k, v in tree.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    ids = torch.from_numpy(batch["data"]).to(DEVICE).long()
    label = torch.from_numpy(batch["softmax_label"]).to(DEVICE).long()
    keep = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
    n_layers = p["layers/block_ln1_gamma"].shape[0]
    for _ in range(steps):
        x = p["embed/tok"][ids] + p["embed/pos"][None]
        for i in range(n_layers):
            def w(name, i=i):
                return p["layers/block_" + name][i]
            h = F.layer_norm(x, (E,), w("ln1_gamma"), w("ln1_beta"))
            qkv = h @ w("att_qkv_weight").t() + w("att_qkv_bias")
            q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
                       for t in qkv.split(E, dim=-1))
            sc = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
            sc = torch.where(keep, sc, torch.full_like(sc, -1e30))
            a = (torch.softmax(sc, dim=-1) @ v).transpose(1, 2) \
                .reshape(B, S, E)
            x = x + a @ w("att_out_weight").t() + w("att_out_bias")
            h = F.layer_norm(x, (E,), w("ln2_gamma"), w("ln2_beta"))
            h = torch.relu(h @ w("ffn1_weight").t() + w("ffn1_bias"))
            x = x + h @ w("ffn2_weight").t() + w("ffn2_bias")
        x = F.layer_norm(x, (E,), p["head/gamma"], p["head/beta"])
        logits = x.reshape(-1, E) @ p["head/w"].t() + p["head/b"]
        loss = F.cross_entropy(logits, label.reshape(-1))
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                m[k] = mom * m[k] - lr * g
                v += m[k]
    return {k: v.detach() for k, v in p.items()}


def _flat_tree(torch, params):
    return {"%s/%s" % (part, k): torch.as_tensor(np.asarray(v))
            for part, tree in params.items() for k, v in tree.items()}


def pipeline_gate(torch, mx, seed, smi, distinct):
    """(f) GPipeTrainer.from_block_symbol on the LM's transformer block at
    full width, gpipe and 1f1b: the first step's loss against the
    trainer's unpipelined reference, and the parameters after
    ``MOE_STEPS`` steps against a plain full-batch run of the same model
    in float64 (:func:`plain_pipe_train`) within rtol 2e-4, atol 2e-5."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.parallel import pipeline as pipe
    E, S, V = MOE["dim"], MOE["seq_len"], MOE["vocab_size"]
    k = 4 if distinct else 2
    block = tf.transformer_block(mx.sym.Variable("data"), "block",
                                 MOE["num_heads"], E, S)
    rng = np.random.RandomState(seed + 23)
    embed_p = {"tok": (rng.randn(V, E) * 0.02).astype(np.float32),
               "pos": (rng.randn(S, E) * 0.02).astype(np.float32)}
    head_p = {"gamma": np.ones(E, np.float32),
              "beta": np.zeros(E, np.float32),
              "w": (rng.randn(V, E) * 0.02).astype(np.float32),
              "b": np.zeros(V, np.float32)}
    batch = zipf_batch(seed)
    embed, head_loss = _pipe_fns(torch)
    out = {}
    plain = None
    for schedule in ("gpipe", "1f1b"):
        mesh = mx.parallel.make_mesh(_dp_contexts(mx, k, distinct), pp=k)
        tr = pipe.GPipeTrainer.from_block_symbol(
            block, n_layers=MOE["num_layers"], mesh=mesh,
            optimizer=mx.optimizer.create("sgd", **TRAIN_SGD),
            embed_fn=embed, head_loss_fn=head_loss, embed_params=embed_p,
            head_params=head_p, input_shape=(S, E),
            num_microbatches=PIPE_MICROBATCHES, seed=seed,
            schedule=schedule)
        if plain is None:
            plain = plain_pipe_train(
                torch, {part: {n: np.asarray(v, np.float64)
                               for n, v in tree.items()}
                        for part, tree in tr.params.items()},
                batch, MOE_STEPS)
        ref = tr.sequential_loss(batch) if schedule == "gpipe" \
            else tr.sequential_loss_microbatched(batch)
        _sync_all(torch, mesh.devices)
        fa.flash_attention_forward.launches = 0
        fa.flash_attention_forward.launches_by_device.clear()
        loss = tr.step(batch)
        for _ in range(MOE_STEPS - 1):
            tr.step(batch)
        _sync_all(torch, mesh.devices)
        launches = fa.flash_attention_forward.launches
        by_device = dict(fa.flash_attention_forward.launches_by_device)
        err, where = _moe_err(torch, _flat_tree(torch, tr.params), plain)
        if abs(loss - ref) >= 1e-5 or not math.isfinite(loss) \
                or err > 1.0 or launches != \
                MOE["num_layers"] * PIPE_MICROBATCHES * MOE_STEPS:
            raise AssertionError("pipeline (f) %s: loss %r against %r; "
                                 "parameters %.3g of the bound from the "
                                 "plain run (at %s); flash launches %d"
                                 % (schedule, loss, ref, err, where,
                                    launches))
        times = []
        for _ in range(PIPE_TIMED_STEPS):
            t0 = time.perf_counter()
            tr.step(batch)
            _sync_all(torch, mesh.devices)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        occ = tr.schedule_occupancy()
        traced = trace_calls(torch, lambda: tr.step(batch),
                             PIPE_TRACED_STEPS) if not distinct else None
        out[schedule] = {"loss": loss, "reference": ref,
                         "bit_for_bit": loss == ref,
                         "err_of_bound": err, "worst": where,
                         "step_ms": ms, "step_ms_all":
                         [t * 1e3 for t in times],
                         "flash_launches": launches,
                         "flash_by_device": by_device,
                         "bubble_fraction": occ["bubble_fraction"],
                         "traced": traced}
        log("pipeline (f) %s, %d layers over pp=%d (%s), M=%d: loss %.7f, "
            "%s %.7f (%s); parameters after %d steps %.3f of the bound from "
            "the plain full-batch run in float64 (rtol %g atol %g, worst "
            "%s); "
            "%.2f ms a step (median of %d); schedule_occupancy's "
            "bubble %.3f (%s, driven by one host thread: the measured step "
            "is the stages' sum); device busy %s; flash launches %d; on %s"
            % (schedule, MOE["num_layers"], k,
               "%d cards" % k if distinct else "one card",
               PIPE_MICROBATCHES, loss,
               "within 1e-5 of sequential_loss" if schedule == "gpipe"
               else "within 1e-5 of sequential_loss_microbatched", ref,
               "bit for bit" if loss == ref else "%.3g off" % abs(loss - ref),
               MOE_STEPS, err, MOE_RTOL, MOE_ATOL, where, ms, PIPE_TIMED_STEPS, occ["bubble_fraction"],
               "the stages on %d cards" % k if distinct
               else "the stages share one card",
               "%.1f%% of a traced step" % (100 * traced["device_busy_share"])
               if traced else "not traced (several cards)", launches, smi))
        del tr
        torch.cuda.empty_cache()
    del plain
    torch.cuda.empty_cache()
    return out


def schedule_gate(kind, smi):
    """(g) ``mxlint --schedule`` on transformer_moe at dp=1,ep=4 and on
    the LM at pp=2, priced at this card's PEAKS row."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for label, argv in (
            ("transformer_moe dp=1,ep=4",
             ["--model", "transformer_moe", "--mesh", "dp=1,ep=4",
              "--world-size", "4"]),
            ("transformer pp=2", ["--model", "transformer", "--mesh",
                                  "pp=2"])):
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.mxlint"] \
            + argv + ["--schedule", "--device-kind", kind, "--format",
                      "json", "--fail-on", "never"]
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise AssertionError("schedule (g) %s: rc %d: %s"
                                 % (label, proc.returncode,
                                    proc.stderr[-800:]))
        doc = json.loads(proc.stdout)[0]
        found = [(i["rule_id"], i["severity"], i["node"])
                 for i in doc["issues"] if i["rule_id"].startswith("MXL-E")]
        rep = doc.get("schedule")
        if rep is None:
            raise AssertionError("schedule (g) %s: no report" % label)
        sims = {k: round(v["bubble_fraction"], 4)
                for k, v in (rep.get("schedules") or {}).items()}
        msgs = [i["message"] for i in doc["issues"]
                if i["rule_id"] == "MXL-E008"][:1]
        log("schedule (g) mxlint --schedule %s at %s: E findings %s; "
            "bubbles %s; %s; on %s" % (label, kind, found, sims,
                                       msgs[0] if msgs else "no E008",
                                       smi))
        out[label] = {"findings": found, "bubbles": sims,
                      "e008": msgs[0] if msgs else None}
    if not any(f[0] == "MXL-E008" for f in
               out["transformer_moe dp=1,ep=4"]["findings"]):
        raise AssertionError("schedule (g): no MXL-E008 on transformer_moe "
                             "at ep=4")
    return out


def phase_moe_pipeline(torch, seed, smi):
    """Phase 20: MoE and pipeline parallelism (the module docstring's
    (a)-(g)).  The rows-3 and -4 launches of its main paths are in the
    result's ``launches``."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    distinct = DEVICE == "cuda" and torch.cuda.device_count() >= 4
    out = {}
    lm = moe_lm_gate(torch, mx, seed, smi)
    out["lm"] = {k: lm[k] for k in ("float32", "bfloat16")}
    out["ep"] = [moe_ep_gate(torch, mx, lm, False)]
    if distinct:
        out["ep"].append(moe_ep_gate(torch, mx, lm, True))
    out["dp"] = moe_dp_gate(torch, mx, lm)
    del lm
    out["queues"] = moe_prefix_gate(torch, mx, seed)
    out["explicit"] = moe_explicit_gate(torch, mx, seed, distinct)
    out["predictor"] = moe_predictor_gate(torch, mx, seed, distinct)
    out["pipeline"] = pipeline_gate(torch, mx, seed, smi, False)
    if distinct:
        out["pipeline_cards"] = pipeline_gate(torch, mx, seed, smi, True)
    out["schedule"] = schedule_gate(torch.cuda.get_device_name(0)
                                    if DEVICE == "cuda"
                                    else "NVIDIA H100 80GB HBM3", smi)
    os.environ.pop("MXTPU_FUSED_OPT", None)
    runs = [out["lm"]["float32"]["launches"],
            out["lm"]["bfloat16"]["launches"], out["dp"]["launches"]] \
        + [e["launches"] for e in out["ep"]]
    pipes = [r for key in ("pipeline", "pipeline_cards")
             for r in out.get(key, {}).values()]
    out["launches"] = {
        "fused_opt": sum(c["fused_opt"] for c in runs),
        "flash_attention": sum(c["flash_attention"] for c in runs)
        + sum(r["flash_launches"] for r in pipes),
        "fused_opt_by_body": {}, "fused_opt_by_device": {},
        "flash_attention_by_device": {},
        "by_path": {
            "moe_lm_training": out["lm"]["float32"]["launches"],
            "moe_lm_training_bfloat16": out["lm"]["bfloat16"]["launches"],
            "moe_data_parallel": out["dp"]["launches"],
            "moe_expert_parallel": [e["launches"] for e in out["ep"]],
            "pipeline_flash_attention": sum(r["flash_launches"]
                                            for r in pipes)}}
    tally = out["launches"]
    for c in runs:
        for body, n in c["fused_opt_by_body"].items():
            tally["fused_opt_by_body"][body] = \
                tally["fused_opt_by_body"].get(body, 0) + n
    for c in runs + [{"flash_attention_by_device": r["flash_by_device"]}
                     for r in pipes]:
        for kernel in ("fused_opt", "flash_attention"):
            for d, n in c.get(kernel + "_by_device", {}).items():
                got = tally[kernel + "_by_device"]
                got[d] = got.get(d, 0) + n
    out["seconds"] = time.perf_counter() - t_phase
    log("moe/pipeline: phase 20 %.2f s; launches %s"
        % (out["seconds"], json.dumps(out["launches"])))
    log("moe/pipeline kernels (rows 3 and 4 on these paths): "
        + json.dumps({"kernels": [
        {"name": "fused_opt", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/fused_opt.cu",
         "replaces": "mxnet_tpu/kernels/fused_opt.py:112",
         "launches": out["launches"]["fused_opt"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mxnet_tpu/parallel/ring_attention.py:128",
         "launches": out["launches"]["flash_attention"]}]}))
    if not all(out["launches"][k] > 0 for k in ("fused_opt",
                                                 "flash_attention")):
        raise AssertionError("phase 20: launches %s" % out["launches"])
    return out


# ----------------------------------------------------------------------
# phase 21: the source lints on the card
# ----------------------------------------------------------------------
#: (c)'s LM steps and Rtc pushes after the warm-up boundary
SRC_WARM_STEPS = 2
SRC_STEPS = 10
SRC_RTC_PUSHES = 20
#: (d): kvstore push_async rounds (the first with set_updater in flight)
SRC_KV_ROUNDS = 4


def src_lints(smi):
    """(a) ``mxlint --distributed --concurrency --retrace mxnet_tpu_torch
    --fail-on=warning`` in a subprocess (gate: exit 0) and, beside it in
    this process, each family's seconds and counts."""
    from mxnet_tpu_torch.analysis import concurrency, divergence, retrace
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.mxlint",
           "--distributed", "--concurrency", "--retrace", "mxnet_tpu_torch",
           "--fail-on=warning"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    fams = {}
    try:
        pkg = [os.path.join(here, "mxnet_tpu_torch")]
        n_files = len(divergence.iter_py_files(pkg))
        for fam, fn in (("D004-D006", divergence.analyze_source_paths),
                        ("Q", concurrency.analyze_concurrency_paths),
                        ("X", retrace.analyze_retrace_paths)):
            t = time.perf_counter()
            found = fn(pkg, root=here)
            fams[fam] = {"seconds": time.perf_counter() - t,
                         "findings": len(found), "files": n_files}
            log("source lints (a) %s: %d findings over %d files, %.3f s "
                "(in process)" % (fam, len(found), n_files,
                                  fams[fam]["seconds"]))
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or any(f["findings"] for f in fams.values()):
        raise AssertionError("source lints (a): mxlint rc %d, findings %s:"
                             " %s %s" % (proc.returncode, fams, out[-800:],
                                         err[-800:]))
    log("source lints (a) %s: rc 0 (%s), %.2f s wall; on %s"
        % (" ".join(cmd[2:]), out.strip().splitlines()[-1], seconds, smi))
    return {"rc": proc.returncode, "seconds": seconds, "families": fams}


#: thread ids the witness op records: "forward", "backward"
THREAD_WITNESS = {}


def _register_thread_witness(mx):
    """A CustomOp host op that records ``threading.get_ident()`` in the
    user's forward and backward (in :data:`THREAD_WITNESS`)."""
    import threading
    if "chip_smoke_thread_witness" in mx.operator.CUSTOM_OP_REGISTRY:
        return

    class Witness(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            THREAD_WITNESS["forward"] = threading.get_ident()
            self.assign(out_data[0], req[0], in_data[0] * 2.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            THREAD_WITNESS["backward"] = threading.get_ident()
            self.assign(in_grad[0], req[0], out_grad[0] * 2.0)

    @mx.operator.register("chip_smoke_thread_witness")
    class WitnessProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Witness()


def src_callback_thread(torch, smi):
    """(b) The Q005 witness: a CustomOp forward and backward on gpu(0),
    ``threading.get_ident()`` in the user's forward, its backward and the
    caller: on the card autograd runs the backward on its device thread."""
    import threading
    import mxnet_tpu_torch as mx
    THREAD_WITNESS.clear()
    seen = THREAD_WITNESS
    _register_thread_witness(mx)
    data = mx.sym.Variable("data")
    net = mx.sym.Custom(data=data, op_type="chip_smoke_thread_witness",
                        name="witness")
    gpu = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    exe = net.simple_bind(gpu, data=(4, 8))
    x = np.random.RandomState(21).randn(4, 8).astype(np.float32)
    exe.arg_dict["data"][:] = x
    caller = threading.get_ident()
    exe.forward(is_train=True)
    exe.backward([mx.nd.ones((4, 8), ctx=gpu)])
    grad = exe.grad_dict["data"].asnumpy()
    out = exe.outputs[0].asnumpy()
    if not (np.array_equal(out, 2.0 * x) and np.array_equal(
            grad, np.full((4, 8), 2.0, np.float32))):
        raise AssertionError("source lints (b): the witness op's output or "
                             "gradient is wrong")
    if set(seen) != {"forward", "backward"}:
        raise AssertionError("source lints (b): the user's forward/backward "
                             "did not run: %s" % seen)
    res = {"caller": caller, "forward": seen["forward"],
           "backward": seen["backward"],
           "forward_off_caller": seen["forward"] != caller,
           "backward_off_caller": seen["backward"] != caller}
    log("source lints (b) CustomOp on %s: forward on the caller's thread %s,"
        " backward on the caller's thread %s (ids caller %d, forward %d, "
        "backward %d); on %s"
        % (gpu, not res["forward_off_caller"],
           not res["backward_off_caller"], caller, seen["forward"],
           seen["backward"], smi))
    return res


def src_retrace_witness(torch, seed, smi):
    """(c) The X witness: the LM through ShardedTrainer with the body
    generated from a user's update_fn (phase 17's path) and Rtc's saxpy
    (phase 8's body (b)), the retrace sentry armed after a warm-up: no
    program build and no NVRTC compile after the boundary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import executor, rtc as rtc_mod
    from mxnet_tpu_torch.kernels import fused_opt as fo, nvrtc
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    from mxnet_tpu_torch.kernels import sweep_codegen as cg
    from mxnet_tpu_torch.observability import retrace
    from mxnet_tpu_torch.parallel import overlap
    calls = {"compile_cubin": 0, "build_program": 0}
    orig = {"compile_cubin": nvrtc.compile_cubin,
            "build_program": executor.build_program}

    def counted(name):
        def run(*a, **kw):
            calls[name] += 1
            return orig[name](*a, **kw)
        return run
    nvrtc.compile_cubin = counted("compile_cubin")
    executor.build_program = counted("build_program")
    was = retrace.installed()
    retrace.install()
    retrace.reset()
    retrace.warmup_begin()

    def state():
        return {"nvrtc_compiles": calls["compile_cubin"],
                "program_builds": calls["build_program"],
                "lowerings": overlap.compile_cache_stats()["lowerings"],
                "sweep_sources": len(cg._BUILT),
                "rtc_keys": sum(len(r._compiled) for r in rk._RTCS.values()),
                "rtc_launches": rtc_mod.launches}
    try:
        SignClip = sign_clip_class(mx)
        S = TRAIN["seq_len"]
        opt = SignClip(learning_rate=0.01,
                       rescale_grad=1.0 / (TRAIN_BATCH * S),
                       clip_gradient=10.0)
        tr, p, st, aux = res_trainer(torch, seeded_train_params(seed), opt)
        b = tr.shard_batch(train_batch(seed))
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 21)
        gpu = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
        x = mx.nd.array(torch.rand(RTC_TIMED_N, generator=gen,
                                   device=DEVICE), ctx=gpu)
        y = mx.nd.array(torch.rand(RTC_TIMED_N, generator=gen,
                                   device=DEVICE), ctx=gpu)
        for _ in range(SRC_WARM_STEPS):
            p, st, aux, _o = tr.step(p, st, aux, b)
        rk.saxpy(x, y)
        torch.cuda.synchronize()
        retrace.warmup_boundary()
        reset_counts()
        before = state()
        t0 = time.perf_counter()
        for _ in range(SRC_STEPS):
            p, st, aux, _o = tr.step(p, st, aux, b)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / SRC_STEPS
        counts = read_counts()
        for _ in range(SRC_RTC_PUSHES):
            z = rk.saxpy(x, y)[0]
        torch.cuda.synchronize()
        after = state()
        sentry = retrace.stats()
    finally:
        nvrtc.compile_cubin = orig["compile_cubin"]
        executor.build_program = orig["build_program"]
        retrace.reset()
        if not was:
            retrace.uninstall()
        os.environ.pop("MXTPU_FUSED_OPT", None)
    err = float((z.data - (2.5 * x.data + y.data)).abs().max())
    n_buckets = len(fo.plan_buckets(p))
    bad = {k: (before[k], after[k]) for k in before
           if k != "rtc_launches" and before[k] != after[k]}
    if bad or sentry["retraces_after_warmup"] or \
            after["rtc_launches"] - before["rtc_launches"] \
            != SRC_RTC_PUSHES or counts["fused_opt_by_body"] != \
            {fo.GENERATED: SRC_STEPS * n_buckets} or not err <= 1e-5:
        raise AssertionError(
            "source lints (c): after the boundary %s changed, sentry %s, "
            "Rtc launches %d, sweeps %s (want %d generated), saxpy err %g"
            % (bad, sentry, after["rtc_launches"] - before["rtc_launches"],
               counts["fused_opt_by_body"], SRC_STEPS * n_buckets, err))
    res = {"before": before, "after": after, "step_ms": step_ms,
           "retraces_after_warmup": sentry["retraces_after_warmup"],
           "lowerings_seen": sentry["lowerings_seen"],
           "launches": counts, "rtc_pushes": SRC_RTC_PUSHES,
           "saxpy_max_abs_err": err}
    log("source lints (c) retrace sentry armed after %d warm-up steps: %d "
        "LM steps through the generated sweep body (%.2f ms a step, sweeps "
        "%s) and %d Rtc saxpy pushes: program builds %d -> %d, NVRTC "
        "compiles %d -> %d, registry lowerings %d -> %d, sweep sources %d, "
        "Rtc keys %d, retraces after warm-up %d; on %s"
        % (SRC_WARM_STEPS, SRC_STEPS, step_ms,
           json.dumps(counts["fused_opt_by_body"]), SRC_RTC_PUSHES,
           before["program_builds"], after["program_builds"],
           before["nvrtc_compiles"], after["nvrtc_compiles"],
           before["lowerings"], after["lowerings"], after["sweep_sources"],
           after["rtc_keys"], sentry["retraces_after_warmup"], smi))
    return res


def src_kvstore_witness(torch, seed, smi):
    """(d) The repaired kvstore path on the card under MXTPU_LOCKCHECK=1:
    push_async of the LM's gradients with the sum over a one-rank NCCL
    group run on the store's worker thread, ``set_updater`` while the
    first bucket is in flight; no lock-order error, and the parameters bit
    for bit those of the synchronous ``push`` under the same updaters."""
    import threading
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as kvmod
    from mxnet_tpu_torch.observability import locktrace
    from mxnet_tpu_torch.resilience import ResilienceError
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group(
            "nccl" if DEVICE == "cuda" else "gloo",
            init_method="tcp://127.0.0.1:%d" % _free_port(), world_size=1,
            rank=0)
    elif dist.get_world_size() != 1:
        raise AssertionError("source lints (d): a process group of %d is "
                             "already up" % dist.get_world_size())
    os.environ["MXTPU_LOCKCHECK"] = "1"
    was = locktrace.installed()
    locktrace.maybe_install()
    locktrace.reset_order_graph()

    class OneRankDist(kvmod.KVStore):
        # the store's dist path in one process: the sum over the
        # one-rank group runs, on push_async's worker thread
        _dist = property(lambda self: True)

    gpu = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    shapes = train_param_shapes()
    rng = np.random.RandomState(seed + 210)
    weights = {n: (rng.randn(*s) * 0.02).astype(np.float32)
               for n, s in shapes.items()}
    grads = [{n: (rng.randn(*s) * 1e-3).astype(np.float32)
              for n, s in shapes.items()} for _ in range(SRC_KV_ROUNDS)]
    keys = sorted(shapes)
    lock_errors = []

    def sgd(lr):
        return mx.optimizer.get_updater(mx.optimizer.create(
            "sgd", learning_rate=lr, momentum=0.9, rescale_grad=1.0))

    def run(kv, async_push, gate=None):
        for i, k in enumerate(keys):
            kv.init(i, mx.nd.array(weights[k], ctx=gpu))
        kv.set_updater(sgd(0.1))
        ms = []
        for r in range(SRC_KV_ROUNDS):
            t0 = time.perf_counter()
            vals = [mx.nd.array(grads[r][k], ctx=gpu) for k in keys]
            if async_push:
                for i, v in enumerate(vals):
                    kv.push_async(i, v)
                if r == 0:
                    kv.set_updater(sgd(0.05))     # bucket 0 in flight
                    gate.set()
                kv.wait_all()
            else:
                for i, v in enumerate(vals):
                    kv.push(i, v)
                if r == 0:
                    kv.set_updater(sgd(0.05))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        outs = [mx.nd.zeros(shapes[k], ctx=gpu) for k in keys]
        for i, o in enumerate(outs):
            kv.pull(i, out=o)
        return [o.data.clone() for o in outs], ms

    try:
        gate = threading.Event()
        kv = OneRankDist("dist_sync")
        real = kv._allreduce

        def gated(merged):
            if not gate.wait(60):
                raise AssertionError("source lints (d): gate never opened")
            return real(merged)
        kv._allreduce = gated
        try:
            got, ms = run(kv, True, gate)
        except ResilienceError as exc:
            lock_errors.append(str(exc))
            raise
        finally:
            if kv._async is not None:
                kv._async.close()
        want, ms_sync = run(kvmod.KVStore("local"), False)
        edges = len(locktrace.order_edges())
    finally:
        locktrace.reset_order_graph()
        if not was:
            locktrace.uninstall()
        os.environ.pop("MXTPU_LOCKCHECK", None)
        if own_group:
            dist.destroy_process_group()
    diff = [k for k, a, b in zip(keys, got, want) if not torch.equal(a, b)]
    if diff or lock_errors:
        raise AssertionError("source lints (d): push_async differs from push "
                             "on %s; lock-order errors %s"
                             % (diff[:5], lock_errors))
    res = {"keys": len(keys), "rounds": SRC_KV_ROUNDS, "lock_errors": 0,
           "order_edges": edges, "round_ms": ms, "round_ms_sync": ms_sync,
           "bitwise": True}
    log("source lints (d) kvstore push_async (%d keys of the LM, %d rounds, "
        "set_updater with round 0 in flight) under MXTPU_LOCKCHECK=1: 0 "
        "lock-order errors (%d order edges), parameters bit for bit the "
        "synchronous push's; ms a round %s (push: %s); on %s"
        % (len(keys), SRC_KV_ROUNDS, edges,
           ", ".join("%.2f" % m for m in ms),
           ", ".join("%.2f" % m for m in ms_sync), smi))
    return res


def phase_source_lints(torch, seed, smi):
    """Phase 21: the source half of the analyzer on the card (the module
    docstring's (a)-(d)).  It launches no new kernel."""
    t_phase = time.perf_counter()
    out = {"lints": src_lints(smi)}
    out["callback_thread"] = src_callback_thread(torch, smi)
    out["retrace"] = src_retrace_witness(torch, seed, smi)
    out["kvstore"] = src_kvstore_witness(torch, seed, smi)
    out["seconds"] = time.perf_counter() - t_phase
    log("source lints: phase 21 %.2f s" % out["seconds"])
    return out


# ----------------------------------------------------------------------
# phase 22: tensor parallelism and FSDP
# ----------------------------------------------------------------------
#: the LM's steps a configuration (phase 7's 3), then the timed ones
TP_STEPS = 3
TP_TIMED_STEPS = 3
#: ShardedPredictor's batch (phase 7's sequence length)
TP_PREDICT_BATCH = 2
TP_PREDICT_TOL = 1e-5


def tp_dir(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_tp", *parts)


def _tp_reset():
    """Every count phase 22 reads, at 0 (the launches of the main path's
    run that follows)."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.parallel import tensor_parallel as tp
    _reset_dp_counts()
    fa.flash_attention_forward.launches_by_heads.clear()
    fd.flash_decode_attention.launches = 0
    fd.flash_decode_attention.launches_by_heads.clear()
    qz.quantized_matmul.launches = 0
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    qz.quantized_matmul.launches_by_qdtype.update(int8=0, fp8_e4m3=0)
    qz.quantized_matmul.launches_by_rows.clear()
    tp.reset_counts()


def _tp_counts():
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.parallel import tensor_parallel as tp
    out = _sweep_counts()
    out.update(
        flash_attention_by_heads=dict(fa.flash_attention_forward
                                      .launches_by_heads),
        flash_attention_by_dtype=dict(fa.flash_attention_forward
                                      .launches_by_dtype),
        flash_decode=fd.flash_decode_attention.launches,
        flash_decode_by_heads=dict(fd.flash_decode_attention
                                   .launches_by_heads),
        quantized_matmul=qz.quantized_matmul.launches,
        quantized_matmul_by_route=dict(qz.quantized_matmul
                                       .launches_by_route),
        quantized_matmul_by_rows=dict(qz.quantized_matmul.launches_by_rows),
        whole_weight_gathers=tp.counts()["whole_weight_gathers"])
    return out


def _plain_refs(torch, params, batch, steps):
    """Phase 7's plain float32 and float64 steps from ``params``: the
    float64 witness every tp and FSDP run is held to."""
    o32, p32, _m = plain_train(torch, params, batch, steps)
    o64, p64, _m = plain_train(torch, _f64(torch, params), batch, steps)
    return o32, p32, o64, p64


def _witness(torch, what, refs, before, outs, p_after):
    """:func:`precision_check`'s readings from precomputed plain steps."""
    o32, p32, o64, p64 = refs
    got = {"what": what,
           "port_vs_plain32": _diff(torch, outs, p_after, o32, p32, before),
           "port_vs_plain64": _diff(torch, outs, p_after, o64, p64, before),
           "plain32_vs_plain64": _diff(torch, o32, p32, o64, p64, before)}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    return got


def _tp_trainer(torch, mx, mesh, params, opt_kw, compute_dtype=None, **kw):
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.parallel.sharding import place
    opt = mx.optimizer.create("sgd", **opt_kw)
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**TRAIN), opt, mesh,
                                    compute_dtype=compute_dtype, **kw)
    p = tr.place_params(params)
    st = {k: place(np.zeros(v.shape, np.float32), mesh,
                   tr.opt_state_sharding(k, v.shape).spec)
          for k, v in params.items()}
    if mesh.size == 1:
        st = {k: v.shards[0] for k, v in st.items()}
    return tr, p, st


def tp_lm_gate(torch, mx, seed, smi, shape, distinct, refs, params, batch,
               dtypes=("float32", "bfloat16"), tp1=None):
    """(a) the LM at full width on ``make_mesh(**shape)``: TP_STEPS steps a
    dtype (SGD with momentum), each member's flash forward over its
    ``H/tp`` heads (once a layer a step) and its own sweeps counted, no
    whole weight gathered, the float32 run held to phase 7's float64
    witness (``refs``) and set beside ``tp1`` (the one-device trainer's
    outputs and parameters after TP_STEPS); then TP_TIMED_STEPS timed
    steps and each card's peak memory."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    n = int(np.prod(list(shape.values())))
    tp_n = shape.get("tp", 1)
    ctxs = _dp_contexts(mx, n, distinct)
    mesh = mx.parallel.make_mesh(ctxs, **shape)
    S = TRAIN["seq_len"]
    opt_kw = dict(TRAIN_SGD, rescale_grad=1.0 / (TRAIN_BATCH * S))
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    heads = TRAIN["num_heads"] // tp_n
    out = {"mesh": dict(shape), "cards": len(set(mesh.devices)),
           "contexts": [str(c) for c in ctxs]}
    for dtype in dtypes:
        cdt = None if dtype == "float32" else dtype
        tr, p, st = _tp_trainer(torch, mx, mesh, params, opt_kw, cdt)
        b = tr.shard_batch(batch)
        _sync_all(torch, mesh.devices)
        _peak_reset_all(torch, mesh.devices)
        _tp_reset()
        t0 = time.perf_counter()
        for _ in range(TP_STEPS):
            p, st, _a, outs = tr.step(p, st, {}, b)
        _sync_all(torch, mesh.devices)
        first_s = time.perf_counter() - t0
        counts = _tp_counts()
        member = {k: p[k].shards[0] for k in tr.param_names}
        buckets = len(fo.plan_buckets(member))
        want_fa = TRAIN["num_layers"] * TP_STEPS * n
        want_fo = buckets * TP_STEPS * n
        what = "tp (a) %s %s" % (dict(shape), dtype)
        if counts["whole_weight_gathers"]:
            raise AssertionError("%s: %d whole-weight gathers"
                                 % (what, counts["whole_weight_gathers"]))
        if counts["flash_attention"] != want_fa \
                or counts["flash_attention_by_heads"] != {heads: want_fa} \
                or counts["flash_attention_by_dtype"][dtype] != want_fa \
                or counts["fused_opt"] != want_fo:
            raise AssertionError(
                "%s: launches %s, want the flash forward %d times over %d "
                "heads (a layer, a step, a member), its %s body, and the "
                "sweep %d (%d buckets a member)"
                % (what, counts, want_fa, heads, dtype, want_fo, buckets))
        dev0 = mesh.devices[0]
        o_whole = outs[0].global_tensor(dev0)
        if not bool(torch.isfinite(o_whole.float()).all()):
            raise AssertionError("%s: non-finite outputs" % what)
        row = {"launches": counts, "buckets_a_member": buckets,
               "first_steps_s": first_s,
               "member_param_bytes": sum(v.numel() * v.element_size()
                                         for v in member.values())}
        if dtype == "float32":
            p_after = {k: v.global_tensor(dev0) for k, v in p.items()}
            wit = _witness(torch, what, refs, params, o_whole, p_after)
            if not wit["ok"]:
                raise AssertionError("%s: the float64 witness %s"
                                     % (what, json.dumps(wit)))
            row["witness"] = wit
            if tp1 is not None:
                row["vs_tp1"] = _diff(torch, o_whole, p_after, *tp1,
                                      params)
            del p_after
        del o_whole, outs
        times = []
        for _ in range(TP_TIMED_STEPS):
            t0 = time.perf_counter()
            p, st, _a, _o = tr.step(p, st, {}, b)
            _sync_all(torch, mesh.devices)
            times.append(time.perf_counter() - t0)
        row["step_ms"] = float(np.median(times)) * 1e3
        row["step_ms_all"] = [t * 1e3 for t in times]
        row["tokens_per_s"] = TRAIN_BATCH * S / (row["step_ms"] / 1e3)
        row["peak_bytes_by_device"] = _peaks_by_device(torch, mesh.devices)
        out[dtype] = row
        log("%s: %.3f ms/step (median of %d), %.1f tokens/s; flash forward "
            "%d over %s heads, sweep %d (%d buckets a member); whole-weight "
            "gathers 0; peak bytes by card %s%s; on %s"
            % (what, row["step_ms"], TP_TIMED_STEPS, row["tokens_per_s"],
               counts["flash_attention"], heads, counts["fused_opt"],
               buckets, json.dumps(row["peak_bytes_by_device"]),
               "; witness %s" % json.dumps(row["witness"])
               if "witness" in row else "", smi))
        del tr, p, st, b, _o
        torch.cuda.empty_cache()
    os.environ.pop("MXTPU_FUSED_OPT", None)
    return out


def tp_fsdp_gate(torch, mx, seed, smi, n, distinct, params, batch):
    """(b) the LM under ``fsdp=True`` at dp=n: its parameters and momentum
    after TP_STEPS and TP_TIMED_STEPS steps bit for bit those of ZeRO-1
    (both reduce-scatter the same gradients) and, on one card, of plain
    dp (over cards NCCL's all-reduce may sum in another order: the
    difference is reported); each member's persistent bytes of
    parameters and state beside plain dp's; the step timed; each card's
    peak."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    ctxs = _dp_contexts(mx, n, distinct)
    mesh = mx.parallel.make_mesh(ctxs, dp=n)
    S = TRAIN["seq_len"]
    opt_kw = dict(TRAIN_SGD, rescale_grad=1.0 / (TRAIN_BATCH * S))
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    runs, got = {}, {}
    for mode in ("replicated", "zero1", "fsdp"):
        kw = {"replicated": {}, "zero1": {"zero1": True},
              "fsdp": {"fsdp": True}}[mode]
        tr, p, st = _tp_trainer(torch, mx, mesh, params, opt_kw, **kw)
        b = tr.shard_batch(batch)
        _sync_all(torch, mesh.devices)
        _peak_reset_all(torch, mesh.devices)
        _tp_reset()
        for _ in range(TP_STEPS):
            p, st, _a, _o = tr.step(p, st, {}, b)
        _sync_all(torch, mesh.devices)
        counts = _tp_counts()
        persistent = [sum(v.shards[r].numel() * v.shards[r].element_size()
                          for d in (p, st) for v in d.values())
                      for r in range(n)]
        times = []
        for _ in range(TP_TIMED_STEPS):
            t0 = time.perf_counter()
            p, st, _a, _o = tr.step(p, st, {}, b)
            _sync_all(torch, mesh.devices)
            times.append(time.perf_counter() - t0)
        dev0 = mesh.devices[0]
        got[mode] = ({k: v.global_tensor(dev0) for k, v in p.items()},
                     {k: v.global_tensor(dev0) for k, v in st.items()})
        runs[mode] = {"launches": counts,
                      "persistent_bytes_by_member": persistent,
                      "step_ms": float(np.median(times)) * 1e3,
                      "step_ms_all": [t * 1e3 for t in times],
                      "peak_bytes_by_device": _peaks_by_device(
                          torch, mesh.devices)}
        del tr, p, st, b, _o
        torch.cuda.empty_cache()
    fp, fs = got["fsdp"]
    diffs = {}
    for mode in ("zero1", "replicated"):
        wp, ws = got[mode]
        bad = [k for k in fp if not torch.equal(fp[k], wp[k])
               or not torch.equal(fs[k], ws[k])]
        diffs[mode] = max(float((fp[k] - wp[k]).abs().max()) for k in fp)
        if bad and (mode == "zero1" or not distinct):
            raise AssertionError("tp (b) fsdp dp=%d: parameters or momentum "
                                 "differ from %s's after %d steps: %s"
                                 % (n, mode, TP_STEPS + TP_TIMED_STEPS,
                                    bad[:5]))
    del got, fp, fs, wp, ws
    torch.cuda.empty_cache()
    share = runs["fsdp"]["persistent_bytes_by_member"][0] \
        / runs["replicated"]["persistent_bytes_by_member"][0]
    out = {"dp": n, "cards": len(set(mesh.devices)), "runs": runs,
           "persistent_share": share, "max_abs_diff": diffs}
    log("tp (b) fsdp dp=%d on %d card(s): parameters and momentum after %d "
        "steps, max |diff| against ZeRO-1 and plain dp %s (0: bit for "
        "bit); persistent bytes a "
        "member %s (fsdp) against %s (replicated), a share of %.4f; ms a "
        "step fsdp %.3f, zero1 %.3f, replicated %.3f; peak bytes by card %s; "
        "sweep launches %s; on %s"
        % (n, out["cards"], TP_STEPS + TP_TIMED_STEPS, json.dumps(diffs),
           runs["fsdp"]["persistent_bytes_by_member"],
           runs["replicated"]["persistent_bytes_by_member"], share,
           runs["fsdp"]["step_ms"], runs["zero1"]["step_ms"],
           runs["replicated"]["step_ms"],
           json.dumps({m: r["peak_bytes_by_device"]
                       for m, r in runs.items()}),
           json.dumps({m: r["launches"]["fused_opt"]
                       for m, r in runs.items()}), smi))
    os.environ.pop("MXTPU_FUSED_OPT", None)
    return out


def tp_engine_gate(torch, mx, seed, smi):
    """(c) ``GenerationEngine(mesh=make_mesh([gpu(0)] * 2, tp=2))`` on
    phase 4's 8 prompts, float32 and fp8: tokens equal to the one-device
    engine's, float32 logits within 1e-3 of a plain forward and fp8
    logits within 1e-3 of the one-device fp8 engine's; each member's
    flash-decode launches (4 heads) and weight-only launches by route and
    rows counted."""
    from mxnet_tpu_torch.serving import GenerationEngine
    params = seeded_params(seed)
    prompts = make_prompts(seed)
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    mesh = mx.parallel.make_mesh([ctx, ctx], tp=2)
    out = {}
    for quantize in (None, "fp8_e4m3"):
        name = quantize or "float32"
        one, one_tok, one_logits = run_engine(torch, params, prompts,
                                              quantize)
        t0 = time.perf_counter()
        eng = GenerationEngine(params, mesh=mesh, quantize=quantize,
                               **MODEL)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng.collect_logits = True
        _tp_reset()
        t0 = time.perf_counter()
        toks = eng.generate(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _tp_counts()
        st = eng.stats()
        what = "tp (c) engine tp=2 %s" % name
        if toks != one_tok:
            first = next(i for i, (a, b) in enumerate(zip(toks, one_tok))
                         if a != b)
            raise AssertionError("%s: prompt %d's tokens differ from the "
                                 "one-device engine's" % (what, first))
        heads = MODEL["num_heads"] // 2
        want_fd = st["decode_steps"] * MODEL["num_layers"] * 2
        if counts["flash_decode_by_heads"] != {heads: want_fd} \
                or counts["whole_weight_gathers"]:
            raise AssertionError("%s: launches %s, want flash-decode %d "
                                 "times over %d heads and no whole-weight "
                                 "gather" % (what, counts, want_fd, heads))
        if quantize:
            # each member's rows of lm_head, ffn1 and ffn2
            rows = {MODEL["vocab_size"] // 2,
                    MODEL["ffn_mult"] * MODEL["dim"] // 2,
                    MODEL["dim"] // 2}
            if set(counts["quantized_matmul_by_rows"]) != rows \
                    or min(counts["quantized_matmul_by_route"].values()) < 1:
                raise AssertionError("%s: weight-only launches by rows %s "
                                     "and route %s, want rows %s on both "
                                     "bodies" % (
                                         what,
                                         counts["quantized_matmul_by_rows"],
                                         counts["quantized_matmul_by_route"],
                                         sorted(rows)))
            err = max(float(np.abs(np.stack(a) - np.stack(b)).max())
                      for a, b in zip(eng.last_logits, one_logits))
        else:
            seq = prompts[0] + toks[0]
            plain = plain_lm_logits(torch, params, seq[:-1])[
                len(prompts[0]) - 1:]
            err = float(np.abs(np.stack(eng.last_logits[0]) - plain).max())
        if not err <= 1e-3:
            raise AssertionError("%s: logits %g from the %s (tol 1e-3)"
                                 % (what, err, "one-device engine's"
                                    if quantize else "plain forward"))
        out[name] = {"tokens_equal": True, "max_abs_err": err,
                     "against": "one-device engine" if quantize
                     else "plain forward",
                     "engine_build_s": build_s, "generate_s": wall,
                     "decode_steps": st["decode_steps"],
                     "decode_ms_per_step":
                         st["decode_s"] * 1e3 / st["decode_steps"],
                     "prefill_ms_per_prompt":
                         st["prefill_s"] * 1e3 / st["prefills"],
                     "one_device": {k: one[k] for k in (
                         "decode_ms_per_step", "prefill_ms_per_prompt",
                         "generate_s")},
                     "launches": counts}
        log("%s: tokens of the 8 prompts equal the one-device engine's; "
            "logits within %.3g of the %s; decode %.3f ms/step (one device "
            "%.3f), prefill %.3f ms/prompt (one device %.3f); flash-decode "
            "by heads %s, weight-only by route %s and rows %s; on %s"
            % (what, err, out[name]["against"],
               out[name]["decode_ms_per_step"], one["decode_ms_per_step"],
               out[name]["prefill_ms_per_prompt"],
               one["prefill_ms_per_prompt"],
               counts["flash_decode_by_heads"],
               counts["quantized_matmul_by_route"],
               counts["quantized_matmul_by_rows"], smi))
        del eng
        torch.cuda.empty_cache()
    return out


def tp_predictor_gate(torch, mx, seed, distinct):
    """(d) ``ShardedPredictor.from_checkpoint`` of the LM at dp=2 x tp=2
    within 1e-5 of ``predictor.Predictor``, no whole weight gathered."""
    from mxnet_tpu_torch.models import transformer as tf
    params = seeded_train_params(seed)
    batch = train_batch(seed, TP_PREDICT_BATCH)
    sym = tf.get_symbol(**TRAIN)
    prefix = tp_dir("lm")
    os.makedirs(tp_dir(), exist_ok=True)
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    mx.model.save_checkpoint(prefix, 1, sym,
                             {k: mx.nd.array(v, ctx=ctx)
                              for k, v in params.items()}, {})
    S = TRAIN["seq_len"]
    pred = mx.predictor.Predictor(
        sym.tojson(), params, {"data": (TP_PREDICT_BATCH, S),
                               "softmax_label": (TP_PREDICT_BATCH, S)},
        ctx=ctx)
    pred.forward(data=batch["data"])
    want = pred.get_output(0)
    want = torch.as_tensor(want.asnumpy() if hasattr(want, "asnumpy")
                           else want)
    mesh = mx.parallel.make_mesh(_dp_contexts(mx, 4, distinct), dp=2, tp=2)
    _tp_reset()
    with ctx:
        sp = mx.parallel.ShardedPredictor.from_checkpoint(prefix, 1, mesh)
    zeros = np.zeros_like(batch["softmax_label"])
    got = torch.as_tensor(sp.predict({"data": batch["data"],
                                      "softmax_label": zeros})[0])
    counts = _tp_counts()
    err = float((got - want).abs().max())
    if err > TP_PREDICT_TOL or not bool(torch.isfinite(got).all()) \
            or counts["whole_weight_gathers"]:
        raise AssertionError("tp (d): ShardedPredictor %.3g from the "
                             "Predictor (tol %g); counts %s"
                             % (err, TP_PREDICT_TOL, counts))
    log("tp (d) ShardedPredictor dp=2 x tp=2 (%s) from %s-0001.params: "
        "outputs %s within %.3g of predictor.Predictor's (tol %g); flash "
        "forward by heads %s; whole-weight gathers 0"
        % ("4 cards" if distinct else "one card", os.path.basename(prefix),
           tuple(got.shape), err, TP_PREDICT_TOL,
           counts["flash_attention_by_heads"]))
    shutil.rmtree(tp_dir(), ignore_errors=True)
    del pred, sp
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "shape": list(got.shape),
            "launches": counts}


#: the member shapes phase 22 launches the kernels at: flash-decode and
#: the flash forward over 4 of the LM's 8 heads, the weight-only kernel
#: on half of lm_head's rows, the sweep on one member's largest bucket at
#: tp=2 and its FSDP vector at dp=2
def tp_kernel_checks(torch, timer, seed, smi):
    """(e) every kernel the phase launches at a new shape, against its
    plain version at that shape (and timed): flash-decode with 4 heads
    (2e-5, bitwise on repeat), the flash forward with 4 heads (phase 5's
    bounds), the weight-only kernel on a row slice (1e-4, and a cosine of
    at least 0.999 against the float32 product of the unquantized
    weight), the sweep on the member buckets (bit for bit); and the
    registered MXL-K specs at those shapes lint clean, with the shared
    memory the built libraries report."""
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.analysis import tiling
    from mxnet_tpu_torch.kernels import (flash_attention as fa,
                                         flash_decode as fd,
                                         fused_opt as fo, quantize as qz)
    rng = np.random.RandomState(seed + 22)
    rows = []
    H = TRAIN["num_heads"] // 2
    D = TRAIN["dim"] // TRAIN["num_heads"]
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    # flash-decode, 4 heads a member, phase 2's positions
    plan = fd.plan_flash_decode(8, H, 32, 32, D, sms)
    case = flash_decode_case(torch, rng, FD_POSITIONS, torch.float32, H=H)
    rows.append(_fd_timed_row(torch, fd, timer, plan, case,
                              1.0 / math.sqrt(D), 2e-5,
                              "tp member H=%d" % H, 0.0, []))
    rows[-1].update(name="flash_decode", H=H)
    # the flash forward, 4 heads a member, the training shape
    B, S = TRAIN_BATCH, TRAIN["seq_len"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = [torch.from_numpy(rng.randn(B, H, S, D).astype(
            np.float32)).to(DEVICE, dtype) for _ in range(3)]
        o, lse = fa.flash_attention_forward(q, k, v, causal=True)
        o2, lse2 = fa.flash_attention_forward(q, k, v, causal=True)
        ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        lse_err = float((lse - rl).abs().max())
        if dtype == torch.float32:
            err = float((o - ro).abs().max())
            ok = err <= 2e-5 and torch.equal(o, o2) \
                and torch.equal(lse, lse2)
        else:
            err, ok = _bf16_close(torch, o, ro)
        if not (ok and lse_err <= 1e-4):
            raise AssertionError("tp (e) flash forward H=%d %s: o %g, lse %g"
                                 % (H, dtype, err, lse_err))
        pairs = S * (S + 1) // 2
        n_ops = 4 * B * H * pairs * D
        n_bytes = 4 * B * H * S * D * q.element_size() + B * H * S * 4
        b_ms, b_by = bound_ms(n_bytes, n_ops, ops_rate(dtype))
        rows.append({
            "name": "flash_attention", "B": B, "H": H, "S": S, "D": D,
            "causal": True, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": timer(lambda: fa.flash_attention_forward(
                q, k, v, causal=True)),
            "plain_ms": timer(lambda: fa.flash_attention_forward_reference(
                q, k, v, causal=True)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, o, o2, ro
    # the weight-only kernel on a member's rows of lm_head, decode (GEMV)
    # and the largest prompt bucket (wgmma)
    N, K = TRAIN["vocab_size"] // 2, TRAIN["dim"]
    for m, qdtype in ((8, "int8"), (8, "fp8_e4m3"), (960, "fp8_e4m3")):
        w = (rng.randn(2 * N, K) * 0.02).astype(np.float32)
        wq_all, sc_all = qz.quantize_array(w, qdtype=qdtype)
        wq = torch.as_tensor(wq_all).to(DEVICE)[N:].contiguous()
        sc = torch.from_numpy(sc_all).to(DEVICE)[N:].contiguous()
        x = torch.from_numpy(rng.randn(m, K).astype(np.float32)).to(DEVICE)
        got = qz.quantized_matmul(x, wq, sc)
        again = qz.quantized_matmul(x, wq, sc)
        want = qz.quantized_matmul_reference(x, wq, sc)
        exact = x @ torch.from_numpy(w[N:]).to(DEVICE).t()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        cos = _cosine(got.cpu().numpy(), exact.cpu().numpy())
        route = qz.plan_quantized_matmul(m, N, K, sms)["route"]
        if not (err <= 1e-4 and torch.equal(got, again) and cos >= 0.999):
            raise AssertionError("tp (e) weight-only M=%d N=%d %s (%s): "
                                 "err %g, cosine %.6f" % (m, N, qdtype,
                                                          route, err, cos))
        n_bytes = m * K * 4 + N * K + N * 4 + m * N * 4
        ops = 2 * m * N * K
        b_ms, b_by = bound_ms(n_bytes, ops) if route == "gemv" \
            else bound_ms(n_bytes, ops, ops_rate("bfloat16"))
        w_deq = wq.float() * sc[:, None]
        rows.append({
            "name": "quantized_matmul", "M": m, "K": K, "N": N,
            "dtype": "float32", "qdtype": qdtype, "route": route,
            "max_abs_err": err, "cosine": cos,
            "ms": timer(lambda: qz.quantized_matmul(x, wq, sc)),
            "plain_ms": timer(lambda: qz.quantized_matmul_reference(
                x, wq, sc)),
            "library_ms": timer(lambda: torch.matmul(x, w_deq.t())),
            "bound_ms": b_ms, "bound_by": b_by})
    # the sweep on a member's buckets: bit for bit, bitwise on repeat
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / 8192, **TRAIN_SGD)
    for n, why in zip((nb for nb, _b in fo.MEMBER_BUCKETS),
                      ("tp=2 member's largest bucket",
                       "fsdp dp=2 member's vector")):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + n % 997)
        w = torch.randn(n, device=DEVICE, generator=gen)
        g = torch.randn(n, device=DEVICE, generator=gen)
        s0 = [torch.randn(n, device=DEVICE, generator=gen)]
        err, ulps, repeat = _sweep_check(torch, fo, opt, w, g, s0, 0.1,
                                         0.0, 3)
        if err != 0.0 or not repeat:
            raise AssertionError("tp (e) sweep at %d (%s): max |kernel - "
                                 "plain| %g, repeat %s" % (n, why, err,
                                                           repeat))
        n_bytes = 5 * n * 4         # w, g, momentum in; w, momentum out
        b_ms, b_by = bound_ms(n_bytes, 0)
        rows.append({
            "name": "fused_opt", "n": n, "optimizer": "sgd_momentum",
            "what": why, "max_abs_err": err, "repeat_bitwise": repeat,
            "ms": timer(lambda: fo.sweep(opt, w, g, s0, 0.1, 0.0, 3)),
            "plain_ms": timer(lambda: fo.sweep_reference(opt, w, g, s0, 0.1,
                                                         0.0, 3)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        del w, g, s0
    torch.cuda.empty_cache()
    # MXL-K at the member shapes: clean, and the built libraries agree
    specs = [(fd.launch_spec(q_dtype="float32", kv_dtype="float32",
                             sms=sms, **fd.MEMBER_SHAPES),
              fd.launch_spec(q_dtype="float32", kv_dtype="float32",
                             sms=sms, compiled=True, **fd.MEMBER_SHAPES))]
    sh = fa.MEMBER_SHAPES
    for dt in ("float32", "bfloat16"):
        specs.append((fa.launch_spec(sh["B"], sh["H"], sh["S"], sh["S"],
                                     sh["D"], dt, sms=sms),
                      fa.launch_spec(sh["B"], sh["H"], sh["S"], sh["S"],
                                     sh["D"], dt, sms=sms, compiled=True)))
    for m, k, n in qz.MEMBER_SHAPES:
        for qd in ("int8", "fp8_e4m3"):
            specs += list(zip(qz.launch_specs(m, n, k, "float32", qd, sms),
                              qz.launch_specs(m, n, k, "float32", qd, sms,
                                              compiled=True)))
    for n, body in fo.MEMBER_BUCKETS:
        s = fo.launch_spec(n, body, "vec4")
        specs.append((s, s))
    from mxnet_tpu_torch.observability.counters import launch_limits
    lim = launch_limits(0 if DEVICE == "cuda" else None)
    for spec, built in specs:
        found = tiling.spec_findings(spec, limits=lim)
        if found or spec != built:
            raise AssertionError("tp (e) MXL-K %s: findings %s, built %s"
                                 % (spec["name"], found, spec == built))
    for r in rows:
        log("tp (e) %s at the member shape %s: err %.3g, kernel %.4f ms, "
            "plain %.4f ms, library %s ms, bound %.5f ms (%s); on %s"
            % (r["name"], {k: r[k] for k in ("B", "H", "S", "D", "M", "N",
                                             "K", "qdtype", "route", "n",
                                             "dtype") if k in r},
               r["max_abs_err"], r["ms"], r["plain_ms"],
               "%.4f" % r["library_ms"] if r["library_ms"] is not None
               else "none", r["bound_ms"], r["bound_by"], smi))
    log("tp (e) %d MXL-K launch specs at the member shapes lint clean "
        "against the card and agree with the built libraries" % len(specs))
    return {"rows": rows, "specs": len(specs)}


def phase_tp(torch, timer, seed, smi):
    """Phase 22: tensor parallelism and FSDP (the module docstring's
    (a)-(f)).  The launches of its main paths are in the result's
    ``launches``."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    params = seeded_train_params(seed)
    batch = train_batch(seed, TRAIN_BATCH)
    refs = _plain_refs(torch, params, batch, TP_STEPS)
    out = {"kernels": tp_kernel_checks(torch, timer, seed, smi)}
    # the one-device trainer's run the tp runs are set beside
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    tr1, p1, st1 = _tp_trainer(torch, mx, mx.parallel.make_mesh([ctx], dp=1),
                               params, dict(TRAIN_SGD, rescale_grad=1.0 / (
                                   TRAIN_BATCH * TRAIN["seq_len"])))
    b1 = tr1.shard_batch(batch)
    for _ in range(TP_STEPS):
        p1, st1, _a, o1 = tr1.step(p1, st1, {}, b1)
    out["lm"] = [tp_lm_gate(torch, mx, seed, smi, shape, False, refs,
                            params, batch, tp1=(o1[0], p1))
                 for shape in ({"tp": 2}, {"dp": 2, "tp": 2})]
    del tr1, p1, st1, b1, o1
    torch.cuda.empty_cache()
    out["fsdp"] = [tp_fsdp_gate(torch, mx, seed, smi, 2, False, params,
                                batch)]
    out["engine"] = tp_engine_gate(torch, mx, seed, smi)
    out["predictor"] = tp_predictor_gate(torch, mx, seed, False)
    del refs
    torch.cuda.empty_cache()
    runs = [r[d]["launches"] for r in out["lm"] for d in ("float32",
                                                          "bfloat16")
            if d in r] + [f["runs"][m]["launches"] for f in out["fsdp"]
                          for m in f["runs"]]
    eng = [out["engine"][q]["launches"] for q in ("float32", "fp8_e4m3")]
    out["launches"] = {
        "fused_opt": sum(c["fused_opt"] for c in runs),
        "flash_attention": sum(c["flash_attention"] for c in runs)
        + out["predictor"]["launches"]["flash_attention"],
        "flash_decode": sum(c["flash_decode"] for c in eng),
        "quantized_matmul": sum(c["quantized_matmul"] for c in eng),
        "quantized_matmul_by_route": {
            r: sum(c["quantized_matmul_by_route"][r] for c in eng)
            for r in ("gemv", "wgmma")},
        "flash_attention_by_dtype": {
            d: sum(c["flash_attention_by_dtype"][d] for c in runs
                   + [out["predictor"]["launches"]])
            for d in ("float32", "bfloat16")},
        "fused_opt_by_body": {}, "fused_opt_by_device": {},
        "flash_attention_by_device": {}}
    tally = out["launches"]
    for c in runs + [out["predictor"]["launches"]]:
        for kernel in ("fused_opt", "flash_attention"):
            for d, n in c.get(kernel + "_by_device", {}).items():
                got = tally[kernel + "_by_device"]
                got[d] = got.get(d, 0) + n
    for c in runs:
        for body, n in c["fused_opt_by_body"].items():
            tally["fused_opt_by_body"][body] = \
                tally["fused_opt_by_body"].get(body, 0) + n
    out["seconds"] = time.perf_counter() - t_phase
    log("tp: phase 22 %.2f s; launches %s"
        % (out["seconds"], json.dumps(out["launches"])))
    member = {}
    for r in out["kernels"]["rows"]:
        member.setdefault(r["name"], r)
    repl = {"flash_decode": "mxnet_tpu/kernels/flash_decode.py:100",
            "quantized_matmul": "mxnet_tpu/kernels/quantize.py:230",
            "flash_attention": "mxnet_tpu/parallel/ring_attention.py:128",
            "fused_opt": "mxnet_tpu/kernels/fused_opt.py:112"}
    log("tp kernels (rows 1-4 at the member shapes, their launches on "
        "these paths): " + json.dumps({"kernels": [
            {"name": name, "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/%s.cu" % name,
             "replaces": repl[name], "launches": out["launches"][name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            for name, r in member.items()]}))
    if not all(out["launches"][k] > 0 for k in repl):
        raise AssertionError("phase 22: launches %s" % out["launches"])
    os.environ.pop("MXTPU_FUSED_OPT", None)
    return out


def phase_tp_cards(torch, timer, seed, smi):
    """Phase 22 (f), on a machine with four cards (``--phases 22f``): the
    NCCL routes of tensor parallelism and FSDP.  The LM at ``tp=4`` over
    four cards (each member's 2 heads on its own card, the gathers and
    sums through ``torch.cuda.nccl``), held to phase 7's float64 witness
    with no whole weight gathered; ``fsdp=True`` at ``dp=4`` over them,
    bit for bit ZeRO-1's; each card's peak memory."""
    import mxnet_tpu_torch as mx
    if DEVICE != "cuda" or torch.cuda.device_count() < 4:
        raise AssertionError("phase 22 (f) needs four cards, found %d"
                             % torch.cuda.device_count())
    t_phase = time.perf_counter()
    params = seeded_train_params(seed)
    batch = train_batch(seed, TRAIN_BATCH)
    refs = _plain_refs(torch, params, batch, TP_STEPS)
    out = {"lm": tp_lm_gate(torch, mx, seed, smi, {"tp": 4}, True, refs,
                            params, batch, ("float32",)),
           "fsdp": tp_fsdp_gate(torch, mx, seed, smi, 4, True, params,
                                batch)}
    out["seconds"] = time.perf_counter() - t_phase
    log("tp (f): four cards %.2f s" % out["seconds"])
    return out

# ----------------------------------------------------------------------
# phase 23: sequence parallelism
# ----------------------------------------------------------------------
#: the sequence and batch of phase 23 (phase 7's widths), and 23f's
#: longer sequence at sp=4
SP_SEQ = 4096
SP_BATCH = 2
SP_SEQ_CARDS = 8192
SP_STEPS = 3
SP_TIMED_STEPS = 3
#: the float32 sp step against the one-card step from the same weights:
#: the first step's outputs (softmax probabilities) and the parameters
#: after it within PRECISION_FACTOR times the distance of the plain
#: float32 step from the plain float64 step (float32's own rounding at
#: this width; the sp and one-card steps run the same kernels and
#: products, and differ only in the order of their sums), each held to
#: the float64 step as phase 7 holds its trainer; each step's loss
#: within SP_LOSS_REL of one card's, relative
SP_LOSS_REL = 1e-5
#: the bfloat16 sp step against the one-card bfloat16 step from the
#: same weights: the first step's outputs and the parameters after it
#: within PRECISION_FACTOR times the one-card bfloat16 step's own
#: distance from the plain float64 step (each hop's o is rounded to
#: bfloat16 by the kernel before the float32 combine, where one card
#: rounds the whole row's o once: a difference of bfloat16's own
#: rounding, no more), each parameter within PRECISION_FACTOR times one
#: card's own distance on it; each step's loss within SP_BF16_LOSS_REL of
#: one card's, relative.  Two control runs with a fault of the bfloat16 ring
#: (``_RingFault``) are read beside it
SP_BF16_LOSS_REL = 1e-2
SP_PREDICT_TOL = 1e-5
#: the hop shapes timed against their plain versions: the ring's chunk
#: at phase 23's S/2 and at S/4 (23f's dp=2 x sp=2 hops are the first)
SP_HOP_SHAPES = ((SP_BATCH, 8, 2048, 64), (SP_BATCH, 8, 1024, 64))
#: the long-context example on the card (the flash kernel takes head
#: dims 32, 64 and 128: dim 64 over 2 heads)
SP_EXAMPLE_ARGS = ["--dim", "64", "--heads", "2"]


def sp_dims(seq):
    return dict(TRAIN, seq_len=seq)


def sp_params(seed, seq):
    """Phase 7's seeded weights with a position table of ``seq`` rows."""
    params = seeded_train_params(seed)
    rng = np.random.RandomState(seed + 23)
    params["pos_embed_weight"] = (rng.randn(seq, TRAIN["dim"]) * 0.02) \
        .astype(np.float32)
    return params


def sp_batch(seed, seq, batch=SP_BATCH):
    rng = np.random.RandomState(seed + 29)
    shape = (batch, seq)
    return {"data": rng.randint(0, TRAIN["vocab_size"], shape)
            .astype(np.float32),
            "softmax_label": rng.randint(0, TRAIN["vocab_size"], shape)
            .astype(np.float32)}


def _sp_reset():
    from mxnet_tpu_torch.parallel import ring_attention as ra
    _tp_reset()
    ra.reset_ring_counts()


def _sp_counts():
    from mxnet_tpu_torch.parallel import ring_attention as ra
    out = _tp_counts()
    out["ring"] = ra.ring_counts()
    return out


def _sp_trainer(torch, mx, mesh, params, seq, batch_n, compute_dtype=None,
                mirror=False):
    """ShardedTrainer over the LM at ``seq`` on ``mesh`` (``seq_axis=1``
    when it has an sp axis), from ``params``, momentum at zero."""
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.parallel.sharding import place
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (batch_n * seq),
                              **TRAIN_SGD)
    sp = mesh.shape.get("sp", 1)
    tr = mx.parallel.ShardedTrainer(
        tf.get_symbol(mirror_blocks=mirror, **sp_dims(seq)), opt, mesh,
        seq_axis=1 if sp > 1 else None, compute_dtype=compute_dtype)
    p = tr.place_params(params)
    st = {k: place(np.zeros(v.shape, np.float32), mesh,
                   tr.opt_state_sharding(k, v.shape).spec)
          for k, v in params.items()}
    if mesh.size == 1:
        st = {k: v.shards[0] for k, v in st.items()}
    return tr, p, st


def sp_run(torch, mx, mesh, params, batch, steps, dtype="float32",
           mirror=False, timed=0, keep_first=False):
    """``steps`` counted steps on ``mesh``: each step's loss (from the
    outputs, on the card), the counts, each card's peak memory over the
    first step and over all; with ``keep_first`` the first step's outputs
    and the parameters after it (on the first card); then ``timed`` steps
    each ended by a synchronize of every card."""
    seq = batch["data"].shape[1]
    cdt = None if dtype == "float32" else dtype
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    tr, p, st = _sp_trainer(torch, mx, mesh, params, seq,
                            batch["data"].shape[0], cdt, mirror)
    b = tr.shard_batch(batch)
    dev0 = mesh.devices[0]
    label = torch.from_numpy(batch["softmax_label"]).to(dev0).long() \
        .reshape(-1)
    _sync_all(torch, mesh.devices)
    _peak_reset_all(torch, mesh.devices)
    _sp_reset()
    out = {"losses": [], "mesh": dict(mesh.shape), "dtype": dtype,
           "mirror": mirror,
           "contexts": sorted({str(d) for d in mesh.devices})}
    t0 = time.perf_counter()
    for i in range(steps):
        p, st, _a, outs = tr.step(p, st, {}, b)
        o = outs[0] if isinstance(outs[0], torch.Tensor) \
            else outs[0].global_tensor(dev0)
        if not bool(torch.isfinite(o.float()).all()):
            raise AssertionError("sp %s %s: non-finite outputs"
                                 % (dict(mesh.shape), dtype))
        pick = o.float().gather(1, label[:, None]).clamp_min(1e-30)
        out["losses"].append(float(-pick.log().mean()))
        if i == 0:
            _sync_all(torch, mesh.devices)
            out["peak_bytes_first_step"] = _peaks_by_device(torch,
                                                            mesh.devices)
            if keep_first:
                out["first_outputs"] = o.float().clone()
                out["first_params"] = {
                    k: (v if isinstance(v, torch.Tensor)
                        else v.global_tensor(dev0)).detach().clone()
                    for k, v in p.items()}
        del o, outs, pick
    _sync_all(torch, mesh.devices)
    out["first_steps_s"] = time.perf_counter() - t0
    out["launches"] = _sp_counts()
    out["peak_bytes_by_device"] = _peaks_by_device(torch, mesh.devices)
    member = {k: (v if isinstance(v, torch.Tensor) else v.shards[0])
              for k, v in p.items()}
    from mxnet_tpu_torch.kernels import fused_opt as fo
    out["buckets_a_member"] = len(fo.plan_buckets(member))
    if timed:
        times = []
        for _ in range(timed):
            t1 = time.perf_counter()
            p, st, _a, _o = tr.step(p, st, {}, b)
            _sync_all(torch, mesh.devices)
            times.append(time.perf_counter() - t1)
        out["step_ms"] = float(np.median(times)) * 1e3
        out["step_ms_all"] = [t * 1e3 for t in times]
        out["tokens_per_s"] = batch["data"].size / (out["step_ms"] / 1e3)
    del tr, p, st, b
    os.environ.pop("MXTPU_FUSED_OPT", None)
    torch.cuda.empty_cache()
    return out


def _sp_launch_check(what, run, mesh, steps, layers, recompute=1):
    """Each member's ring hops (causal: its own chunk and the earlier
    ones'), the flash forward once a hop on the card, and every member's
    own sweeps."""
    sp = mesh.shape.get("sp", 1)
    n = mesh.size
    c = run["launches"]
    idx = [mesh.coords(r).get("sp", 0) for r in range(n)]
    want_hops = {r: layers * steps * recompute * (idx[r] + 1)
                 for r in range(n)} if sp > 1 else {}
    want_fa = layers * steps * recompute * (
        n // sp * sp * (sp + 1) // 2 if sp > 1 else n)
    want_fo = run["buckets_a_member"] * steps * n
    if c["ring"]["hops"] != want_hops or c["flash_attention"] != want_fa \
            or c["fused_opt"] != want_fo:
        raise AssertionError(
            "%s: launches %s, want ring hops %s, the flash forward %d times "
            "and the sweep %d (%d buckets a member)"
            % (what, json.dumps(c), want_hops, want_fa, want_fo,
               run["buckets_a_member"]))


def _sp_members(mesh, run):
    """Per member: ring hops (each one flash forward), bytes sent (and
    across cards), its card's flash and sweep launches and peak bytes."""
    c = run["launches"]
    rows = []
    for r, d in enumerate(mesh.devices):
        rows.append({
            "member": r, "coords": mesh.coords(r), "device": str(d),
            "ring_hops": c["ring"]["hops"].get(r, 0),
            "ring_skipped": c["ring"]["skipped"].get(r, 0),
            "bytes_sent": c["ring"]["bytes_sent"].get(r, 0),
            "bytes_across_cards": c["ring"]["bytes_peer"].get(r, 0),
            "card_flash_launches": c["flash_attention_by_device"].get(
                str(d), 0),
            "card_sweep_launches": c["fused_opt_by_device"].get(str(d), 0),
            "card_peak_bytes": run["peak_bytes_by_device"].get(str(d), 0)})
    return rows


def sp_refs(torch, params, batch):
    """One plain step from ``params`` in float32 and in float64 (layers
    checkpointed): ``(o32, p32, o64, p64)``."""
    o32, p32, _m = plain_train(torch, params, batch, 1, checkpoint=True)
    o64, p64, _m = plain_train(torch, _f64(torch, params), batch, 1,
                               checkpoint=True)
    return o32, p32, o64, p64


def sp_gate(torch, what, run, ref, refs, params):
    """The float32 sp run against the one-card run from the same weights
    and against the plain float64 step (``refs``): each reading
    ``[max |diff| of the first step's outputs, of the parameters after
    it]``, every one within PRECISION_FACTOR times the plain float32
    step's own distance from float64; every loss within SP_LOSS_REL of
    one card's."""
    o32, p32, o64, p64 = refs
    first = (run["first_outputs"], run["first_params"])
    one = (ref["first_outputs"], ref["first_params"])
    got = {"what": what,
           "sp_vs_one_card": _diff(torch, *first, *one, params),
           "sp_vs_plain64": _diff(torch, *first, o64, p64, params),
           "one_card_vs_plain64": _diff(torch, *one, o64, p64, params),
           "plain32_vs_plain64": _diff(torch, o32, p32, o64, p64, params),
           "largest_update": _param_err(torch, p64, p64, params)[1],
           "loss_rel": [abs(a - b) / abs(b) for a, b in
                        zip(run["losses"], ref["losses"])]}
    scale = got["plain32_vs_plain64"]
    got["ok"] = all(a <= PRECISION_FACTOR * b
                    for key in ("sp_vs_one_card", "sp_vs_plain64")
                    for a, b in zip(got[key], scale)) \
        and max(got["loss_rel"]) <= SP_LOSS_REL
    if not got["ok"]:
        raise AssertionError("%s: %s (bounds: %g times plain32_vs_plain64, "
                             "losses %g)" % (what, json.dumps(got),
                                             PRECISION_FACTOR, SP_LOSS_REL))
    return got


class _RingFault:
    """A control for (b): while active, the ring's flash module
    (``ring_attention._fa``) and its backward are stand-ins that inject
    one fault into the bfloat16 ring.  "hop dropped": every hop but a
    member's own (sp=2: member 1's hop 1, a layer) gets lse -inf, so the
    combine gives it no weight, and no gradient in the backward (the
    ring as if it skipped that hop); "lse in bfloat16": each hop's lse
    rounded to bfloat16 before the combine."""
    KINDS = ("hop dropped", "lse in bfloat16")

    def __init__(self, torch, kind):
        from mxnet_tpu_torch.parallel import ring_attention as ra
        self.torch, self.kind, self.ra = torch, kind, ra
        self.real, self.real_bwd = ra._fa, ra._flash_backward_blockwise

    def __getattr__(self, name):
        return getattr(self.real, name)

    def flash_attention_forward(self, q, k, v, causal=False, scale=None):
        o, lse = self.real.flash_attention_forward(q, k, v, causal=causal,
                                                   scale=scale)
        if self.kind == "hop dropped" and not causal:
            lse = self.torch.full_like(lse, -float("inf"))
        elif self.kind == "lse in bfloat16":
            lse = lse.to(self.torch.bfloat16).float()
        return o, lse

    def backward(self, q, k, v, o, lse, do, causal, scale, **kw):
        if self.kind == "hop dropped" and not causal:
            return tuple(self.torch.zeros(t.shape, dtype=self.torch.float32,
                                          device=t.device) for t in (q, k, v))
        return self.real_bwd(q, k, v, o, lse, do, causal, scale, **kw)

    def __enter__(self):
        self.ra._fa, self.ra._flash_backward_blockwise = self, self.backward
        return self

    def __exit__(self, *exc):
        self.ra._fa, self.ra._flash_backward_blockwise = \
            self.real, self.real_bwd


def sp_bf16_gate(torch, run, ref, controls, refs, params):
    """(b): the bfloat16 sp run against the one-card bfloat16 run from the
    same weights, each reading ``[max |diff| of the first step's outputs,
    of the parameters after it]``: the sp run's distance from one card's
    and from the plain float64 step within PRECISION_FACTOR times one
    card's own distance from float64; every loss within SP_BF16_LOSS_REL
    of one card's; and every parameter's distance from one card's within
    PRECISION_FACTOR times one card's own distance from float64 on that
    parameter (``worst_leaf``: the parameter with the largest multiple,
    and that multiple).  The controls (``_RingFault``) are read the same
    way, each with ``caught`` (a reading above its bound), and the
    dropped hop must be caught (else the bounds could not tell it)."""
    _o32, _p32, o64, p64 = refs
    one = (ref["first_outputs"], ref["first_params"])
    own = {k: float((v.double() - p64[k].double()).abs().max())
           for k, v in ref["first_params"].items()}

    def reading(r):
        first = (r["first_outputs"], r["first_params"])
        leaf = {k: float((v.double() - ref["first_params"][k].double())
                         .abs().max()) / max(own[k], 1e-30)
                for k, v in r["first_params"].items()}
        worst = max(leaf, key=leaf.get)
        return {"vs_one_card": _diff(torch, *first, *one, params),
                "vs_plain64": _diff(torch, *first, o64, p64, params),
                "worst_leaf": [worst, leaf[worst]],
                "first_loss_rel": abs(r["losses"][0] - ref["losses"][0])
                / abs(ref["losses"][0])}
    got = {"what": "sp (b) bfloat16 dp=1 x sp=2",
           "one_card_vs_plain64": _diff(torch, *one, o64, p64, params),
           "loss_rel": [abs(a - b) / abs(b) for a, b in
                        zip(run["losses"], ref["losses"])]}
    got.update(reading(run))
    got["bound"] = [PRECISION_FACTOR * b for b in got["one_card_vs_plain64"]]
    got["controls"] = {k: reading(c) for k, c in controls.items()}
    for c in got["controls"].values():
        c["caught"] = any(a > b for key in ("vs_one_card", "vs_plain64")
                          for a, b in zip(c[key], got["bound"])) \
            or c["worst_leaf"][1] > PRECISION_FACTOR
    got["ok"] = all(a <= b for key in ("vs_one_card", "vs_plain64")
                    for a, b in zip(got[key], got["bound"])) \
        and got["worst_leaf"][1] <= PRECISION_FACTOR \
        and max(got["loss_rel"]) <= SP_BF16_LOSS_REL \
        and got["controls"]["hop dropped"]["caught"]
    if not got["ok"]:
        raise AssertionError("sp (b) bfloat16: %s (bounds: %g times "
                             "one_card_vs_plain64, and a parameter's own, "
                             "losses %g; the dropped hop caught)"
                             % (json.dumps(got), PRECISION_FACTOR,
                                SP_BF16_LOSS_REL))
    return got


def _drop_tensors(run):
    for k in ("first_outputs", "first_params"):
        run.pop(k, None)
    return run


def ring_timing(torch, seed, smi):
    """The ring alone at a layer's shape, forward and backward, over two
    members on the first card (CUDA events, median of 10): what it takes
    of an sp step (times the layers), float32 and bfloat16."""
    from mxnet_tpu_torch.parallel import ring_attention as ra
    timer = Timer(torch, 10)
    rows = []
    for B, H, S, D in SP_HOP_SHAPES[:1]:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(seed + S)
            chunks = [[torch.from_numpy(rng.randn(B, H, S, D).astype(
                np.float32)).to(DEVICE, dtype).requires_grad_(True)
                for _ in range(2)] for _ in range(3)]

            def fwd_bwd():
                outs = ra.ring_attention(*chunks, causal=True)
                torch.autograd.backward(outs, [torch.ones_like(o)
                                               for o in outs])

            def fwd():
                with torch.no_grad():
                    ra.ring_attention(*chunks, causal=True)
            rows.append({"B": B, "H": H, "chunk": S, "D": D, "members": 2,
                         "dtype": str(dtype).replace("torch.", ""),
                         "forward_ms": timer(fwd),
                         "forward_backward_ms": timer(fwd_bwd)})
            log("sp ring %s: forward %.4f ms, forward and backward %.4f ms "
                "(two members on one card); on %s"
                % (json.dumps({k: rows[-1][k] for k in ("B", "H", "chunk",
                                                        "D", "dtype")}),
                   rows[-1]["forward_ms"], rows[-1]["forward_backward_ms"],
                   smi))
            del chunks
    torch.cuda.empty_cache()
    return rows


def sp_kernel_checks(torch, timer, seed, smi, params):
    """Each kernel of the sp path at the shapes the path gives it, against
    its plain version and timed: the flash forward at each hop shape
    (hop 0 causal, the other hops not), float32 (2e-5, bitwise on repeat)
    and bfloat16 (one ulp), lse within 1e-4; the sweep on a member's
    largest bucket (bit for bit, bitwise on repeat)."""
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    rng = np.random.RandomState(seed + 31)
    rows = []
    for B, H, S, D in SP_HOP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = [torch.from_numpy(rng.randn(B, H, S, D).astype(
                np.float32)).to(DEVICE, dtype) for _ in range(3)]
            for causal in (True, False):
                o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
                o2, lse2 = fa.flash_attention_forward(q, k, v,
                                                      causal=causal)
                ro, rl = fa.flash_attention_forward_reference(
                    q, k, v, causal=causal)
                torch.cuda.synchronize()
                lse_err = float((lse - rl).abs().max())
                if dtype == torch.float32:
                    err = float((o - ro).abs().max())
                    ok = err <= 2e-5 and torch.equal(o, o2) \
                        and torch.equal(lse, lse2)
                else:
                    err, ok = _bf16_close(torch, o, ro)
                if not (ok and lse_err <= 1e-4):
                    raise AssertionError(
                        "sp hop kernel %s %s causal=%s: o %g, lse %g"
                        % ((B, H, S, D), dtype, causal, err, lse_err))
                pairs = S * (S + 1) // 2 if causal else S * S
                n_ops = 4 * B * H * pairs * D
                n_bytes = 4 * B * H * S * D * q.element_size() \
                    + B * H * S * 4
                b_ms, b_by = bound_ms(n_bytes, n_ops, ops_rate(dtype))
                rows.append({
                    "name": "flash_attention", "B": B, "H": H, "S": S,
                    "D": D, "causal": causal,
                    "hop": "own chunk" if causal else "an earlier chunk",
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": err, "lse_max_abs_err": lse_err,
                    "ms": timer(lambda: fa.flash_attention_forward(
                        q, k, v, causal=causal)),
                    "plain_ms": timer(
                        lambda: fa.flash_attention_forward_reference(
                            q, k, v, causal=causal)),
                    "library_ms": timer(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=causal)),
                    "bound_ms": b_ms, "bound_by": b_by})
                del o, o2, ro, rl, lse, lse2
            del q, k, v
    torch.cuda.empty_cache()
    # the sweep on a member's largest bucket (every member holds the
    # whole LM, its pos table of SP_SEQ rows)
    member = {k: torch.empty(v.shape) for k, v in params.items()}
    n = max(sum(member[k].numel() for k in bk)
            for bk in fo.plan_buckets(member))
    del member
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (SP_BATCH * SP_SEQ),
                              **TRAIN_SGD)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 23)
    w = torch.randn(n, device=DEVICE, generator=gen)
    g = torch.randn(n, device=DEVICE, generator=gen)
    s0 = [torch.randn(n, device=DEVICE, generator=gen)]
    err, _ulps, repeat = _sweep_check(torch, fo, opt, w, g, s0, 0.1, 0.0, 3)
    if err != 0.0 or not repeat:
        raise AssertionError("sp sweep at %d: max |kernel - plain| %g, "
                             "repeat %s" % (n, err, repeat))
    b_ms, b_by = bound_ms(5 * n * 4, 0)
    lib_step, lib_name = _library_optimizer(torch, "sgd_momentum", w, g)
    rows.append({
        "name": "fused_opt", "n": n, "optimizer": "sgd_momentum",
        "what": "an sp member's largest bucket", "max_abs_err": err,
        "repeat_bitwise": repeat,
        "ms": timer(lambda: fo.sweep(opt, w, g, s0, 0.1, 0.0, 3)),
        "plain_ms": timer(lambda: fo.sweep_reference(opt, w, g, s0, 0.1,
                                                     0.0, 3)),
        "library_ms": timer(lib_step), "library": lib_name,
        "bound_ms": b_ms, "bound_by": b_by})
    del w, g, s0, lib_step
    torch.cuda.empty_cache()
    for r in rows:
        log("sp (e) %s at %s: err %.3g, kernel %.4f ms, plain %.4f ms, "
            "library %s ms, bound %.5f ms (%s); on %s"
            % (r["name"], {k: r[k] for k in ("B", "H", "S", "D", "causal",
                                             "dtype", "n") if k in r},
               r["max_abs_err"], r["ms"], r["plain_ms"],
               "%.4f" % r["library_ms"] if r["library_ms"] is not None
               else "none", r["bound_ms"], r["bound_by"], smi))
    return rows


def sp_predictor_gate(torch, mx, params, batch, devices):
    """(d) ``ShardedPredictor(seq_axis=1)`` at dp=1 x sp=2 against the
    one-card predictor from the same weights."""
    from mxnet_tpu_torch.models import transformer as tf
    sym = tf.get_symbol(**sp_dims(batch["data"].shape[1]))
    feed = {"data": batch["data"],
            "softmax_label": np.zeros_like(batch["data"])}
    one = mx.parallel.ShardedPredictor(
        sym, mx.parallel.make_mesh(devices[:1], dp=1), params).predict(feed)
    _sp_reset()
    got = mx.parallel.ShardedPredictor(
        sym, mx.parallel.make_mesh(devices, dp=1, sp=len(devices)), params,
        seq_axis=1).predict(feed)
    counts = _sp_counts()
    err = float(np.abs(got[0] - one[0]).max())
    if got[0].shape != one[0].shape or not err <= SP_PREDICT_TOL:
        raise AssertionError("sp (d) ShardedPredictor: %s against one card's "
                             "%s, max |diff| %g (bound %g)"
                             % (got[0].shape, one[0].shape, err,
                                SP_PREDICT_TOL))
    return {"max_abs_err": err, "launches": counts}


def sp_example(torch, smi):
    """The long-context example on the card (``SP_EXAMPLE_ARGS``): its
    three assertions (the sp step matches one card, the mirrored walk
    keeps fewer bytes, the loss descends)."""
    ex = _example_module("example/long-context-torch/train_lm_long.py",
                         "train_lm_long_torch")
    t0 = time.perf_counter()
    got = ex.main(SP_EXAMPLE_ARGS)
    got["seconds"] = time.perf_counter() - t0
    log("sp example/long-context-torch/train_lm_long.py %s: mesh %s, loss "
        "%.4f -> %.4f, one card's first losses %s, residual bytes %s, "
        "%.2f s; on %s"
        % (" ".join(SP_EXAMPLE_ARGS), got["mesh"], got["losses"][0],
           got["losses"][-1], ["%.4f" % x for x in got["losses_one_device"]],
           got["residual_bytes"], got["seconds"], smi))
    return got


def phase_sp(torch, timer, seed, smi):
    """Phase 23: sequence parallelism (the module docstring's (a)-(e)).
    The launches of its main paths are in the result's ``launches``."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    layers = TRAIN["num_layers"]
    params = sp_params(seed, SP_SEQ)
    batch = sp_batch(seed, SP_SEQ)
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    one = mx.parallel.make_mesh([ctx], dp=1)
    sp2 = mx.parallel.make_mesh([ctx, ctx], dp=1, sp=2)
    out = {"kernels": sp_kernel_checks(torch, timer, seed, smi, params)}
    refs = sp_refs(torch, params, batch)
    # (a) float32: the one-card witness, then sp=2
    ref = sp_run(torch, mx, one, params, batch, SP_STEPS, timed=SP_TIMED_STEPS,
                 keep_first=True)
    run = sp_run(torch, mx, sp2, params, batch, SP_STEPS, timed=SP_TIMED_STEPS,
                 keep_first=True)
    _sp_launch_check("sp (a) float32", run, sp2, SP_STEPS, layers)
    run["vs_one_card"] = sp_gate(torch, "sp (a) float32 dp=1 x sp=2", run,
                                 ref, refs, params)
    run["members"] = _sp_members(sp2, run)
    # (b) bfloat16: step times; the first step's outputs and parameters
    # against one card's, and two faulty controls beside them
    ref16 = sp_run(torch, mx, one, params, batch, SP_STEPS, "bfloat16",
                   timed=SP_TIMED_STEPS, keep_first=True)
    run16 = sp_run(torch, mx, sp2, params, batch, SP_STEPS, "bfloat16",
                   timed=SP_TIMED_STEPS, keep_first=True)
    _sp_launch_check("sp (b) bfloat16", run16, sp2, SP_STEPS, layers)
    controls = {}
    for kind in _RingFault.KINDS:
        with _RingFault(torch, kind):
            controls[kind] = sp_run(torch, mx, sp2, params, batch, 1,
                                    "bfloat16", keep_first=True)
    run16["vs_one_card"] = sp_bf16_gate(torch, run16, ref16, controls,
                                        refs, params)
    del refs, controls
    run16["members"] = _sp_members(sp2, run16)
    out["bfloat16"] = {"one_card": _drop_tensors(ref16),
                       "sp2": _drop_tensors(run16)}
    # (c) the mirrored step from the same weights: bit for bit (a)'s first
    # step, every member's segment recomputed in lockstep (its hops twice)
    mir = sp_run(torch, mx, sp2, params, batch, 1, mirror=True,
                 keep_first=True)
    _sp_launch_check("sp (c) mirrored", mir, sp2, 1, layers, recompute=2)
    same = all(torch.equal(mir["first_params"][k], run["first_params"][k])
               for k in run["first_params"]) \
        and torch.equal(mir["first_outputs"], run["first_outputs"])
    if not same:
        raise AssertionError("sp (c): the mirrored step is not the "
                             "unmirrored one bit for bit")
    mir["members"] = _sp_members(sp2, mir)
    out["float32"] = {"one_card": _drop_tensors(ref), "sp2": _drop_tensors(run)}
    out["mirrored"] = _drop_tensors(mir)
    # (d) the predictor
    out["predictor"] = sp_predictor_gate(torch, mx, params, batch,
                                         [ctx, ctx])
    for name, r in (("(a) float32 one card", ref), ("(a) float32 sp=2", run),
                    ("(c) mirrored sp=2, one step", mir),
                    ("(b) bfloat16 one card", ref16),
                    ("(b) bfloat16 sp=2", run16)):
        log("sp %s at S=%d B=%d: %s ms/step (median of %d), losses %s, "
            "first step peak bytes %s%s; on %s"
            % (name, SP_SEQ, SP_BATCH,
               "%.3f" % r["step_ms"] if "step_ms" in r else "-",
               SP_TIMED_STEPS, ["%.6f" % x for x in r["losses"]],
               json.dumps(r["peak_bytes_first_step"]),
               "; members %s" % json.dumps(r["members"])
               if "members" in r else "", smi))
    log("sp (a) against one card: %s" % json.dumps(run["vs_one_card"]))
    log("sp (b) against one card: %s" % json.dumps(run16["vs_one_card"]))
    out["ring"] = ring_timing(torch, seed, smi)
    out["example"] = sp_example(torch, smi)
    runs = [ref, run, mir, ref16, run16]
    counts = [r["launches"] for r in runs] + [out["predictor"]["launches"]]
    out["launches"] = {
        "fused_opt": sum(r["launches"]["fused_opt"] for r in runs),
        "flash_attention": sum(r["launches"]["flash_attention"]
                               for r in runs)
        + out["predictor"]["launches"]["flash_attention"],
        "flash_attention_by_dtype": {
            d: sum(c["flash_attention_by_dtype"][d] for c in counts)
            for d in ("float32", "bfloat16")},
        "fused_opt_by_body": {},
        "ring_hops": sum(sum(r["launches"]["ring"]["hops"].values())
                         for r in runs)
        + sum(out["predictor"]["launches"]["ring"]["hops"].values())}
    for c in counts:
        for body, n in c["fused_opt_by_body"].items():
            got = out["launches"]["fused_opt_by_body"]
            got[body] = got.get(body, 0) + n
    out["seconds"] = time.perf_counter() - t_phase
    log("sp: phase 23 %.2f s; launches %s"
        % (out["seconds"], json.dumps(out["launches"])))
    _sp_kernels_line("sp kernels (rows 3 and 4 at the sp path's shapes, "
                     "their launches on these paths)", out)
    if not (out["launches"]["fused_opt"] > 0
            and out["launches"]["flash_attention"] > 0):
        raise AssertionError("phase 23: launches %s" % out["launches"])
    return out


def _sp_kernels_line(what, out):
    main = {"flash_attention": next(
        r for r in out["kernels"] if r["name"] == "flash_attention"
        and r["dtype"] == "float32" and r["causal"]),
        "fused_opt": next(r for r in out["kernels"]
                          if r["name"] == "fused_opt")}
    repl = {"flash_attention": "mxnet_tpu/parallel/ring_attention.py:128",
            "fused_opt": "mxnet_tpu/kernels/fused_opt.py:112"}
    log(what + ": " + json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/%s.cu" % name,
         "replaces": repl[name], "launches": out["launches"][name],
         "max_abs_err": max(x["max_abs_err"] for x in out["kernels"]
                            if x["name"] == name
                            and x.get("dtype", "float32") == "float32"),
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in main.items()]}))


def phase_sp_cards(torch, timer, seed, smi):
    """Phase 23 (f), on a machine with four cards (``--phases 23f``): the
    LM at sp=4 over the four cards at ``SP_SEQ_CARDS``, and at dp=2 x
    sp=2 over them at ``SP_SEQ`` (k and v rotated by peer copies), each
    in float32 against the one-card step on the first card at the same
    width (``sp_gate``), with each card's peak memory beside the one
    card's."""
    import mxnet_tpu_torch as mx
    if DEVICE == "cuda" and torch.cuda.device_count() < 4:
        raise AssertionError("phase 23 (f) needs four cards, found %d"
                             % torch.cuda.device_count())
    t_phase = time.perf_counter()
    layers = TRAIN["num_layers"]
    cards = _dp_contexts(mx, 4, True)
    out = {"kernels": sp_kernel_checks(torch, timer, seed, smi,
                                       sp_params(seed, SP_SEQ))}
    runs = []
    for shape, seq in (({"sp": 4}, SP_SEQ_CARDS),
                       ({"dp": 2, "sp": 2}, SP_SEQ)):
        params = sp_params(seed, seq)
        batch = sp_batch(seed, seq)
        refs = sp_refs(torch, params, batch)
        ref = sp_run(torch, mx, mx.parallel.make_mesh(cards[:1], dp=1),
                     params, batch, SP_STEPS, timed=SP_TIMED_STEPS,
                     keep_first=True)
        mesh = mx.parallel.make_mesh(cards, **shape)
        run = sp_run(torch, mx, mesh, params, batch, SP_STEPS,
                     timed=SP_TIMED_STEPS, keep_first=True)
        what = "sp (f) %s at S=%d" % (shape, seq)
        _sp_launch_check(what, run, mesh, SP_STEPS, layers)
        run["vs_one_card"] = sp_gate(torch, what, run, ref, refs, params)
        del refs
        run["members"] = _sp_members(mesh, run)
        one_peak = ref["peak_bytes_first_step"][str(mesh.devices[0])]
        run["peak_share_of_one_card"] = {
            d: b / max(one_peak, 1)
            for d, b in run["peak_bytes_first_step"].items()}
        log("%s: %.3f ms/step against one card's %.3f; losses %s; against "
            "one card %s; first step peak bytes %s, one card's %d; members "
            "%s; on %s"
            % (what, run["step_ms"], ref["step_ms"],
               ["%.6f" % x for x in run["losses"]],
               json.dumps(run["vs_one_card"]),
               json.dumps(run["peak_bytes_first_step"]), one_peak,
               json.dumps(run["members"]), smi))
        out[json.dumps(shape)] = {"seq": seq, "one_card": _drop_tensors(ref),
                                  "run": _drop_tensors(run)}
        runs += [ref, run]
        del params, batch
    out["launches"] = {
        "fused_opt": sum(r["launches"]["fused_opt"] for r in runs),
        "flash_attention": sum(r["launches"]["flash_attention"]
                               for r in runs)}
    out["seconds"] = time.perf_counter() - t_phase
    _sp_kernels_line("sp (f) kernels (rows 3 and 4, their launches on "
                     "these paths)", out)
    log("sp (f): four cards %.2f s; launches %s"
        % (out["seconds"], json.dumps(out["launches"])))
    return out


# ----------------------------------------------------------------------
# the profiler's CUPTI records inside a long process
# ----------------------------------------------------------------------
#: profiler sessions this process has run (``trace_calls``)
PROFILER_SESSIONS = [0]
CUPTI_TRIES = 30


def cupti_long_probe(torch, smi):
    """``--phases 17cupti``, in this process after the phases listed
    before it (``--phases 13,4c,17cupti``: profiler sessions, then a
    minute of the fleet's CUDA work, the state in which CUPTI leaves the
    first kernels of a session without timestamps): ``CUPTI_TRIES``
    sessions each of five kernels (the probe's size before
    ``profiler.PROBE_KERNELS``), of the profiler's probe, and of
    ``mx.profiler`` around five kernels of the caller's.  Fails when an
    ``mx.profiler`` session lost one of the caller's kernels: its
    lead-in must take every record left without timestamps."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity
    from mxnet_tpu_torch.tools import cupti_probe as cp
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    five = [cp._session(torch, acts, 4) for _ in range(CUPTI_TRIES)]
    probe = [mx.profiler.probe_session(torch, acts)
             for _ in range(CUPTI_TRIES)]
    mx.profiler.profiler_set_config(filename=obs_dir("cupti"))
    kept = []
    for _ in range(CUPTI_TRIES):
        mx.profiler.profiler_set_state("run")
        try:
            x = torch.ones(1 << 20, device="cuda")
            for _k in range(4):
                x = x * 2
            torch.cuda.synchronize()
        finally:
            path = mx.profiler.profiler_set_state("stop")
        with open(path) as f:
            doc = json.load(f)
        os.remove(path)
        kernels = [e for e in doc.get("traceEvents", [])
                   if e.get("cat") == "kernel"]
        lead = lead_in_kernels(doc, kernels)
        kept.append([len(kernels) - lead, lead])
    got = {"earlier_profiler_sessions": PROFILER_SESSIONS[0],
           "five_kernel_sessions": five,
           "five_kernel_sessions_empty": sum(1 for t in five if t == 0),
           "probe_kernels": mx.profiler.PROBE_KERNELS,
           "probe_sessions": probe,
           "lead_in": mx.profiler.LEAD_IN,
           "profiler_sessions_caller_and_lead_in": kept,
           "seconds": time.perf_counter() - t0}
    log("cupti in this process, after %d profiler sessions: %s; on %s"
        % (PROFILER_SESSIONS[0], json.dumps(got), smi))
    if any(k[0] != 5 for k in kept):
        raise AssertionError("mx.profiler sessions lost the caller's "
                             "kernels: %s (caller's, lead-in's kept)" % kept)
    return got


#: the phases ``--phases`` runs, which read no other phase's result
ALONE = {
    "4c": lambda torch, timer, seed, smi: phase_fleet(torch, seed, smi),
    "13": phase_lstm,
    "17cupti": lambda torch, timer, seed, smi: cupti_long_probe(torch, smi),
    "19": lambda torch, timer, seed, smi: phase_analysis(torch, seed, smi),
    "20": lambda torch, timer, seed, smi: phase_moe_pipeline(torch, seed,
                                                             smi),
    "21": lambda torch, timer, seed, smi: phase_source_lints(torch, seed,
                                                             smi),
    "22": phase_tp,
    "22f": phase_tp_cards,
    "23": phase_sp,
    "23f": phase_sp_cards,
}


def run_alone(names, torch, timer, seed, smi, out_path):
    """``--phases``: each phase of ``names`` in turn, its seconds, and its
    result in ``out_path``; 0, or 1 when a phase failed."""
    phase_s, results = {}, {}
    try:
        for name in names:
            t = time.perf_counter()
            results[name] = ALONE[name](torch, timer, seed, smi)
            phase_s[name] = round(time.perf_counter() - t, 2)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log("seconds by phase (%s alone; MXTPU_BIND_VALIDATE=%s): %s"
        % (",".join(names), os.environ.get("MXTPU_BIND_VALIDATE", "warn"),
           json.dumps(phase_s)))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"phase_seconds": phase_s, "results": results}, f,
                      indent=1, default=str)
    log(smi)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per measurement (median)")
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    ap.add_argument("--phases", default=None,
                    help="run only these phases, comma-separated, of %s "
                    "(the ones that read no other phase's result), and "
                    "print no result line" % ", ".join(ALONE))
    args = ap.parse_args(argv)
    if args.phases and not set(args.phases.split(",")) <= set(ALONE):
        ap.error("--phases takes only %s" % ", ".join(ALONE))

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        print("chip_smoke: the mxnet_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    # float32 comparisons throughout: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        from mxnet_tpu_torch.kernels import _build
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log("device: %s (count %d), torch %s, CUDA %s"
            % (kind, torch.cuda.device_count(), torch.__version__,
               torch.version.cuda))
        log("nvidia-smi: %s" % smi)
        cards = nvidia_smi_cards()
        log("nvidia-smi -L: %d cards: %s" % (len(cards), " | ".join(cards)))
        peak_card = load_peaks(kind)
        log("peaks (observability.counters.PEAKS[%r]): %g B/s HBM, %g "
            "float32 and %g bfloat16 operations/s"
            % (peak_card, HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S))
        t0 = time.perf_counter()
        info = _build.build_all()
        log("build: %.2f s wall; %s" % (
            time.perf_counter() - t0,
            ", ".join("%s %.2f s" % (n, i["seconds"])
                      for n, i in sorted(info.items()))))
        for name, i in sorted(info.items()):
            for fn, regs, st, ld, smem in ptxas_functions(i["log"]):
                log("  ptxas %s: %s: %d registers, %d bytes spill stores, "
                    "%d bytes spill loads, %d bytes smem"
                    % (name, fn, regs, st, ld, smem))
            for line in i["log"].splitlines():
                if "Performance Loss" in line:
                    log("  ptxas %s: %s" % (name, line.strip()))
        check_no_spills(info)
        torch.manual_seed(args.seed)
        timer = Timer(torch, args.iters, LEAD_CYCLES)
        if args.phases:
            return run_alone(args.phases.split(","), torch, timer,
                             args.seed, smi, args.out)
        phase_s = {}

        def run(name, fn, *a):
            t = time.perf_counter()
            out = fn(*a)
            phase_s[name] = round(time.perf_counter() - t, 2)
            return out
        fd_rows = run("2", phase_flash_decode, torch, timer, args.seed)
        qmm_rows = run("3", phase_quantized_matmul, torch, timer, args.seed)
        eng = run("4", phase_engine, torch, args.seed)
        serve = run("4b", phase_serve, torch, args.seed, smi,
                    eng["float32_tokens"])
        fleet = run("4c", phase_fleet, torch, args.seed, smi)
        fa_rows = run("5", phase_flash_attention, torch, timer, args.seed)
        fo_rows, bucket_sizes = run("6", phase_fused_opt, torch, timer,
                                    args.seed)
        train = run("7", phase_train, torch, args.seed, smi)
        imperative = run("8", phase_imperative, torch, args.seed)
        rtc_res = run("8 rtc", phase_rtc_kernels, torch, timer, args.seed)
        resnet = run("9", phase_resnet, torch, args.seed, smi)
        module = run("10", phase_module, torch, args.seed, smi)
        feed = run("11", phase_feed, torch, args.seed, smi, resnet, module)
        zoo = run("12", phase_zoo, torch, args.seed, smi, resnet)
        lstm = run("13", phase_lstm, torch, timer, args.seed, smi)
        rcnn = run("14", phase_rcnn, torch, timer, args.seed, smi)
        dp = run("15", phase_dp, torch, args.seed, smi)
        capi = run("16", phase_capi, torch, args.seed, smi)
        res = run("17", phase_resilience, torch, timer, args.seed, smi)
        obs = run("18", phase_observability, torch, args.seed, smi)
        ana = run("19", phase_analysis, torch, args.seed, smi,
                  {"lm": train, "resnet50": resnet})
        moe = run("20", phase_moe_pipeline, torch, args.seed, smi)
        src = run("21", phase_source_lints, torch, args.seed, smi)
        tpr = run("22", phase_tp, torch, timer, args.seed, smi)
        spr = run("23", phase_sp, torch, timer, args.seed, smi)
        log("seconds by phase: %s" % json.dumps(phase_s))
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    # one row per kernel: flash-decode at the decode batch of 8 (float32),
    # the int8 matmul at the decode lm_head shape (M=8, K=512, N=8192)
    fd_main = next(r for r in fd_rows if r["B"] == 8
                   and r["dtype"] == "float32" and r["kv_dtype"] == "float32")
    qmm_main = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                    == (8, 512, 8192) and r["dtype"] == "float32"
                    and r["qdtype"] == "int8")
    # the int8 matmul's prefill row: the wgmma body at the largest prompt
    # bucket (M=960, the lm_head shape, float32 x)
    qmm_prefill = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                       == (960, 512, 8192) and r["dtype"] == "float32"
                       and r["qdtype"] == "int8")
    # its fp8 e4m3 rows at the same shapes
    qmm_fp8 = {r["M"]: r for r in qmm_rows if r["qdtype"] == "fp8_e4m3"}
    # the generation paths: phase 4's two engines and the serve phase
    launches = {k: eng["float32"]["launches"][k] + eng["int8"]["launches"][k]
                + serve["launches"][k]
                for k in ("flash_decode", "quantized_matmul")}
    launches.update({k: train["float32"]["launches"][k]
                     + train["bfloat16"]["launches"][k]
                     for k in ("flash_attention", "fused_opt")})
    # the image-classification path (phase 9) launches the sweep alone:
    # its main path is the batch-64 SGD runs, float32 and bfloat16; the
    # gates' runs (deterministic cuDNN: SGD, NAG, RMSProp) and the
    # batch-8 witness are counted apart
    resnet_main = sum(resnet[d]["launches"]["fused_opt"]
                      for d in ("float32", "bfloat16"))
    launches["fused_opt"] += resnet_main
    # the image feed (phase 11): ShardedTrainer over prefetch_feed, float32
    # and bfloat16, is a main path; its prefetch on/off gate is apart
    feed_main = sum(feed["trainer"][d]["launches"]["fused_opt"]
                    for d in ("float32", "bfloat16"))
    launches["fused_opt"] += feed_main
    # the model zoo (phase 12): Inception-BN through ShardedTrainer,
    # float32 and bfloat16, is its main path; the witness, the mirroring
    # gates and the other four networks are counted apart
    zoo_main = sum(zoo["main"][d]["launches"]["fused_opt"]
                   for d in ("float32", "bfloat16"))
    launches["fused_opt"] += zoo_main
    # the bucketing LSTM (phase 13): its BucketingModule.fit launches no
    # hand kernel (the fused step is leafwise, as in the JAX package);
    # ShardedTrainer on the 40-bucket graph is the path through the sweep
    lstm_main = lstm["trainer"]["kernel"]["launches"]["fused_opt"]
    launches["fused_opt"] += lstm_main
    # data parallelism (phase 15): ShardedTrainer's dp steps (ResNet-50
    # with and without ZeRO-1, the gate steps; the LM's dp step), on one
    # card and, with several, across them; counted by device
    dp_runs = [dp[k]["gate"][z]["launches"] for k in ("trainer_one_card",
                                                      "trainer_cards")
               if k in dp for z in ("false", "true")]
    dp_lm = [dp[k]["launches"] for k in ("lm_one_card", "lm_cards")
             if k in dp]
    dp_main = sum(c["fused_opt"] for c in dp_runs + dp_lm)
    dp_flash = sum(c["flash_attention"] for c in dp_lm)
    launches["fused_opt"] += dp_main
    launches["flash_attention"] += dp_flash
    # the C ABI (phase 16): the LM's steps driven by train_lm, counted
    # by the C process's own wrappers
    capi_flash = capi["lm"]["c_launches"]["flash_attention"]
    launches["flash_attention"] += capi_flash
    # resilience (phase 17): the sentinel LM's 6 steps (every sweep gated)
    # and the LM's 2 steps through the body generated from a user's
    # update_fn
    from mxnet_tpu_torch.kernels.fused_opt import GENERATED as fo_generated
    res_counts = [res["sentinel"]["launches"],
                  res["generated"]["trainer_launches"]]
    res_sweeps = sum(c["fused_opt"] for c in res_counts)
    res_flash = sum(c["flash_attention"] for c in res_counts)
    launches["fused_opt"] += res_sweeps
    launches["flash_attention"] += res_flash
    # observability (phase 18): the LM's telemetry steps, float32 and
    # bfloat16, and the fp8 LM served under the sanitizers
    obs_counts = [obs[d]["launches"] for d in ("float32", "bfloat16")]
    obs_sweeps = sum(c["fused_opt"] for c in obs_counts)
    obs_flash = sum(c["flash_attention"] for c in obs_counts)
    launches["fused_opt"] += obs_sweeps
    launches["flash_attention"] += obs_flash
    for k in ("flash_decode", "quantized_matmul"):
        launches[k] += obs["serve"]["launches"][k]
    # MoE and pipeline parallelism (phase 20): the MoE LM's steps (one
    # card, ep, dp) and the pipeline's flash forwards
    moe_sweeps = moe["launches"]["fused_opt"]
    moe_flash = moe["launches"]["flash_attention"]
    launches["fused_opt"] += moe_sweeps
    launches["flash_attention"] += moe_flash
    # tensor parallelism and FSDP (phase 22): each member's launches of
    # the tp and FSDP LM steps, the tp engine and the tp predictor
    tp_l = tpr["launches"]
    for k in ("fused_opt", "flash_attention", "flash_decode",
              "quantized_matmul"):
        launches[k] += tp_l[k]
    # sequence parallelism (phase 23, on the first card): the LM's one-card
    # and sp=2 steps (float32, mirrored, bfloat16) and the sp predictor
    sp_l = spr["launches"]
    for k in ("fused_opt", "flash_attention"):
        launches[k] += sp_l[k]
    by_device = {"fused_opt": {}, "flash_attention": {}}
    first_card = "cuda:0" if DEVICE == "cuda" else "cpu"
    by_device["fused_opt"][first_card] = launches["fused_opt"] - dp_main \
        - moe_sweeps - tp_l["fused_opt"]
    by_device["flash_attention"][first_card] = \
        launches["flash_attention"] - dp_flash - moe_flash \
        - tp_l["flash_attention"]
    for c in dp_runs + dp_lm + [moe["launches"], tp_l]:
        for kernel, key in (("fused_opt", "fused_opt_by_device"),
                            ("flash_attention",
                             "flash_attention_by_device")):
            for d, k in c[key].items():
                by_device[kernel][d] = by_device[kernel].get(d, 0) + k
    sweep_routes = {}
    for c in dp_runs + dp_lm:
        for d, routes in c["fused_opt_by_route"].items():
            for r, k in routes.items():
                sweep_routes.setdefault(d, {})
                sweep_routes[d][r] = sweep_routes[d].get(r, 0) + k
    resnet_other = {"resnet50_gate_" + n: g["launches"]
                    for n, g in resnet["gates"].items()}
    resnet_other["resnet50_witness_batch8"] = resnet["witness"]["launches"]
    resnet_other["resnet50_image_feed_gate"] = \
        feed["trainer"]["gate"]["launches"]
    resnet_other["inception_bn_witness_batch2"] = zoo["witness"]["launches"]
    for k in ("trainer", "remat"):
        resnet_other["inception_bn_mirror_gate_" + k] = \
            zoo["mirror"][k]["launches"]
    for name, r in zoo["others"].items():
        resnet_other[name + "_training"] = r["launches"]
        resnet_other[name + "_sweep_gate"] = r["gate"]["launches"]
    transformer_sweeps = train["float32"]["launches"]["fused_opt"] \
        + train["bfloat16"]["launches"]["fused_opt"]
    transformer_flash = train["float32"]["launches"]["flash_attention"] \
        + train["bfloat16"]["launches"]["flash_attention"]
    # by body, over every path in launches_by_path
    sweep_by_body = {1: transformer_sweeps}
    for c in [resnet[d]["launches"] for d in ("float32", "bfloat16")] \
            + [feed["trainer"][d]["launches"]
               for d in ("float32", "bfloat16")] \
            + [zoo["main"][d]["launches"] for d in ("float32", "bfloat16")] \
            + [lstm["trainer"]["kernel"]["launches"]] \
            + dp_runs + dp_lm + res_counts + obs_counts \
            + [moe["launches"], tp_l, sp_l] + list(resnet_other.values()):
        for body, n in c["fused_opt_by_body"].items():
            sweep_by_body[body] = sweep_by_body.get(body, 0) + n
    # flash attention at the training shape (causal, float32); the sweep
    # at the model's largest bucket (SGD with momentum, as trained)
    fa_main = next(r for r in fa_rows if r["S"] == TRAIN["seq_len"]
                   and r["D"] == TRAIN["dim"] // TRAIN["num_heads"]
                   and r["causal"] and r["dtype"] == "float32")
    fa_bf16 = next(r for r in fa_rows if r["S"] == TRAIN["seq_len"]
                   and r["D"] == TRAIN["dim"] // TRAIN["num_heads"]
                   and r["causal"] and r["dtype"] == "bfloat16")
    fo_main = next(r for r in fo_rows if r["n"] == max(bucket_sizes)
                   and r["optimizer"] == "sgd_momentum")
    kernels = []
    for name, src, repl, main_row, rows in (
            ("flash_decode", "mxnet_tpu_torch/csrc/flash_decode.cu",
             "mxnet_tpu/kernels/flash_decode.py:100", fd_main, fd_rows),
            ("quantized_matmul", "mxnet_tpu_torch/csrc/quantized_matmul.cu",
             "mxnet_tpu/kernels/quantize.py:230", qmm_main, qmm_rows),
            ("flash_attention", "mxnet_tpu_torch/csrc/flash_attention.cu",
             "mxnet_tpu/parallel/ring_attention.py:128", fa_main, fa_rows),
            ("fused_opt", "mxnet_tpu_torch/csrc/fused_opt.cu",
             "mxnet_tpu/kernels/fused_opt.py:112", fo_main, fo_rows)):
        f32_rows = [r for r in rows if r.get("dtype", "float32") == "float32"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": {k: main_row[k] for k in ("B", "M", "K", "N", "H", "S",
                                               "D", "causal", "n",
                                               "optimizer", "dtype")
                      if k in main_row}})
    # the bodies beside the main rows: the flash forward's bfloat16
    # (wgmma) row at the training shape, the int8 matmul's prefill
    # (wgmma) row; and the launches of the main paths by body
    timing_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "max_abs_err")
    for k in kernels:
        if k["name"] == "fused_opt":
            k["launches_by_body"] = {str(b): n for b, n
                                     in sorted(sweep_by_body.items())}
            k["bodies"] = {
                r["optimizer"]: dict({t: r[t] for t in timing_keys},
                                     body=r["body"], n=r["n"],
                                     library=r["library"])
                for r in fo_rows if r["n"] == SWEEP_N}
            k["launches_by_path"] = dict(
                {"transformer_training": transformer_sweeps,
                 "resnet50_training": resnet_main,
                 "resnet50_image_feed": feed_main,
                 "inception_bn_training": zoo_main,
                 "lstm_lm_training": lstm_main,
                 "data_parallel_training": dp_main},
                **{p: c["fused_opt"] for p, c in resnet_other.items()})
            k["launches_by_device"] = by_device["fused_opt"]
            k["data_parallel_routes_by_device"] = sweep_routes
            k["launches_gated"] = res["sentinel"]["launches"][
                "fused_opt_gated"]
            k["launches_generated"] = sweep_by_body.get(fo_generated, 0)
            k["launches_by_path"]["transformer_sentinel"] = \
                res["sentinel"]["launches"]["fused_opt"]
            k["launches_by_path"]["transformer_generated_body"] = \
                res["generated"]["trainer_launches"]["fused_opt"]
            k["launches_by_path"]["transformer_telemetry"] = obs_sweeps
            k["launches_by_path"]["moe_lm_training"] = moe_sweeps
            k["launches_by_path"]["tp_and_fsdp_lm_training"] = \
                tp_l["fused_opt"]
            k["launches_by_path"]["sp_lm_training"] = sp_l["fused_opt"]
            gen = next(r for r in res["generated"]["rows"]
                       if r["n"] == SWEEP_N)
            k["generated"] = dict(
                {t: gen[t] for t in timing_keys}, n=gen["n"],
                ms_gated=gen["ms_gated"], library=gen["library"],
                compile_s=res["generated"]["compile_s"],
                ops=res["generated"]["ops"])
        elif k["name"] == "flash_attention":
            k["bfloat16"] = dict({t: fa_bf16[t] for t in timing_keys},
                                 shape={"B": fa_bf16["B"], "H": fa_bf16["H"],
                                        "S": fa_bf16["S"], "D": fa_bf16["D"],
                                        "causal": True})
            k["launches_by_dtype"] = {
                d: train["float32"]["flash_attention_by_dtype"][d]
                + train["bfloat16"]["flash_attention_by_dtype"][d]
                for d in ("float32", "bfloat16")}
            k["launches_by_dtype"]["float32"] += dp_flash + capi_flash \
                + res_flash
            for d in ("float32", "bfloat16"):
                k["launches_by_dtype"][d] += obs[d]["launches"][
                    "flash_attention"]
            moe_bf16 = moe["lm"]["bfloat16"]["launches"]["flash_attention"]
            k["launches_by_dtype"]["bfloat16"] += moe_bf16
            k["launches_by_dtype"]["float32"] += moe_flash - moe_bf16
            for d in ("float32", "bfloat16"):
                k["launches_by_dtype"][d] += \
                    tp_l["flash_attention_by_dtype"][d] \
                    + sp_l["flash_attention_by_dtype"][d]
            k["launches_by_device"] = by_device["flash_attention"]
            k["launches_by_path"] = {
                "transformer_training": transformer_flash,
                "data_parallel_training": dp_flash,
                "c_abi_lm_training": capi_flash,
                "transformer_sentinel":
                    res["sentinel"]["launches"]["flash_attention"],
                "transformer_generated_body":
                    res["generated"]["trainer_launches"][
                        "flash_attention"],
                "transformer_telemetry": obs_flash,
                "moe_lm_and_pipeline": moe_flash,
                "tp_lm_and_predictor": tp_l["flash_attention"],
                "sp_lm_and_predictor": sp_l["flash_attention"]}
            k["sp_ring_hops"] = sp_l["ring_hops"]
            k["c_abi_twin_launches"] = capi["lm"]["twin_flash_launches"]
        elif k["name"] == "quantized_matmul":
            k["prefill"] = dict({t: qmm_prefill[t] for t in timing_keys},
                                shape={"M": 960, "K": 512, "N": 8192,
                                       "dtype": "float32"})
            k["qdtypes"] = ["int8", "fp8_e4m3"]
            k["fp8_e4m3"] = {
                "M%d" % m: dict({t: r[t] for t in timing_keys},
                                route=r["route"])
                for m, r in sorted(qmm_fp8.items())}
            k["launches_by_route"] = {
                r: eng["int8"]["quantized_matmul_by_route"][r]
                + serve["launches"]["quantized_matmul_by_route"][r]
                + obs["serve"]["launches"]["quantized_matmul_by_route"][r]
                + tp_l["quantized_matmul_by_route"][r]
                for r in ("gemv", "wgmma")}
            k["launches_by_qdtype"] = {
                "int8": eng["int8"]["launches"]["quantized_matmul"],
                "fp8_e4m3": serve["launches"]["quantized_matmul_by_qdtype"][
                    "fp8_e4m3"] + obs["serve"]["launches"][
                    "quantized_matmul"] + tp_l["quantized_matmul"]}
            k["launches_by_path"] = {
                "served_under_sanitizers":
                    obs["serve"]["launches"]["quantized_matmul"],
                "tp_engine": tp_l["quantized_matmul"]}
        elif k["name"] == "flash_decode":
            k["launches_by_path"] = {
                "served_under_sanitizers":
                    obs["serve"]["launches"]["flash_decode"],
                "tp_engine": tp_l["flash_decode"]}
    # Rtc: kernel (b), 2.5*x + y at 2^24 float32 (example/rtc's kernel);
    # its launches are the imperative path's (phase 8) and the C ABI's
    # rtc_saxpy push (phase 16, counted by the C process)
    rtc_main = next(r for r in rtc_res["rows"] if r["kernel"] == "saxpy"
                    and r["n"] == RTC_TIMED_N and not r["offset"])
    kernels.append({
        "name": "rtc", "route": "cuda", "compiler": "nvrtc",
        "source": "mxnet_tpu_torch/kernels/rtc_kernels.py",
        "replaces": "mxnet_tpu/rtc.py:79",
        "launches": imperative["launches"]
        + capi["rtc"]["c_launches"]["rtc"],
        "launches_by_path": {
            "imperative": imperative["launches"],
            "c_abi_rtc_saxpy": capi["rtc"]["c_launches"]["rtc"]},
        "max_abs_err": max([r["max_abs_err"] for r in rtc_res["rows"]
                            if r["dtype"] == "float32"]
                           + [capi["rtc"]["max_abs_err"]]),
        "ms": rtc_main["ms"], "plain_ms": rtc_main["plain_ms"],
        "bound_ms": rtc_main["bound_ms"], "bound_by": rtc_main["bound_by"],
        "library_ms": rtc_main["library_ms"],
        "shape": {"kernel": "saxpy", "n": RTC_TIMED_N, "dtype": "float32"}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "build": {n: i["seconds"] for n, i in info.items()},
                       "flash_decode": fd_rows, "quantized_matmul": qmm_rows,
                       "engine": eng, "serve": serve, "fleet": fleet,
                       "flash_attention": fa_rows,
                       "fused_opt": fo_rows, "train": train,
                       "resnet": resnet, "module": module, "feed": feed,
                       "zoo": zoo, "lstm": lstm, "rcnn": rcnn, "dp": dp,
                       "capi": capi, "resilience": res,
                       "observability": obs, "analysis": ana,
                       "moe_pipeline": moe, "source_lints": src,
                       "tp": tpr, "sp": spr,
                       "phase_seconds": phase_s,
                       "imperative": imperative, "rtc": rtc_res,
                       "kernels": kernels}, f, indent=1)
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
