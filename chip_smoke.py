#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python chip_smoke.py

Phases, each fatal on failure (an uncaught exception exits non-zero):

1. Device: torch's device name and count, and nvidia-smi's name and
   power limit.
2. Build: every kernel of the serving and training paths is compiled from
   paddle_tpu_torch/kernels/csrc with nvcc for sm_90a (one nvcc per
   source, all started together); prints the build seconds and ptxas's
   registers, shared memory and spills per kernel, and fails where ptxas
   serializes a kernel's wgmma (C7518).
3. Kernel vs plain: each kernel's wrapper on CUDA tensors against its plain
   torch version on the same inputs, at the paths' shapes and at ragged
   ones, with the tolerance printed beside the error.  The flash cases
   include a peaked softmax (q and k x 4), Tq = Tk = 65 and a [B, T, H, d]
   view 1 float off 16-byte alignment (4-byte staging); the LM-head
   cases a ragged N and V, an odd D (8-byte staging), int32 labels, N, D
   and V below one tile, and a peaked softmax (x x 12, |logit| up to
   about 80); the block cases a ragged T, head dim 128, an odd D and F
   (D 201, E 128, F 333: 8-byte staging) and W1 x 8 (large W2 sums over
   K 2048).  The flash backward, both LM-head kernels and the block must
   also give the same bits twice, and the [B, H, T, d] flash calls the
   head-major call's bits on the same data.  The bf16 kernels of the AMP
   path (head-major flash forward and backward, LM head forward and
   backward) are held to their plain versions in bf16 on the f32 cases
   (the path shape, ragged T, head dim 128, a token-strided q, a peaked
   softmax; the LM head's ragged, odd and peaked cases), at BF16_RTOL of
   max |plain| on bf16 outputs (for flash, of each head's 64-token tile's
   max |plain|) and the f32 tolerances on lse and loss; two calls of each
   must give the same bits.  The bf16 flash forward and backward run
   each case (FLASH_HDT_BF16_CASES, FLASH_BHTD_BF16_CASES) once on the
   path its operands choose (flash_attention.fwd_bf16_path and
   bwd_bf16_path: wgmma where TMA can describe the operands, else sync),
   checked by their path counters, then on every path the operands admit,
   forced; the cases include T a multiple of 8 that is not one of 128
   (T 520) on the wgmma path, and a do in the other orientation than q, k
   and v (feature stride 1 beside head-major q, k, v; token stride 1
   beside [B, T, H, d] views).  The flash compare must refuse a planted
   fault (the last row tile skipping the first key tile), against the
   plain version and the wgmma kernels' o and dq.  The bf16
   LM-head forward and backward run each case (HEAD_BF16_CASES) on the
   path their operands choose (lm_head.bf16_path, one condition for
   both: wgmma where TMA can describe x and W, sync for V 1001,
   D 201 and D 12), checked by their path counters, and each wgmma case
   again forced onto the sync path, each path twice for the same bits;
   the forward's wgmma schedule as lm_head.fwd_bf16_plan and
   fwd_bf16_segments give it (what the CPU tests hold) must be the
   library's own on every case (fwd_plan_drift); one more case is aligned and a multiple of no tile (N 3001, D 264, V
   4104, chunk 1000), and one has D 1024, where the wgmma forward streams
   x.  The compare must refuse two planted faults by more than 4x their
   tolerance: a forward merge without one segment's state of the wgmma
   split (segmented_fwd), and a backward whose dlogits miss the onehot
   term in one vocab tile.  The bf16
   kernels of the AMP fuse_block path: the [B, H, T, d] flash forward and
   backward on the block's [B, T, H, d] views (contiguous and 2 bytes off
   16-byte alignment, a ragged T, head dim 128, Tq != Tk, a peaked
   softmax, T 520) at BF16_RTOL by tile; forward and backward, on every
   path both the view and its head-major copy take, the head-major call's
   bits on the same data, and where their own choices cross paths (the
   copy's T not a multiple of 8), the two held to each other at BF16_RTOL
   (and FA_TOL on lse); the bf16
   block on the path shape, a ragged T, head dim 128, D 264 / E 192 /
   F 520 (multiples of 8, not of 128), an odd D and F (bf16 vectors
   there) and W1 x 8, at BLOCK_BF16_RTOL of max |plain|, each case with
   its four GEMMs on the path its operands choose (fused_block.
   block_gemm_path: wgmma for all but D 201 / F 333), checked by the path
   counters, and every wgmma case again forced onto the sync path; the
   GEMMs forced onto wgmma at D 201 must raise before any launch with no
   counter moved, and the wgmma schedule as fused_block.block_gemm_plan
   gives it (what the CPU tests hold) must be the library's own on every
   case (block_plan_drift).
   Both give the same bits twice and refuse a planted fault (the flash
   skipping a key tile, the block without b1).  The layer norm on bf16
   rows (LN_BF16_CASES: the training shape, N 4095 and N 1, D 264, 520,
   768 (BERT-base's rows and its MLM head's), 2048 and 8192, rows of
   mean 64) on the path its operands choose
   (layer_norm.bf16_path: v16 for all of these), checked by the path
   counters, and again forced onto the scalar path on the same inputs: y
   within LN_BF16_TOL, mean and rstd within LN_TOL, two calls of each
   path the same bits, the share of y entries bit-equal between the
   paths logged; the v16 grid as layer_norm.bf16_plan gives it must be
   the library's (ln_plan_drift); D 201 and an x 2 bytes off 16-byte
   alignment take the scalar path with no v16 launch, and v16 forced on
   them raises before any launch with no counter moved.
4. Serve: the flagship causal LM at full width (d512/L6/H8/d_inner 2048/
   V32000, T 512, random weights from a fixed seed) is initialised by
   Executor(CUDAPlace(0)).run(startup), saved with save_inference_model,
   loaded by create_predictor(AnalysisConfig(dir)) and answers requests of
   batch 1, 4 and 8 with ragged, right-padded prompts; prints each prompt's
   greedy next token.  The kernels' launch counters are zeroed just before
   and read just after: each request must launch 13 layer-norm and 6 flash
   kernels, and no other.  Request 1 is answered again by a CPU predictor
   (use_gpu=False: the plain versions) on the same dir, and the logits at
   each prompt's last position must agree.  Each batch's latency is
   printed with the logits readback (into pinned host memory) beside the
   pageable copy's p50 measured before (PAGEABLE_READBACK_MS).
4b. Decode: the unfused flagship (build_lm_net(fused_attention=False),
   program T 256, the same widths, random weights from SEED) served token
   by token as bench.py's serving row runs it: DecodeEngine(max_batch 8,
   max_len 512, prompt buckets 64/128/256) whose prepare() must capture a
   CUDA graph per bucket and one for the decode step (the capture seconds
   logged).  Four prompts of 5, 64, 100 and 200 tokens, one per slot,
   decode greedily; slot 1 is retired after 3 steps and backfilled with a
   37-token prompt while the others go on.  Every sequence's first 8
   tokens (4 for the retired one) are held to the full-recompute forward
   of the same program through Executor(CUDAPlace(0)): the engine's token
   must be the oracle's argmax, or the oracle's top-2 margin must be under
   DECODE_RTOL x max |logit| (then that sequence's compare stops, at most
   one may), and the engine's logits row must be within DECODE_RTOL x max
   |logit| of the oracle's; the positions compared, the largest gap
   between the engine's logit of its token and the oracle's top logit and
   the largest row error are logged.  A control engine with TF32 matmuls
   must fail that row check at every position it is held to (its prompts'
   prefills and first steps), so the check would catch an engine that
   computes below f32.  The kernels' counters are zeroed just before the
   engine's own work (the checked decode, the timings, the load) and read
   just after it: the engine launches no kernel of this repo.  They are
   zeroed again for the oracle, which must show its 13 layer norms a
   forward ("decode_oracle").  The engine's timings: the decode-step
   replay p50 (host clock, synchronized), the whole decode_step() p50 and
   the prefill p50 per bucket, beside the step's byte bound (the weights,
   the K/V positions the timed steps' lengths need and the logits; the
   whole padded slab's bound is logged beside it); then the
   ContinuousBatcher under loadgen.run_loadgen(inproc_submit(batcher),
   8 streams x 4 requests, 32 new tokens, prompts of 4-128 tokens): every
   request accounted for and ok, none given up and serving_compiles_total
   unmoved; generated tokens/s, TTFT and per-token p50/p99, peak device
   memory and the slabs' bytes, beside nvidia-smi's line.  One replay is
   traced at the end (trace_decode: device busy time and launches; the
   trace must show cuBLAS products and no kernel of this repo).
5. Train: the same LM's training program (build_lm_net(fused_head=True) +
   optimizer.Adam(1e-4).minimize) at full width takes 5 Adam steps at
   batch 32 on one fixed batch through Executor(CUDAPlace(0)).run; every
   loss must be finite and the last below the first.  The counters are
   zeroed just before and read just after: each step must launch 13
   layer-norm, 6 flash forward, 6 flash backward and 1 LM-head forward
   kernels, and one LM-head backward per 4096-token chunk.  Then one step
   of the same program at L 2, batch 2 runs on the card and on a CPUPlace
   executor (the plain versions) from the same weights: the losses must
   agree; the relu units whose pre-activation took the other branch on
   the card are listed beside the gradient entries that differ; then the
   CPU step runs again taking the card's relu branches, and every @GRAD
   entry must agree.
5b. Train with fuse_block: the same, for the program that
   transpiler.maybe_fuse rewrites (FLAGS_fuse_block on, before minimize;
   6 fused_transformer_block ops, no fused_mha, mul or relu).  Each step
   must launch 6 block forwards, 6 [B, H, T, d] flash forwards and 6
   flash backwards (the blocks' recompute backward), 1 layer norm, 1
   LM-head forward and one LM-head backward per chunk, and no head-major
   flash (the block's C entry runs its flash and layer norms itself).
   The L 2 match replays the card's relu masks inside the block's
   composition (the relu is not an op there).
5c. Train with AMP: the program of phase 5 built and run under
   FLAGS_amp_bf16 (bf16 activations, f32 master params), 10 Adam steps at
   batch 32.  Each step must launch the bf16 flash forward 6 times and
   its backward 6 times, the bf16 LM-head forward once and its backward
   once per chunk, 13 layer norms (the first on the f32 embedding sum,
   12 on bf16 residual sums, all 12 on the v16 path by the counters) and
   no f32 flash or LM-head kernel; every
   bf16 flash forward and backward and LM-head forward and backward on
   the wgmma path (their path counters), with the strides of q, k, v and
   do that autograd hands the flash backward logged.  The L 2
   match runs under the flag too, at AMP_STEP_LOSS_RTOL and
   AMP_STEP_GRAD_RTOL.
5d. Train fuse_block under AMP: the program of phase 5b built and run
   under FLAGS_amp_bf16, 10 Adam steps at batch 32.  Each step must launch
   the bf16 block kernel 6 times, the bf16 [B, H, T, d] flash forward and
   backward 6 times each (the blocks' recompute), 1 layer norm (on the
   last block's bf16 output, on the v16 path), the bf16 LM-head forward
   once and its
   backward once per chunk, and no f32 block, flash or LM-head kernel and
   no head-major flash; the recompute's flash forward and backward, the
   block kernel's own flash launch and four GEMMs and the LM head's forward
   and backward on the wgmma path (their path counters; the flash
   backward's operand strides logged).  The
   L 2 match replays the card's relu masks inside the blocks, at the AMP
   tolerances.
5e. Training loops: (a) run_steps on bench.py's AMP row (the program of
   phase 5c, dropout 0): two scopes from one saved state, one taking
   LOOP_STEPS (8) Executor.run calls on 8 batches, the other one
   Executor.run_steps(8, per_step_feeds=("tokens", "labels")) over the
   same batches; the stacked losses and every persistable at the end
   must be bit-equal (or, only where one step run twice from the saved
   state shows the card's step is not deterministic, within
   tests/test_torch_train.py's tolerances; the log says which held), and
   every launch counter over the run_steps call must read 8 times one
   run's.  Then run_steps is timed as bench.py's _time_steps times it (a
   warm-up call of 20 steps, the best of 3 calls, per step), beside the
   run loop's p50.  (b) the Trainer on the unfused flagship
   (fused_attention=False, fused_head=True, f32) with dropout 0.1,
   accumulate_steps 2, prefetch_depth 2, Adam 1e-4: one epoch of 8
   micro-batches of 16 x 512.  Every EndStepEvent loss finite; the params
   bit-equal to the previous micro-step's after micro-steps 1, 3, 5, 7 and
   all moved after 2, 4, 6, 8; the accumulation counter 1, 0, 1, 0, ...;
   the embedding dropout's Mask (train_func's one metric, [16, 512, 512])
   keeping between 0.899 and 0.901 of its entries at micro-step 0; 13 f32
   layer norms, 1 LM-head forward and 2 LM-head backwards (two 4096-token
   chunks) a micro-step and no other kernel.  The micro-step p50, the
   data wait p50 and the peak memory are logged beside nvidia-smi's line.
5f. Verify (slice 17): from phase 4 on, FLAGS_verify_program is error, so
   the Executor verifies every program it runs (each key once), under the
   flags it runs with, before any op runs; the phase logs each
   verification's finding counts and host time, verifies the Predictor's
   program at its request's shapes, and fails on any error finding.  A
   shape fault planted in bench.py's AMP row (the first FFN weight
   swapped for a [D, D] matrix) must raise ProgramVerificationError with
   no launch counter moved and torch.cuda.memory_allocated() unchanged.
   On the AMP row (batch 32): ByGlobalNorm(1e30) with L2Decay(0.0) must
   be bit-equal to the row without them over 3 steps (losses and every
   persistable); ByGlobalNorm at half of step 1's global norm with
   L2Decay(1e-4) must give grads whose global norm, less the decay term
   and taken in f64 from the fetched grads, is the clip norm at rtol
   1e-5, and a finite loss over 10 steps.  The step p50 with and without
   clip and decay, and the run p50 with verify_program off and warn, four
   windows each in turns (a b b a a b b a), and the gate's host time a
   run on a kept verdict, are logged beside nvidia-smi's line.
5g. ResNet-50 (slice 18), bench.py's bench_resnet50 and
   bench_resnet50_infer: (a) models.resnet.build_train_net at 3x224x224,
   class_dim 1000, Momentum(0.1, 0.9), batch 8, 3 steps on one batch on
   the card; before each, the card's state goes to a CPUPlace executor
   that takes the same step, and a control with cudnn.allow_tf32 on
   takes it on the card; card vs CPU within RESNET_BOUNDS (the loss,
   every velocity, every param's and running stat's change), the control
   outside one of them on every step; the card's own step under a 1e-6
   change of the input is logged beside them.  The trained program's
   Predictor (probabilities and logits, batch 16) on the card against
   the CPU Predictor at RESNET_PRED_RTOL.  (b) no scope tensor carries
   autograd state; the peak after step 10 of (c) equals step 3's within
   RESNET_PEAK_SLACK.  (c) batch 64, 10 steps on one batch, f32 and
   under AMP: step p50, img/s, first step, peak memory; the AMP losses
   within RESNET_AMP_LOSS_RTOL of the f32 ones over the first
   RESNET_AMP_TRACK steps, and falling over 10 steps at RESNET_FALL_LR;
   one AMP step traced by kernel class (cuDNN convolutions, the GEMMs,
   reductions, elementwise), with the batch_norm and momentum lowerings'
   kernels attributed through record_function ranges; no kernel of this
   repo.  (d) the is_test build saved and served by the Predictor at
   batch 16, f32 and AMP: request p50 and img/s.  Every new path
   ("resnet_train", "resnet_train_amp", "resnet_train_amp_fall",
   "resnet_serve", "resnet_serve_amp") launches none of this repo's
   kernels, by the counters, and appears in the JSON line's
   launches_by_path.
5h. Transformer-base NMT (slice 19), bench.py's bench_nmt: models.
   transformer.build_train_net at V 8000, L 6, H 8, d 512, d_inner 2048,
   dropout 0, label smoothing 0.1, S 64, Adam(1e-4), batch 256; and BERT-
   base pretraining (models.bert.build_pretrain_net, BertConfig() at its
   defaults: V 30522, hidden 768, 12 layers, 12 heads, 3072, dropout 0.1)
   at seq 128, batch 32, 20 predictions a sequence, Adam(1e-4).  (a) For
   each, one f32 step at batch 8 with ragged masks (src_mask, tgt_mask or
   input_mask zeros, zero mask_weight rows; BERT's dropout 0) from the
   card's startup state, on the card, on a CPUPlace executor and on the
   card with TF32 matmuls: the loss's relative error and every @GRAD's
   ||card - CPU|| / ||CPU|| within XFMR_LOSS_RTOL and XFMR_GRAD_RTOL, the
   control outside one of them.  (b) Each training row on the card, f32
   and under AMP: XFMR_WARMUP + XFMR_RUNS runs on one batch with the
   counters zeroed just before and read just after (the layer norms the
   program's layer_norm ops and their input dtypes give, every bf16 one
   on the v16 path, no other kernel of this repo), the AMP loss falling
   over the first XFMR_RUNS runs; the first run, the run p50, peak
   memory, and time_run_steps as bench.py's _time_steps times the row,
   with tokens/s (NMT: src + tgt) and BERT's sequences/s.  (c) bench_nmt's
   is_test build saved and served by the Predictor at batch 8 with ragged
   masks: the card's logits against the CPU Predictor's at XFMR_PRED_RTOL
   of max |logit|, the request p50 and its layer-norm launches.  (d) the
   layer norm at D 768, N 4096 timed f32 and on bf16 rows beside its
   plain version, F.layer_norm and its byte bound.  The AMP step of each
   model is traced at the end of the smoke (kernel classes, idle share,
   the layer norms by kernel).  Paths "nmt_train", "nmt_train_amp",
   "bert_train", "bert_train_amp" and "nmt_serve" in launches_by_path.
5i. DeepFM CTR (slice 20), bench.py's bench_deepfm: models.deepfm.
   build_train_net(DeepFMConfig()) (F 39, two tables of 1,000,001 rows,
   K 10, towers 400-400-400) with Adagrad(0.01) at batch 512.  (a) One
   f32 step at batch 64 with an id planted in several fields and rows,
   from the card's startup state, on the card, on a CPUPlace executor
   taking the card's relu branches and on the card with TF32 matmuls:
   the loss and every @GRAD within DEEPFM_LOSS_RTOL and
   DEEPFM_GRAD_RTOL, the control outside one of them, and every table
   row no id named (with its moment) bit-equal to its start on both.
   (b) Every optimizer class (DEEPFM_OPTIMIZERS), the first tower at
   ParamAttr.learning_rate 0.5: 3 steps card vs CPU at the same bounds.
   (c) ModelAverage: apply after startup a no-op, after 5 steps the mean
   of the post-step params, restore bit-equal.  (d) The training row f32
   and under AMP, and the hash-bucketed sparse build under AMP on raw
   ids over [0, 2^40) (5 % negated): DEEPFM_WARMUP + DEEPFM_RUNS runs with
   the counters zeroed just before and read just after (no kernel of
   this repo), the AMP loss falling; the first run, run p50, peak memory
   and time_run_steps with examples/s.  (e) The sparse build's buckets on
   the card against sparse.hash_bucket.  (f) The f32 row's program saved
   with prob as the fetch and served by the Predictor at batch 512: card
   vs CPU probabilities, metrics.Auc, the request p50.  The AMP step is
   traced at the end of the smoke by kernel class (embedding gather and
   backward, cuBLAS, the lookups' and Adagrad's kernels by their op
   ranges).  Paths "deepfm_train", "deepfm_train_amp",
   "deepfm_sparse_train_amp" and "deepfm_serve" in launches_by_path.
5j. AlexNet, GoogLeNet, SE-ResNeXt-50 and the stacked LSTM (slice 21),
   bench.py's bench_alexnet and bench_googlenet (_bench_conv_train:
   3x224x224, class_dim 1000, batch 128, Momentum(0.01, 0.9); GoogLeNet
   with its three heads), SE-ResNeXt-50 at bench_resnet50's batch 64 and
   Momentum(0.1, 0.9), and bench_lstm (T 100, V 30000, emb 512, h 512, 2
   layers, batch 64, Adam(1e-3), make_fake_batch); and BASELINE config 1,
   LeNet through the Trainer.  (a) For each of the five programs (LeNet's
   with SGD(0.1) at batch 64) one f32 step at a small check batch, dropout
   0, from the card's startup state: on the card, on the card with TF32
   convolutions and matmuls (the control), and on a CPUPlace executor
   taking the card's relu branches and the control's: the loss and every
   @GRAD within CNL_LOSS_RTOL and CNL_GRAD_RTOL, the control outside one.
   (b) Each training row f32 and under AMP: CNL_WARMUP + CNL_RUNS runs
   with the counters zeroed around them (no kernel of this repo), the run
   p50, peak memory and time_run_steps with images or sequences a second;
   the AMP losses within CNL_AMP_LOSS_RTOL of the f32 ones over the first
   CNL_AMP_TRACK runs, the LSTM's AMP loss falling.  (c) LeNet
   (models.lenet.build_train_net()) through Trainer(place=CUDAPlace(0)),
   SGD(0.1), 3 epochs of 24 MNIST-shaped batches of 64 (mnist_like), the
   loss falling; save_params, a second Trainer with param_path, and
   test() of both equal.  One step of each row is traced at the end of
   the smoke by kernel class with the device's idle share.  Paths
   "<model>_train", "<model>_train_amp" and "lenet_trainer" in
   launches_by_path.
5k. The GRU machine-translation model and its beam decode, and the five
   book models (slice 22): models.machine_translation.build_train_net at
   the reference fluid benchmark's widths (embedding and GRU 512, V
   30000), source and target length 50, batch 32, Adam(1e-3), on
   make_copy_task_batch.  (a) One f32 step at batch 4 from the card's
   startup state on the card, on a CPUPlace executor and on the card with
   TF32 matmuls: the loss and every @GRAD within MT_LOSS_RTOL and
   MT_GRAD_RTOL, the control outside one.  (b) The training row f32 and
   under AMP: MT_WARMUP + MT_RUNS runs with the counters zeroed around
   them (no kernel of this repo), the loss falling, the AMP losses within
   MT_AMP_LOSS_RTOL of the f32 ones over the first MT_AMP_TRACK runs; run
   p50, peak memory, time_run_steps and tokens/s (source + target).
   (c) build_decode_net (beam 3, max_len 250) built after the f32 row's
   training, saved by save_inference_model and served by the Predictor at
   batch 32: request p50, hypothesis tokens/s, no kernel of this repo;
   every SentenceScores entry within MT_SCORE_RTOL of its hypothesis's
   log-prob up to and including its first end_id, from a teacher-forced
   forward of build_train_net (target length 250) on the CPU over the
   card's own SentenceIds; the hypotheses equal to a CPU Predictor's
   decode token for token are counted.  (d) Each book model (fit_a_line,
   word2vec at dict 2048, recommender_system, rnn_encoder_decoder,
   db_lstm at the builders' defaults) with Adam(1e-3) at batch 32: one
   f32 step card vs CPU within BOOK_LOSS_RTOL and BOOK_GRAD_RTOL
   (db_lstm's Viterbi path equal), then time_run_steps with examples/s.
   The phase's seconds are logged, and the whole smoke's at its end.
5l. In-graph lr schedules, While and Switch, and the rest of the conv
   family (slice 23).  (a) bench_nmt with Adam's lr noam_decay(512,
   4000): the card-vs-CPU step at batch 8 with its TF32 control (as
   phase 5h's, the schedule's counter in the state); run_steps of
   SCHED_NMT_STEPS steps f32 and under AMP, each step's lr within
   SCHED_LR_RTOL of the closed form, the counter SCHED_NMT_STEPS after
   it, the layer norms the only kernel of this repo; time_run_steps
   beside phase 5h's constant-lr row.  (b) bench_resnet50 with
   Momentum's lr piecewise_decay([2, 4], [0.1, 0.01, 0.001]): steps 1
   and 2 (each side of the first boundary) at batch 8, card vs CPU
   within RESNET_BOUNDS, a cuDNN TF32 control outside one; then
   SCHED_RESNET_STEPS steps at batch 64, every lr against the closed
   form.  (c) Each CONV_FAMILY op at the widths of the public model that
   uses it (DCGAN's conv2d_transpose, C3D's conv3d and its pools,
   conv3d_transpose, ResNet's stem pool with index, group_norm at G 32,
   instance_norm at style-transfer widths): forward and backward ms f32
   and under AMP; on the first CONV_CHECK_SAMPLES samples the card
   against the CPU within CONV_RTOL (AMP: CONV_AMP_STEPS bf16 steps), the
   Masks equal, each convolution's TF32 control outside CONV_RTOL.  (d)
   JAX's While and Switch programs on the card, and a While of
   WHILE_ITERS [WHILE_N, WHILE_N] matmuls against the body unrolled:
   the same bits, WHILE_ITERS + 1 condition reads, host syncs and wall
   time of each.  At the end of the smoke, with the other traces: the
   schedule's two ops alone (launches, no host sync) and each conv-family
   op's forward and backward by kernel class (cuDNN, pooling,
   reductions, eager elementwise).  Paths "nmt_noam_train(_amp)",
   "resnet_piecewise_train" and "conv_family" in launches_by_path.
   One MT step (f32, AMP) and one decode request are traced at the end
   of the smoke by kernel class with the device's idle share.  Paths
   "mt_train", "mt_train_amp", "mt_decode" and "book_<model>" in
   launches_by_path.
5m. int8 and fp8: (1) the flagship's products (QUANT_LM_PRODUCTS,
   N 16384) for int8, e4m3 and e5m2: the codes of the same inputs equal
   on the card and the CPU; the library product's accumulators
   (torch._int_mm, torch._scaled_mm with use_fast_accum=False, a bf16
   torch.mm with f32 output) equal to the plain version on the card (f64
   for int8) and to the CPU's on QUANT_CPU_ROWS rows (int8), or within
   FP8_RTOL; e4m3's use_fast_accum=True error against f64 logged; the
   low_precision_matmul forward and STE backward in f32 and under AMP,
   card rows against the CPU's; the product, the quantize pass and the
   bf16 and f32 products timed beside the product's bound.  (2)
   quantized_conv2d's im2col lowering at ResNet-50's stem, a 3x3 and a
   1x1 s2 downsample (batch 16), and grouped, dilated and depthwise
   cases: the accumulators of QUANT_CHECK_SAMPLES samples against
   F.conv2d of the same codes on the CPU (f64 for int8: equal), the
   products a call, the time beside cuDNN's f32 and bf16 convolutions.
   (3) bench_lm_int8: phase 5c's AMP program with quantize_dtype int8
   and without it in one process: one step of each from the same state
   (losses within LM_INT8_LOSS_RTOL), this repo's kernel launches equal on
   both, one _int_mm a mul (12 a step), no host sync added (the syncs'
   sites logged), peak memory, run_steps in turns (AMP, int8, int8, AMP)
   with tokens/s; then one f32 int8 step at L LM_INT8_CHECK_LAYERS, batch
   LM_INT8_CHECK_BATCH on the card and the CPU: the code flips and relu
   flips counted, the CPU step again on the card's codes and relu
   branches held as phase 5's match.  (4) bench_resnet50_infer_int8: the
   is_test ResNet-50 pruned, training_transpile, freeze_program to int8
   (53 quantized_conv2d, 1 quantized_matmul) on the executor path at
   batch 16: p50 and bench.py's window with img/s, 54 _int_mm a batch, no
   kernel of this repo; its logits on 2 samples card vs CPU, the code
   flips counted and the CPU run on the card's codes within
   QUANT_PRED_RTOL; the model saved and served by the Predictor, equal
   to the executor bit for bit.  (5) QAT on bench_resnet50 (batch 64,
   Momentum(0.1, 0.9), moving-average activations): QAT_STEPS steps,
   every scale moving every step, the p50 beside phase 5g's f32 row; the
   for_test clone frozen to e4m3 and served at batch 16 as (4), held at
   QAT_FP8_PRED_RTOL.  (6) fused_multihead_attention at FMHA's widths,
   forward and backward, f32 and AMP, card vs CPU within FMHA_RTOL, one
   flash forward and backward a run.  The bench_lm_int8 step and the int8
   ResNet-50 batch are traced at the end of the smoke by kernel class
   (int8 GEMMs, bf16 / f32 GEMMs, copies and casts, reductions,
   elementwise, this repo's kernels), with the device ms inside
   quantize_array and the low-precision forwards.  Paths
   "lm_int8_train", "resnet_int8_serve", "resnet_qat_train",
   "fused_multihead_attention" and "fused_multihead_attention_amp" in
   launches_by_path.
5n. The dense op plane (slice 25): (a) bench_deepfm's program (phase
   5i's configuration: 39 fields, two tables of 1,000,001 rows, K 10,
   towers 400-400-400, batch 512, Adagrad(0.01)) with layers.auc(prob,
   label) appended trains DENSE_AUC_STEPS steps through Executor.run,
   fetching the AUC and the probabilities; the card's StatPos/StatNeg
   must equal metrics.Auc fed the same fetched probabilities and labels
   bit for bit, and the AUC its eval within DENSE_AUC_ATOL; run_steps is
   timed with and without the auc op, f32 and under AMP, in turns, with
   the host syncs of the fewer of two runs without the op and of the
   most of three with it (the op must add none), and at the end of the
   smoke one step of each is traced for the kernel launches and the
   device busy time the op adds.  (b) Every op the plane added
   (_dense_sweep_cases) runs through the Executor on the card and on the
   CPU at DENSE_N x DENSE_D f32 operands or the like, with the gradient
   of each differentiable op through append_backward: movement, index and
   integer ops bit for bit (ties planted for arg_max, arg_min, argsort
   and maxout, repeated ids for the overwriting scatter), the rest within
   DENSE_RTOL of max |CPU|; the random ops by their moments on the card
   (_dense_random_cases).  Any miss fails the phase.
5o. The sequence, LoD-array, CTC and sampling planes (slice 26): (a) a
   CTC acoustic model built from the port's public layers in the shape of
   DeepSpeech2 (ctc_build: 161 spectrogram bins a frame, fc 512 relu,
   row_conv with 2 future frames, layers.lstm at hidden 512, 2 layers,
   bidirectional (the cudnn_lstm op), fc 29 (28 characters and the blank
   0), warpctc with input lengths in 150-200 and label lengths in 20-40,
   mean; ctc_greedy_decoder and edit_distance ignoring the blank fetched)
   at T 200, Adam(1e-4).  One f32 step at CTC_CHECK_BATCH from the card's
   startup state on the card, on the card with TF32 matmuls (the control)
   and on a CPUPlace executor taking the card's relu branches and the
   control's: the loss and every @GRAD within CTC_LOSS_RTOL and
   CTC_GRAD_RTOL, the control outside one; the greedy ids equal to the
   CPU's save where the CPU's top-2 margin is within CTC_TIE_RTOL of max
   |logit| (named in the log), the decoded ids and edit distances equal
   on every other row.  Then batch 32, CTC_STEPS Executor.run steps on
   one batch (the loss falls) and time_run_steps with utterances/s and
   frames/s, the counters zeroed around them (no kernel of this repo).
   (b) Every op the plane added (_sequence_sweep_cases) through the
   Executor on the card and on the CPU at a few MB, with the gradient of
   each differentiable op through append_backward: movement, index and
   integer ops (the LoD arrays, unique, hash, ctc_align, chunk_eval,
   sequence_enumerate, split_ids among them) bit for bit, the rest
   within DENSE_RTOL of max |CPU| (the scatters with repeated ids among
   them); clamped array indices (7 and -1 on a length-3 array), wrapped
   and dropped scatter ids planted; nce on the card and on the CPU fed
   the card's draw, the draw uniform within SEQ_NCE_SPREAD / N; random
   crop the slice of X at offsets in range; the same draw twice under
   one seed.  Any miss fails the phase.  At the end of the smoke one CTC
   step is traced by kernel class with the device's idle share, the
   forward launches inside cudnn_lstm's and warpctc's ranges and each op
   alone, forward and backward, at the step's shapes (trace_ctc).
6. Timings: each kernel's device time at its paths' shapes (CUDA events
   around calls queued behind a sleep kernel, so the host's launch cost
   is left out and printed apart), its bound, the plain version and one
   PyTorch library call as a yardstick (the port never calls it); request
   latency p50 and tokens/s per batch size; training step p50 and
   tokens/s at batch 32, both programs; peak device memory; the
   [B, H, T, d] flash on the block's [B, T, H, d] views beside the
   contiguous and head-major calls; every kernel runs on the tensor cores
   but layer norm, so their bound is the 3xTF32 one (also under
   tc_bound_ms), with the f32 bound without tensor cores beside it
   (simt_bound_ms) and the achieved TFLOP/s.  Timed calls are cold: each
   takes its activations from a rotation of input sets larger than the
   L2 (the block also warm, warm_ms); then torch.profiler traces of one
   batch-8 request and one step of each training program split by kernel
   class, with the device's busy share (the fuse_block step must show 4
   block GEMM launches a layer), one block forward kernel by kernel, and
   the names of the kernels SDPA launches (its library yardstick).  The
   four bf16 kernels and layer norm on bf16 rows are timed the same way at
   the training shapes, beside the plain versions and the library calls
   in bf16 (SDPA; matmul + F.cross_entropy and its autograd), with their
   bound at the bf16 tensor-core peak (989 TFLOP/s) or the bytes; the
   layer norm on bf16 rows on its chosen (v16) path and forced onto the
   scalar path in turns, each with its host enqueue; the AMP step is
   traced by kernel class, its 12 layer norms on bf16 rows all v16
   kernels and its one on f32 rows the scalar kernel.  The AMP
   fuse_block path's three bf16 kernels likewise: the flash on the block's
   views beside the contiguous and head-major calls, the bf16 block beside
   torch.nn.TransformerEncoderLayer in bf16, its GEMMs on the path they
   choose and forced onto sync in turns (chosen, sync, sync, chosen) with
   each path's host enqueue; the bf16 block's launches one by one
   (BLOCK_BF16_CHAIN_LAUNCHES) on each GEMM path, with each GEMM's TFLOP/s
   and, on the wgmma path, its tiles and CTAs as the library plans them,
   in the log (the smoke fails unless the four GEMMs are the wgmma kernel
   on the wgmma path and the mma.sync one on the sync path); the AMP
   fuse_block step traced by kernel class (its 13 layer norms all the v16
   kernel; the bf16 block's two, LN1 and LN2, listed by name in
   block_breakdown, must be v16 launches).  The bf16 flash forward and
   backward (head-major, and on the block's views) and the bf16 LM-head
   forward and backward name the
   path they took (from the counters of the timed calls) and time the
   sync path on the same inputs beside it, with their host enqueue time;
   the bf16 block's flash launch must be the wgmma kernel;
   flash_bwd_breakdown lists the bf16 flash backward's two launches
   (dk/dv, dq) on both paths with their TFLOP/s; head_breakdown lists the
   bf16 LM-head forward's two launches and the backward's, one by one, on
   both paths with their TFLOP/s, and the smoke fails unless the forward
   makes HEAD_FWD_KERNELS on each path (the wgmma kernels on the wgmma
   path) and the backward's wgmma path head_bwd_kernels() a chunk.  The
   traces of short calls (a few launches each: the schedule, the conv
   family's cases, the bench_deepfm steps with and without the auc op,
   and the LM-head, flash-backward, block and SDPA breakdowns) run in a
   fresh process of their own (short_traces) with the same checks, and
   each recorded cycle holds PROFILE_PAD_S of idle host time at both
   ends.
7. A JSON line with every kernel's numbers at the training step's shapes
   (layer norm and flash forward also at the serving shape, under
   "serve"; launches on its training path, and on every path under
   "launches_by_path", the decode engine's under "decode" and its oracle's
   under "decode_oracle", phase 5e's run_steps call's under
   "train_run_steps" and its Trainer's under "trainer", phase 5g's under
   "resnet_*", all 0, phase 5h's under "nmt_*" and "bert_*", layer norms
   only, phase 5i's under "deepfm_*", all 0, phase 5j's under
   "alexnet_*", "googlenet_*", "se_resnext_*", "stacked_lstm_*" and
   "lenet_trainer", all 0, phase 5k's under "mt_*" and "book_*", all 0,
   phase 5l's under "nmt_noam_*" (layer norms only),
   "resnet_piecewise_train" and "conv_family", all 0, phase 5m's under
   "lm_int8_train" (the AMP row's), "resnet_int8_serve" and
   "resnet_qat_train" (0) and "fused_multihead_attention(_amp)",
   phase 5n's under "dense_plane", phase 5o's under "ctc_speech_train"
   and "sequence_plane", all 0;
   layer_norm's D-768 times under "d768"; the bf16 kernels' launches are the AMP step's;
   lm_head_fwd_bf16, lm_head_bwd_bf16 and transformer_block_bf16 also
   carry their path and both paths' breakdowns; layer_norm's "bf16" entry
   is the v16 path's, with the scalar path's times and the AMP programs'
   launches by path beside them),
   nvidia-smi's line, and as the last line {"ok": true, "device": {...}}.

TF32 is switched off for matmuls and cuDNN: every f32 product of torch here
is full f32, so the card and the CPU compute the same math.  (The flash,
LM-head and block kernels take their products on the TF32 tensor cores in
three passes, f32-grade by construction; their bf16 twins take one bf16
product per product with f32 accumulation.)  The script exits
non-zero and prints no result when no CUDA device is visible, or when the
paddle_tpu_torch package is not beside it.
"""
import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 20261016
DEVICE = "cuda"
# the flagship LM of README "Performance" at full width; depth is not cut
FLAGSHIP = dict(src_vocab_size=32000, max_length=512, n_layer=6, n_head=8,
                d_model=512, d_inner=2048, dropout=0.0)
SERVE_T = 512
BATCHES = (1, 4, 8)
TRAIN_T = 512
TRAIN_BATCH = 32               # bench.py's flagship training batch
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
HEAD_CHUNK = 4096              # layers.fused_lm_head_loss's chunk_size
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 without tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
SLEEP_CYCLES = 40_000_000      # about 20 ms at the H100's 1.98 GHz boost
ROTATE = 4                     # input sets a timed call rotates over (cold)
FAULT_TILE = 12800             # the LM head's planted fault: its vocab tile

# the decode phase: bench.py's serving row (bench_lm_serving) at its card
# shapes — the flagship widths, max_len 512, a program T of 256, prompt
# buckets (64, 128, 256), 8 slots, 32 new tokens, 8 closed-loop streams of
# 4 requests with prompts of 4-128 tokens
DECODE_T = 256
DECODE_MAX_LEN = 512
DECODE_BUCKETS = (64, 128, 256)
DECODE_SLOTS = 8
DECODE_PROMPTS = (5, 64, 100, 200)   # one per slot, held to the oracle
DECODE_BACKFILL = 37                 # the prompt backfilled into slot 1
DECODE_NEW = 8                       # greedy tokens a sequence compared
DECODE_LOAD = dict(streams=8, requests_per_stream=4, max_new_tokens=32,
                   prompt_len_range=(4, 128))
DECODE_TIMED = 50                    # timed replays / steps / prefills
# the logits readback's p50 with a pageable copy (the Predictor's before
# it copied into pinned memory), NVIDIA H100 80GB HBM3 at 700.00 W
PAGEABLE_READBACK_MS = {1: 35.99, 4: 122.02, 8: 259.16}

LN_TOL = 1e-4        # abs, f32: the same math summed in another order
LN_BF16_TOL = 2e-2   # abs on bf16 y of magnitude < 4: one bf16 rounding
FA_TOL = 2e-4        # abs on o and lse, f32
LOGIT_RTOL = 1e-3    # of max |logit|: GPU vs CPU, same f32 math
# of max |logit|: the decode engine's logits rows against the Executor's
# full forward, both f32 on the card.  Between the f32 engine's largest
# reading and a TF32 control engine's smallest (PERF.md, PR 15)
DECODE_RTOL = 3e-5
BWD_RTOL = 1e-4      # of max |plain| (flash: over dq, dk, dv) on the
                     # backward's outputs: f32 sums over thousands of
                     # products in another order
HEAD_TOL = 2e-4      # abs on the LM head's loss and lse (|lse| ~ 10), f32
STEP_LOSS_RTOL = 1e-5  # training loss, card vs CPU
# per @GRAD entry, of the @GRAD's max |CPU| entry, card vs a CPU step that
# takes the card's relu branches: f32 sums in another order
STEP_GRAD_RTOL = 1e-3
BLOCK_RTOL = 1e-4    # of max |plain| on the block's output: f32 sums of
                     # 512-2048 products per projection in another order
# bf16 kernels against their plain versions in bf16, of max |plain| on
# every bf16 output (flash: of each head's 64-token tile's max |plain|,
# tile_rel_err): 4 units of bf16 roundoff (2^-8).  Both round at the
# same places, but an f32 value near a rounding boundary may round one
# step (2 units) the other way, and the flash kernels round p against the
# running max of their key tile, not the row's max (another unit); never
# looser than the reference's bf16 tolerance 2e-2
BF16_RTOL = 4 * 2.0 ** -8
# the bf16 block kernel against its plain version, of max |plain| on the
# output: BF16_RTOL.  The two round at the same places but the attention:
# the kernel rounds p against its key tile's running max and divides after
# the product (flash), the plain version rounds the normalized weights
BLOCK_BF16_RTOL = BF16_RTOL
# the L 2 AMP step, card vs CPU: the loss, a mean over 1024 tokens of bf16
# activations whose last bits may round apart; each @GRAD after the relu
# replay, of its max |CPU| entry: the reference's bf16 tolerance
AMP_STEP_LOSS_RTOL = 1e-3
AMP_STEP_GRAD_RTOL = 2e-2

# the training loops (phase_train_loops): run_steps on bench.py's AMP row
# against as many sequential runs, then timed as bench.py's _time_steps
# times it (bench.py:139-172: a warm-up call, the best of the calls after
# it over their steps); the Trainer on the unfused flagship with dropout,
# gradient accumulation and device prefetch
LOOP_STEPS = 8
LOOP_TIMED_STEPS = 20
LOOP_TIMED_CALLS = 3
TRAINER_MICRO_BATCH = 16
TRAINER_MICRO_STEPS = 8
TRAINER_ACCUMULATE = 2
TRAINER_PREFETCH = 2
TRAINER_DROPOUT = 0.1
# the embedding dropout's keep share at micro-step 0: 0.9 within about 6.8
# binomial standard deviations of 16 x 512 x 512 entries (1.46e-4)
KEEP_SHARE = (0.899, 0.901)

# the bf16 LM head's compare cases (N, D, V, chunk, ignored labels, scale
# of x, label dtype, path): the f32 LM head's, one aligned case that is a
# multiple of no tile and one with D above the wgmma forward's x-resident
# limit; V 1001, D 201 and D 12 take the sync paths (element copies), the
# rest the wgmma ones, which each case also runs forced onto the sync path
HEAD_BF16_CASES = [
    (TRAIN_BATCH * TRAIN_T, 512, 32000, HEAD_CHUNK, 0, 1, "int64", "train"),
    (1000, 512, 1001, 256, 37, 1, "int64", "ragged"),
    (777, 201, 3000, 300, 11, 1, "int32", "ragged"),
    (5, 12, 100, HEAD_CHUNK, 1, 1, "int64", "ragged"),
    (2048, 512, 32000, 1024, 5, 12, "int64", "ragged"),
    (3001, 264, 4104, 1000, 23, 1, "int64", "ragged"),
    (1000, 1024, 4104, 256, 9, 1, "int64", "ragged"),
]

# name -> (module of paddle_tpu_torch.kernels whose wrapper of that name
# launches the kernel and counts it, CUDA source, TPU kernel it replaces)
KERNELS = {
    "layer_norm": ("layer_norm", "layer_norm.cu",
                   "paddle_tpu/kernels/layer_norm.py:47"),
    "flash_attention_hdt": ("flash_attention", "flash_attention_hdt.cu",
                            "paddle_tpu/kernels/flash_attention.py:685"),
    "flash_attention_hdt_bwd": ("flash_attention",
                                "flash_attention_hdt_bwd.cu",
                                "paddle_tpu/kernels/flash_attention.py:794"),
    "lm_head_fwd": ("lm_head", "lm_head.cu",
                    "paddle_tpu/kernels/lm_head.py:144"),
    "lm_head_bwd": ("lm_head", "lm_head.cu",
                    "paddle_tpu/kernels/lm_head.py:215"),
    # the fuse-block path: the same two flash sources called through
    # [B, H, T, d] strides, and the block forward
    "flash_attention": ("flash_attention", "flash_attention_hdt.cu",
                        "paddle_tpu/kernels/flash_attention.py:157"),
    "flash_attention_bwd": ("flash_attention",
                            "flash_attention_hdt_bwd.cu",
                            "paddle_tpu/kernels/flash_attention.py:346"),
    "transformer_block": ("fused_block", "fused_block.cu",
                          "paddle_tpu/kernels/fused_block.py:235"),
    # the AMP path (FLAGS_amp_bf16): the bf16 kernels of the head-major
    # flash and the LM head
    "flash_attention_hdt_bf16": ("flash_attention", "flash_attention_bf16.cu",
                                 "paddle_tpu/kernels/flash_attention.py:685"),
    "flash_attention_hdt_bwd_bf16": (
        "flash_attention", "flash_attention_bf16.cu",
        "paddle_tpu/kernels/flash_attention.py:794"),
    "lm_head_fwd_bf16": ("lm_head", "lm_head_bf16.cu",
                         "paddle_tpu/kernels/lm_head.py:144"),
    "lm_head_bwd_bf16": ("lm_head", "lm_head_bf16.cu",
                         "paddle_tpu/kernels/lm_head.py:215"),
    # the AMP fuse-block path: the bf16 flash through [B, H, T, d] strides
    # and the bf16 block forward
    "flash_attention_bf16": ("flash_attention", "flash_attention_bf16.cu",
                             "paddle_tpu/kernels/flash_attention.py:157"),
    "flash_attention_bwd_bf16": (
        "flash_attention", "flash_attention_bf16.cu",
        "paddle_tpu/kernels/flash_attention.py:346"),
    "transformer_block_bf16": ("fused_block", "fused_block_bf16.cu",
                               "paddle_tpu/kernels/fused_block.py:235"),
}
# the kernels that only the fuse_block training program launches
FUSE_BLOCK_KERNELS = ("flash_attention", "flash_attention_bwd",
                      "transformer_block")
# the kernels that only the AMP training program launches
AMP_KERNELS = ("flash_attention_hdt_bf16", "flash_attention_hdt_bwd_bf16",
               "lm_head_fwd_bf16", "lm_head_bwd_bf16")
# the kernels that only the fuse_block program under AMP launches
FUSE_BLOCK_AMP_KERNELS = ("flash_attention_bf16", "flash_attention_bwd_bf16",
                          "transformer_block_bf16")


@contextlib.contextmanager
def amp_bf16(on=True):
    """FLAGS_amp_bf16 set to `on` in the port for the block."""
    import paddle_tpu_torch as ptt
    old = ptt.flags.get_flag("amp_bf16")
    ptt.flags.set_flag("amp_bf16", on)
    try:
        yield
    finally:
        ptt.flags.set_flag("amp_bf16", old)


def wrapper(name):
    """The wrapper whose .launches counts kernel `name`'s launches."""
    import importlib
    mod = importlib.import_module("paddle_tpu_torch.kernels."
                                  + KERNELS[name][0])
    return getattr(mod, name)


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5):
    """(device ms, host ms) per call of fn.  The calls are queued behind a
    sleep kernel and timed by CUDA events around them, so the device time
    excludes the host's launch overhead even where a call's host work
    outlasts its kernels; the host time is the enqueue time per call.  The
    sleep doubles until the host has queued every call before it ends."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        ev[1].record()
        for _ in range(iters):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters
        cycles *= 2
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the device")


def timed_on_path(fn, call, path, iters=50, warmup=5, counter="launches_",
                  paths=("wgmma", "sync")):
    """(device ms, host ms, path) of call(path) by time_ms, for a wrapper
    fn with a counter per path of `paths` (.launches_wgmma, .launches_sync,
    or under another prefix `counter`) and `path` None (the operands'
    choice) or forced: the path its timed calls took, read from the
    counters, which must name one path for every call."""
    def count(p):
        return getattr(fn, counter + p)

    before = {p: count(p) for p in paths}
    ms, host = time_ms(lambda: call(path), iters=iters, warmup=warmup)
    moved = {p: count(p) - before[p] for p in paths}
    took = [p for p, n in moved.items() if n]
    if len(took) != 1 or took[0] != (path or took[0]):
        raise RuntimeError(f"{fn.__name__} timing (path {path}): the calls "
                           f"moved the path counters {moved}")
    return ms, host, took[0]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b):
    """max |a - b| over max |b|."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def tile_rel_err(got, want, tile=64, floor=1 / 16):
    """The bf16 flash compares' error: the largest, over the outputs and
    each head's tiles of `tile` tokens, of max |got - want| over that
    tile's max |want| (head-major [H, d, N] tensors), or over `floor` of
    the output's max |want| where the tile's max is below that.

    One max over a whole output would be set by the first rows of a
    causal sequence, far above the late rows, which average hundreds of
    keys: a kernel that dropped a key tile there could pass.  The floor
    covers tiles whose entries are sums that cancel (dq and dk where one
    key takes nearly all of a row's weight: ds = p (dp - delta) -> 0):
    their rounding error follows the size of their terms, not of their
    sum.  Two correct versions, the Pallas kernel and the plain one, put
    such a dq tile, at 1 % of the output's max, 2.1e-2 of its own max
    apart (T 65, q and k x 4, on the CPU)."""
    def tiles(t):                         # [H, N] -> [H, tiles of N]
        n = t.shape[-1]
        full = t.new_zeros(t.shape[0], -(-n // tile) * tile)
        full[:, :n] = t
        return full.view(t.shape[0], -1, tile).amax(-1)

    worst = 0.0
    for a, b in zip(got, want):
        e = tiles((a.float() - b.float()).abs().amax(1))
        m = tiles(b.float().abs().amax(1))
        m = m.clamp_min(max(floor * float(m.max()), 1e-30))
        worst = max(worst, float((e / m).max()))
    return worst


def skipped_key_tile(fa, q, k, v, lse, delta, do, B, T, tile=64):
    """(o, dq) of a causal bf16 flash kernel with a planted fault: the last
    row tile of each sequence skips the first key tile, 64 of its 448-512
    keys at T 512.  Built from the plain bf16 versions: the row tile over
    the diagonal key tile (causal) and over the other kept keys, merged by
    their lse in f32; dq sums the two parts' dq at the true lse and
    delta."""
    H, d, _ = q.shape
    o = fa.flash_attention_hdt_plain(q, k, v, B, causal=True)[0].clone()
    dq = fa.flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, B,
                                          causal=True)[0].clone()

    def part(t, cols):                    # [H, c, B*T] -> [H, c, B*len]
        return t.reshape(H, t.shape[1], B, T)[..., cols].reshape(
            H, t.shape[1], -1)

    last = (T - 1) // tile * tile
    rows, diag, kept = (slice(last, T), slice(last, T),
                        slice(tile, last))
    qi, doi, li, di = (part(t, rows) for t in (q, do, lse, delta))
    od, ld = fa.flash_attention_hdt_plain(qi, part(k, diag), part(v, diag),
                                          B, causal=True)
    gd = fa.flash_attention_hdt_bwd_plain(
        qi, part(k, diag), part(v, diag), li, di, doi, B, causal=True)[0]
    oi, gi = od.float(), gd.float()
    if last > tile:
        ok, lk = fa.flash_attention_hdt_plain(qi, part(k, kept),
                                              part(v, kept), B)
        lt = ld.logaddexp(lk)
        oi = od.float() * (ld - lt).exp() + ok.float() * (lk - lt).exp()
        gi = gi + fa.flash_attention_hdt_bwd_plain(
            qi, part(k, kept), part(v, kept), li, di, doi, B)[0].float()
    n = T - last
    o.view(H, d, B, T)[..., rows] = oi.to(o.dtype).view(H, d, B, n)
    dq.view(H, d, B, T)[..., rows] = gi.to(dq.dtype).view(H, d, B, n)
    return o, dq


def dropped_onehot_tile(lmh, x, w, labels, lse, g, chunk, width=128):
    """(dx, dW) of a bf16 LM-head backward with a planted fault: the
    dlogits of the tokens whose label lies in vocab columns [FAULT_TILE,
    FAULT_TILE + width) miss the onehot term (the softmax term stays).
    lm_head_bwd_plain's arithmetic and roundings otherwise."""
    import torch
    y = labels.long()
    kept = (y >= 0) & ~((y >= FAULT_TILE) & (y < FAULT_TILE + width))
    wf = w.float()
    gm = g.float() * (y >= 0).float()
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        sl = slice(r0, min(r0 + chunk, x.shape[0]))
        xs = x[sl].float()
        dl = torch.exp(xs @ wf - lse[sl].float()[:, None])
        rows = torch.arange(dl.shape[0], device=x.device)
        dl[rows, y[sl].clamp(min=0)] -= kept[sl].float()
        dl = (dl * gm[sl, None]).to(torch.bfloat16).float()
        dx[sl] = dl @ wf.t()
        dw += xs.t() @ dl
    return dx.to(x.dtype), dw.to(w.dtype)


def segmented_fwd(lmh, x, w, labels, ctas, drop=None):
    """(loss, lse) f32 of the bf16 LM-head forward in its wgmma path's
    order: each segment of lmh.fwd_bf16_segments (a CTA's vocab tiles of
    one token tile) takes each row's (max, sum of exp(l - max), gold
    logit) over its columns of the f32 logits of the bf16 operands, and
    each token tile's segment states are merged in slot (vocabulary)
    order.  drop: (token tile, slot) of a segment whose state the merge
    leaves out (the compare's planted fault)."""
    import torch
    N, V = x.shape[0], w.shape[1]
    logits = x.float() @ w.float()
    y = labels.long()
    m_all = torch.full((N,), -1e30, device=x.device)
    l_all = torch.zeros(N, device=x.device)
    g_all = torch.zeros(N, device=x.device)
    for _, m, v0, v1, slot in lmh.fwd_bf16_segments(N, V, ctas):
        if drop == (m, slot):
            continue
        rows = slice(m * 128, min(N, (m + 1) * 128))
        c0, c1 = v0 * 128, min(V, v1 * 128)
        seg = logits[rows, c0:c1]
        mx = seg.max(1).values
        sm = torch.exp(seg - mx[:, None]).sum(1)
        yr = y[rows]
        inside = (yr >= c0) & (yr < c1)
        gold = torch.where(inside, seg.gather(1, (yr - c0).clamp(
            0, c1 - c0 - 1)[:, None])[:, 0], torch.zeros_like(mx))
        mo, lo = m_all[rows], l_all[rows]
        mn = torch.maximum(mo, mx)
        l_all[rows] = lo * torch.exp(mo - mn) + sm * torch.exp(mx - mn)
        m_all[rows] = mn
        g_all[rows] += gold
    lse = m_all + torch.log(l_all.clamp_min(1e-30))
    return torch.where(y >= 0, lse - g_all, torch.zeros_like(lse)), lse


def fault_segment(lmh, N, V, ctas):
    """The segment segmented_fwd drops for the planted fault: slot 1 of
    the first token tile that has two (None if none has)."""
    for _, m, _, _, slot in lmh.fwd_bf16_segments(N, V, ctas):
        if slot == 1:
            return m, 1
    return None


def block_inputs(rnd, B, T, D, F, E=None, w1_scale=1.0):
    """x [B, T, D] and the 12 fused-block params (kernels/fused_block.py's
    PARAM_NAMES order; E defaults to D) at about the startup program's
    scale: Xavier weights, LN scales near 1, small biases.  w1_scale
    scales W1, and so the MLP's hidden units and the W2 product's sums."""
    E = D if E is None else E

    def w(r, c):
        return rnd(r, c) * math.sqrt(2.0 / (r + c))

    def vec(n, mean=0.0):
        return mean + 0.1 * rnd(n)

    return rnd(B, T, D), (vec(D, 1.0), vec(D), w(D, E), w(D, E), w(D, E),
                          w(E, D), vec(D, 1.0), vec(D), w(D, F) * w1_scale,
                          vec(F), w(F, D), vec(D))


def bthd_view(x, H):
    """A [B, T, E] tensor as the [B, H, T, d] view (token stride E) that
    the fused block's recompute hands flash_attention."""
    B, T, E = x.shape
    return x.reshape(B, T, H, E // H).transpose(1, 2)


def head_major(t):
    """A [B, H, T, d] tensor copied into the head-major [H, d, B*T] (token
    stride 1: a copy even where reshape could return a view, as it can of
    a [B, T, H, d] view)."""
    B, H, T, d = t.shape
    return t.permute(1, 3, 0, 2).reshape(H, d, B * T).contiguous()


# the bf16 head-major flash compares (phase 3): (H, d, B, Tq, Tk, causal,
# kv_len, layout of q and do, scale of q and k, path).  "strided" has token
# stride d, "+1" starts 1 element (2 bytes) into its storage: both take the
# sync kernels and element copies; so does a T that is not a multiple of 8
# (rows not 16-byte aligned).  The cases after the first nine have T a
# multiple of 8, so that the wgmma kernels take kv_len, Tq != Tk, d 128, a
# peaked softmax, a ragged tile (T 520) and kv_len under a causal mask too.
# "do-f1" keeps q head-major and gives do feature stride 1 (the other
# orientation): the wgmma backward reads each in its own.
FLASH_HDT_BF16_CASES = [
    (8, 64, TRAIN_BATCH, TRAIN_T, TRAIN_T, True, None, "", 1, "train"),
    (8, 64, 2, 300, 300, False, 250, "", 1, "ragged"),
    (8, 64, 2, 200, 333, False, None, "", 1, "ragged"),
    (4, 128, 2, 300, 300, True, None, "", 1, "ragged"),
    (4, 64, 3, 130, 130, True, None, "strided", 1, "ragged"),
    (8, 64, 2, 65, 65, True, None, "", 1, "ragged"),
    (8, 64, 2, 256, 256, True, None, "+1", 1, "ragged"),
    (8, 64, 4, 512, 512, True, None, "", 4, "ragged"),
    (4, 128, 2, 300, 300, False, 250, "strided", 4, "ragged"),
    (8, 64, 2, 304, 304, False, 250, "", 1, "ragged"),
    (8, 64, 2, 200, 336, False, None, "", 1, "ragged"),
    (4, 128, 2, 296, 296, True, None, "", 1, "ragged"),
    (4, 128, 2, 304, 304, False, 250, "", 4, "ragged"),
    (8, 64, 2, 520, 520, True, None, "", 1, "ragged"),
    (8, 64, 2, 384, 384, True, 300, "", 1, "ragged"),
    (8, 64, 2, 256, 256, True, None, "do-f1", 1, "ragged")]

# the bf16 [B, H, T, d] flash compares (phase 3): (H, d, B, Tq, Tk, causal,
# layout, scale of q and k, path).  "bthd" is the block's [B, T, H, d] view
# (feature stride 1), "bthd+1" the same 2 bytes into its storage (the sync
# kernels), "bhtd" contiguous; ":do-t1" gives do token stride 1 instead, as
# the rows of a [H d, B T] gradient (the strides autograd handed the
# block's recompute on the CPU).  The head-major copy of a case whose T is
# not a multiple of 8 takes the sync kernels where the view takes wgmma:
# there the two calls cross paths.  T 520 is ragged with both on wgmma.
FLASH_BHTD_BF16_CASES = [
    (8, 64, TRAIN_BATCH, TRAIN_T, TRAIN_T, True, "bthd", 1, "train"),
    (8, 64, 2, 300, 300, False, "bhtd", 1, "ragged"),
    (8, 64, 2, 200, 333, False, "bthd", 1, "ragged"),
    (4, 128, 2, 300, 300, True, "bthd", 1, "ragged"),
    (8, 64, 2, 65, 65, True, "bthd", 4, "ragged"),
    (8, 64, 2, 300, 300, True, "bthd+1", 1, "ragged"),
    (4, 128, 2, 200, 333, False, "bthd+1", 4, "ragged"),
    (8, 64, 4, 512, 512, True, "bthd", 4, "ragged"),
    (8, 64, 2, 520, 520, True, "bthd", 1, "ragged"),
    (8, 64, 2, 256, 256, True, "bthd:do-t1", 1, "ragged")]


def hdt_bf16_operands(rnd, case):
    """q, k, v and do in bf16 of a FLASH_HDT_BF16_CASES case, from rnd
    (f32 tensors of a shape)."""
    import torch
    H, d, B, Tq, Tk, _, _, layout, amp, _ = case
    bf = torch.bfloat16
    if layout == "strided":
        q = (rnd(H, B * Tq, d) * amp).to(bf).transpose(1, 2)
        do = rnd(H, B * Tq, d).to(bf).transpose(1, 2)
    elif layout == "+1":
        n = H * d * B * Tq
        q = (rnd(n + 1) * amp).to(bf)[1:].view(H, d, B * Tq)
        do = rnd(n + 1).to(bf)[1:].view(H, d, B * Tq)
    elif layout == "do-f1":
        q = (rnd(H, d, B * Tq) * amp).to(bf)
        do = rnd(H, B * Tq, d).to(bf).transpose(1, 2)
    else:
        q = (rnd(H, d, B * Tq) * amp).to(bf)
        do = rnd(H, d, B * Tq).to(bf)
    return q, (rnd(H, d, B * Tk) * amp).to(bf), rnd(H, d, B * Tk).to(bf), do


def bhtd_bf16_operands(rnd, case):
    """q, k, v and do in bf16 of a FLASH_BHTD_BF16_CASES case, from rnd."""
    import torch
    H, d, B, Tq, Tk, _, layout, amp, _ = case
    bf = torch.bfloat16
    layout, _, do_layout = layout.partition(":")

    def make(T, mul):
        if layout == "bthd":
            return bthd_view((rnd(B, T, H * d) * mul).to(bf), H)
        if layout == "bthd+1":
            x = (rnd(B * T * H * d + 1) * mul).to(bf)
            return bthd_view(x[1:].view(B, T, H * d), H)
        return (rnd(B, H, T, d) * mul).to(bf)

    q, k, v = make(Tq, amp), make(Tk, amp), make(Tk, 1)
    if do_layout == "do-t1":
        return q, k, v, rnd(H * d, B * Tq).to(bf).view(H, d, B, Tq).permute(
            2, 0, 3, 1)
    return q, k, v, make(Tq, 1)


def on_paths(torch, fn, call):
    """A bf16 wrapper fn with path counters (.launches_wgmma and
    .launches_sync: the flash kernels, the LM-head forward) on one input:
    call(path) runs it.  Runs it once with path None and reads
    the path it took from the counters, then twice on each path the
    operands admit (both where they took wgmma), forced.  Returns (the
    path taken, {path: (its outputs, two runs bit-identical)})."""
    before = (fn.launches_wgmma, fn.launches_sync)
    call(None)
    moved = (fn.launches_wgmma - before[0], fn.launches_sync - before[1])
    took = {(1, 0): "wgmma", (0, 1): "sync"}.get(moved)
    if took is None:
        raise RuntimeError(f"{fn.__name__}: one call moved the path counters "
                           f"{moved}")
    res = {}
    for p in ("wgmma", "sync") if took == "wgmma" else ("sync",):
        a, b = call(p), call(p)
        torch.cuda.synchronize()
        res[p] = (a, all(torch.equal(x, y) for x, y in zip(a, b)))
    return took, res


def check_bwd_paths(tag, res, want, hm=lambda t: t):
    """A bf16 flash backward's runs on each path (on_paths' dict) against
    its plain version: dq, dk and dv bf16, within BF16_RTOL of their
    tile's max |plain| (tile_rel_err of hm of each, hm taking [B, H, T, d]
    to head-major), bit-identical on repeat.  Returns the largest max abs
    error over the paths."""
    import torch
    worst = 0.0
    for p, (got, same) in res.items():
        rb = tile_rel_err([hm(t) for t in got], [hm(t) for t in want])
        log(f"[compare] {tag}: backward on the {p} path (forced): dq, dk, "
            f"dv {rb:.3g} of their tile's max |plain| (tol {BF16_RTOL:g}); "
            f"two runs bit-identical: {same}")
        if not rb <= BF16_RTOL:
            raise RuntimeError(f"bf16 flash backward ({p}) disagrees: {rb}")
        if not all(t.dtype == torch.bfloat16 for t in got) or not same:
            raise RuntimeError(f"bf16 flash backward ({p}): outputs not bf16, "
                               f"or not deterministic")
        worst = max(worst, max(max_err(a, b) for a, b in zip(got, want)))
    return worst


def flash_work(B, H, T, d):
    """(FLOP, bytes) of the causal flash forward and backward at these
    shapes: 4 d and 10 d FLOP per kept (query, key) pair; q, k, v, o, lse
    (and do, dq, dk, dv, delta) moved once, f32."""
    pairs = B * H * T * (T + 1) // 2
    n = H * d * B * T
    return ((4 * d * pairs, 4 * (4 * n + H * B * T)),
            (10 * d * pairs, 4 * (7 * n + 2 * H * B * T)))


def block_work(B, T, H, D, F, width=4):
    """(FLOP, bytes) of one block forward, E = D: the q/k/v, Wo, W1 and W2
    products, the causal attention, x in and out and the weights once in
    `width` bytes an element (2: bf16), the vectors in f32."""
    N = B * T
    flops = 2 * N * D * 3 * D + 2 * N * D * D + 4 * N * D * F \
        + flash_work(B, H, T, D // H)[0][0]
    nbytes = width * (2 * N * D + 4 * D * D + 2 * D * F) + 4 * (5 * D + F)
    return flops, nbytes


def bf16_block_params(params, vectors="f32"):
    """The fused-block params as the op hands them under AMP: bf16
    matrices, f32 vectors (or bf16 ones, given vectors="bf16")."""
    import torch
    return tuple(t.to(torch.bfloat16) if t.ndim == 2 or vectors == "bf16"
                 else t for t in params)


def rotation(make, n=ROTATE):
    """A function that returns, call by call, the next of n input sets made
    by make(): a timed call that takes its inputs from it finds them in
    device memory, not in the 50 MB L2, once n sets exceed it, as a kernel
    of the training step finds its inputs."""
    sets = [make() for _ in range(n)]
    it = itertools.cycle(sets)
    return lambda: next(it)


def bound_ms(flops, nbytes, peak=F32_FLOPS_PER_S):
    return max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3


def bf16_bounds(flops, nbytes, ms):
    """A bf16 tensor-core kernel's bound (the larger of its FLOP at the
    bf16 dense peak and its bytes at the HBM rate), what bounds it, and its
    rate in TFLOP/s."""
    tc = bound_ms(flops, nbytes, BF16_FLOPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS_PER_S \
        else "operations"
    return dict(bound_ms=tc, bound_by=by, tflops=flops / ms / 1e9)


def tc_bounds(flops, nbytes, ms):
    """A tensor-core kernel's bounds and rate.  Its f32 products run as
    3xTF32, three TF32 products for each f32 one, so bound_ms (and
    tc_bound_ms, the same number) is the larger of 3 x flops at the TF32
    peak and the bytes at the HBM rate; simt_bound_ms is the f32 bound
    without tensor cores, which rows before the tensor-core kernels
    reported; tflops is the f32 work over the time."""
    tc = bound_ms(3 * flops, nbytes, TF32_FLOPS_PER_S)
    return dict(bound_ms=tc, tc_bound_ms=tc,
                simt_bound_ms=bound_ms(flops, nbytes), tflops=flops / ms / 1e9)


def _short_kernel_name(name):
    """A demangled kernel name without its return type, argument list and
    "(anonymous namespace)::"."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):   # the argument list's "("
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth <= 0:
            name = name[:i] if name[i] == "(" else name
            break
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def phase_build(torch):
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    log(f"[build] {path.name} from {[s.name for s in _build.sources()]} "
        f"in {secs:.2f} s")
    # every kernel's registers, static shared memory and spills (the
    # tile-loop kernels also take gemm_tc.cuh's ring as dynamic shared
    # memory, which ptxas does not see), and any wgmma serialization
    # (C7518), which fails the phase: ptxas then runs every wgmma of that
    # kernel one after another
    serialized = []
    for line in _build.build_log().splitlines():
        if "C7518" in line:
            serialized.append(line.strip())
        if ("ptxas info" in line and ("Used" in line or "entry" in line)) \
                or "spill" in line or "warning" in line.lower() \
                or "C7518" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")
    log(f"[build] wgmma serialized (C7518) in {len(serialized)} kernels")
    if serialized:
        raise RuntimeError(f"ptxas serializes the wgmma of "
                           f"{len(serialized)} kernels (C7518)")


def phase_compare(torch):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_block as fb
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import lm_head as lmh
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    # name -> {path: max abs err at that path's shape}; "train" and
    # "serve" are the shapes the training step and a batch-8 request give
    # the kernel, "ragged" the maximum over the other cases; the layer norm
    # on bf16 rows (the AMP programs') under "layer_norm_bf16"
    errs = {n: {} for n in KERNELS}
    errs["layer_norm_bf16"] = {}

    def note(name, path, e):
        errs[name][path] = max(errs[name].get(path, 0.0), e)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    for n, d, dtype, path in [
            (TRAIN_BATCH * TRAIN_T, 512, torch.float32, "train"),
            (8 * SERVE_T, 512, torch.float32, "serve"),
            (4095, 512, torch.float32, "ragged"),
            (4096, 768, torch.float32, "ragged"),   # BERT-base's rows
            (640, 768, torch.float32, "ragged"),    # its MLM head's
            (333, 2048, torch.float32, "ragged"),
            (7, 8192, torch.float32, "ragged")]:
        x = rnd(n, d, dtype=dtype) * 2 + 0.5
        gam, bet = rnd(d), rnd(d)
        got = ln.layer_norm(x, gam, bet, 1e-5)
        want = ln.layer_norm_plain(x, gam, bet, 1e-5)
        torch.cuda.synchronize()
        e = max(max_err(a, b) for a, b in zip(got, want))
        log(f"[compare] layer_norm N={n} D={d} {str(dtype)[6:]}: "
            f"max abs err {e:.3g} (tol {LN_TOL:g})")
        if not e <= LN_TOL:
            raise RuntimeError(f"layer_norm kernel disagrees: {e} > {LN_TOL}")
        note("layer_norm", path, e)
    compare_layer_norm_bf16(torch, ln, rnd, note)

    # (H, d, B, Tq, Tk, causal, kv_len, strided q, scale of q and k,
    # path); q and k x 4 make the softmax peaked (|s| up to ~80), where
    # the lo terms of the 3xTF32 split matter most; v keeps its scale, and
    # so does o, on which FA_TOL is absolute
    for H, d, B, Tq, Tk, causal, kv_len, strided, amp, path in [
            (8, 64, TRAIN_BATCH, TRAIN_T, TRAIN_T, True, None, False, 1,
             "train"),
            (8, 64, 8, SERVE_T, SERVE_T, True, None, False, 1, "serve"),
            (8, 64, 2, 300, 300, False, 250, False, 1, "ragged"),
            (8, 64, 2, 200, 333, False, None, False, 1, "ragged"),  # Tq!=Tk
            (4, 128, 2, 300, 300, True, None, False, 1, "ragged"),
            (4, 64, 3, 130, 130, True, None, True, 1, "ragged"),
            (8, 64, 2, 65, 65, True, None, False, 1, "ragged"),
            (8, 64, 4, 512, 512, True, None, False, 4, "ragged"),
            (4, 128, 2, 300, 300, False, 250, False, 4, "ragged")]:
        if strided:   # q as a transposed view: token stride d, not 1
            q = (rnd(H, B * Tq, d) * amp).transpose(1, 2)
        else:
            q = rnd(H, d, B * Tq) * amp
        k, v = rnd(H, d, B * Tk) * amp, rnd(H, d, B * Tk)
        got = fa.flash_attention_hdt(q, k, v, B, causal=causal,
                                     kv_len=kv_len)
        want = fa.flash_attention_hdt_plain(q, k, v, B, causal=causal,
                                            kv_len=kv_len)
        torch.cuda.synchronize()
        e = max(max_err(a, b) for a, b in zip(got, want))
        log(f"[compare] flash_attention_hdt H={H} d={d} B={B} Tq={Tq} "
            f"Tk={Tk} causal={causal} kv_len={kv_len} strided={strided} "
            f"q, k x{amp}: max abs err {e:.3g} (tol {FA_TOL:g})")
        if not e <= FA_TOL:
            raise RuntimeError(f"flash kernel disagrees: {e} > {FA_TOL}")
        note("flash_attention_hdt", path, e)

    # flash backward from the forward's residuals: (H, d, B, Tq, Tk,
    # causal, kv_len, strided q and do, scale of q and k, path)
    for H, d, B, Tq, Tk, causal, kv_len, strided, amp, path in [
            (8, 64, TRAIN_BATCH, TRAIN_T, TRAIN_T, True, None, False, 1,
             "train"),
            (8, 64, 2, 300, 300, False, 250, False, 1, "ragged"),
            (8, 64, 2, 200, 333, False, None, False, 1, "ragged"),
            (4, 128, 2, 300, 300, True, None, False, 1, "ragged"),
            (4, 64, 3, 130, 130, True, None, True, 1, "ragged"),
            (8, 64, 2, 65, 65, True, None, False, 1, "ragged"),
            (8, 64, 4, 512, 512, True, None, False, 4, "ragged"),
            (4, 128, 2, 300, 300, False, 250, True, 4, "ragged")]:
        if strided:   # token stride d, as a transposed view (do: as
            q = (rnd(H, B * Tq, d) * amp).transpose(1, 2)  # autograd
            do = rnd(H, B * Tq, d).transpose(1, 2)         # hands it)
        else:
            q, do = rnd(H, d, B * Tq) * amp, rnd(H, d, B * Tq)
        k, v = rnd(H, d, B * Tk) * amp, rnd(H, d, B * Tk)
        o, lse = fa.flash_attention_hdt_plain(q, k, v, B, causal=causal,
                                              kv_len=kv_len)
        delta = (do * o).sum(1, keepdim=True)
        args = (q, k, v, lse, delta, do, B)
        kw = dict(causal=causal, kv_len=kv_len)
        got = fa.flash_attention_hdt_bwd(*args, **kw)
        again = fa.flash_attention_hdt_bwd(*args, **kw)
        want = fa.flash_attention_hdt_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        e = max(max_err(a, b) for a, b in zip(got, want))
        # of the largest plain gradient: dq and dk nearly vanish where a
        # query sees one key (ds = p * (do.v - do.o))
        r = e / max(float(b.abs().max()) for b in want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[compare] flash_attention_hdt_bwd H={H} d={d} B={B} Tq={Tq} "
            f"Tk={Tk} causal={causal} kv_len={kv_len} strided={strided} "
            f"q, k x{amp}: "
            f"max abs err {e:.3g}, {r:.3g} of max |plain| (tol "
            f"{BWD_RTOL:g}); two runs bit-identical: {same}")
        if not r <= BWD_RTOL:
            raise RuntimeError(f"flash backward disagrees: {r} > {BWD_RTOL}")
        if not same:
            raise RuntimeError("flash backward is not deterministic")
        note("flash_attention_hdt_bwd", path, e)

    # LM head: (N, D, V, chunk, ignored labels, scale of x, label dtype,
    # path).  Besides the path shape: a ragged N and V (V odd: W's rows
    # take 8-byte copies), D odd (x's rows take 8-byte copies) with int32
    # labels, N, D and V below one tile, and a peaked softmax (x x 12,
    # |logit| up to about 80)
    for N, D, V, chunk, n_ign, amp, ydt, path in [
            (TRAIN_BATCH * TRAIN_T, 512, 32000, HEAD_CHUNK, 0, 1,
             torch.int64, "train"),
            (1000, 512, 1001, 256, 37, 1, torch.int64, "ragged"),
            (777, 201, 3000, 300, 11, 1, torch.int32, "ragged"),
            (5, 12, 100, HEAD_CHUNK, 1, 1, torch.int64, "ragged"),
            (2048, 512, 32000, 1024, 5, 12, torch.int64, "ragged")]:
        x, w = rnd(N, D) * amp, rnd(D, V) * 0.05
        y = torch.randint(0, V, (N,), generator=g, device=dev)
        y[torch.randperm(N, generator=g, device=dev)[:n_ign]] = -1
        y = y.to(ydt)
        gl = torch.rand(N, generator=g, device=dev) * (2.0 / N)
        loss, lse = lmh.lm_head_fwd(x, w, y)
        loss2, lse2 = lmh.lm_head_fwd(x, w, y)
        ploss, plse = lmh.lm_head_fwd_plain(x, w, y)
        got = lmh.lm_head_bwd(x, w, y, lse, gl, chunk)
        again = lmh.lm_head_bwd(x, w, y, lse, gl, chunk)
        want = lmh.lm_head_bwd_plain(x, w, y, plse, gl, chunk)
        torch.cuda.synchronize()
        top = float(plse.abs().max())
        ef = max(max_err(loss, ploss), max_err(lse, plse))
        eb = max(max_err(a, b) for a, b in zip(got, want))
        rb = max(rel_err(a, b) for a, b in zip(got, want))
        same_f = torch.equal(loss, loss2) and torch.equal(lse, lse2)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[compare] lm_head_fwd N={N} D={D} V={V} ignored={n_ign} "
            f"x*{amp} labels {str(ydt)[6:]} (max |lse| {top:.3g}): max abs "
            f"err on loss and lse {ef:.3g} (tol {HEAD_TOL:g}); two runs "
            f"bit-identical: {same_f}")
        log(f"[compare] lm_head_bwd N={N} D={D} V={V} chunk={chunk}: max "
            f"abs err {eb:.3g}, {rb:.3g} of max |plain| (tol "
            f"{BWD_RTOL:g}); two runs bit-identical: {same}")
        if not ef <= HEAD_TOL:
            raise RuntimeError(f"LM head forward disagrees: {ef}")
        if not bool((loss[y < 0] == 0).all()):
            raise RuntimeError("LM head forward: ignored labels give loss")
        if not same_f:
            raise RuntimeError("LM head forward is not deterministic")
        if not rb <= BWD_RTOL:
            raise RuntimeError(f"LM head backward disagrees: {rb}")
        if not same:
            raise RuntimeError("LM head backward is not deterministic")
        note("lm_head_fwd", path, ef)
        note("lm_head_bwd", path, eb)

    # flash in [B, H, T, d] through strides, forward and backward, against
    # the plain versions and against the head-major call on the same data
    # (the same kernels and sums: the same bits).  "bthd" is the block
    # recompute's [B, T, H, d] view of a [B, T, E] projection, "bthd+1"
    # the same view starting 1 float into its storage (not 16-byte
    # aligned, so the kernels stage it by 4-byte copies), "bhtd" the
    # contiguous layout.  (H, d, B, Tq, Tk, causal, layout, scale of q
    # and k, path)
    for H, d, B, Tq, Tk, causal, layout, amp, path in [
            (8, 64, TRAIN_BATCH, TRAIN_T, TRAIN_T, True, "bthd", 1,
             "train"),
            (8, 64, 2, 300, 300, False, "bhtd", 1, "ragged"),
            (8, 64, 2, 200, 333, False, "bthd", 1, "ragged"),
            (4, 128, 2, 300, 300, True, "bthd", 1, "ragged"),
            (4, 64, 3, 130, 130, True, "bhtd", 1, "ragged"),
            (8, 64, 2, 65, 65, True, "bthd", 1, "ragged"),
            (8, 64, 2, 300, 300, True, "bthd+1", 1, "ragged"),
            (4, 128, 2, 200, 333, False, "bthd+1", 4, "ragged"),
            (8, 64, 4, 512, 512, True, "bthd", 4, "ragged")]:
        def make(T, mul=amp):
            if layout == "bthd":
                return bthd_view(rnd(B, T, H * d) * mul, H)
            if layout == "bthd+1":
                x = rnd(B * T * H * d + 1) * mul
                return bthd_view(x[1:].view(B, T, H * d), H)
            return rnd(B, H, T, d) * mul

        q, k, v, do = make(Tq), make(Tk), make(Tk, 1), make(Tq, 1)
        if layout == "bthd+1" and q.data_ptr() % 16 == 0:
            raise RuntimeError("the misaligned case is 16-byte aligned")
        scale = 1.0 / math.sqrt(d)
        o, lse = fa._launch_bhtd(q, k, v, causal, scale)
        po, plse = fa.flash_attention_plain(q, k, v, causal)
        delta = (do * o).sum(-1)
        got = fa.flash_attention_bwd(q, k, v, lse, delta, do, causal)
        again = fa.flash_attention_bwd(q, k, v, lse, delta, do, causal)
        want = fa.flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)
        qh, kh, vh, doh = map(head_major, (q, k, v, do))
        oh, lseh = fa.flash_attention_hdt(qh, kh, vh, B, causal=causal)
        lse_hm = lse.permute(1, 0, 2).reshape(H, 1, B * Tq).contiguous()
        gh = fa.flash_attention_hdt_bwd(
            qh, kh, vh, lse_hm,
            delta.permute(1, 0, 2).reshape(H, 1, B * Tq).contiguous(), doh,
            B, causal=causal)
        torch.cuda.synchronize()
        ef = max(max_err(o, po), max_err(lse, plse))
        eb = max(max_err(a, b) for a, b in zip(got, want))
        rb = eb / max(float(b.abs().max()) for b in want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        bits_f = torch.equal(head_major(o), oh) and torch.equal(lse_hm, lseh)
        bits_b = all(torch.equal(head_major(a), b) for a, b in zip(got, gh))
        log(f"[compare] flash_attention [B,H,T,d] ({layout}) H={H} d={d} "
            f"B={B} Tq={Tq} Tk={Tk} causal={causal} q, k x{amp}: forward "
            f"max abs err "
            f"{ef:.3g} (tol {FA_TOL:g}); backward max abs err {eb:.3g}, "
            f"{rb:.3g} of max |plain| (tol {BWD_RTOL:g}); two backward runs "
            f"bit-identical: {same}; same bits as the head-major call: "
            f"forward {bits_f}, backward {bits_b}")
        if not ef <= FA_TOL:
            raise RuntimeError(f"[B,H,T,d] flash disagrees: {ef} > {FA_TOL}")
        if not rb <= BWD_RTOL:
            raise RuntimeError(f"[B,H,T,d] flash backward disagrees: {rb}")
        if not (same and bits_f and bits_b):
            raise RuntimeError("[B,H,T,d] flash: not deterministic, or not "
                               "the head-major call's bits")
        note("flash_attention", path, ef)
        note("flash_attention_bwd", path, eb)

    # the fused block against its plain version, twice for the same bits:
    # (B, T, H, D, E, F, causal, scale of W1, path).  H 4 at E 512 is head
    # dim 128; D 201, F 333 give each operand whose rows hold D or F pairs
    # (a, Wo, W1, u, W2) 8-byte copies; W1 x 8 makes the hidden units and
    # W2's 2048-long sums large (the peaked long-K case)
    for B, T, H, D, E, F, causal, w1s, path in [
            (TRAIN_BATCH, TRAIN_T, 8, 512, 512, 2048, True, 1, "train"),
            (2, 300, 8, 512, 512, 2048, False, 1, "ragged"),
            (2, 300, 4, 512, 512, 2048, True, 1, "ragged"),
            (2, 67, 2, 201, 128, 333, True, 1, "ragged"),
            (4, 512, 8, 512, 512, 2048, True, 8, "ragged")]:
        x, params = block_inputs(rnd, B, T, D, F, E, w1s)
        got = fb.transformer_block(x, params, H, causal)
        again = fb.transformer_block(x, params, H, causal)
        want = fb.transformer_block_plain(x, params, H, causal)
        torch.cuda.synchronize()
        e, r = max_err(got, want), rel_err(got, want)
        same = torch.equal(got, again)
        log(f"[compare] transformer_block B={B} T={T} H={H} D={D} E={E} "
            f"F={F} causal={causal} W1 x{w1s}: max abs err {e:.3g}, {r:.3g} "
            f"of max |plain| {float(want.abs().max()):.3g} (tol "
            f"{BLOCK_RTOL:g}); two runs bit-identical: {same}")
        if not r <= BLOCK_RTOL:
            raise RuntimeError(f"block kernel disagrees: {r} > {BLOCK_RTOL}")
        if not same:
            raise RuntimeError("block kernel is not deterministic")
        note("transformer_block", path, e)

    compare_flash_hdt_bf16(torch, rnd, note)

    compare_lm_head_bf16(torch, lmh, rnd, g, note)
    compare_fuse_block_amp(torch, rnd, note)
    return errs


# the layer norm on bf16 rows: (N, D, mean of x, path); x = randn * 2 +
# mean, gamma and beta randn.  Each case runs on the path its operands
# choose (layer_norm.bf16_path: v16 for all of these) and again forced onto
# the scalar path, with the same inputs.  Mean 64 makes E[x^2] - mean^2
# lose 12 of f32's 24 bits, which the centred variance does not
LN_BF16_CASES = [
    (TRAIN_BATCH * TRAIN_T, 512, 0.5, "train"),
    (4096, 512, 0.5, "ragged"),
    (4095, 512, 0.5, "ragged"),
    (1, 512, 0.5, "ragged"),
    (1000, 264, 0.5, "ragged"),
    (777, 520, 0.5, "ragged"),
    (4096, 768, 0.5, "ragged"),     # BERT-base's rows and its MLM head's
    (640, 768, 0.5, "ragged"),
    (333, 2048, 0.5, "ragged"),
    (7, 8192, 0.5, "ragged"),
    (4096, 512, 64.0, "ragged"),
]


def ln_bf16_inputs(rnd, n, d, mu=0.5):
    """Inputs of a layer-norm compare on bf16 rows: x = randn * 2 + mu in
    bf16, and f32 gamma and beta, randn clamped to +-2 and scaled by 0.3
    and 0.15, so that |y| <= 0.6 |xhat| + 0.3 stays under 4 (|xhat| of
    randn rows is about 5.6 at most over 8M entries), where LN_BF16_TOL is
    one bf16 rounding.  (Under gamma and beta ~ N(0, 1), |y| reaches 16,
    and an entry whose f32 value lies within the last bits of a rounding
    boundary rounds one step apart on the two sides: 0.03125 at |y| in
    [4, 8), on the v16 and the scalar path alike, about 300 of the
    training shape's 8.4M entries.)"""
    import torch
    x = (rnd(n, d) * 2 + mu).to(torch.bfloat16)
    return x, rnd(d).clamp(-2, 2) * 0.3, rnd(d).clamp(-2, 2) * 0.15


def bf16_steps(got, want):
    """The largest |got - want| over bf16 tensors, in units of the bf16
    spacing at |want| (2^(e - 7) for |want| in [2^e, 2^(e+1))), the unit
    at least 2^-13: below that the f32 rounding of terms that cancel to a
    small y outweighs a step."""
    import torch
    w = want.float().abs().clamp_min(2.0 ** -6)
    unit = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return float(((got.float() - want.float()).abs() / unit).max())


def ln_plan_drift(ln, N, D):
    """Where the Python mirror of the v16 layer norm's grid
    (layer_norm.bf16_plan, which the CPU tests hold) differs from the
    library's plan on this card, as text, or "" where they agree."""
    lib = ln.bf16_plan_of_library(N, D)
    mine = ln.bf16_plan(N, D, lib["sms"], lib["ctas_per_sm"])
    return "; ".join(f"{k} {v} (library {lib[k]})"
                     for k, v in mine.items() if lib[k] != v)


def compare_layer_norm_bf16(torch, ln, rnd, note):
    """The layer norm on bf16 rows against layer_norm_plain: every
    LN_BF16_CASES case on its chosen path (v16), checked by the path
    counters, then forced onto the scalar path on the same inputs; y bf16
    within LN_BF16_TOL, mean and rstd within LN_TOL; two calls of each
    path the same bits; the share of y entries bit-equal between the
    paths; the v16 plan the library's (ln_plan_drift).  D 201 and an x
    view 2 bytes off 16-byte alignment choose the scalar path with no v16
    launch, and v16 forced on them raises before any launch."""
    bf = torch.bfloat16
    fn = ln.layer_norm

    def run(x, gam, bet, path, want_path):
        before = (fn.launches_v16, fn.launches_scalar)
        got = fn(x, gam, bet, 1e-5, path=path)
        again = fn(x, gam, bet, 1e-5, path=path)
        torch.cuda.synchronize()
        took = dict(v16=fn.launches_v16 - before[0],
                    scalar=fn.launches_scalar - before[1])
        if took != {p: 2 * (p == want_path) for p in ln.BF16_PATHS}:
            raise RuntimeError(f"layer_norm bf16 paths {took}, expected two "
                               f"calls on {want_path}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if got[0].dtype != bf or not same:
            raise RuntimeError(f"layer_norm bf16 ({want_path}): y not bf16, "
                               f"or not deterministic")
        return got, same

    def check(tag, got, want):
        if not float(want[0].float().abs().max()) < 4:
            raise RuntimeError(f"layer_norm bf16 compare ({tag}): |y| >= 4, "
                               f"outside LN_BF16_TOL's premise")
        ey = max_err(got[0], want[0])
        es = max(max_err(got[1], want[1]), max_err(got[2], want[2]))
        log(f"[compare] layer_norm {tag}: y max abs err {ey:.3g} (tol "
            f"{LN_BF16_TOL:g}), mean and rstd {es:.3g} (tol {LN_TOL:g})")
        if not (ey <= LN_BF16_TOL and es <= LN_TOL):
            raise RuntimeError(f"layer_norm bf16 kernel disagrees ({tag}): "
                               f"y {ey}, stats {es}")
        return max(ey, es)

    def share(a, b):   # % of bf16 entries with the same bits
        return 100 * float((a.view(torch.int16)
                            == b.view(torch.int16)).float().mean())

    for n, d, mu, path in LN_BF16_CASES:
        drift = ln_plan_drift(ln, n, d)
        if drift:
            raise RuntimeError(f"the v16 layer norm's plan at N={n} D={d} is "
                               f"not the library's: {drift}")
        x, gam, bet = ln_bf16_inputs(rnd, n, d, mu)
        want = ln.layer_norm_plain(x, gam, bet, 1e-5)
        got, same = run(x, gam, bet, None, "v16")
        tag = f"N={n} D={d} bf16 mean {mu:g}"
        note("layer_norm_bf16", path, check(f"{tag} v16 (chosen)", got,
                                            want))
        scalar, _ = run(x, gam, bet, "scalar", "scalar")
        check(f"{tag} scalar (forced)", scalar, want)
        log(f"[compare] layer_norm {tag}: y bit-equal between the paths "
            f"{share(got[0], scalar[0]):.4f} % (to the plain version: v16 "
            f"{share(got[0], want[0]):.4f} %, scalar "
            f"{share(scalar[0], want[0]):.4f} %); two calls of each "
            f"bit-identical: {same}")
    # gamma and beta ~ N(0, 1), |y| up to 16: each path within one bf16
    # step of the plain version, entry by entry
    x = (rnd(TRAIN_BATCH * TRAIN_T, 512) * 2 + 0.5).to(bf)
    gam, bet = rnd(512), rnd(512)
    want = ln.layer_norm_plain(x, gam, bet, 1e-5)
    for path in ln.BF16_PATHS:
        got = fn(x, gam, bet, 1e-5, path=path)
        steps = bf16_steps(got[0], want[0])
        log(f"[compare] layer_norm N={TRAIN_BATCH * TRAIN_T} D=512 bf16, "
            f"gamma and beta randn (max |y| "
            f"{float(want[0].float().abs().max()):.3g}), {path}: y within "
            f"{steps:g} bf16 step of the plain version's, "
            f"{int((got[0] != want[0]).sum())} entries apart")
        if not steps <= 1:
            raise RuntimeError(f"layer_norm bf16 ({path}): y {steps} bf16 "
                               f"steps from the plain version's")
    # operands v16 cannot take: the scalar path, no v16 launch
    for tag, n, d, off in (
            ("N=300 D=201", 300, 201, 0),
            ("N=4096 D=512, x 2 bytes off 16-byte alignment", 4096, 512, 1)):
        x, gam, bet = ln_bf16_inputs(rnd, n + off, d)
        x = x.view(-1)[off:off + n * d].view(n, d)
        got, _ = run(x, gam, bet, None, "scalar")
        note("layer_norm_bf16", "ragged", check(
            f"{tag} bf16: scalar (chosen)", got,
            ln.layer_norm_plain(x, gam, bet, 1e-5)))
        before = (fn.launches, fn.launches_v16, fn.launches_scalar)
        try:
            fn(x, gam, bet, 1e-5, path="v16")
        except ValueError as err:
            log(f"[compare] layer_norm {tag} bf16 forced onto v16: refused "
                f"({err})")
        else:
            raise RuntimeError(f"the v16 layer norm ran on {tag}")
        if (fn.launches, fn.launches_v16, fn.launches_scalar) != before:
            raise RuntimeError("a refused layer_norm call moved its counters")


def fwd_plan_drift(lmh, N, D, V, sms):
    """Where the Python mirror of the wgmma forward's schedule
    (lm_head.fwd_bf16_plan and fwd_bf16_segments, which the CPU tests and
    segmented_fwd hold) differs from the library's own plan on this card,
    as text, or "" where they agree: the CTAs, slots, x resident, stages,
    each CTA's range of flat tiles, each segment's slot, and the workspace
    (12 slots N bytes, 256-aligned)."""
    lib = lmh.fwd_bf16_plan_of_library(N, D, V)
    mine = lmh.fwd_bf16_plan(N, D, V, sms)
    out = [f"{k} {mine[k]} (library {lib[k]})"
           for k in ("ctas", "slots", "x_resident", "stages")
           if mine[k] != lib[k]]
    nt, begins = mine["vocab_tiles"], lib["begins"]
    segs = lmh.fwd_bf16_segments(N, V, mine["ctas"])
    starts = {}
    for c, m, v0, _, slot in segs:
        starts.setdefault(c, m * nt + v0)
        first = max(k for k in range(len(begins) - 1)
                    if begins[k] <= m * nt)
        if slot != c - first:
            out.append(f"CTA {c}'s segment of token tile {m}: slot {slot} "
                       f"(library {c - first})")
    mine_begins = [starts.get(c) for c in range(mine["ctas"])] \
        + [mine["tiles"]]
    if mine_begins != begins:
        out.append("the CTAs' ranges")
    work = lmh._fn("ptt_lm_head_fwd_bf16_wgmma_workspace")(N, D, V)
    if work != -(-12 * mine["slots"] * N // 256) * 256:
        out.append(f"workspace {work} bytes for {mine['slots']} slots")
    return "; ".join(out)


def block_plan_drift(fb, B, T, D, E, F, sms):
    """Where the Python mirror of the bf16 block's wgmma schedule
    (fused_block.block_gemm_plan, which the CPU tests hold) differs from
    the library's plan of each of the four launches on this card, as
    text, or "" where they agree."""
    out = []
    for name, dims in fb.block_gemm_launches(B, T, D, E, F).items():
        lib = fb.block_gemm_plan_of_library(*dims)
        mine = fb.block_gemm_plan(*dims, sms)
        out += [f"{name} {k} {v} (library {lib[k]})"
                for k, v in mine.items() if lib[k] != v]
    return "; ".join(out)


def compare_lm_head_bf16(torch, lmh, rnd, g, note, cases=None):
    """Phase 3's compares of the bf16 LM head (the AMP path's), on
    HEAD_BF16_CASES (or `cases`): the forward on the path its operands
    choose (lm_head.bf16_path, checked by its path counters) and again
    on each path they admit, forced, twice, its loss and lse within
    HEAD_TOL of lm_head_fwd_plain and bit-identical on repeat; the
    backward likewise at BF16_RTOL of max |plain|; on the training case
    the planted faults (a forward merge without one segment's state, a
    backward without the onehot term in one vocab tile) refused by more
    than 4x their tolerance.  note(kernel, path, err) records each
    kernel's error on the path its operands choose."""
    bf = torch.bfloat16
    dev = g.device
    bwd, fwd = lmh.lm_head_bwd_bf16, lmh.lm_head_fwd_bf16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for N, D, V, chunk, n_ign, amp, ydt, path in cases or HEAD_BF16_CASES:
        x, w = (rnd(N, D) * amp).to(bf), (rnd(D, V) * 0.05).to(bf)
        y = torch.randint(0, V, (N,), generator=g, device=dev)
        y[torch.randperm(N, generator=g, device=dev)[:n_ign]] = -1
        y = y.to(getattr(torch, ydt))
        gl = torch.rand(N, generator=g, device=dev) * (2.0 / N)
        ploss, plse = lmh.lm_head_fwd_plain(x, w, y)
        want = lmh.lm_head_bwd_plain(x, w, y, plse, gl, chunk)
        # the forward on the path its operands choose, then on each path
        # they admit, forced, twice
        fpath, fres = on_paths(torch, fwd,
                               lambda p: fwd(x, w, y, path=p))
        if fpath != lmh.bf16_path(x.data_ptr(), w.data_ptr(), D, V):
            raise RuntimeError(f"bf16 LM head forward took the {fpath} "
                               f"path")
        plan = lmh.fwd_bf16_plan(N, D, V, sms)
        drift = fwd_plan_drift(lmh, N, D, V, sms)
        if drift:
            raise RuntimeError(f"bf16 LM head forward N={N} D={D} V={V}: "
                               f"fwd_bf16_plan is not the library's plan: "
                               f"{drift}")
        for p, ((floss, flse), same_f) in fres.items():
            ef = max(max_err(floss, ploss), max_err(flse, plse))
            log(f"[compare] lm_head_fwd_bf16 N={N} D={D} V={V} "
                f"ignored={n_ign} x*{amp} labels {ydt} on the {p} "
                f"path{'' if p == fpath else ' (forced)'}"
                + (f" (x {'resident' if plan['x_resident'] else 'streamed'}"
                   f", {plan['ctas']} CTAs, {plan['slots']} slots)"
                   if p == "wgmma" else "")
                + f": loss and lse max abs err {ef:.3g} (tol {HEAD_TOL:g});"
                f" two runs bit-identical: {same_f}")
            if not ef <= HEAD_TOL:
                raise RuntimeError(f"bf16 LM head forward ({p}) disagrees: "
                                   f"{ef}")
            if not bool((floss[y < 0] == 0).all()):
                raise RuntimeError("bf16 LM head: ignored labels give loss")
            if not same_f:
                raise RuntimeError(f"bf16 LM head forward ({p}) is not "
                                   f"deterministic")
        (loss, lse), _ = fres[fpath]
        ef = max(max_err(loss, ploss), max_err(lse, plse))
        if path == "train":
            # the compare must refuse a forward whose merge drops one
            # segment's state
            drop = fault_segment(lmh, N, V, plan["ctas"])
            floss, flse = segmented_fwd(lmh, x, w, y, plan["ctas"], drop)
            fault = max(max_err(floss, ploss), max_err(flse, plse))
            log(f"[fault] lm_head_fwd_bf16, the merge without segment "
                f"{drop} (token tile, slot) of the wgmma split: loss and "
                f"lse {fault:.3g} (tol {HEAD_TOL:g})")
            if not fault > 4 * HEAD_TOL:
                raise RuntimeError(f"the bf16 LM head compare passes a "
                                   f"dropped segment: {fault}")
        shape_path = lmh.bf16_path(x.data_ptr(), w.data_ptr(), D, V)
        for forced in (None, "sync") if shape_path == "wgmma" else (None,):
            took = forced or shape_path
            before = (bwd.launches_wgmma, bwd.launches_sync)
            got = bwd(x, w, y, lse, gl, chunk, path=forced)
            again = bwd(x, w, y, lse, gl, chunk, path=forced)
            torch.cuda.synchronize()
            n_ch = 2 * -(-N // min(chunk, N))
            moved = (bwd.launches_wgmma - before[0],
                     bwd.launches_sync - before[1])
            if moved != ((n_ch, 0) if took == "wgmma" else (0, n_ch)):
                raise RuntimeError(f"bf16 LM head backward: expected the "
                                   f"{took} path, counters moved {moved}")
            rb = max(rel_err(a, b) for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"[compare] lm_head_bwd_bf16 N={N} D={D} V={V} "
                f"chunk={chunk} ignored={n_ign} x*{amp} labels "
                f"{ydt} on the {took} path"
                f"{' (forced)' if forced else ''}: dx, dW {rb:.3g} of max "
                f"|plain| (tol {BF16_RTOL:g}); two runs bit-identical: "
                f"{same}")
            if not rb <= BF16_RTOL:
                raise RuntimeError(f"bf16 LM head backward ({took}) "
                                   f"disagrees: {rb}")
            if not all(t.dtype == bf for t in got):
                raise RuntimeError("bf16 LM head backward: outputs not bf16")
            if not same:
                raise RuntimeError(f"bf16 LM head backward ({took}) is not "
                                   f"deterministic")
            if forced is None:
                note("lm_head_bwd_bf16", path,
                     max(max_err(a, b) for a, b in zip(got, want)))
        if path == "train":
            # the compare must refuse a backward whose dlogits miss the
            # onehot term in one vocab tile
            fdx, fdw = dropped_onehot_tile(lmh, x, w, y, plse, gl, chunk)
            fault = max(rel_err(fdx, want[0]), rel_err(fdw, want[1]))
            log(f"[fault] lm_head_bf16, dlogits without the onehot term "
                f"in vocab tile [{FAULT_TILE}, {FAULT_TILE + 128}): dx, dW "
                f"{fault:.3g} of max |plain| (tol {BF16_RTOL:g})")
            if not fault > 4 * BF16_RTOL:
                raise RuntimeError(f"the bf16 LM head compare passes a "
                                   f"dropped onehot tile: {fault}")
        note("lm_head_fwd_bf16", path, ef)



def compare_flash_hdt_bf16(torch, rnd, note):
    """Phase 3's compares of the bf16 head-major flash (the AMP path's
    fused_mha): FLASH_HDT_BF16_CASES on every path, and the planted fault
    (rnd makes f32 inputs on the card, note records each kernel's error by
    path)."""
    # the bf16 kernels of the AMP path against their plain versions in
    # bf16 (FLASH_HDT_BF16_CASES).  The forward and the backward run each
    # case on every path its operands admit, forced, after one call that
    # must take fwd_bf16_path's (bwd_bf16_path's) choice, read from the
    # path counters
    from paddle_tpu_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    fwd = fa.flash_attention_hdt_bf16
    bwd = fa.flash_attention_hdt_bwd_bf16
    for case in FLASH_HDT_BF16_CASES:
        H, d, B, Tq, Tk, causal, kv_len, strided, amp, path = case
        q, k, v, do = hdt_bf16_operands(rnd, case)
        if strided == "+1" and q.data_ptr() % 16 == 0:
            raise RuntimeError("the misaligned case is 16-byte aligned")
        kw = dict(causal=causal, kv_len=kv_len)
        took, res = on_paths(torch, fwd, lambda p: fwd(
            q, k, v, B, path=p, **kw))
        want_path = fa.fwd_bf16_path(q, k, v, res[took][0][0], batch=B)
        po, plse = fa.flash_attention_hdt_plain(q, k, v, B, **kw)
        # delta in f32 from the bf16 o, as _FlashHdt.backward takes it
        delta = (do.float() * po.float()).sum(1, keepdim=True)
        args = (q, k, v, plse, delta, do, B)
        took_b, res_b = on_paths(torch, bwd, lambda p: bwd(
            *args, path=p, **kw))
        want = fa.flash_attention_hdt_bwd_plain(*args, **kw)
        want_b = fa.bwd_bf16_path(*args[:3], do, *res_b[took_b][0], plse,
                                  delta, batch=B)
        torch.cuda.synchronize()
        tag = (f"H={H} d={d} B={B} Tq={Tq} Tk={Tk} causal={causal} "
               f"kv_len={kv_len} strided={strided} q, k x{amp}")
        log(f"[compare] flash_attention_hdt_bf16 {tag}: the forward took the "
            f"{took} path (fwd_bf16_path: {want_path}), the backward the "
            f"{took_b} path (bwd_bf16_path: {want_b})")
        if (took, took_b) != (want_path, want_b):
            raise RuntimeError(f"bf16 flash took {took}, {took_b}, expected "
                               f"{want_path}, {want_b}")
        for p, ((o, lse), same_f) in res.items():
            ro, el = tile_rel_err([o], [po]), max_err(lse, plse)
            log(f"[compare] flash_attention_hdt_bf16 {tag}: forward on the "
                f"{p} path (forced): o {ro:.3g} of its tile's max |plain| "
                f"(tol {BF16_RTOL:g}), lse max abs err {el:.3g} (tol "
                f"{FA_TOL:g}); two runs bit-identical: {same_f}")
            if not (ro <= BF16_RTOL and el <= FA_TOL):
                raise RuntimeError(f"bf16 flash kernel ({p}) disagrees: "
                                   f"{ro}, {el}")
            if o.dtype != bf or not same_f:
                raise RuntimeError(f"bf16 flash forward ({p}): o not bf16, "
                                   f"or not deterministic")
            note("flash_attention_hdt_bf16", path, max_err(o, po))
        note("flash_attention_hdt_bwd_bf16", path,
             check_bwd_paths(f"flash_attention_hdt_bwd_bf16 {tag}", res_b,
                             want))
        if path == "train":
            # the compare must refuse a kernel that drops a key tile late,
            # against the plain version and against the wgmma kernels'
            # o and dq
            fo, fdq = skipped_key_tile(fa, q, k, v, plse, delta, do, B, Tq)
            fault = (tile_rel_err([fo], [po]), tile_rel_err([fdq], [want[0]]),
                     tile_rel_err([fo], [res["wgmma"][0][0]]),
                     tile_rel_err([fdq], [res_b["wgmma"][0][0]]))
            whole = (rel_err(fo, po), max_err(fdq, want[0]) / max(
                float(w.float().abs().max()) for w in want))
            log(f"[fault] flash bf16, the last row tile skipping the first "
                f"key tile: o {fault[0]:.3g}, dq {fault[1]:.3g} of their "
                f"tile's max |plain|, o {fault[2]:.3g}, dq {fault[3]:.3g} of "
                f"the wgmma kernels' (tol {BF16_RTOL:g}); of max |plain| over "
                f"the whole output: o {whole[0]:.3g}, dq {whole[1]:.3g}")
            if not min(fault) > BF16_RTOL:
                raise RuntimeError(f"the bf16 flash compare passes a "
                                   f"skipped key tile: {fault}")


def compare_flash_bhtd_bf16(torch, rnd, note):
    """Phase 3's compares of the bf16 [B, H, T, d] flash (the AMP
    fuse_block path's recompute): FLASH_BHTD_BF16_CASES on every path,
    against the head-major call on the same data, and the planted fault."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    # the bf16 [B, H, T, d] flash (FLASH_BHTD_BF16_CASES) against its plain
    # versions in bf16 (by each head's tile, on head-major copies) and
    # against the head-major bf16 call on the same data.  The forward and
    # the backward run on every path the operands admit, forced.  On a path
    # both calls take they must give the head-major call's bits (the same
    # products in the same order, whichever layout the strides pick);
    # where the two calls' own choices cross paths (a head-major copy whose
    # T is not a multiple of 8 takes sync), their outputs are held to each
    # other at BF16_RTOL by tile (and FA_TOL on lse)
    for case in FLASH_BHTD_BF16_CASES:
        H, d, B, Tq, Tk, causal, layout, amp, path = case
        q, k, v, do = bhtd_bf16_operands(rnd, case)
        if layout == "bthd+1" and q.data_ptr() % 16 == 0:
            raise RuntimeError("the misaligned case is 16-byte aligned")
        fwd, fwd_h = fa.flash_attention_bf16, fa.flash_attention_hdt_bf16
        bwd, bwd_h = fa.flash_attention_bwd_bf16, \
            fa.flash_attention_hdt_bwd_bf16
        took, res = on_paths(torch, fwd, lambda p: fwd(
            q, k, v, causal, path=p))
        want_path = fa.fwd_bf16_path(q, k, v, res[took][0][0])
        po, plse = fa.flash_attention_plain(q, k, v, causal)
        delta = (do.float() * po.float()).sum(-1)
        args = (q, k, v, plse, delta, do, causal)
        took_b, res_b = on_paths(torch, bwd, lambda p: bwd(*args, path=p))
        want_b = fa.bwd_bf16_path(q, k, v, do, *res_b[took_b][0], plse,
                                  delta)
        want = fa.flash_attention_bwd_plain(*args)
        qh, kh, vh, doh = map(head_major, (q, k, v, do))
        lse_h = plse.permute(1, 0, 2).reshape(H, 1, B * Tq).contiguous()
        delta_h = delta.permute(1, 0, 2).reshape(H, 1, B * Tq).contiguous()
        took_h, res_h = on_paths(torch, fwd_h, lambda p: fwd_h(
            qh, kh, vh, B, causal=causal, path=p))
        took_hb, res_hb = on_paths(torch, bwd_h, lambda p: bwd_h(
            qh, kh, vh, lse_h, delta_h, doh, B, causal=causal, path=p))
        torch.cuda.synchronize()

        def hm_lse(t):
            return t.permute(1, 0, 2).reshape(H, 1, B * Tq)

        def held(p, outs, res_hm, took_hm):
            """(ok, what) of head-major outputs outs on path p against the
            head-major call: its bits where it took p too, else within
            BF16_RTOL by tile of its own path's outputs (the forward's
            (o, lse): o by tile, lse within FA_TOL)"""
            if p in res_hm:
                same = all(torch.equal(a, b)
                           for a, b in zip(outs, res_hm[p][0]))
                return same, f"the same path: bits {same}"
            mine = res_hm[took_hm][0]
            if len(outs) == 2:
                rh, eh = tile_rel_err(outs[:1], mine[:1]), \
                    max_err(outs[1], mine[1])
                return (rh <= BF16_RTOL and eh <= FA_TOL,
                        f"its {took_hm} path: o {rh:.3g} by tile (tol "
                        f"{BF16_RTOL:g}), lse {eh:.3g} (tol {FA_TOL:g})")
            rh = tile_rel_err(outs, mine)
            return rh <= BF16_RTOL, (f"its {took_hm} path: {rh:.3g} by tile "
                                     f"(tol {BF16_RTOL:g})")

        tag = (f"({layout}) H={H} d={d} B={B} Tq={Tq} Tk={Tk} "
               f"causal={causal} q, k x{amp}")
        log(f"[compare] flash_attention_bf16 [B,H,T,d] {tag}: the forward "
            f"took the {took} path (fwd_bf16_path: {want_path}), its "
            f"head-major copy the {took_h} path; the backward the {took_b} "
            f"path (bwd_bf16_path: {want_b}), the copy's the {took_hb} path")
        if (took, took_b) != (want_path, want_b):
            raise RuntimeError(f"bf16 [B,H,T,d] flash took {took}, {took_b}, "
                               f"expected {want_path}, {want_b}")
        for p, ((o, lse), same_f) in res.items():
            ro, el = tile_rel_err([head_major(o)], [head_major(po)]), \
                max_err(lse, plse)
            ok_h, what = held(p, (head_major(o), hm_lse(lse)), res_h, took_h)
            log(f"[compare] flash_attention_bf16 [B,H,T,d] {tag}: forward on "
                f"the {p} path (forced): o {ro:.3g} of its tile's max "
                f"|plain| (tol {BF16_RTOL:g}), lse max abs err {el:.3g} (tol "
                f"{FA_TOL:g}); two runs bit-identical: {same_f}; against "
                f"the head-major call on {what}")
            if not (ro <= BF16_RTOL and el <= FA_TOL):
                raise RuntimeError(f"bf16 [B,H,T,d] flash ({p}) disagrees: "
                                   f"{ro}, {el}")
            if o.dtype != bf or not same_f or not ok_h:
                raise RuntimeError(f"bf16 [B,H,T,d] flash ({p}): o not bf16, "
                                   f"not deterministic, or not the "
                                   f"head-major call's: {what}")
            note("flash_attention_bf16", path, max_err(o, po))
        note("flash_attention_bwd_bf16", path,
             check_bwd_paths(f"flash_attention_bwd_bf16 [B,H,T,d] {tag}",
                             res_b, want, head_major))
        for p, (got, _) in res_b.items():
            ok_h, what = held(p, tuple(map(head_major, got)), res_hb,
                              took_hb)
            log(f"[compare] flash_attention_bwd_bf16 [B,H,T,d] {tag}: "
                f"backward on the {p} path against the head-major call on "
                f"{what}")
            if not ok_h:
                raise RuntimeError(f"bf16 [B,H,T,d] flash backward ({p}): "
                                   f"not the head-major call's: {what}")
        if path == "train":
            fo, fdq = skipped_key_tile(fa, qh, kh, vh, lse_h, delta_h, doh,
                                       B, Tq)
            fault = (tile_rel_err([fo], [head_major(po)]),
                     tile_rel_err([fdq], [head_major(want[0])]),
                     tile_rel_err([fo], [head_major(res["wgmma"][0][0])]),
                     tile_rel_err([fdq], [head_major(res_b["wgmma"][0][0])]))
            log(f"[fault] flash bf16 [B,H,T,d], the last row tile skipping "
                f"the first key tile: o {fault[0]:.3g}, dq {fault[1]:.3g} "
                f"of their tile's max |plain|, o {fault[2]:.3g}, dq "
                f"{fault[3]:.3g} of the wgmma kernels' (tol {BF16_RTOL:g})")
            if not min(fault) > BF16_RTOL:
                raise RuntimeError(f"the bf16 [B,H,T,d] flash compare passes "
                                   f"a skipped key tile: {fault}")


def compare_fuse_block_amp(torch, rnd, note):
    """Phase 3's compares of the AMP fuse_block path's kernels: the bf16
    [B, H, T, d] flash and the bf16 block (rnd makes f32 inputs on the
    card, note records each kernel's error by path)."""
    from paddle_tpu_torch.kernels import fused_block as fb
    bf = torch.bfloat16
    compare_flash_bhtd_bf16(torch, rnd, note)

    # the bf16 block against its plain version in bf16, twice for the same
    # bits: (B, T, H, D, E, F, causal, scale of W1, vectors, path).  The
    # op's inputs: bf16 x and matrices, f32 vectors (bf16 ones, which the
    # wrapper widens, in the odd case).  Each case runs on the GEMM path
    # its operands choose (block_gemm_path: wgmma where D, E and F are
    # multiples of 8, D 264 / E 192 / F 520 among them; D 201, F 333 take
    # sync and element copies), checked by the path counters, and a
    # wgmma case again forced onto sync, which holds the same bar
    blk = fb.transformer_block_bf16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, T, H, D, E, F, causal, w1s, vectors, path in [
            (TRAIN_BATCH, TRAIN_T, 8, 512, 512, 2048, True, 1, "f32",
             "train"),
            (2, 300, 8, 512, 512, 2048, False, 1, "f32", "ragged"),
            (2, 300, 4, 512, 512, 2048, True, 1, "f32", "ragged"),
            (2, 300, 3, 264, 192, 520, True, 1, "f32", "ragged"),
            (2, 67, 2, 201, 128, 333, True, 1, "bf16", "ragged"),
            (4, 512, 8, 512, 512, 2048, True, 8, "f32", "ragged")]:
        drift = block_plan_drift(fb, B, T, D, E, F, sms)
        if drift:
            raise RuntimeError(f"the bf16 block's wgmma plan at B={B} T={T} "
                               f"D={D} E={E} F={F} is not the library's: "
                               f"{drift}")
        x, params = block_inputs(rnd, B, T, D, F, E, w1s)
        x, params = x.to(bf), bf16_block_params(params, vectors)
        want = fb.transformer_block_plain(x, params, H, causal)
        own = "wgmma" if all(n % 8 == 0 for n in (D, E, F)) else "sync"
        if own == "sync":
            odd = (x, params, H)
        for force in (None, "sync") if own == "wgmma" else (None,):
            before = (blk.launches_gemm_wgmma, blk.launches_gemm_sync)
            got = blk(x, params, H, causal, gemm_path=force)
            again = blk(x, params, H, causal, gemm_path=force)
            torch.cuda.synchronize()
            took = dict(wgmma=blk.launches_gemm_wgmma - before[0],
                        sync=blk.launches_gemm_sync - before[1])
            e, r = max_err(got, want), rel_err(got, want)
            same = torch.equal(got, again)
            log(f"[compare] transformer_block_bf16 B={B} T={T} H={H} D={D} "
                f"E={E} F={F} causal={causal} W1 x{w1s} {vectors} vectors, "
                f"GEMMs {force or 'chosen'} (calls by path {took}): max abs "
                f"err {e:.3g}, {r:.3g} of max |plain| "
                f"{float(want.float().abs().max()):.3g} (tol "
                f"{BLOCK_BF16_RTOL:g}); two runs bit-identical: {same}")
            if took != {p_: 2 * (p_ == (force or own))
                        for p_ in ("wgmma", "sync")}:
                raise RuntimeError(f"bf16 block GEMM paths {took}, expected "
                                   f"two calls on {force or own}")
            if not r <= BLOCK_BF16_RTOL:
                raise RuntimeError(f"bf16 block kernel disagrees: {r} > "
                                   f"{BLOCK_BF16_RTOL}")
            if got.dtype != bf or not same:
                raise RuntimeError("bf16 block kernel: output not bf16, or "
                                   "not deterministic")
            if force is None:
                note("transformer_block_bf16", path, e)
        if path == "train":
            cut = list(params)
            cut[9] = torch.zeros_like(cut[9])          # b1
            fault = rel_err(fb.transformer_block_plain(x, cut, H, causal),
                            want)
            log(f"[fault] block bf16 without b1: {fault:.3g} of max |plain| "
                f"(tol {BLOCK_BF16_RTOL:g})")
            if not fault > BLOCK_BF16_RTOL:
                raise RuntimeError(f"the bf16 block compare passes a block "
                                   f"without b1: {fault}")
    # the forced wgmma path where TMA cannot describe the operands (D 201)
    # raises before any launch, and no counter moves
    before = (blk.launches, blk.launches_gemm_wgmma, blk.launches_gemm_sync)
    try:
        blk(*odd, True, gemm_path="wgmma")
    except ValueError as err:
        log(f"[compare] transformer_block_bf16 forced onto wgmma at D=201: "
            f"refused ({err})")
    else:
        raise RuntimeError("the bf16 block ran its wgmma GEMMs at D 201")
    if (blk.launches, blk.launches_gemm_wgmma,
            blk.launches_gemm_sync) != before:
        raise RuntimeError("a refused bf16 block call moved its counters")


def phase_serve(torch):
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(**FLAGSHIP)
    T, V = SERVE_T, cfg.src_vocab_size
    counters = {n: wrapper(n) for n in KERNELS}
    for fn in counters.values():
        fn.launches = 0
    lnw = counters["layer_norm"]
    lnw.launches_v16 = lnw.launches_scalar = 0

    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        _, _, logits = tr.build_lm_net(cfg, T, is_test=True)
    n_params = sum(math.prod(p.shape) for p in main.all_parameters()
                   if p.trainable)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    rng = np.random.RandomState(SEED)
    batches = list(BATCHES) * 3
    requests = []
    for b in batches:
        lens = rng.randint(16, T + 1, size=b)
        toks = rng.randint(1, V, size=(b, T)).astype("int64")
        for i, n in enumerate(lens):
            toks[i, n:] = 0            # right-pad to the served length
        requests.append((toks, lens))

    with tempfile.TemporaryDirectory() as model_dir:
        ptt.io.save_inference_model(model_dir, ["tokens"], [logits], exe,
                                    main_program=main)
        pred = create_predictor(AnalysisConfig(model_dir))
        log(f"[serve] flagship LM d{cfg.d_model}/L{cfg.n_layer}/"
            f"H{cfg.n_head}/d_inner{cfg.d_inner}/V{V} T={T}: "
            f"{n_params / 1e6:.1f}M params, program ops "
            f"{len(pred.program.global_block().ops)}, on "
            f"{pred._device}")
        torch.cuda.reset_peak_memory_stats()
        pred.prepare_buckets({"tokens": requests[0][0]}, BATCHES)
        runs = len(BATCHES)
        lat = {b: [] for b in BATCHES}
        dev_ms = {b: [] for b in BATCHES}
        first_logits = None
        for r, (toks, lens) in enumerate(requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = pred.run({"tokens": toks})
            lat[len(lens)].append((time.perf_counter() - t0) * 1e3)
            runs += 1
            if out.shape != (len(lens), T, V) or not np.isfinite(out).all():
                raise RuntimeError(f"request {r}: bad logits {out.shape}")
            last = out[np.arange(len(lens)), lens - 1]
            log(f"[serve] request {r} batch {len(lens)} prompt lens "
                f"{lens.tolist()} -> next tokens "
                f"{last.argmax(-1).tolist()} ({lat[len(lens)][-1]:.1f} ms)")
            if first_logits is None:
                first_logits = last
            # device-side time of the same request, without the host
            # readback of the [B, T, V] logits
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.run({"tokens": toks}, return_numpy=False)
            torch.cuda.synchronize()
            dev_ms[len(lens)].append((time.perf_counter() - t0) * 1e3)
            runs += 1
        counts = {n: fn.launches for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        # per request: 2 layer norms per layer + the final one; one
        # attention per layer (13 and 6 for the flagship)
        want = {n: 0 for n in KERNELS}
        want.update({"layer_norm": (2 * cfg.n_layer + 1) * runs,
                     "flash_attention_hdt": cfg.n_layer * runs})
        log(f"[serve] {runs} predictor runs; kernel launches {counts} "
            f"(expected {want})")
        if counts != want:
            raise RuntimeError(f"launch counts {counts} != {want}")
        if (lnw.launches_v16, lnw.launches_scalar) != (0, 0):
            raise RuntimeError("the f32 serving path launched layer norms "
                               "on bf16 rows")

        cpu = create_predictor(AnalysisConfig(model_dir, use_gpu=False))
        toks, lens = requests[0]
        ref, = cpu.run({"tokens": toks})
        ref = ref[np.arange(len(lens)), lens - 1]
        err = float(np.abs(first_logits - ref).max())
        scale = float(np.abs(ref).max())
        log(f"[serve] request 0 GPU vs CPU plain path: max abs err "
            f"{err:.3g} over max |logit| {scale:.3g} "
            f"(tol {LOGIT_RTOL:g} x max)")
        if not err <= LOGIT_RTOL * scale:
            raise RuntimeError("GPU logits disagree with the CPU path")
        if first_logits.argmax(-1).tolist() != ref.argmax(-1).tolist():
            raise RuntimeError("GPU and CPU greedy tokens differ")

    for b in BATCHES:
        p50 = float(np.median(lat[b]))
        d50 = float(np.median(dev_ms[b]))
        log(f"[serve] batch {b}: latency p50 {p50:.2f} ms "
            f"({b * T / p50 * 1e3:.0f} tokens/s over {b}x{T} positions) "
            f"with the logits readback into pinned memory (a pageable "
            f"copy measured {PAGEABLE_READBACK_MS[b]:.2f} ms on an NVIDIA "
            f"H100 80GB HBM3 at 700.00 W); without the readback p50 "
            f"{d50:.2f} ms ({b * T / d50 * 1e3:.0f} tokens/s)")
    log(f"[serve] peak device memory {peak / 2**20:.1f} MiB")
    return counts, pred, requests[-1][0]


def decode_oracle(torch, exe, main, logits, toks):
    """The full-recompute forward of the unfused program on the card (the
    Executor, right-padded to DECODE_T): the logits [V] at the last
    position of `toks`."""
    import numpy as np
    pad = np.zeros((1, DECODE_T), np.int64)
    pad[0, :len(toks)] = toks
    out, = exe.run(main, feed={"tokens": pad,
                               "labels": np.zeros((1, DECODE_T), np.int64)},
                   fetch_list=[logits], return_numpy=False)
    return out[0, len(toks) - 1].double().cpu().numpy()


def row_error(row, want):
    """|row - want| at its largest, over max |want|."""
    import numpy as np
    return float(np.abs(row - want).max()) / float(np.abs(want).max())


def hold_to_oracle(oracle, seqs):
    """Each (label, prompt, tokens, engine logits rows) sequence against
    the oracle, token by token: the engine's greedy token must be the
    oracle's argmax; where they differ, the oracle's top-2 margin must be
    under DECODE_RTOL x max |logit| (a near tie), and that sequence's
    compare stops there — at most one may stop early.  The engine's whole
    logits row must also be within DECODE_RTOL x max |logit| of the
    oracle's.  Returns (positions compared, largest gap between the
    engine's logit of its token and the oracle's top logit, largest row
    error over max |logit|)."""
    import numpy as np
    compared, stopped, gap, row_err = 0, [], 0.0, 0.0
    for label, prompt, toks, rows in seqs:
        ctx = list(prompt)
        for j, (tok, row) in enumerate(zip(toks, rows)):
            want = oracle(ctx)
            scale = float(np.abs(want).max())
            top2 = np.sort(want)[-2:]
            compared += 1
            gap = max(gap, float(abs(want.max() - row[tok])))
            err = row_error(row, want)
            row_err = max(row_err, err)
            if err > DECODE_RTOL:
                raise RuntimeError(f"[decode] {label} token {j}: logits "
                                   f"{err:.3g} x max |logit| off the "
                                   f"oracle's (tol {DECODE_RTOL:g})")
            if tok != int(np.argmax(want)):
                margin = float(top2[1] - top2[0])
                log(f"[decode] {label} token {j}: engine {tok}, oracle "
                    f"{int(np.argmax(want))}, oracle top-2 margin "
                    f"{margin:.3g} (near-tie bar "
                    f"{DECODE_RTOL * scale:.3g})")
                if margin >= DECODE_RTOL * scale:
                    raise RuntimeError(f"[decode] {label} token {j} "
                                       f"differs from the oracle's")
                stopped.append(label)
                break
            ctx.append(tok)
    if len(stopped) > 1:
        raise RuntimeError(f"[decode] {len(stopped)} sequences stopped at "
                           f"a near tie: {stopped}")
    return compared, gap, row_err


def decode_engine(cfg, params):
    """bench.py's serving engine on the card over role-keyed params."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import serving
    return serving.DecodeEngine(cfg, params, max_batch=DECODE_SLOTS,
                                max_len=DECODE_MAX_LEN,
                                prompt_buckets=DECODE_BUCKETS, seed=SEED,
                                place=ptt.CUDAPlace(0))


def tf32_control_rows(torch, cfg, params, prompts):
    """The control for the decode check's row tolerance: the same engine
    with TF32 matmuls (products of 10-bit mantissas, every cuBLAS call of
    its captured graphs).  Each prompt's prefill and first decode step:
    [(context, logits row)].  TF32 is off again when it returns."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        e = decode_engine(cfg, params)
        e.prepare()
        out, first = [], []
        for s, p in enumerate(prompts):
            first.append(e.start_sequence(s, p))
            out.append((list(p), e.last_logits[0].double().cpu().numpy()))
        e.decode_step()
        host = e.last_logits.double().cpu().numpy()
        out += [(list(p) + [first[s]], host[s])
                for s, p in enumerate(prompts)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return out


def kv_bytes_needed(cfg, lengths):
    """The K/V bytes a decode step must move at these slot lengths: the
    new entry written and positions [0, length] read, K and V, f32."""
    per_pos = cfg.n_layer * cfg.n_head * cfg.d_key * 4 * 2
    return per_pos * sum(int(n) + 2 for n in lengths)


def phase_decode(torch):
    """Serving token by token: the KV-cache DecodeEngine (CUDA graphs
    captured by prepare()) and the ContinuousBatcher at bench.py's serving
    shapes, held to the full-forward oracle through the Executor, then
    bench.py's closed-loop load.  Returns (kernel launches of the
    engine's work, kernel launches of the oracle's forwards, a function
    that builds and prepares the same engine again).  Nothing of the
    phase stays on the card after it, so the later phases' peak memory is
    their own."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.serving import loadgen

    counters = {n: wrapper(n) for n in KERNELS}
    cfg = tr.TransformerConfig(**dict(FLAGSHIP,
                                      max_length=DECODE_MAX_LEN))
    V = cfg.src_vocab_size
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        _, _, logits = tr.build_lm_net(cfg, DECODE_T, is_test=True,
                                       fused_attention=False,
                                       fused_head=False)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    params = serving.extract_lm_params(main, exe.scope, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def compiles():
        m = obs_metrics.REGISTRY.get("serving_compiles_total")
        return 0.0 if m is None else m.total()

    # -- the engine's own work, counted from here to the load's end ---------
    for fn in counters.values():
        fn.launches = 0
    engine = decode_engine(cfg, params)
    c0 = compiles()
    report = engine.prepare()
    if engine.device.type != DEVICE or engine._step is None \
            or getattr(engine._step, "graph", None) is None:
        raise RuntimeError("the decode engine is not on graph replays")
    log(f"[decode] unfused flagship d{cfg.d_model}/L{cfg.n_layer}/"
        f"H{cfg.n_head}/d_inner{cfg.d_inner}/V{V}, program T {DECODE_T}, "
        f"max_len {DECODE_MAX_LEN}, {DECODE_SLOTS} slots, buckets "
        f"{list(DECODE_BUCKETS)}: prepare() captured "
        f"{compiles() - c0:.0f} graphs in {report['total_seconds']} s "
        + ", ".join(f"{k} {v * 1e3:.1f} ms"
                    for k, v in engine.capture_seconds.items()))
    if compiles() - c0 != len(DECODE_BUCKETS) + 1:
        raise RuntimeError("prepare() did not capture every bucket and "
                           "the step")

    # four prompts, one per slot, and a backfill: held to the oracle below
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, V, n).tolist() for n in DECODE_PROMPTS]
    toks = {s: [] for s in range(len(prompts))}
    rows = {s: [] for s in range(len(prompts))}

    def note(slot, tok, row):
        toks[slot].append(tok)
        rows[slot].append(row)

    for s, p in enumerate(prompts):
        note(s, engine.start_sequence(s, p),
             engine.last_logits[0].double().cpu().numpy())
    seqs_done = {}
    backfill = rng.randint(1, V, DECODE_BACKFILL).tolist()
    for step in range(2 * DECODE_NEW - 1):
        if step == 3:
            # retire slot 1 mid-decode and backfill it
            seqs_done["slot 1"] = (prompts[1], toks[1], rows[1])
            engine.retire_slot(1)
            toks[1], rows[1] = [], []
            note(1, engine.start_sequence(1, backfill),
                 engine.last_logits[0].double().cpu().numpy())
        out = engine.decode_step()
        host = engine.last_logits.double().cpu().numpy()
        for s, t in out.items():
            note(s, t, host[s])
    seqs = [(f"slot {s} ({len(prompts[s])} tokens)", prompts[s],
             toks[s][:DECODE_NEW], rows[s][:DECODE_NEW])
            for s in (0, 2, 3)]
    seqs.append(("slot 1 retired mid-decode",) + seqs_done["slot 1"])
    seqs.append((f"slot 1 backfilled ({DECODE_BACKFILL} tokens)", backfill,
                 toks[1][:DECODE_NEW], rows[1][:DECODE_NEW]))
    engine.reset()

    # timings: replays, steps and prefills, all slots active
    for s in range(DECODE_SLOTS):
        engine.start_sequence(s, rng.randint(1, V, 60).tolist())
    replay, step, kv_bytes = [], [], []
    for _ in range(DECODE_TIMED):
        kv_bytes.append(kv_bytes_needed(cfg, engine._lengths_host))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with engine._on_device():
            engine._step()
        torch.cuda.synchronize()
        replay.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine.decode_step()
        step.append((time.perf_counter() - t0) * 1e3)
    lens = (int(engine._lengths_host.min()) - DECODE_TIMED,
            int(engine._lengths_host.max()) - 1)
    engine.reset()
    prefill = {}
    for b in DECODE_BUCKETS:
        p = rng.randint(1, V, b - 3).tolist()
        ms = []
        for _ in range(DECODE_TIMED // 5):
            t0 = time.perf_counter()
            engine.start_sequence(0, p)
            ms.append((time.perf_counter() - t0) * 1e3)
            engine.retire_slot(0)
        prefill[b] = float(np.median(ms))
    engine.reset()
    # the step's bytes: the weights it reads (every layer's four matrices
    # and two biases, the norms, the head, B embedding rows, B positions),
    # the K/V positions its slots' lengths need, and the logits written
    w_bytes = sum(t.nbytes for k, t in engine._params.items() if k != "emb")
    w_bytes += 2 * DECODE_SLOTS * cfg.d_model * 4
    out_bytes = DECODE_SLOTS * V * 4
    kv_need = float(np.median(kv_bytes))
    slab = engine._kv_k.nbytes
    step_bytes = w_bytes + kv_need + out_bytes
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    padded_bound = (w_bytes + 2 * slab + out_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[decode] decode-step replay p50 {np.median(replay):.3f} ms "
        f"(host clock, synchronized; {DECODE_SLOTS} slots active at "
        f"lengths {lens[0]}-{lens[1]}); whole decode_step() p50 "
        f"{np.median(step):.3f} ms (replay, sampling, the tokens' "
        f"readback); byte bound of the step {step_bound:.4f} ms "
        f"({step_bytes / 1e6:.1f} MB: {w_bytes / 1e6:.1f} MB of weights "
        f"read, {kv_need / 1e6:.1f} MB of K/V at the median step's "
        f"lengths, {out_bytes / 1e6:.1f} MB of logits) at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s; the graph reads both padded "
        f"slabs whole ({2 * slab / 1e6:.1f} MB), which would bound it at "
        f"{padded_bound:.4f} ms")
    log("[decode] prefill p50 by bucket (one replay, the first token's "
        "sampling and readback): " + ", ".join(
            f"{b}: {ms:.3f} ms" for b, ms in prefill.items()))

    # bench.py's serving load
    batcher = serving.ContinuousBatcher(engine)
    batcher.start()
    serving.attach(batcher)
    c0 = compiles()
    try:
        rep = loadgen.run_loadgen(loadgen.inproc_submit(batcher),
                                  vocab_size=V, p99_budget_ms=0.0,
                                  **DECODE_LOAD)
    finally:
        serving.reset()
    counts = {n: fn.launches for n, fn in counters.items()}
    n_req = DECODE_LOAD["streams"] * DECODE_LOAD["requests_per_stream"]
    keys = ("counts", "duration_s", "tokens_per_sec", "ttft_ms",
            "per_token_ms", "accounted")
    log(f"[decode] load {json.dumps({k: rep[k] for k in keys})}")
    if not rep["accounted"] or rep["counts"]["gave_up"] \
            or rep["counts"]["ok"] != n_req:
        raise RuntimeError(f"the serving load lost requests: "
                           f"{rep['counts']}")
    if compiles() != c0:
        raise RuntimeError(f"{compiles() - c0:.0f} graph captures on the "
                           f"request path")
    log(f"[decode] kernel launches of the engine's work (prepare, the "
        f"checked decode, the timings, the load) {counts}: none expected")
    if any(counts.values()):
        raise RuntimeError("the decode engine launched kernels of this "
                           "repo")
    peak = torch.cuda.max_memory_allocated()
    smi = nvidia_smi_line()
    log(f"[decode] {smi}: {rep['tokens_per_sec']:.1f} generated tokens/s "
        f"({rep['counts']['tokens']} tokens, {n_req} requests, "
        f"{DECODE_LOAD['streams']} streams, {rep['duration_s']} s); TTFT "
        f"p50 {rep['ttft_ms']['p50']:.2f} ms p99 "
        f"{rep['ttft_ms']['p99']:.2f} ms; per token p50 "
        f"{rep['per_token_ms']['p50']:.2f} ms p99 "
        f"{rep['per_token_ms']['p99']:.2f} ms; no capture during the load")
    log(f"[decode] {smi}: peak device memory {peak / 2**20:.1f} MiB; K/V "
        f"slabs {slab / 2**20:.1f} MiB each ({slab} bytes)")
    del batcher, engine
    control = tf32_control_rows(torch, cfg, params, prompts + [backfill])

    # -- the oracle: the Executor's full forward, counted on its own --------
    memo = {}

    def oracle(ctx):
        key = tuple(ctx)
        if key not in memo:
            memo[key] = decode_oracle(torch, exe, main, logits, ctx)
        return memo[key]

    for fn in counters.values():
        fn.launches = 0
    compared, gap, row_err = hold_to_oracle(oracle, seqs)
    log(f"[decode] greedy tokens held to the Executor's full forward: "
        f"{compared} positions compared over {len(seqs)} sequences; "
        f"largest gap between the engine's logit of its token and the "
        f"oracle's top logit {gap:.3g}; largest logits-row error "
        f"{row_err:.3g} x max |logit| (tol {DECODE_RTOL:g})")
    ctl = [row_error(row, oracle(ctx)) for ctx, row in control]
    log(f"[decode] TF32 control engine: logits-row errors "
        f"{min(ctl):.3g}-{max(ctl):.3g} x max |logit| over {len(ctl)} "
        f"positions (prefills and first steps); the check's tolerance "
        f"{DECODE_RTOL:g} must refuse every one")
    if not min(ctl) > DECODE_RTOL:
        raise RuntimeError("the decode row check passes a TF32 engine")
    oracle_counts = {n: fn.launches for n, fn in counters.items()}
    want = {n: 0 for n in KERNELS}
    want["layer_norm"] = (2 * cfg.n_layer + 1) * len(memo)
    log(f"[decode] kernel launches of the oracle's {len(memo)} forwards "
        f"{oracle_counts} (expected {want})")
    if oracle_counts != want:
        raise RuntimeError(f"decode oracle launch counts {oracle_counts} "
                           f"!= {want}")

    # each engine's stream got a cuBLAS workspace of its own: free them,
    # so the later phases' peak memory is their own
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()

    def remake():
        e = decode_engine(cfg, params)
        e.prepare()
        return e
    return counts, oracle_counts, remake


def build_train(cfg, fuse_block=False, amp=False, T=TRAIN_T, clip=None,
                regularization=None):
    """The flagship training program: (main, startup, avg_cost, param
    grads).  With fuse_block, FLAGS_fuse_block is on while it is built and
    transpiler.maybe_fuse runs before minimize, as bench.py's _bench_lm_cfg
    does; every layer must fuse.  With amp, FLAGS_amp_bf16 is on while it
    is built, as bench.py sets it before every row (the port's program is
    the same: AMP applies when it runs).  `clip` is set on the program
    (clip.set_gradient_clip) and `regularization` given to Adam."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    old = ptt.flags.get_flag("fuse_block")
    ptt.flags.set_flag("fuse_block", fuse_block)
    try:
        with amp_bf16(amp), ptt.program_guard(main, startup):
            _, avg_cost, _ = tr.build_lm_net(cfg, T, fused_attention=True,
                                             fused_head=True)
            fused = ptt.transpiler.maybe_fuse(main)
            if clip is not None:
                ptt.clip.set_gradient_clip(clip, program=main)
            _, pg = ptt.optimizer.Adam(
                learning_rate=TRAIN_LR,
                regularization=regularization).minimize(avg_cost)
    finally:
        ptt.flags.set_flag("fuse_block", old)
    want = cfg.n_layer if fuse_block else 0
    if fused != want:
        raise RuntimeError(f"maybe_fuse fused {fused} blocks, expected "
                           f"{want}")
    return main, startup, avg_cost, pg


def phase_train(torch, fuse_block=False, amp=False):
    """Train the flagship at full width: 5 Adam steps at batch 32 on one
    batch, launch counts per step, loss falling, then the step time over 5
    more steps and the card-vs-CPU match at L 2.  With fuse_block, the
    program is the FuseBlockTranspiler's (slice 3), else slice 2's; with
    amp, built and run under FLAGS_amp_bf16 (slice 7; with fuse_block,
    slice 8)."""
    with amp_bf16(amp):
        return _phase_train(torch, fuse_block, amp)


def _phase_train(torch, fuse_block, amp):
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr
    from paddle_tpu_torch.ops import nn_ops

    from paddle_tpu_torch.kernels import flash_attention as fa
    tag = "[train" + (" fuse_block" if fuse_block else "") + (
        " amp" if amp else "") + "]"
    cfg = tr.TransformerConfig(**FLAGSHIP)
    main, startup, avg_cost, pg = build_train(cfg, fuse_block, amp)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    batch = tr.make_fake_lm_batch(cfg, TRAIN_BATCH, TRAIN_T, seed=SEED)
    ops = [op.type for op in main.global_block().ops]
    log(f"{tag} flagship LM d{cfg.d_model}/L{cfg.n_layer}/H{cfg.n_head}/"
        f"d_inner{cfg.d_inner}/V{cfg.src_vocab_size} T={TRAIN_T} batch "
        f"{TRAIN_BATCH}: {len(pg)} trainable params, {len(ops)} ops "
        f"({ops.count('adam')} adam, {ops.count('autodiff')} autodiff, "
        f"{ops.count('fused_transformer_block')} fused_transformer_block, "
        f"{ops.count('fused_mha')} fused_mha)")
    if fuse_block and {"fused_mha", "mul", "relu"} & set(ops):
        raise RuntimeError(f"the fused program keeps unfused ops: {ops}")
    if amp and any(p.dtype != "float32" for p in main.all_parameters()):
        raise RuntimeError("the AMP program declares non-f32 params")
    # the input dtype of each layer norm of the first step
    ln_rows, ln_dtypes = nn_ops._layer_norm_rows, []

    def ln_record(x2d, *args):
        # the verifier's meta evaluation (before the step runs) is not a
        # layer norm of the step
        if x2d.device.type != "meta":
            ln_dtypes.append(str(x2d.dtype)[6:])
        return ln_rows(x2d, *args)

    counters = {n: wrapper(n) for n in KERNELS}
    for fn in counters.values():
        fn.launches = 0
    head_bwd, head_fwd = (counters["lm_head_bwd_bf16"],
                          counters["lm_head_fwd_bf16"])
    for fn in (head_bwd, head_fwd):
        fn.launches_wgmma = fn.launches_sync = 0
    # the bf16 flash by path: fused_mha's head-major call, the recompute's
    # [B, T, H, d] views, their backwards and the bf16 block kernel's own
    # forward launch
    flash_paths = {n: counters[n] for n in (
        "flash_attention_hdt_bf16", "flash_attention_bf16",
        "flash_attention_hdt_bwd_bf16", "flash_attention_bwd_bf16")}
    for fn in flash_paths.values():
        fn.launches_wgmma = fn.launches_sync = 0
    block = counters["transformer_block_bf16"]
    block.launches_flash_wgmma = block.launches_flash_sync = 0
    block.launches_gemm_wgmma = block.launches_gemm_sync = 0
    lnw = counters["layer_norm"]
    lnw.launches_v16 = lnw.launches_scalar = 0
    # the (q, k, v, do) strides that autograd hands each bf16 flash
    # backward in step 0, by site
    bwd_strides = {}
    launches = {n: getattr(fa, n) for n in ("_launch_bwd", "_launch_bwd_bhtd")}

    def spy(name):
        def call(q, k, v, lse, delta, do, *args, **kw):
            if q.dtype == torch.bfloat16:
                bwd_strides.setdefault(name, set()).add(
                    tuple(tuple(t.stride()) for t in (q, k, v, do)))
            return launches[name](q, k, v, lse, delta, do, *args, **kw)
        return call

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nn_ops._layer_norm_rows = ln_record if step == 0 else ln_rows
        for name in launches if step == 0 else ():
            setattr(fa, name, spy(name))
        try:
            loss, = exe.run(main, feed=batch, fetch_list=[avg_cost])
        finally:
            nn_ops._layer_norm_rows = ln_rows
            for name, fn in launches.items():
                setattr(fa, name, fn)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss[0]))
        log(f"{tag} step {step}: loss {losses[-1]:.6f} "
            f"({step_ms[-1]:.1f} ms)")
    counts = {n: fn.launches for n, fn in counters.items()}
    # the bf16 LM-head forward's calls and backward's chunks by path:
    # every one on the wgmma path at this shape
    for n, fn in (("forward calls", head_fwd), ("backward chunks", head_bwd)):
        paths = dict(wgmma=fn.launches_wgmma, sync=fn.launches_sync)
        if amp:
            log(f"{tag} bf16 LM-head {n} by path: {paths}")
        if paths != dict(wgmma=counts[fn.__name__], sync=0):
            raise RuntimeError(f"bf16 LM-head {n} paths {paths}")
    # ... and every bf16 flash forward and backward on the wgmma path
    fpaths = {n: dict(wgmma=fn.launches_wgmma, sync=fn.launches_sync)
              for n, fn in flash_paths.items()}
    fpaths["transformer_block_bf16 (its flash launch)"] = dict(
        wgmma=block.launches_flash_wgmma, sync=block.launches_flash_sync)
    if amp:
        log(f"{tag} bf16 flash launches by path: {fpaths}")
        log(f"{tag} bf16 flash backward operand strides (q, k, v, do) of "
            f"step 0 by site: { {n: sorted(v) for n, v in bwd_strides.items()} }")
    for n, c in fpaths.items():
        if c != dict(wgmma=counts[n.split()[0]], sync=0):
            raise RuntimeError(f"bf16 flash paths of {n}: {c}")
    # ... and every bf16 block's four GEMMs on the wgmma path
    gpaths = dict(wgmma=block.launches_gemm_wgmma,
                  sync=block.launches_gemm_sync)
    if amp and fuse_block:
        log(f"{tag} bf16 block calls by GEMM path: {gpaths}")
    if gpaths != dict(wgmma=counts["transformer_block_bf16"], sync=0):
        raise RuntimeError(f"bf16 block GEMM paths {gpaths}")
    # AMP: the first layer norm takes the f32 embedding sum, every later
    # one a residual sum that stays bf16
    want_ln = (["float32"] + ["bfloat16"] * (2 * cfg.n_layer) if amp
               else ["float32"] * (2 * cfg.n_layer + 1))
    if fuse_block:   # the final layer norm: the embedding's dtype or bf16
        want_ln = ["bfloat16" if amp else "float32"]
    log(f"{tag} layer-norm inputs of step 0 by dtype: "
        f"{ {d: ln_dtypes.count(d) for d in sorted(set(ln_dtypes))} }")
    if ln_dtypes != want_ln:
        raise RuntimeError(f"layer-norm input dtypes {ln_dtypes} != "
                           f"{want_ln}")
    # ... and every layer norm on bf16 rows on the v16 path
    ln_paths = dict(v16=lnw.launches_v16, scalar=lnw.launches_scalar)
    if amp:
        log(f"{tag} layer norms on bf16 rows by path: {ln_paths}")
    if ln_paths != dict(v16=want_ln.count("bfloat16") * TRAIN_STEPS,
                        scalar=0):
        raise RuntimeError(f"layer norm bf16 paths {ln_paths}")
    peak = torch.cuda.max_memory_allocated()
    n_tok = TRAIN_BATCH * TRAIN_T
    chunk, = [op.attrs["chunk_size"] for op in main.global_block().ops
              if op.type == "fused_lm_head_loss"]
    per_step = {n: 0 for n in KERNELS}
    per_step.update({"lm_head_fwd": 1, "lm_head_bwd": -(-n_tok // chunk)})
    if fuse_block and amp:
        # the bf16 kernels of slice 3's launches; no f32 block, flash or
        # LM-head kernel and no head-major flash
        per_step.update({"transformer_block_bf16": cfg.n_layer,
                         "flash_attention_bf16": cfg.n_layer,
                         "flash_attention_bwd_bf16": cfg.n_layer,
                         "layer_norm": 1, "lm_head_fwd": 0, "lm_head_bwd": 0,
                         "lm_head_fwd_bf16": 1,
                         "lm_head_bwd_bf16": -(-n_tok // chunk)})
    elif fuse_block:
        # one block kernel per layer (its flash and layer norms run inside
        # its C entry, not through the Python wrappers); the backward
        # recompute of each block runs the [B, H, T, d] flash forward and
        # backward; the final layer norm is the one layer_norm op
        per_step.update({"transformer_block": cfg.n_layer,
                         "flash_attention": cfg.n_layer,
                         "flash_attention_bwd": cfg.n_layer,
                         "layer_norm": 1})
    elif amp:
        # the bf16 kernels, and no f32 flash or LM-head kernel
        per_step.update({"layer_norm": 2 * cfg.n_layer + 1,
                         "flash_attention_hdt_bf16": cfg.n_layer,
                         "flash_attention_hdt_bwd_bf16": cfg.n_layer,
                         "lm_head_fwd": 0, "lm_head_bwd": 0,
                         "lm_head_fwd_bf16": 1,
                         "lm_head_bwd_bf16": -(-n_tok // chunk)})
    else:
        per_step.update({"layer_norm": 2 * cfg.n_layer + 1,
                         "flash_attention_hdt": cfg.n_layer,
                         "flash_attention_hdt_bwd": cfg.n_layer})
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    log(f"{tag} {TRAIN_STEPS} steps; kernel launches {counts} (expected "
        f"{want}, per step {per_step})")
    if counts != want:
        raise RuntimeError(f"launch counts {counts} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training loss did not fall: {losses}")
    # steady-state step time: more steps on the same batch
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[avg_cost])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(step_ms[1:]))
    log(f"{tag} step time p50 {p50:.2f} ms over steps 1-"
        f"{len(step_ms) - 1} ({n_tok / p50 * 1e3:.0f} tokens/s at batch "
        f"{TRAIN_BATCH}x{TRAIN_T}); first step {step_ms[0]:.2f} ms; peak "
        f"device memory {peak / 2**20:.1f} MiB")
    if fuse_block:
        train_match_fused(torch, amp)
    else:
        train_match(torch, amp)
    return counts, dict(exe=exe, main=main, batch=batch,
                        avg_cost=avg_cost, p50_ms=p50, peak=peak,
                        ln_paths=ln_paths)


def launch_counters():
    """Every launch counter of every kernel wrapper: (wrapper name,
    attribute) -> wrapper, the .launches of each and its per-path
    .launches_* counters."""
    out = {}
    for n in KERNELS:
        fn = wrapper(n)
        for attr in vars(fn):
            if attr.startswith("launches"):
                out[(n, attr)] = fn
    return out


def zero_counters(counters):
    for (_, attr), fn in counters.items():
        setattr(fn, attr, 0)


def read_counters(counters):
    return {key: getattr(fn, key[1]) for key, fn in counters.items()}


def snapshot(scope, names):
    """Copies of the named scope tensors (on their device)."""
    return {n: scope.find_var(n).detach().clone() for n in names}


def bits_differ(a, b):
    """The names whose tensors are not bit-equal between two snapshots."""
    import torch
    return sorted(n for n in a if not torch.equal(a[n], b[n]))


def state_within_train_tols(a, b, params):
    """tests/test_torch_train.py's tolerances on two states: params atol
    2e-6, moment1 rtol 1e-4 atol 1e-7, moment2 rtol 2e-4 atol 1e-10, pows
    and lr rtol 1e-6.  Returns the names outside them."""
    import torch
    bad = []
    for n in a:
        if n in params:
            tol = dict(rtol=0, atol=2e-6)
        elif n.endswith(".moment1"):
            tol = dict(rtol=1e-4, atol=1e-7)
        elif n.endswith(".moment2"):
            tol = dict(rtol=2e-4, atol=1e-10)
        else:
            tol = dict(rtol=1e-6, atol=0)
        if not torch.allclose(a[n].float(), b[n].float(), **tol):
            bad.append(n)
    return bad


def run_steps_match(torch, cfg, batch, steps, amp, T=TRAIN_T,
                    tag="[loops run_steps]"):
    """The flagship training program (build_train, with amp under
    FLAGS_amp_bf16) from one saved state in two scopes: `steps`
    sequential Executor.run calls in one, Executor.run_steps(steps,
    per_step_feeds=("tokens", "labels")) over the same batches in the
    other.  The stacked losses and the final params, moments and pows
    must be bit-equal; where they are not, one step run twice from the
    saved state tells whether the card's step is deterministic: if it is
    not, the two are held at tests/test_torch_train.py's tolerances
    (the loss at rtol 1e-5), and if it is, the smoke fails.  Every
    launch counter over the run_steps call must read `steps` times one
    run's.  Returns the numbers and the run_steps executor."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr

    main, startup, avg_cost, _ = build_train(cfg, amp=amp, T=T)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    params = {p.name for p in main.all_parameters()}
    init = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    init.run(startup)
    state = snapshot(init.scope, names)
    del init
    bs = [tr.make_fake_lm_batch(cfg, batch, T, seed=SEED + 10 + i)
          for i in range(steps)]
    slabs = {k: np.stack([b[k] for b in bs]) for k in ("tokens", "labels")}

    def fresh():
        scope = ptt.Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        return ptt.Executor(ptt.CUDAPlace(0), scope=scope)

    counters = launch_counters()
    with amp_bf16(amp):
        seq = fresh()
        zero_counters(counters)
        losses, run_ms, one_run = [], [], None
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, = seq.run(main, feed={k: v[i] for k, v in slabs.items()},
                            fetch_list=[avg_cost])
            run_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if i == 0:
                one_run = read_counters(counters)
        seq_counts = read_counters(counters)
        multi = fresh()
        zero_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked, = multi.run_steps(main, feed=slabs, fetch_list=[avg_cost],
                                   steps=steps,
                                   per_step_feeds=("tokens", "labels"))
        call_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counters(counters)
    want = {k: steps * c for k, c in one_run.items()}
    moved = {f"{n}.{a}": c for (n, a), c in counts.items() if c}
    log(f"{tag} run_steps({steps}) launches {moved}; one run's x {steps}: "
        f"{counts == want}; the {steps} runs': {seq_counts == want}")
    if counts != want or seq_counts != want:
        raise RuntimeError(f"run_steps launches {counts} != {steps} x one "
                           f"run's {one_run} (the runs': {seq_counts})")
    losses = np.stack(losses)
    if stacked.shape != losses.shape or not np.isfinite(stacked).all():
        raise RuntimeError(f"run_steps losses {stacked} against {losses}")
    end_seq, end_multi = snapshot(seq.scope, names), snapshot(
        multi.scope, names)
    differ = bits_differ(end_seq, end_multi)
    same_loss = np.array_equal(stacked, losses)
    log(f"{tag} stacked losses {stacked.ravel().tolist()}; bit-equal to "
        f"the runs': {same_loss}; {len(names) - len(differ)} of "
        f"{len(names)} persistables bit-equal")
    held = "bits"
    if differ or not same_loss:
        # is one step from the saved state deterministic on the card?
        probe = []
        for _ in range(2):
            exe = fresh()
            with amp_bf16(amp):
                exe.run(main, feed={k: v[0] for k, v in slabs.items()},
                        fetch_list=[avg_cost])
            probe.append(snapshot(exe.scope, names))
        nondet = bits_differ(*probe)
        log(f"{tag} one step run twice from the saved state: "
            f"{len(nondet)} persistables differ in their bits "
            f"({nondet[:6]})")
        if not nondet:
            raise RuntimeError(f"the card's step is deterministic, but "
                               f"run_steps differs from the runs in "
                               f"{differ[:6]} (losses equal: {same_loss})")
        bad = state_within_train_tols(end_multi, end_seq, params)
        le = float(np.abs(stacked - losses).max() / np.abs(losses).max())
        log(f"{tag} the card's step is not deterministic: held at "
            f"tests/test_torch_train.py's tolerances instead: loss rel err "
            f"{le:.3g} (tol 1e-5), persistables outside {bad[:6]}")
        if bad or not le <= 1e-5:
            raise RuntimeError(f"run_steps against the runs: {bad}, loss "
                               f"rel err {le}")
        held = "tolerances"
    return dict(exe=multi, main=main, avg_cost=avg_cost, held=held,
                counts=counts, one_run=one_run, run_ms=run_ms,
                call_ms=call_ms, feed={k: v[0] for k, v in slabs.items()},
                losses=stacked.ravel().tolist())


def time_run_steps(torch, exe, main, feed, fetch, steps=LOOP_TIMED_STEPS,
                   calls=LOOP_TIMED_CALLS):
    """bench.py's _time_steps (bench.py:139-172) on the port: one
    run_steps call of `steps` steps to warm up, then the best of `calls`
    calls, each synchronized, divided by `steps` (ms a step)."""
    best = float("inf")
    for i in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run_steps(main, feed=feed, fetch_list=[fetch], steps=steps,
                      return_numpy=False)
        torch.cuda.synchronize()
        if i:
            best = min(best, (time.perf_counter() - t0) * 1e3 / steps)
    return best


def trainer_boundary(torch, cfg, micro_batch, micro_steps, k, prefetch,
                     T=TRAIN_T, keep_share=None, tag="[loops trainer]"):
    """Trainer(accumulate_steps=k) on the unfused LM build of `cfg` (its
    dropout on), f32, Adam TRAIN_LR, on CUDAPlace(0): one epoch of
    `micro_steps` micro-batches of micro_batch x T tokens, through
    device_prefetch at depth `prefetch`.  train_func returns the loss and
    the embedding dropout's Mask as its one metric.  Every EndStepEvent
    loss must be finite; the params must be bit-equal to their previous
    values after each micro-step that is not a boundary and differ after
    each that is; the accumulation counter must read 1, 0, 1, 0, ... (k
    2); with keep_share, the Mask of micro-step 0 must keep a share
    inside it.  Each micro-step must launch 2 L + 1 f32 layer norms, one
    LM-head forward and one LM-head backward per chunk, and no other
    kernel of this repo.  Returns the numbers."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr

    def train_func():
        ptt.default_startup_program().random_seed = SEED
        _, loss, _ = tr.build_lm_net(cfg, T, fused_attention=False,
                                     fused_head=True)
        block = ptt.default_main_program().global_block()
        drop = next(op for op in block.ops if op.type == "dropout")
        return [loss, block.var(drop.outputs["Mask"][0])]

    trainer = ptt.Trainer(train_func,
                          lambda: ptt.optimizer.Adam(learning_rate=TRAIN_LR),
                          place=ptt.CUDAPlace(0), accumulate_steps=k)
    prog = trainer.train_program
    params = [p.name for p in prog.all_parameters() if p.trainable]
    counter, = [v.name for v in prog.list_vars()
                if v.name.endswith(".acc_counter")]
    ops = [op.type for op in prog.global_block().ops]
    log(f"{tag} unfused LM d{cfg.d_model}/L{cfg.n_layer}/H{cfg.n_head}/"
        f"d_inner{cfg.d_inner}/V{cfg.src_vocab_size} T={T}, dropout "
        f"{cfg.dropout}: {len(params)} trainable params, {len(ops)} ops "
        f"({ops.count('dropout')} dropout, {ops.count('adam')} adam, "
        f"{ops.count('assign')} assign); accumulate_steps {k}, "
        f"prefetch_depth {prefetch}, {micro_steps} micro-batches of "
        f"{micro_batch} x {T}")
    batches = [tr.make_fake_lm_batch(cfg, micro_batch, T, seed=SEED + 100 + i)
               for i in range(micro_steps)]

    def reader():
        for b in batches:
            yield [(b["tokens"][j], b["labels"][j])
                   for j in range(micro_batch)]

    rec = dict(prev=snapshot(trainer.scope, params), losses=[], step_ms=[],
               wait_ms=[], counter=[], frozen=[], keep=None, begin=None,
               end=None)

    def handler(e):
        if isinstance(e, ptt.BeginStepEvent):
            now = time.perf_counter()
            if rec["end"] is not None:
                rec["wait_ms"].append((now - rec["end"]) * 1e3)
            rec["begin"] = now
        elif isinstance(e, ptt.EndStepEvent):
            rec["step_ms"].append((time.perf_counter() - rec["begin"]) * 1e3)
            loss, mask = e.metrics
            rec["losses"].append(float(loss[0]))
            if e.step == 0:
                rec["keep"] = float(mask.mean())
                rec["mask_shape"] = mask.shape
            cur = snapshot(trainer.scope, params)
            moved = bits_differ(cur, rec["prev"])
            rec["frozen"].append(not moved)
            if moved and len(moved) != len(params):
                raise RuntimeError(f"micro-step {e.step} moved only "
                                   f"{len(moved)} of {len(params)} params")
            rec["prev"] = cur
            rec["counter"].append(
                float(trainer.scope.find_var(counter)[0]))
            rec["end"] = time.perf_counter()

    counters = launch_counters()
    zero_counters(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(1, handler, reader, ["tokens", "labels"],
                  prefetch_depth=prefetch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = read_counters(counters)
    trainer.stop()
    n_tok = micro_batch * T
    per_step = {("layer_norm", "launches"): 2 * cfg.n_layer + 1,
                ("lm_head_fwd", "launches"): 1,
                ("lm_head_bwd", "launches"): -(-n_tok // HEAD_CHUNK)}
    want = {key: per_step.get(key, 0) * micro_steps for key in counts}
    got = {f"{n}.{a}": c for (n, a), c in counts.items() if c}
    log(f"{tag} launches {got} over {micro_steps} micro-steps (per "
        f"micro-step { {f'{n}.{a}': c for (n, a), c in per_step.items()} })")
    if counts != want:
        raise RuntimeError(f"Trainer launches {counts} != {want}")
    losses = rec["losses"]
    log(f"{tag} EndStepEvent losses {losses}; params bit-equal to the "
        f"previous micro-step's: {rec['frozen']}; {counter}: "
        f"{rec['counter']}")
    if len(losses) != micro_steps or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"Trainer losses {losses}")
    want_frozen = [(i + 1) % k != 0 for i in range(micro_steps)]
    if rec["frozen"] != want_frozen:
        raise RuntimeError(f"params frozen {rec['frozen']}, expected "
                           f"{want_frozen}")
    want_counter = [float((i + 1) % k) for i in range(micro_steps)]
    if rec["counter"] != want_counter:
        raise RuntimeError(f"accumulation counter {rec['counter']}, "
                           f"expected {want_counter}")
    if keep_share is not None:
        lo, hi = keep_share
        log(f"{tag} micro-step 0's embedding dropout Mask "
            f"{list(rec['mask_shape'])} keeps {rec['keep']:.6f} of its "
            f"entries (bounds {lo}, {hi})")
        if not lo <= rec["keep"] <= hi:
            raise RuntimeError(f"dropout keep share {rec['keep']}")
    return dict(counts=counts, losses=losses, peak=peak,
                step_p50=float(np.median(rec["step_ms"][1:])),
                wait_p50=float(np.median(rec["wait_ms"])),
                step_ms=rec["step_ms"], wait_ms=rec["wait_ms"],
                keep=rec["keep"])


def phase_train_loops(torch):
    """The reference's training loops on the card.  (a)
    run_steps on bench.py's AMP row (the fused flagship under
    FLAGS_amp_bf16, dropout 0, batch 32) against LOOP_STEPS sequential
    runs (run_steps_match), then timed as bench.py's _time_steps times
    it, beside the runs' p50.  (b) the Trainer on the unfused flagship
    with dropout TRAINER_DROPOUT, accumulate_steps TRAINER_ACCUMULATE and
    prefetch_depth TRAINER_PREFETCH (trainer_boundary).  Returns the
    launch counts of each, by kernel."""
    import numpy as np
    from paddle_tpu_torch.models import transformer as tr

    smi = nvidia_smi_line()
    cfg = tr.TransformerConfig(**FLAGSHIP)
    rs = run_steps_match(torch, cfg, TRAIN_BATCH, LOOP_STEPS, amp=True)
    with amp_bf16():
        per_step = time_run_steps(torch, rs["exe"], rs["main"], rs["feed"],
                                  rs["avg_cost"])
    run_p50 = float(np.median(rs["run_ms"][1:]))
    log(f"[loops run_steps] AMP row, batch {TRAIN_BATCH} x {TRAIN_T}: "
        f"run_steps({LOOP_STEPS}) matched {LOOP_STEPS} runs by "
        f"{rs['held']}; the call took {rs['call_ms']:.2f} ms; timed as "
        f"bench.py's _time_steps (warm-up call, best of "
        f"{LOOP_TIMED_CALLS} calls of {LOOP_TIMED_STEPS} steps): "
        f"{per_step:.3f} ms a step ({TRAIN_BATCH * TRAIN_T / per_step * 1e3:.0f} "
        f"tokens/s), against the run loop's p50 {run_p50:.3f} ms (runs "
        f"2-{LOOP_STEPS}, each synchronized by its loss readback); {smi}")
    del rs["exe"]
    tcfg = tr.TransformerConfig(**dict(FLAGSHIP, dropout=TRAINER_DROPOUT))
    tb = trainer_boundary(torch, tcfg, TRAINER_MICRO_BATCH,
                          TRAINER_MICRO_STEPS, TRAINER_ACCUMULATE,
                          TRAINER_PREFETCH, keep_share=KEEP_SHARE)
    log(f"[loops trainer] micro-step p50 {tb['step_p50']:.2f} ms "
        f"(micro-steps 2-{TRAINER_MICRO_STEPS}, host clock from "
        f"BeginStepEvent to EndStepEvent: the step, its synchronized "
        f"readback and the guard; all {[round(x, 2) for x in tb['step_ms']]}), "
        f"data wait p50 {tb['wait_p50']:.3f} ms "
        f"(EndStepEvent to the next BeginStepEvent, prefetch depth "
        f"{TRAINER_PREFETCH}), peak device memory "
        f"{tb['peak'] / 2**20:.1f} MiB; {smi}")

    def by_kernel(counts):
        return {n: counts[(n, "launches")] for n in KERNELS}

    return {"train_run_steps": by_kernel(rs["counts"]),
            "trainer": by_kernel(tb["counts"])}


# phase 5f: verification records, the clip and decay checks
VERIFY_LOG = []          # one dict per verification the port made
VERIFY_PHASE = ["setup"]  # the phase the smoke is in, for the records
CLIP_STEPS = 3           # the identity clip held bit for bit
CLIP_FINITE_STEPS = 10   # the biting clip: the loss stays finite
CLIP_RTOL = 1e-5         # the clipped grads' global norm against clip_norm
CLIP_DECAY = 1e-4        # L2Decay beside the biting clip
VERIFY_TIMED_RUNS = 12   # runs a timing window (the first one dropped)
VERIFY_ROUNDS = 4        # timing windows of each variant, in turns
GATE_CALLS = 2000        # calls of the gate timed on a kept verdict


def record_verifications():
    """Wrap paddle_tpu_torch.analysis.verify_program, which the
    Executor's gate calls under FLAGS_verify_program=error, so that every
    verification of the run is logged with its phase, program, fed
    shapes, flags, finding counts and host time."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import analysis
    real = analysis.verify_program

    def recorded(program=None, *args, **kw):
        t0 = time.perf_counter()
        res = real(program, *args, **kw)
        VERIFY_LOG.append(dict(
            phase=VERIFY_PHASE[0], uid=program._uid,
            ops=len(program.global_block().ops),
            feeds={n: list(v) for n, v in
                   sorted((kw.get("feed_shapes") or {}).items())},
            amp=bool(ptt.flags.get_flag("amp_bf16")),
            fuse_block=any(op.type == "fused_transformer_block"
                           for op in program.global_block().ops),
            counts=res.counts(), errors=len(res.errors),
            ms=(time.perf_counter() - t0) * 1e3))
        return res
    analysis.verify_program = recorded


def in_turns(windows, rounds=VERIFY_ROUNDS):
    """Each named window (a zero-arg callable returning a number) run
    `rounds` times, in turns a b b a a b ...; the numbers by name."""
    names = list(windows)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(windows[n]())
    return out


def run_p50(torch, exe, main, feed, fetch, runs=VERIFY_TIMED_RUNS):
    """The p50 of `runs` Executor.run calls (ms, host clock, each
    synchronized by its fetch's readback), the first one dropped."""
    import numpy as np
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[fetch])
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[1:]))


def phase_verify(torch, pred, pred_feed):
    """The verifier on the card (slice 17).  (a) Every program the smoke
    ran so far went through the Executor's gate under
    FLAGS_verify_program=error (main() sets it): each verification's
    finding counts and host time, and none may have an error.  The
    Predictor's program (executor-free) is verified here with its
    request's shapes.  (b) A planted shape fault (the first FFN weight
    swapped for a [D, D] matrix) in bench.py's AMP row must raise
    ProgramVerificationError with no kernel launch and no change of
    torch.cuda.memory_allocated().  (c) On the AMP row (the fused
    flagship under FLAGS_amp_bf16, batch 32): ByGlobalNorm with a clip
    norm no grad reaches and L2Decay(0.0) must be bit-equal to the row
    without them over CLIP_STEPS steps; with clip_norm half of step 1's
    global norm and L2Decay(CLIP_DECAY) the grads the updates see, less
    the decay term, must have global norm clip_norm (in f64 from the
    fetched grads) at CLIP_RTOL, and the loss stay finite over
    CLIP_FINITE_STEPS steps; the step p50 with and without clip and decay
    in turns.  (d) The AMP row's run p50 with FLAGS_verify_program off
    and warn, in turns, and the gate's host time a call on a kept
    verdict in each mode.  Returns the numbers."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.models import transformer as tr

    smi = nvidia_smi_line()
    # (a) the gate's verifications so far, and the Predictor's program
    t0 = time.perf_counter()
    res = analysis.verify_program(
        pred.program, feed=pred.feed_names, fetch_list=pred.fetch_names,
        feed_shapes={n: tuple(np.shape(v)) for n, v in pred_feed.items()})
    pred_ms = (time.perf_counter() - t0) * 1e3
    VERIFY_LOG[-1].update(phase="serve (Predictor)")
    if res.errors:
        raise RuntimeError(f"the Predictor's program fails verification:\n"
                           f"{res.report()}")
    for r in VERIFY_LOG:
        log(f"[verify] {r['phase']}: program {r['uid']} ({r['ops']} ops"
            f"{', fuse_block' if r['fuse_block'] else ''}"
            f"{', amp_bf16' if r['amp'] else ''}) fed {r['feeds']}: "
            f"findings {r['counts']}, {r['ms']:.1f} ms")
    bad = [r for r in VERIFY_LOG if r["errors"]]
    if bad:
        raise RuntimeError(f"programs with error findings: {bad}")
    total = sum(r["ms"] for r in VERIFY_LOG)
    log(f"[verify] {len(VERIFY_LOG)} verifications of "
        f"{len({r['uid'] for r in VERIFY_LOG})} programs, none with an "
        f"error; host time {total:.1f} ms in all, the largest "
        f"{max(r['ms'] for r in VERIFY_LOG):.1f} ms; {smi}")
    n_before = len(VERIFY_LOG)

    cfg = tr.TransformerConfig(**FLAGSHIP)
    batch = tr.make_fake_lm_batch(cfg, TRAIN_BATCH, TRAIN_T, seed=SEED + 40)
    counters = launch_counters()
    with amp_bf16():
        # (b) a planted shape fault: nothing launches, nothing allocates
        main, startup, avg_cost, pg = build_train(cfg, amp=True)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        state = snapshot(exe.scope, names)
        block = main.global_block()
        w1 = next(op for op in block.ops if op.type == "mul")
        D = cfg.d_model
        block.create_parameter("planted_w", [D, D])
        good_w, w1.inputs["Y"] = w1.inputs["Y"], ["planted_w"]
        zero_counters(counters)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        try:
            exe.run(main, feed=batch, fetch_list=[avg_cost])
        except analysis.ProgramVerificationError as e:
            fault = e.result.by_code("shape_mismatch")
        else:
            raise RuntimeError("the planted shape fault ran")
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        moved = {f"{n}.{a}": c for (n, a), c in
                 read_counters(counters).items() if c}
        log(f"[verify] planted fault ({w1.outputs['Out'][0]} = "
            f"{w1.inputs['X'][0]} x planted_w [{D}, {D}]): "
            f"ProgramVerificationError with {[str(f) for f in fault]}; "
            f"launches {moved or 'none'}; memory_allocated {mem0} -> "
            f"{mem1} bytes")
        if not fault or moved or mem1 != mem0:
            raise RuntimeError(f"the planted fault: findings {fault}, "
                               f"launches {moved}, memory {mem0} -> {mem1}")
        w1.inputs["Y"] = good_w

        # (c) the clip and the decay on the AMP row
        def fresh(program_state=state):
            scope = ptt.Scope()
            for n, t in program_state.items():
                scope.set_var(n, t.clone())
            return ptt.Executor(ptt.CUDAPlace(0), scope=scope)

        def steps(program, loss, n, fetch=()):
            """n steps from the saved state; step 1 also fetches
            `fetch`.  Returns the executor and each step's fetches."""
            exe = fresh()
            out = [exe.run(program, feed=batch,
                           fetch_list=[loss] + list(fetch if i == 0
                                                    else ()),
                           return_numpy=False) for i in range(n)]
            return exe, out

        plain = build_train(cfg, amp=True)
        ident = build_train(
            cfg, amp=True, clip=ptt.clip.GradientClipByGlobalNorm(1e30),
            regularization=ptt.regularizer.L2Decay(0.0))
        for prog in (plain, ident):
            if sorted(v.name for v in prog[0].list_vars()
                      if v.persistable) != names:
                raise RuntimeError("the clip program's state differs")
        ea, la = steps(plain[0], plain[2], CLIP_STEPS)
        eb, lb = steps(ident[0], ident[2], CLIP_STEPS)
        differ = bits_differ(snapshot(ea.scope, names),
                             snapshot(eb.scope, names))
        same_loss = all(torch.equal(a[0], b[0]) for a, b in zip(la, lb))
        log(f"[verify] AMP row with ByGlobalNorm(1e30) and L2Decay(0.0) "
            f"against the row without, {CLIP_STEPS} steps: losses "
            f"bit-equal {same_loss}; {len(names) - len(differ)} of "
            f"{len(names)} persistables bit-equal")
        if differ or not same_loss:
            raise RuntimeError(f"the identity clip changed {differ[:6]} "
                               f"(losses equal: {same_loss})")
        grads = [g.name for _, g in plain[3]]
        _, (out,) = steps(plain[0], plain[2], 1, grads)
        gnorm1 = math.sqrt(sum(float((g.double() ** 2).sum())
                               for g in out[1:]))
        clip_norm = gnorm1 / 2
        bite = build_train(
            cfg, amp=True,
            clip=ptt.clip.GradientClipByGlobalNorm(clip_norm),
            regularization=ptt.regularizer.L2Decay(CLIP_DECAY))
        decays = [g + ".l2decay" for g in grads]
        eb, outs = steps(bite[0], bite[2], CLIP_FINITE_STEPS,
                         grads + decays + ["global_norm.factor"])
        first = outs[0]
        n = len(grads)
        if len(first) != 2 + 2 * n:
            raise RuntimeError(f"step 1 fetched {len(first)} values")
        clipped = math.sqrt(sum(
            float(((g.double() - d.double()) ** 2).sum())
            for g, d in zip(first[1:1 + n], first[1 + n:1 + 2 * n])))
        factor = float(first[-1])
        losses = [float(o[0]) for o in outs]
        rel = abs(clipped / clip_norm - 1)
        log(f"[verify] step 1's global norm {gnorm1:.6g} (f64 from the "
            f"{n} fetched grads); ByGlobalNorm({clip_norm:.6g}) with "
            f"L2Decay({CLIP_DECAY}): factor {factor:.6g}, the grads the "
            f"updates see less the decay have global norm {clipped:.7g} "
            f"(rel err {rel:.3g}, tol {CLIP_RTOL}); losses over "
            f"{CLIP_FINITE_STEPS} steps {[round(x, 4) for x in losses]}")
        if not rel <= CLIP_RTOL or not np.isfinite(losses).all() \
                or not factor < 1:
            raise RuntimeError(f"clipped norm {clipped} against "
                               f"{clip_norm}, factor {factor}, losses "
                               f"{losses}")
        del ea, eb, out, outs, first
        # step p50 with and without the clip and the decay, in turns
        ep, eq = fresh(), fresh()
        p50 = in_turns({
            "plain": lambda: run_p50(torch, ep, plain[0], batch, plain[2]),
            "clip_decay": lambda: run_p50(torch, eq, bite[0], batch,
                                          bite[2])})
        log(f"[verify] AMP row step p50 (ms, runs 2-{VERIFY_TIMED_RUNS} of "
            f"a window, windows in turns a b b a ...): without clip and "
            f"decay {[round(x, 3) for x in p50['plain']]}, with "
            f"ByGlobalNorm and L2Decay "
            f"{[round(x, 3) for x in p50['clip_decay']]}; {smi}")
        del ep, eq

        # (d) the run p50 with the gate off and in warn mode, in turns,
        # and the gate's own host time a run on a kept verdict
        def window(mode):
            ptt.flags.set_flag("verify_program", mode)
            try:
                return run_p50(torch, fresh(), plain[0], batch, plain[2])
            finally:
                ptt.flags.set_flag("verify_program", "error")
        modes = in_turns({m: functools.partial(window, m)
                          for m in ("off", "warn")})
        gate_us = {}
        for mode in ("off", "warn"):
            ptt.flags.set_flag("verify_program", mode)
            try:
                exe = fresh()
                exe.run(plain[0], feed=batch, fetch_list=[plain[2]])
                t0 = time.perf_counter()
                for _ in range(GATE_CALLS):
                    exe._verify_before_run(plain[0], batch, [plain[2].name],
                                           exe.scope, False)
                gate_us[mode] = (time.perf_counter() - t0) / GATE_CALLS * 1e6
            finally:
                ptt.flags.set_flag("verify_program", "error")
        log(f"[verify] AMP row run p50 (ms, windows in turns) with "
            f"verify_program off {[round(x, 3) for x in modes['off']]}, "
            f"warn {[round(x, 3) for x in modes['warn']]} (the verdict is "
            f"kept per key: one quick_lints a window, in its dropped first "
            f"run); the gate a run on a kept verdict: off "
            f"{gate_us['off']:.2f} us, warn {gate_us['warn']:.2f} us "
            f"(host clock over {GATE_CALLS} calls); {smi}")
    mine = VERIFY_LOG[n_before:]
    log(f"[verify] this phase's programs: {len(mine)} verifications, "
        f"{sum(r['errors'] for r in mine)} with an error (the planted "
        f"fault), {[round(r['ms'], 1) for r in mine]} ms")
    if sum(bool(r["errors"]) for r in mine) != 1:
        raise RuntimeError(f"phase 5f's verifications: {mine}")
    return dict(verify_ms=total, predictor_verify_ms=pred_ms,
                clip_rel_err=rel, step_p50=p50, run_p50=modes,
                gate_us=gate_us)


@contextlib.contextmanager
def replayed_relu_masks(masks):
    """Within the block every relu op computes x * mask, taking the masks
    in the order the ops run; yields the list of masks not yet taken.  The
    verifier's meta evaluation takes the plain relu and no mask."""
    import dataclasses
    from paddle_tpu_torch.framework import registry
    orig = registry.get_op_def("relu")
    left = list(masks)

    def lower(ctx, ins, attrs):
        x = registry.single_input(ins)
        if x.device.type == "meta":
            return orig.lower(ctx, ins, attrs)
        return {"Out": [x * left.pop(0).to(x.device, x.dtype)]}

    registry._REGISTRY["relu"] = dataclasses.replace(orig, lower=lower)
    try:
        yield left
    finally:
        registry._REGISTRY["relu"] = orig


def train_match(torch, amp=False):
    """One step of the training program at full width, L 2, batch 2, from
    the same weights on the card and on the CPU (the plain versions); with
    amp, under FLAGS_amp_bf16 (the caller's) at the AMP tolerances.

    The losses must agree.  Where a pre-activation lies within rounding of
    0, the two devices may take different relu branches, and the gradient
    then differs by that (token, unit)'s share.  So the step lists the
    relu flips and where the gradients differ, then runs the CPU step
    again taking the card's relu branches: every @GRAD entry must then
    agree within STEP_GRAD_RTOL of its @GRAD's max entry."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(**dict(FLAGSHIP, n_layer=2))
    main, startup, avg_cost, pg = build_train(cfg, amp=amp)
    tag = "[train amp]" if amp else "[train]"
    loss_tol = AMP_STEP_LOSS_RTOL if amp else STEP_LOSS_RTOL
    grad_tol = AMP_STEP_GRAD_RTOL if amp else STEP_GRAD_RTOL
    init = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    init.run(startup)
    state = {v.name: init.scope.find_var(v.name).numpy()
             for v in main.list_vars() if v.persistable}
    block = main.global_block()
    producer = {n: op for op in block.ops for n in op.output_names()}
    # each FFN relu's input, and the fc weight and bias behind it
    # (mul -> elementwise_add -> relu)
    relus, ffn_params = [], []
    for op in block.ops:
        if op.type == "relu":
            pre = op.inputs["X"][0]
            add = producer[pre]
            mul = producer[add.inputs["X"][0]]
            relus.append(pre)
            ffn_params.append((mul.inputs["Y"][0], add.inputs["Y"][0]))
    batch = tr.make_fake_lm_batch(cfg, 2, TRAIN_T, seed=SEED + 2)
    fetch = [avg_cost] + [gv for _, gv in pg] + relus
    n_g = len(pg)

    def step(place):
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, place)
        out = ptt.Executor(place, scope=scope).run(main, feed=batch,
                                                   fetch_list=fetch)
        return out[0][0], out[1:1 + n_g], out[1 + n_g:]

    loss, grads, pres = step(ptt.CUDAPlace(0))
    cpu_loss, cpu_grads, cpu_pres = step(ptt.CPUPlace())
    le = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    log(f"{tag} L2 batch 2 step, card vs CPU: loss {loss:.6f} vs "
        f"{cpu_loss:.6f} (rel err {le:.3g}, tol {loss_tol:g})")
    if not le <= loss_tol:
        raise RuntimeError("training loss differs between card and CPU")

    flipped_units, masks = {}, []
    for pre, (w, b), a, c in zip(relus, ffn_params, pres, cpu_pres):
        flip = (a > 0) != (c > 0)
        tok, unit = np.nonzero(flip.reshape(-1, flip.shape[-1]))
        flipped_units[w] = flipped_units[b] = set(unit.tolist())
        near = np.abs(c[flip]).max() if flip.any() else 0.0
        log(f"{tag}   relu of {w}: {int(flip.sum())} of {flip.size} "
            f"pre-activations on the other branch on the card, at (token, "
            f"unit) {list(zip(tok.tolist(), unit.tolist()))[:8]}; there "
            f"max |CPU pre-activation| {near:.3g}, against max |card - "
            f"CPU| {np.abs(a - c).max():.3g} over all of them and max "
            f"|pre-activation| {np.abs(c).max():.3g}")
        masks.append(torch.from_numpy((a > 0).astype(np.float32)))
    for (p, _), a, c in zip(pg, grads, cpu_grads):
        if a.shape != c.shape or not np.isfinite(a).all():
            raise RuntimeError(f"{p.name}@GRAD: bad card gradient")
        far = np.abs(a - c) > grad_tol * max(np.abs(c).max(), 1e-30)
        if far.any():
            where = "not an FFN weight behind a relu"
            if p.name in flipped_units:
                # the unit is the last axis of the fc weight [in, units]
                # and of its bias [units]
                units = set(np.nonzero(far)[-1].tolist())
                where = (f"in units {sorted(units)[:8]}, all of them "
                         f"flipped: {units <= flipped_units[p.name]}")
            log(f"{tag}   {p.name}@GRAD: {int(far.sum())} entries off by "
                f"more than {grad_tol:g} of its max entry (up to "
                f"{np.abs(a - c).max() / np.abs(c).max():.3g}), {where}")

    with replayed_relu_masks(masks) as left:
        r_loss, r_grads, _ = step(ptt.CPUPlace())
    if left:
        raise RuntimeError(f"{len(left)} relu masks were not replayed")
    check_replayed(tag, pg, loss, grads, r_loss, r_grads, loss_tol,
                   grad_tol)


def check_replayed(tag, pg, loss, grads, r_loss, r_grads,
                   loss_tol=STEP_LOSS_RTOL, grad_tol=STEP_GRAD_RTOL):
    """The card's L 2 step against the CPU step that took the card's relu
    branches: the loss within loss_tol, every @GRAD entry within grad_tol
    of its @GRAD's max |CPU| entry."""
    import numpy as np
    worst, worst_name = 0.0, ""
    for (p, _), a, c in zip(pg, grads, r_grads):
        r = float(np.abs(a - c).max()) / max(float(np.abs(c).max()), 1e-30)
        if r > worst:
            worst, worst_name = r, p.name
    le = abs(float(loss) - float(r_loss)) / abs(float(r_loss))
    log(f"{tag} L2 step, card vs CPU taking the card's relu branches: "
        f"loss rel err {le:.3g} (tol {loss_tol:g}); worst of "
        f"{len(pg)} @GRADs max |card - CPU| {worst:.3g} of max |CPU| "
        f"({worst_name}; tol {grad_tol:g})")
    if not le <= loss_tol:
        raise RuntimeError("training loss differs between card and CPU")
    if not worst <= grad_tol:
        raise RuntimeError(f"{worst_name}@GRAD differs between card and "
                           f"CPU: {worst}")


@contextlib.contextmanager
def block_relu(record=None, masks=None):
    """Within kernels/fused_block.block_reference (the block's plain
    forward and its backward recompute), the MLP's relu appends its f32
    pre-activation (fused_block._mlp_pre, the block's own u plan) to
    `record` (as numpy), or, given `masks`, computes pre * mask, taking
    the masks in call order; yields the masks not yet taken.  The
    verifier's meta evaluation takes the plain relu: no record, no mask."""
    import torch
    from paddle_tpu_torch.kernels import fused_block as fb
    orig = fb._mlp_hidden
    left = list(masks or [])

    def hidden(f, w1, b1):
        pre = fb._mlp_pre(f, w1, b1)
        if pre.device.type == "meta":
            return torch.relu(pre)
        if record is not None:
            record.append(pre.detach().cpu().numpy())
        if masks is None:
            return torch.relu(pre)
        return pre * left.pop(0).to(pre.device, pre.dtype)

    fb._mlp_hidden = hidden
    try:
        yield left
    finally:
        fb._mlp_hidden = orig


def train_match_fused(torch, amp=False):
    """train_match for the fuse-block program: one step at full width,
    L 2, batch 2, from the same weights on the card and on the CPU; with
    amp, under FLAGS_amp_bf16 (the caller's) at the AMP tolerances.

    The block's relu is inside fused_transformer_block, not an op, so the
    registry-level replay of train_match cannot reach it.  The gradients
    come from the backward's recompute of block_reference, which calls
    fused_block._mlp_hidden once per layer (the last layer first) on the
    card, and twice per layer on the CPU (the plain forward in layer
    order, then the recompute).  So the card step records the recompute's
    pre-activations, the flips against the CPU recompute's are listed, and
    the CPU step runs again taking the card's relu masks in both calls:
    every @GRAD entry must then agree within STEP_GRAD_RTOL of its
    @GRAD's max entry."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(**dict(FLAGSHIP, n_layer=2))
    L = cfg.n_layer
    tag = "[train fuse_block amp]" if amp else "[train fuse_block]"
    loss_tol = AMP_STEP_LOSS_RTOL if amp else STEP_LOSS_RTOL
    grad_tol = AMP_STEP_GRAD_RTOL if amp else STEP_GRAD_RTOL
    main, startup, avg_cost, pg = build_train(cfg, fuse_block=True, amp=amp)
    init = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    init.run(startup)
    state = {v.name: init.scope.find_var(v.name).numpy()
             for v in main.list_vars() if v.persistable}
    batch = tr.make_fake_lm_batch(cfg, 2, TRAIN_T, seed=SEED + 2)
    fetch = [avg_cost] + [gv for _, gv in pg]

    def step(place, **relu):
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, place)
        with block_relu(**relu) as left:
            out = ptt.Executor(place, scope=scope).run(main, feed=batch,
                                                       fetch_list=fetch)
        if left:
            raise RuntimeError(f"{len(left)} relu masks were not taken")
        return out[0][0], out[1:]

    card_pre, cpu_pre = [], []
    loss, grads = step(ptt.CUDAPlace(0), record=card_pre)
    cpu_loss, cpu_grads = step(ptt.CPUPlace(), record=cpu_pre)
    if len(card_pre) != L or len(cpu_pre) != 2 * L:
        raise RuntimeError(f"the block's relu ran {len(card_pre)} times on "
                           f"the card and {len(cpu_pre)} on the CPU, "
                           f"expected {L} and {2 * L}")
    card_pre, cpu_rec = card_pre[::-1], cpu_pre[L:][::-1]
    le = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    log(f"{tag} L2 batch 2 step, card vs CPU: loss {loss:.6f} vs "
        f"{cpu_loss:.6f} (rel err {le:.3g}, tol {loss_tol:g})")
    if not le <= loss_tol:
        raise RuntimeError("fused training loss differs between card and "
                           "CPU")
    for layer, (a, c) in enumerate(zip(card_pre, cpu_rec)):
        flip = (a > 0) != (c > 0)
        near = np.abs(c[flip]).max() if flip.any() else 0.0
        log(f"{tag}   block {layer} relu (backward "
            f"recompute): {int(flip.sum())} of {flip.size} pre-activations "
            f"on the other branch on the card, there max |CPU "
            f"pre-activation| {near:.3g}, against max |card - CPU| "
            f"{np.abs(a - c).max():.3g} over all of them")
    for (p, _), a, c in zip(pg, grads, cpu_grads):
        if a.shape != c.shape or not np.isfinite(a).all():
            raise RuntimeError(f"{p.name}@GRAD: bad card gradient")
        far = np.abs(a - c) > grad_tol * max(np.abs(c).max(), 1e-30)
        if far.any():
            log(f"{tag}   {p.name}@GRAD: {int(far.sum())} "
                f"entries off by more than {grad_tol:g} of its max "
                f"entry (up to {np.abs(a - c).max() / np.abs(c).max():.3g})"
                f" before the card's relu masks are replayed")
    masks = [torch.from_numpy((a > 0).astype(np.float32)) for a in card_pre]
    r_loss, r_grads = step(ptt.CPUPlace(), masks=masks + masks[::-1])
    check_replayed(tag, pg, loss, grads, r_loss, r_grads, loss_tol, grad_tol)


# phase 5g: ResNet-50 as bench.py's bench_resnet50 (:338-367) trains it and
# bench_resnet50_infer (:370-404) serves it
RESNET_DEPTH = 50
RESNET_IMG = (3, 224, 224)
RESNET_CLASSES = 1000
RESNET_LR, RESNET_MU = 0.1, 0.9     # bench_resnet50's Momentum(0.1, 0.9)
RESNET_CHECK_BATCH = 8     # the card-vs-CPU steps (the CPU side is the cost)
RESNET_CHECK_STEPS = 3
RESNET_BATCH = 64          # bench_resnet50's batch
RESNET_STEPS = 10
RESNET_SERVE_BATCH = 16    # bench_resnet50_infer's batch
RESNET_SERVE_TIMED = 30    # timed requests (bench.py: 30 a window)
# card vs CPU, one f32 Momentum step from the same state, by kind: the
# loss's relative error; for every velocity and every param's change
# (after less before) ||card - CPU|| / ||CPU||, the largest over the
# tensors; the same for every running stat's change.  Card and CPU
# (other convolution algorithms, f32 sums in other orders) agree on the
# forward (loss 1e-6, running stats 5e-5) and part on the gradients by
# up to 3.5e-2 (H100 80GB HBM3, 700 W): batch norm's
# backward leaves a residue of near-cancelling sums that amplifies f32
# rounding of the activations (a 1e-6 relative change of the input moves
# the card's own step by RESNET_PERTURB's logged amount).  TF32
# convolutions (cudnn.allow_tf32, PyTorch's default) move the gradients
# by 0.35-0.84, the running stats by 1.7e-2-3.2e-2 and the loss by
# 1.3e-5-1.5e-3: the control run must exceed a bound on every step.
RESNET_LOSS_RTOL = 3e-5
RESNET_GRAD_RTOL = 0.1
RESNET_STAT_RTOL = 1e-3
RESNET_PERTURB = 1e-6      # relative change of the input for the log
RESNET_PRED_RTOL = 1e-4    # the Predictor's outputs, of their max
# bench's row under AMP against f32: the loss's relative difference over
# the first RESNET_AMP_TRACK steps (readings up to 6e-3, H100 80GB HBM3,
# 700 W).  Later steps are not compared: at lr 0.1 the loss rises after
# step 2 and two f32 runs of the row part there (the card's f32 step is
# not bit-reproducible; 9.34 against 11.93 at step 9 in two runs)
RESNET_AMP_LOSS_RTOL = 5e-2
RESNET_AMP_TRACK = 3
# at bench's lr the loss on one batch falls at step 2 and then rises past
# the first (7.59 -> 4.91 -> 9.5 over 10 steps, f32 and AMP alike: lr 0.1
# with momentum 0.9 overshoots on one repeated batch), so the AMP loss is
# also held to fall over 10 steps at the lr of the JAX package's
# test_resnet_trains_under_amp_bf16 (tests/test_models.py:278)
RESNET_FALL_LR = 0.05
RESNET_PEAK_SLACK = 0.01   # peak after step 10 vs step 3, of the latter


def build_resnet(is_test=False, lr=RESNET_LR, schedule=None):
    """bench.py's ResNet-50 program, (main, startup, loss, acc,
    prediction): the training one with Momentum(lr, 0.9), or (is_test)
    bench_resnet50_infer's build.  With `schedule` (a function of the
    layers module returning an lr var, phase 5l) Momentum's lr is that
    var, returned in place of the accuracy."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        _, loss, acc, pred = resnet.build_train_net(
            class_dim=RESNET_CLASSES, img_shape=RESNET_IMG,
            depth=RESNET_DEPTH, is_test=is_test)
        if not is_test:
            if schedule is not None:
                lr = acc = schedule(ptt.layers)
            ptt.optimizer.Momentum(learning_rate=lr,
                                   momentum=RESNET_MU).minimize(loss)
    return main, startup, loss, acc, pred


def resnet_feed(batch, seed, device=None):
    """bench.py's feed: uniform images, labels in [0, class_dim), as
    numpy or as tensors on `device`."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    feed = {"img": rng.rand(batch, *RESNET_IMG).astype("float32"),
            "label": rng.randint(0, RESNET_CLASSES,
                                 (batch, 1)).astype("int64")}
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def resnet_kinds(main):
    """The persistables the steps are compared on, by kind."""
    params = main.all_parameters()
    return {"velocity": sorted(v.name for v in main.list_vars()
                               if v.name.endswith(".velocity")),
            "param": sorted(p.name for p in params if p.trainable),
            "running_stat": sorted(p.name for p in params
                                   if not p.trainable)}


def host_state(scope, names):
    return {n: scope.find_var(n).detach().float().cpu() for n in names}


def step_errors(kinds, before, want, got, want_loss, got_loss):
    """One step's errors: the loss's relative error and, by kind, the
    largest ||got - want|| / ||want|| over the tensors (velocities as they
    are, params and running stats as their change), with its tensor."""
    out = {"loss": (abs(got_loss - want_loss) / abs(want_loss), "loss")}
    for kind, names in kinds.items():
        worst = (-1.0, "")
        for n in names:
            base = 0 if kind == "velocity" else before[n].double()
            w, g = want[n].double() - base, got[n].double() - base
            err = float((g - w).norm() / w.norm().clamp_min(1e-30))
            worst = max(worst, (err, n))
        out[kind] = worst
    return out


RESNET_BOUNDS = {"loss": RESNET_LOSS_RTOL, "velocity": RESNET_GRAD_RTOL,
                 "param": RESNET_GRAD_RTOL, "running_stat": RESNET_STAT_RTOL}


def fmt_errors(errs):
    return {k: (f"{e:.3g}", n) for k, (e, n) in errs.items()}


def no_autograd_state(scope, names, tag):
    bad = [n for n in names if scope.find_var(n).requires_grad
           or scope.find_var(n).grad_fn is not None]
    if bad:
        raise RuntimeError(f"{tag}: scope tensors with autograd state: "
                           f"{bad[:5]}")


@contextlib.contextmanager
def cudnn_tf32(torch):
    """cuDNN's TF32 on for the block (PyTorch's default; main() turns it
    off)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def resnet_card_vs_cpu(torch):
    """(a) ResNet-50 at bench.py's shapes, batch RESNET_CHECK_BATCH, f32:
    RESNET_CHECK_STEPS Momentum steps on one batch on the card; before
    each, the card's state goes to a CPUPlace executor, which takes the
    same step (the plain torch ops), and a control with cudnn.allow_tf32
    on takes it on the card from the same state.  Each step is held to
    RESNET_BOUNDS and the control must exceed one of them on every step.
    A free-running CPU trajectory is not held: batch norm amplifies
    rounding (tests/test_torch_resnet.py), so two correct f32 runs part
    over steps.  Then (b) no scope tensor
    carries autograd state, and the Predictor of the trained program on
    the card against the CPU Predictor at batch RESNET_SERVE_BATCH."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    main, startup, loss, _, pred = build_resnet()
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    kinds = resnet_kinds(main)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    feed = resnet_feed(RESNET_CHECK_BATCH, SEED)
    n_train = len(kinds["param"])
    log(f"[resnet check] ResNet-{RESNET_DEPTH} {RESNET_IMG} class_dim "
        f"{RESNET_CLASSES}, batch {RESNET_CHECK_BATCH}, Momentum("
        f"{RESNET_LR}, {RESNET_MU}): {len(main.global_block().ops)} ops, "
        f"{n_train} trainable params, {len(kinds['running_stat'])} running "
        f"stats, {sum(math.prod(p.shape) for p in main.all_parameters() if p.trainable)} "
        f"weights")

    def card_step(state, feed=feed):
        ptt.io.params_from_numpy(card.scope, {n: t.numpy() for n, t in
                                              state.items()},
                                 ptt.CUDAPlace(0))
        out, = card.run(main, feed=feed, fetch_list=[loss])
        return float(out.reshape(())), host_state(card.scope, names)

    passed, failed_ctl, cpu_s = True, True, []
    for step in range(RESNET_CHECK_STEPS):
        before = host_state(card.scope, names)
        ptt.io.params_from_numpy(cpu.scope, {n: t.numpy() for n, t in
                                             before.items()},
                                 ptt.CPUPlace())
        t0 = time.perf_counter()
        out, = cpu.run(main, feed=feed, fetch_list=[loss])
        cpu_s.append(time.perf_counter() - t0)
        want_loss, want = float(out.reshape(())), host_state(cpu.scope,
                                                             names)
        with cudnn_tf32(torch):
            ctl_loss, ctl = card_step(before)
        if step == 0:    # the card's own sensitivity, for the log
            rng = np.random.RandomState(SEED)
            img = feed["img"] * (1 + RESNET_PERTURB * rng.randn(
                *feed["img"].shape)).astype("float32")
            shaken_loss, shaken = card_step(before, dict(feed, img=img))
        got_loss, got = card_step(before)
        if step == 0:
            log(f"[resnet check] the card's own step 0 with the input "
                f"changed by {RESNET_PERTURB:g} (relative, seeded): "
                f"{fmt_errors(step_errors(kinds, before, got, shaken, got_loss, shaken_loss))}")
        errs = step_errors(kinds, before, want, got, want_loss, got_loss)
        ctl_errs = step_errors(kinds, before, want, ctl, want_loss, ctl_loss)
        log(f"[resnet check] step {step}: loss card {got_loss:.7f} CPU "
            f"{want_loss:.7f} (TF32 control {ctl_loss:.7f}); card vs CPU "
            f"{fmt_errors(errs)}; TF32 control {fmt_errors(ctl_errs)}")
        passed &= all(errs[k][0] <= b for k, b in RESNET_BOUNDS.items())
        failed_ctl &= any(ctl_errs[k][0] > b
                          for k, b in RESNET_BOUNDS.items())
        if not math.isfinite(got_loss):
            raise RuntimeError(f"ResNet step {step}: loss {got_loss}")
    log(f"[resnet check] bounds {RESNET_BOUNDS}; card within them on "
        f"every step: {passed}; the TF32 control outside a bound on every "
        f"step: {failed_ctl}; CPU step "
        f"{[round(x, 2) for x in cpu_s]} s")
    if not passed:
        raise RuntimeError("the card's ResNet steps are off the CPU's")
    if not failed_ctl:
        raise RuntimeError("the TF32 control passed a bound of the ResNet "
                           "step check: the check cannot tell f32 from "
                           "TF32")
    no_autograd_state(card.scope, names, "resnet check (card)")
    no_autograd_state(cpu.scope, names, "resnet check (CPU)")
    # the softmax of the trained network saturates (loss 22 at step 3):
    # its logits (the softmax's input) are served and held beside it
    logits, = [op.inputs["X"][0] for op in main.global_block().ops
               if op.type == "softmax"]
    img = resnet_feed(RESNET_SERVE_BATCH, SEED + 2)["img"]
    with tempfile.TemporaryDirectory() as td:
        ptt.io.save_inference_model(td, ["img"], [pred, logits], card,
                                    main_program=main)
        on_card = create_predictor(AnalysisConfig(td))
        on_cpu = create_predictor(AnalysisConfig(td, use_gpu=False))
    got, want = on_card.run({"img": img}), on_cpu.run({"img": img})
    errs = [float(abs(g - w).max() / abs(w).max()) for g, w in zip(got,
                                                                  want)]
    log(f"[resnet check] Predictor of the trained program (is_test, "
        f"batch {RESNET_SERVE_BATCH}) card vs CPU: probabilities "
        f"{errs[0]:.3g} and logits {errs[1]:.3g} of their max (tolerance "
        f"{RESNET_PRED_RTOL:g}); max p {float(want[0].max()):.3f}; top-1 "
        f"agree {int((got[0].argmax(1) == want[0].argmax(1)).sum())}/"
        f"{len(got[0])}")
    if got[0].shape != (RESNET_SERVE_BATCH, RESNET_CLASSES) or not (
            max(errs) <= RESNET_PRED_RTOL):
        raise RuntimeError(f"ResNet Predictor {got[0].shape}, {errs}")


@contextlib.contextmanager
def op_ranges(torch, types):
    """Each lowering of the op types in `types` inside a record_function
    range RANGE_PREFIX + type, for attributed_ms (meta evaluations pass
    through)."""
    from paddle_tpu_torch.framework.registry import get_op_def
    defs = {t: get_op_def(t) for t in types}
    old = {t: d.lower for t, d in defs.items()}
    for t, d in defs.items():
        def lower(ctx, ins, attrs, _t=t, _f=old[t]):
            with torch.profiler.record_function(RANGE_PREFIX + _t):
                return _f(ctx, ins, attrs)
        d.lower = lower
    try:
        yield
    finally:
        for t, d in defs.items():
            d.lower = old[t]


def attributed_ms(raw, label):
    """Device ms of the kernels launched under the CPU range `label` (any
    depth below it) in one profiled call's events."""
    total = 0.0
    for e in raw:
        if not e.kernels:
            continue
        p = e
        while p is not None and p.name != label:
            p = p.cpu_parent
        if p is not None:
            total += sum(k.duration for k in e.kernels)
    return total / 1e3


def _resnet_kernel_class(name):
    """Kernel classes of the conv plane's trace (cuDNN and torch)."""
    if "(this repo)" in _kernel_class(name):
        return _kernel_class(name)
    low = name.lower()
    if any(k in low for k in ("dgrad", "wgrad", "bprop")):
        return "cuDNN conv backward"
    if any(k in low for k in ("fprop", "convolve", "conv2d", "implicit_gemm")):
        return "cuDNN conv forward"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "cuDNN layout transposes"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in ("gemm", "cutlass", "nvjet")):
        return "GEMM kernels (the fc, and cuDNN's 1x1 convolutions)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "reduce" in low:
        return "reductions (batch norm's statistics and their backward)"
    return "elementwise and other (batch norm, relu, adds, casts, Momentum)"


def resnet_train(torch, amp, lr=RESNET_LR):
    """(c) bench_resnet50's row: batch RESNET_BATCH, RESNET_STEPS steps on
    one batch already on the card, f32 or under FLAGS_amp_bf16, at `lr`;
    returns the counts of this repo's kernels over the steps and the
    numbers.  (b) the peak after step RESNET_STEPS against step 3's."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = f"[resnet train{' amp' if amp else ''} lr {lr}]"
    with amp_bf16(amp):
        main, startup, loss, _, _ = build_resnet(lr=lr)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        feed = resnet_feed(RESNET_BATCH, SEED + 1, device=DEVICE)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters = launch_counters()
        zero_counters(counters)
        losses, step_ms, peaks = [], [], {}
        for step in range(1, RESNET_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(())))
            if step in (3, RESNET_STEPS):
                peaks[step] = torch.cuda.max_memory_allocated()
        counts = {n: v for (n, attr), v in read_counters(counters).items()
                  if attr == "launches"}
    no_autograd_state(exe.scope, names, tag)
    p50 = float(np.median(step_ms[1:]))
    grew = peaks[RESNET_STEPS] - peaks[3]
    log(f"{tag} batch {RESNET_BATCH}: losses "
        f"{[round(x, 4) for x in losses]}; step p50 {p50:.2f} ms (steps "
        f"2-{RESNET_STEPS}; host clock around a synchronized run with its "
        f"loss readback), {RESNET_BATCH / p50 * 1e3:.1f} img/s; first "
        f"step {step_ms[0]:.2f} ms; peak device memory "
        f"{peaks[RESNET_STEPS] / 2**20:.1f} MiB ({(peaks[RESNET_STEPS] - base) / 2**20:.1f} "
        f"above the {base / 2**20:.1f} MiB held before), after step 3 "
        f"{peaks[3] / 2**20:.1f} MiB (grew {grew / 2**20:.1f} MiB, slack "
        f"{RESNET_PEAK_SLACK:.0%}); this repo's kernels launched "
        f"{sum(counts.values())} times; {nvidia_smi_line()}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} non-finite loss {losses}")
    if grew > RESNET_PEAK_SLACK * peaks[3]:
        raise RuntimeError(f"{tag} peak memory grew {grew} bytes from step "
                           f"3 to step {RESNET_STEPS}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(exe=exe, main=main, feed=feed, loss=loss, p50=p50,
                        peak=peaks[RESNET_STEPS], losses=losses)


def resnet_serve(torch, amp):
    """(d) bench_resnet50_infer's row: the is_test build, its startup run
    on the card, save_inference_model, the card Predictor, batch
    RESNET_SERVE_BATCH of images already on the card; the p50 of
    RESNET_SERVE_TIMED requests, each returning its probabilities as
    numpy."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    tag = f"[resnet serve{' amp' if amp else ''}]"
    with amp_bf16(amp):
        main, startup, _, _, pred = build_resnet(is_test=True)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        with tempfile.TemporaryDirectory() as td:
            ptt.io.save_inference_model(td, ["img"], [pred], exe,
                                        main_program=main)
            p = create_predictor(AnalysisConfig(td))
        feed = {"img": resnet_feed(RESNET_SERVE_BATCH, SEED + 3,
                                   device=DEVICE)["img"]}
        p.prepare(feed)
        counters = launch_counters()
        zero_counters(counters)
        ms = []
        for _ in range(RESNET_SERVE_TIMED):
            t0 = time.perf_counter()
            out, = p.run(feed)
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = {n: v for (n, attr), v in read_counters(counters).items()
                  if attr == "launches"}
    p50 = float(np.median(ms))
    log(f"{tag} batch {RESNET_SERVE_BATCH}: request p50 {p50:.3f} ms "
        f"(min {min(ms):.3f}, max {max(ms):.3f}; host clock around "
        f"Predictor.run returning the [{RESNET_SERVE_BATCH}, "
        f"{RESNET_CLASSES}] probabilities as numpy), "
        f"{RESNET_SERVE_BATCH / p50 * 1e3:.1f} img/s; {nvidia_smi_line()}")
    if out.shape != (RESNET_SERVE_BATCH, RESNET_CLASSES) or not (
            np.isfinite(out).all() and abs(out.sum(1) - 1).max() < 1e-2):
        raise RuntimeError(f"{tag} output {out.shape}, sums "
                           f"{out.sum(1)[:4]}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(predictor=p, feed=feed, p50=p50)


def phase_resnet(torch):
    """Phase 5g: train and serve ResNet-50 (bench.py's two rows): the
    card-vs-CPU check (a, b), the training row in f32 and under AMP (c),
    one traced AMP step, the serving row in f32 and under AMP (d).
    Returns the launch counts of this repo's kernels on each path (all
    zero: no kernel of this repo lies on the conv plane)."""
    resnet_card_vs_cpu(torch)
    by_path = {}
    by_path["resnet_train"], f32 = resnet_train(torch, amp=False)
    del f32["exe"]
    by_path["resnet_train_amp"], amp = resnet_train(torch, amp=True)
    gaps = [abs(a - b) / abs(b) for a, b in zip(amp["losses"],
                                                 f32["losses"])]
    log(f"[resnet] AMP loss against f32, step for step: "
        f"{[f'{g:.2g}' for g in gaps]} (bound {RESNET_AMP_LOSS_RTOL:g} on "
        f"the first {RESNET_AMP_TRACK})")
    if max(gaps[:RESNET_AMP_TRACK]) > RESNET_AMP_LOSS_RTOL:
        raise RuntimeError(f"the AMP losses left the f32 ones: {gaps}")
    by_path["resnet_train_amp_fall"], fall = resnet_train(
        torch, amp=True, lr=RESNET_FALL_LR)
    del fall["exe"]
    if not fall["losses"][-1] < fall["losses"][0]:
        raise RuntimeError(f"the AMP loss did not fall at lr "
                           f"{RESNET_FALL_LR}: {fall['losses']}")
    raw = []
    with amp_bf16(), op_ranges(torch, ("batch_norm", "momentum")):
        names = trace_run(
            torch, f"AMP ResNet-{RESNET_DEPTH} training step at batch "
                   f"{RESNET_BATCH}",
            lambda: amp["exe"].run(amp["main"], feed=amp["feed"],
                                   fetch_list=[amp["loss"]],
                                   return_numpy=False),
            classify=_resnet_kernel_class, raw=raw)
    for t, note in (("batch_norm", " (the forward; its backward runs in "
                                   "autograd, under the classes above)"),
                    ("momentum", "")):
        log(f"[trace]   kernels launched inside the {t} lowerings{note}: "
            f"{attributed_ms(raw, RANGE_PREFIX + t):.3f} ms")
    ours = [c for c in names if "(this repo)" in c]
    if ours or not names.get("cuDNN conv forward") \
            or not names.get("cuDNN conv backward"):
        raise RuntimeError(f"the AMP ResNet step's kernel classes "
                           f"{sorted(names)}: expected cuDNN convolutions "
                           f"and none of this repo's")
    del amp["exe"]
    QUANT_ROWS["resnet_train"] = f32["p50"]
    log(f"[resnet] train p50 f32 {f32['p50']:.2f} ms "
        f"({RESNET_BATCH / f32['p50'] * 1e3:.1f} img/s), AMP "
        f"{amp['p50']:.2f} ms ({RESNET_BATCH / amp['p50'] * 1e3:.1f} img/s)")
    for amp in (False, True):
        key = f"resnet_serve{'_amp' if amp else ''}"
        by_path[key], row = resnet_serve(torch, amp=amp)
        QUANT_ROWS[key] = row["p50"]
    recs = [r for r in VERIFY_LOG if r["phase"] == "resnet"]
    log(f"[resnet] the gate verified {len(recs)} programs in error mode "
        f"({[(r['ops'], r['amp'], round(r['ms'], 1)) for r in recs]}: "
        f"ops, amp, host ms), {sum(r['errors'] for r in recs)} with an "
        f"error")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"resnet verifications {recs}")
    return by_path


# phase 5h: Transformer-base NMT as bench.py's bench_nmt (:448-478) trains
# it, and BERT-base pretraining at Google's run_pretraining.py defaults
# (BertConfig() widths, seq 128, batch 32, 20 predictions a sequence)
NMT_CFG = dict(src_vocab_size=8000, tgt_vocab_size=8000, n_layer=6,
               n_head=8, d_model=512, d_inner=2048, dropout=0.0)
NMT_T = 64                  # bench_nmt's S, source and target
NMT_BATCH = 256             # bench_nmt's batch
BERT_CFG = {}                # BertConfig() at its defaults: BERT-base
BERT_T = 128
BERT_BATCH = 32
BERT_PREDS = 20
XFMR_LR = 1e-4              # bench_nmt's Adam(1e-4), and BERT's
XFMR_WARMUP = 3             # bench_nmt's warm-up runs
XFMR_RUNS = 10              # synchronized runs after them (the run p50);
                            # the AMP loss must fall over the first 10 runs
XFMR_TIMED_STEPS = 10       # time_run_steps: steps a call, timed calls
XFMR_TIMED_CALLS = 2
XFMR_CHECK_BATCH = 8        # the card-vs-CPU step (the CPU side is the cost)
NMT_SERVE_BATCH = 8         # the is_test build through the Predictor
NMT_SERVE_TIMED = 30
# card vs CPU, one f32 Adam step from the same state at batch 8 with
# ragged masks, the CPU step taking the card's relu branches: the loss's
# relative error, and ||card - CPU|| / ||CPU|| of every @GRAD, the
# largest over the params (tests/test_torch_train.py's 1e-5 and 1e-4).
# The f32 card read 0 and 2.0e-6-4.3e-6, a TF32 control 1.4e-6-1.7e-5
# and 1.4e-3-2.2e-3 against the CPU taking its branches (H100 80GB
# HBM3, 700 W); without the replay one to nine relu flips put the card's
# worst @GRAD at 2.2e-4-2.0e-3
XFMR_LOSS_RTOL = 1e-5
XFMR_GRAD_RTOL = 1e-4
XFMR_PRED_RTOL = 1e-4       # the Predictor's logits, of max |logit|
XFMR_ROWS = {}              # phase 5h's training rows, for phase 5l


def xfmr_build(model, is_test=False, check=False, schedule=None):
    """(main, startup, loss, grad names, extra fetches) of `model` ("nmt"
    or "bert") at the card shapes: bench_nmt's program with Adam(1e-4),
    or BERT-base's pretraining program with Adam(1e-4) (BERT's dropout 0
    with `check`); `is_test` builds without the optimizer.  With
    `schedule` (a function of the layers module returning an lr var,
    phase 5l), Adam's lr is that var, the last of the extra fetches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import bert, transformer
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        if model == "nmt":
            cfg = transformer.TransformerConfig(**NMT_CFG)
            _, loss, logits = transformer.build_train_net(
                cfg, src_len=NMT_T, tgt_len=NMT_T, is_test=is_test)
            extra = [logits]
        else:
            cfg = bert.BertConfig(**BERT_CFG,
                                  **({"dropout": 0.0} if check else {}))
            _, loss, extra = bert.build_pretrain_net(cfg, BERT_T,
                                                     is_test=is_test)
            extra = list(extra)
        grads = []
        if not is_test:
            lr = XFMR_LR
            if schedule is not None:
                lr = schedule(ptt.layers)
                extra.append(lr)
            _, pg = ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads, extra


def xfmr_feed(model, batch, seed, ragged=False, device=None):
    """make_fake_batch's feed of `model` at `batch`; with `ragged`, every
    other sequence padded past a seeded length (src_mask and tgt_mask, or
    input_mask, 0 there) and BERT's last 5 predictions of every other
    sequence weighted 0.  As numpy, or as tensors on `device`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import bert, transformer
    rng = np.random.RandomState(seed)
    if model == "nmt":
        cfg = transformer.TransformerConfig(**NMT_CFG)
        feed = transformer.make_fake_batch(cfg, batch, NMT_T, NMT_T,
                                           seed=seed)
        masks = ("src_mask", "tgt_mask")
    else:
        feed = bert.make_fake_batch(bert.BertConfig(**BERT_CFG), batch,
                                    BERT_T, max_preds=BERT_PREDS, seed=seed)
        masks = ("input_mask",)
        w = feed["mask_weight"].reshape(batch, BERT_PREDS)
        if ragged:
            w[::2, -5:] = 0
    if ragged:
        for k in masks:
            T = feed[k].shape[1]
            for i in range(0, batch, 2):
                feed[k][i, rng.randint(T // 4, T):] = 0
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def grad_rel_errs(want, got):
    """||got - want|| / ||want|| of each named tensor, in f64."""
    return {n: float((got[n].double() - want[n].double()).norm()
                     / want[n].double().norm().clamp_min(1e-30))
            for n in want}


def xfmr_card_vs_cpu(torch, model, schedule=None):
    """One f32 Adam step of `model` at batch XFMR_CHECK_BATCH with ragged
    masks (dropout 0), from the card's startup state, on the card, on a
    CPUPlace executor (the plain versions), and on the card with TF32
    matmuls (the control).  A pre-activation within rounding of 0 may
    take the other relu branch on one device, which moves its unit's
    column of the FFN's gradients (train_match): so the CPU step runs
    again taking the card's relu branches (replayed_relu_masks), and
    again taking the control's.  The loss's relative error and every
    @GRAD's ||card - CPU|| / ||CPU|| against the replay of the card's
    branches are held to XFMR_LOSS_RTOL and XFMR_GRAD_RTOL; the control,
    against the replay of its own, must exceed one of them.  The
    card's gather backward (BERT's MLM positions) adds with atomics: its
    sums over repeated rows are not ordered, which these norms absorb."""
    import paddle_tpu_torch as ptt
    tag = f"[{model} check{' ' + schedule.__name__ if schedule else ''}]"
    main, startup, loss, grads, _ = xfmr_build(model, check=True,
                                               schedule=schedule)
    relus = [op.inputs["X"][0] for op in main.global_block().ops
             if op.type == "relu"]
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: t.numpy() for n, t in host_state(card.scope, names).items()}
    feed = xfmr_feed(model, XFMR_CHECK_BATCH, SEED + 7, ragged=True)
    zeros = {k: int((v == 0).sum()) for k, v in feed.items()
             if k.endswith(("mask", "weight"))}
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())

    def step(exe, place, masks=None):
        """(loss, {@GRAD: host f32}, relu inputs' signs) of one step from
        `state`, each relu taking `masks`' branches where given."""
        ptt.io.params_from_numpy(exe.scope, state, place)
        replay = (replayed_relu_masks(masks) if masks is not None
                  else contextlib.nullcontext([]))
        with replay as left:
            out = exe.run(main, feed=feed, fetch_list=[loss] + grads + relus,
                          return_numpy=False)
        if left:
            raise RuntimeError(f"{tag} {len(left)} relu masks not taken")
        n = 1 + len(grads)
        return (float(out[0].float().cpu().reshape(())),
                {g: t.detach().float().cpu() for g, t in zip(grads,
                                                             out[1:n])},
                [(t > 0).cpu() for t in out[n:]])

    t0 = time.perf_counter()
    want_loss, want, cpu_signs = step(cpu, ptt.CPUPlace())
    cpu_s = time.perf_counter() - t0
    got_loss, got, card_signs = step(card, ptt.CUDAPlace(0))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl_loss, ctl, ctl_signs = step(card, ptt.CUDAPlace(0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    flips = {k: sum(int((a != b).sum()) for a, b in zip(signs, cpu_signs))
             for k, signs in (("card", card_signs), ("control", ctl_signs))}
    res = {}
    for name, l, g, signs in (("card", got_loss, got, card_signs),
                              ("TF32 control", ctl_loss, ctl, ctl_signs)):
        r_loss, r, _ = step(cpu, ptt.CPUPlace(),
                            masks=[m.float() for m in signs])
        errs = grad_rel_errs(r, g)
        worst = max(errs, key=errs.get)
        raw = grad_rel_errs(want, g)
        res[name] = (abs(l - r_loss) / abs(r_loss), errs[worst], worst,
                     max(raw.values()))
    log(f"{tag} batch {XFMR_CHECK_BATCH}, {len(grads)} @GRADs, zeros in "
        f"{zeros}: loss CPU {want_loss:.7f} card {got_loss:.7f} TF32 "
        f"control {ctl_loss:.7f}; relu branches taken apart from the CPU's "
        f"{flips} (of {sum(int(m.numel()) for m in cpu_signs)} units); "
        f"against the CPU step taking their branches: card loss "
        f"{res['card'][0]:.3g}, worst @GRAD {res['card'][1]:.3g} "
        f"({res['card'][2]}); TF32 control loss {res['TF32 control'][0]:.3g},"
        f" worst @GRAD {res['TF32 control'][1]:.3g} "
        f"({res['TF32 control'][2]}); bounds {XFMR_LOSS_RTOL:g} / "
        f"{XFMR_GRAD_RTOL:g}; without the replay the worst @GRAD is card "
        f"{res['card'][3]:.3g}, control {res['TF32 control'][3]:.3g}; CPU "
        f"step {cpu_s:.1f} s")
    if not (res["card"][0] <= XFMR_LOSS_RTOL
            and res["card"][1] <= XFMR_GRAD_RTOL):
        raise RuntimeError(f"{tag} the card's step is off the CPU's: "
                           f"{res['card']}")
    if not (res["TF32 control"][0] > XFMR_LOSS_RTOL
            or res["TF32 control"][1] > XFMR_GRAD_RTOL):
        raise RuntimeError(f"{tag} the TF32 control passed the bounds: "
                           f"the check cannot tell f32 from TF32")
    return dict(loss=res["card"][0], grad=res["card"][1],
                ctl_loss=res["TF32 control"][0],
                ctl_grad=res["TF32 control"][1], flips=flips)


def record_ln_dtypes(torch):
    """A context that records the input dtype of every layer norm on
    real rows (the verifier's meta evaluation passes through) into the
    list it yields."""
    from paddle_tpu_torch.ops import nn_ops
    rows, seen = nn_ops._layer_norm_rows, []

    def rec(x2d, *args):
        if x2d.device.type != "meta":
            seen.append(str(x2d.dtype)[6:])
        return rows(x2d, *args)

    @contextlib.contextmanager
    def ctx():
        nn_ops._layer_norm_rows = rec
        try:
            yield seen
        finally:
            nn_ops._layer_norm_rows = rows
    return ctx()


def ln_per_run(torch, main, run):
    """The layer norms one call of run() makes, by input dtype, checked
    against the program's layer_norm ops (each normalises the trailing
    axis with scale and bias, so each is a launch of the row kernel)."""
    with record_ln_dtypes(torch) as seen:
        run()
    n_ops = sum(op.type == "layer_norm" for op in main.global_block().ops)
    if len(seen) != n_ops:
        raise RuntimeError(f"{len(seen)} layer norms ran, the program has "
                           f"{n_ops} layer_norm ops")
    return {"float32": seen.count("float32"),
            "bfloat16": seen.count("bfloat16")}


def check_ln_counts(tag, counts, per_run, runs):
    """The counters of one path: layer_norm launches = the layer norms a
    run makes x runs, bf16 ones all on the v16 path, and no other kernel
    of this repo."""
    want = {k: 0 for k in counts}
    want[("layer_norm", "launches")] = sum(per_run.values()) * runs
    want[("layer_norm", "launches_v16")] = per_run["bfloat16"] * runs
    if counts != want:
        bad = {k: (counts[k], want[k]) for k in want if counts[k] != want[k]}
        raise RuntimeError(f"{tag} launches (got, expected): {bad}")
    return {n: c for (n, attr), c in counts.items() if attr == "launches"}


def xfmr_train(torch, model, amp):
    """The training row of `model` at its card shapes, f32 or under
    FLAGS_amp_bf16: the batch on the card, XFMR_WARMUP runs and
    XFMR_RUNS synchronized runs, the counters zeroed just before the
    first and read just after the last (the layer norms their dtypes
    give, no other kernel of this repo); the first run's time, the run
    p50 and peak memory; then time_run_steps as bench.py's _time_steps
    times the row."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = f"[{model} train{' amp' if amp else ''}]"
    B = NMT_BATCH if model == "nmt" else BERT_BATCH
    with amp_bf16(amp):
        main, startup, loss, grads, _ = xfmr_build(model)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        feed = xfmr_feed(model, B, SEED + 1, device=DEVICE)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters = launch_counters()
        zero_counters(counters)
        losses, ms = [], []

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(())))

        per_run = ln_per_run(torch, main, run)
        for _ in range(XFMR_WARMUP + XFMR_RUNS - 1):
            run()
        runs = XFMR_WARMUP + XFMR_RUNS
        counts = check_ln_counts(tag, read_counters(counters), per_run, runs)
        peak = torch.cuda.max_memory_allocated()
        step_ms = time_run_steps(torch, exe, main, feed, loss,
                                 steps=XFMR_TIMED_STEPS,
                                 calls=XFMR_TIMED_CALLS)
    no_autograd_state(exe.scope, names, tag)
    p50 = float(np.median(ms[XFMR_WARMUP:]))
    # bench_nmt's src + tgt count, or BERT's sequence tokens
    toks = B * 2 * NMT_T if model == "nmt" else B * BERT_T
    rate = (f"{toks / step_ms * 1e3:.0f} tokens/s (src + tgt)"
            if model == "nmt" else
            f"{B / step_ms * 1e3:.1f} sequences/s, "
            f"{toks / step_ms * 1e3:.0f} tokens/s")
    ops = [op.type for op in main.global_block().ops]
    log(f"{tag} batch {B}, {len(ops)} ops ({ops.count('adam')} adam), "
        f"{sum(math.prod(p.shape) for p in main.all_parameters() if p.trainable)} "
        f"weights: losses {[round(x, 4) for x in losses]}; run_steps "
        f"{step_ms:.2f} ms a step (time_run_steps: {XFMR_TIMED_STEPS} "
        f"steps a call, best of {XFMR_TIMED_CALLS} after one), {rate}; run "
        f"p50 {p50:.2f} ms (runs {XFMR_WARMUP + 1}-{runs}, synchronized, "
        f"with the loss readback); first run {ms[0]:.2f} ms; peak device "
        f"memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} above "
        f"the {base / 2**20:.1f} MiB held before); layer norms a run by "
        f"input dtype {per_run}; {nvidia_smi_line()}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} non-finite loss {losses}")
    if amp and not losses[XFMR_RUNS - 1] < losses[0]:
        raise RuntimeError(f"{tag} the AMP loss did not fall over "
                           f"{XFMR_RUNS} runs: {losses}")
    return counts, dict(exe=exe, main=main, feed=feed, loss=loss, p50=p50,
                        step_ms=step_ms, first_ms=ms[0], peak=peak,
                        per_run=per_run, losses=losses)


def nmt_serve(torch):
    """bench_nmt's program at is_test (no dropout, hard-label loss),
    saved for inference with its logits as the fetch and served by the
    Predictor at batch NMT_SERVE_BATCH with ragged masks: the card's
    logits against the CPU Predictor's on the same dir, then the request
    p50 with the counters zeroed just before and read just after."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    tag = "[nmt serve]"
    main, startup, _, _, (logits,) = xfmr_build("nmt", is_test=True)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    names = ["src_ids", "tgt_ids", "src_mask", "tgt_mask"]
    feed = xfmr_feed("nmt", NMT_SERVE_BATCH, SEED + 3, ragged=True)
    feed = {k: feed[k] for k in names}
    with tempfile.TemporaryDirectory() as td:
        ptt.io.save_inference_model(td, names, [logits], exe,
                                    main_program=main)
        on_card = create_predictor(AnalysisConfig(td))
        on_cpu = create_predictor(AnalysisConfig(td, use_gpu=False))
    got, = on_card.run(feed)
    want, = on_cpu.run(feed)
    err = float(abs(got - want).max() / abs(want).max())
    log(f"{tag} Predictor logits {got.shape} card vs CPU: {err:.3g} of max "
        f"|logit| {float(abs(want).max()):.3f} (tolerance "
        f"{XFMR_PRED_RTOL:g})")
    if got.shape != (NMT_SERVE_BATCH, NMT_T, NMT_CFG["tgt_vocab_size"]) \
            or not err <= XFMR_PRED_RTOL:
        raise RuntimeError(f"{tag} {got.shape}, {err}")
    dev = {k: torch.as_tensor(v, device=DEVICE) for k, v in feed.items()}
    on_card.prepare(dev)
    per_run = ln_per_run(torch, on_card.program,
                         lambda: on_card.run(dev))
    counters = launch_counters()
    zero_counters(counters)
    ms = []
    for _ in range(NMT_SERVE_TIMED):
        t0 = time.perf_counter()
        on_card.run(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = check_ln_counts(tag, read_counters(counters), per_run,
                             NMT_SERVE_TIMED)
    p50 = float(np.median(ms))
    log(f"{tag} batch {NMT_SERVE_BATCH}: request p50 {p50:.3f} ms (min "
        f"{min(ms):.3f}, max {max(ms):.3f}; host clock around "
        f"Predictor.run returning the logits as numpy), "
        f"{NMT_SERVE_BATCH * 2 * NMT_T / p50 * 1e3:.0f} tokens/s; layer "
        f"norms a request {per_run}; {nvidia_smi_line()}")
    return counts, dict(p50=p50, err=err)


def ln_d768_times(torch):
    """The layer norm at BERT-base's width (D 768, N 4096 = 32 x 128), f32
    and on bf16 rows (v16 path), cold as phase_timings times it, beside
    its plain version, F.layer_norm and its byte bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import layer_norm as ln
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    N, D = BERT_BATCH * BERT_T, 768
    gam = torch.randn(D, generator=g, device=dev)
    bet = torch.randn(D, generator=g, device=dev)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        rot = rotation(lambda: torch.randn(N, D, generator=g,
                                           device=dev).to(dt), 8)
        if dt == torch.bfloat16:
            ms, host, took = timed_on_path(
                ln.layer_norm, lambda p: ln.layer_norm(rot(), gam, bet, 1e-5,
                                                       path=p),
                None, paths=ln.BF16_PATHS)
        else:
            ms, host = time_ms(lambda: ln.layer_norm(rot(), gam, bet, 1e-5))
            took = "f32"
        plain, _ = time_ms(lambda: ln.layer_norm_plain(rot(), gam, bet,
                                                       1e-5))
        lib, _ = time_ms(lambda: F.layer_norm(rot(), (D,), gam.to(dt),
                                              bet.to(dt), 1e-5))
        del rot
        size = 2 if dt == torch.bfloat16 else 4
        nbytes = 2 * size * N * D + 2 * 4 * D + 2 * 4 * N
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        key = "bf16" if dt == torch.bfloat16 else "f32"
        res[key] = dict(N=N, D=D, path=took, ms=ms, host_ms=host,
                        plain_ms=plain, library_ms=lib, bound_ms=bound,
                        bound_by="bytes")
        log(f"[time] layer_norm N={N} D={D} {key} ({took} path): kernel "
            f"{ms:.4f} ms ({100 * bound / ms:.1f} % of the bound), plain "
            f"{plain:.4f} ms, F.layer_norm {lib:.4f} ms, bound {bound:.4f} "
            f"ms ({nbytes / 1e6:.2f} MB); host enqueue {host:.4f} ms")
    if res["bf16"]["path"] != "v16":
        raise RuntimeError(f"D 768 bf16 rows took {res['bf16']['path']}")
    return res


def phase_nmt_bert(torch):
    """Phase 5h: Transformer-base NMT (bench_nmt) and BERT-base trained on
    the card: the card-vs-CPU step with its TF32 control, the training
    rows f32 and under AMP, the NMT is_test build through the Predictor,
    and the layer norm timed at D 768.  Returns the launches by path, the
    AMP rows (traced at the end of the smoke, with the other traces) and
    the D-768 times."""
    checks = {m: xfmr_card_vs_cpu(torch, m) for m in ("nmt", "bert")}
    by_path, amp_rows, rows = {}, {}, {}
    for model in ("nmt", "bert"):
        for amp in (False, True):
            key = f"{model}_train{'_amp' if amp else ''}"
            by_path[key], row = xfmr_train(torch, model, amp)
            rows[key] = {k: row[k] for k in ("p50", "step_ms", "peak")}
            XFMR_ROWS[key] = rows[key]
            if amp:
                gaps = [abs(a - b) / abs(b) for a, b in zip(
                    row["losses"], rows[f"{model}_train"]["losses"])]
                log(f"[{model}] AMP loss against f32, run for run: "
                    f"{[f'{x:.2g}' for x in gaps]}")
                amp_rows[model] = row
            else:
                rows[key]["losses"] = row["losses"]
                del row["exe"]
        f32, amp = rows[f"{model}_train"], rows[f"{model}_train_amp"]
        log(f"[{model}] run_steps a step f32 {f32['step_ms']:.2f} ms, AMP "
            f"{amp['step_ms']:.2f} ms; peak f32 {f32['peak'] / 2**20:.1f} "
            f"MiB, AMP {amp['peak'] / 2**20:.1f} MiB")
    by_path["nmt_serve"], _ = nmt_serve(torch)
    ln_times = ln_d768_times(torch)
    recs = [r for r in VERIFY_LOG if r["phase"] == "nmt_bert"]
    log(f"[nmt_bert] the gate verified {len(recs)} programs in error mode "
        f"({[(r['ops'], r['amp'], round(r['ms'], 1)) for r in recs]}: ops, "
        f"amp, host ms), {sum(r['errors'] for r in recs)} with an error; "
        f"checks {checks}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"nmt_bert verifications {recs}")
    return by_path, amp_rows, ln_times


def trace_xfmr(torch, model, row):
    """One AMP training step of `model` traced by kernel class: the layer
    norms by kernel (f32 rows, bf16 scalar, bf16 v16) as the row's
    dtypes give them, and no other kernel of this repo."""
    B = NMT_BATCH if model == "nmt" else BERT_BATCH
    with amp_bf16():
        names = trace_run(
            torch, f"AMP {model} training step at batch {B}",
            lambda: row["exe"].run(row["main"], feed=row["feed"],
                                   fetch_list=[row["loss"]],
                                   return_numpy=False))
    kinds = ln_launch_kinds(names)
    want = {"f32": row["per_run"]["float32"], "bf16 scalar": 0,
            "bf16 v16": row["per_run"]["bfloat16"]}
    log(f"[trace]   AMP {model} step layer norms by kernel: {kinds}")
    ours = sorted(c for c in names if "(this repo)" in c
                  and c != _kernel_class("ln_fwd_kernel"))
    if kinds != want or ours:
        raise RuntimeError(f"AMP {model} step: layer norms {kinds} (want "
                           f"{want}), other kernels of this repo {ours}")


# phase 5i: DeepFM CTR as bench.py's bench_deepfm (:756-791) trains it
# (DeepFMConfig(): 39 fields, two tables of 1,000,001 rows, K 10, towers
# 400-400-400; batch 512, Adagrad(0.01)), and its hash-bucketed sparse
# build
DEEPFM_CFG = {}             # DeepFMConfig() at its defaults
DEEPFM_BATCH = 512          # bench_deepfm's batch
DEEPFM_LR = 0.01            # bench_deepfm's Adagrad(0.01)
DEEPFM_WARMUP = 2           # bench_deepfm's warm-up runs
DEEPFM_RUNS = 10            # synchronized runs after them (the run p50);
                            # the AMP loss must fall over the first 10 runs
DEEPFM_TIMED_STEPS = 10     # time_run_steps: steps a call, timed calls
DEEPFM_TIMED_CALLS = 2
DEEPFM_RAW_IDS = 2 ** 40    # the sparse build's raw ids: [0, 2^40), and
DEEPFM_NEGATIVE = 0.05      # this share of them negated
DEEPFM_CHECK_BATCH = 64     # the card-vs-CPU steps (the CPU side is the cost)
DEEPFM_DUP_ID = 123457      # planted in fields 0, 5, 17 of rows 0-7
DEEPFM_OPT_STEPS = 3        # each optimizer class, card vs CPU
DEEPFM_TOWER_LR = 0.5       # the first tower's ParamAttr.learning_rate there
DEEPFM_AVG_STEPS = 5        # Adagrad steps before ModelAverage.apply
DEEPFM_SERVE_TIMED = 30     # timed Predictor requests at DEEPFM_BATCH
# card vs CPU, one f32 step from the same state at batch 64 with planted
# duplicate ids, the CPU step taking the card's relu branches: the loss's
# relative error, and ||card - CPU|| / ||CPU|| of every @GRAD and of
# every persistable's change after the optimizer classes' 3 steps
# (tests/test_torch_train.py's 1e-5 and 1e-4)
DEEPFM_LOSS_RTOL = 1e-5
DEEPFM_GRAD_RTOL = 1e-4
DEEPFM_PRED_ATOL = 1e-5     # the Predictor's probabilities, card vs CPU
DEEPFM_AVG_RTOL = 1e-6      # ModelAverage's apply against the host mean
# the optimizer classes held card vs CPU: (class, its arguments)
DEEPFM_OPTIMIZERS = (
    ("LarsMomentum", dict(learning_rate=0.1, momentum=0.9)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.01)),
    ("Adamax", dict(learning_rate=0.01)),
    ("Adagrad", dict(learning_rate=DEEPFM_LR)),
    # its moment starts at (1 - decay) g^2, so a step is 4.5 lr / entry
    ("DecayedAdagrad", dict(learning_rate=0.001)),
    ("Adadelta", dict(learning_rate=1.0)),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    ("RMSProp", dict(learning_rate=0.01, centered=True)),
    ("Ftrl", dict(learning_rate=0.05, l1=0.01, l2=0.01)),
    ("Ftrl", dict(learning_rate=0.05, l2=0.01, lr_power=-0.7)),
    ("Lamb", dict(learning_rate=0.01)),
    ("ProximalGD", dict(learning_rate=0.05, l1=1e-3, l2=1e-3)),
    ("ProximalAdagrad", dict(learning_rate=0.05, l1=1e-3, l2=1e-3)),
)


def deepfm_build(sparse=False, opt="Adagrad", kw=None, tower_lr=None,
                 average=False):
    """(main, startup, loss, grad names, prob, ModelAverage or None) of
    bench_deepfm's program (the hash-bucketed build with `sparse`) with
    opt(**kw).minimize (Adagrad(DEEPFM_LR) by default; none with opt
    None); `tower_lr` sets the first tower's ParamAttr.learning_rate (its
    optimize_attr, as the layer's ParamAttr sets it), `average` appends a
    ModelAverage."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import deepfm
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        cfg = deepfm.DeepFMConfig(**DEEPFM_CFG)
        build = (deepfm.build_sparse_train_net if sparse
                 else deepfm.build_train_net)
        _, loss, prob = build(cfg)
        grads, ma = [], None
        if opt:
            if tower_lr is not None:
                tower = [p for p in main.all_parameters()
                         if p.name.startswith("fc_")][:2]
                for p in tower:
                    p.optimize_attr = {"learning_rate": tower_lr}
            _, pg = getattr(ptt.optimizer, opt)(
                **(kw or dict(learning_rate=DEEPFM_LR))).minimize(loss)
            grads = [g.name for _, g in pg]
            if average:
                ma = ptt.optimizer.ModelAverage()
    return main, startup, loss, grads, prob, ma


def deepfm_feed(batch, seed, sparse=False, dup=False, device=None):
    """make_fake_batch's feed at `batch`; with `sparse`, raw ids over
    [0, DEEPFM_RAW_IDS), DEEPFM_NEGATIVE of them negated; with `dup`,
    DEEPFM_DUP_ID in fields 0, 5 and 17 of rows 0-7.  As numpy, or as
    tensors on `device`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import deepfm
    cfg = deepfm.DeepFMConfig(**DEEPFM_CFG)
    feed = deepfm.make_fake_batch(cfg, batch, seed=seed)
    if sparse:
        rng = np.random.RandomState(seed)
        ids = rng.randint(0, DEEPFM_RAW_IDS, feed["feat_ids"].shape,
                          dtype=np.int64)
        ids[rng.rand(*ids.shape) < DEEPFM_NEGATIVE] *= -1
        feed["feat_ids"] = ids
    if dup:
        feed["feat_ids"][:8, [0, 5 % cfg.num_field,
                              17 % cfg.num_field]] = DEEPFM_DUP_ID
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def deepfm_relus(main):
    return [op.inputs["X"][0] for op in main.global_block().ops
            if op.type == "relu"]


def deepfm_card_vs_cpu(torch):
    """(a) One f32 Adagrad step of bench_deepfm's program at full width,
    batch DEEPFM_CHECK_BATCH with duplicate ids planted, from the card's
    startup state, on the card, on a CPUPlace executor taking the card's
    relu branches (replayed_relu_masks), and on the card with TF32
    matmuls (the control, against the CPU taking its branches): the
    loss's relative error and every @GRAD's ||card - CPU|| / ||CPU||
    within DEEPFM_LOSS_RTOL and DEEPFM_GRAD_RTOL, the control outside one
    of them.  The card's embedding backward sums a duplicate id's rows in
    another order than the CPU's (f32 rounding, inside the bounds).
    Every table row no id named, and its Adagrad moment, is bit-equal to
    its start value after the step, on the card and on the CPU."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = "[deepfm check]"
    main, startup, loss, grads, _, _ = deepfm_build()
    relus = deepfm_relus(main)
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: t.numpy() for n, t in host_state(card.scope, names).items()}
    feed = deepfm_feed(DEEPFM_CHECK_BATCH, SEED + 11, dup=True)
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    tables = [n for n in names if n.startswith(("fm_w1", "fm_emb"))
              or n.endswith((".fm_w1.moment", ".fm_emb.moment"))]
    untouched = np.setdiff1d(np.arange(state["fm_w1"].shape[0]),
                             feed["feat_ids"].ravel())

    def step(exe, place, masks=None):
        """(loss, {@GRAD: host f32}, relu signs, tables kept) of one step
        from `state`, each relu taking `masks`' branches where given."""
        ptt.io.params_from_numpy(exe.scope, state, place)
        replay = (replayed_relu_masks(masks) if masks is not None
                  else contextlib.nullcontext([]))
        with replay as left:
            out = exe.run(main, feed=feed, fetch_list=[loss] + grads + relus,
                          return_numpy=False)
        if left:
            raise RuntimeError(f"{tag} {len(left)} relu masks not taken")
        kept = all(np.array_equal(exe.scope.find_var(n).cpu().numpy()[
            untouched], state[n][untouched]) for n in tables)
        n = 1 + len(grads)
        return (float(out[0].float().cpu().reshape(())),
                {g: t.detach().float().cpu() for g, t in zip(grads,
                                                             out[1:n])},
                [(t > 0).cpu() for t in out[n:]], kept)

    t0 = time.perf_counter()
    want_loss, want, cpu_signs, cpu_kept = step(cpu, ptt.CPUPlace())
    cpu_s = time.perf_counter() - t0
    got_loss, got, card_signs, card_kept = step(card, ptt.CUDAPlace(0))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl_loss, ctl, ctl_signs, _ = step(card, ptt.CUDAPlace(0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    flips = {k: sum(int((a != b).sum()) for a, b in zip(signs, cpu_signs))
             for k, signs in (("card", card_signs), ("control", ctl_signs))}
    res = {}
    for name, l, g, signs in (("card", got_loss, got, card_signs),
                              ("TF32 control", ctl_loss, ctl, ctl_signs)):
        r_loss, r, _, _ = step(cpu, ptt.CPUPlace(),
                               masks=[m.float() for m in signs])
        errs = grad_rel_errs(r, g)
        worst = max(errs, key=errs.get)
        res[name] = (abs(l - r_loss) / abs(r_loss), errs[worst], worst,
                     max(grad_rel_errs(want, g).values()))
    log(f"{tag} DeepFMConfig({DEEPFM_CFG}), batch {DEEPFM_CHECK_BATCH}, "
        f"id {DEEPFM_DUP_ID} planted {int((feed['feat_ids'] == DEEPFM_DUP_ID).sum())} "
        f"times, {len(grads)} @GRADs: loss CPU {want_loss:.7f} card "
        f"{got_loss:.7f} TF32 control {ctl_loss:.7f}; relu branches taken "
        f"apart from the CPU's {flips} (of "
        f"{sum(int(m.numel()) for m in cpu_signs)} units); against the CPU "
        f"step taking their branches: card loss {res['card'][0]:.3g}, "
        f"worst @GRAD {res['card'][1]:.3g} ({res['card'][2]}); TF32 control"
        f" loss {res['TF32 control'][0]:.3g}, worst @GRAD "
        f"{res['TF32 control'][1]:.3g} ({res['TF32 control'][2]}); bounds "
        f"{DEEPFM_LOSS_RTOL:g} / {DEEPFM_GRAD_RTOL:g}; without the replay "
        f"the worst @GRAD is card {res['card'][3]:.3g}, control "
        f"{res['TF32 control'][3]:.3g}; {len(untouched)} untouched rows of "
        f"{tables} bit-equal after the step: card {card_kept}, CPU "
        f"{cpu_kept}; CPU step {cpu_s:.1f} s")
    if not (res["card"][0] <= DEEPFM_LOSS_RTOL
            and res["card"][1] <= DEEPFM_GRAD_RTOL):
        raise RuntimeError(f"{tag} the card's step is off the CPU's: "
                           f"{res['card']}")
    if not (res["TF32 control"][0] > DEEPFM_LOSS_RTOL
            or res["TF32 control"][1] > DEEPFM_GRAD_RTOL):
        raise RuntimeError(f"{tag} the TF32 control passed the bounds: "
                           f"the check cannot tell f32 from TF32")
    if not (card_kept and cpu_kept):
        raise RuntimeError(f"{tag} an untouched table row moved")
    return dict(loss=res["card"][0], grad=res["card"][1],
                ctl_loss=res["TF32 control"][0],
                ctl_grad=res["TF32 control"][1], flips=flips)


def deepfm_optimizers(torch):
    """(b) Each optimizer class of DEEPFM_OPTIMIZERS, the first tower at
    ParamAttr.learning_rate DEEPFM_TOWER_LR: DEEPFM_OPT_STEPS f32 steps of
    bench_deepfm's program at batch DEEPFM_CHECK_BATCH from the card's
    startup state on the card and on the CPU, the CPU taking the card's
    relu branches each step: each step's loss within DEEPFM_LOSS_RTOL,
    and every persistable within DEEPFM_GRAD_RTOL after the steps (the
    params and their change as ||card - CPU|| / ||CPU|| of the change,
    the accumulators as values); every param moved (or, under FTRL's l1
    step, is exactly 0)."""
    import paddle_tpu_torch as ptt
    tag = "[deepfm optimizers]"
    feeds = [deepfm_feed(DEEPFM_CHECK_BATCH, SEED + 20 + i, dup=True)
             for i in range(DEEPFM_OPT_STEPS)]
    rows, cpu_s = [], 0.0
    for opt, kw in DEEPFM_OPTIMIZERS:
        main, startup, loss, _, _, _ = deepfm_build(
            opt=opt, kw=kw, tower_lr=DEEPFM_TOWER_LR)
        ops = [op.type for op in main.global_block().ops]
        relus = deepfm_relus(main)
        card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        card.run(startup)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        params = {p.name for p in main.all_parameters()}
        start = host_state(card.scope, names)
        cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
        ptt.io.params_from_numpy(cpu.scope, {n: t.numpy() for n, t in
                                             start.items()}, ptt.CPUPlace())
        losses = []
        for feed in feeds:
            out = card.run(main, feed=feed, fetch_list=[loss] + relus,
                           return_numpy=False)
            t0 = time.perf_counter()
            with replayed_relu_masks([(t > 0).float().cpu()
                                      for t in out[1:]]) as left:
                want, = cpu.run(main, feed=feed, fetch_list=[loss])
            cpu_s += time.perf_counter() - t0
            if left:
                raise RuntimeError(f"{tag} {len(left)} relu masks not taken")
            losses.append((float(out[0].float().cpu().reshape(())),
                           float(want.reshape(()))))
        got, want = host_state(card.scope, names), host_state(cpu.scope,
                                                              names)
        errs = {}
        for n in names:
            base = start[n].double() if n in params else 0
            w, g = want[n].double() - base, got[n].double() - base
            errs[n] = float((g - w).norm() / w.norm().clamp_min(1e-30))
        worst = max(errs, key=errs.get)
        loss_err = max(abs(a - b) / abs(b) for a, b in losses)
        # FTRL's l1 step may hold a zero-initialised bias at exactly 0
        moved = all(not torch.equal(got[n], start[n]) or not got[n].any()
                    for n in params)
        label = f"{opt}({', '.join(f'{k}={v}' for k, v in kw.items())})"
        rows.append((label, loss_err, errs[worst], worst))
        log(f"{tag} {label}: {ops.count('scale')} scale ops (the tower's "
            f"lr), losses card/CPU {[(round(a, 5), round(b, 5)) for a, b in losses]}"
            f" (worst {loss_err:.3g}); worst state {errs[worst]:.3g} "
            f"({worst}); every param moved {moved}")
        if not (loss_err <= DEEPFM_LOSS_RTOL
                and errs[worst] <= DEEPFM_GRAD_RTOL and moved):
            raise RuntimeError(f"{tag} {label} is off the CPU's steps")
    log(f"{tag} {len(rows)} classes within the bounds {DEEPFM_LOSS_RTOL:g} "
        f"/ {DEEPFM_GRAD_RTOL:g}; CPU steps {cpu_s:.1f} s in all")
    return rows


def deepfm_model_average(torch):
    """(c) ModelAverage on bench_deepfm's program, Adagrad, on the card:
    apply right after the startup run leaves every param bit-equal;
    after DEEPFM_AVG_STEPS steps (the params read back after each) apply
    gives their mean (the f32 sum in order over the steps, divided by the
    count) within DEEPFM_AVG_RTOL, and restore gives back the trained
    values bit for bit."""
    import paddle_tpu_torch as ptt
    tag = "[deepfm ModelAverage]"
    main, startup, loss, _, _, ma = deepfm_build(average=True)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    params = [p.name for p in main.all_parameters()]
    start = snapshot(exe.scope, params)
    with ma.apply(exe):
        noop = bits_differ(snapshot(exe.scope, params), start)
    total = None
    for i in range(DEEPFM_AVG_STEPS):
        exe.run(main, feed=deepfm_feed(DEEPFM_CHECK_BATCH, SEED + 30 + i),
                fetch_list=[loss])
        now = snapshot(exe.scope, params)
        total = now if total is None else {n: total[n] + now[n]
                                           for n in params}
    trained = snapshot(exe.scope, params)
    with ma.apply(exe):
        avg = snapshot(exe.scope, params)
    restored = bits_differ(snapshot(exe.scope, params), trained)
    errs = {n: float(((avg[n] - total[n] / DEEPFM_AVG_STEPS).abs()
                      / (total[n] / DEEPFM_AVG_STEPS).abs().clamp_min(1.0)
                      ).max()) for n in params}
    worst = max(errs, key=errs.get)
    log(f"{tag} apply after startup changed {noop or 'nothing'}; after "
        f"{DEEPFM_AVG_STEPS} steps apply's worst error against the mean "
        f"{errs[worst]:.3g} ({worst}; bound {DEEPFM_AVG_RTOL:g} of "
        f"max(1, |mean|)); restore changed {restored or 'nothing'}")
    if noop or restored or errs[worst] > DEEPFM_AVG_RTOL:
        raise RuntimeError(f"{tag} apply/restore: {noop}, {restored}, "
                           f"{errs[worst]}")
    return errs[worst]


def deepfm_train(torch, amp, sparse=False):
    """(d) bench_deepfm's row (or its sparse build on raw ids, `sparse`)
    at batch DEEPFM_BATCH, f32 or under FLAGS_amp_bf16: the batch on the
    card, DEEPFM_WARMUP runs and DEEPFM_RUNS synchronized runs, the
    counters zeroed just before the first and read just after the last
    (no kernel of this repo runs); the first run's time, the run p50 and
    peak memory; then time_run_steps as bench.py's _time_steps times the
    row, and examples/s."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = (f"[deepfm{' sparse' if sparse else ''} train"
           f"{' amp' if amp else ''}]")
    with amp_bf16(amp):
        main, startup, loss, grads, prob, _ = deepfm_build(sparse=sparse)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        host = deepfm_feed(DEEPFM_BATCH, SEED + 1, sparse=sparse)
        feed = {k: torch.as_tensor(v, device=DEVICE)
                for k, v in host.items()}
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters = launch_counters()
        zero_counters(counters)
        losses, ms = [], []
        for _ in range(DEEPFM_WARMUP + DEEPFM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(())))
        counts = {n: v for (n, attr), v in read_counters(counters).items()
                  if attr == "launches"}
        peak = torch.cuda.max_memory_allocated()
        step_ms = time_run_steps(torch, exe, main, feed, loss,
                                 steps=DEEPFM_TIMED_STEPS,
                                 calls=DEEPFM_TIMED_CALLS)
    no_autograd_state(exe.scope, names, tag)
    p50 = float(np.median(ms[DEEPFM_WARMUP:]))
    ops = [op.type for op in main.global_block().ops]
    n_weights = sum(math.prod(p.shape) for p in main.all_parameters())
    log(f"{tag} batch {DEEPFM_BATCH}, {len(ops)} ops "
        f"({ops.count('adagrad')} adagrad), {n_weights} weights: losses "
        f"{[round(x, 4) for x in losses]}; run_steps {step_ms:.2f} ms a "
        f"step (time_run_steps: {DEEPFM_TIMED_STEPS} steps a call, best of "
        f"{DEEPFM_TIMED_CALLS} after one), "
        f"{DEEPFM_BATCH / step_ms * 1e3:.0f} examples/s; run p50 "
        f"{p50:.2f} ms (runs {DEEPFM_WARMUP + 1}-"
        f"{DEEPFM_WARMUP + DEEPFM_RUNS}, synchronized, with the loss "
        f"readback), {DEEPFM_BATCH / p50 * 1e3:.0f} examples/s; first run "
        f"{ms[0]:.2f} ms; peak device memory {peak / 2**20:.1f} MiB "
        f"({(peak - base) / 2**20:.1f} above the {base / 2**20:.1f} MiB "
        f"held before); this repo's kernels launched "
        f"{sum(counts.values())} times; {nvidia_smi_line()}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} non-finite loss {losses}")
    if amp and not losses[DEEPFM_RUNS - 1] < losses[0]:
        raise RuntimeError(f"{tag} the AMP loss did not fall over "
                           f"{DEEPFM_RUNS} runs: {losses}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(exe=exe, main=main, feed=feed, host=host, loss=loss,
                        prob=prob, p50=p50, step_ms=step_ms, first_ms=ms[0],
                        peak=peak - base, losses=losses)


def deepfm_buckets(torch):
    """(e) The sparse build's lookups on the card take the row that the
    host plane's sparse.hash_bucket gives each raw id (above 2^32 and
    below 0 among them): fm_w1 holds its row index as its value (exact
    in f32 below 2^24), and the first lookup's output is read back."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import sparse
    main, startup, _, _, _, _ = deepfm_build(sparse=True, opt=None)
    out = [op.outputs["Out"][0] for op in main.global_block().ops
           if op.type == "sparse_embedding_lookup"][0]
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    rows = exe.scope.find_var("fm_w1").shape[0]
    ptt.io.params_from_numpy(
        exe.scope, {"fm_w1": np.arange(rows, dtype="float32").reshape(-1,
                                                                      1)},
        ptt.CUDAPlace(0))
    feed = deepfm_feed(DEEPFM_BATCH, SEED + 1, sparse=True)
    got, = exe.run(main, feed=feed, fetch_list=[out])
    ids = feed["feat_ids"]
    want = sparse.hash_bucket(ids, rows)
    same = int((got.reshape(ids.shape).astype(np.int64) == want).sum())
    log(f"[deepfm buckets] {ids.size} raw ids ({int((ids > 2**32).sum())} "
        f"above 2^32, {int((ids < 0).sum())} below 0) into {rows} rows: "
        f"{same} took the host's hash_bucket row, "
        f"{len(np.unique(want))} rows touched")
    if same != ids.size:
        raise RuntimeError("the card's buckets are not the host plane's")


def deepfm_serve(torch, row):
    """(f) The f32 training row's program after its runs, saved for
    inference with prob as the fetch (feeds feat_ids, feat_vals) and
    served by the Predictor at batch DEEPFM_BATCH: the card's
    probabilities against the CPU Predictor's on the same dir within
    DEEPFM_PRED_ATOL, metrics.Auc of them against the batch's labels
    (the batch it trained on), and the request p50 with the counters
    zeroed just before and read just after."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import metrics
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    tag = "[deepfm serve]"
    names = ["feat_ids", "feat_vals"]
    feed = {k: row["host"][k] for k in names}
    with tempfile.TemporaryDirectory() as td:
        ptt.io.save_inference_model(td, names, [row["prob"]], row["exe"],
                                    main_program=row["main"])
        on_card = create_predictor(AnalysisConfig(td))
        on_cpu = create_predictor(AnalysisConfig(td, use_gpu=False))
    got, = on_card.run(feed)
    want, = on_cpu.run(feed)
    err = float(abs(got - want).max())
    auc = metrics.Auc()
    auc.update(got, row["host"]["label"])
    dev = {k: torch.as_tensor(v, device=DEVICE) for k, v in feed.items()}
    on_card.prepare(dev)
    counters = launch_counters()
    zero_counters(counters)
    ms = []
    for _ in range(DEEPFM_SERVE_TIMED):
        t0 = time.perf_counter()
        on_card.run(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    p50 = float(np.median(ms))
    log(f"{tag} batch {DEEPFM_BATCH}: probabilities {got.shape} card vs "
        f"CPU {err:.3g} (tolerance {DEEPFM_PRED_ATOL:g}); Auc against the "
        f"labels {auc.eval():.4f}; request p50 {p50:.3f} ms (min "
        f"{min(ms):.3f}, max {max(ms):.3f}; host clock around "
        f"Predictor.run returning the probabilities as numpy), "
        f"{DEEPFM_BATCH / p50 * 1e3:.0f} examples/s; {nvidia_smi_line()}")
    if got.shape != (DEEPFM_BATCH, 1) or not err <= DEEPFM_PRED_ATOL \
            or not 0.5 < auc.eval() <= 1.0:
        raise RuntimeError(f"{tag} {got.shape}, {err}, {auc.eval()}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(p50=p50, err=err, auc=auc.eval())


def phase_deepfm(torch):
    """Phase 5i: DeepFM CTR (bench_deepfm) trained and served on the card:
    the card-vs-CPU Adagrad step with its TF32 control, every optimizer
    class card vs CPU, ModelAverage, the training row f32 and under AMP,
    the sparse build under AMP on raw ids with its buckets checked, and
    the Predictor.  Returns the launches by path (all zero: no kernel of
    this repo lies on the CTR path) and the AMP row (traced at the end of
    the smoke)."""
    check = deepfm_card_vs_cpu(torch)
    deepfm_optimizers(torch)
    deepfm_model_average(torch)
    by_path, rows = {}, {}
    by_path["deepfm_train"], f32 = deepfm_train(torch, amp=False)
    by_path["deepfm_train_amp"], amp = deepfm_train(torch, amp=True)
    by_path["deepfm_sparse_train_amp"], sp = deepfm_train(torch, amp=True,
                                                          sparse=True)
    del sp["exe"]
    deepfm_buckets(torch)
    by_path["deepfm_serve"], serve = deepfm_serve(torch, f32)
    del f32["exe"]
    for key, row in (("f32", f32), ("amp", amp), ("sparse amp", sp)):
        rows[key] = (round(row["step_ms"], 3),
                     round(DEEPFM_BATCH / row["step_ms"] * 1e3),
                     round(row["p50"], 3), round(row["peak"] / 2**20, 1))
    recs = [r for r in VERIFY_LOG if r["phase"] == "deepfm"]
    log(f"[deepfm] (run_steps ms a step, examples/s, run p50 ms, peak MiB "
        f"above what was held) {rows}; serve p50 {serve['p50']:.3f} ms, "
        f"Auc {serve['auc']:.4f}; check {check}; the gate verified "
        f"{len(recs)} programs in error mode, "
        f"{sum(r['errors'] for r in recs)} with an error; "
        f"{nvidia_smi_line()}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"deepfm verifications {recs}")
    return by_path, amp


def _deepfm_kernel_class(name):
    """Kernel classes of the CTR step's trace (torch and cuBLAS)."""
    if "(this repo)" in _kernel_class(name):
        return _kernel_class(name)
    low = name.lower()
    if any(k in low for k in ("indexselect", "index_select", "gather")):
        return "embedding gather (torch)"
    if any(k in low for k in ("embedding", "grad_weight", "sum_and_scatter",
                              "segment", "radix", "sort", "unique")):
        return "embedding backward (torch)"
    if any(k in low for k in ("gemm", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "reduce" in low:
        return "reductions"
    return "other (elementwise: Adagrad, FM terms, loss, casts)"


def deepfm_bytes(main):
    """(MB of the tables' dense gradient a step, Adagrad's byte bound in
    ms: each param, grad and moment read once, each param and moment
    written once, at HBM_BYTES_PER_S) of a DeepFM training program."""
    block = main.global_block()
    tables = sum(math.prod(block.var(n).shape) for n in ("fm_w1", "fm_emb"))
    weights = sum(math.prod(p.shape) for p in main.all_parameters())
    return tables * 4 / 1e6, 5 * 4 * weights / HBM_BYTES_PER_S * 1e3


def trace_deepfm(torch, row):
    """One AMP training step of bench_deepfm traced by kernel class, the
    lookups' and the Adagrad ops' kernels attributed through their
    ranges (beside Adagrad's byte bound); no kernel of this repo."""
    raw = []
    with amp_bf16(), op_ranges(torch, ("lookup_table", "adagrad")):
        names = trace_run(
            torch, f"AMP DeepFM training step at batch {DEEPFM_BATCH}",
            lambda: row["exe"].run(row["main"], feed=row["feed"],
                                   fetch_list=[row["loss"]],
                                   return_numpy=False),
            classify=_deepfm_kernel_class, raw=raw)
    for t in ("lookup_table", "adagrad"):
        log(f"[trace]   kernels launched inside the {t} lowerings: "
            f"{attributed_ms(raw, RANGE_PREFIX + t):.3f} ms")
    mb, bound = deepfm_bytes(row["main"])
    log(f"[trace]   the tables' dense gradient {mb:.1f} MB a step; "
        f"Adagrad's byte bound {bound:.4f} ms")
    ours = [c for c in names if "(this repo)" in c]
    if ours or not names.get("matmul (cuBLAS)"):
        raise RuntimeError(f"the AMP DeepFM step's kernel classes "
                           f"{sorted(names)}: expected cuBLAS and none of "
                           f"this repo's")


# phase 5j: AlexNet and GoogLeNet as bench.py's _bench_conv_train trains
# them (:492-508), SE-ResNeXt-50 at bench_resnet50's batch and Momentum,
# the stacked LSTM as bench_lstm trains it (:525-545), and BASELINE
# config 1: LeNet through the Trainer on MNIST-shaped batches
CNL_IMG = (3, 224, 224)
CNL_CLASSES = 1000
# model -> (module, build kwargs, batch, optimizer class and arguments,
# card-vs-CPU check batch, what a row of the batch is)
CNL_MODELS = {
    "alexnet": ("alexnet", dict(class_dim=CNL_CLASSES, img_shape=CNL_IMG),
                128, ("Momentum", dict(learning_rate=0.01, momentum=0.9)),
                8, "img"),
    "googlenet": ("googlenet", dict(class_dim=CNL_CLASSES,
                                    img_shape=CNL_IMG),
                  128, ("Momentum", dict(learning_rate=0.01, momentum=0.9)),
                  8, "img"),
    "se_resnext": ("se_resnext", dict(class_dim=CNL_CLASSES,
                                      img_shape=CNL_IMG, depth=50),
                   64, ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
                   4, "img"),
    "stacked_lstm": ("stacked_lstm", dict(dict_dim=30000, seq_len=100,
                                          emb_dim=512, hidden_dim=512,
                                          num_layers=2),
                     64, ("Adam", dict(learning_rate=1e-3)), 8, "seq"),
    "lenet": ("lenet", {}, 64, ("SGD", dict(learning_rate=0.1)), 64, "img"),
}
CNL_TRAIN = ("alexnet", "googlenet", "se_resnext", "stacked_lstm")
CNL_WARMUP = 2              # bench.py's warm-up runs
CNL_RUNS = 5                # synchronized runs after them (the run p50)
CNL_TIMED_STEPS = 5         # time_run_steps: steps a call, timed calls
CNL_TIMED_CALLS = 2
CNL_AMP_TRACK = 3           # AMP losses held to f32 over the first steps
CNL_AMP_LOSS_RTOL = 5e-2
# card vs CPU, one f32 step from the card's startup state at the check
# batch, dropout 0, the CPU taking the card's relu branches: the loss's
# relative error and the largest ||card - CPU|| / ||CPU|| over the @GRADs.
# cuDNN's f32 algorithms for the 5x5 convolutions part from the CPU's
# direct sums by more than a GEMM does (AlexNet's 5x5 weight gradient
# 1.85e-4 where its other @GRADs are within 1.3e-6; GoogLeNet, a 5x5 in
# every inception, 7.25e-4 spread over the layers), and the LSTM's output
# bias gradient is a near-cancelling sum at p = 0.5 (3.35e-4; its next
# 3.5e-6), H100 80GB HBM3, 700 W; TF32 puts each 1.05e-2 to 6.2e-2 off
CNL_LOSS_RTOL = 1e-5
CNL_GRAD_RTOL = {"googlenet": 2e-3}
CNL_GRAD_RTOL_DEFAULT = 1e-3
# config 1: LeNet through the Trainer on MNIST-shaped synthetic batches
TRAINER_MNIST_BATCHES = 24  # batches an epoch
TRAINER_MNIST_EPOCHS = 3
TRAINER_MNIST_RTOL = 1e-5   # the reloaded Trainer's test() against the first


def cnl_build(model, check=False, opt=True):
    """(main, startup, loss, grad names, relu inputs) of `model`'s training
    program at CNL_MODELS' widths with its optimizer (none with `opt`
    False); with `check`, every dropout rate 0."""
    import importlib
    import paddle_tpu_torch as ptt
    mod_name, kw, _, (opt_cls, opt_kw), _, _ = CNL_MODELS[model]
    mod = importlib.import_module("paddle_tpu_torch.models." + mod_name)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        _, loss, _, _ = mod.build_train_net(**kw)
        grads = []
        if opt:
            _, pg = getattr(ptt.optimizer, opt_cls)(**opt_kw).minimize(loss)
            grads = [g.name for _, g in pg]
    if check:
        for op in main.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
    relus = [op.inputs["X"][0] for op in main.global_block().ops
             if op.type == "relu"]
    return main, startup, loss, grads, relus


def mnist_like(batch, seed):
    """MNIST-shaped batches that a LeNet can learn: 1x28x28 images in
    [0, 1), each half a class's fixed template and half noise; labels
    0-9."""
    import numpy as np
    templates = np.random.RandomState(SEED).rand(10, 1, 28, 28)
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 10, (batch, 1)).astype("int64")
    img = 0.5 * templates[label[:, 0]] + 0.5 * rng.rand(batch, 1, 28, 28)
    return {"img": img.astype("float32"), "label": label}


def cnl_feed(model, batch, seed, device=None):
    """bench.py's feed of `model` at `batch`: uniform images with labels
    in [0, class_dim) (_img_feed), make_fake_batch's ragged sequences for
    the LSTM, mnist_like for LeNet; as numpy, or as tensors on
    `device`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import stacked_lstm
    if model == "stacked_lstm":
        kw = CNL_MODELS[model][1]
        feed = stacked_lstm.make_fake_batch(batch, dict_dim=kw["dict_dim"],
                                            seq_len=kw["seq_len"], seed=seed)
    elif model == "lenet":
        feed = mnist_like(batch, seed)
    else:
        rng = np.random.RandomState(seed)
        feed = {"img": rng.rand(batch, *CNL_IMG).astype("float32"),
                "label": rng.randint(0, CNL_CLASSES,
                                     (batch, 1)).astype("int64")}
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


@contextlib.contextmanager
def tf32_everywhere(torch):
    """TF32 on for cuDNN and matmuls in the block (PyTorch's cuDNN default;
    main() turns both off)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def cnl_card_vs_cpu(torch, model):
    """(a) One f32 step of `model`'s program at full width, batch its
    check batch, dropout 0, from the card's startup state: on the card,
    on the card with TF32 convolutions and matmuls (the control), and on
    a CPUPlace executor twice, taking the card's relu branches and the
    control's (replayed_relu_masks; a unit within rounding of 0 takes
    either branch, and at these batches one flip moves a late layer's
    gradient by percents).  The card's loss and every @GRAD within the
    model's bounds of the CPU step on its branches; the control outside
    one of them."""
    import paddle_tpu_torch as ptt
    tag = f"[{model} check]"
    main, startup, loss, grads, relus = cnl_build(model, check=True)
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: t.numpy() for n, t in host_state(card.scope, names).items()}
    feed = cnl_feed(model, CNL_MODELS[model][4], SEED + 40)
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())

    def step(exe, place, masks=None):
        """(loss, {@GRAD: host f32}, relu signs) of one step from
        `state`, the relus taking `masks`' branches where given."""
        ptt.io.params_from_numpy(exe.scope, state, place)
        replay = (replayed_relu_masks(masks) if masks is not None
                  else contextlib.nullcontext([]))
        with replay as left:
            out = exe.run(main, feed=feed, fetch_list=[loss] + grads + relus,
                          return_numpy=False)
        if left:
            raise RuntimeError(f"{tag} {len(left)} relu masks not taken")
        n = 1 + len(grads)
        return (float(out[0].float().cpu().reshape(())),
                {g: t.detach().float().cpu() for g, t in zip(grads,
                                                             out[1:n])},
                [(t > 0).float().cpu() for t in out[n:]])

    got_loss, got, card_signs = step(card, ptt.CUDAPlace(0))
    with tf32_everywhere(torch):
        ctl_loss, ctl, ctl_signs = step(card, ptt.CUDAPlace(0))
    res, cpu_s = {}, []
    for name, l, g, signs in (("card", got_loss, got, card_signs),
                              ("TF32 control", ctl_loss, ctl, ctl_signs)):
        t0 = time.perf_counter()
        want_loss, want, cpu_signs = step(cpu, ptt.CPUPlace(), masks=signs)
        cpu_s.append(time.perf_counter() - t0)
        errs = grad_rel_errs(want, g)
        worst = sorted(errs, key=errs.get, reverse=True)
        res[name] = (abs(l - want_loss) / abs(want_loss), errs[worst[0]],
                     worst[0], want_loss,
                     [(n, f"{errs[n]:.3g}") for n in worst[1:4]])
    flips = sum(int((a != b).sum()) for a, b in zip(card_signs, ctl_signs))
    lb = CNL_LOSS_RTOL
    gb = CNL_GRAD_RTOL.get(model, CNL_GRAD_RTOL_DEFAULT)
    ops = main.global_block().ops
    log(f"{tag} {CNL_MODELS[model][1] or 'LeNet'}, batch "
        f"{CNL_MODELS[model][4]}, {len(ops)} ops, {len(grads)} @GRADs, "
        f"{len(relus)} relu ops: loss card {got_loss:.7f} CPU "
        f"{res['card'][3]:.7f} (rel {res['card'][0]:.3g}), TF32 control "
        f"{ctl_loss:.7f} (rel {res['TF32 control'][0]:.3g}); worst @GRAD "
        f"card {res['card'][1]:.3g} ({res['card'][2]}; next "
        f"{res['card'][4]}), control "
        f"{res['TF32 control'][1]:.3g} ({res['TF32 control'][2]}); bounds "
        f"{lb:g} / {gb:g}; relu branches the control took apart from the "
        f"card's: {flips}; CPU steps {[round(s, 1) for s in cpu_s]} s")
    if not (res["card"][0] <= lb and res["card"][1] <= gb):
        raise RuntimeError(f"{tag} the card's step is off the CPU's: "
                           f"{res['card']}")
    if not (res["TF32 control"][0] > lb or res["TF32 control"][1] > gb):
        raise RuntimeError(f"{tag} the TF32 control passed the bounds: the "
                           f"check cannot tell f32 from TF32")
    return dict(loss=res["card"][0], grad=res["card"][1],
                ctl_loss=res["TF32 control"][0],
                ctl_grad=res["TF32 control"][1])


def cnl_train(torch, model, amp):
    """(b) bench.py's row of `model` (its batch, optimizer and feed, the
    batch on the card), f32 or under FLAGS_amp_bf16: CNL_WARMUP runs and
    CNL_RUNS synchronized runs with the counters zeroed just before the
    first and read just after the last (no kernel of this repo runs);
    the first run's time, the run p50, peak memory; then time_run_steps
    as bench.py's _time_steps times the row, and images or sequences a
    second."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = f"[{model} train{' amp' if amp else ''}]"
    batch, unit = CNL_MODELS[model][2], CNL_MODELS[model][5]
    with amp_bf16(amp):
        main, startup, loss, _, _ = cnl_build(model)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        feed = cnl_feed(model, batch, SEED + 1, device=DEVICE)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters = launch_counters()
        zero_counters(counters)
        losses, ms = [], []
        for _ in range(CNL_WARMUP + CNL_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(())))
        counts = {n: v for (n, attr), v in read_counters(counters).items()
                  if attr == "launches"}
        peak = torch.cuda.max_memory_allocated()
        step_ms = time_run_steps(torch, exe, main, feed, loss,
                                 steps=CNL_TIMED_STEPS,
                                 calls=CNL_TIMED_CALLS)
    no_autograd_state(exe.scope, names, tag)
    p50 = float(np.median(ms[CNL_WARMUP:]))
    ops = main.global_block().ops
    n_weights = sum(math.prod(p.shape) for p in main.all_parameters())
    log(f"{tag} batch {batch}, {len(ops)} ops, {n_weights} weights: losses "
        f"{[round(x, 4) for x in losses]}; run_steps {step_ms:.2f} ms a step"
        f" (time_run_steps: {CNL_TIMED_STEPS} steps a call, best of "
        f"{CNL_TIMED_CALLS} after one), {batch / step_ms * 1e3:.1f} {unit}/s;"
        f" run p50 {p50:.2f} ms (runs {CNL_WARMUP + 1}-"
        f"{CNL_WARMUP + CNL_RUNS}, synchronized, with the loss readback), "
        f"{batch / p50 * 1e3:.1f} {unit}/s; first run {ms[0]:.2f} ms; peak "
        f"device memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} "
        f"above the {base / 2**20:.1f} MiB held before); this repo's kernels"
        f" launched {sum(counts.values())} times; {nvidia_smi_line()}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} non-finite loss {losses}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(exe=exe, main=main, feed=feed, loss=loss, p50=p50,
                        step_ms=step_ms, first_ms=ms[0], peak=peak - base,
                        losses=losses, batch=batch, unit=unit)


def lenet_trainer(torch):
    """(c) BASELINE config 1: models.lenet.build_train_net() through the
    port's Trainer on the card, SGD(0.1), TRAINER_MNIST_EPOCHS epochs of
    TRAINER_MNIST_BATCHES MNIST-shaped batches of 64 (mnist_like; no
    dataset is read), prefetch 2, the counters zeroed around train(): the
    loss falls (the mean of the last 5 steps under that of the first 5),
    every step's metrics are finite.  Then save_params, a second Trainer
    with param_path, and test() of both on the same batches: the reloaded
    Trainer's metrics equal the first's within TRAINER_MNIST_RTOL, and the
    test accuracy beats chance."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.reader import decorator
    tag = "[lenet trainer]"
    batch = CNL_MODELS["lenet"][2]

    def train_func():
        _, avg_loss, acc, _ = lenet.build_train_net()
        return [avg_loss, acc]

    def opt_func():
        return ptt.optimizer.SGD(learning_rate=0.1)

    def samples(seed0, n):
        def r():
            for i in range(n):
                b = mnist_like(batch, seed0 + i)
                for j in range(batch):
                    yield b["img"][j], b["label"][j]
        return r

    train_reader = decorator.batch(samples(SEED + 500,
                                           TRAINER_MNIST_BATCHES), batch)
    test_reader = decorator.batch(samples(SEED + 900, 4), batch)
    steps, stamps = [], []

    def handler(e):
        if isinstance(e, ptt.EndStepEvent):
            steps.append([float(np.asarray(m).mean()) for m in e.metrics])
            stamps.append(time.perf_counter())

    trainer = ptt.Trainer(train_func, opt_func, place=ptt.CUDAPlace(0))
    counters = launch_counters()
    zero_counters(counters)
    t0 = time.perf_counter()
    trainer.train(TRAINER_MNIST_EPOCHS, handler, train_reader,
                  ["img", "label"], prefetch_depth=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    first = trainer.test(test_reader, ["img", "label"])
    with tempfile.TemporaryDirectory() as td:
        trainer.save_params(td)
        again = ptt.Trainer(train_func, opt_func, place=ptt.CUDAPlace(0),
                            param_path=td)
        second = again.test(test_reader, ["img", "label"])
    losses = [s[0] for s in steps]
    gaps = np.diff(stamps[TRAINER_MNIST_BATCHES:]) * 1e3
    step_ms = float(np.median(gaps))
    errs = [abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)
            for a, b in zip(first, second)]
    log(f"{tag} {TRAINER_MNIST_EPOCHS} epochs x {TRAINER_MNIST_BATCHES} "
        f"batches of {batch}: losses (every 12th step) "
        f"{[round(x, 4) for x in losses[::12]]}, last {losses[-1]:.4f}; "
        f"train() {train_s:.2f} s, step p50 {step_ms:.2f} ms after epoch 1 "
        f"(host clock between EndStepEvents), {batch / step_ms * 1e3:.0f} "
        f"img/s; test() loss/acc {[round(float(x), 4) for x in first]}, "
        f"after save_params and a Trainer(param_path=...) "
        f"{[round(float(x), 4) for x in second]} (rel {max(errs):.3g}, "
        f"bound {TRAINER_MNIST_RTOL:g}); this repo's kernels launched "
        f"{sum(counts.values())} times; {nvidia_smi_line()}")
    if len(steps) != TRAINER_MNIST_EPOCHS * TRAINER_MNIST_BATCHES or not \
            all(math.isfinite(x) for s in steps for x in s):
        raise RuntimeError(f"{tag} steps {len(steps)}: {steps[-3:]}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise RuntimeError(f"{tag} the loss did not fall: {losses}")
    if max(errs) > TRAINER_MNIST_RTOL or not float(first[1]) > 0.2:
        raise RuntimeError(f"{tag} test() {first} and after reload "
                           f"{second}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    trainer.stop()
    again.stop()
    return counts, dict(step_ms=step_ms, losses=losses, test=first)


def phase_convnets_lstm(torch):
    """Phase 5j: AlexNet, GoogLeNet, SE-ResNeXt-50 and the stacked LSTM at
    bench.py's shapes, and LeNet through the Trainer (config 1): the
    card-vs-CPU step of each (with LeNet's program) and its TF32 control,
    each training row f32 and under AMP (the AMP losses held to the f32
    ones over the first CNL_AMP_TRACK steps; the LSTM's AMP loss falls),
    the Trainer.  Returns the launches by path (all zero: no kernel of
    this repo lies on these paths) and the rows, traced at the end of the
    smoke."""
    checks = {m: cnl_card_vs_cpu(torch, m) for m in CNL_TRAIN + ("lenet",)}
    by_path, rows = {}, {}
    for model in CNL_TRAIN:
        for amp in (False, True):
            key = f"{model}_train{'_amp' if amp else ''}"
            by_path[key], rows[key] = cnl_train(torch, model, amp)
        f32, amp = rows[f"{model}_train"], rows[f"{model}_train_amp"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(amp["losses"],
                                                     f32["losses"])]
        log(f"[{model}] AMP loss against f32, run for run: "
            f"{[f'{g:.2g}' for g in gaps]} (bound {CNL_AMP_LOSS_RTOL:g} "
            f"on the first {CNL_AMP_TRACK})")
        if max(gaps[:CNL_AMP_TRACK]) > CNL_AMP_LOSS_RTOL:
            raise RuntimeError(f"{model}: the AMP losses left the f32 "
                               f"ones: {gaps}")
    lstm = rows["stacked_lstm_train_amp"]["losses"]
    if not lstm[-1] < lstm[0]:
        raise RuntimeError(f"the stacked LSTM's AMP loss did not fall: "
                           f"{lstm}")
    by_path["lenet_trainer"], trainer = lenet_trainer(torch)
    summary = {k: (round(r["step_ms"], 2),
                   round(r["batch"] / r["step_ms"] * 1e3, 1),
                   round(r["p50"], 2), round(r["peak"] / 2**20, 1))
               for k, r in rows.items()}
    recs = [r for r in VERIFY_LOG if r["phase"] == "convnets_lstm"]
    log(f"[convnets_lstm] (run_steps ms a step, images or sequences a "
        f"second, run p50 ms, peak MiB above what was held) {summary}; "
        f"LeNet Trainer step {trainer['step_ms']:.2f} ms; checks "
        f"{ {m: (round(c['loss'], 9), round(c['grad'], 7), round(c['ctl_grad'], 5)) for m, c in checks.items()} }; "
        f"the gate verified {len(recs)} programs in error mode, "
        f"{sum(r['errors'] for r in recs)} with an error; "
        f"{nvidia_smi_line()}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"convnets_lstm verifications {recs}")
    return by_path, rows


def _cnl_kernel_class(name):
    """Phase 5j's trace classes: the conv plane's (_resnet_kernel_class),
    with cuDNN's FFT and Winograd convolutions filed apart and the rest
    under "other", whose largest kernels trace_run lists by name."""
    c = _resnet_kernel_class(name)
    if "(this repo)" in c:
        return c
    if any(k in name.lower() for k in ("fft", "winograd", "flip_filter")):
        return "cuDNN FFT and Winograd convolutions"
    if c.startswith("elementwise and other"):
        return "other (elementwise: LRN, relu, the optimizers, casts)"
    return c


def trace_convnets_lstm(torch, rows):
    """One step of each phase-5j training row traced by kernel class (the
    device's busy and idle share of the step's wall time); no kernel of
    this repo in any."""
    for key, row in rows.items():
        amp = key.endswith("_amp")
        with amp_bf16(amp):
            names = trace_run(
                torch, f"{'AMP ' if amp else ''}{key.split('_train')[0]} "
                       f"training step at batch {row['batch']}",
                lambda: row["exe"].run(row["main"], feed=row["feed"],
                                       fetch_list=[row["loss"]],
                                       return_numpy=False),
                classify=_cnl_kernel_class)
        launches = sum(sum(v.values()) for v in names.values())
        log(f"[trace]   {key}: {launches} kernel launches a step")
        ours = [c for c in names if "(this repo)" in c]
        if ours:
            raise RuntimeError(f"{key}'s trace holds this repo's kernels: "
                               f"{ours}")


# phase 5k: the GRU machine-translation model of the reference's fluid
# benchmark (benchmark/fluid/models/machine_translation.py, BASELINE.md:65)
# at its widths (embedding, encoder and decoder 512, dict 30000, beam 3,
# max_length 250) on the JAX package's structure (a GRU encoder and
# dot-product attention), at fluid_benchmark's default batch 32, source
# and target length 50 (this slice's choice: the dense build needs one
# length) on the synthetic copy task; and the five book models at the
# JAX builders' default sizes, word2vec at dict_size 2048
MT_CFG = dict(src_vocab=30000, tgt_vocab=30000, emb_dim=512,
              hidden_dim=512)
MT_T = 50
MT_BATCH = 32
MT_LR = 1e-3
MT_BEAM = 3
MT_MAX_LEN = 250
MT_START, MT_END = 0, 1
MT_WARMUP = 2               # warm-up runs
MT_RUNS = 5                 # synchronized runs after them (the run p50)
MT_TIMED_STEPS = 5          # time_run_steps: steps a call, timed calls
MT_TIMED_CALLS = 2
MT_AMP_TRACK = 3            # AMP losses held to f32 over the first runs
MT_AMP_LOSS_RTOL = 5e-2
MT_CHECK_BATCH = 4          # the card-vs-CPU step (the CPU side is the cost)
MT_DECODE_RUNS = 3          # served decode requests after a warm-up one
# card vs CPU, one f32 Adam step from the card's startup state: the loss's
# relative error and the largest ||card - CPU|| / ||CPU|| over the @GRADs
# (tests/test_torch_train.py's 1e-5 and 1e-4); a TF32 control must fail
MT_LOSS_RTOL = 1e-5
MT_GRAD_RTOL = 1e-4
# the decode's rescoring: each hypothesis's SentenceScores against the sum
# of its per-token log-probs up to and including its first end_id, from a
# teacher-forced forward of build_train_net on the CPU
MT_SCORE_RTOL = 1e-4
MT_RESCORE_CHUNK = 32       # hypotheses a CPU forward (its logits' memory)
BOOK_BATCH = 32
BOOK_MODELS = {"fit_a_line": {}, "word2vec": {"dict_size": 2048},
               "recommender_system": {}, "rnn_encoder_decoder": {},
               "db_lstm": {}}
BOOK_LR = 1e-3              # Adam
BOOK_TIMED_STEPS = 5
BOOK_TIMED_CALLS = 2
BOOK_LOSS_RTOL = 1e-5
BOOK_GRAD_RTOL = 1e-4


def mt_build(tgt_len=MT_T, opt=True):
    """(main, startup, loss, grad names) of the MT train program at
    MT_CFG, source length MT_T and target length `tgt_len`, with
    Adam(MT_LR) where `opt`."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import machine_translation as mt
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        _, loss = mt.build_train_net(src_len=MT_T, tgt_len=tgt_len,
                                     **MT_CFG)
        grads = []
        if opt:
            _, pg = ptt.optimizer.Adam(learning_rate=MT_LR).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads


def mt_feed(batch, seed, device=None):
    import torch
    from paddle_tpu_torch.models import machine_translation as mt
    feed = mt.make_copy_task_batch(batch, MT_T, MT_CFG["tgt_vocab"],
                                   seed=seed, start_id=MT_START,
                                   end_id=MT_END)
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def mt_card_vs_cpu(torch):
    """One f32 Adam step of the MT program at batch MT_CHECK_BATCH from
    the card's startup state, on the card, on a CPUPlace executor (no
    relu: nothing to replay) and on the card with TF32 matmuls (the
    control): the loss and every @GRAD within MT_LOSS_RTOL and
    MT_GRAD_RTOL of the CPU's, the control outside one of them."""
    import paddle_tpu_torch as ptt
    tag = "[mt check]"
    main, startup, loss, grads = mt_build()
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: t.numpy() for n, t in host_state(card.scope, names).items()}
    feed = mt_feed(MT_CHECK_BATCH, SEED + 7)
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())

    def step(exe, place):
        ptt.io.params_from_numpy(exe.scope, state, place)
        out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      return_numpy=False)
        return (float(out[0].float().cpu().reshape(())),
                {g: t.detach().float().cpu() for g, t in zip(grads,
                                                             out[1:])})

    t0 = time.perf_counter()
    want_loss, want = step(cpu, ptt.CPUPlace())
    cpu_s = time.perf_counter() - t0
    got_loss, got = step(card, ptt.CUDAPlace(0))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl_loss, ctl = step(card, ptt.CUDAPlace(0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for name, l, g in (("card", got_loss, got), ("TF32 control", ctl_loss,
                                                 ctl)):
        errs = grad_rel_errs(want, g)
        worst = sorted(errs, key=errs.get, reverse=True)
        res[name] = (abs(l - want_loss) / abs(want_loss), errs[worst[0]],
                     worst[0], [(n, f"{errs[n]:.3g}") for n in worst[1:4]])
    log(f"{tag} batch {MT_CHECK_BATCH}, {len(grads)} @GRADs: loss CPU "
        f"{want_loss:.7f} card {got_loss:.7f} (rel {res['card'][0]:.3g}) "
        f"TF32 control {ctl_loss:.7f} (rel {res['TF32 control'][0]:.3g}); "
        f"worst @GRAD card {res['card'][1]:.3g} ({res['card'][2]}; next "
        f"{res['card'][3]}), control {res['TF32 control'][1]:.3g} "
        f"({res['TF32 control'][2]}); bounds {MT_LOSS_RTOL:g} / "
        f"{MT_GRAD_RTOL:g}; CPU step {cpu_s:.1f} s")
    if not (res["card"][0] <= MT_LOSS_RTOL
            and res["card"][1] <= MT_GRAD_RTOL):
        raise RuntimeError(f"{tag} the card's step is off the CPU's: "
                           f"{res['card']}")
    if not (res["TF32 control"][0] > MT_LOSS_RTOL
            or res["TF32 control"][1] > MT_GRAD_RTOL):
        raise RuntimeError(f"{tag} the TF32 control passed the bounds: "
                           f"the check cannot tell f32 from TF32")
    return dict(loss=res["card"][0], grad=res["card"][1],
                ctl_loss=res["TF32 control"][0],
                ctl_grad=res["TF32 control"][1])


def mt_train(torch, amp):
    """The MT program at MT_BATCH, f32 or under FLAGS_amp_bf16, the batch
    on the card: MT_WARMUP + MT_RUNS synchronized runs with the counters
    zeroed just before the first and read just after the last (no kernel
    of this repo lies on this path); the first run, the run p50, peak
    memory; then time_run_steps, with tokens/s (source + target)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = f"[mt train{' amp' if amp else ''}]"
    with amp_bf16(amp):
        main, startup, loss, _ = mt_build()
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        feed = mt_feed(MT_BATCH, SEED + 1, device=DEVICE)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters = launch_counters()
        zero_counters(counters)
        losses, ms = [], []
        for _ in range(MT_WARMUP + MT_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out.reshape(())))
        counts = {n: v for (n, attr), v in read_counters(counters).items()
                  if attr == "launches"}
        peak = torch.cuda.max_memory_allocated()
        step_ms = time_run_steps(torch, exe, main, feed, loss,
                                 steps=MT_TIMED_STEPS, calls=MT_TIMED_CALLS)
    no_autograd_state(exe.scope, names, tag)
    p50 = float(np.median(ms[MT_WARMUP:]))
    toks = MT_BATCH * 2 * MT_T
    ops = main.global_block().ops
    log(f"{tag} batch {MT_BATCH}, T {MT_T}, {len(ops)} ops and "
        f"{len(main.blocks[1].ops)} in the decoder step's block, "
        f"{sum(math.prod(p.shape) for p in main.all_parameters())} weights:"
        f" losses {[round(x, 4) for x in losses]}; run_steps {step_ms:.2f} "
        f"ms a step (time_run_steps: {MT_TIMED_STEPS} steps a call, best of "
        f"{MT_TIMED_CALLS} after one), {toks / step_ms * 1e3:.0f} tokens/s "
        f"(src + tgt); run p50 {p50:.2f} ms (runs {MT_WARMUP + 1}-"
        f"{MT_WARMUP + MT_RUNS}, synchronized, with the loss readback); "
        f"first run {ms[0]:.2f} ms; peak device memory {peak / 2**20:.1f} "
        f"MiB ({(peak - base) / 2**20:.1f} above the {base / 2**20:.1f} MiB "
        f"held before); this repo's kernels launched "
        f"{sum(counts.values())} times; {nvidia_smi_line()}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} the loss did not fall: {losses}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(exe=exe, main=main, feed=feed, loss=loss, p50=p50,
                        step_ms=step_ms, first_ms=ms[0], peak=peak - base,
                        losses=losses, batch=MT_BATCH, unit="seq")


def mt_rescore(torch, state, src, ids):
    """Each hypothesis's log-prob from a teacher-forced forward of
    build_train_net (target length MT_MAX_LEN, the same parameter names)
    on the CPU from `state`: src [B, Ts] repeated per beam, the decoder's
    input start_id and the hypothesis shifted right, the labels the
    hypothesis; the sum of -cost up to and including the first end_id
    (all MT_MAX_LEN tokens where it has none).  [B, K] float64."""
    import numpy as np
    import paddle_tpu_torch as ptt
    B, K, T = ids.shape
    main, _, _, _ = mt_build(tgt_len=T, opt=False)
    sce, = [op for op in main.global_block().ops
            if op.type == "softmax_with_cross_entropy"]
    cost = sce.outputs["Loss"][0]
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    ptt.io.params_from_numpy(exe.scope, state, ptt.CPUPlace())
    hyp = ids.reshape(B * K, T).astype("int64")
    srcs = np.repeat(src, K, axis=0)
    tgt = np.concatenate([np.full((B * K, 1), MT_START, "int64"),
                          hyp[:, :-1]], axis=1)
    costs = []
    for i in range(0, B * K, MT_RESCORE_CHUNK):
        sl = slice(i, i + MT_RESCORE_CHUNK)
        c, = exe.run(main, feed={"src": srcs[sl], "tgt": tgt[sl],
                                 "lbl": hyp[sl]}, fetch_list=[cost])
        costs.append(np.asarray(c, np.float64).reshape(-1, T))
    costs = np.concatenate(costs)
    ended = np.cumsum(hyp == MT_END, axis=1)
    upto = (ended == 0) | ((ended == 1) & (hyp == MT_END))
    return -(costs * upto).sum(axis=1).reshape(B, K), upto.sum(axis=1)


def mt_decode(torch, row):
    """The decode program (build_decode_net: beam MT_BEAM, max_len
    MT_MAX_LEN) built after the f32 row's training, saved by
    save_inference_model from its scope and served by the Predictor on
    the card at batch MT_BATCH: a warm-up request, then MT_DECODE_RUNS
    synchronized ones with the counters zeroed around them (no kernel of
    this repo), the request p50, hypothesis tokens/s and peak memory.
    Its check does not depend on tie order: every SentenceScores entry
    within MT_SCORE_RTOL of mt_rescore's log-prob of its own
    SentenceIds.  A CPU Predictor on the same directory decodes the same
    batch, and the hypotheses equal to it token for token are counted
    (information, not a check)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.models import machine_translation as mt
    tag = "[mt decode]"
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        _, sent, scores = mt.build_decode_net(
            MT_CFG["src_vocab"], MT_CFG["tgt_vocab"], MT_T,
            beam_size=MT_BEAM, max_len=MT_MAX_LEN, start_id=MT_START,
            end_id=MT_END, emb_dim=MT_CFG["emb_dim"],
            hidden_dim=MT_CFG["hidden_dim"])
    src = mt_feed(MT_BATCH, SEED + 31)["src"]
    with tempfile.TemporaryDirectory() as d:
        ptt.io.save_inference_model(d, ["src"], [sent, scores], row["exe"],
                                    main_program=main)
        pred = create_predictor(AnalysisConfig(d))
        cpu_pred = create_predictor(AnalysisConfig(d, use_gpu=False))
    n_ops = (len(pred.program.global_block().ops),
             len(pred.program.blocks[1].ops))
    pred.run({"src": src}, return_numpy=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    zero_counters(counters)
    ms = []
    for _ in range(MT_DECODE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, sc = pred.run({"src": src})
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(ms))
    names = sorted(v.name for v in row["main"].list_vars()
                   if v.persistable)
    state = {n: t.numpy() for n, t in host_state(row["exe"].scope,
                                                 names).items()}
    t0 = time.perf_counter()
    want, lengths = mt_rescore(torch, state, src, ids)
    rescore_s = time.perf_counter() - t0
    rel = np.abs(sc.astype(np.float64) - want) / np.abs(want)
    t0 = time.perf_counter()
    cpu_ids, cpu_sc = cpu_pred.run({"src": src})
    cpu_s = time.perf_counter() - t0
    same = int(np.all(cpu_ids == ids, axis=2).sum())
    toks = MT_BATCH * MT_BEAM * MT_MAX_LEN
    log(f"{tag} batch {MT_BATCH}, beam {MT_BEAM}, max_len {MT_MAX_LEN}, "
        f"source length {MT_T}: {n_ops[0]} ops and {n_ops[1]} in the beam "
        f"step's block; SentenceIds {ids.shape} {ids.dtype}, best scores "
        f"{[round(float(x), 3) for x in sc[:3, 0]]}; hypotheses with an "
        f"end_id {int((lengths < MT_MAX_LEN).sum())} of {ids.shape[0] * ids.shape[1]}; "
        f"request p50 {p50:.1f} ms (requests {[round(x, 1) for x in ms]}, "
        f"synchronized, with the readback), {toks / p50 * 1e3:.0f} "
        f"hypothesis tokens/s ({MT_BATCH * MT_MAX_LEN / p50 * 1e3:.0f} a "
        f"best hypothesis); peak device memory {peak / 2**20:.1f} MiB "
        f"({(peak - base) / 2**20:.1f} above the {base / 2**20:.1f} MiB "
        f"held before); rescored on the CPU teacher-forced in "
        f"{rescore_s:.1f} s: worst rel {rel.max():.3g} (bound "
        f"{MT_SCORE_RTOL:g}); a CPU Predictor's decode ({cpu_s:.1f} s) equals"
        f" {same} of {MT_BATCH * MT_BEAM} hypotheses token for token, its "
        f"scores within rel {float(np.max(np.abs(cpu_sc - sc) / np.abs(sc))):.3g}"
        f"; this repo's kernels launched {sum(counts.values())} times; "
        f"{nvidia_smi_line()}")
    if ids.shape != (MT_BATCH, MT_BEAM, MT_MAX_LEN) or ids.dtype != np.int32:
        raise RuntimeError(f"{tag} SentenceIds {ids.shape} {ids.dtype}")
    if not np.isfinite(sc).all() or not rel.max() <= MT_SCORE_RTOL:
        raise RuntimeError(f"{tag} the scores are off the rescoring: worst "
                           f"rel {rel.max():.3g}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(pred=pred, src=src, p50=p50, peak=peak - base,
                        rel=float(rel.max()), same=same)


def book_feed(model, batch, seed, device=None):
    """A seeded batch of the book model's feeds at BOOK_MODELS' sizes
    (ids uniform over each table, fit_a_line's y a line of x plus noise,
    the recommender's score in [1, 5])."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)

    def ints(hi, *shape):
        return rng.randint(0, hi, (batch,) + shape).astype("int64")

    if model == "fit_a_line":
        x = rng.randn(batch, 13).astype("float32")
        feed = {"x": x, "y": (x[:, :1] * 2 + 1 + 0.1 * rng.randn(
            batch, 1)).astype("float32")}
    elif model == "word2vec":
        V = BOOK_MODELS[model]["dict_size"]
        feed = {f"word_{i}": ints(V, 1) for i in range(4)}
        feed["next_word"] = ints(V, 1)
    elif model == "recommender_system":
        feed = {k: ints(n, 1) for k, n in (
            ("user_id", 100), ("gender_id", 2), ("age_id", 7),
            ("job_id", 21), ("movie_id", 200))}
        feed.update(category_id=ints(10, 3), movie_title=ints(500, 8),
                    score=rng.uniform(1, 5, (batch, 1)).astype("float32"))
    elif model == "rnn_encoder_decoder":
        feed = {k: ints(100, 8) for k in ("src_word", "tgt_word", "label")}
    else:
        feed = {f"{s}_data": ints(100, 8) for s in (
            "word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")}
        feed.update(verb_data=ints(50, 8), mark_data=ints(2, 8),
                    target=ints(10, 8))
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def book_build(model):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import book
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        _, loss, pred = getattr(book, model)(**BOOK_MODELS[model])
        _, pg = ptt.optimizer.Adam(learning_rate=BOOK_LR).minimize(loss)
    return main, startup, loss, [g.name for _, g in pg], pred


def book_card_vs_cpu(torch, model):
    """One f32 Adam step of the book model at BOOK_BATCH from the card's
    startup state, on the card and on a CPUPlace executor: the loss and
    every @GRAD within BOOK_LOSS_RTOL and BOOK_GRAD_RTOL (db_lstm's
    Viterbi path equal too); then time_run_steps on the card, with
    examples/s.  The counters are zeroed around the card's work (no
    kernel of this repo)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = f"[book {model}]"
    main, startup, loss, grads, pred = book_build(model)
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: t.numpy() for n, t in host_state(card.scope, names).items()}
    feed = book_feed(model, BOOK_BATCH, SEED + 50)
    fetch = [loss] + grads + ([pred] if model == "db_lstm" else [])
    counters = launch_counters()
    zero_counters(counters)
    out = {}
    for side, exe, place in (("cpu", ptt.Executor(ptt.CPUPlace(),
                                                  scope=ptt.Scope()),
                              ptt.CPUPlace()),
                             ("card", card, ptt.CUDAPlace(0))):
        ptt.io.params_from_numpy(exe.scope, state, place)
        res = exe.run(main, feed=feed, fetch_list=fetch, return_numpy=False)
        out[side] = (float(res[0].float().cpu().reshape(())),
                     {g: t.detach().float().cpu() for g, t in
                      zip(grads, res[1:1 + len(grads)])},
                     res[-1].cpu().numpy() if model == "db_lstm" else None)
    dev_feed = {k: torch.as_tensor(v, device=DEVICE) for k, v in feed.items()}
    step_ms = time_run_steps(torch, card, main, dev_feed, loss,
                             steps=BOOK_TIMED_STEPS, calls=BOOK_TIMED_CALLS)
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    errs = grad_rel_errs(out["cpu"][1], out["card"][1])
    worst = max(errs, key=errs.get)
    path_same = (model != "db_lstm"
                 or np.array_equal(out["card"][2], out["cpu"][2]))
    log(f"{tag} batch {BOOK_BATCH}, {len(main.global_block().ops)} ops, "
        f"{sum(math.prod(p.shape) for p in main.all_parameters())} weights:"
        f" loss card {out['card'][0]:.7f} CPU {out['cpu'][0]:.7f} (rel "
        f"{loss_rel:.3g}); worst @GRAD {errs[worst]:.3g} ({worst}) of "
        f"{len(grads)}; bounds {BOOK_LOSS_RTOL:g} / {BOOK_GRAD_RTOL:g}"
        f"{'; Viterbi path equal' if model == 'db_lstm' and path_same else ''}"
        f"; run_steps {step_ms:.3f} ms a step ({BOOK_TIMED_STEPS} steps a "
        f"call, best of {BOOK_TIMED_CALLS} after one), "
        f"{BOOK_BATCH / step_ms * 1e3:.0f} examples/s; this repo's kernels "
        f"launched {sum(counts.values())} times")
    if not (loss_rel <= BOOK_LOSS_RTOL and errs[worst] <= BOOK_GRAD_RTOL
            and path_same):
        raise RuntimeError(f"{tag} the card's step is off the CPU's: loss "
                           f"{loss_rel:.3g}, {worst} {errs[worst]:.3g}, "
                           f"path equal {path_same}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(exe=card, main=main, feed=dev_feed, loss=loss,
                        step_ms=step_ms, loss_rel=loss_rel,
                        grad=errs[worst])


def phase_seq2seq_book(torch):
    """Phase 5k: the MT model's card-vs-CPU step and TF32 control, its
    training row f32 and under AMP (the AMP losses within
    MT_AMP_LOSS_RTOL of the f32 ones over the first MT_AMP_TRACK runs),
    the decode built after the f32 row's training, saved and served by
    the Predictor and rescored on the CPU; each book model's card-vs-CPU
    step and run_steps.  Returns the launches by path (all zero: no
    kernel of this repo lies on these paths) and the rows traced at the
    end of the smoke."""
    t0 = time.perf_counter()
    check = mt_card_vs_cpu(torch)
    by_path, rows = {}, {}
    for amp in (False, True):
        key = f"mt_train{'_amp' if amp else ''}"
        by_path[key], rows[key] = mt_train(torch, amp)
    f32, amp = rows["mt_train"], rows["mt_train_amp"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(amp["losses"],
                                                 f32["losses"])]
    log(f"[mt] AMP loss against f32, run for run: "
        f"{[f'{g:.2g}' for g in gaps]} (bound {MT_AMP_LOSS_RTOL:g} on the "
        f"first {MT_AMP_TRACK})")
    if max(gaps[:MT_AMP_TRACK]) > MT_AMP_LOSS_RTOL:
        raise RuntimeError(f"mt: the AMP losses left the f32 ones: {gaps}")
    by_path["mt_decode"], decode = mt_decode(torch, f32)
    books = {}
    for model in BOOK_MODELS:
        by_path[f"book_{model}"], books[model] = book_card_vs_cpu(torch,
                                                                  model)
    recs = [r for r in VERIFY_LOG if r["phase"] == "seq2seq_book"]
    phase_s = time.perf_counter() - t0
    log(f"[seq2seq_book] MT (run_steps ms a step, tokens/s, run p50 ms, "
        f"peak MiB above what was held) "
        f"{ {k: (round(r['step_ms'], 2), round(2 * MT_T * MT_BATCH / r['step_ms'] * 1e3), round(r['p50'], 2), round(r['peak'] / 2**20, 1)) for k, r in rows.items()} }; "
        f"decode p50 {decode['p50']:.1f} ms; check loss {check['loss']:.3g} "
        f"@GRAD {check['grad']:.3g} (TF32 control {check['ctl_grad']:.3g});"
        f" book (run_steps ms, examples/s) "
        f"{ {m: (round(b['step_ms'], 3), round(BOOK_BATCH / b['step_ms'] * 1e3)) for m, b in books.items()} }; "
        f"the gate verified {len(recs)} programs in error mode, "
        f"{sum(r['errors'] for r in recs)} with an error; phase "
        f"{phase_s:.1f} s; {nvidia_smi_line()}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"seq2seq_book verifications {recs}")
    rows["mt_decode"] = decode
    return by_path, rows


def _s2s_kernel_class(name):
    """Phase 5k's trace classes: beam_search's stable sort (cub's radix
    sort and its passes) apart from the GEMMs, the reductions (softmax,
    logsumexp, the sums), the copies and the elementwise rest."""
    if "(this repo)" in _kernel_class(name):
        return _kernel_class(name)
    low = name.lower()
    if "radixsort" in low or "sort_postprocess" in low:
        return "sort (beam_search's stable descending sort)"
    if any(k in low for k in ("gemm", "cutlass", "nvjet")):
        return "GEMMs (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("reduce", "softmax", "logsumexp")):
        return "reductions (softmax, log_softmax, sums)"
    return ("other (elementwise: the GRU gates, autograd's adds, Adam, "
            "gathers, casts)")


def trace_seq2seq(torch, rows):
    """One MT training step (f32 and AMP) and one served decode request
    traced by kernel class, with the device's idle share; no kernel of
    this repo in any."""
    for key in ("mt_train", "mt_train_amp", "mt_decode"):
        row = rows[key]
        amp = key.endswith("_amp")
        if key == "mt_decode":
            label = (f"MT decode request at batch {MT_BATCH}, beam "
                     f"{MT_BEAM}, max_len {MT_MAX_LEN}")
            fn = functools.partial(row["pred"].run, {"src": row["src"]},
                                   return_numpy=False)
        else:
            label = (f"{'AMP ' if amp else ''}MT training step at batch "
                     f"{MT_BATCH}")
            fn = functools.partial(row["exe"].run, row["main"],
                                   feed=row["feed"],
                                   fetch_list=[row["loss"]],
                                   return_numpy=False)
        with amp_bf16(amp):
            names = trace_run(torch, label, fn, classify=_s2s_kernel_class)
        launches = sum(sum(v.values()) for v in names.values())
        log(f"[trace]   {key}: {launches} kernel launches")
        ours = [c for c in names if "(this repo)" in c]
        if ours:
            raise RuntimeError(f"{key}'s trace holds this repo's kernels: "
                               f"{ours}")


# phase 5l: in-graph learning-rate schedules on the two north-star rows,
# the rest of the conv family at the widths of the public models that
# use each op, and While / Switch on the card (slice 23)
SCHED_NOAM = (512, 4000)     # noam_decay(d_model, warmup): the paper's
SCHED_NMT_STEPS = 4          # run_steps steps whose lrs are checked
SCHED_RESNET = ([2, 4], [0.1, 0.01, 0.001])   # piecewise_decay's
SCHED_RESNET_STEPS = 5       # steps at batch 64: the lrs cross both
SCHED_CHECK_STEPS = 2        # card vs CPU at batch 8: each side of step 2
SCHED_LR_RTOL = 1e-6
# the conv family: (op, input shape, extra inputs' shapes, attrs); the
# pools take conv3d's output; Scale and Bias beside the norms
CONV_FAMILY = {
    # DCGAN's generator (Radford et al. 2015, 64x64): 512 -> 256 at 8x8,
    # 128 -> 3 at 32x32, k4 s2 p1
    "conv2d_transpose_dcgan_512": ("conv2d_transpose", (64, 512, 8, 8),
                                   {"Filter": (512, 256, 4, 4)},
                                   {"strides": 2, "paddings": 1}),
    "conv2d_transpose_dcgan_128": ("conv2d_transpose", (64, 128, 32, 32),
                                   {"Filter": (128, 3, 4, 4)},
                                   {"strides": 2, "paddings": 1}),
    # C3D's first layer (Tran et al. 2015: 16 frames of 112x112, 64
    # 3x3x3 filters), and its pool, k2 s2
    "conv3d_c3d": ("conv3d", (8, 3, 16, 112, 112),
                   {"Filter": (64, 3, 3, 3, 3)}, {"paddings": 1}),
    "pool3d_c3d": ("pool3d", "conv3d_c3d", {},
                   {"ksize": 2, "strides": 2, "pooling_type": "max"}),
    "max_pool3d_with_index_c3d": ("max_pool3d_with_index", "conv3d_c3d",
                                  {}, {"ksize": 2, "strides": 2}),
    "conv3d_transpose": ("conv3d_transpose", (8, 64, 8, 28, 28),
                         {"Filter": (64, 32, 2, 2, 2)}, {"strides": 2}),
    # ResNet's stem pool
    "max_pool2d_with_index_stem": ("max_pool2d_with_index",
                                   (64, 64, 112, 112), {},
                                   {"ksize": 3, "strides": 2,
                                    "paddings": 1}),
    # the group-norm paper's ResNet-50 setting (Wu & He 2018, G 32)
    "group_norm_resnet50": ("group_norm", (32, 256, 56, 56),
                            {"Scale": (256,), "Bias": (256,)},
                            {"groups": 32}),
    # style-transfer widths (Ulyanov et al. 2016)
    "instance_norm_style": ("instance_norm", (16, 64, 128, 128),
                            {"Scale": (64,), "Bias": (64,)}, {}),
}
CONV_CHECK_SAMPLES = 2       # the CPU oracle's samples of each input
# card vs CPU on those samples, f32 with TF32 off: max |card - CPU| over
# max |CPU| of the output and of each gradient; a TF32 control of each
# convolution must exceed it.  Under AMP, CONV_AMP_STEPS bf16 steps
# (2^-7) of max |CPU|, the CPU under the flag on the same inputs.
CONV_RTOL = 1e-4
CONV_AMP_STEPS = 4
CONV_TIMED = 5               # timed calls of a forward or a backward
WHILE_N = 4096               # the While's [N, N] matmul body
WHILE_ITERS = 32


def count_syncs(torch, fn):
    """(fn's result, the host syncs it made): the synchronizing CUDA
    calls torch's sync debug mode reports."""
    out, sites = sync_sites(torch, fn)
    return out, len(sites)


def noam(layers):
    return layers.noam_decay(*SCHED_NOAM)


def piecewise(layers):
    return layers.piecewise_decay(*SCHED_RESNET)


def noam_lr(step):
    d, w = SCHED_NOAM
    return d ** -0.5 * min(step ** -0.5, step * w ** -1.5)


def piecewise_lr(step):
    bounds, values = SCHED_RESNET
    return values[sum(step >= b for b in bounds)]


def check_lrs(tag, got, want):
    import numpy as np
    got = np.asarray(got, np.float64).ravel()
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    if got.shape != (len(want),) or not err <= SCHED_LR_RTOL:
        raise RuntimeError(f"{tag} lrs {list(got)} against the closed form "
                           f"{list(want)}: {err:.3g}")
    return err


def schedule_cost(torch):
    """The launches and host syncs the schedule adds to a step: runs of
    a program holding only noam_decay's two ops (the counter's increment
    and lr_schedule) on the card, traced and under the sync debug mode
    (with the other short traces, in a fresh process); after two warm
    runs (in a fresh process the second run of the program made one
    sync), the next two must make none."""
    import paddle_tpu_torch as ptt
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        lr = noam(ptt.layers)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)

    def run():
        return exe.run(main, fetch_list=[lr], return_numpy=False)
    warm = [sync_sites(torch, run)[1] for _ in range(2)]
    sites = [sync_sites(torch, run)[1] for _ in range(2)]
    syncs = sum(len(s) for s in sites)
    events, wall_us = profiled(torch, run)
    launches = _device_launches(torch, events)
    kernels = sorted(_short_kernel_name(e.key)[:40] for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0)
    log(f"[trace] the schedule alone (noam_decay{SCHED_NOAM}): "
        f"{len(main.global_block().ops)} ops, {launches} kernel launches "
        f"({kernels}), {syncs} host syncs in two runs (the warm runs' "
        f"{warm}), {wall_us / 1e3:.3f} ms a run (synchronized)")
    if syncs:
        raise RuntimeError(f"the schedule made {syncs} host syncs: {sites}")
    return launches, syncs


def sched_nmt_train(torch, amp):
    """bench_nmt's row with Adam's lr noam_decay(512, 4000): run_steps of
    SCHED_NMT_STEPS steps from the startup state, the counters zeroed
    around it (the layer norms its dtypes give, nothing else of this
    repo), each step's fetched lr against the closed form at steps
    1..n, the counter n after it; then time_run_steps as phase 5h times
    its constant-lr row, beside that row's number; the host syncs of one
    run."""
    import paddle_tpu_torch as ptt
    tag = f"[nmt noam train{' amp' if amp else ''}]"
    n = SCHED_NMT_STEPS
    with amp_bf16(amp):
        main, startup, loss, _, extra = xfmr_build("nmt", schedule=noam)
        lr = extra[-1]
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        feed = xfmr_feed("nmt", NMT_BATCH, SEED + 1, device=DEVICE)
        counters = launch_counters()
        zero_counters(counters)
        with record_ln_dtypes(torch) as seen:
            losses, lrs = exe.run_steps(main, feed=feed,
                                        fetch_list=[loss, lr], steps=n)
        n_ln = sum(op.type == "layer_norm" for op in main.global_block().ops)
        if len(seen) != n * n_ln:
            raise RuntimeError(f"{tag} {len(seen)} layer norms in {n} "
                               f"steps of {n_ln}")
        per_run = {"float32": seen.count("float32") // n,
                   "bfloat16": seen.count("bfloat16") // n}
        counts = check_ln_counts(tag, read_counters(counters), per_run, n)
        counter = int(exe.scope.find_var("@lr_global_step@").item())
        err = check_lrs(tag, lrs, [noam_lr(s) for s in range(1, n + 1)])
        if counter != n:
            raise RuntimeError(f"{tag} the counter reads {counter} after "
                               f"{n} steps")
        _, syncs = count_syncs(torch, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], return_numpy=False))
        step_ms = time_run_steps(torch, exe, main, feed, loss,
                                 steps=XFMR_TIMED_STEPS,
                                 calls=XFMR_TIMED_CALLS)
    const = XFMR_ROWS.get(f"nmt_train{'_amp' if amp else ''}", {})
    log(f"{tag} batch {NMT_BATCH}: lrs {[f'{float(x):.6g}' for x in lrs.ravel()]}"
        f" (closed form within {err:.2g}, bound {SCHED_LR_RTOL:g}), counter "
        f"{counter}; losses {[round(float(x), 4) for x in losses]}; "
        f"run_steps {step_ms:.2f} ms a step against phase 5h's constant-lr "
        f"row's {const.get('step_ms', float('nan')):.2f} in this process "
        f"({XFMR_TIMED_STEPS} steps a call, best of {XFMR_TIMED_CALLS}); "
        f"{syncs} host syncs in one run (fetch left on the card); layer "
        f"norms a step {per_run}; {nvidia_smi_line()}")
    if not all(math.isfinite(float(x)) for x in losses):
        raise RuntimeError(f"{tag} non-finite loss {losses}")
    return counts, dict(step_ms=step_ms, const_ms=const.get("step_ms"),
                        syncs=syncs, lrs=[float(x) for x in lrs.ravel()])


def sched_resnet(torch):
    """bench_resnet50's row with Momentum's lr piecewise_decay([2, 4],
    [0.1, 0.01, 0.001]): (a) SCHED_CHECK_STEPS f32 steps at batch
    RESNET_CHECK_BATCH from the card's state (the counter among it), on
    the card, on a CPUPlace executor and on the card with cuDNN's TF32
    (the control), each step held to RESNET_BOUNDS (the params' change
    carries the lr) and the control outside one; (b) SCHED_RESNET_STEPS
    steps at batch RESNET_BATCH from a fresh startup, the counters zeroed
    around them (no kernel of this repo), each step's lr against the
    closed form (both boundaries crossed), the step p50."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = "[resnet piecewise]"
    main, startup, loss, lr, _ = build_resnet(schedule=piecewise)
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    kinds = resnet_kinds(main)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    feed = resnet_feed(RESNET_CHECK_BATCH, SEED + 11)
    rows = []
    for step in range(SCHED_CHECK_STEPS):
        before = host_state(card.scope, names)
        ptt.io.params_from_numpy(cpu.scope, {n: t.numpy() for n, t in
                                             before.items()},
                                 ptt.CPUPlace())
        t0 = time.perf_counter()
        out, want_lr = cpu.run(main, feed=feed, fetch_list=[loss, lr])
        cpu_s = time.perf_counter() - t0
        want_loss, want = float(out.reshape(())), host_state(cpu.scope,
                                                             names)
        res = {}
        for ctl in (True, False):      # the card's own step last
            ptt.io.params_from_numpy(card.scope, {n: t.numpy() for n, t in
                                                  before.items()},
                                     ptt.CUDAPlace(0))
            with (cudnn_tf32(torch) if ctl else contextlib.nullcontext()):
                out, got_lr = card.run(main, feed=feed,
                                       fetch_list=[loss, lr])
            res[ctl] = step_errors(kinds, before, want,
                                   host_state(card.scope, names),
                                   want_loss, float(out.reshape(())))
        check_lrs(tag, [float(got_lr[0]), float(want_lr[0])],
                  [piecewise_lr(step + 1)] * 2)
        rows.append((step + 1, float(got_lr[0]), res[False][ "param"][0],
                     res[True]["param"][0]))
        log(f"{tag} check step {step + 1} (lr {float(got_lr[0]):g}), batch "
            f"{RESNET_CHECK_BATCH}: card vs CPU {fmt_errors(res[False])}; "
            f"TF32 control {fmt_errors(res[True])}; CPU step {cpu_s:.1f} s")
        if not all(res[False][k][0] <= b for k, b in RESNET_BOUNDS.items()):
            raise RuntimeError(f"{tag} step {step + 1} off the CPU's")
        if not any(res[True][k][0] > b for k, b in RESNET_BOUNDS.items()):
            raise RuntimeError(f"{tag} the TF32 control passed the bounds "
                               f"at step {step + 1}")
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    feed = resnet_feed(RESNET_BATCH, SEED + 1, device=DEVICE)
    counters = launch_counters()
    zero_counters(counters)
    lrs, losses, ms = [], [], []
    for _ in range(SCHED_RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, got = exe.run(main, feed=feed, fetch_list=[loss, lr])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.reshape(())))
        lrs.append(float(got[0]))
    counts = {k: v for (k, attr), v in read_counters(counters).items()
              if attr == "launches"}
    err = check_lrs(tag, lrs, [piecewise_lr(s) for s in
                               range(1, SCHED_RESNET_STEPS + 1)])
    p50 = float(np.median(ms[1:]))
    log(f"{tag} batch {RESNET_BATCH}: lrs {lrs} (closed form within "
        f"{err:.2g}); losses {[round(x, 4) for x in losses]}; step p50 "
        f"{p50:.2f} ms (steps 2-{SCHED_RESNET_STEPS}, synchronized, loss "
        f"and lr read back), {RESNET_BATCH / p50 * 1e3:.1f} img/s; "
        f"{nvidia_smi_line()}")
    if any(counts.values()) or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} launches {counts}, losses {losses}")
    return counts, dict(p50=p50, lrs=lrs, checks=rows)


def _conv_inputs(torch, name, made):
    """A family case's inputs on the card (seeded), as {slot: [tensor]};
    the pools take conv3d's output from `made`."""
    op, shape, extra, _ = CONV_FAMILY[name]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + len(made))
    if isinstance(shape, str):
        x = made[shape]
    else:
        x = torch.randn(shape, generator=g, device=DEVICE)
    ins = {"Input" if "conv" in op else "X": [x]}
    for slot, s in extra.items():
        t = torch.randn(s, generator=g, device=DEVICE)
        if slot == "Filter":
            t = t * (2.0 / math.prod(s[1:])) ** 0.5
        ins[slot] = [t]
    return ins


def _conv_run(torch, op, ins, attrs, device, amp, bf16_input):
    """One forward and backward of `op` on `device`: (outputs, grads of
    every float input) as host f32 tensors; the cotangent is seeded and
    made on the host, so both devices take the same one."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    ins = {k: [t.detach().to(device) for t in v] for k, v in ins.items()}
    x_slot = "Input" if "Input" in ins else "X"
    if bf16_input:
        ins[x_slot] = [ins[x_slot][0].to(torch.bfloat16)]
    leaves = [t.requires_grad_(True) for v in ins.values() for t in v]
    with amp_bf16(amp):
        res = get_op_def(op).lower(LowerContext(SEED, device), ins, attrs)
    out_slot = "Output" if "Output" in res else ("Y" if "Y" in res
                                                 else "Out")
    out = res[out_slot][0]
    gen = torch.Generator().manual_seed(SEED)
    ct = torch.randn(tuple(out.shape), generator=gen).to(device, out.dtype)
    grads = torch.autograd.grad(out, leaves, ct)
    outs = {out_slot: out.detach().float().cpu()}
    if "Mask" in res:
        outs["Mask"] = res["Mask"][0].cpu()
    return outs, [g.float().cpu() for g in grads]


def _conv_errs(got, want):
    """max |got - want| / max |want| of each output and gradient; the
    Mask's mismatched entries."""
    errs = {}
    for k, w in want[0].items():
        if k == "Mask":
            errs[k] = int((got[0][k] != w).sum())
        else:
            errs[k] = rel_err(got[0][k], w)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        errs[f"grad{i}"] = rel_err(g, w)
    return errs


def _conv_kernel_class(name):
    """The conv family's trace classes: cuDNN's convolutions (and their
    transposes), pooling, reductions, the eager elementwise rest."""
    c = _resnet_kernel_class(name)
    if c.startswith("reductions"):
        return "reductions (amax, the norms' statistics)"
    return "elementwise (eager torch)" if c.startswith("elementwise") else c


def conv_family(torch):
    """Each CONV_FAMILY case at full width: forward and backward timed
    (CONV_TIMED calls each, the backward retaining the graph) in f32 and
    under AMP (the convolutions cast to bf16 by the flag, the pools and
    norms fed a bf16 activation, as they are after a bf16 convolution);
    on the first CONV_CHECK_SAMPLES samples of the same inputs the card
    against the CPU (the CPU under the flag too for AMP): the output and
    every input's gradient within CONV_RTOL (f32) or CONV_AMP_STEPS bf16
    steps (AMP), the index pools' Mask equal, and for each convolution a
    run with cuDNN's TF32 on outside CONV_RTOL.  The counters are zeroed
    around it: no kernel of this repo.  Returns the counts and the rows."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    counters = launch_counters()
    zero_counters(counters)
    made, rows = {}, {}
    for name, (op, _, _, attrs) in CONV_FAMILY.items():
        ins = _conv_inputs(torch, name, made)
        is_conv = "conv" in op
        row = {}
        for amp in (False, True):
            bf16_in = amp and not is_conv
            tag = f"[conv family] {name}{' amp' if amp else ''}"
            full, leaves = _conv_case(torch, name, ins, amp)
            ctx = LowerContext(SEED, torch.device(DEVICE))
            with amp_bf16(amp):
                res = get_op_def(op).lower(ctx, full, attrs)
                out_slot = ("Output" if "Output" in res else
                            "Y" if "Y" in res else "Out")
                out = res[out_slot][0]
                fwd_ms, _ = time_ms(lambda: get_op_def(op).lower(
                    ctx, full, attrs), iters=CONV_TIMED, warmup=1)
            ct = torch.randn_like(out)
            bwd_ms, _ = time_ms(lambda: torch.autograd.grad(
                out, leaves, ct, retain_graph=True), iters=CONV_TIMED,
                warmup=1)
            if name == "conv3d_c3d" and not amp:
                made[name] = out.detach()
            del res, out, ct
            part = {k: [t[:CONV_CHECK_SAMPLES] if k in ("Input", "X")
                        else t for t in v] for k, v in ins.items()}
            t0 = time.perf_counter()
            want = _conv_run(torch, op, part, attrs, torch.device("cpu"),
                             amp, bf16_in)
            cpu_s = time.perf_counter() - t0
            got = _conv_run(torch, op, part, attrs, torch.device(DEVICE),
                            amp, bf16_in)
            errs = _conv_errs(got, want)
            bound = CONV_AMP_STEPS * 2.0 ** -7 if amp else CONV_RTOL
            ctl = None
            if is_conv and not amp:
                with cudnn_tf32(torch):
                    ctl = _conv_errs(_conv_run(
                        torch, op, part, attrs, torch.device(DEVICE), amp,
                        bf16_in), want)
            log(f"{tag}: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
                f"at {tuple(ins['Input' if 'Input' in ins else 'X'][0].shape)}"
                f"; card vs CPU on {CONV_CHECK_SAMPLES} samples "
                f"{ {k: (v if k == 'Mask' else f'{v:.3g}') for k, v in errs.items()} }"
                f" (bound {bound:.3g}, Mask equal)"
                + (f"; TF32 control {max(ctl.values()):.3g}" if ctl else "")
                + f"; CPU {cpu_s:.2f} s")
            if any(v > (0 if k == "Mask" else bound)
                   for k, v in errs.items()):
                raise RuntimeError(f"{tag} card off the CPU: {errs}")
            if ctl is not None and not max(ctl.values()) > CONV_RTOL:
                raise RuntimeError(f"{tag} the TF32 control passed "
                                   f"CONV_RTOL: {ctl}")
            row["amp" if amp else "f32"] = dict(fwd_ms=fwd_ms,
                                                bwd_ms=bwd_ms, **errs)
        rows[name] = row
    counts = {k: v for (k, attr), v in read_counters(counters).items()
              if attr == "launches"}
    if any(counts.values()):
        raise RuntimeError(f"[conv family] launched this repo's kernels: "
                           f"{counts}")
    return counts, rows


def _conv_case(torch, name, ins, amp):
    """A family case's full-width inputs as its lowering takes them (the
    pools' and norms' X in bf16 under AMP, as after a bf16 convolution),
    each a leaf: (inputs by slot, leaves)."""
    bf16_in = amp and "conv" not in CONV_FAMILY[name][0]
    full = {k: [t.to(torch.bfloat16) if bf16_in and k in ("Input", "X")
                else t for t in v] for k, v in ins.items()}
    leaves = [t.detach().requires_grad_(True)
              for v in full.values() for t in v]
    it = iter(leaves)
    return {k: [next(it) for _ in v] for k, v in full.items()}, leaves


def conv_family_cases(torch):
    """Every conv-family case at full width, f32 and AMP, made as
    conv_family makes them: {(name, amp): (op, inputs, attrs, leaves)}."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    made, cases = {}, {}
    for name, (op, _, _, attrs) in CONV_FAMILY.items():
        ins = _conv_inputs(torch, name, made)
        for amp in (False, True):
            full, leaves = _conv_case(torch, name, ins, amp)
            cases[(name, amp)] = (op, full, attrs, leaves)
        if name == "conv3d_c3d":
            res = get_op_def(op).lower(
                LowerContext(SEED, torch.device(DEVICE)),
                cases[(name, False)][1], attrs)
            made[name] = res["Output"][0].detach()
    return cases


def while_switch(torch):
    """JAX's two control-flow programs (tests/test_control_flow.py: the
    While summing 0..4, a Switch on each side of its threshold) on the
    card, then a While of WHILE_ITERS iterations whose body is a
    [WHILE_N, WHILE_N] f32 matmul, a round trip through bf16 (two casts)
    and an increment, against the same body unrolled WHILE_ITERS times
    in one block: the same bits, the host syncs of each (torch's sync
    debug mode) and the wall time of a synchronized run."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import control_flow as cf
    L = ptt.layers

    def program(build):
        ptt.reset_default_programs()
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            fetch = build()
        return main, fetch

    def while_sum():
        i = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", 5.0)
        acc = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, n)
        with L.While(cond).block():
            L.assign(L.elementwise_add(acc, i), acc)
            L.assign(L.increment(i, value=1.0, in_place=False), i)
            L.less_than(i, n, cond=cond)
        return [acc, i]

    def switch(step):
        s = L.fill_constant([1], "float32", step)
        lr = L.fill_constant([1], "float32", 0.0)
        with L.Switch() as sw:
            with sw.case(L.less_than(s, L.fill_constant([1], "float32",
                                                        5.0))):
                L.assign(L.fill_constant([1], "float32", 0.1), lr)
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 0.01), lr)
        return [lr]

    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    main, fetch = program(while_sum)
    acc, i = exe.run(main, fetch_list=fetch)
    lrs = []
    for step in (7.0, 2.0):
        main, fetch = program(lambda: switch(step))
        lrs.append(float(exe.run(main, fetch_list=fetch)[0][0]))
    if (float(acc[0]), float(i[0])) != (10.0, 5.0) or lrs != [
            np.float32(0.01), np.float32(0.1)]:
        raise RuntimeError(f"[while/switch] JAX's programs on the card: "
                           f"acc {acc}, i {i}, Switch {lrs}")

    def body(x, w):
        y = L.matmul(x, w)
        return L.cast(L.cast(y, "bfloat16"), "float32")

    def looped():
        x = L.data("x", [WHILE_N, WHILE_N], append_batch_size=False)
        w = L.data("w", [WHILE_N, WHILE_N], append_batch_size=False)
        k = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", float(WHILE_ITERS))
        cond = L.less_than(k, n)
        with L.While(cond).block():
            L.assign(body(x, w), x)
            L.increment(k, value=1.0)
            L.less_than(k, n, cond=cond)
        return [x]

    def unrolled():
        x = L.data("x", [WHILE_N, WHILE_N], append_batch_size=False)
        w = L.data("w", [WHILE_N, WHILE_N], append_batch_size=False)
        for _ in range(WHILE_ITERS):
            x = body(x, w)
        return [x]

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    feed = {"x": torch.randn(WHILE_N, WHILE_N, generator=g, device=DEVICE),
            "w": torch.randn(WHILE_N, WHILE_N, generator=g, device=DEVICE)
            / WHILE_N ** 0.5}
    res = {}
    for kind, build in (("while", looped), ("unrolled", unrolled)):
        main, fetch = program(build)

        def run():
            out, = exe.run(main, feed=feed, fetch_list=fetch,
                           return_numpy=False)
            torch.cuda.synchronize()
            return out
        run()
        reads = cf._read_cond.cond_reads
        out, syncs = count_syncs(torch, run)
        reads = cf._read_cond.cond_reads - reads
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[kind] = dict(out=out, syncs=syncs, reads=reads,
                         ms=float(np.median(ms)))
    same = bool(torch.equal(res["while"]["out"], res["unrolled"]["out"]))
    log(f"[while/switch] JAX's While (acc 10, i 5) and Switch (step 7 -> "
        f"0.01, step 2 -> 0.1) on the card; a While of {WHILE_ITERS} "
        f"[{WHILE_N}, {WHILE_N}] matmuls: {res['while']['ms']:.2f} ms, "
        f"{res['while']['syncs']} host syncs ({res['while']['reads']} "
        f"condition reads) against the body unrolled "
        f"{res['unrolled']['ms']:.2f} ms, {res['unrolled']['syncs']} host "
        f"syncs (run p50 of 3, synchronized, the result left on the card); "
        f"the same bits: {same}; {nvidia_smi_line()}")
    if not same or res["while"]["reads"] != WHILE_ITERS + 1:
        raise RuntimeError(f"[while/switch] the While's result or its "
                           f"condition reads: {same}, {res['while']}")


def phase_sched_conv(torch):
    """Phase 5l: noam_decay on bench_nmt's row (card vs CPU with its TF32
    control, run_steps f32 and AMP), piecewise_decay on bench_resnet50's,
    what a schedule adds to a step, the conv family at its public
    models' widths, and While / Switch on the card.  Returns the launch
    counts by path."""
    t0 = time.perf_counter()
    check = xfmr_card_vs_cpu(torch, "nmt", schedule=noam)
    by_path, rows = {}, {}
    for amp in (False, True):
        key = f"nmt_noam_train{'_amp' if amp else ''}"
        by_path[key], rows[key] = sched_nmt_train(torch, amp)
    by_path["resnet_piecewise_train"], rows["resnet"] = sched_resnet(torch)
    by_path["conv_family"], conv_rows = conv_family(torch)
    while_switch(torch)
    recs = [r for r in VERIFY_LOG if r["phase"] == "sched_conv"]
    log(f"[sched_conv] NMT noam check loss "
        f"{check['loss']:.3g} @GRAD {check['grad']:.3g} (TF32 control "
        f"{check['ctl_grad']:.3g}); run_steps ms a step (noam, constant) "
        f"{ {k: (round(r['step_ms'], 2), r['const_ms'] and round(r['const_ms'], 2)) for k, r in rows.items() if k != 'resnet'} }; "
        f"conv family (fwd ms, bwd ms) "
        f"{ {k: {m: (round(v['fwd_ms'], 3), round(v['bwd_ms'], 3)) for m, v in r.items()} for k, r in conv_rows.items()} }; "
        f"the gate verified {len(recs)} programs in error mode, "
        f"{sum(r['errors'] for r in recs)} with an error; phase "
        f"{time.perf_counter() - t0:.1f} s; {nvidia_smi_line()}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"sched_conv verifications {recs}")
    return by_path


def trace_sched_conv(torch, cases):
    """One forward and backward of each conv-family case
    (conv_family_cases) traced by kernel class (f32 and AMP), with the
    device's idle share; no kernel of this repo in any."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    for (name, amp), (op, full, attrs, leaves) in cases.items():
        def fn():
            with amp_bf16(amp):
                res = get_op_def(op).lower(
                    LowerContext(SEED, torch.device(DEVICE)), full, attrs)
            out = res.get("Output", res.get("Y", res.get("Out")))[0]
            torch.autograd.grad(out, leaves, torch.ones_like(out))
        names = trace_run(torch, f"{name}{' AMP' if amp else ''} forward "
                                 f"and backward", fn,
                          classify=_conv_kernel_class)
        if any("(this repo)" in c for c in names):
            raise RuntimeError(f"{name}'s trace holds this repo's kernels")


# phase 5m: int8 and fp8: FLAGS_quantize_dtype's products at
# the flagship's shapes and bench_lm_int8 (bench.py:250), freeze_program's
# quantized_conv2d / quantized_matmul at ResNet-50's and
# bench_resnet50_infer_int8 (:407), QAT on bench_resnet50 and its e4m3
# freeze, and fused_multihead_attention
QUANT_DTYPES = ("int8", "e4m3", "e5m2")
# (rows, K, columns) of the flagship's products at batch 32 x T 512: the
# attention projections (fused_mha's, which stay bf16 in bench_lm_int8,
# and fused_multihead_attention's), W1 and W2
QUANT_LM_PRODUCTS = ((16384, 512, 512), (16384, 512, 2048),
                     (16384, 2048, 512))
# the unfused attention's q.k^T at the flagship's training shape (B, H,
# T, d): both operands batched, one 2-D product a (batch, head)
QUANT_ATTN = (32, 8, 512, 64)
QUANT_CPU_ROWS = 512       # the CPU side's rows of each product
QUANT_X_MAX = 8.0          # planted in row 0 (x is clipped to +-7 first),
                           # so the CPU rows see the card's abs-max scale
# ResNet-50's stem (7x7 s2), a 3x3 and a 1x1 s2 downsample at batch 16,
# and small grouped, dilated and depthwise cases: (batch, C, H, W, O, k,
# stride, pad, dilation, groups)
QUANT_CONVS = {"stem": (16, 3, 224, 224, 64, 7, 2, 3, 1, 1),
               "3x3": (16, 64, 56, 56, 64, 3, 1, 1, 1, 1),
               "1x1_s2": (16, 256, 56, 56, 512, 1, 2, 0, 1, 1),
               "grouped": (2, 32, 14, 14, 64, 3, 1, 1, 1, 4),
               "dilated": (2, 16, 14, 14, 16, 3, 1, 2, 2, 1),
               "depthwise": (2, 32, 14, 14, 32, 3, 1, 1, 1, 32)}
QUANT_CHECK_SAMPLES = 2    # the CPU oracle's samples of a convolution or model
# fp8 accumulators on the card against the CPU's f32 sums (and the f64
# plain version on the card), of max |CPU|: cuBLASLt's e4m3 product with
# use_fast_accum=False does not accumulate in full f32 on Hopper's fp8
# tensor cores (products 1.8e-4-4.1e-4 in phase 5m, H100 80GB HBM3, 700 W); e5m2
# runs as a bf16 product with f32 accumulation (1e-7)
FP8_RTOL = {"e4m3": 2e-3, "e5m2": 1e-6}
QUANT_GRAD_RTOL = {False: 1e-4, True: 2e-2}   # STE backward, f32 / AMP
LM_INT8_RUNS = 2           # counted runs of each row
LM_INT8_TIMED_STEPS = 10   # time_run_steps: steps a call, timed calls
LM_INT8_TIMED_CALLS = 2
LM_INT8_CHECK_BATCH = 8    # the int8 card-vs-CPU step (the CPU side is the cost)
LM_INT8_CHECK_LAYERS = 2
LM_INT8_LOSS_RTOL = 5e-3   # the int8 row's first loss against the AMP row's
QUANT_PRED_RTOL = 1e-4     # int8 model outputs, card vs CPU on the card's codes
QAT_FP8_PRED_RTOL = 1e-2   # e4m3 outputs, card vs CPU on the card's codes
QAT_STEPS = 5
FMHA = dict(B=8, T=512, D=512, H=8)
FMHA_RTOL = {False: 1e-4, True: 2e-2}   # outputs and @GRADs, of their max
QUANT_TIMED = 20           # timed calls of a product, a pass or a convolution
QUANT_ROWS = {}            # phase 5g's rows, for 5m's comparisons


@contextlib.contextmanager
def quantize_flag(qd):
    """FLAGS_quantize_dtype set to `qd` in the port for the block."""
    import paddle_tpu_torch as ptt
    old = ptt.flags.get_flag("quantize_dtype")
    ptt.flags.set_flag("quantize_dtype", qd)
    try:
        yield
    finally:
        ptt.flags.set_flag("quantize_dtype", old)


@contextlib.contextmanager
def quant_codes(record=None, replay=None):
    """quantize_ops.quantize_array recording its codes (on the host, in
    call order) into `record`, or returning the codes of `replay` in call
    order; yields the codes not yet replayed.  Meta evaluations pass
    through."""
    from paddle_tpu_torch.ops import quantize_ops as qo
    orig = qo.quantize_array
    left = list(replay or ())

    def qa(x, scale, qd):
        if x.device.type == "meta":
            return orig(x, scale, qd)
        if replay is not None:
            return left.pop(0).to(x.device)
        out = orig(x, scale, qd)
        record.append(out.cpu())
        return out

    qo.quantize_array = qa
    try:
        yield left
    finally:
        qo.quantize_array = orig


def code_flips(a, b):
    """(codes that differ, codes) between two recordings of the same
    calls."""
    import torch
    if len(a) != len(b):
        raise RuntimeError(f"{len(a)} against {len(b)} quantize calls")
    n = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise RuntimeError(f"codes {x.shape} {x.dtype} against "
                               f"{y.shape} {y.dtype}")
        if x.is_floating_point():
            x, y = x.view(torch.uint8), y.view(torch.uint8)
        n += int((x != y).sum())
    return n, sum(x.numel() for x in a)


def sync_sites(torch, fn):
    """(fn's result, the host syncs it made as torch's sync debug mode
    reports them), each sync as the innermost frames of the port or this
    script that made it."""
    import traceback
    import warnings
    sites = []
    show = warnings.showwarning

    def record(message, *args, **kw):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "paddle_tpu_torch" in f.filename
                      or f.filename.endswith("chip_smoke.py")]
            sites.append(" <- ".join(
                f"{f.filename.split('/')[-1]}:{f.lineno} {f.name}"
                for f in reversed(frames[-3:])))

    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(old)
            warnings.showwarning = show
    return out, sites


def lp_launches():
    from paddle_tpu_torch.ops import quantize_ops as qo
    return dict(qo.lp_product.launches)


def lp_moved(before):
    now = lp_launches()
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0)}


def lp_peak(qd):
    """The card's dense peak for a product of `qd` operands (int8 and fp8
    1979 T/s; e5m2's bf16 lowering 989)."""
    return 989e12 if qd == "e5m2" else 1979e12


def quant_products(torch):
    """(1) The flagship's products for int8, e4m3 and e5m2: the codes of
    the same inputs on both devices, the library product's accumulators
    against the plain version on the card (f64 for int8) and the CPU's on
    QUANT_CPU_ROWS rows; e4m3's use_fast_accum=True error against f64
    logged (a finding, not a path); low_precision_matmul forward and STE
    backward in f32 and under AMP, card rows against the CPU's; the
    product, the quantize pass and the bf16 / f32 products timed."""
    import numpy as np
    from paddle_tpu_torch.ops import quantize_ops as qo
    rng = np.random.RandomState(SEED + 40)
    R = QUANT_CPU_ROWS
    rows = {}
    for (N, K, M) in QUANT_LM_PRODUCTS:
        x = np.clip(rng.randn(N, K), -7, 7).astype(np.float32)
        x[0, 0] = QUANT_X_MAX
        w = (rng.randn(K, M) * 0.05).astype(np.float32)
        g = rng.randn(N, M).astype(np.float32)
        xc, wc, gc = (torch.from_numpy(a) for a in (x, w, g))
        xg, wg, gg = (t.to(DEVICE) for t in (xc, wc, gc))
        for qd in QUANT_DTYPES:
            tag = f"[quant {qd} {N}x{K}x{M}]"
            codes = {}
            for dev, (a, b) in (("card", (xg, wg)), ("cpu", (xc, wc))):
                codes[dev] = (qo.quantize_array(a, a.abs().max(), qd),
                              qo.quantize_array(b, b.abs().amax(0)[None],
                                                qd))
            flips, n = code_flips([c.cpu() for c in codes["card"]],
                                  list(codes["cpu"]))
            xq, wq = codes["card"]
            before = lp_launches()
            acc = qo.lp_product(xq, wq, qd)
            moved = lp_moved(before)
            plain = qo.lp_product_plain(xq, wq, qd)
            cpu = qo.lp_product_plain(codes["cpu"][0][:R], codes["cpu"][1],
                                      qd)
            if qd == "int8":
                ok = (torch.equal(acc, plain)
                      and torch.equal(acc[:R].cpu(), cpu))
                errs = dict(plain=0.0 if ok else rel_err(acc, plain),
                            cpu=0.0 if ok else rel_err(acc[:R].cpu(), cpu))
            else:
                errs = dict(plain=rel_err(acc.double(), plain.double()),
                            cpu=rel_err(acc[:R].cpu().double(),
                                        cpu.double()))
                ok = max(errs.values()) <= FP8_RTOL[qd]
            fast = None
            if qd == "e4m3":
                one = torch.ones((), device=DEVICE)
                f = torch._scaled_mm(xq, wq.t().contiguous().t(),
                                     scale_a=one, scale_b=one,
                                     out_dtype=torch.float32,
                                     use_fast_accum=True)
                fast = rel_err(f.double(), plain.double())
            # forward and STE backward through low_precision_matmul
            ste = {}
            for amp in (False, True):
                with amp_bf16(amp):
                    a, b = (xg.clone().requires_grad_(),
                            wg.clone().requires_grad_())
                    out = qo.low_precision_matmul(a, b, qd, torch.float32)
                    ga, gb = torch.autograd.grad(out, (a, b),
                                                 gg.to(out.dtype))
                    c = xc[:R].clone().requires_grad_()
                    out_c = qo.low_precision_matmul(c, wc, qd,
                                                    torch.float32)
                    gc_, = torch.autograd.grad(out_c, c,
                                               gc[:R].to(out_c.dtype))
                xa = xg.to(torch.bfloat16) if amp else xg
                gb_plain = xa.double().t() @ gg.to(out.dtype).double()
                out, out_c = out.detach(), out_c.detach()
                e_out = (0.0 if torch.equal(out[:R].cpu(), out_c)
                         else rel_err(out[:R].cpu(), out_c))
                ste[amp] = dict(out=e_out, gx=rel_err(ga[:R].cpu(), gc_),
                                gw=rel_err(gb.double(), gb_plain))
                bound = 0.0 if qd == "int8" else FP8_RTOL[qd]
                if amp and qd != "int8":
                    bound += 2 ** -7     # one bf16 step of the max
                if ste[amp]["out"] > bound or max(
                        ste[amp]["gx"], ste[amp]["gw"]) > \
                        QUANT_GRAD_RTOL[amp]:
                    raise RuntimeError(f"{tag} low_precision_matmul "
                                       f"{'AMP' if amp else 'f32'}: "
                                       f"{ste[amp]}")
            ms = dict(product=time_ms(lambda: qo.lp_product(xq, wq, qd),
                                      iters=QUANT_TIMED)[0],
                      quantize=time_ms(
                          lambda: qo.quantize_array(xg, xg.abs().max(), qd),
                          iters=QUANT_TIMED)[0],
                      bf16=time_ms(lambda: torch.matmul(
                          xg.to(torch.bfloat16), wg.to(torch.bfloat16)),
                          iters=QUANT_TIMED)[0],
                      f32=time_ms(lambda: torch.matmul(xg, wg),
                                  iters=QUANT_TIMED)[0])
            bound_ms = 2 * N * K * M / lp_peak(qd) * 1e3
            log(f"{tag} codes card vs CPU: {flips} of {n} differ; library "
                f"product {moved} against the plain version on the card "
                f"(f64 for int8) {errs['plain']:.3g} and the CPU's {R} rows "
                f"{errs['cpu']:.3g} of max (bound "
                f"{0 if qd == 'int8' else FP8_RTOL[qd]:g})"
                + (f"; use_fast_accum=True {fast:.3g} against f64 (a "
                   f"finding: not a path)" if fast is not None else "")
                + f"; low_precision_matmul card rows vs CPU (out, gx; gw vs "
                  f"f64 on the card) f32 "
                  f"{ {k: round(v, 9) for k, v in ste[False].items()} }, AMP "
                  f"{ {k: round(v, 9) for k, v in ste[True].items()} }; ms: "
                  f"product {ms['product']:.4f} (bound {bound_ms:.4f}), "
                  f"quantize x {ms['quantize']:.4f}, bf16 matmul "
                  f"{ms['bf16']:.4f}, f32 {ms['f32']:.4f}")
            if flips or not ok or moved != {
                    {"int8": "int_mm", "e4m3": "scaled_mm",
                     "e5m2": "bf16_mm"}[qd]: 1}:
                raise RuntimeError(f"{tag} flips {flips}, errors {errs}, "
                                   f"launches {moved}")
            rows[(qd, (N, K, M))] = dict(errs, fast=fast, ste=ste, **ms)
    rows.update(quant_batched(torch))
    return rows


def quant_batched(torch):
    """(1) A product of two batched operands (QUANT_ATTN's q.k^T, as the
    unfused attention runs it under the flag): one library product a
    (batch, head), the accumulators against the plain version on the card
    and on the CPU for the first pair, and its time beside one bf16
    batched matmul."""
    from paddle_tpu_torch.ops import quantize_ops as qo
    B, H, T, d = QUANT_ATTN
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 44)
    q = torch.randn(B, H, T, d, generator=gen, device=DEVICE)
    k = torch.randn(B, H, d, T, generator=gen, device=DEVICE)
    rows = {}
    for qd in ("int8", "e4m3"):
        xq = qo.quantize_array(q, q.abs().max(), qd)
        yq = qo.quantize_array(k, k.abs().amax(dim=(0, 1, 2), keepdim=True),
                               qd)
        before = lp_launches()
        acc = qo.lp_product(xq, yq, qd)
        moved = lp_moved(before)
        plain = qo.lp_product_plain(xq, yq, qd)
        cpu = qo.lp_product_plain(xq[:1, :1].cpu(), yq[:1, :1].cpu(), qd)
        if qd == "int8":
            ok = torch.equal(acc, plain) and torch.equal(acc[:1, :1].cpu(),
                                                         cpu)
            err = 0.0 if ok else rel_err(acc, plain)
        else:
            err = max(rel_err(acc.double(), plain.double()),
                      rel_err(acc[:1, :1].cpu().double(), cpu.double()))
            ok = err <= FP8_RTOL[qd]
        ms, clock = device_or_host_ms(
            torch, lambda: qo.lp_product(xq, yq, qd), iters=5)
        qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
        bf16 = time_ms(lambda: torch.matmul(qb, kb), iters=QUANT_TIMED)[0]
        want = {{"int8": "int_mm", "e4m3": "scaled_mm"}[qd]: B * H}
        log(f"[quant {qd} batched] q.k^T {(B, H, T, d)}: products a call "
            f"{moved}; accumulators against the plain version (card, and "
            f"the CPU's first pair) {err:.3g} of max; {ms:.3f} ms a call "
            f"({clock}) against one bf16 batched matmul's {bf16:.4f}")
        if not ok or moved != want:
            raise RuntimeError(f"[quant {qd} batched] error {err}, "
                               f"launches {moved}")
        rows[(qd, "batched")] = dict(plain=err, ms=ms, bf16=bf16)
    return rows



def device_or_host_ms(torch, fn, iters=QUANT_TIMED):
    """(ms a call, clock): time_ms's device time where the host can queue
    the calls ahead of the device, else the host clock around
    `iters` synchronized calls (a call whose host work outlasts its
    kernels, as the depthwise case's 32 group products)."""
    try:
        return time_ms(fn, iters=iters)[0], "device"
    except RuntimeError:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters, "host clock"


def quant_convs(torch):
    """(2) quantized_conv2d's lowering at ResNet-50's shapes (int8 and
    e4m3): the im2col product's accumulators on the first
    QUANT_CHECK_SAMPLES samples against F.conv2d of the same codes on the
    CPU (f64 for int8: equal; f32 for e4m3: FP8_RTOL), the products a
    call, and its time beside cuDNN's f32 and bf16 convolutions."""
    import numpy as np
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import quantize_ops as qo
    rng = np.random.RandomState(SEED + 42)
    rows = {}
    for name, (B, C, H, W, O, k, s, p, d, g) in QUANT_CONVS.items():
        x = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32))
        w = torch.from_numpy(rng.randn(O, C // g, k, k).astype(np.float32))
        xg, wg = x.to(DEVICE), w.to(DEVICE)
        geo = ((s, s), (p, p), (d, d), g)
        for qd in ("int8", "e4m3"):
            xq = qo.quantize_array(xg, xg.abs().max(), qd)
            wq = qo.quantize_array(
                wg, qo.channel_scales(wg, 0).reshape(-1, 1, 1, 1), qd)
            before = lp_launches()
            acc = qo.lp_conv2d(xq, wq, qd, *geo)
            moved = lp_moved(before)
            S = QUANT_CHECK_SAMPLES
            cpu = qo.lp_conv2d_plain(xq[:S].cpu(), wq.cpu(), qd, *geo)
            got = acc[:S].cpu()
            if qd == "int8":
                err = 0.0 if torch.equal(got, cpu) else rel_err(got, cpu)
                ok = err == 0.0
            else:
                err = rel_err(got.double(), cpu.double())
                ok = err <= FP8_RTOL[qd]
            ms, clock = device_or_host_ms(
                torch, lambda: qo.lp_conv2d(xq, wq, qd, *geo))
            ms_f32 = time_ms(lambda: F.conv2d(xg, wg, None, *geo),
                             iters=QUANT_TIMED)[0]
            xb, wb = xg.to(torch.bfloat16), wg.to(torch.bfloat16)
            ms_bf16 = time_ms(lambda: F.conv2d(xb, wb, None, *geo),
                              iters=QUANT_TIMED)[0]
            flops = 2 * acc.numel() * (C // g) * k * k
            log(f"[quant conv {name} {qd}] {tuple(x.shape)} -> "
                f"{tuple(acc.shape)} k{k} s{s} p{p} d{d} g{g}: "
                f"accumulators of {S} samples vs the CPU's F.conv2d "
                f"{err:.3g} of max (bound "
                f"{0 if qd == 'int8' else FP8_RTOL[qd]:g}); products a call "
                f"{moved}; {ms:.4f} ms ({clock}; bound "
                f"{flops / lp_peak(qd) * 1e3:.4f}; cuDNN f32 {ms_f32:.4f}, "
                f"bf16 {ms_bf16:.4f})")
            want = {"int8": "int_mm", "e4m3": "scaled_mm"}[qd]
            if not ok or moved != {want: g}:
                raise RuntimeError(f"[quant conv {name} {qd}] error {err}, "
                                   f"launches {moved}")
            rows[(name, qd)] = dict(err=err, ms=ms, cudnn_f32=ms_f32,
                                    cudnn_bf16=ms_bf16)
    return rows


def lm_int8(torch):
    """(3) bench_lm_int8: bench.py's AMP row (phase 5c's program) run with
    FLAGS_quantize_dtype int8 and without it, in one process: one step of
    each from the same state (the losses within LM_INT8_LOSS_RTOL), the
    kernel launches of this repo per run on both (equal: no int8 product
    inside any kernel) and the int8 products (one a mul: the FFN's two a
    layer), the host syncs of one warm run of each (equal), peak memory,
    and time_run_steps in turns (AMP, int8, int8, AMP) with tokens/s."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr
    tag = "[lm int8]"
    cfg = tr.TransformerConfig(**FLAGSHIP)
    with amp_bf16():
        main, startup, avg_cost, _ = build_train(cfg, amp=True, T=TRAIN_T)
        muls = sum(op.type in ("mul", "matmul", "bmm")
                   for op in main.global_block().ops)
        exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        exe.run(startup)
        batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
                 tr.make_fake_lm_batch(cfg, TRAIN_BATCH, TRAIN_T,
                                       seed=SEED).items()}
        names = [v.name for v in main.list_vars() if v.persistable
                 and exe.scope.find_var(v.name) is not None]
        state0 = snapshot(exe.scope, names)
        first = {}
        for qd in ("", "int8"):      # one step of each from the same state
            for n, t in state0.items():
                exe.scope.set_var(n, t.clone())
            with quantize_flag(qd):
                first[qd] = float(exe.run(main, feed=batch,
                                          fetch_list=[avg_cost])[0][0])
        del state0
        counters = launch_counters()
        rows = {}
        for qd in ("", "int8"):
            with quantize_flag(qd):
                exe.run(main, feed=batch, fetch_list=[avg_cost])
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                zero_counters(counters)
                before = lp_launches()
                losses = [float(exe.run(main, feed=batch,
                                        fetch_list=[avg_cost])[0][0])
                          for _ in range(LM_INT8_RUNS)]
                rows[qd] = dict(counts=read_counters(counters),
                                lp=lp_moved(before), losses=losses,
                                peak=torch.cuda.max_memory_allocated() - held,
                                ms=[])
        for qd in ("", "int8"):      # both rows warm: no first-use syncs
            with quantize_flag(qd):
                rows[qd]["syncs"] = sync_sites(torch, lambda: exe.run(
                    main, feed=batch, fetch_list=[avg_cost],
                    return_numpy=False))[1]
        for qd in ("", "int8", "int8", ""):
            with quantize_flag(qd):
                rows[qd]["ms"].append(time_run_steps(
                    torch, exe, main, batch, avg_cost,
                    steps=LM_INT8_TIMED_STEPS, calls=LM_INT8_TIMED_CALLS))
    amp_row, row = rows[""], rows["int8"]
    n_tok = TRAIN_BATCH * TRAIN_T
    ms, ams = min(row["ms"]), min(amp_row["ms"])
    log(f"{tag} bench_lm_int8 (batch {TRAIN_BATCH} x {TRAIN_T}, AMP, "
        f"Adam({TRAIN_LR:g}), {muls} mul/matmul/bmm ops): run_steps "
        f"{[round(m, 2) for m in row['ms']]} ms a step against the AMP "
        f"row's {[round(m, 2) for m in amp_row['ms']]} in turns "
        f"(AMP, int8, int8, AMP): {n_tok / ms * 1e3:.0f} against "
        f"{n_tok / ams * 1e3:.0f} tokens/s ({ms / ams:.3f}x); peak device "
        f"memory of a run above what was held {row['peak'] / 2**20:.1f} "
        f"MiB against {amp_row['peak'] / 2**20:.1f}; first step's loss "
        f"from one state "
        f"{first['int8']:.6f} against {first['']:.6f} (bound "
        f"{LM_INT8_LOSS_RTOL:g}); host syncs a run {len(row['syncs'])} "
        f"against {len(amp_row['syncs'])}; int8 products over "
        f"{LM_INT8_RUNS} runs "
        f"{row['lp']} (AMP row {amp_row['lp']}); {nvidia_smi_line()}")
    kernels = {k: v for k, v in row["counts"].items() if v}
    log(f"{tag} this repo's kernels over {LM_INT8_RUNS} runs, by counter: "
        f"{kernels}")
    if row["counts"] != amp_row["counts"]:
        raise RuntimeError(f"{tag} kernel launches {row['counts']} against "
                           f"the AMP row's {amp_row['counts']}")
    if row["lp"] != {"int_mm": muls * LM_INT8_RUNS} or amp_row["lp"]:
        raise RuntimeError(f"{tag} int8 products {row['lp']}, AMP row "
                           f"{amp_row['lp']}: expected {muls} a run")
    for qd, r in (("int8", row), ("AMP", amp_row)):
        for site in r["syncs"]:
            log(f"{tag} {qd} row host sync at {site}")
    if len(row["syncs"]) > len(amp_row["syncs"]):
        raise RuntimeError(f"{tag} the int8 row adds host syncs: "
                           f"{row['syncs']} against {amp_row['syncs']}")
    if not all(math.isfinite(x) for x in row["losses"]) or abs(
            first["int8"] - first[""]) > LM_INT8_LOSS_RTOL * abs(first[""]):
        raise RuntimeError(f"{tag} losses {first}, {row['losses']}")
    counts = {n: v for (n, attr), v in row["counts"].items()
              if attr == "launches"}
    return counts, dict(exe=exe, main=main, feed=batch, loss=avg_cost,
                        ms=ms, amp_ms=ams)


def lm_int8_card_vs_cpu(torch):
    """(3) One f32 step of the flagship at L LM_INT8_CHECK_LAYERS, batch
    LM_INT8_CHECK_BATCH, under FLAGS_quantize_dtype int8, from the same
    weights on the card and on the CPU: the loss, the codes that differ
    (quantization flips) and the relu flips; then the CPU step again
    taking the card's codes and relu branches, held as phase 5's match."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as tr
    tag = "[lm int8 check]"
    cfg = tr.TransformerConfig(**dict(FLAGSHIP,
                                      n_layer=LM_INT8_CHECK_LAYERS))
    main, startup, avg_cost, pg = build_train(cfg, T=TRAIN_T)
    init = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    init.run(startup)
    state = {v.name: init.scope.find_var(v.name).numpy()
             for v in main.list_vars() if v.persistable}
    relus = [op.inputs["X"][0] for op in main.global_block().ops
             if op.type == "relu"]
    batch = tr.make_fake_lm_batch(cfg, LM_INT8_CHECK_BATCH, TRAIN_T,
                                  seed=SEED + 41)
    fetch = [avg_cost] + [gv for _, gv in pg] + relus
    n_g = len(pg)

    def step(place):
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, place)
        out = ptt.Executor(place, scope=scope).run(main, feed=batch,
                                                   fetch_list=fetch)
        return out[0][0], out[1:1 + n_g], out[1 + n_g:]

    with quantize_flag("int8"):
        card_codes, cpu_codes = [], []
        with quant_codes(record=card_codes):
            loss, grads, pres = step(ptt.CUDAPlace(0))
        with quant_codes(record=cpu_codes):
            cpu_loss, cpu_grads, cpu_pres = step(ptt.CPUPlace())
        flips, n = code_flips(card_codes, cpu_codes)
        relu_flips = sum(int(((a > 0) != (c > 0)).sum())
                         for a, c in zip(pres, cpu_pres))
        worst = max(float(np.abs(a - c).max()) / max(float(np.abs(c).max()),
                                                     1e-30)
                    for a, c in zip(grads, cpu_grads))
        le = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        log(f"{tag} L{cfg.n_layer} batch {LM_INT8_CHECK_BATCH} x {TRAIN_T} "
            f"f32 int8 step, card vs CPU: loss {loss:.6f} vs "
            f"{cpu_loss:.6f} (rel err {le:.3g}); {flips} of {n} int8 codes "
            f"differ over {len(card_codes)} quantize calls, {relu_flips} "
            f"relu pre-activations on the other branch; worst @GRAD max "
            f"|card - CPU| {worst:.3g} of max |CPU|")
        masks = [torch.from_numpy((a > 0).astype(np.float32)) for a in pres]
        with replayed_relu_masks(masks) as left_relu, \
                quant_codes(replay=card_codes) as left_codes:
            r_loss, r_grads, _ = step(ptt.CPUPlace())
    if left_relu or left_codes:
        raise RuntimeError(f"{tag} {len(left_relu)} relu masks and "
                           f"{len(left_codes)} codes not replayed")
    check_replayed(tag + " (the card's codes too)", pg, loss, grads, r_loss,
                   r_grads)
    return dict(flips=flips, codes=n, relu_flips=relu_flips, loss=le,
                grad=worst)


def resnet_cpu_scope(scope, names):
    """A CPU scope holding copies of the named scope tensors."""
    import paddle_tpu_torch as ptt
    out = ptt.Scope()
    for n in names:
        out.set_var(n, scope.find_var(n).detach().cpu())
    return out


def model_card_vs_cpu(torch, tag, prog, scope, feed, fetch, rtol):
    """A frozen program's `fetch` (its logits) on QUANT_CHECK_SAMPLES
    samples, card vs CPU: the codes that differ (a flip in an early layer
    moves every later layer's activations, so flips cascade), the error;
    then the CPU run again taking the card's codes, held at rtol of max
    |CPU|."""
    import numpy as np
    import paddle_tpu_torch as ptt
    names = [v.name for v in prog.list_vars() if v.persistable
             and scope.find_var(v.name) is not None]
    cpu_exe = ptt.Executor(ptt.CPUPlace(),
                           scope=resnet_cpu_scope(scope, names))
    card_exe = ptt.Executor(ptt.CUDAPlace(0), scope=scope)
    small = {"img": feed["img"][:QUANT_CHECK_SAMPLES].cpu().numpy()}
    card_codes, cpu_codes = [], []
    with quant_codes(record=card_codes):
        got, = card_exe.run(prog, feed=small, fetch_list=[fetch])
    with quant_codes(record=cpu_codes):
        want, = cpu_exe.run(prog, feed=small, fetch_list=[fetch])
    flips, n = code_flips(card_codes, cpu_codes)
    with quant_codes(replay=card_codes) as left:
        replayed, = cpu_exe.run(prog, feed=small, fetch_list=[fetch])
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    r_err = float(np.abs(got - replayed).max()) / scale
    log(f"{tag} {QUANT_CHECK_SAMPLES} samples, card vs CPU: {flips} of {n} "
        f"codes differ over {len(card_codes)} quantize calls; outputs "
        f"{err:.3g} of max, {r_err:.3g} with the card's codes (bound "
        f"{rtol:g}); max |logit| {scale:.4g}")
    if left or not r_err <= rtol or not np.isfinite(got).all():
        raise RuntimeError(f"{tag} card vs CPU {r_err} ({len(left)} codes "
                           f"left)")
    return dict(flips=flips, codes=n, err=err, replayed=r_err)


def frozen_serve(torch, tag, prog, exe, feed, fetch, per_run):
    """A frozen program on the executor path at batch RESNET_SERVE_BATCH:
    p50 of RESNET_SERVE_TIMED synchronized runs (the output read back) and
    bench.py's number (the best of 3 windows of RESNET_SERVE_TIMED
    unsynchronized runs, each window synchronized at its end), the
    library products a run and no kernel of this repo."""
    import numpy as np
    exe.run(prog, feed=feed, fetch_list=[fetch])
    counters = launch_counters()
    zero_counters(counters)
    before = lp_launches()
    ms = []
    for _ in range(RESNET_SERVE_TIMED):
        t0 = time.perf_counter()
        out, = exe.run(prog, feed=feed, fetch_list=[fetch])
        ms.append((time.perf_counter() - t0) * 1e3)
    moved = lp_moved(before)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_SERVE_TIMED):
            exe.run(prog, feed=feed, fetch_list=[fetch], return_numpy=False)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3
                   / RESNET_SERVE_TIMED)
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    p50 = float(np.median(ms))
    log(f"{tag} batch {RESNET_SERVE_BATCH} on the executor path: p50 "
        f"{p50:.3f} ms a batch (synchronized, output read back), "
        f"{RESNET_SERVE_BATCH / p50 * 1e3:.1f} img/s; bench.py's window "
        f"{best:.3f} ms, {RESNET_SERVE_BATCH / best * 1e3:.1f} img/s; "
        f"products over {RESNET_SERVE_TIMED} runs {moved}; "
        f"{nvidia_smi_line()}")
    want = {k: v * RESNET_SERVE_TIMED for k, v in per_run.items()}
    if moved != want or any(counts.values()):
        raise RuntimeError(f"{tag} products {moved} (expected {want}), "
                           f"this repo's kernels {counts}")
    if out.shape != (RESNET_SERVE_BATCH, RESNET_CLASSES) or not (
            np.isfinite(out).all() and abs(out.sum(1) - 1).max() < 1e-2):
        raise RuntimeError(f"{tag} output {out.shape}")
    return counts, dict(p50=p50, window=best, out=out)


def logits_of(prog):
    """The input of the program's last softmax: the logits (the
    probabilities of a random-weight ResNet-50 saturate to 0 and 1, which
    would hide any difference)."""
    return [op for op in prog.global_block().ops
            if op.type == "softmax"][-1].inputs["X"][0]


def frozen_kinds(prog):
    ops = [op.type for op in prog.global_block().ops]
    return {t: ops.count(t) for t in ("quantized_conv2d", "quantized_matmul",
                                      "conv2d", "mul") if ops.count(t)}


def resnet_int8_serve(torch):
    """(4) bench_resnet50_infer_int8: the is_test ResNet-50 pruned to its
    prediction, training_transpile (abs_max activations, channel-wise
    weights), freeze_program to int8, on the executor path at batch
    RESNET_SERVE_BATCH; card vs CPU on QUANT_CHECK_SAMPLES samples; the
    frozen model saved and served by the Predictor, equal to the
    executor's output bit for bit."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    tag = "[resnet int8 serve]"
    main, startup, _, _, pred = build_resnet(is_test=True)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    prog = main.prune(["img"], [pred.name])
    qt = ptt.transpiler.QuantizeTranspiler()
    qt.training_transpile(prog, startup)
    t0 = time.perf_counter()
    qt.freeze_program(prog, scope=exe.scope, quantize_dtype="int8")
    freeze_s = time.perf_counter() - t0
    kinds = frozen_kinds(prog)
    log(f"{tag} frozen in {freeze_s:.2f} s: {kinds}")
    if kinds != {"quantized_conv2d": 53, "quantized_matmul": 1}:
        raise RuntimeError(f"{tag} frozen ops {kinds}")
    feed = {"img": resnet_feed(RESNET_SERVE_BATCH, SEED + 3,
                               device=DEVICE)["img"]}
    counts, row = frozen_serve(torch, tag, prog, exe, feed, pred.name,
                               {"int_mm": 54})
    logits = logits_of(prog)
    row["check"] = model_card_vs_cpu(torch, tag, prog, exe.scope, feed,
                                     logits, QUANT_PRED_RTOL)
    with tempfile.TemporaryDirectory() as td:
        ptt.io.save_inference_model(td, ["img"], [pred, logits], exe,
                                    main_program=prog)
        p = create_predictor(AnalysisConfig(td))
    served = p.run(feed)
    direct = exe.run(prog, feed=feed, fetch_list=[pred.name, logits])
    differ = [int((a != b).sum()) for a, b in zip(served, direct)]
    log(f"{tag} the saved model through the Predictor against the "
        f"executor: {differ} of {served[0].size} probabilities and logits "
        f"differ")
    if any(differ):
        raise RuntimeError(f"{tag} the Predictor's outputs differ")
    row.update(exe=exe, prog=prog, feed=feed, fetch=pred.name)
    return counts, row


def build_resnet_qat():
    """bench_resnet50's program with training_transpile
    (moving_average_abs_max activations) before Momentum's minimize, and
    its for_test clone taken between the two: (main, startup, loss, pred,
    infer, transpiler)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    qt = ptt.transpiler.QuantizeTranspiler(
        activation_quantize_type="moving_average_abs_max")
    with ptt.program_guard(main, startup):
        _, loss, _, pred = resnet.build_train_net(
            class_dim=RESNET_CLASSES, img_shape=RESNET_IMG,
            depth=RESNET_DEPTH)
        qt.training_transpile(main, startup)
        infer = main.clone(for_test=True)
        ptt.optimizer.Momentum(learning_rate=RESNET_LR,
                               momentum=RESNET_MU).minimize(loss)
    return main, startup, loss, pred, infer, qt


def resnet_qat(torch):
    """(5) QAT on bench_resnet50 (batch RESNET_BATCH, Momentum(0.1, 0.9)):
    QAT_STEPS steps on one batch, every moving-average scale advancing
    each step, the step p50 beside phase 5g's f32 row; then the for_test
    clone pruned and frozen to e4m3, served at batch RESNET_SERVE_BATCH
    and held to the CPU on QUANT_CHECK_SAMPLES samples."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = "[resnet qat]"
    main, startup, loss, pred, infer, qt = build_resnet_qat()
    fakes = sum(op.type.startswith("fake_") for op in main.global_block().ops)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    feed = resnet_feed(RESNET_BATCH, SEED + 1, device=DEVICE)
    scales = sorted(v.name for v in main.list_vars()
                    if v.persistable and v.name.endswith(".quant_in_scale"))
    counters = launch_counters()
    zero_counters(counters)
    prev = {n: float(exe.scope.find_var(n)) for n in scales}
    losses, step_ms, still = [], [], []
    for step in range(1, QAT_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.reshape(())))
        now = {n: float(exe.scope.find_var(n)) for n in scales}
        still.append(sum(now[n] == prev[n] for n in scales))
        prev = now
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    p50 = float(np.median(step_ms[1:]))
    f32 = QUANT_ROWS.get("resnet_train")
    log(f"{tag} {fakes} fake-quantize ops, {len(scales)} moving-average "
        f"scales; batch {RESNET_BATCH}: losses "
        f"{[round(x, 4) for x in losses]}; scales unmoved a step {still}; "
        f"step p50 {p50:.2f} ms ({RESNET_BATCH / p50 * 1e3:.1f} img/s; "
        f"phase 5g's f32 row {f32 and round(f32, 2)} ms); first step "
        f"{step_ms[0]:.2f} ms; {nvidia_smi_line()}")
    if any(still) or not all(math.isfinite(x) for x in losses) \
            or any(counts.values()):
        raise RuntimeError(f"{tag} scales unmoved {still}, losses {losses}, "
                           f"this repo's kernels {counts}")
    prog = infer.prune(["img"], [pred.name])
    qt.freeze_program(prog, scope=exe.scope, quantize_dtype="e4m3")
    kinds = frozen_kinds(prog)
    if kinds != {"quantized_conv2d": 53, "quantized_matmul": 1}:
        raise RuntimeError(f"{tag} frozen ops {kinds}")
    sfeed = {"img": feed["img"][:RESNET_SERVE_BATCH]}
    _, row = frozen_serve(torch, "[resnet qat e4m3 serve]", prog, exe,
                          sfeed, pred.name, {"scaled_mm": 54})
    row["check"] = model_card_vs_cpu(torch, "[resnet qat e4m3 serve]", prog,
                                     exe.scope, sfeed, logits_of(prog),
                                     QAT_FP8_PRED_RTOL)
    row.update(p50_train=p50, losses=losses)
    return counts, row


def fmha_program(amp):
    """q, k, v [B, T, D] -> fused_multihead_attention (causal) -> mean of
    its square, with SGD(0) for the @GRADs: (main, startup, loss, out,
    param grads)."""
    import paddle_tpu_torch as ptt
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with amp_bf16(amp), ptt.program_guard(main, startup):
        q, k, v = (ptt.layers.data(n, [FMHA["T"], FMHA["D"]],
                                   dtype="float32") for n in "qkv")
        out = ptt.layers.fused_multihead_attention(q, k, v, FMHA["H"],
                                                   causal=True)
        loss = ptt.layers.mean(ptt.layers.square(out))
        _, pg = ptt.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return main, startup, loss, out, pg


def fmha_check(torch):
    """(6) fused_multihead_attention at d FMHA["D"], H FMHA["H"], T
    FMHA["T"], batch FMHA["B"]: forward and backward, f32 and under AMP,
    card vs CPU from the same weights (the output and every @GRAD within
    FMHA_RTOL of its max), the flash launches a run, and the run's ms."""
    import numpy as np
    import paddle_tpu_torch as ptt
    rng = np.random.RandomState(SEED + 43)
    feed = {n: rng.randn(FMHA["B"], FMHA["T"], FMHA["D"]).astype(np.float32)
            for n in "qkv"}
    by_path = {}
    for amp in (False, True):
        tag = f"[fmha{' amp' if amp else ''}]"
        main, startup, loss, out, pg = fmha_program(amp)
        init = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
        init.run(startup)
        state = {v.name: init.scope.find_var(v.name).numpy()
                 for v in main.list_vars() if v.persistable}
        fetch = [out] + [g for _, g in pg]
        res = {}
        with amp_bf16(amp):
            for place in (ptt.CPUPlace(), ptt.CUDAPlace(0)):
                scope = ptt.Scope()
                ptt.io.params_from_numpy(scope, state, place)
                exe = ptt.Executor(place, scope=scope)
                if isinstance(place, ptt.CUDAPlace):
                    exe.run(main, feed=feed, fetch_list=fetch)
                    counters = launch_counters()
                    zero_counters(counters)
                res[type(place).__name__] = exe.run(main, feed=feed,
                                                    fetch_list=fetch)
            counts = {n: v for (n, attr), v in
                      read_counters(counters).items() if attr == "launches"}
            ms = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss],
                        return_numpy=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        errs = [float(np.abs(a - c).max()) / max(float(np.abs(c).max()),
                                                 1e-30)
                for a, c in zip(res["CUDAPlace"], res["CPUPlace"])]
        want = ({"flash_attention_bf16": 1, "flash_attention_bwd_bf16": 1}
                if amp else {"flash_attention": 1, "flash_attention_bwd": 1})
        moved = {n: c for n, c in counts.items() if c}
        log(f"{tag} B{FMHA['B']} T{FMHA['T']} D{FMHA['D']} H{FMHA['H']} "
            f"causal, forward and backward: card vs CPU output "
            f"{errs[0]:.3g}, worst of {len(pg)} @GRADs {max(errs[1:]):.3g} "
            f"of max (bound {FMHA_RTOL[amp]:g}); this repo's kernels a run "
            f"{moved}; run p50 {float(np.median(ms)):.3f} ms")
        if max(errs) > FMHA_RTOL[amp] or moved != want:
            raise RuntimeError(f"{tag} errors {errs}, launches {moved}")
        by_path[f"fused_multihead_attention{'_amp' if amp else ''}"] = counts
    return by_path


def phase_quant(torch):
    """Phase 5m: int8 and fp8 on the card.  Returns the launch
    counts of this repo's kernels by path and what the traces at the end
    of the smoke run."""
    t0 = time.perf_counter()
    products = quant_products(torch)
    convs = quant_convs(torch)
    by_path, keep = {}, {}
    by_path["lm_int8_train"], keep["lm"] = lm_int8(torch)
    check = lm_int8_card_vs_cpu(torch)
    by_path["resnet_int8_serve"], keep["resnet"] = resnet_int8_serve(torch)
    by_path["resnet_qat_train"], qat = resnet_qat(torch)
    by_path.update(fmha_check(torch))
    recs = [r for r in VERIFY_LOG if r["phase"] == "quant"]
    serve = keep["resnet"]
    log(f"[quant] products: worst int8 error {max(r['plain'] for (q, _), r in products.items() if q == 'int8'):.3g}, "
        f"e4m3 {max(r['plain'] for (q, _), r in products.items() if q == 'e4m3'):.3g}; "
        f"convolutions (ms int8, e4m3) "
        f"{ {n: (round(convs[(n, 'int8')]['ms'], 4), round(convs[(n, 'e4m3')]['ms'], 4)) for n in QUANT_CONVS} }; "
        f"bench_lm_int8 {keep['lm']['ms']:.2f} ms a step against AMP "
        f"{keep['lm']['amp_ms']:.2f}; int8 step check: {check}; ResNet-50 "
        f"int8 serve p50 {serve['p50']:.3f} ms (f32 "
        f"{QUANT_ROWS.get('resnet_serve') and round(QUANT_ROWS['resnet_serve'], 3)}, "
        f"AMP {QUANT_ROWS.get('resnet_serve_amp') and round(QUANT_ROWS['resnet_serve_amp'], 3)}); "
        f"QAT step p50 {qat['p50_train']:.2f} ms, e4m3 serve "
        f"{qat['p50']:.3f} ms; the gate verified {len(recs)} programs in "
        f"error mode, {sum(r['errors'] for r in recs)} with an error; phase "
        f"{time.perf_counter() - t0:.1f} s; {nvidia_smi_line()}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"quant verifications {recs}")
    return by_path, keep


@contextlib.contextmanager
def quant_ranges(torch):
    """quantize_array and low_precision_matmul's forward inside
    record_function ranges, for attributed_ms."""
    from paddle_tpu_torch.ops import quantize_ops as qo
    old = {n: getattr(qo, n) for n in ("quantize_array", "_lp_forward")}

    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(RANGE_PREFIX + name):
                return fn(*a, **kw)
        return call

    for n, fn in old.items():
        setattr(qo, n, ranged(n, fn))
    try:
        yield
    finally:
        for n, fn in old.items():
            setattr(qo, n, fn)


def _quant_kernel_class(name):
    """Kernel classes of the quantize plane's traces."""
    c = _kernel_class(name)
    if "(this repo)" in c:
        return c
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "imma")):
        if any(k in low for k in ("s8", "i8", "imma", "int8")):
            return "int8 GEMMs"
        if any(k in low for k in ("e4m3", "fp8", "f8")):
            return "fp8 GEMMs"
        return "bf16 / f32 GEMMs"
    if "copy" in low or "memset" in low or "pad" in low:
        return "copies and casts (im2col, operand padding, dtype casts)"
    if "reduce" in low:
        return "reductions (abs-max scales, batch norm)"
    return "elementwise and other (quantize, dequantize, casts)"


def trace_quant(torch, keep):
    """One bench_lm_int8 step and one int8 ResNet-50 batch traced by
    kernel class with the device's idle share; the quantize passes' and
    the low-precision forwards' device ms by their ranges.  The int8 step
    launches the bf16 kernels of the AMP row and no f32 flash or LM head."""
    lm = keep["lm"]
    n_head_bwd = -(-TRAIN_BATCH * TRAIN_T // HEAD_CHUNK) * head_bwd_kernels()
    raw = []
    with amp_bf16(), quantize_flag("int8"), quant_ranges(torch):
        trace_run(torch, f"bench_lm_int8 step at batch {TRAIN_BATCH}",
                  lambda: lm["exe"].run(lm["main"], feed=lm["feed"],
                                        fetch_list=[lm["loss"]],
                                        return_numpy=False),
                  expect={"flash forward bf16 (this repo)": FLAGSHIP["n_layer"],
                          "flash backward bf16 (this repo)":
                              2 * FLAGSHIP["n_layer"],
                          "lm_head_fwd bf16 (this repo)": 2,
                          "lm_head_bwd bf16 (this repo)": n_head_bwd,
                          "lm_head_fwd (this repo)": 0,
                          "lm_head_bwd (this repo)": 0},
                  classify=_quant_kernel_class, raw=raw)
    for n in ("_lp_forward", "quantize_array"):
        log(f"[trace]   kernels launched inside {n}: "
            f"{attributed_ms(raw, RANGE_PREFIX + n):.3f} ms")
    rs = keep["resnet"]
    raw = []
    with quant_ranges(torch):
        trace_run(torch, f"int8 ResNet-{RESNET_DEPTH} batch "
                         f"{RESNET_SERVE_BATCH}",
                  lambda: rs["exe"].run(rs["prog"], feed=rs["feed"],
                                        fetch_list=[rs["fetch"]],
                                        return_numpy=False),
                  classify=_quant_kernel_class, raw=raw)
    log(f"[trace]   kernels launched inside quantize_array: "
        f"{attributed_ms(raw, RANGE_PREFIX + 'quantize_array'):.3f} ms")


# phase 5n: the dense op plane.  (a) DeepFM as bench_deepfm trains it
# (phase 5i's DEEPFM_CFG, batch and Adagrad) with layers.auc appended;
# (b) every op the plane added, through the Executor on the card and on
# the CPU, forward and (where it is differentiable) backward through
# append_backward, at DENSE_N x DENSE_D f32 operands (2 MiB) or the
# like
DENSE_AUC_STEPS = 5
DENSE_AUC_ATOL = 1e-6       # the in-graph AUC against the host Auc's
DENSE_N, DENSE_D = 512, 1024
DENSE_RTOL = 1e-5           # max |card - CPU| / max |CPU| where it computes
DENSE_DRAWS = 1 << 20       # entries of each random op's draw


def _dense_f(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype("float32")


def _dense_kinks(r, points, *shape, scale=1.0):
    """Seeded normals with each of `points` planted in 1/8 of the entries
    (the kinks and bounds of the op)."""
    x = _dense_f(r, *shape, scale=scale)
    flat = x.reshape(-1)
    for i, p in enumerate(points):
        flat[i::8 * len(points)] = p
    return x


def _dense_ties(r, *shape):
    return r.randint(0, 4, shape).astype("float32")


def _dense_unary(op, points=(0.0,), attrs=None, positive=False, scale=1.0):
    import numpy as np

    def build(r):
        x = _dense_kinks(r, points, DENSE_N, DENSE_D, scale=scale)
        return {"X": [np.abs(x) + 0.5 if positive else x]}
    return (op, build, attrs or {}, {"Out": 1}, ("X",), "rel")


def _dense_sweep_cases():
    """name -> (op, inputs(rng), attrs, {out slot: count}, differentiated
    slots, kind): "bits" holds outputs and gradients bit for bit, "fwd"
    the outputs bit for bit and the gradients (sums) at DENSE_RTOL, "rel"
    both at DENSE_RTOL."""
    import numpy as np
    N, D = DENSE_N, DENSE_D
    f, kinks, ties = _dense_f, _dense_kinks, _dense_ties
    img = (16, 8, 64, 64)
    c = {
        "abs": _dense_unary("abs"), "ceil": _dense_unary("ceil", (0.5,)),
        "floor": _dense_unary("floor", (0.5,)),
        "round": _dense_unary("round", (0.5, 1.5, 2.5), scale=3.0),
        "cos": _dense_unary("cos"), "sin": _dense_unary("sin"),
        "exp": _dense_unary("exp"), "erf": _dense_unary("erf"),
        "log": _dense_unary("log", (), positive=True),
        "rsqrt": _dense_unary("rsqrt", (), positive=True),
        "reciprocal": _dense_unary("reciprocal", (), positive=True),
        "logsigmoid": _dense_unary("logsigmoid"),
        "tanh_shrink": _dense_unary("tanh_shrink"),
        "softplus": _dense_unary("softplus"),
        "softsign": _dense_unary("softsign"),
        "brelu": _dense_unary("brelu", (-1.0, 1.0),
                              {"t_min": -1.0, "t_max": 1.0}),
        "leaky_relu": _dense_unary("leaky_relu", (0.0,), {"alpha": 0.1}),
        "soft_relu": _dense_unary("soft_relu", (-1.0, 1.0),
                                  {"threshold": 1.0}),
        "elu": _dense_unary("elu"),
        "relu6": _dense_unary("relu6", (0.0, 6.0), scale=4.0),
        "pow": _dense_unary("pow", (0.0,), {"factor": 3.0}),
        "stanh": _dense_unary("stanh"),
        "hard_shrink": _dense_unary("hard_shrink", (0.5, -0.5)),
        "softshrink": _dense_unary("softshrink", (0.5, -0.5)),
        "hard_sigmoid": _dense_unary("hard_sigmoid", (-2.5, 2.5),
                                     scale=3.0),
        "swish": _dense_unary("swish"),
        "hard_swish": _dense_unary("hard_swish", (-3.0, 3.0), scale=4.0),
        "mish": _dense_unary("mish"),
        "thresholded_relu": _dense_unary("thresholded_relu", (1.0,)),
        "selu": _dense_unary("selu"),
        "prelu": ("prelu", lambda r: {"X": [kinks(r, (0.0,), *img)],
                                      "Alpha": [f(r, 8, scale=0.2)]},
                  {"mode": "channel"}, {"Out": 1}, ("X", "Alpha"), "rel"),
        "maxout": ("maxout", lambda r: {"X": [ties(r, *img)]},
                   {"groups": 2}, {"Out": 1}, ("X",), "fwd"),
        "reshape2": ("reshape2", lambda r: {"X": [f(r, N, D)]},
                     {"shape": [0, 32, -1]}, {"Out": 1, "XShape": 1},
                     ("X",), "bits"),
        "transpose2": ("transpose2", lambda r: {"X": [f(r, 32, N, 32)]},
                       {"axis": [2, 0, 1]}, {"Out": 1, "XShape": 1},
                       ("X",), "bits"),
        "squeeze2": ("squeeze2", lambda r: {"X": [f(r, N, 1, D)]},
                     {"axes": [1]}, {"Out": 1, "XShape": 1}, ("X",),
                     "bits"),
        "unsqueeze2": ("unsqueeze2", lambda r: {"X": [f(r, N, D)]},
                       {"axes": [0, 2]}, {"Out": 1, "XShape": 1}, ("X",),
                       "bits"),
        "stack": ("stack", lambda r: {"X": [f(r, N, D // 2),
                                            f(r, N, D // 2)]},
                  {"axis": 1}, {"Y": 1}, ("X",), "bits"),
        "unstack": ("unstack", lambda r: {"X": [f(r, N, 4, D // 4)]},
                    {"axis": 1}, {"Y": 4}, ("X",), "bits"),
        "unbind": ("unbind", lambda r: {"X": [f(r, 2, N, D // 2)]},
                   {"axis": 0}, {"Y": 2}, ("X",), "bits"),
        "flatten": ("flatten", lambda r: {"X": [f(r, *img)]}, {"axis": 2},
                    {"Out": 1}, ("X",), "bits"),
        "flatten2": ("flatten2", lambda r: {"X": [f(r, *img)]}, {"axis": 1},
                     {"Out": 1, "XShape": 1}, ("X",), "bits"),
        "flatten_contiguous_range": ("flatten_contiguous_range", lambda r: {
            "X": [f(r, *img)]}, {"start_axis": 1, "stop_axis": 2},
            {"Out": 1}, ("X",), "bits"),
        "expand_as": ("expand_as", lambda r: {"X": [f(r, 1, D)],
                                              "Y": [f(r, N, D)]}, {},
                      {"Out": 1}, ("X",), "fwd"),
        "tile": ("tile", lambda r: {"X": [f(r, N // 4, D // 2)]},
                 {"repeat_times": [4, 2]}, {"Out": 1}, ("X",), "fwd"),
        "strided_slice": ("strided_slice", lambda r: {"Input": [f(r, N, D)]},
                          {"axes": [0, 1], "starts": [N - 1, 3],
                           "ends": [0, D], "strides": [-3, 2]}, {"Out": 1},
                          ("Input",), "bits"),
        "gather_nd": ("gather_nd", lambda r: {
            "X": [f(r, N, D)], "Index": [r.randint(0, N, (N, 1))]}, {},
            {"Out": 1}, ("X",), "fwd"),
        # a repeated id keeps its last update, and only it gets a gradient
        "scatter": ("scatter", lambda r: {
            "X": [f(r, 4 * N, 256)], "Ids": [r.randint(0, N, (2 * N,))],
            "Updates": [f(r, 2 * N, 256)]}, {"overwrite": True}, {"Out": 1},
            ("X", "Updates"), "bits"),
        "scatter_add": ("scatter", lambda r: {
            "X": [f(r, 4 * N, 256)], "Ids": [r.randint(0, N, (2 * N,))],
            "Updates": [f(r, 2 * N, 256)]}, {"overwrite": False},
            {"Out": 1}, ("X", "Updates"), "rel"),
        "scatter_nd_add": ("scatter_nd_add", lambda r: {
            "X": [f(r, 4 * N, 256)], "Index": [r.randint(0, N, (2 * N, 1))],
            "Updates": [f(r, 2 * N, 256)]}, {}, {"Out": 1},
            ("X", "Updates"), "rel"),
        "pad": ("pad", lambda r: {"X": [f(r, N, D)]},
                {"paddings": [1, 2, 3, 0], "pad_value": 0.5}, {"Out": 1},
                ("X",), "bits"),
        "pad2d_reflect": ("pad2d", lambda r: {"X": [f(r, *img)]},
                          {"paddings": [2, 1, 1, 3], "mode": "reflect"},
                          {"Out": 1}, ("X",), "fwd"),
        "pad2d_edge": ("pad2d", lambda r: {"X": [f(r, *img)]},
                       {"paddings": [1, 2, 3, 0], "mode": "edge"},
                       {"Out": 1}, ("X",), "fwd"),
        "pad_constant_like": ("pad_constant_like", lambda r: {
            "X": [f(r, N, D)], "Y": [f(r, N - 7, D - 5)]},
            {"pad_value": 1.5}, {"Out": 1}, ("Y",), "bits"),
        "crop": ("crop", lambda r: {"X": [f(r, *img)]},
                 {"offsets": [0, 1, 3, 2], "shape": [-1, 6, 50, 60]},
                 {"Out": 1}, ("X",), "bits"),
        "reverse": ("reverse", lambda r: {"X": [f(r, N, D)]},
                    {"axis": [0, 1]}, {"Out": 1}, ("X",), "bits"),
        "flip": ("flip", lambda r: {"X": [f(r, *img)]}, {"axis": [2]},
                 {"Out": 1}, ("X",), "bits"),
        "roll": ("roll", lambda r: {"X": [f(r, N, D)]},
                 {"shifts": [-3, 100], "axis": [0, 1]}, {"Out": 1}, ("X",),
                 "bits"),
        "multiplex": ("multiplex", lambda r: {
            "Ids": [r.randint(0, 3, (N, 1))],
            "X": [f(r, N, D), f(r, N, D), f(r, N, D)]}, {}, {"Out": 1},
            ("X",), "bits"),
        "where": ("where", lambda r: {
            "Condition": [r.rand(N, D) < 0.5], "X": [f(r, N, D)],
            "Y": [f(r, N, D)]}, {}, {"Out": 1}, ("X", "Y"), "bits"),
        "where_index": ("where_index", lambda r: {
            "Condition": [r.rand(N, D) < 0.3]}, {}, {"Out": 1}, (), "bits"),
        "space_to_depth": ("space_to_depth", lambda r: {"X": [f(r, *img)]},
                           {"blocksize": 2}, {"Out": 1}, ("X",), "bits"),
        "pixel_shuffle": ("pixel_shuffle", lambda r: {"X": [f(r, *img)]},
                          {"upscale_factor": 2}, {"Out": 1}, ("X",),
                          "bits"),
        "is_empty": ("is_empty", lambda r: {"X": [f(r, N, D)]}, {},
                     {"Out": 1}, (), "bits"),
        "shard_index": ("shard_index", lambda r: {
            "X": [r.randint(0, 1 << 20, (N * D // 4, 1))]},
            {"index_num": 1 << 20, "nshards": 3, "shard_id": 1,
             "ignore_value": -1}, {"Out": 1}, (), "bits"),
        # ties in most rows: the first index, a stable order
        "arg_max": ("arg_max", lambda r: {"X": [ties(r, N, D)]},
                    {"axis": 1}, {"Out": 1}, (), "bits"),
        "arg_min": ("arg_min", lambda r: {"X": [ties(r, N, D)]},
                    {"axis": 0}, {"Out": 1}, (), "bits"),
        "argsort": ("argsort", lambda r: {"X": [ties(r, N, D)]},
                    {"axis": 1, "descending": True},
                    {"Out": 1, "Indices": 1}, ("X",), "bits"),
        "dot": ("dot", lambda r: {"X": [f(r, N, D)], "Y": [f(r, N, D)]},
                {}, {"Out": 1}, ("X", "Y"), "rel"),
        "minus": ("minus", lambda r: {"X": [f(r, N, D)], "Y": [f(r, N, D)]},
                  {}, {"Out": 1}, ("X", "Y"), "bits"),
        "clip": _dense_unary("clip", (-0.5, 0.5), {"min": -0.5,
                                                   "max": 0.5}),
        "cumsum": ("cumsum", lambda r: {"X": [f(r, N, D)]},
                   {"axis": 1, "exclusive": True, "reverse": True},
                   {"Out": 1}, ("X",), "rel"),
        "isfinite": ("isfinite", lambda r: {"X": [f(r, N, D)]}, {},
                     {"Out": 1}, (), "bits"),
        "squared_l2_distance": ("squared_l2_distance", lambda r: {
            "X": [f(r, N, D)], "Y": [f(r, N, D)]}, {},
            {"Out": 1, "sub_result": 1}, ("X", "Y"), "rel"),
        "l1_norm": ("l1_norm", lambda r: {"X": [kinks(r, (0.0,), N, D)]},
                    {}, {"Out": 1}, ("X",), "rel"),
        "norm": ("norm", lambda r: {"X": [f(r, N, D)]}, {"axis": 1},
                 {"Out": 1, "Norm": 1}, ("X",), "rel"),
        "bilinear_tensor_product": ("bilinear_tensor_product", lambda r: {
            "X": [f(r, N, 64)], "Y": [f(r, N, 64)],
            "Weight": [f(r, 32, 64, 64, scale=0.1)],
            "Bias": [f(r, 1, 32)]}, {}, {"Out": 1},
            ("X", "Y", "Weight", "Bias"), "rel"),
        "fill_zeros_like": ("fill_zeros_like", lambda r: {"X": [f(r, N, D)]},
                            {}, {"Out": 1}, (), "bits"),
        "fill_any_like": ("fill_any_like", lambda r: {"X": [f(r, N, D)]},
                          {"value": 2.5}, {"Out": 1}, (), "bits"),
        "shape": ("shape", lambda r: {"Input": [f(r, *img)]}, {},
                  {"Out": 1}, (), "bits"),
        "range": ("range", lambda r: {"Start": [np.full((1,), -1.5, "f4")],
                                      "End": [np.full((1,), 9.0, "f4")],
                                      "Step": [np.full((1,), 0.01, "f4")]},
                  {"len": 1000}, {"Out": 1}, ("Start", "Step"), "rel"),
        "eye": ("eye", lambda r: {}, {"num_rows": N, "num_columns": D},
                {"Out": 1}, (), "bits"),
        "linspace": ("linspace", lambda r: {}, {"start": 0.0, "stop": 511.0,
                                                "num": D}, {"Out": 1}, (),
                     "bits"),
        "mse_loss": ("mse_loss", lambda r: {"X": [f(r, N, D)],
                                            "Label": [f(r, N, D)]}, {},
                     {"Out": 1}, ("X",), "rel"),
        "smooth_l1_loss": ("smooth_l1_loss", lambda r: {
            "X": [f(r, N, D)], "Y": [f(r, N, D)],
            "InsideWeight": [np.abs(f(r, N, D))],
            "OutsideWeight": [np.abs(f(r, N, D))]}, {"sigma": 2.0},
            {"Out": 1, "Diff": 1}, ("X", "Y"), "rel"),
        "huber_loss": ("huber_loss", lambda r: {"X": [f(r, N, D)],
                                                "Y": [f(r, N, D)]},
                       {"delta": 0.7}, {"Out": 1, "Residual": 1},
                       ("X", "Y"), "rel"),
        "log_loss": ("log_loss", lambda r: {
            "Predicted": [r.rand(N * D, 1).astype("f4") * 0.8 + 0.1],
            "Labels": [r.randint(0, 2, (N * D, 1)).astype("f4")]}, {},
            {"Loss": 1}, ("Predicted",), "rel"),
        "hinge_loss": ("hinge_loss", lambda r: {
            "Logits": [kinks(r, (1.0, -1.0), N * D, 1)],
            "Labels": [r.randint(0, 2, (N * D, 1)).astype("f4")]}, {},
            {"Loss": 1}, ("Logits",), "rel"),
        "modified_huber_loss": ("modified_huber_loss", lambda r: {
            "X": [kinks(r, (-1.0, 1.0), N * D, 1, scale=2.0)],
            "Y": [r.randint(0, 2, (N * D, 1)).astype("f4")]}, {},
            {"Out": 1, "IntermediateVal": 1}, ("X",), "rel"),
        "bpr_loss": ("bpr_loss", lambda r: {
            "X": [f(r, N, D)], "Label": [r.randint(0, D, (N, 1))]}, {},
            {"Y": 1}, ("X",), "rel"),
        "margin_rank_loss": ("margin_rank_loss", lambda r: {
            "X1": [f(r, N * D, 1)], "X2": [f(r, N * D, 1)],
            "Label": [np.sign(f(r, N * D, 1))]}, {"margin": 0.1},
            {"Out": 1, "Activated": 1}, ("X1", "X2"), "rel"),
        "rank_loss": ("rank_loss", lambda r: {
            "Left": [f(r, N * D, 1)], "Right": [f(r, N * D, 1)],
            "Label": [r.randint(0, 2, (N * D, 1)).astype("f4")]}, {},
            {"Out": 1}, ("Left", "Right"), "rel"),
        "kldiv_loss": ("kldiv_loss", lambda r: {
            "X": [np.log(r.rand(N, D).astype("f4") + 0.1)],
            "Target": [r.rand(N, D).astype("f4")]},
            {"reduction": "batchmean"}, {"Loss": 1}, ("X",), "rel"),
        "npair_loss": ("npair_loss", lambda r: {
            "Anchor": [f(r, N, 256, scale=0.1)],
            "Positive": [f(r, N, 256, scale=0.1)],
            "Labels": [r.randint(0, 64, (N,)).astype("f4")]}, {},
            {"Out": 1}, ("Anchor", "Positive"), "rel"),
        "auc": ("auc", lambda r: {
            "Predict": [r.rand(N * D // 8, 2).astype("f4")],
            "Label": [r.randint(0, 2, (N * D // 8, 1))],
            "StatPos": [r.randint(0, 9, (4096,)).astype("f4")],
            "StatNeg": [r.randint(0, 9, (4096,)).astype("f4")]}, {},
            {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}, (), "bits"),
        "mean_iou": ("mean_iou", lambda r: {
            "Predictions": [r.randint(0, 21, (N * D,))],
            "Labels": [r.randint(0, 21, (N * D,))]}, {"num_classes": 21},
            {"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1}, (), "rel"),
        "precision_recall": ("precision_recall", lambda r: {
            "Indices": [r.randint(0, 10, (N * D, 1))],
            "Labels": [r.randint(0, 10, (N * D, 1))],
            "StatesInfo": [np.zeros((10, 3), "f4")]}, {},
            {"BatchMetrics": 1, "AccumMetrics": 1, "AccumStatesInfo": 1},
            (), "rel"),
        "edit_distance": ("edit_distance", lambda r: {
            "Hyps": [r.randint(0, 6, (4 * D, 24))],
            "Refs": [r.randint(0, 6, (4 * D, 20))]}, {"normalized": True},
            {"Out": 1, "SequenceNum": 1}, (), "bits"),
        "sequence_erase": ("sequence_erase", lambda r: {
            "X": [r.randint(0, 9, (N, D))]}, {"tokens": [2, 5]}, {"Out": 1},
            (), "bits"),
        "interpolate_align": ("interpolate", lambda r: {"X": [f(r, *img)]},
                              {"out_h": 96, "out_w": 80}, {"Out": 1},
                              ("X",), "rel"),
        "bilinear_interp_shrink": ("bilinear_interp", lambda r: {
            "X": [f(r, *img)]}, {"out_h": 40, "out_w": 27,
                                 "align_corners": False}, {"Out": 1},
            ("X",), "rel"),
        "nearest_interp": ("nearest_interp", lambda r: {"X": [f(r, *img)]},
                           {"out_h": 40, "out_w": 100}, {"Out": 1}, ("X",),
                           "fwd"),
        "interpolate_bicubic": ("interpolate", lambda r: {
            "X": [f(r, *img)]}, {"out_h": 80, "out_w": 48,
                                 "interp_method": "bicubic",
                                 "align_corners": False}, {"Out": 1},
            ("X",), "rel"),
        "lookup_table_v2": ("lookup_table_v2", lambda r: {
            "W": [f(r, 4 * N, 256)], "Ids": [r.randint(0, 4 * N, (N, 4))]},
            {"padding_idx": 7}, {"Out": 1}, ("W",), "fwd"),
    }
    return c


# the random ops, held by their moments on the card: (op, inputs, attrs,
# check(draw) -> None or what is wrong)
def _dense_random_cases():
    import numpy as np
    n = DENSE_DRAWS
    tstd = 0.8796256610342398      # a normal cut to [-2, 2]

    def moments(lo, hi, mean, std):
        def check(x):
            m, s = float(x.mean()), float(x.std())
            if not (x.min() >= lo and x.max() <= hi
                    and abs(m - mean) < 0.01 and abs(s - std) < 0.01):
                return f"min {x.min()} max {x.max()} mean {m} std {s}"
        return check

    p = np.array([0.1, 0.2, 0.0, 0.7], "float32")

    def freq(x):
        got = np.bincount(x.reshape(-1), minlength=4) / x.size
        if np.abs(got - p).max() > 0.01:
            return f"frequencies {got}"

    inf = float("inf")
    return {
        "uniform_random_batch_size_like": (
            {"Input": [np.zeros((n // 64, 3), "f4")]},
            {"shape": [-1, 64], "min": -0.5, "max": 1.5},
            moments(-0.5, 1.5, 0.5, 2 / 12 ** 0.5)),
        "gaussian_random_batch_size_like": (
            {"Input": [np.zeros((2, n // 64), "f4")]},
            {"shape": [64, -1], "input_dim_idx": 1, "output_dim_idx": 1,
             "mean": 1.0, "std": 2.0}, moments(-inf, inf, 1.0, 2.0)),
        "truncated_gaussian_random": (
            {}, {"shape": [n], "mean": 1.0, "std": 2.0},
            moments(-3.0, 5.0, 1.0, 2 * tstd)),
        "sampling_id": ({"X": [np.tile(p, (n // 16, 1))]}, {}, freq),
    }


def dense_program(torch, case, arrays, rng):
    """(main, feed, parameter arrays, fetch vars, number of outputs among
    them) of one sweep case: its differentiated inputs parameters (set
    from the host arrays), the others fed; with any, the sum of each
    float output times a seeded cotangent as the loss, and
    append_backward's grads of the parameters after the outputs."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.backward import append_backward
    from paddle_tpu_torch.framework.layer_helper import LayerHelper
    op, _, attrs, outs, diff, _ = case
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    feed, params = {}, {}
    with ptt.program_guard(main, startup):
        block = main.global_block()
        ins = {}
        for slot, arrs in arrays.items():
            ins[slot] = []
            for i, a in enumerate(arrs):
                name = f"{slot}_{i}"
                if slot in diff:
                    v = block.create_parameter(name, list(a.shape),
                                               dtype=str(a.dtype))
                    params[name] = a
                else:
                    v = block.create_var(name=name, shape=list(a.shape),
                                         dtype=str(a.dtype), is_data=True,
                                         stop_gradient=True)
                    feed[name] = a
                ins[slot].append(v)
        helper = LayerHelper(op)
        out_vars = {slot: [helper.create_variable_for_type_inference()
                           for _ in range(n)] for slot, n in outs.items()}
        helper.append_op(op, ins, out_vars, dict(attrs))
        fetch = [v for vs in out_vars.values() for v in vs]
        grads = []
        if params:
            terms = []
            for v in fetch:
                if not v.dtype.startswith("float"):
                    continue
                ct = block.create_var(name=f"ct_{v.name}",
                                      shape=list(v.shape), dtype=v.dtype,
                                      is_data=True, stop_gradient=True)
                feed[ct.name] = np.asarray(rng.randn(*v.shape), v.dtype)
                terms.append(ptt.layers.reduce_sum(
                    ptt.layers.elementwise_mul(v, ct)))
            loss = terms[0] if len(terms) == 1 else ptt.layers.sums(terms)
            grads = [g for _, g in append_backward(
                loss, parameter_list=list(params))]
    return main, feed, params, fetch + grads, len(fetch)


def dense_run(torch, place, main, feed, params, fetch):
    """The program's fetches on `place` (host numpy)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    exe = ptt.Executor(place, scope=ptt.Scope())
    ptt.io.params_from_numpy(exe.scope, params, place)
    return [np.asarray(o) for o in exe.run(main, feed=feed,
                                            fetch_list=fetch)]


def sweep_compare(name, kind, n_out, card, cpu, misses):
    """A sweep case's card fetches against the CPU's, `n_out` outputs
    then gradients, by its kind (_dense_sweep_cases): each miss appended
    to `misses`; returns the worst relative error where one was taken."""
    import numpy as np
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        what = "output" if i < n_out else "grad"
        bits = kind == "bits" or (kind == "fwd" and i < n_out)
        if a.shape != b.shape or a.dtype != b.dtype:
            misses.append(f"{name} {what} {i}: {a.shape} {a.dtype} "
                          f"against the CPU's {b.shape} {b.dtype}")
        elif bits and not np.array_equal(a, b, equal_nan=True):
            misses.append(f"{name} {what} {i}: "
                          f"{int((a != b).sum())} entries differ")
        elif not bits:
            err = float(np.abs(a.astype("f8") - b).max()
                        / max(float(np.abs(b).max()), 1e-30))
            worst = max(worst, err)
            if not err <= DENSE_RTOL:
                misses.append(f"{name} {what} {i}: {err:.3g} of max "
                              f"|CPU| against {DENSE_RTOL}")
    return worst


def dense_sweep(torch):
    """(b) Every op of the dense plane through the Executor on the card
    and on the CPU: outputs, and gradients through append_backward, bit
    for bit where the case's kind says so, else within DENSE_RTOL of
    max |CPU|; the random ops by their moments on the card, and the same
    draw from two runs under the program's seed.  Returns the misses (an
    empty list when every case holds)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    cases = _dense_sweep_cases()
    misses, rows = [], {}
    t0 = time.perf_counter()
    for name, case in cases.items():
        rng = np.random.RandomState(SEED + len(rows))
        arrays = case[1](rng)
        main, feed, params, fetch, n_out = dense_program(torch, case,
                                                         arrays, rng)
        card = dense_run(torch, ptt.CUDAPlace(0), main, feed, params, fetch)
        cpu = dense_run(torch, ptt.CPUPlace(), main, feed, params, fetch)
        worst = sweep_compare(name, case[5], n_out, card, cpu, misses)
        rows[name] = (case[5], len(fetch) - n_out, worst)
    for name, (ins, attrs, check) in _dense_random_cases().items():
        main, feed, params, fetch, _ = dense_program(
            torch, (name, None, dict(attrs, dtype="float32"),
                    {"Out": 1}, (), "random"), ins, None)
        draws = [dense_run(torch, ptt.CUDAPlace(0), main, feed, params,
                           fetch)[0] for _ in range(2)]
        why = check(draws[0])
        if why is None and not np.array_equal(draws[0], draws[1]):
            why = "two runs under one seed drew different numbers"
        if why is not None:
            misses.append(f"{name}: {why}")
        rows[name] = ("moments", 0, 0.0)
    n_grads = sum(r[1] for r in rows.values())
    log(f"[dense sweep] {len(rows)} cases ({len(cases)} held to the CPU, "
        f"{len(rows) - len(cases)} random by their moments), "
        f"{sum(1 for r in rows.values() if r[0] == 'bits')} bit for bit, "
        f"{n_grads} gradients; worst relative errors "
        f"{ {n: float(f'{r[2]:.3g}') for n, r in rows.items() if r[2]} }; "
        f"{len(misses)} misses; {time.perf_counter() - t0:.1f} s")
    return misses


def dense_deepfm_build(auc):
    """(main, startup, loss, prob, label, [AUC, stat_pos, stat_neg] or
    None) of bench_deepfm's program, with layers.auc(prob, label) before
    Adagrad's minimize when `auc`."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import deepfm
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        feeds, loss, prob = deepfm.build_train_net(
            deepfm.DeepFMConfig(**DEEPFM_CFG))
        extra = None
        if auc:
            a, stats = ptt.layers.auc(prob, feeds[2])
            extra = [a] + stats
        ptt.optimizer.Adagrad(learning_rate=DEEPFM_LR).minimize(loss)
    return main, startup, loss, prob, feeds[2], extra


def dense_deepfm_auc(torch):
    """(a) bench_deepfm with layers.auc: DENSE_AUC_STEPS Executor.run
    steps on the card fetching the AUC and the probabilities; the card's
    StatPos/StatNeg bit-equal to metrics.Auc fed the same fetched
    probabilities and labels, the AUC within DENSE_AUC_ATOL of its eval.
    Then run_steps timed with and without the auc op, f32 and AMP, in
    turns, with the host syncs of runs of each.  Returns the AUC steps
    and the timing rows."""
    import numpy as np
    import paddle_tpu_torch as ptt
    host = ptt.metrics.Auc("auc")
    main, startup, loss, prob, label, extra = dense_deepfm_build(True)
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    aucs = []
    for step in range(DENSE_AUC_STEPS):
        feed = deepfm_feed(DEEPFM_BATCH, SEED + 40 + step)
        out = exe.run(main, feed=feed, fetch_list=[loss, prob] + extra)
        host.update(out[1], feed["label"])
        if not (np.array_equal(out[3], host.stat_pos)
                and np.array_equal(out[4], host.stat_neg)):
            raise RuntimeError(
                f"[dense auc] step {step}: the card's StatPos/StatNeg are "
                f"not the host Auc's: {int((out[3] != host.stat_pos).sum())}"
                f" and {int((out[4] != host.stat_neg).sum())} buckets "
                f"differ")
        err = abs(float(out[2]) - host.eval())
        if not err <= DENSE_AUC_ATOL:
            raise RuntimeError(f"[dense auc] step {step}: AUC "
                               f"{float(out[2])} against the host's "
                               f"{host.eval()}")
        aucs.append((float(out[0]), float(out[2]), err))
    if host.stat_pos.sum() + host.stat_neg.sum() != (DENSE_AUC_STEPS
                                                     * DEEPFM_BATCH):
        raise RuntimeError("[dense auc] the histograms lost predictions")
    rows, built = {}, {}
    for amp, auc in DENSE_VARIANTS:
        e, m, l, feed = dense_variant(amp, auc)
        with amp_bf16(amp):
            runs = [sync_sites(torch, lambda: e.run(
                m, feed=feed, fetch_list=[l], return_numpy=False))[1]
                for _ in range(3 if auc else 2)]
            # without the op, the fewer of two runs (a run's own syncs, not
            # a one-off's); with it, the most of three, so that a sync the
            # op makes on some runs only still counts
            sites = (max if auc else min)(runs, key=len)
        built[(amp, auc)] = (e, m, l, feed)
        rows[(amp, auc)] = {"syncs": len(sites), "sites": sites, "ms": []}
    for order in (DENSE_VARIANTS, DENSE_VARIANTS[::-1]):     # in turns
        for amp, auc in order:
            e, m, l, feed = built[(amp, auc)]
            with amp_bf16(amp):
                rows[(amp, auc)]["ms"].append(time_run_steps(
                    torch, e, m, feed, l, steps=DEEPFM_TIMED_STEPS,
                    calls=DEEPFM_TIMED_CALLS))
    for (amp, auc), r in rows.items():
        r["ms"] = min(r["ms"])
    return aucs, rows


# (amp, auc): bench_deepfm f32 and AMP, without and with the auc op
DENSE_VARIANTS = [(amp, auc) for amp in (False, True)
                  for auc in (False, True)]


def dense_variant(amp, auc):
    """bench_deepfm's program, with the auc op or without, f32 or under
    AMP, on an Executor of its own after one warm run: (executor,
    program, loss, feed)."""
    import paddle_tpu_torch as ptt
    with amp_bf16(amp):
        m, s, l, _, _, _ = dense_deepfm_build(auc)
        e = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
        e.run(s)
        feed = deepfm_feed(DEEPFM_BATCH, SEED + 50, device=DEVICE)
        e.run(m, feed=feed, fetch_list=[l])
    return e, m, l, feed


def phase_dense(torch):
    """Phase 5n: the dense op plane on the card, (a) DeepFM's in-graph AUC
    and (b) the sweep of every op the plane added.  Returns the launch
    counts of this repo's kernels by path (all 0: no TPU kernel lies on
    this plane)."""
    t0 = time.perf_counter()
    counters = launch_counters()
    zero_counters(counters)
    aucs, rows = dense_deepfm_auc(torch)
    misses = dense_sweep(torch)
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    recs = [r for r in VERIFY_LOG if r["phase"] == "dense"]
    added = {amp: (rows[(amp, True)]["ms"] - rows[(amp, False)]["ms"],
                   rows[(amp, True)]["syncs"] - rows[(amp, False)]["syncs"])
             for amp in (False, True)}
    log(f"[dense auc] bench_deepfm + auc, {DENSE_AUC_STEPS} steps (loss, "
        f"AUC, |AUC - host|) {[tuple(round(v, 7) for v in a) for a in aucs]}"
        f"; run_steps ms a step (f32 without / with auc, AMP without / "
        f"with): {rows[(False, False)]['ms']:.4f} / "
        f"{rows[(False, True)]['ms']:.4f}, {rows[(True, False)]['ms']:.4f}"
        f" / {rows[(True, True)]['ms']:.4f}; the auc op adds "
        f"{added[False][0]:.4f} ms (f32) and {added[True][0]:.4f} ms "
        f"(AMP) a step and {added[False][1]} and {added[True][1]} host "
        f"syncs a run (expected 0; a run's syncs with the op, f32 "
        f"{rows[(False, True)]['syncs']}, AMP {rows[(True, True)]['syncs']}:"
        f" {rows[(False, True)]['sites']}); the gate verified {len(recs)} programs "
        f"in error mode, {sum(r['errors'] for r in recs)} with an error; "
        f"this repo's kernels launched {sum(counts.values())} times; phase "
        f"{time.perf_counter() - t0:.1f} s; {nvidia_smi_line()}")
    if misses:
        raise RuntimeError("[dense sweep] the card parts from the CPU:\n  "
                           + "\n  ".join(misses))
    if added[False][1] > 0 or added[True][1] > 0:
        raise RuntimeError(
            f"[dense auc] the auc op adds host syncs: {added}; sites with "
            f"it {[rows[(a, True)]['sites'] for a in (False, True)]}, "
            f"without {[rows[(a, False)]['sites'] for a in (False, True)]}")
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"dense verifications {recs}")
    if any(counts.values()):
        raise RuntimeError(f"[dense] launched this repo's kernels: {counts}")
    return {"dense_plane": counts}


def trace_dense(torch):
    """The kernel launches and the device busy time the auc op adds to one
    bench_deepfm step, f32 and AMP: each program's step traced, with and
    without the op."""
    n = {}
    for amp, auc in DENSE_VARIANTS:
        e, m, l, feed = dense_variant(amp, auc)
        with amp_bf16(amp):
            events, wall = profiled(torch, lambda: e.run(
                m, feed=feed, fetch_list=[l], return_numpy=False))
        busy_ms = sum(ev.self_device_time_total for ev in events
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and ev.self_device_time_total > 0) / 1e3
        n[(amp, auc)] = (_device_launches(torch, events), wall / 1e3,
                         busy_ms)
    log(f"[trace] bench_deepfm step kernel launches (f32 without / with "
        f"auc, AMP without / with): {n[(False, False)][0]} / "
        f"{n[(False, True)][0]}, {n[(True, False)][0]} / "
        f"{n[(True, True)][0]}: the auc op adds "
        f"{n[(False, True)][0] - n[(False, False)][0]} (f32) and "
        f"{n[(True, True)][0] - n[(True, False)][0]} (AMP) launches and "
        f"{n[(False, True)][2] - n[(False, False)][2]:.4f} ms (f32) and "
        f"{n[(True, True)][2] - n[(True, False)][2]:.4f} ms (AMP) of device "
        f"busy time; device busy ms { {k: round(v[2], 4) for k, v in n.items()} }"
        f", traced walls (ms) { {k: round(v[1], 3) for k, v in n.items()} }")


# phase 5o: the sequence, LoD-array, CTC and sampling planes.  (a) A CTC
# acoustic model in the shape of DeepSpeech2 (161 spectrogram bins a
# frame, a row convolution with 2 future frames, a bidirectional
# recurrence, 29 outputs: 28 characters and the blank 0) built from the
# port's public layers, at hidden 512, 2 layers, T 200 and batch 32;
# (b) every op the plane added, through the Executor on the card and on
# the CPU at a few MB (DENSE_N x DENSE_D f32 operands or the like)
CTC_T, CTC_FEAT, CTC_BATCH = 200, 161, 32
CTC_HIDDEN, CTC_LAYERS = 512, 2
CTC_CLASSES = 29             # 28 characters and the blank 0
CTC_LABEL = 40               # label slots; lengths in CTC_LAB_LEN
CTC_IN_LEN = (150, 200)      # input lengths, inclusive
CTC_LAB_LEN = (20, 40)
CTC_LR = 1e-4                # Adam
CTC_STEPS = 3                # Executor.run steps on one batch: the loss falls
CTC_CHECK_BATCH = 8          # the card-vs-CPU step (the CPU side is the cost)
CTC_LOSS_RTOL = 1e-5
CTC_GRAD_RTOL = 1e-4         # ||card - CPU|| / ||CPU|| of every @GRAD
CTC_TIE_RTOL = 1e-5          # a greedy id may part only at a top-2 margin
                             # below this x max |logit| (an argmax tie)
CTC_TIMED_STEPS = 3          # time_run_steps: steps a call, timed calls
CTC_TIMED_CALLS = 2
SEQ_NCE_CLASSES = 64         # the sweep's nce draw: each class within
SEQ_NCE_SPREAD = 0.25        # this share of 1 / N of its frequency


def ctc_build():
    """(main, startup, loss, @GRAD names, logits, greedy ids (arg_max),
    decoded ids (ctc_align), edit distances, relu inputs) of the CTC
    model: fc(512, relu) -> row_conv(2) -> layers.lstm(512, 2 layers,
    bidirectional) -> fc(29) -> warpctc(blank 0, input and label
    lengths) -> mean, Adam(CTC_LR); ctc_greedy_decoder and
    edit_distance(ignored_tokens [0]) beside it."""
    import paddle_tpu_torch as ptt
    L = ptt.layers
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup):
        x = L.data("x", [CTC_T, CTC_FEAT])
        label = L.data("label", [CTC_LABEL], dtype="int64")
        in_len = L.data("input_length", [1], dtype="int64")
        lab_len = L.data("label_length", [1], dtype="int64")
        h = L.fc(x, CTC_HIDDEN, num_flatten_dims=2, act="relu")
        h = L.row_conv(h, 2)
        h, _, _ = L.lstm(h, hidden_size=CTC_HIDDEN, num_layers=CTC_LAYERS,
                         is_bidirec=True)
        logits = L.fc(h, CTC_CLASSES, num_flatten_dims=2)
        loss = L.mean(L.warpctc(logits, label, blank=0, input_length=in_len,
                                label_length=lab_len))
        decoded = L.ctc_greedy_decoder(logits, blank=0)
        dist, _ = L.edit_distance(decoded, label, ignored_tokens=[0])
        _, pg = ptt.optimizer.Adam(learning_rate=CTC_LR).minimize(loss)
    block = main.global_block()
    greedy = [op.outputs["Out"][0] for op in block.ops
              if op.type == "arg_max"][0]
    relus = [op.inputs["X"][0] for op in block.ops if op.type == "relu"]
    return (main, startup, loss, [g.name for _, g in pg], logits,
            block.var(greedy), decoded, dist, relus)


def ctc_feed(batch, seed, device=None):
    """A seeded batch: frames of 161 normal bins, input lengths in
    CTC_IN_LEN, labels over 1-28 with lengths in CTC_LAB_LEN, 0 (the
    blank) past them; numpy, or tensors on `device`."""
    import numpy as np
    import torch
    r = np.random.RandomState(seed)
    lab_len = r.randint(CTC_LAB_LEN[0], CTC_LAB_LEN[1] + 1, (batch, 1))
    label = r.randint(1, CTC_CLASSES, (batch, CTC_LABEL))
    label[np.arange(CTC_LABEL)[None, :] >= lab_len] = 0
    feed = {"x": r.randn(batch, CTC_T, CTC_FEAT).astype("float32"),
            "label": label.astype("int64"),
            "input_length": r.randint(CTC_IN_LEN[0], CTC_IN_LEN[1] + 1,
                                      (batch, 1)).astype("int64"),
            "label_length": lab_len.astype("int64")}
    if device is None:
        return feed
    return {k: torch.as_tensor(v, device=device) for k, v in feed.items()}


def ctc_greedy_ties(card_ids, cpu_ids, cpu_logits):
    """Where the card's greedy ids part from the CPU's: (row, step, top-2
    margin / max |logit|) of each, and whether every one is an argmax tie
    (margin within CTC_TIE_RTOL)."""
    import numpy as np
    where = np.argwhere(card_ids != cpu_ids)
    top2 = np.sort(cpu_logits, axis=-1)[..., -2:]
    scale = float(np.abs(cpu_logits).max())
    parts = [(int(b), int(t), float((top2[b, t, 1] - top2[b, t, 0]) / scale))
             for b, t in where]
    return parts, all(m <= CTC_TIE_RTOL for _, _, m in parts)


def ctc_card_vs_cpu(torch):
    """(a) One f32 Adam step of the CTC model at CTC_CHECK_BATCH from the
    card's startup state: on the card, on the card with TF32 matmuls (the
    control), and on a CPUPlace executor twice, taking the card's relu
    branches and the control's.  The card's loss and every @GRAD within
    CTC_LOSS_RTOL and CTC_GRAD_RTOL of the CPU step on its branches, the
    control outside one of them; the card's greedy ids equal to the
    CPU's save at a named argmax tie, the decoded ids and the edit
    distances equal on every row without one."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = "[ctc check]"
    (main, startup, loss, grads, logits, greedy, decoded, dist,
     relus) = ctc_build()
    card = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    card.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state = {n: t.numpy() for n, t in host_state(card.scope, names).items()}
    feed = ctc_feed(CTC_CHECK_BATCH, SEED + 60)
    cpu = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    fetch = [loss] + grads + [logits, greedy, decoded, dist] + relus

    def step(exe, place, masks=None):
        ptt.io.params_from_numpy(exe.scope, state, place)
        replay = (replayed_relu_masks(masks) if masks is not None
                  else contextlib.nullcontext([]))
        with replay as left:
            out = exe.run(main, feed=feed, fetch_list=fetch,
                          return_numpy=False)
        if left:
            raise RuntimeError(f"{tag} {len(left)} relu masks not taken")
        n = 1 + len(grads)
        return (float(out[0].float().cpu().reshape(())),
                {g: t.detach().float().cpu() for g, t in zip(grads,
                                                             out[1:n])},
                [t.detach().cpu().numpy() for t in out[n:n + 4]],
                [(t > 0).float().cpu() for t in out[n + 4:]])

    got_loss, got, got_dec, card_signs = step(card, ptt.CUDAPlace(0))
    with tf32_everywhere(torch):
        ctl_loss, ctl, _, ctl_signs = step(card, ptt.CUDAPlace(0))
    res, cpu_s, decs = {}, [], []
    for name, l, g, signs in (("card", got_loss, got, card_signs),
                              ("TF32 control", ctl_loss, ctl, ctl_signs)):
        t0 = time.perf_counter()
        want_loss, want, dec, _ = step(cpu, ptt.CPUPlace(), masks=signs)
        cpu_s.append(time.perf_counter() - t0)
        decs.append(dec)
        errs = grad_rel_errs(want, g)
        worst = sorted(errs, key=errs.get, reverse=True)
        res[name] = (abs(l - want_loss) / abs(want_loss), errs[worst[0]],
                     worst[0], want_loss,
                     [(n, f"{errs[n]:.3g}") for n in worst[1:4]])
    want_dec = decs[0]          # the CPU step on the card's relu branches
    parts, ties_only = ctc_greedy_ties(got_dec[1], want_dec[1], want_dec[0])
    tied_rows = {b for b, _, _ in parts}
    rows_same = all(np.array_equal(got_dec[i][b], want_dec[i][b])
                    for i in (2, 3) for b in range(CTC_CHECK_BATCH)
                    if b not in tied_rows)
    flips = sum(int((a != b).sum()) for a, b in zip(card_signs, ctl_signs))
    log(f"{tag} batch {CTC_CHECK_BATCH}, T {CTC_T}, "
        f"{len(main.global_block().ops)} ops, {len(grads)} @GRADs: loss "
        f"card {got_loss:.7f} CPU {res['card'][3]:.7f} (rel "
        f"{res['card'][0]:.3g}), TF32 control {ctl_loss:.7f} (rel "
        f"{res['TF32 control'][0]:.3g}); worst @GRAD card "
        f"{res['card'][1]:.3g} ({res['card'][2]}; next {res['card'][4]}), "
        f"control {res['TF32 control'][1]:.3g} ({res['TF32 control'][2]});"
        f" bounds {CTC_LOSS_RTOL:g} / {CTC_GRAD_RTOL:g}; greedy ids "
        f"parting from the CPU's (row, step, top-2 margin of max |logit|) "
        f"{parts}; decoded ids and edit distances equal on the other rows: "
        f"{rows_same}; relu branches the control took apart from the "
        f"card's: {flips}; CPU steps {[round(s, 1) for s in cpu_s]} s")
    if not (res["card"][0] <= CTC_LOSS_RTOL
            and res["card"][1] <= CTC_GRAD_RTOL):
        raise RuntimeError(f"{tag} the card's step is off the CPU's: "
                           f"{res['card']}")
    if not (res["TF32 control"][0] > CTC_LOSS_RTOL
            or res["TF32 control"][1] > CTC_GRAD_RTOL):
        raise RuntimeError(f"{tag} the TF32 control passed the bounds: the "
                           f"check cannot tell f32 from TF32")
    if not (ties_only and rows_same):
        raise RuntimeError(f"{tag} the greedy decode parts from the CPU's "
                           f"off a tie: {parts}, other rows equal "
                           f"{rows_same}")
    return dict(loss=res["card"][0], grad=res["card"][1],
                ctl_loss=res["TF32 control"][0],
                ctl_grad=res["TF32 control"][1], ties=parts)


def ctc_train(torch):
    """The CTC model at CTC_BATCH on the card: CTC_STEPS Executor.run
    steps on one batch (every loss finite, the last below the first, the
    greedy decode and edit distances fetched), then run_steps timed as
    bench.py's _time_steps times a row.  The counters are zeroed around
    the card's work.  Returns the counts and the row."""
    import numpy as np
    import paddle_tpu_torch as ptt
    tag = "[ctc train]"
    (main, startup, loss, _, logits, _, decoded, dist, _) = ctc_build()
    exe = ptt.Executor(ptt.CUDAPlace(0), scope=ptt.Scope())
    exe.run(startup)
    feed = ctc_feed(CTC_BATCH, SEED + 61, device=DEVICE)
    counters = launch_counters()
    zero_counters(counters)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(CTC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, decoded, dist])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0]))
    peak = torch.cuda.max_memory_allocated() - base
    step_ms = time_run_steps(torch, exe, main, feed, loss,
                             steps=CTC_TIMED_STEPS, calls=CTC_TIMED_CALLS)
    counts = {n: v for (n, attr), v in read_counters(counters).items()
              if attr == "launches"}
    frames = int(feed["input_length"].sum())
    log(f"{tag} batch {CTC_BATCH}, T {CTC_T}, {CTC_FEAT} bins, hidden "
        f"{CTC_HIDDEN} x {CTC_LAYERS} layers bidirectional, "
        f"{CTC_CLASSES} classes, "
        f"{sum(math.prod(p.shape) for p in main.all_parameters())} weights:"
        f" losses {[round(v, 4) for v in losses]}; decoded shape "
        f"{tuple(out[1].shape)}, mean edit distance "
        f"{float(np.mean(out[2])):.4f}; run ms {[round(v, 1) for v in ms]};"
        f" run_steps {step_ms:.2f} ms a step ({CTC_TIMED_STEPS} steps a "
        f"call, best of {CTC_TIMED_CALLS} after one), "
        f"{CTC_BATCH / step_ms * 1e3:.1f} utterances/s, "
        f"{frames / step_ms * 1e3:.0f} frames/s; peak "
        f"{peak / 2**20:.1f} MiB above what was held; this repo's kernels "
        f"launched {sum(counts.values())} times; {nvidia_smi_line()}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise RuntimeError(f"{tag} the loss did not fall: {losses}")
    if any(counts.values()):
        raise RuntimeError(f"{tag} launched this repo's kernels: {counts}")
    return counts, dict(exe=exe, main=main, feed=feed, loss=loss,
                        losses=losses, step_ms=step_ms, peak=peak)


def _seq_ids(r, n, hi, *shape):
    """Ids in [0, hi) with ids planted as the sweep's index rules need:
    -1 (wraps once), hi (dropped) and a run of one id (repeats sum)."""
    ids = r.randint(0, hi, shape).astype("int64")
    flat = ids.reshape(-1)
    flat[0:n] = flat[0]
    flat[n::97] = -1
    flat[n + 1::97] = hi
    return ids


def _seq_tags(r, *shape):
    return r.randint(0, 7, shape).astype("int64")


def _sequence_sweep_cases():
    """name -> (op, inputs(rng), attrs, {out slot: count}, differentiated
    slots, kind), as _dense_sweep_cases: "bits" holds outputs and
    gradients bit for bit, "fwd" the outputs bit for bit and the gradients
    at DENSE_RTOL, "rel" both at DENSE_RTOL of max |CPU| (the scatters
    with repeated ids among them: atomics on the card)."""
    import numpy as np
    f, kinks = _dense_f, _dense_kinks
    B, T, D = 64, 128, 64
    img = (16, 8, 64, 64)

    def seq(r):
        return f(r, B, T, D)

    def lengths(r, n=B, hi=T):
        v = r.randint(0, hi + 1, n).astype("int64")
        v[:2] = (0, hi)
        return v

    def mask(r):
        return (np.arange(T)[None, :] < lengths(r)[:, None]).astype("f4")

    def cudnn_w(r, d, h, layers):
        n, din = 0, d
        for _ in range(layers):
            n += 2 * (din * 4 * h + h * 4 * h + 4 * h)
            din = 2 * h
        return f(r, n, scale=0.1)

    perm = lambda r, n: r.permutation(n).astype("int64")  # noqa: E731
    c = {
        "sequence_mask": ("sequence_mask", lambda r: {
            "X": [lengths(r, 4096, 300)]}, {"maxlen": 256}, {"Y": 1}, (),
            "bits"),
        "sequence_softmax": ("sequence_softmax", lambda r: {
            "X": [seq(r)], "Mask": [mask(r)]}, {}, {"Out": 1}, ("X",),
            "rel"),
        "sequence_expand": ("sequence_expand", lambda r: {
            "X": [f(r, B, 1024)], "Y": [f(r, B, 16, 8)]}, {}, {"Out": 1},
            ("X",), "fwd"),
        "sequence_expand_as": ("sequence_expand_as", lambda r: {
            "X": [f(r, B, 1024)], "Y": [f(r, B, 16)]}, {}, {"Out": 1},
            ("X",), "fwd"),
        "sequence_reverse": ("sequence_reverse", lambda r: {
            "X": [seq(r)], "Length": [lengths(r)]}, {}, {"Y": 1}, ("X",),
            "bits"),
        "sequence_concat": ("sequence_concat", lambda r: {
            "X": [seq(r), f(r, B, 32, D)]}, {}, {"Out": 1}, ("X",), "bits"),
        "sequence_slice": ("sequence_slice", lambda r: {"X": [seq(r)]},
                           {"offset": 17, "length": 90}, {"Out": 1}, ("X",),
                           "bits"),
        "sequence_pad": ("sequence_pad", lambda r: {
            "X": [seq(r)], "Length": [lengths(r)]},
            {"padded_length": 160, "pad_value": 0.5},
            {"Out": 1, "Length": 1}, ("X",), "bits"),
        "sequence_unpad": ("sequence_unpad", lambda r: {
            "X": [seq(r)], "Length": [lengths(r)]}, {}, {"Out": 1}, ("X",),
            "bits"),
        "sequence_enumerate": ("sequence_enumerate", lambda r: {
            "X": [r.randint(0, 30000, (256, 512)).astype("int64")]},
            {"win_size": 4, "pad_value": 1}, {"Out": 1}, (), "bits"),
        "sequence_reshape": ("sequence_reshape", lambda r: {"X": [seq(r)]},
                             {"new_dim": 128}, {"Out": 1}, ("X",), "bits"),
        "sequence_scatter": ("sequence_scatter", lambda r: {
            "X": [f(r, B, 1024)], "Ids": [_seq_ids(r, 40, 1024, B, 256)],
            "Updates": [f(r, B, 256)]}, {}, {"Out": 1}, ("X", "Updates"),
            "rel"),
        "lod_reset": ("lod_reset", lambda r: {"X": [seq(r)]},
                      {"target_lod": []}, {"Out": 1}, ("X",), "bits"),
        "row_conv": ("row_conv", lambda r: {
            "X": [seq(r)], "Filter": [f(r, 3, D, scale=0.3)]}, {},
            {"Out": 1}, ("X", "Filter"), "rel"),
        "add_position_encoding": ("add_position_encoding", lambda r: {
            "X": [seq(r)]}, {"alpha": 0.5, "beta": 2.0}, {"Out": 1},
            ("X",), "rel"),
        # the LoD arrays
        "lod_rank_table": ("lod_rank_table", lambda r: {
            "X": [(np.arange(256)[None, :]
                   < r.randint(0, 257, (4096, 1))).astype("f4")]}, {},
            {"Out": 1, "Lengths": 1}, (), "bits"),
        "max_sequence_len": ("max_sequence_len", lambda r: {
            "RankTable": [lengths(r, 4096, 1000)]}, {}, {"Out": 1}, (),
            "bits"),
        "reorder_lod_tensor_by_rank": ("reorder_lod_tensor_by_rank",
                                       lambda r: {
            "X": [f(r, 4096, 256)], "RankTable": [perm(r, 4096)]}, {},
            {"Out": 1}, ("X",), "bits"),
        "tensor_array_to_tensor": ("tensor_array_to_tensor", lambda r: {
            "X": [f(r, 512, 256) for _ in range(4)]}, {"axis": 1},
            {"Out": 1, "OutIndex": 1}, ("X",), "bits"),
        "split_lod_tensor": ("split_lod_tensor", lambda r: {
            "X": [f(r, 512, 1024)], "Mask": [r.rand(512, 1) < 0.5]}, {},
            {"OutTrue": 1, "OutFalse": 1}, ("X",), "bits"),
        "merge_lod_tensor": ("merge_lod_tensor", lambda r: {
            "InTrue": [f(r, 512, 1024)], "InFalse": [f(r, 512, 1024)],
            "Mask": [r.rand(512, 1) < 0.5]}, {}, {"Out": 1},
            ("InTrue", "InFalse"), "bits"),
        "lod_array_length": ("lod_array_length", lambda r: {
            "X": [f(r, 512, 256) for _ in range(3)]}, {}, {"Out": 1}, (),
            "bits"),
        "lod_tensor_to_array": ("lod_tensor_to_array", lambda r: {
            "X": [f(r, 256, 8, 256)], "RankTable": [perm(r, 256)]}, {},
            {"Out": 8}, ("X",), "bits"),
        "array_to_lod_tensor": ("array_to_lod_tensor", lambda r: {
            "X": [f(r, 256, 256) for _ in range(8)],
            "RankTable": [perm(r, 256)]}, {}, {"Out": 1}, ("X",), "bits"),
        "shrink_rnn_memory": ("shrink_rnn_memory", lambda r: {
            "X": [f(r, 512, 1024)], "RankTable": [lengths(r, 512, 50)],
            "I": [np.array([20], "int64")]}, {}, {"Out": 1}, ("X",),
            "bits"),
        "rnn_memory_helper": ("rnn_memory_helper", lambda r: {
            "X": [f(r, 512, 1024)]}, {}, {"Out": 1}, ("X",), "bits"),
        # lax's rule: 7 clamps to row 2 of 3, -1 wraps to row 2
        **{f"write_to_array_{i}": ("write_to_array", lambda r, i=i: {
            "X": [f(r, 512, 512)], "I": [np.array([i], "int64")],
            "Array": [f(r, 3, 512, 512)]}, {}, {"Out": 1}, ("X", "Array"),
            "bits") for i in (1, 7, -1)},
        **{f"read_from_array_{i}": ("read_from_array", lambda r, i=i: {
            "X": [f(r, 3, 512, 512)], "I": [np.array([i], "int64")]}, {},
            {"Out": 1}, ("X",), "bits") for i in (9, -1)},
        # the recurrent extras
        "sequence_context": ("sequence_context", lambda r: {
            "X": [seq(r)]}, {"context_length": 3}, {"Out": 1}, ("X",),
            "fwd"),
        "conv_shift": ("conv_shift", lambda r: {
            "X": [f(r, 512, 1024)], "Y": [f(r, 512, 5)]}, {}, {"Out": 1},
            ("X", "Y"), "rel"),
        "lstmp": ("lstmp", lambda r: {
            "Input": [f(r, 32, 64, 512)], "Weight": [f(r, 64, 512,
                                                       scale=0.1)],
            "ProjWeight": [f(r, 128, 64, scale=0.1)]}, {},
            {"Projection": 1, "Cell": 1, "LastH": 1, "LastC": 1},
            ("Input", "Weight", "ProjWeight"), "rel"),
        "cudnn_lstm": ("cudnn_lstm", lambda r: {
            "Input": [f(r, 16, 64, 128)], "W": [cudnn_w(r, 128, 128, 2)]},
            {"hidden_size": 128, "num_layers": 2, "is_bidirec": True},
            {"Out": 1, "LastH": 1, "LastC": 1}, ("Input", "W"), "rel"),
        # CTC and chunks
        "warpctc": ("warpctc", lambda r: {
            "Logits": [f(r, 32, CTC_T, CTC_CLASSES, scale=2.0)],
            "Label": [r.randint(1, CTC_CLASSES, (32, CTC_LABEL))],
            "LogitsLength": [r.randint(CTC_IN_LEN[0], CTC_T + 1, 32)],
            "LabelLength": [np.concatenate([[0], r.randint(
                CTC_LAB_LEN[0], CTC_LABEL + 1, 31)])]}, {}, {"Loss": 1},
            ("Logits",),
            "rel"),
        "ctc_align": ("ctc_align", lambda r: {
            "Input": [r.randint(0, 4, (512, 1024)).astype("int64")]},
            {"blank": 0}, {"Output": 1}, (), "bits"),
        "chunk_eval": ("chunk_eval", lambda r: {
            "Inference": [_seq_tags(r, 256, 512)],
            "Label": [_seq_tags(r, 256, 512)]},
            {"num_chunk_types": 3, "excluded_chunk_types": [1]},
            {"Precision": 1, "Recall": 1, "F1-Score": 1,
             "NumInferChunks": 1, "NumLabelChunks": 1,
             "NumCorrectChunks": 1}, (), "bits"),
        # sampling (nce apart, in sequence_sweep)
        "hierarchical_sigmoid": ("hierarchical_sigmoid", lambda r: {
            "X": [f(r, 4096, 64)], "W": [f(r, 999, 64, scale=0.2)],
            "Label": [r.randint(0, 1000, (4096, 1))],
            "Bias": [f(r, 999)]}, {"num_classes": 1000},
            {"Out": 1, "PreOut": 1}, ("X", "W", "Bias"), "rel"),
        "teacher_student_sigmoid_loss": (
            "teacher_student_sigmoid_loss", lambda r: {
                "X": [kinks(r, (0.0, 15.0, -15.0), 65536, 1, scale=8.0)],
                "Label": [np.where(r.rand(65536, 1) < 0.5, r.rand(65536, 1),
                                   r.randint(0, 2, (65536, 1))).astype(
                                       "f4")]}, {}, {"Y": 1}, ("X",),
            "rel"),
        "positive_negative_pair": ("positive_negative_pair", lambda r: {
            "Score": [np.round(r.rand(2048, 1) * 20).astype("f4")],
            "Label": [r.randint(0, 3, (2048, 1)).astype("f4")],
            "QueryID": [r.randint(0, 8, (2048, 1))]}, {},
            {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1}, (),
            "bits"),
        # selected rows and ids
        "unique": ("unique", lambda r: {
            "X": [r.randint(0, 5000, 262144).astype("int64")]}, {},
            {"Out": 1, "Index": 1, "Count": 1}, (), "bits"),
        "unique_with_counts": ("unique_with_counts", lambda r: {
            "X": [r.randint(0, 5000, 262144).astype("int64")]}, {},
            {"Out": 1, "Index": 1, "Count": 1, "UniqueCount": 1}, (),
            "bits"),
        "hash": ("hash", lambda r: {
            "X": [r.randint(-2**40, 2**40, (65536, 4))]},
            {"num_hash": 4, "mod_by": 100003}, {"Out": 1}, (), "bits"),
        "lookup_sparse_table": ("lookup_sparse_table", lambda r: {
            "W": [f(r, 4096, 256)], "Ids": [r.randint(0, 4096, 8192)]}, {},
            {"Out": 1}, ("W",), "fwd"),
        "split_ids": ("split_ids", lambda r: {
            "Ids": [r.randint(-1000, 100000, 262144)]}, {"num_shards": 4},
            {"Out": 4}, (), "bits"),
        "merge_ids": ("merge_ids", lambda r: {
            "X": [f(r, 512, 1024), f(r, 512, 1024)]}, {}, {"Out": 1},
            ("X",), "bits"),
        "merge_selected_rows": ("merge_selected_rows", lambda r: {
            "Ids": [r.randint(0, 1000, 8192)], "Values": [f(r, 8192, 128)]},
            {}, {"OutIds": 1, "Out": 1}, ("Values",), "rel"),
        "split_selected_rows": ("split_selected_rows", lambda r: {
            "Ids": [r.randint(0, 1000, 8192)], "Values": [f(r, 8192, 128)]},
            {"height_sections": [300, 300, 400]}, {"OutIds": 3, "Out": 3},
            ("Values",), "bits"),
        "get_tensor_from_selected_rows": ("get_tensor_from_selected_rows",
                                          lambda r: {
            "Ids": [_seq_ids(r, 40, 1000, 8192)],
            "Values": [f(r, 8192, 128)]}, {"height": 1000}, {"Out": 1},
            ("Values",), "rel"),
        # vision
        "affine_channel": ("affine_channel", lambda r: {
            "X": [f(r, *img)], "Scale": [f(r, 8)], "Bias": [f(r, 8)]}, {},
            {"Out": 1}, ("X", "Scale", "Bias"), "rel"),
        "im2sequence": ("im2sequence", lambda r: {"X": [f(r, *img)]},
                        {"kernels": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1, 0, 0]}, {"Out": 1}, ("X",),
                        "bits"),
        "grid_sampler": ("grid_sampler", lambda r: {
            "X": [f(r, *img)],
            "Grid": [kinks(r, (0.0, 1.0, -1.0), 16, 48, 48, 2, scale=0.8)]},
            {}, {"Output": 1}, ("X", "Grid"), "rel"),
        "pad3d": ("pad3d", lambda r: {"X": [f(r, 8, 4, 16, 32, 32)]},
                  {"paddings": [1, 2, 0, 3, 2, 1], "value": 0.5},
                  {"Out": 1}, ("X",), "bits"),
        "shuffle_channel": ("shuffle_channel", lambda r: {
            "X": [f(r, *img)]}, {"group": 4}, {"Out": 1}, ("X",), "bits"),
        "similarity_focus": ("similarity_focus", lambda r: {
            "X": [np.round(r.rand(*img) * 8).astype("f4")]},
            {"axis": 1, "indexes": [0, 3, 5]}, {"Out": 1}, (), "bits"),
        "spp": ("spp", lambda r: {"X": [f(r, *img)]},
                {"pyramid_height": 3}, {"Out": 1}, ("X",), "fwd"),
        "unpool": ("unpool", lambda r: {
            "X": [f(r, 16, 8, 32, 32)],
            "Indices": [_seq_ids(r, 40, 4096, 16, 8, 32, 32)]},
            {"unpooled_height": 64, "unpooled_width": 64}, {"Out": 1},
            ("X",), "rel"),
        "scale_sub_region": ("scale_sub_region", lambda r: {
            "X": [f(r, *img)],
            "Indices": [np.sort(r.randint(1, 9, (16, 3, 2)), axis=2).reshape(
                16, 6) * [1, 1, 8, 8, 8, 8]]}, {"value": 2.5}, {"Out": 1},
            ("X",), "bits"),
        # host ops
        "fill": ("fill", lambda r: {}, {"shape": [64, 1024],
                                        "dtype": "float32",
                                        "value": f(np.random.RandomState(
                                            SEED), 64 * 1024).tolist()},
                 {"Out": 1}, (), "bits"),
        "print": ("print", lambda r: {"X": [f(r, 4, 4)]},
                  {"message": "[sequence sweep] print: "}, {"Out": 1}, (),
                  "bits"),
        "delete_var": ("delete_var", lambda r: {"X": [f(r, 4, 4)]}, {}, {},
                       (), "bits"),
    }
    return c


def seq_nce(torch, misses):
    """nce on the card and on the CPU fed the card's draw (the port's
    nce_negatives returns it): cost, logits and the gradients within
    DENSE_RTOL, the samples equal; the card's negatives uniform over
    SEQ_NCE_CLASSES (each class within SEQ_NCE_SPREAD / N of 1 / N) and
    the same again under the program's seed."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import sampling_ops
    n, k, batch = SEQ_NCE_CLASSES, 16, 4096
    r = np.random.RandomState(SEED + 70)
    arrays = {"Input": [_dense_f(r, batch, 64)],
              "Weight": [_dense_f(r, n, 64, scale=0.2)],
              "Bias": [_dense_f(r, n)],
              "Label": [r.randint(0, n, (batch, 1))]}
    case = ("nce", None, {"num_total_classes": n, "num_neg_samples": k},
            {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1},
            ("Input", "Weight", "Bias"), "rel")
    main, feed, params, fetch, n_out = dense_program(torch, case, arrays, r)
    card = [dense_run(torch, ptt.CUDAPlace(0), main, feed, params, fetch)
            for _ in range(2)]
    neg = card[0][2][:, 1:]
    real = sampling_ops.nce_negatives
    sampling_ops.nce_negatives = lambda ctx, b, kk, nn, device: (
        torch.from_numpy(neg.copy()).to(device))
    try:
        cpu = dense_run(torch, ptt.CPUPlace(), main, feed, params, fetch)
    finally:
        sampling_ops.nce_negatives = real
    worst = sweep_compare("nce", "rel", n_out, card[0], cpu, misses)
    freq = np.bincount(neg.reshape(-1), minlength=n) / neg.size
    spread = float(np.abs(freq - 1 / n).max() * n)
    if not (freq.shape == (n,) and spread <= SEQ_NCE_SPREAD):
        misses.append(f"nce: the card's negatives are not uniform: "
                      f"{spread:.3g} of 1 / N off")
    if not np.array_equal(card[0][2], card[1][2]):
        misses.append("nce: two runs under one seed drew different samples")
    return worst, spread


def seq_random_crop(torch, misses):
    """random_crop on the card over an arange X: each run's crop is X's
    slice at offsets within [0, size - crop], and the same crop again
    under the program's seed."""
    import numpy as np
    import paddle_tpu_torch as ptt
    shape, crop = (8, 3, 64, 64), [48, 40]
    x = np.arange(math.prod(shape), dtype="float32").reshape(shape)
    case = ("random_crop", None, {"shape": crop}, {"Out": 1}, (), "bits")
    main, feed, params, fetch, _ = dense_program(torch, case, {"X": [x]},
                                                 None)
    outs = [dense_run(torch, ptt.CUDAPlace(0), main, feed, params, fetch)[0]
            for _ in range(2)]
    idx = np.unravel_index(int(outs[0].reshape(-1)[0]), shape)
    off = idx[2:]
    want = x[:, :, off[0]:off[0] + crop[0], off[1]:off[1] + crop[1]]
    if not (idx[:2] == (0, 0) and 0 <= off[0] <= shape[2] - crop[0]
            and 0 <= off[1] <= shape[3] - crop[1]
            and np.array_equal(outs[0], want)):
        misses.append(f"random_crop: the crop is not X's slice at offsets "
                      f"in range: {idx}")
    if not np.array_equal(outs[0], outs[1]):
        misses.append("random_crop: two runs under one seed cropped apart")
    return tuple(int(o) for o in off)


def sequence_sweep(torch):
    """(b) Every op of the plane through the Executor on the card and on
    the CPU, with the gradients of the differentiable ones through
    append_backward, held as _sequence_sweep_cases says; nce and
    random_crop as seq_nce and seq_random_crop hold them.  Returns the
    misses (empty when every case holds)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    cases = _sequence_sweep_cases()
    misses, rows = [], {}
    t0 = time.perf_counter()
    for name, case in cases.items():
        rng = np.random.RandomState(SEED + 100 + len(rows))
        arrays = case[1](rng)
        main, feed, params, fetch, n_out = dense_program(torch, case,
                                                         arrays, rng)
        card = dense_run(torch, ptt.CUDAPlace(0), main, feed, params, fetch)
        cpu = dense_run(torch, ptt.CPUPlace(), main, feed, params, fetch)
        worst = sweep_compare(name, case[5], n_out, card, cpu, misses)
        rows[name] = (case[5], len(fetch) - n_out, worst)
    nce_err, spread = seq_nce(torch, misses)
    rows["nce"] = ("rel", 3, nce_err)
    off = seq_random_crop(torch, misses)
    rows["random_crop"] = ("slice", 0, 0.0)
    n_grads = sum(r[1] for r in rows.values())
    log(f"[sequence sweep] {len(rows)} cases ({len(cases)} held to the CPU,"
        f" nce on the card's draw, random_crop by its slice), "
        f"{sum(1 for r in rows.values() if r[0] == 'bits')} bit for bit, "
        f"{n_grads} gradients; worst relative errors "
        f"{ {n: float(f'{r[2]:.3g}') for n, r in rows.items() if r[2]} }; "
        f"nce's draw within {spread:.3g} / N of uniform; random_crop "
        f"offsets {off}; {len(misses)} misses; "
        f"{time.perf_counter() - t0:.1f} s")
    return misses


def phase_sequence(torch):
    """Phase 5o: the CTC model's card-vs-CPU step and TF32 control, its
    training row, and the sweep of every op the plane added.  Returns the
    launches of this repo's kernels by path (all 0: no TPU kernel lies
    on this plane) and the training row, traced at the end of the
    smoke."""
    t0 = time.perf_counter()
    check = ctc_card_vs_cpu(torch)
    counts, row = ctc_train(torch)
    counters = launch_counters()
    zero_counters(counters)
    misses = sequence_sweep(torch)
    sweep = {n: v for (n, attr), v in read_counters(counters).items()
             if attr == "launches"}
    recs = [r for r in VERIFY_LOG if r["phase"] == "sequence"]
    log(f"[sequence] CTC check loss {check['loss']:.3g} @GRAD "
        f"{check['grad']:.3g} (TF32 control {check['ctl_loss']:.3g} / "
        f"{check['ctl_grad']:.3g}), greedy ties {check['ties']}; CTC "
        f"run_steps {row['step_ms']:.2f} ms a step, losses "
        f"{[round(v, 4) for v in row['losses']]}; the gate verified "
        f"{len(recs)} programs in error mode, "
        f"{sum(r['errors'] for r in recs)} with an error; this repo's "
        f"kernels launched {sum(counts.values()) + sum(sweep.values())} "
        f"times; phase {time.perf_counter() - t0:.1f} s; "
        f"{nvidia_smi_line()}")
    if misses:
        raise RuntimeError("[sequence sweep] the card parts from the CPU:"
                           "\n  " + "\n  ".join(misses))
    if not recs or any(r["errors"] for r in recs):
        raise RuntimeError(f"sequence verifications {recs}")
    if any(sweep.values()):
        raise RuntimeError(f"[sequence] launched this repo's kernels: "
                           f"{sweep}")
    return {"ctc_speech_train": counts, "sequence_plane": sweep}, row


def attributed_launches(raw, label):
    """Kernel launches under the CPU range `label` (any depth below it)
    in one profiled call's events."""
    n = 0
    for e in raw:
        p = e
        while p is not None and p.name != label:
            p = p.cpu_parent
        if p is not None:
            n += len(e.kernels)
    return n


def _ctc_op_launches(torch, op, ins, attrs, wrt):
    """Kernel launches of one forward and backward of `op` on the card at
    the CTC model's shapes (the op alone, autograd over `wrt`)."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    ctx = LowerContext(SEED, torch.device(DEVICE))
    out_slot = {"cudnn_lstm": "Out", "warpctc": "Loss"}[op]

    def call():
        leaves = [ins[s][0].detach().requires_grad_(True) for s in wrt]
        run = dict(ins, **{s: [t] for s, t in zip(wrt, leaves)})
        out = get_op_def(op).lower(ctx, run, attrs)[out_slot][0]
        torch.autograd.grad(out.sum(), leaves)
    events, wall = profiled(torch, call)
    return _device_launches(torch, events), wall / 1e3


def trace_ctc(torch, row):
    """One CTC training step traced by kernel class, with the device's
    idle share (no kernel of this repo), and the launches a step takes in
    cudnn_lstm and warpctc: each op's forward inside its range of the
    traced step, and each op alone, forward and backward, at the step's
    shapes."""
    import numpy as np
    raw = []
    with op_ranges(torch, ("cudnn_lstm", "warpctc")):
        names = trace_run(
            torch, f"CTC training step at batch {CTC_BATCH}",
            lambda: row["exe"].run(row["main"], feed=row["feed"],
                                   fetch_list=[row["loss"]],
                                   return_numpy=False), raw=raw)
    launches = sum(sum(v.values()) for v in names.values())
    fwd = {t: attributed_launches(raw, RANGE_PREFIX + t)
           for t in ("cudnn_lstm", "warpctc")}
    r = np.random.RandomState(SEED + 62)
    n_w = 0
    din = CTC_HIDDEN
    for _ in range(CTC_LAYERS):
        n_w += 2 * (din * 4 * CTC_HIDDEN + CTC_HIDDEN * 4 * CTC_HIDDEN
                    + 4 * CTC_HIDDEN)
        din = 2 * CTC_HIDDEN
    dev = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
    feed = row["feed"]
    alone = {
        "cudnn_lstm": _ctc_op_launches(
            torch, "cudnn_lstm",
            {"Input": [dev(_dense_f(r, CTC_BATCH, CTC_T, CTC_HIDDEN))],
             "W": [dev(_dense_f(r, n_w, scale=0.05))]},
            {"hidden_size": CTC_HIDDEN, "num_layers": CTC_LAYERS,
             "is_bidirec": True}, ("Input", "W")),
        "warpctc": _ctc_op_launches(
            torch, "warpctc",
            {"Logits": [dev(_dense_f(r, CTC_BATCH, CTC_T, CTC_CLASSES))],
             "Label": [feed["label"]],
             "LogitsLength": [feed["input_length"]],
             "LabelLength": [feed["label_length"]]},
            {"blank": 0}, ("Logits",))}
    log(f"[trace]   CTC step: {launches} kernel launches; forward launches"
        f" inside the op's range {fwd}; each op alone, forward and "
        f"backward (launches, wall ms) "
        f"{ {k: (v[0], round(v[1], 2)) for k, v in alone.items()} }")
    ours = [c for c in names if "(this repo)" in c]
    if ours:
        raise RuntimeError(f"the CTC step's trace holds this repo's "
                           f"kernels: {ours}")


BLOCK_GEMMS = "transformer_block GEMMs (this repo)"
BLOCK_GEMMS_BF16 = "transformer_block GEMMs bf16 (this repo)"
# the launches of one block forward (fused_block.cu's chain): the weights'
# split, LN1, q/k/v, flash, o's split, Wo, LN2, W1, W2
BLOCK_CHAIN_LAUNCHES = 9
# ... and of one bf16 block forward (fused_block_bf16.cu's): LN1, q/k/v,
# flash, Wo, LN2, W1, W2
BLOCK_BF16_CHAIN_LAUNCHES = 7


# the launches of one chunk of the bf16 LM-head backward on the sync path:
# dlogits, dx's K ranges, their sum, dW
HEAD_BWD_SYNC_KERNELS = 4
# ... and of one bf16 LM-head forward on either path: the products with
# the running softmax, the merge of the vocabulary shares (sync) or of each
# token tile's segments (wgmma)
HEAD_FWD_KERNELS = 2


def head_bwd_kernels():
    """Launches of one chunk of the bf16 LM-head backward at the training
    shape on the wgmma path: its three products, and the sum of dx's K
    ranges where the plan cuts K."""
    import torch
    from paddle_tpu_torch.kernels import lm_head as lmh
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = lmh.bwd_bf16_plan(HEAD_CHUNK, FLAGSHIP["d_model"],
                             FLAGSHIP["src_vocab_size"], sms)
    return 3 + (plan["ranges"] > 1)


def _kernel_class(name):
    if "_bf16" in name:   # the AMP path's kernels
        for key, cls in (("block_gemm", BLOCK_GEMMS_BF16),
                         ("flash_bwd", "flash backward bf16 (this repo)"),
                         ("flash_fwd", "flash forward bf16 (this repo)"),
                         ("lm_head_fwd", "lm_head_fwd bf16 (this repo)"),
                         ("lm_head_bwd", "lm_head_bwd bf16 (this repo)")):
            if key in name:
                return cls
    if "flash_bwd" in name:
        return "flash backward (this repo; head-major and [B,H,T,d] calls)"
    if "flash_fwd_hdt" in name:
        return ("flash forward (this repo; head-major, [B,H,T,d] and "
                "in-block calls)")
    if "block_gemm" in name:
        return BLOCK_GEMMS
    if "block_split" in name:
        return "transformer_block operand splits (this repo)"
    if "ln_fwd" in name:   # ln_fwd_kernel (f32, scalar), ln_fwd_v16_*
        return "layer_norm (this repo)"
    if "lm_head_fwd" in name:
        return "lm_head_fwd (this repo)"
    if "lm_head_bwd" in name:
        return "lm_head_bwd (this repo)"
    if any(k in name.lower() for k in ("gemm", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies"
    return "other (elementwise, embedding, reductions, adam)"


def ln_launch_kinds(names):
    """The layer-norm launches of a trace_run record by kernel: the f32
    rows' ln_fwd_kernel<float, ...>, and on bf16 rows the scalar path's
    ln_fwd_kernel<__nv_bfloat16, ...> and the v16 path's
    ln_fwd_v16_tma_kernel and ln_fwd_v16_row_kernel."""
    ln = names.get(_kernel_class("ln_fwd_kernel"), {})
    kinds = {"f32": "ln_fwd_kernel<float", "bf16 scalar":
             "ln_fwd_kernel<__nv_bfloat16", "bf16 v16": "ln_fwd_v16_"}
    return {kind: sum(c for k, c in ln.items() if key in k)
            for kind, key in kinds.items()}


PROFILE_TRIES = 5   # the tracer once lost one call's records 3 times running
RANGE_PREFIX = "smoke_range:"   # record_function labels of op_ranges
# idle host time at each end of the recorded cycle: on the H100 a
# 20,000-launch call's trace kept 19333-19996 of its records unpadded and
# all of them with 0.2 s of padding (tools/tracer_probe.py), and single
# traces put a kernel 1.3 ms before or 8.6 ms after its launch call on the
# host's clock, where the tracer keeps only the records inside the cycle
PROFILE_PAD_S = 0.1


def _device_launches(torch, events, part=""):
    """Launches of the kernels in a torch.profiler record whose name holds
    part, counted over the events with device time."""
    return sum(e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and part in e.key)


def profiled(torch, fn, cpu=False, lost=None, raw=None):
    """fn's events from torch.profiler, and the wall time of its call in
    microseconds.  fn runs twice: the first call is the schedule's warm-up
    cycle, whose events are dropped, so that the kernels launched while the
    tracer starts up are not lost from the recorded call.  The schedule's
    step annotation, which spans the call on the device's timeline too, is
    left out.  The recorded cycle holds PROFILE_PAD_S of idle host time
    before and after the call, outside its wall time.  The tracer now and
    then loses a call's kernel records (a whole call's, or one kernel's):
    lost(events) says what a record lacks (None when it is whole; by
    default, a record without device time is not), and such a record is
    traced again, up to PROFILE_TRIES in all, before the call fails.  With
    `raw` (a list), the recorded call's FunctionEvents are put into it
    (their CPU parents and kernels, for attributed_ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    lost = lost or (lambda ev: None if _device_launches(torch, ev) else
                    "no kernel with device time")
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILE_PAD_S)
            prof.step()
        events = [e for e in prof.key_averages()
                  if not e.key.startswith(("ProfilerStep", RANGE_PREFIX))]
        why = lost(events)
        if why is None:
            if raw is not None:
                raw[:] = prof.events()
            return events, wall_us
        kept = sorted(f"{_short_kernel_name(e.key)} x{e.count}"
                      for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0)
        log(f"[profile] trace {attempt} of {PROFILE_TRIES} lost kernel "
            f"records: {why}; it holds {kept[:8]}")
    raise RuntimeError(f"torch.profiler lost kernel records in "
                       f"{PROFILE_TRIES} traces: {why}")


def trace_run(torch, label, fn, expect=None, classify=None, raw=None):
    """Device-time breakdown of one call of fn from a torch.profiler
    trace: kernel time by class (`classify`, by default _kernel_class)
    and the device's busy share of the call's wall time.  expect maps a
    class to the launches it must show.  Returns {class: {kernel name:
    launches}}; `raw` as profiled's."""
    classify = classify or _kernel_class
    def lost(events):
        by_class = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and e.self_device_time_total > 0:
                c = classify(e.key)
                by_class[c] = by_class.get(c, 0) + e.count
        if not by_class:
            return "no kernel with device time"
        short = {c: (by_class.get(c, 0), n) for c, n in (expect or {}).items()
                 if by_class.get(c, 0) < n}
        return f"(launches, expected) {short}" if short else None
    events, wall_us = profiled(torch, fn, cpu=True, lost=lost, raw=raw)
    by_class, launches, names, other = {}, {}, {}, {}
    for e in events:
        # kernels only: a CPU op's self device time repeats its kernels'
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            c = classify(e.key)
            by_class[c] = by_class.get(c, 0.0) + us
            launches[c] = launches.get(c, 0) + e.count
            names.setdefault(c, {})[_short_kernel_name(e.key)] = e.count
            if c.startswith("other"):
                other[_short_kernel_name(e.key)[:100]] = (us, e.count)
    busy = sum(by_class.values())
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    log(f"[trace] {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), idle "
        f"{100 * (1 - busy / wall_us):.1f} %")
    for c, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"[trace]   {c}: {us / 1e3:.3f} ms ({100 * us / busy:.1f} % of "
            f"device time, {launches[c]} launches)")
    for name, (us, n) in sorted(other.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"[trace]     other: {name} {us / 1e3:.3f} ms ({n} launches)")
    for c, n in (expect or {}).items():
        if launches.get(c, 0) != n:
            raise RuntimeError(f"{label}: {launches.get(c, 0)} launches of "
                               f"{c}, expected {n}: {names.get(c, {})}")
    return names


def trace_decode(torch, remake):
    """torch.profiler over one decode-step replay with every slot active,
    on the engine that remake() builds and prepares: device busy time and
    kernel launches.  The trace must show cuBLAS products and no kernel
    of this repo."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    engine = remake()
    for s in range(engine.max_batch):
        engine.start_sequence(
            s, rng.randint(1, FLAGSHIP["src_vocab_size"], 60).tolist())

    def replay():
        with engine._on_device():
            engine._step()
    names = trace_run(torch, "decode-step replay", replay)
    n = sum(c for by in names.values() for c in by.values())
    log(f"[trace]   decode-step replay: {n} kernel launches")
    ours = [c for c in names if "(this repo)" in c]
    if ours or not names.get("matmul (cuBLAS)"):
        raise RuntimeError(f"decode-step replay: kernel classes "
                           f"{sorted(names)}; expected cuBLAS products "
                           f"and none of this repo's")


def block_breakdown(torch, bf16=False, chain=None, gemm_path=None):
    """The block forward's launches at the training shape (B 32, T 512,
    H 8, D = E 512, F 2048), f32 or (bf16) the AMP inputs, the bf16
    block's GEMMs on `gemm_path` (None: its own choice): each kernel's
    device time over one call from torch.profiler, and the GEMM kernels'
    TFLOP/s of their work: {kernel name: {"ms", "launches"(, "tflops")}}.
    On the wgmma path the log also gives each GEMM's tiles and CTAs as the
    library plans them (fused_block.block_gemm_plan_of_library), not as
    the trace records them.  chain is the launches one call makes; a record
    with fewer is traced again."""
    from paddle_tpu_torch.kernels import fused_block as fb
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    B, T, H, D, FF = TRAIN_BATCH, TRAIN_T, 8, 512, 2048
    N = B * T
    x, params = block_inputs(
        lambda *s: torch.randn(*s, generator=g, device=DEVICE), B, T, D, FF)
    if bf16:
        x, params = x.to(torch.bfloat16), bf16_block_params(params)
        call = functools.partial(fb.transformer_block_bf16, x, params, H,
                                 True, gemm_path=gemm_path)
    else:
        call = functools.partial(fb.transformer_block, x, params, H, True)
    events, _ = profiled(
        torch, call,
        lost=lambda ev: None if _device_launches(torch, ev) >= (chain or 1)
        else f"{_device_launches(torch, ev)} launches, expected {chain}")
    # FLOP of block_gemm(_bf16)(_wg)_kernel<EPI>: q/k/v, Wo, W1, W2
    gemm_flops = {0: 2 * N * D * 3 * D, 1: 2 * N * D * D, 2: 2 * N * D * FF,
                  3: 2 * N * FF * D}
    plans = [fb.block_gemm_plan_of_library(*dims) for dims in
             fb.block_gemm_launches(B, T, D, D, FF).values()]
    res, epis = {}, {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        row = dict(ms=ms, launches=e.count)
        if "_kernel<" in e.key and "block_gemm" in e.key:
            epi = int(e.key.split("_kernel<")[1][0])
            row["tflops"] = gemm_flops[epi] / ms / 1e9
            if "_wg_kernel" in e.key:
                epis[_short_kernel_name(e.key)] = epi
        res[_short_kernel_name(e.key)] = row
    total = sum(r["ms"] for r in res.values())
    gemms = f", GEMMs on {gemm_path or 'the chosen path'}" if bf16 else ""
    log(f"[block] one {'bf16 ' if bf16 else ''}block forward B={B} T={T} "
        f"H={H} D={D} F={FF}{gemms}: "
        f"{sum(r['launches'] for r in res.values())} launches, {total:.4f} "
        f"ms of device time")
    for name, r in res.items():
        rate = f", {r['tflops']:.2f} TFLOP/s" if "tflops" in r else ""
        if name in epis:
            plan = plans[epis[name]]
            rate += (f", {plan['tiles']} tiles on {plan['ctas']} CTAs as "
                     f"the library plans them")
        log(f"[block]   {name}: {r['ms']:.4f} ms ({r['launches']} "
            f"launches{rate})")
    return res


def head_breakdown(torch, launches):
    """The bf16 LM head's launches at the training shape (N 16384, D 512,
    V 32000, chunk 4096): one forward and one backward, each on the wgmma
    path and on the sync path (the first design): each kernel's device time
    over one call from torch.profiler, and the product kernels' TFLOP/s of
    their work (2 N D V FLOP the forward's, 2 C D V a backward launch):
    {direction ("fwd", "bwd"): {path: {kernel name: {"ms", "launches"(,
    "tflops")}}}}.  launches maps each path to the launches one backward
    makes there (a forward makes HEAD_FWD_KERNELS on either); a record with
    fewer is traced again."""
    from paddle_tpu_torch.kernels import lm_head as lmh
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    N, D, V, C = TRAIN_BATCH * TRAIN_T, 512, 32000, HEAD_CHUNK
    x = torch.randn(N, D, generator=g, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn(D, V, generator=g, device=DEVICE) * 0.05).to(
        torch.bfloat16)
    y = torch.randint(0, V, (N,), generator=g, device=DEVICE)
    gl = torch.full((N,), 1.0 / N, device=DEVICE)
    lse = lmh.lm_head_fwd_bf16(x, w, y)[1]
    res = {"fwd": {}, "bwd": {}}
    for d, key, flops, merges in (("fwd", "lm_head_fwd", 2 * N * D * V,
                                   ("merge",)),
                                  ("bwd", "lm_head_bwd", 2 * C * D * V,
                                   ("reduce",))):
        for path in ("wgmma", "sync"):
            need = HEAD_FWD_KERNELS if d == "fwd" else launches[path]
            call = (functools.partial(lmh.lm_head_fwd_bf16, x, w, y,
                                      path=path) if d == "fwd" else
                    functools.partial(lmh.lm_head_bwd_bf16, x, w, y, lse,
                                      gl, C, path=path))
            events, _ = profiled(
                torch, call,
                lost=lambda ev: None
                if _device_launches(torch, ev, key) >= need else
                f"{_device_launches(torch, ev, key)} {key} launches, "
                f"expected {need}")
            rows = {}
            for e in events:
                if e.device_type != torch.autograd.DeviceType.CUDA \
                        or e.self_device_time_total <= 0 \
                        or key not in e.key:
                    continue
                ms = e.self_device_time_total / 1e3
                row = dict(ms=ms, launches=e.count)
                if not any(k in e.key for k in merges):   # the products
                    row["tflops"] = flops * e.count / ms / 1e9
                rows[_short_kernel_name(e.key)] = row
            total = sum(r["ms"] for r in rows.values())
            work = flops if d == "fwd" else 3 * flops * (N // C)
            what = "forward" if d == "fwd" else "backward"
            log(f"[head] one bf16 LM-head {what} N={N} D={D} V={V}"
                f"{'' if d == 'fwd' else f' chunk {C}'}, {path} path: "
                f"{sum(r['launches'] for r in rows.values())} launches, "
                f"{total:.4f} ms of device time "
                f"({work / total / 1e9:.1f} TFLOP/s)")
            for name, r in rows.items():
                rate = f", {r['tflops']:.1f} TFLOP/s" if "tflops" in r else ""
                log(f"[head]   {name}: {r['ms']:.4f} ms ({r['launches']} "
                    f"launches{rate})")
            res[d][path] = rows
    return res


def flash_bwd_breakdown(torch):
    """The bf16 head-major flash backward's two launches at the training
    shape (B 32, H 8, T 512, d 64, causal) on each path: each kernel's
    device time over one call from torch.profiler and its TFLOP/s on the
    work it issues (dk/dv: s, dp, dv and dk, 8 d FLOP a kept pair; dq: s,
    dp and dq, 6 d): {path: {kernel name: {"ms", "launches", "tflops"}}}.
    A record with fewer than two flash_bwd launches is traced again; where
    the tracer loses them PROFILE_TRIES times (it did, in one process, on
    the card), the path's split is logged as not measured and left out:
    it is a measurement, and the path counters and the step traces check
    the launches."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    H, d, B, T = 8, 64, TRAIN_BATCH, TRAIN_T
    q, k, v, do = (torch.randn(H, d, B * T, generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_hdt_bf16(q, k, v, B, causal=True)
    delta = (do.float() * o.float()).sum(1, keepdim=True)
    pairs = B * H * T * (T + 1) // 2
    res = {}
    for path in ("wgmma", "sync"):
        try:
            events, _ = profiled(
                torch, lambda: fa.flash_attention_hdt_bwd_bf16(
                    q, k, v, lse, delta, do, B, causal=True, path=path),
                lost=lambda ev: None
                if _device_launches(torch, ev, "flash_bwd") >= 2 else
                f"{_device_launches(torch, ev, 'flash_bwd')} flash_bwd "
                f"launches, expected 2")
        except RuntimeError as e:
            log(f"[flash bwd] {path} path: not measured ({e})")
            continue
        rows = {}
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CUDA \
                    or e.self_device_time_total <= 0 \
                    or "flash_bwd" not in e.key:
                continue
            ms = e.self_device_time_total / 1e3
            per_pair = 8 * d if "dkv" in e.key else 6 * d
            rows[_short_kernel_name(e.key)] = dict(
                ms=ms, launches=e.count,
                tflops=per_pair * pairs * e.count / ms / 1e9)
        total = sum(r["ms"] for r in rows.values())
        log(f"[flash bwd] one bf16 flash backward H={H} d={d} B={B} T={T} "
            f"causal, {path} path: {total:.4f} ms of device time "
            f"({10 * d * pairs / total / 1e9:.1f} TFLOP/s of the 10 d work)")
        for name, r in rows.items():
            log(f"[flash bwd]   {name}: {r['ms']:.4f} ms ({r['launches']} "
                f"launches, {r['tflops']:.1f} TFLOP/s of its issued work)")
        res[path] = rows
    return res


def sdpa_kernels(torch, dtype=None):
    """The kernels PyTorch's SDPA launches at the training shape (B 32, H 8,
    T 512, d 64, causal, TF32 off), f32 or in dtype, forward and backward
    apart, from torch.profiler: {"fwd": {name: device ms}, "bwd": {...}}.
    It shows on the card which kernel the yardstick is (expected in f32:
    CUTLASS's memory-efficient fmha on the TF32 tensor cores in 3 passes;
    in bf16: a flash-attention kernel)."""
    import torch.nn.functional as F
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    q, k, v, do = (torch.randn(TRAIN_BATCH, 8, TRAIN_T, 64, generator=g,
                               device=DEVICE).to(dtype or torch.float32)
                   for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    calls = {
        "fwd": lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True),
        "bwd": lambda: torch.autograd.grad(o, (q, k, v), do,
                                           retain_graph=True)}
    res = {}
    for what, fn in calls.items():
        events, _ = profiled(torch, fn)
        res[what] = {e.key: e.self_device_time_total / 1e3
                     for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0}
        for name, ms in res[what].items():
            log(f"[sdpa] {str(dtype or torch.float32)[6:]} {what}: {name} "
                f"{ms:.4f} ms")
    return res


def phase_timings(torch):
    """The serving and training paths' kernels at their shapes, cold:
    every timed call (kernel, plain and library alike) takes its
    activations from a rotation() of input sets larger than the L2
    together; weights stay."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import lm_head as lmh
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    res = {}

    # layer norm and flash forward at both paths' shapes: the training
    # step's batch 32 and a served batch 8, T 512.  The layer-norm inputs
    # rotate over 8 buffers (64 MiB or more).
    gam = torch.randn(512, generator=g, device=dev)
    bet = torch.randn(512, generator=g, device=dev)
    for path, B in (("train", TRAIN_BATCH), ("serve", 8)):
        N, D = B * TRAIN_T, 512
        rot = rotation(lambda: torch.randn(N, D, generator=g, device=dev), 8)
        ms, host = time_ms(lambda: ln.layer_norm(rot(), gam, bet, 1e-5))
        plain, plain_host = time_ms(
            lambda: ln.layer_norm_plain(rot(), gam, bet, 1e-5))
        lib, lib_host = time_ms(lambda: F.layer_norm(rot(), (D,), gam, bet,
                                                     1e-5))
        del rot
        nbytes = 2 * N * D * 4 + 2 * D * 4 + 2 * N * 4
        ops = 8 * N * D
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        res.setdefault("layer_norm", {})[path] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
            bound_by="bytes")
        log(f"[time] layer_norm ({path}) N={N} D={D} f32: kernel {ms:.4f} "
            f"ms, plain {plain:.4f} ms, F.layer_norm {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s); host enqueue per call: "
            f"wrapper {host:.4f} ms, plain {plain_host:.4f} ms, "
            f"F.layer_norm {lib_host:.4f} ms")

    H, d, T = 8, 64, TRAIN_T

    def bhtd_b(x, batch):
        return x.reshape(H, d, batch, T).permute(2, 0, 3, 1).contiguous()

    # flash forward: q, k, v rotate over ROTATE sets (96 MiB a set at B 32,
    # 24 MiB at B 8), the head-major ones and SDPA's [B, H, T, d] copies
    for path, B in (("train", TRAIN_BATCH), ("serve", 8)):
        def make():
            qkv = [torch.randn(H, d, B * T, generator=g, device=dev)
                   for _ in range(3)]
            return qkv, [bhtd_b(x, B) for x in qkv]

        rot = rotation(make)
        ms, host = time_ms(lambda: fa.flash_attention_hdt(*rot()[0], B,
                                                          causal=True))
        plain, _ = time_ms(lambda: fa.flash_attention_hdt_plain(
            *rot()[0], B, causal=True), iters=10)
        lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
            *rot()[1], is_causal=True))
        del rot
        pairs = B * H * T * (T + 1) // 2      # (query, key) pairs kept
        ops = 4 * d * pairs                   # q.k and p.v, 2 FLOP/MAC
        nbytes = 4 * (4 * H * d * B * T + H * B * T)
        extra = tc_bounds(ops, nbytes, ms)
        res.setdefault("flash_attention_hdt", {})[path] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_by="operations",
            **extra)
        log(f"[time] flash_attention_hdt ({path}) H={H} d={d} B={B} T={T} "
            f"causal f32, cold: kernel {ms:.4f} ms ({ops / ms / 1e9:.2f} "
            f"TFLOP/s), plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{extra['bound_ms']:.4f} ms ({ops / 1e9:.3f} GFLOP in 3xTF32 "
            f"at {TF32_FLOPS_PER_S / 1e12:g} TFLOP/s), f32 SIMT bound "
            f"{extra['simt_bound_ms']:.4f} ms; host enqueue per call "
            f"{host:.4f} ms")

    # flash backward at the training path's shape: B 32; each set carries
    # its forward's o-derived delta and lse, and SDPA's graph of its own
    B = TRAIN_BATCH

    def make_bwd():
        q, k, v, do = (torch.randn(H, d, B * T, generator=g, device=dev)
                       for _ in range(4))
        o, lse = fa.flash_attention_hdt(q, k, v, B, causal=True)
        delta = (do * o).sum(1, keepdim=True)
        q4, k4, v4 = (bhtd_b(x, B).requires_grad_() for x in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        return (q, k, v, lse, delta, do), (o4, (q4, k4, v4), bhtd_b(do, B))

    rot = rotation(make_bwd)
    ms, host = time_ms(lambda: fa.flash_attention_hdt_bwd(
        *rot()[0], B, causal=True), iters=20, warmup=2)
    plain, _ = time_ms(lambda: fa.flash_attention_hdt_bwd_plain(
        *rot()[0], B, causal=True), iters=5, warmup=1)

    def lib_bwd():
        o4, ins, do4 = rot()[1]
        return torch.autograd.grad(o4, ins, do4, retain_graph=True)

    lib, _ = time_ms(lib_bwd, iters=20, warmup=2)
    del rot
    pairs = B * H * T * (T + 1) // 2
    ops = 10 * d * pairs                      # 5 d-long products per pair
    nbytes = 4 * (7 * H * d * B * T + 2 * H * B * T)
    extra = tc_bounds(ops, nbytes, ms)
    res["flash_attention_hdt_bwd"] = {"train": dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_by="operations",
        **extra)}
    log(f"[time] flash_attention_hdt_bwd H={H} d={d} B={B} T={T} causal "
        f"f32, cold: kernel {ms:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s of the "
        f"least work; the kernels do 7/5 of it), plain {plain:.4f} ms, "
        f"sdpa backward {lib:.4f} ms, bound {extra['bound_ms']:.4f} ms "
        f"({ops / 1e9:.3f} GFLOP in 3xTF32 at "
        f"{TF32_FLOPS_PER_S / 1e12:g} TFLOP/s), f32 SIMT bound "
        f"{extra['simt_bound_ms']:.4f} ms; host enqueue per call "
        f"{host:.4f} ms")

    # LM head at the training path's shape: N = 32 x 512 tokens, D 512,
    # V 32000; the loss cotangent is 1/N, as the op's mean gives it.  x
    # (32 MiB) rotates with its lse; W (62.5 MiB) exceeds the L2 itself
    N, D, V = TRAIN_BATCH * TRAIN_T, 512, 32000
    w = torch.randn(D, V, generator=g, device=dev) * 0.05
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    gl = torch.full((N,), 1.0 / N, device=dev)

    def make_head():
        x = torch.randn(N, D, generator=g, device=dev)
        return x, lmh.lm_head_fwd(x, w, y)[1]

    rot = rotation(make_head)
    x, lse = rot()
    # each kernel's peak device memory over one call, above what was
    # allocated before it (its outputs and workspace)
    peak = {}
    for n, call in (("lm_head_fwd", lambda: lmh.lm_head_fwd(x, w, y)),
                    ("lm_head_bwd", lambda: lmh.lm_head_bwd(x, w, y, lse, gl,
                                                            HEAD_CHUNK))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak[n] = (torch.cuda.max_memory_allocated() - base) / 2**20
    fms, fhost = time_ms(lambda: lmh.lm_head_fwd(rot()[0], w, y), iters=5,
                         warmup=1)
    fplain, _ = time_ms(lambda: lmh.lm_head_fwd_plain(rot()[0], w, y),
                        iters=5, warmup=1)
    flib, _ = time_ms(lambda: F.cross_entropy(
        torch.matmul(rot()[0], w), y, reduction="none"), iters=5, warmup=1)

    def head_bwd(bwd):
        x_, lse_ = rot()
        return bwd(x_, w, y, lse_, gl, HEAD_CHUNK)

    bms, bhost = time_ms(lambda: head_bwd(lmh.lm_head_bwd), iters=3,
                         warmup=1)
    bplain, _ = time_ms(lambda: head_bwd(lmh.lm_head_bwd_plain), iters=3,
                        warmup=1)

    def make_lib():
        xg, wg = rot()[0].clone().requires_grad_(), w.clone().requires_grad_()
        return F.cross_entropy(torch.matmul(xg, wg), y, reduction="none"), \
            (xg, wg)

    lib_rot = rotation(make_lib)

    def lib_bwd():
        ce, ins = lib_rot()
        return torch.autograd.grad(ce, ins, gl, retain_graph=True)

    blib, _ = time_ms(lib_bwd, iters=3, warmup=1)
    del rot, lib_rot
    fops = 2 * N * D * V
    fbytes = 4 * (N * D + D * V) + 8 * N + 2 * 4 * N
    bbytes = 4 * (2 * N * D + 2 * D * V) + 8 * N + 2 * 4 * N
    fb = tc_bounds(fops, fbytes, fms)
    bb = tc_bounds(3 * fops, bbytes, bms)
    res["lm_head_fwd"] = {"train": dict(
        ms=fms, plain_ms=fplain, library_ms=flib, bound_by="operations",
        **fb, peak_mib=peak["lm_head_fwd"])}
    res["lm_head_bwd"] = {"train": dict(
        ms=bms, plain_ms=bplain, library_ms=blib, bound_by="operations",
        **bb, peak_mib=peak["lm_head_bwd"])}
    log(f"[time] lm_head_fwd N={N} D={D} V={V} f32, cold: kernel {fms:.3f} "
        f"ms ({fops / fms / 1e9:.2f} TFLOP/s), plain {fplain:.3f} ms, matmul "
        f"+ F.cross_entropy {flib:.3f} ms, bound {fb['bound_ms']:.3f} ms "
        f"({fops / 1e9:.1f} GFLOP in 3xTF32), f32 SIMT bound "
        f"{fb['simt_bound_ms']:.3f} ms; host enqueue per call "
        f"{fhost:.4f} ms; peak device memory over a call "
        f"{peak['lm_head_fwd']:.1f} MiB above its inputs")
    log(f"[time] lm_head_bwd N={N} D={D} V={V} chunk {HEAD_CHUNK} f32, "
        f"cold: kernel {bms:.3f} ms ({3 * fops / bms / 1e9:.2f} TFLOP/s), "
        f"plain {bplain:.3f} ms, autograd of matmul + F.cross_entropy "
        f"{blib:.3f} ms, bound {bb['bound_ms']:.3f} ms "
        f"({3 * fops / 1e9:.1f} GFLOP in 3xTF32), f32 SIMT bound "
        f"{bb['simt_bound_ms']:.3f} ms; host enqueue per call "
        f"{bhost:.4f} ms; peak device memory over a call "
        f"{peak['lm_head_bwd']:.1f} MiB above its inputs")
    return res


def phase_timings_amp(torch):
    """The AMP path's kernels at the training step's shapes, in bf16, cold
    as in phase_timings (activations rotate over sets larger than the L2):
    the four bf16 kernels and layer norm on bf16 rows, each beside its
    plain version and the library call on the same bf16 inputs (SDPA
    forward and backward; matmul + F.cross_entropy and its autograd;
    F.layer_norm), with its bound at the bf16 tensor-core peak or the
    bytes."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import lm_head as lmh
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    res = {}
    # layer norm on bf16 rows: y bf16, mean and rstd f32; the path the rows
    # choose (v16) and the scalar path forced, in turns (chosen, scalar,
    # scalar, chosen), each with its host enqueue
    N, D = TRAIN_BATCH * TRAIN_T, 512
    gam = torch.randn(D, generator=g, device=dev)
    bet = torch.randn(D, generator=g, device=dev)
    rot = rotation(lambda: rnd(N, D), 8)
    runs = {}
    for path in (None, "scalar", "scalar", None):
        ms, host, took = timed_on_path(
            ln.layer_norm, lambda p: ln.layer_norm(rot(), gam, bet, 1e-5,
                                                   path=p),
            path, paths=ln.BF16_PATHS)
        runs.setdefault(path, []).append((ms, host, took))
    plain, _ = time_ms(lambda: ln.layer_norm_plain(rot(), gam, bet, 1e-5))
    lib, _ = time_ms(lambda: F.layer_norm(rot(), (D,), gam.to(bf),
                                          bet.to(bf), 1e-5))
    del rot
    (ms, host, took), (ms2, host2, _) = runs[None]
    (sms_, shost, _), (sms2, shost2, _) = runs["scalar"]
    if took != "v16":
        raise RuntimeError(f"the training rows took the {took} path")
    nbytes = 2 * 2 * N * D + 2 * 4 * D + 2 * 4 * N
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    res["layer_norm"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
        bound_by="bytes", path=took, path_ms=[ms, ms2],
        host_ms=[host, host2], scalar_ms=sms_, scalar_path_ms=[sms_, sms2],
        scalar_host_ms=[shost, shost2])
    log(f"[time amp] layer_norm N={N} D={D} bf16: kernel ({took} path) "
        f"{ms:.4f} / {ms2:.4f} ms ({100 * bound / ms:.1f} % of the bound), "
        f"scalar path {sms_:.4f} / {sms2:.4f} ms, plain {plain:.4f} ms, "
        f"F.layer_norm (bf16 gamma, beta) {lib:.4f} ms, bound {bound:.4f} "
        f"ms ({nbytes / 1e6:.1f} MB); host enqueue per call: {took} "
        f"{host:.4f} / {host2:.4f} ms, scalar {shost:.4f} / {shost2:.4f} ms")

    # flash forward and backward, head-major, B 32, T 512, H 8, d 64
    H, d, B, T = 8, 64, TRAIN_BATCH, TRAIN_T

    def bhtd(x):
        return x.reshape(H, d, B, T).permute(2, 0, 3, 1).contiguous()

    def make():
        q, k, v, do = (rnd(H, d, B * T) for _ in range(4))
        o, lse = fa.flash_attention_hdt_bf16(q, k, v, B, causal=True)
        delta = (do.float() * o.float()).sum(1, keepdim=True)
        q4, k4, v4 = (bhtd(x).requires_grad_() for x in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        return (q, k, v, lse, delta, do), (o4, (q4, k4, v4), bhtd(do))

    rot = rotation(make)
    hdt = fa.flash_attention_hdt_bf16

    def hdt_call(path):
        return hdt(*rot()[0][:3], B, causal=True, path=path)

    fms, fhost, fpath = timed_on_path(hdt, hdt_call, None)
    # the same kernels forced onto the sync path (the parent's design)
    fsync, fsync_host, _ = timed_on_path(hdt, hdt_call, "sync")
    fplain, _ = time_ms(lambda: fa.flash_attention_hdt_plain(
        *rot()[0][:3], B, causal=True), iters=10)
    flib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        *(t.detach() for t in rot()[1][1]), is_causal=True))
    bwd16 = fa.flash_attention_hdt_bwd_bf16

    def bwd_call(path):
        return bwd16(*rot()[0], B, causal=True, path=path)

    bms, bhost, bpath = timed_on_path(bwd16, bwd_call, None, iters=20,
                                      warmup=2)
    # the same kernels forced onto the sync path (the parent's design)
    bsync, bsync_host, _ = timed_on_path(bwd16, bwd_call, "sync", iters=20,
                                         warmup=2)
    bplain, _ = time_ms(lambda: fa.flash_attention_hdt_bwd_plain(
        *rot()[0], B, causal=True), iters=5, warmup=1)

    def lib_bwd():
        o4, ins, do4 = rot()[1]
        return torch.autograd.grad(o4, ins, do4, retain_graph=True)

    blib, _ = time_ms(lib_bwd, iters=20, warmup=2)
    del rot
    pairs = B * H * T * (T + 1) // 2
    n = H * d * B * T
    fops, fbytes = 4 * d * pairs, 2 * 4 * n + 4 * H * B * T
    bops, bbytes = 10 * d * pairs, 2 * 7 * n + 2 * 4 * H * B * T
    res["flash_attention_hdt_bf16"] = dict(
        ms=fms, plain_ms=fplain, library_ms=flib, path=fpath, sync_ms=fsync,
        host_ms=fhost, sync_host_ms=fsync_host,
        **bf16_bounds(fops, fbytes, fms))
    res["flash_attention_hdt_bwd_bf16"] = dict(
        ms=bms, plain_ms=bplain, library_ms=blib, path=bpath, sync_ms=bsync,
        host_ms=bhost, sync_host_ms=bsync_host,
        **bf16_bounds(bops, bbytes, bms))
    for name, ms_, plain_, lib_, host_, ops, nb, what in (
            ("flash_attention_hdt_bf16", fms, fplain, flib, fhost, fops,
             fbytes, "sdpa"),
            ("flash_attention_hdt_bwd_bf16", bms, bplain, blib, bhost, bops,
             bbytes, "sdpa backward")):
        r = res[name]
        log(f"[time amp] {name} H={H} d={d} B={B} T={T} causal bf16, "
            f"cold: kernel {ms_:.4f} ms ({r['tflops']:.2f} TFLOP/s), plain "
            f"{plain_:.4f} ms, {what} (bf16) {lib_:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({ops / 1e9:.3f} "
            f"GFLOP at {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s, {nb / 1e6:.1f} "
            f"MB at {HBM_BYTES_PER_S / 1e12:g} TB/s); host enqueue per "
            f"call {host_:.4f} ms")
    log(f"[time amp] flash_attention_hdt_bf16 took the {fpath} path; the "
        f"sync path on the same inputs {fsync:.4f} ms "
        f"({fops / fsync / 1e9:.2f} TFLOP/s), host enqueue per call "
        f"{fsync_host:.4f} ms")
    log(f"[time amp] flash_attention_hdt_bwd_bf16 took the {bpath} path; "
        f"the sync path on the same inputs {bsync:.4f} ms "
        f"({bops / bsync / 1e9:.2f} TFLOP/s), host enqueue per call "
        f"{bsync_host:.4f} ms")

    # the LM head, N 16384, D 512, V 32000, chunk 4096: x (16 MiB) and W
    # (31 MiB in bf16, which would stay in the 50 MiB L2) rotate with their
    # lse, as training casts a fresh bf16 W each step
    N, D, V = TRAIN_BATCH * TRAIN_T, 512, 32000
    y = torch.randint(0, V, (N,), generator=g, device=dev)
    gl = torch.full((N,), 1.0 / N, device=dev)

    def make_head():
        x, w_ = rnd(N, D), rnd(D, V, scale=0.05)
        return x, w_, lmh.lm_head_fwd_bf16(x, w_, y)[1]

    rot = rotation(make_head)
    x, w, lse = rot()
    peak = {}
    for name, call in (("lm_head_fwd_bf16",
                        lambda: lmh.lm_head_fwd_bf16(x, w, y)),
                       ("lm_head_bwd_bf16",
                        lambda: lmh.lm_head_bwd_bf16(x, w, y, lse, gl,
                                                     HEAD_CHUNK))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
    fwd16 = lmh.lm_head_fwd_bf16

    def fwd_call(path):
        return fwd16(*rot()[:2], y, path=path)

    fms, fhost, fpath = timed_on_path(fwd16, fwd_call, None, iters=10,
                                      warmup=2)
    # the same inputs forced onto the sync path (the first design)
    fsync, fsync_host, _ = timed_on_path(fwd16, fwd_call, "sync", iters=10,
                                         warmup=2)
    fplain, _ = time_ms(lambda: lmh.lm_head_fwd_plain(*rot()[:2], y),
                        iters=5, warmup=1)
    flib, _ = time_ms(lambda: F.cross_entropy(
        torch.matmul(*rot()[:2]), y, reduction="none"), iters=5, warmup=1)

    def head_bwd(bwd):
        x_, w_, lse_ = rot()
        return bwd(x_, w_, y, lse_, gl, HEAD_CHUNK)

    def timed_path(path):
        """the bf16 backward on the rotated inputs on `path`"""
        bwd = lmh.lm_head_bwd_bf16
        return timed_on_path(bwd, lambda p: head_bwd(functools.partial(
            bwd, path=p)), path, iters=5, warmup=1)

    bms, bhost, bpath = timed_path(None)
    # the same kernels forced onto the sync path (the parent's design)
    bsync, _, _ = timed_path("sync")
    bplain, _ = time_ms(lambda: head_bwd(lmh.lm_head_bwd_plain), iters=3,
                        warmup=1)

    def make_lib():
        xg, wg = (t.clone().requires_grad_() for t in rot()[:2])
        return F.cross_entropy(torch.matmul(xg, wg), y, reduction="none"), \
            (xg, wg)

    lib_rot = rotation(make_lib)

    def lib_bwd_head():
        ce, ins = lib_rot()
        return torch.autograd.grad(ce, ins, gl, retain_graph=True)

    blib, _ = time_ms(lib_bwd_head, iters=3, warmup=1)
    del rot, lib_rot
    fops = 2 * N * D * V
    fbytes = 2 * (N * D + D * V) + 8 * N + 2 * 4 * N
    bbytes = 2 * (2 * N * D + 2 * D * V) + 8 * N + 2 * 4 * N
    res["lm_head_fwd_bf16"] = dict(ms=fms, plain_ms=fplain, library_ms=flib,
                                   peak_mib=peak["lm_head_fwd_bf16"],
                                   path=fpath, sync_ms=fsync, host_ms=fhost,
                                   sync_host_ms=fsync_host,
                                   **bf16_bounds(fops, fbytes, fms))
    res["lm_head_bwd_bf16"] = dict(ms=bms, plain_ms=bplain, library_ms=blib,
                                   peak_mib=peak["lm_head_bwd_bf16"],
                                   path=bpath, sync_ms=bsync,
                                   **bf16_bounds(3 * fops, bbytes, bms))
    for name, ms_, plain_, lib_, host_, ops, what in (
            ("lm_head_fwd_bf16", fms, fplain, flib, fhost, fops,
             "matmul + F.cross_entropy"),
            ("lm_head_bwd_bf16", bms, bplain, blib, bhost, 3 * fops,
             "autograd of matmul + F.cross_entropy")):
        r = res[name]
        log(f"[time amp] {name} N={N} D={D} V={V} chunk {HEAD_CHUNK} bf16, "
            f"cold: kernel {ms_:.3f} ms ({r['tflops']:.2f} TFLOP/s), plain "
            f"{plain_:.3f} ms, {what} (bf16) {lib_:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms by {r['bound_by']} ({ops / 1e9:.1f} "
            f"GFLOP at {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s); host enqueue "
            f"per call {host_:.4f} ms; peak device memory over a call "
            f"{peak[name]:.1f} MiB above its inputs")
    log(f"[time amp] lm_head_fwd_bf16 took the {fpath} path; the sync path "
        f"(gemm_bf16.cuh's loop) on the same inputs {fsync:.3f} ms "
        f"({fops / fsync / 1e9:.1f} TFLOP/s), host enqueue per call "
        f"{fsync_host:.4f} ms")
    log(f"[time amp] lm_head_bwd_bf16 took the {bpath} path; the sync path "
        f"(gemm_bf16.cuh's loop) on the same inputs {bsync:.3f} ms "
        f"({3 * fops / bsync / 1e9:.1f} TFLOP/s)")
    return res


def phase_timings_fused(torch):
    """The fuse-block path's kernels at its shapes (B 32, T 512, H 8,
    d 64, D 512, F 2048), cold as in phase_timings: the [B, H, T, d] flash
    forward and backward as the block's recompute calls them (q, k, v and
    do as [B, T, H, d] views of [B, T, E] tensors, token stride E), beside
    the contiguous [B, H, T, d] call (token stride d) and the head-major
    call on the same data, which is the cost of the strided staging; and
    the block forward, cold and warm (one x), beside
    torch.nn.TransformerEncoderLayer as its library yardstick, whose output
    is first held against the plain version."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_block as fb
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    B, T, H, d, D, FF = TRAIN_BATCH, TRAIN_T, 8, 64, 512, 2048
    scale = 1.0 / math.sqrt(d)
    (fops, fbytes), (bops, bbytes) = flash_work(B, H, T, d)

    def make():
        """One input set in the three layouts: name -> (q, k, v, do, o,
        lse, delta), the last three for the backward."""
        q, k, v, do = (bthd_view(rnd(B, T, H * d), H) for _ in range(4))
        sets = {"bthd": (q, k, v, do),
                "bhtd": tuple(t.contiguous() for t in (q, k, v, do))}
        out = {}
        for name, (q_, k_, v_, do_) in sets.items():
            o_, lse_ = fa._launch_bhtd(q_, k_, v_, True, scale)
            out[name] = (q_, k_, v_, do_, o_, lse_, (do_ * o_).sum(-1))
        qh, kh, vh, doh = map(head_major, sets["bhtd"])
        oh, lseh = fa.flash_attention_hdt(qh, kh, vh, B, causal=True)
        out["head-major"] = (qh, kh, vh, doh, oh, lseh,
                             (doh * oh).sum(1, keepdim=True))
        return out

    rot = rotation(make)

    def fwd_call(name):
        q_, k_, v_ = rot()[name][:3]
        if name == "head-major":
            return fa.flash_attention_hdt(q_, k_, v_, B, causal=True)
        return fa.flash_attention(q_, k_, v_, causal=True)

    def bwd_call(name, fn=None):
        q_, k_, v_, do_, _, lse_, delta_ = rot()[name]
        if name == "head-major":
            return fa.flash_attention_hdt_bwd(q_, k_, v_, lse_, delta_, do_,
                                              B, causal=True)
        return (fn or fa.flash_attention_bwd)(q_, k_, v_, lse_, delta_, do_,
                                              True)

    fwd, bwd, host = {}, {}, {}
    for name in ("bthd", "bhtd", "head-major"):
        fwd[name], host[name] = time_ms(lambda: fwd_call(name))
        bwd[name], host[name + " bwd"] = time_ms(lambda: bwd_call(name),
                                                 iters=20, warmup=2)
    fplain, _ = time_ms(lambda: fa.flash_attention_plain(
        *rot()["bthd"][:3], True), iters=10)
    bplain, _ = time_ms(lambda: bwd_call("bthd", fa.flash_attention_bwd_plain),
                        iters=5, warmup=1)
    flib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        *rot()["bhtd"][:3], is_causal=True))
    del rot

    def make_lib():
        qg, kg, vg, doc = (rnd(B, H, T, d) for _ in range(4))
        qg, kg, vg = (t.requires_grad_() for t in (qg, kg, vg))
        return (F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
                (qg, kg, vg), doc)

    lib_rot = rotation(make_lib)

    def lib_bwd():
        og, ins, doc = lib_rot()
        return torch.autograd.grad(og, ins, doc, retain_graph=True)

    blib, _ = time_ms(lib_bwd, iters=20, warmup=2)
    del lib_rot
    res = {
        "flash_attention": {"train": dict(
            ms=fwd["bthd"], plain_ms=fplain, library_ms=flib,
            bound_by="operations", contiguous_bhtd_ms=fwd["bhtd"],
            head_major_ms=fwd["head-major"],
            **tc_bounds(fops, fbytes, fwd["bthd"]))},
        "flash_attention_bwd": {"train": dict(
            ms=bwd["bthd"], plain_ms=bplain, library_ms=blib,
            bound_by="operations", contiguous_bhtd_ms=bwd["bhtd"],
            head_major_ms=bwd["head-major"],
            **tc_bounds(bops, bbytes, bwd["bthd"]))}}
    for n, ops, times, plain, lib, what in (
            ("flash_attention", fops, fwd, fplain, flib, "sdpa"),
            ("flash_attention_bwd", bops, bwd, bplain, blib,
             "sdpa backward")):
        log(f"[time] {n} [B,H,T,d] H={H} d={d} B={B} T={T} causal f32, "
            f"cold: kernel on the block recompute's [B,T,H,d] views (token "
            f"stride {H * d}) {times['bthd']:.4f} ms ({ops / times['bthd'] / 1e9:.2f} "
            f"TFLOP/s), on contiguous [B,H,T,d] (token stride {d}) "
            f"{times['bhtd']:.4f} ms, the head-major call (token stride 1) "
            f"{times['head-major']:.4f} ms; plain {plain:.4f} ms, {what} "
            f"{lib:.4f} ms, bound {res[n]['train']['bound_ms']:.4f} ms "
            f"({ops / 1e9:.3f} GFLOP in 3xTF32), f32 SIMT bound "
            f"{res[n]['train']['simt_bound_ms']:.4f} ms; host enqueue per call "
            f"{host['bthd' if n == 'flash_attention' else 'bthd bwd']:.4f} ms")

    # the block forward: x (32 MiB) rotates over ROTATE buffers for the
    # kernel, the plain version and the library layer alike; the weights
    # stay (12.6 MB)
    x, params = block_inputs(rnd, B, T, D, FF)
    rot = rotation(lambda: rnd(B, T, D))
    ms, bhost = time_ms(lambda: fb.transformer_block(rot(), params, H, True),
                        iters=10, warmup=2)
    warm, _ = time_ms(lambda: fb.transformer_block(x, params, H, True),
                      iters=10, warmup=2)
    plain, _ = time_ms(lambda: fb.transformer_block_plain(rot(), params, H,
                                                          True),
                       iters=5, warmup=1)
    layer = torch.nn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0, activation="relu", batch_first=True,
        norm_first=True, device=dev).eval()
    ln1g, ln1b, wq, wk, wv, wo, ln2g, ln2b, w1, b1, w2, b2 = params
    with torch.no_grad():
        sa = layer.self_attn
        sa.in_proj_weight.copy_(torch.cat([wq, wk, wv], 1).t())
        sa.in_proj_bias.zero_()
        sa.out_proj.weight.copy_(wo.t())
        sa.out_proj.bias.zero_()
        for mod, w_, b_ in ((layer.linear1, w1.t(), b1),
                            (layer.linear2, w2.t(), b2),
                            (layer.norm1, ln1g, ln1b),
                            (layer.norm2, ln2g, ln2b)):
            mod.weight.copy_(w_)
            mod.bias.copy_(b_)
        mask = torch.nn.Transformer.generate_square_subsequent_mask(
            T, device=dev)

        def lib_call(x_):
            return layer(x_, src_mask=mask, is_causal=True)

        lib_err = rel_err(lib_call(x), fb.transformer_block_plain(
            x, params, H, True))
        lib, _ = time_ms(lambda: lib_call(rot()), iters=10, warmup=2)
    del rot
    if not lib_err <= BLOCK_RTOL:
        raise RuntimeError(f"TransformerEncoderLayer is not the block's "
                           f"function: {lib_err} of max |plain|")
    ops, nbytes = block_work(B, T, H, D, FF)
    extra = tc_bounds(ops, nbytes, ms)
    res["transformer_block"] = {"train": dict(
        ms=ms, warm_ms=warm, plain_ms=plain, library_ms=lib,
        bound_by="operations", **extra)}
    log(f"[time] transformer_block B={B} T={T} H={H} D={D} F={FF} causal "
        f"f32: kernel cold {ms:.4f} ms ({extra['tflops']:.2f} TFLOP/s), "
        f"warm {warm:.4f} ms, plain "
        f"{plain:.4f} ms, TransformerEncoderLayer (norm_first, causal mask, "
        f"attention biases 0; output {lib_err:.3g} of max |plain| from the "
        f"plain version) {lib:.4f} ms, bound {extra['bound_ms']:.4f} ms "
        f"({ops / 1e9:.2f} GFLOP in 3xTF32 at "
        f"{TF32_FLOPS_PER_S / 1e12:g} TFLOP/s), f32 SIMT bound "
        f"{extra['simt_bound_ms']:.4f} ms; host enqueue per call "
        f"{bhost:.4f} ms")
    return res


def phase_timings_fused_amp(torch):
    """The AMP fuse-block path's bf16 kernels at its shapes (B 32, T 512,
    H 8, d 64, D 512, F 2048), cold as in phase_timings: the bf16
    [B, H, T, d] flash forward and backward on the block recompute's
    [B, T, H, d] views, beside the contiguous [B, H, T, d] call and the
    head-major bf16 call on the same data, its plain version and SDPA in
    bf16; the bf16 block forward, cold and warm, beside its plain version
    and torch.nn.TransformerEncoderLayer in bf16, whose output is first
    held against the plain version at the reference's bf16 tolerance."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_block as fb
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    B, T, H, d, D, FF = TRAIN_BATCH, TRAIN_T, 8, 64, 512, 2048
    pairs = B * H * T * (T + 1) // 2
    n = H * d * B * T
    fops, fbytes = 4 * d * pairs, 2 * 4 * n + 4 * H * B * T
    bops, bbytes = 10 * d * pairs, 2 * 7 * n + 2 * 4 * H * B * T

    def make():
        """One input set in the three layouts: name -> (q, k, v, do, lse,
        delta)."""
        q, k, v, do = (bthd_view(rnd(B, T, H * d), H) for _ in range(4))
        sets = {"bthd": (q, k, v, do),
                "bhtd": tuple(t.contiguous() for t in (q, k, v, do))}
        out = {}
        for name, (q_, k_, v_, do_) in sets.items():
            o_, lse_ = fa.flash_attention_bf16(q_, k_, v_, True)
            out[name] = (q_, k_, v_, do_, lse_,
                         (do_.float() * o_.float()).sum(-1))
        qh, kh, vh, doh = map(head_major, sets["bhtd"])
        oh, lseh = fa.flash_attention_hdt_bf16(qh, kh, vh, B, causal=True)
        out["head-major"] = (qh, kh, vh, doh, lseh,
                             (doh.float() * oh.float()).sum(1, keepdim=True))
        return out

    rot = rotation(make)

    def fwd_call(name, fn=None):
        q_, k_, v_ = rot()[name][:3]
        if name == "head-major":
            return fa.flash_attention_hdt_bf16(q_, k_, v_, B, causal=True)
        return (fn or fa.flash_attention_bf16)(q_, k_, v_, True)

    def bwd_call(name, fn=None):
        q_, k_, v_, do_, lse_, delta_ = rot()[name]
        if name == "head-major":
            return fa.flash_attention_hdt_bwd_bf16(q_, k_, v_, lse_, delta_,
                                                   do_, B, causal=True)
        return (fn or fa.flash_attention_bwd_bf16)(q_, k_, v_, lse_, delta_,
                                                   do_, True)

    fwd, bwd, host = {}, {}, {}
    for name in ("bthd", "bhtd", "head-major"):
        fwd[name], host[name] = time_ms(lambda: fwd_call(name))
        bwd[name], host[name + " bwd"] = time_ms(lambda: bwd_call(name),
                                                 iters=20, warmup=2)
    # the views' forward and backward on the path each takes and forced
    # onto the sync path
    fa16, fb16 = fa.flash_attention_bf16, fa.flash_attention_bwd_bf16
    paths = {p: timed_on_path(fa16, lambda p_: fwd_call(
        "bthd", functools.partial(fa16, path=p_)), p) for p in (None, "sync")}
    bpaths = {p: timed_on_path(fb16, lambda p_: bwd_call(
        "bthd", functools.partial(fb16, path=p_)), p, iters=20, warmup=2)
        for p in (None, "sync")}
    fplain, _ = time_ms(lambda: fwd_call("bthd", fa.flash_attention_plain),
                        iters=10)
    bplain, _ = time_ms(lambda: bwd_call("bthd", fa.flash_attention_bwd_plain),
                        iters=5, warmup=1)
    flib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        *rot()["bhtd"][:3], is_causal=True))
    del rot

    def make_lib():
        qg, kg, vg, doc = (rnd(B, H, T, d) for _ in range(4))
        qg, kg, vg = (t.requires_grad_() for t in (qg, kg, vg))
        return (F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
                (qg, kg, vg), doc)

    lib_rot = rotation(make_lib)

    def lib_bwd():
        og, ins, doc = lib_rot()
        return torch.autograd.grad(og, ins, doc, retain_graph=True)

    blib, _ = time_ms(lib_bwd, iters=20, warmup=2)
    del lib_rot
    res = {
        "flash_attention_bf16": dict(
            ms=fwd["bthd"], plain_ms=fplain, library_ms=flib,
            contiguous_bhtd_ms=fwd["bhtd"], head_major_ms=fwd["head-major"],
            path=paths[None][2], path_ms=paths[None][0],
            host_ms=paths[None][1], sync_ms=paths["sync"][0],
            sync_host_ms=paths["sync"][1],
            **bf16_bounds(fops, fbytes, fwd["bthd"])),
        "flash_attention_bwd_bf16": dict(
            ms=bwd["bthd"], plain_ms=bplain, library_ms=blib,
            contiguous_bhtd_ms=bwd["bhtd"], head_major_ms=bwd["head-major"],
            path=bpaths[None][2], path_ms=bpaths[None][0],
            host_ms=bpaths[None][1], sync_ms=bpaths["sync"][0],
            sync_host_ms=bpaths["sync"][1],
            **bf16_bounds(bops, bbytes, bwd["bthd"]))}
    for name, ops, nb, times, plain, lib, what, h in (
            ("flash_attention_bf16", fops, fbytes, fwd, fplain, flib,
             "sdpa", host["bthd"]),
            ("flash_attention_bwd_bf16", bops, bbytes, bwd, bplain, blib,
             "sdpa backward", host["bthd bwd"])):
        r = res[name]
        log(f"[time fuse_block amp] {name} [B,H,T,d] H={H} d={d} B={B} "
            f"T={T} causal bf16, cold: kernel on the block recompute's "
            f"[B,T,H,d] views (token stride {H * d}) {times['bthd']:.4f} ms "
            f"({r['tflops']:.2f} TFLOP/s), on contiguous [B,H,T,d] (token "
            f"stride {d}) {times['bhtd']:.4f} ms, the head-major call (token "
            f"stride 1) {times['head-major']:.4f} ms; plain {plain:.4f} ms, "
            f"{what} (bf16) {lib:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({ops / 1e9:.3f} GFLOP at "
            f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s, {nb / 1e6:.1f} MB at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s); host enqueue per call "
            f"{h:.4f} ms")
    for name, ops, (pms, phost, ppath), (sms, shost, _) in (
            ("flash_attention_bf16", fops, paths[None], paths["sync"]),
            ("flash_attention_bwd_bf16", bops, bpaths[None],
             bpaths["sync"])):
        log(f"[time fuse_block amp] {name} on the [B,T,H,d] views took the "
            f"{ppath} path: {pms:.4f} ms, host enqueue per call {phost:.4f} "
            f"ms; the sync path on the same inputs {sms:.4f} ms "
            f"({ops / sms / 1e9:.2f} TFLOP/s), host enqueue per call "
            f"{shost:.4f} ms")

    # the block forward: x (16 MiB in bf16) rotates over ROTATE buffers for
    # the kernel, the plain version and the library layer alike; the
    # weights stay (6.3 MB)
    xf, params = block_inputs(lambda *sh: torch.randn(
        *sh, generator=g, device=dev), B, T, D, FF)
    x, params = xf.to(bf), bf16_block_params(params)
    brot = rotation(lambda: rnd(B, T, D))
    blk = fb.transformer_block_bf16
    # the GEMMs on the path the operands choose and forced onto sync, in
    # turns (chosen, sync, sync, chosen), each with its host enqueue
    runs = [timed_on_path(blk, lambda p_: blk(brot(), params, H, True,
                                              gemm_path=p_),
                          p, iters=10, warmup=2, counter="launches_gemm_")
            for p in (None, "sync", "sync", None)]
    gpath = runs[0][2]
    if gpath != "wgmma":
        raise RuntimeError(f"the bf16 block's GEMMs took the {gpath} path at "
                           f"the training shape")
    # one window each, as every other row: the second windows are kept
    # beside them
    (ms, bhost, _), (sync_ms, sync_host, _) = runs[0], runs[1]
    warm, _ = time_ms(lambda: blk(x, params, H, True), iters=10, warmup=2)
    plain, _ = time_ms(lambda: fb.transformer_block_plain(brot(), params, H,
                                                          True),
                       iters=5, warmup=1)
    layer = torch.nn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0, activation="relu", batch_first=True,
        norm_first=True, device=dev).eval()
    ln1g, ln1b, wq, wk, wv, wo, ln2g, ln2b, w1, b1, w2, b2 = params
    with torch.no_grad():
        sa = layer.self_attn
        sa.in_proj_weight.copy_(torch.cat([wq, wk, wv], 1).t())
        sa.in_proj_bias.zero_()
        sa.out_proj.weight.copy_(wo.t())
        sa.out_proj.bias.zero_()
        for mod, w_, b_ in ((layer.linear1, w1.t(), b1),
                            (layer.linear2, w2.t(), b2),
                            (layer.norm1, ln1g, ln1b),
                            (layer.norm2, ln2g, ln2b)):
            mod.weight.copy_(w_)
            mod.bias.copy_(b_)
        layer = layer.to(bf)
        mask = torch.nn.Transformer.generate_square_subsequent_mask(
            T, device=dev, dtype=bf)

        def lib_call(x_):
            return layer(x_, src_mask=mask, is_causal=True)

        lib_err = rel_err(lib_call(x), fb.transformer_block_plain(
            x, params, H, True))
        lib, _ = time_ms(lambda: lib_call(brot()), iters=10, warmup=2)
    del brot
    if not lib_err <= 2e-2:
        raise RuntimeError(f"TransformerEncoderLayer in bf16 is not the "
                           f"block's function: {lib_err} of max |plain|")
    ops, nbytes = block_work(B, T, H, D, FF, width=2)
    res["transformer_block_bf16"] = dict(
        ms=ms, warm_ms=warm, plain_ms=plain, library_ms=lib, path=gpath,
        host_ms=bhost, sync_ms=sync_ms, sync_host_ms=sync_host,
        path_ms=[runs[0][0], runs[3][0]], sync_path_ms=[runs[1][0],
                                                          runs[2][0]],
        **bf16_bounds(ops, nbytes, ms))
    r = res["transformer_block_bf16"]
    log(f"[time fuse_block amp] transformer_block_bf16 B={B} T={T} H={H} "
        f"D={D} F={FF} causal bf16: kernel cold {ms:.4f} ms "
        f"({r['tflops']:.2f} TFLOP/s, {100 * r['bound_ms'] / ms:.1f} % of "
        f"the bound), warm {warm:.4f} ms, plain "
        f"{plain:.4f} ms, TransformerEncoderLayer in bf16 (norm_first, "
        f"causal mask, attention biases 0; output {lib_err:.3g} of max "
        f"|plain| from the plain version, tol 2e-2) {lib:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({ops / 1e9:.2f} GFLOP "
        f"at {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB); "
        f"host enqueue per call {bhost:.4f} ms")
    log(f"[time fuse_block amp] transformer_block_bf16 GEMMs on the {gpath} "
        f"path: {runs[0][0]:.4f}/{runs[3][0]:.4f} ms cold, host enqueue per "
        f"call {runs[0][1]:.4f}/{runs[3][1]:.4f} ms; forced onto the sync "
        f"path in the same turns {runs[1][0]:.4f}/{runs[2][0]:.4f} ms, host "
        f"enqueue per call {runs[1][1]:.4f}/{runs[2][1]:.4f} ms")
    return res


def torch_settings(torch):
    """TF32 off for matmul and cuDNN, and the AMP path's cuBLAS bf16
    products adding their split-K sums in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# the time the short traces' process may take (its own start included)
SHORT_TRACES_TIMEOUT_S = 300


def short_traces(torch):
    """The traces of the short calls, each of a few launches, made by
    short_traces_main in a process of its own, and their results: on the
    H100 the tracer of a process that has run and traced the smoke's
    phases lost every kernel record of a short call (1-9 launches) on
    first tries, and several times running, from some point late in the
    smoke on, while a fresh process's lost none.  The process runs the
    same checks; a failure there fails the smoke."""
    log("[trace] the short calls' traces, in a process of their own")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "short_traces.json")
        sys.stdout.flush()
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--short-traces", out], cwd=here,
            timeout=SHORT_TRACES_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"the short traces' process exited "
                               f"{proc.returncode}")
        with open(out) as f:
            return json.load(f)


def short_traces_main(out):
    """`chip_smoke.py --short-traces OUT`, run by short_traces: the
    schedule's launches, each conv-family case's forward and backward,
    the launches the auc op adds to a bench_deepfm step, and the
    breakdowns of the bf16 LM head, the bf16 flash backward, the block
    (f32, and bf16 on each GEMM path) and SDPA (f32 and bf16), each
    traced and checked as in the smoke's own process; the breakdowns
    are written to OUT as JSON for the smoke's checks."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.kernels import _build
    torch_settings(torch)
    _build.load()
    ptt.flags.set_flag("verify_program", "error")
    schedule_cost(torch)
    trace_sched_conv(torch, conv_family_cases(torch))
    trace_dense(torch)
    n_head_bwd = -(-TRAIN_BATCH * TRAIN_T // HEAD_CHUNK) * head_bwd_kernels()
    n_head_sync = (-(-TRAIN_BATCH * TRAIN_T // HEAD_CHUNK)
                   * HEAD_BWD_SYNC_KERNELS)
    res = {"heads": head_breakdown(torch, {"wgmma": n_head_bwd,
                                           "sync": n_head_sync}),
           "flash_bwd": flash_bwd_breakdown(torch),
           "block": block_breakdown(torch, chain=BLOCK_CHAIN_LAUNCHES),
           "block_bf16": {gpath: block_breakdown(
               torch, bf16=True, chain=BLOCK_BF16_CHAIN_LAUNCHES,
               gemm_path=gpath) for gpath in ("wgmma", "sync")},
           "sdpa": sdpa_kernels(torch),
           "sdpa_bf16": sdpa_kernels(torch, torch.bfloat16)}
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 3
    torch_settings(torch)
    log("[setup] TF32 off for matmul and cuDNN: every f32 product is "
        "full f32; bf16 products add their split-K sums in f32")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    phase_build(torch)
    errs = phase_compare(torch)
    # every program the smoke runs is verified by the Executor's gate in
    # error mode before it runs (phase 5f reads the records)
    import paddle_tpu_torch as ptt
    ptt.flags.set_flag("verify_program", "error")
    record_verifications()
    VERIFY_PHASE[0] = "serve"
    serve_counts, pred, toks = phase_serve(torch)
    VERIFY_PHASE[0] = "decode"
    decode_counts, oracle_counts, decode_remake = phase_decode(torch)
    VERIFY_PHASE[0] = "train"
    counts, train = phase_train(torch)
    VERIFY_PHASE[0] = "train fuse_block"
    fcounts, ftrain = phase_train(torch, fuse_block=True)
    VERIFY_PHASE[0] = "train amp"
    acounts, atrain = phase_train(torch, amp=True)
    VERIFY_PHASE[0] = "train fuse_block amp"
    facounts, fatrain = phase_train(torch, fuse_block=True, amp=True)
    VERIFY_PHASE[0] = "training loops"
    loop_counts = phase_train_loops(torch)
    VERIFY_PHASE[0] = "verify"
    phase_verify(torch, pred, {"tokens": toks})
    VERIFY_PHASE[0] = "resnet"
    resnet_counts = phase_resnet(torch)
    VERIFY_PHASE[0] = "nmt_bert"
    xfmr_counts, xfmr_amp, ln_d768 = phase_nmt_bert(torch)
    VERIFY_PHASE[0] = "deepfm"
    deepfm_counts, deepfm_amp = phase_deepfm(torch)
    VERIFY_PHASE[0] = "convnets_lstm"
    cnl_counts, cnl_rows = phase_convnets_lstm(torch)
    VERIFY_PHASE[0] = "seq2seq_book"
    s2s_counts, s2s_rows = phase_seq2seq_book(torch)
    VERIFY_PHASE[0] = "sched_conv"
    sc_counts = phase_sched_conv(torch)
    VERIFY_PHASE[0] = "quant"
    q_counts, q_keep = phase_quant(torch)
    VERIFY_PHASE[0] = "dense"
    dense_counts = phase_dense(torch)
    VERIFY_PHASE[0] = "sequence"
    sequence_counts, ctc_row = phase_sequence(torch)
    n_verified = len(VERIFY_LOG)
    VERIFY_PHASE[0] = "timings"
    times = phase_timings(torch)
    times.update(phase_timings_fused(torch))
    amp_times = phase_timings_amp(torch)
    amp_times.update(phase_timings_fused_amp(torch))
    # last: the profiler stays attached to the process once started, and
    # its per-launch cost would skew the timings above
    trace_run(torch, f"batch {toks.shape[0]} request",
              lambda: pred.run({"tokens": toks}, return_numpy=False))
    trace_decode(torch, decode_remake)
    trace_run(torch, f"training step at batch {TRAIN_BATCH}",
              lambda: train["exe"].run(train["main"], feed=train["batch"],
                                       fetch_list=[train["avg_cost"]],
                                       return_numpy=False))
    # four GEMM kernels a block forward, six blocks
    trace_run(torch, f"fuse_block training step at batch {TRAIN_BATCH}",
              lambda: ftrain["exe"].run(ftrain["main"],
                                        feed=ftrain["batch"],
                                        fetch_list=[ftrain["avg_cost"]],
                                        return_numpy=False),
              expect={BLOCK_GEMMS: 4 * FLAGSHIP["n_layer"]})
    # the AMP step: the bf16 kernels (the LM-head forward and the merge of
    # its segments, the backward's kernels per chunk, both on the wgmma
    # path), no f32 flash or LM head; the layer norms by their input type
    # (the first takes the f32 embedding)
    n_head_bwd = -(-TRAIN_BATCH * TRAIN_T // HEAD_CHUNK) * head_bwd_kernels()
    with amp_bf16():
        names = trace_run(
            torch, f"AMP training step at batch {TRAIN_BATCH}",
            lambda: atrain["exe"].run(atrain["main"], feed=atrain["batch"],
                                      fetch_list=[atrain["avg_cost"]],
                                      return_numpy=False),
            expect={"flash forward bf16 (this repo)": FLAGSHIP["n_layer"],
                    "flash backward bf16 (this repo)":
                        2 * FLAGSHIP["n_layer"],
                    "lm_head_fwd bf16 (this repo)": 2,
                    "lm_head_bwd bf16 (this repo)": n_head_bwd,
                    "lm_head_fwd (this repo)": 0,
                    "lm_head_bwd (this repo)": 0,
                    _kernel_class("flash_fwd_hdt_kernel"): 0,
                    _kernel_class("flash_bwd_dq_kernel"): 0})
    ln_kinds = ln_launch_kinds(names)
    log(f"[trace]   AMP step layer norms by kernel: {ln_kinds}")
    if ln_kinds != {"f32": 1, "bf16 scalar": 0,
                    "bf16 v16": 2 * FLAGSHIP["n_layer"]}:
        raise RuntimeError(f"AMP step layer norms {ln_kinds}")
    # the AMP fuse_block step: four bf16 block GEMMs a layer; the bf16 flash
    # forward inside each block and in its recompute, the backward's two
    # kernels; every layer norm on bf16 rows (12 inside the blocks, the
    # final one); no f32 block, flash or LM head
    with amp_bf16():
        names = trace_run(
            torch, f"AMP fuse_block training step at batch {TRAIN_BATCH}",
            lambda: fatrain["exe"].run(fatrain["main"],
                                       feed=fatrain["batch"],
                                       fetch_list=[fatrain["avg_cost"]],
                                       return_numpy=False),
            expect={BLOCK_GEMMS_BF16: 4 * FLAGSHIP["n_layer"],
                    "flash forward bf16 (this repo)": 2 * FLAGSHIP["n_layer"],
                    "flash backward bf16 (this repo)":
                        2 * FLAGSHIP["n_layer"],
                    "lm_head_fwd bf16 (this repo)": 2,
                    "lm_head_bwd bf16 (this repo)": n_head_bwd,
                    BLOCK_GEMMS: 0,
                    "lm_head_fwd (this repo)": 0,
                    "lm_head_bwd (this repo)": 0,
                    _kernel_class("flash_fwd_hdt_kernel"): 0,
                    _kernel_class("flash_bwd_dq_kernel"): 0})
    ln_kinds = ln_launch_kinds(names)
    log(f"[trace]   AMP fuse_block step layer norms by kernel: {ln_kinds}")
    if ln_kinds != {"f32": 0, "bf16 scalar": 0,
                    "bf16 v16": 2 * FLAGSHIP["n_layer"] + 1}:
        raise RuntimeError(f"AMP fuse_block step layer norms {ln_kinds}")
    # the AMP NMT and BERT steps: their layer norms by kernel, as the
    # rows' input dtypes give them, and no other kernel of this repo
    for model, row in xfmr_amp.items():
        trace_xfmr(torch, model, row)
    del xfmr_amp
    trace_deepfm(torch, deepfm_amp)
    del deepfm_amp
    trace_convnets_lstm(torch, cnl_rows)
    del cnl_rows
    trace_seq2seq(torch, s2s_rows)
    del s2s_rows
    trace_quant(torch, q_keep)
    del q_keep
    trace_ctc(torch, ctc_row)
    del ctc_row
    short = short_traces(torch)
    n_head_sync = (-(-TRAIN_BATCH * TRAIN_T // HEAD_CHUNK)
                   * HEAD_BWD_SYNC_KERNELS)
    heads = short["heads"]
    for d, path, n in (("bwd", "wgmma", n_head_bwd),
                       ("bwd", "sync", n_head_sync),
                       ("fwd", "wgmma", HEAD_FWD_KERNELS),
                       ("fwd", "sync", HEAD_FWD_KERNELS)):
        n_head = sum(r["launches"] for r in heads[d][path].values())
        if n_head != n:
            raise RuntimeError(f"one bf16 LM-head {d} on the {path} path "
                               f"made {n_head} launches, expected {n}")
    for path, rows in heads["fwd"].items():
        if (path == "wgmma") != all("_wg_" in n for n in rows):
            raise RuntimeError(f"the bf16 LM-head forward's {path} path "
                               f"launched {sorted(rows)}")
    for d, name, n in (("bwd", "lm_head_bwd_bf16", n_head_bwd),
                       ("fwd", "lm_head_fwd_bf16", HEAD_FWD_KERNELS)):
        amp_times[name].update(by_kernel=heads[d]["wgmma"],
                               sync_by_kernel=heads[d]["sync"],
                               launches_per_call=n)
    by_path = short["flash_bwd"]
    for path, rows in by_path.items():
        if sum(r["launches"] for r in rows.values()) != 2:
            raise RuntimeError(f"one bf16 flash backward on the {path} path "
                               f"made {rows}, not 2 launches")
        if (path == "wgmma") != all("_wg_kernel" in n for n in rows):
            raise RuntimeError(f"the bf16 flash backward's {path} path "
                               f"launched {sorted(rows)}")
    amp_times["flash_attention_hdt_bwd_bf16"].update(
        {key: by_path[path] for key, path in (("by_kernel", "wgmma"),
                                              ("sync_by_kernel", "sync"))
         if path in by_path})
    by_kernel = short["block"]
    n_chain = sum(r["launches"] for r in by_kernel.values())
    if n_chain != BLOCK_CHAIN_LAUNCHES:
        raise RuntimeError(f"one block forward made {n_chain} launches, "
                           f"expected {BLOCK_CHAIN_LAUNCHES}")
    times["transformer_block"]["train"].update(by_kernel=by_kernel,
                                               launches_per_call=n_chain)
    # the bf16 block on each GEMM path: its four GEMMs the wgmma kernel
    # on the wgmma path and the mma.sync kernel on the sync path; its
    # flash launch on the path that fwd_bf16_path gives the block's views,
    # the wgmma kernel at this shape
    blocks, chains = {}, {}
    for gpath in ("wgmma", "sync"):
        by_kernel = short["block_bf16"][gpath]
        n_chain = sum(r["launches"] for r in by_kernel.values())
        if n_chain != BLOCK_BF16_CHAIN_LAUNCHES:
            raise RuntimeError(f"one bf16 block forward made {n_chain} "
                               f"launches, expected "
                               f"{BLOCK_BF16_CHAIN_LAUNCHES}")
        flash = [n for n in by_kernel if "flash_fwd" in n]
        if len(flash) != 1 or "flash_fwd_bf16_wg_kernel" not in flash[0]:
            raise RuntimeError(f"the bf16 block's flash launch is {flash}, "
                               f"not the wgmma kernel")
        # LN1 and LN2 on the v16 path (layer_norm.cu's rule in the C entry)
        norms = {n: r["launches"] for n, r in by_kernel.items()
                 if "ln_fwd" in n}
        if sum(norms.values()) != 2 or any("ln_fwd_v16_" not in n
                                           for n in norms):
            raise RuntimeError(f"the bf16 block's layer norms are {norms}, "
                               f"not two v16 launches")
        gemms = [n for n, r in by_kernel.items() if "block_gemm" in n]
        if sum(by_kernel[n]["launches"] for n in gemms) != 4 or any(
                ("_wg_kernel" in n) != (gpath == "wgmma") for n in gemms):
            raise RuntimeError(f"the bf16 block's GEMMs on the {gpath} path "
                               f"launched {gemms}")
        blocks[gpath], chains[gpath] = by_kernel, n_chain
    amp_times["transformer_block_bf16"].update(
        by_kernel=blocks["wgmma"], sync_by_kernel=blocks["sync"],
        launches_per_call=chains["wgmma"],
        sync_launches_per_call=chains["sync"])
    sdpa = short["sdpa"]
    for n in ("flash_attention_hdt", "flash_attention"):
        times[n]["train"]["library_kernels"] = sorted(sdpa["fwd"])
    for n in ("flash_attention_hdt_bwd", "flash_attention_bwd"):
        times[n]["train"]["library_kernels"] = sorted(sdpa["bwd"])
    sdpa = short["sdpa_bf16"]
    amp_times["flash_attention_hdt_bf16"]["library_kernels"] = sorted(
        sdpa["fwd"])
    amp_times["flash_attention_hdt_bwd_bf16"]["library_kernels"] = sorted(
        sdpa["bwd"])
    amp_times["flash_attention_bf16"]["library_kernels"] = sorted(
        sdpa["fwd"])
    amp_times["flash_attention_bwd_bf16"]["library_kernels"] = sorted(
        sdpa["bwd"])
    # the layer norm on bf16 rows: the AMP programs' launches (on the v16
    # path, as phase_train checked) and the v16 path's numbers
    times["layer_norm"]["train"]["bf16"] = dict(
        amp_times.pop("layer_norm"), launches=atrain["ln_paths"]["v16"],
        max_abs_err=errs["layer_norm_bf16"]["train"],
        launches_by_path={"train_amp": atrain["ln_paths"],
                          "train_fuse_block_amp": fatrain["ln_paths"]})
    for n, r in amp_times.items():
        times[n] = {"train": r}
    log(f"[train amp] step p50 {atrain['p50_ms']:.2f} ms against the f32 "
        f"step's {train['p50_ms']:.2f} ms; peak device memory "
        f"{atrain['peak'] / 2**20:.1f} MiB against "
        f"{train['peak'] / 2**20:.1f} MiB")
    log(f"[train fuse_block amp] step p50 {fatrain['p50_ms']:.2f} ms against "
        f"the f32 fuse_block step's {ftrain['p50_ms']:.2f} ms; peak device "
        f"memory {fatrain['peak'] / 2**20:.1f} MiB against "
        f"{ftrain['peak'] / 2**20:.1f} MiB")

    # each kernel's launches on its training path (slice 2's program for
    # the five it runs, the fuse_block program for the three it adds, the
    # AMP program for its four bf16 kernels, the AMP fuse_block program for
    # its three),
    # with the counts of every path under "launches_by_path", its errors
    # and times at the training step's shapes; the two kernels that
    # serving runs too carry the serving shape's under "serve"
    by_path = {"serve": serve_counts, "decode": decode_counts,
               "decode_oracle": oracle_counts, "train": counts,
               "train_fuse_block": fcounts, "train_amp": acounts,
               "train_fuse_block_amp": facounts, **loop_counts,
               **resnet_counts, **xfmr_counts, **deepfm_counts,
               **cnl_counts, **s2s_counts, **sc_counts, **q_counts,
               **dense_counts, **sequence_counts}
    kernels = []
    for n, (_, source, replaces) in KERNELS.items():
        path = ("train_fuse_block" if n in FUSE_BLOCK_KERNELS else
                "train_amp" if n in AMP_KERNELS else
                "train_fuse_block_amp" if n in FUSE_BLOCK_AMP_KERNELS else
                "train")
        k = dict(name=n, route="cuda",
                 source="paddle_tpu_torch/kernels/csrc/" + source,
                 replaces=replaces, launches=by_path[path][n],
                 max_abs_err=errs[n]["train"], **times[n]["train"],
                 launches_by_path={p: c[n] for p, c in by_path.items()})
        if serve_counts[n]:
            k["serve"] = dict(launches=serve_counts[n],
                              max_abs_err=errs[n]["serve"],
                              **times[n]["serve"])
        if n == "layer_norm":   # BERT-base's width, f32 and bf16 rows
            k["d768"] = ln_d768
        kernels.append(k)
    later = VERIFY_LOG[n_verified:]
    log(f"[verify] phase 6 made {len(later)} more verifications, "
        f"{sum(r['errors'] for r in later)} with an error, "
        f"{sum(r['ms'] for r in later):.1f} ms of host time")
    log(f"[smoke] the whole run took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--short-traces"]:
        sys.exit(short_traces_main(sys.argv[2]))
    sys.exit(main())
