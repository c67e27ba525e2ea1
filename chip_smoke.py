#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), then build every kernel
     of paddle_tpu_torch/ops/csrc/ with nvcc, one process per source, all
     at once, and beside them the native host runtime (libptnative, g++,
     paddle_tpu_torch/native), logging its command line; while they build,
     the phases that launch no hand-written kernel run (8b, 8e, 14, 15 and
     16 below), then the run waits for the builds;
  2. each kernel against its plain torch version at the full-width shapes
     of the main paths, with max abs error against its tolerance and the
     kernel / plain / library-call times in ms:
     - paged flash (decode q [8, 768] / table [8, 64]; prefill chunk
       q [32, 768] / table [64]), seeded inputs with pos < 0 rows, rows on a
       page boundary and partly filled last pages; atol = rtol = 1e-5; the
       shared (prefill) form also at chunks of 1, 17, 32 and 48 rows, across
       a stage and a split boundary, with pos = 0 and pos < 0 rows, over f32
       and int8 pools, each repeated bit for bit; the decode form also at
       1, 8, 16 and 64 slots x page sizes 8, 16 and 32 x head widths 6, 64,
       80, 128 and 160, with pos of -1, 0, page and split boundaries, the
       table's last position and past it and a corrupt table entry, over
       f32 and int8 pools, each repeated bit for bit; heads past 128 (the
       wide kernel) at decode widths 256 and 512 and prefill chunks of 1,
       32 and 48 rows at widths 160, 256 and 512, page sizes 16, 32 and
       128, the same edge positions and a corrupt entry, both pool types,
       then timed at Gemma 7B's attention widths (16 heads of 256, page
       size 16: 8 decode slots, a 32-row chunk) beside the byte bound;
     - the GEMM epilogue at Transformer base's FFN shapes (4096 x 512 @
       512 x 2048 + relu, 4096 x 2048 @ 2048 x 512), beside torch.addmm
       at both shapes and both bounds (3xTF32 on the tensor cores, f32 on
       the CUDA cores); atol = rtol = 1e-4;
     - layer_norm forward (4096 x 512, with and without the residual), 1e-5;
       backward (one launch), dx 1e-5, dscale / dbias rtol 1e-4 atol 1e-3;
       then both over an edge grid (cols 96-49152 x rows 1-4096, f32 and
       bf16 at 1e-2, with and without the residual, scale and bias null and
       set) and on views off 16-byte alignment: s bit for bit, the column
       sums repeat bit for bit, the arrival counters back at 0;
     - multi-tensor Adam over the model's 183 tensors (f32 moments, bit for
       bit; bf16 moments, one bf16 ulp), a ragged-tail set and views at odd
       element offsets (bit for bit), timed against torch._fused_adam_ in 3
       interleaved rounds (medians);
     - flash attention, forward and backward, at the train-flash path's
       (16, 8, 256, 64) f32 as strided views, causal and not, where the
       backward takes the fused tier: out and lse atol = rtol = 1e-5, grads
       rtol 1e-4 with atol 1e-4 of the largest magnitude, timed beside the
       plain versions and scaled_dot_product_attention (forward; backward
       from a retained graph); the same at (1, 2, 16384, 64), where the
       backward takes the dK/dV + dQ pair (as the JAX package takes its
       streamed tiers); the pair also in bf16 at t = 16384 (timed beside
       SDPA's bf16 backward), at t = 4097 and causal with tq = 300, tk =
       1000, f32 and bf16; bf16 at the main shape against the f32 plain
       version on the same rounded inputs at 2e-2; each case's launches
       must land on its tier; then every head width d in {6, 8, 16, 32, 80,
       96}, f32 and bf16, causal and not, at a length each backward tier
       takes (d <= 64: both), and (b, h, t, d) = (65600, 1, 32, 16), past the
       65535 of a grid's y axis; then head widths past 128 (129, 160, 192,
       256, 512: the wide forward; 640: the chunked one; the backward's
       pair), f32 and bf16, causal and not, and timed at (16, 8, 256, 256)
       beside SDPA, the forward also at (16, 8, 256, 512); forward and
       backward repeat bit for bit;
     - the int8 paged flash forms at path A's shapes (decode q [16, 768] /
       table [16, 64]; prefill chunk q [32, 768] / table [64]; int8 pools
       with per-row f32 scales), atol = rtol = 1e-5;
     - the quant GEMM at 1024 x 2048 @ 2048 x 2048: int8 with relu and with
       no act, bit for bit; e4m3, rtol 1e-5 of the largest |z|; timed
       beside torch._int_mm and torch._scaled_mm, and at path B's 256-row
       bucket (with the wrapper's host time a call); then an edge grid (m
       1, 17, 250, 1024 x k 16, 48, 2064, 8192 x n 16, 2064, and a ragged
       128-row tile at 1000 x 2064 x 2064; the five acts, both forms), each
       call repeated bit for bit;
     - fp8_matmul (fp8_gemm.cu: the forward in one launch, the cast in
       the producer; the dx and dy forms on bf16 tensor cores) at the bf16
       Transformer's products (the attention projections, q k^T and p v of
       16 x 8 heads, the FFN products, the vocab projection at n = 37000)
       and edges (m 1-1024, k 1-4096 with k % 16 != 0, n 1-2064, y
       broadcast over x's batch and x over y's), f32 and bf16 operands,
       values past 448: NaN where the plain version has NaN; the forward
       f32 within rtol 1e-5 of max |out|, bf16 one bf16 ulp; the gradient
       against the plain backward within one e4m3 ulp plus the forward's
       f32 bar, at least 99.9 % equal; the rounding kernel against the plain rounding bit for bit;
       the forward timed at (4096, 512) @ (512, 512) bf16 beside
       torch._scaled_mm, dx and dy there and at the vocab product beside
       the f32 matmuls with plain rounding they replace;
  Every serve and train phase runs its main path on replayed CUDA graphs
  (a GenerationEngine captures its decode step and prefill buckets at
  warmup(); Executor.run captures a training step at its second call) and
  then on the op-by-op path (FLAGS_profile_ops inside profiler.profiler(),
  a device sync after every op): the same requests give the same tokens, a
  request run alone gives the same logits bit for bit in every prefill
  chunk and decode step, with the same paged kernel launches; the first 3
  training steps from one seed give the same losses bit for bit, with the
  same launches and dispatches a step. Both paths' decode and prefill
  p50, tokens/s, step p50 and target tokens/s (and a training step's
  device busy time) are printed, and gathered in one `paths` JSON line,
  with the memory the card reserves after the serving engine's warmup and
  after each training phase's graph steps (graphs of one engine or one
  executor share one memory pool);
  3. serving: a GenerationEngine over GPTDecoder at GPT-2 small's widths
     (12 layers, 12 heads, d_model 768, d_inner 3072, vocab 50257, 1024
     positions; random weights from a seed), warmup(), then a
     GenerationScheduler answering 8 concurrent greedy requests with prompts
     of 40-700 tokens and 32 new tokens each. Every request must finish,
     no variant may be captured after warmup, both paged kernel launch
     counters must move, and two requests must match serial engine.generate;
  4. paged vs dense: the engine's prefill and decode logits against the
     whole-sequence program build_forward(1, 64) on the same parameters;
     then that program rewritten by the fuse_attention pass (12
     flash_attention ops, no softmax, 12 forward kernel launches) against
     the unfused one, logits within 1e-4;
  4b. serve int8 KV (path A): GPT-2 small over int8 KV pools at 16 slots
     with the f32 engine's weights, a GenerationScheduler answering 16
     concurrent greedy requests (the serve prompts, each twice; 32 new
     tokens each): all finish, no variant captured again, both int8 paged kernels
     launched; logits against the f32 pools within a relative drift of 0.05
     on shared contexts; the kernel path against paged_flash off on the
     same int8 pools within 1e-4;
  4b'. paged export: for the f32 engine and the int8 one, its decode
     program and the 32-row prefill-chunk program exported
     (GenerationEngine.export_variant: aot_serve_lowering(return_state=
     True), executor.export_block, the KV pools the written state), one
     paddle_tpu_torch.paged_flash_attention node a layer; a 32-token
     request alone, one chunk and 8 decode steps on the engine's graph
     path, replayed by the exported programs on copies of the pools as they
     were before it: every call's logits and every pool bit for bit, 12
     shared-table and 96 per-slot launches;
  4c. serve int8 GEMM (path B): the fc head of the JAX package's int8
     serving bench (3 x fc(2048 -> 2048, relu), fc(2048 -> 16)) fitted 30
     steps by the port's Executor + Adam, saved by io.py, served by an f32
     and a calibrated-int8 ServingEngine: 8 batches of 250 rows and one of
     1024; 4 muls quantized, frozen and fused; quant GEMM launches per call
     equal to the chains the predicate accepts; top-1 delta <= 0.005 and
     max relative logit error < 0.05; rows/s and the single shot's wall;
     the int8 engine call's device busy time and the quant GEMM's share
     (torch.profiler);
  4d. serve wide heads: GPTDecoder at GPT-2 medium's widths with 4 heads
     of 256, cut to 2 layers (random weights from a seed), page_size 128,
     4 slots, over f32 then int8 pools: 4 greedy requests of 40-700
     prompt tokens, 16 new each; all finish, no variant captured again, both wide
     paged kernels of the pool type launched and no narrow one; paged
     against dense logits and the fuse_attention rewrite (the wide flash
     forward) within 1e-4; the int8 kernel path against the plain path;
  5. training: Transformer base (6 layers, d_model 512, d_ff 2048, 8 heads,
     vocab 37000, batches of 16 x 256 tokens, dropout 0.1, f32; random
     weights from a seed) trained by Executor.run under the training_fused
     pass preset for 6 steps: every loss finite, every training kernel
     launched by the expected count each step, then the first 3 losses
     against an unfused run (no pass pipeline) from the same seed within
     rtol 2e-3, atol 2e-4; step wall p50, target tokens/s, the device's
     busy share and its launches a step;
  6. train flash: the same model with use_flash=True, padded=False (every
     attention block one flash_attention op, no bias feeds; batches of 16
     pairs of exactly 256 tokens) for 6 steps: every loss finite, per step
     12 + 6 forward and 12 + 6 fused-tier backward flash launches
     (non-causal + causal) and none of the pair, beside the training
     kernels' counts, and the same readings;
     then flash against dense (bias feeds at full length) on the same
     weights at dropout 0 for 3 steps, losses within rtol 2e-3, atol 2e-4;
     train multistep: the same model at dropout 0.1, 3 calls of
     steps_per_run=4 against 12 single runs from the same state: losses
     and every persistable bit for bit, one host synchronization a call
     (torch.profiler), the same launches a step, the step walls; then the
     py_reader form: the program built with layers.py_reader + read_file,
     Executor.run with no feed pulling 4 staged batches a call, 3 calls
     bit for bit the stacked calls (losses and persistables), no more host
     syncs a call and no capture beyond theirs, then EOFException; an epoch
     of 9: calls of 4, 4 and a stacked tail of 1, then EOFException, the
     losses bit for bit the single runs';
  7. train lenet: the fluid book script through paddle_tpu_torch.fluid
     (tests/test_mnist.py, tests/test_book.py): batch(reader.shuffle(
     dataset.mnist.train(), 500), 64) into a DataFeeder, LeNet-5
     (models/lenet.py) under Adam 1e-3 and training_fused for 60 graph
     steps, every step 3 GEMM epilogue launches (the fc chains, k = 400,
     120, 84) and 1 multi_adam launch; the last 5 losses under 0.7x the
     first 5 and accuracy above 0.5 (tests/test_mnist.py:64-67); the first
     3 losses against an unfused run (rtol 2e-3, atol 2e-4) and against the
     op-by-op path (bit for bit, the same launches and dispatches a step);
     then at batch 16 the for_test clone (op by op, captured, replayed: the
     same bits), save_persistables / load_persistables into a fresh scope
     (the same test loss and logits bit for bit) and save_inference_model /
     load_inference_model (the same logits);
  8. train resnet50: ResNet-50 at its published widths (He et al. 2016,
     Table 1: bottlenecks [3, 4, 6, 3], filters 64-512 (x4), 3 x 224 x 224,
     1000 classes; random weights from a seed) under Momentum(0.1, 0.9),
     f32, batch 256 (bench.py:23-39), synthetic batches staged on the card,
     under training_fused: the warmup and the capture, then 6 graph steps,
     every loss finite and no hand-written kernel launched (the one fc, n =
     1000, is declined by the GEMM epilogue's block rule, as in the JAX
     package); the first 3 steps op by op from the same weights give the
     same losses and running means and variances bit for bit (cuDNN
     restricted to deterministic algorithms); images/s, step wall p50,
     device busy share and launches a step, memory reserved, and the
     device time split by op type (convolution forward, dgrad and wgrad,
     batch_norm forward and backward, pooling, momentum, elementwise, fc);
     batch_norm trains through the explicit batch_norm_grad; the same
     model again with batch_norm's generic (vjp) grad, 4 graph steps and 2
     op by op, gives the before-and-after step wall and batch_norm's
     device share from the same call, its first loss equal to the explicit
     grad's bit for bit and its second within rtol 2e-3, atol 2e-4; then
     the input pipeline (bench.py's pyreader / staged ratio), each leg
     pulling its batches (feed=None) inside the timed steps: a PyReader
     thread over the staged batches copied to host once and cycled (pinned
     copy, the reader's copy stream; losses bit for bit the staged steps'),
     and the data runtime (2 decode worker processes, uint8 on the wire,
     the shared-memory ring; its first loss against the same images fed as
     f32 within rtol 1e-6); each leg's images/s at least 0.9 of the staged
     steps', and one batch's staging cost beside the step;
  8b. batch_norm grad: the explicit batch_norm_grad against the generic
     grad at ResNet-50's (256, 64, 112, 112) and SE-ResNeXt-50's (64, 64,
     112, 112) training shapes, rtol 1e-4 with atol 1e-5 of the largest
     |grad|, repeated bit for bit, both timed beside the byte bound;
  8c. train zoo: VGG-19 (batch 64, Momentum(0.01, 0.9), bench.py:229-260),
     AlexNet (batch 128) and GoogLeNet (batch 128, both auxiliary heads;
     the reference speed table's rows, Momentum(0.01, 0.9)) and
     SE-ResNeXt-50 32x4d (batch 64, Momentum(0.1, 0.9)) at 3 x 224 x 224,
     1000 classes, f32, training_fused (tools/profile_zoo.py): the warmup,
     the capture and 6 graph steps, every loss finite, the same counters
     every step with 2, 2, 2 and 32 GEMM epilogue launches; the first 3
     steps op by op bit for bit with the same counters, the GEMM epilogue
     held against its plain version at the inputs the first step gave it
     (VGG-19's (64, 25088) @ (25088, 4096) and AlexNet's (128, 9216) @
     (9216, 4096) among them); images/s and step wall p50 over graph steps
     3-8, busy share, launches and memory reserved a step, and the device
     time of 2 op-by-op steps split by op type;
  8d. deploy resnet50 (tools/profile_deploy.py): ResNet-50 at 3 x 224 x 224,
     1000 classes, f32, trained with simulated quantization (the
     quantize_training pass) under Momentum(0.1, 0.9) at batch 64 for 8
     graph steps beside the f32 program's 8 (images/s, step wall p50, busy
     share, launches and memory of each; the first 3 QAT losses op by op
     bit for bit), batch_norm's running statistics re-estimated by 40 steps
     at learning rate 0; then five inference legs at batch 128 on those
     parameters: (a) the f32 test clone, (b) (a) after InferenceTranspiler,
     (c) (b) after memory_optimize, (d) the QAT test clone after
     freeze_program, (e) (d) after convert_to_int8, each 8 graph-path calls
     and one op-by-op run bit for bit with the same counters, images/s,
     wall p50 over replays 3-8, busy share, launches and memory, (a) and
     (e) split by op type; (b) within rtol 1e-4, atol 1e-5 of (a), (c) bit
     for bit with (b), (e) within 1e-4 of (d), (e)'s top-1 agreement with
     (a); the quant GEMM launched once per int8_conv2d (53) every call of
     (e) and held bit for bit against its plain version on every im2col
     product of (e)'s op-by-op run, the stem's and two 3 x 3
     convolutions' timed beside torch._int_mm; then (e)'s program saved by
     io.save_inference_model and served by inference.Predictor and by
     load_compiled(export_compiled(...)), 4 calls each: every fetch bit
     for bit the Predictor's first and that one leg (e)'s, 53
     quant_gemm_bias_act nodes in the graph and 53 launches a call;
  8e. extra ops: the 46 op types of nn_extra_ops.py and compose_ops.py at
     published models' shapes (C3D, 3D U-Net, DCGAN, FCN, SegNet, SPP-net,
     group norm's ResNet-50, the Spatial Transformer, the train lstm and
     nmt phases' widths and others), forward eager on the card, captured
     and replayed bit for bit, and backward, against the CPU on the same
     inputs (floats within rtol 1e-4 and atol 1e-4 of max(1, max |x|),
     integers exactly; random_crop a window at one offset for the batch);
  9. train lstm: the stacked dynamic-LSTM text model (models/stacked_lstm.py)
     at the JAX bench's shape (bench.py:265-290): dict 30000, emb 512, hid
     512, stacked_num 2, batch 64 of 100 words fed as a lod_level=1 var with
     its @LEN companion, 2 classes, Adam(2e-3), f32, training_fused: the
     warmup and the capture, then 6 graph steps on the full-length batch
     and 3 on a ragged one (lengths 1-100), every loss finite, the same
     launches and dispatches every step, 1 multi_adam launch a step; the
     first 3 steps op by op from the same weights: the same losses bit for
     bit and the same counters a step; the GEMM epilogue and multi_adam
     kernels held against their plain versions on the inputs the op-by-op
     run's first step gives them (the path's own shapes and values); the
     first 3 steps unfused (no kernel launched) within the fused-vs-unfused
     bar of the fused losses; tokens/s (the non-pad tokens of graph
     steps 2-6 over their summed wall), step wall p50, device busy share,
     launches a step, memory reserved, and the op-by-op device time split
     into the recurrent products, the gates' elementwise work, the generic
     grad's replayed forward, the embedding and Adam;
 10. train nmt: the GRU attention NMT model (models/machine_translation.py):
     (a) the copy task of tests/test_machine_translation.py (vocab 12, 5
     words, batch 8, Adam(1e-2), 150 graph steps; the last loss under 0.3x
     the first) and a beam decode of the trained batch (beam 3): at least
     4 of 8 sources copied exactly; (b) emb = hid = 512, dict 30000, 16
     words, batch 64, Adam(1e-3): 6 graph steps, every loss finite, the
     first 3 op by op bit for bit, the kernels held against their plain
     versions at the path's inputs and the first 3 steps unfused as in
     train lstm, the same readings as train lstm; then a
     beam decode of one batch (beam 4, max_out_len 16) that runs op by op
     for the stated reason open_ended_while, with finite scores and every
     hypothesis 1-16 long, its wall and the number of ops it ran;
 11. schedules: each of the seven learning-rate schedules drives SGD over a
     one-fc program for the warmup, the capture and 6 graph steps; the
     learning rate fetched at every step equals the schedule's closed form
     at that step (rtol 1e-6), so a replayed graph advances the step
     counter;
 12. train deepfm: DeepFM (models/deepfm.py) at the JAX bench's recsys
     widths (bench.py:1533-1557): a 2^20 x 32 table, 16 fields, batch 512,
     layer_sizes (32, 16), Adam(1e-3) with bf16 moments, training_fused,
     dense and is_sparse=True (SelectedRows grads, lazy Adam on the
     touched rows): the warmup, the capture and 6 graph steps each, 3 GEMM
     epilogue and 1 multi_adam launches every step, no block op by op but
     the startup program; the first 2 steps op by op bit for bit with the
     same counters, the kernels held at the path's inputs; step wall,
     examples/s, embedding rows/s, busy share, launches and memory a step,
     the sparse:dense step ratio; then sparse against dense SGD at the
     parity leg's shape (2048 rows, 4 fields, dim 8, batch 64, 6 batches)
     bit for bit, losses and tables; then tests/test_deepfm.py's training
     (200 sparse Adam steps): the last 5 losses under 0.9x the first 5 and
     the AUC of a fresh batch of 512 above 0.65; then the native feed:
     16 RECSYS batches written as MultiSlot text, parsed by libptnative's
     C++ MultiSlotDataFeed through AsyncExecutor(CUDAPlace(0), thread_num=
     1) (dense DeepFM: its loss means of every 4 steps bit for bit an
     Executor fed the same assembled batches as dicts) and through
     contrib.reader.ctr_reader with feed=None to EOFException (losses bit
     for bit the dict-fed run's);
 13. train bf16: ResNet-50 (batch 256, Momentum(0.1, 0.9)), VGG-19 (3
     steps, as bench.py:229-260 runs it), the stacked
     LSTM (Adam 2e-3) and Transformer base, each as its f32 phase builds
     it, rewritten by Bf16Transpiler after its startup program (the JAX
     bench's precision: f32 masters, bf16 activations and gradients) and
     trained on CUDA graphs from the same seed and batches: the first 3
     losses within rtol 5e-2, atol 2e-2 of the f32 phase's, every master
     and moment still f32, the first 3 steps op by op bit for bit with the
     same counters, the GEMM epilogue (bf16 operands, 2e-2) and Adam (bf16
     grads, f32 masters, bit for bit) held at the path's inputs; images/s
     or tokens/s, step wall, busy share and memory beside the f32 phase's;
     then 3 Transformer steps with FLAGS_fp8_matmul: fp8_matmul's
     forward, dx and dy forms launched, losses within 0.1 relative of the
     bf16 steps', bit for bit op by op, its first product held against the
     plain version; the step wall and the op-by-op device split
     (profile_training.fp8_step_split) beside the redesign's parent's;
 14. train ssd: MobileNet-SSD (tools/profile_detection.py: the reference
     era's mobilenet_ssd.py, batch 64, 3 x 300 x 300, 21 classes, 1917
     priors, f32, random weights from a seed) under RMSProp(piecewise_decay)
     with L2Decay(5e-5) on a fixed synthetic VOC-shaped batch staged on the
     card: the warmup, the capture and 30 graph steps, no hand-written
     kernel launched, the last loss under 0.7x the first
     (tests/test_detection.py:265); the first 3 steps op by op bit for bit
     with the same counters; step wall, images/s, busy share, memory, and
     the op-by-op device time of ssd_loss and its grad against the
     convolutions and batch_norm; then the generic batch_norm grad's run,
     as in train resnet50;
 15. eval ssd: the eval program (the for_test clone, detection_output,
     the detection_map host op) on the trained state, 3 runs: one device
     segment and one host call each, the segment captured at the second
     run and replayed at the third, the detections the same bits every
     run, the host op's mAP equal to evaluator.DetectionMAP over the
     fetched rows; the segment's busy time and kernel nodes, the capture's
     wall, the host op's own time;
 16. detection ops: each of the 18 detection ops at a published
     detector's shapes (Faster R-CNN R50-C4 on 800 x 1333, YOLOv3 at 608,
     SSD300's 1917 priors, FaceBoxes, EAST, a text detector's
     perspective crops) eager on the card against the CPU (floats within
     1e-4, integers exactly), then captured alone and replayed bit for
     bit; each graph's capture wall, nodes and replay time;
 17. host ops: a Print between two device segments fires on each of 3
     graph-path runs; FLAGS_check_nan_inf raises on a NaN feed at a
     replay, naming the variable and its last writer; save_combine /
     load_combine round-trip f32, int32 and bf16 vars bit for bit; a
     program holding the eight reader markers (read, the create_*_reader
     ops, open_files) runs on the graph path and fetches 16.0;
 17a. eager: the LeNet-5 of models/lenet.py built from imperative.nn
     (conv 1 -> 6 5x5 pad 2 relu, pool 2, conv 6 -> 16 5x5 relu, pool 2,
     fc 400 -> 120 -> 84 -> 10, a log-softmax loss Layer), 60 eager Adam
     steps of batch 64 on fluid.dataset.mnist's batches, a guard a step:
     the gates of tests/test_mnist.py:64-67, the first 3 losses against
     the port's own CPU run from the same weights (rtol 2e-3, atol 2e-4);
     BatchNorm (train, then eval), LayerNorm, Embedding with padding_idx,
     a PyLayer and Layer.jit() (torch.compile, inductor) once each on the
     card against the CPU at rtol 1e-4; DataParallel at world 1 bit for
     bit the plain layer; the step wall p50 and the device busy share;
 17b. telemetry: train_flash's Transformer base (f32, training_fused),
     6 graph steps fed through layers.py_reader with FLAGS_telemetry_dir
     (interval 2) against the same steps with it off: 6 step records and
     their fields, the feed-stall the collector recorded, the Prometheus
     file parsed by promparse equal to the registry, the shard merged,
     equal host syncs a step, the same losses, the step wall p50 of each;
     FLAGS_tensor_stats="*layer_norm*": one capture more, one host sync
     more a replay, its rows against the same outputs fetched op by op
     from the same state (rtol 1e-5, atol 1e-5 of absmax, nonfinite
     counts exactly); FLAGS_nan_provenance with the guard and the
     nan_grad fault: the record names the first op reading the poisoned
     feed, the rollback bit for bit; one op-by-op step under
     profiler.xla_trace: device_op_profile's per-op device ms within 5 %
     of the trace's kernel time, the top rows with the H100's Roof%; a
     replayed step's trace raises;
 17c. online: DeepFM at 2^20 x 32 (16 fields, batch 512, layer_sizes (32,
     16), sparse and use_distributed, SGD 0.05, training_fused on CUDA
     graphs) under an OnlineTrainer publishing a version every 5 steps
     (60 steps: a base and 11 deltas of the touched rows) while a
     ModelServer in this process serves the saved model and a HotReloader
     lands each version under 4 urllib :predict clients: every reply 200,
     each client's versions monotone, every version applied with no
     reload error, the staleness within StalenessContract(50), 4 served
     versions restored from load_with_deltas bit for bit, the GEMM
     epilogue 3 launches a step; the trainer's rows/s, the publish and
     reload walls of a base and a delta, a delta's bytes each way, the
     :predict p50 / p99;
 17d. fleet: 3 replica processes of paddle_tpu_torch.fleet.replica on the
     card (GPT-2 small :generate, the f32 fc head :predict, seeded the
     same) behind a Router gated on a published version: steady traffic
     (3 :predict, 2 greedy :generate clients), replica_kill in r0 in the
     middle of a request, failover, its restart and rejoin once it acked
     the version, conn_reset in r1 and slow_response in r2 (each breaker
     opens and closes again), hedged :predict against slowed r2: every
     reply 200, every routed :generate reply the tokens of one replica
     called directly, each replica's paged launches reported at its exit;
     p99 by round and route, kill to rejoin, retries and hedges, each
     replica's boot seconds and memory reserved;
 18. train parallel: at world = the visible cards, on NCCL and CUDA
     graphs. Past one card, a process a card first trains Transformer
     base at dp = world (its first 3 losses within the fused bar of the
     train phase's, every rank the same; rank 0's step profiled for its
     NCCL kernels), then under ZeRO-1, and DeepFM at ep = world against
     the local build bit for bit. Then in this process, a world-1 NCCL
     group: Transformer base under training_fused through the
     ParallelExecutor, its first 3 losses bit for bit the train phase's,
     24 GEMM epilogue, 30 + 30 layer_norm and 1 Adam launches a step, the
     NCCL kernels of its captured step and its step wall beside the
     Executor's; an all-reduce captured in a CUDA graph and replayed;
     DeepFM at 2^20 x 32 with use_distributed at ep = 1 against local bit
     for bit; ring attention's per-step forward and backward over 4 chunks
     at train_flash's widths against flash attention over the whole
     sequence (out and lse within 1e-5, grads rtol 1e-4 with atol 1e-4 of
     the largest); the ParallelExecutor with the Megatron sharding rules
     at world 1 (they prune away: the Executor's losses bit for bit, its
     launches), and steps_per_run=4 through it bit for bit 4 single runs.
     Past one card, the A6b leg (a process a card, NCCL with a timeout,
     each part under a deadline that names a hang): Transformer base
     train_flash at dropout 0 at dp 2 x tp 2, fsdp 4, pp 4 and dp 2 x pp
     2 under GPipe and 1F1B (pp 2 alone on 2 or 3 cards), each leg's
     first 3 losses within the fused bar of the one-card Executor's, its
     collectives, flash's head count, its bytes a rank and, under pp, its
     stages and bubble; steps_per_run at dp 4 and the ZeRO-1 checkpoint
     at dp 4, bit for bit; then on four cards the ring leg (ROADMAP C2):
     ring attention over dp 2 x sp 2 and sp 4, eager and captured, within
     the bars above, or, while its known hang stands, the stage each rank
     stopped at;
 19. artifacts: compiled artifacts on torch.export, the hand kernels as
     the paddle_tpu_torch torch.library ops. (a) Transformer base
     train_flash under training_fused, exported after its startup program
     (train_export.export_train_step) at dropout 0 and at 0.1; a fresh
     process that imports only paddle_tpu_torch.train_export and numpy
     loads each artifact: at dropout 0 its first 3 losses bit for bit
     Executor.run's from the same state, the loss falling over 6 steps,
     every step's launches (24 GEMM epilogue, 30 + 30 layer_norm, 1 Adam,
     12 + 6 flash forward and 12 + 6 fused flash backward) and its step
     wall beside the Executor's; at dropout 0.1 (2 layers of Transformer
     base's widths) the runner restored from its save_state continues the
     run it made before, bit for bit. (b) the
     same model's inference program (the for_test clone pruned to the
     37000-wide logits) served by inference.Predictor and by
     load_compiled(export_compiled(...)): fetches bit for bit between the
     two and between the artifact's first (op by op) call and its graph
     replays, 12 + 6 flash forward launches a call, both walls. (c) the
     contrib decoder at NMT's widths (profile_rnn.DECODER) trains 3 steps
     and beam-decodes (beam 4, max length 16) on the card and on the CPU
     from the same weights: losses at rtol 2e-3 atol 2e-4, ids equal on
     every row but where the CPU's top-k had a tie within 1e-5 (at the
     first step the card selects otherwise, both selections' scores agree
     within 1e-5; those rows counted). (e) Transformer base (dropout 0)
     rewritten to bf16 under FLAGS_fp8_matmul and training_fused (train
     bf16's fp8 configuration), exported by export_train_step and run by
     TrainStepRunner in this process: 3 losses bit for bit Executor.run's
     from the same state, fp8_matmul and fp8_matmul_grads nodes in the
     graph, the fp8 forward, dx and dy launches a step of both, the
     export and load times and the file size;
 20. the `paths` JSON line, then a `kernels` JSON line (launches on the
     graph path, error, times, bound per kernel; gemm_epilogue and
     multi_adam count the Transformer's, LeNet's, the zoo's, the LSTM's,
     the NMT model's, DeepFM's, the bf16 runs', the multi-step phase's,
     the PE's and the train artifacts' steps, and their
     max_abs_err is
     the worst of their own check and the path checks; fp8_matmul,
     fp8_matmul_dx and fp8_matmul_dy count the fp8 steps' and the fp8
     artifact's; e4m3_round and quant_gemm_fp8 (on no main path) the
     kernel phase's; quant_gemm_int8 the int8 ServingEngine's calls, deploy
     resnet50's leg (e) and its artifact, 53 a call; gemm_epilogue also
     the online trainer's steps, paged_flash and paged_flash_shared also
     the fleet replicas' serving, as each reports at its exit, and the
     paged forms the exported programs' calls).
The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or without the paddle_tpu_torch package beside it,
the script exits non-zero and prints no result.
"""

import contextlib
import json
import math
import os
import sys
import time

import numpy as np

SEED = 0
GIB = float(1 << 30)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores, NVIDIA data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores, NVIDIA data sheet
ATOL = RTOL = 1e-5  # kernel vs plain: both f32, sums in another order
LOGIT_ATOL = LOGIT_RTOL = 1e-4  # paged vs dense, 12 layers of f32 rounding

GPT2_SMALL = dict(vocab_size=50257, n_layer=12, n_head=12, d_model=768,
                  d_inner=3072, max_context=1024)
ENGINE = dict(max_slots=8, page_size=16, max_context=1024)
PROMPT_LENS = (40, 131, 217, 305, 388, 472, 569, 700)
NEW_TOKENS = 32
NO_EOS = -1  # never sampled: every request generates NEW_TOKENS tokens

KERNEL_META = {
    "paged_flash": ("paddle_tpu/ops/pallas_kernels.py:1470", False),
    "paged_flash_shared": ("paddle_tpu/ops/pallas_kernels.py:1505", True),
}

# int8 serving: path A, int8 KV pools at twice the f32 engine's slots (the
# JAX package's int8-KV recipe, bench.py:2101-2109); path B, the JAX
# package's calibrated-int8 ServingEngine vehicle, the fc head of
# bench.py:2031-2064 (3 x fc(2048 -> 2048, relu), fc(2048 -> 16))
INT8_ENGINE = dict(ENGINE, max_slots=16)
INT8_KERNEL_META = {
    "paged_flash_int8": ("paddle_tpu/ops/pallas_kernels.py:1540", False),
    "paged_flash_shared_int8": ("paddle_tpu/ops/pallas_kernels.py:1579", True),
}
INT8_DRIFT = 0.05  # int8 vs f32 pools, relative (tests/test_quant.py:271-272)
HEAD = dict(d_model=2048, classes=16, depth=3)
HEAD_FIT_STEPS, HEAD_FIT_ROWS = 30, 64
HEAD_EVAL_BATCHES, HEAD_EVAL_ROWS, HEAD_SHOT_ROWS = 8, 250, 1024
HEAD_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
TOP1_DELTA, HEAD_REL_ERR = 0.005, 0.05  # the JAX package's int8 serving gates
INT8_TOPS = 1979e12  # H100 SXM dense int8 / fp8 tensor-core rate, NVIDIA data sheet

# training kernels: tolerances against the plain versions
GEMM_TOL = 1e-4  # k up to 25088 (VGG-19's fc6), sums in another order
LN_TOL = 1e-5  # f32 statistics
LN_SUM_RTOL, LN_SUM_ATOL = 1e-4, 1e-3  # dscale / dbias: sums over 4096 rows
LN_BF16_TOL = 1e-2  # bf16 y and dx: one rounding of the output
# the layer_norm edge grid: every register width of both kernels, the
# chunked forward and the wide backward, up to the widest f32 row the path
# takes (49152); rows of 1 and 7 (a CTA barely filled), 200 and 4096 (more
# than one row run of the backward)
LN_EDGE_COLS = (96, 128, 512, 768, 1024, 4096, 8192, 49152)
LN_EDGE_ROWS = (1, 7, 200, 4096)
TRAIN_STEPS = 6  # fused steps of the training phase
RNN_STEPS = 6  # graph steps of the LSTM and the NMT model at full width
LSTM_RAGGED_STEPS = 3  # and the LSTM's steps on the ragged batch
SCHEDULE_STEPS = 6  # replayed steps of each learning-rate schedule
SCHEDULE_RTOL = 1e-6
COMPARE_STEPS = 3  # of them compared with the unfused run
FUSED_RTOL, FUSED_ATOL = 2e-3, 2e-4  # the JAX package's fused-vs-unfused bar
BF16_KERNEL_TOL = 2e-2  # a kernel with bf16 operands against its plain version
# the f32 phases' first COMPARE_STEPS losses on the graph path, by model,
# which the bf16 runs of the same weights and batches are held against
F32_FIRST = {}


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log("[%s] start" % self.name)
        return self

    def __exit__(self, et, ev, tb):
        if ev is None:
            log("[%s] ok %.1f s" % (self.name, time.perf_counter() - self.t0))
        return False


# ---------------------------------------------------------------- phase 2


def paged_case(torch, device, shared, seed):
    """Full-width inputs: pool of 513 pages of 16 rows x 768, decode rows
    with per-slot tables or one prefill chunk with a shared table."""
    rng = np.random.RandomState(seed)
    ps, n_head, d = ENGINE["page_size"], 12, 64
    feat = n_head * d
    max_pages = ENGINE["max_context"] // ps
    pool_pages = ENGINE["max_slots"] * max_pages + 1
    kp = rng.randn(pool_pages * ps, feat).astype("float32")
    vp = rng.randn(pool_pages * ps, feat).astype("float32")
    pages = rng.permutation(np.arange(1, pool_pages)).astype(np.int32)
    if shared:
        rows = 32
        # a chunk starting mid-page at 600, crossing pages 608 and 624; the
        # last two rows are dead (pos < 0)
        pos = np.arange(600, 600 + rows, dtype=np.int32)
        pos[-2:] = -1
        bt = np.zeros(max_pages, np.int32)
        need = pos.max() // ps + 1
        bt[:need] = pages[:need]
    else:
        rows = ENGINE["max_slots"]
        # idle slot, first row, page boundary (15, 16), partial last pages,
        # the last position of the context
        pos = np.array([-1, 0, 15, 16, 333, 700, 871, 1023], np.int32)
        bt = np.zeros((rows, max_pages), np.int32)
        used = 0
        for r in range(rows):
            need = pos[r] // ps + 1 if pos[r] >= 0 else 0
            bt[r, :need] = pages[used:used + need]
            used += need
    q = rng.randn(rows, feat).astype("float32")
    args = [torch.from_numpy(a).to(device) for a in (q, kp, vp, bt, pos)]
    return args, dict(n_head=n_head, page_size=ps)


def _bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _paged_work(pos, shared, rows, feat, ps, n_pages, kv_bytes):
    """(bytes, flops, K/V rows) of the work these inputs need: each input byte
    read once (only the K/V pages up to pos, kv_bytes a K or V row), each
    output byte written once; the flops of q k^T and p v over the live
    entries."""
    live = [min(int(p) + 1, n_pages * ps) if p >= 0 else 0 for p in pos]
    if shared:
        kv_rows = (max(live) + ps - 1) // ps * ps
    else:
        kv_rows = sum((n + ps - 1) // ps * ps for n in live)
    table = (n_pages if shared else rows * n_pages) * 4
    nbytes = 2 * kv_rows * kv_bytes + 2 * rows * feat * 4 + table + rows * 4
    return nbytes, sum(4 * n * feat for n in live), kv_rows


def bound(pos, shared, rows, feat, ps, n_pages):
    """Least time for the work these inputs need (f32 pools): the bytes
    against the flops of q k^T and p v, as f32 on the CUDA cores (the
    decode form's) or, for the shared form, as 3xTF32 on the tensor cores."""
    nbytes, flops, _ = _paged_work(pos, shared, rows, feat, ps, n_pages, feat * 4)
    return (_tf32x3_bound if shared else _bound)(nbytes, flops)


GATE_CYCLES = 400_000_000  # a sleep kernel of ~0.2 s at the H100's clocks


def profiled_device_ms(torch, fn, n):
    """Mean device ms per call over n calls: the summed time of the kernels
    and copies torch.profiler records. For a function of thousands of
    launches, which cannot be queued behind a gate (the launch queue fills
    and the host waits on the card)."""
    return profiled_device_split(torch, fn, n, "")[0]


def profiled_device_split(torch, fn, n, match):
    """(device ms a call, of it the kernels whose name holds `match`) over n
    calls after one warm call: the kernels and copies torch.profiler
    records, summed."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device time")
    total = sum(e.device_time_total for e in dev) / 1e3 / n
    part = sum(e.device_time_total for e in dev if match in e.name) / 1e3 / n
    return total, part


def time_ms(torch, fn, n, flush, gated):
    """Mean ms per call over n calls, each with a cold L2 (a 64 MB buffer is
    rewritten between calls, outside the timed region).

    gated: the calls are queued behind a sleep kernel, so the card runs them
    back to back and each event pair brackets device work only (the
    kernel's time). Ungated, the card waits on the host between calls and
    the pair also holds the wrapper's launch cost (the time a caller sees)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    if gated:
        gate = torch.cuda.Event()
        torch.cuda._sleep(GATE_CYCLES)
        gate.record()
    for i in range(n):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    if gated and gate.query():
        raise RuntimeError("the gate opened before %d calls were queued: "
                           "the device times would hold host gaps" % n)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


def check_kernels(torch, pf, device):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = {}
    for name, (replaces, shared) in KERNEL_META.items():
        args, kw = paged_case(torch, device, shared, SEED + len(name))
        got = pf.paged_flash_attention(*args, **kw)
        want = pf.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError("%s: kernel vs plain max abs err %g" % (name, err))
        dead = args[4] < 0
        if dead.any() and float(got[dead].abs().max()) != 0.0:
            raise AssertionError("%s: pos < 0 rows are not exact zeros" % name)
        if not torch.equal(got, pf.paged_flash_attention(*args, **kw)):
            raise AssertionError("%s: the output differs from run to run" % name)
        kernel = lambda: pf.paged_flash_attention(*args, **kw)  # noqa: E731
        ms = time_ms(torch, kernel, 50, flush, gated=True)
        call_ms = time_ms(torch, kernel, 50, flush, gated=False)
        plain_ms = time_ms(torch, lambda: pf.paged_attention_plain(*args, **kw), 10, flush,
                           gated=True)
        q, bt, pos = args[0], args[3], args[4]
        bound_ms, bound_by = bound(
            pos.tolist(), shared, q.shape[0], q.shape[1], kw["page_size"], bt.shape[-1]
        )
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/paged_flash.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call reads a paged pool through a block table
            "library_ms": None,
        }
        log("kernel %s: q %s table %s max_abs_err %.3g (atol=rtol=%g; repeats bit for bit) "
            "kernel %.4f ms (device), %.4f ms a call with the wrapper's launch cost; plain "
            "%.4f ms (device); bound %.4f ms (%s%s)" % (
                name, tuple(q.shape), tuple(bt.shape), err, ATOL, ms, call_ms, plain_ms,
                bound_ms, bound_by, ", products as 3xTF32 on the tensor cores" if shared
                else ", products as f32 on the CUDA cores"))
    return results


def _entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def _close(torch, name, got, want, atol, rtol):
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError("%s: kernel vs plain max abs err %g (atol %g rtol %g)"
                             % (name, err, atol, rtol))
    return err


def _within_bf16_ulp(torch, name, got, want):
    want = want.float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    err = (got.float() - want).abs()
    if bool((err > ulp).any()):
        raise AssertionError("%s: %d values more than one bf16 ulp from the plain version"
                             % (name, int((err > ulp).sum())))
    return float(err.max())


def _tf32x3_bound(nbytes, flops):
    """(ms, what bounds it) of f32-accurate work on the tensor cores: the
    bytes over the HBM rate, or 3xTF32's three products of `flops` over the
    dense TF32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_gemm(torch, ge, device, flush):
    """The two FFN GEMMs of Transformer base (m = 16 x 256 tokens), beside
    torch.addmm (the product and the bias: FFN2's whole function, FFN1's
    without its relu). The kernels-line entry is FFN2."""
    rng = np.random.RandomState(SEED + 11)
    out = {}
    for case, (m, k, n, act) in (("ffn1", (4096, 512, 2048, "relu")),
                                 ("ffn2", (4096, 2048, 512, None))):
        x = torch.from_numpy(rng.randn(m, k).astype("float32")).to(device)
        w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype("float32")).to(device)
        b = torch.from_numpy(rng.randn(n).astype("float32")).to(device)
        z, y = ge.gemm_bias_act(x, w, b, act)
        zp, yp = ge.gemm_bias_act_plain(x, w, b, act)
        torch.cuda.synchronize()
        err = _close(torch, "gemm_epilogue " + case, z, zp, GEMM_TOL, GEMM_TOL)
        if act:
            err = max(err, _close(torch, "gemm_epilogue " + case, y, yp, GEMM_TOL, GEMM_TOL))
        ms = time_ms(torch, lambda: ge.gemm_bias_act(x, w, b, act), 20, flush, gated=True)
        plain_ms = time_ms(torch, lambda: ge.gemm_bias_act_plain(x, w, b, act), 10, flush,
                           gated=True)
        lib_ms = time_ms(torch, lambda: torch.addmm(b, x, w), 20, flush, gated=True)
        nbytes, flops = (m * k + k * n + n + (2 if act else 1) * m * n) * 4, 2 * m * n * k
        (bound_ms, bound_by), (cc_ms, cc_by) = _tf32x3_bound(nbytes, flops), _bound(nbytes, flops)
        log("kernel gemm_epilogue %s: x %s @ w %s act %s max_abs_err %.3g (atol=rtol=%g) "
            "kernel %.4f ms (device); plain %.4f ms; torch.addmm %.4f ms (%s), "
            "kernel / addmm %.3f; bound %.4f ms (%s, 3xTF32 on the tensor cores), f32 on the "
            "CUDA cores %.4f ms (%s)" % (
                case, (m, k), (k, n), act, err, GEMM_TOL, ms, plain_ms, lib_ms,
                "product + bias, no relu" if act else "the same function", ms / lib_ms,
                bound_ms, bound_by, cc_ms, cc_by))
        out[case] = _entry("gemm_epilogue", "paddle_tpu_torch/ops/csrc/gemm_epilogue.cu",
                           "paddle_tpu/ops/pallas_kernels.py:1121", err, ms, plain_ms,
                           bound_ms, bound_by, lib_ms)
    return out["ffn2"]


def check_layer_norm(torch, ln, device, flush):
    """layer_norm at (4096, 512): forward with the residual (the main
    path's form and the kernels-line entry) and without (a side reading
    against torch.native_layer_norm, which computes that form), then the
    backward against native_layer_norm_backward."""
    rng = np.random.RandomState(SEED + 12)
    rows, cols, eps = 4096, 512, 1e-5

    def t(a):
        return torch.from_numpy(a.astype("float32")).to(device)

    x, r, dy = t(rng.randn(rows, cols) * 2 + 0.5), t(rng.randn(rows, cols)), t(rng.randn(rows, cols))
    scale, bias = t(rng.rand(cols) + 0.5), t(rng.randn(cols))
    entries = {}
    for form, res in (("residual", r), ("plain", None)):
        got = ln.fused_layer_norm(x, res, scale, bias, eps)
        want = ln.fused_layer_norm_plain(x, res, scale, bias, eps)
        torch.cuda.synchronize()
        if res is not None and not torch.equal(got[0], want[0]):
            raise AssertionError("layer_norm: the residual sum differs from x + r")
        err = max(_close(torch, "layer_norm " + form, g, w_, LN_TOL, LN_TOL)
                  for g, w_ in zip(got[1:], want[1:]))
        ms = time_ms(torch, lambda: ln.fused_layer_norm(x, res, scale, bias, eps), 50, flush,
                     gated=True)
        plain_ms = time_ms(torch, lambda: ln.fused_layer_norm_plain(x, res, scale, bias, eps),
                           20, flush, gated=True)
        lib_ms = None
        if res is None:
            lib_ms = time_ms(torch, lambda: torch.native_layer_norm(x, [cols], scale, bias, eps),
                             50, flush, gated=True)
        n_in = 2 if res is not None else 1
        n_out = 2 if res is not None else 1
        bound_ms, bound_by = _bound(((n_in + n_out) * rows * cols + 2 * cols + 2 * rows) * 4,
                                    8 * rows * cols)
        log("kernel layer_norm (%s): (%d, %d) max_abs_err %.3g (atol=rtol=%g) kernel %.4f ms "
            "(device); plain %.4f ms; torch.native_layer_norm %s; bound %.4f ms (%s)" % (
                form, rows, cols, err, LN_TOL, ms, plain_ms,
                "%.4f ms" % lib_ms if lib_ms is not None
                else "none (no single call returns both s and y)",
                bound_ms, bound_by))
        entries[form] = _entry("layer_norm", "paddle_tpu_torch/ops/csrc/layer_norm.cu",
                               "paddle_tpu/ops/pallas_kernels.py:1802", err, ms, plain_ms,
                               bound_ms, bound_by, lib_ms)
    _, _, mean, var = ln.fused_layer_norm_plain(x, None, scale, bias, eps)
    got = ln.fused_layer_norm_grad(x, scale, mean, var, dy, eps)
    want = ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, eps)
    torch.cuda.synchronize()
    err = _close(torch, "layer_norm_grad dx", got[0], want[0], LN_TOL, LN_TOL)
    for name, g, w_ in (("dscale", got[1], want[1]), ("dbias", got[2], want[2])):
        err = max(err, _close(torch, "layer_norm_grad " + name, g, w_, LN_SUM_ATOL, LN_SUM_RTOL))
    again = ln.fused_layer_norm_grad(x, scale, mean, var, dy, eps)
    if not (torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])):
        raise AssertionError("layer_norm_grad: dscale / dbias differ from run to run")
    rstd = torch.rsqrt(var + eps)[:, None]
    mask = [True, True, True]
    ms = time_ms(torch, lambda: ln.fused_layer_norm_grad(x, scale, mean, var, dy, eps), 50,
                 flush, gated=True)
    plain_ms = time_ms(torch, lambda: ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, eps),
                       20, flush, gated=True)
    lib_ms = time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [cols], mean[:, None], rstd, scale, bias, mask), 50, flush, gated=True)
    bound_ms, bound_by = _bound((3 * rows * cols + 3 * cols + 2 * rows) * 4, 12 * rows * cols)
    log("kernel layer_norm_grad: (%d, %d) max_abs_err %.3g (dx atol=rtol=%g; dscale/dbias "
        "rtol %g atol %g; the sums repeat bit for bit) kernel %.4f ms (device); plain %.4f ms; "
        "native_layer_norm_backward %.4f ms; bound %.4f ms (%s)" % (
            rows, cols, err, LN_TOL, LN_SUM_RTOL, LN_SUM_ATOL, ms, plain_ms, lib_ms,
            bound_ms, bound_by))
    entries["grad"] = _entry("layer_norm_grad", "paddle_tpu_torch/ops/csrc/layer_norm.cu",
                             "paddle_tpu/ops/pallas_kernels.py:1899", err, ms, plain_ms,
                             bound_ms, bound_by, lib_ms)
    check_layer_norm_edges(torch, ln, device)
    return entries["residual"], entries["grad"]


def _ln_edge_case(torch, ln, counters, worst, x, r, sc, bi, dy, name):
    """One case of the edge grid: the forward against its plain form (s bit
    for bit), the backward against its plain form on the kernel's stats, its
    column sums again bit for bit, the arrival counters 0 after each call."""
    kind = "f32" if x.dtype == torch.float32 else "bf16"
    tol = LN_TOL if kind == "f32" else LN_BF16_TOL
    got = ln.fused_layer_norm(x, r, sc, bi, 1e-5)
    want = ln.fused_layer_norm_plain(x, r, sc, bi, 1e-5)
    torch.cuda.synchronize()
    if r is not None and not torch.equal(got[0], want[0]):
        raise AssertionError("layer_norm %s: the residual sum differs from x + r" % name)
    errs = {"y " + kind: _close(torch, "layer_norm y " + name, got[1], want[1], tol, tol),
            "mean": _close(torch, "layer_norm mean " + name, got[2], want[2], LN_TOL, LN_TOL),
            "var": _close(torch, "layer_norm var " + name, got[3], want[3], LN_TOL, LN_TOL)}
    mean, var = got[2], got[3]
    dx, ds, db = ln.fused_layer_norm_grad(x, sc, mean, var, dy, 1e-5)
    pdx, pds, pdb = ln.fused_layer_norm_grad_plain(x, sc, mean, var, dy, 1e-5)
    again = ln.fused_layer_norm_grad(x, sc, mean, var, dy, 1e-5)
    torch.cuda.synchronize()
    errs["dx " + kind] = _close(torch, "layer_norm_grad dx " + name, dx, pdx, tol, tol)
    errs["dscale"] = _close(torch, "layer_norm_grad dscale " + name, ds, pds, LN_SUM_ATOL,
                            LN_SUM_RTOL)
    errs["dbias"] = _close(torch, "layer_norm_grad dbias " + name, db, pdb, LN_SUM_ATOL,
                           LN_SUM_RTOL)
    if not (torch.equal(ds, again[1]) and torch.equal(db, again[2])):
        raise AssertionError("layer_norm_grad %s: dscale / dbias differ from run to run" % name)
    if int(counters.count_nonzero()):
        raise AssertionError("layer_norm_grad %s: an arrival counter was left set" % name)
    for k, v in errs.items():
        worst[k] = max(worst.get(k, 0.0), v)


def check_layer_norm_edges(torch, ln, device):
    """Both layer_norm kernels over the edge grid (LN_EDGE_COLS x
    LN_EDGE_ROWS, f32 and bf16, with and without the residual, scale and
    bias null and set), then with x, r, dy, scale and bias as views one
    element past a 16-byte boundary (element-by-element loads)."""
    from paddle_tpu_torch.ops import _build

    counters = _build.arrival_counters(device, torch.cuda.current_stream(device).cuda_stream, 1)
    gen = torch.Generator(device=device)
    worst, n, t0 = {}, 0, time.perf_counter()

    def case(rows, cols, dtype, seed):
        # made on the card: a 4096 x 49152 tensor is slow to make on the host
        gen.manual_seed(seed)
        x = (torch.randn(rows, cols, generator=gen, device=device) * 2 + 0.5).to(dtype)
        r, dy = (torch.randn(rows, cols, generator=gen, device=device).to(dtype)
                 for _ in range(2))
        return (x, r, dy, torch.rand(cols, generator=gen, device=device) + 0.5,
                torch.randn(cols, generator=gen, device=device))

    for dtype in (torch.float32, torch.bfloat16):
        for cols in LN_EDGE_COLS:
            for rows in LN_EDGE_ROWS:
                x, r, dy, scale, bias = case(rows, cols, dtype, SEED + rows + cols)
                for sc, bi in ((None, None), (scale, bias)):
                    for res in (None, r):
                        name = "(%d, %d) %s%s%s" % (
                            rows, cols, dtype, "" if res is None else " residual",
                            "" if sc is None else " scale/bias")
                        _ln_edge_case(torch, ln, counters, worst, x, res, sc, bi, dy, name)
                        n += 1
                del x, r, dy
        torch.cuda.empty_cache()
        for cols in (512, 4096):
            views = []
            for t in case(200, cols, dtype, SEED + 13):
                buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
                views.append(buf[1:].view(t.shape))
                views[-1].copy_(t)
            x, r, dy, scale, bias = views
            _ln_edge_case(torch, ln, counters, worst, x, r, scale, bias, dy,
                          "(200, %d) %s off 16-byte alignment" % (cols, dtype))
            n += 1
    log("kernel layer_norm / layer_norm_grad edge grid: %d cases (cols %s x rows %s, f32 and "
        "bf16, with and without the residual, scale/bias null and set; views off 16-byte "
        "alignment at 512 and 4096 columns) in %.1f s: worst %s (f32 y, mean, var, dx "
        "atol=rtol=%g; bf16 y, dx %g; dscale/dbias rtol %g atol %g); s bit for bit, the column "
        "sums repeat bit for bit, the arrival counters 0 after every call" % (
            n, list(LN_EDGE_COLS), list(LN_EDGE_ROWS), time.perf_counter() - t0,
            json.dumps({k: float("%.3g" % v) for k, v in sorted(worst.items())}), LN_TOL,
            LN_BF16_TOL, LN_SUM_RTOL, LN_SUM_ATOL))


def _adam_set(torch, device, shapes, moment_dtype, seed):
    rng = np.random.RandomState(seed)
    mdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype("float32")).to(device=device, dtype=dt)

    params = [t(rng.randn(*s) * 0.05) for s in shapes]
    grads = [t(rng.randn(*s) * 1e-3) for s in shapes]
    m1s = [t(rng.randn(*s) * 1e-4, mdt) for s in shapes]
    m2s = [t(np.abs(rng.randn(*s)) * 1e-7, mdt) for s in shapes]
    lr_t = torch.from_numpy((1e-3 * (1 + rng.rand(len(shapes)))).astype("float32")).to(device)
    return params, grads, m1s, m2s, lr_t


def _adam_check(torch, ma, name, device, shapes, moment_dtype, seed):
    kern = _adam_set(torch, device, shapes, moment_dtype, seed)
    plain = _adam_set(torch, device, shapes, moment_dtype, seed)
    ma.multi_tensor_adam(*kern, 0.9, 0.999, 1e-8)
    ma.multi_tensor_adam_plain(*plain, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    err = 0.0
    for slot in (0, 2, 3):
        for got, want in zip(kern[slot], plain[slot]):
            if got.dtype == torch.bfloat16:
                err = max(err, _within_bf16_ulp(torch, name, got, want))
                continue
            # the same f32 expressions, rounded the same way: bit for bit
            err = max(err, float((got - want).abs().max()) if got.numel() else 0.0)
            if not torch.equal(got, want):
                raise AssertionError("%s: f32 output differs from the plain version, max abs "
                                     "err %g" % (name, err))
    return err, kern


ADAM_ROUNDS = 2  # interleaved kernel / torch._fused_adam_ rounds, medians compared


def _adam_views(torch, ma, device):
    """Adam on views at element offsets 1-3 (a base not on 16 bytes: a
    scalar head, then vectors) and with the parameter alone one element off
    (element by element), bit for bit with the plain version."""
    rng = np.random.RandomState(SEED + 16)
    n = 3 * ma.chunk_elems() + 7
    for offsets in ((1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3), (1, 0, 0, 0)):
        sets = []
        for _ in range(2):
            r = np.random.RandomState(SEED + 17)
            views = []
            for at, scale in zip(offsets, (0.05, 1e-3, 1e-4, 1e-7)):
                buf = torch.zeros(n + 8, device=device)
                x = r.randn(n).astype("float32") * scale
                buf[at:at + n] = torch.from_numpy(np.abs(x) if scale == 1e-7 else x).to(device)
                views.append([buf[at:at + n]])
            sets.append(views)
        lr = torch.from_numpy(np.float32([1e-3 * (1 + rng.rand())])).to(device)
        ma.multi_tensor_adam(*sets[0], lr, 0.9, 0.999, 1e-8)
        ma.multi_tensor_adam_plain(*sets[1], lr, 0.9, 0.999, 1e-8)
        torch.cuda.synchronize()
        for slot in (0, 2, 3):
            if not torch.equal(sets[0][slot][0], sets[1][slot][0]):
                raise AssertionError("multi_adam: views at offsets %s differ from the plain "
                                     "version" % (offsets,))


def check_adam(torch, ma, device, flush, shapes):
    """Adam over the model's parameter shapes, f32 and bf16 moments, a
    ragged-tail set and views at odd offsets; the f32 set is the
    kernels-line entry, timed against torch._fused_adam_ over the same list
    in ADAM_ROUNDS interleaved rounds (the medians stand)."""
    ragged = [(7, 13), (4097,), (1,), (3,), (3 * 4096 + 5,), (33, 4095), (ma.chunk_elems() + 5,)]
    err_r, _ = _adam_check(torch, ma, "multi_adam ragged", device, ragged, "float32", SEED + 13)
    _adam_views(torch, ma, device)
    err_b, bset = _adam_check(torch, ma, "multi_adam bf16", device, shapes, "bfloat16", SEED + 14)
    bf16_ms = time_ms(torch, lambda: ma.multi_tensor_adam(*bset, 0.9, 0.999, 1e-8), 10, flush,
                      gated=True)
    del bset
    err, kset = _adam_check(torch, ma, "multi_adam", device, shapes, "float32", SEED + 15)
    # the plain version is ~2700 launches a call: summed device time instead
    plain_ms = profiled_device_ms(
        torch, lambda: ma.multi_tensor_adam_plain(*kset, 0.9, 0.999, 1e-8), 1)
    p, g, m1, m2, _ = kset
    steps = [torch.ones((), device=device) for _ in p]
    rounds = {"kernel": [], "fused_adam": []}
    for _ in range(ADAM_ROUNDS):
        rounds["kernel"].append(time_ms(
            torch, lambda: ma.multi_tensor_adam(*kset, 0.9, 0.999, 1e-8), 10, flush, gated=True))
        rounds["fused_adam"].append(time_ms(torch, lambda: torch._fused_adam_(
            p, g, m1, m2, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
            eps=1e-8, amsgrad=False, maximize=False), 10, flush, gated=True))
    ms, lib_ms = (float(np.median(rounds[k])) for k in ("kernel", "fused_adam"))
    elems = sum(int(np.prod(s)) for s in shapes)
    bound_ms, bound_by = _bound(elems * 28 + len(shapes) * 4, 12 * elems)
    log("kernel multi_adam: %d tensors, %d elements, f32 moments, the ragged set and views at "
        "offsets 1-3 and mixed equal to the plain version bit for bit; bf16 moments max err "
        "%.3g (one bf16 ulp) %.4f ms; kernel %.4f ms (device; median of %d rounds "
        "interleaved with torch._fused_adam_: %s); plain %.4f ms (profiler, device); "
        "torch._fused_adam_ %.4f ms (median: %s), kernel / _fused_adam_ %.3f; bound %.4f ms "
        "(%s)" % (len(shapes), elems, err_b, bf16_ms, ms, ADAM_ROUNDS,
                  " ".join("%.4f" % x for x in rounds["kernel"]), plain_ms, lib_ms,
                  " ".join("%.4f" % x for x in rounds["fused_adam"]), ms / lib_ms, bound_ms,
                  bound_by))
    return _entry("multi_adam", "paddle_tpu_torch/ops/csrc/multi_adam.cu",
                  "paddle_tpu/ops/pallas_kernels.py:1993", max(err, err_r), ms, plain_ms,
                  bound_ms, bound_by, lib_ms)


def check_training_kernels(torch, device, shapes):
    from paddle_tpu_torch.ops import gemm_epilogue as ge
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops import multi_adam as ma

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = {"gemm_epilogue": check_gemm(torch, ge, device, flush)}
    out["layer_norm"], out["layer_norm_grad"] = check_layer_norm(torch, ln, device, flush)
    out["multi_adam"] = check_adam(torch, ma, device, flush, shapes)
    return out


FLASH_SHAPE = (16, 8, 256, 64)  # the train-flash path's (b, h, t, d)
FLASH_LONG = (1, 2, 16384, 64)  # where the JAX package takes its streamed tiers
FLASH_GRAD_TOL = 1e-4  # rtol, and atol as a share of the plain result's largest magnitude
FLASH_BF16_TOL = 2e-2  # the JAX package's on-chip bar (tests/test_pallas_kernels.py:20-21)
FLASH_SOURCE = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
# the pair off its timed shape: (b, h, tq, tk, d), causal, dtype; tq = tk
# past a tile boundary, and causal tq < tk (bottom-right alignment)
FLASH_PAIR_CASES = (((1, 2, 16384, 16384, 64), False, "bfloat16"),
                    ((1, 2, 16384, 16384, 64), True, "bfloat16"),
                    ((1, 2, 300, 1000, 64), True, "float32"),
                    ((1, 2, 300, 1000, 64), True, "bfloat16"),
                    ((1, 2, 4097, 4097, 64), False, "float32"),
                    ((1, 2, 4097, 4097, 64), True, "float32"))


def _flash_inputs(torch, device, shape, seed):
    """q, k, v and dout as the model hands them over: (b, h, t, d) views of
    (b, t, h, d) memory, seeded."""
    rng = np.random.RandomState(seed)
    b, h, t, d = shape
    return [torch.from_numpy(rng.randn(b, t, h, d).astype("float32")).to(device).transpose(1, 2)
            for _ in range(4)]


def _flash_pairs(b, h, t, causal):
    """(query, key) pairs the work needs: all of them, or the causal lower
    triangle (tq = tk)."""
    return b * h * (t * (t + 1) // 2 if causal else t * t)


def _flash_compare(torch, fa, name, q, k, v, g, causal, scale, dtype):
    """Kernel forward and backward against the plain versions; for bf16
    against the f32 plain version on the same rounded inputs. Returns
    (forward max abs err, backward max abs err, out, lse)."""
    qd, kd, vd, gd = (x.to(dtype) for x in (q, k, v, g))
    out, lse = fa.flash_forward(qd, kd, vd, causal, scale)
    grads = fa.flash_backward(qd, kd, vd, out, lse, gd, causal, scale)
    torch.cuda.synchronize()
    f32 = [x.float() for x in (qd, kd, vd, gd)]
    pout, plse = fa.flash_forward_plain(*f32[:3], causal, scale)
    pgrads = fa.flash_backward_plain(*f32[:3], out.float(), lse, f32[3], causal, scale)
    if dtype == torch.float32:
        err_f = max(_close(torch, name + " out", out, pout, ATOL, RTOL),
                    _close(torch, name + " lse", lse, plse, ATOL, RTOL))
        err_b = max(_close(torch, name + " d" + n, got, want,
                           FLASH_GRAD_TOL * float(want.abs().max()), FLASH_GRAD_TOL)
                    for n, got, want in zip("qkv", grads, pgrads))
    else:
        err_f = _close(torch, name + " out", out, pout, FLASH_BF16_TOL, FLASH_BF16_TOL)
        err_b = 0.0
        for n, got, want in zip("qkv", grads, pgrads):
            m = max(1.0, float(want.abs().max()))
            err_b = max(err_b, _close(torch, name + " d" + n, got.float() / m, want / m,
                                      FLASH_BF16_TOL, FLASH_BF16_TOL))
    again = fa.flash_backward(qd, kd, vd, out, lse, gd, causal, scale)
    if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
        raise AssertionError("%s: the backward differs from run to run" % name)
    out2, lse2 = fa.flash_forward(qd, kd, vd, causal, scale)
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        raise AssertionError("%s: the forward differs from run to run" % name)
    return err_f, err_b, out, lse


def _flash_fwd_bounds(b, h, t, d, causal):
    """The forward's bounds over the pairs the work needs, q, k, v read and
    out, lse written once: 3xTF32's two products on the tensor cores (the
    kernel's form, and the entry's bound), and one f32 product each on the
    CUDA cores."""
    nbytes, flops = (4 * b * h * t * d + b * h * t) * 4, 4 * _flash_pairs(b, h, t, causal) * d
    return _tf32x3_bound(nbytes, flops), _bound(nbytes, flops)


def _flash_bwd_bounds(b, h, t, d, causal):
    """The backward's bounds over the pairs the work needs, each input read
    and each output written once: 3xTF32's five products on the tensor
    cores (the fused kernel's form, and the entry's bound), and one f32
    product each on the CUDA cores."""
    nbytes, flops = (8 * b * h * t * d + b * h * t) * 4, 10 * _flash_pairs(b, h, t, causal) * d
    return _tf32x3_bound(nbytes, flops), _bound(nbytes, flops)


def _tier_moved(fa, before, tier, form, n):
    """The backward launches since `before` went n times to `tier` (the
    fused kernel, or the pair: delta, then the dK/dV and dQ kernels) and
    never to the other."""
    after = fa.kernel_launches()
    want = {"fused": {"flash_bwd_fused": n, "flash_bwd_delta": 0, "flash_bwd_dkv": 0,
                      "flash_bwd_dq": 0},
            "pair": {"flash_bwd_fused": 0, "flash_bwd_delta": n, "flash_bwd_dkv": n,
                     "flash_bwd_dq": n}}[tier]
    got = {k: after[k + form] - before[k + form] for k in want}
    if got != want:
        raise AssertionError("flash backward%s: launches %s, want %s" % (form, got, want))
    return got


def _sdpa_bwd_ms(torch, q, k, v, g, causal, scale, n, flush):
    """The library call (never called by the port): SDPA's backward alone,
    from a retained graph."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal, scale=scale)
    return time_ms(torch, lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), n,
                   flush, gated=True)


def check_flash(torch, device, flush):
    """The flash kernels against their plain versions at the train-flash
    path's shape, causal and not (timed, with the library call
    scaled_dot_product_attention beside them; the backward takes the fused
    tier), at t = 16384 (the dK/dV + dQ
    pair, as the JAX package takes its streamed tiers there) and in bf16;
    returns the kernels-line entries: forward, fused backward and the pair,
    each non-causal and causal."""
    from paddle_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, t, d = FLASH_SHAPE
    scale = d ** -0.5
    entries = {}
    for causal in (False, True):
        form = "_causal" if causal else ""
        q, k, v, g = _flash_inputs(torch, device, FLASH_SHAPE, SEED + 20 + causal)
        before = fa.kernel_launches()
        err_f, err_b, out, lse = _flash_compare(torch, fa, "flash" + form, q, k, v, g, causal,
                                                scale, torch.float32)
        _tier_moved(fa, before, "fused", form, 2)
        fwd = lambda: fa.flash_forward(q, k, v, causal, scale)  # noqa: E731
        ms_f = time_ms(torch, fwd, 20, flush, gated=True)
        ms_b = time_ms(torch, lambda: fa.flash_backward(q, k, v, out, lse, g, causal, scale),
                       20, flush, gated=True)
        plain_f = time_ms(torch, lambda: fa.flash_forward_plain(q, k, v, causal, scale), 10,
                          flush, gated=True)
        plain_b = time_ms(torch, lambda: fa.flash_backward_plain(q, k, v, out, lse, g, causal,
                                                                  scale), 10, flush, gated=True)
        lib_f = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal, scale=scale), 20, flush,
                        gated=True)
        lib_b = _sdpa_bwd_ms(torch, q, k, v, g, causal, scale, 20, flush)
        bound_f, cc_f = _flash_fwd_bounds(b, h, t, d, causal)
        bound_b, cc_b = _flash_bwd_bounds(b, h, t, d, causal)
        log("kernel flash%s: (b, h, t, d) %s f32 strided views; forward (two 3xTF32 "
            "products) max_abs_err %.3g (out, lse atol=rtol=%g; repeats bit for bit) kernel "
            "%.4f ms (device); plain %.4f ms; scaled_dot_product_attention %.4f ms, kernel / "
            "SDPA %.3f; bound %.4f ms (%s, 3xTF32 on the tensor cores), f32 on the CUDA cores "
            "%.4f ms (%s) | backward, fused tier "
            "(five products, 3xTF32) max_abs_err %.3g (rtol %g, atol %g of the largest "
            "magnitude; repeats bit for bit) kernel %.4f ms; plain %.4f ms; SDPA backward "
            "%.4f ms (forward + backward %.4f ms), kernel / SDPA %.3f; bound %.4f ms (%s, 3xTF32 "
            "on the tensor cores), f32 on the CUDA cores %.4f ms (%s)" % (
                form, FLASH_SHAPE, err_f, ATOL, ms_f, plain_f, lib_f, ms_f / lib_f, bound_f[0],
                bound_f[1], cc_f[0], cc_f[1],
                err_b, FLASH_GRAD_TOL, FLASH_GRAD_TOL, ms_b, plain_b, lib_b,
                lib_f + lib_b, ms_b / lib_b, bound_b[0], bound_b[1], cc_b[0], cc_b[1]))
        entries["flash_fwd" + form] = _entry(
            "flash_fwd" + form, FLASH_SOURCE, "paddle_tpu/ops/pallas_kernels.py:129", err_f,
            ms_f, plain_f, bound_f[0], bound_f[1], lib_f)
        entries["flash_bwd" + form] = _entry(
            "flash_bwd" + form, FLASH_SOURCE, "paddle_tpu/ops/pallas_kernels.py:461", err_b,
            ms_b, plain_b, bound_b[0], bound_b[1], lib_b)
        del q, k, v, g, out, lse
    lb, lh, lt, ld = FLASH_LONG
    for causal in (False, True):
        form = "_causal" if causal else ""
        q, k, v, g = _flash_inputs(torch, device, FLASH_LONG, SEED + 22 + causal)
        before = fa.kernel_launches()
        err_f, err_b, out, lse = _flash_compare(torch, fa, "flash_long" + form, q, k, v, g,
                                                causal, scale, torch.float32)
        moved = _tier_moved(fa, before, "pair", form, 2)
        ms_f = time_ms(torch, lambda: fa.flash_forward(q, k, v, causal, scale), 5, flush,
                       gated=True)
        ms_b = time_ms(torch, lambda: fa.flash_backward(q, k, v, out, lse, g, causal, scale),
                       5, flush, gated=True)
        plain_f = time_ms(torch, lambda: fa.flash_forward_plain(q, k, v, causal, scale), 2,
                          flush, gated=True)
        plain_b = time_ms(torch, lambda: fa.flash_backward_plain(q, k, v, out, lse, g, causal,
                                                                  scale), 2, flush, gated=True)
        torch.cuda.empty_cache()
        lib_f = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal, scale=scale), 5, flush,
                        gated=True)
        lib_b = _sdpa_bwd_ms(torch, q, k, v, g, causal, scale, 5, flush)
        bound_f, cc_f = _flash_fwd_bounds(lb, lh, lt, ld, causal)
        bound_b, cc_b = _flash_bwd_bounds(lb, lh, lt, ld, causal)
        log("kernel flash%s at %s (the dK/dV + dQ pair, as the JAX package takes its streamed "
            "tiers; launches %s): forward max_abs_err %.3g, backward %.3g; kernel forward %.4f "
            "ms, backward %.4f ms; plain forward %.4f ms, backward %.4f ms; SDPA forward %.4f "
            "ms, backward %.4f ms; forward bound %.4f ms (%s, 3xTF32), f32 on the CUDA cores "
            "%.4f ms (%s); backward bound %.4f ms (%s, 3xTF32), f32 on the CUDA cores "
            "%.4f ms (%s)" % (
                form, FLASH_LONG, json.dumps(moved), err_f, err_b, ms_f, ms_b, plain_f, plain_b,
                lib_f, lib_b, bound_f[0], bound_f[1], cc_f[0], cc_f[1], bound_b[0], bound_b[1],
                cc_b[0], cc_b[1]))
        entry = _entry("flash_bwd_streamed" + form, FLASH_SOURCE,
                       "paddle_tpu/ops/pallas_kernels.py:679", err_b, ms_b, plain_b, bound_b[0],
                       bound_b[1], lib_b)
        # no main path reaches the pair (train_flash's t = 256 takes the
        # fused tier): its launches are this phase's own
        entry["launches"] = moved["flash_bwd_dkv"]
        entry["path"] = None
        entries["flash_bwd_streamed" + form] = entry
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    check_flash_pair_cases(torch, fa, device, flush)
    for causal in (False, True):
        form = "_causal" if causal else ""
        q, k, v, g = _flash_inputs(torch, device, FLASH_SHAPE, SEED + 24 + causal)
        before = fa.kernel_launches()
        err_f, err_b, _, _ = _flash_compare(torch, fa, "flash_bf16" + form, q, k, v, g, causal,
                                            scale, torch.bfloat16)
        _tier_moved(fa, before, "fused", form, 2)
        log("kernel flash%s bf16 at %s (fused backward tier) against the f32 plain version on "
            "the same rounded inputs: out max_abs_err %.3g, grads / max(1, max|want|) %.3g "
            "(atol=rtol=%g)" % (form, FLASH_SHAPE, err_f, err_b, FLASH_BF16_TOL))
    check_flash_widths(torch, fa, device)
    entries.update(check_flash_wide(torch, fa, device, flush))
    return entries


def check_flash_pair_cases(torch, fa, device, flush):
    """The dK/dV + dQ pair at FLASH_PAIR_CASES against the plain versions
    (bf16 against the f32 plain version on the same rounded inputs), each
    repeated bit for bit, its launches on the pair; the bf16 cases at t =
    16384 timed beside SDPA's bf16 backward."""
    for (b, h, tq, tk, d), causal, dt in FLASH_PAIR_CASES:
        form = "_causal" if causal else ""
        dtype = getattr(torch, dt)
        seed = SEED + 30 + tq + causal
        q, _, _, g = _flash_inputs(torch, device, (b, h, tq, d), seed)
        _, k, v, _ = _flash_inputs(torch, device, (b, h, tk, d), seed + 1)
        before = fa.kernel_launches()
        name = "flash pair %s%s (b, h, tq, tk, d) %s" % (dt, form, (b, h, tq, tk, d))
        err_f, err_b, out, lse = _flash_compare(torch, fa, name, q, k, v, g, causal, d ** -0.5,
                                                dtype)
        moved = _tier_moved(fa, before, "pair", form, 2)
        timing = ""
        if tq >= 16384:
            qd, kd, vd, gd = (x.to(dtype) for x in (q, k, v, g))
            ms = time_ms(torch, lambda: fa.flash_backward(qd, kd, vd, out, lse, gd, causal,
                                                          d ** -0.5), 5, flush, gated=True)
            lib = _sdpa_bwd_ms(torch, qd, kd, vd, gd, causal, d ** -0.5, 5, flush)
            # the five products over the pairs the work needs at the card's
            # dense bf16 rate (each input read once is far less time)
            bf16_ms = 10 * _flash_pairs(b, h, tq, causal) * d / BF16_FLOPS * 1e3
            timing = ("; kernel %.4f ms, SDPA's backward in %s %.4f ms, kernel / SDPA %.3f; "
                      "bound %.4f ms (five products at the dense bf16 rate)" % (
                          ms, dt, lib, ms / lib, bf16_ms))
            del qd, kd, vd, gd
        log("kernel %s: forward max_abs_err %.3g, backward %.3g (%s; launches %s); repeats bit "
            "for bit%s" % (name, err_f, err_b, "out, lse atol=rtol=%g, grads rtol %g with atol "
                           "%g of the largest magnitude" % (ATOL, FLASH_GRAD_TOL, FLASH_GRAD_TOL)
                           if dt == "float32" else "against the f32 plain version, %g"
                           % FLASH_BF16_TOL, json.dumps(moved), timing))
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()


FLASH_WIDTHS = (6, 8, 16, 32, 80, 96)  # head widths off the 64 / 128 the kernels once took
FLASH_WIDTH_SHAPES = ((2, 4, 200), (1, 4, 300))  # (b, h, t): the fused tier's and the pair's
FLASH_MANY_HEADS = (65600, 1, 32, 16)  # b * h past the 65535 of a grid's y axis


def check_flash_widths(torch, fa, device):
    """Forward and backward against the plain versions at every head width
    of FLASH_WIDTHS (rows of d % 4 != 0 elements load element by element),
    f32 and bf16, causal and not, at a length each backward tier takes (d <=
    64: the fused tier at t = 200, the pair at t = 300; wider: the pair at
    both), then at FLASH_MANY_HEADS; each case's launches must land on its
    tier, and both directions repeat bit for bit."""
    seed = SEED + 40
    for d in FLASH_WIDTHS:
        errs, tiers = {}, set()
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                form = "_causal" if causal else ""
                for b, h, t in FLASH_WIDTH_SHAPES:
                    seed += 1
                    q, k, v, g = _flash_inputs(torch, device, (b, h, t, d), seed)
                    tier = "fused" if fa.flash_bwd_fused_ok(t, d) else "pair"
                    before = fa.kernel_launches()
                    name = "flash d=%d %s%s t=%d" % (d, str(dtype)[6:], form, t)
                    err = _flash_compare(torch, fa, name, q, k, v, g, causal, d ** -0.5, dtype)
                    _tier_moved(fa, before, tier, form, 2)
                    tiers.add(tier)
                    key = str(dtype)[6:]
                    errs[key] = max(errs.get(key, 0.0), err[0], err[1])
        if tiers != ({"fused", "pair"} if d <= fa.FUSED_BWD_HEAD_DIM else {"pair"}):
            raise AssertionError("flash d=%d: backward tiers %s" % (d, sorted(tiers)))
        log("kernel flash at head width d=%d ((b, h, t) %s, causal and not, backward tiers %s): "
            "max_abs_err f32 %.3g (out, lse atol=rtol=%g; grads rtol %g, atol %g of the largest "
            "magnitude), bf16 %.3g (against the f32 plain version, %g); forward and backward "
            "repeat bit for bit" % (d, FLASH_WIDTH_SHAPES, sorted(tiers), errs["float32"], ATOL,
                                    FLASH_GRAD_TOL, FLASH_GRAD_TOL, errs["bfloat16"],
                                    FLASH_BF16_TOL))
    for causal in (False, True):
        form = "_causal" if causal else ""
        q, k, v, g = _flash_inputs(torch, device, FLASH_MANY_HEADS, SEED + 60 + causal)
        before = fa.kernel_launches()
        err_f, err_b, _, _ = _flash_compare(torch, fa, "flash many heads" + form, q, k, v, g,
                                            causal, 0.25, torch.float32)
        moved = _tier_moved(fa, before, "fused", form, 2)
        log("kernel flash%s at (b, h, t, d) %s, b * h = %d: forward max_abs_err %.3g, backward "
            "%.3g (launches %s); repeats bit for bit" % (
                form, FLASH_MANY_HEADS, FLASH_MANY_HEADS[0] * FLASH_MANY_HEADS[1], err_f, err_b,
                json.dumps(moved)))
        del q, k, v, g
        torch.cuda.empty_cache()


# head widths past 128: the wide forward (its query tile resident) up to
# 512, the chunked forward past it; the pair's 128-wide column blocks
FLASH_WIDE = (129, 160, 192, 256, 512, 640)
FLASH_WIDE_SHAPES = ((2, 2, 200, 200), (1, 3, 77, 150))  # (b, h, tq, tk)
FLASH_WIDE_TIMED = (16, 8, 256, 256)  # the train-flash shape at d = 256
FLASH_WIDE_TIMED_512 = (16, 8, 256, 512)  # and at d = 512 (the forward)


def time_flash_fwd(torch, fa, device, flush, shape, seed):
    """The forward kernel at `shape` f32 (strided views), non-causal: (max abs
    err against the plain version, kernel ms, plain ms, SDPA ms, 3xTF32
    bound, CUDA-core bound); the output repeats bit for bit."""
    b, h, t, d = shape
    scale = d ** -0.5
    q, k, v, _ = _flash_inputs(torch, device, shape, seed)
    out, lse = fa.flash_forward(q, k, v, False, scale)
    pout, plse = fa.flash_forward_plain(q, k, v, False, scale)
    torch.cuda.synchronize()
    name = "flash forward %s" % (shape,)
    err = max(_close(torch, name + " out", out, pout, ATOL, RTOL),
              _close(torch, name + " lse", lse, plse, ATOL, RTOL))
    out2, lse2 = fa.flash_forward(q, k, v, False, scale)
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        raise AssertionError("%s: the forward differs from run to run" % name)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(torch, lambda: fa.flash_forward(q, k, v, False, scale), 10, flush, gated=True)
    plain = time_ms(torch, lambda: fa.flash_forward_plain(q, k, v, False, scale), 5, flush,
                    gated=True)
    lib = time_ms(torch, lambda: sdpa(q, k, v, scale=scale), 10, flush, gated=True)
    tc, cc = _flash_fwd_bounds(b, h, t, d, False)
    return err, ms, plain, lib, tc, cc


def check_flash_wide(torch, fa, device, flush):
    """Forward and backward (the dK/dV + dQ pair: the fused tier stops at d
    = 64) against the plain versions at every head width of FLASH_WIDE, f32
    and bf16, causal and not, at FLASH_WIDE_SHAPES (tq = tk, and tq < tk
    with masked tails), each repeated bit for bit; then both directions
    timed at FLASH_WIDE_TIMED beside SDPA, and the forward at
    FLASH_WIDE_TIMED_512. Returns the kernels-line entries of the wide
    forward (its launches are the wide-head serve phase's) and the wide
    pair (no main path has heads past 128 in training: its launches are
    this phase's own)."""
    seed = SEED + 80
    for d in FLASH_WIDE:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                form = "_causal" if causal else ""
                for b, h, tq, tk in FLASH_WIDE_SHAPES:
                    seed += 1
                    q, _, _, g = _flash_inputs(torch, device, (b, h, tq, d), seed)
                    _, k, v, _ = _flash_inputs(torch, device, (b, h, tk, d), seed + 1000)
                    before = fa.kernel_launches()
                    name = "flash d=%d %s%s tq=%d tk=%d" % (d, str(dtype)[6:], form, tq, tk)
                    err = _flash_compare(torch, fa, name, q, k, v, g, causal, d ** -0.5, dtype)
                    _tier_moved(fa, before, "pair", form, 2)
                    key = str(dtype)[6:]
                    errs[key] = max(errs.get(key, 0.0), err[0], err[1])
        log("kernel flash at head width d=%d (the forward %s; (b, h, tq, tk) %s, causal and "
            "not, backward: the pair's 128-wide column blocks): max_abs_err f32 %.3g (out, lse atol=rtol=%g; grads "
            "rtol %g, atol %g of the largest magnitude), bf16 %.3g (against the f32 plain "
            "version, %g); forward and backward repeat bit for bit" % (
                d, "query tile resident" if d <= 512 else "chunked", FLASH_WIDE_SHAPES,
                errs["float32"], ATOL, FLASH_GRAD_TOL, FLASH_GRAD_TOL,
                errs["bfloat16"], FLASH_BF16_TOL))
    b, h, t, d = FLASH_WIDE_TIMED
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, g = _flash_inputs(torch, device, FLASH_WIDE_TIMED, SEED + 90)
    before = fa.kernel_launches()
    err_f, err_b, out, lse = _flash_compare(torch, fa, "flash_wide", q, k, v, g, False, scale,
                                            torch.float32)
    ms_f = time_ms(torch, lambda: fa.flash_forward(q, k, v, False, scale), 10, flush, gated=True)
    ms_b = time_ms(torch, lambda: fa.flash_backward(q, k, v, out, lse, g, False, scale), 5,
                   flush, gated=True)
    plain_f = time_ms(torch, lambda: fa.flash_forward_plain(q, k, v, False, scale), 5, flush,
                      gated=True)
    plain_b = time_ms(torch, lambda: fa.flash_backward_plain(q, k, v, out, lse, g, False, scale),
                      5, flush, gated=True)
    lib_f = time_ms(torch, lambda: sdpa(q, k, v, scale=scale), 10, flush, gated=True)
    lib_b = _sdpa_bwd_ms(torch, q, k, v, g, False, scale, 5, flush)
    moved = {k_: n - before[k_] for k_, n in fa.kernel_launches().items() if n != before[k_]}
    bound_f, cc_f = _flash_fwd_bounds(b, h, t, d, False)
    bound_b, cc_b = _flash_bwd_bounds(b, h, t, d, False)
    log("kernel flash_wide at (b, h, t, d) %s f32 strided views: forward max_abs_err %.3g, "
        "kernel %.4f ms (device); plain %.4f ms; SDPA %.4f ms, kernel / SDPA %.3f; bound %.4f "
        "ms (%s, 3xTF32), f32 on the CUDA cores %.4f ms (%s) | backward (the pair) max_abs_err "
        "%.3g, kernel %.4f ms; plain %.4f ms; SDPA backward %.4f ms, kernel / SDPA %.3f; bound "
        "%.4f ms (%s, 3xTF32), f32 on the CUDA cores %.4f ms (%s)" % (
            FLASH_WIDE_TIMED, err_f, ms_f, plain_f, lib_f, ms_f / lib_f, bound_f[0], bound_f[1],
            cc_f[0], cc_f[1], err_b, ms_b, plain_b, lib_b, ms_b / lib_b, bound_b[0], bound_b[1],
            cc_b[0], cc_b[1]))
    err5, ms5, plain5, lib5, tc5, cc5 = time_flash_fwd(torch, fa, device, flush,
                                                      FLASH_WIDE_TIMED_512, SEED + 91)
    log("kernel flash_wide forward at (b, h, t, d) %s f32 strided views: max_abs_err %.3g, "
        "kernel %.4f ms (device); plain %.4f ms; SDPA %.4f ms, kernel / SDPA %.3f; bound %.4f "
        "ms (%s, 3xTF32), f32 on the CUDA cores %.4f ms (%s)" % (
            FLASH_WIDE_TIMED_512, err5, ms5, plain5, lib5, ms5 / lib5, tc5[0], tc5[1], cc5[0],
            cc5[1]))
    entries = {"flash_fwd_wide": _entry(
        "flash_fwd_wide", FLASH_SOURCE, "paddle_tpu/ops/pallas_kernels.py:129", err_f, ms_f,
        plain_f, bound_f[0], bound_f[1], lib_f)}
    entry = _entry("flash_bwd_wide", FLASH_SOURCE, "paddle_tpu/ops/pallas_kernels.py:679",
                   err_b, ms_b, plain_b, bound_b[0], bound_b[1], lib_b)
    entry["launches"] = moved["flash_bwd_dkv"]
    entry["path"] = None
    entries["flash_bwd_wide"] = entry
    del q, k, v, g, out, lse
    torch.cuda.empty_cache()
    return entries


def int8_paged_case(torch, device, shared, seed):
    """Path A's inputs: pools of 1025 pages of 16 rows x 768 int8 levels
    with a per-row f32 scale, decode rows of 16 slots with per-slot tables,
    or one prefill chunk of 32 rows with a shared table."""
    rng = np.random.RandomState(seed)
    ps, n_head, d = INT8_ENGINE["page_size"], 12, 64
    feat = n_head * d
    max_pages = INT8_ENGINE["max_context"] // ps
    pool_pages = INT8_ENGINE["max_slots"] * max_pages + 1
    pools = []
    for _ in range(2):
        pools.append(rng.randint(-127, 128, (pool_pages * ps, feat)).astype(np.int8))
        pools.append((rng.rand(pool_pages * ps) * 0.05 + 1e-3).astype("float32"))
    pages = rng.permutation(np.arange(1, pool_pages)).astype(np.int32)
    if shared:
        rows = 32
        pos = np.arange(600, 600 + rows, dtype=np.int32)
        pos[-2:] = -1
        bt = np.zeros(max_pages, np.int32)
        need = pos.max() // ps + 1
        bt[:need] = pages[:need]
    else:
        rows = INT8_ENGINE["max_slots"]
        # idle slots, first row, page boundaries, partly filled last pages,
        # the last position of the context
        pos = np.array([-1, 0, 15, 16, 31, 32, 100, 333, 471, 569, 700, 871, 990, 1022, 1023,
                        -1], np.int32)
        bt = np.zeros((rows, max_pages), np.int32)
        used = 0
        for r in range(rows):
            need = pos[r] // ps + 1 if pos[r] >= 0 else 0
            bt[r, :need] = pages[used:used + need]
            used += need
    q = rng.randn(rows, feat).astype("float32")
    kp, ks, vp, vs = (torch.from_numpy(a).to(device) for a in pools)
    args = [torch.from_numpy(q).to(device), kp, vp] + [
        torch.from_numpy(a).to(device) for a in (bt, pos)]
    return args, dict(n_head=n_head, page_size=ps, k_scales=ks, v_scales=vs)


def check_int8_paged(torch, pf, device, flush):
    """Rows 3-4 at path A's shapes against the plain int8 version."""
    results = {}
    for name, (replaces, shared) in INT8_KERNEL_META.items():
        args, kw = int8_paged_case(torch, device, shared, SEED + 30 + shared)
        got = pf.paged_flash_attention(*args, **kw)
        want = pf.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = _close(torch, name, got, want, ATOL, RTOL)
        dead = args[4] < 0
        if dead.any() and float(got[dead].abs().max()) != 0.0:
            raise AssertionError("%s: pos < 0 rows are not exact zeros" % name)
        if not torch.equal(got, pf.paged_flash_attention(*args, **kw)):
            raise AssertionError("%s: the output differs from run to run" % name)
        kernel = lambda: pf.paged_flash_attention(*args, **kw)  # noqa: E731
        ms = time_ms(torch, kernel, 50, flush, gated=True)
        plain_ms = time_ms(torch, lambda: pf.paged_attention_plain(*args, **kw), 10, flush,
                           gated=True)
        q, bt, pos = args[0], args[3], args[4].tolist()
        rows, feat, ps, n_pages = q.shape[0], q.shape[1], kw["page_size"], bt.shape[-1]
        # K and V rows at 1 B an element plus a 4-byte scale each; q, out f32
        nbytes, flops, kv_rows = _paged_work(pos, shared, rows, feat, ps, n_pages, feat + 4)
        deq = 2 * kv_rows * feat  # one multiply an element, on the CUDA cores
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        if shared:  # the products as 3xTF32 on the tensor cores
            t_ops = (3 * flops / TF32_FLOPS + deq / F32_FLOPS) * 1e3
        else:
            t_ops = (flops + deq) / F32_FLOPS * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        log("kernel %s: q %s table %s int8 pools, per-row scales; max_abs_err %.3g "
            "(atol=rtol=%g; repeats bit for bit) kernel %.4f ms (device); plain %.4f ms; bound "
            "%.4f ms (%s): bytes %.5f ms, operations %.5f ms (%s)" % (
                name, tuple(q.shape), tuple(bt.shape), err, ATOL, ms, plain_ms, bound_ms,
                bound_by, t_bytes, t_ops, "q k^T and p v as 3xTF32 on the tensor cores" if shared
                else "f32 on the CUDA cores"))
        # no single PyTorch call reads a paged pool through a block table
        results[name] = _entry(name, "paddle_tpu_torch/ops/csrc/paged_flash.cu", replaces, err,
                               ms, plain_ms, bound_ms, bound_by, None)
    return results


# prefill chunks for the shared form at GPT-2 small's widths: name ->
# positions of the chunk's rows (page size 16, a 64-entry table; a stage of
# the kernel is 64 positions, a split two stages)
PAGED_CHUNKS = {
    "rows1": [600],
    "rows17": list(range(600, 617)),
    "rows32_dead_tail": list(range(600, 630)) + [-1, -1],
    "rows48": list(range(580, 628)),
    "across_stage": list(range(56, 72)),
    "across_split": list(range(112, 144)),
    "pos0": [0, 0, 1, -1],
    "dead_rows": [-1, 300, -1, 1023],
}


def check_paged_chunks(torch, pf, device):
    """The shared-table kernel against the plain version at every chunk of
    PAGED_CHUNKS, over f32 pools (the serve engine's 513 pages) and int8
    pools with per-row scales (the int8 engine's 1025 pages): atol = rtol =
    1e-5, pos < 0 rows exact zeros, the output repeated bit for bit."""
    ps, n_head, d = ENGINE["page_size"], 12, 64
    feat, n_pages = n_head * d, ENGINE["max_context"] // ps
    for quant, eng in ((False, ENGINE), (True, INT8_ENGINE)):
        rng = np.random.RandomState(SEED + 70 + quant)
        pool_pages = eng["max_slots"] * n_pages + 1
        kw = dict(n_head=n_head, page_size=ps)
        if quant:
            pools = [torch.from_numpy(rng.randint(-127, 128, (pool_pages * ps, feat))
                                      .astype(np.int8)).to(device) for _ in range(2)]
            kw.update({n: torch.from_numpy((rng.rand(pool_pages * ps) * 0.05 + 1e-3)
                                           .astype("float32")).to(device)
                       for n in ("k_scales", "v_scales")})
        else:
            pools = [torch.from_numpy(rng.randn(pool_pages * ps, feat).astype("float32"))
                     .to(device) for _ in range(2)]
        key = "paged_flash_shared" + ("_int8" if quant else "")
        errs = {}
        for name, pos in PAGED_CHUNKS.items():
            pos = np.asarray(pos, np.int32)
            bt = np.zeros(n_pages, np.int32)
            need = max(int(pos.max()) // ps + 1, 0)
            bt[:need] = rng.permutation(np.arange(1, pool_pages))[:need]
            q = rng.randn(len(pos), feat).astype("float32")
            args = [torch.from_numpy(q).to(device)] + pools + [
                torch.from_numpy(a).to(device) for a in (bt, pos)]
            before = pf.kernel_launches()[key]
            got = pf.paged_flash_attention(*args, **kw)
            torch.cuda.synchronize()
            if pf.kernel_launches()[key] != before + 1:
                raise AssertionError("%s %s: the kernel did not launch" % (key, name))
            want = pf.paged_attention_plain(*args, **kw)
            errs[name] = _close(torch, "%s %s" % (key, name), got, want, ATOL, RTOL)
            dead = args[4] < 0
            if dead.any() and float(got[dead].abs().max()) != 0.0:
                raise AssertionError("%s %s: pos < 0 rows are not exact zeros" % (key, name))
            if not torch.equal(got, pf.paged_flash_attention(*args, **kw)):
                raise AssertionError("%s %s: the output differs from run to run" % (key, name))
        chunks = {n: "%d: %d..%d" % (len(p), min(p), max(p)) for n, p in PAGED_CHUNKS.items()}
        log("kernel %s at prefill chunks (rows: positions) %s: max_abs_err %s (atol=rtol=%g); "
            "pos < 0 rows exact zeros; each repeats bit for bit" % (
                key, chunks, json.dumps({n: float("%.3g" % e) for n, e in errs.items()}), ATOL))


# the per-slot (decode) form beyond the main path's shape: slots x page
# sizes x head widths (160 takes the wide kernel past the decode kernel's
# 128) over tables of 1024 positions
DECODE_SLOTS = (1, 8, 16, 64)
DECODE_PAGE_SIZES = (8, 16, 32)
DECODE_WIDTHS = (6, 64, 80, 128, 160)


def check_paged_decode(torch, pf, device):
    """The decode form against the plain version at every DECODE_SLOTS x
    DECODE_PAGE_SIZES x DECODE_WIDTHS, over f32 pools and int8 pools with
    per-row scales: positions -1, 0, a page's last and the next page's
    first, a split boundary (127, 128), the table's last position and past
    the table, then seeded; one corrupt table entry (clamped into the pool
    by the kernel, as the JAX gather clamps: the plain version gets the
    clamped table); atol = rtol = 1e-5, pos < 0 rows exact zeros, each
    output repeated bit for bit."""
    for quant in (False, True):
        worst, n = {}, 0
        for slots in DECODE_SLOTS:
            for ps in DECODE_PAGE_SIZES:
                for d in DECODE_WIDTHS:
                    rng = np.random.RandomState(SEED + 100 + slots + ps + d + quant)
                    n_head = 2 if d > 64 else 4
                    feat, n_pages = n_head * d, 1024 // ps
                    pool_pages = n_pages + 2
                    pools = [rng.randn(pool_pages * ps, feat).astype("float32") for _ in range(2)]
                    kw = dict(n_head=n_head, page_size=ps)
                    if quant:
                        scales = [(np.abs(x).max(axis=1) / 127.0).astype("float32") for x in pools]
                        pools = [np.clip(np.round(x / sc[:, None]), -127, 127).astype(np.int8)
                                 for x, sc in zip(pools, scales)]
                        kw.update(k_scales=torch.from_numpy(scales[0]).to(device),
                                  v_scales=torch.from_numpy(scales[1]).to(device))
                    edges = [-1, 0, ps - 1, ps, 127, 128, n_pages * ps - 1, n_pages * ps + 40]
                    pos = np.array([edges[r] if r < len(edges) else rng.randint(-1, n_pages * ps)
                                    for r in range(slots)], np.int32)
                    bt = rng.randint(1, pool_pages, size=(slots, n_pages)).astype(np.int32)
                    bt[0, 0] = 10 ** 6  # corrupt
                    q = rng.randn(slots, feat).astype("float32")
                    args = [torch.from_numpy(a).to(device) for a in (q, pools[0], pools[1], bt, pos)]
                    clamped = args[:3] + [args[3].clamp(0, pool_pages - 1), args[4]]
                    key = pf.launch_key(False, d, quant)
                    name = "%s slots=%d page_size=%d d=%d" % (key, slots, ps, d)
                    before = pf.kernel_launches()[key]
                    got = pf.paged_flash_attention(*args, **kw)
                    torch.cuda.synchronize()
                    if pf.kernel_launches()[key] != before + 1:
                        raise AssertionError("%s: the kernel did not launch" % name)
                    err = _close(torch, name, got, pf.paged_attention_plain(*clamped, **kw),
                                 ATOL, RTOL)
                    wkey = "d=%d" % d
                    worst[wkey] = max(worst.get(wkey, 0.0), err)
                    dead = args[4] < 0
                    if dead.any() and float(got[dead].abs().max()) != 0.0:
                        raise AssertionError("%s: pos < 0 rows are not exact zeros" % name)
                    if not torch.equal(got, pf.paged_flash_attention(*args, **kw)):
                        raise AssertionError("%s: the output differs from run to run" % name)
                    n += 1
        log("kernel paged_flash%s at decode steps of %s slots, page sizes %s, head widths %s (%d cases; "
            "positions -1, 0, page and split boundaries, the table's last and past it; a "
            "corrupt table entry): max_abs_err by width %s (atol=rtol=%g); pos < 0 rows exact "
            "zeros; each repeats bit for bit" % (
                "_int8" * quant, DECODE_SLOTS, DECODE_PAGE_SIZES, DECODE_WIDTHS, n,
                json.dumps({k: float("%.3g" % e) for k, e in worst.items()}), ATOL))


# heads past 128 on paged pools (the wide kernel): the decode form at head
# widths 256 and 512, the shared form at chunks of 1, 32 and 48 rows and
# widths 160, 256 and 512, each at page sizes 16, 32 and 128 over tables of
# 1024 positions, f32 and int8 pools. A whole page of K and V at page size
# 128 and d = 256 (or, for a 32-row chunk, at d = 512 and page size 32)
# passes a CTA's shared memory: the kernel gathers position by position
WIDE_DECODE_WIDTHS = (256, 512)
WIDE_CHUNK_WIDTHS = (160, 256, 512)
WIDE_PAGE_SIZES = (16, 32, 128)
WIDE_CONTEXT = 1024
WIDE_SOURCE = "paddle_tpu_torch/ops/csrc/paged_flash.cu"


def _wide_chunk_pos(rows):
    """A prefill chunk's positions: one row at 1000; 32 rows across a page,
    a split (64) and a page of 128, with a pos = 0 and a pos < 0 row; 48
    rows up to the table's last position and past it, with pos = 0 and pos
    < 0 rows."""
    if rows == 1:
        return [1000]
    if rows == 32:
        return list(range(50, 80)) + [0, -1]
    return list(range(980, 1024)) + [0, -1, 1023, WIDE_CONTEXT + 40]


def wide_paged_cases():
    """(name, shared, rows or positions, d, page_size, quant) of every wide
    paged edge case."""
    cases = []
    for quant in (False, True):
        for ps in WIDE_PAGE_SIZES:
            for d in WIDE_DECODE_WIDTHS:
                cases.append(("decode d=%d page_size=%d%s" % (d, ps, " int8" * quant), False,
                              None, d, ps, quant))
            for rows in (1, 32, 48):
                for d in WIDE_CHUNK_WIDTHS:
                    cases.append(("chunk rows=%d d=%d page_size=%d%s" % (
                        rows, d, ps, " int8" * quant), True, _wide_chunk_pos(rows), d, ps, quant))
    return cases


def _wide_paged_inputs(torch, device, shared, pos, d, ps, quant, seed):
    """(args, clamped args, kwargs) of one wide case: 2 heads of d, a pool of
    the table's pages + 2, a random table with one corrupt entry on a live
    position (the kernel clamps it into the pool, as the JAX gather clamps:
    the plain version gets the clamped table). Decode slots sit at -1, 0, a
    page's last position and the next page's first, a split boundary (63,
    64), 127, the table's last position and past it."""
    rng = np.random.RandomState(seed)
    n_head, n_pages = 2, WIDE_CONTEXT // ps
    feat, pool_pages = n_head * d, n_pages + 2
    pools = [rng.randn(pool_pages * ps, feat).astype("float32") for _ in range(2)]
    kw = dict(n_head=n_head, page_size=ps)
    if quant:
        scales = [(np.abs(x).max(axis=1) / 127.0).astype("float32") for x in pools]
        pools = [np.clip(np.round(x / sc[:, None]), -127, 127).astype(np.int8)
                 for x, sc in zip(pools, scales)]
        kw.update(k_scales=torch.from_numpy(scales[0]).to(device),
                  v_scales=torch.from_numpy(scales[1]).to(device))
    if shared:
        pos = np.asarray(pos, np.int32)
        bt = rng.permutation(np.arange(1, pool_pages))[:n_pages].astype(np.int32)
        bt[1] = 10 ** 6  # corrupt: read by every chunk whose positions reach ps
    else:
        pos = np.array([-1, 0, ps - 1, ps, 63, 64, 127, WIDE_CONTEXT - 1, WIDE_CONTEXT + 40],
                       np.int32)
        bt = rng.randint(1, pool_pages, size=(len(pos), n_pages)).astype(np.int32)
        bt[7, 1] = 10 ** 6  # corrupt, in a slot that reads every entry
    q = rng.randn(len(pos), feat).astype("float32")
    args = [torch.from_numpy(a).to(device) for a in (q, pools[0], pools[1], bt, pos)]
    clamped = args[:3] + [args[3].clamp(0, pool_pages - 1), args[4]]
    return args, clamped, kw


def run_wide_paged_case(torch, pf, device, case, seed):
    """One wide case against the plain version: atol = rtol = 1e-5, pos < 0
    rows exact zeros, the output repeated bit for bit; the launch lands on
    the form's counter. Returns the max abs error; raises on any miss (and
    where the kernel cannot run the shape)."""
    name, shared, pos, d, ps, quant = case
    args, clamped, kw = _wide_paged_inputs(torch, device, shared, pos, d, ps, quant, seed)
    before = sum(pf.kernel_launches().values())
    got = pf.paged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    if sum(pf.kernel_launches().values()) != before + 1:
        raise AssertionError("%s: the kernel did not count one launch" % name)
    err = _close(torch, name, got, pf.paged_attention_plain(*clamped, **kw), ATOL, RTOL)
    dead = args[4] < 0
    if dead.any() and float(got[dead].abs().max()) != 0.0:
        raise AssertionError("%s: pos < 0 rows are not exact zeros" % name)
    if not torch.equal(got, pf.paged_flash_attention(*args, **kw)):
        raise AssertionError("%s: the output differs from run to run" % name)
    return err


def check_paged_wide(torch, pf, device):
    """Every wide_paged_cases() case against the plain version, each launch
    counted under its form's wide key."""
    worst, want = {}, {}
    cases = wide_paged_cases()
    before = pf.kernel_launches()
    for i, case in enumerate(cases):
        err = run_wide_paged_case(torch, pf, device, case, SEED + 200 + i)
        key = ("chunk" if case[1] else "decode") + (" int8" if case[5] else "")
        worst[key] = max(worst.get(key, 0.0), err)
        lk = pf.launch_key(case[1], case[3], case[5])
        want[lk] = want.get(lk, 0) + 2  # the checked call and its repeat
    moved = {k: n - before[k] for k, n in pf.kernel_launches().items() if n != before[k]}
    if moved != want:
        raise AssertionError("wide paged launches %s, want %s" % (moved, want))
    log("kernel paged_flash wide heads: %d cases (decode d %s, chunks of 1, 32, 48 rows at d "
        "%s, page sizes %s over %d positions, f32 and int8 pools; edge positions, a corrupt "
        "table entry): max_abs_err %s (atol=rtol=%g); pos < 0 rows exact zeros; each repeats "
        "bit for bit" % (len(cases), WIDE_DECODE_WIDTHS, WIDE_CHUNK_WIDTHS, WIDE_PAGE_SIZES,
                         WIDE_CONTEXT, json.dumps({k: float("%.3g" % e) for k, e in worst.items()}),
                         ATOL))


# the wide paged kernel's timed shapes: the attention widths of Gemma 7B
# (16 heads of 256; Gemma Team 2024), page_size 16, 64-entry tables; decode
# 8 slots at the serve run's last positions, prefill one 32-row chunk
WIDE_TIMED = dict(n_head=16, d=256, page_size=16, n_pages=64)
WIDE_TIMED_POS = tuple(n + NEW_TOKENS - 1 for n in PROMPT_LENS)  # 71..731
WIDE_TIMED_CHUNK = tuple(range(600, 632))


def _wide_timed_inputs(torch, device, shared, quant, seed):
    rng = np.random.RandomState(seed)
    n_head, d, ps, n_pages = (WIDE_TIMED[k] for k in ("n_head", "d", "page_size", "n_pages"))
    feat = n_head * d
    pos = np.asarray(WIDE_TIMED_CHUNK if shared else WIDE_TIMED_POS, np.int32)
    pool_pages = (1 if shared else len(pos)) * n_pages + 1
    pages = rng.permutation(np.arange(1, pool_pages)).astype(np.int32)
    bt = pages[:n_pages] if shared else pages.reshape(len(pos), n_pages)
    kw = dict(n_head=n_head, page_size=ps)
    if quant:
        pools = [torch.from_numpy(rng.randint(-127, 128, (pool_pages * ps, feat)).astype(np.int8))
                 .to(device) for _ in range(2)]
        kw.update({n: torch.from_numpy((rng.rand(pool_pages * ps) * 0.05 + 1e-3)
                                       .astype("float32")).to(device)
                   for n in ("k_scales", "v_scales")})
    else:
        pools = [torch.from_numpy(rng.randn(pool_pages * ps, feat).astype("float32")).to(device)
                 for _ in range(2)]
    q = torch.from_numpy(rng.randn(len(pos), feat).astype("float32")).to(device)
    return [q] + pools + [torch.from_numpy(a).to(device) for a in (bt, pos)], kw


def time_paged_wide(torch, pf, device, flush, strict=True):
    """The wide kernel in both forms and both pool types at WIDE_TIMED,
    against the plain version: (name -> kernels-line entry). Bound: bytes,
    the K/V rows read up to pos (int8: 1 B an element and a 4-byte scale a
    row) over the HBM rate, against q k^T and p v as f32 FMAs on the CUDA
    cores (the kernel's form). strict=False (a tool timing another tree's
    kernels) records the error instead of raising past the tolerance."""
    out = {}
    for quant in (False, True):
        for shared in (False, True):
            name = "paged_flash%s_wide%s" % ("_shared" if shared else "", "_int8" if quant else "")
            args, kw = _wide_timed_inputs(torch, device, shared, quant, SEED + 300 + len(name))
            got = pf.paged_flash_attention(*args, **kw)
            want = pf.paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            if strict:
                err = _close(torch, name, got, want, ATOL, RTOL)
            else:
                err = float((got - want).abs().max())
            if not torch.equal(got, pf.paged_flash_attention(*args, **kw)):
                raise AssertionError("%s: the output differs from run to run" % name)
            ms = time_ms(torch, lambda: pf.paged_flash_attention(*args, **kw), 50, flush,
                         gated=True)
            plain_ms = time_ms(torch, lambda: pf.paged_attention_plain(*args, **kw), 10, flush,
                               gated=True)
            q, bt, pos = args[0], args[3], args[4].tolist()
            rows, feat = q.shape
            nbytes, flops, kv_rows = _paged_work(pos, shared, rows, feat, WIDE_TIMED["page_size"],
                                                 bt.shape[-1], feat + 4 if quant else feat * 4)
            deq = 2 * kv_rows * feat if quant else 0  # one multiply an element
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = (flops + deq) / F32_FLOPS * 1e3
            bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            log("kernel %s at Gemma 7B's attention widths (16 heads x 256), q %s, table %s, "
                "page_size %d: max_abs_err %.3g (atol=rtol=%g; repeats bit for bit) kernel %.4f "
                "ms (device); plain %.4f ms; bound %.4f ms (%s): bytes %.5f ms, f32 operations "
                "%.5f ms" % (name, tuple(q.shape), tuple(bt.shape), WIDE_TIMED["page_size"], err,
                             ATOL, ms, plain_ms, bound_ms, bound_by, t_bytes, t_ops))
            replaces = INT8_KERNEL_META if quant else KERNEL_META
            base = "paged_flash%s%s" % ("_shared" if shared else "", "_int8" if quant else "")
            # no single PyTorch call reads a paged pool through a block table
            out[name] = _entry(name, WIDE_SOURCE, replaces[base][0], err, ms, plain_ms,
                               bound_ms, bound_by, None)
            del args, kw, got, want
    torch.cuda.empty_cache()
    return out

QGEMM_SHAPE = (1024, 2048, 2048)  # (m, k, n): path B's single shot through a hidden layer
QGEMM_BATCH = 256  # path B's 250-row eval batches, in their bucket
# edge grid: one row, a ragged row tile, a bucket and a whole single shot;
# k from one 16-byte step to past a ring's 128-byte stage (2064 = 16 stages
# + 16) and the e4m3 long sum (8192); n one 16-column group, or 16 past a
# 128-column tile
QGEMM_EDGE_M = (1, 17, 250, 1024)
QGEMM_EDGE_K = (16, 48, 2064, 8192)
QGEMM_EDGE_N = (16, 2064)
QGEMM_EDGE_EXTRA = ((1000, 2064, 2064),)  # a ragged 128-row CTA tile (ops/quant_gemm.py)
QGEMM_ACTS = (None, "relu", "gelu", "tanh", "sigmoid")
QGEMM_SOURCE = "paddle_tpu_torch/ops/csrc/quant_gemm.cu"
QGEMM_DESIGN = ("wgmma m64nNk32 s8 from 128-byte-swizzled shared memory in a 4-stage mbarrier "
                "ring: x and w by TMA, w transposed to K-major in shared memory by the producer "
                "warpgroup (word reads, 4 x 4 byte __byte_perm transposes, 16-byte stores); "
                "e4m3: both operands widened to f16 by the producer (wgmma's e4m3 sums keep "
                "about 13 bits), m64nNk16 f16, each 64-deep stage summed from 0 and added in f32")


def _qgemm_operands(torch, rng, form, m, k, n, device):
    """Seeded operands of one form: int8 levels in [-127, 127], or e4m3
    values of x ~ 8 N(0, 1) and w ~ N(0, 1); a bias; the form's scale."""
    if form == "int8":
        x = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8)).to(device)
        w = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8)).to(device)
        scale = torch.tensor(3.1e-6, device=device)
    else:
        f8 = torch.float8_e4m3fn
        x = torch.from_numpy(np.clip(rng.randn(m, k) * 8, -448, 448).astype("float32")).to(
            device).to(f8)
        w = torch.from_numpy(np.clip(rng.randn(k, n), -448, 448).astype("float32")).to(
            device).to(f8)
        scale = torch.tensor(0.0625, device=device)
    bias = torch.from_numpy(rng.randn(n).astype("float32")).to(device)
    return x, w, scale, bias


def _qgemm_held(torch, qg, name, form, args, act, zp):
    """One call against the plain product zp (no act): int8 z bit for bit,
    y bit for bit for relu and within 1e-5 for the transcendental acts (the
    card's erff / tanhf / expf against torch's); e4m3 z and y within rtol
    1e-5 and atol 1e-5 of max |z|; a second call equal bit for bit. Returns
    the max abs error of z."""
    from paddle_tpu_torch.ops.gemm_epilogue import ACT_F32

    z, y = qg.quant_gemm_bias_act(*args, act=act)
    z2, y2 = qg.quant_gemm_bias_act(*args, act=act)
    torch.cuda.synchronize()
    if not torch.equal(z, z2) or (act and not torch.equal(y, y2)):
        raise AssertionError("%s act %s: differs from run to run" % (name, act))
    yp = ACT_F32[act](zp) if act else None
    err = float((z - zp).abs().max())
    if form == "int8":
        if not torch.equal(z, zp) or (act == "relu" and not torch.equal(y, yp)):
            raise AssertionError("%s act %s: differs from the plain version, max abs err %g"
                                 % (name, act, err))
        if act and act != "relu":
            _close(torch, "%s act %s y" % (name, act), y, yp, 1e-5, 1e-5)
    else:
        tol = 1e-5 * float(zp.abs().max())
        _close(torch, "%s act %s z" % (name, act), z, zp, tol, 1e-5)
        if act:
            _close(torch, "%s act %s y" % (name, act), y, yp, tol, 1e-5)
    return err


def check_quant_gemm_edges(torch, qg, device):
    """Both forms at every (m, k, n) of the edge grid and every act, held
    against the plain version (int8 bit for bit, e4m3 rtol 1e-5 of max |z|),
    each call repeated bit for bit."""
    rng = np.random.RandomState(SEED + 41)
    worst = {}
    n_cases = 0
    shapes = [(m, k, n) for m in QGEMM_EDGE_M for k in QGEMM_EDGE_K for n in QGEMM_EDGE_N]
    for form in ("int8", "e4m3"):
        for m, k, n in shapes + list(QGEMM_EDGE_EXTRA):
            x, w, scale, bias = _qgemm_operands(torch, rng, form, m, k, n, device)
            zp, _ = qg.quant_gemm_bias_act_plain(x, w, scale, bias, None)
            for act in QGEMM_ACTS:
                name = "quant_gemm %s (m, k, n) %s" % (form, (m, k, n))
                err = _qgemm_held(torch, qg, name, form, (x, w, scale, bias), act, zp)
                rel = err / max(float(zp.abs().max()), 1e-30)
                worst[form] = max(worst.get(form, 0.0), rel)
                n_cases += 1
            del x, w, zp
    log("kernel quant_gemm edge grid: %d cases (int8 and e4m3 x m %s x k %s x n %s, and %s; "
        "acts %s): "
        "int8 z bit for bit (y bit for bit at relu, 1e-5 for gelu / tanh / sigmoid), e4m3 within "
        "rtol 1e-5 and atol 1e-5 of max |z| (worst max abs err / max |z|: int8 %.3g, e4m3 %.3g); "
        "every call repeats bit for bit" % (
            n_cases, QGEMM_EDGE_M, QGEMM_EDGE_K, QGEMM_EDGE_N, QGEMM_EDGE_EXTRA, list(QGEMM_ACTS),
            worst["int8"],
            worst["e4m3"]))


def check_quant_gemm(torch, device, flush):
    """Row 7 at path B's single-shot shape: int8 with relu (the hidden
    layers' form, the kernels-line entry) and with no act, bit for bit
    against the plain version; e4m3 against the plain version at rtol 1e-5
    of the largest |z|; both timed at m = 1024 and at path B's 256-row
    bucket, the wrapper's host time a call there, then the edge grid.
    Yardsticks: torch._int_mm (the int8 product alone, no epilogue) and
    torch._scaled_mm (the fp8 form without an act)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_gemm as qg

    ptxas = [ln.split(":", 1)[-1].strip() for ln in _build.build_logs.get("quant_gemm", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    log("kernel quant_gemm design: %s; ptxas: %s" % (QGEMM_DESIGN, " | ".join(ptxas[:8])))
    m, k, n = QGEMM_SHAPE
    rng = np.random.RandomState(SEED + 40)
    xi, wi, scale, bias = _qgemm_operands(torch, rng, "int8", m, k, n, device)
    entries = {}
    zp, _ = qg.quant_gemm_bias_act_plain(xi, wi, scale, bias, None)
    for act in ("relu", None):
        _qgemm_held(torch, qg, "quant_gemm int8", "int8", (xi, wi, scale, bias), act, zp)
        ms = time_ms(torch, lambda: qg.quant_gemm_bias_act(xi, wi, scale, bias, act), 20, flush,
                     gated=True)
        plain_ms = time_ms(torch, lambda: qg.quant_gemm_bias_act_plain(xi, wi, scale, bias, act),
                           5, flush, gated=True)
        lib_ms = time_ms(torch, lambda: torch._int_mm(xi, wi), 20, flush, gated=True)
        bound_ms, bound_by = _qgemm_bound(m, k, n, act)
        log("kernel quant_gemm int8 act %s: x %s @ w %s, equal to the plain version bit for bit; "
            "kernel %.4f ms (device); plain (float64 product) %.4f ms; torch._int_mm (the int8 "
            "product alone, no epilogue) %.4f ms, kernel / _int_mm %.3f; bound %.4f ms (%s)" % (
                act, (m, k), (k, n), ms, plain_ms, lib_ms, ms / lib_ms, bound_ms, bound_by))
        if act:
            entries["quant_gemm_int8"] = _entry(
                "quant_gemm_int8", QGEMM_SOURCE, "paddle_tpu/ops/pallas_kernels.py:1274", 0.0,
                ms, plain_ms, bound_ms, bound_by, lib_ms)
    del xi, wi, zp
    xf, wf, fscale, _ = _qgemm_operands(torch, rng, "e4m3", m, k, n, device)
    zp, _ = qg.quant_gemm_bias_act_plain(xf, wf, fscale, bias, None)
    err = _qgemm_held(torch, qg, "quant_gemm e4m3", "e4m3", (xf, wf, fscale, bias), None, zp)
    ms = time_ms(torch, lambda: qg.quant_gemm_bias_act(xf, wf, fscale, bias, None), 20, flush,
                 gated=True)
    plain_ms = time_ms(torch, lambda: qg.quant_gemm_bias_act_plain(xf, wf, fscale, bias, None), 5,
                       flush, gated=True)
    wcol = wf.t().contiguous().t()  # _scaled_mm takes its second operand column-major
    one = torch.ones((), device=device)
    lib_ms = time_ms(torch, lambda: torch._scaled_mm(xf, wcol, scale_a=one, scale_b=fscale,
                                                     out_dtype=torch.float32), 20, flush,
                     gated=True)
    bound_ms, bound_by = _qgemm_bound(m, k, n, None)
    launches = qg.kernel_launches()["quant_gemm_fp8"]
    log("kernel quant_gemm fp8 (e4m3): x %s @ w %s max_abs_err %.3g (rtol 1e-5 of max |z| %.4g) "
        "kernel %.4f ms (device); plain (f32 product) %.4f ms; torch._scaled_mm (no bias) %.4f ms, "
        "kernel / _scaled_mm %.3f; bound %.4f ms (%s); %d launches here" % (
            (m, k), (k, n), err, float(zp.abs().max()), ms, plain_ms, lib_ms, ms / lib_ms,
            bound_ms, bound_by, launches))
    # no main path takes the e4m3 form (fp8_matmul has fp8_gemm.cu): its
    # launches are this phase's own
    entries["quant_gemm_fp8"] = dict(_entry(
        "quant_gemm_fp8", QGEMM_SOURCE, "paddle_tpu/ops/pallas_kernels.py:1274", err, ms,
        plain_ms, bound_ms, bound_by, lib_ms), launches=launches, path=None)
    del xf, wf, zp
    # path B's bucket (64-row CTA tiles) beside the library calls
    mb = QGEMM_BATCH
    xi, wi, scale, bias = _qgemm_operands(torch, rng, "int8", mb, k, n, device)
    xf, wf, fscale, _ = _qgemm_operands(torch, rng, "e4m3", mb, k, n, device)
    ms_i = time_ms(torch, lambda: qg.quant_gemm_bias_act(xi, wi, scale, bias, "relu"), 20, flush,
                   gated=True)
    ms_f = time_ms(torch, lambda: qg.quant_gemm_bias_act(xf, wf, fscale, bias, None), 20, flush,
                   gated=True)
    lib_i = time_ms(torch, lambda: torch._int_mm(xi, wi), 20, flush, gated=True)
    wcol = wf.t().contiguous().t()
    lib_f = time_ms(torch, lambda: torch._scaled_mm(xf, wcol, scale_a=one, scale_b=fscale,
                                                    out_dtype=torch.float32), 20, flush,
                    gated=True)
    log("kernel quant_gemm at m = %d (path B's bucket), k = n = %d: int8 + relu %.4f ms, "
        "torch._int_mm %.4f, bound %.4f ms; e4m3 %.4f ms, torch._scaled_mm %.4f, bound %.4f ms" % (
            mb, k, ms_i, lib_i, _qgemm_bound(mb, k, n, "relu")[0], ms_f, lib_f,
            _qgemm_bound(mb, k, n, None)[0]))
    del xi, wi, xf, wf
    log("kernel quant_gemm host time a wrapper call at m = %d, int8 + relu: %.2f us (median of "
        "5 runs of 100 calls, host clock)" % (mb, qgemm_host_us(torch, device)))
    check_quant_gemm_edges(torch, qg, device)
    return entries


def qgemm_host_us(torch, device):
    """Host microseconds a quant_gemm_bias_act call takes at path B's bucket
    (int8 + relu, 256 x 2048 @ 2048 x 2048): the median over 5 runs of 100
    calls queued without a sync between them (the card runs each in about
    20 us, so the launch queue never fills and the host clock reads the
    wrapper's own work)."""
    from paddle_tpu_torch.ops import quant_gemm as qg

    _, k, n = QGEMM_SHAPE
    x, w, scale, bias = _qgemm_operands(torch, np.random.RandomState(SEED + 42), "int8",
                                        QGEMM_BATCH, k, n, device)
    runs = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            qg.quant_gemm_bias_act(x, w, scale, bias, "relu")
        runs.append((time.perf_counter() - t) * 1e4)
    torch.cuda.synchronize()
    return sorted(runs[1:])[2]  # the first run warms


def _qgemm_bound(m, k, n, act):
    """Each 1-byte operand read once, bias and scale read once, z (and y)
    written once; 2mnk operations at the int8 / fp8 tensor-core rate."""
    nbytes = m * k + k * n + 4 * n + 4 + (2 if act else 1) * m * n * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * m * n * k / INT8_TOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# fp8_matmul (FLAGS_fp8_matmul's products): the bf16 Transformer base's
# products that the flag takes (the attention projections, q k^T and p v of
# 16 x 8 heads, the FFN products the generic grads replay, the vocab
# projection, whose n = 37000 is 8 past a multiple of 16), then edges: m 1
# to 1024, k 1 to 4096 (4095: k % 16 != 0), n 1 to 2064, y broadcast over
# a batch of x (twice) and x broadcast over a batch of y
FP8_MM_PATH = (((4096, 512), (512, 512)), ((16, 8, 256, 64), (16, 8, 64, 256)),
               ((16, 8, 256, 256), (16, 8, 256, 64)), ((4096, 512), (512, 2048)),
               ((4096, 2048), (2048, 512)), ((4096, 512), (512, 37000)))
FP8_MM_EDGES = (((1, 1), (1, 1)), ((1, 4096), (4096, 2064)), ((17, 37), (37, 5)),
                ((250, 48), (48, 2064)), ((1024, 4095), (4095, 33)),
                ((1000, 2064), (2064, 2064)), ((3, 100, 20), (20, 130)),
                ((4, 6, 20), (20, 5)), ((100, 20), (3, 20, 130)))
FP8_MM_TIMED = ((4096, 512), (512, 512))  # the commonest product of an fp8 step
FP8_MM_VOCAB = ((4096, 512), (512, 37000))  # the vocab projection, the largest
FP8_MM_RTOL = 1e-5  # of max |out|: the same e4m3 values, f32 sums in another order
# the gradients against the plain backward: at least this share equal, and
# each value within one e4m3 ulp (where the two f32 sums, in another order,
# fall on either side of a rounding boundary) plus FP8_MM_RTOL of max |out|
# (the forward's bar on those sums: a sum that cancels to near zero keeps
# their rounding, which one ulp there does not cover; on an H100 the plain
# backward's own value of such a sum was an ulp off its float64 sum)
FP8_GRAD_EQUAL = 0.999
FP8_SOURCE = "paddle_tpu_torch/ops/csrc/fp8_gemm.cu"
FP8_REPLACES = "paddle_tpu/ops/pallas_kernels.py:1393"


def _fp8_operands(torch, device, xs, ys, dtype, seed, past_448=True, scale=40.0):
    """Seeded operands ~ scale N(0, 1) (40: across e4m3's range); with
    past_448, x[..., 0, 0] = 500 (a NaN row) and y[..., -1, -1] = -1e4 (a
    NaN column) where the operand keeps other rows or columns finite."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(xs, device=device, generator=gen) * scale
    y = torch.randn(ys, device=device, generator=gen) * scale
    if past_448 and xs[-2] > 1:
        x[..., 0, 0] = 500.0
    if past_448 and ys[-1] > 1:
        y[..., -1, -1] = -1e4
    return x.to(dtype), y.to(dtype)


def _fp8_held(torch, qg, x, y):
    """fp8_matmul's forward kernel against fp8_matmul_plain: NaN where the
    plain version has NaN, f32 within FP8_MM_RTOL of max |out|, bf16 within
    one bf16 ulp (or that bar where it is larger); a second call equal bit
    for bit, one launch each. Returns (the max abs error over the finite
    outputs, that error as a share of max |out|)."""
    before = qg.kernel_launches()
    got, again = qg.fp8_matmul(x, y), qg.fp8_matmul(x, y)
    after = qg.kernel_launches()
    want = qg.fp8_matmul_plain(x, y)
    torch.cuda.synchronize()
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    name = "fp8_matmul %s @ %s %s" % (tuple(x.shape), tuple(y.shape), x.dtype)
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if got.numel() and x.shape[-1] and moved != {"fp8_matmul": 2}:
        raise AssertionError("%s: launches %s, want two of the forward alone" % (name, moved))
    if got.dtype != x.dtype or got.shape != want.shape:
        raise AssertionError("%s: %s %s, want %s %s" % (name, got.dtype, tuple(got.shape),
                                                        x.dtype, tuple(want.shape)))
    if not torch.equal(got.view(bits), again.view(bits)):
        raise AssertionError("%s: differs from run to run" % name)
    g, w = got.float(), want.float()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError("%s: NaN where the plain version has none, or none where it has" %
                             name)
    ok = ~torch.isnan(w)
    if not bool(ok.any()):
        return 0.0, 0.0
    scale = float(w[ok].abs().max())
    err = (g - w)[ok].abs()
    bar = torch.full_like(err, FP8_MM_RTOL * scale)
    if x.dtype == torch.bfloat16:
        ulp = torch.pow(2.0, torch.floor(torch.log2(w[ok].abs().clamp(min=1e-30))) - 7)
        bar = torch.maximum(bar, ulp)
    if bool((err > bar).any()):
        raise AssertionError("%s: %d values past the bar, max abs err %g (max |out| %g)"
                             % (name, int((err > bar).sum()), float(err.max()), scale))
    return float(err.max()), float(err.max()) / max(scale, 1e-30)


def _e4m3_ulp(torch, v):
    """One e4m3 ulp at each |v|: 2^(exponent - 3), 2^-9 among the
    subnormals."""
    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -6)))
    return torch.pow(2.0, e - 3)


def _fp8_grad_g(torch, x, y, seed, scale=40.0):
    """A seeded g for operands ~ scale N(0, 1): scaled so that the gradients
    are about 64 (the sums over the longest reduction, batch included),
    inside e4m3's range but for the NaN rows and columns of values past
    448."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    batch = torch.broadcast_shapes(tuple(x.shape[:-2]), tuple(y.shape[:-2]))
    red = max(x.shape[-2], y.shape[-1]) * max(1, math.prod(batch))
    return (torch.randn(tuple(batch) + (x.shape[-2], y.shape[-1]), device=x.device, generator=gen)
            * (64.0 / (scale * math.sqrt(red)))).to(x.dtype)


def _fp8_grads_held(torch, qg, x, y, seed):
    """fp8_matmul's gradient (the dx and dy forms for bf16, the library
    products and the rounding kernel for f32) against
    fp8_matmul_grads_plain on _fp8_grad_g's g: NaN where the plain version
    has NaN, each value within one e4m3 ulp plus FP8_MM_RTOL of max |out|,
    at least FP8_GRAD_EQUAL of them equal; repeated bit for bit. Returns
    ({"dx": share equal, "dy": ...}, the launches of one backward)."""
    g = _fp8_grad_g(torch, x, y, seed)
    xr, yr = x.detach().requires_grad_(), y.detach().requires_grad_()
    before = qg.kernel_launches()
    got = torch.autograd.grad(qg.fp8_matmul(xr, yr), (xr, yr), g)
    again = torch.autograd.grad(qg.fp8_matmul(xr, yr), (xr, yr), g)
    after = qg.kernel_launches()
    want = qg.fp8_matmul_grads_plain(x, y, g)
    torch.cuda.synchronize()
    name = "fp8_matmul grad %s @ %s %s" % (tuple(x.shape), tuple(y.shape), x.dtype)
    shares = {}
    for label, a, b, w, t in zip(("dx", "dy"), got, again, want, (x, y)):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        if a.dtype != t.dtype or a.shape != t.shape:
            raise AssertionError("%s %s: %s %s" % (name, label, a.dtype, tuple(a.shape)))
        if not torch.equal(a.view(bits), b.view(bits)):
            raise AssertionError("%s %s: differs from run to run" % (name, label))
        a32, w32 = a.float(), w.float()
        if not torch.equal(torch.isnan(a32), torch.isnan(w32)):
            raise AssertionError("%s %s: NaN where the plain version has none, or none where it "
                                 "has" % (name, label))
        ok = ~torch.isnan(w32)
        if not bool(ok.any()):
            shares[label] = 1.0
            continue
        err = (a32 - w32)[ok].abs()
        ulp = (_e4m3_ulp(torch, torch.maximum(a32[ok].abs(), w32[ok].abs()))
               + FP8_MM_RTOL * float(w32[ok].abs().max()))
        if bool((err > ulp).any()):
            # the worst value beside its sum in float64 from the same rounded
            # operands, before the output's rounding
            i = int(torch.nonzero(ok.reshape(-1)).reshape(-1)[int(torch.argmax(err - ulp))])
            x8, y8 = (qg.e4m3_round_plain(v).double() for v in (x, y))
            exact = (torch.matmul(g.double(), y8.transpose(-1, -2)) if label == "dx"
                     else torch.matmul(x8.transpose(-1, -2), g.double()))
            exact = qg.reduce_grad_to_shape(exact, t.shape).reshape(-1)[i]
            raise AssertionError("%s %s: %d values past one e4m3 ulp and the sums' bar (max abs "
                                 "err %g); "
                                 "the worst, flat index %d: kernel %r, plain %r, its float64 "
                                 "sum %r" % (name, label, int((err > ulp).sum()), float(err.max()),
                                             i, float(a32.reshape(-1)[i]),
                                             float(w32.reshape(-1)[i]), float(exact)))
        shares[label] = float((err == 0).float().mean())
        if shares[label] < FP8_GRAD_EQUAL:
            raise AssertionError("%s %s: %.5f of the values equal, under %g"
                                 % (name, label, shares[label], FP8_GRAD_EQUAL))
    moved = {k: (after[k] - before[k]) // 2 for k in after if after[k] != before[k]}
    return shares, moved


def _fp8_grad_bound(m, k, n):
    """dx = e4m3(g @ y8^T) or dy = e4m3(x8^T @ g), the same work: g [m, n],
    the rounded operand and the result bf16, each read or written once;
    2mnk operations at the bf16 tensor-core rate."""
    nbytes = 2 * (m * n + k * n + m * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * m * n * k / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_fp8_matmul(torch, device, flush):
    """fp8_matmul (row 15: pallas_kernels.py:1393) on fp8_gemm.cu: the
    forward (one launch, the cast in the producer) held against its plain
    version at the bf16 Transformer's products and the edges, f32 and bf16
    operands, values past 448; the gradient against the plain backward at
    the same shapes (bf16: the dx and dy forms; f32: library products and
    the rounding kernel); the rounding kernel against e4m3_round_plain bit
    for bit. Timed: the forward at FP8_MM_TIMED in bf16 beside
    torch._scaled_mm (the product of operands already in e4m3, no cast),
    dx and dy there and at the vocab shape beside the f32 torch.matmul with
    plain rounding that they replace."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_gemm as qg

    ptxas = [ln.split(":", 1)[-1].strip() for ln in _build.build_logs.get("fp8_gemm", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    log("kernel fp8_gemm ptxas: %s" % " | ".join(ptxas))
    worst, equal, n_cases, launches = {}, {}, 0, set()
    for i, (xs, ys) in enumerate(FP8_MM_PATH + FP8_MM_EDGES):
        for dtype in (torch.float32, torch.bfloat16):
            x, y = _fp8_operands(torch, device, xs, ys, dtype, SEED + 60 + i)
            rel = _fp8_held(torch, qg, x, y)[1]
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), rel)
            shares, moved = _fp8_grads_held(torch, qg, x, y, SEED + 160 + i)
            for k, v in shares.items():
                key = "%s %s" % (k, str(dtype)[6:])
                equal[key] = min(equal.get(key, 1.0), v)
            launches.add("%s %s" % (str(dtype)[6:], sorted(moved)))
            n_cases += 1
            del x, y
    # the rounding kernel alone: bit for bit with the plain rounding
    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    t = (torch.randn(3, 37, 45, device=device, generator=gen)
         * torch.logspace(-4, 3, 45, device=device))
    t[0, 0, :6] = torch.tensor([464.0, 464.01, -448.5, float("inf"), float("nan"), -0.0])
    for dtype in (torch.float32, torch.bfloat16):
        td = t.to(dtype)
        got = qg.e4m3_round(td).float()
        want = qg.e4m3_round_plain(td)
        torch.cuda.synchronize()
        ok = ~torch.isnan(want)
        if (not torch.equal(torch.isnan(got), ~ok)
                or not torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))):
            raise AssertionError("e4m3_round %s: differs from the plain rounding" % dtype)
    log("kernel fp8_matmul: %d cases (the bf16 Transformer's products %s and the edges %s, f32 "
        "and bf16 operands, values past 448) held against the plain version: NaN where it has "
        "NaN, worst max abs err / max |out| %s (bar: f32 %g of max |out|, bf16 one bf16 ulp), "
        "one forward launch a call; the gradient against the plain backward: NaN where it "
        "has NaN, every value within one e4m3 ulp plus the forward's f32 bar, the least share "
        "equal %s (bar %g), the "
        "launches of a backward %s; every call repeats bit for bit; the rounding kernel equals "
        "the plain rounding bit for bit (f32 and bf16, ties, subnormals, 464 / 464.01, inf, "
        "NaN, -0)" % (n_cases, [s for s in FP8_MM_PATH], [s for s in FP8_MM_EDGES],
                      json.dumps(worst), FP8_MM_RTOL, json.dumps(equal), FP8_GRAD_EQUAL,
                      sorted(launches)))

    (m, k), (_, n) = FP8_MM_TIMED
    x, y = _fp8_operands(torch, device, (m, k), (k, n), torch.bfloat16, SEED + 71,
                         past_448=False, scale=1.0)
    err = _fp8_held(torch, qg, x, y)[0]
    ms = time_ms(torch, lambda: qg.fp8_matmul(x, y), 20, flush, gated=True)
    plain_ms = time_ms(torch, lambda: qg.fp8_matmul_plain(x, y), 10, flush, gated=True)
    x8, y8 = x.to(torch.float8_e4m3fn), y.to(torch.float8_e4m3fn)
    ycol = y8.t().contiguous().t()  # _scaled_mm takes its second operand column-major
    one = torch.ones((), device=device)
    lib_ms = time_ms(torch, lambda: torch._scaled_mm(x8, ycol, scale_a=one, scale_b=one,
                                                     out_dtype=torch.bfloat16), 20, flush,
                     gated=True)
    nbytes = 2 * (m * k + k * n + m * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * m * n * k / BF16_FLOPS
    bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    log("kernel fp8_matmul: x %s @ y %s bf16 -> bf16, max abs err %.3g; %.4f ms (device, one "
        "launch, the casts in the producer), plain (the rounding, an f32 matmul) %.4f ms; "
        "torch._scaled_mm on operands already in e4m3 (the product alone, bf16 out) %.4f ms, "
        "fp8_matmul / _scaled_mm %.3f; bound %.4f ms (%s: %d bytes %.4f ms, 2mnk at the 16-bit "
        "rate %.4f ms)" % ((m, k), (k, n), err, ms, plain_ms, lib_ms, ms / lib_ms, bound_ms,
                           bound_by, nbytes, t_bytes * 1e3, t_ops * 1e3))
    entries = {"fp8_matmul": _entry("fp8_matmul", FP8_SOURCE, FP8_REPLACES, err, ms, plain_ms,
                                    bound_ms, bound_by, lib_ms)}
    del x8, y8, ycol
    # the gradient forms at FP8_MM_TIMED and at the vocab shape; the last
    # shape's times go into the kernels line
    for (m, k), (_, n) in (FP8_MM_TIMED, FP8_MM_VOCAB):
        x, y = _fp8_operands(torch, device, (m, k), (k, n), torch.bfloat16, SEED + 72,
                             past_448=False, scale=1.0)
        g = _fp8_grad_g(torch, x, y, SEED + 73, scale=1.0)
        for label, need in (("dx", (True, False)), ("dy", (False, True))):
            ms = time_ms(torch, lambda: qg._fp8_grads_cuda(x, y, g, need), 10, flush, gated=True)
            plain_ms = time_ms(torch, lambda: qg.fp8_matmul_grads_plain(x, y, g, need), 5, flush,
                               gated=True)
            # the product alone on operands already rounded, bf16 out
            a, b = ((g, qg.e4m3_round(y).t()) if label == "dx"
                    else (qg.e4m3_round(x).t(), g))
            lib_ms = time_ms(torch, lambda: torch.matmul(a, b), 10, flush, gated=True)
            bound_ms, bound_by = _fp8_grad_bound(m, k, n)
            i = 0 if label == "dx" else 1
            got = qg._fp8_grads_cuda(x, y, g, need)[i].float()
            want = qg.fp8_matmul_grads_plain(x, y, g, need)[i].float()
            torch.cuda.synchronize()
            if not torch.equal(torch.isnan(got), torch.isnan(want)):
                raise AssertionError("fp8_matmul %s at %s: NaN where the plain backward has none, "
                                     "or none where it has" % (label, ((m, k), (k, n))))
            ok = ~torch.isnan(want)
            gerr = float((got - want)[ok].abs().max()) if bool(ok.any()) else 0.0
            log("kernel fp8_matmul %s: x %s @ y %s bf16, g bf16: %.4f ms (device, one launch), "
                "the f32 torch.matmul with plain rounding it replaces %.4f ms (%.2fx); the bf16 "
                "torch.matmul on operands already rounded (no e4m3 output) %.4f ms; bound %.4f "
                "ms (%s); max abs err against the plain backward %.3g" % (
                    label, (m, k), (k, n), ms, plain_ms, plain_ms / ms, lib_ms, bound_ms,
                    bound_by, gerr))
            entries["fp8_matmul_" + label] = _entry(
                "fp8_matmul_" + label, FP8_SOURCE, FP8_REPLACES, gerr, ms, plain_ms, bound_ms,
                bound_by, lib_ms)
            del a, b, got, want
        del x, y, g
    # the rounding kernel at x of FP8_MM_TIMED (the f32 gradients' pass)
    (m, k), _ = FP8_MM_TIMED
    xr = _fp8_operands(torch, device, (m, k), (k, 1), torch.float32, SEED + 74)[0]
    r_ms = time_ms(torch, lambda: qg.e4m3_round(xr), 20, flush, gated=True)
    r_plain = time_ms(torch, lambda: qg.e4m3_round_plain(xr), 10, flush, gated=True)
    r_lib = time_ms(torch, lambda: xr.to(torch.float8_e4m3fn), 20, flush, gated=True)
    r_bound = 8.0 * m * k / HBM_BYTES_PER_S * 1e3
    log("kernel e4m3_round: %s f32 -> f32 %.4f ms (device), plain %.4f ms, .to(float8_e4m3fn) "
        "(saturating, 1-byte out) %.4f ms, bound %.4f ms (bytes)" % (
            (m, k), r_ms, r_plain, r_lib, r_bound))
    # the f32 gradients' pass: on no main path of the bf16 steps, so its
    # launches are this phase's own
    entries["e4m3_round"] = dict(_entry("e4m3_round", FP8_SOURCE, FP8_REPLACES, 0.0, r_ms,
                                        r_plain, r_bound, "bytes", r_lib),
                                 launches=qg.kernel_launches()["e4m3_round"], path=None)
    del xr
    return entries


# ---------------------------------------------------------------- phase 3


def timed(fn, sink):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    return wrapper


def op_by_op():
    """The op-by-op path: FLAGS_profile_ops inside profiler.profiler(), the
    only way to it on the card (every op lowered eagerly, a device sync
    after each)."""
    from paddle_tpu_torch.tools.profile_generation import op_by_op as ctx

    return ctx()


def _schedule(engine, pf, prompts, new_tokens, timeout=600):
    """Every prompt through a GenerationScheduler over `engine`: every
    request must finish with new_tokens tokens. Returns (results, their
    reading: tokens/s over the run and the decode step and prefill chunk
    walls, the paged kernels' launches over the run)."""
    from paddle_tpu_torch.serving import GenerationScheduler

    # per-call host wall time of the engine's two step kinds (each ends in
    # the logits copy to the host, so it includes the device work)
    step_ms, chunk_ms = [], []
    engine.decode_step = timed(engine.decode_step, step_ms)
    engine.prefill_step = timed(engine.prefill_step, chunk_ms)
    sched = GenerationScheduler(engine, max_queue_requests=64, timeout_ms=timeout * 1e3)
    try:
        pf.reset_kernel_launches()  # the main path's counting window opens here
        t0 = time.perf_counter()
        futs = [sched.submit(p, max_new_tokens=new_tokens, eos_id=NO_EOS) for p in prompts]
        results = [f.result(timeout) for f in futs]
        wall = time.perf_counter() - t0
        launches = pf.kernel_launches()  # and closes here
    finally:
        assert sched.close(drain=True)
        del engine.decode_step, engine.prefill_step
    for p, r in zip(prompts, results):
        if r.finish_reason != "length" or len(r.tokens) != new_tokens:
            raise AssertionError("%s: request of %d tokens: %r %d tokens" % (
                engine.name, len(p), r.finish_reason, len(r.tokens)))
    n_tok = sum(len(r.tokens) for r in results)
    reading = {"requests": len(results), "new_tokens": n_tok, "wall_s": wall,
               "tokens_per_s": n_tok / wall, "decode_p50_ms": float(np.median(step_ms)),
               "decode_steps": len(step_ms), "prefill_p50_ms": float(np.median(chunk_ms)),
               "prefill_chunks": len(chunk_ms)}
    return results, reading, launches


def _path_line(reading):
    return ("%d requests, %d new tokens in %.3f s: %.1f tokens/s; decode step p50 %.3f ms over "
            "%d steps; prefill chunk p50 %.3f ms over %d chunks" % (
                reading["requests"], reading["new_tokens"], reading["wall_s"],
                reading["tokens_per_s"], reading["decode_p50_ms"], reading["decode_steps"],
                reading["prefill_p50_ms"], reading["prefill_chunks"]))


def _op_by_op_serve(engine, pf, prompts, new_tokens, results, label, card):
    """The same requests on the op-by-op path, with no prefix-cache hits
    (the graph run had none): the same greedy tokens. Returns its reading."""
    saved, engine.prefix_cache = engine.prefix_cache, None
    try:
        with op_by_op():
            eager, reading, _ = _schedule(engine, pf, prompts, new_tokens)
    finally:
        engine.prefix_cache = saved
    for i, (a, b) in enumerate(zip(results, eager)):
        if a.tokens != b.tokens:
            raise AssertionError("%s: request %d: graph and op-by-op tokens differ" % (label, i))
    log("%s, op by op: %s; the same tokens as the graph path; card %s"
        % (label, _path_line(reading), card))
    return reading


def _stepwise_calls(engine, pf, prompt, n_new):
    """One request run alone: (logits, paged kernel launches) of every engine
    call (each prefill chunk, then each decode step)."""
    from paddle_tpu_torch.serving import GenRequest

    calls, call = [], engine._call

    def recorded(variant, feeds):
        before = pf.kernel_launches()
        out = call(variant, feeds)
        after = pf.kernel_launches()
        calls.append((out[0].copy(), {k: after[k] - before[k] for k in after if after[k] - before[k]}))
        return out

    engine._call = recorded
    run = engine.start(GenRequest(prompt, max_new_tokens=n_new, eos_id=NO_EOS))
    try:
        while not run.done:
            engine.decode_step([run])
    finally:
        engine.finish(run)
        del engine._call
    return calls


def graph_vs_op_by_op(engine, pf, prompt, n_new, label):
    """A request run alone on the graph path and on the op-by-op path, with no
    prefix-cache hits: every call's logits bit for bit, and its paged kernel
    launches equal."""
    saved, engine.prefix_cache = engine.prefix_cache, None
    try:
        got = _stepwise_calls(engine, pf, prompt, n_new)
        with op_by_op():
            want = _stepwise_calls(engine, pf, prompt, n_new)
    finally:
        engine.prefix_cache = saved
    if len(got) != len(want):
        raise AssertionError("%s: %d graph calls, %d op by op" % (label, len(got), len(want)))
    for i, ((g, gl), (w, wl)) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError("%s: call %d: graph and op-by-op logits differ (max abs %g)" % (
                label, i, float(np.abs(g - w).max()) if g.shape == w.shape else float("nan")))
        if gl != wl or not gl:
            raise AssertionError("%s: call %d: launches %s on the graph path, %s op by op"
                                 % (label, i, gl, wl))
    chunks = -(-len(prompt) // engine.prefill_chunk)
    log("%s: graph vs op by op, a %d-token prompt alone: %d prefill chunks and %d decode steps, "
        "logits bit for bit, paged kernel launches equal in every call (%s a decode step)" % (
            label, len(prompt), chunks, len(got) - chunks, json.dumps(got[-1][1])))


def serve(torch, pf, engine, card, readings):
    rng = np.random.RandomState(SEED)
    prompts = [
        rng.randint(2, GPT2_SMALL["vocab_size"], size=n).tolist() for n in PROMPT_LENS
    ]
    traces = (engine.traces, engine.captures())
    results, graph, launches = _schedule(engine, pf, prompts, NEW_TOKENS)
    launches = {k: v for k, v in launches.items() if k in KERNEL_META}
    if (engine.traces, engine.captures()) != traces:
        raise AssertionError("variants prepared or captured after warmup: %s -> %s"
                             % (traces, (engine.traces, engine.captures())))
    if not all(launches.values()):
        raise AssertionError("a kernel never launched on the main path: %s" % launches)
    for i in (0, len(prompts) - 1):
        want = engine.generate(prompts[i], max_new_tokens=NEW_TOKENS, eos_id=NO_EOS)
        if want.tokens != results[i].tokens:
            raise AssertionError("request %d: scheduler tokens differ from serial generate" % i)
    if not np.all(np.isfinite(engine.last_logits)):
        raise AssertionError("non-finite decode logits")
    log("serve: %d prompt tokens; graph path (%d variants captured at warmup): %s; kernel "
        "launches %s; card %s" % (sum(PROMPT_LENS), engine.captures(), _path_line(graph),
                                  json.dumps(launches), card))
    eager = _op_by_op_serve(engine, pf, prompts, NEW_TOKENS, results, "serve", card)
    graph_vs_op_by_op(engine, pf, prompts[1], 8, "serve")
    readings["serve"] = {"graph": graph, "op_by_op": eager}
    return launches


# ---------------------------------------------------------------- phase 4


def paged_vs_dense(torch, engine, model=GPT2_SMALL):
    """The engine's paged prefill and decode logits against the dense
    program, then the fuse_attention rewrite against the unfused program.
    Returns the forward kernel's launches in the rewritten program's run."""
    from paddle_tpu_torch.executor import aot_serve_lowering, scope_guard
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.passes import PassManager
    from paddle_tpu_torch.serving import GenRequest

    T = 64
    main, _, feeds, fetches = engine.model.build_forward(1, T)
    with scope_guard(engine.scope):
        dense, ro, _ = aot_serve_lowering(main, feeds, fetches, engine.scope)

    def dense_row(tokens):
        buf = np.zeros((1, T, 1), np.int64)
        buf[0, :len(tokens), 0] = tokens
        (lg,) = dense({"fwd_tokens": buf}, ro, {})
        return lg[0, len(tokens) - 1].cpu().numpy()

    prompt = np.random.RandomState(SEED + 1).randint(2, model["vocab_size"], 40).tolist()
    run = engine.start(GenRequest(prompt, max_new_tokens=T - len(prompt), eos_id=NO_EOS))
    rows, seq = [engine.last_prefill_logits], list(prompt)
    try:
        while not run.done:
            engine.decode_step([run])
            rows.append(engine.last_logits[run.slot])
    finally:
        engine.finish(run)
    err = 0.0
    for step, row in enumerate(rows):
        want = dense_row(seq)
        if row.shape != want.shape or not np.all(np.isfinite(row)):
            raise AssertionError("step %d: bad logits %s" % (step, row.shape))
        err = max(err, float(np.abs(row - want).max()))
        if not np.allclose(row, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
            raise AssertionError("step %d: paged vs dense max abs err %g" % (step, err))
        seq.append(run.tokens[step])
    log("paged vs dense: %d steps (prefill + decode to %d tokens), max abs logit err %.3g "
        "(atol=rtol=%g)" % (len(rows), T, err, LOGIT_ATOL))

    # the fuse_attention pass on the same dense program: one flash_attention
    # op per layer, through the forward kernel, the same logits
    fused = PassManager(["fuse_attention"]).apply(main, scope=engine.scope, feed_names=feeds,
                                                  fetch_names=fetches)
    types = [op.type for op in fused.global_block().ops]
    n_layer = model["n_layer"]
    if types.count("flash_attention") != n_layer or "softmax" in types:
        raise AssertionError("fuse_attention: %d flash_attention ops, softmax %s"
                             % (types.count("flash_attention"), "softmax" in types))
    with scope_guard(engine.scope):
        flash, fro, _ = aot_serve_lowering(fused, feeds, fetches, engine.scope)
    buf = np.asarray(seq[:T], np.int64).reshape(1, T, 1)
    (want,) = dense({"fwd_tokens": buf}, ro, {})
    fa.reset_kernel_launches()
    (got,) = flash({"fwd_tokens": buf}, fro, {})
    torch.cuda.synchronize()
    launches = fa.kernel_launches()["flash_fwd_causal"]
    if launches != n_layer:
        raise AssertionError("fuse_attention: the forward kernel launched %d times, want %d"
                             % (launches, n_layer))
    ferr = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise AssertionError("fuse_attention vs unfused logits: max abs err %g" % ferr)
    log("fuse_attention: %d score chains -> flash_attention, no softmax left; %d forward "
        "kernel launches; logits over %d positions max abs err %.3g against the unfused "
        "program (atol=rtol=%g)" % (n_layer, launches, T, ferr, LOGIT_ATOL))
    return launches


# a wide-head model served through the normal entry point: GPT-2 medium's
# widths (d_model 1024, d_inner 4096, vocab 50257, 1024 positions; Radford
# et al. 2019) at 4 heads of 256 and 2 layers, page_size 128, 4 slots, f32
# and int8 KV pools
WIDE_MODEL = dict(vocab_size=50257, n_layer=2, n_head=4, d_model=1024, d_inner=4096,
                  max_context=1024)
WIDE_ENGINE = dict(max_slots=4, page_size=128, max_context=1024)
WIDE_PROMPT_LENS = (40, 217, 472, 700)
WIDE_NEW_TOKENS = 16


def serve_wide(torch, pf, card, readings=None):
    """The wide-head model served by a GenerationEngine over f32 pools, then
    over int8 pools with the same weights: 4 greedy requests each through
    the scheduler on the graph path (every request finishes, no variant
    captured after warmup, both wide paged kernels of the pool type launch
    and no narrow one) and on the op-by-op path, a request alone on both
    bit for bit; paged against dense logits and the fuse_attention rewrite
    (the wide flash forward) on the f32 engine; the int8 engine's kernel
    path against the plain path (paged_flash off) on the same pools.
    Returns the wide kernels' launches over the graph path's requests and
    the wide forward's in the rewritten program."""
    from paddle_tpu_torch import CUDAPlace, flags
    from paddle_tpu_torch.models import GPTDecoder
    from paddle_tpu_torch.serving import GenerationEngine

    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(2, WIDE_MODEL["vocab_size"], size=n).tolist() for n in WIDE_PROMPT_LENS]
    launches, engines = {}, {}
    for quant in (False, True):
        t0 = time.perf_counter()
        kw = dict(kv_dtype="int8") if quant else {}
        label = "serve wide heads (%s pools)" % ("int8" if quant else "f32")
        engine = GenerationEngine(GPTDecoder(**WIDE_MODEL, **kw), place=CUDAPlace(0),
                                  name="wide_heads" + "_int8" * quant, **WIDE_ENGINE)
        if quant:
            with torch.no_grad():
                for name in engine.model.param_names():
                    engine.scope.vars[name].copy_(engines[False].scope.vars[name])
        n = engine.warmup()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        traces = (engine.traces, engine.captures())
        results, graph, got = _schedule(engine, pf, prompts, WIDE_NEW_TOKENS)
        if (engine.traces, engine.captures()) != traces:
            raise AssertionError("wide-head variants prepared or captured after warmup: %s -> %s"
                                 % (traces, (engine.traces, engine.captures())))
        head = WIDE_MODEL["d_model"] // WIDE_MODEL["n_head"]
        keys = [pf.launch_key(shared, head, quant) for shared in (False, True)]
        if not all(got[k] for k in keys) or sum(got.values()) != sum(got[k] for k in keys):
            raise AssertionError("wide-head serve: kernel launches %s" % got)
        if not np.all(np.isfinite(engine.last_logits)):
            raise AssertionError("non-finite wide-head decode logits")
        launches.update({k: got[k] for k in keys})
        log("%s: %d heads of %d, %d layers, page_size %d, %d slots; %d variants captured in "
            "%.1f s; %d prompt tokens; graph path: %s; kernel launches %s; card %s" % (
                label, WIDE_MODEL["n_head"], head, WIDE_MODEL["n_layer"],
                WIDE_ENGINE["page_size"], WIDE_ENGINE["max_slots"], n, t1 - t0,
                sum(WIDE_PROMPT_LENS), _path_line(graph), json.dumps({k: got[k] for k in keys}),
                card))
        eager = _op_by_op_serve(engine, pf, prompts, WIDE_NEW_TOKENS, results, label, card)
        graph_vs_op_by_op(engine, pf, prompts[1], 4, label)
        if readings is not None:
            readings["serve_wide_" + ("int8" if quant else "f32")] = {
                "graph": graph, "op_by_op": eager}
        engines[quant] = engine
    flash_launches = paged_vs_dense(torch, engines[False], WIDE_MODEL)
    engine = engines[True]
    tok_k, rows_k = _stepwise(engine, prompts[-1], 8)
    flags.set_flags({"paged_flash": "off"})
    try:
        tok_p, rows_p = _stepwise(engine, prompts[-1], 8)
    finally:
        flags.set_flags({"paged_flash": "auto"})
    kerr = max(float(np.abs(a - b).max()) for a, b in zip(rows_k, rows_p))
    if tok_k != tok_p or not all(np.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
                                 for a, b in zip(rows_k, rows_p)):
        raise AssertionError("wide heads, int8 pools, kernel vs plain path: max abs logit err %g"
                             % kerr)
    log("serve wide heads: int8 pools, kernel vs plain path (paged_flash off) over %d steps of "
        "a %d-token prompt, max abs logit err %.3g (atol=rtol=%g)" % (
            len(rows_k), len(prompts[-1]), kerr, LOGIT_ATOL))
    del engines, engine
    torch.cuda.empty_cache()
    return launches, flash_launches

def _stepwise(engine, prompt, n_new):
    """(tokens, logits of every step) of one request run alone."""
    from paddle_tpu_torch.serving import GenRequest

    run = engine.start(GenRequest(prompt, max_new_tokens=n_new, eos_id=NO_EOS))
    rows = [np.array(engine.last_prefill_logits)]
    try:
        while not run.done:
            engine.decode_step([run])
            rows.append(np.array(engine.last_logits[run.slot]))
    finally:
        engine.finish(run)
    return list(run.tokens), rows


def _op_nodes(program):
    """{paddle_tpu_torch op name: its nodes} in an exported program's graph."""
    out = {}
    for n in program.graph.nodes:
        t = str(n.target)
        if t.startswith("paddle_tpu_torch."):
            name = t.split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


PAGED_EXPORT_PROMPT = 32  # tokens of the exported request's prompt: one chunk, the largest bucket
PAGED_EXPORT_STEPS = 8  # decode steps after it


def paged_export(torch, pf, engine, label, card):
    """(f) of the compiled artifacts: the engine's decode program and one
    prefill-chunk program exported (GenerationEngine.export_variant:
    aot_serve_lowering(return_state=True), executor.export_block, the KV
    pools the written state), one paddle_tpu_torch.paged_flash_attention
    node a layer. A request alone (a PAGED_EXPORT_PROMPT-token prompt, no
    prefix-cache hit: one prefill chunk, then PAGED_EXPORT_STEPS decode
    steps) on the engine's graph path, the pools kept after every call;
    then the exported programs (executor._ExportedRun: call 1 op by op,
    then a CUDA graph) replay those calls on copies of the pools as they
    were before it: every call's logits and every pool bit for bit. Returns
    (the exported programs' paged kernel launches, the record)."""
    from paddle_tpu_torch.executor import _ExportedRun
    from paddle_tpu_torch.serving import GenRequest

    rng = np.random.RandomState(SEED + 7)
    prompt = rng.randint(2, engine.model.vocab_size, size=PAGED_EXPORT_PROMPT).tolist()
    chunk = "prefill:%d" % engine.prefill_bucket(len(prompt))
    start = {n: t.clone() for n, t in engine._state.items()}
    calls, call = [], engine._call

    def recorded(variant, feeds):
        kind = next(k for k, v in engine._variants.items() if v is variant)
        held = {n: np.array(feeds[n]) for n in variant.feed_names}
        out = call(variant, feeds)
        calls.append((kind, held, [np.array(o) for o in out],
                      {n: engine._state[n].clone() for n in variant.mut_names}))
        return out

    saved, engine.prefix_cache = engine.prefix_cache, None
    engine._call = recorded
    try:
        run = engine.start(GenRequest(prompt, max_new_tokens=PAGED_EXPORT_STEPS + 1,
                                      eos_id=NO_EOS))
        for _ in range(PAGED_EXPORT_STEPS):
            engine.decode_step([run])
        engine.finish(run)
    finally:
        engine.prefix_cache = saved
        del engine._call
    kinds = [c[0] for c in calls]
    if kinds != [chunk] + ["decode"] * PAGED_EXPORT_STEPS:
        raise AssertionError("%s export: the request made calls %s" % (label, kinds))
    exported, export_s, nodes = {}, {}, {}
    for kind in (chunk, "decode"):
        feeds = next(c[1] for c in calls if c[0] == kind)
        t0 = time.perf_counter()
        program, ro, mut_names, dtypes = engine.export_variant(kind, feeds)
        export_s[kind] = time.perf_counter() - t0
        nodes[kind] = _op_nodes(program).get("paged_flash_attention", 0)
        if nodes[kind] != engine.model.n_layer:
            raise AssertionError("%s export %s: %d paged_flash_attention nodes, want %d"
                                 % (label, kind, nodes[kind], engine.model.n_layer))
        exported[kind] = (_ExportedRun(program.module(), dtypes, engine.device), ro, mut_names)
    pools = start
    pf.reset_kernel_launches()  # the exported programs' counting window
    walls = []
    for i, (kind, feeds, want, want_pools) in enumerate(calls):
        fn, ro, mut_names = exported[kind]
        t0 = time.perf_counter()
        got = [o.cpu().numpy() for o in fn(feeds, ro, {n: pools[n] for n in mut_names})]
        walls.append((time.perf_counter() - t0) * 1e3)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.tobytes() != w.tobytes():
                raise AssertionError("%s export, call %d (%s): logits differ from the engine's "
                                     "(max abs %g)" % (label, i, kind, float(np.abs(g - w).max())))
        bad = [n for n in mut_names if not torch.equal(pools[n], want_pools[n])]
        if bad:
            raise AssertionError("%s export, call %d (%s): pools %s differ from the engine's"
                                 % (label, i, kind, bad[:4]))
    launches = {k: v for k, v in pf.kernel_launches().items() if v}
    decode_key = pf.launch_key(False, engine.model.d_model // engine.model.n_head,
                               engine.kv_dtype == "int8")
    shared_key = pf.launch_key(True, engine.model.d_model // engine.model.n_head,
                               engine.kv_dtype == "int8")
    want_launches = {shared_key: engine.model.n_layer,
                     decode_key: engine.model.n_layer * PAGED_EXPORT_STEPS}
    if launches != want_launches:
        raise AssertionError("%s export: launches %s, want %s" % (label, launches, want_launches))
    record = {"export_s": export_s, "nodes": nodes, "launches": launches,
              "exported_call_walls_ms": walls}
    log("paged export %s: %s and decode (%d slots) exported by GenerationEngine.export_variant "
        "in %s s, %s paged_flash_attention nodes; a %d-token prompt and %d decode steps on the "
        "engine's graph path replayed by the exported programs (call 1 op by op, then a CUDA "
        "graph) on copies of the pools: logits and all %d pool tensors bit for bit after every "
        "call; launches %s; exported call walls %s ms; card %s" % (
            label, chunk, engine.max_slots, json.dumps({k: round(v, 1) for k, v in
                                                        export_s.items()}),
            json.dumps(nodes), len(prompt), PAGED_EXPORT_STEPS, len(start), json.dumps(launches),
            ["%.2f" % w for w in walls], card))
    del exported, calls, start, pools
    torch.cuda.empty_cache()
    return launches, record


def serve_int8_kv(torch, pf, f32_engine, card, readings):
    """Path A: GPT-2 small over int8 KV pools at 16 slots, the f32 engine's
    weights copied in by name; 16 concurrent requests through the
    scheduler on the graph path and on the op-by-op path, a request alone
    on both bit for bit, then the last-step logits against the f32 pools
    and the kernel path against the plain one (paged_flash off) on the
    same int8 pools. Returns the int8 paged kernels' launches over the
    graph path's requests, and the engine."""
    from paddle_tpu_torch import CUDAPlace, flags
    from paddle_tpu_torch.models import GPTDecoder
    from paddle_tpu_torch.serving import GenerationEngine

    t0 = time.perf_counter()
    engine = GenerationEngine(GPTDecoder(kv_dtype="int8", **GPT2_SMALL), name="gpt2_small_int8",
                              place=CUDAPlace(0), **INT8_ENGINE)
    with torch.no_grad():
        for name in engine.model.param_names():
            engine.scope.vars[name].copy_(f32_engine.scope.vars[name])
    n = engine.warmup()
    torch.cuda.synchronize()
    log("int8 engine: %d variants captured, %d slots, params copied from the f32 engine, ready "
        "in %.1f s; KV pools %.3f GB (int8 levels + f32 row scales) against %.3f GB of f32 "
        "pools at %d slots" % (n, INT8_ENGINE["max_slots"], time.perf_counter() - t0,
                               engine.kv_state_bytes / 1e9, f32_engine.kv_state_bytes / 1e9,
                               ENGINE["max_slots"]))
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(2, GPT2_SMALL["vocab_size"], size=n).tolist()
               for n in PROMPT_LENS * 2]
    traces = (engine.traces, engine.captures())
    results, graph, launches = _schedule(engine, pf, prompts, NEW_TOKENS)
    if (engine.traces, engine.captures()) != traces:
        raise AssertionError("int8 variants prepared or captured after warmup: %s -> %s"
                             % (traces, (engine.traces, engine.captures())))
    if not (launches["paged_flash_int8"] and launches["paged_flash_shared_int8"]):
        raise AssertionError("an int8 paged kernel never launched: %s" % launches)
    if launches["paged_flash"] or launches["paged_flash_shared"]:
        raise AssertionError("f32 paged kernels launched on int8 pools: %s" % launches)
    log("serve int8 KV: %d prompt tokens, %d slots; graph path: %s; kernel launches %s; card %s"
        % (2 * sum(PROMPT_LENS), INT8_ENGINE["max_slots"], _path_line(graph),
           json.dumps(launches), card))
    eager = _op_by_op_serve(engine, pf, prompts, NEW_TOKENS, results, "serve int8 KV", card)
    graph_vs_op_by_op(engine, pf, prompts[1], 8, "serve int8 KV")
    readings["serve_int8_kv"] = {"graph": graph, "op_by_op": eager}

    # the same weights over f32 pools. Step i's logits have the context
    # prompt + tokens[:i]: the two runs are compared at every step up to
    # the last whose context they share (a near-tie can flip a greedy token,
    # after which the streams run on different contexts)
    drift, same, total, steps = 0.0, 0, 0, 0
    for p in prompts[::4]:
        t32, r32 = _stepwise(f32_engine, p, 8)
        t8, r8 = _stepwise(engine, p, 8)
        shared = next((i for i, (a, b) in enumerate(zip(t32, t8)) if a != b), len(t32))
        for i in range(min(shared + 1, len(r32))):
            drift = max(drift, float(np.abs(r32[i] - r8[i]).max() / (np.abs(r32[i]).max() + 1e-9)))
            steps += 1
        same += shared
        total += len(t32)
    if not drift < INT8_DRIFT:
        raise AssertionError("int8 vs f32 pools: last-step logit drift %g" % drift)
    # the kernel against the plain path on the same int8 pools
    tok_k, rows_k = _stepwise(engine, prompts[5], 16)
    flags.set_flags({"paged_flash": "off"})
    try:
        tok_p, rows_p = _stepwise(engine, prompts[5], 16)
    finally:
        flags.set_flags({"paged_flash": "auto"})
    kerr = max(float(np.abs(a - b).max()) for a, b in zip(rows_k, rows_p))
    if tok_k != tok_p or not all(np.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
                                 for a, b in zip(rows_k, rows_p)):
        raise AssertionError("int8 pools, kernel vs plain path: max abs logit err %g" % kerr)
    log("serve int8 KV: logits against the f32 pools on the same weights, relative drift "
        "%.4g (< %g) over %d steps of %d prompts with a shared context; greedy tokens agree on "
        "%d of %d before the first difference; kernel vs plain path (paged_flash off) on the "
        "same int8 pools over %d steps max abs logit err %.3g (atol=rtol=%g)" % (
            drift, INT8_DRIFT, steps, len(prompts[::4]), same, total, len(rows_k), kerr,
            LOGIT_ATOL))
    return {k: launches[k] for k in INT8_KERNEL_META}, engine


def _head_batch(means, rng, bs):
    """bench.py:2036-2040: clustered rows around a class mean."""
    y = rng.randint(0, HEAD["classes"], (bs, 1)).astype("int64")
    x = (means[y.reshape(-1)] + 0.7 * rng.randn(bs, HEAD["d_model"])).astype("float32")
    return x, y


def _fit_head(torch, means, model_dir):
    """Fit the fc head with the port's Executor + Adam (bench.py
    _quant_fit_classifier) and save it with io.save_inference_model."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[HEAD["d_model"]], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        h = img
        for _ in range(HEAD["depth"]):
            h = pt.layers.fc(h, size=HEAD["d_model"], act="relu")
        logits = pt.layers.fc(h, size=HEAD["classes"])
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, label))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    place = pt.CUDAPlace(0)
    exe, scope = pt.Executor(place), pt.Scope(seed=11, place=place)
    rng = np.random.RandomState(11)
    losses = []
    pt.flags.set_flags({"pass_pipeline": ""})
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(HEAD_FIT_STEPS):
            x, y = _head_batch(means, rng, HEAD_FIT_ROWS)
            (lv,) = exe.run(main, feed={"img": x, "label": y}, fetch_list=[loss.name])
            losses.append(float(lv.reshape(-1)[0]))
        pt.io.save_inference_model(model_dir, ["img"], [logits], exe, main_program=main)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("fc head fit: losses %s" % losses)
    return losses


def _expected_qgemm_launches(engine, rows):
    """Quant GEMM launches one call of `rows` rows makes: the tagged
    gemm_int8 chains whose shape the copied predicate accepts at the
    call's bucket."""
    from paddle_tpu_torch.ops import fused

    m = engine.bucket_batch(rows)
    count = 0
    for op in engine.program.global_block().ops:
        if op.type == "int8_mul" and op.attrs.get("__pallas_kernel__") == "gemm_int8":
            k, n = engine.scope.vars[op.input("Y")[0]].shape
            count += fused.quant_gemm_path_taken(m, n, k, engine.scope.vars[op.input("Y")[0]].dtype)
    return count


def serve_int8_gemm(torch, card):
    """Path B: the fc head fitted and saved by the port, served by an f32
    and a calibrated-int8 ServingEngine on the card: 8 eval batches of 250
    rows and one single shot of 1024. Returns the quant GEMM's launches
    over the int8 engine's calls, and the phase's readings (rows/s, the
    single shot's walls, the int8 engine's device busy ms a call and its
    quant GEMM part)."""
    import tempfile

    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.ops import quant_gemm as qg
    from paddle_tpu_torch.serving import ServingEngine

    means = np.random.RandomState(101).randn(HEAD["classes"], HEAD["d_model"])
    with tempfile.TemporaryDirectory(prefix="fc_head_") as tmp:
        t0 = time.perf_counter()
        losses = _fit_head(torch, means, tmp)
        log("fc head %s: fitted %d steps of %d rows with Adam (loss %.4f -> %.4f) and saved in "
            "%.1f s" % (json.dumps(HEAD), HEAD_FIT_STEPS, HEAD_FIT_ROWS, losses[0], losses[-1],
                        time.perf_counter() - t0))
        rng = np.random.RandomState(3)
        calib = [{"img": _head_batch(means, rng, 16)[0]} for _ in range(8)]
        t0 = time.perf_counter()
        e32 = ServingEngine(tmp, name="fc_head_f32", place=CUDAPlace(0),
                            batch_buckets=HEAD_BUCKETS)
        e8 = ServingEngine(tmp, name="fc_head_int8", place=CUDAPlace(0),
                           batch_buckets=HEAD_BUCKETS, precision="int8", calibration_feeds=calib)
        n_var = e32.warmup() + e8.warmup()
        torch.cuda.synchronize()
    q = e8.stats()["quant"]
    want_q = {"quantized_muls": 4, "weights_frozen": 4, "fused_groups": 4}
    if any(q[k] != v for k, v in want_q.items()):
        raise AssertionError("int8 engine quant stats %s, want %s" % (q, want_q))
    log("serve int8 GEMM: engines built (calibration on 8 batches of 16 rows) and %d variants "
        "warmed in %.1f s; quant %s" % (n_var, time.perf_counter() - t0, json.dumps(q)))
    ok32 = ok8 = agree = tot = 0
    drift, t32, t8 = 0.0, 0.0, 0.0
    traces = [(e.traces, e.stats()["captures"]) for e in (e32, e8)]
    qg.reset_kernel_launches()  # the main path's counting window opens here
    per_call = []

    def both(x):
        nonlocal t32, t8
        t = time.perf_counter()
        (a,) = e32.run({"img": x})
        t32 += time.perf_counter() - t
        before = qg.kernel_launches()["quant_gemm_int8"]
        t = time.perf_counter()
        (b,) = e8.run({"img": x})
        t8 += time.perf_counter() - t
        per_call.append((qg.kernel_launches()["quant_gemm_int8"] - before,
                         _expected_qgemm_launches(e8, x.shape[0])))
        return a, b

    for _ in range(HEAD_EVAL_BATCHES):
        x, y = _head_batch(means, rng, HEAD_EVAL_ROWS)
        a, b = both(x)
        pa, pb, yy = np.argmax(a, -1), np.argmax(b, -1), y.reshape(-1)
        ok32 += int((pa == yy).sum())
        ok8 += int((pb == yy).sum())
        agree += int((pa == pb).sum())
        tot += x.shape[0]
        drift = max(drift, float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9)))
    rows_s = (tot / t32, tot / t8)
    x, _ = _head_batch(means, rng, HEAD_SHOT_ROWS)
    t32 = t8 = 0.0
    a, b = both(x)
    shot = (t32 * 1e3, t8 * 1e3)
    drift = max(drift, float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9)))
    launches = qg.kernel_launches()["quant_gemm_int8"]  # and closes here
    if any(got != want for got, want in per_call) or not launches:
        raise AssertionError("quant GEMM launches per call %s, want the predicate's count"
                             % per_call)
    if [(e.traces, e.stats()["captures"]) for e in (e32, e8)] != traces:
        raise AssertionError("serving variants prepared or captured after warmup")
    delta = abs(ok32 - ok8) / tot
    if not (delta <= TOP1_DELTA and drift < HEAD_REL_ERR):
        raise AssertionError("int8 vs f32: top-1 delta %g, max relative logit error %g"
                             % (delta, drift))
    busy = {}
    for rows in (HEAD_EVAL_ROWS, HEAD_SHOT_ROWS):
        xb, _ = _head_batch(means, rng, rows)
        busy[rows] = profiled_device_split(torch, lambda: e8.run({"img": xb}), 5,
                                           "quant_gemm_kernel")
    log("serve int8 GEMM: the int8 engine's device busy time a call (torch.profiler, 5 calls "
        "after a warm one): %d rows %.4f ms, of it the quant GEMM kernel %.4f ms (%.3f); %d rows "
        "%.4f ms, quant GEMM %.4f ms (%.3f); card %s" % (
            HEAD_EVAL_ROWS, busy[HEAD_EVAL_ROWS][0], busy[HEAD_EVAL_ROWS][1],
            busy[HEAD_EVAL_ROWS][1] / busy[HEAD_EVAL_ROWS][0], HEAD_SHOT_ROWS,
            busy[HEAD_SHOT_ROWS][0], busy[HEAD_SHOT_ROWS][1],
            busy[HEAD_SHOT_ROWS][1] / busy[HEAD_SHOT_ROWS][0], card))
    log("serve int8 GEMM: %d eval rows (%d x %d) + a single shot of %d: top-1 f32 %.4f, int8 "
        "%.4f (delta %.4f <= %g), agreement %.4f, max relative logit error %.4g (< %g); quant "
        "GEMM launches per int8 call (launched, predicate) %s; f32 engine %.1f rows/s, int8 "
        "engine %.1f rows/s over the eval batches (host clock, each call ending in the fetch "
        "copy); single shot f32 %.3f ms, int8 %.3f ms; card %s" % (
            tot, HEAD_EVAL_BATCHES, HEAD_EVAL_ROWS, HEAD_SHOT_ROWS, ok32 / tot, ok8 / tot, delta,
            TOP1_DELTA, agree / tot, drift, HEAD_REL_ERR, per_call, rows_s[0], rows_s[1],
            shot[0], shot[1], card))
    readings = {"rows_per_s": {"f32": rows_s[0], "int8": rows_s[1]},
                "single_shot_ms": {"f32": shot[0], "int8": shot[1]},
                "int8_busy_ms": {str(r): {"call": b[0], "quant_gemm": b[1]}
                                 for r, b in busy.items()}}
    return {"quant_gemm_int8": launches}, readings


# ---------------------------------------------------------------- phase 4e

# the HTTP front end over four hosted models: GPT-2 small with f32 and int8
# KV pools, the fc head in f32 and calibrated int8
HTTP_CLIENTS = 8
HTTP_TIMEOUT = 300  # seconds, every client call
HTTP_PREDICTS = 12  # :predict requests a client sends, fc_head and fc_head_int8 in turn
HTTP_GENERATES = 2  # :generate requests a client sends, gpt2 and gpt2_int8kv in turn
HTTP_NEW_TOKENS = 64
HTTP_PROMPT_LENS = (40, 131, 217, 305, 388, 472, 569, 700)
HTTP_JSON_ROWS = 16  # :predict bodies up to this many rows go as JSON, larger as npz
HTTP_FC_SWAPS, HTTP_GPT_SWAPS = 4, 2
HTTP_WALL_CALLS = 6  # calls timed a form for the graphs-vs-op-by-op wall
GPT_SWAP_PARAMS = ("lnf_w", "lnf_b")  # what a gpt2 swap replaces

_COLD_BOOT = r"""
import json, sys, time
t_import = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import numpy as np
import chip_smoke
t0 = time.perf_counter()
out, ys = chip_smoke._boot_heads(*sys.argv[2:6])
out["import_s"] = t0 - t_import
np.savez(sys.argv[6], **ys)
print(json.dumps(out))
"""


def _boot_heads(md, cache, data, buckets):
    """Boot fc_head and fc_head_int8 on `cache` (a ServingEngine each,
    warmed) and serve the data's eval rows: (stats, outputs)."""
    import torch

    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import ServingEngine

    data = np.load(data)
    calib = [{"img": data["calib%d" % i]} for i in range(8)]
    out, ys = {}, {}
    built = set(_build.build_logs)
    for name, kw in (("fc_head", {}),
                     ("fc_head_int8", {"precision": "int8", "calibration_feeds": calib})):
        t = time.perf_counter()
        eng = ServingEngine(md, name=name, place=CUDAPlace(0), batch_buckets=json.loads(buckets),
                            cache_dir=cache, **kw)
        eng.warmup()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        st = eng.stats()
        (ys[name],) = eng.run({"img": data["x"]})
        out[name] = {"warm_s": warm, "traces": st["traces"], "cache_hits": st["cache_hits"],
                     "captures": st["captures"]}
    out["nvcc_built"] = sorted(set(_build.build_logs) - built)
    return out, ys


def _http_call(base, path, body=None, ctype="application/json"):
    """(code, headers, body, ms) of one client call (HTTP_TIMEOUT)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype} if body is not None else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            code, headers, out = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        code, headers, out = e.code, dict(e.headers), e.read()
    return code, headers, out, (time.perf_counter() - t0) * 1e3


def _predict_body(x, as_npz):
    import io as stdio

    if not as_npz:
        return json.dumps({"inputs": {"img": x.tolist()}}).encode(), "application/json"
    buf = stdio.BytesIO()
    np.savez(buf, img=x)
    return buf.getvalue(), "application/x-npz"


def _predict_out(body, as_npz):
    import io as stdio

    if as_npz:
        got = np.load(stdio.BytesIO(body))
        return got[got.files[0]], None
    doc = json.loads(body)
    (out,) = doc["outputs"].values()
    return np.asarray(out, np.float32), doc["model_version"]


def _http_requests(client, means):
    """Client `client`'s requests: :predict of 1-250 rows on the two fc
    heads, :generate of 40-700 prompt tokens on the two GPT-2 engines,
    greedy on even clients and seeded temperature on odd ones."""
    rng = np.random.RandomState(1000 + client)
    out = []
    for j in range(HTTP_PREDICTS):
        rows = int(rng.randint(1, 251))
        x, _ = _head_batch(means, rng, rows)
        out.append({"kind": "predict", "model": ("fc_head", "fc_head_int8")[j % 2], "x": x,
                    "npz": rows > HTTP_JSON_ROWS})
    for j in range(HTTP_GENERATES):
        n = HTTP_PROMPT_LENS[(client + 3 * j) % len(HTTP_PROMPT_LENS)]
        doc = {"prompt": rng.randint(2, GPT2_SMALL["vocab_size"], size=n).tolist(),
               "max_new_tokens": HTTP_NEW_TOKENS, "eos_id": NO_EOS}
        if client % 2:
            doc.update(temperature=0.8, seed=100 + client)
        out.insert(1 + 6 * j, {"kind": "generate", "model": ("gpt2", "gpt2_int8kv")[j % 2],
                               "doc": doc})
    return out


def _http_load(base, server, means, swap):
    """HTTP_CLIENTS threads send their requests; `swap(done)` runs on its
    own thread as replies come in. Returns (replies, wall s)."""
    import threading

    replies, errors, lock = [], [], threading.Lock()

    def client(i):
        try:
            for req in _http_requests(i, means):
                engine = server._models[req["model"]].engine
                before = engine.model_version
                if req["kind"] == "predict":
                    body, ctype = _predict_body(req["x"], req["npz"])
                    code, headers, out, ms = _http_call(
                        base, "/v1/models/%s:predict" % req["model"], body, ctype)
                    rec = dict(req, code=code, ms=ms, before=before)
                    if code == 200:
                        rec["out"], rec["version"] = _predict_out(out, req["npz"])
                    else:
                        rec["version"] = None
                else:
                    code, headers, out, ms = _http_call(
                        base, "/v1/models/%s:generate" % req["model"],
                        json.dumps(req["doc"]).encode())
                    rec = dict(req, code=code, ms=ms, before=before)
                    rec["version"] = None
                    if code == 200:
                        doc = json.loads(out)
                        rec["tokens"], rec["version"] = doc["tokens"], doc["model_version"]
                rec["client"], rec["after"] = i, engine.model_version
                with lock:
                    replies.append(rec)
        except Exception as e:  # raised below, after every thread ended
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
    swapper = threading.Thread(target=swap, args=(lambda: len(replies),))
    t0 = time.perf_counter()
    for t in threads + [swapper]:
        t.start()
    for t in threads + [swapper]:
        t.join(HTTP_TIMEOUT * 4)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads + [swapper]):
        raise AssertionError("HTTP clients failed: %s" % errors[:4])
    return replies, wall


def _gpt_swap_sets(engine, n):
    """n parameter sets of the gpt2 swaps: the final layer_norm's scale and
    shift, perturbed from a seed (index 0: as built)."""
    names = [p for p in engine.model.param_names() if p.endswith(GPT_SWAP_PARAMS)]
    base = {p: engine.scope.vars[p].cpu().numpy().copy() for p in names}
    rng = np.random.RandomState(77)
    return [base] + [{p: (a + 0.2 * k * rng.randn(*a.shape)).astype("float32")
                      for p, a in base.items()} for k in range(1, n + 1)]


def _fc_swap_sets(engine, n):
    base = {p: engine.scope.vars[p].cpu().numpy().copy() for p in engine.param_names()}
    rng = np.random.RandomState(78)
    return [base] + [{p: (a + 0.01 * k * rng.randn(*a.shape)).astype("float32")
                      for p, a in base.items()} for k in range(1, n + 1)]


def _route_line(replies, wall):
    """requests/s over the load wall and p50 / p99 latency, by route."""
    out = {}
    for model in sorted({r["model"] for r in replies}):
        ms = np.array([r["ms"] for r in replies if r["model"] == model])
        kind = next(r["kind"] for r in replies if r["model"] == model)
        out["%s:%s" % (model, kind)] = {
            "requests": int(ms.size), "requests_per_s": ms.size / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}
    return out


def _at_a_served_bucket(engine, x, out, buckets):
    """Whether `out` equals the engine's direct run of rows `x` padded to
    one of the buckets its calls served under the load (the batcher packs
    a request's rows with others into one bucket; a bucket's rows are
    computed alike whatever shares it)."""
    n = len(x)
    for b in sorted(b for b in buckets if b >= engine.bucket_batch(n)):
        xp = np.zeros((b,) + x.shape[1:], x.dtype)
        xp[:n] = x
        (y,) = engine.run({"img": xp})
        if np.array_equal(y[:n], out):
            return True
    return False


def _check_replies(torch, server, replies, fc_sets, gpt_sets, md, buckets):
    """Every reply against the engine that served it. A :predict reply
    equals that engine's direct run of its rows at the bucket that served
    them and at its version's parameters, and so does a fresh engine given
    those parameters, bit for bit (an npz reply names no version: it must
    equal one of those live while it ran); a :generate reply whose version
    did not move while it ran equals the scheduler's own tokens at that
    version; versions are monotone a client."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.serving import ServingEngine

    seen = {}
    for r in replies:  # a client's replies in the order it sent them
        v, key = r.get("version"), (r["client"], r["model"])
        if v is None:
            continue
        if not r["before"] <= v <= r["after"] or v < seen.get(key, 0):
            raise AssertionError("client %d, %s: version %d after %d (live %d..%d)" % (
                r["client"], r["model"], v, seen.get(key, 0), r["before"], r["after"]))
        seen[key] = v
    compared = {"predict": 0, "generate": 0}
    e32 = server._models["fc_head"].engine
    fc = [r for r in replies if r["model"] == "fc_head"]
    matched = set()
    for k, params in enumerate(fc_sets):
        mine = [r for r in fc if (r["version"] == k if r["version"] is not None
                                  else r["before"] <= k <= r["after"])]
        if not mine:
            continue
        e32.set_params(params, version=k)
        fresh = ServingEngine(md, name="fc_head_fresh%d" % k, place=CUDAPlace(0),
                              batch_buckets=HEAD_BUCKETS)
        fresh.set_params(params)
        for r in mine:
            if _at_a_served_bucket(e32, r["x"], r["out"], buckets["fc_head"]) and \
                    _at_a_served_bucket(fresh, r["x"], r["out"], buckets["fc_head"]):
                matched.add(id(r))
            elif r["version"] is not None:
                raise AssertionError("fc_head reply at version %d, %d rows: not the direct "
                                     "run's or a fresh engine's at any served bucket"
                                     % (k, len(r["x"])))
        del fresh
    if len(matched) != len(fc):
        raise AssertionError("%d fc_head replies equal no version live while they ran"
                             % (len(fc) - len(matched)))
    compared["predict"] += len(fc)
    e8 = server._models["fc_head_int8"].engine
    for r in replies:
        if r["model"] == "fc_head_int8":
            if not _at_a_served_bucket(e8, r["x"], r["out"], buckets["fc_head_int8"]):
                raise AssertionError("fc_head_int8 reply of %d rows differs from its direct run"
                                     % len(r["x"]))
            compared["predict"] += 1
    for model, sets in (("gpt2", gpt_sets), ("gpt2_int8kv", [None])):
        hosted = server._models[model]
        clean = [r for r in replies if r["model"] == model and r["before"] == r["after"]]
        # no prefix-cache hits: the load had none, and a hit chunks a
        # prompt's prefill differently
        saved, hosted.engine.prefix_cache = hosted.engine.prefix_cache, None
        try:
            for k, params in enumerate(sets):
                mine = [r for r in clean if r["version"] == k]
                if params is not None:
                    hosted.engine.set_params(params, version=k)
                futs = [hosted.batcher.submit(**r["doc"]) for r in mine]
                for r, f in zip(mine, futs):
                    if f.result(HTTP_TIMEOUT).tokens != r["tokens"]:
                        raise AssertionError("%s reply at version %d (%s) differs from the "
                                             "scheduler's tokens" % (
                                                 model, k, "seeded" if "seed" in r["doc"]
                                                 else "greedy"))
                    compared["generate"] += 1
        finally:
            hosted.engine.prefix_cache = saved
    return compared


def _cold_start(md, means, card):
    """Two boots of fc_head and fc_head_int8 on one cache_dir: the first in
    this process on the empty cache, the second a process of its own,
    which prepares nothing, hits every bucket, captures every bucket and
    serves the same outputs."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cold_start_") as tmp:
        rng = np.random.RandomState(3)
        data = {"calib%d" % i: _head_batch(means, rng, 16)[0] for i in range(8)}
        data["x"] = _head_batch(means, rng, HEAD_EVAL_ROWS)[0]
        paths = [os.path.join(tmp, n) for n in ("data.npz", "cache")]
        np.savez(paths[0], **data)
        buckets = json.dumps(list(HEAD_BUCKETS))
        t0 = time.perf_counter()
        first, first_ys = _boot_heads(md, paths[1], paths[0], buckets)
        first.update(import_s=0.0, process_s=time.perf_counter() - t0)
        out_path = os.path.join(tmp, "out.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _COLD_BOOT, os.path.dirname(os.path.abspath(__file__)),
             md, paths[1], paths[0], buckets, out_path],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError("cold-start boot 2 failed:\n%s" % proc.stderr[-4000:])
        second = json.loads(proc.stdout.strip().splitlines()[-1])
        second["process_s"] = time.perf_counter() - t0
        boots, outs = [first, second], [first_ys, np.load(out_path)]
        n = len(HEAD_BUCKETS)
        for name in ("fc_head", "fc_head_int8"):
            a, b = first[name], second[name]
            if (a["traces"], a["cache_hits"]) != (n, 0) or (b["traces"], b["cache_hits"]) != (0, n) \
                    or a["captures"] != n or b["captures"] != n:
                raise AssertionError("cold start %s: %s then %s" % (name, a, b))
            if not np.array_equal(outs[0][name], outs[1][name]):
                raise AssertionError("cold start %s: the second boot's outputs differ" % name)
        for boot, rec in enumerate(boots):
            log("serve http cold start, boot %d (%s): imports %.2f s; "
                "fc_head warm %.3f s (traces %d, cache hits %d, captures %d); fc_head_int8 "
                "warm %.3f s (traces %d, cache hits %d, captures %d, calibration included); "
                "kernels compiled by nvcc in this boot: %s; boot %.1f s; card %s" % (
                    boot + 1, "this process, cache empty" if boot == 0 else
                    "a process of its own, the first boot's cache",
                    rec["import_s"], rec["fc_head"]["warm_s"], rec["fc_head"]["traces"],
                    rec["fc_head"]["cache_hits"], rec["fc_head"]["captures"],
                    rec["fc_head_int8"]["warm_s"], rec["fc_head_int8"]["traces"],
                    rec["fc_head_int8"]["cache_hits"], rec["fc_head_int8"]["captures"],
                    rec["nvcc_built"] or "none", rec["process_s"], card))
        return boots


def _unwritten_fetch_model(md_src, md_dst):
    """A copy of a saved model whose fetch list names a declared var no op
    writes."""
    import shutil

    shutil.copytree(md_src, md_dst)
    path = os.path.join(md_dst, "__model__")
    with open(path) as f:
        doc = json.load(f)
    doc["blocks"][0]["vars"].append({"name": "never_written", "shape": [-1, HEAD["classes"]],
                                     "dtype": "float32"})
    doc["fetch_var_names"].append("never_written")
    with open(path, "w") as f:
        json.dump(doc, f)


def _static_verify_leg(torch, md, calib, card):
    """FLAGS_static_verify on: the four engines built and warmed (the gate
    at load, at each variant's aot_serve_lowering and each generation
    variant) and one Transformer base training step under training_fused
    (pass-manager stage 0 and each pass, Executor.run); the gate's wall
    summed. A saved model whose fetch is never written raises at load."""
    import tempfile

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, scope_guard
    from paddle_tpu_torch import flags as pt_flags
    from paddle_tpu_torch.analysis import StaticVerifyError
    from paddle_tpu_torch.analysis import verify as sv
    from paddle_tpu_torch.models import GPTDecoder
    from paddle_tpu_torch.serving import GenerationEngine, ServingEngine
    from paddle_tpu_torch.tools import profile_training as prof

    walls, where = [], {}
    real = sv.static_verify

    def gate(program, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real(program, *a, **kw)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)
            w = kw.get("where", "direct").split(":")[0]
            where[w] = where.get(w, 0) + 1

    engines, build_s = {}, {}
    sv.static_verify = gate
    pt_flags.set_flags({"static_verify": True})
    try:
        for name, kw in (("fc_head", {}),
                         ("fc_head_int8", {"precision": "int8", "calibration_feeds": calib})):
            t0 = time.perf_counter()
            engines[name] = ServingEngine(md, name=name, place=CUDAPlace(0),
                                          batch_buckets=HEAD_BUCKETS, **kw)
            engines[name].warmup()  # each variant's gate runs here
            build_s[name] = time.perf_counter() - t0
        for name, kw in (("gpt2", ENGINE), ("gpt2_int8kv", INT8_ENGINE)):
            t0 = time.perf_counter()
            model = GPTDecoder(**dict(GPT2_SMALL, kv_dtype="int8" if "int8" in name
                                      else "float32"))
            engines[name] = GenerationEngine(model, name=name, place=CUDAPlace(0), **kw)
            if name == "gpt2_int8kv":
                with torch.no_grad():
                    for p in model.param_names():
                        engines[name].scope.vars[p].copy_(engines["gpt2"].scope.vars[p])
            engines[name].warmup()  # the generation variants' gates run here
            build_s[name] = time.perf_counter() - t0
        n_serving = len(walls)
        main, startup, loss = prof.build(prof.BASE)
        pt_flags.set_flags({"pass_pipeline": "training_fused"})
        scope = Scope(seed=SEED, place=CUDAPlace(0))
        with scope_guard(scope):
            exe = Executor(CUDAPlace(0))
            exe.run(startup)
            (lv,) = exe.run(main, feed=prof.make_batch(prof.BASE, SEED), fetch_list=[loss.name])
        if not np.all(np.isfinite(lv)):
            raise AssertionError("the verified Transformer step's loss is not finite")
        with tempfile.TemporaryDirectory(prefix="bad_model_") as tmp:
            _unwritten_fetch_model(md, os.path.join(tmp, "m"))
            try:
                ServingEngine(os.path.join(tmp, "m"), name="bad_model", place=CUDAPlace(0))
            except StaticVerifyError as e:
                if "fetch-unwritten" not in str(e) or "never_written" not in str(e):
                    raise
                bad = str(e).splitlines()[1]
            else:
                raise AssertionError("a fetch nobody writes was served")
    finally:
        sv.static_verify = real
        pt_flags.set_flags({"static_verify": False, "pass_pipeline": ""})
    del exe, scope, main, startup
    torch.cuda.empty_cache()
    log("serve http static verify: FLAGS_static_verify on while the 4 engines were built "
        "and warmed (%s s) and one Transformer base step ran (loss %.4f): %d gate runs (%s), %.1f ms in "
        "all (%.1f ms for the serving engines, %.1f ms for the training step's); a saved "
        "model whose fetch no op writes: StaticVerifyError at load: %s; card %s" % (
            json.dumps({k: round(v, 2) for k, v in build_s.items()}), float(lv.reshape(-1)[0]),
            len(walls), json.dumps(where), sum(walls), sum(walls[:n_serving]),
            sum(walls[n_serving:]), bad, card))
    return engines, {"gate_ms": sum(walls), "gate_runs": len(walls)}


def _fault_leg(base, server, means):
    """slow_response, then conn_reset, then a full queue: the client sees
    the delay, the reset and a 503 with Retry-After; the server serves on."""
    import threading
    import urllib.error

    from paddle_tpu_torch.resilience import faults

    x, _ = _head_batch(means, np.random.RandomState(5), 4)
    body, ctype = _predict_body(x, False)
    path = "/v1/models/fc_head_int8:predict"
    plain = min(_http_call(base, path, body, ctype)[3] for _ in range(3))
    faults.install("slow_response:ms=300")
    try:
        code, _, _, slow = _http_call(base, path, body, ctype)
        faults.install("conn_reset:step=1")
        try:
            code2 = _http_call(base, path, body, ctype)[0]
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            reset = type(e).__name__
        else:
            raise AssertionError("conn_reset: the client got a reply (%d)" % code2)
    finally:
        faults.install(None)
    if code != 200 or slow < 300.0:
        raise AssertionError("slow_response: code %d after %.1f ms" % (code, slow))
    after = _http_call(base, path, body, ctype)[0]
    # a full queue: fc_head's engine held, its batcher cut to 256 rows takes
    # one call in flight and one 250-row request queued; the third is refused
    eng, batcher = server._models["fc_head"].engine, server._models["fc_head"].batcher
    big, bctype = _predict_body(_head_batch(means, np.random.RandomState(6), 250)[0], True)
    codes, lock = [], threading.Lock()

    def client():
        code, headers, _, _ = _http_call(base, "/v1/models/fc_head:predict", big, bctype)
        with lock:
            codes.append((code, headers.get("Retry-After")))

    eng._swap_lock.acquire()
    limit, batcher.max_queue_rows = batcher.max_queue_rows, 256
    try:
        threads = []
        for _ in range(3):
            threads.append(threading.Thread(target=client))
            threads[-1].start()
            time.sleep(0.2)
        time.sleep(0.5)
    finally:
        batcher.max_queue_rows = limit
        eng._swap_lock.release()
    for t in threads:
        t.join(HTTP_TIMEOUT)
    full = [ra for c, ra in codes if c == 503]
    if sorted(c for c, _ in codes) != [200, 200, 503] or not full[0] or int(full[0]) < 1:
        raise AssertionError("full queue: replies %s" % codes)
    if after != 200 or _http_call(base, "/healthz")[0] != 200:
        raise AssertionError("the server stopped serving after the faults")
    log("serve http faults: slow_response:ms=300 -> 200 after %.1f ms (%.1f ms without); "
        "conn_reset -> the client saw %s and the next request got %d; a full queue "
        "(fc_head's engine held, 3 x 250 rows) -> replies %s, Retry-After %s s" % (
            slow, plain, reset, after, sorted(c for c, _ in codes), full[0]))


def _load_launches(engines, gen0, buckets, launches):
    """The kernels' launches over the load against what its engine calls
    imply: per layer one decode launch a decode step and one prefill launch
    a chunk (f32 or int8 pools), and the quant GEMM's predicate count at
    each int8 call's bucket."""
    n_layer = GPT2_SMALL["n_layer"]
    e8 = engines["fc_head_int8"]
    want = {"quant_gemm_int8": sum(_expected_qgemm_launches(e8, b) for b in buckets)}
    for name, dec, pre in (("gpt2", "paged_flash", "paged_flash_shared"),
                           ("gpt2_int8kv", "paged_flash_int8", "paged_flash_shared_int8")):
        steps = engines[name]._m_steps.value() - gen0[name][0]
        chunks = engines[name]._m_chunks.value() - gen0[name][1]
        want[dec], want[pre] = n_layer * steps, n_layer * chunks
    got = {k: launches.get(k, 0) for k in want}
    if got != want or not all(got.values()):
        raise AssertionError("kernel launches under load %s, the requests imply %s"
                             % (got, want))
    return got


def serve_http(torch, pf, card, readings):
    """Phase 4e: one ModelServer on 127.0.0.1 (port 0) hosting gpt2 and
    gpt2_int8kv (GPT-2 small, f32 and int8 KV) and fc_head and
    fc_head_int8 (the fc head in f32 and calibrated int8), all warmed
    before they are registered, built with FLAGS_static_verify on. Eight
    client threads send :predict and :generate over urllib while another
    hot-swaps fc_head 4 times and gpt2 twice; then the faults, the
    graphs-vs-op-by-op call walls and two cold boots on one cache_dir (the
    first in this process, the second a process of its own). Returns the
    paged kernels' and the quant GEMM's launches over the
    load."""
    import tempfile

    from paddle_tpu_torch.ops import gemm_epilogue as ge
    from paddle_tpu_torch.ops import quant_gemm as qg
    from paddle_tpu_torch.serving import ModelServer

    means = np.random.RandomState(101).randn(HEAD["classes"], HEAD["d_model"])
    with tempfile.TemporaryDirectory(prefix="serve_http_") as tmp:
        md = os.path.join(tmp, "fc_head")
        _fit_head(torch, means, md)
        rng = np.random.RandomState(3)
        calib = [{"img": _head_batch(means, rng, 16)[0]} for _ in range(8)]
        engines, gate = _static_verify_leg(torch, md, calib, card)
        server = ModelServer(host="127.0.0.1", port=0, request_timeout_ms=HTTP_TIMEOUT * 1e3)
        try:
            t0 = time.perf_counter()
            for name in ("fc_head", "fc_head_int8"):
                # room for every client's largest request at once
                server.add_model(name, engine=engines[name],
                                 batcher_opts={"max_queue_rows": HTTP_CLIENTS * 256,
                                               "timeout_ms": HTTP_TIMEOUT * 1e3})
            for name in ("gpt2", "gpt2_int8kv"):
                server.add_generation_model(name, engine=engines[name],
                                            scheduler_opts={"timeout_ms": HTTP_TIMEOUT * 1e3})
            torch.cuda.synchronize()
            base = "http://127.0.0.1:%d" % server.start()
            health = json.loads(_http_call(base, "/healthz")[2])
            if not health["ready"] or sorted(health["models"]) != sorted(engines):
                raise AssertionError("healthz: %s" % health)
            log("serve http: %s up with %s warmed in %.1f s (fc variants %s; gpt2 %d and "
                "gpt2_int8kv %d captures); memory reserved %.3f GiB; card %s" % (
                    base, sorted(engines), time.perf_counter() - t0,
                    {n: engines[n].stats()["captures"] for n in ("fc_head", "fc_head_int8")},
                    engines["gpt2"].captures(), engines["gpt2_int8kv"].captures(),
                    torch.cuda.memory_reserved() / GIB, card))
            fc_sets = _fc_swap_sets(engines["fc_head"], HTTP_FC_SWAPS)
            gpt_sets = _gpt_swap_sets(engines["gpt2"], HTTP_GPT_SWAPS)
            counts0 = {n: (e.traces, e.stats()["captures"]) for n, e in engines.items()}
            gen0 = {n: (engines[n]._m_steps.value(), engines[n]._m_chunks.value())
                    for n in ("gpt2", "gpt2_int8kv")}
            e8 = engines["fc_head_int8"]
            buckets = {"fc_head": [], "fc_head_int8": []}  # each call's bucket

            def counted(engine, sink):
                real = engine._call

                def call(v, padded, n, bucket, eager):
                    sink.append(bucket)
                    return real(v, padded, n, bucket, eager)

                return call

            total = HTTP_CLIENTS * (HTTP_PREDICTS + HTTP_GENERATES)
            plan = ["fc", "gpt", "fc", "fc", "gpt", "fc"]
            swap_log = []

            def swap(done):
                k = {"fc": 0, "gpt": 0}
                for i, what in enumerate(plan):
                    while done() < (i + 1) * total // (len(plan) + 2):
                        time.sleep(0.005)
                    k[what] += 1
                    if what == "fc":
                        engines["fc_head"].set_params(fc_sets[k[what]], version=k[what])
                    else:
                        engines["gpt2"].set_params(gpt_sets[k[what]], version=k[what])
                    swap_log.append((what, k[what], done()))

            for name in buckets:
                engines[name]._call = counted(engines[name], buckets[name])
            pf.reset_kernel_launches()
            qg.reset_kernel_launches()  # the main path's counting window opens here
            epilogue = ge.kernel_launches()["gemm_epilogue"]
            try:
                replies, wall = _http_load(base, server, means, swap)
            finally:
                for name in buckets:
                    del engines[name]._call
            launches = dict(pf.kernel_launches(), **qg.kernel_launches())  # and closes here
            epilogue = ge.kernel_launches()["gemm_epilogue"] - epilogue
            if any(r["code"] != 200 for r in replies) or len(replies) != total:
                raise AssertionError("replies: %d of %d, codes %s" % (
                    len(replies), total, sorted({r["code"] for r in replies})))
            counts1 = {n: (e.traces, e.stats()["captures"]) for n, e in engines.items()}
            if counts1 != counts0:
                raise AssertionError("prepared or captured under load: %s -> %s"
                                     % (counts0, counts1))
            got = _load_launches(engines, gen0, buckets["fc_head_int8"], launches)
            routes = _route_line(replies, wall)
            log("serve http load: %d clients, %d requests in %.3f s (%d :predict of 1-250 rows, "
                "JSON up to %d rows, npz past; %d :generate of 40-700 prompt tokens and %d new, "
                "greedy and seeded temperature); hot swaps (what, version, replies done) %s; "
                "by route %s; kernel launches %s (as the engine calls imply), the GEMM "
                "epilogue %d (the f32 head's chains); card %s" % (
                    HTTP_CLIENTS, len(replies), wall, HTTP_CLIENTS * HTTP_PREDICTS,
                    HTTP_JSON_ROWS, HTTP_CLIENTS * HTTP_GENERATES, HTTP_NEW_TOKENS, swap_log,
                    json.dumps(routes), json.dumps(got), epilogue, card))
            prom = _http_call(base, "/metrics")[2].decode()
            health = json.loads(_http_call(base, "/healthz")[2])
            if 'serving_http_requests{code="200"}' not in prom or not health["ready"] or \
                    not all(m["ready"] for m in health["models"].values()):
                raise AssertionError("/metrics or /healthz after the load")
            compared = _check_replies(torch, server, replies, fc_sets, gpt_sets, md,
                                      {k: set(v) for k, v in buckets.items()})
            copies = {n: e.stats()["state_copies"] for n, e in engines.items()}
            if any(copies.values()):
                raise AssertionError("replays copied parameters after a swap: %s" % copies)
            log("serve http checks: %s replies equal the engine's direct call and a fresh "
                "engine at their version and a bucket the load served (:predict, bit for "
                "bit; buckets %s) or the scheduler's tokens at "
                "their version (:generate, those whose version did not move mid-request); "
                "versions monotone a client; state copies by replays %s; /healthz ready; "
                "/metrics serving/http/requests by code" % (
                    json.dumps(compared), {k: sorted(set(v)) for k, v in buckets.items()},
                    json.dumps(copies)))
            _fault_leg(base, server, means)
            walls = {}
            for name in ("fc_head", "fc_head_int8"):
                x, _ = _head_batch(means, np.random.RandomState(9), HEAD_EVAL_ROWS)
                eng = engines[name]
                graph, eager = [], []
                for _ in range(HTTP_WALL_CALLS):
                    timed(eng.run, graph)({"img": x})
                    timed(eng.run_op_by_op, eager)({"img": x})
                walls[name] = {"graph_ms": float(np.median(graph)),
                               "op_by_op_ms": float(np.median(eager))}
            log("serve http call wall (%d rows, bucket %d, host clock to the fetch copy, median "
                "of %d calls interleaved): %s; card %s" % (
                    HEAD_EVAL_ROWS, engines["fc_head"].bucket_batch(HEAD_EVAL_ROWS),
                    HTTP_WALL_CALLS, json.dumps(walls), card))
        finally:
            server.stop(drain=True)
        boots = _cold_start(md, means, card)
    readings["serve_http"] = {"routes": routes, "load_wall_s": wall, "call_wall": walls,
                              "gemm_epilogue_launches": epilogue,
                              "static_verify": gate,
                              "cold_start": [{k: b[k] for k in ("import_s", "fc_head",
                                                                "fc_head_int8")}
                                             for b in boots]}
    return got


# ---------------------------------------------------------------- phase 5


def _startup_state(startup):
    """The persistables the startup program makes from SEED on the card."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, scope_guard

    scope = Scope(seed=SEED, place=CUDAPlace(0))
    with scope_guard(scope):
        Executor(CUDAPlace(0)).run(startup)
    return dict(scope.vars)


def _counter_delta(before, after):
    return {(kind, k): after[kind][k] - before[kind].get(k, 0)
            for kind in after for k in after[kind] if after[kind][k] != before[kind].get(k, 0)}


def _fluid_run(torch, model, feeds, pipeline, fetch, per_op=False, check=None, after=None,
               init=None):
    """One step of `model["main"]` per feed dict (a list, or an iterator
    that makes them, here the reader and the DataFeeder) from a fresh scope
    seeded with SEED, its startup state overwritten by name from `init`
    where given, under `pipeline`, on the graph path (call 1 op by op,
    call 2 captured and replayed, the rest replayed) or with per_op on the
    op-by-op path. `check(i, before, after)` sees each step's counters and
    `after(i, scope)` the scope after each step. Returns (fetches a step,
    walls, counter deltas a step, the feeds, step, scope)."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, scope_guard
    from paddle_tpu_torch.ops import fused

    flags.set_flags({"pass_pipeline": pipeline})
    place = CUDAPlace(0)
    scope, exe = Scope(seed=SEED, place=place), Executor(place)
    names = [v.name for v in fetch]

    def step(feed):
        with scope_guard(scope):
            return exe.run(model["main"], feed=feed, fetch_list=names)

    with scope_guard(scope):
        exe.run(model["startup"])
    for name, value in (init or {}).items():
        if scope.find_var(name) is None or scope.find_var(name).shape != value.shape:
            raise AssertionError("carried state %r has no counterpart in the program" % name)
        scope.set_var(name, value.clone())
    torch.cuda.synchronize()
    outs, walls, deltas, used = [], [], [], []
    with (op_by_op() if per_op else contextlib.nullcontext()):
        for i, feed in enumerate(feeds):
            before = fused.stats()
            t0 = time.perf_counter()
            out = step(feed)
            walls.append((time.perf_counter() - t0) * 1e3)
            now = fused.stats()
            if check is not None:
                check(i, before, now)
            deltas.append(_counter_delta(before, now))
            outs.append([v.reshape(-1)[0] if v.size == 1 else v for v in out])
            used.append(feed)
            if not np.isfinite(outs[-1][0]):
                raise AssertionError("%s step %d: loss %r" % (pipeline or "unfused", i,
                                                              outs[-1][0]))
            if after is not None:
                after(i, scope)
    return outs, walls, deltas, used, step, scope


def _train_run(torch, main_prog, startup, loss, batches, pipeline, step_check, init=None,
               per_op=False):
    """_fluid_run's steps of a program that fetches its loss alone:
    (losses, walls, scope, step, each step's counter deltas)."""
    outs, walls, deltas, _, step, scope = _fluid_run(
        torch, {"main": main_prog, "startup": startup}, batches, pipeline, [loss],
        per_op=per_op, check=step_check, init=init)
    return [o[0] for o in outs], walls, scope, step, deltas


FLASH_KERNELS = ("flash_fwd", "flash_bwd_fused")  # a train_flash step's
FLASH_PAIR = ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq")  # the long tier: none a step


def _per_step(cfg):
    """Kernel launches a training step of `cfg` makes: two GEMMs in each FFN,
    a residual layer_norm after each sublayer (2 in an encoder layer, 3 in a
    decoder layer) and its grad, one Adam launch for the whole (f32)
    parameter set (each also a dispatch of its fused family); under
    use_flash one forward and one fused-tier backward launch per attention
    block (encoder self and cross attention non-causal, decoder self
    attention causal), and none of the dK/dV + dQ pair."""
    n = cfg["n_layer"]
    fused_want = {"gemm_epilogue": 4 * n, "layer_norm": 5 * n, "layer_norm_grad": 5 * n,
                  "multi_adam": 1}
    flash = cfg.get("use_flash", False)
    flash_want = {}
    for kern in FLASH_KERNELS + FLASH_PAIR:
        on = flash and kern in FLASH_KERNELS
        flash_want[kern] = 2 * n if on else 0
        flash_want[kern + "_causal"] = n if on else 0
    return fused_want, flash_want


def _launch_check(cfg):
    fused_want, flash_want = _per_step(cfg)

    def check(i, before, after):
        for k, n in fused_want.items():
            got = after["launches"][k] - before["launches"][k]
            disp = after["dispatches"].get(k, 0) - before["dispatches"].get(k, 0)
            if got != n or disp != n:
                raise AssertionError("step %d: %s launched %d times, dispatched %d, want %d"
                                     % (i, k, got, disp, n))
        for k, n in flash_want.items():
            got = after["launches"][k] - before["launches"][k]
            if got != n:
                raise AssertionError("step %d: %s launched %d times, want %d" % (i, k, got, n))

    return check


def _train_fused(torch, cfg, card, label, readings):
    """TRAIN_STEPS steps of `cfg` under training_fused on the graph path, each
    step's launches checked, then COMPARE_STEPS steps on the op-by-op path
    from the same seed: the same losses bit for bit and the same launches
    and dispatches a step. Returns (launches over the graph steps, losses,
    batches, program)."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof

    t0 = time.perf_counter()
    main_prog, startup, loss = prof.build(cfg)
    n_adam = sum(op.type == "adam" for op in main_prog.global_block().ops)
    batches = [prof.make_batch(cfg, SEED + i) for i in range(TRAIN_STEPS)]
    fused.reset_stats()  # the main path's counting window opens here
    losses, walls, scope, step, deltas = _train_run(
        torch, main_prog, startup, loss, batches, "training_fused", _launch_check(cfg))
    launches = fused.stats()["launches"]  # and closes here
    reserved = torch.cuda.memory_reserved() / GIB  # the scope, its graph and the pool
    log("%s: Transformer base %s, %d Adam ops, built and initialised in %.1f s" % (
        label, json.dumps(cfg), n_adam, time.perf_counter() - t0))
    # steps 3-6 replay the graph (step 1 runs op by op and applies the pass
    # pipeline, step 2 captures)
    tokens = sum(prof.target_tokens(b) for b in batches[2:])
    graph = {"step_p50_ms": float(np.median(walls[2:])),
             "target_tokens_per_s": tokens / (sum(walls[2:]) / 1e3),
             "memory_reserved_gib_after_graph_steps": reserved}
    breakdown = prof.profile_steps(step, batches[:2], registry, per_op=True)
    del scope, step
    torch.cuda.empty_cache()
    e_losses, e_walls, escope, estep, e_deltas = _train_run(
        torch, main_prog, startup, loss, batches[:COMPARE_STEPS], "training_fused",
        _launch_check(cfg), per_op=True)
    del escope, estep
    torch.cuda.empty_cache()
    for i, (g, e) in enumerate(zip(losses, e_losses)):
        if g.tobytes() != e.tobytes():
            raise AssertionError("%s step %d: graph loss %r, op by op %r" % (label, i, g, e))
    if deltas[:COMPARE_STEPS] != e_deltas:
        raise AssertionError("%s: counters a step %s on the graph path, %s op by op"
                             % (label, deltas[:COMPARE_STEPS], e_deltas))
    e_tokens = sum(prof.target_tokens(b) for b in batches[1:COMPARE_STEPS])
    eager = {"step_p50_ms": float(np.median(e_walls[1:])),
             "target_tokens_per_s": e_tokens / (sum(e_walls[1:]) / 1e3)}
    for path, d, b in (("graph", graph, breakdown), ("op_by_op", eager, breakdown["op_by_op"])):
        d.update(device_busy_ms=b["device_busy_ms_per_step"],
                 device_launches=b["device_launches_per_step"],
                 profiled_wall_p50_ms=b["wall_ms_p50"])
    readings[label.replace(" ", "_")] = {"graph": graph, "op_by_op": eager}
    fused_want, flash_want = _per_step(cfg)
    by_kernel = breakdown["device_ms_per_step_by_kernel"]
    ln_fwd = [v for k, v in by_kernel.items() if "ln_fwd_kernel" in k]
    ln_bwd = [v for k, v in by_kernel.items() if "ln_bwd_kernel" in k]
    adam = [v for k, v in by_kernel.items() if "multi_adam_kernel" in k]
    log("%s: in the profiled graph steps ln_fwd_kernel takes %.4f ms of device time a step (%s "
        "launches), ln_bwd_kernel %.4f ms (%s launches) and multi_adam_kernel %.4f ms (%s "
        "launches); op by op, the fused Adam lowering takes %.3f ms of host time a step (op "
        "timer); card %s" % (
            label, sum(v["ms"] for v in ln_fwd), sum(v["launches"] for v in ln_fwd),
            sum(v["ms"] for v in ln_bwd), sum(v["launches"] for v in ln_bwd),
            sum(v["ms"] for v in adam), sum(v["launches"] for v in adam),
            breakdown["op_by_op"]["op_host_ms_per_step"].get("fused:multi_adam", 0.0), card))
    log("%s: %d graph steps, losses %s; step wall p50 %.3f ms over steps 3-%d (step 1 op by op "
        "with the pass pipeline %.1f ms, step 2 captured %.1f ms); %.1f target tokens/s (their "
        "target tokens over their summed wall); device busy %s ms a step = %s of the wall p50 of "
        "the profiled window (%.3f ms), %s device launches a step; kernel launches %s (per step "
        "%s); memory reserved after the graph steps %.4f GiB; card %s" % (
            label, TRAIN_STEPS, ["%.6f" % v for v in losses], graph["step_p50_ms"], TRAIN_STEPS,
            walls[0], walls[1], graph["target_tokens_per_s"], breakdown["device_busy_ms_per_step"],
            breakdown["device_busy_share"], breakdown["wall_ms_p50"],
            breakdown["device_launches_per_step"], json.dumps(launches),
            json.dumps(dict(fused_want, **flash_want)), reserved, card))
    log("%s, op by op: %d steps from the same seed, losses %s bit for bit the graph path's, the "
        "same launches and dispatches a step; step wall p50 %.3f ms over steps 2-%d; %.1f target "
        "tokens/s; device busy %s ms a step, %s device launches a step; card %s" % (
            label, COMPARE_STEPS, ["%.6f" % v for v in e_losses], eager["step_p50_ms"],
            COMPARE_STEPS, eager["target_tokens_per_s"], eager["device_busy_ms"],
            eager["device_launches"], card))
    return launches, [float(v) for v in losses], batches, (main_prog, startup, loss)


def train(torch, card, readings):
    """Transformer base under training_fused for TRAIN_STEPS steps (and op
    by op), then an unfused run from the same seed; returns the training
    kernels' launches over the fused graph steps."""
    from paddle_tpu_torch.tools import profile_training as prof

    launches, losses, batches, prog = _train_fused(torch, prof.BASE, card, "train", readings)
    F32_FIRST["transformer"] = losses[:COMPARE_STEPS]
    ref, _, uscope, ustep, _ = _train_run(torch, *prog, batches[:COMPARE_STEPS], "",
                                          _exact_counts({}, "unfused train"))
    ref = [float(v) for v in ref]
    del uscope, ustep
    torch.cuda.empty_cache()
    a, b = np.asarray(losses[:COMPARE_STEPS]), np.asarray(ref)
    if not np.allclose(a, b, rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("fused vs unfused losses differ: %s vs %s" % (a.tolist(), b.tolist()))
    log("train: fused losses %s; unfused %s (max abs diff %.3g, rtol %g atol %g)" % (
        ["%.6f" % v for v in a], ["%.6f" % v for v in ref], float(np.abs(a - b).max()),
        FUSED_RTOL, FUSED_ATOL))
    return {k: launches[k] for k in _per_step(prof.BASE)[0]}


def train_flash(torch, card, readings):
    """The flash configuration (use_flash=True, padded=False, no bias feeds)
    under training_fused for TRAIN_STEPS steps (and op by op), then flash
    against dense on the same weights at dropout 0; returns the flash
    kernels' launches over the flash graph steps."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.tools import profile_training as prof

    launches, _, _, _ = _train_fused(torch, prof.BASE_FLASH, card, "train flash", readings)
    # the dense program cannot drop attention-weight dropout, so both run at 0
    fcfg, dcfg = dict(prof.BASE_FLASH, dropout=0.0), dict(prof.BASE, dropout=0.0)
    b, t, h = fcfg["batch"], fcfg["t"], fcfg["n_head"]
    lens = [t] * b
    biases = {"src_slf_attn_bias": transformer.make_attn_bias(lens, t, h),
              "trg_slf_attn_bias": transformer.make_attn_bias(lens, t, h, causal=True),
              "trg_src_attn_bias": transformer.make_attn_bias(lens, t, h)}
    fbatches = [prof.make_batch(fcfg, SEED + 100 + i) for i in range(COMPARE_STEPS)]
    dbatches = [dict(fb, **biases) for fb in fbatches]
    fprog, dprog = prof.build(fcfg), prof.build(dcfg)
    init = _startup_state(fprog[1])
    runs = []
    for prog, batches in ((fprog, fbatches), (dprog, dbatches)):
        out = _train_run(torch, *prog, batches, "training_fused", lambda *a: None, init=init)
        runs.append(np.asarray([float(v) for v in out[0]]))
        del out
        torch.cuda.empty_cache()
    del init
    a, d = runs
    if not np.allclose(a, d, rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("flash vs dense losses differ: %s vs %s" % (a.tolist(), d.tolist()))
    log("train flash: flash vs dense on the same weights at dropout 0, %d steps: losses %s vs "
        "%s (max abs diff %.3g, rtol %g atol %g)" % (
            COMPARE_STEPS, ["%.6f" % v for v in a], ["%.6f" % v for v in d],
            float(np.abs(a - d).max()), FUSED_RTOL, FUSED_ATOL))
    return {"flash_fwd": launches["flash_fwd"],
            "flash_fwd_causal": launches["flash_fwd_causal"],
            "flash_bwd": launches["flash_bwd_fused"],
            "flash_bwd_causal": launches["flash_bwd_fused_causal"]}


# ---------------------------------------------------------------- phase 7

LENET_STEPS = 60  # graph steps of the book script (tests/test_mnist.py's 60)
LENET_TEST_BATCH = 16
# a LeNet step: its three fc chains (k = 400, 120, 84) take the GEMM
# epilogue, its Adam one multi_adam launch; nothing else
LENET_PER_STEP = {"gemm_epilogue": 3, "multi_adam": 1}
# ResNet-50 at bench.py's batch 256 (bench.py:39), the first rung of its
# ladder (256, 128, 64, 32; bench.py:3945)
RESNET_STEPS = 4  # graph steps after the warmup (op by op) and the capture


def _exact_counts(want, label):
    def check(i, before, after):
        got = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
        disp = {k: v - before["dispatches"].get(k, 0) for k, v in after["dispatches"].items()}
        launched = {k: v for k, v in got.items() if v}
        dispatched = {k: v for k, v in disp.items() if v}
        if launched != want or dispatched != want:
            raise AssertionError("%s step %d: launches %s, dispatches %s, want %s each"
                                 % (label, i, launched, dispatched, want))

    return check


def _same_bits(label, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if np.asarray(g).tobytes() != np.asarray(w).tobytes():
            raise AssertionError("%s %d: %r against %r" % (label, i, g, w))


def train_lenet(torch, card, readings):
    """The book script through paddle_tpu_torch.fluid on CUDAPlace(0):
    batch(reader.shuffle(dataset.mnist.train(), 500), 64) into a DataFeeder,
    LeNet-5 under Adam 1e-3 and training_fused for LENET_STEPS graph steps
    (every step 3 GEMM epilogue and 1 multi_adam launches), with the gates
    of tests/test_mnist.py:64-67; the first 3 losses against an unfused run
    and against the op-by-op path; then, at batch 16, the for_test clone,
    a save_persistables / load_persistables round trip into a fresh scope
    and a save_inference_model / load_inference_model round trip. Returns
    the kernels' launches over the main path's steps."""
    import itertools
    import tempfile

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, fluid, scope_guard
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof

    place = CUDAPlace(0)
    model = prof.build_lenet()
    feeder = fluid.DataFeeder([model["img"], model["label"]], place=place, program=model["main"])
    reader = prof.mnist_reader()
    fetch = [model["loss"], model["acc"]]
    fused.reset_stats()  # the main path's counting window opens here
    outs, walls, deltas, feeds, step, scope = _fluid_run(
        torch, model, (feeder.feed(b) for b in itertools.islice(reader(), LENET_STEPS)),
        "training_fused", fetch, check=_exact_counts(LENET_PER_STEP, "lenet"))
    launches = fused.stats()["launches"]  # and closes here
    losses = [float(o[0]) for o in outs]
    accs = [float(o[1]) for o in outs]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (last5 < 0.7 * first5 and np.mean(accs[-5:]) > 0.5):
        raise AssertionError("lenet did not learn: loss %.4f -> %.4f, accuracy %.3f"
                             % (first5, last5, np.mean(accs[-5:])))
    graph = {"step_p50_ms": float(np.median(walls[2:])),
             "images_per_s": prof.LENET["batch"] * (len(walls) - 2) / (sum(walls[2:]) / 1e3)}
    breakdown = prof.profile_steps(lambda b: step(b), feeds[:4], registry)
    graph.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                 device_launches=breakdown["device_launches_per_step"],
                 profiled_wall_p50_ms=breakdown["wall_ms_p50"])

    # the for_test clone at batch 16: op by op, captured, replayed, the same
    # bits; a checkpoint into a fresh scope gives them again
    test_feed = feeder.feed(next(prof.mnist_reader(LENET_TEST_BATCH, test=True)()))
    exe = Executor(place)
    tfetch = [model["loss"].name, model["logits"].name]
    with scope_guard(scope):
        tests = [exe.run(model["test"], feed=test_feed, fetch_list=tfetch) for _ in range(3)]
    for t in tests[1:]:
        _same_bits("lenet test loss and logits, run", t, tests[0])
    with tempfile.TemporaryDirectory() as d:
        with scope_guard(scope):
            fluid.io.save_persistables(exe, os.path.join(d, "ckpt"), model["main"])
            fluid.io.save_inference_model(os.path.join(d, "infer"), ["img"], [model["logits"]],
                                          exe, main_program=model["main"])
        with scope_guard(Scope(seed=SEED + 1, place=place)):
            fluid.io.load_persistables(exe, os.path.join(d, "ckpt"), model["main"])
            loaded = [exe.run(model["test"], feed=test_feed, fetch_list=tfetch)
                      for _ in range(2)]
        with scope_guard(Scope(seed=SEED + 2, place=place)):
            prog, feed_names, fetch_vars = fluid.io.load_inference_model(os.path.join(d, "infer"),
                                                                         exe)
            (infer_logits,) = exe.run(prog, feed={feed_names[0]: test_feed["img"]},
                                      fetch_list=[v.name for v in fetch_vars])
    for t in loaded:
        _same_bits("lenet test loss and logits after load_persistables, run", t, tests[0])
    _same_bits("lenet logits from load_inference_model", [infer_logits], [tests[0][1]])
    del step, scope, exe
    torch.cuda.empty_cache()

    unfused, _, _, _, ustep, uscope = _fluid_run(torch, model, feeds[:COMPARE_STEPS], "", fetch,
                                                 check=_exact_counts({}, "unfused lenet"))
    ref = [float(o[0]) for o in unfused]
    a = np.asarray(losses[:COMPARE_STEPS])
    if not np.allclose(a, ref, rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("lenet fused vs unfused losses differ: %s vs %s" % (a.tolist(), ref))
    eager, e_walls, e_deltas, _, estep, escope = _fluid_run(
        torch, model, feeds[:COMPARE_STEPS], "training_fused", fetch, per_op=True,
        check=_exact_counts(LENET_PER_STEP, "lenet op by op"))
    _same_bits("lenet loss and accuracy, graph against op by op, step", [o for o in eager],
               outs[:COMPARE_STEPS])
    if e_deltas != deltas[:COMPARE_STEPS]:
        raise AssertionError("lenet: counters a step %s on the graph path, %s op by op"
                             % (deltas[:COMPARE_STEPS], e_deltas))
    del ustep, uscope, estep, escope
    torch.cuda.empty_cache()
    readings["train_lenet"] = {"graph": graph, "op_by_op": {
        "step_p50_ms": float(np.median(e_walls[1:])),
        "images_per_s": prof.LENET["batch"] * (len(e_walls) - 1) / (sum(e_walls[1:]) / 1e3)}}
    log("train lenet: the book script, %d graph steps of batch %d from reader -> DataFeeder -> "
        "Executor.run, losses %.4f -> %.4f (first and last 5), accuracy of the last 5 %.3f; "
        "fused vs unfused %s vs %s (rtol %g atol %g); the first %d losses and accuracies bit for "
        "bit op by op, the same launches and dispatches a step (%s); the for_test clone at batch "
        "%d, load_persistables into a fresh scope and load_inference_model give its loss and "
        "logits bit for bit; step wall p50 %.3f ms, %.1f images/s over steps 3-%d, device busy "
        "%s ms a step, %s device launches a step; op by op %.3f ms a step; kernel launches %s; "
        "card %s" % (
            LENET_STEPS, prof.LENET["batch"], first5, last5, float(np.mean(accs[-5:])),
            ["%.6f" % v for v in a], ["%.6f" % v for v in ref], FUSED_RTOL, FUSED_ATOL,
            COMPARE_STEPS, json.dumps(LENET_PER_STEP), LENET_TEST_BATCH, graph["step_p50_ms"],
            graph["images_per_s"], LENET_STEPS, graph["device_busy_ms"],
            graph["device_launches"], readings["train_lenet"]["op_by_op"]["step_p50_ms"],
            json.dumps({k: v for k, v in launches.items() if v}), card))
    return {k: launches[k] for k in LENET_PER_STEP}


def _running_stats(model, scope):
    """Copies of every batch_norm's running mean and variance in the scope."""
    names = sorted({n for op in model["main"].global_block().ops if op.type == "batch_norm"
                    for n in op.input("Mean") + op.input("Variance")})
    return {n: scope.vars[n].detach().clone() for n in names}


BN_AB_STEPS = 4  # graph steps of the generic-grad run, after the warmup and capture
# a batch_norm_grad call against the generic grad on the card: rtol, and
# atol as a share of the generic grad's largest magnitude (sums over
# millions of values a channel, in another order)
BN_GRAD_TOL = (1e-4, 1e-5)


@contextlib.contextmanager
def _generic_bn_grad():
    """batch_norm's generic vjp grad (the forward replayed under
    torch.func.vjp) in place of the explicit batch_norm_grad, while
    entered: the parent's form, for the before-and-after reading. A block
    prepared inside lowers with the generic grad."""
    from paddle_tpu_torch.ops import registry

    explicit = registry.OPS.pop("batch_norm_grad")
    try:
        yield
    finally:
        registry.OPS["batch_norm_grad"] = explicit


def _explicit_bn_grad():
    """Fails unless batch_norm_grad lowers through its explicit lowering."""
    from paddle_tpu_torch.ops import core_ops, registry

    if registry.get("batch_norm_grad").lower is not core_ops._batch_norm_grad:
        raise AssertionError("batch_norm_grad does not lower through the explicit grad")


def _bn_share(split, cats):
    """(batch_norm's device ms a step, its share of the op-by-op device
    time) over the categories `cats` of an op_device_split."""
    ms = sum(split["by_category"][c] for c in cats)
    return ms, ms / split["device_ms_per_step"]


def _bn_grad_ab(torch, model, feeds, label, explicit_losses, split_by, cats):
    """The model again with batch_norm's generic grad, from the same seed
    and batches: BN_AB_STEPS graph steps after the warmup and the capture
    (the step wall p50), and 2 op-by-op steps split by op type
    (batch_norm's device ms and share). The first loss (one forward, no
    grad yet) equals the explicit grad run's bit for bit and the second
    (one update through every batch_norm grad) is within the
    fused-vs-unfused bar; later ones are logged only: at these rates the
    runs part by more than rounding within two updates (ResNet-50's third
    loss by 3e-3 relative for a 1e-6 difference in the second). Returns
    the reading."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.tools import profile_training as prof

    with _generic_bn_grad():
        outs, walls, _, _, step, scope = _fluid_run(
            torch, model, feeds[:2 + BN_AB_STEPS], "training_fused", [model["loss"]])
        del step, scope
        torch.cuda.empty_cache()
        _, _, _, _, estep, escope = _fluid_run(
            torch, model, feeds[:1], "training_fused", [model["loss"]], per_op=True)
        split = prof.op_device_split(estep, feeds[:2], registry, split_by=split_by)
        del estep, escope
        torch.cuda.empty_cache()
    losses = [float(o[0]) for o in outs]
    if losses[0] != explicit_losses[0] or not np.isclose(
            explicit_losses[1], losses[1], rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("%s: explicit batch_norm_grad losses %s against the generic grad's "
                             "%s (the first bit for bit, the second within rtol %g atol %g)"
                             % (label, explicit_losses[:2], losses[:2], FUSED_RTOL, FUSED_ATOL))
    ms, share = _bn_share(split, cats)
    return {"step_p50_ms": float(np.median(walls[2:])), "losses": losses[:COMPARE_STEPS],
            "op_by_op_device_ms": split["device_ms_per_step"], "batch_norm_ms": ms,
            "batch_norm_share": share}


def _bn_ab_line(label, explicit, generic, card):
    log("%s batch_norm_grad before / after (the generic vjp grad, then the explicit grad, same "
        "call, same seed and batches): graph step wall p50 %.3f / %.3f ms; op by op: batch_norm "
        "forward + grad %.3f / %.3f ms a step = %.4f / %.4f of the device time (%.3f / %.3f ms); "
        "first %d losses %s / %s; card %s" % (
            label, generic["step_p50_ms"], explicit["step_p50_ms"], generic["batch_norm_ms"],
            explicit["batch_norm_ms"], generic["batch_norm_share"], explicit["batch_norm_share"],
            generic["op_by_op_device_ms"], explicit["op_by_op_device_ms"], COMPARE_STEPS,
            ["%.6f" % v for v in generic["losses"]], ["%.6f" % v for v in explicit["losses"]],
            card))


def train_resnet50(torch, card, readings):
    """ResNet-50 at its published widths (He et al. 2016, Table 1, 50-layer:
    bottlenecks [3, 4, 6, 3], filters 64-512 (x4), 3 x 224 x 224 inputs,
    1000 classes; random weights from SEED) under Momentum(0.1, 0.9) in
    f32 at batch 256 (bench.py:23-39), synthetic batches staged on the card
    and cycled (bench.py:63-72), under training_fused: the warmup and the
    capture, then RESNET_STEPS graph steps, every loss finite and no
    hand-written kernel launched (its one fc has n = 1000, which the GEMM
    epilogue's block rule declines, as in the JAX package); then the first
    3 steps op by op from the same weights: the losses and every running
    mean and variance bit for bit (cuDNN restricted to deterministic
    algorithms). Logs images/s, the step wall, the device's busy share and
    launches, the memory reserved and the busy split by op type; then the
    same model with batch_norm's generic grad (_bn_grad_ab): the step wall
    and batch_norm's device share before and after the explicit
    batch_norm_grad, from this call."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof

    _explicit_bn_grad()
    t0 = time.perf_counter()
    model = prof.build_resnet50()
    staged = prof.resnet50_feeds(torch.device("cuda", 0))
    feeds = [staged[i % len(staged)] for i in range(2 + RESNET_STEPS)]
    batch = prof.RESNET50["batch"]
    snap = {}

    def keep_stats(i, scope):
        if i == COMPARE_STEPS - 1:
            snap.update(_running_stats(model, scope))

    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # the main path's counting window opens here
    outs, walls, _, _, step, scope = _fluid_run(
        torch, model, feeds, "training_fused", [model["loss"]], check=_exact_counts({}, "resnet50"),
        after=keep_stats)
    stats = fused.stats()  # and closes here: nothing launched or dispatched
    reserved = torch.cuda.max_memory_reserved() / GIB
    losses = [float(o[0]) for o in outs]
    F32_FIRST["resnet50"] = losses[:COMPARE_STEPS]
    graph = {"batch": batch, "step_p50_ms": float(np.median(walls[2:])),
             "images_per_s": batch * RESNET_STEPS / (sum(walls[2:]) / 1e3),
             "memory_max_reserved_gib": reserved}
    breakdown = prof.profile_steps(step, feeds[2:4], registry)
    graph.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                 device_busy_share=breakdown["device_busy_share"],
                 device_launches=breakdown["device_launches_per_step"],
                 profiled_wall_p50_ms=breakdown["wall_ms_p50"])
    top = list(breakdown["device_ms_per_step_by_kernel"].items())[:8]
    del step, scope
    torch.cuda.empty_cache()
    eager, e_walls, _, _, estep, escope = _fluid_run(
        torch, model, feeds[:COMPARE_STEPS], "training_fused", [model["loss"]], per_op=True,
        check=_exact_counts({}, "resnet50 op by op"))
    _same_bits("resnet50 loss, graph against op by op, step", [o[0] for o in eager],
               [o[0] for o in outs[:COMPARE_STEPS]])
    estats = _running_stats(model, escope)
    if sorted(estats) != sorted(snap) or not snap:
        raise AssertionError("resnet50: running statistics %s vs %s" % (sorted(estats),
                                                                          sorted(snap)))
    for n in snap:
        if not torch.equal(estats[n], snap[n]):
            raise AssertionError("resnet50 %s after %d steps: graph and op by op differ by %g"
                                 % (n, COMPARE_STEPS, float((estats[n] - snap[n]).abs().max())))
    split = prof.op_device_split(estep, feeds[:2], registry)
    del estep, escope
    torch.cuda.empty_cache()
    eager_reading = {"step_p50_ms": float(np.median(e_walls[1:])),
                     "images_per_s": batch * (len(e_walls) - 1) / (sum(e_walls[1:]) / 1e3),
                     "device_ms_by_op_type": split["device_ms_per_step"],
                     "split": split["by_category"],
                     "conv_backward_by_kernel_name": split["conv_backward_by_kernel_name"]}
    readings["train_resnet50"] = {"graph": graph, "op_by_op": eager_reading}
    bn_cats = ("batch_norm_forward", "batch_norm_backward")
    bn_ms, bn_share = _bn_share(split, bn_cats)
    explicit = {"step_p50_ms": graph["step_p50_ms"], "losses": losses[:COMPARE_STEPS],
                "op_by_op_device_ms": split["device_ms_per_step"], "batch_norm_ms": bn_ms,
                "batch_norm_share": bn_share}
    generic = _bn_grad_ab(torch, model, feeds, "resnet50", losses, prof.SPLIT, bn_cats)
    readings["train_resnet50"]["batch_norm_grad_ab"] = {"generic": generic, "explicit": explicit}
    _bn_ab_line("train resnet50", explicit, generic, card)
    log("train resnet50, op by op: the top kernels of each category (ms a step) %s; card %s"
        % (json.dumps({c: {k[:70]: round(v, 3) for k, v in ks.items()}
                       for c, ks in split["top_kernels_by_category"].items()}), card))
    log("train resnet50: ResNet-50 (bottlenecks [3, 4, 6, 3], 3 x 224 x 224, 1000 classes), "
        "Momentum(0.1, 0.9), f32, batch %d, %d ops, built and run in %.1f s; losses %s; no "
        "hand-written kernel launched or dispatched (%s); the first %d losses and %d running "
        "statistics bit for bit op by op; step wall p50 %.3f ms, %.1f images/s over the %d graph "
        "steps; device busy %s ms a step = %s of the profiled wall p50 (%.3f ms), %s device "
        "launches a step; max memory reserved %.3f GiB; top kernels %s; op by op: step wall p50 "
        "%.3f ms, device %.3f ms a step by op type, split %s, conv grads by kernel name %s; "
        "card %s" % (
            batch, len(model["main"].global_block().ops), time.perf_counter() - t0,
            ["%.6f" % v for v in losses], json.dumps(stats), COMPARE_STEPS, len(snap),
            graph["step_p50_ms"], graph["images_per_s"], RESNET_STEPS, graph["device_busy_ms"],
            graph["device_busy_share"], breakdown["wall_ms_p50"], graph["device_launches"],
            reserved, json.dumps([(k[:60], round(v["ms"], 3)) for k, v in top]),
            eager_reading["step_p50_ms"], split["device_ms_per_step"],
            json.dumps({k: round(v, 3) for k, v in split["by_category"].items()}),
            json.dumps({k: round(v, 3) for k, v in split["conv_backward_by_kernel_name"].items()}),
            card))
    _resnet50_pipeline(torch, model, staged, losses, walls, graph, card, readings)


PIPELINE_RATIO_MIN = 0.9  # a fed step's images/s against the staged steps' (bench.py's frac)
PIPELINE_WORKERS = 2  # decode workers of the data-runtime leg
PIPELINE_U8_RTOL = 1e-6
PIPELINE_STEPS = 8  # graph steps of a fed leg: a one-off stall weighs 1/8 of its window


def _allocator_counts(torch):
    """(cudaMalloc calls, allocation retries, pinned host blocks created,
    ms spent creating them) so far: the caching allocator's segments
    allocated (torch.cuda.memory_stats) and the pinned host allocator's
    growth (torch.cuda.host_memory_stats; zeros where the build lacks it)."""
    stats = torch.cuda.memory_stats()
    host = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    return (int(stats.get("num_device_alloc", stats.get("segment.all.allocated", 0))),
            int(stats.get("num_alloc_retries", 0)), int(host.get("num_host_alloc", 0)),
            float(host.get("host_alloc_time.total", 0)) / 1e3)


def _resnet50_pipeline(torch, model, staged, staged_losses, staged_walls, graph, card,
                       readings):
    """ResNet-50 fed through the data layer, as bench.py feeds it, each leg
    the warmup, the capture and PIPELINE_STEPS graph steps from the phase's
    weights, Executor.run pulling each batch from the program's reader
    (feed=None) inside the timed step:

    - the thread path: a PyReader over the phase's staged batches copied
      to host memory once and cycled (numpy's RNG out of the timed window):
      its feeder thread copies batch k+1 into pinned memory and to the card
      on its copy stream while step k runs. Losses bit for bit the staged
      steps';
    - the data-runtime path: PIPELINE_WORKERS decode worker processes (a
      shard factory: each worker makes its shard's uint8 images once),
      uint8 on the wire (the executor's f32 feed buffer makes the cast on
      the card), the shared-memory ring, the drain thread's copy stream.
      Its first batch fed again as f32 from the same weights: the first
      loss within rtol PIPELINE_U8_RTOL.

    Each leg's images/s over its graph steps against the staged steps'
    (graph["images_per_s"]) must be at least PIPELINE_RATIO_MIN. Also
    reported: the same ratio over the steady steps (the first replay after
    the capture left out of both), the cudaMalloc calls and allocation
    retries in each fed step, and the cost of staging one batch (pinned copy
    and the copy to the card) beside the step."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.data.runtime import Stager, take
    from paddle_tpu_torch.py_reader import PyReader
    from paddle_tpu_torch.tools import profile_training as prof

    device = torch.device("cuda", 0)
    batch = prof.RESNET50["batch"]
    n = 2 + PIPELINE_STEPS
    host = [{k: v.cpu().numpy() for k, v in b.items()} for b in staged]
    ref_ips = graph["images_per_s"]
    main = model["main"]

    def steady_ips(walls):
        return batch * (len(walls) - 3) / (sum(walls[3:]) / 1e3)

    def fed_run(reader, first=None):
        main._py_readers = [reader]
        counts = [_allocator_counts(torch)]
        try:
            feeds = ([first] if first is not None else []) + [None] * (n - (first is not None))
            outs, walls, _, _, step, scope = _fluid_run(
                torch, model, feeds, "training_fused", [model["loss"]],
                check=lambda i, before, now: counts.append(_allocator_counts(torch)))
        finally:
            reader.reset()
            main._py_readers = []
        del step, scope
        torch.cuda.empty_cache()
        ips = batch * PIPELINE_STEPS / (sum(walls[2:]) / 1e3)
        per_step = [[b[j] - a[j] for a, b in zip(counts, counts[1:])] for j in range(4)]
        return [float(o[0]) for o in outs], walls, ips, per_step

    # the thread path
    thread = PyReader(["img", "label"], capacity=2, place=CUDAPlace(0))
    thread.decorate_tensor_provider(lambda: (host[i % len(host)] for i in range(n)))
    thread.start()
    t_losses, t_walls, t_ips, t_mallocs = fed_run(thread)
    thread.close()
    if len(staged_losses) > n:
        raise AssertionError("%d staged losses against %d fed steps" % (len(staged_losses), n))
    _same_bits("resnet50 fed by the PyReader thread against the staged steps, loss at step",
               t_losses[:len(staged_losses)], staged_losses)

    # the data-runtime path: uint8 on the wire from decode workers
    per_shard = n // PIPELINE_WORKERS

    def shards(shard_id, num_shards):
        rng = np.random.RandomState(SEED + 1000 + shard_id)
        b = {"img": rng.randint(0, 256, (batch, 3, 224, 224)).astype("uint8"),
             "label": rng.randint(0, 1000, (batch, 1)).astype("int64")}
        for _ in range(per_shard):
            yield b

    runtime = PyReader(["img", "label"], capacity=4, wire_dtypes={"img": "uint8"},
                       place=CUDAPlace(0))
    runtime.decorate_tensor_provider(shards, num_workers=PIPELINE_WORKERS,
                                     num_shards=PIPELINE_WORKERS)
    runtime.start()
    first = runtime.next_batch()
    if first["img"].dtype != torch.uint8 or first["img"].device != device:
        raise AssertionError("the runtime staged img as %s on %s" % (first["img"].dtype,
                                                                    first["img"].device))
    as_f32 = {"img": first["img"].float(), "label": first["label"].clone()}
    r_losses, r_walls, r_ips, r_mallocs = fed_run(runtime, first)
    runtime.close()
    f32_outs, _, _, _, step, scope = _fluid_run(torch, model, [as_f32], "training_fused",
                                                [model["loss"]])
    del step, scope
    torch.cuda.empty_cache()
    u8_err = abs(r_losses[0] - float(f32_outs[0][0])) / abs(float(f32_outs[0][0]))
    if not np.isfinite(r_losses).all() or u8_err > PIPELINE_U8_RTOL:
        raise AssertionError("resnet50 uint8 wire: losses %s, the first against f32 %.3g "
                             "(bar %g)" % (r_losses, u8_err, PIPELINE_U8_RTOL))

    # one batch staged: the pinned copy and the copy to the card
    stager = Stager(device)
    stage_ms, copy_ms = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = take(stager(host[i % len(host)]))
        torch.cuda.current_stream().synchronize()
        stage_ms.append((time.perf_counter() - t0) * 1e3)
        pin = torch.empty(b["img"].shape, dtype=b["img"].dtype, pin_memory=True)
        pin.copy_(torch.from_numpy(host[i % len(host)]["img"]))
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        b["img"].copy_(pin, non_blocking=True)
        ev1.record()
        ev1.synchronize()
        copy_ms.append(ev0.elapsed_time(ev1))
        del b, pin
    torch.cuda.empty_cache()
    ratios = {"pyreader_thread": t_ips / ref_ips, "data_runtime_uint8": r_ips / ref_ips}
    ref_steady = steady_ips(staged_walls)
    steady = {"pyreader_thread": steady_ips(t_walls) / ref_steady,
              "data_runtime_uint8": steady_ips(r_walls) / ref_steady}
    step_ms = graph["step_p50_ms"]
    reading = {
        "staged_images_per_s": ref_ips, "pyreader_images_per_s": t_ips,
        "data_runtime_images_per_s": r_ips, "ratios": ratios, "fed_steps": PIPELINE_STEPS,
        "staged_steady_images_per_s": ref_steady, "steady_ratios": steady,
        "pyreader_cuda_mallocs_a_step": t_mallocs[0],
        "pyreader_alloc_retries_a_step": t_mallocs[1],
        "pyreader_pinned_blocks_a_step": t_mallocs[2],
        "pyreader_pinned_alloc_ms_a_step": t_mallocs[3],
        "data_runtime_cuda_mallocs_a_step": r_mallocs[0],
        "data_runtime_alloc_retries_a_step": r_mallocs[1],
        "data_runtime_pinned_blocks_a_step": r_mallocs[2],
        "data_runtime_pinned_alloc_ms_a_step": r_mallocs[3],
        "pyreader_step_p50_ms": float(np.median(t_walls[2:])),
        "data_runtime_step_p50_ms": float(np.median(r_walls[2:])),
        "pyreader_step_walls_ms": t_walls, "data_runtime_step_walls_ms": r_walls,
        "stage_one_batch_ms_p50": float(np.median(stage_ms[1:])),
        "h2d_copy_device_ms_p50": float(np.median(copy_ms[1:])),
        "h2d_copy_share_of_step": float(np.median(copy_ms[1:])) / step_ms,
        "uint8_first_loss_rel_err": u8_err}
    readings["train_resnet50"]["pipeline"] = reading
    log("train resnet50, input pipeline (%d fed graph steps a leg, %d staged): staged %.1f "
        "images/s; the PyReader thread path (host batches cycled, pinned copy + copy stream) "
        "%.1f images/s = %.4f of staged, losses bit for bit the staged steps'; the data runtime "
        "(%d worker processes, uint8 wire, shm ring, drain thread's copy stream) %.1f images/s "
        "= %.4f of staged, its first loss against the same images as f32 %.3g (bar %g); over "
        "the steady steps (the first replay left out) staged %.1f images/s, ratios %.4f / "
        "%.4f; step p50 %.3f / %.3f ms (staged %.3f), the step walls %s / %s ms (staged %s; "
        "the warmup and the capture first); cudaMalloc calls a step %s / %s, allocation "
        "retries %s / %s, pinned host blocks created %s / %s (%s / %s ms); staging one f32 batch (%.1f MB: pinned copy + copy to the card) "
        "%.3f ms wall, the copy %.3f device ms = %.4f of a staged step; bar %.2f; card %s" % (
            PIPELINE_STEPS, RESNET_STEPS, ref_ips, t_ips, ratios["pyreader_thread"],
            PIPELINE_WORKERS, r_ips, ratios["data_runtime_uint8"], u8_err, PIPELINE_U8_RTOL,
            ref_steady, steady["pyreader_thread"], steady["data_runtime_uint8"],
            reading["pyreader_step_p50_ms"], reading["data_runtime_step_p50_ms"], step_ms,
            ["%.3f" % w for w in t_walls], ["%.3f" % w for w in r_walls],
            ["%.3f" % w for w in staged_walls], t_mallocs[0], r_mallocs[0], t_mallocs[1],
            r_mallocs[1], t_mallocs[2], r_mallocs[2], ["%.3f" % v for v in t_mallocs[3]],
            ["%.3f" % v for v in r_mallocs[3]], host[0]["img"].nbytes / 1e6, reading["stage_one_batch_ms_p50"],
            reading["h2d_copy_device_ms_p50"], reading["h2d_copy_share_of_step"],
            PIPELINE_RATIO_MIN, card))
    low = {k: v for k, v in ratios.items() if v < PIPELINE_RATIO_MIN}
    if low:
        raise AssertionError("the input pipeline does not keep up: %s (bar %.2f)"
                             % (low, PIPELINE_RATIO_MIN))


# the batch_norm shapes of the checks: ResNet-50's largest at batch 256 (the
# stem's output; the 256-channel maps at 56 x 56 are as large) and
# SE-ResNeXt-50's at batch 64
BN_GRAD_SHAPES = {"resnet50": (256, 64, 112, 112), "se_resnext50": (64, 64, 112, 112)}


def check_batch_norm_grad(torch, card):
    """The explicit batch_norm_grad (one native_batch_norm_backward from the
    saved statistics) against the generic vjp grad on the same inputs, at
    BN_GRAD_SHAPES in training mode: x, scale and bias grads within
    BN_GRAD_TOL, repeated bit for bit; both timed (device ms a call, cold
    L2) beside the byte bound of the explicit call (x and dy read once, dx
    written once, over the HBM rate)."""
    from paddle_tpu_torch.ops import registry

    _explicit_bn_grad()
    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    for label, shape in BN_GRAD_SHAPES.items():
        c = shape[1]
        x = torch.randn(shape, device=device, generator=gen) * 2 + 1
        ins = {"X": [x], "Scale": [torch.rand(c, device=device, generator=gen) + 0.5],
               "Bias": [torch.randn(c, device=device, generator=gen)],
               "Mean": [torch.zeros(c, device=device)], "Variance": [torch.ones(c, device=device)]}
        attrs = {"is_test": False, "data_layout": "NCHW", "momentum": 0.9, "epsilon": 1e-5}
        ctx = registry.LowerCtx(device)
        fwd = registry.get("batch_norm").lower(ctx, ins, attrs)
        gins = dict(ins, **fwd)
        gins["Y@GRAD"] = [torch.randn(shape, device=device, generator=gen)]
        gattrs = dict(attrs, **{registry.FWD_IN_SLOTS_ATTR: list(ins),
                                registry.FWD_OUT_SLOTS_ATTR: list(fwd)})
        explicit_fn = registry.get("batch_norm_grad").lower
        generic_fn = registry._make_generic_grad(registry.get("batch_norm"))
        got = explicit_fn(ctx, gins, gattrs)
        again = explicit_fn(ctx, gins, gattrs)
        want = generic_fn(ctx, gins, gattrs)
        torch.cuda.synchronize()
        errs = {}
        for slot in ("X@GRAD", "Scale@GRAD", "Bias@GRAD"):
            g, w = got[slot][0], want[slot][0]
            if not torch.equal(g, again[slot][0]):
                raise AssertionError("batch_norm_grad %s %s: a repeat differs" % (label, slot))
            scale = float(w.abs().max())
            rel = float((g - w).abs().max()) / scale
            if not torch.allclose(g, w, rtol=BN_GRAD_TOL[0], atol=BN_GRAD_TOL[1] * scale):
                raise AssertionError("batch_norm_grad %s %s: %g of the largest |grad| from the "
                                     "generic grad (rtol %g, atol %g of it)"
                                     % (label, slot, rel, *BN_GRAD_TOL))
            errs[slot] = rel
        del got, again, want
        ms = time_ms(torch, lambda: explicit_fn(ctx, gins, gattrs), 5, flush, gated=True)
        generic_ms = time_ms(torch, lambda: generic_fn(ctx, gins, gattrs), 5, flush, gated=True)
        bound_ms = 3 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        out[label] = {"shape": list(shape), "ms": ms, "generic_ms": generic_ms,
                      "bound_ms": bound_ms, "err_over_max": errs}
        del x, ins, fwd, gins, ctx
        torch.cuda.empty_cache()
    log("batch_norm_grad: the explicit grad against the generic vjp grad (training mode), "
        "rtol %g with atol %g of the largest |grad|, repeated bit for bit: %s; ms a call (cold "
        "L2) explicit / generic / byte bound: %s; card %s" % (
            BN_GRAD_TOL[0], BN_GRAD_TOL[1],
            json.dumps({k: {s: "%.3g" % e for s, e in v["err_over_max"].items()}
                        for k, v in out.items()}),
            json.dumps({k: "%s: %.4f / %.4f / %.4f" % (v["shape"], v["ms"], v["generic_ms"],
                                                      v["bound_ms"]) for k, v in out.items()}),
            card))
    return out


ZOO_STEPS = 4  # replayed graph steps of each zoo model (graph steps 3-6)
# GEMM epilogue launches a zoo step: the fcs the block rule takes (VGG-19's
# and AlexNet's fc6 / fc7, GoogLeNet's two auxiliary 1152 -> 1024 fcs,
# SE-ResNeXt's 16 squeeze and 16 excitation fcs); every n = 1000 head
# declines, as in the JAX package
ZOO_GEMM = {"vgg19": 2, "alexnet": 2, "googlenet": 2, "se_resnext50": 32}
# the (m, k) @ (k, n) products the GEMM epilogue must take in a step
ZOO_GEMM_SHAPES = {"vgg19": [(64, 25088, 4096), (64, 4096, 4096)],
                   "alexnet": [(128, 9216, 4096), (128, 4096, 4096)]}


def _time_path_gemm(torch, x, w, b, act, flush):
    """gemm_bias_act's kernel on a path's recorded inputs, timed (device ms
    a call, cold L2) beside its plain version and torch.addmm (the product
    and the bias), with its 3xTF32 bound."""
    from paddle_tpu_torch.ops import gemm_epilogue as ge

    m, k = x.shape
    n = w.shape[1]
    b1 = b.reshape(-1)
    ms = time_ms(torch, lambda: ge.gemm_bias_act(x, w, b, act), 10, flush, gated=True)
    plain_ms = time_ms(torch, lambda: ge.gemm_bias_act_plain(x, w, b, act), 10, flush,
                       gated=True)
    lib_ms = time_ms(torch, lambda: torch.addmm(b1, x, w), 10, flush, gated=True)
    nbytes, flops = (m * k + k * n + n + (2 if act else 1) * m * n) * 4, 2 * m * n * k
    bound_ms, bound_by = _tf32x3_bound(nbytes, flops)
    return {"act": act, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def train_zoo(torch, card, readings):
    """The rest of the CNN zoo at published ImageNet widths
    (tools/profile_zoo.py: VGG-19 batch 64, AlexNet batch 128, GoogLeNet
    batch 128 with its auxiliary heads, SE-ResNeXt-50 32x4d batch 64; f32,
    Momentum, synthetic batches staged on the card), each under
    training_fused: the warmup, the capture and ZOO_STEPS graph steps,
    every loss finite, the same counters every step with ZOO_GEMM GEMM
    epilogue launches; images/s and the step wall p50 over graph steps 3-6,
    the busy share, launches and memory reserved; the first 3 steps op by
    op from the same seed: the same losses bit for bit with the same
    counters, the GEMM epilogue held against its plain version on what the
    first step gave it (VGG-19's (64, 25088) @ (25088, 4096) and AlexNet's
    (128, 9216) @ (9216, 4096) among them), and 2 steps' device time split
    by op type. Returns the kernels' launches on the graph path and their
    worst errors."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof
    from paddle_tpu_torch.tools import profile_zoo as zoo

    _explicit_bn_grad()
    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    launches, errs = {}, {}
    for name, cfg in zoo.ZOO.items():
        t0 = time.perf_counter()
        model = zoo.build(name)
        staged = zoo.feeds(name, device)
        feeds = [staged[i % len(staged)] for i in range(2 + ZOO_STEPS)]
        batch = cfg["batch"]
        torch.cuda.reset_peak_memory_stats()
        fused.reset_stats()  # the main path's counting window opens here
        outs, walls, deltas, _, step, scope = _fluid_run(
            torch, model, feeds, "training_fused", [model["loss"]])
        counts = {k: v for k, v in fused.stats()["launches"].items() if v}  # and closes here
        reserved = torch.cuda.max_memory_reserved() / GIB
        _uniform_counts(name, deltas, {("launches", "gemm_epilogue"): ZOO_GEMM[name],
                                       ("dispatches", "gemm_epilogue"): ZOO_GEMM[name]})
        losses = [float(o[0]) for o in outs]
        F32_FIRST[name] = losses[:COMPARE_STEPS]
        window = walls[2:2 + ZOO_STEPS]
        graph = {"batch": batch, "step_p50_ms": float(np.median(window)),
                 "images_per_s": batch * len(window) / (sum(window) / 1e3),
                 "memory_max_reserved_gib": reserved}
        breakdown = prof.profile_steps(step, feeds[2:4], registry)
        graph.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                     device_busy_share=breakdown["device_busy_share"],
                     device_launches=breakdown["device_launches_per_step"],
                     profiled_wall_p50_ms=breakdown["wall_ms_p50"])
        del step, scope
        torch.cuda.empty_cache()
        rec = _PathInputs(ZOO_GEMM[name], n_adam=0)
        with rec:
            eager, e_walls, e_deltas, _, estep, escope = _fluid_run(
                torch, model, feeds[:COMPARE_STEPS], "training_fused", [model["loss"]],
                per_op=True)
        _same_bits("%s loss, graph against op by op, step" % name, [o[0] for o in eager],
                   [o[0] for o in outs[:COMPARE_STEPS]])
        if e_deltas != deltas[:COMPARE_STEPS]:
            raise AssertionError("%s: counters a step %s on the graph path, %s op by op"
                                 % (name, deltas[:COMPARE_STEPS], e_deltas))
        split = prof.op_device_split(estep, feeds[:2], registry, split_by=zoo.SPLIT)
        del estep, escope
        torch.cuda.empty_cache()
        shapes = [(int(x.shape[0]), int(x.shape[1]), int(w.shape[1])) for x, w, _, _ in rec.gemm]
        missing = [sh for sh in ZOO_GEMM_SHAPES.get(name, []) if sh not in shapes]
        if missing:
            raise AssertionError("%s: the GEMM epilogue never took %s (it took %s)"
                                 % (name, missing, shapes))
        timed = {}
        for x, w, b, act in rec.gemm:
            sh = (int(x.shape[0]), int(x.shape[1]), int(w.shape[1]))
            if sh in ZOO_GEMM_SHAPES.get(name, []) and sh not in timed:
                timed[sh] = _time_path_gemm(torch, x, w, b, act, flush)
        e, held = rec.hold(torch, name)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        errs["gemm_epilogue"] = max(errs.get("gemm_epilogue", 0.0), e["gemm_epilogue"])
        eager_reading = {"step_p50_ms": float(np.median(e_walls[1:])),
                         "device_ms_by_op_type": split["device_ms_per_step"],
                         "split": split["by_category"],
                         "top_ops": dict(list(split["by_op"].items())[:8])}
        readings["train_" + name] = {"graph": graph, "op_by_op": eager_reading}
        for sh, t in timed.items():
            log("train zoo %s: gemm_epilogue at the path's (%d, %d) @ (%d, %d) act %s: kernel "
                "%.4f ms (device, cold L2), plain %.4f ms, torch.addmm %.4f ms (product + bias, "
                "no act), kernel / addmm %.3f, bound %.4f ms (%s, 3xTF32 on the tensor cores), "
                "%d launches a step; card %s" % (
                    name, sh[0], sh[1], sh[1], sh[2], t["act"], t["ms"], t["plain_ms"],
                    t["library_ms"], t["ms"] / t["library_ms"], t["bound_ms"], t["bound_by"],
                    ZOO_GEMM[name], card))
        readings["train_" + name]["gemm_epilogue"] = {"%dx%dx%d" % sh: t
                                                      for sh, t in timed.items()}
        log("train zoo %s: %s, images 3 x 224 x 224, 1000 classes, Momentum(%g, %g), f32, batch "
            "%d, %d ops, training_fused, built and run in %.1f s; losses (warmup, capture, %d "
            "graph steps) %s; the same counters every step %s; the first %d losses bit for bit "
            "op by op with the same counters; GEMM epilogue at the path's inputs: %s; graph: "
            "step wall p50 %.3f ms, %.1f images/s over graph steps 3-%d, device busy %s ms a "
            "step = %s of the profiled wall p50 (%.3f ms), %s launches a step, max memory "
            "reserved %.3f GiB; op by op: step wall p50 %.3f ms, device %.3f ms a step, split "
            "%s, top ops %s; card %s" % (
                name, cfg["source"], cfg["lr"], cfg["momentum"], batch,
                len(model["main"].global_block().ops), time.perf_counter() - t0, ZOO_STEPS,
                ["%.6f" % v for v in losses], json.dumps({"%s:%s" % k: v for k, v in
                                                          deltas[0].items()}),
                COMPARE_STEPS, held, graph["step_p50_ms"], graph["images_per_s"],
                2 + ZOO_STEPS, graph["device_busy_ms"], graph["device_busy_share"],
                graph["profiled_wall_p50_ms"], graph["device_launches"], reserved,
                eager_reading["step_p50_ms"], split["device_ms_per_step"],
                json.dumps({k: round(v, 3) for k, v in split["by_category"].items()}),
                json.dumps({k: round(v, 3) for k, v in eager_reading["top_ops"].items()}),
                card))
        del model, staged, feeds, outs, rec
        torch.cuda.empty_cache()
    return launches, errs


def _uniform_counts(label, deltas, want):
    """Every step's counter deltas equal the first's, which hold `want`."""
    for i, d in enumerate(deltas):
        if d != deltas[0]:
            raise AssertionError("%s step %d: counters %s, step 0 %s" % (label, i, d, deltas[0]))
    for key, n in want.items():
        if deltas[0].get(key, 0) != n:
            raise AssertionError("%s: %s %d a step, want %d (counters %s)"
                                 % (label, key, deltas[0].get(key, 0), n, deltas[0]))


def _rnn_graph_reading(prof, step, walls, feeds, tokens, registry, torch):
    """The graph path's readings of a recurrent training run: tokens/s over
    graph steps 2-6 (walls[3:8]), the step wall p50 over the 6 graph steps
    and the profiled busy share."""
    window = walls[3:2 + RNN_STEPS]
    reading = {"step_p50_ms": float(np.median(walls[2:2 + RNN_STEPS])),
               "tokens_per_s": sum(tokens[3:2 + RNN_STEPS]) / (sum(window) / 1e3),
               "memory_max_reserved_gib": torch.cuda.max_memory_reserved() / GIB}
    breakdown = prof.profile_steps(step, feeds[2:4], registry)
    reading.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                   device_busy_share=breakdown["device_busy_share"],
                   device_launches=breakdown["device_launches_per_step"],
                   profiled_wall_p50_ms=breakdown["wall_ms_p50"])
    return reading


class _PathInputs:
    """While entered, keeps copies of what the first `n_gemm` gemm_bias_act
    calls, the first multi_tensor_adam call and the first `n_fp8`
    fp8_matmul calls are given (before the kernel runs: Adam updates in
    place), so that each kernel can be held against its plain version at
    the main path's own shapes and values. Recording launches nothing."""

    def __init__(self, n_gemm, n_fp8=0, n_adam=1):
        from paddle_tpu_torch.ops import gemm_epilogue as ge
        from paddle_tpu_torch.ops import multi_adam as ma
        from paddle_tpu_torch.ops import quant_gemm as qg

        self.ge, self.ma, self.qg = ge, ma, qg
        self.n_gemm, self.n_fp8, self.n_adam = n_gemm, n_fp8, n_adam
        self.gemm, self.adam, self.fp8 = [], [], []

    def __enter__(self):
        self.saved = gemm, adam = self.ge.gemm_bias_act, self.ma.multi_tensor_adam
        self.saved_fp8 = fp8 = self.qg.fp8_matmul

        def fp8_rec(x, y):
            if len(self.fp8) < self.n_fp8:
                self.fp8.append((x.detach().clone(), y.detach().clone()))
            return fp8(x, y)

        self.qg.fp8_matmul = fp8_rec

        def gemm_rec(x2, w2, bias_row, act=None):
            if len(self.gemm) < self.n_gemm:
                self.gemm.append((x2.clone(), w2.clone(), bias_row.clone(), act))
            return gemm(x2, w2, bias_row, act=act)

        def adam_rec(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon, **kw):
            if len(self.adam) < self.n_adam:
                lists = [[t.clone() for t in ts] for ts in (params, grads, m1s, m2s)]
                lr = lr_ts.clone() if hasattr(lr_ts, "clone") else list(lr_ts)
                self.adam.append(lists + [lr, beta1, beta2, epsilon])
            return adam(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon, **kw)

        self.ge.gemm_bias_act, self.ma.multi_tensor_adam = gemm_rec, adam_rec
        return self

    def __exit__(self, *exc):
        self.ge.gemm_bias_act, self.ma.multi_tensor_adam = self.saved
        self.qg.fp8_matmul = self.saved_fp8
        return False

    def hold(self, torch, label):
        """Each recorded call's kernel against its plain version on the
        same inputs: the GEMM epilogue within GEMM_TOL (bf16 operands: the
        JAX package's on-card bf16 bar, BF16_KERNEL_TOL), Adam bit for bit
        with f32 moments (within one bf16 ulp with bf16 ones), fp8_matmul as
        in check_fp8_matmul. Returns ({kernel: worst abs error}, a line that
        says what was held)."""
        ge, ma = self.ge, self.ma
        if (len(self.gemm) != self.n_gemm or len(self.adam) != self.n_adam
                or len(self.fp8) != self.n_fp8):
            raise AssertionError("%s: recorded %d GEMM epilogue calls of %d, %d Adam calls of %d "
                                 "and %d fp8_matmul calls of %d" % (
                                     label, len(self.gemm), self.n_gemm, len(self.adam),
                                     self.n_adam, len(self.fp8), self.n_fp8))
        errs, held = {"gemm_epilogue": 0.0, "multi_adam": 0.0}, []
        for x, w, b, act in self.gemm:
            name = "%s gemm_epilogue %s @ %s act %s %s" % (label, tuple(x.shape), tuple(w.shape),
                                                          act, x.dtype)
            tol = BF16_KERNEL_TOL if x.dtype == torch.bfloat16 else GEMM_TOL
            (z, y), (zp, yp) = ge.gemm_bias_act(x, w, b, act), ge.gemm_bias_act_plain(x, w, b, act)
            torch.cuda.synchronize()
            err = _close(torch, name, z, zp, tol, tol)
            if act:
                err = max(err, _close(torch, name, y, yp, tol, tol))
            errs["gemm_epilogue"] = max(errs["gemm_epilogue"], err)
            held.append("%s @ %s act %s %s (err %.3g)" % (tuple(x.shape), tuple(w.shape), act,
                                                          str(x.dtype)[6:], err))
        for x, y in self.fp8:
            err, rel = _fp8_held(torch, self.qg, x, y)
            errs["fp8_matmul"] = max(errs.get("fp8_matmul", 0.0), err)
            held.append("fp8_matmul %s @ %s %s (err / max |out| %.3g)" % (
                tuple(x.shape), tuple(y.shape), str(x.dtype)[6:], rel))
        if not self.adam:
            self.gemm, self.fp8 = [], []
            return errs, "; ".join(held)
        p, g, m1, m2, lr, b1, b2, eps = self.adam[0]
        plain = [[t.clone() for t in ts] for ts in (p, g, m1, m2)]
        ma.multi_tensor_adam(p, g, m1, m2, lr, b1, b2, eps)
        ma.multi_tensor_adam_plain(*plain, lr, b1, b2, eps)
        torch.cuda.synchronize()
        for slot, got_ts in ((0, p), (2, m1), (3, m2)):
            for got, want in zip(got_ts, plain[slot]):
                if got.dtype == torch.bfloat16:
                    err = _within_bf16_ulp(torch, label + " multi_adam", got, want)
                else:
                    err = float((got - want).abs().max()) if got.numel() else 0.0
                    if not torch.equal(got, want):
                        raise AssertionError("%s multi_adam: a tensor of %s differs from the "
                                             "plain version by %g" % (label, tuple(got.shape), err))
                errs["multi_adam"] = max(errs["multi_adam"], err)
        held.append("Adam over %d tensors, %d elements, params %s, grads %s, moments %s "
                    "(err %.3g)" % (len(p), sum(t.numel() for t in p), str(p[0].dtype)[6:],
                                    str(g[0].dtype)[6:], str(m1[0].dtype)[6:],
                                    errs["multi_adam"]))
        self.gemm, self.adam, self.fp8 = [], [], []
        return errs, "; ".join(held)


def _unfused(torch, model, feeds, outs, label):
    """The first COMPARE_STEPS steps with no pass pipeline (no kernel
    launched or dispatched) from the same seed: their losses within
    FUSED_RTOL / FUSED_ATOL of the fused path's. Returns them."""
    unfused, _, _, _, ustep, uscope = _fluid_run(
        torch, model, feeds[:COMPARE_STEPS], "", [model["loss"]],
        check=_exact_counts({}, "unfused " + label))
    ref = [float(o[0]) for o in unfused]
    a = np.asarray([float(o[0]) for o in outs[:COMPARE_STEPS]])
    if not np.allclose(a, ref, rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("%s fused vs unfused losses differ: %s vs %s (rtol %g atol %g)"
                             % (label, a.tolist(), ref, FUSED_RTOL, FUSED_ATOL))
    del ustep, uscope
    torch.cuda.empty_cache()
    return ref


def _rnn_op_by_op(torch, rnn, registry, model, feeds, outs, deltas, label):
    """The first COMPARE_STEPS steps op by op from the same seed: the same
    losses bit for bit and the same counters a step; the GEMM epilogue and
    Adam kernels held against their plain versions on what the first step
    gave them; then the same steps unfused. Returns the op-by-op reading
    with its device split, the kernels' worst errors and the unfused
    losses."""
    rec = _PathInputs(deltas[0].get(("launches", "gemm_epilogue"), 0))
    with rec:
        eager, e_walls, e_deltas, _, estep, escope = _fluid_run(
            torch, model, feeds[:COMPARE_STEPS], "training_fused", [model["loss"]], per_op=True)
    _same_bits("%s loss, graph against op by op, step" % label, [o[0] for o in eager],
               [o[0] for o in outs[:COMPARE_STEPS]])
    if e_deltas != deltas[:COMPARE_STEPS]:
        raise AssertionError("%s: counters a step %s on the graph path, %s op by op"
                             % (label, deltas[:COMPARE_STEPS], e_deltas))
    split = rnn.rnn_device_split(estep, feeds[:2], registry)
    del estep, escope
    torch.cuda.empty_cache()
    errs, held = rec.hold(torch, label)
    log("%s: kernels against their plain versions at the path's inputs: %s" % (label, held))
    ref = _unfused(torch, model, feeds, outs, label)
    return {"step_p50_ms": float(np.median(e_walls[1:])),
            "device_ms_per_step": split["device_ms_per_step"],
            "split": split["by_category"], "recurrent": split["recurrent"],
            "top_ops": dict(list(split["by_op"].items())[:8])}, errs, ref


def train_lstm(torch, card, readings):
    """The stacked LSTM at the JAX bench's shape (see the module docstring,
    phase 9). Returns the kernels' launches over the main path's steps and
    their worst errors against their plain versions at its inputs."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_rnn as rnn
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = rnn.LSTM
    t0 = time.perf_counter()
    model = rnn.build_lstm(cfg)
    full = rnn.lstm_feed(cfg, SEED)
    ragged = rnn.lstm_feed(cfg, SEED + 1, ragged=True)
    feeds = [full] * (2 + RNN_STEPS) + [ragged] * LSTM_RAGGED_STEPS
    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # the main path's counting window opens here
    t1 = time.perf_counter()
    outs, walls, deltas, _, step, scope = _fluid_run(
        torch, model, feeds, "training_fused", [model["loss"]])
    launches = fused.stats()["launches"]  # and closes here
    _uniform_counts("lstm", deltas, {("launches", "multi_adam"): 1})
    losses = [float(o[0]) for o in outs]
    F32_FIRST["lstm"] = losses[:COMPARE_STEPS]
    tokens = [int(f["words@LEN"].sum()) for f in feeds]
    t2 = time.perf_counter()
    graph = _rnn_graph_reading(prof, step, walls, feeds, tokens, registry, torch)
    graph["ragged_step_p50_ms"] = float(np.median(walls[2 + RNN_STEPS:]))
    del step, scope
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    eager, errs, ref = _rnn_op_by_op(torch, rnn, registry, model, feeds, outs, deltas, "lstm")
    log("train lstm: the graph run took %.1f s (the warmup %.3f s, the capture %.3f s), its "
        "profile %.1f s, the op-by-op run, its split, the kernel checks and the unfused run "
        "%.1f s" % (
            t2 - t1, walls[0] / 1e3, walls[1] / 1e3, t3 - t2, time.perf_counter() - t3))
    readings["train_lstm"] = {"graph": graph, "op_by_op": eager}
    log("train lstm: stacked dynamic LSTM %s, f32, training_fused, built and run in %.1f s; "
        "losses (warmup, capture, %d full-length graph steps, %d ragged) %s; the same counters "
        "every step %s; the first %d losses bit for bit op by op with the same counters; "
        "unfused %s (rtol %g atol %g); graph: "
        "step wall p50 %.3f ms (ragged %.3f ms), %.1f tokens/s over graph steps 2-6, device "
        "busy %s ms a step = %s of the profiled wall p50 (%.3f ms), %s launches a step, max "
        "memory reserved %.3f GiB; op by op: step wall p50 %.3f ms, device %.3f ms a step, "
        "split %s, recurrent %s; card %s" % (
            json.dumps(cfg), time.perf_counter() - t0, RNN_STEPS, LSTM_RAGGED_STEPS,
            ["%.6f" % v for v in losses], json.dumps({"%s:%s" % k: v for k, v in
                                                      deltas[0].items()}),
            COMPARE_STEPS, ["%.6f" % v for v in ref], FUSED_RTOL, FUSED_ATOL,
            graph["step_p50_ms"], graph["ragged_step_p50_ms"],
            graph["tokens_per_s"], graph["device_busy_ms"], graph["device_busy_share"],
            graph["profiled_wall_p50_ms"], graph["device_launches"],
            graph["memory_max_reserved_gib"], eager["step_p50_ms"], eager["device_ms_per_step"],
            json.dumps({k: round(v, 3) for k, v in eager["split"].items()}),
            json.dumps({k: round(v, 4) for k, v in eager["recurrent"].items()}), card))
    return {k: v for k, v in launches.items() if v}, errs


class _CountOps:
    """Counts every op lowered while entered, sub-block ops included (each
    loop iteration's)."""

    def __init__(self, registry):
        self.registry = registry
        self.n = 0

    def __enter__(self):
        self.saved = self.registry._lower_one

        def lower_one(ctx, op, env):
            self.n += 1
            return self.saved(ctx, op, env)

        self.registry._lower_one = lower_one
        return self

    def __exit__(self, *exc):
        self.registry._lower_one = self.saved
        return False


def _beam_decode(torch, rnn, cfg, scope, batch):
    """One beam decode of `batch` over the scope's trained weights with no
    pass pipeline (its open-ended While runs op by op): (ids, scores,
    lengths, wall ms, ops run, the op-by-op runs it added by reason)."""
    from paddle_tpu_torch import CUDAPlace, Executor, flags, scope_guard
    from paddle_tpu_torch.ops import registry

    infer = rnn.build_nmt_infer(cfg)
    flags.set_flags({"pass_pipeline": ""})
    exe = Executor(CUDAPlace(0))
    before = dict(Executor.stats()["op_by_op"])
    with scope_guard(scope), _CountOps(registry) as count:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, scores, lens = exe.run(
            infer["main"], feed={"src": batch["src"], "src_len": batch["src_len"]},
            fetch_list=[infer["ids"].name, infer["scores"].name, infer["hyp_len"].name])
        wall = (time.perf_counter() - t0) * 1e3
    after = Executor.stats()["op_by_op"]
    added = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    if added != {"open_ended_while": 1}:
        raise AssertionError("beam decode: op-by-op runs added %s, want one open_ended_while"
                             % added)
    b, beam = cfg["batch"], cfg["beam_size"]
    if ids.shape[:2] != (b, beam) or not np.isfinite(scores).all():
        raise AssertionError("beam decode: ids %s, scores finite %s"
                             % (ids.shape, np.isfinite(scores).all()))
    if lens.min() < 1 or lens.max() > cfg["max_out_len"]:
        raise AssertionError("beam decode: hypothesis lengths %d-%d, want 1-%d"
                             % (lens.min(), lens.max(), cfg["max_out_len"]))
    return ids, scores, lens, wall, count.n, added


def train_nmt(torch, card, readings):
    """The GRU attention NMT model (see the module docstring, phase 10).
    Returns the kernels' launches over the full-width main path's steps and
    their worst errors against their plain versions at its inputs."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_rnn as rnn
    from paddle_tpu_torch.tools import profile_training as prof

    # (a) the copy task and its gates
    cfg = rnn.COPY
    t0 = time.perf_counter()
    model = rnn.build_nmt_train(cfg)
    batch = rnn.nmt_batch(cfg, np.random.RandomState(7))
    outs, walls, _, _, step, scope = _fluid_run(
        torch, model, [batch] * cfg["steps"], "training_fused", [model["loss"]])
    losses = [float(o[0]) for o in outs]
    if not losses[-1] < 0.3 * losses[0]:
        raise AssertionError("nmt copy task: loss %.4f -> %.4f, want under 0.3x"
                             % (losses[0], losses[-1]))
    ids, scores, lens, _, _, _ = _beam_decode(torch, rnn, cfg, scope, batch)
    n_copied = rnn.copied(batch["src"], batch["src_len"], ids, lens)
    if n_copied < cfg["batch"] // 2:
        raise AssertionError("nmt copy task: %d of %d sources copied" % (n_copied, cfg["batch"]))
    log("train nmt (copy task): vocab %d, %d words, batch %d, Adam(%g), %d graph steps in "
        "%.1f s: loss %.4f -> %.4f (< 0.3x), step wall p50 %.3f ms; beam %d decode of the "
        "trained batch: %d of %d sources copied exactly; card %s" % (
            cfg["dict_size"], cfg["seq_len"], cfg["batch"], cfg["lr"], cfg["steps"],
            time.perf_counter() - t0, losses[0], losses[-1], float(np.median(walls[2:])),
            cfg["beam_size"], n_copied, cfg["batch"], card))
    del step, scope
    torch.cuda.empty_cache()

    # (b) full width
    cfg = rnn.NMT
    t0 = time.perf_counter()
    model = rnn.build_nmt_train(cfg)
    rng = np.random.RandomState(SEED)
    feeds = [rnn.nmt_batch(cfg, rng) for _ in range(2 + RNN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # the main path's counting window opens here
    outs, walls, deltas, _, step, scope = _fluid_run(
        torch, model, feeds, "training_fused", [model["loss"]])
    launches = fused.stats()["launches"]  # and closes here
    _uniform_counts("nmt", deltas, {("launches", "multi_adam"): 1})
    losses = [float(o[0]) for o in outs]
    tokens = [int(f["trg_len"].sum()) for f in feeds]
    graph = _rnn_graph_reading(prof, step, walls, feeds, tokens, registry, torch)
    ids, scores, lens, wall, n_ops, added = _beam_decode(torch, rnn, cfg, scope, feeds[0])
    decode = {"wall_ms": wall, "ops_run": n_ops, "op_by_op": added,
              "beam_size": cfg["beam_size"], "max_out_len": cfg["max_out_len"],
              "hypothesis_len_min": int(lens.min()), "hypothesis_len_max": int(lens.max())}
    del step, scope
    torch.cuda.empty_cache()
    eager, errs, ref = _rnn_op_by_op(torch, rnn, registry, model, feeds, outs, deltas, "nmt")
    readings["train_nmt"] = {"graph": graph, "op_by_op": eager}
    readings["nmt_decode"] = {"op_by_op": decode}
    log("train nmt: emb = hid = %d, dict %d, %d words, batch %d, Adam(%g), f32, "
        "training_fused, built and run in %.1f s; losses (warmup, capture, %d graph steps) %s; "
        "the same counters every step %s; the first %d losses bit for bit op by op with the "
        "same counters; unfused %s (rtol %g atol %g); graph: step wall p50 %.3f ms, %.1f target "
        "tokens/s over graph steps "
        "2-6, device busy %s ms a step = %s of the profiled wall p50 (%.3f ms), %s launches a "
        "step, max memory reserved %.3f GiB; op by op: step wall p50 %.3f ms, device %.3f ms a "
        "step, split %s, recurrent %s; card %s" % (
            cfg["emb_dim"], cfg["dict_size"], cfg["seq_len"], cfg["batch"], cfg["lr"],
            time.perf_counter() - t0, RNN_STEPS, ["%.6f" % v for v in losses],
            json.dumps({"%s:%s" % k: v for k, v in deltas[0].items()}), COMPARE_STEPS,
            ["%.6f" % v for v in ref], FUSED_RTOL, FUSED_ATOL, graph["step_p50_ms"],
            graph["tokens_per_s"], graph["device_busy_ms"],
            graph["device_busy_share"], graph["profiled_wall_p50_ms"], graph["device_launches"],
            graph["memory_max_reserved_gib"], eager["step_p50_ms"], eager["device_ms_per_step"],
            json.dumps({k: round(v, 3) for k, v in eager["split"].items()}),
            json.dumps({k: round(v, 4) for k, v in eager["recurrent"].items()}), card))
    log("nmt decode: beam %d, max_out_len %d, batch %d: ran op by op for %s in %.3f ms, %d ops "
        "lowered (the While's body every step); scores finite, hypothesis lengths %d-%d; card %s"
        % (cfg["beam_size"], cfg["max_out_len"], cfg["batch"], json.dumps(added), wall, n_ops,
           decode["hypothesis_len_min"], decode["hypothesis_len_max"], card))
    return {k: v for k, v in launches.items() if v}, errs


# (name, layer kwargs, closed form of the step counter's value k); the
# counter starts at 0 (noam: at 1) and a run raises it first
# ---------------------------------------------------------------- phase 12

DEEPFM_STEPS = 6  # graph steps of each DeepFM run, after the warmup and the capture
DEEPFM_EAGER_STEPS = 2  # and op by op
# a DeepFM step: its three fc chains (512 -> 32 relu, 32 -> 16 relu,
# 16 -> 1) take the GEMM epilogue, its dense Adam one multi_adam launch
DEEPFM_PER_STEP = {"gemm_epilogue": 3, "multi_adam": 1}


def _deepfm_run(torch, recsys, prof, registry, cfg, is_sparse, batches, card, readings):
    """One DeepFM configuration on the graph path (the warmup, the capture,
    DEEPFM_STEPS replays), then DEEPFM_EAGER_STEPS op by op from the same
    seed: the losses bit for bit, the same launches and dispatches a step,
    and the GEMM epilogue and Adam kernels held against their plain
    versions at the path's inputs. Returns (the main path's launches, the
    kernels' worst errors, the graph reading)."""
    from paddle_tpu_torch import Executor
    from paddle_tpu_torch.ops import fused

    label = "deepfm " + ("sparse" if is_sparse else "dense")
    model = recsys.build_deepfm(cfg, is_sparse)
    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # the main path's counting window opens here
    outs, walls, deltas, _, step, scope = _fluid_run(
        torch, model, batches, "training_fused", [model["loss"]],
        check=_exact_counts(DEEPFM_PER_STEP, label))
    launches = fused.stats()["launches"]  # and closes here
    reserved = torch.cuda.max_memory_reserved() / GIB
    runs = dict(Executor.stats()["op_by_op"])
    if runs != {"creates_persistables": 1}:
        raise AssertionError("%s: blocks run op by op %s (only the startup program may)"
                             % (label, runs))
    losses = [float(o[0]) for o in outs]
    replayed = sum(walls[2:]) / 1e3
    rows = recsys.embedding_rows_per_step(cfg)
    graph = {"step_p50_ms": float(np.median(walls[2:])),
             "examples_per_s": cfg["batch"] * DEEPFM_STEPS / replayed,
             "embedding_rows_per_s": rows * DEEPFM_STEPS / replayed,
             "memory_max_reserved_gib": reserved}
    breakdown = prof.profile_steps(step, batches[2:4], registry)
    graph.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                 device_busy_share=breakdown["device_busy_share"],
                 device_launches=breakdown["device_launches_per_step"],
                 profiled_wall_p50_ms=breakdown["wall_ms_p50"])
    top = [(k[:50], round(v["ms"], 4)) for k, v in
           list(breakdown["device_ms_per_step_by_kernel"].items())[:6]]
    del step, scope
    torch.cuda.empty_cache()
    rec = _PathInputs(DEEPFM_PER_STEP["gemm_epilogue"])
    with rec:
        eager, e_walls, e_deltas, _, estep, escope = _fluid_run(
            torch, model, batches[:DEEPFM_EAGER_STEPS], "training_fused", [model["loss"]],
            per_op=True)
    _same_bits("%s loss, graph against op by op, step" % label, [o[0] for o in eager],
               [o[0] for o in outs[:DEEPFM_EAGER_STEPS]])
    if e_deltas != deltas[:DEEPFM_EAGER_STEPS]:
        raise AssertionError("%s: counters a step %s on the graph path, %s op by op"
                             % (label, deltas[:DEEPFM_EAGER_STEPS], e_deltas))
    del estep, escope
    torch.cuda.empty_cache()
    errs, held = rec.hold(torch, label)
    readings["train_" + label.replace(" ", "_")] = {
        "graph": graph, "op_by_op": {"step_p50_ms": float(np.median(e_walls[1:]))}}
    log("train %s: DeepFM %s, Adam(%g) with %s moments, training_fused; losses %s; every step "
        "%s launches and dispatches; the first %d losses bit for bit op by op with the same "
        "counters; kernels at the path's inputs: %s; graph: step wall p50 %.4f ms, %.1f "
        "examples/s, %.1f embedding rows/s (%d a step) over the %d graph steps, device busy %s "
        "ms a step = %s of the profiled wall p50 (%.4f ms), %s launches a step, top kernels %s, "
        "max memory reserved %.3f GiB; op by op %.3f ms a step; card %s" % (
            label, json.dumps(cfg), cfg["lr"], cfg["moment_dtype"], ["%.6f" % v for v in losses],
            json.dumps(DEEPFM_PER_STEP), DEEPFM_EAGER_STEPS, held, graph["step_p50_ms"],
            graph["examples_per_s"], graph["embedding_rows_per_s"], rows, DEEPFM_STEPS,
            graph["device_busy_ms"], graph["device_busy_share"], graph["profiled_wall_p50_ms"],
            graph["device_launches"], json.dumps(top), reserved,
            readings["train_" + label.replace(" ", "_")]["op_by_op"]["step_p50_ms"], card))
    return {k: launches[k] for k in DEEPFM_PER_STEP}, errs, graph


def train_deepfm(torch, card, readings):
    """DeepFM at the JAX bench's recsys widths (profile_recsys.RECSYS: 2^20 x
    32 table, 16 fields, batch 512, layer_sizes (32, 16), Adam 1e-3 with
    bf16 moments), dense and is_sparse=True (SelectedRows grads, lazy Adam),
    each on CUDA graphs and op by op; the sparse:dense step ratio; then
    sparse against dense SGD bit for bit at the parity leg's shape, and the
    convergence gates of tests/test_deepfm.py. Returns the kernels' launches
    over the two main paths' steps and their worst errors."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.tools import profile_recsys as recsys
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = recsys.RECSYS
    batches = recsys.recsys_batches(np.random.RandomState(SEED), cfg["rows"], cfg["fields"],
                                    cfg["batch"], 2 + DEEPFM_STEPS)
    launches, errs, graphs = {}, {}, {}
    for is_sparse in (False, True):
        got, e, graphs[is_sparse] = _deepfm_run(torch, recsys, prof, registry, cfg, is_sparse,
                                                batches, card, readings)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        torch.cuda.empty_cache()
    ratio = graphs[True]["step_p50_ms"] / graphs[False]["step_p50_ms"]

    # the parity leg: sparse against dense SGD, the same bits
    pc = recsys.PARITY
    pb = recsys.recsys_batches(np.random.RandomState(pc["seed"]), pc["rows"], pc["fields"],
                               pc["batch"], pc["steps"])
    par = {}
    for is_sparse in (False, True):
        model = recsys.build_deepfm(pc, is_sparse)
        outs, _, _, _, step, scope = _fluid_run(torch, model, pb, "training_fused",
                                                [model["loss"]])
        par[is_sparse] = ([o[0] for o in outs],
                          {n: scope.vars[n].cpu().numpy() for n in ("fm_emb", "fm_first")})
        del step, scope
    _same_bits("deepfm parity, sparse against dense SGD loss, step", par[True][0], par[False][0])
    for n in par[False][1]:
        if par[True][1][n].tobytes() != par[False][1][n].tobytes():
            raise AssertionError("deepfm parity: %s differs between sparse and dense SGD" % n)

    # convergence (tests/test_deepfm.py:29-66), sparse
    cc = recsys.CONVERGE
    rng = np.random.RandomState(cc["seed"])
    feeds = [recsys.converge_batch(rng, cc) for _ in range(cc["steps"])]
    eval_feed = recsys.converge_batch(rng, cc, cc["eval_batch"])
    model = recsys.build_deepfm(cc, is_sparse=True)
    outs, _, _, _, step, scope = _fluid_run(torch, model, feeds + [eval_feed], "training_fused",
                                            [model["loss"], model["pred"]])
    closs = [float(o[0]) for o in outs[:cc["steps"]]]
    first5, last5 = float(np.mean(closs[:5])), float(np.mean(closs[-5:]))
    auc = recsys.auc(outs[-1][1], eval_feed["label"])
    del step, scope
    torch.cuda.empty_cache()
    if not (last5 < 0.9 * first5 and auc > 0.65):
        raise AssertionError("deepfm did not learn: loss %.4f -> %.4f, AUC %.3f"
                             % (first5, last5, auc))
    log("train deepfm: sparse:dense step wall p50 %.4f (%.4f / %.4f ms); parity leg %s: sparse "
        "and dense SGD losses %s and both tables bit for bit over %d steps; convergence %s "
        "(sparse, %d graph steps): loss %.4f -> %.4f (first and last 5, gate 0.9x), AUC of a "
        "fresh batch of %d %.3f (gate 0.65); card %s" % (
            ratio, graphs[True]["step_p50_ms"], graphs[False]["step_p50_ms"], json.dumps(pc),
            ["%.6f" % v for v in par[True][0]], pc["steps"], json.dumps(cc), cc["steps"], first5,
            last5, cc["eval_batch"], auc, card))
    readings["train_deepfm_sparse"]["graph"]["sparse_to_dense_step_ratio"] = ratio
    for k, v in _deepfm_async(torch, card, readings).items():
        launches[k] = launches.get(k, 0) + v
    return launches, errs


ASYNC_BATCHES = 16  # DeepFM batches written as MultiSlot text, two files
ASYNC_PERIOD = 4  # AsyncExecutor's print_period: the loss means compared


def _multislot_files(tmp, cfg, n):
    """`n` RECSYS batches (profile_recsys.recsys_batches from SEED) as
    MultiSlot text in two files: a line is "16 <16 ids> 1 <label>"."""
    from paddle_tpu_torch.tools import profile_recsys as recsys

    batches = recsys.recsys_batches(np.random.RandomState(SEED + 7), cfg["rows"], cfg["fields"],
                                    cfg["batch"], n)
    files = [os.path.join(tmp, "part-%d.txt" % i) for i in range(2)]
    per = n // len(files)
    for i, path in enumerate(files):
        with open(path, "w") as f:
            for b in batches[i * per:(i + 1) * per]:
                ids = b["ids"].reshape(cfg["batch"], cfg["fields"])
                for row, lab in zip(ids, b["label"].reshape(-1)):
                    f.write("%d %s 1 %d\n" % (cfg["fields"], " ".join(map(str, row)), lab))
    return files


def _deepfm_async(torch, card, readings):
    """DeepFM at RECSYS's widths (dense Adam) fed from MultiSlot text files
    by the native runtime (libptnative's C++ parser):

    - AsyncExecutor(CUDAPlace(0)) with thread_num=1 over ASYNC_BATCHES
      batches in two files: its loss means of every ASYNC_PERIOD steps bit
      for bit those of an Executor fed the same assembled batches
      (async_executor.stream_batches) as dicts, from the same weights. The
      assembly gives ids as (batch, 16) int64 (a sparse slot, its 16 ids a
      line), which DeepFM's program takes as it is: it reshapes its ids to
      one column first;
    - contrib.reader.ctr_reader over the same files, Executor.run with no
      feed until EOFException: its losses bit for bit the dict-fed run's.

    Returns the kernel launches of the three runs."""
    import tempfile

    from paddle_tpu_torch import (AsyncExecutor, CUDAPlace, DataFeedDesc, EOFException,
                                  Executor, Scope, flags, framework, scope_guard)
    from paddle_tpu_torch.async_executor import stream_batches
    from paddle_tpu_torch.contrib.reader.ctr_reader import ctr_reader
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_recsys as recsys

    cfg = recsys.RECSYS
    proto = ('name: "MultiSlotDataFeed"\nbatch_size: %d\nmulti_slot_desc {\n'
             '  slots {\n    name: "ids"\n    type: "uint64"\n    is_dense: false\n'
             '    is_used: true\n  }\n  slots {\n    name: "label"\n    type: "float"\n'
             '    is_dense: true\n    is_used: true\n  }\n}\n' % cfg["batch"])
    flags.set_flags({"pass_pipeline": "training_fused"})
    place = CUDAPlace(0)
    launches = {}

    def count(before):
        for k, v in _launch_delta(before, fused.stats()).items():
            launches[k] = launches.get(k, 0) + v

    def fresh(model):
        scope = Scope(seed=SEED, place=place)
        with scope_guard(scope):
            Executor(place).run(model["startup"])
        return scope

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = _multislot_files(tmp, cfg, ASYNC_BATCHES)
        write_s = time.perf_counter() - t0
        desc = DataFeedDesc(proto)
        # the Executor fed the assembled batches as dicts
        assembled = list(stream_batches(desc, files, thread_num=1))
        if len(assembled) != ASYNC_BATCHES or assembled[0]["ids"].shape != (cfg["batch"],
                                                                           cfg["fields"]):
            raise AssertionError("assembled %d batches, ids %s" % (
                len(assembled), assembled[0]["ids"].shape))
        model = recsys.build_deepfm(cfg, is_sparse=False)
        scope, exe = fresh(model), Executor(place)
        before = fused.stats()
        dict_losses = [float(exe.run(model["main"], feed=b, fetch_list=[model["loss"].name],
                                     scope=scope)[0].reshape(-1)[0]) for b in assembled]
        count(before)
        del scope, exe
        want = [float(np.mean(np.asarray([[v] for v in dict_losses[i:i + ASYNC_PERIOD]]),
                              axis=0)[0]) for i in range(0, ASYNC_BATCHES, ASYNC_PERIOD)]
        # AsyncExecutor: the native parser, the staging PyReader, the graphs
        model = recsys.build_deepfm(cfg, is_sparse=False)
        scope = fresh(model)
        captures0 = Executor.stats()["graphs"].get("captures", 0)
        before = fused.stats()
        t0 = time.perf_counter()
        with scope_guard(scope):
            means = AsyncExecutor(place).run(model["main"], desc, files, thread_num=1,
                                             fetch=[model["loss"]], print_period=ASYNC_PERIOD)
        async_s = time.perf_counter() - t0
        count(before)
        captures = Executor.stats()["graphs"].get("captures", 0) - captures0
        del scope
        _same_bits("AsyncExecutor's loss means against the dict-fed Executor's, period",
                   means, want)
        # contrib.reader.ctr_reader, feed=None until EOF
        model = recsys.build_deepfm(cfg, is_sparse=False)
        with framework.program_guard(model["main"], model["startup"]):
            reader = ctr_reader(capacity=8, thread_num=1, batch_size=cfg["batch"],
                                file_list=files, slots=desc)
        scope, exe = fresh(model), Executor(place)
        before = fused.stats()
        ctr_losses = []
        with scope_guard(scope):
            reader.start()
            with _raises(EOFException, "ctr_reader past its files"):
                while True:
                    ctr_losses.append(float(exe.run(model["main"], fetch_list=[
                        model["loss"].name], scope=scope)[0].reshape(-1)[0]))
            reader.reset()
        count(before)
        del scope, exe
    _same_bits("ctr_reader's losses against the dict-fed Executor's, step", ctr_losses,
               dict_losses)
    readings["train_deepfm_async"] = {"graph": {
        "async_executor_s": async_s, "captures": captures, "steps": ASYNC_BATCHES}}
    log("train deepfm, native feed: %d RECSYS batches (%d x %d ids, labels) written as MultiSlot "
        "text in 2 files in %.2f s; AsyncExecutor(CUDAPlace(0), thread_num=1) ran them in %.3f "
        "s (the native parser, the staging PyReader, %d graph captured: one feed shape, ids "
        "(%d, %d) in their bucket), its loss means %s bit for bit the dict-fed Executor's; "
        "ctr_reader fed the program %d steps to EOFException, losses bit for bit the dict-fed "
        "run's; launches %s; card %s" % (
            ASYNC_BATCHES, cfg["batch"], cfg["fields"], write_s, async_s, captures,
            cfg["batch"], cfg["fields"], ["%.6f" % v for v in means], len(ctr_losses),
            json.dumps(launches), card))
    return launches


# ---------------------------------------------------------------- phase 13

BF16_RTOL, BF16_ATOL = 5e-2, 2e-2  # bf16 against f32 (tests/test_transpiler.py:515)
FP8_STEPS = 3  # graph steps of the Transformer under FLAGS_fp8_matmul
FP8_LOSS_RTOL = 0.1  # fp8 against bf16 losses, relative
# the fp8 Transformer step before fp8_gemm.cu (quant_gemm.cu's cast pass and
# e4m3 GEMM, f32 library products and plain rounding in the grads): the
# replayed step's wall and the op-by-op device ms a step split as
# profile_training.fp8_step_split splits it
FP8_BEFORE = {
    "origin": "NVIDIA H100 80GB HBM3, 700.00 W: the parent tree's step through "
              "tools/profile_training.py --model transformer_fp8 --per-op, graph wall p50 of 4",
    "step_ms": 97.935,
    "split": {"other ops": 37.846, "forward: fp8 kernel": 3.494, "forward: other": 0.724,
              "grad: replayed forward": 4.269, "grad: rounding and other": 27.418,
              "grad: products": 21.31, "device_ms": 95.059}}


def _bf16_state_f32(torch, label, model, scope):
    """Every floating persistable of the transpiled program (parameters,
    moments, batch_norm statistics, learning rate) is still f32 in the
    scope: the masters. Returns how many."""
    from paddle_tpu_torch import convert

    names = convert.persistable_names(model["main"])
    bad = {n: str(scope.vars[n].dtype) for n in names
           if torch.is_floating_point(scope.vars[n]) and scope.vars[n].dtype != torch.float32}
    if bad:
        raise AssertionError("%s: masters or moments not f32 after bf16 steps: %s" % (label, bad))
    return sum(torch.is_floating_point(scope.vars[n]) for n in names)


def _bf16_run(torch, label, model, feeds, n_eager, ref, ref_rtol, card, n_fp8=0,
              fp8_split=False):
    """The transpiled `model` on the graph path over `feeds`, its first 3
    losses against `ref` (rtol ref_rtol, atol BF16_ATOL), the masters f32;
    with fp8_split, two more steps op by op split by op type and the fp8
    products' kernels (profile_training.fp8_step_split); then n_eager steps
    op by op from the same seed: the losses bit for bit and the same
    counters a step, the kernels held at the path's inputs. Returns
    (losses, walls, the main path's launches, per-step counters, profiled
    breakdown, kernel errors, held line, op-by-op walls, max reserved GiB,
    masters, the split)."""
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof

    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # the main path's counting window opens here
    outs, walls, deltas, _, step, scope = _fluid_run(
        torch, model, feeds, "training_fused", [model["loss"]])
    launches = {k: v for k, v in fused.stats()["launches"].items() if v}  # and closes here
    reserved = torch.cuda.max_memory_reserved() / GIB
    _uniform_counts(label, deltas, {})
    masters = _bf16_state_f32(torch, label, model, scope)
    losses = [float(o[0]) for o in outs]
    a, b = np.asarray(losses[:COMPARE_STEPS]), np.asarray(ref[:COMPARE_STEPS])
    if not np.allclose(a, b, rtol=ref_rtol, atol=BF16_ATOL):
        raise AssertionError("%s: losses %s against %s (rtol %g atol %g)"
                             % (label, a.tolist(), b.tolist(), ref_rtol, BF16_ATOL))
    breakdown = prof.profile_steps(step, feeds[2:4], registry) if len(feeds) >= 4 else None
    split = None
    if fp8_split:
        by_op = prof.op_device_split(step, feeds[:2], registry)
        split = dict(prof.fp8_step_split(by_op), device_ms=by_op["device_ms_per_step"])
    del step, scope
    torch.cuda.empty_cache()
    rec = _PathInputs(deltas[0].get(("launches", "gemm_epilogue"), 0), n_fp8=n_fp8,
                      n_adam=deltas[0].get(("launches", "multi_adam"), 0))
    with rec:
        eager, e_walls, e_deltas, _, estep, escope = _fluid_run(
            torch, model, feeds[:n_eager], "training_fused", [model["loss"]], per_op=True)
    _same_bits("%s loss, graph against op by op, step" % label, [o[0] for o in eager],
               [o[0] for o in outs[:n_eager]])
    if e_deltas != deltas[:n_eager]:
        raise AssertionError("%s: counters a step %s on the graph path, %s op by op"
                             % (label, deltas[:n_eager], e_deltas))
    del estep, escope
    torch.cuda.empty_cache()
    errs, held = rec.hold(torch, label)
    return dict(losses=losses, walls=walls, launches=launches, deltas=deltas[0],
                breakdown=breakdown, errs=errs, held=held, e_walls=e_walls,
                reserved=reserved, masters=masters, split=split)


def _bf16_line(label, r, rate, unit, f32, card):
    b = r["breakdown"]
    log("train bf16 %s: Bf16Transpiler after the startup program, training_fused, %d graph steps "
        "(the warmup and the capture among them), losses %s, within rtol %g atol %g of the f32 "
        "phase's first %d from the same weights and batches; %d masters and moments f32 after "
        "the steps; the first %d losses bit for bit op by op with the same counters a step %s; "
        "kernels at the path's inputs: %s; graph: step wall p50 %.3f ms, %.1f %s over the "
        "replayed steps (f32: %s), device busy %s ms a step = %s of the profiled wall p50 (%s "
        "ms), %s launches a step, max memory reserved %.3f GiB (f32: %s GiB); op by op %.3f ms a "
        "step; cuDNN and the library products run bf16 (allow_tf32 off touches only f32); card "
        "%s" % (
            label, len(r["losses"]), ["%.6f" % v for v in r["losses"]], BF16_RTOL, BF16_ATOL,
            COMPARE_STEPS, r["masters"], len(r["e_walls"]),
            json.dumps({"%s:%s" % k: v for k, v in r["deltas"].items()}), r["held"],
            float(np.median(r["walls"][2:])), rate, unit, f32.get("rate"),
            b and b["device_busy_ms_per_step"], b and b["device_busy_share"],
            b and b["wall_ms_p50"], b and b["device_launches_per_step"], r["reserved"],
            f32.get("memory"), float(np.median(r["e_walls"][1:])), card))


def _bf16_vgg19(torch, card, readings):
    """VGG-19 as the JAX bench runs it (bench.py:229-260: Bf16Transpiler
    after the startup program), 3 steps on the f32 zoo phase's batches,
    held against its first losses. Returns _bf16_run's result."""
    from paddle_tpu_torch.tools import profile_recsys as recsys
    from paddle_tpu_torch.tools import profile_zoo as zoo

    model = zoo.build("vgg19")
    recsys.bf16_transpiled(model["main"])
    staged = zoo.feeds("vgg19", torch.device("cuda", 0))
    feeds = [staged[i % len(staged)] for i in range(COMPARE_STEPS)]
    r = _bf16_run(torch, "vgg19", model, feeds, COMPARE_STEPS, F32_FIRST["vgg19"], BF16_RTOL,
                  card)
    batch = zoo.ZOO["vgg19"]["batch"]
    rate = batch * (len(r["walls"]) - 2) / (sum(r["walls"][2:]) / 1e3)
    f32 = readings["train_vgg19"]["graph"]
    readings["train_bf16_vgg19"] = {"graph": {
        "step_p50_ms": float(np.median(r["walls"][2:])), "images_per_s": rate,
        "memory_max_reserved_gib": r["reserved"]}}
    _bf16_line("vgg19", r, rate, "images/s",
               {"rate": "%.1f images/s" % f32["images_per_s"],
                "memory": "%.3f" % f32["memory_max_reserved_gib"]}, card)
    return r


def train_bf16(torch, card, readings):
    """The JAX bench's own precision: ResNet-50 at batch 256 under
    Momentum(0.1, 0.9), VGG-19 at batch 64 under Momentum(0.01, 0.9) (3
    steps, bench.py:229-260), the stacked LSTM at bench.py:265-297 (Adam
    2e-3) and Transformer base, each built as its f32 phase built it, rewritten by
    Bf16Transpiler after its startup program (f32 masters, bf16 activations
    and gradients) and trained on CUDA graphs from the same seed and
    batches; then 3 Transformer steps with FLAGS_fp8_matmul (fp8_gemm.cu's
    forward, dx and dy forms), their losses within FP8_LOSS_RTOL of the
    bf16 steps', and their op-by-op device split. Returns the kernels'
    launches over the main paths' steps and their worst errors."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_recsys as recsys
    from paddle_tpu_torch.tools import profile_rnn as rnn
    from paddle_tpu_torch.tools import profile_training as prof

    launches, errs = {}, {}

    def add(r):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in r["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)

    # ResNet-50
    model = prof.build_resnet50()
    recsys.bf16_transpiled(model["main"])
    staged = prof.resnet50_feeds(torch.device("cuda", 0))
    feeds = [staged[i % len(staged)] for i in range(2 + RESNET_STEPS)]
    r = _bf16_run(torch, "resnet50", model, feeds, COMPARE_STEPS, F32_FIRST["resnet50"],
                  BF16_RTOL, card)
    batch = prof.RESNET50["batch"]
    rate = batch * RESNET_STEPS / (sum(r["walls"][2:]) / 1e3)
    f32 = readings["train_resnet50"]["graph"]
    readings["train_bf16_resnet50"] = {"graph": {
        "step_p50_ms": float(np.median(r["walls"][2:])), "images_per_s": rate,
        "device_busy_ms": r["breakdown"]["device_busy_ms_per_step"],
        "device_busy_share": r["breakdown"]["device_busy_share"],
        "memory_max_reserved_gib": r["reserved"]}}
    _bf16_line("resnet50", r, rate, "images/s",
               {"rate": "%.1f images/s" % f32["images_per_s"],
                "memory": "%.3f" % f32["memory_max_reserved_gib"]}, card)
    add(r)
    del model, staged, feeds, r
    torch.cuda.empty_cache()

    add(_bf16_vgg19(torch, card, readings))
    torch.cuda.empty_cache()

    # the stacked LSTM
    cfg = rnn.LSTM
    model = rnn.build_lstm(cfg)
    recsys.bf16_transpiled(model["main"])
    feeds = [rnn.lstm_feed(cfg, SEED)] * (2 + RNN_STEPS)
    r = _bf16_run(torch, "lstm", model, feeds, COMPARE_STEPS, F32_FIRST["lstm"], BF16_RTOL, card)
    tokens = int(feeds[0]["words@LEN"].sum())
    rate = tokens * RNN_STEPS / (sum(r["walls"][2:]) / 1e3)
    f32 = readings["train_lstm"]["graph"]
    readings["train_bf16_lstm"] = {"graph": {
        "step_p50_ms": float(np.median(r["walls"][2:])), "tokens_per_s": rate,
        "device_busy_ms": r["breakdown"]["device_busy_ms_per_step"],
        "device_busy_share": r["breakdown"]["device_busy_share"],
        "memory_max_reserved_gib": r["reserved"]}}
    _bf16_line("lstm", r, rate, "tokens/s",
               {"rate": "%.1f tokens/s" % f32["tokens_per_s"],
                "memory": "%.3f" % f32["memory_max_reserved_gib"]}, card)
    add(r)
    del model, feeds, r
    torch.cuda.empty_cache()

    # Transformer base, bf16 then fp8 products
    main_prog, startup, loss = prof.build(prof.BASE)
    recsys.bf16_transpiled(main_prog)
    model = {"main": main_prog, "startup": startup, "loss": loss}
    feeds = [prof.make_batch(prof.BASE, SEED + i) for i in range(TRAIN_STEPS)]
    r = _bf16_run(torch, "transformer", model, feeds, COMPARE_STEPS, F32_FIRST["transformer"],
                  BF16_RTOL, card)
    tokens = sum(prof.target_tokens(b) for b in feeds[2:])
    rate = tokens / (sum(r["walls"][2:]) / 1e3)
    f32 = readings["train"]["graph"]
    readings["train_bf16_transformer"] = {"graph": {
        "step_p50_ms": float(np.median(r["walls"][2:])), "target_tokens_per_s": rate,
        "device_busy_ms": r["breakdown"]["device_busy_ms_per_step"],
        "device_busy_share": r["breakdown"]["device_busy_share"],
        "memory_max_reserved_gib": r["reserved"]}}
    _bf16_line("transformer", r, rate, "target tokens/s",
               {"rate": "%.1f target tokens/s" % f32["target_tokens_per_s"],
                "memory": "%.3f" % f32["memory_reserved_gib_after_graph_steps"]}, card)
    add(r)
    bf16_losses = r["losses"]
    flags.set_flags({"fp8_matmul": True})
    try:
        r8 = _bf16_run(torch, "transformer fp8", model, feeds[:FP8_STEPS], FP8_STEPS,
                       bf16_losses, FP8_LOSS_RTOL, card, n_fp8=1, fp8_split=True)
    finally:
        flags.set_flags({"fp8_matmul": False})
    for k in ("fp8_matmul", "fp8_matmul_dx", "fp8_matmul_dy"):
        if not r8["launches"].get(k):
            raise AssertionError("transformer fp8: %s never launched (%s)" % (k, r8["launches"]))
    if r8["launches"].get("quant_gemm_fp8"):
        raise AssertionError("transformer fp8: the e4m3 quant GEMM launched (%s)" % r8["launches"])
    log("train bf16 transformer fp8: FLAGS_fp8_matmul, %d graph steps (the warmup, the capture, "
        "a replay), losses %s within %g relative of the bf16 steps' %s; launches %s (%s a step), "
        "the first %d losses bit for bit op by op with the same counters; kernels at the path's "
        "inputs: %s; step walls %s ms (the replay's before the redesign: %.3f ms, %s); op by op "
        "device ms a step %s (before: %s); card %s" % (
            FP8_STEPS, ["%.6f" % v for v in r8["losses"]], FP8_LOSS_RTOL,
            ["%.6f" % v for v in bf16_losses[:FP8_STEPS]], json.dumps(r8["launches"]),
            json.dumps({"%s:%s" % k: v for k, v in r8["deltas"].items()}), FP8_STEPS, r8["held"],
            ["%.3f" % v for v in r8["walls"]], FP8_BEFORE["step_ms"], FP8_BEFORE["origin"],
            json.dumps({k: round(v, 3) for k, v in r8["split"].items()}),
            json.dumps(FP8_BEFORE["split"]), card))
    add(r8)
    del model, feeds, r, r8
    torch.cuda.empty_cache()
    return launches, errs


SCHEDULES = (
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=2, decay_rate=0.5),
     lambda k: 0.1 * 0.5 ** (k / 2.0)),
    ("natural_exp_decay", dict(learning_rate=0.1, decay_steps=2, decay_rate=0.5),
     lambda k: 0.1 * np.exp(-0.5 * k / 2.0)),
    ("inverse_time_decay", dict(learning_rate=0.1, decay_steps=2, decay_rate=0.5),
     lambda k: 0.1 / (1.0 + 0.5 * k / 2.0)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=4, end_learning_rate=0.01,
                              power=2.0),
     lambda k: (0.1 - 0.01) * (1.0 - min(k, 4) / 4.0) ** 2 + 0.01),
    ("piecewise_decay", dict(boundaries=[2, 4], values=[0.1, 0.05, 0.01]),
     lambda k: 0.1 if k < 2 else 0.05 if k < 4 else 0.01),
    ("cosine_decay", dict(learning_rate=0.1, step_each_epoch=2, epochs=3),
     lambda k: 0.05 * (np.cos(np.floor(k / 2.0) * np.pi / 3) + 1)),
    ("noam_decay", dict(d_model=512, warmup_steps=3),
     lambda k: 512 ** -0.5 * min(k ** -0.5, k * 3 ** -1.5)),
)


def schedules(torch, card):
    """Each schedule drives SGD over a one-fc program: the warmup, the
    capture and SCHEDULE_STEPS replays, the fetched learning rate against
    the closed form at every step."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, fluid, scope_guard

    rng = np.random.RandomState(SEED)
    x = rng.randn(4, 8).astype("float32")
    got = {}
    for name, kwargs, closed in SCHEDULES:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            xv = fluid.layers.data(name="x", shape=[8], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(xv, size=1))
            lr = getattr(fluid.layers, name)(**kwargs)
            fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        scope, exe = Scope(seed=SEED, place=CUDAPlace(0)), Executor(CUDAPlace(0))
        with scope_guard(scope):
            exe.run(startup)
            lrs = [float(exe.run(main, feed={"x": x}, fetch_list=[lr.name])[0].reshape(-1)[0])
                   for _ in range(2 + SCHEDULE_STEPS)]
        first = 1 if name == "noam_decay" else 0
        want = [closed(first + k) for k in range(len(lrs))]
        if not np.allclose(lrs, want, rtol=SCHEDULE_RTOL, atol=0):
            raise AssertionError("%s: learning rates %s, closed form %s" % (name, lrs, want))
        got[name] = lrs
    log("schedules: %d learning-rate schedules, each over SGD for the warmup, the capture and "
        "%d replayed steps, equal their closed forms at every step (rtol %g): %s; card %s" % (
            len(SCHEDULES), SCHEDULE_STEPS, SCHEDULE_RTOL,
            json.dumps({k: ["%.7g" % v for v in vs] for k, vs in got.items()}), card))


# ---------------------------------------------------------------- phase 14

SSD_STEPS = 30  # graph steps of MobileNet-SSD on its fixed batch, after the warmup and capture
SSD_FALL = 0.7  # the last loss under this share of the first (tests/test_detection.py:265)
SSD_EVAL_RUNS = 3  # the warmup, the capture, a replay


def _ssd_model():
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.tools import profile_detection as det

    return det, det.build(fluid, det.SSD)


def _staged(torch, feed):
    """A feed dict of numpy arrays, staged on the card once."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in feed.items()}


def train_ssd(torch, card, readings):
    """MobileNet-SSD at full width (profile_detection.SSD: batch 64, 3 x 300
    x 300, 21 classes, 1917 priors, f32; random weights from SEED) under
    RMSProp(piecewise_decay) with L2Decay, on a fixed synthetic VOC-shaped
    batch staged on the card: the warmup, the capture and SSD_STEPS graph
    steps, no hand-written kernel launched and only the startup program op
    by op; the last loss under SSD_FALL of the first; then the first
    COMPARE_STEPS steps op by op from the same seed: the same losses bit
    for bit and the same counters a step. Logs the step wall, images/s,
    the device's busy share, the memory reserved and the device time of
    ssd_loss (its grad included) against the convolutions'; then the step
    wall and batch_norm's device share with the generic grad against the
    explicit batch_norm_grad, from this call (_bn_grad_ab). Returns the
    trained scope's state for eval_ssd."""
    from paddle_tpu_torch import Executor
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_training as prof

    _explicit_bn_grad()
    det, model = _ssd_model()
    cfg = det.SSD
    feed = _staged(torch, det.synthetic_batch(np.random.RandomState(SEED), cfg))
    feeds = [feed] * (2 + SSD_STEPS)
    state = {}

    def keep(i, scope):
        if i == len(feeds) - 1:
            state.update({n: v.clone() for n, v in scope.vars.items()
                          if isinstance(v, torch.Tensor)})

    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # the main path's counting window opens here
    outs, walls, deltas, _, step, scope = _fluid_run(
        torch, model, feeds, "training_fused", [model["loss"]],
        check=_exact_counts({}, "ssd"), after=keep)
    runs = dict(Executor.stats()["op_by_op"])  # and closes here
    if runs != {"creates_persistables": 1}:
        raise AssertionError("ssd: blocks run op by op %s (only the startup program may)" % runs)
    reserved = torch.cuda.max_memory_reserved() / GIB
    losses = [float(o[0]) for o in outs]
    if not losses[-1] < SSD_FALL * losses[0]:
        raise AssertionError("ssd: the loss did not fall under %.2fx: %s" % (SSD_FALL, losses))
    batch = cfg["batch"]
    graph = {"batch": batch, "step_p50_ms": float(np.median(walls[2:])),
             "images_per_s": batch * SSD_STEPS / (sum(walls[2:]) / 1e3),
             "memory_max_reserved_gib": reserved}
    breakdown = prof.profile_steps(step, feeds[2:4], registry)
    graph.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                 device_busy_share=breakdown["device_busy_share"],
                 device_launches=breakdown["device_launches_per_step"],
                 profiled_wall_p50_ms=breakdown["wall_ms_p50"])
    del step, scope
    torch.cuda.empty_cache()
    eager, e_walls, e_deltas, _, estep, escope = _fluid_run(
        torch, model, feeds[:COMPARE_STEPS], "training_fused", [model["loss"]], per_op=True)
    _same_bits("ssd loss, graph against op by op, step", [o[0] for o in eager],
               [o[0] for o in outs[:COMPARE_STEPS]])
    if e_deltas != deltas[:COMPARE_STEPS]:
        raise AssertionError("ssd: counters a step %s on the graph path, %s op by op"
                             % (deltas[:COMPARE_STEPS], e_deltas))
    ops = {o.type for o in model["main"].global_block().ops}
    conv = sorted(t for t in ops if "conv2d" in t)
    ssd_split = (("ssd_loss", ("ssd_loss", "ssd_loss_grad")), ("convolutions", tuple(conv)),
                 ("batch_norm", ("batch_norm", "batch_norm_grad")), ("rmsprop", ("rmsprop",)))
    split = prof.op_device_split(estep, feeds[:1], registry, split_by=ssd_split)
    del estep, escope
    torch.cuda.empty_cache()
    eager_reading = {"step_p50_ms": float(np.median(e_walls[1:])),
                     "device_ms_by_op_type": split["device_ms_per_step"],
                     "split": split["by_category"]}
    readings["train_ssd"] = {"graph": graph, "op_by_op": eager_reading}
    bn_ms, bn_share = _bn_share(split, ("batch_norm",))
    explicit = {"step_p50_ms": graph["step_p50_ms"], "losses": losses[:COMPARE_STEPS],
                "op_by_op_device_ms": split["device_ms_per_step"], "batch_norm_ms": bn_ms,
                "batch_norm_share": bn_share}
    generic = _bn_grad_ab(torch, model, feeds, "ssd", losses, ssd_split, ("batch_norm",))
    readings["train_ssd"]["batch_norm_grad_ab"] = {"generic": generic, "explicit": explicit}
    _bn_ab_line("train ssd", explicit, generic, card)
    sl = split["by_category"]["ssd_loss"]
    cv = split["by_category"]["convolutions"]
    log("train ssd: MobileNet-SSD %s, RMSProp(piecewise_decay) lr %g, L2Decay(%g), f32, %d ops; "
        "losses %s (the last %.3f of the first, gate %.2f); no hand-written kernel launched; the "
        "first %d losses bit for bit op by op with the same counters; graph: step wall p50 %.3f "
        "ms, %.1f images/s over the %d graph steps, device busy %s ms a step = %s of the "
        "profiled wall p50 (%.3f ms), %s launches a step, max memory reserved %.3f GiB; op by "
        "op: step wall p50 %.3f ms, device %.3f ms a step, ssd_loss and its grad %.3f ms "
        "against the convolutions' %.3f ms (%s), split %s; card %s" % (
            json.dumps(cfg), cfg["lr"], cfg["l2"], len(model["main"].global_block().ops),
            ["%.5f" % v for v in losses], losses[-1] / losses[0], SSD_FALL, COMPARE_STEPS,
            graph["step_p50_ms"], graph["images_per_s"], SSD_STEPS, graph["device_busy_ms"],
            graph["device_busy_share"], breakdown["wall_ms_p50"], graph["device_launches"],
            reserved, eager_reading["step_p50_ms"], split["device_ms_per_step"], sl, cv,
            ", ".join(conv),
            json.dumps({k: round(v, 3) for k, v in split["by_category"].items()}), card))
    return model, state, feed


def eval_ssd(torch, card, readings, model, state, feed):
    """The eval program (the for_test clone, detection_output with
    nms_threshold 0.45, the detection_map host op, 11-point AP) on the
    trained state: SSD_EVAL_RUNS runs, each one device segment and one
    host call; the device segment captured at the second run and replayed
    at the third with no capture again; the detections the same bits on
    every run; the host op's mAP equal to evaluator.DetectionMAP over the
    fetched rows. Logs the eval wall, the segment's device time and
    launches a replay (its graph's kernel nodes), the capture's wall and
    the host op's own time."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, evaluator, scope_guard
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.tools import profile_detection as det
    from paddle_tpu_torch.tools import profile_generation as pgen
    place = CUDAPlace(0)
    scope, exe = Scope(seed=SEED, place=place), Executor(place)
    with scope_guard(scope):
        exe.run(model["startup"])
    for n, v in state.items():
        if n in scope.vars:
            scope.vars[n] = v
    fetch = [model["nmsed"], model["map"], model["labels"]]
    outs, walls, stats = [], [], []
    with scope_guard(scope):
        for _ in range(SSD_EVAL_RUNS):
            fused.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(exe.run(model["test"], feed=feed, fetch_list=fetch))
            walls.append((time.perf_counter() - t0) * 1e3)
            stats.append(Executor.stats())
    segs = [s["segments"] for s in stats]
    graphs = [s["graphs"] for s in stats]
    if segs != [{"device": 1, "host": 1}] * SSD_EVAL_RUNS:
        raise AssertionError("eval ssd: segments a run %s, want one device segment and one "
                             "host call" % segs)
    if graphs != [{}, {"captures": 1, "replays": 1}, {"replays": 1}]:
        raise AssertionError("eval ssd: graphs a run %s (captured at the second run, "
                             "replayed after)" % graphs)
    _same_bits("eval ssd detections, run", [o[0] for o in outs[1:]], [outs[0][0]] * 2)
    nmsed, m, labels = outs[-1]
    want = det.reference_map(nmsed, labels, evaluator.DetectionMAP, det.SSD["classes"])
    if abs(float(m[0]) - want) > 1e-6:
        raise AssertionError("eval ssd: host op mAP %r, DetectionMAP %r" % (float(m[0]), want))
    n_det = int((nmsed[..., 0] >= 0).sum())
    if not n_det:
        raise AssertionError("eval ssd: no detections")

    def run():
        w = []
        for _ in range(2):
            t0 = time.perf_counter()
            with scope_guard(scope):
                exe.run(model["test"], feed=feed, fetch_list=fetch)
            w.append((time.perf_counter() - t0) * 1e3)
        return w

    prof = pgen._windows(run, 2, True)
    # the host op alone, on the detections the last run left in the scope
    op = [o for o in model["test"].global_block().ops if o.type == "detection_map"][0]
    host_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        registry.get("detection_map").host_fn(op, scope)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    reading = {"wall_ms_p50": prof["wall_ms_p50"], "capture_run_ms": walls[1],
               "warmup_run_ms": walls[0], "replay_run_ms": walls[2],
               "device_segment_busy_ms": prof["device_busy_ms_per_step"],
               "device_segment_launches": prof["device_launches_per_step"],
               "host_op_ms": float(np.median(host_ms)), "map_11point": float(m[0]),
               "detections": n_det}
    readings["eval_ssd"] = {"graph": reading}
    log("eval ssd: the for_test clone + detection_output (nms_threshold %g, nms_top_k 400, "
        "keep_top_k 200) + detection_map (11point) on the trained state, batch %d: %s a run "
        "(one device segment, one host call); graphs a run %s; the detections the same bits on "
        "all %d runs; %d detections; host-op mAP %.6f = DetectionMAP over the fetched rows "
        "%.6f; wall p50 %.3f ms a run, the device segment %.3f ms busy a replay in %s launches "
        "(its graph's kernel nodes; the NMS 400 rounds of them), capture run %.1f ms, warmup "
        "run %.1f ms, the host op %.3f ms alone; card %s" % (
            det.SSD["nms_threshold"], det.SSD["batch"], json.dumps(segs[0]), json.dumps(graphs),
            SSD_EVAL_RUNS, n_det, float(m[0]), want, prof["wall_ms_p50"],
            prof["device_busy_ms_per_step"], prof["device_launches_per_step"], walls[1],
            walls[0], reading["host_op_ms"], card))


def _faster_rcnn_cases(torch, registry, rng):
    """The detection ops at a published detector's shapes: Faster R-CNN
    (R50-C4, stride 16) on an 800 x 1333 image (a 50 x 84 map, 1024
    channels), anchors of sizes 32-512 at ratios 0.5, 1, 2 (15 a cell),
    pre_nms_topN 6000, post_nms_topN 1000, 256 RPN samples, 512 RoIs an
    image, RoIAlign and RoIPool 7 x 7 at 1/16, 2 images; YOLOv3 at 608 x 608
    (19/38/76 grids, 80 classes, the nine anchors by mask, ignore_thresh
    0.7, 8 images of 50 boxes); SSD300 (MobileNet-SSD's 1917 priors, 21
    classes, 64 images); FaceBoxes' density priors (1024 x 1024, a 32 x 32
    map); EAST's geometry map (512 x 512 at 1/4); a text detector's
    perspective crops (32 channels at 1/4 of 512 x 512, 64 quads to 8 x
    64). Returns [(name, op, ins, attrs)]."""
    f32 = np.float32
    b, h, w, a, c = 2, 50, 84, 15, 1024
    cases = []
    feat = np.zeros((b, 8, h, w), f32)
    sizes, ratios = [32.0, 64.0, 128.0, 256.0, 512.0], [0.5, 1.0, 2.0]
    cases.append(("anchor_generator", "anchor_generator", {"Input": [feat]},
                  {"anchor_sizes": sizes, "aspect_ratios": ratios, "stride": [16.0, 16.0],
                   "variances": [1.0, 1.0, 1.0, 1.0], "offset": 0.5}))
    # the anchors as the op makes them, for the ops that take them
    anchors = _cpu_op(torch, registry, *cases[-1][1:])["Anchors"][0]
    g = 20
    gt = np.zeros((b, g, 4), f32)
    glen = np.array([13, 20], np.int32)
    for i in range(b):
        xy = rng.rand(glen[i], 2) * [1000, 600]
        wh = rng.uniform(20, 330, size=(glen[i], 2))
        gt[i, :glen[i]] = np.concatenate([xy, np.minimum(xy + wh, [1332, 799])], 1)
    gcls = rng.randint(1, 81, (b, g)).astype(np.int32)
    cases.append(("generate_proposals", "generate_proposals",
                  {"Scores": [rng.rand(b, a, h, w).astype(f32)],
                   "BboxDeltas": [(rng.randn(b, a * 4, h, w) * 0.2).astype(f32)],
                   "ImInfo": [np.array([[800.0, 1333.0, 1.0]] * b, f32)],
                   "Anchors": [anchors], "Variances": [np.ones_like(anchors)]},
                  {"pre_nms_topN": 6000, "post_nms_topN": 1000, "nms_thresh": 0.7,
                   "min_size": 0.0}))
    cases.append(("rpn_target_assign", "rpn_target_assign",
                  {"Anchor": [anchors.reshape(-1, 4)], "GtBox": [gt], "GtLen": [glen]},
                  {"rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3,
                   "rpn_batch_size_per_im": 256, "rpn_fg_fraction": 0.5}))
    r = 1000
    xy = rng.rand(b, r, 2) * [1100, 650]
    rois = np.concatenate([xy, xy + rng.uniform(16, 300, (b, r, 2))], 2).astype(f32)
    rois[:, -50:] = -1.0  # NMS's padding rows
    cases.append(("generate_proposal_labels", "generate_proposal_labels",
                  {"RpnRois": [rois], "GtClasses": [gcls], "GtBoxes": [gt], "GtLen": [glen]},
                  {"fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
                   "batch_size_per_im": 512, "fg_fraction": 0.25}))
    x = rng.randn(b, c, h, w).astype(f32)
    sampled = rois[:, :512].copy()
    rlen = np.array([512, 512], np.int32)
    for op in ("roi_align", "roi_pool"):
        attrs = {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1.0 / 16}
        if op == "roi_align":
            attrs["sampling_ratio"] = -1
        cases.append((op, op, {"X": [x], "ROIs": [sampled], "RoisLen": [rlen]}, attrs))
    # YOLOv3 at 608 x 608, each head with its three anchors
    anchors9 = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156, 198, 373, 326]
    yb, yg, cls = 8, 50, 80
    ygt = np.zeros((yb, yg, 4), f32)
    for i in range(yb):
        n = rng.randint(5, yg + 1)
        ygt[i, :n, :2] = rng.uniform(0.05, 0.95, (n, 2))
        ygt[i, :n, 2:] = rng.uniform(0.02, 0.6, (n, 2))
    ylab = rng.randint(0, cls, (yb, yg)).astype(np.int32)
    for grid, mask in ((19, (6, 7, 8)), (38, (3, 4, 5)), (76, (0, 1, 2))):
        anc = [v for m in mask for v in anchors9[2 * m:2 * m + 2]]
        cases.append(("yolov3_loss_%d" % grid, "yolov3_loss",
                      {"X": [(rng.randn(yb, 3 * (5 + cls), grid, grid) * 0.5).astype(f32)],
                       "GTBox": [ygt], "GTLabel": [ylab]},
                      {"anchors": anc, "class_num": cls, "ignore_thresh": 0.7}))
    # SSD300: MobileNet-SSD's priors, 21 classes, 64 images, 16 gt an image
    sb, m, sc, sg = 64, 1917, 21, 16
    pxy = rng.rand(m, 2) * 0.8
    prior = np.concatenate([pxy, pxy + rng.uniform(0.05, 0.5, (m, 2))], 1).astype(f32)
    sgt = np.zeros((sb, sg, 4), f32)
    slen = rng.randint(1, 9, sb).astype(np.int32)
    for i in range(sb):
        xy = rng.rand(slen[i], 2) * 0.6
        sgt[i, :slen[i]] = np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (slen[i], 2))], 1)
    img = np.zeros((sb, 3, 300, 300), f32)
    cases.append(("prior_box", "prior_box", {"Input": [np.zeros((sb, 8, 19, 19), f32)],
                                             "Image": [img]},
                  {"min_sizes": [60.0], "max_sizes": [], "aspect_ratios": [2.0], "flip": True,
                   "variances": [0.1, 0.1, 0.2, 0.2], "offset": 0.5}))
    cases.append(("density_prior_box", "density_prior_box",
                  {"Input": [np.zeros((1, 8, 32, 32), f32)],
                   "Image": [np.zeros((1, 3, 1024, 1024), f32)]},
                  {"fixed_sizes": [32.0, 64.0, 128.0], "densities": [4, 2, 1],
                   "fixed_ratios": [1.0], "clip": True}))
    pvar = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], f32), (m, 1))
    loc = (rng.randn(sb, m, 4) * 0.5).astype(f32)
    cases.append(("box_coder", "box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                                             "TargetBox": [loc]},
                  {"code_type": "decode_center_size"}))
    cases.append(("iou_similarity", "iou_similarity", {"X": [sgt[0]], "Y": [prior]}, {}))
    dist = _cpu_op(torch, registry, "iou_similarity", {"X": [sgt], "Y": [prior]}, {})["Out"][0]
    dist *= (np.arange(sg)[None, :, None] < slen[:, None, None])
    cases.append(("bipartite_match", "bipartite_match", {"DistMat": [dist]},
                  {"match_type": "per_prediction", "dist_threshold": 0.5}))
    match = np.where(dist.max(1) >= 0.5, dist.argmax(1), -1).astype(np.int32)
    cases.append(("mine_hard_examples", "mine_hard_examples",
                  {"ClsLoss": [rng.rand(sb, m).astype(f32)], "MatchIndices": [match]},
                  {"neg_pos_ratio": 3.0}))
    neg = np.full((sb, m), -1, np.int32)
    neg[:, :100] = rng.randint(0, m, (sb, 100))
    cases.append(("target_assign", "target_assign",
                  {"X": [sgt], "MatchIndices": [match], "NegIndices": [neg]},
                  {"mismatch_value": 0}))
    scores = rng.rand(sb, sc, m).astype(f32)
    scores /= scores.sum(1, keepdims=True)
    cases.append(("multiclass_nms", "multiclass_nms",
                  {"BBoxes": [loc * 0.1 + prior[None]], "Scores": [scores]},
                  {"background_label": 0, "score_threshold": 0.01, "nms_top_k": 400,
                   "nms_threshold": 0.45, "keep_top_k": 200, "normalized": True}))
    labels = rng.randint(1, sc, (sb, sg, 1)).astype(np.int32)
    cases.append(("ssd_loss", "ssd_loss",
                  {"Location": [loc], "Confidence": [rng.randn(sb, m, sc).astype(f32)],
                   "GTBox": [sgt], "GTLabel": [labels], "GTLen": [slen], "PriorBox": [prior],
                   "PriorBoxVar": [pvar]}, {"match_type": "per_prediction"}))
    geo = rng.randn(1, 8, 128, 128).astype(f32)
    geo[rng.rand(*geo.shape) < 0.5] = 0.0
    cases.append(("polygon_box_transform", "polygon_box_transform", {"Input": [geo]}, {}))
    qxy = rng.rand(1, 64, 2) * [100, 110]
    quad = np.concatenate([qxy, qxy + [24, 2], qxy + [25, 9], qxy + [1, 8]], 2).astype(f32)
    cases.append(("roi_perspective_transform", "roi_perspective_transform",
                  {"X": [rng.randn(1, 32, 128, 128).astype(f32)], "ROIs": [quad]},
                  {"transformed_height": 8, "transformed_width": 64, "spatial_scale": 1.0}))
    return cases


def _cpu_op(torch, registry, op, ins, attrs):
    """{slot: [numpy]} of one lowering on the CPU (inputs for another case)."""
    ctx = _lower_ctx(torch, registry, "cpu")
    outs = registry.get(op).lower(ctx, {s: [torch.from_numpy(v) for v in vs]
                                        for s, vs in ins.items()}, dict(attrs))
    return {s: [v.numpy() for v in vs] for s, vs in outs.items()}


DET_TOL = 1e-4  # a lowering on the card against the CPU: f32 in another order
DET_REPLAYS = 3  # replays of each op's graph, timed by CUDA events


def _graph_nodes(graph):
    """The nodes (kernels, copies, memsets) of a CUDA graph captured with
    keep_graph=True, by libcuda's cuGraphGetNodes on its cudaGraph_t."""
    import ctypes

    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError("cuGraphGetNodes failed with CUresult %d" % rc)
    return count.value


def _lower_ctx(torch, registry, device):
    """A lowering context on `device` with its own generators and constant
    cache, made outside any capture (a capture cannot make a generator)."""
    return registry.LowerCtx(device, cache={}, host_random=False,
                             generator=torch.Generator().manual_seed(SEED),
                             device_generator=torch.Generator(device=device).manual_seed(SEED))


def _close_outs(name, got, want, tol):
    """Floats within rtol = atol = tol, integers exactly (NaN where NaN)."""
    worst = 0.0
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            g, w = g.detach().cpu().numpy(), w.detach().cpu().numpy()
            if g.shape != w.shape:
                raise AssertionError("%s %s: shape %s, want %s" % (name, slot, g.shape, w.shape))
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg="%s %s" % (name,
                                                                                         slot))
                both = np.isfinite(w)
                if both.any():
                    worst = max(worst, float(np.abs(g[both] - w[both]).max()))
            elif not np.array_equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError("%s %s: %d of %d integers differ" % (name, slot, bad, g.size))
    return worst


def detection_ops(torch, card):
    """Each detection op at a published detector's shapes
    (_faster_rcnn_cases): eager on the card against eager on the CPU
    (floats within DET_TOL, integers exactly), then captured alone in a
    CUDA graph and replayed: the replay's outputs equal the card's eager
    run bit for bit. Logs each op's capture wall, replay time (CUDA events
    over DET_REPLAYS replays) and graph nodes."""
    from paddle_tpu_torch.executor import _on_capture_stream
    from paddle_tpu_torch.ops import registry

    device = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)
    rows = {}
    for name, op, ins_np, attrs in _faster_rcnn_cases(torch, registry, rng):
        lower = registry.get(op).lower
        cpu_ins = {s: [torch.from_numpy(v) for v in vs] for s, vs in ins_np.items()}
        want = lower(_lower_ctx(torch, registry, "cpu"), cpu_ins, dict(attrs))
        ctx = _lower_ctx(torch, registry, device)
        static = {s: [v.to(device) for v in vs] for s, vs in cpu_ins.items()}
        with _on_capture_stream(device):
            eager = lower(ctx, static, dict(attrs))
        torch.cuda.synchronize()
        err = _close_outs(name, eager, want, DET_TOL)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # _graph_nodes reads it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _on_capture_stream(device) as stream:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                captured = lower(ctx, static, dict(attrs))
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        nodes = _graph_nodes(graph)
        graph.instantiate()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DET_REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        for slot in eager:
            for g, e in zip(captured[slot], eager[slot]):
                if g.detach().cpu().numpy().tobytes() != e.detach().cpu().numpy().tobytes():
                    raise AssertionError("%s %s: the replay differs from the eager run"
                                         % (name, slot))
        rows[name] = {"max_abs_err_vs_cpu": err, "capture_ms": capture_ms,
                      "replay_ms": start.elapsed_time(end) / DET_REPLAYS,
                      "graph_nodes": nodes,
                      "shapes": {s: [list(v.shape) for v in vs] for s, vs in ins_np.items()}}
        del graph, captured, eager, static, want
        torch.cuda.empty_cache()
    log("detection ops: %d ops at published shapes, each eager on the card against the CPU "
        "(floats within %g, integers exactly) and captured alone then replayed bit for bit: "
        "%s; card %s" % (len(rows), DET_TOL, json.dumps(
            {k: {f: (round(v, 4) if isinstance(v, float) else v) for f, v in r.items()
                 if f != "shapes"} for k, r in rows.items()}), card))
    log("detection ops shapes: %s" % json.dumps({k: r["shapes"] for k, r in rows.items()}))
    return rows


# ---------------------------------------------------------------- deploy resnet50

DEPLOY_STEPS = 8  # training steps of each program: the warmup, the capture, 6 graph steps
DEPLOY_STATS_STEPS = 40  # QAT steps at learning rate 0 before the legs (0.9^40 of stale stats)
DEPLOY_CALLS = 8  # calls of each inference leg: the warmup, the capture, 6 replays
DEPLOY_EAGER = 2  # op-by-op runs of legs (a) and (e), split by op type
DEPLOY_FOLD_TOL = (1e-4, 1e-5)  # (b) against (a), rtol / atol: tests/test_transpiler.py:310
DEPLOY_INT8_TOL = 1e-4  # (e) against (d) with exact sums, rtol = atol: tests/test_transpiler.py:397
RESNET50_INT8_CONVS = 53  # the stem, 16 bottlenecks of 3 and 4 projection shortcuts
DEPLOY_TIMED = {"stem 7x7 s2": (128 * 112 * 112, 160, 64),
                "stage1 3x3": (128 * 56 * 56, 576, 64),
                "stage4 3x3": (128 * 7 * 7, 4608, 512)}


class _Im2colInputs:
    """While entered, keeps a copy of the operands of the first quant GEMM
    call at each (m, k, n) (int8_conv2d's im2col columns and filter on the
    card), so the kernel can be held against its plain version on the main
    path's own operands. Recording launches nothing."""

    def __init__(self):
        from paddle_tpu_torch.ops import quant_gemm as qg

        self.qg, self.seen = qg, {}

    def __enter__(self):
        self.saved = call = self.qg.quant_gemm_bias_act

        def rec(x2, w2, scale, bias_row=None, act=None):
            key = (int(x2.shape[0]), int(x2.shape[1]), int(w2.shape[1]))
            if key not in self.seen:
                self.seen[key] = (x2.clone(), w2.clone(), scale.clone())
            return call(x2, w2, scale, bias_row, act)

        self.qg.quant_gemm_bias_act = rec
        return self

    def __exit__(self, *exc):
        self.qg.quant_gemm_bias_act = self.saved
        return False


def _deploy_train(torch, prof, registry, model, feeds, batch):
    """DEPLOY_STEPS graph-path steps of a training program (no pass
    pipeline): the readings over graph steps 3-8, and the scope and step."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    outs, walls, deltas, _, step, scope = _fluid_run(torch, model, feeds, "", [model["loss"]])
    window = walls[2:]
    reading = {"batch": batch, "losses": [float(o[0]) for o in outs],
               "step_p50_ms": float(np.median(window)),
               "images_per_s": batch * len(window) / (sum(window) / 1e3),
               "memory_max_reserved_gib": torch.cuda.max_memory_reserved() / GIB,
               "counters_a_step": {"%s:%s" % k: v for k, v in deltas[-1].items()}}
    breakdown = prof.profile_steps(step, feeds[2:4], registry)
    reading.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                   device_busy_share=breakdown["device_busy_share"],
                   device_launches=breakdown["device_launches_per_step"],
                   profiled_wall_p50_ms=breakdown["wall_ms_p50"])
    return reading, outs, step, scope


def _deploy_leg(torch, dep, prof, registry, leg, prog, scope, feed, fetch, n_int8):
    """One inference leg: DEPLOY_CALLS graph-path calls (the warmup, the
    capture, replays), the same counters every call (leg (e): a quant GEMM
    launch and an int8_conv2d dispatch for each of its n_int8 convolutions,
    the other legs none); the op-by-op path's logits equal to the replays'
    bit for bit with the same counters; legs (a) and (e) split by op type.
    Returns (reading, logits, the im2col recorder or None)."""
    from paddle_tpu_torch import CUDAPlace, Executor, scope_guard
    from paddle_tpu_torch.ops import fused

    exe = Executor(CUDAPlace(0))

    def step(f):
        with scope_guard(scope):
            return exe.run(prog, feed=f, fetch_list=[fetch])[0]

    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    fused.reset_stats()  # leg (e)'s counting window opens here
    walls, outs, deltas = [], [], []
    for _ in range(DEPLOY_CALLS):
        before = fused.stats()
        t0 = time.perf_counter()
        outs.append(step(feed))
        walls.append((time.perf_counter() - t0) * 1e3)
        deltas.append(_counter_delta(before, fused.stats()))
    counts = {k: v for k, v in fused.stats()["launches"].items() if v}  # and closes here
    graphs = Executor.stats()["graphs"]
    want = ({("launches", "quant_gemm_int8"): n_int8, ("dispatches", "int8_conv2d"): n_int8}
            if leg == "e" else {})
    for i, d in enumerate(deltas):
        if d != want:
            raise AssertionError("leg %s call %d: counters %s, want %s" % (leg, i, d, want))
    if graphs != {"captures": 1, "replays": DEPLOY_CALLS - 1}:
        raise AssertionError("leg %s: graphs %s" % (leg, graphs))
    peak = torch.cuda.max_memory_reserved()
    window = walls[2:]
    batch = feed["img"].shape[0]
    reading = {"batch": int(batch), "wall_p50_ms": float(np.median(window)),
               "images_per_s": batch * len(window) / (sum(window) / 1e3),
               "memory_max_reserved_gib": peak / GIB,
               "memory_added_by_leg_gib": (peak - base) / GIB,
               "ops": len(prog.global_block().ops), "launches": counts}
    breakdown = prof.profile_steps(step, [feed, feed], registry)
    reading.update(device_busy_ms=breakdown["device_busy_ms_per_step"],
                   device_busy_share=breakdown["device_busy_share"],
                   device_launches=breakdown["device_launches_per_step"],
                   profiled_wall_p50_ms=breakdown["wall_ms_p50"])
    rec = _Im2colInputs() if leg == "e" else None
    with rec or contextlib.nullcontext(), op_by_op():
        before = fused.stats()
        t0 = time.perf_counter()
        eager = step(feed)
        reading["op_by_op_wall_ms"] = (time.perf_counter() - t0) * 1e3
        e_delta = _counter_delta(before, fused.stats())
    if eager.tobytes() != outs[-1].tobytes():
        raise AssertionError("leg %s: graph and op-by-op logits differ by %g" % (
            leg, float(np.abs(eager - outs[-1]).max())))
    if e_delta != want:
        raise AssertionError("leg %s op by op: counters %s, want %s" % (leg, e_delta, want))
    if leg in ("a", "e"):
        split = prof.op_device_split(step, [feed] * DEPLOY_EAGER, registry, split_by=dep.SPLIT)
        reading["op_by_op_device_ms"] = split["device_ms_per_step"]
        reading["split"] = split["by_category"]
        reading["top_ops"] = dict(list(split["by_op"].items())[:8])
        reading["top_kernels_by_op"] = {
            o: dict(sorted(ks.items(), key=lambda kv: -kv[1])[:4])
            for o, ks in split["kernels_by_op"].items() if o in reading["top_ops"]}
    del exe, step
    return reading, eager, rec


def _exact_conv_run(torch, prog, scope, feed, fetch):
    """One op-by-op run of `prog` with cuDNN off, so that its f32
    convolutions are the native im2col GEMM's (exact sums of integer
    levels here). Returns the fetch."""
    from paddle_tpu_torch import CUDAPlace, Executor, scope_guard

    with torch.backends.cudnn.flags(enabled=False, deterministic=True, allow_tf32=False), \
            op_by_op(), scope_guard(scope):
        out = Executor(CUDAPlace(0)).run(prog, feed=feed, fetch_list=[fetch])[0]
    torch.cuda.empty_cache()
    return out


def _hold_im2col(torch, qg, rec, flush):
    """The quant GEMM kernel against its plain version, bit for bit, on each
    recorded im2col product; DEPLOY_TIMED's shapes timed (device ms, cold
    L2) beside the plain version and torch._int_mm over the same columns."""
    held, timed = [], {}
    for (m, k, n), (x2, w2, scale) in sorted(rec.seen.items()):
        z, _ = qg.quant_gemm_bias_act(x2, w2, scale)
        zp, _ = qg.quant_gemm_bias_act_plain(x2, w2, scale)
        torch.cuda.synchronize()
        if not torch.equal(z, zp):
            raise AssertionError("quant_gemm at the im2col product (%d, %d) @ (%d, %d): kernel "
                                 "and plain differ by %g" % (m, k, k, n,
                                                             float((z - zp).abs().max())))
        held.append([m, k, n])
    for name, (m, k, n) in DEPLOY_TIMED.items():
        if (m, k, n) not in rec.seen:
            raise AssertionError("int8_conv2d never gave the quant GEMM %s's product %s "
                                 "(it gave %s)" % (name, (m, k, n), sorted(rec.seen)))
        x2, w2, scale = rec.seen[(m, k, n)]
        ms = time_ms(torch, lambda: qg.quant_gemm_bias_act(x2, w2, scale), 10, flush,
                     gated=True)
        plain_ms = time_ms(torch, lambda: qg.quant_gemm_bias_act_plain(x2, w2, scale), 3, flush,
                           gated=True)
        lib_ms = time_ms(torch, lambda: torch._int_mm(x2, w2), 10, flush, gated=True)
        bound_ms, bound_by = _qgemm_bound(m, k, n, None)
        timed[name] = {"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain_ms,
                       "int_mm_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    return held, timed


def _deploy_artifact(torch, prog, scope, feed, fetch, n_int8, want, card):
    """(d) of the compiled artifacts: leg (e)'s int8 program (frozen,
    convert_to_int8) saved by io.save_inference_model, then served by
    inference.Predictor and by load_compiled(export_compiled(...)), each
    INFER_CALLS calls: every fetch bit for bit the Predictor's first, and
    that one bit for bit leg (e)'s op-by-op logits `want`; the exported
    graph holds one quant_gemm_bias_act node, and each call launches the
    quant GEMM once, per int8_conv2d. Returns (the artifact's quant GEMM
    launches, its record)."""
    import shutil
    import tempfile

    from paddle_tpu_torch import CUDAPlace, Executor, inference, io, scope_guard
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.serving import compile_cache

    tmp = tempfile.mkdtemp(prefix="deploy_artifact_")
    try:
        model_dir = os.path.join(tmp, "int8")
        with scope_guard(scope):
            io.save_inference_model(model_dir, ["img"], [prog.global_block().var(fetch)],
                                    Executor(CUDAPlace(0)), main_program=prog)
        host = {"img": feed["img"].cpu().numpy()}
        pred = inference.Predictor(model_dir, place=CUDAPlace(0))
        p_outs, p_walls, p_deltas = _infer_calls(pred.run, host)
        del pred
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        path = inference.export_compiled(model_dir, host, os.path.join(tmp, "art"),
                                         place=CUDAPlace(0))
        export_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        nodes = _op_nodes(compile_cache.read_artifact(path)["program"]).get(
            "quant_gemm_bias_act", 0)
        t0 = time.perf_counter()
        art = inference.load_compiled(path)
        load_s = time.perf_counter() - t0
        fused.reset_stats()  # the artifact's counting window
        a_outs, a_walls, a_deltas = _infer_calls(art.run, host)
        launches = fused.stats()["launches"].get("quant_gemm_int8", 0)
        del art
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    want_counts = {"quant_gemm_int8": n_int8}
    for label, deltas in (("Predictor", p_deltas), ("artifact", a_deltas)):
        for i, d in enumerate(deltas):
            if d != want_counts:
                raise AssertionError("deploy artifact, %s call %d: launches %s, want %s"
                                     % (label, i, d, want_counts))
    if nodes != n_int8:
        raise AssertionError("deploy artifact: %d quant_gemm_bias_act nodes, want %d"
                             % (nodes, n_int8))
    ref = p_outs[0]
    if ref.tobytes() != want.tobytes():
        raise AssertionError("deploy artifact: the Predictor's logits differ from leg (e)'s "
                             "(max abs %g)" % float(np.abs(ref - want).max()))
    for label, outs in (("Predictor", p_outs), ("artifact", a_outs)):
        for i, o in enumerate(outs):
            if o.tobytes() != ref.tobytes():
                raise AssertionError("deploy artifact, %s call %d: logits differ from the "
                                     "Predictor's first (max abs %g)"
                                     % (label, i, float(np.abs(o - ref).max())))
    record = {"export_s": export_s, "load_s": load_s, "bytes": size, "nodes": nodes,
              "predictor_wall_p50_ms": float(np.median(p_walls[2:])),
              "artifact_wall_p50_ms": float(np.median(a_walls[2:])),
              "artifact_walls_1_2_ms": a_walls[:2], "launches_a_call": want_counts}
    log("deploy resnet50 artifact (d): leg (e)'s int8 program (%d int8_conv2d) saved by "
        "io.save_inference_model, exported by inference.export_compiled in %.1f s (%d bytes, %d "
        "paddle_tpu_torch.quant_gemm_bias_act nodes), loaded in %.1f s; Predictor and loaded "
        "artifact %d calls each at batch %d, every fetch bit for bit the Predictor's first, "
        "and that one leg (e)'s; "
        "launches a call %s, %d over the artifact's calls; wall p50 over calls 3-%d: Predictor "
        "%.3f ms, artifact %.3f ms (artifact calls 1-2: %.1f / %.1f ms); card %s" % (
            n_int8, export_s, size, nodes, load_s, INFER_CALLS, host["img"].shape[0],
            json.dumps(want_counts), launches, INFER_CALLS, record["predictor_wall_p50_ms"],
            record["artifact_wall_p50_ms"], a_walls[0], a_walls[1], card))
    return launches, record


def deploy_resnet50(torch, card, readings):
    """The CNN deployment path (tools/profile_deploy.py): ResNet-50 at its
    published widths (3 x 224 x 224, 1000 classes, random weights from
    SEED), f32, synthetic batches staged on the card. Quantization-aware
    training (the quantize_training pass) under Momentum(0.1, 0.9) at batch
    64: the warmup, the capture and 6 graph steps, every loss finite, the
    first 3 losses op by op bit for bit; beside it the f32 program's 8
    steps (the gap is the fake quantize / dequantize ops' cost). Then
    DEPLOY_STATS_STEPS QAT steps at learning rate 0 re-estimate
    batch_norm's running statistics, and the five inference legs at batch
    128 run on those parameters, each with DEPLOY_CALLS graph-path calls
    and one op by op (bit for bit, the same counters): (b) within the fold
    bar of (a), (c) bit for bit with (b), (e) within DEPLOY_INT8_TOL of (d)
    run once more with cuDNN off (its f32 convolutions over integer levels
    then sum exactly, as (e)'s int32 sums do; (d)'s own difference is
    reported), (e)'s top-1 agreement with (a) reported; leg (e) launches the quant GEMM once per int8_conv2d (53)
    every call, and the kernel is held against its plain version bit for
    bit on every im2col product its op-by-op run gave it, the stem's and
    two 3 x 3 convolutions' timed beside torch._int_mm. Returns the quant
    GEMM's launches over leg (e)'s graph-path calls."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.ops import quant_gemm as qg
    from paddle_tpu_torch.tools import profile_deploy as dep
    from paddle_tpu_torch.tools import profile_training as prof

    _explicit_bn_grad()
    cfg = dep.RESNET50
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    plain, qat = dep.build(cfg, qat=False), dep.build(cfg, qat=True)
    n_fake = sum(op.type == "fake_quantize_abs_max" for op in qat["main"].global_block().ops)
    staged = dep.feeds(cfg, device, cfg["train_batch"])
    feeds = [staged[i % len(staged)] for i in range(DEPLOY_STEPS)]
    train = {}
    train["qat"], outs, step, scope = _deploy_train(torch, prof, registry, qat, feeds,
                                                    cfg["train_batch"])
    # batch_norm's running statistics trail the weights (momentum 0.9) and
    # a test-mode ResNet-50 on stale ones grows its activations block by
    # block, so a deployment re-estimates them: steps at learning rate 0
    # keep the weights as trained and bring the statistics to theirs
    for op in qat["main"].global_block().ops:
        if op.type == "momentum":
            lr = op.input("LearningRate")[0]
            scope.set_var(lr, torch.zeros_like(scope.find_var(lr)))
    weights = {p.name: scope.find_var(p.name).clone()
               for p in qat["main"].global_block().all_parameters() if p.trainable}
    t_stats = time.perf_counter()
    for i in range(DEPLOY_STATS_STEPS):
        step(feeds[i % len(feeds)])
    torch.cuda.synchronize()
    t_stats = time.perf_counter() - t_stats
    for name, w in weights.items():
        if not torch.equal(scope.find_var(name), w):
            raise AssertionError("deploy: %s moved at learning rate 0" % name)
    state = {n: scope.find_var(n) for n, v in qat["main"].global_block().vars.items()
             if v.persistable and scope.find_var(n) is not None}
    del step, scope, weights
    eager, _, e_deltas, _, _, _ = _fluid_run(torch, qat, feeds[:COMPARE_STEPS], "",
                                             [qat["loss"]], per_op=True)
    _same_bits("deploy qat loss, graph against op by op, step", [o[0] for o in eager],
               [o[0] for o in outs[:COMPARE_STEPS]])
    train["f32"], _, step, scope = _deploy_train(torch, prof, registry, plain, feeds,
                                                 cfg["train_batch"])
    del step, scope, staged, feeds
    torch.cuda.empty_cache()
    log("deploy resnet50 train: ResNet-50 (3 x 224 x 224, 1000 classes), Momentum(%g, %g), f32, "
        "batch %d, quantize_training (%d fake_quantize_abs_max ops): %s; the first %d losses bit "
        "for bit op by op; then %d steps at learning rate 0 in %.1f s re-estimate batch_norm's "
        "running statistics, the weights unchanged; the f32 program: %s; QAT / f32 step wall "
        "%.3f; card %s" % (
            cfg["lr"], cfg["momentum"], cfg["train_batch"], n_fake, json.dumps(train["qat"]),
            COMPARE_STEPS, DEPLOY_STATS_STEPS, t_stats, json.dumps(train["f32"]),
            train["qat"]["step_p50_ms"] / train["f32"]["step_p50_ms"], card))

    infer_feed = dep.feeds(cfg, device, cfg["infer_batch"], n=1, seed=SEED + 1)[0]
    legs = dep.inference_legs(plain, qat, state, CUDAPlace(0))
    del state
    fetch = plain["logits"].name
    n_int8 = dep.int8_conv_count(legs["e"][0])
    if n_int8 != RESNET50_INT8_CONVS or dep.int8_conv_count(legs["e"][0], grouped=True):
        raise AssertionError("leg (e) holds %d int8_conv2d ops with groups == 1, want %d"
                             % (n_int8, RESNET50_INT8_CONVS))
    results, logits, rec = {}, {}, None
    launches = 0
    # (d)'s f32 convolutions over integer levels, cuDNN's algorithms off
    # (the native im2col GEMM sums the integer products exactly while a
    # partial sum stays under 2^24): the same program computing what (e)'s
    # exact int32 sums compute, where cuDNN's choice (a Winograd transform
    # for a 3 x 3) rounds
    logits["d_exact"] = _exact_conv_run(torch, *legs["d"], infer_feed, fetch)
    for leg in dep.LEGS:
        prog, scope = legs[leg]
        results[leg], logits[leg], r = _deploy_leg(torch, dep, prof, registry, leg, prog, scope,
                                                   infer_feed, fetch, n_int8)
        results[leg]["name"] = dep.LEG_NAMES[leg]
        log("deploy resnet50 leg (%s) %s, batch %d: %s; card %s" % (
            leg, dep.LEG_NAMES[leg], cfg["infer_batch"], json.dumps(results[leg]), card))
        if leg == "e":
            rec = r
            launches = results[leg]["launches"].get("quant_gemm_int8", 0)
        torch.cuda.empty_cache()
    art_launches, artifact = _deploy_artifact(torch, *legs["e"], infer_feed, fetch, n_int8,
                                              logits["e"], card)
    del legs
    diff = {}
    for got, want in (("b", "a"), ("c", "b"), ("e", "d"), ("d_exact", "d"), ("e", "d_exact"),
                      ("e", "a")):
        d = np.abs(logits[got] - logits[want])
        diff["%s-%s" % (got, want)] = {"max_abs": float(d.max()), "max_rel": float(
            (d / np.maximum(np.abs(logits[want]), 1e-30)).max()),
            "max_abs_logit": float(np.abs(logits[want]).max())}
    top1 = float((logits["e"].argmax(1) == logits["a"].argmax(1)).mean())
    log("deploy resnet50: logits across legs %s; top-1 agreement of (e) with (a) %.4f; card %s"
        % (json.dumps(diff), top1, card))
    rtol, atol = DEPLOY_FOLD_TOL
    if not np.allclose(logits["b"], logits["a"], rtol=rtol, atol=atol):
        raise AssertionError("leg (b) against (a): %s (rtol %g atol %g)" % (diff["b-a"], rtol,
                                                                              atol))
    if logits["c"].tobytes() != logits["b"].tobytes():
        raise AssertionError("leg (c) against (b): %s, want bit for bit" % diff["c-b"])
    if not np.allclose(logits["e"], logits["d_exact"], rtol=DEPLOY_INT8_TOL,
                       atol=DEPLOY_INT8_TOL):
        raise AssertionError("leg (e) against (d) with exact convolution sums: %s (rtol = atol "
                             "= %g)" % (diff["e-d_exact"], DEPLOY_INT8_TOL))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    held, timed = _hold_im2col(torch, qg, rec, flush)
    del rec, flush
    torch.cuda.empty_cache()
    # the int8_mul fc head: no pass pipeline tags int8 chains on this path,
    # and the gemm_int8 family's block rule declines n = 1000 in any case
    head_taken = fused.quant_gemm_path_taken(cfg["infer_batch"], cfg["classes"], 2048,
                                             torch.int8)
    readings["deploy_resnet50"] = {"train": train, "legs": results, "logits": diff,
                                   "top1_e_vs_a": top1, "quant_gemm_im2col": timed,
                                   "artifact": artifact}
    for name, t in timed.items():
        log("deploy resnet50: quant_gemm_kernel at %s's im2col product (%d, %d) @ (%d, %d), no "
            "bias, scale 1.0: kernel %.4f ms (device, cold L2), plain (float64 product) %.4f ms, "
            "torch._int_mm %.4f ms (kernel / _int_mm %.3f), bound %.4f ms (%s); card %s" % (
                name, t["m"], t["k"], t["k"], t["n"], t["ms"], t["plain_ms"], t["int_mm_ms"],
                t["ms"] / t["int_mm_ms"], t["bound_ms"], t["bound_by"], card))
    log("deploy resnet50: quant_gemm_kernel bit for bit with its plain version on the %d im2col "
        "products of leg (e)'s first op-by-op run %s; %d launches a leg-(e) run (one per "
        "int8_conv2d with groups == 1), %d over its %d graph-path calls; the int8_mul fc head "
        "(128 x 2048 @ 2048 x 1000) takes the gemm_int8 family: %s (no pass pipeline tags int8 "
        "chains on this path, and quant_gemm_path_taken declines n = 1000 by the float GEMM's "
        "block rule), so it runs as the float64 int8_mul; built and run in %.1f s" % (
            len(held), json.dumps(held), n_int8, launches, DEPLOY_CALLS, head_taken,
            time.perf_counter() - t0))
    return {"quant_gemm_int8": launches + art_launches}


# ---------------------------------------------------------------- extra ops

EXTRA_TOL = 1e-4  # rtol, and atol as a share of max(1, the CPU result's largest magnitude)
EXTRA_REPLAYS = 3  # replays of each op's forward graph, timed by CUDA events


def _extra_cases(torch, device, seed):
    """(op type, inputs {slot: [tensor]}, attrs, comparison rows, {slot:
    batch axis}, source) of each forward op type of nn_extra_ops.py and
    compose_ops.py at a published model's shapes, one at a time, drawn on
    `device` from `seed`. The card runs each at these shapes; the CPU
    reference takes the first `rows` rows of the batch axis of the named
    slots (None: the whole inputs)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=device) * s

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=device, dtype=torch.int32)

    def lens(b, t):
        out = torch.randint(1, t + 1, (b,), generator=gen, device=device, dtype=torch.int32)
        out[0] = t
        return out

    b0 = {"X": 0}
    yield ("conv3d", {"Input": [r(8, 3, 16, 112, 112)], "Filter": [r(64, 3, 3, 3, 3, s=0.1)]},
           {"paddings": [1, 1, 1]}, 1, {"Input": 0}, "C3D conv1a (Tran et al. 2015), batch 8")
    yield ("conv3d_transpose", {"Input": [r(2, 128, 16, 16, 16)],
                                "Filter": [r(128, 128, 2, 2, 2, s=0.05)]},
           {"strides": [2, 2, 2]}, 1, {"Input": 0},
           "3D U-Net (Cicek et al. 2016) 2x2x2 up-convolution, 128 channels, batch 2")
    yield ("conv2d_transpose", {"Input": [r(64, 512, 4, 4)], "Filter": [r(512, 256, 4, 4,
                                                                          s=0.05)]},
           {"strides": [2, 2], "paddings": [1, 1]}, 1, {"Input": 0},
           "DCGAN generator ConvTranspose2d(512, 256, 4, 2, 1), batch 64")
    yield ("depthwise_conv2d_transpose", {"Input": [r(16, 21, 16, 16)],
                                          "Filter": [r(21, 1, 4, 4)]},
           {"strides": [2, 2], "groups": 21}, 1, {"Input": 0},
           "FCN-8s upscore2 (Long et al. 2015), group 21, batch 16")
    yield ("pool3d", {"X": [r(8, 64, 16, 112, 112)]},
           {"pooling_type": "max", "ksize": [1, 2, 2], "strides": [1, 2, 2]}, 1, b0,
           "C3D pool1 1x2x2 on conv1a's output, batch 8")
    yield ("max_pool2d_with_index", {"X": [r(4, 64, 360, 480)]},
           {"ksize": [2, 2], "strides": [2, 2]}, 1, b0,
           "SegNet pool1 on CamVid 360 x 480 (Badrinarayanan et al. 2017), batch 4")
    yield ("max_pool3d_with_index", {"X": [r(8, 128, 16, 56, 56)]},
           {"ksize": [2, 2, 2], "strides": [2, 2, 2]}, 1, b0, "C3D pool2 2x2x2, batch 8")
    pooled = r(4, 64, 180, 240)
    rows_, cols_ = torch.meshgrid(torch.arange(180, device=device),
                                  torch.arange(240, device=device), indexing="ij")
    idx = (rows_ * 960 + cols_ * 2 + ints(2, 4, 64, 180, 240) * 480
           + ints(2, 4, 64, 180, 240)).to(torch.int32)
    yield ("unpool", {"X": [pooled], "Indices": [idx]},
           {"ksize": [2, 2], "strides": [2, 2]}, 1, {"X": 0, "Indices": 0},
           "SegNet upsample4 (pool1's mask) to 360 x 480, batch 4")
    yield ("spp", {"X": [r(32, 256, 13, 13)]}, {"pyramid_height": 4, "pooling_type": "max"}, 1,
           b0, "SPP-net 4-level pyramid on conv5 maps (He et al. 2014), batch 32")
    yield ("maxout", {"X": [r(128, 384, 16, 16)]}, {"groups": 2}, 1, b0,
           "Maxout networks' CIFAR-10 conv layer, 2 pieces (Goodfellow et al. 2013)")
    yield ("group_norm", {"X": [r(32, 256, 56, 56)], "Scale": [r(256)], "Bias": [r(256)]},
           {"groups": 32, "epsilon": 1e-5}, 1, b0,
           "Group Normalization's ResNet-50 res2, 32 groups (Wu and He 2018), batch 32")
    yield ("affine_channel", {"X": [r(2, 256, 200, 336)], "Scale": [r(256)], "Bias": [r(256)]},
           {}, 1, b0, "Detectron's frozen-BN ResNet-50 res2 at 800 x 1333, 2 images")
    yield ("bilinear_tensor_product", {"X": [r(128, 100)], "Y": [r(128, 100)],
                                       "Weight": [r(4, 100, 100, s=0.1)], "Bias": [r(1, 4)]},
           {}, None, {}, "Neural Tensor Network (Socher et al. 2013), d 100, 4 slices")
    yield ("grid_sampler", {"X": [r(64, 3, 224, 224)],
                            "Grid": [torch.rand((64, 224, 224, 2), generator=gen,
                                                device=device) * 2.2 - 1.1]},
           {}, 1, {"X": 0, "Grid": 0}, "Spatial Transformer Networks at 224 x 224, batch 64")
    yield ("affine_grid", {"Theta": [r(64, 2, 3)]}, {"output_shape": [64, 3, 224, 224]}, None,
           {}, "Spatial Transformer Networks' affine grid at 224 x 224, batch 64")
    yield ("minus", {"X": [r(128, 4096)], "Y": [r(128, 4096)]}, {}, None, {},
           "VGG-16 fc7 features, batch 128")
    yield ("l1_norm", {"X": [r(4096, 4096, s=0.01)]}, {}, None, {}, "VGG-16 fc7's weight")
    yield ("squared_l2_distance", {"X": [r(1800, 128)], "Y": [r(1800, 128)]}, {}, None, {},
           "FaceNet 128-d embeddings, batch 1800 (Schroff et al. 2015)")
    yield ("selu", {"X": [r(128, 1024)]}, {}, None, {},
           "Self-normalizing networks' 1024-unit layers (Klambauer et al. 2017)")
    yield ("fill", {}, {"shape": [1000], "dtype": "float32", "value": r(1000).tolist()}, None,
           {}, "a 1000-class prior")
    yield ("is_empty", {"X": [r(128, 1000)]}, {}, None, {}, "ResNet-50's logits at batch 128")
    yield ("multiplex", {"X": [r(128, 1000), r(128, 1000), r(128, 1000)],
                         "Ids": [ints(3, 128, 1)]}, {}, None, {},
           "three 1000-class heads, batch 128")
    yield ("crop", {"X": [r(2, 21, 544, 544)]},
           {"shape": [2, 21, 500, 500], "offsets": [0, 0, 19, 19]}, None, {},
           "FCN-8s crop of upscore to 500 x 500 (Long et al. 2015), batch 2")
    yield ("pad_constant_like", {"X": [r(2, 21, 544, 544)], "Y": [r(2, 21, 500, 500)]},
           {"pad_value": 0.0}, None, {}, "FCN's 500 x 500 score padded to 544, batch 2")
    yield ("random_crop", {"X": [r(128, 3, 256, 256)],
                           "Seed": [torch.tensor([7], dtype=torch.int32, device=device)]},
           {"shape": [224, 224]}, None, {}, "ImageNet 256 -> 224 crop, batch 128")
    yield ("space_to_depth", {"X": [r(64, 64, 26, 26)]}, {"blocksize": 2}, 1, b0,
           "YOLOv2 passthrough (reorg) layer, 26 x 26 x 64 -> 13 x 13 x 256, batch 64")
    yield ("conv_shift", {"X": [r(64, 128)], "Y": [r(64, 3)]}, {}, None, {},
           "Neural Turing Machine shift weighting, 128 locations, shifts -1..1, batch 64")
    yield ("add_position_encoding", {"X": [r(16, 256, 512)]}, {"alpha": 1.0, "beta": 1.0}, 1,
           b0, "Transformer base, 16 x 256 tokens, d_model 512")
    yield ("mean_iou", {"Predictions": [ints(21, 16, 500, 500)],
                        "Labels": [ints(21, 16, 500, 500)]}, {"num_classes": 21}, None, {},
           "PASCAL VOC 21 classes at 500 x 500, batch 16")
    yield ("similarity_focus", {"X": [r(16, 3, 48, 48)]}, {"axis": 1, "indexes": [0, 2]}, None,
           {}, "the reference's similarity focus over 3 channels of 48 x 48 maps, batch 16")
    yield ("fc", {"Input": [r(128, 2048)], "W": [r(2048, 1000, s=0.02)], "Bias": [r(1000)]},
           {"in_num_col_dims": 1}, None, {}, "ResNet-50's head, 128 x 2048 -> 1000")
    yield ("fused_elemwise_activation", {"X": [r(128, 256, 56, 56)], "Y": [r(128, 256, 56, 56)]},
           {"functor_list": ["relu", "elementwise_add"]}, 1, {"X": 0, "Y": 0},
           "ResNet-50 res2's residual add + relu, batch 128")
    ssd = [(12, 19), (24, 10), (24, 5), (24, 3), (24, 2), (24, 1)]
    yield ("fusion_transpose_flatten_concat", {"X": [r(64, c, s_, s_) for c, s_ in ssd]},
           {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1, "concat_axis": 1}, 1,
           {"X": 0}, "MobileNet-SSD's six location heads, batch 64")
    h = 512
    seq = {"SeqLen": 0}
    yield ("lstm", {"Input": [r(64, 100, 4 * h)], "Weight": [r(h, 4 * h, s=0.05)],
                    "Bias": [r(1, 4 * h)], "SeqLen": [lens(64, 100)]},
           {"use_peepholes": False}, 1, dict(seq, Input=0), "the train lstm phase's widths")
    yield ("gru", {"Input": [r(64, 16, 3 * h)], "Weight": [r(h, 3 * h, s=0.05)],
                   "Bias": [r(1, 3 * h)], "SeqLen": [lens(64, 16)]}, {}, 1,
           dict(seq, Input=0), "the train nmt phase's GRU widths")
    yield ("lstmp", {"Input": [r(64, 100, 4 * h)], "Weight": [r(256, 4 * h, s=0.05)],
                     "ProjWeight": [r(h, 256, s=0.05)], "Bias": [r(1, 4 * h)],
                     "SeqLen": [lens(64, 100)]}, {"proj_activation": "tanh"}, 1,
           dict(seq, Input=0), "the train lstm phase's widths, a 256-wide projection")
    from paddle_tpu_torch.ops.compose_ops import cudnn_lstm_weight_size

    yield ("cudnn_lstm", {"Input": [r(100, 64, h)],
                          "W": [r(cudnn_lstm_weight_size(h, h, 2), s=0.05)]},
           {"hidden_size": h, "num_layers": 2}, 1, {"Input": 1},
           "the train lstm phase's widths, 2 layers")
    yield ("fusion_lstm", {"X": [r(64, 100, h)], "WeightX": [r(h, 4 * h, s=0.05)],
                           "WeightH": [r(h, 4 * h, s=0.05)], "Bias": [r(1, 4 * h)],
                           "SeqLen": [lens(64, 100)]}, {"use_peepholes": False}, 1,
           dict(seq, X=0), "the train lstm phase's widths")
    yield ("fusion_gru", {"X": [r(64, 16, h)], "WeightX": [r(h, 3 * h, s=0.05)],
                          "WeightH": [r(h, 3 * h, s=0.05)], "SeqLen": [lens(64, 16)]}, {}, 1,
           dict(seq, X=0), "the train nmt phase's GRU widths")
    yield ("fused_embedding_fc_lstm", {"Ids": [ints(30000, 64, 100, 1)],
                                       "Embeddings": [r(30000, 4 * h, s=0.05)],
                                       "WeightH": [r(h, 4 * h, s=0.05)], "Bias": [r(1, 4 * h)],
                                       "SeqLen": [lens(64, 100)]}, {"use_peepholes": False}, 1,
           dict(seq, Ids=0), "the train lstm phase's vocabulary and widths")
    yield ("fusion_seqconv_eltadd_relu", {"X": [r(64, 100, 300)], "Filter": [r(900, 100,
                                                                               s=0.05)],
                                          "Bias": [r(100)], "SeqLen": [lens(64, 100)]},
           {"contextLength": 3, "contextStart": -1}, 1, dict(seq, X=0),
           "Kim (2014)'s text CNN: 300-d embeddings, 100 filters of width 3")
    yield ("fusion_seqexpand_concat_fc", {"X": [r(64, 100, h), r(64, h)],
                                          "FCWeight": [r(2 * h, h, s=0.05)],
                                          "FCBias": [r(h)]}, {"fc_activation": "tanh"}, 1,
           {"X": 0}, "the train lstm phase's widths")
    yield ("attention_lstm", {"X": [r(64, 100, h)], "SeqLen": [lens(64, 100)],
                              "AttentionWeight": [r(2 * h, 1, s=0.05)],
                              "LSTMWeight": [r(2 * h, 4 * h, s=0.05)],
                              "LSTMBias": [r(1, 4 * h)]}, {}, 1, dict(seq, X=0),
           "the train lstm phase's widths")
    yield ("conv2d_fusion", {"Input": [r(128, 64, 56, 56)], "Filter": [r(64, 64, 3, 3, s=0.05)],
                             "Bias": [r(64)], "ResidualData": [r(128, 64, 56, 56)]},
           {"paddings": [1, 1], "activation": "relu"}, 1, {"Input": 0, "ResidualData": 0},
           "ResNet-50 res2's 3x3 conv + bias + residual + relu, batch 128")


def _rows(ins, rows, axes):
    """CPU copies of `ins`, the slots of `axes` cut to their first `rows`
    rows there (rows None: whole)."""
    return {s: [(v.narrow(axes[s], 0, rows) if rows is not None and s in axes else v)
                .contiguous().cpu() for v in vs] for s, vs in ins.items()}


def _extra_grad_ins(registry, op, ins, attrs, outs, seed, randn):
    """(grad op type, its inputs, attrs) of one op's backward: the explicit
    max-pool grads through the mask, else the generic grad with cotangents
    `randn(shape, seed)` on every floating output (`outs`: numpy arrays or
    tensors, as `ins`)."""
    if op in ("max_pool2d_with_index", "max_pool3d_with_index"):
        dy = randn(tuple(outs["Out"][0].shape), seed)
        return op + "_grad", {"X": ins["X"], "Mask": [outs["Mask"][0]], "Out@GRAD": [dy]}, attrs
    cots = {s: [randn(tuple(v.shape), seed + j) for j, v in enumerate(vs)]
            for s, vs in outs.items() if all(_floating(v) for v in vs)}
    meta = {registry.FWD_IN_SLOTS_ATTR: list(ins), registry.FWD_OUT_SLOTS_ATTR: list(cots)}
    gins = dict(ins)
    gins.update({s + "@GRAD": vs for s, vs in cots.items()})
    return op + "_grad", gins, dict(attrs, **meta)


def _floating(v):
    return np.issubdtype(v.dtype, np.floating) if isinstance(v, np.ndarray) else \
        v.dtype.is_floating_point


def _cpu_randn(shape, seed):
    import torch

    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _extra_close(name, got, want):
    worst = 0.0
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            if g.shape != w.shape:
                raise AssertionError("%s %s: shape %s, want %s" % (name, slot, g.shape, w.shape))
            if np.issubdtype(w.dtype, np.floating):
                # spp's edge bins at pyramid level 3 hold only padding: -inf in
                # both packages, compared as equal
                fin = np.isfinite(w)
                scale = max(1.0, float(np.abs(w[fin]).max()) if fin.any() else 1.0)
                np.testing.assert_allclose(g, w, rtol=EXTRA_TOL, atol=EXTRA_TOL * scale,
                                           err_msg="%s %s" % (name, slot))
                if fin.any():
                    worst = max(worst, float(np.abs(g[fin] - w[fin]).max()) / scale)
            elif not np.array_equal(g, w):
                raise AssertionError("%s %s: %d of %d values differ" % (name, slot,
                                                                        int((g != w).sum()),
                                                                        w.size))
    return worst


def extra_ops(torch, card):
    """Each op type of nn_extra_ops.py and compose_ops.py (tools: the
    reference's op library beside the zoo) at a published model's shapes
    (_extra_cases): forward eager on the card, timed (host clock around the
    call and a sync), then captured alone in a CUDA graph and replayed
    (CUDA events); its backward (the generic grad, or max_pool*_with_index's
    explicit grad op through the mask) eager on the card, timed; then both
    against the CPU on the same inputs (the first rows of the batch where
    the CPU would take long): floats within EXTRA_TOL, integers exactly;
    random_crop's output a window of its input at one offset for the whole
    batch; each replay bit for bit with the eager run."""
    from paddle_tpu_torch.executor import _on_capture_stream
    from paddle_tpu_torch.ops import registry

    device = torch.device("cuda", 0)
    rows_out, done = {}, set()

    def to(ins, dev):
        return {s: [(v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(dev)
                    for v in vs] for s, vs in ins.items()}

    def np_outs(outs):
        return {s: [v.detach().cpu().numpy() for v in vs] for s, vs in outs.items()}

    def dev_randn(shape, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device)

    def run(op, ins, attrs, dev):
        ctx = _lower_ctx(torch, registry, dev)
        return registry.get(op).lower(ctx, to(ins, dev), dict(attrs))

    for i, (op, static, attrs, rows, axes, source) in enumerate(
            _extra_cases(torch, device, SEED + 7)):
        opdef = registry.get(op)
        lower = opdef.lower
        ctx = _lower_ctx(torch, registry, device)
        with _on_capture_stream(device):
            lower(ctx, static, dict(attrs))  # warm: caches, the library's first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _on_capture_stream(device):
            eager = lower(ctx, static, dict(attrs))
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        graph = torch.cuda.CUDAGraph()
        if opdef.stochastic:
            graph.register_generator_state(ctx.device_generator)
        with _on_capture_stream(device) as stream:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                captured = lower(ctx, static, dict(attrs))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graph.replay()
        start.record()
        for _ in range(EXTRA_REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end) / EXTRA_REPLAYS
        row = {"source": source, "forward_ms": fwd_ms, "replay_ms": replay_ms,
               "shapes": {s: [list(v.shape) for v in vs] for s, vs in static.items()}}
        if not opdef.stochastic:
            for slot in eager:
                for g, e in zip(captured[slot], eager[slot]):
                    if g.detach().cpu().numpy().tobytes() != e.detach().cpu().numpy().tobytes():
                        raise AssertionError("%s %s: the replay differs from the eager run"
                                             % (op, slot))
        else:  # random_crop: a window of the input at one offset, for every row
            x, out = static["X"][0], captured["Out"][0]
            hs, ws = attrs["shape"]
            hits = [(a, b) for a in range(x.shape[2] - hs + 1) for b in range(x.shape[3] - ws + 1)
                    if torch.equal(out[:, :, 0, 0], x[:, :, a, b])
                    and torch.equal(out, x[:, :, a:a + hs, b:b + ws])]
            if len(hits) != 1:
                raise AssertionError("random_crop: the output is a window at %s" % hits)
            row["offset"] = list(hits[0])
        del graph, captured
        grad_op = None
        if not opdef.no_grad:
            # the full-size backward's cotangents are drawn on the card
            grad_op, gstatic, gattrs = _extra_grad_ins(registry, op, static, attrs, eager,
                                                       SEED + i, dev_randn)
            gctx = _lower_ctx(torch, registry, device)
            registry.get(grad_op).lower(gctx, gstatic, dict(gattrs))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            registry.get(grad_op).lower(gctx, gstatic, dict(gattrs))
            torch.cuda.synchronize()
            row["backward_ms"] = (time.perf_counter() - t0) * 1e3
            del gstatic
        del eager
        if op != "random_crop":
            cins = _rows(static, rows, axes)
            want, got = np_outs(run(op, cins, attrs, "cpu")), np_outs(run(op, cins, attrs,
                                                                          device))
            row["max_err_fwd"] = _extra_close(op, got, want)
            if grad_op is not None:
                _, gins, gattrs = _extra_grad_ins(registry, op, cins, attrs, want, SEED + i,
                                                  _cpu_randn)
                gwant = np_outs(run(grad_op, gins, gattrs, "cpu"))
                ggot = np_outs(run(grad_op, gins, gattrs, device))
                row["max_err_grad"] = _extra_close(grad_op, ggot, gwant)
            row["cpu_rows"] = rows
        rows_out[op] = row
        del static
        done.update([op] + ([grad_op] if grad_op in ("max_pool2d_with_index_grad",
                                                     "max_pool3d_with_index_grad") else []))
        torch.cuda.empty_cache()
    if len(done) != 46:
        raise AssertionError("extra ops: %d op types run, want 46: %s" % (len(done),
                                                                          sorted(done)))
    log("extra ops: the %d op types of nn_extra_ops.py and compose_ops.py at published shapes "
        "on the card against the CPU (floats within rtol %g, atol %g of max(1, max |x|); "
        "integers exactly; forward and backward), each forward captured alone and replayed bit "
        "for bit (ms; errors over max(1, max |x|)): %s; card %s" % (
            len(done), EXTRA_TOL, EXTRA_TOL, json.dumps(
                {k: {f: (v if f.startswith("max_err") or not isinstance(v, float)
                         else round(v, 4)) for f, v in r.items() if f not in ("shapes", "source")}
                 for k, r in rows_out.items()}), card))
    log("extra ops sources and shapes: %s" % json.dumps(
        {k: [r["source"], r["shapes"]] for k, r in rows_out.items()}))
    return rows_out


def host_ops(torch, card):
    """Host ops on the graph path: a Print between two device segments
    fires on each of 3 runs (the second captures, the third replays);
    FLAGS_check_nan_inf raises on a NaN feed at a replay, naming the
    variable and its last writer; a save_combine program and a
    load_combine program round-trip a scope bit for bit; a program holding
    the eight reader markers (read, the create_*_reader ops, open_files)
    runs on the graph path and fetches what it computes."""
    import io as _io
    import tempfile

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, fluid, scope_guard

    # the program as built: a pass pipeline's dead-code elimination drops a
    # print whose output nothing reads, in both packages
    flags.set_flags({"pass_pipeline": ""})
    place = CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 8], dtype="float32", append_batch_size=False)
        y = fluid.layers.log(fluid.layers.scale(x, scale=2.0))
        printed = fluid.layers.Print(y, message="host_ops probe", summarize=4)
        out = fluid.layers.reduce_sum(fluid.layers.scale(printed, scale=3.0))
    xv = np.random.RandomState(SEED).rand(4, 8).astype("float32") + 0.5
    scope, exe = Scope(seed=SEED, place=place), Executor(place)
    buf = _io.StringIO()
    with scope_guard(scope), contextlib.redirect_stdout(buf):
        from paddle_tpu_torch.ops import fused

        fused.reset_stats()
        got = [float(exe.run(main, feed={"x": xv}, fetch_list=[out])[0].reshape(-1)[0])
               for _ in range(3)]
        stats = Executor.stats()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("host_ops probe")]
    if len(lines) != 3 or stats["graphs"] != {"captures": 2, "replays": 4}:
        raise AssertionError("print: %d lines over 3 runs, graphs %s" % (len(lines),
                                                                         stats["graphs"]))
    want = float((np.log(2 * xv) * 3).sum())
    if not np.allclose(got, want, rtol=1e-5):
        raise AssertionError("print program: %s, want %s" % (got, want))
    bad = xv.copy()
    bad[0, 0] = -1.0
    flags.set_flags({"check_nan_inf": True})
    try:
        with scope_guard(scope), contextlib.redirect_stdout(_io.StringIO()):
            exe.run(main, feed={"x": bad}, fetch_list=[out])
        raise AssertionError("check_nan_inf did not raise on a NaN feed")
    except FloatingPointError as e:
        msg = str(e)
    finally:
        flags.set_flags({"check_nan_inf": False})
    if "last written by op reduce_sum:%s" % out.name not in msg:
        raise AssertionError("check_nan_inf: %r names no variable and writer" % msg)

    # save_combine / load_combine of a trained-size scope
    params = {"w%d" % i: torch.randn(256, 512, device="cuda") for i in range(4)}
    params["steps"] = torch.arange(7, dtype=torch.int32, device="cuda")
    params["half"] = torch.randn(64, 64, device="cuda").to(torch.bfloat16)
    path = os.path.join(tempfile.mkdtemp(), "ckpt")
    save, load = fluid.Program(), fluid.Program()
    for prog, op_type, slots in ((save, "save_combine", ("X", None)),
                                 (load, "load_combine", (None, "Out"))):
        blk = prog.global_block()
        for n, v in params.items():
            blk.create_var(name=n, shape=tuple(v.shape), dtype=str(v.dtype).split(".")[-1],
                           persistable=True)
        blk.append_op(type=op_type, inputs={slots[0]: list(params)} if slots[0] else {},
                      outputs={slots[1]: list(params)} if slots[1] else {},
                      attrs={"file_path": path})
    s1, s2 = Scope(seed=SEED, place=place), Scope(seed=SEED, place=place)
    s1.vars.update(params)
    with scope_guard(s1):
        exe.run(save)
    with scope_guard(s2):
        exe.run(load)
    for n, v in params.items():
        if s2.vars[n].dtype != v.dtype or not torch.equal(s2.vars[n], v):
            raise AssertionError("save_combine / load_combine: %s differs" % n)

    # the reader ops are markers: a program holding all eight runs on the
    # graph path and fetches what it computes (4 x 4 x 1.0 = 16)
    markers = ("read", "create_custom_reader", "create_recordio_file_reader",
               "create_shuffle_reader", "create_batch_reader", "create_double_buffer_reader",
               "create_py_reader", "open_files")
    prog, start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, start):
        total = fluid.layers.reduce_sum(fluid.layers.fill_constant(shape=[4, 4], dtype="float32",
                                                                   value=1.0))
        blk = prog.global_block()
        for i, t in enumerate(markers):
            blk.create_var(name="reader_%d" % i, shape=[1], dtype="float32")
            blk.create_var(name="batch_%d" % i, shape=[4, 4], dtype="float32")
            blk.append_op(type=t, inputs={"Reader": ["reader_%d" % i]},
                          outputs={"Out": ["batch_%d" % i]}, attrs={})
    fused.reset_stats()
    with scope_guard(Scope(seed=SEED, place=place)):
        read = [float(exe.run(prog, fetch_list=[total])[0].reshape(-1)[0]) for _ in range(3)]
    rstats = Executor.stats()["graphs"]
    if read != [16.0] * 3 or rstats != {"captures": 1, "replays": 2}:
        raise AssertionError("reader markers: fetched %s, graphs %s" % (read, rstats))
    log("host ops: print fired on each of 3 graph-path runs (%s), graphs %s; check_nan_inf on a "
        "NaN feed at a replay raised: %s; save_combine / load_combine round-tripped %d vars "
        "(f32, int32, bf16) bit for bit; a program holding the %d reader markers fetched %s over "
        "3 graph-path runs (graphs %s); card %s" % (
            json.dumps(lines[-1]), json.dumps(stats["graphs"]), json.dumps(msg), len(params),
            len(markers), read, json.dumps(rstats), card))


# ---------------------------------------------------------------- train parallel

PE_STEPS = 6  # ParallelExecutor steps of Transformer base (the warmup and the capture among them)
PE_DEEPFM_STEPS = 4  # DeepFM steps a build, use_distributed off and on
RING_CHUNKS = 4
RING_OUT_TOL = 1e-5  # out and lse of the ring's per-step path against the whole sequence
RING_GRAD_TOL = 1e-4  # grads: rtol, and atol as a share of the largest


def _pe_steps(torch, cfg, batches, check=None, reduce=False, rules=False):
    """Transformer `cfg` under training_fused through a ParallelExecutor on
    this process's card (ZeRO-1 with `reduce`; with `rules`, the Megatron
    sharding rules of profile_training.tp_rules), from a Scope seeded with
    SEED: (losses, walls, the step function, the PE)."""
    from paddle_tpu_torch import (BuildStrategy, CUDAPlace, Executor, ParallelExecutor, Scope,
                                  scope_guard)
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_training as prof

    place = CUDAPlace(torch.cuda.current_device())
    main_prog, startup, loss = prof.build(cfg)
    scope = Scope(seed=SEED, place=place)
    with scope_guard(scope):
        Executor(place).run(startup)
    strategy = BuildStrategy()
    strategy.pass_pipeline = "training_fused"
    if reduce:
        strategy.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    if rules:
        strategy.sharding_rules = prof.tp_rules(main_prog)
    pe = ParallelExecutor(loss_name=loss.name, main_program=main_prog, build_strategy=strategy,
                          scope=scope)

    def step(feed):
        return pe.run(fetch_list=[loss.name], feed=feed)

    losses, walls = [], []
    for i, feed in enumerate(batches):
        before = fused.stats()
        t0 = time.perf_counter()
        (val,) = step(feed)
        walls.append((time.perf_counter() - t0) * 1e3)
        if check is not None:
            check(i, before, fused.stats())
        losses.append(np.asarray(val).reshape(-1)[0])
    return losses, walls, step, pe


def _deepfm_losses(torch, cfg, batches, use_distributed, mesh_config=None):
    """DeepFM `cfg` (sparse tables) through the ParallelExecutor from a
    Scope seeded with SEED: (losses, fm_emb whole, distributed lookups)."""
    from paddle_tpu_torch import CUDAPlace, Executor, ParallelExecutor, Scope, scope_guard
    from paddle_tpu_torch.parallel import collectives
    from paddle_tpu_torch.tools import profile_recsys as recsys

    model = recsys.build_deepfm(cfg, True, use_distributed=use_distributed)
    place = CUDAPlace(torch.cuda.current_device())
    scope = Scope(seed=SEED, place=place)
    with scope_guard(scope):
        Executor(place).run(model["startup"])
    pe = ParallelExecutor(loss_name=model["loss"].name, main_program=model["main"], scope=scope,
                          mesh_config=mesh_config)
    losses = [pe.run([model["loss"].name], feed=f)[0].reshape(-1)[0] for f in batches]
    n_dist = [op.type for op in model["main"].global_block().ops].count(
        "distributed_lookup_table")
    return losses, collectives.gathered_state(scope, "fm_emb"), n_dist


def _pe_rank_main(rank, world, store):
    """One rank of the multi-card leg (a process a card, NCCL): Transformer
    base at dp = world, AllReduce then ZeRO-1; DeepFM at ep = world against
    the local build on this card. Prints its record as JSON."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.parallel import MeshConfig, init_distributed
    from paddle_tpu_torch.tools import profile_recsys as recsys
    from paddle_tpu_torch.tools import profile_training as prof

    init_distributed(store=dist.FileStore(store, world), world_size=world, rank=rank,
                     backend="nccl")
    try:
        cfg = prof.BASE
        batches = [prof.make_batch(cfg, SEED + i) for i in range(PE_STEPS)]
        losses, walls, step, pe = _pe_steps(torch, cfg, batches)
        mesh = pe.mesh.shape
        # every rank runs the profiled steps (their collectives pair up)
        split = prof.profile_steps(step, batches[2:4], registry)
        by_kernel = split["device_ms_per_step_by_kernel"]
        nccl = {k[:60]: v for k, v in by_kernel.items() if "nccl" in k.lower()}
        profile = {"device_busy_ms": split["device_busy_ms_per_step"],
                   "device_launches": split["device_launches_per_step"],
                   "wall_ms_p50": split["wall_ms_p50"], "nccl": nccl,
                   "top": [(k[:50], round(v["ms"], 4)) for k, v in list(by_kernel.items())[:6]]}
        del step, pe
        z1, z1_walls, _, pe = _pe_steps(torch, cfg, batches[:COMPARE_STEPS], reduce=True)
        shards = len(pe._scope.row_shards)
        del pe
        torch.cuda.empty_cache()
        rcfg = recsys.RECSYS
        rb = recsys.recsys_batches(np.random.RandomState(SEED), rcfg["rows"], rcfg["fields"],
                                   rcfg["batch"], PE_DEEPFM_STEPS)
        local, local_emb, _ = _deepfm_losses(torch, rcfg, rb, False,
                                             MeshConfig(dp=1, ep=world))
        dist_l, dist_emb, n_dist = _deepfm_losses(torch, rcfg, rb, True,
                                                  MeshConfig(dp=1, ep=world))
        print(json.dumps({
            "rank": rank, "mesh": mesh, "losses": [float(v) for v in losses], "walls": walls,
            "profile": profile,
            "zero1": [float(v) for v in z1], "zero1_walls": z1_walls, "zero1_shards": shards,
            "deepfm_local": [float(v) for v in local], "deepfm_ep": [float(v) for v in dist_l],
            "deepfm_tables_equal": bool(torch.equal(local_emb, dist_emb)),
            "deepfm_distributed_ops": n_dist}))
    finally:
        dist.destroy_process_group()


_PE_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke._pe_rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[2])
"""


def _pe_ranks(world):
    """The multi-card leg at world = the visible cards, a process a card:
    each rank's record."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pe_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _PE_RANK, os.path.dirname(os.path.abspath(__file__)), store,
             str(r), str(world)], env=dict(os.environ, LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            done = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.communicate()
        for r, (pr, (out, err)) in enumerate(zip(procs, done)):
            if pr.returncode != 0:
                raise AssertionError("PE rank %d failed:\n%s" % (r, err[-4000:]))
        return [json.loads(out.strip().splitlines()[-1]) for out, _ in done]


def _nccl_kernels(by_kernel):
    return {k[:60]: v["launches"] for k, v in by_kernel.items() if "nccl" in k.lower()}


def _nccl_in_graph(torch, card):
    """One all-reduce over the world group captured in a CUDA graph beside
    an add, replayed: its node runs in every replay, and the values are the
    sum over the world."""
    import torch.distributed as dist

    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.tools import profile_training as prof

    world = dist.get_world_size()
    buf = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the communicator exists before the capture
        dist.all_reduce(buf)
        buf.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dist.all_reduce(buf)
        buf.add_(1.0)
    buf.copy_(torch.arange(1 << 20, dtype=torch.float32, device="cuda"))
    want = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        graph.replay()
        want = want * world + 1.0
    torch.cuda.synchronize()
    if not torch.equal(buf, want):
        raise AssertionError("the captured all-reduce gave %s, want %s" % (buf[:4], want[:4]))
    def replay():
        t0 = time.perf_counter()
        graph.replay()
        return [(time.perf_counter() - t0) * 1e3]

    split = prof.profile_window(replay, 1, registry)
    nodes = _nccl_kernels(split["device_ms_per_step_by_kernel"])
    log("train parallel: an NCCL all-reduce of 4 MiB captured in a CUDA graph at world %d, "
        "replayed 3 times bit for bit (sum over the world, then + 1); its NCCL kernels a replay "
        "%s; card %s" % (world, json.dumps(nodes), card))


def _ring_per_step(torch, card):
    """The ring's per-step forward and backward (flash kernels) over
    RING_CHUNKS sequence chunks held in one process, at train_flash's
    widths, against flash_forward / flash_backward over the whole sequence."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.ring_attention import ring_backward_chunks, ring_forward_chunks
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = prof.BASE_FLASH
    b, h, t, d = cfg["batch"], cfg["n_head"], cfg["t"], cfg["d_key"]
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for causal in (False, True):
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda") for _ in range(4))
        out, lse = fa.flash_forward(q, k, v, causal, scale)
        dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, causal, scale)
        qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(RING_CHUNKS, 2)]
                           for x in (q, k, v, do))
        before = fa.kernel_launches()
        fwd = ring_forward_chunks(qs, ks, vs, causal, scale)
        outs, lses = [o for o, _ in fwd], [s for _, s in fwd]
        grads = ring_backward_chunks(qs, ks, vs, outs, lses, dos, causal, scale)
        torch.cuda.synchronize()
        after = fa.kernel_launches()
        moved = {k_: after[k_] - before[k_] for k_ in after if after[k_] != before[k_]}
        errs = {"out": float((torch.cat(outs, 2) - out).abs().max()),
                "lse": float((torch.cat(lses, 2) - lse).abs().max())}
        if max(errs.values()) > RING_OUT_TOL:
            raise AssertionError("ring per-step forward, causal=%s: %s" % (causal, errs))
        for name, got, ref in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
            got = torch.cat(got, 2)
            lim = RING_GRAD_TOL * ref.abs() + RING_GRAD_TOL * float(ref.abs().max())
            if not bool(((got - ref).abs() <= lim).all()):
                raise AssertionError("ring per-step %s, causal=%s: max abs err %g" % (
                    name, causal, float((got - ref).abs().max())))
            errs[name] = float((got - ref).abs().max())
        log("train parallel: ring attention's per-step path over %d chunks of %s, causal=%s, "
            "the flash kernels (launches %s) against flash_forward / flash_backward on the whole "
            "sequence: max abs err %s (out and lse within %g; grads within rtol %g and atol %g of "
            "the largest); card %s" % (RING_CHUNKS, (b, h, t // RING_CHUNKS, d), causal,
                                      json.dumps(moved), json.dumps(errs), RING_OUT_TOL,
                                      RING_GRAD_TOL, RING_GRAD_TOL, card))


def _deepfm_distributed(torch, card):
    """DeepFM at profile_recsys.RECSYS (a 2^20 x 32 table) through the
    ParallelExecutor at ep = 1: use_distributed=True equals
    use_distributed=False bit for bit, losses and tables."""
    from paddle_tpu_torch import CUDAPlace, Executor, ParallelExecutor, Scope, scope_guard
    from paddle_tpu_torch.tools import profile_recsys as recsys

    cfg = recsys.RECSYS
    batches = recsys.recsys_batches(np.random.RandomState(SEED), cfg["rows"], cfg["fields"],
                                    cfg["batch"], PE_DEEPFM_STEPS)
    got = {}
    for dist_ in (False, True):
        model = recsys.build_deepfm(cfg, True, use_distributed=dist_)
        place = CUDAPlace(torch.cuda.current_device())
        scope = Scope(seed=SEED, place=place)
        with scope_guard(scope):
            Executor(place).run(model["startup"])
        pe = ParallelExecutor(loss_name=model["loss"].name, main_program=model["main"],
                              scope=scope)
        losses = [pe.run([model["loss"].name], feed=f)[0].reshape(-1)[0] for f in batches]
        got[dist_] = (losses, scope.vars["fm_emb"].clone(), scope.vars["fm_first"].clone(),
                      [op.type for op in model["main"].global_block().ops].count(
                          "distributed_lookup_table"))
        del pe, scope, model
    _same_bits("deepfm use_distributed at ep = 1 against local, loss at step", got[True][0],
               got[False][0])
    for i, name in ((1, "fm_emb"), (2, "fm_first")):
        if not torch.equal(got[True][i], got[False][i]):
            raise AssertionError("deepfm use_distributed at ep = 1: %s differs" % name)
    if got[True][3] != 2 or got[False][3] != 0:
        raise AssertionError("deepfm: distributed_lookup_table ops %s" % [got[True][3],
                                                                          got[False][3]])
    log("train parallel: DeepFM %s through the ParallelExecutor at ep = 1, %d steps: "
        "use_distributed=True (2 distributed_lookup_table ops, the EmbeddingEngine's tables) "
        "equals use_distributed=False bit for bit, losses %s and both tables; card %s" % (
            json.dumps(cfg), PE_DEEPFM_STEPS, ["%.6f" % v for v in got[True][0]], card))
    del got
    torch.cuda.empty_cache()


def _multi_card(world, cfg, card, readings):
    """The multi-card leg's records held: every rank the same losses; the
    Transformer's first COMPARE_STEPS within the fused bar of the
    Executor's on one card, ZeRO-1 within it of AllReduce; DeepFM at ep =
    world equal to the local build bit for bit."""
    recs = _pe_ranks(world)
    r0 = recs[0]
    for rec in recs[1:]:
        for key in ("losses", "zero1", "deepfm_ep"):
            _same_bits("%s, rank %d against rank 0, step" % (key, rec["rank"]), rec[key],
                       r0[key])
    want = np.asarray(F32_FIRST["transformer"])
    for key, got in (("losses", r0["losses"][:COMPARE_STEPS]), ("zero1", r0["zero1"])):
        if not np.allclose(got, want, rtol=FUSED_RTOL, atol=FUSED_ATOL):
            raise AssertionError("PE at world %d, %s: %s against the Executor's %s"
                                 % (world, key, got, want.tolist()))
    _same_bits("DeepFM at ep = %d against the local build, step" % world, r0["deepfm_ep"],
               r0["deepfm_local"])
    if not all(r["deepfm_tables_equal"] for r in recs) or r0["deepfm_distributed_ops"] != 2:
        raise AssertionError("DeepFM at ep = %d: tables %s, lookups %d" % (
            world, [r["deepfm_tables_equal"] for r in recs], r0["deepfm_distributed_ops"]))
    prof0 = r0["profile"]
    if not prof0["nccl"]:
        raise AssertionError("PE at world %d: no NCCL kernel in a profiled step" % world)
    readings["train_parallel_cards"] = {"graph": dict(
        world=world, step_p50_ms=float(np.median(r0["walls"][2:])),
        zero1_step_ms=r0["zero1_walls"][-1], **prof0)}
    log("train parallel: Transformer base at world %d (a process a card, NCCL, mesh %s), "
        "global batch %d: losses %s, the first %d within rtol %g atol %g of the Executor's "
        "%s on one card; step wall p50 %.3f ms over steps 3-%d; rank 0's profiled step: "
        "device busy %s ms, %s launches, wall p50 %s ms, NCCL kernels (ms and launches a "
        "step) %s, top kernels %s; ZeRO-1 (%d state tensors "
        "sharded a rank) losses %s; DeepFM %s at ep = %d (1/%d of the table a card) equals "
        "the local build bit for bit, losses %s and the gathered table; every rank the same "
        "losses; card %s" % (
            world, json.dumps(r0["mesh"]), cfg["batch"], ["%.6f" % v for v in r0["losses"]],
            COMPARE_STEPS, FUSED_RTOL, FUSED_ATOL, ["%.6f" % v for v in want],
            float(np.median(r0["walls"][2:])), PE_STEPS, prof0["device_busy_ms"],
            prof0["device_launches"], prof0["wall_ms_p50"], json.dumps(prof0["nccl"]),
            json.dumps(prof0["top"]), r0["zero1_shards"],
            ["%.6f" % v for v in r0["zero1"]], "2^20 x 32", world, world,
            ["%.6f" % v for v in r0["deepfm_ep"]], card))


def train_parallel(torch, card, readings):
    """The data-parallel path at world = the visible cards, on NCCL and
    CUDA graphs: Transformer base under training_fused through the
    ParallelExecutor (at one card in this process, its first
    COMPARE_STEPS losses bit for bit the Executor phase's; past one card a
    process a card), the launches a step of the GEMM epilogue, layer_norm
    and Adam kernels and the NCCL kernels of its captured graph, its step
    wall beside the Executor's; an all-reduce captured in a CUDA graph;
    DeepFM at 2^20 x 32 with use_distributed at ep = 1 against local bit
    for bit; ring attention's per-step path; then, past one card, the
    multi-card legs (last, so that a fault there leaves every one-card
    reading in place). Returns the training kernels' launches over the PE's
    steps."""
    import tempfile

    import torch.distributed as dist

    from paddle_tpu_torch.ops import fused, registry
    from paddle_tpu_torch.parallel import init_distributed
    from paddle_tpu_torch.tools import profile_training as prof

    world = torch.cuda.device_count()
    cfg = prof.BASE
    batches = [prof.make_batch(cfg, SEED + i) for i in range(PE_STEPS)]
    with tempfile.TemporaryDirectory(prefix="pe_store_") as tmp:
        t0 = time.perf_counter()
        init_distributed(store=dist.FileStore(os.path.join(tmp, "store"), 1), world_size=1,
                         rank=0, backend="nccl")
        try:
            log("train parallel: process group up in %.2f s, backend %s, world %d" % (
                time.perf_counter() - t0, dist.get_backend(), dist.get_world_size()))
            fused.reset_stats()  # the main path's counting window opens here
            losses, walls, step, pe = _pe_steps(torch, cfg, batches, _launch_check(cfg))
            launches = fused.stats()["launches"]  # and closes here
            graphs = dict(fused.GRAPHS)
            _same_bits("PE (world 1) against the Executor phase, loss at step",
                       [float(v) for v in losses[:COMPARE_STEPS]], F32_FIRST["transformer"])
            split = prof.profile_steps(step, batches[2:4], registry)
            by_kernel = split["device_ms_per_step_by_kernel"]
            nccl = _nccl_kernels(by_kernel)
            exe_p50 = readings["train"]["graph"]["step_p50_ms"]
            pe_p50 = float(np.median(walls[2:]))
            per_kernel = {k: sum(v["launches"] for n, v in by_kernel.items() if k in n)
                          for k in ("gemm_bias_act_kernel", "ln_fwd_kernel", "ln_bwd_kernel",
                                    "multi_adam_kernel")}
            readings["train_parallel"] = {"graph": {
                "step_p50_ms": pe_p50, "executor_step_p50_ms": exe_p50,
                "device_busy_ms": split["device_busy_ms_per_step"],
                "device_launches": split["device_launches_per_step"],
                "nccl_kernels_a_step": sum(nccl.values()), "mesh": pe.mesh.shape}}
            log("train parallel: Transformer base %s through the ParallelExecutor at world 1 "
                "(NCCL, mesh %s), training_fused on CUDA graphs (%s), %d steps, losses %s, the "
                "first %d bit for bit the Executor phase's; kernel launches over the steps %s "
                "(a profiled step: %s); NCCL kernels in the captured step %s (dp = 1 averages "
                "nothing); step wall p50 %.3f ms over steps 3-%d against the Executor's %.3f ms "
                "(the train phase, this call); device busy %s ms a step, %s launches; card %s" % (
                    json.dumps(cfg), json.dumps(pe.mesh.shape), json.dumps(graphs), PE_STEPS,
                    ["%.6f" % v for v in losses], COMPARE_STEPS, json.dumps(launches),
                    json.dumps(per_kernel), json.dumps(nccl), pe_p50, PE_STEPS, exe_p50,
                    split["device_busy_ms_per_step"], split["device_launches_per_step"], card))
            del step, pe
            torch.cuda.empty_cache()
            _nccl_in_graph(torch, card)
            _deepfm_distributed(torch, card)
            _pe_world1_a6b(torch, card, readings)
        finally:
            dist.destroy_process_group()
    _ring_per_step(torch, card)
    if world > 1:
        torch.cuda.empty_cache()
        _multi_card(world, cfg, card, readings)
        _a6b_cards(world, card, readings)
        if world >= 4:
            _ring_cards(4, card, readings)
    return {k: launches[k] for k in _per_step(cfg)[0]}


# ---------------------------------------------------------------- A6b: steps_per_run, rules,
# tp / fsdp / pp on cards

MULTI_K = 4  # steps_per_run of the multi-step phase
MULTI_CALLS = 3  # its calls, against MULTI_K * MULTI_CALLS single runs
# the CUDA runtime calls that make the host wait for the card
HOST_SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                   "cudaMemcpy")
A6B_STEPS = COMPARE_STEPS  # steps of each multi-card mesh leg
PP_MICRO = 8  # microbatches of the pp legs (the dp-local batch of 8 divides it)
NCCL_TIMEOUT_S = 45  # a collective that does not pair up fails instead of hanging
A6B_LEG_S = 90  # a multi-card part's deadline: past it the rank dumps its stacks and ends
# the whole multi-card leg's, start-up included (its parts took 73 s on four
# H100s); with the ring leg's, it keeps a four-card run inside the limit
A6B_WAIT_S = 200
# the ring leg (ROADMAP C2): its meshes, run in this order, each stage's
# deadline on a rank (past NCCL's timeout, so a hung collective is named by
# NCCL first) and the leg's, start-up included
RING_MESHES = (("dp2_sp2", dict(dp=2, sp=2)), ("sp4", dict(dp=1, sp=4)))
RING_STAGE_S = 60
RING_WAIT_S = 100  # start-up, then stages that took 7.6 s on four H100s up to the capture
# where the multi-card leg leaves each rank's log and its records (beside
# the working directory; git ignores it)
A6B_OUT = "chip_smoke_out"


def _sync_calls(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        out = fn()
    names = [e.name for e in p.events()]
    return out, {n: names.count(n) for n in HOST_SYNC_CALLS}


def _host_syncs(torch, fn):
    """(fn's result, the host synchronizations it made: the CUDA runtime
    calls of HOST_SYNC_CALLS that torch.profiler recorded, less those a
    profiled call that does nothing records, the profiler's own)."""
    _, base = _sync_calls(torch, lambda: None)
    out, got = _sync_calls(torch, fn)
    return out, {n: got[n] - base[n] for n in HOST_SYNC_CALLS if got[n] - base[n]}


def _launch_delta(before, after):
    return {k: after["launches"][k] - before["launches"].get(k, 0) for k in after["launches"]
            if after["launches"][k] != before["launches"].get(k, 0)}


def train_multistep(torch, card, readings):
    """Transformer base train_flash (dropout as the train phase has it)
    under training_fused: MULTI_CALLS calls of steps_per_run=MULTI_K
    against MULTI_K * MULTI_CALLS single runs from the same state. The
    losses and every persistable bit for bit, one host synchronization in a
    call of replays (torch.profiler's CUDA runtime calls), the same kernel
    launches a step, the step wall beside the single runs'."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = prof.BASE_FLASH
    main_prog, startup, loss = prof.build(cfg)
    init = _startup_state(startup)
    n = MULTI_K * MULTI_CALLS
    batches = [prof.make_batch(cfg, SEED + 200 + i) for i in range(n)]
    flags.set_flags({"pass_pipeline": "training_fused"})
    place = CUDAPlace(0)

    def fresh():
        scope = Scope(seed=SEED, place=place)
        for name, value in init.items():
            scope.set_var(name, value.clone())
        return scope, Executor(place)

    def run(*a, **kw):
        return exe.run(main_prog, *a, fetch_list=[loss.name], scope=scope, **kw)

    # the last single run and the last call are profiled for their host
    # syncs; the others are timed without the profiler
    scope, exe = fresh()
    single, swalls, sdeltas = [], [], []
    for i, feed in enumerate(batches):
        before = fused.stats()
        t0 = time.perf_counter()
        if i == n - 1:
            (val,), ssyncs = _host_syncs(torch, lambda: run(feed=feed))
        else:
            (val,) = run(feed=feed)
            swalls.append((time.perf_counter() - t0) * 1e3)
        sdeltas.append(_launch_delta(before, fused.stats()))
        single.append(float(val.reshape(-1)[0]))
    want = {k: v.clone() for k, v in scope.vars.items() if k in init}
    del scope, exe
    scope, exe = fresh()
    multi, mwalls, mdeltas = [], [], []
    captures0 = Executor.stats()["graphs"].get("captures", 0)
    for c in range(MULTI_CALLS):
        stacked = {k: np.stack([b[k] for b in batches[c * MULTI_K:(c + 1) * MULTI_K]])
                   for k in batches[0]}
        before = fused.stats()
        t0 = time.perf_counter()
        if c == MULTI_CALLS - 1:
            (vals,), msyncs = _host_syncs(torch, lambda: run(feed=stacked,
                                                             steps_per_run=MULTI_K))
        else:
            (vals,) = run(feed=stacked, steps_per_run=MULTI_K)
            mwalls.append((time.perf_counter() - t0) * 1e3)
        mdeltas.append(_launch_delta(before, fused.stats()))
        multi.extend(float(v) for v in vals.reshape(-1))
    stacked_captures = Executor.stats()["graphs"].get("captures", 0) - captures0
    _same_bits("steps_per_run=%d against single runs, loss at step" % MULTI_K, multi, single)
    for k, v in want.items():
        if not torch.equal(scope.vars[k], v):
            raise AssertionError("steps_per_run=%d: %s differs from the single runs'" % (
                MULTI_K, k))
    if sum(msyncs.values()) != 1:
        raise AssertionError("a call of %d replayed steps made host syncs %s, want 1" % (
            MULTI_K, msyncs))
    per_step = {k: v // MULTI_K for k, v in mdeltas[-1].items()}
    if any(v % MULTI_K for v in mdeltas[-1].values()) or per_step != sdeltas[-1]:
        raise AssertionError("steps_per_run launches %s a call against %s a single step" % (
            mdeltas[-1], sdeltas[-1]))
    step_ms, single_ms = mwalls[-1] / MULTI_K, float(np.median(swalls[2:]))
    readings["train_multistep"] = {"graph": {
        "step_wall_ms": step_ms, "single_step_wall_p50_ms": single_ms,
        "host_syncs_a_call": sum(msyncs.values()),
        "host_syncs_a_single_step": sum(ssyncs.values())}}
    log("train multistep: Transformer base train_flash %s, dropout %g: %d calls of "
        "steps_per_run=%d equal %d single runs bit for bit (losses %s, and all %d persistables); "
        "the last call of replays (profiled): host syncs %s (the last single run: %s); kernel "
        "launches a step %s (a single step: %s); step wall %.3f ms (call 2's wall %.3f / %d, "
        "unprofiled) against the single runs' p50 %.3f ms (steps 3-%d, unprofiled); the first "
        "call (warmup, capture) %.3f ms; card %s" % (
            json.dumps(cfg), cfg["dropout"], MULTI_CALLS, MULTI_K, n,
            ["%.6f" % v for v in multi], len(want), json.dumps(msyncs),
            json.dumps(ssyncs), json.dumps(per_step), json.dumps(sdeltas[-1]), step_ms,
            mwalls[-1], MULTI_K, single_ms, n - 1, mwalls[0], card))
    del scope, exe
    rdeltas = _multistep_reader(torch, cfg, batches, init, fresh, multi, single, want,
                                msyncs, stacked_captures, card, readings)
    del want, init
    torch.cuda.empty_cache()
    # the phase's launches as counted: every single run's and every call's;
    # the kernels line names the fused flash backward's launches "flash_bwd"
    names = {"flash_bwd_fused": "flash_bwd", "flash_bwd_fused_causal": "flash_bwd_causal"}
    total = {}
    for delta in sdeltas + mdeltas + rdeltas:
        for k, v in delta.items():
            total[names.get(k, k)] = total.get(names.get(k, k), 0) + v
    return total


def _multistep_reader(torch, cfg, batches, init, fresh, multi, single, want, msyncs,
                      stacked_captures, card, readings):
    """The py_reader form of steps_per_run on the same model: the program
    built with layers.py_reader + read_file (profile_training.build(reader=
    True)), Executor.run with no feed. First the phase's batches, MULTI_CALLS
    pulls of MULTI_K: losses and every persistable bit for bit the stacked
    calls', no more host syncs in a call than a stacked call's, and no
    capture beyond the stacked form's. Then an epoch of 2 * MULTI_K + 1
    batches from the start: calls of MULTI_K, MULTI_K and a stacked tail of
    1, then EOFException, the losses bit for bit the single runs'. Returns
    each call's kernel launches."""
    from paddle_tpu_torch import EOFException, Executor
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_training as prof

    main_prog, _, loss = prof.build(cfg, reader=True)
    reader = main_prog._py_readers[0]

    def epoch(bs):
        reader.decorate_tensor_provider(lambda: (prof.reader_feed(main_prog, b) for b in bs))
        reader.start()

    def pull():
        return exe.run(main_prog, fetch_list=[loss.name], scope=scope, steps_per_run=MULTI_K)

    deltas = []
    scope, exe = fresh()
    captures0 = Executor.stats()["graphs"].get("captures", 0)
    epoch(batches)
    pulled, walls = [], []
    for c in range(MULTI_CALLS):
        before = fused.stats()
        t0 = time.perf_counter()
        if c == MULTI_CALLS - 1:
            (vals,), psyncs = _host_syncs(torch, pull)
        else:
            (vals,) = pull()
            walls.append((time.perf_counter() - t0) * 1e3)
        deltas.append(_launch_delta(before, fused.stats()))
        pulled.extend(float(v) for v in vals.reshape(-1))
    with _raises(EOFException, "a pull past the epoch's 12 batches"):
        pull()
    reader.reset()
    captures = Executor.stats()["graphs"].get("captures", 0) - captures0
    _same_bits("steps_per_run=%d pulled from layers.py_reader against the stacked calls, loss "
               "at step" % MULTI_K, pulled, multi)
    for k, v in want.items():
        if not torch.equal(scope.vars[k], v):
            raise AssertionError("steps_per_run=%d pulled: %s differs from the stacked calls'"
                                 % (MULTI_K, k))
    if sum(psyncs.values()) > sum(msyncs.values()):
        raise AssertionError("a pulling call made host syncs %s, a stacked call %s"
                             % (psyncs, msyncs))
    if captures != stacked_captures:
        raise AssertionError("the pulled calls captured %d graphs, the stacked calls %d"
                             % (captures, stacked_captures))
    del scope, exe
    scope, exe = fresh()
    n_tail = 2 * MULTI_K + 1
    epoch(batches[:n_tail])
    tail, shapes = [], []
    for _ in range(3):
        before = fused.stats()
        (vals,) = pull()
        deltas.append(_launch_delta(before, fused.stats()))
        shapes.append(int(vals.shape[0]))
        tail.extend(float(v) for v in vals.reshape(-1))
    with _raises(EOFException, "the call after the epoch's tail"):
        pull()
    reader.reset()
    if shapes != [MULTI_K, MULTI_K, 1]:
        raise AssertionError("an epoch of %d at steps_per_run=%d ran calls of %s"
                             % (n_tail, MULTI_K, shapes))
    _same_bits("the epoch of %d pulled (calls %s) against single runs, loss at step"
               % (n_tail, shapes), tail, single[:n_tail])
    del scope, exe
    step_ms = walls[-1] / MULTI_K
    readings["train_multistep"]["graph"].update(
        reader_step_wall_ms=step_ms, reader_host_syncs_a_call=sum(psyncs.values()))
    log("train multistep, py_reader form: layers.py_reader + read_file, Executor.run(feed=None, "
        "steps_per_run=%d): %d pulled calls equal the stacked calls bit for bit (losses and all "
        "%d persistables), then EOFException; host syncs in the last call (profiled) %s "
        "(a stacked call's %s); graphs captured %d (the stacked calls' %d); step wall %.3f ms "
        "(call 2's wall %.3f / %d, unprofiled); an epoch of %d: calls of %s (the tail's fetch "
        "[1, ...]), then EOFException, losses bit for bit the single runs' %s; card %s" % (
            MULTI_K, MULTI_CALLS, len(want), json.dumps(psyncs), json.dumps(msyncs), captures,
            stacked_captures, step_ms, walls[-1], MULTI_K, n_tail, shapes,
            ["%.6f" % v for v in tail], card))
    return deltas


class _raises:
    """Fails unless the body raises `exc` (what names the call)."""

    def __init__(self, exc, what):
        self.exc, self.what = exc, what

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            raise AssertionError("%s did not raise %s" % (self.what, self.exc.__name__))
        return issubclass(et, self.exc)


def _pe_multistep(torch, cfg, seed):
    """The PE over `cfg` under training_fused (dp = the process group's
    world) from one seed, twice: MULTI_K single runs, and one call of
    steps_per_run=MULTI_K over the same batches. Fails unless the losses
    and every persistable are bit for bit; returns both runs' losses and
    walls."""
    from paddle_tpu_torch import BuildStrategy, CUDAPlace, Executor, ParallelExecutor, Scope
    from paddle_tpu_torch.tools import profile_training as prof

    fb = [prof.make_batch(cfg, seed + i) for i in range(MULTI_K)]
    losses, walls, states = {}, {}, {}
    for k in (1, MULTI_K):
        main_prog, startup, loss = prof.build(cfg)
        place = CUDAPlace(torch.cuda.current_device())
        scope = Scope(seed=SEED, place=place)
        Executor(place).run(startup, scope=scope)
        strategy = BuildStrategy()
        strategy.pass_pipeline = "training_fused"
        pe = ParallelExecutor(loss_name=loss.name, main_program=main_prog,
                              build_strategy=strategy, scope=scope)
        t0 = time.perf_counter()
        if k == 1:
            vals = [pe.run([loss.name], feed=f)[0].reshape(-1)[0] for f in fb]
        else:
            stacked = {n: np.stack([f[n] for f in fb]) for n in fb[0]}
            vals = list(pe.run([loss.name], feed=stacked, steps_per_run=k)[0].reshape(-1))
        walls[str(k)] = (time.perf_counter() - t0) * 1e3
        losses[str(k)] = [float(v) for v in vals]
        states[k] = {n: t.clone() for n, t in scope.vars.items()}
        del pe, scope
    _same_bits("PE steps_per_run=%d against single runs, loss at step" % MULTI_K,
               losses[str(MULTI_K)], losses["1"])
    for n, t in states[1].items():
        if not torch.equal(states[MULTI_K][n], t):
            raise AssertionError("PE steps_per_run=%d: %s differs" % (MULTI_K, n))
    del states
    torch.cuda.empty_cache()
    return {"losses": losses, "wall_ms": walls}


def _pe_world1_a6b(torch, card, readings):
    """At world 1 (this process's NCCL group): the PE with SpecLayout's
    Megatron rules over Transformer base's projections (they prune to
    nothing: the losses bit for bit the Executor phase's, the kernels
    launched as in the Executor), and steps_per_run through the PE bit for
    bit its single runs."""
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = prof.BASE
    batches = [prof.make_batch(cfg, SEED + i) for i in range(COMPARE_STEPS)]
    losses, _, _, pe = _pe_steps(torch, cfg, batches, _launch_check(cfg), rules=True)
    _same_bits("PE (world 1) with the tp rules against the Executor phase, loss at step",
               [float(v) for v in losses], F32_FIRST["transformer"])
    n_rules = len(pe._rules())
    stored = len(pe._stored)
    del pe
    torch.cuda.empty_cache()
    ms = _pe_multistep(torch, prof.BASE_FLASH, SEED + 400)
    log("train parallel: the PE at world 1 with SpecLayout's Megatron rules (%d rules over "
        "Transformer base's Q/K/V/FFN-up and attn-out/FFN-down weights) prunes them to "
        "nothing (%d variables stored in pieces): losses %s bit for bit the Executor phase's, "
        "24 GEMM epilogue, 30 + 30 layer_norm and 1 Adam launches a step; steps_per_run=%d "
        "through the PE equals %d single runs bit for bit (losses %s, all persistables); "
        "card %s" % (n_rules, stored, ["%.6f" % v for v in losses], MULTI_K, MULTI_K,
                     ["%.6f" % v for v in ms["losses"][str(MULTI_K)]], card))


def _state_bytes(scope, main_prog):
    """Bytes this rank holds of the trainable parameters and of their
    optimizer moments."""
    block = main_prog.global_block()
    params = {p.name for p in block.all_parameters() if p.trainable}
    total = 0
    for n, t in scope.vars.items():
        if n in params or (any(n.startswith(p + "_") for p in params) and "_acc_" in n):
            total += t.numel() * t.element_size()
    return total


def _a6b_leg(torch, label, cfg, batches, mesh_kw, rules=False, schedule=None, reduce=False):
    """One mesh leg on this rank: the PE over `cfg` under training_fused,
    A6B_STEPS steps (op by op, capture, replay): losses, walls, the
    collectives and kernel launches of the replayed step, the head counts
    flash's forward saw, the parameter and moment bytes this rank holds, the
    peak memory of the step and, under pp, the stage plan and the profiled
    step's device busy."""
    from paddle_tpu_torch import (BuildStrategy, CUDAPlace, ExecutionStrategy, Executor,
                                  ParallelExecutor, Scope)
    from paddle_tpu_torch.ops import flash_attention, fused, registry
    from paddle_tpu_torch.parallel import MeshConfig
    from paddle_tpu_torch.tools import profile_training as prof

    main_prog, startup, loss = prof.build(cfg)
    place = CUDAPlace(torch.cuda.current_device())
    scope = Scope(seed=SEED, place=place)
    Executor(place).run(startup, scope=scope)
    whole = _state_bytes(scope, main_prog)
    strategy = BuildStrategy()
    strategy.pass_pipeline = "training_fused"
    if rules:
        strategy.sharding_rules = prof.tp_rules(main_prog)
    if reduce:
        strategy.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    es = ExecutionStrategy()
    if schedule:
        es.pipeline_schedule, es.num_microbatches = schedule, PP_MICRO
    pe = ParallelExecutor(loss_name=loss.name, main_program=main_prog, build_strategy=strategy,
                          exec_strategy=es, scope=scope, mesh_config=MeshConfig(**mesh_kw))
    heads = set()
    forward = flash_attention.flash_forward

    def spy(q, *a, **kw):
        heads.add(int(q.shape[1]))
        return forward(q, *a, **kw)

    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, feed in enumerate(batches):
        flash_attention.flash_forward = spy if i == 0 else forward
        before = fused.stats()
        coll = dict(fused.COLLECTIVES)
        t0 = time.perf_counter()
        try:
            (val,) = pe.run([loss.name], feed=feed)
        finally:
            flash_attention.flash_forward = forward
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(val.reshape(-1)[0]))
        launches = _launch_delta(before, fused.stats())
        colls = {k: v - coll.get(k, 0) for k, v in fused.COLLECTIVES.items()
                 if v != coll.get(k, 0)}
    peak = torch.cuda.max_memory_allocated() / GIB
    rec = {"losses": losses, "walls": walls, "collectives_a_step": colls,
           "launches_a_step": launches, "flash_heads": sorted(heads),
           "state_bytes": _state_bytes(scope, main_prog), "state_bytes_world1": whole,
           "stored_pieces": len(pe._stored), "peak_gib": peak, "mesh": pe.mesh.shape}
    if schedule:
        block = next(iter(pe._cache.values()))
        plan = getattr(block, "block", block).stage_plan
        rec["stage_ops"] = [len(s) for s in plan["stages"]]
        split = prof.profile_steps(lambda f: pe.run([loss.name], feed=f), batches[1:], registry)
        rec["busy_ms"] = split["device_busy_ms_per_step"]
        rec["profiled_wall_ms"] = split["wall_ms_p50"]
        # NCCL's receive kernels spin while a stage waits: the stage's own
        # compute is the busy time without them
        rec["nccl_ms"] = sum(v["ms"] for k, v in split["device_ms_per_step_by_kernel"].items()
                             if "nccl" in k.lower())
    del pe, scope
    torch.cuda.empty_cache()
    return rec


def _zero1_ckpt_cards(torch, tmp):
    """ZeRO-1 at dp = world: 3 steps, against 2 steps, save_persistables
    (whole variables, rank 0 writes), a fresh scope with load_persistables
    (resharded), 1 step: the losses bit for bit."""
    from paddle_tpu_torch import (BuildStrategy, CUDAPlace, Executor, ParallelExecutor, Scope,
                                  io, scope_guard)
    from paddle_tpu_torch.parallel.multihost import barrier
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = dict(prof.BASE_FLASH, dropout=0.0)
    batches = [prof.make_batch(cfg, SEED + 500 + i) for i in range(3)]
    place = CUDAPlace(torch.cuda.current_device())

    def pe_on(scope, main_prog, loss):
        strategy = BuildStrategy()
        strategy.pass_pipeline = "training_fused"
        strategy.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
        return ParallelExecutor(loss_name=loss.name, main_program=main_prog,
                                build_strategy=strategy, scope=scope)

    runs = []
    for cut in (None, 2):
        main_prog, startup, loss = prof.build(cfg)
        scope = Scope(seed=SEED, place=place)
        exe = Executor(place)
        exe.run(startup, scope=scope)
        pe = pe_on(scope, main_prog, loss)
        losses = []
        for i, feed in enumerate(batches):
            if cut is not None and i == cut:
                with scope_guard(scope):
                    io.save_persistables(exe, tmp, main_prog)
                barrier()
                sharded = len(scope.row_shards)
                main_prog, startup, loss = prof.build(cfg)
                scope = Scope(seed=SEED + 1, place=place)
                exe.run(startup, scope=scope)
                pe = pe_on(scope, main_prog, loss)
                with scope_guard(scope):
                    io.load_persistables(exe, tmp, main_prog)
            losses.append(float(pe.run([loss.name], feed=feed)[0].reshape(-1)[0]))
        runs.append(losses)
        del pe, scope
    torch.cuda.empty_cache()
    return {"full": runs[0], "resumed": runs[1], "sharded": sharded}


def _rank_parts(log_path, rec):
    """A rank's `part(name, seconds)`: a context that writes "start name" to
    the rank's log before the part and "done name" with the record so far
    (a PARTIAL line) after it, and past `seconds` dumps every thread's
    stack into the log and ends the process, so a hang names its part. A
    part that raises writes "failed name" and the traceback first: the
    exception's way out (the process group's teardown) may hang in turn,
    and the teardown runs under a deadline of its own (`part("teardown",
    ...)`)."""
    import faulthandler
    import traceback

    log_f = open(log_path, "a")

    @contextlib.contextmanager
    def part(name, seconds):
        log_f.write("start %s\n" % name)
        log_f.flush()
        faulthandler.dump_traceback_later(seconds, exit=True, file=log_f)
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            log_f.write("failed %s\n%s" % (name, traceback.format_exc()))
            log_f.flush()
            raise
        finally:
            faulthandler.cancel_dump_traceback_later()
        log_f.write("done %s %.1f s\nPARTIAL %s\n" % (name, time.perf_counter() - t0,
                                                      json.dumps(rec)))
        log_f.flush()

    return part


def _a6b_rank_main(rank, world, store, log_path, legs):
    """One rank of the A6b multi-card leg (a process a card, NCCL with a
    timeout): each mesh leg of `legs` over Transformer base train_flash at
    dropout 0, steps_per_run through the PE at dp = world and the ZeRO-1
    checkpoint, then the pipelined legs. Each part runs under a deadline (a
    hang dumps every thread's stack into `log_path` and ends the process)
    and appends the record so far to `log_path`; the whole record is
    printed as JSON. (Ring attention over sp runs in processes of its own,
    _ring_rank_main.)"""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_distributed
    from paddle_tpu_torch.tools import profile_training as prof

    rec = {"rank": rank}
    part = _rank_parts(log_path, rec)
    with part("init", 120):
        init_distributed(store=dist.FileStore(store, world), world_size=world, rank=rank,
                         backend="nccl", timeout_s=NCCL_TIMEOUT_S)
    try:
        cfg = dict(prof.BASE_FLASH, dropout=0.0)
        batches = [prof.make_batch(cfg, SEED + 300 + i) for i in range(A6B_STEPS)]

        def run_legs(pipelined):
            for label, kw in legs:
                if bool(kw.get("schedule")) == pipelined:
                    with part(label, A6B_LEG_S):
                        t0 = time.perf_counter()
                        rec[label] = _a6b_leg(torch, label, cfg, batches, **kw)
                        rec[label]["leg_s"] = time.perf_counter() - t0

        run_legs(False)
        if world >= 4:
            with part("multistep_dp", A6B_LEG_S):
                rec["multistep_dp"] = _pe_multistep(torch, cfg, SEED + 600)
            with part("zero1_ckpt", A6B_LEG_S):
                rec["zero1_ckpt"] = _zero1_ckpt_cards(torch, os.path.join(
                    os.path.dirname(store), "zero1_ckpt"))
        run_legs(True)
        print(json.dumps(rec))
    finally:
        with part("teardown", NCCL_TIMEOUT_S):
            dist.destroy_process_group()


# a rank process: chip_smoke.<argv[2]>(rank, world, store, log path, *json args)
_RANK = r"""
import sys, json
sys.path.insert(0, sys.argv[1])
import chip_smoke
getattr(chip_smoke, sys.argv[2])(int(sys.argv[4]), int(sys.argv[5]), sys.argv[3], sys.argv[6],
                                 *json.loads(sys.argv[7]))
"""


def _run_ranks(fn, world, args, wait_s, tag, env=None):
    """`world` processes, a card each, running chip_smoke.<fn> with
    (rank, world, store, log path, *args), each with its log, stdout and
    stderr under A6B_OUT as <tag>_rank<r>.*; those still running after
    `wait_s` seconds (start-up included) are killed. Returns (each rank's
    return code, each rank's files' path stem, the wall in seconds)."""
    import subprocess
    import tempfile

    os.makedirs(A6B_OUT, exist_ok=True)
    stems = [os.path.join(A6B_OUT, "%s_rank%d" % (tag, r)) for r in range(world)]
    with tempfile.TemporaryDirectory(prefix="%s_ranks_" % tag) as tmp:
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        procs = []
        for r, stem in enumerate(stems):
            if os.path.exists(stem + ".log"):
                os.remove(stem + ".log")
            with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK, os.path.dirname(os.path.abspath(__file__)),
                     fn, store, str(r), str(world), stem + ".log", json.dumps(args)],
                    env=dict(os.environ, LOCAL_RANK=str(r), **(env or {})), stdout=out,
                    stderr=err))
        try:
            for pr in procs:
                pr.wait(timeout=max(1.0, wait_s - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.perf_counter() - t0
    return [pr.returncode for pr in procs], stems, wall


def _rank_tail(stem, n=4000):
    """The last `n` characters of a rank's log and of its stderr."""
    text = ""
    for ext in (".log", ".err"):
        if os.path.exists(stem + ext):
            with open(stem + ext) as f:
                text += f.read()[-n:]
    return text


def _last_record(stem):
    """A rank's record: the last JSON object its stdout printed (NCCL's own
    lines, under NCCL_DEBUG, may follow it from the teardown)."""
    with open(stem + ".out") as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def _a6b_legs(world):
    """The mesh legs the visible cards allow."""
    legs = []
    if world >= 4:
        legs += [("dp2_tp2", dict(mesh_kw=dict(dp=2, tp=2), rules=True)),
                 ("fsdp4", dict(mesh_kw=dict(dp=1, fsdp=4), rules=True)),
                 ("dp2_sp2", dict(mesh_kw=dict(dp=2, sp=2)))]
    pp = 4 if world >= 4 else 2
    for schedule in ("gpipe", "1f1b"):
        legs.append(("pp%d_%s" % (pp, schedule),
                     dict(mesh_kw=dict(dp=1, pp=pp), schedule=schedule)))
    if world >= 4:
        for schedule in ("gpipe", "1f1b"):
            legs.append(("dp2_pp2_%s" % schedule,
                         dict(mesh_kw=dict(dp=2, pp=2), schedule=schedule)))
    return legs


def _a6b_summary(recs, legs, ref, whole, world):
    """The multi-card records held and summarized: the tp / fsdp legs' ranks
    agree bit for bit, every leg's losses are within the fused bar of the
    one-card Executor's `ref`, the ZeRO-1 checkpoint and steps_per_run at
    dp = world bit for bit; each leg's readings (a pp leg's device idle
    share is 1 - busy / wall on its card: NCCL's receive kernels spin while
    they wait, so it is not the pipeline's bubble; the busy time without
    the NCCL kernels gives the measured bubble)."""
    from paddle_tpu_torch.parallel.pipeline import analytic_bubble

    r0 = recs[0]
    summary = {"world": world, "executor_losses": ref}
    for label, _ in legs:
        for rec in recs[1:]:
            if label.startswith("dp2_tp2") or label.startswith("fsdp"):
                _same_bits("%s, rank %d against rank 0, step" % (label, rec["rank"]),
                           rec[label]["losses"], r0[label]["losses"])
        got = np.asarray(r0[label]["losses"])
        if not np.allclose(got, ref, rtol=FUSED_RTOL, atol=FUSED_ATOL):
            raise AssertionError("%s: losses %s against the one-card Executor's %s" % (
                label, got.tolist(), ref))
        leg = r0[label]
        line = {"losses": leg["losses"], "step_ms": leg["walls"][-1],
                "state_bytes_a_rank": [r[label]["state_bytes"] for r in recs],
                "state_bytes_world1": whole, "collectives_a_step": leg["collectives_a_step"],
                "launches_a_step": leg["launches_a_step"], "flash_heads": leg["flash_heads"],
                "peak_gib_a_rank": [r[label]["peak_gib"] for r in recs], "leg_s": leg["leg_s"]}
        if "stage_ops" in leg:
            line["stage_ops"] = leg["stage_ops"]
            line["busy_ms_a_rank"] = [r[label]["busy_ms"] for r in recs]
            line["profiled_wall_ms_a_rank"] = [r[label]["profiled_wall_ms"] for r in recs]
            line["device_idle_share_a_rank"] = [
                1.0 - r[label]["busy_ms"] / r[label]["profiled_wall_ms"] for r in recs]
            line["nccl_ms_a_rank"] = [r[label]["nccl_ms"] for r in recs]
            # the measured bubble: the share of the step a stage spends
            # outside its own compute (NCCL's waiting kernels excluded)
            line["measured_bubble_a_rank"] = [
                1.0 - (r[label]["busy_ms"] - r[label]["nccl_ms"]) / r[label]["profiled_wall_ms"]
                for r in recs]
            line["analytic_bubble"] = analytic_bubble(leg["mesh"]["pp"], PP_MICRO)
        summary[label] = line
    if world >= 4:
        z = r0["zero1_ckpt"]
        _same_bits("ZeRO-1 checkpoint round trip at dp = %d, step" % world, z["resumed"],
                   z["full"])
        summary["zero1_ckpt"] = z
        # each rank held its steps_per_run call to its single runs
        summary["multistep_dp"] = r0["multistep_dp"]
    return summary


def _ring_errs(got, ref_o, ref_lse, ref_g, mesh):
    """Max abs errors of a ring run (out, this rank's lse chunk, dq, dk, dv)
    against the whole sequence's, and whether they are inside the one-card
    ring check's bars."""
    n, me = mesh.axis_size("sp"), mesh.index("sp")
    t_loc = ref_o.shape[2] // n
    errs = {"out": float((got[0] - ref_o).abs().max()),
            "lse": float((got[1] - ref_lse.narrow(2, me * t_loc, t_loc)).abs().max())}
    ok = max(errs.values()) <= RING_OUT_TOL
    for name, g, ref in zip(("dq", "dk", "dv"), got[2:], ref_g):
        lim = RING_GRAD_TOL * ref.abs() + RING_GRAD_TOL * float(ref.abs().max())
        ok = ok and bool(((g - ref).abs() <= lim).all())
        errs[name] = float((g - ref).abs().max())
    return errs, ok


def _ring_rank_main(rank, world, store, log_path):
    """One rank of the ring leg: ring attention over the sp axis of each of
    RING_MESHES at train_flash's widths, on NCCL with NCCL_TIMEOUT_S. First
    eager on every mesh (the forward, then the backward, each waited for),
    then on every mesh captured in one CUDA graph with the ring's send /
    recv inside it and replayed; each result against flash_forward /
    flash_backward over the whole sequence on this card. As the executor
    does, each capture runs on the stream its warmup ran on: the flash
    backward's arrival counters are made per stream, outside any capture
    (ops/_build.py arrival_counters), so a capture on a stream that no
    warmup ran on raises (ROADMAP C2). Every stage is a part of the rank's
    log, so a hang or a failure names its stage (and NCCL's timeout its
    collective); the record is printed as JSON."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import MeshConfig, init_distributed, make_mesh
    from paddle_tpu_torch.parallel.ring_attention import sharded_backward, sharded_forward
    from paddle_tpu_torch.tools import profile_training as prof

    rec = {"rank": rank}
    part = _rank_parts(log_path, rec)
    with part("init", RING_STAGE_S):
        init_distributed(store=dist.FileStore(store, world), world_size=world, rank=rank,
                         backend="nccl", timeout_s=NCCL_TIMEOUT_S)
    try:
        cfg = prof.BASE_FLASH
        b, h, t, d = cfg["batch"], cfg["n_head"], cfg["t"], cfg["d_key"]
        scale = d ** -0.5
        cases = {}
        for causal in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(SEED + int(causal))
            q, k, v, do = (torch.randn((b, h, t, d), generator=gen, device="cuda")
                           for _ in range(4))
            ref_o, ref_lse = fa.flash_forward(q, k, v, causal, scale)
            cases[causal] = (q, k, v, do, ref_o, ref_lse,
                             fa.flash_backward(q, k, v, ref_o, ref_lse, do, causal, scale))
        meshes = {}
        for label, kw in RING_MESHES:
            with part("mesh %s" % label, RING_STAGE_S):
                meshes[label] = make_mesh(MeshConfig(**kw))
        for label, _ in RING_MESHES:
            mesh = meshes[label]
            for causal, (q, k, v, do, ref_o, ref_lse, ref_g) in cases.items():
                name = "eager %s causal=%s" % (label, causal)
                with part(name + " forward", RING_STAGE_S):
                    o, lse = sharded_forward(q, k, v, mesh, "sp", causal, scale)
                    torch.cuda.synchronize()
                with part(name + " backward", RING_STAGE_S):
                    g = sharded_backward(q, k, v, o, do, mesh, "sp", causal, scale, lse=lse)
                    torch.cuda.synchronize()
                errs, ok = _ring_errs((o, lse) + g, ref_o, ref_lse, ref_g, mesh)
                rec[name] = {"errs": errs, "ok": ok}
        capture = torch.cuda.Stream()
        for label, _ in RING_MESHES:
            mesh = meshes[label]
            for causal, (q, k, v, do, ref_o, ref_lse, ref_g) in cases.items():
                name = "graph %s causal=%s" % (label, causal)

                def body():
                    o, lse = sharded_forward(q, k, v, mesh, "sp", causal, scale)
                    return (o, lse) + sharded_backward(q, k, v, o, do, mesh, "sp", causal,
                                                       scale, lse=lse)

                with part(name + " warmup", RING_STAGE_S):
                    capture.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(capture):
                        body()
                    torch.cuda.current_stream().wait_stream(capture)
                    torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with part(name + " capture", RING_STAGE_S):
                    with torch.cuda.graph(graph, stream=capture,
                                          capture_error_mode="thread_local"):
                        got = body()
                with part(name + " replay", RING_STAGE_S):
                    graph.replay()
                    torch.cuda.synchronize()
                errs, ok = _ring_errs(got, ref_o, ref_lse, ref_g, mesh)
                rec[name] = {"errs": errs, "ok": ok}
                del graph, got
        print(json.dumps(rec))
    finally:
        with part("teardown", RING_STAGE_S):
            dist.destroy_process_group()


def _ring_cards(world, card, readings):
    """The ring leg on four cards, in processes of its own so that a hang
    stays in them: every rank must finish inside RING_WAIT_S with its
    results inside the ring check's bars, eager and captured. A rank that
    hangs or fails fails the smoke, naming the stage each rank stopped at
    and its log's last lines."""
    rcs, stems, wall = _run_ranks("_ring_rank_main", world, [], RING_WAIT_S, "ring",
                                  env={"TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
                                       "NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT"})
    if any(rcs):
        stopped = {}
        for r, stem in enumerate(stems):
            started, done = [], set()
            if os.path.exists(stem + ".log"):
                with open(stem + ".log") as f:
                    for ln in f:
                        if ln.startswith("start "):
                            started.append(ln[6:].strip())
                        elif ln.startswith("done "):
                            done.add(ln[5:].rsplit(" ", 2)[0])
            stopped[r] = next((st for st in reversed(started) if st not in done), None)
        raise AssertionError(
            "ring attention over %s on %d cards did not finish (return codes %s, after %.1f "
            "s); each rank stopped in %s; the ranks' logs and stderr end:\n%s" % (
                [m for m, _ in RING_MESHES], world, rcs, wall, json.dumps(stopped),
                "\n".join("-- rank %d\n%s" % (r, _rank_tail(stem, 1500))
                          for r, stem in enumerate(stems))))
    recs = [_last_record(stem) for stem in stems]
    bad = {(rec["rank"], k): v for rec in recs for k, v in rec.items()
           if isinstance(v, dict) and not v["ok"]}
    if bad:
        raise AssertionError("ring attention on %d cards outside the bars (out and lse %g, "
                             "grads rtol %g atol %g of the largest): %s" % (
                                 world, RING_OUT_TOL, RING_GRAD_TOL, RING_GRAD_TOL, bad))
    worst = {}
    for rec in recs:
        for k, v in rec.items():
            if isinstance(v, dict):
                worst[k] = {e: max(worst.get(k, {}).get(e, 0.0), x)
                            for e, x in v["errs"].items()}
    readings["ring_cards"] = {"graph": {"max_abs_err": worst, "wall_s": wall}}
    log("train parallel (ring): ring attention over %s on %d cards, eager and captured in a "
        "CUDA graph with its NCCL send / recv, every rank inside the bars (out and lse %g, "
        "grads rtol %g atol %g of the largest): max abs err over the ranks %s; card %s" % (
            [m for m, _ in RING_MESHES], world, RING_OUT_TOL, RING_GRAD_TOL, RING_GRAD_TOL,
            json.dumps(worst), card))


def _a6b_cards(world, card, readings):
    """A6b's multi-card leg: a process a card (world 4: every leg; 2 or 3:
    pp 2 alone on the first two), each leg's first A6B_STEPS losses within
    the fused bar of the one-card Executor's from the same weights, every
    rank agreeing; steps_per_run and the ZeRO-1 checkpoint at world 4."""
    import torch

    from paddle_tpu_torch.tools import profile_training as prof

    world = 4 if world >= 4 else 2
    cfg = dict(prof.BASE_FLASH, dropout=0.0)
    batches = [prof.make_batch(cfg, SEED + 300 + i) for i in range(A6B_STEPS)]
    main_prog, startup, loss = prof.build(cfg)
    ref, ref_walls, rscope, rstep, _ = _train_run(torch, main_prog, startup, loss, batches,
                                                  "training_fused", lambda *a: None)
    ref = [float(v) for v in ref]
    whole = _state_bytes(rscope, main_prog)
    del rscope, rstep
    torch.cuda.empty_cache()
    log("train parallel (A6b): the one-card Executor's first %d losses %s, its parameter and "
        "moment bytes %d, the legs' reference; card %s" % (
            A6B_STEPS, ["%.6f" % v for v in ref], whole, card))
    legs = _a6b_legs(world)
    rcs, stems, wall = _run_ranks("_a6b_rank_main", world, [legs], A6B_WAIT_S, "a6b",
                                  env={"TORCH_NCCL_ASYNC_ERROR_HANDLING": "1"})
    for r, rc in enumerate(rcs):
        if rc != 0:
            raise AssertionError("A6b rank %d ended %s after %.1f s; its log:\n%s" % (
                r, rc, wall, _rank_tail(stems[r])))
    recs = [_last_record(stem) for stem in stems]
    summary = _a6b_summary(recs, legs, ref, whole, world)
    summary["wall_s"] = wall
    readings["a6b_cards"] = {"graph": summary}
    with open(os.path.join(A6B_OUT, "a6b_cards.json"), "w") as f:
        json.dump({"card": card, "records": recs, "summary": summary}, f)
    log("train parallel (A6b): %d cards, a process a card, Transformer base train_flash at "
        "dropout 0 (%s), the one-card Executor's losses %s; %s; card %s" % (
            world, json.dumps(cfg), ["%.6f" % v for v in ref], json.dumps(summary), card))


def _on_thread(fn):
    """Run fn() on a thread; the returned call waits for it and gives (its
    result, its seconds), or raises its error."""
    import threading

    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: B036 — raised by the waiter
            box["err"] = e
        box["s"] = time.perf_counter() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"], box["s"]

    return wait


def _start_native_build():
    """Build libptnative (paddle_tpu_torch/native, g++) on a thread; the
    returned call waits for it and gives its log line (or raises its
    error)."""
    from paddle_tpu_torch import native

    done = _on_thread(native.lib)

    def wait():
        _, secs = done()
        return "g++ build of libptnative in %.1f s (zlib: %s): %s" % (
            secs, native.build_log.get("zlib"),
            native.build_log.get("cmd", "a build of this source was already there"))

    return wait


def _start_nvcc_build():
    """Build every kernel of ops/csrc/ (one nvcc per source, all at once) on
    a thread; the returned call waits for it and gives its log lines (or
    raises its error). A kernel launched meanwhile waits for its library."""
    from paddle_tpu_torch.ops import _build

    done = _on_thread(_build.build_all)

    def wait():
        _, secs = done()
        lines = ["nvcc sm_90a build of %s in %.1f s" % (sorted(_build.build_logs), secs)]
        for stem, text in sorted(_build.build_logs.items()):
            ptxas = [ln.split(":", 1)[-1].strip() for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln]
            lines.append("ptxas %s: %s" % (stem, " | ".join(ptxas)))
        return lines

    return wait


# ---------------------------------------------------------------- resilience

RESILIENCE_STEPS = 6  # supervised graph steps of train_flash's configuration
RESILIENCE_EVERY = 2  # a checkpoint every 2 steps, the newest 2 kept
GUARD_STEPS = 2  # steps a turn of the guard-off / guard-on walls
# kernel table name -> launch key of the rows a supervised step reaches
RESILIENCE_KERNELS = {"gemm_epilogue": "gemm_epilogue", "flash_fwd": "flash_fwd",
                      "flash_fwd_causal": "flash_fwd_causal", "flash_bwd": "flash_bwd_fused",
                      "flash_bwd_causal": "flash_bwd_fused_causal", "layer_norm": "layer_norm",
                      "layer_norm_grad": "layer_norm_grad", "multi_adam": "multi_adam"}
PSERVER_STEPS = 4  # sync rounds of the DeepFM cluster
PSERVER_RTOL, PSERVER_ATOL = 2e-3, 2e-4  # tests/test_dist_subprocess.py's bar


def _bits_equal(torch, a, b):
    """Whether two tensors hold the same bits (a float compared as the
    integers of its width, so -0.0 and 0.0 or two NaNs are told apart)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float64: torch.int64, torch.float16: torch.int16}
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = ints.get(a.dtype)
    return bool(torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b))


def _differing(torch, got, want):
    return sorted(n for n in want if not _bits_equal(torch, got[n], want[n]))


def train_resilience(torch, card, readings):
    """train_flash's configuration (Transformer base, f32, Adam, training_fused,
    use_flash) at dropout 0 under the elastic Supervisor: RESILIENCE_STEPS graph
    steps with a checkpoint every RESILIENCE_EVERY (AsyncCheckpointer: each
    save's stall, state bytes, pinned buffers made and commit wall; each
    commit verified); a fresh Scope and Executor resumed from step 4 give
    steps 5-6's losses and every persistable bit for bit; the NaN guard's
    step wall against the guard off, in turns; a nan_grad step rolled back
    bit for bit with the learning rate decayed; a preempt fault (SIGTERM)
    drained and committed. Returns the training kernels' launches over the
    supervised steps."""
    import shutil
    import tempfile

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, scope_guard
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.py_reader import PyReader
    from paddle_tpu_torch.resilience import Preempted, Supervisor, async_ckpt, faults, health
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = dict(prof.BASE_FLASH, dropout=0.0)
    main_prog, startup, loss = prof.build(cfg)
    batches = [prof.make_batch(cfg, SEED + 200 + i) for i in range(RESILIENCE_STEPS)]
    flags.set_flags({"pass_pipeline": "training_fused"})
    place = CUDAPlace(0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        # the uninterrupted run, supervised, on CUDA graphs
        root = os.path.join(tmp, "run")
        scope, exe = Scope(seed=SEED, place=place), Executor(place)
        sup = Supervisor(exe, root, program=main_prog, scope=scope, ckpt_every=RESILIENCE_EVERY,
                         keep_last=2)
        cp = sup.checkpointer
        losses, saves = [], []
        with scope_guard(scope):
            if sup.resume_or_init(startup)[0] != 0:
                raise AssertionError("train resilience: a fresh root resumed")
            fused.reset_stats()  # the main path's counting window opens here
            with sup:
                for feed in batches:
                    (lv,) = sup.run_step(program=main_prog, feed=feed, fetch_list=[loss.name])
                    losses.append(np.asarray(lv).reshape(-1)[0])
                    if sup.step % RESILIENCE_EVERY == 0:
                        # join this save's writer so each commit is read and
                        # verified on its own
                        cp.wait()
                        if not async_ckpt.verify_elastic_checkpoint(cp.last_commit_dir):
                            raise AssertionError("train resilience: commit %s does not verify"
                                                 % cp.last_commit_dir)
                        saves.append(dict(cp.stats))
            launches = fused.stats()["launches"]  # and closes here
        final = {n: t.clone() for n, t in sup._state().items()}
        moved = {k: launches.get(key, 0) for k, key in RESILIENCE_KERNELS.items()}
        if not all(moved.values()):
            raise AssertionError("train resilience: kernels not launched %s" % moved)
        if not (saves[0]["pinned_blocks"] > 0 and all(s["pinned_blocks"] == 0 for s in saves[1:])):
            raise AssertionError("train resilience: pinned buffers made a save %s"
                                 % [s["pinned_blocks"] for s in saves])
        # resume from step 4 in a fresh Scope (another seed: the restore
        # must win) and Executor
        r4 = os.path.join(tmp, "from4")
        os.makedirs(r4)
        os.rename(os.path.join(root, "eckpt-%08d" % 4), os.path.join(r4, "eckpt-%08d" % 4))
        shutil.rmtree(root)
        del sup
        scope2, exe2 = Scope(seed=SEED + 1, place=place), Executor(place)
        sup2 = Supervisor(exe2, r4, program=main_prog, scope=scope2, ckpt_every=0)
        with scope_guard(scope2):
            start, cursor = sup2.resume_or_init(startup)
            if (start, cursor.get("batch_index")) != (4, 4):
                raise AssertionError("train resilience: resumed at %s, cursor %s" % (start, cursor))
            with sup2:
                resumed = [np.asarray(sup2.run_step(program=main_prog, feed=feed,
                                                    fetch_list=[loss.name])[0]).reshape(-1)[0]
                           for feed in batches[4:]]
        _same_bits("train resilience, resumed loss against the uninterrupted run's, step",
                   resumed, losses[4:])
        bad = _differing(torch, sup2._state(), final)
        if bad or sorted(sup2._state()) != sorted(final):
            raise AssertionError("train resilience: after the resume, persistables %s differ" % bad)
        n_state = len(final)
        del final

        # the guard's finiteness test on the card: one NaN or Inf element
        # anywhere in f32 or bf16 state is found
        from paddle_tpu_torch.executor import _all_finite

        dev = scope2.device
        probe = [torch.randn(1 << 22, device=dev), torch.randn(4097, device=dev).bfloat16()]
        for t, i, v in ((0, 123457, float("nan")), (1, 4096, float("inf")),
                        (0, (1 << 22) - 1, -float("inf")), (1, 0, float("nan"))):
            if not _all_finite(probe):
                raise AssertionError("train resilience: finite tensors read as non-finite")
            old = probe[t][i].clone()
            probe[t][i] = v
            if _all_finite(probe):
                raise AssertionError("train resilience: %r at %d of tensor %d not found" % (v, i, t))
            probe[t][i] = old
        del probe

        # the NaN guard: its step wall against the guard off, in turns (the
        # graph replays), then one poisoned step rolled back
        walls = {False: [], True: []}
        with scope_guard(scope2):
            for on in (False, True, False, True):
                flags.set_flags({"resilience_nan_guard": on})
                for j in range(GUARD_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (lv,) = exe2.run(main_prog, feed=batches[j], fetch_list=[loss.name])
                    walls[on].append((time.perf_counter() - t0) * 1e3)
            health.reset()
            before = {n: t.clone() for n, t in sup2._state().items()}
            faults.install("nan_grad:step=1")
            try:
                (lv,) = exe2.run(main_prog, feed=batches[0], fetch_list=[loss.name])
            finally:
                faults.install(None)
            decay = flags.get_flags("resilience_lr_decay")["resilience_lr_decay"]
            after = sup2._state()
            lr_names = [n for n in before if n.rsplit("/", 1)[-1].startswith("learning_rate")]
            want = dict(before, **{n: before[n] * decay for n in lr_names})
            bad = _differing(torch, after, want)
            if not np.isnan(lv).all() or bad or not lr_names:
                raise AssertionError("train resilience: the guarded step left %s changed (loss %r, "
                                     "lr vars %s)" % (bad, lv, lr_names))
            if health.get("nan_steps_skipped") != 1:
                raise AssertionError("train resilience: nan_steps_skipped %d"
                                     % health.get("nan_steps_skipped"))
            # the next replay copies the rolled-back values into the graph's
            # own tensors and trains from them
            (lv,) = exe2.run(main_prog, feed=batches[1], fetch_list=[loss.name])
            if not np.isfinite(lv).all():
                raise AssertionError("train resilience: the step after the rollback gave %r" % lv)
            flags.set_flags({"resilience_nan_guard": False})
        del before, want, after

        # preemption: SIGTERM at the second supervised step drains the
        # reader and commits the step it stopped at
        proot = os.path.join(tmp, "preempt")
        reader = PyReader(["x"], return_device_arrays=False, place=place)
        reader.decorate_paddle_reader(
            lambda: iter([[(np.full(4, i, "float32"),) for i in range(2)] for _ in range(8)]))
        reader.start()
        sup3 = Supervisor(exe2, proot, program=main_prog, scope=scope2, ckpt_every=0,
                          reader=reader)
        sup3.step = 7
        faults.install("preempt:step=2")
        preempted = None
        try:
            with scope_guard(scope2), sup3:
                for feed in batches:
                    sup3.run_step(program=main_prog, feed=feed, fetch_list=[loss.name])
        except Preempted as e:
            preempted = str(e)
        finally:
            faults.install(None)
        found = async_ckpt.latest_valid_elastic(proot)
        if preempted is None or found is None or found[0] != sup3.step or \
                health.get("preemptions") != 1:
            raise AssertionError("train resilience: preemption %r, commit %r at step %d"
                                 % (preempted, found, sup3.step))
        dropped = health.get("drain_batches_dropped")
        del sup2, sup3, scope2, exe2, scope, exe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    p50 = {on: float(np.median(w)) for on, w in walls.items()}
    reading = {"saves": saves, "guard_off_step_p50_ms": p50[False],
               "guard_on_step_p50_ms": p50[True], "preempt_commit_step": found[0],
               "launches": moved}
    readings["train_resilience"] = reading
    log("train resilience: Transformer base flash at dropout 0 (%s), %d supervised graph steps, "
        "losses %s; saves (AsyncCheckpointer, every %d, keep 2): %s; each commit verified; "
        "resumed from step 4 in a fresh Scope and Executor: steps 5-6's losses and all %d "
        "persistables bit for bit; NaN guard: step wall p50 %.3f ms on, %.3f ms off (%d steps a "
        "turn, 2 turns each, in turns; the device copy of the state a step), a nan_grad step "
        "rolled back bit for bit with %s x %g, nan_steps_skipped 1; preempt: SIGTERM at step %d "
        "drained the reader (%d batches dropped) and committed step %d (%s); kernel launches "
        "over the supervised steps %s; card %s" % (
            json.dumps(cfg), RESILIENCE_STEPS, ["%.6f" % v for v in losses], RESILIENCE_EVERY,
            json.dumps(saves), n_state, p50[True], p50[False], GUARD_STEPS,
            "the learning rate", decay, found[0], dropped, found[0], preempted,
            json.dumps(moved), card))
    return moved


def _free_endpoints(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    eps = ["127.0.0.1:%d" % s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return eps


def _outside(torch, got, scope, init):
    """name -> {max_abs_err, elements outside the phase's bar, of; the worst
    element's cluster, one-process and initial values} of the cluster's
    parameters `got` against a one-process scope."""
    out = {}
    for name, g in got.items():
        want = scope.vars[name].detach().cpu()
        diff = (g - want).abs()
        bad = diff > PSERVER_ATOL + PSERVER_RTOL * want.abs()
        flat = int(torch.argmax(diff))
        out[name] = {"max_abs_err": float(diff.max()), "elements": int(bad.sum()),
                     "of": int(bad.numel()), "worst": [float(g.reshape(-1)[flat]),
                                                       float(want.reshape(-1)[flat]),
                                                       float(init[name].reshape(-1)[flat])]}
    return out


def train_pserver(torch, card, readings):
    """DeepFM at the recsys widths (profile_recsys.RECSYS, the dense form)
    transpiled by DistributeTranspiler (sync, min_block_size 1) to 2 pservers
    and 2 trainers, each a process on this card (tools/pserver_cluster.py),
    PSERVER_STEPS rounds from one shared initialization. The mean of the
    trainers' losses against the one-process Executor on the concatenated
    batches (minimizing 2 x the loss, whose gradient is the trainers' sum,
    with the beta pows frozen as on the pservers), and the losses and the
    parameters the pservers write by checkpoint_notify against the
    one-process run grouped as the pservers group (local_grouped: each
    trainer's batch at its shapes, the gradients summed, the updates on
    the sums); the concatenated run's parameters are read beside. The
    trainers' step wall, bytes and send / recv share, and their GEMM
    epilogue launches."""
    import shutil
    import tempfile

    from paddle_tpu_torch import CUDAPlace, flags, fluid, io
    from paddle_tpu_torch.tools import pserver_cluster as pc
    from paddle_tpu_torch.tools import profile_recsys as recsys

    cfg = recsys.RECSYS
    place = CUDAPlace(0)
    flags.set_flags({"pass_pipeline": "training_fused"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pserver_")
    try:
        t0 = time.perf_counter()
        init = pc.init_arrays(fluid, "deepfm", cfg["lr"], 2, place, cfg=cfg)
        init_dir, ckpt_dir = os.path.join(tmp, "init"), os.path.join(tmp, "ckpt")
        io.save_arrays(init_dir, init)
        full = {n: v for n, v in init.items() if ".block" not in n}
        del init
        t_init = time.perf_counter() - t0
        cluster = pc.Cluster(_free_endpoints(2), n_trainers=2,
                             cwd=os.path.dirname(os.path.abspath(__file__)), model="deepfm",
                             steps=PSERVER_STEPS, lr=cfg["lr"], place="cuda",
                             pipeline="training_fused")
        t0 = time.perf_counter()
        try:
            res = cluster.run(pserver_args={"load_dir": init_dir},
                              trainer_args={"load_dir": init_dir, "save_dir": ckpt_dir,
                                            "save_after": PSERVER_STEPS}, timeout=600)
        finally:
            cluster.cleanup()
        t_cluster = time.perf_counter() - t0
        dist = np.mean([r["losses"] for r in res], axis=0)
        saved = io.load_arrays(ckpt_dir)
        cluster_params = {}
        for name in full:
            parts = sorted((int(k.rpartition(".block")[2]), v) for k, v in saved.items()
                           if k.rpartition(".block")[0] == name)
            cluster_params[name] = torch.cat([v for _, v in parts]) if parts else saved[name]
        del saved
        # the one-process run on the concatenated batches: the losses gate;
        # its parameters are read (Adam turns a gradient element that rounds
        # to the other sign into a step of the other sign)
        concat, cscope = pc.local_losses(fluid, "deepfm", cfg["lr"], 2, PSERVER_STEPS, place,
                                         init=full, cfg=cfg, summed=True)
        if not np.allclose(dist, concat, rtol=PSERVER_RTOL, atol=PSERVER_ATOL):
            raise AssertionError("train pserver: cluster losses %s, one process on the "
                                 "concatenated batches %s" % (dist.tolist(), concat))
        concat_params = _outside(torch, cluster_params, cscope, full)
        del cscope
        torch.cuda.empty_cache()
        # the one-process run grouped as the pservers group: losses and
        # parameters gate
        grouped, gscope = pc.local_grouped(fluid, "deepfm", cfg["lr"], 2, PSERVER_STEPS, place,
                                           init=full, cfg=cfg)
        if not np.allclose(dist, grouped, rtol=PSERVER_RTOL, atol=PSERVER_ATOL):
            raise AssertionError("train pserver: cluster losses %s, one process grouped as the "
                                 "pservers %s" % (dist.tolist(), grouped))
        grouped_params = _outside(torch, cluster_params, gscope, full)
        del gscope, cluster_params
        if any(v["elements"] for v in grouped_params.values()):
            raise AssertionError("train pserver: parameters outside rtol %g atol %g of the "
                                 "grouped one-process run: %s" % (PSERVER_RTOL, PSERVER_ATOL,
                                                                   json.dumps(grouped_params)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    trainers = []
    for r in res:
        rd = r["readings"]
        gemm = (rd["launches"].get("gemm_epilogue", 0), rd["dispatches"].get("gemm_epilogue", 0))
        if gemm != (3 * PSERVER_STEPS,) * 2:
            raise AssertionError("train pserver: a trainer launched and dispatched gemm_epilogue "
                                 "%s times, want %d" % (gemm, 3 * PSERVER_STEPS))
        walls = rd["walls_ms"]
        rpc_s = {k: v[1] for k, v in rd["host_ops"].items()}
        trainers.append({
            "step_p50_ms": float(np.median(walls[2:])),
            "bytes_sent_per_step": rd["bytes_sent"] / PSERVER_STEPS,
            "bytes_received_per_step": rd["bytes_received"] / PSERVER_STEPS,
            "send_share": rpc_s.get("send", 0.0) * 1e3 / sum(walls),
            "recv_share": rpc_s.get("recv", 0.0) * 1e3 / sum(walls),
            "barrier_share": (rpc_s.get("send_barrier", 0.0) + rpc_s.get("fetch_barrier", 0.0))
            * 1e3 / sum(walls),
            "walls_ms": walls, "launches": rd["launches"]})
    readings["train_pserver"] = {"trainers": trainers, "grouped_params": grouped_params,
                                 "concatenated_params": concat_params}
    log("train pserver: DeepFM %s, dense, DistributeTranspiler sync min_block_size 1, 2 pservers "
        "x 2 trainers as processes on this card, %d rounds; losses (trainer mean) %s; one process "
        "on the concatenated batches %s, grouped as the pservers %s (rtol %g atol %g); the "
        "pservers' checkpoint_notify parameters against the grouped run %s, against the "
        "concatenated run %s ([cluster, one process, init] at the worst element); trainers: %s; "
        "shared init %.1f s, the cluster's life %.1f s; card %s" % (
            json.dumps(cfg), PSERVER_STEPS, ["%.6f" % v for v in dist],
            ["%.6f" % v for v in concat], ["%.6f" % v for v in grouped], PSERVER_RTOL,
            PSERVER_ATOL, json.dumps(grouped_params), json.dumps(concat_params),
            json.dumps([{k: v for k, v in t.items() if k != "walls_ms"} for t in trainers]),
            t_init, t_cluster, card))
    return {"gemm_epilogue": sum(t["launches"].get("gemm_epilogue", 0) for t in trainers)}


# ---------------------------------------------------------------- eager mode

EAGER_STEPS = 60  # eager LeNet steps (tests/test_mnist.py's 60, its gates)
EAGER_CPU_STEPS = 3  # of them held against the port's own CPU run
EAGER_LAYER_TOL = 1e-4  # a layer on the card against the CPU, rtol (atol of the largest)
EAGER_BUSY_STEPS = 5  # eager steps profiled for the device busy share
EAGER_LR = 5e-3  # the eager Adam's rate (the JAX package's eager LeNet test's)


def _eager_lenet(imp, nn):
    """LeNet-5 at paddle_tpu/models/lenet.py's widths built from
    imperative.nn: conv 1 -> 6 5x5 pad 2 relu, max pool 2, conv 6 -> 16 5x5
    relu, max pool 2, fc 400 -> 120 relu, fc 120 -> 84 relu, fc 84 -> 10, a
    log-softmax loss Layer. A call gives (logits, loss)."""
    import torch

    class Loss(imp.Layer):
        def forward(self, logits, label):
            logp = torch.log_softmax(logits, dim=-1)
            return -logp.gather(1, label.long().reshape(-1, 1)).mean()

    class LeNet(imp.Layer):
        def __init__(self):
            super().__init__()
            self.convs = [self.add_sublayer(nn.Conv2D(1, 6, 5, padding=2, act="relu")),
                          self.add_sublayer(nn.Conv2D(6, 16, 5, act="relu"))]
            self.pool = nn.Pool2D(2)
            self.fcs = [self.add_sublayer(nn.FC(120, 400, act="relu")),
                        self.add_sublayer(nn.FC(84, 120, act="relu")),
                        self.add_sublayer(nn.FC(10, 84))]
            self.loss = Loss()

        def __call__(self, img, label):
            h = img
            for conv in self.convs:
                h = self.pool(conv(h))
            for fc in self.fcs:
                h = fc(h)
            return h, self.loss(h, imp.Variable(label, stop_gradient=True))

    return LeNet()


def _eager_batches(n):
    from paddle_tpu_torch.tools import profile_training as prof

    out = []
    for b in prof.mnist_reader()():
        out.append((np.stack([s[0] for s in b]).astype(np.float32),
                    np.asarray([s[1] for s in b], np.int64).reshape(-1, 1)))
        if len(out) == n:
            return out
    raise AssertionError("the mnist reader gave %d batches, want %d" % (len(out), n))


def _eager_train(imp, nn, net, place, batches, walls=None):
    """Eager Adam steps (EAGER_LR) of `net` over `batches`, a guard a step:
    (losses, accuracies)."""
    opt = nn.AdamOptimizer(net.parameters(), learning_rate=EAGER_LR)
    losses, accs = [], []
    for img, label in batches:
        t0 = time.perf_counter()
        with imp.guard(place):
            logits, loss = net(img, label)
            loss.backward()
            opt.step()
            opt.clear_gradients()
        losses.append(float(loss.numpy()))
        if walls is not None:
            walls.append((time.perf_counter() - t0) * 1e3)
        accs.append(float((logits.numpy().argmax(-1) == label.reshape(-1)).mean()))
    return losses, accs


def _eager_close(torch, name, got, want):
    """got (card) against want (CPU), numpy: rtol EAGER_LAYER_TOL, atol of
    the largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if got.shape != want.shape or not np.allclose(got, want, rtol=EAGER_LAYER_TOL,
                                                  atol=EAGER_LAYER_TOL * scale):
        raise AssertionError("eager %s: card against CPU max abs err %g (shape %s / %s)"
                             % (name, err, got.shape, want.shape))
    return err


def _eager_layer_cases(torch, imp, nn):
    """(name, make() -> layer, [inputs], steps, then eval) of the layers held
    once on the card against the CPU."""
    rng = np.random.RandomState(SEED + 7)

    class Tanh(imp.PyLayer):
        @staticmethod
        def forward(x, s):
            Tanh.saved = (x, s)
            return np.tanh(x) * s

        @staticmethod
        def backward(dy):
            x, s = Tanh.saved
            return dy * (1.0 - np.tanh(x) ** 2) * s, dy * np.tanh(x)

    class MLP(imp.Layer):
        def __init__(self):
            super().__init__()
            self.w1 = self.create_parameter([512, 1024])
            self.b1 = self.create_parameter([1024], initializer=0.0)
            self.w2 = self.create_parameter([1024, 512])

        def forward(self, x, w1, b1, w2):
            return torch.relu(x @ w1 + b1) @ w2

    x4 = (rng.randn(64, 32, 14, 14) * 2 + 1).astype(np.float32)
    return [
        ("batch_norm", lambda: nn.BatchNorm(32), [x4], 2, True),
        ("layer_norm", lambda: nn.LayerNorm(512), [rng.randn(256, 512).astype(np.float32)], 1,
         False),
        ("embedding_padding_idx", lambda: nn.Embedding(size=[1000, 128], padding_idx=0),
         [rng.randint(0, 1000, (64, 20)).astype(np.int64) * (rng.rand(64, 20) > 0.2)], 1, False),
        ("pylayer", lambda: Tanh, [rng.randn(256, 64).astype(np.float32),
                                  rng.randn(256, 64).astype(np.float32)], 1, False),
        ("jit", lambda: MLP().jit(), [rng.randn(256, 512).astype(np.float32)], 1, False),
    ]


def _eager_layer_run(torch, imp, layer, inputs, place, pylayer):
    """(output, input grad, [param grads]) of one traced call under a
    weighted-sum loss."""
    with imp.guard(place):
        xs = [imp.to_variable(a) for a in inputs]
        if pylayer:
            xs[1].stop_gradient = True
            y = layer.apply(*xs)
        else:
            y = layer(*xs)
        w = torch.from_numpy(np.random.RandomState(SEED + 9).randn(*y.shape).astype(np.float32))

        class Weighted(imp.Layer):
            def forward(self, t):
                return (t * w.to(t.device)).sum()

        Weighted()(y).backward()
        params = [] if pylayer else [p.gradient() for p in layer.parameters()]
        xg = xs[0].gradient() if xs[0].value.is_floating_point() else None
    return y.numpy(), xg, params


def eager(torch, card, readings):
    """Eager mode on the card: the LeNet-5 of models/lenet.py built from
    imperative.nn, EAGER_STEPS steps of batch 64 with the eager Adam on
    fluid.dataset.mnist's batches as train lenet reads them (a guard a
    step), the gates of tests/test_mnist.py:64-67, the first EAGER_CPU_STEPS
    losses against the port's own CPU run from the same weights (rtol 2e-3,
    atol 2e-4); BatchNorm (train, then eval, its running statistics),
    LayerNorm, Embedding with padding_idx, a PyLayer (a stop_gradient
    input) and Layer.jit() (torch.compile, inductor) once each on the card
    against the CPU at rtol 1e-4; DataParallel at world 1 bit for bit the
    plain layer. Readings: the step wall p50 and the device busy share."""
    import itertools

    from paddle_tpu_torch import CUDAPlace, CPUPlace, convert, imperative as imp
    from paddle_tpu_torch.imperative import nn

    card_place, cpu = CUDAPlace(0), CPUPlace()
    batches = _eager_batches(EAGER_STEPS)
    state = np.random.get_state()
    np.random.seed(SEED)
    try:
        with imp.guard(cpu):
            cpu_net = _eager_lenet(imp, nn)
    finally:
        np.random.set_state(state)
    init = [p.numpy() for p in cpu_net.parameters()]

    def card_net():
        with imp.guard(card_place):
            return convert.load_imperative(_eager_lenet(imp, nn), init)

    net = card_net()
    if net.parameters()[0].value.device.type != card_place.torch_device().type:
        raise AssertionError("eager: the LeNet's parameters are not on the card")
    walls = []
    losses, accs = _eager_train(imp, nn, net, card_place, batches, walls)
    first5, last5, acc5 = (float(np.mean(losses[:5])), float(np.mean(losses[-5:])),
                           float(np.mean(accs[-5:])))
    if not (last5 < 0.7 * first5 and acc5 > 0.5):
        raise AssertionError("eager lenet did not learn: loss %.4f -> %.4f, accuracy %.3f"
                             % (first5, last5, acc5))
    cpu_losses, _ = _eager_train(imp, nn, cpu_net, cpu, batches[:EAGER_CPU_STEPS])
    if not np.allclose(losses[:EAGER_CPU_STEPS], cpu_losses, rtol=FUSED_RTOL, atol=FUSED_ATOL):
        raise AssertionError("eager lenet: card losses %s against the CPU's %s"
                             % (losses[:EAGER_CPU_STEPS], cpu_losses))
    # the device busy share over a few more steps (torch.profiler's kernels
    # and copies, summed)
    step_batches = itertools.cycle(batches[:EAGER_BUSY_STEPS])
    opt = nn.AdamOptimizer(net.parameters(), learning_rate=EAGER_LR)

    def one():
        img, label = next(step_batches)
        with imp.guard(card_place):
            _, loss = net(img, label)
            loss.backward()
            opt.step()
            opt.clear_gradients()
        return float(loss.numpy())

    busy_ms = profiled_device_ms(torch, one, EAGER_BUSY_STEPS)
    wall_p50 = float(np.median(walls[2:]))

    # DataParallel at world 1: the plain layer bit for bit
    plain, wrapped = card_net(), imp.DataParallel(card_net())
    img, label = batches[0]
    outs = []
    for model in (plain, wrapped):
        with imp.guard(card_place):
            _, loss = model(img, label)
            loss.backward()
            if model is wrapped:
                model.apply_collective_grads()
        outs.append([loss.value] + [p._grad for p in model.parameters()])
    if not all(_bits_equal(torch, a, b) for a, b in zip(*outs)):
        raise AssertionError("eager: DataParallel at world 1 differs from the plain layer")

    # the other layers, once each on the card against the CPU
    errs = {}
    for name, make, inputs, steps, then_eval in _eager_layer_cases(torch, imp, nn):
        pylayer = name == "pylayer"
        state = np.random.get_state()
        np.random.seed(SEED + 3)
        try:
            with imp.guard(cpu):
                ref = make()
        finally:
            np.random.set_state(state)
        with imp.guard(card_place):
            got = make()
        if not pylayer:
            convert.load_imperative(got, [p.numpy() for p in ref.parameters()])
        err = 0.0
        for _ in range(steps):
            want = _eager_layer_run(torch, imp, ref, inputs, cpu, pylayer)
            have = _eager_layer_run(torch, imp, got, inputs, card_place, pylayer)
            for i, (h, w) in enumerate(zip(have[:2] + tuple(have[2]), want[:2] + tuple(want[2]))):
                if w is not None:
                    err = max(err, _eager_close(torch, "%s output %d" % (name, i), h, w))
        if name == "batch_norm":
            for (gm, gv), (wm, wv) in zip(convert.running_stats(got), convert.running_stats(ref)):
                err = max(err, _eager_close(torch, "batch_norm running mean", gm, wm),
                          _eager_close(torch, "batch_norm running var", gv, wv))
        if then_eval:
            ref.eval()
            got.eval()
            err = max(err, _eager_close(torch, "%s eval" % name,
                                        _eager_layer_run(torch, imp, got, inputs, card_place,
                                                         pylayer)[0],
                                        _eager_layer_run(torch, imp, ref, inputs, cpu,
                                                         pylayer)[0]))
        if name == "embedding_padding_idx":
            out = _eager_layer_run(torch, imp, got, inputs, card_place, pylayer)[0]
            if np.abs(out[inputs[0].reshape(out.shape[:2]) == 0]).max() != 0:
                raise AssertionError("eager embedding: padding rows are not zero")
        errs[name] = err
    readings["eager"] = {"eager": {
        "step_p50_ms": wall_p50, "images_per_s": 64 / (wall_p50 / 1e3),
        "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_p50}}
    log("eager: LeNet-5 (imperative.nn, the widths of models/lenet.py) %d eager Adam steps of "
        "batch 64 on the card, a guard a step: losses %.4f -> %.4f (first and last 5), accuracy "
        "of the last 5 %.3f; the first %d losses %s against the CPU's %s (rtol %g atol %g); step "
        "wall p50 %.3f ms (steps 3-%d, the loss read each step), %.1f images/s; device busy "
        "%.3f ms a step (torch.profiler, %d steps), busy share %.3f; DataParallel at world 1 "
        "bit for bit the plain layer (loss and every grad); card against CPU, max abs err %s "
        "(rtol %g, atol of the largest); card %s" % (
            EAGER_STEPS, first5, last5, acc5, EAGER_CPU_STEPS,
            ["%.6f" % v for v in losses[:EAGER_CPU_STEPS]], ["%.6f" % v for v in cpu_losses],
            FUSED_RTOL, FUSED_ATOL, wall_p50, EAGER_STEPS, 64 / (wall_p50 / 1e3), busy_ms,
            EAGER_BUSY_STEPS, busy_ms / wall_p50, json.dumps({k: float("%.3g" % v)
                                                               for k, v in errs.items()}),
            EAGER_LAYER_TOL, card))


# ---------------------------------------------------------------- telemetry

TELEMETRY_STEPS = 6  # graph steps of train_flash fed through layers.py_reader, each form
TELEMETRY_INTERVAL = 2  # FLAGS_telemetry_interval_steps
TENSOR_STATS_GLOB = "*layer_norm*"
TENSOR_STATS_TOL = 1e-5  # rtol, and atol as a share of each row's absmax
OP_PROFILE_COVERAGE = 0.95  # per-op device ms against the trace's kernel time
TELEMETRY_METRICS = ("steps_total", "step_ms", "input/feed_stall_ms_total",
                     "compile_cache/hits", "compile_cache/misses", "nan_guard/trips")


def _tstat_rows(torch, tensors):
    """[mean, std, absmax, nonfinite] of each tensor, as the executor
    computes them on the device."""
    rows = []
    for t in tensors:
        x = t.detach().float()
        rows.append(torch.stack([x.mean(), x.std(correction=0), x.abs().amax(),
                                 (~torch.isfinite(x)).sum().float()]))
    return torch.stack(rows).cpu().numpy()


def _telemetry_reader_steps(torch, exe, main_prog, scope, loss, batches, reader, prof, walls,
                            deltas):
    """One step a batch pulled from the program's layers.py_reader; the
    last one profiled for its host syncs. Returns (losses, its syncs)."""
    from paddle_tpu_torch.ops import fused

    reader.decorate_tensor_provider(lambda: (prof.reader_feed(main_prog, b) for b in batches))
    reader.start()
    losses, syncs = [], None
    for i in range(len(batches)):
        before = fused.stats()
        t0 = time.perf_counter()
        if i == len(batches) - 1:
            (lv,), syncs = _host_syncs(torch, lambda: exe.run(main_prog, fetch_list=[loss.name],
                                                              scope=scope))
        else:
            (lv,) = exe.run(main_prog, fetch_list=[loss.name], scope=scope)
            walls.append((time.perf_counter() - t0) * 1e3)
        deltas.append(_launch_delta(before, fused.stats()))
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    reader.reset()
    return losses, syncs


def telemetry(torch, card, readings):
    """Step telemetry and op-level attribution on train_flash's path
    (Transformer base, f32, training_fused, use_flash):
    - TELEMETRY_STEPS graph steps fed through layers.py_reader with
      FLAGS_telemetry_dir set (interval TELEMETRY_INTERVAL), against the
      same steps with telemetry off in the same call: the step records and
      their fields, the feed-stall the collector recorded, the Prometheus
      file parsed by promparse equal to default_registry().snapshot() (the
      telemetry metrics), the shard merged by rank 0, equal host syncs a
      step on and off, the same losses; the step wall p50 of each;
    - FLAGS_tensor_stats="*layer_norm*" on the feed-dict form: the flag
      change captures a new graph, a replay makes one host sync more than a
      step without it, and its rows equal the statistics of the same
      outputs fetched on the op-by-op path from the same state and
      generator state (rtol 1e-5 with atol 1e-5 of absmax; nonfinite
      counts exactly);
    - FLAGS_nan_provenance with the NaN guard and the nan_grad fault: the
      record names the first op that reads the poisoned feed, the rollback
      bit for bit, the replay's wall;
    - one op-by-op step under profiler.xla_trace: device_op_profile's
      per-op device ms within 5 % of the trace's kernel time, the top rows
      with the H100's Roof%; a replayed step's trace raises.
    Returns the kernels' launches over the telemetry-on steps."""
    import shutil
    import tempfile

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, profiler
    from paddle_tpu_torch.executor import _run_ops
    from paddle_tpu_torch.observability import export, opprof, promparse, registry, stepstats
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.resilience import faults, health
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = prof.BASE_FLASH
    place = CUDAPlace(0)
    flags.set_flags({"pass_pipeline": "training_fused"})
    main_prog, startup, loss = prof.build(cfg, reader=True)
    reader = main_prog._py_readers[0]
    init = _startup_state(startup)
    batches = [prof.make_batch(cfg, SEED + 300 + i) for i in range(TELEMETRY_STEPS)]

    def fresh():
        scope = Scope(seed=SEED, place=place)
        for name, value in init.items():
            scope.set_var(name, value.clone())
        return scope, Executor(place)

    col = stepstats.collector()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        # telemetry off, then on, each from the startup state
        walls, deltas, losses, syncs = {}, {}, {}, {}
        for on in (False, True):
            if on:
                col.close()
                col.reset()
                flags.set_flags({"telemetry_dir": tmp,
                                 "telemetry_interval_steps": TELEMETRY_INTERVAL})
                stall0 = sum(registry.default_registry().snapshot().get(
                    "input/feed_stall_ms_total", {}).get("values", {"": 0.0}).values())
            scope, exe = fresh()
            walls[on], deltas[on] = [], []
            if on:
                fused.reset_stats()  # the main path's counting window opens here
            losses[on], syncs[on] = _telemetry_reader_steps(
                torch, exe, main_prog, scope, loss, batches, reader, prof, walls[on], deltas[on])
            del scope, exe
        snap = registry.default_registry().snapshot()
        flags.set_flags({"telemetry_dir": ""})
        col.close()
        _same_bits("telemetry on against off, loss at step", losses[True], losses[False])
        if syncs[True] != syncs[False]:
            raise AssertionError("telemetry: host syncs a step %s on, %s off"
                                 % (syncs[True], syncs[False]))
        recs = export.read_records(os.path.join(tmp, "telemetry-host0.jsonl"))
        steps = [r for r in recs if r["kind"] == "step"]
        fields = {"kind", "step", "ts", "host", "wall_ms", "n_steps", "feed_stall_ms",
                  "cache_hit", "nan_trip", "training", "loss"}
        if len(steps) != TELEMETRY_STEPS or any(set(r) != fields for r in steps) or \
                [r["step"] for r in steps] != list(range(1, TELEMETRY_STEPS + 1)) or \
                not all(r["training"] and not r["nan_trip"] for r in steps) or \
                [r["cache_hit"] for r in steps] != [False] + [True] * (TELEMETRY_STEPS - 1):
            raise AssertionError("telemetry: step records %s" % steps)
        np.testing.assert_allclose([r["loss"] for r in steps], losses[True], rtol=1e-6)
        stall = sum(snap["input/feed_stall_ms_total"]["values"].values()) - stall0
        stalls = [r["feed_stall_ms"] for r in steps]
        if not stall > 0 or abs(sum(stalls) - stall) > 1e-3 * max(1.0, stall):
            raise AssertionError("telemetry: feed-stall %r ms in the counter, %r in the records"
                                 % (stall, stalls))
        snaps = [r for r in recs if r["kind"] == "snapshot"]
        if len(snaps) != TELEMETRY_STEPS // TELEMETRY_INTERVAL:
            raise AssertionError("telemetry: %d snapshot records" % len(snaps))
        with open(os.path.join(tmp, "metrics-host0.prom")) as f:
            parsed = promparse.parse(f.read())
        # (a metric with no sample has no line in the file)
        mine = {n: snap[n] for n in TELEMETRY_METRICS
                if n in snap and (snap[n]["kind"] == "histogram" or snap[n].get("values"))}
        if {n: parsed.get(n) for n in mine} != mine:
            raise AssertionError("telemetry: the Prometheus file reads back %s, the registry "
                                 "holds %s" % ({n: parsed.get(n) for n in mine}, mine))
        merged = export.merge_host_shards(tmp)
        if export.read_records(merged) != sorted(recs, key=lambda r: (r["ts"], r["host"])):
            raise AssertionError("telemetry: the merged view differs from the shard")
        p50 = {on: float(np.median(w[2:])) for on, w in walls.items()}
        launches = {}
        names = {"flash_bwd_fused": "flash_bwd", "flash_bwd_fused_causal": "flash_bwd_causal"}
        for delta in deltas[True]:
            for k, v in delta.items():
                launches[names.get(k, k)] = launches.get(names.get(k, k), 0) + v

        # FLAGS_tensor_stats on the feed-dict form
        fmain, fstartup, floss = prof.build(cfg)
        fbatches = [prof.make_batch(cfg, SEED + 400 + i) for i in range(4)]
        scope, exe = fresh()

        def run(feed, fetch=None, **kw):
            return exe.run(fmain, feed=feed, fetch_list=fetch or [floss.name], scope=scope, **kw)

        def replay_walls():
            walls = []
            for b in fbatches:
                t0 = time.perf_counter()
                run(b)
                walls.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(walls))

        run(fbatches[0])
        run(fbatches[1])  # captured
        plain_ms = replay_walls()
        (_,), plain_syncs = _host_syncs(torch, lambda: run(fbatches[2]))
        captures0 = Executor.stats()["graphs"].get("captures", 0)
        flags.set_flags({"tensor_stats": TENSOR_STATS_GLOB})
        run(fbatches[0])  # a new block: the warmup
        run(fbatches[1])  # its capture
        if Executor.stats()["graphs"].get("captures", 0) - captures0 != 1:
            raise AssertionError("tensor_stats: the flag change captured %d graphs"
                                 % (Executor.stats()["graphs"].get("captures", 0) - captures0))
        stat_ms = replay_walls()
        state = {n: t.clone() for n, t in scope.vars.items() if n in init}
        gen = scope.device_generator.get_state()
        (_,), stat_syncs = _host_syncs(torch, lambda: run(fbatches[2]))
        rows = opprof.last_tensor_stats()
        if sum(stat_syncs.values()) != sum(plain_syncs.values()) + 1:
            raise AssertionError("tensor_stats: a replay made host syncs %s, without it %s"
                                 % (stat_syncs, plain_syncs))
        # the same step op by op from the same state: the matched outputs
        # fetched, their statistics computed by the same expressions
        for n, t in state.items():
            scope.vars[n].copy_(t)
        scope.device_generator.set_state(gen)
        flags.set_flags({"tensor_stats": ""})
        names_spec = [name for name in rows]
        vars_ = [name.split(":", 1)[1] for name in names_spec]
        with op_by_op():
            fetched = run(fbatches[2], [floss.name] + vars_, return_numpy=False)
        want = _tstat_rows(torch, fetched[1:])
        got = np.asarray([[rows[n]["mean"], rows[n]["std"], rows[n]["absmax"],
                           rows[n]["nonfinite"]] for n in names_spec])
        for (name, g, w) in zip(names_spec, got, want):
            if g[3] != w[3] or not np.allclose(g[:3], w[:3], rtol=TENSOR_STATS_TOL,
                                               atol=TENSOR_STATS_TOL * max(w[2], 1e-30)):
                raise AssertionError("tensor_stats %s: %s on the graph, %s op by op"
                                     % (name, g.tolist(), w.tolist()))
        stats_err = float(np.abs(got[:, :3] - want[:, :3]).max())

        # FLAGS_nan_provenance with the guard and the nan_grad fault
        flags.set_flags({"nan_provenance": True, "resilience_nan_guard": True})
        try:
            t0 = time.perf_counter()
            run(fbatches[3])
            guard_ms = (time.perf_counter() - t0) * 1e3
            before = {n: scope.vars[n].clone() for n in init}
            health.reset()
            faults.install("nan_grad:step=1")
            t0 = time.perf_counter()
            try:
                (lv,) = run(fbatches[3])
            finally:
                faults.install(None)
            prov_ms = (time.perf_counter() - t0) * 1e3
        finally:
            flags.set_flags({"nan_provenance": False, "resilience_nan_guard": False})
        decay = flags.get_flags("resilience_lr_decay")["resilience_lr_decay"]
        lr_names = [n for n in before if n.rsplit("/", 1)[-1].startswith("learning_rate")]
        bad = _differing(torch, {n: scope.vars[n] for n in before},
                         dict(before, **{n: before[n] * decay for n in lr_names}))
        if bad or not lr_names or not np.isnan(lv).all():
            raise AssertionError("nan_provenance: the guarded step left %s changed (loss %r)"
                                 % (bad, lv))
        prov = opprof.last_provenance()
        if prov is None or health.get("nan_provenance") != 1:
            raise AssertionError("nan_provenance: no record (health %d)"
                                 % health.get("nan_provenance"))
        ops = next(_run_ops(c) for c in exe._cache.values()
                   if any(opprof.op_display_name(op) == prov["op"] for op in _run_ops(c)))
        poisoned = sorted(n for n, v in fbatches[3].items() if np.asarray(v).dtype.kind == "f")[0]
        first = next(op for op in ops if poisoned in op.input_arg_names)
        if prov["op"] != opprof.op_display_name(first):
            raise AssertionError("nan_provenance: the record names %s, the first op reading %s "
                                 "is %s" % (prov["op"], poisoned, opprof.op_display_name(first)))
        del before

        # one op-by-op step under xla_trace, and a replayed one
        trace_dir = os.path.join(tmp, "trace")
        with op_by_op(), profiler.xla_trace(trace_dir):
            t0 = time.perf_counter()
            run(fbatches[0])
            traced_ms = (time.perf_counter() - t0) * 1e3
        table = profiler.device_op_profile(trace_dir, print_table=False)
        total = sum(r[1] for r in table.values())
        per_op = sum(r[1] for k, r in table.items() if not k.startswith("kernel:"))
        outside = sorted(((r[1], k) for k, r in table.items() if k.startswith("kernel:")),
                         reverse=True)[:8]
        if not total or per_op / total < OP_PROFILE_COVERAGE:
            raise AssertionError("device_op_profile: per-op %.3f of %.3f kernel ms; the largest "
                                 "outside every op range: %s" % (per_op, total, outside))
        avals = {n: np.asarray(v) for n, v in fbatches[0].items()}
        rec = opprof.device_profile(exe, trace_dir, block=fmain.global_block(), feed_avals=avals)
        graph_dir = os.path.join(tmp, "graph_trace")
        with profiler.xla_trace(graph_dir):
            run(fbatches[1])
        with _raises(RuntimeError, "device_op_profile over a replayed graph's trace"):
            profiler.device_op_profile(graph_dir, print_table=False)
        del scope, exe
    finally:
        flags.set_flags({"telemetry_dir": "", "tensor_stats": "", "nan_provenance": False,
                         "resilience_nan_guard": False})
        col.close()
        col.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    readings["telemetry"] = {"graph": {
        "step_p50_ms_telemetry_on": p50[True], "step_p50_ms_telemetry_off": p50[False],
        "host_syncs_a_step": sum(syncs[True].values()),
        "tensor_stats_step_p50_ms": stat_ms, "tensor_stats_off_step_p50_ms": plain_ms,
        "tensor_stats_host_syncs": sum(stat_syncs.values()),
        "provenance_step_ms": prov_ms, "guarded_step_ms": guard_ms,
        "op_profile_coverage": per_op / total}}
    log("telemetry: train_flash %s, %d graph steps through layers.py_reader with "
        "FLAGS_telemetry_dir (interval %d) against the same steps off: losses bit for bit, host "
        "syncs a step %s on and %s off, %d step records (%s), %d snapshot records, feed-stall "
        "%.3f ms over the steps (records %s), the Prometheus file read back by promparse equal to "
        "the registry's %s, the shard merged; step wall p50 %.3f ms on, %.3f ms off (steps "
        "3-%d); tensor_stats %r: one capture more, replay wall p50 %.3f ms against %.3f ms "
        "without (%d replays each), host syncs %s (without: %s), %d rows against the op-by-op fetches, max abs err %.3g (rtol %g, atol %g of "
        "absmax), nonfinite counts equal; nan_provenance with the guard and nan_grad: the "
        "record names %s (the first op reading %r), the tripped step with the replay %.3f ms "
        "against a guarded step %.3f ms; one op-by-op step under xla_trace (%.3f ms): per-op "
        "device ms %.3f of %.3f kernel ms (%.2f %%; outside every op range, the largest: %s), "
        "a replayed step's trace raises; card %s"
        % (json.dumps(cfg), TELEMETRY_STEPS, TELEMETRY_INTERVAL, json.dumps(syncs[True]),
           json.dumps(syncs[False]), len(steps), sorted(fields), len(snaps), stall,
           ["%.3f" % s for s in stalls], list(mine), p50[True], p50[False], TELEMETRY_STEPS,
           TENSOR_STATS_GLOB, stat_ms, plain_ms, len(fbatches), json.dumps(stat_syncs),
           json.dumps(plain_syncs),
           len(names_spec), stats_err, TENSOR_STATS_TOL, TENSOR_STATS_TOL, prov["op"], poisoned,
           prov_ms, guard_ms, traced_ms, per_op, total, 100.0 * per_op / total,
           [(round(ms, 4), k) for ms, k in outside], card))
    log("telemetry: the op-by-op step's device profile (torch.profiler, Roof%% against the "
        "H100's %g TFLOP/s and %g GB/s)\n%s" % (rec["peak_tflops"], rec["peak_bw_gbs"],
                                                opprof.render_table(rec, top=12)))
    return launches


ONLINE_STEPS = 60  # stream batches (bench.py run_online_bench: interval * (10 swaps + 2))
ONLINE_INTERVAL = 5  # steps between publishes: 12 versions, 1 base and 11 deltas
ONLINE_CLIENTS = 4  # urllib :predict clients while the trainer publishes
ONLINE_MAX_STALENESS = 50  # StalenessContract(max_staleness_steps)
ONLINE_PARITY = 4  # served versions restored from load_with_deltas, bit for bit
ONLINE_GEMM_PER_STEP = 3  # the DeepFM fc chain's GEMM epilogue launches a step


def _pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def online(torch, card, readings):
    """The online loop at DeepFM's full widths (bench.py run_online_bench
    over profile_recsys.RECSYS: 2^20 x 32 table, 16 fields, batch 512,
    layer_sizes (32, 16); is_sparse and use_distributed, SGD 0.05, on CUDA
    graphs under training_fused): an OnlineTrainer publishes every
    ONLINE_INTERVAL steps into a repository on local disk (a base, then
    deltas of the touched rows; StalenessContract(50)); one ModelServer in
    this process serves the saved inference model from a ServingEngine on
    CUDA graphs (bucket 2: a reply's batch is its request's) while a
    HotReloader lands every version and ONLINE_CLIENTS urllib clients post
    :predict. Gates: every reply 200; each client's versions monotone;
    every published version applied, reload_errors 0; the staleness gauge
    within the contract; at ONLINE_PARITY served versions a fresh engine
    restored from load_with_deltas(upto_step=k) gives the served reply bit
    for bit; the GEMM epilogue launched 3 times a step. Returns the
    launches of the threaded steps."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, scope_guard
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.online import (HotReloader, ModelPublisher, OnlineTrainer,
                                         StalenessContract, read_latest)
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.resilience import async_ckpt
    from paddle_tpu_torch.serving import ModelServer, ServingEngine
    from paddle_tpu_torch.tools import profile_recsys as recsys

    cfg = dict(recsys.RECSYS, optimizer="sgd", lr=0.05)
    model = recsys.build_deepfm(cfg, is_sparse=True, use_distributed=True)
    main_prog, loss = model["main"], model["loss"]
    flags.set_flags({"pass_pipeline": "training_fused"})
    place = CUDAPlace(0)
    contract = StalenessContract(max_staleness_steps=ONLINE_MAX_STALENESS)
    rng = np.random.RandomState(SEED + 11)
    batches = recsys.recsys_batches(rng, cfg["rows"], cfg["fields"], cfg["batch"], ONLINE_STEPS)
    feed_ids = rng.randint(0, cfg["rows"], (2, cfg["fields"], 1)).astype("int64")
    payload = json.dumps({"inputs": {"ids": feed_ids.tolist()}}).encode()
    work = tempfile.mkdtemp(prefix="chip_smoke_online_")
    srv = reloader = None
    try:
        repo, model_dir = os.path.join(work, "repo"), os.path.join(work, "model")
        exe, scope = Executor(place), Scope(seed=SEED, place=place)
        with scope_guard(scope):
            exe.run(model["startup"])
            pio.save_inference_model(model_dir, ["ids"], [model["pred"]], exe,
                                     main_program=main_prog)
        srv = ModelServer(port=0)
        eng = srv.add_model("ctr", model_dir, place=place, batch_buckets=(2,),
                            batcher_opts={"max_batch_delay_ms": 1.0})
        base_url = "http://127.0.0.1:%d" % srv.start()
        trainer = OnlineTrainer(exe, main_prog, repo, eng.param_names(),
                                publisher=ModelPublisher(repo, max_chain=ONLINE_STEPS,
                                                         contract=contract),
                                publish_interval=ONLINE_INTERVAL, scope=scope)
        publishes = []  # (version, kind, wall ms)
        orig_publish = trainer.publisher.publish

        def timed_publish(*a, **kw):
            t0 = time.perf_counter()
            ptr = orig_publish(*a, **kw)
            if ptr is not None:
                publishes.append((ptr["version"], ptr["kind"], (time.perf_counter() - t0) * 1e3))
            return ptr

        trainer.publisher.publish = timed_publish
        reloader = HotReloader(repo, {"ctr": eng}, consumer="smoke", poll_interval_s=0.02,
                               contract=contract)
        stream = iter(batches)
        # the first interval alone: the step's warmup and capture, and the
        # base, before any other thread touches the card
        with scope_guard(scope):
            curve = trainer.run(stream, fetch_list=[loss.name], max_steps=ONLINE_INTERVAL)
        if reloader.check_once() != 1:
            raise AssertionError("online: the base version did not land")
        reloader.start()

        stop = threading.Event()
        per_client = [[] for _ in range(ONLINE_CLIENTS)]  # (version, out, ms)
        errors, stale = [], []

        def client(i):
            while not stop.is_set():
                req = urllib.request.Request(base_url + "/v1/models/ctr:predict", data=payload,
                                             headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
                        code, doc = r.status, json.loads(r.read())
                except Exception as e:
                    errors.append(repr(e))
                    continue
                ms = (time.perf_counter() - t0) * 1e3
                if code != 200:
                    errors.append(code)
                    continue
                (out,) = doc["outputs"].values()
                per_client[i].append((int(doc["model_version"]), np.asarray(out, np.float32), ms))

        def sample_staleness():
            # the reloader's gauge, and the steps the served version trails
            # the newest published one
            snap = registry.default_registry().snapshot()
            for v in ((snap.get("online/serving_staleness_steps") or {}).get("values")
                      or {}).values():
                stale.append(float(v))
            latest = read_latest(repo)
            if latest:
                stale.append(float(latest["version"] - eng.model_version))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(ONLINE_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        torch.cuda.synchronize()
        fused.reset_stats()  # the main path's counting window opens here
        wall = []

        def train():
            t0 = time.perf_counter()
            with scope_guard(scope):
                curve.extend(trainer.run(stream, fetch_list=[loss.name], max_steps=ONLINE_STEPS))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)

        tthread = threading.Thread(target=train, daemon=True)
        tthread.start()
        while tthread.is_alive():
            tthread.join(0.05)
            sample_staleness()
        launches = dict(fused.stats()["launches"])  # and closes here
        if not wall:
            raise AssertionError("online: the trainer thread failed")
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            latest = read_latest(repo)
            if latest and reloader.applied_version == latest["version"]:
                break
            time.sleep(0.05)
            sample_staleness()
        time.sleep(0.3)  # replies against the final version
        stop.set()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        if any(t.is_alive() for t in threads):
            raise AssertionError("online: a client did not stop")
        reloader.stop()
        srv.stop(drain=True)
        srv = None

        steps_threaded = ONLINE_STEPS - ONLINE_INTERVAL
        want = ONLINE_GEMM_PER_STEP * steps_threaded
        if launches.get("gemm_epilogue") != want:
            raise AssertionError("online: gemm_epilogue launched %s times over %d steps, want %d"
                                 % (launches.get("gemm_epilogue"), steps_threaded, want))
        published = [v for v, _, _ in publishes]
        applied = [h["version"] for h in reloader.history]
        kinds = [h["kind"] for h in reloader.history]
        samples = [s for cs in per_client for s in cs]
        if errors:
            raise AssertionError("online: %d failed replies: %s" % (len(errors), errors[:5]))
        for i, cs in enumerate(per_client):
            vs = [v for v, _, _ in cs]
            if not cs or vs != sorted(vs):
                raise AssertionError("online: client %d saw versions %s" % (i, vs))
        if published != list(range(ONLINE_INTERVAL, ONLINE_STEPS + 1, ONLINE_INTERVAL)) or \
                applied != published or kinds != ["base"] + ["delta"] * (len(published) - 1):
            raise AssertionError("online: published %s, applied %s (%s)"
                                 % (published, applied, kinds))
        if reloader.errors or reloader.reloads != len(published):
            raise AssertionError("online: reload errors %d, reloads %d"
                                 % (reloader.errors, reloader.reloads))
        table_bytes = cfg["rows"] * cfg["dim"] * 4
        moved = [(h["version"], h["h2d_bytes"]) for h in reloader.history if h["kind"] == "delta"]
        if any(not 0 < h2d < table_bytes for _, h2d in moved):
            raise AssertionError("online: deltas copied (version, bytes) %s to the card, want "
                                 "only their rows (a table is %d bytes)" % (moved, table_bytes))
        if max(stale or [0.0]) > contract.max_staleness_steps:
            raise AssertionError("online: staleness %s steps past the contract's %d"
                                 % (max(stale), contract.max_staleness_steps))
        if not all(np.isfinite(curve)) or len(curve) != len(published):
            raise AssertionError("online: loss curve %s" % curve)

        by_version = {}
        for v, out, _ in samples:
            by_version.setdefault(v, out)
        check = sorted(v for v in by_version if v > 0)[-ONLINE_PARITY:]
        if len(check) < ONLINE_PARITY:
            raise AssertionError("online: clients saw only versions %s" % sorted(by_version))
        for k in check:
            step_k, arrays, _ = async_ckpt.load_with_deltas(repo, upto_step=k)
            off = ServingEngine(model_dir, name="online_off%d" % k, place=place,
                                batch_buckets=(2,))
            off.set_params(arrays, version=k)
            off.warmup()
            (out_k,) = off.run({"ids": feed_ids})
            if step_k != k or np.asarray(out_k, np.float32).tobytes() != by_version[k].tobytes():
                raise AssertionError("online: version %d served %s, restored %s"
                                     % (k, by_version[k].ravel(), np.asarray(out_k).ravel()))
            del off, arrays
        torch.cuda.empty_cache()
    finally:
        if reloader is not None:
            reloader.stop()
        if srv is not None:
            srv.stop(drain=False)
        shutil.rmtree(work, ignore_errors=True)

    lat = [ms for _, _, ms in samples]
    deltas = [h for h in reloader.history if h["kind"] == "delta"]
    pub_ms = {k: [ms for _, kind, ms in publishes if kind == k] for k in ("base", "delta")}
    reading = {
        "rows_per_s_while_serving": cfg["batch"] * steps_threaded / wall[0],
        "steps": ONLINE_STEPS, "versions": published,
        "publish_ms": {"base": pub_ms["base"][0], "delta_p50": float(np.median(pub_ms["delta"]))},
        "reload_ms": {"base": reloader.history[0]["ms"],
                      "delta_p50": float(np.median([h["ms"] for h in deltas])),
                      "delta_read_p50": float(np.median([h["read_ms"] for h in deltas]))},
        "delta_h2d_bytes": deltas[0]["h2d_bytes"],
        "predict_p50_ms": _pct(lat, 50), "predict_p99_ms": _pct(lat, 99),
        "requests": len(samples), "max_staleness_steps_seen": max(stale or [0.0]),
        "parity_versions": check, "launches": {"gemm_epilogue": launches["gemm_epilogue"]},
        "losses": curve,
    }
    readings["online"] = reading
    log("online: DeepFM %s, is_sparse and use_distributed, SGD(0.05), training_fused on CUDA "
        "graphs; %d steps, a version every %d (1 base + %d deltas, StalenessContract(%d)): "
        "trainer %.1f rows/s while serving (%d steps threaded, %.3f s); publish wall base %.1f ms, "
        "delta p50 %.2f ms; reload wall base %.1f ms, delta p50 %.2f ms (%.2f ms of it reading the "
        "delta's files; the first delta %d bytes host to device, none back: its rows "
        "scattered into the served table); %d :predict "
        "replies from %d clients, all 200, versions monotone per client, p50 %.3f ms, p99 %.3f ms; "
        "every version applied, reload_errors 0; staleness at most %s steps; versions %s restored "
        "from load_with_deltas give the served replies bit for bit; gemm_epilogue %d launches "
        "(%d a step); loss means %s; card %s" % (
            json.dumps({k: cfg[k] for k in ("rows", "dim", "fields", "batch", "layer_sizes")}),
            ONLINE_STEPS, ONLINE_INTERVAL, len(published) - 1, ONLINE_MAX_STALENESS,
            reading["rows_per_s_while_serving"], steps_threaded, wall[0],
            reading["publish_ms"]["base"], reading["publish_ms"]["delta_p50"],
            reading["reload_ms"]["base"], reading["reload_ms"]["delta_p50"],
            reading["reload_ms"]["delta_read_p50"],
            reading["delta_h2d_bytes"], len(samples), ONLINE_CLIENTS,
            reading["predict_p50_ms"], reading["predict_p99_ms"],
            reading["max_staleness_steps_seen"], check, launches["gemm_epilogue"],
            ONLINE_GEMM_PER_STEP, ["%.5f" % v for v in curve], card))
    return {"gemm_epilogue": launches["gemm_epilogue"]}


FLEET_REPLICAS = 3
FLEET_PREDICT_CLIENTS = 3
FLEET_GENERATE_CLIENTS = 2
FLEET_PREDICT_ROWS = 4  # rows of each fc-head :predict, its replicas' one bucket (a call is a
# request, so every reply is the same bits)
FLEET_CROSS_PROMPTS = (0, 6)  # PROMPT_LENS entries every replica decodes, called directly
FLEET_STEADY_GENERATES = 1  # :generate replies a generate client gets in the steady round
FLEET_FAILOVER_S = 1.0  # traffic on two replicas after the kill, before the restart
FLEET_RECOVERED_S = 1.5  # traffic on three replicas after the rejoin
FLEET_ROUND_CAP_S = 40.0  # a breaker round's bound
FLEET_HEDGES = 3  # hedges won against slowed r2 in the hedged leg
FLEET_SLOW_MS = 1200  # slow_response's delay: past the breaker router's 0.4 s attempt timeout
FLEET_BOOT_S = 300.0  # a replica's boot bound (wait_ready)


def _fleet_spec(name, md, repo, work):
    return {
        "name": name, "place": "cuda", "request_timeout_ms": HTTP_TIMEOUT * 1e3,
        "predict": {"model": "fc_head", "model_dir": md,
                    "batch_buckets": [FLEET_PREDICT_ROWS]},
        "generate": {"model": "gpt2", "model_kw": GPT2_SMALL, "seed": SEED,
                     "max_slots": ENGINE["max_slots"], "page_size": ENGINE["page_size"],
                     "max_context": ENGINE["max_context"]},
        "repo": repo, "poll_interval_s": 0.2,
        "exit_file": os.path.join(work, "%s.exit.json" % name),
        "fault_file": os.path.join(work, "%s.faults" % name),
    }


def _arm(rep, plan):
    """Install (or with None, drop) a fault plan in a running replica."""
    path = rep.spec["fault_file"]
    if plan is None:
        if os.path.exists(path):
            os.remove(path)
    else:
        with open(path + ".tmp", "w") as f:
            f.write(plan)
        os.replace(path + ".tmp", path)
    time.sleep(0.3)  # the replica polls its fault file every 50 ms


def _breaker_round(router, url, body, armed, cap_s):
    """:predict requests one at a time through `router` until the armed
    replica's breaker has opened and closed again. Returns (codes, opens)."""
    from paddle_tpu_torch.fleet import CLOSED

    codes, opened = [], False
    deadline = time.monotonic() + cap_s
    br = router.replicas()[armed].breaker
    while time.monotonic() < deadline:
        codes.append(_http_call(url, "", body)[0])
        if br.stats()["opens"] >= 1:
            opened = True
            if br.state == CLOSED:
                return codes, br.stats()["opens"]
        time.sleep(0.01)
    raise AssertionError("fleet: %s's breaker opened %s, never closed again in %.0f s (codes %s)"
                         % (armed, opened, cap_s, codes[-8:]))


def fleet(torch, card, readings):
    """The serving fleet at full width (bench.py run_fleet_bench): 3
    ReplicaProcess children of paddle_tpu_torch.fleet.replica on this card,
    seeded the same, each serving GPT-2 small :generate (GPT2_SMALL /
    ENGINE: f32 KV, 8 slots, page size 16) and the f32 fc head (bench.py
    :2031-2064, fitted here as serve_http fits it) on :predict, behind one
    Router with the staleness gate on a repository holding a published
    version of the head. 3 :predict clients (hedged) and 2 greedy
    :generate clients (PROMPT_LENS, 32 new tokens) through the router:
    steady; replica_kill armed in r0 (it dies in the middle of a request);
    failover; r0 restarted and rejoined once it acked the version; then
    conn_reset armed in r1 and slow_response in r2, each through a router
    without hedging (attempt timeout 0.4 s) until that replica's breaker
    opened and closed again, and hedged :predict through the main router
    against slowed r2. Gates: every reply 200 (served fraction 1.0); r0
    down and rejoined at the target version; both breakers open and close;
    every routed :generate reply the same prompt's tokens from one replica
    called directly, all replicas alike; each replica reports paged_flash
    and paged_flash_shared launches at its exit. The parent built the
    kernels (build phase) before any replica starts. Returns the replicas'
    paged launches."""
    import shutil
    import tempfile
    import threading

    from paddle_tpu_torch import CPUPlace
    from paddle_tpu_torch.fleet import ReplicaProcess, Router
    from paddle_tpu_torch.online import ModelPublisher
    from paddle_tpu_torch.serving import ServingEngine

    means = np.random.RandomState(101).randn(HEAD["classes"], HEAD["d_model"])
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    reps, routers = [], []
    try:
        md, repo = os.path.join(work, "fc_head"), os.path.join(work, "repo")
        _fit_head(torch, means, md)
        head = ServingEngine(md, name="fleet_head_cpu", place=CPUPlace(), batch_buckets=(1,))
        ModelPublisher(repo).publish({n: head.scope.vars[n] for n in head.param_names()}, 1)
        target = 1
        del head
        reps = [ReplicaProcess(_fleet_spec("r%d" % i, md, repo, work), work)
                for i in range(FLEET_REPLICAS)]
        t0 = time.perf_counter()
        for r in reps:
            r.start()
        boot_wall = {}
        for r in reps:
            r.wait_ready(timeout=FLEET_BOOT_S)
            boot_wall[r.name] = time.perf_counter() - t0
        infos = {r.name: r.info() for r in reps}
        for name, info in infos.items():
            if info["package"] != "paddle_tpu_torch" or not info["device"].startswith("cuda"):
                raise AssertionError("fleet: replica %s runs %s on %s"
                                     % (name, info["package"], info["device"]))
        router = Router(port=0, hedge=True, probe_interval_s=0.2, down_after=2,
                        total_deadline_s=HTTP_TIMEOUT, attempt_timeout_s=60.0,
                        repo=repo, repo_model="fc_head", seed=SEED)
        routers.append(router)
        base = "http://127.0.0.1:%d" % router.start()
        for r in reps:
            router.register(r.name, r.url)
        router.probe_once()
        if sorted(router.stats()["routable"]) != ["r0", "r1", "r2"]:
            raise AssertionError("fleet: routable %s" % router.stats())

        rng = np.random.RandomState(SEED + 21)
        prompts = [rng.randint(2, GPT2_SMALL["vocab_size"], size=n).tolist() for n in PROMPT_LENS]
        gen_bodies = [json.dumps({"prompt": p, "max_new_tokens": NEW_TOKENS, "eos_id": NO_EOS})
                      .encode() for p in prompts]
        x, _ = _head_batch(means, np.random.RandomState(SEED + 22), FLEET_PREDICT_ROWS)
        p_body = json.dumps({"inputs": {"img": x.tolist()}}).encode()
        # the reference tokens: every prompt from r1, called directly
        ref = {}
        for i, body in enumerate(gen_bodies):
            code, _, out, _ = _http_call(reps[1].url, "/v1/models/gpt2:generate", body)
            if code != 200:
                raise AssertionError("fleet: direct :generate on r1 gave %d" % code)
            ref[i] = json.loads(out)["tokens"]
        code, _, out, _ = _http_call(reps[1].url, "/v1/models/fc_head:predict", p_body)
        p_ref = json.loads(out)["outputs"]

        phase = ["steady"]
        samples, errors, mismatched = [], [], []
        counts = {"generate": [0] * FLEET_GENERATE_CLIENTS}
        stop = threading.Event()

        def client(kind, i):
            j = i
            while not stop.is_set():
                if kind == "predict":
                    code, _, out, ms = _http_call(base, "/v1/models/fc_head:predict", p_body)
                else:
                    k = j % len(gen_bodies)
                    code, _, out, ms = _http_call(base, "/v1/models/gpt2:generate", gen_bodies[k])
                    j += FLEET_GENERATE_CLIENTS
                if code != 200:
                    errors.append((phase[0], kind, code, out[:200]))
                    continue
                doc = json.loads(out)
                if kind == "generate":
                    counts["generate"][i] += 1
                    if doc["tokens"] != ref[k]:
                        mismatched.append((phase[0], k))
                elif doc["outputs"] != p_ref:
                    mismatched.append((phase[0], "predict"))
                samples.append((phase[0], kind, ms))

        threads = [threading.Thread(target=client, args=("predict", i), daemon=True)
                   for i in range(FLEET_PREDICT_CLIENTS)]
        threads += [threading.Thread(target=client, args=("generate", i), daemon=True)
                    for i in range(FLEET_GENERATE_CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while min(counts["generate"]) < FLEET_STEADY_GENERATES and not errors and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        # round 2: r0 dies at its second POST after the plan lands, in the
        # middle of that request
        phase[0] = "failover"
        _arm(reps[0], "replica_kill:step=2")
        deadline = time.monotonic() + 60
        while reps[0].alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        if reps[0].alive():
            raise AssertionError("fleet: r0 survived its replica_kill plan")
        t_kill = time.perf_counter()
        os.remove(reps[0].spec["fault_file"])
        time.sleep(FLEET_FAILOVER_S)
        router.probe_once()
        router.probe_once()
        down = router.replicas()["r0"].stats()["state"]
        if down != "down" or "r0" in router.stats()["routable"]:
            raise AssertionError("fleet: the killed r0 is %s at the router" % down)
        # round 4: restart, rejoin gated on the ack of the target version
        t_restart = time.perf_counter()
        reps[0].restart()
        reps[0].wait_ready(timeout=FLEET_BOOT_S)
        restart_boot = time.perf_counter() - t_restart
        router.register("r0", reps[0].url)
        rejoined = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            router.probe_once()
            if "r0" in router.stats()["routable"]:
                rejoined = router.replicas()["r0"].version_for_gate("fc_head")
                break
            time.sleep(0.1)
        if rejoined is None or rejoined < target:
            raise AssertionError("fleet: r0 rejoined at %s, target %d" % (rejoined, target))
        kill_to_rejoin = time.perf_counter() - t_kill
        infos["r0"] = reps[0].info()
        phase[0] = "recovered"
        time.sleep(FLEET_RECOVERED_S)
        stop.set()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        if any(t.is_alive() for t in threads):
            raise AssertionError("fleet: a client did not stop")

        # the routers share the process's metric registry: the main rounds'
        # counts now, the later legs' as deltas
        retries = router._m_retries.value(kind="predict") + router._m_retries.value(
            kind="generate")
        hedges = (router._m_hedges.value(event="launched"), router._m_hedges.value(event="won"))
        # rounds 5 and 6: one fault armed in one replica, a router without
        # hedging whose attempt timeout a slowed reply exceeds
        breaker_rounds = {}
        for kind, armed, plan in (("conn_reset", "r1", "conn_reset:every=2"),
                                  ("slow_response", "r2",
                                   "slow_response:every=2@ms=%d" % FLEET_SLOW_MS)):
            crouter = Router(port=0, hedge=False, probe_interval_s=0.2, total_deadline_s=20.0,
                             attempt_timeout_s=0.4, repo=repo, repo_model="fc_head", seed=1,
                             breaker_opts=dict(failure_threshold=3, error_rate_threshold=0.5,
                                               min_requests=4, open_for_s=0.3,
                                               success_threshold=1))
            routers.append(crouter)
            curl = "http://127.0.0.1:%d/v1/models/fc_head:predict" % crouter.start()
            for r in reps:
                crouter.register(r.name, r.url)
            crouter.probe_once()
            _arm(reps[int(armed[1])], plan)
            codes, opens = _breaker_round(crouter, curl, p_body, armed, FLEET_ROUND_CAP_S)
            if kind == "slow_response":
                # hedged :predict through the main router against slowed r2
                hrouter = Router(port=0, hedge=True, hedge_delay_ms=80.0,
                                 hedge_after_observations=10 ** 9, probe_interval_s=0.2,
                                 total_deadline_s=20.0, attempt_timeout_s=5.0,
                                 repo=repo, repo_model="fc_head", seed=2)
                routers.append(hrouter)
                hurl = "http://127.0.0.1:%d/v1/models/fc_head:predict" % hrouter.start()
                for r in reps:
                    hrouter.register(r.name, r.url)
                hrouter.probe_once()
                hedged = []
                won0 = hrouter._m_hedges.value(event="won")
                launched0 = hrouter._m_hedges.value(event="launched")
                while hrouter._m_hedges.value(event="won") - won0 < FLEET_HEDGES and \
                        len(hedged) < 60:
                    launched = hrouter._m_hedges.value(event="launched")
                    code, _, out, ms = _http_call(hurl, "", p_body)
                    hedged.append((code, ms))
                    if code != 200 or json.loads(out)["outputs"] != p_ref:
                        raise AssertionError("fleet: hedged :predict gave %d" % code)
                    if hrouter._m_hedges.value(event="launched") > launched:
                        # the cancelled leg's thread waits out r2's slowed
                        # reply, and r2 stays out of least-inflight picks
                        # until it ends
                        time.sleep(FLEET_SLOW_MS / 1e3)
                breaker_rounds["hedged"] = {
                    "requests": len(hedged),
                    "launched": hrouter._m_hedges.value(event="launched") - launched0,
                    "won": hrouter._m_hedges.value(event="won") - won0,
                    "p99_ms": _pct([ms for _, ms in hedged], 99)}
                if breaker_rounds["hedged"]["won"] < FLEET_HEDGES:
                    raise AssertionError("fleet: no hedge won against slowed r2 %s"
                                         % breaker_rounds["hedged"])
            _arm(reps[int(armed[1])], None)
            if any(c != 200 for c in codes):
                raise AssertionError("fleet: %s round codes %s" % (kind, codes))
            breaker_rounds[kind] = {"replica": armed, "requests": len(codes), "opens": opens}

        # every replica decodes as r1 did, called directly
        for r in reps:
            for i in FLEET_CROSS_PROMPTS:
                code, _, out, _ = _http_call(r.url, "/v1/models/gpt2:generate", gen_bodies[i])
                if code != 200 or json.loads(out)["tokens"] != ref[i]:
                    raise AssertionError("fleet: %s decodes prompt %d otherwise than r1"
                                         % (r.name, i))
        stats = router.stats()
        for rt in routers:
            rt.stop()
        routers = []
        reports = {}
        for r in reps:
            rc = r.terminate(timeout=60.0)
            with open(r.spec["exit_file"]) as f:
                reports[r.name] = json.load(f)
            if rc != 0:
                raise AssertionError("fleet: %s exited %s" % (r.name, rc))
    except BaseException:
        for r in reps:  # what each replica said, before its folder goes
            try:
                with open(r.log_path) as f:
                    log("fleet: %s's log ends: %s" % (r.name, f.read()[-3000:]))
            except OSError:
                pass
        raise
    finally:
        for rt in routers:
            rt.stop()
        for r in reps:
            try:
                r.kill()
            except Exception:
                pass
        shutil.rmtree(work, ignore_errors=True)
    if errors or mismatched:
        raise AssertionError("fleet: %d failed replies %s, %d replies off the reference %s"
                             % (len(errors), errors[:4], len(mismatched), mismatched[:4]))
    launches = {"paged_flash": 0, "paged_flash_shared": 0}
    for name, rep in reports.items():
        got = {k: rep["paged_launches"].get(k, 0) for k in launches}
        if not all(got.values()):
            raise AssertionError("fleet: replica %s reports paged launches %s" % (name, got))
        for k, v in got.items():
            launches[k] += v
    phases = ("steady", "failover", "recovered")
    p99 = {kind: {ph: _pct([ms for p, k, ms in samples if p == ph and k == kind], 99)
                  for ph in phases} for kind in ("predict", "generate")}
    reading = {
        "requests": len(samples), "served_fraction": 1.0, "p99_ms": p99,
        "kill_to_rejoin_s": kill_to_rejoin, "restart_boot_s": restart_boot,
        "rejoined_at_version": rejoined, "retries": retries,
        "hedges_launched": hedges[0], "hedges_won": hedges[1], "breaker_rounds": breaker_rounds,
        "boot_s": {n: i["boot_s"] for n, i in infos.items()},
        "boot_wall_s": boot_wall,
        "memory_reserved_gib": {n: i["memory_reserved_bytes"] / GIB for n, i in infos.items()},
        "replica_launches": {n: rep["paged_launches"] for n, rep in reports.items()},
        "routable_at_end": stats["routable"],
    }
    readings["fleet"] = reading
    log("fleet: %d replicas of paddle_tpu_torch.fleet.replica on this card (GPT-2 small "
        ":generate, f32 KV, %d slots, page size %d; the f32 fc head on :predict), the staleness "
        "gate at version %d; %d replies through the router, served fraction 1.0, zero 5xx; p99 "
        "ms steady / failover / recovered: :predict %s, :generate %s; r0 killed mid-request, "
        "down, restarted (boot "
        "%.1f s) and rejoined at version %s %.1f s after the kill; retries %d, hedges launched %d "
        "won %d; breaker rounds %s; every routed :generate reply the tokens of r1 called "
        "directly, and all 3 replicas decode prompts %s alike; boot s %s (parallel wall %s); "
        "memory reserved GiB %s; paged launches a replica %s; card %s" % (
            FLEET_REPLICAS, ENGINE["max_slots"], ENGINE["page_size"], target, len(samples),
            *[" / ".join("%.1f" % v if v is not None else "n/a" for v in p99[k].values())
              for k in ("predict", "generate")],
            restart_boot, rejoined, kill_to_rejoin, retries, hedges[0], hedges[1],
            json.dumps(breaker_rounds), [PROMPT_LENS[i] for i in FLEET_CROSS_PROMPTS],
            json.dumps({k: round(v, 2) for k, v in
                                                    reading["boot_s"].items()}),
            json.dumps({k: round(v, 2) for k, v in boot_wall.items()}),
            json.dumps({k: round(v, 3) for k, v in reading["memory_reserved_gib"].items()}),
            json.dumps(reading["replica_launches"]), card))
    return launches

# ---------------------------------------------------------------- phase 19

ARTIFACT_STEPS = 6  # runner steps at dropout 0; the first 3 against Executor.run's
RESUME_STEPS = 2  # dropout-0.1 runner steps before and after its save_state
RESUME_LAYERS = 2  # layers of the dropout-0.1 resume leg (the dropout-0 leg keeps 6)
INFER_CALLS = 4  # Predictor and loaded-artifact calls (op by op, capture, replays)
DECODER_STEPS = 3
DECODER_TIE = 1e-5  # selections this close (relative): a top-k tie the card may break

_ARTIFACT_CHILD = r"""
import json, sys, time
import numpy as np
root, spec = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
from paddle_tpu_torch.train_export import load_train_step

data = np.load(spec["batches"])


def feed(i):
    pre = "%d/" % i
    return {k[len(pre):]: data[k] for k in data.files if k.startswith(pre)}


import torch
from paddle_tpu_torch.ops import fused

out = {}
t0 = time.perf_counter()
runner = load_train_step(spec["art0"])
out["load_s"] = time.perf_counter() - t0
fused.reset_stats()
losses, walls, deltas = [], [], []
for i in range(spec["steps"]):
    before = fused.stats()["launches"]
    t0 = time.perf_counter()
    (loss,) = runner.run(feed(i))
    walls.append((time.perf_counter() - t0) * 1e3)
    after = fused.stats()["launches"]
    deltas.append({k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)})
    losses.append(float(np.asarray(loss).reshape(-1)[0]))
out.update(losses=[v.hex() for v in losses], walls=walls, deltas=deltas,
           launches=fused.stats()["launches"])
del runner
torch.cuda.empty_cache()
runner = load_train_step(spec["art1"])
for i in range(spec["resume"]):
    runner.run(feed(i))
ckpt = runner.save_state(spec["ckpt"])
tails = []
for _ in range(2):  # the unbroken run, then the runner restored from its checkpoint
    tails.append([float(np.asarray(runner.run(feed(spec["resume"] + i))[0]).reshape(-1)[0])
                  for i in range(spec["resume"])])
    runner.load_state(ckpt)
tail_a, tail_b = tails
out.update(tail_a=[v.hex() for v in tail_a], tail_b=[v.hex() for v in tail_b],
           foreign=sorted(m for m in ("jax", "paddle_tpu") if m in sys.modules))
print(json.dumps(out))
"""


def _artifact_train(torch, card, tmp, beside=None):
    """(a): the train artifact at dropout 0 against Executor.run, and at
    dropout 0.1 resumed from save_state, in a fresh process, while
    `beside()` runs in this one (host work: (e)'s export, so the child's
    graph replays share the card with nothing). Returns (the runner's
    launches over its steps, what beside returned)."""
    import subprocess

    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, scope_guard
    from paddle_tpu_torch.train_export import export_train_step
    from paddle_tpu_torch.tools import profile_training as prof

    flags.set_flags({"pass_pipeline": "training_fused"})
    place = CUDAPlace(0)
    cfg0 = dict(prof.BASE_FLASH, dropout=0.0)
    # one batch, so the loss falls within the steps (random batches need
    # more steps than these to move it)
    batches = [prof.make_batch(cfg0, SEED + 200)] * ARTIFACT_STEPS
    np.savez(os.path.join(tmp, "batches.npz"),
             **{"%d/%s" % (i, n): v for i, b in enumerate(batches) for n, v in b.items()})
    arts, export_s = [], []
    # the resume leg at Transformer base's widths, cut in depth
    cfg1 = dict(prof.BASE_FLASH, n_layer=RESUME_LAYERS)
    for k, cfg in enumerate((cfg0, cfg1)):
        main_prog, startup, loss = prof.build(cfg)
        scope, exe = Scope(seed=SEED + k, place=place), Executor(place)
        with scope_guard(scope):
            exe.run(startup)
        t0 = time.perf_counter()
        arts.append(export_train_step(os.path.join(tmp, "train%d" % k), batches[0], [loss],
                                      program=main_prog, scope=scope))
        export_s.append(time.perf_counter() - t0)
        log("artifacts (a): dropout %g exported and written in %.1f s" % (cfg["dropout"],
                                                                         export_s[-1]))
        if k == 0:
            # Executor.run from the state the artifact holds
            e_losses, e_walls = [], []
            for b in batches:
                t0 = time.perf_counter()
                with scope_guard(scope):
                    (v,) = exe.run(main_prog, feed=b, fetch_list=[loss.name])
                e_walls.append((time.perf_counter() - t0) * 1e3)
                e_losses.append(float(np.asarray(v).reshape(-1)[0]))
        del scope, exe
        torch.cuda.empty_cache()
    sizes = [os.path.getsize(a) for a in arts]
    spec = {"art0": arts[0], "art1": arts[1], "batches": os.path.join(tmp, "batches.npz"),
            "ckpt": os.path.join(tmp, "ckpt"), "steps": ARTIFACT_STEPS, "resume": RESUME_STEPS}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", _ARTIFACT_CHILD, root, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        side = beside() if beside is not None else None
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("train artifact runner failed (rc %d):\n%s" % (
            proc.returncode, stderr[-4000:]))
    got = json.loads(stdout.strip().splitlines()[-1])
    if got["foreign"]:
        raise AssertionError("the runner's process imported %s" % got["foreign"])
    losses = [float.fromhex(v) for v in got["losses"]]
    if got["losses"][:COMPARE_STEPS] != [v.hex() for v in e_losses[:COMPARE_STEPS]]:
        raise AssertionError("train artifact: runner losses %s, Executor.run %s (first %d bit "
                             "for bit)" % (losses, e_losses, COMPARE_STEPS))
    if not losses[-1] < losses[0]:
        raise AssertionError("train artifact: loss %r -> %r does not fall" % (losses[0],
                                                                           losses[-1]))
    if got["tail_a"] != got["tail_b"]:
        raise AssertionError("train artifact at dropout 0.1: a restored runner's losses %s, "
                             "the unbroken run's %s" % (got["tail_b"], got["tail_a"]))
    fused_want, flash_want = _per_step(cfg0)
    want = {k: n for k, n in dict(fused_want, **flash_want).items() if n}
    for i, d in enumerate(got["deltas"]):
        if d != want:
            raise AssertionError("train artifact step %d: launches %s, want %s" % (i, d, want))
    log("artifacts (a): Transformer base train_flash under training_fused exported after its "
        "startup program in %s s (dropout 0 / 0.1), %s bytes each; a fresh process importing "
        "only paddle_tpu_torch.train_export and numpy (no %s) loaded the dropout-0 artifact in "
        "%.1f s and trained %d steps: losses %s, the first %d bit for bit Executor.run's from "
        "the same state (%s), falling; launches a step %s; step wall p50 %.3f ms over steps "
        "3-%d (step 1 op by op %.1f ms, step 2 captured %.1f ms) against Executor.run's %.3f "
        "ms in this call; at dropout 0.1 a runner restored from save_state after %d steps "
        "(the same runner, its graph captured) continued the unbroken run bit for bit (%s); the "
        "child took %.1f s, beside (e)'s export here; card %s" % (
            ["%.1f" % v for v in export_s], sizes, "jax", got["load_s"], ARTIFACT_STEPS,
            ["%.6f" % v for v in losses], COMPARE_STEPS,
            ["%.6f" % v for v in e_losses[:COMPARE_STEPS]], json.dumps(want),
            float(np.median(got["walls"][2:])), ARTIFACT_STEPS, got["walls"][0],
            got["walls"][1], float(np.median(e_walls[2:])), RESUME_STEPS,
            ["%.6f" % float.fromhex(v) for v in got["tail_a"]], child_s, card))
    return {"flash_fwd": got["launches"]["flash_fwd"],
            "flash_fwd_causal": got["launches"]["flash_fwd_causal"],
            "flash_bwd": got["launches"]["flash_bwd_fused"],
            "flash_bwd_causal": got["launches"]["flash_bwd_fused_causal"],
            "gemm_epilogue": got["launches"]["gemm_epilogue"],
            "layer_norm": got["launches"]["layer_norm"],
            "layer_norm_grad": got["launches"]["layer_norm_grad"],
            "multi_adam": got["launches"]["multi_adam"]}, side


def _infer_calls(run, feed, n=INFER_CALLS):
    """n calls of an inference callable `run(feed) -> [one fetch]`: (the
    fetches, walls ms, each call's kernel launches)."""
    from paddle_tpu_torch.ops import fused

    outs, walls, deltas = [], [], []
    for _ in range(n):
        before = fused.stats()["launches"]
        t0 = time.perf_counter()
        (o,) = run(feed)
        walls.append((time.perf_counter() - t0) * 1e3)
        after = fused.stats()["launches"]
        deltas.append({k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)})
        outs.append(o)
    return outs, walls, deltas


ARTIFACT_FP8_STEPS = 3  # (e)'s runner and Executor.run steps, all compared bit for bit
ARTIFACT_FP8_KERNELS = ("fp8_matmul", "fp8_matmul_dx", "fp8_matmul_dy")


def _fp8_export(tmp):
    """(e)'s export: Transformer base (dropout 0) rewritten to bf16 by
    Bf16Transpiler, its startup program run, then export_train_step under
    FLAGS_fp8_matmul and training_fused (train_bf16's fp8 configuration).
    Host work but for the startup program. Returns what _artifact_fp8
    runs: the path, the export's seconds and the state it was made from."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, scope_guard
    from paddle_tpu_torch.tools import profile_recsys as recsys
    from paddle_tpu_torch.tools import profile_training as prof
    from paddle_tpu_torch.train_export import export_train_step

    place = CUDAPlace(0)
    cfg = dict(prof.BASE, dropout=0.0)
    batches = [prof.make_batch(cfg, SEED + 400 + i) for i in range(ARTIFACT_FP8_STEPS)]
    main_prog, startup, loss = prof.build(cfg)
    recsys.bf16_transpiled(main_prog)
    flags.set_flags({"pass_pipeline": "training_fused", "fp8_matmul": True})
    try:
        scope, exe = Scope(seed=SEED, place=place), Executor(place)
        with scope_guard(scope):
            exe.run(startup)
        t0 = time.perf_counter()
        path = export_train_step(os.path.join(tmp, "fp8"), batches[0], [loss],
                                 program=main_prog, scope=scope)
        export_s = time.perf_counter() - t0
    finally:
        flags.set_flags({"fp8_matmul": False})
    return dict(path=path, export_s=export_s, batches=batches, main=main_prog, loss=loss,
                scope=scope, exe=exe)


def _artifact_fp8(torch, card, exported):
    """(e): the exported bf16 fp8 step of _fp8_export, loaded by
    TrainStepRunner in this process: its ARTIFACT_FP8_STEPS losses bit for
    bit Executor.run's from the state it was exported from, under the same
    flag and transpile; the fp8 launches a step of both. Returns the
    runner's launches over its steps and the record."""
    from paddle_tpu_torch import flags, scope_guard
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.serving import compile_cache
    from paddle_tpu_torch.train_export import TrainStepRunner

    path, export_s, batches = exported["path"], exported["export_s"], exported["batches"]
    main_prog, loss, scope, exe = (exported.pop(k) for k in ("main", "loss", "scope", "exe"))
    flags.set_flags({"pass_pipeline": "training_fused", "fp8_matmul": True})
    try:
        e_losses, e_walls, e_deltas = [], [], []
        for b in batches:
            before = fused.stats()
            t0 = time.perf_counter()
            with scope_guard(scope):
                (v,) = exe.run(main_prog, feed=b, fetch_list=[loss.name])
            e_walls.append((time.perf_counter() - t0) * 1e3)
            e_deltas.append(_launch_delta(before, fused.stats()))
            e_losses.append(float(np.asarray(v).reshape(-1)[0]))
    finally:
        flags.set_flags({"fp8_matmul": False})
    del scope, exe
    torch.cuda.empty_cache()
    size = os.path.getsize(path)
    graph = _op_nodes(compile_cache.read_artifact(path)["program"])
    t0 = time.perf_counter()
    runner = TrainStepRunner.load(path)
    load_s = time.perf_counter() - t0
    fused.reset_stats()  # the runner's counting window
    r_losses, r_walls, r_deltas = [], [], []
    for b in batches:
        before = fused.stats()
        t0 = time.perf_counter()
        (v,) = runner.run(b)
        r_walls.append((time.perf_counter() - t0) * 1e3)
        r_deltas.append(_launch_delta(before, fused.stats()))
        r_losses.append(float(np.asarray(v).reshape(-1)[0]))
    launches = {k: v for k, v in fused.stats()["launches"].items() if v}
    del runner
    torch.cuda.empty_cache()
    if [v.hex() for v in r_losses] != [v.hex() for v in e_losses]:
        raise AssertionError("fp8 artifact: runner losses %s, Executor.run %s (bit for bit)"
                             % (r_losses, e_losses))
    if not np.isfinite(r_losses).all():
        raise AssertionError("fp8 artifact: losses %s" % r_losses)
    for name in ("fp8_matmul", "fp8_matmul_grads"):
        if not graph.get(name):
            raise AssertionError("fp8 artifact: no %s node in the exported step (%s)"
                                 % (name, graph))
    if any(d != r_deltas[0] for d in r_deltas) or any(d != e_deltas[0] for d in e_deltas):
        raise AssertionError("fp8 artifact: launches a step vary: runner %s, Executor %s"
                             % (r_deltas, e_deltas))
    for k in ARTIFACT_FP8_KERNELS:
        if not r_deltas[0].get(k):
            raise AssertionError("fp8 artifact: %s never launched a runner step (%s)"
                                 % (k, r_deltas[0]))
    fp8 = {k: (r_deltas[0].get(k, 0), e_deltas[0].get(k, 0)) for k in ARTIFACT_FP8_KERNELS}
    log("artifacts (e): Transformer base (dropout 0) rewritten to bf16 under FLAGS_fp8_matmul "
        "and training_fused, exported by export_train_step in %.1f s (%d bytes; nodes %s), "
        "loaded by TrainStepRunner in this process in %.1f s; %d runner steps (1 op by op, 2 "
        "captured, then replays), losses %s, bit for bit Executor.run's from the same state; "
        "fp8 launches a step (runner, Executor.run) %s; all launches a runner step %s, an "
        "Executor step %s; step walls runner %s ms, Executor.run %s ms; card %s" % (
            export_s, size, json.dumps(graph), load_s, ARTIFACT_FP8_STEPS,
            ["%.6f" % v for v in r_losses], json.dumps(fp8), json.dumps(r_deltas[0]),
            json.dumps(e_deltas[0]), ["%.1f" % w for w in r_walls],
            ["%.1f" % w for w in e_walls], card))
    return launches, {"export_s": export_s, "load_s": load_s, "bytes": size,
                      "fp8_a_step_runner_executor": fp8,
                      "runner_walls_ms": r_walls, "executor_walls_ms": e_walls}


def _artifact_infer(torch, card, tmp):
    """(b): Transformer base train_flash's inference program served by the
    Predictor and by the loaded export_compiled artifact. Returns the
    artifact's flash forward launches."""
    from paddle_tpu_torch import CUDAPlace, Executor, Scope, flags, inference, io, scope_guard
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_training as prof

    # both serve the program as saved (the artifact's lowering runs no pass)
    flags.set_flags({"pass_pipeline": ""})
    cfg = dict(prof.BASE_FLASH, dropout=0.0)
    main_prog, startup, _ = prof.build(cfg)
    ce = next(op for op in main_prog.global_block().ops
              if op.type == "softmax_with_cross_entropy")
    logits = main_prog.global_block().var(ce.input("Logits")[0])
    names = ["src_word", "src_pos", "trg_word", "trg_pos"]
    model_dir = os.path.join(tmp, "infer")
    exe = Executor(CUDAPlace(0))
    with scope_guard(Scope(seed=SEED, place=CUDAPlace(0))):
        exe.run(startup)
        io.save_inference_model(model_dir, names, [logits], exe,
                                main_program=main_prog.clone(for_test=True))
    del exe
    batch = prof.make_batch(cfg, SEED + 300)
    feed = {n: batch[n] for n in names}
    pred = inference.Predictor(model_dir, place=CUDAPlace(0))
    p_outs, p_walls, p_deltas = _infer_calls(pred.run, feed)
    del pred
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path = inference.export_compiled(model_dir, feed, os.path.join(tmp, "infer_art"),
                                     place=CUDAPlace(0))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = inference.load_compiled(path)
    load_s = time.perf_counter() - t0
    fused.reset_stats()  # the artifact's counting window
    a_outs, a_walls, a_deltas = _infer_calls(art.run, feed)
    launches = fused.stats()["launches"]
    del art
    torch.cuda.empty_cache()
    want = {"flash_fwd": 2 * cfg["n_layer"], "flash_fwd_causal": cfg["n_layer"]}
    for label, deltas in (("Predictor", p_deltas), ("artifact", a_deltas)):
        for i, d in enumerate(deltas):
            if d != want:
                raise AssertionError("%s call %d: launches %s, want %s" % (label, i, d, want))
    ref = p_outs[0]
    if ref.shape != (cfg["batch"] * cfg["t"], cfg["vocab"]) or not np.isfinite(ref).all():
        raise AssertionError("inference logits: shape %s, finite %s" % (
            ref.shape, bool(np.isfinite(ref).all())))
    for label, outs in (("Predictor", p_outs), ("artifact", a_outs)):
        for i, o in enumerate(outs):
            if o.tobytes() != ref.tobytes():
                raise AssertionError("%s call %d: logits differ from the Predictor's first "
                                     "(max abs %g)" % (label, i, float(np.abs(o - ref).max())))
    log("artifacts (b): Transformer base train_flash's inference program (the for_test clone "
        "pruned to the %d-wide logits, %s) exported in %.1f s (%d bytes), loaded in %.1f s; "
        "Predictor (Executor.run, CUDA graphs) and the loaded artifact (call 1 op by op, call 2 "
        "captured, then replays) %d calls each, every fetch bit for bit the Predictor's first; "
        "launches a call %s; wall p50 over calls 3-%d: Predictor %.3f ms, artifact %.3f ms "
        "(calls 1-2: %.1f / %.1f ms and %.1f / %.1f ms); card %s" % (
            cfg["vocab"], tuple(ref.shape), export_s, os.path.getsize(path), load_s,
            INFER_CALLS, json.dumps(want), INFER_CALLS, float(np.median(p_walls[2:])),
            float(np.median(a_walls[2:])), p_walls[0], p_walls[1], a_walls[0], a_walls[1], card))
    return {"flash_fwd": launches["flash_fwd"], "flash_fwd_causal": launches["flash_fwd_causal"]}


def _decoder_run(cfg, m, place, init, feed, dfeed, trained=None):
    """(losses over DECODER_STEPS steps, trained state, decode, decode wall
    ms) of the contrib decoder on `place` from `init`, the decode from
    `trained` where given (else from its own trained state). `decode`: the
    decoded (ids, scores) and each step's selected ids, scores and parent
    slots ([max_out_len, batch * beam] each, the While's arrays)."""
    from paddle_tpu_torch import Executor, Scope, convert, scope_guard

    scope, exe = Scope(seed=SEED, place=place), Executor(place)
    names = sorted(init)
    arrays = next(op for op in m["infer"].global_block().ops
                  if op.type == "beam_search_decode")
    fetch = [m["ids"].name, m["scores"].name] + [arrays.input(slot)[0] for slot in
                                                 ("Ids", "Scores", "Parents")]
    with scope_guard(scope):
        exe.run(m["startup"])
        convert.load_into_scope(scope, init, names)
        losses = [float(np.asarray(exe.run(m["main"], feed=feed,
                                           fetch_list=[m["loss"].name])[0]).reshape(-1)[0])
                  for _ in range(DECODER_STEPS)]
        state = convert.scope_to_numpy(scope, names)
        if trained is not None:
            convert.load_into_scope(scope, trained, names)
        t0 = time.perf_counter()
        outs = exe.run(m["infer"], feed=dfeed, fetch_list=fetch, return_numpy=False)
        wall = (time.perf_counter() - t0) * 1e3
    # a tensor array fetches as its (buffer, size)
    outs = [(o[0] if isinstance(o, tuple) else o).detach().cpu().numpy() for o in outs]
    steps = [o.reshape(cfg["max_out_len"], -1) for o in outs[2:]]
    return losses, state, outs[:2] + steps, wall


def _decoder_ties(cfg, card, cpu):
    """(rows whose decoded ids differ, of them the rows the CPU's selection
    explains by a tie): a row's ids may differ only where, at the first
    step the card selects other (id, parent) pairs than the CPU, the two
    selections' scores agree within DECODER_TIE (relative): the CPU's top-k
    had a tie there, which rounding on the card may break the other way."""
    beam, rows = cfg["beam_size"], cfg["batch"]
    differ = ~(card[0].reshape(rows, -1) == cpu[0].reshape(rows, -1)).all(axis=1)
    tied = np.zeros(rows, dtype=bool)
    for r in np.nonzero(differ)[0]:
        sl = slice(r * beam, (r + 1) * beam)
        for t in range(cfg["max_out_len"]):
            picked = [sorted(zip(ids[t, sl].tolist(), par[t, sl].tolist()))
                      for ids, par in ((card[2], card[4]), (cpu[2], cpu[4]))]
            if picked[0] != picked[1]:
                a, b = np.sort(card[3][t, sl]), np.sort(cpu[3][t, sl])
                tied[r] = bool(np.allclose(a, b, rtol=DECODER_TIE, atol=DECODER_TIE))
                break
    return differ, tied


def _artifact_decoder(torch, card):
    """(c): the contrib decoder at NMT's widths on the card against the
    port's CPU run from the same weights."""
    from paddle_tpu_torch import CPUPlace, CUDAPlace, ParamAttr, convert, flags
    from paddle_tpu_torch.contrib import decoder
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import profile_rnn as rnn

    flags.set_flags({"pass_pipeline": "training_fused"})
    cfg = rnn.DECODER
    m = rnn.build_contrib_decoder(fluid, decoder, ParamAttr, cfg)
    feed, dfeed = rnn.decoder_batch(cfg, SEED)
    init = {n: v.detach().cpu().numpy() for n, v in _startup_state(m["startup"]).items()
            if n in set(convert.persistable_names(m["main"]))}
    t0 = time.perf_counter()
    card_losses, trained, dec, card_wall = _decoder_run(cfg, m, CUDAPlace(0), init, feed,
                                                        dfeed)
    card_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_losses, _, cdec, cpu_wall = _decoder_run(cfg, m, CPUPlace(), init, feed, dfeed,
                                                 trained=trained)
    cpu_s = time.perf_counter() - t0
    a, b = np.asarray(card_losses), np.asarray(cpu_losses)
    if not (np.isfinite(a).all() and np.allclose(a, b, rtol=FUSED_RTOL, atol=FUSED_ATOL)):
        raise AssertionError("contrib decoder losses: card %s, CPU %s" % (a.tolist(), b.tolist()))
    if dec[0].shape != cdec[0].shape or dec[0].shape[:2] != (cfg["batch"], cfg["beam_size"]):
        raise AssertionError("contrib decoder ids: card %s, CPU %s" % (dec[0].shape,
                                                                      cdec[0].shape))
    differ, tied = _decoder_ties(cfg, dec, cdec)
    if (differ & ~tied).any():
        raise AssertionError("contrib decoder: rows %s decode other ids on the card with no "
                             "tie within %g on the CPU" % (np.nonzero(differ & ~tied)[0].tolist(),
                                                           DECODER_TIE))
    log("artifacts (c): the contrib decoder (InitState, StateCell, TrainingDecoder, "
        "BeamSearchDecoder) at %s: %d Adam steps on the card, losses %s, against the CPU's "
        "from the same weights %s (rtol %g atol %g); beam %d decode, max length %d, from the "
        "card's trained weights on both: %d of %d rows' ids equal, %d ties (rows whose first "
        "other selection on the card had the CPU's scores within %g); card %.1f s (decode "
        "%.1f ms, op by op: its While has no maximum_iterations), CPU %.1f s (decode %.1f "
        "ms); card %s" % (
            json.dumps(cfg), DECODER_STEPS, ["%.6f" % v for v in a], ["%.6f" % v for v in b],
            FUSED_RTOL, FUSED_ATOL, cfg["beam_size"], cfg["max_out_len"],
            int((~differ).sum()), cfg["batch"], int(tied.sum()), DECODER_TIE, card_s,
            card_wall, cpu_s, cpu_wall, card))


def artifacts(torch, card, readings):
    """Compiled artifacts on the card (see the module docstring, phase 19).
    Returns the train and inference artifacts' kernel launches."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="artifacts_")
    try:
        launches, fp8 = _artifact_train(torch, card, tmp, beside=lambda: _fp8_export(tmp))
        torch.cuda.empty_cache()
        counts, readings["artifact_fp8"] = _artifact_fp8(torch, card, fp8)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        del fp8
        torch.cuda.empty_cache()
        for k, n in _artifact_infer(torch, card, tmp).items():
            launches[k] += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    _artifact_decoder(torch, card)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch import CUDAPlace, flags
        from paddle_tpu_torch.models import GPTDecoder
        from paddle_tpu_torch.ops import paged_flash as pf
        from paddle_tpu_torch.serving import GenerationEngine
        from paddle_tpu_torch.tools import profile_training as prof
    except ImportError as e:
        print("chip_smoke: the paddle_tpu_torch package is missing: %s" % e, file=sys.stderr)
        return 2
    # full f32 products on the card (the reference for every tolerance here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    paths = {}  # path -> {"graph": reading, "op_by_op": reading}

    with Phase("build"):
        card = prof.card_line()
        log(card)
        log("python %s, torch %s (CUDA %s); CUDAGraph.register_generator_state: %s" % (
            sys.version.split()[0], torch.__version__, torch.version.cuda,
            hasattr(torch.cuda.CUDAGraph, "register_generator_state")))
        native_build = _start_native_build()  # g++, beside the nvcc builds
        nvcc_build = _start_nvcc_build()
    # the phases that launch no hand-written kernel run while nvcc builds
    # (one that reached a kernel would wait for its library); the flags
    # they set are put back for the phases after them
    saved_flags = flags.get_flags()
    with Phase("batch_norm grad"):
        check_batch_norm_grad(torch, card)
    torch.cuda.empty_cache()
    with Phase("extra ops"):
        extra_ops(torch, card)
    torch.cuda.empty_cache()
    with Phase("train ssd"):
        ssd = train_ssd(torch, card, paths)
    with Phase("eval ssd"):
        eval_ssd(torch, card, paths, *ssd)
    del ssd
    torch.cuda.empty_cache()
    with Phase("detection ops"):
        detection_ops(torch, card)
    torch.cuda.empty_cache()
    flags.set_flags(saved_flags)
    with Phase("build wait"):
        for line in nvcc_build():
            log(line)
        log(native_build())
    with Phase("kernels vs plain"):
        kernels = check_kernels(torch, pf, device)
        main_prog = prof.build(prof.BASE)[0]
        shapes = [tuple(p.shape) for p in main_prog.global_block().all_parameters()
                  if p.trainable]
        del main_prog
        kernels.update(check_training_kernels(torch, device, shapes))
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        kernels.update(check_flash(torch, device, flush))
        kernels.update(check_int8_paged(torch, pf, device, flush))
        check_paged_chunks(torch, pf, device)
        check_paged_decode(torch, pf, device)
        check_paged_wide(torch, pf, device)
        kernels.update(time_paged_wide(torch, pf, device, flush))
        kernels.update(check_quant_gemm(torch, device, flush))
        kernels.update(check_fp8_matmul(torch, device, flush))
        del flush
    torch.cuda.empty_cache()
    with Phase("serve"):
        t0 = time.perf_counter()
        engine = GenerationEngine(GPTDecoder(**GPT2_SMALL), name="gpt2_small",
                                  place=CUDAPlace(0), **ENGINE)
        before = torch.cuda.memory_reserved(device) / GIB
        n = engine.warmup()
        torch.cuda.synchronize()
        after = torch.cuda.memory_reserved(device) / GIB
        log("engine: %d variants built and captured, params + pools ready in %.1f s; KV pools "
            "%.3f GB; memory reserved %.4f GiB with params and pools, %.4f GiB after warmup "
            "(the variants' graphs share one pool); card %s" % (
                n, time.perf_counter() - t0, engine.kv_state_bytes / 1e9, before, after, card))
        launches = serve(torch, pf, engine, card, paths)
        paths["serve"]["graph"].update(memory_reserved_gib_before_warmup=before,
                                       memory_reserved_gib_after_warmup=after)
    with Phase("paged vs dense"):
        paged_vs_dense(torch, engine)
    with Phase("serve int8 KV"):
        counts, engine8 = serve_int8_kv(torch, pf, engine, card, paths)
        launches.update(counts)
    with Phase("paged export"):
        for label, eng in (("f32", engine), ("int8", engine8)):
            counts, paths.setdefault("paged_export", {})[label] = paged_export(
                torch, pf, eng, label, card)
            for name, n in counts.items():
                launches[name] += n
    del engine, engine8
    torch.cuda.empty_cache()
    with Phase("serve int8 GEMM"):
        launches.update(serve_int8_gemm(torch, card)[0])
    torch.cuda.empty_cache()
    with Phase("serve http"):
        for name, n in serve_http(torch, pf, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("serve wide heads"):
        wide, launches["flash_fwd_wide"] = serve_wide(torch, pf, card, paths)
        launches.update(wide)
    torch.cuda.empty_cache()
    with Phase("train"):
        launches.update(train(torch, card, paths))
    with Phase("train flash"):
        launches.update(train_flash(torch, card, paths))
    torch.cuda.empty_cache()
    with Phase("train multistep"):
        for name, n in train_multistep(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("train lenet"):
        for name, n in train_lenet(torch, card, paths).items():
            launches[name] += n
    with Phase("train resnet50"):
        train_resnet50(torch, card, paths)
    torch.cuda.empty_cache()
    with Phase("train zoo"):
        counts, errs = train_zoo(torch, card, paths)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        for name, err in errs.items():
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    torch.cuda.empty_cache()
    with Phase("deploy resnet50"):
        for name, n in deploy_resnet50(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    for label, phase in (("train lstm", train_lstm), ("train nmt", train_nmt)):
        torch.cuda.empty_cache()
        with Phase(label):
            counts, errs = phase(torch, card, paths)
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            for name, err in errs.items():
                kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    for label, phase in (("train deepfm", train_deepfm), ("train bf16", train_bf16)):
        torch.cuda.empty_cache()
        with Phase(label):
            counts, errs = phase(torch, card, paths)
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            for name, err in errs.items():
                kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    with Phase("schedules"):
        schedules(torch, card)
    torch.cuda.empty_cache()
    with Phase("host ops"):
        host_ops(torch, card)
    torch.cuda.empty_cache()
    with Phase("train resilience"):
        for name, n in train_resilience(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("train pserver"):
        for name, n in train_pserver(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("eager"):
        eager(torch, card, paths)
    torch.cuda.empty_cache()
    with Phase("telemetry"):
        for name, n in telemetry(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("online"):
        for name, n in online(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("fleet"):
        for name, n in fleet(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("train parallel"):
        for name, n in train_parallel(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    with Phase("artifacts"):
        for name, n in artifacts(torch, card, paths).items():
            launches[name] = launches.get(name, 0) + n
    # every main path on replayed CUDA graphs beside the op-by-op path
    log(json.dumps({"paths": paths, "card": card}))
    for name, n in launches.items():
        kernels[name]["launches"] = n
    # an entry with "path": None is on no main path (the flash backward
    # pair: no main path reaches its lengths): its launches are the kernel
    # phase's own
    if not all(k["launches"] for k in kernels.values() if k.get("path", True) is not None):
        raise AssertionError("a kernel never launched on its main path: %s"
                             % {k: v["launches"] for k, v in kernels.items()})
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
