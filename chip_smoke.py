#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (analytics_zoo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero):

1. build: compile every CUDA kernel of the port from ``ops/csrc``, and
   count the tensor-core MMA, ``wgmma``, ``cp.async``, TMA, ``ldmatrix``
   and atomic instructions of each kernel instantiation (none may have
   atomics; the sm90 kernels must have ``wgmma`` and TMA loads, the sm90
   backward no ``mma.sync``, every other kernel ``mma.sync`` and
   ``cp.async``, the baseline forward ``ldmatrix``);
2. kernels: hold each kernel (the flash forward and the backward's dq
   and dk/dv, each at both of its designs where the sm90 one takes the
   case: TMA and ``wgmma``, and the ``mma.sync`` baseline) against its
   plain PyTorch version on the card, at the paths' shapes and at edge
   cases, every kernel launched twice and equal bit for bit, and time
   the kernels (their device time, replayed from a CUDA graph, the median
   and range of three replays, and back-to-back calls from Python), the
   plain version and one PyTorch library call that computes the same
   function, timed the same two ways (a yardstick only; the port never
   calls it);
3. path: ``TransformerLM.generate`` at full width (12 layers, d_model 768,
   12 heads, vocab 32000; batch 8, prompt 512, 128 greedy tokens) from
   seeded random weights, with the kernel launch counts read around it,
   then the full forward as an oracle for every greedy token;
4. serve: the serving plane at the same width (max_len 640):
   ``InferenceModel(decode_capacity=8, decode_prompt_buckets=(128, 256,
   512), decode_prefix_pool=8)`` warmed, 32 requests of 16-512 prompt
   tokens and 8 or 128 new ones streamed from 4 threads (every greedy
   token against the forward's argmax, the flash forward launched 12 times
   an admission, no CUDA graph captured after warm-up), the same requests
   at step_fuse=1 (equal streams; fused and single-step dispatch timed in
   turns, with a steady decode beside), 24 requests sharing a 256-token
   prefix with the prefix pool on and off, speculative decoding with a
   0-layer draft against the plain engine, coalesced LeNet predict from 8
   threads against solo predict, and beam search (4 beams) against the
   forward's log-probs;
5. train: ``TransformerLM.compile``/``fit`` at the same width with
   seq_len 2048 (adam 3e-4, batch 8, 4 steps on 32 periodic sequences
   after a warm-up fit), with the launch counts read around the 4 steps,
   then a gradient check of the kernels' backward against blockwise
   attention on one batch;
6. small: a small model on the card against the same weights on the CPU,
   for predict, greedy streams and 3 training steps;
7. lenet: the reference's LeNet (a Sequential of Convolution2D,
   MaxPooling2D, Flatten, Dense) fitted for 3 epochs on 512 synthetic
   28x28 blobs with validation, then predict, predict_classes, evaluate,
   save_model/load_model and to_model, and the same weights on the CPU;
8. graph: a functional attention Model (Input, Embedding,
   PositionalEmbedding, LayerNorm, MultiHeadSelfAttention(flash), Dense)
   at d_model 768, 12 heads, seq 2048, batch 2: 2 fit steps, each of which
   must launch all three kernels, and predict against the same weights
   under blockwise attention;
9. mixed: the train phase's model and data compiled with
   ``compute_dtype=torch.bfloat16`` and ``accum_steps=2`` (two
   microbatches of 4): a warm-up fit and 4 one-step fits, each of which
   must launch every kernel at bf16 once a layer and microbatch and none
   at f32, with f32 master weights and adam moments after, and losses
   within atol 0.05, rtol 0.05 of the train phase's f32 losses; then, at
   f32 and 2 layers, one step with accum_steps=2 against one with
   accum_steps=1 from the same weights;
10. resnet: ``ImageClassifier("resnet-50")`` on the JAX bench's plan
   (224x224x3, 1000 classes, batch 128, sgd 0.1 momentum 0.9,
   ``compute_dtype=torch.bfloat16``, x ~ N(0, 1) and uniform labels from
   seed 0): a warm-up fit and 10 one-step fits, timed (ms a step,
   images/s, peak GiB, the share of the bf16 peak that the convolutions'
   and Dense's FLOPs make, beside bench.py's analytic count); f32 master
   weights and momentum, every BatchNormalization's count equal to the
   steps and its moving statistics off their init; an f32 copy of the
   seeded init on the card against one on the CPU (batch 4: predict
   within 1e-4, then one sgd step: moving statistics within 1e-4, weight
   change within 0.1, each over the largest entry); f32
   predict of 128 images (rows sum to 1 within 1e-5),
   save_model/load_model (predict within 1e-6, every count and moving
   statistic restored) and to_serving predict of 16 images from 4
   threads within 1e-5;
11. registry: the other eight architectures of the registry at their
   input size (299 for inception-v3), batch 16: one predict and two
   bf16 fit steps each, timed; then the space-to-depth ResNet-50 stem with
   ``space_to_depth_stem_kernel``'s weights against the standard stem
   (f32 predict within 1e-4);
12. detect: ``ObjectDetector("ssd-vgg16-300")`` with PASCAL VOC's 21
   classes (conf 0.01, NMS 0.45, top_k 200, 100 detections) from seed 0:
   f32 ``predict`` of 8 images of 300x300 (x ~ U(0, 255)) and
   ``decode_output`` on the card, timed (ms, images/s, peak GiB, the
   share of the f32 peak that the convolutions' FLOPs make, the decode's
   kernel launches), the decode of ``predict``'s numpy with the model's
   priors (on the card, equal), ``ScaleDetection`` to 480x640 (boxes
   inside the image, padding rows all -1); an f32 copy on the CPU with the same
   weights at 2 images (raw head within 1e-4 of its largest entry, equal
   labels, scores and boxes within 1e-4); then ssd-mobilenet-300 (2,252
   priors) and ssd-vgg16-512 (24,656) predict and decode at batch 2;
13. recommend: ``NeuralCF`` on the JAX bench's plan (6040 users x 3706
   items, 5 classes, embeddings 20/20, MF 20, hidden (40, 20, 10), batch
   2800, adam 1e-3, class_nll; ids and labels from seed 0 as
   ``_bench_ncf`` draws them): a warm-up fit, 20 timed one-step fits and
   one fit of 20 epochs (ms a step, steps/s, samples/s, peak GiB; losses
   finite and falling), an f32 copy on the CPU after 3 steps (parameters
   within NCF_TOL of the largest change the steps made),
   ``predict_user_item_pair`` probabilities in [0, 1] and
   ``recommend_for_user`` sorted; ``WideAndDeep("wide_n_deep")`` through
   a fit and a predict (exp rows sum to 1 within 1e-5); a ``CustomLoss``
   model of each form and a ``Parameter`` model through a fit step;
14. textclass: ``TextClassifier`` at the upstream news20 example's
   widths (20 classes, a ``WordEmbedding`` over a 5,000-word 200-d
   GloVe-format file written from seed 0, sequence_length 500,
   encoder_output_dim 256; token ids and labels from seed 0, batch 128,
   adagrad 0.01) with the cnn, lstm and gru encoders, and the sentiment
   app's BiLSTM model (Embedding(20000, 64), Bidirectional(LSTM(32)),
   Dense(2); seq 200, batch 64, adam): a warm-up fit and 10 one-step
   fits each, timed (ms a step, samples/s, kernels a step, peak GiB;
   losses finite and falling), then an f32 copy on the CPU with the same
   weights (dropout off on both): predictions within 1e-4 of the
   largest entry, 3 steps, parameters within 1e-3 of the largest change
   (the CPU's max pool taking the card's argmax picks, which rounding
   can decide differently at a near-tie; the picks that differ are
   counted);
15. moe: the train phase's model and plan with every second MLP a
   ``SwitchMoE`` of 8 experts at capacity factor 1.25 (6 MoE blocks,
   ~334M parameters), f32: a warm-up fit and 4 one-step fits (ms,
   tokens/s, peak GiB, each kernel launched 12 times a step, the share
   of tokens dropped at capacity), gradients against blockwise attention
   with no routing decision differing: each tensor within 1e-3 of its
   largest entry of an f64 blockwise reference, or within twice an f32
   blockwise reference's own distance from it (both references holding
   the kernels' run's relu masks in the experts, which rounding can flip
   at a kink; the flips are counted), the aux term (the
   loss at aux weight 0.01 minus the loss at 0 equals the summed aux
   within 1e-5), the index dispatch against the dense one-hot at (4096,
   768) within 1e-5; ``generate`` (the path phase's plan) against a
   drop-free forward's argmax; ``InferenceModel(decode_capacity=8)``
   streaming 16 mixed requests (every token against the argmax, the
   flash forward once a layer an admission, the captured decode step
   equal to the eager one, a step_fuse=1 engine's streams equal); then
   the same model at bf16 with ``accum_steps=2``: 24 bf16 launches of
   each kernel a step, none at f32, losses within 0.05 of the f32 ones;
16. image: the image-inference path.  64 images of 180-500 px a side,
   written from seed 0 as PNG (a standard-library encoder) into 4 class
   folders, read back by the host's route (the port's native library,
   built with g++ under ``build/native``; else PIL; else the written
   arrays), pixels exact, and through ``ImageLoader.from_folder``;
   ResNet-50 (224x224x3, 1000 classes, f32, seed 0) through
   ``predict_image_set`` with ``ImageConfigure.parse("resnet-50")``
   (host preprocessing, predict and end-to-end times, top-5; a CPU copy
   on the same preprocessed tensors within 1e-4); ``resnet-50-quantize``
   from the same weights (images/s, weights under a third of f32's,
   probabilities within 0.05 of f32's, the int32 accumulators of the
   stem, a 3x3 64->64 and a 1x1 256->64 convolution and the fc at
   batches 1, 2 and 32 on the card equal to the CPU's); SSD-VGG16-300
   with VOC's 21 classes through ``predict_image_set`` with its parsed
   configure (boxes in each image's pixels, a CPU copy at 2 images
   finding the same detections, the int8 variant's raw head within
   0.12); ``InferenceModel(quantize=True)``
   on a saved ResNet-50 from 4 threads, ``reload`` staying int8; a torch
   CNN imported by ``load_torch_state_dict`` within 1e-5;
17. layers: every class of the rest of the Keras layer set and of
   ``keras2`` (advanced activations, noise, the 3-D, atrous, transposed
   and locally connected convolutions, padding, cropping, upsampling,
   bilinear resize up and down, the 1-D and 3-D pools, the rest of
   core.py, the two LRNs, every Merge mode, the torch-style layers) on
   the card against an f32 CPU copy with the same parameters, at batch
   32 of 64x64x64 images, 16^3x16 volumes or 128x256 sequences: forward,
   input and parameter gradients within 1e-5 of the largest entry (2e-5
   for LRN2D, 1e-4 for the 3x3 stride-1 convolutions, whose weight
   gradient cuDNN takes by Winograd), the pads, crops, permutes, the
   upsampling forward and the mask bit for bit, the random layers in
   eval mode; then the conv VAE of the reference's faces app
   (``conv_vae``: 64x64x3, encoder widths 32 to 256, latent 128, a
   ResizeBilinear decoder; vae.py's CustomLoss; adam 1e-3, batch 64 of
   seeded images) at full width: 3 steps against a CPU copy given the
   same sampler noise (losses within 1e-4), eval predictions against the
   copy holding the card's weights and statistics (1e-5; from its own,
   measured), 20 timed one-step fits (ms a step, images/s, peak GiB),
   one profiled step (launches, device ms by kind, idle share), and a
   save_model/load_model round trip on the card predicting the same
   bits;
18. resume: fault-tolerant training at full width, through the
   supervisor's environment contract, with this script as the
   supervisor (one card holds no two-rank pod): the train phase's model
   and plan with dropout 0.1 (adam 3e-4, seq 2048, batch 8, 6 batches an
   epoch, 8 steps) run in worker processes (``RESUME_WORKER``, written
   under ``build/chip_smoke``): two uninterrupted runs (their final
   weights and adam moments compared: the spread); an incarnation with
   ``SeveralIteration(2)`` snapshots under ``ZOO_CKPT_SYNC``,
   ``ZOO_FAULT_CORRUPT_TAG=6`` and ``ZOO_FAULT_CRASH_STEP=7``, which must
   die by SIGKILL after step 7; a second under ``ZOO_RESUME=1``, which
   must discard tag 6 on its checksum, restore tag 4 (epoch step 4),
   replay steps 5-8 across the epoch's end and end on the uninterrupted
   state bit for bit (or within the two runs' spread, when they differ);
   every kernel at least 12 times a step in each run; the recovery
   seconds (import, build, restore with its deep verify, first step);
   the SIGKILLed incarnation runs with ``ZOO_FLIGHTREC_DIR``, and the
   post-mortem of its flight recorder (``flightrec.write_postmortem``)
   must name step 7 as its last completed step;
   then 8 steps with asynchronous ``SeveralIteration(4)`` snapshots
   against 8 without (step ms, the ms the copy to the host blocks, the
   writer's and the commit's seconds, bytes a snapshot, a deep verify);
   then one forward and backward with and without remat on every
   attention and MLP sublayer (dropout 0, same weights and batch): peak
   GiB, ms, flash_fwd 24 launches against 12, gradients within rtol
   2e-4, atol 2e-5;
19. parallel: the parallel strategies on a world of one (one card holds
   no two-rank NCCL group; the ranks' arithmetic is the gloo tests'): an
   NCCL process group and a mesh naming all six axes (each of size 1, so
   every rule table replicates every leaf, which the phase reports),
   then the train phase's model and plan (seq 2048, batch 8, adam 3e-4,
   f32, dropout 0) compiled under ``strategy="fsdp_tp"`` with the
   per-layer tensor rules: a warm-up fit and 4 one-step fits through all
   three kernels (12 launches of each a step), losses and final weights
   bit for bit against the plain Trainer from the same weights (step ms,
   peak GiB and launches of each); ``save_weights`` and a restore onto
   the mesh through ``restore_sharded(shardings=...)`` (DTensor leaves
   placed as the rule tables say, every leaf bit for bit); a
   ``MultiHeadSelfAttention(implementation="ring")`` layer at d 768,
   seq 2048, batch 2 on the ``seq`` axis against the same weights
   through the flash kernels (values within 1e-5, gradients within 1e-4
   of their largest entry); ``moe_sharded`` on an ``expert`` axis of one
   against ``switch_moe`` (equal);
20. observe: observability on the train and serve paths at full width.
   The train phase's model and plan (dropout 0) from one set of
   weights: a warm-up fit, then 3 pairs of 4-step fits with the step
   profiler (its timeline) and the flight recorder off and on in turns,
   each timed by CUDA events around the whole fit (ms a step, the traced
   step rate over the untraced one); losses and final weights bit for
   bit across all of them, each kernel launched 12 times a step in each,
   every timeline row holding the five phases, the recorder's last step
   and step entries, ``train_families()`` and the profiler's families
   through the Prometheus round trip; one fit under
   ``set_tensorboard(profile=True, profile_steps=2)`` whose
   ``torch.profiler`` trace must name all three hand kernels.  Then the
   serve phase's handle: 8 generate requests from 4 threads, each under
   a span of its own (``decode_wait -> prefill -> decode_step``, gap-free
   to 1e-3 ms, 12 flash_fwd launches an admission, no CUDA graph
   captured after warm-up by the profile's compile count, streams equal
   to the same requests untraced; the phases' medians), and one traced
   coalesced LeNet predict (``coalesce_wait, pad, device_put, execute,
   depad``).
21. control: the serving control plane.  (a) The serve phase's handle
   (capacity 8, max_len 640, prompt buckets 128/256/512) deployed as
   ``lm`` v1 (seed 0) in a ``ModelRegistry(max_queue=16,
   max_concurrency=8)``; each of 16 prompts of 16-511 tokens (8-64 new
   tokens) gets its solo greedy stream from v1 and from v2 (seed 1); 4
   clients then cycle through them with ``generate_ex`` while v2
   deploys, until v2 served 16: zero failed requests, every stream equal
   to its serving version's solo stream, both versions served, 12
   flash_fwd launches an admission (warm-up admissions included);
   requests/s, TTFT and ITL medians (from the request spans), v2's
   warm-up seconds and the peak GiB with both engines.  (b) 32 requests
   at once against the bounded queue (high water <= 16; every rejection
   an immediate ``Overloaded`` 429), a LeNet canary at 0.25 routed
   exactly 10 of 40 requests, and a deploy whose warm-up raises leaving
   v1 serving.  (c) Three pageable ResNet-50 f32 handles (coalescing,
   buckets to 32, 224x224) under ``pager={"max_resident": 2}`` and a
   pinned handle of model 0's weights: model 0 faults in bit-equal to
   the pinned handle, and paging it out frees at least 95% of its weight
   bytes on the card; fault-in ms and bytes a fault.  (d) LeNet on
   ``replicas=["cuda:0", "cuda:0"]`` (two streams), coalesced and
   hedged at one bucket (32): every result bit-identical to a solo
   handle's, a replica made to raise is marked unhealthy while its
   groups re-route and a re-probe heals it, a replica slowed by an
   injected 20 ms wait fires hedges that win bit-exact (latency p50/p99
   with hedging and without), and ``set_active_replicas(1)`` then
   ``(2)`` cost no build.

Since PR 18 a shard phase runs last: (a) the serve phase's full-width
TransformerLM, saved and loaded again with ``InferenceModel.load``
under ``{"axes": {"tensor": 2}}`` over ``["cuda:0"] * 4`` (two groups
of two on one card; the model is read onto the host and the card's
allocation grows by the groups' blocks alone), coalesced: every
bucket's output from either group bit-equal to the single-device
handle's, one build a signature and none for group 1, 12 flash_fwd
launches a dispatch, each member's bytes at rest against the whole
model's, the dispatch peak (gathering costs less than half the model),
predict p50/p99 against the single-device handle.  (b) The mesh decode
engine (capacity 8 split over two members on one card) on 16 mixed
prompts: the largest difference of the logits its members' step body
computes (eagerly, at their step batch) to the unsplit engine's
(<= 1e-5, and whether the bits held), streams equal token for token, 12
flash_fwd launches an admission, tokens/s in turns.  (c) A sharded
registry deploy under a pager of one: paged out (the bytes freed),
refused while its placement reads incomplete, faulted in bit-equal.
(d) The kernel-library store (``ZOO_EXECSTORE_DIR``): three worker
processes from fresh copies of the package, no build directory: the
first runs ``nvcc`` and writes, the second builds nothing and gives
the first one's bits, the third after a flipped byte counts the entry
invalid, rebuilds flash_fwd and gives the same bits; ``stat`` lists the
entries with their tag.

Then a fleet phase: the serve phase's full-width TransformerLM served
by ``FleetRouter(n_workers=2, device="cuda")`` on the one card, the
workers running from a fresh copy of the package (no kernel build
directory) over a share under ``build/chip_smoke/fleet`` with the store
in it.  (1) Deploy through the ``lm`` builder: the first activation
runs nvcc and misses the store, the second builds nothing.  (2) 16 of
the serve phase's mixed prompts, greedy and sampled, from 4 threads:
every stream equal to a single-process ``ModelRegistry`` built here from
the same spec, each worker's flash_fwd count (read by ``ping``) 12 an
admission that computed its prompt; requests/s, TTFT and ITL medians
beside the single-process registry's.  (3) Predict of 1 and 2 rows at
640 tokens on the binary wire, then the JSON wire: bit-equal to each
other and to the single-process handle, 12 flash_fwd launches a
dispatch, bytes and p50/p99 a request on each wire; a 4-row reply over
the 256 MiB frame bound comes back as the structured error with its
``attempted_bytes`` and the connection serves on.  (4) v2 (seed 1)
deployed under traffic: no failed request, each reply equal to its
version's reference, no nvcc.  (5) Worker 1 SIGKILLed while it holds a
request: no failed request, a retry, a postmortem, the restarted
worker replaying v2 with no nvcc and no store miss and serving equal
replies; seconds until it is routable again.  (6) The killed request
stitched offline from the flight directory (attributed fraction at
least 0.95; the CLI once), ``fleet_gap_ms`` on traced requests with the
worker leg under ``worker_call``, traced closed-loop requests/s at least
0.95 of untraced.  (7) The scrape holds both ranks and the
``zoo_fleet_*`` families.

Then a stream phase: the train phase's model (seed 0, adam 3e-4) after
one warm-up step fits 4 steps from ``Dataset.from_batch_iterable`` over
32 ``periodic_tokens`` rows pulled in ragged chunks of 3 through a
windowed shuffle of 32 rows; a second model from the same weights fits
the batches the stream emitted from ``Dataset.from_ndarray``
(``shuffle=False``): losses and weights bit for bit, each kernel 12
times a step in both; step ms and tokens/s of each, the host pull ms a
batch.  And an interop phase, reaching no flash kernel: ResNet-50's
stem and stage 1 as an ONNX model built with the port's codec (batch 32
at 224x224) through ``Net.load_onnx`` and an ``InferenceModel`` handle
against the port's CPU conversion (1e-4), and one sgd step on the card
and on the CPU against one in f64; an NHWC GraphDef (Conv2D SAME stride
2, FusedBatchNormV3, MaxPool SAME, BiasAdd, Mean, MatMul, Softmax)
through ``Net.load_tf`` and ``InferenceModel.load_tf`` against the CPU;
``NNClassifier`` (the MNIST MLP) on a frame of numpy columns, 2,048 rows
of 784 features for 2 epochs, its probabilities within 1e-5 of a CPU
copy of the trained weights and a save/load bit for bit.  Each part's
predict ms, rows/s and a converted-graph call's host ms beside its
device ms.

Last, a sanitize phase: the serve phase's model behind a coalescing
handle on the card and one on two replicas of it, each warmed on its
bucket ladder; 32 closed-loop predicts from 4 clients unguarded, then
the same under ``zoolint.sanitize(max_compiles=0, invariants=...)``
(``set_sync_debug_mode("error")``): no error, 0 events of each compile
kind, the coalescer's and replicas' gauges level.  The handle's decode
engine, warmed at every occupancy, serves 16 requests unguarded and
then guarded: the same greedy tokens, 0 events, 12 flash_fwd launches
an admission.  A new bucket in a guarded block raises
``RecompileDetected`` naming ``signature_build``, an injected
``.item()`` raises, and after both the sync mode is the entry one and
no compile listener is left.  Rates with and without the guard.

Every flash forward launch of the train, mixed, serve and sanitize
phases (all at head dim 64) must run the sm90 design: the forward's
running counts by design (``total_by_design``, which no reset clears),
read before and after the phase, warm-ups and checks included, fail the
phase if one went to the baseline.  So must every backward launch at
the dtypes ``BWD_SM90_PHASES`` names for a phase, all at head dim 64
(``total_by_dtype_design``): bf16 in the mixed and moe phases, f32 in
the train, graph, moe, resume, parallel, observe and stream phases (the
resume workers' runs report theirs by design).  The kernels line's
launch counts by design are each phase's own run's, read after its own
reset where its ``launches`` are.

``python3 chip_smoke.py --phases train,resume`` runs only the named
phases (after the build), for a short call.

The card's line, then ``resnet:``, ``detect:``, ``recommend:``,
``textclass:``, ``moe:``, ``image:``, ``layers:``, ``resume:``,
``parallel:``, ``control:``, ``observe:``, ``shard:``, ``fleet:``,
``stream:``, ``interop:`` and ``sanitize:`` summary lines (each
with the card's name and power limit) come near the end; the line
before the last is a JSON object with each kernel's numbers (each
kernel's two designs as two entries, ``flash_fwd`` and
``flash_fwd_base`` etc.); the last line is ``{"ok": true, "device":
{...}}``.  ResNet-50, the registry, SSD, the recommenders, the text
classifiers and the layer set reach
none of the port's CUDA kernels (BatchNorm's closed form, NMS, the
gathers and the recurrences are torch ops): their launch counts stand
beside the other paths'.
Without CUDA, or without the package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

F32_PEAK = 67e12      # FLOP/s, H100 SXM, f32 outside the tensor cores
TF32_PEAK = 495e12    # FLOP/s, H100 SXM, dense TF32 tensor cores
BF16_PEAK = 989e12    # FLOP/s, H100 SXM, dense bf16 tensor cores
HBM_RATE = 3.35e12    # bytes/s, H100 SXM
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # o, dq, dk, dv
#: the forward's lse, which both backward kernels replay p from
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}

FULL = dict(vocab_size=32000, seq_len=1024, n_layers=12, d_model=768,
            n_heads=12, d_ff=3072)
BATCH, PROMPT, NEW = 8, 512, 128
# the repo's training configuration (bench.py transformer_lm_b8_seq2048)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 2048, 8, 4, 3e-4
GRAD_TOL = 1e-3     # per parameter, max|kernels - blockwise| / max|ref|
# LeNet (tests/test_lenet_e2e.py): 512 blobs, 3 epochs at batch 64
LENET_N, LENET_EPOCHS, LENET_BATCH, LENET_TIMED_STEPS = 512, 3, 64, 20
# the graph phase's functional attention model
GRAPH = dict(vocab=32000, d_model=768, n_heads=12, seq=2048, batch=2,
             steps=2)
# the mixed phase: bf16 compute, two microbatches a step; its losses
# track the f32 ones within the JAX package's own bf16 bound
# (tests/test_trainer_sharded.py::test_bf16_keeps_f32_master_weights_...)
MIXED_ACCUM = 2
MIXED_LOSS_TOL = dict(atol=0.05, rtol=0.05)
# accum_steps=2 against 1 at f32, 2 layers, one sgd step at rate 1, so
# that the weights move by the (accumulated) gradient itself: adam's
# first step, lr * g / (|g| + eps), is +-lr wherever |g| >> eps (it
# hides a wrongly scaled gradient) and amplifies the rounding of
# gradients near eps.  The bound of the JAX package's accumulation test
# on the weights, and 1e-4 (not the CPU's 1e-5) on the losses: the
# 3xTF32 kernels and the GEMMs re-associate differently at half the
# batch
ACCUM_LAYERS = 2
ACCUM_OPTIMIZER = {"name": "sgd", "lr": 1.0}
ACCUM_TOL = dict(loss_rtol=1e-4, rtol=1e-4, atol=1e-6)
# the serve phase: the handle of bench.py's decode cells at full width
SERVE = dict(capacity=8, max_len=640, buckets=(128, 256, 512), pool=8,
             requests=32, threads=4, max_new=(8, 8, 8, 8, 128),
             prefix_len=256, prefix_tail=32, prefix_requests=24,
             spec_requests=8, steady_len=16, steady_new=128,
             spec_new=32, spec_tokens=4, spec_scale=0.02,
             predict_threads=8, predict_requests=4, beams=4, beam_batch=2)
TIE = 1e-4          # top-2 log-prob gap below which a greedy pick is a tie
BEAM_TOL = 1e-3     # beam score against the forward's summed log-probs
PREDICT_TOL = 1e-5  # coalesced predict against solo predict
# the resnet phase: the JAX bench's plan (bench.py:129-160), ResNet-50 at
# 224x224, 1000 classes, batch 128, sgd 0.1 momentum 0.9, bf16 compute;
# then an f32 copy on the card against the CPU at batch 4
RESNET = dict(size=224, classes=1000, batch=128, timed_steps=10,
              cpu_batch=4, predict_rows=128, serve_rows=16,
              serve_threads=4)
RESNET_OPTIMIZER = {"name": "sgd", "lr": 0.1, "momentum": 0.9}
# the weight change's bound is the JAX package's own spread, doubled:
# at its random init ResNet-50's training-mode gradient is
# ill-conditioned (the stem's norm near 1e4), and the JAX package's two
# forms of BatchNorm give weight changes 4.9% apart on the CPU
# (tests/test_torch_image_classifier.py); the card's f32 step lands
# 2-4% from the CPU's, its forward within 1e-6
RESNET_TOL = dict(cpu_predict=1e-4, cpu_stats=1e-4, cpu_change=0.1,
                  row_sum=1e-5, load=1e-6, serve=1e-5)
#: bench.py:306's analytic count: ResNet-50's forward is 4.09 G
#: multiply-adds an image at 224x224, and a train step 3 forwards
BENCH_GMAC_PER_IMAGE = 4.09
# the registry phase: the other eight architectures at their registry
# input size, one predict and two bf16 fit steps each
REGISTRY = dict(batch=16, sizes={"inception-v3": 299}, s2d_rows=8,
                s2d_tol=1e-4)
# the detect phase: SSD-VGG16-300 with PASCAL VOC's 21 classes and the
# registry's postprocessing, f32 at batch 8 on x ~ U(0, 255); then an f32
# copy on the CPU at 2 images, and the other two architectures at batch 2
DETECT = dict(name="ssd-vgg16-300", classes=21, size=300, batch=8,
              conf_threshold=0.01, nms_threshold=0.45, top_k=200,
              max_detections=100, reps=5, cpu_rows=2, scaled=(480, 640),
              priors=8732, others={"ssd-mobilenet-300": (300, 2252),
                                   "ssd-vgg16-512": (512, 24656)},
              other_batch=2)
DETECT_TOL = 1e-4   # raw head over its largest entry; scores and boxes
# the recommend phase: bench.py's NCF plan (_bench_ncf, ncf_b2800_plan:
# MovieLens-1M's 6040 users x 3706 items, 5 classes, batch 2800, adam
# 1e-3, class_nll), then 3 steps of an f32 copy on the CPU
NCF = dict(users=6040, items=3706, classes=5, embed=20, mf=20,
           hidden=(40, 20, 10), batch=2800, timed_steps=20, cpu_steps=3,
           pairs=64, top=3)
NCF_OPTIMIZER = {"name": "adam", "lr": 1e-3}
NCF_TOL = 1e-3      # parameters over the largest change, card vs CPU
                    # (read 1.7e-4 on an H100 80GB HBM3 at 700 W)
WND_TOL = 1e-5      # WideAndDeep's probability rows sum to 1
# the textclass phase: TextClassifier at the upstream news20 example's
# widths (20 classes, GloVe 200-d) and the JAX package's defaults
# (sequence_length 500, encoder_output_dim 256), a WordEmbedding over a
# 5,000-word GloVe-format file written from seed 0, batch 128, adagrad
# 0.01; then the sentiment app's --data model
# (apps/sentiment-analysis/sentiment.py:113-124) on random ids
TEXTCLASS = dict(classes=20, token_length=200, sequence_length=500,
                 encoder_output_dim=256, words=5000, batch=128,
                 timed_steps=10, check_steps=3,
                 encoders=("cnn", "lstm", "gru"))
TEXTCLASS_OPTIMIZER = {"name": "adagrad", "lr": 0.01}
SENTIMENT = dict(vocab=20000, embed=64, units=32, seq=200, batch=64)
# card against an f32 CPU copy: predictions over their largest entry,
# parameters over the largest change the check's steps made
TEXT_TOL = dict(predict=1e-4, change=1e-3)
# the moe phase: the train phase's model and plan with the JAX package's
# Switch-MoE defaults: every second block's MLP a SwitchMoE of 8 experts
# at capacity factor 1.25 (6 MoE blocks), aux weight 0.01
MOE = dict(moe_every=2, n_experts=8, capacity_factor=1.25)
MOE_AUX = 0.01
MOE_DISPATCH = (4096, 768)  # (tokens, d_model) of the dispatch check
MOE_SERVE_REQUESTS = 16
# the aux term against the loss difference (absolute), the index
# dispatch against the dense one-hot (over the largest entry), the
# graph-captured decode step's caches against the eager step's
MOE_TOL = dict(aux=1e-5, dispatch=1e-5, cache=1e-5)
# the image phase: 64 images of 180-500 px a side from seed 0 in 4 class
# folders, through ImageConfigure's registry preprocessing to ResNet-50
# (f32 and int8) and SSD-VGG16-300; the CPU copies at cpu_rows images
# (probabilities within prob_tol), the int8 model within the JAX
# package's bounds of its f32 one (tests/test_quantize.py: probabilities
# 0.05, SSD's raw head 0.12 of its largest entry), and a torch CNN
# imported within import_tol; the int8 twin served from 4 threads
IMAGE = dict(images=64, classes=4, sides=(180, 500), seed=0, cpu_rows=8,
             prob_tol=1e-4, int8_prob_tol=0.05, int8_head_tol=0.12,
             int8_cpu_tol=1e-5, int8_top1_floor=0.5, layer_tol=1e-5,
             import_tol=1e-5,
             fc_batches=(1, 2, 32),
             threads=4, per_request=4, requests=96, passes=3)
# the parallel phase: the train plan under fsdp_tp with the per-layer
# tensor rules (the port's TransformerLM leaf paths, the JAX package's);
# the ring layer against the flash kernels (over the largest entry)
PARALLEL_RULES = {r"attn_\d+/W[qkv]$": 1, r"attn_\d+/Wo$": 0,
                  r"mlp_up_\d+/W$": 1, r"mlp_down_\d+/W$": 0}
PARALLEL = dict(ring_batch=2, moe_tokens=4096, moe_experts=8)
PARALLEL_TOL = dict(ring=1e-5, ring_grad=1e-4)
#: the summary line printed near the end for each phase, and its keys
SUMMARIES = {
    "resnet": ("step_ms", "images_per_s", "peak_gib", "flop_share_bf16",
               "bench_analytic_share_bf16", "batch", "size", "card"),
    "detect": ("predict_ms", "decode_ms", "images_per_s", "decode_launches",
               "peak_gib", "flop_share_f32", "batch", "card"),
    "recommend": ("step_ms", "steps_per_s", "samples_per_s",
                  "fit_ms_per_step", "peak_gib", "batch", "card"),
    "textclass": ("summary", "card"),
    "moe": ("step_ms", "tokens_per_s", "peak_gib", "dropped_share",
            "launches_per_step", "bf16_step_ms", "generate_ms",
            "serve_tokens_per_s", "card"),
    "image": ("images", "decode_route", "resize_branch",
              "host_preprocess_ms_per_image", "f32_images_per_s",
              "int8_images_per_s", "card"),
    "layers": ("sweep_failed", "step_ms", "images_per_s", "peak_gib",
               "launches_per_step", "idle_share", "loss_rel_err",
               "predict_rel_err", "own_state_predict_rel_err", "card"),
    "resume": ("resumed_vs_uninterrupted", "uninterrupted_runs_differ",
               "incarnation2", "async", "postmortem", "card"),
    "parallel": ("backend", "mesh", "split_leaves", "fit_bitwise",
                 "sharded_step_ms", "plain_step_ms", "step_ratio",
                 "sharded_peak_gib", "plain_peak_gib", "restore_bitwise",
                 "ring_rel_err", "ring_grad_rel_err", "moe_equal",
                 "card"),
    "control": ("requests_per_s", "ttft_ms_median", "itl_ms_median",
                "v2_warmup_s", "peak_gib", "fault_in_ms", "bytes_per_fault",
                "hedged_ms", "unhedged_ms", "card"),
    "observe": ("step_ms_off", "step_ms_on", "rate_ratio_on_off", "bitwise",
                "profile_hand_kernels", "decode_phase_median_ms",
                "predict_chain", "card"),
    "shard": ("whole_model_bytes", "member_bytes", "dispatch_peak_bytes",
              "gather_bytes", "predict_ms", "decode_tokens_per_s",
              "logit_max_abs_diff", "logit_bits_equal", "freed_bytes",
              "store_cold_build_s", "store_warm_first_answer_s", "card"),
    "stream": ("step_ms", "memory_step_ms", "tokens_per_s",
               "memory_tokens_per_s", "host_pull_ms_per_batch",
               "losses_bitwise", "weights_bitwise", "launches_per_step",
               "card"),
    "interop": ("onnx", "tf", "frame", "card"),
    "sanitize": ("predict_solo", "predict_replicas", "decode", "sync_mode",
                 "card"),
    "fleet": ("requests_per_s", "ref_requests_per_s", "ttft_ms_median",
              "ref_ttft_ms_median", "itl_ms_median", "ref_itl_ms_median",
              "first_activation_kernel_builds", "warm_ms", "fanout_s",
              "predict_ms_p50", "recovery_s", "attributed_fraction",
              "traced_ratio", "card"),
}
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_fwd": ("analytics_zoo_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
                  "analytics_zoo_tpu/ops/attention.py:149"),
    "flash_bwd_dq": ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd_sm90.cu",
                     "analytics_zoo_tpu/ops/attention.py:214"),
    "flash_bwd_dkv": ("analytics_zoo_tpu_torch/ops/csrc/flash_bwd_sm90.cu",
                      "analytics_zoo_tpu/ops/attention.py:265"),
}
#: the flash forward's designs (``_kernels.fwd_design``): the sm90 one runs
#: every main-path launch (d = 64), the baseline every shape TMA or wgmma
#: does not take
FWD_SOURCES = {"sm90": KERNELS["flash_fwd"][0],
               "base": "analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu"}
#: the backward kernels' designs (``_kernels.bwd_design``): the sm90 one
#: runs every main-path launch (d = 64, f32 and bf16), the baseline every
#: shape TMA or wgmma does not take
BWD_SOURCES = {"sm90": KERNELS["flash_bwd_dq"][0],
               "base": "analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu"}
SOURCES = {"flash_fwd": FWD_SOURCES, "flash_bwd_dq": BWD_SOURCES,
           "flash_bwd_dkv": BWD_SOURCES}
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
#: the phases whose every flash_fwd launch (all d = 64) must be sm90's
SM90_PHASES = ("train", "mixed", "serve", "sanitize")
#: the phases whose every backward launch at these dtypes (all d = 64) must
#: be sm90's
BWD_SM90_PHASES = {"train": ("f32",), "graph": ("f32",),
                   "mixed": ("bf16",), "moe": ("f32", "bf16"),
                   "resume": ("f32",), "parallel": ("f32",),
                   "observe": ("f32",), "stream": ("f32",)}
#: FLOP per valid (query, key) pair and head-dim element, per kernel:
#: 2 per product, and 2, 3 or 4 products
PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def log(*a):
    print(*a, flush=True)


def all_sm90(kernels, name, before):
    """Whether every flash_fwd launch of a phase ran the sm90 design, and
    at least one did: the forward's ``total_by_design`` (which no reset
    clears) against ``before``, its value at the phase's start, so the
    phase's warm-ups and checks count too."""
    seen = {d: kernels.flash_fwd.total_by_design[d] - before.get(d, 0)
            for d in kernels.FWD_DESIGNS}
    log(f"{name}: flash_fwd launches by design over the whole phase "
        f"{json.dumps(seen)}")
    if seen["base"] or not seen["sm90"]:
        log(f"{name}: FAIL {seen['base']} d = 64 flash_fwd launches went "
            f"to the baseline, {seen['sm90']} to sm90")
        return False
    return True


def bwd_all_sm90(kernels, name, before, dtypes):
    """Whether every backward launch of a phase at each of ``dtypes``
    ("f32", "bf16") ran the sm90 design, and at least one did, for each
    backward kernel: its ``total_by_dtype_design`` against ``before``
    ({kernel: counts at the phase's start})."""
    ok = True
    for kernel in BWD_KERNELS:
        totals = kernels.KERNELS[kernel].total_by_dtype_design
        for dt in dtypes:
            seen = {d: totals[f"{dt},{d}"] - before[kernel].get(
                f"{dt},{d}", 0) for d in kernels.BWD_DESIGNS}
            log(f"{name}: {kernel} {dt} launches by design over the whole "
                f"phase {json.dumps(seen)}")
            if seen["base"] or not seen["sm90"]:
                log(f"{name}: FAIL {seen['base']} {dt} {kernel} launches "
                    f"went to the baseline, {seen['sm90']} to sm90")
                ok = False
    return ok


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, stream=None):
    """The device time of one call of ``fn``: the median of
    :func:`device_times`."""
    import statistics
    return statistics.median(device_times(fn, reps, stream))


def device_times(fn, reps, stream=None, replays=3):
    """The device time of one call of ``fn`` in each of ``replays``
    replays: ``reps`` calls captured into a CUDA graph (on ``stream``,
    else torch's capture stream), each replay timed by CUDA events.
    Unlike :func:`cuda_ms` it holds no host time: a call whose launches
    take the host longer than the card takes to run them reads the card's
    time, not the host's.  (A ``torch.profiler`` session would read the
    same and leave its tracer in the process, slowing every later
    phase.)"""
    import torch
    fn()
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm off the capture's stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def timed_ms(fn, reps, stream=None):
    """``ms`` (the median of three device-time replays, as
    :func:`device_times`), ``ms_min`` and ``ms_max`` of one call."""
    import statistics
    times = device_times(fn, reps, stream)
    return dict(ms=statistics.median(times), ms_min=min(times),
                ms_max=max(times))


def attention_bound(q, k, lens, causal, kernel="flash_fwd"):
    """The least time for this call's work, as a dict: ``bound_ms`` and
    ``bound_by`` ("bytes" or "operations") on the tensor cores, where f32
    products at f32 accuracy cost three TF32 products (3xTF32, 3 x ops at
    495 TFLOP/s) and bf16 ones one (989 TFLOP/s); ``bound_f32_cuda_ms``,
    the same work in f32 on the CUDA cores (67 TFLOP/s) or bytes.
    Operations: 2*d FLOP per product per valid (query, key) pair, with 2
    products in the forward (q.k, p.v), 3 in dq (q.k, do.v, ds.k) and 4 in
    dk/dv (k.q, v.do, p.do, ds.q).  Bytes: each input read once and each
    output written once -- per query row q-sized tensors (fwd: q, o; dq:
    q, do, dq; dkv: q, do) and f32 statistics (lse; lse and delta), the
    keys and values each row may see, and dk, dv in full; and lens."""
    import torch
    bh, sq, d = q.shape
    sk = k.shape[1]
    limit = torch.full((sq,), sk, dtype=torch.float64, device=q.device)
    if causal:
        limit = torch.arange(sq, device=q.device, dtype=torch.float64) \
            + (sk - sq + 1)
    per_bh = (torch.full((bh,), float(sk), dtype=torch.float64,
                         device=q.device) if lens is None
              else lens.double())
    pairs = float(torch.minimum(limit[None, :], per_bh[:, None]).sum())
    ops = 2.0 * d * PRODUCTS[kernel] * pairs
    keys = float(per_bh.sum())
    item = q.element_size()
    q_side, stats, full_kv = {"flash_fwd": (2, 1, 0),
                              "flash_bwd_dq": (3, 2, 0),
                              "flash_bwd_dkv": (2, 2, 2)}[kernel]
    nbytes = (q_side * bh * sq * d * item + 2 * keys * d * item
              + full_kv * bh * sk * d * item + stats * bh * sq * 4
              + (0 if lens is None else bh * 4))
    t_ops = (3 * ops / TF32_PEAK if q.dtype == torch.float32
             else ops / BF16_PEAK)
    t_bytes = nbytes / HBM_RATE
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_f32_cuda_ms=max(ops / F32_PEAK, t_bytes) * 1e3)


#: SDPA's backends, fused ones first (names of torch's SDPBackend)
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_call(q, k, v, lens, causal, scale):
    """(fn, backend): one F.scaled_dot_product_attention call on the
    (1, bh, s, d) view of folded (bh, s, d) inputs -- the fused backends
    take 4-D inputs only -- held to the first backend of SDPA_BACKENDS
    that runs it, and that backend's name."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = q[None], k[None], v[None]
    sq, sk = q.shape[1], k.shape[1]
    kw = dict(scale=scale)
    if lens is None and (not causal or sq == sk):
        kw["is_causal"] = causal
    else:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask.tril(sk - sq)
        mask = mask[None]
        if lens is not None:
            mask = mask & (torch.arange(sk, device=q.device)[None, None, :]
                           < lens[:, None, None])
        kw["attn_mask"] = mask[None]
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def fn(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4, **kw)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fn()
        except RuntimeError:
            continue
        return fn, name.lower()
    raise RuntimeError("no SDPA backend runs this case")


# name, bh, sq, sk, d, dtype, causal, longest length (None: no lens),
# timed
CASES = [
    ("prefill", 96, 512, 512, 64, "float32", True, None, True),
    ("predict", 96, 1024, 1024, 64, "float32", True, None, True),
    ("train", 96, TRAIN_SEQ, TRAIN_SEQ, 64, "float32", True, None, True),
    ("prefill", 96, 512, 512, 64, "bfloat16", True, None, True),
    # the serve phase's prefills, one prompt (12 heads) per bucket: the
    # admission's and the prefix block's
    *[("serve admit", 12, s, s, 64, "float32", True, None, True)
      for s in SERVE["buckets"]],
    ("predict", 96, 1024, 1024, 64, "bfloat16", True, None, True),
    # the shard phase's sharded predict at its top bucket (4 rows of 12
    # heads at the serve model's 640 positions)
    ("shard predict", 48, SERVE["max_len"], SERVE["max_len"], 64,
     "float32", True, None, True),
    # the fleet phase's predicts of 1 and 2 rows at the same 640 positions,
    # launched in the workers
    *[("fleet predict", 12 * rows, SERVE["max_len"], SERVE["max_len"], 64,
       "float32", True, None, True) for rows in (1, 2)],
    ("cross causal", 24, 192, 512, 64, "float32", True, None, False),
    ("cross", 24, 200, 777, 64, "float32", False, None, False),
    ("kv_lengths", 24, 512, 512, 64, "float32", True, 512, False),
    ("kv_lengths", 24, 300, 300, 64, "bfloat16", False, 300, False),
    ("prime", 12, 37, 37, 64, "float32", True, None, False),
    ("prime d128", 12, 251, 251, 128, "float32", False, 251, False),
    ("d128", 24, 384, 384, 128, "bfloat16", True, None, False),
    ("d16", 4, 40, 40, 16, "float32", True, None, False),
    # lengths of at most 130 of 700 keys: whole key tiles lie past them
    ("tiles past lens", 8, 160, 700, 64, "float32", False, 130, False),
    # the backward kernels' tile edges: lengths one short of and one past
    # 64 and 128 (own tiles of 64 rows, walked tiles of 32), head dims
    # that are no multiple of the MMA depth (8 f32, 16 bf16) and whose
    # rows are no 16-byte multiple (plain-load staging), cross causal
    ("edge 63", 8, 63, 63, 64, "float32", True, None, False),
    ("edge 65", 8, 65, 65, 64, "bfloat16", True, 65, False),
    ("edge 127", 8, 127, 127, 64, "float32", False, 127, False),
    ("edge 129", 8, 129, 129, 64, "float32", True, None, False),
    ("d20", 8, 129, 129, 20, "float32", True, 129, False),
    ("d20", 8, 127, 127, 20, "bfloat16", True, None, False),
    ("d72", 8, 200, 200, 72, "float32", True, None, False),
    ("d72", 8, 65, 65, 72, "bfloat16", False, 65, False),
    ("d37", 4, 65, 65, 37, "float32", True, None, False),
    ("d5", 4, 63, 63, 5, "bfloat16", False, 63, False),
    ("d128 edge", 8, 129, 129, 128, "float32", True, 129, False),
    ("d128 cross causal", 8, 63, 129, 128, "bfloat16", True, None, False),
    ("cross causal lens", 8, 65, 127, 64, "float32", True, 127, False),
    ("cross causal d72", 8, 127, 129, 72, "bfloat16", True, None, False),
    ("train", 96, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16", True, None, True),
    # the mixed phase's microbatch: 4 of the 8 sequences
    ("mixed", 48, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16", True, None, True),
    # head dims past 128 (DP = 256: 16-row walked tiles at f32, dk/dv in
    # two 128-column halves); rows of 130 f32 or 250 bf16 are no 16-byte
    # multiple, and d = 130 leaves one column tile in the second half
    ("d192", 8, 129, 129, 192, "float32", True, 129, False),
    ("d192", 8, 127, 127, 192, "bfloat16", True, None, False),
    ("d256", 8, 200, 200, 256, "float32", True, None, False),
    ("d256 cross causal", 8, 65, 129, 256, "bfloat16", True, 129, False),
    ("d130", 4, 63, 63, 130, "float32", False, 63, False),
    ("d250", 4, 65, 65, 250, "bfloat16", True, None, False),
    # the forward's ragged query edge at its extreme: one or two query
    # rows at the end of a long causal key range; and f32 d = 256 (16-key
    # walked tiles) with lengths
    ("sq 1", 8, 1, 512, 64, "float32", True, None, False),
    ("sq 2", 8, 2, 512, 64, "float32", True, 512, False),
    ("sq 2", 8, 2, 512, 64, "bfloat16", True, None, False),
    ("d256 lens", 8, 129, 300, 256, "float32", False, 300, False),
    # the sm90 backward's TMA edges at the head dims it takes beyond 64
    # and 128: 32 (a half-empty swizzle atom) and 96 (1.5 atoms)
    ("d32", 8, 200, 333, 32, "bfloat16", False, 333, False),
    ("d96 cross causal", 8, 129, 300, 96, "bfloat16", True, 300, False),
]


def case_inputs(torch, g, bh, sq, sk, d, dtype, lens_max):
    dtype = getattr(torch, dtype)
    q, do = (torch.randn((bh, sq, d), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bh, sk, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lens = None
    if lens_max is not None:
        lens = torch.randint(1, lens_max + 1, (bh,), generator=g,
                             device="cuda").float()
    return q, k, v, do, lens


def sdpa_backward_call(torch, q, k, v, do, lens, causal, scale, stream):
    """(fn, backend): the library yardstick of the backward, autograd of
    scaled_dot_product_attention (:func:`sdpa_call`) from one saved
    forward (retain_graph), timed apart from that forward.  The forward
    runs on ``stream``, where autograd then runs the backward: a capture
    on ``stream`` (``device_ms(fn, reps, stream)``) holds it."""
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # every node of the forward, views too
        fwd, backend = sdpa_call(qs, ks, vs, lens, causal, scale)
        out = fwd()
    torch.cuda.current_stream().wait_stream(stream)
    return (lambda: torch.autograd.grad(out, (qs, ks, vs), do[None],
                                        retain_graph=True)), backend


SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "LDSM", "ATOM", "RED")


def sass_counts(kernels):
    """Per kernel instantiation of the built libraries, counts of the SASS
    instructions that show the design (``cuobjdump -sass``): HMMA
    (mma.sync), HGMMA (wgmma), LDGSTS (cp.async), UTMALDG (TMA loads),
    LDSM (ldmatrix), ATOM and RED (atomics).  None where the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts, fn = {}, None
    for lib in sorted(kernels._build_dir().glob("*.so")):
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        for line in text.splitlines():
            if "Function :" in line:
                m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_sm90)?"
                              r"_kernel)I(f|13__nv_bfloat16)Li(\d+)E"
                              r"(?:Li(\d+)E)?", line)
                fn = (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}"
                      f"{',' + m[4] if m[4] else ''}>"
                      if m else line.split("Function :")[1].strip())
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
                continue
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z]+)",
                          line)
            if fn and op and op[1] in counts[fn]:
                counts[fn][op[1]] += 1
    return counts


def phase_kernels(torch, ops_attn, kernels):
    """Each kernel against its plain version, case by case: flash_fwd
    against flash_attention_reference (o within TOL, lse within LSE_TOL)
    at the design ``fwd_design`` picks and, where that is sm90, at the
    baseline too, each forward launched twice and equal bit for bit;
    flash_bwd_dq and flash_bwd_dkv the same way at the design
    ``bwd_design`` picks and the baseline, against flash_bwd_dq_reference
    and flash_bwd_dkv_reference (dq, dk, dv each within max|diff| /
    max|ref| <= TOL), dk = dv = 0 exactly past every length, and a second
    launch of each backward kernel equal to the first, bit for bit.
    Timed cases time every kernel at each of its designs (the backward at
    the training sequence, beside SDPA's backward)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = [], True
    diff = lambda a, b: float((a.double() - b.double()).abs().max())
    rel = lambda a, b: diff(a, b) / max(float(b.double().abs().max()),
                                        1e-30)
    for name, bh, sq, sk, d, dt, causal, lens_max, timed in CASES:
        q, k, v, do, lens = case_inputs(torch, g, bh, sq, sk, d, dt,
                                        lens_max)
        masked = lens is not None
        scale = d ** -0.5
        o_ref, lse_ref = ops_attn.flash_attention_reference(
            q, k, v, causal, scale, lens)
        chosen = kernels.fwd_design(q.dtype, d, (q.stride(), k.stride(),
                                                 v.stride()),
                                    (q.data_ptr(), k.data_ptr(),
                                     v.data_ptr()))
        base = dict(case=name, dtype=dt, bh=bh, sq=sq, sk=sk, d=d,
                    causal=causal, lens=masked)
        fwd_rows, outs = [], {}
        for design in dict.fromkeys((chosen, "base")):
            o, lse = kernels.flash_fwd._run(design, q, k, v, lens, causal,
                                            scale)
            again = kernels.flash_fwd._run(design, q, k, v, lens, causal,
                                           scale)
            torch.cuda.synchronize()
            outs[design] = (o, lse)
            row = dict(base, kernel="flash_fwd", design=design,
                       abs_err=diff(o, o_ref), err_lse=diff(lse, lse_ref),
                       deterministic=bool(torch.equal(o, again[0])
                                          and torch.equal(lse, again[1])))
            row["ok"] = (row["abs_err"] <= TOL[dt]
                         and row["err_lse"] <= LSE_TOL[dt]
                         and row["deterministic"]
                         and bool(torch.isfinite(o).all()))
            fwd_rows.append(row)
        o, lse = outs[chosen]
        delta = ops_attn._flash_delta(o, do)
        args = (q, k, v, do, lse, delta, lens, causal, scale)
        refs = {"flash_bwd_dq": (ops_attn.flash_bwd_dq_reference(*args),),
                "flash_bwd_dkv": ops_attn.flash_bwd_dkv_reference(*args)}
        bwd_chosen = kernels.bwd_design(
            q.dtype, d, [t.stride() for t in (q, k, v, do)],
            [t.data_ptr() for t in (q, k, v, do)])
        bwd_rows = []
        for design in dict.fromkeys((bwd_chosen, "base")):
            got = {"flash_bwd_dq": (kernels.flash_bwd_dq._run(design, *args),),
                   "flash_bwd_dkv": kernels.flash_bwd_dkv._run(design, *args)}
            again = {"flash_bwd_dq": (kernels.flash_bwd_dq._run(design,
                                                                *args),),
                     "flash_bwd_dkv": kernels.flash_bwd_dkv._run(design,
                                                                 *args)}
            torch.cuda.synchronize()
            deterministic = all(map(torch.equal, (*got["flash_bwd_dq"],
                                                  *got["flash_bwd_dkv"]),
                                    (*again["flash_bwd_dq"],
                                     *again["flash_bwd_dkv"])))
            for kern in BWD_KERNELS:
                errs = [rel(a, b) for a, b in zip(got[kern], refs[kern])]
                row = dict(base, kernel=kern, design=design, err=max(errs),
                           abs_err=max(diff(a, b) for a, b in zip(
                               got[kern], refs[kern])),
                           deterministic=deterministic)
                if kern == "flash_bwd_dkv":
                    row.update(err_dk=errs[0], err_dv=errs[1])
                row["ok"] = (row["err"] <= TOL[dt] and deterministic and all(
                    bool(torch.isfinite(a).all()) for a in got[kern]))
                if masked and kern == "flash_bwd_dkv":
                    past = (torch.arange(sk, device="cuda")[None, :]
                            >= lens[:, None])[..., None]
                    row["zero_past_lens"] = all(
                        bool((a.masked_select(past) == 0).all())
                        for a in got[kern])
                    row["ok"] &= row["zero_past_lens"]
                bwd_rows.append(row)
        if timed:
            # ms: the kernels' device time (timed_ms, a replayed CUDA
            # graph: the median and range of three replays); eager_ms:
            # back-to-back calls from Python, the host's launch path
            # included
            lib_fn, lib_backend = sdpa_call(q, k, v, lens, causal, scale)
            common = dict(
                plain_ms=cuda_ms(lambda: ops_attn.flash_attention_reference(
                    q, k, v, causal, scale, lens), 3),
                library_ms=device_ms(lib_fn, 20),
                library_eager_ms=cuda_ms(lib_fn, 20),
                library_backend=lib_backend)
            for row in fwd_rows:
                fn = (lambda design=row["design"]: kernels.flash_fwd._run(
                    design, q, k, v, lens, causal, scale))
                row.update(common, **timed_ms(fn, 20),
                           eager_ms=cuda_ms(fn, 20))
            if sq == TRAIN_SEQ:
                # the backward's yardstick: autograd of SDPA, device time
                # as the kernels', its eager time beside it
                side = torch.cuda.Stream()
                lib_fn, lib_backend = sdpa_backward_call(
                    torch, q, k, v, do, lens, causal, scale, side)
                lib = dict(library_ms=device_ms(lib_fn, 10, side),
                           library_eager_ms=cuda_ms(lib_fn, 10),
                           library_backend=lib_backend)
                plain = {kern: cuda_ms(lambda ref=ref: ref(*args), 2)
                         for kern, ref in (
                             ("flash_bwd_dq", ops_attn.flash_bwd_dq_reference),
                             ("flash_bwd_dkv",
                              ops_attn.flash_bwd_dkv_reference))}
                for row in bwd_rows:
                    fn = (lambda kern=kernels.KERNELS[row["kernel"]],
                          design=row["design"]: kern._run(design, *args))
                    row.update(**timed_ms(fn, 10), eager_ms=cuda_ms(fn, 10),
                               plain_ms=plain[row["kernel"]], **lib)
            for row in (*fwd_rows, *bwd_rows):
                if "ms" in row:
                    row.update(attention_bound(q, k, lens, causal,
                                               row["kernel"]))
                    row["bound_share"] = row["bound_ms"] / row["ms"]
        for row in (*fwd_rows, *bwd_rows):
            ok &= row["ok"]
            rows.append(row)
            log("kernel", json.dumps(row))
    return ok, rows


def phase_path(torch, TransformerLM, kernels):
    """Full-width generate with the launch counts around it, then the
    full forward as the oracle of every greedy token."""
    t0 = time.perf_counter()
    model = TransformerLM(**FULL, device="cuda", seed=0).eval()
    torch.cuda.synchronize()
    log(f"path: model built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, FULL["vocab_size"], (BATCH, PROMPT),
                           generator=g).numpy()

    def timed_generate(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.generate(prompt, n)  # returns host ids: synchronised
        return out, time.perf_counter() - t

    timed_generate(2)  # warm-up: cuBLAS handles, allocator
    t_first = min(timed_generate(1)[1] for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, t_all = timed_generate(NEW)
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    decode_ms = (t_all - t_first) / (NEW - 1) * 1e3
    stats = dict(prefill_ms=t_first * 1e3, generate_ms=t_all * 1e3,
                 decode_ms_per_token=decode_ms,
                 tokens_per_s=BATCH * NEW / t_all,
                 launches=counts, peak_gib=peak_gib)
    log("path:", json.dumps(stats))
    ok = out.shape == (BATCH, PROMPT + NEW) and (out[:, :PROMPT]
                                                 == prompt).all()
    ok &= counts["flash_fwd"] >= FULL["n_layers"]
    if counts["flash_fwd"] < FULL["n_layers"]:
        log(f"path: FAIL flash_fwd launched {counts['flash_fwd']} times, "
            f"expected >= {FULL['n_layers']}")

    oracle = argmax_oracle(torch, model, out, PROMPT)
    log("oracle:", json.dumps(oracle))
    ok &= (oracle["finite"] and oracle["mismatched"] == 0
           and oracle["checked"] >= oracle["total"] // 2)
    return bool(ok), stats


def argmax_oracle(torch, model, out, prompt_len):
    """Token t of each greedy stream (``out``: prompts then continuations)
    against the argmax of one full forward at the position before it;
    positions whose top two log-probs lie within TIE are ties at f32
    noise and are counted, not compared."""
    ids = torch.as_tensor(out[:, :-1], device=model.device)
    with torch.no_grad():
        logp = model(ids)[:, prompt_len - 1:]
    finite = bool(torch.isfinite(logp).all())
    top2 = logp.topk(2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    expect = top2.indices[..., 0].cpu().numpy()
    checked = (margin > TIE).cpu().numpy()
    mismatched = int(((expect != out[:, prompt_len:]) & checked).sum())
    return dict(finite=finite, shape=list(logp.shape),
                checked=int(checked.sum()), total=int(checked.size),
                mismatched=mismatched)


def percentile(values, q):
    import numpy as np
    return float(np.percentile(values, q)) if len(values) else None


def greedy_oracle(torch, model, prompts, outs):
    """Each greedy token against the argmax of the model's forward at the
    position before it, one request at a time: (checked, ties,
    mismatched), positions whose top two log-probs lie within TIE counted
    as ties and not compared."""
    checked = ties = mismatched = 0
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = torch.as_tensor(list(p) + list(o[:-1]), device=model.device)
            logp = model(ids[None])[0, len(p) - 1:]
            top2 = logp.topk(2, dim=-1)
            tie = (top2.values[:, 0] - top2.values[:, 1] <= TIE).cpu()
            bad = (top2.indices[:, 0].cpu()
                   != torch.as_tensor(o, dtype=torch.long)) & ~tie
            ties += int(tie.sum())
            checked += int((~tie).sum())
            mismatched += int(bad.sum())
    return checked, ties, mismatched


def compare_streams(torch, model, prompts, a, b):
    """Two runs' streams of the same greedy requests: (equal, tied,
    differing).  Where two streams part, the pick at the parting
    position must be a tie of the forward (top-2 gap within TIE), or the
    pair counts as differing."""
    equal = tied = differing = 0
    with torch.no_grad():
        for p, x, y in zip(prompts, a, b):
            x, y = list(x), list(y)
            if x == y:
                equal += 1
                continue
            j = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                     min(len(x), len(y)))
            ids = torch.as_tensor(list(p) + x[:j], device=model.device)
            top2 = model(ids[None])[0, -1].topk(2)
            if len(x) == len(y) and float(
                    top2.values[0] - top2.values[1]) <= TIE:
                tied += 1
            else:
                differing += 1
    return equal, tied, differing


def mixed_requests(cfg, rng, n=SERVE["requests"]):
    """The mixed stream's requests: ``n`` prompts of lengths drawn from
    16-512, max_new cycling SERVE["max_new"]."""
    lens = rng.integers(16, SERVE["buckets"][-1] + 1, n)
    prompts = [rng.integers(0, cfg["vocab_size"], int(L)) for L in lens]
    news = [SERVE["max_new"][i % len(SERVE["max_new"])] for i in range(n)]
    return prompts, news


def serve_stream(submit, prompts, news):
    """``prompts`` submitted from SERVE["threads"] threads at once through
    ``submit`` (``generate_stream`` or an engine's ``submit``): the
    outputs, the wall seconds, and each request's time to first token,
    inter-token gaps and time per output token after the first."""
    import threading
    n = len(prompts)
    streams = [None] * n
    errors = []
    go = threading.Event()

    def client(t):
        try:
            go.wait(10)
            mine = range(t, n, SERVE["threads"])
            for i in mine:
                streams[i] = submit(prompts[i], news[i])
            for i in mine:
                streams[i].result(timeout=120)
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE["threads"])]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    go.set()
    for t in threads:
        t.join(180)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    outs = [s.result(timeout=1) for s in streams]
    ttft = [s.t_tokens[0] - s.t_submit for s in streams]
    itl = [b - a for s in streams for a, b in zip(s.t_tokens, s.t_tokens[1:])]
    # time per output token after the first, per request
    tpot = [(s.t_tokens[-1] - s.t_tokens[0]) / (len(s.t_tokens) - 1)
            for s in streams if len(s.t_tokens) > 1]
    return outs, wall, ttft, itl, tpot


def stream_metrics(outs, wall, ttft, itl, tpot):
    """A served stream's end-to-end numbers (the serve line's keys)."""
    tokens = sum(len(o) for o in outs)
    return dict(
        requests=len(outs), generated_tokens=tokens, wall_s=wall,
        requests_per_s=len(outs) / wall, tokens_per_s=tokens / wall,
        ttft_ms_p50=percentile(ttft, 50) * 1e3,
        ttft_ms_p99=percentile(ttft, 99) * 1e3,
        itl_ms_p50=percentile(itl, 50) * 1e3,
        itl_ms_p99=percentile(itl, 99) * 1e3,
        tpot_ms_p50=percentile(tpot, 50) * 1e3,
        tpot_ms_p99=percentile(tpot, 99) * 1e3)


def fusion_timing(torch, submits, vocab, prompts, news):
    """Fused (step_fuse 4) against single-step dispatch, in turns fused,
    unfused, unfused, fused on one card: the mixed stream, then a steady
    decode with no admission in its way (capacity prompts of
    SERVE["steady_len"] tokens, SERVE["steady_new"] new tokens each),
    each run's tokens/s, TPOT p50 and TTFT p50.  Returns the unfused
    engine's first mixed-stream outputs too."""
    import numpy as np
    rng = np.random.default_rng(5)
    steady = [rng.integers(0, vocab, SERVE["steady_len"])
              for _ in range(SERVE["capacity"])]
    steady_new = [SERVE["steady_new"]] * len(steady)
    runs = {"fused": [], "unfused": []}
    first_unfused = None
    for name in ("fused", "unfused", "unfused", "fused"):
        row = {}
        for cell, (ps, ns) in (("mixed", (prompts, news)),
                               ("steady", (steady, steady_new))):
            outs, wall, ttft, itl, tpot = serve_stream(submits[name], ps, ns)
            m = stream_metrics(outs, wall, ttft, itl, tpot)
            row[cell] = dict(tokens_per_s=m["tokens_per_s"],
                             tpot_ms_p50=m["tpot_ms_p50"],
                             ttft_ms_p50=m["ttft_ms_p50"])
            if name == "unfused" and cell == "mixed" and first_unfused is None:
                first_unfused = outs
        runs[name].append(row)
    return runs, first_unfused


def step_times(torch, engine, reps=50):
    """Device ms of one replay of the engine's single-step graph and of
    its fused window (per token), and of the same step run eagerly, at
    the engine's capacity (the engine idle, its state don't-care)."""
    out = {}
    with engine._on_device():
        plans = {"step_ms": (engine._step_plan.graph.replay, 1),
                 "step_ms_eager": (engine._step_body, 1)}
        for k, plan in engine._stepk_plans.items():
            plans[f"window{k}_ms_per_token"] = (plan.graph.replay, k)
        for name, (fn, k) in plans.items():
            out[name] = cuda_ms(fn, reps) / k
    return out


def scaled_copy(torch, TransformerLM, cfg, scale, device):
    """The serve model's weights with every block weight scaled by
    ``scale``: a target its 0-layer draft agrees with often."""
    model = TransformerLM(**cfg, device=device, seed=0).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("attn_", "mlp_", "ln_attn", "ln_mlp")):
                p.mul_(scale)
    return model


def beam_check(torch, model, cfg, generation):
    """generate(num_beams) at the path phase's prompt and length, batch
    SERVE["beam_batch"]; then the plan's beams: descending scores, each
    within BEAM_TOL of the forward's summed log-probs of its tokens, and
    the first equal to generate's answer."""
    import numpy as np
    W, b = SERVE["beams"], SERVE["beam_batch"]
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg["vocab_size"], (b, PROMPT), generator=g)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = model.generate(prompt.numpy(), NEW, num_beams=W)
    beam_s = time.perf_counter() - t
    with torch.no_grad():
        seqs, scores = generation._backtrack_beams(
            *generation.build_beam_fn(PROMPT, NEW, W)(
                model, prompt.to(model.device)))
        ids = torch.cat([prompt.repeat_interleave(W, 0), torch.as_tensor(
            seqs.reshape(b * W, NEW), dtype=torch.long)], 1).to(model.device)
        logp = model(ids[:, :-1])[:, PROMPT - 1:]
        tok = ids[:, PROMPT:]
        ref = logp.gather(-1, tok[..., None])[..., 0].double().sum(-1)
    err = float(np.abs(ref.cpu().numpy().reshape(b, W) - scores).max())
    ok = (out.shape == (b, PROMPT + NEW)
          and (out[:, PROMPT:] == seqs[:, 0]).all()
          and bool((np.diff(scores, axis=1) <= 0).all()) and err <= BEAM_TOL)
    return bool(ok), dict(beams=W, batch=b, new=NEW, seconds=beam_s,
                          score_max_abs_err=err, scores=scores.tolist())


def predict_check(torch, keras, device="cuda"):
    """LeNet through to_serving(coalescing=True) from SERVE[
    "predict_threads"] threads of ragged 1-32-row batches, each result
    within PREDICT_TOL of a solo predict, one build per bucket."""
    import threading
    import numpy as np
    net = build_lenet(keras, device)
    coal = net.to_serving(supported_concurrent_num=2, max_batch_size=32,
                          coalescing=True, warmup_shapes=(28, 28, 1))
    solo = net.to_serving(max_batch_size=32)
    rng = np.random.default_rng(3)
    jobs = [rng.normal(size=(int(rng.integers(1, 33)), 28, 28, 1)).astype(
        np.float32) for _ in range(SERVE["predict_threads"]
                                   * SERVE["predict_requests"])]
    results = [None] * len(jobs)
    errors = []

    def client(t):
        try:
            for i in range(t, len(jobs), SERVE["predict_threads"]):
                results[i] = coal.predict(jobs[i])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE["predict_threads"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    wall = time.perf_counter() - t0
    try:
        if errors:
            raise errors[0]
        err = max(float(np.abs(r - solo.predict(x)).max())
                  for r, x in zip(results, jobs))
        stats = coal.serving_stats()
    finally:
        coal.close()
        solo.close()
    ok = (err <= PREDICT_TOL
          and set(stats["misses"].values()) == {1}
          and set(stats["misses"]) == set(stats["buckets"]))
    return bool(ok), dict(requests=len(jobs), rows=sum(len(x) for x in jobs),
                          seconds=wall, max_abs_err=err,
                          dispatches=stats["dispatches"],
                          misses=stats["misses"])


def phase_serve(torch, TransformerLM, keras, kernels, inference,
                generation, device="cuda"):
    """The serving plane at full width (SERVE): the mixed stream with
    the launch counts read around it, step times, then the fused,
    prefix, speculative, predict and beam checks.  What it holds is
    freed before the next phase, lest it stand in that phase's peak
    memory: its engines and models (a plan's body closes over its
    engine, so they live in reference cycles until a collection), and
    the cuBLAS workspace PyTorch keeps for each stream it ran a GEMM on
    (every engine and coalescer runs on a stream of its own)."""
    import gc
    try:
        return serve_checks(torch, TransformerLM, keras, kernels, inference,
                            generation, device)
    finally:
        gc.collect()
        if device == "cuda":
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()


def serve_checks(torch, TransformerLM, keras, kernels, inference,
                 generation, device):
    import numpy as np
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    model = TransformerLM(**cfg, device=device, seed=0).eval()
    handle = inference.InferenceModel(
        decode_capacity=SERVE["capacity"], decode_max_len=SERVE["max_len"],
        decode_prompt_buckets=SERVE["buckets"],
        decode_prefix_pool=SERVE["pool"])
    t = time.perf_counter()
    handle.load_keras_net(model)
    warm_s = time.perf_counter() - t
    engine = handle.decode_engine
    before = engine.stats()
    rng = np.random.default_rng(2)
    checks, stats = {}, {}
    try:
        prompts, news = mixed_requests(cfg, rng)
        kernels.reset_launch_counts()
        outs, wall, ttft, itl, tpot = serve_stream(handle.generate_stream,
                                                   prompts, news)
        launches = kernels.launch_counts()
        by_design = kernels.launch_counts_by_design()
        after = engine.stats()
        admitted = after["admitted"] - before["admitted"]
        computed = admitted - (after["prefix_hits"] - before["prefix_hits"])
        tokens = sum(len(o) for o in outs)
        checked, ties, mismatched = greedy_oracle(torch, model, prompts,
                                                  outs)
        checks["mixed"] = (
            all(len(o) == m for o, m in zip(outs, news))
            and mismatched == 0 and checked >= tokens // 2
            and launches["flash_fwd"] == cfg["n_layers"] * admitted
            and computed == admitted
            and after["captures"] == before["captures"])
        stats.update(stream_metrics(outs, wall, ttft, itl, tpot))
        stats.update(
            oracle=dict(checked=checked, ties=ties, mismatched=mismatched),
            admitted=admitted, flash_fwd_launches=launches["flash_fwd"],
            launches=launches, launches_by_design=by_design,
            captures=after["captures"],
            captures_at_warmup=before["captures"], warmup_s=warm_s,
            steps=after["steps"] - before["steps"],
            fused_dispatches=(after["fused_dispatches"]
                              - before["fused_dispatches"]))
        stats.update(step_times(torch, engine))

        # the same requests one step a dispatch, timed against the fused
        # handle
        unfused = inference.DecodeEngine(
            model, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"], prefix_pool=SERVE["pool"],
            step_fuse=1)
        try:
            unfused.warmup()
            stats["fusion"], unfused_outs = fusion_timing(
                torch, {"fused": handle.generate_stream,
                        "unfused": unfused.submit}, cfg["vocab_size"],
                prompts, news)
            res = compare_streams(torch, model, prompts, outs, unfused_outs)
        finally:
            unfused.close()
        stats["fused_vs_unfused"] = dict(zip(("equal", "tied",
                                              "differing"), res))
        checks["fused"] = res[2] == 0

        # a shared 256-token prefix, pool on (the handle) and off
        head = rng.integers(0, cfg["vocab_size"], SERVE["prefix_len"])
        pp = [np.concatenate([head, rng.integers(0, cfg["vocab_size"],
                                                 int(u))])
              for u in rng.integers(1, SERVE["prefix_tail"],
                                    SERVE["prefix_requests"])]
        pn = [8 if i % 8 == 7 else 2 for i in range(len(pp))]
        s0 = engine.stats()
        on = handle.generate(pp, pn, timeout=120)
        s1 = engine.stats()
        plain = inference.DecodeEngine(
            model, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"])
        try:
            plain.warmup()
            kernels.reset_launch_counts()
            off = plain.generate(pp, pn, timeout=120)
            off_launches = kernels.launch_counts()["flash_fwd"]
            off_prefills = plain.stats()["prefills"]
        finally:
            plain.close()
        res = compare_streams(torch, model, pp, on, off)
        misses = s1["prefix_misses"] - s0["prefix_misses"]
        stats["prefix"] = dict(zip(("equal", "tied", "differing"), res),
                               misses=misses,
                               hits=s1["prefix_hits"] - s0["prefix_hits"],
                               pool_off_prefills=off_prefills,
                               pool_off_flash_fwd=off_launches)
        checks["prefix"] = (res[2] == 0 and misses == 1
                            and off_prefills == len(pp)
                            and off_launches == cfg["n_layers"] * len(pp))
    finally:
        handle.close()
    del handle, engine

    # speculative decoding against the plain engine, same weights
    target = scaled_copy(torch, TransformerLM, cfg, SERVE["spec_scale"],
                         device)
    sp = prompts[:SERVE["spec_requests"]]
    sn = [SERVE["spec_new"]] * len(sp)
    runs, window_ms = {}, None
    for name, draft in (("spec", inference.skeleton_draft(target)),
                        ("plain", None)):
        eng = inference.DecodeEngine(
            target, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"], draft=draft,
            spec_tokens=SERVE["spec_tokens"])
        try:
            eng.warmup()
            t = time.perf_counter()
            runs[name] = (eng.generate(sp, sn, timeout=120),
                          time.perf_counter() - t, eng.stats())
            if draft is not None and device == "cuda":
                with eng._on_device():
                    window_ms = cuda_ms(eng._spec_plan.graph.replay, 20)
        finally:
            eng.close()
    res = compare_streams(torch, target, sp, runs["spec"][0],
                          runs["plain"][0])
    st = runs["spec"][2]
    stats["spec"] = dict(zip(("equal", "tied", "differing"), res),
                         acceptance=st["spec_acceptance"],
                         windows=st["spec_windows"],
                         window_ms=window_ms,
                         spec_s=runs["spec"][1], plain_s=runs["plain"][1])
    checks["spec"] = res[2] == 0 and st["spec_windows"] > 0
    del target

    checks["predict"], stats["predict"] = predict_check(torch, keras,
                                                        device)
    checks["beam"], stats["beam"] = beam_check(torch, model, cfg,
                                               generation)
    stats["checks"] = checks
    stats["card"] = smi_card()
    log("serve:", json.dumps(stats))
    for name, ok in checks.items():
        if not ok:
            log(f"serve: FAIL {name}")
    return all(checks.values()), stats


def periodic_tokens(n, vocab, seq, seed):
    """The periodic next-token task of tests/test_transformer_lm.py:
    token[t] = (start + step * t) % vocab, step in 1..3 per sequence."""
    import numpy as np
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, n)
    start = rng.integers(0, vocab, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(seq + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def gradient_pairs(torch, model, objectives, x, y,
                   impls=("flash", "blockwise")):
    """One backward through the kernels and one through blockwise
    attention (each of ``impls``), same weights and batch: {parameter
    name: (the gradient of each implementation, in order)}."""
    attns = [getattr(model, f"attn_{i}")
             for i in range(model.hyper["n_layers"])]
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    ids = torch.as_tensor(x, device="cuda")
    labels = torch.as_tensor(y, device="cuda")
    grads = []
    try:
        for impl in impls:
            for a in attns:
                a.implementation = impl
            loss = objectives.class_nll(labels, model(ids)).mean()
            grads.append(torch.autograd.grad(loss, [p for _, p in named]))
            del loss
    finally:
        for a in attns:
            a.implementation = "auto"
    return {n: pair for (n, _), pair in zip(named, zip(*grads))}


def max_entry_err(a, b):
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def gradient_check(torch, model, objectives, x, y):
    """Per parameter tensor, max|kernels - blockwise| / max|blockwise|
    of :func:`gradient_pairs`."""
    return [max_entry_err(a, b) for a, b in gradient_pairs(
        torch, model, objectives, x, y).values()]


def phase_train(torch, TransformerLM, kernels, objectives):
    """Full-width compile/fit: a warm-up fit, then TRAIN_STEPS fits of one
    step each (each ends synchronised: fit reads its losses back), with
    the launch counts read around them; then the gradient check."""
    import statistics
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                  metrics=["accuracy"])
    x, y = periodic_tokens(TRAIN_BATCH * (TRAIN_STEPS + 1),
                           cfg["vocab_size"], TRAIN_SEQ, seed=1)
    model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH], batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    log(f"train: model built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(1, TRAIN_STEPS + 1):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        t = time.perf_counter()
        hist = model.fit(x[rows], y[rows], batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses += hist["loss"]
    counts = kernels.launch_counts()
    by_design = kernels.launch_counts_by_design()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = statistics.median(step_s)
    stats = dict(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step,
                 peak_gib=peak_gib, losses=losses, launches=counts,
                 launches_by_design=by_design,
                 launches_per_step={n: c / TRAIN_STEPS
                                    for n, c in counts.items()})
    log("train:", json.dumps(stats))
    ok = (len(losses) == TRAIN_STEPS
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0])
    for name in KERNELS:
        if counts[name] < cfg["n_layers"] * TRAIN_STEPS:
            ok = False
            log(f"train: FAIL {name} launched {counts[name]} times in "
                f"{TRAIN_STEPS} steps, expected >= {cfg['n_layers']} a "
                "step")
    errs = gradient_check(torch, model, objectives, x[:2], y[:2])
    stats["grad_max_rel_err"] = max(errs)
    log(f"train: gradient check against blockwise over {len(errs)} "
        f"tensors, max rel err {max(errs):.3g} (tol {GRAD_TOL})")
    ok &= max(errs) <= GRAD_TOL
    return bool(ok), stats


def phase_small(torch, TransformerLM, from_jax_params, to_jax_params):
    """A small model on the card against the same weights on the CPU:
    predict log-probs within 1e-4, equal greedy streams, and the losses
    of 3 adam steps within 1e-4."""
    small = dict(vocab_size=59, seq_len=32, n_layers=2, d_model=32,
                 n_heads=2)
    gpu = TransformerLM(**small, device="cuda", seed=3).eval()
    cpu = TransformerLM(**small, device="cpu", seed=4).eval()
    from_jax_params(cpu, to_jax_params(gpu))
    rng = torch.Generator().manual_seed(5)
    x = torch.randint(0, 59, (3, 32), generator=rng).numpy()
    err = float(abs(gpu.predict(x, 3) - cpu.predict(x, 3)).max())
    prompt = x[:, :8]
    same = (gpu.generate(prompt, 6) == cpu.generate(prompt, 6)).all()
    lens = [8, 5, 3]
    same &= (gpu.generate(prompt, 6, prompt_lengths=lens)
             == cpu.generate(prompt, 6, prompt_lengths=lens)).all()
    log(f"small: predict max abs err {err:.3g} (tol 1e-4), greedy streams "
        f"equal: {bool(same)}")
    xt, yt = periodic_tokens(24, 59, 32, seed=6)
    fits = []
    for m in (gpu, cpu):
        m.compile({"name": "adam", "lr": 3e-3}, "class_nll")
        fits.append(m.fit(xt, yt, batch_size=8)["loss"])
    loss_err = max(abs(a - b) for a, b in zip(*fits))
    log(f"small: 3 training steps, losses {fits[0]} (card) {fits[1]} (CPU), "
        f"max abs diff {loss_err:.3g} (tol 1e-4)")
    return (err <= 1e-4 and bool(same) and len(fits[0]) == 3
            and loss_err <= 1e-4)


def smi_card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: no output"


def lenet_blobs(n, seed, classes=10):
    """tests/test_lenet_e2e.py's make_data: class-dependent blobs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    for i in range(n):
        x[i, 2 * y[i]:2 * y[i] + 3, 2 * y[i]:2 * y[i] + 3, 0] += 2.0
    return x, y.astype(np.int32)


def build_lenet(keras, device, seed=0):
    """tests/test_lenet_e2e.py's LeNet, unchanged but for the device."""
    L = keras.layers
    model = keras.Sequential(device=device, seed=seed)
    model.add(L.Convolution2D(6, 5, 5, activation="relu",
                              border_mode="same", input_shape=(28, 28, 1)))
    model.add(L.MaxPooling2D())
    model.add(L.Convolution2D(16, 5, 5, activation="relu"))
    model.add(L.MaxPooling2D())
    model.add(L.Flatten())
    model.add(L.Dense(120, activation="relu"))
    model.add(L.Dropout(0.1))
    model.add(L.Dense(84, activation="relu"))
    model.add(L.Dense(10, activation="softmax"))
    return model


def phase_lenet(torch, keras, kernels, tmp):
    """LeNet on the card: fit with validation (losses fall, accuracy above
    0.5), predict (rows sum to 1 within 1e-4, the CPU's answer on the
    same weights within 1e-4), predict_classes, evaluate (accuracy and
    top5accuracy), save_model/load_model and to_model (predictions within
    1e-6); then LENET_TIMED_STEPS synchronised one-step fits, timed."""
    import statistics
    import numpy as np
    x, y = lenet_blobs(LENET_N, seed=0)
    xv, yv = lenet_blobs(128, seed=1)
    model = build_lenet(keras, "cuda")
    model.compile(optimizer={"name": "adam", "lr": 1e-3},
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "top5accuracy"])
    kernels.reset_launch_counts()
    hist = model.fit(x, y, batch_size=LENET_BATCH, nb_epoch=LENET_EPOCHS,
                     validation_data=(xv, yv))
    counts = kernels.launch_counts()
    losses, val = hist["loss"], hist["val"]
    probs = model.predict(x[:100], batch_size=LENET_BATCH)
    row_err = float(abs(probs.sum(axis=1) - 1).max())
    classes = model.predict_classes(x[:100])
    results = model.evaluate(x, y, batch_size=LENET_BATCH)
    cpu = build_lenet(keras, "cpu", seed=1)
    cpu.set_weights(model.get_weights())
    cpu_err = float(abs(cpu.predict(x[:100], LENET_BATCH) - probs).max())
    model.save_model(os.path.join(tmp, "lenet"))
    loaded = keras.load_model(os.path.join(tmp, "lenet"), device="cuda")
    load_err = float(abs(loaded.predict(x[:100], LENET_BATCH)
                         - probs).max())
    model_err = float(abs(model.to_model().predict(x[:100], LENET_BATCH)
                          - probs).max())

    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(LENET_TIMED_STEPS):
        rows = slice((i % (LENET_N // LENET_BATCH)) * LENET_BATCH,
                     (i % (LENET_N // LENET_BATCH) + 1) * LENET_BATCH)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.fit(x[rows], y[rows], batch_size=LENET_BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    step = statistics.median(step_s)
    stats = dict(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 images_per_s=LENET_BATCH / step,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 card=smi_card(), losses_first_last=[losses[0], losses[-1]],
                 steps=len(losses), val=val, evaluate=results,
                 row_sum_err=row_err, cpu_err=cpu_err,
                 load_model_err=load_err, to_model_err=model_err,
                 launches=counts)
    log("lenet:", json.dumps(stats))
    ok = (len(losses) == LENET_EPOCHS * (LENET_N // LENET_BATCH)
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0]
          and len(val) == LENET_EPOCHS and val[-1]["accuracy"] > 0.5
          and probs.shape == (100, 10) and row_err <= 1e-4
          and classes.shape == (100,)
          and set(results) >= {"accuracy", "top5accuracy", "loss"}
          and cpu_err <= 1e-4 and load_err <= 1e-6 and model_err <= 1e-6
          and all(p.is_cuda for p in loaded.parameters()))
    return bool(ok), stats


def build_attention_model(keras, impl, seed=0):
    L = keras.layers
    x = L.Input((GRAPH["seq"],))
    h = L.Embedding(GRAPH["vocab"], GRAPH["d_model"])(x)
    h = L.PositionalEmbedding(GRAPH["seq"])(h)
    h = L.LayerNorm()(h)
    h = L.MultiHeadSelfAttention(GRAPH["n_heads"], causal=True,
                                 implementation=impl)(h)
    y = L.Dense(GRAPH["vocab"], activation="log_softmax")(h)
    return keras.Model(input=x, output=y, device="cuda", seed=seed)


def phase_graph(torch, keras, kernels):
    """The functional attention Model: GRAPH["steps"] synchronised
    one-step fits, each of which must launch the flash forward, dq and
    dk/dv kernels (the counts read around each); then predict under
    flash against predict under blockwise on the same weights, within
    1e-4."""
    import numpy as np
    model = build_attention_model(keras, "flash")
    attn = [l for l in model.to_graph().layers
            if type(l).__name__ == "MultiHeadSelfAttention"]
    model.compile({"name": "adam", "lr": 3e-4}, "class_nll")
    x, y = periodic_tokens(GRAPH["batch"] * (GRAPH["steps"] + 1),
                           GRAPH["vocab"], GRAPH["seq"], seed=2)
    b = GRAPH["batch"]
    model.fit(x[:b], y[:b], batch_size=b)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    per_step, losses, step_s = [], [], []
    for i in range(1, GRAPH["steps"] + 1):
        before = kernels.launch_counts()
        t = time.perf_counter()
        losses += model.fit(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b],
                            batch_size=b)["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
    counts = kernels.launch_counts()
    by_design = kernels.launch_counts_by_design()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    flash = model.predict(x[:b], batch_size=b)
    try:
        for layer in attn:
            layer.implementation = "blockwise"
        plain = model.predict(x[:b], batch_size=b)
    finally:
        for layer in attn:
            layer.implementation = "flash"
    err = float(np.abs(flash - plain).max())
    stats = dict(step_ms_all=[t * 1e3 for t in step_s], losses=losses,
                 launches=counts, launches_by_design=by_design,
                 launches_per_step=per_step,
                 peak_gib=peak_gib, predict_vs_blockwise_max_abs_err=err,
                 shape=list(flash.shape))
    log("graph:", json.dumps(stats))
    ok = (len(attn) == 1 and len(losses) == GRAPH["steps"]
          and all(math.isfinite(v) for v in losses)
          and all(step[n] >= 1 for step in per_step for n in KERNELS)
          and flash.shape == (b, GRAPH["seq"], GRAPH["vocab"])
          and bool(np.isfinite(flash).all()) and err <= 1e-4)
    return bool(ok), stats


def forward_flops(model, batch):
    """FLOPs (2 a multiply-add) of one forward of the convolutions and
    Dense layers of a graph model at ``batch``, from its layers' shapes:
    the work on the tensor cores.  BatchNorm, the pools and the
    activations are left out (a few percent of ResNet-50's)."""
    total = 0
    for v in model.to_graph().nodes:
        kind = type(v.layer).__name__
        if kind == "Convolution2D":
            _, ho, wo, co = v.shape
            kh, kw, ci, _ = v.layer.W.shape
            total += 2 * ho * wo * kh * kw * ci * co
        elif kind == "SeparableConvolution2D":
            _, ho, wo, co = v.shape
            kh, kw, _, mid = v.layer.depthwise.shape
            total += 2 * ho * wo * (kh * kw * mid + mid * co)
        elif kind == "Dense":
            ci, co = v.layer.W.shape
            total += 2 * ci * co
    return total * batch


def bn_layers(model):
    return [l for l in model.to_graph().layers
            if type(l).__name__ == "BatchNormalization"]


def rel_err(got, ref, base=None):
    """max |got - ref| over max |ref - base| across two JAX-keyed trees
    ({layer: {name: array}}) of the same keys."""
    import numpy as np
    num = max(float(np.abs(got[n][k] - ref[n][k]).max())
              for n in ref for k in ref[n])
    den = max(float(np.abs(ref[n][k] - (0 if base is None
                                        else base[n][k])).max())
              for n in ref for k in ref[n])
    return num / den if den > 0 else math.inf


def worst_tensors(got, ref, base, n=3):
    """The ``n`` tensors of the largest max |got - ref| over the largest
    max |ref - base| of the model, with those values."""
    import numpy as np
    den = max(float(np.abs(ref[l][k] - base[l][k]).max())
              for l in ref for k in ref[l])
    errs = sorted(((float(np.abs(got[l][k] - ref[l][k]).max()) / den,
                    f"{l}/{k}") for l in ref for k in ref[l]), reverse=True)
    return [[name, err] for err, name in errs[:n]]


def resnet_vs_cpu(torch, models, weights, state, x, y):
    """An f32 ResNet-50 on the card and one on the CPU, from the same
    weights and state: predict, then one sgd step on the same batch
    (TF32 is off).  Returns the predict error, the moving statistics'
    error and the weight change's error (each over the largest entry of
    the CPU's, or of its change), and the tensors whose change differs
    most."""
    from_jax, to_state = models.from_jax_params, models.to_jax_state
    runs = []
    for dev in ("cuda", "cpu"):
        m = models.ImageClassifier(
            "resnet-50", input_shape=(RESNET["size"],) * 2 + (3,),
            num_classes=RESNET["classes"], device=dev)
        from_jax(m, weights, state)
        probs = m.predict(x, batch_size=len(x))
        m.compile(RESNET_OPTIMIZER, "sparse_categorical_crossentropy")
        m.fit(x, y, batch_size=len(x), shuffle=False)
        moving = {n: {k: v for k, v in d.items() if k != "count"}
                  for n, d in to_state(m).items()}
        runs.append((probs, moving, m.get_weights()))
        del m
    (p, s, w), (p_ref, s_ref, w_ref) = runs
    return (rel_err({"p": {"p": p}}, {"p": {"p": p_ref}}),
            rel_err(s, s_ref), rel_err(w, w_ref, weights),
            worst_tensors(w, w_ref, weights))


def serve_predict(net, x, threads):
    """``to_serving()`` predict of ``x`` split row-wise over ``threads``
    threads; the rows back in order."""
    import threading
    import numpy as np
    im = net.to_serving(max_batch_size=len(x))
    parts = np.array_split(np.arange(len(x)), threads)
    out, errors = [None] * threads, []

    def client(i):
        try:
            out[i] = im.predict(x[parts[i]])
        except Exception as e:  # re-raised below
            errors.append(e)

    workers = [threading.Thread(target=client, args=(i,))
               for i in range(threads)]
    try:
        for t in workers:
            t.start()
        for t in workers:
            t.join(300)
        if errors:
            raise errors[0]
        return np.concatenate(out)
    finally:
        im.close()


def phase_resnet(torch, models, keras, kernels, tmp):
    """ResNet-50 on the JAX bench's plan (RESNET): a warm-up fit and
    RESNET["timed_steps"] synchronised one-step fits at bf16, timed;
    f32 master weights and momentum, every BatchNormalization's count
    equal to the steps and its statistics off their init; an f32 copy of
    the seeded init on the card against one on the CPU (predict, then
    one sgd step); f32 predict (rows sum to 1), save_model/load_model
    (predict and every moving statistic and count) and to_serving
    predict from several threads."""
    import statistics
    import numpy as np
    R = RESNET
    shape = (R["size"], R["size"], 3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(R["batch"],) + shape).astype(np.float32)
    y = rng.integers(0, R["classes"], R["batch"]).astype(np.int32)
    model = models.ImageClassifier("resnet-50", input_shape=shape,
                                   num_classes=R["classes"], seed=0)
    # the seeded init, for the check against the CPU: sgd at 0.1 drives
    # this plan's random-label softmax into the loss's clipping within a
    # few steps, where the gradients vanish
    weights, state = model.get_weights(), models.to_jax_state(model)
    model.compile(RESNET_OPTIMIZER, "sparse_categorical_crossentropy",
                  compute_dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    losses = model.fit(x, y, batch_size=R["batch"])["loss"]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(R["timed_steps"]):
        t = time.perf_counter()
        losses += model.fit(x, y, batch_size=R["batch"])["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = kernels.launch_counts()
    step = statistics.median(step_s)
    flops = 3 * forward_flops(model, R["batch"])
    bench_flops = 3 * 2 * BENCH_GMAC_PER_IMAGE * 1e9 * R["batch"]
    st = model.trainer.state
    bns = bn_layers(model)
    steps = 1 + R["timed_steps"]
    f32_master = all(p.dtype == torch.float32 for p in st.params) and all(
        t.dtype == torch.float32 for s in st.opt_state.states
        if s is not None for t in s)
    counts = {float(l.count) for l in bns}
    stats_moved = all(bool(l.moving_mean.abs().max() > 0)
                      and bool((l.moving_var - 1).abs().max() > 0)
                      for l in bns)

    cpu_pred, cpu_stats, cpu_change, cpu_worst = resnet_vs_cpu(
        torch, models, weights, state, x[:R["cpu_batch"]],
        y[:R["cpu_batch"]])

    probs = model.predict(x[:R["predict_rows"]], batch_size=R["batch"])
    row_err = float(np.abs(probs.sum(axis=1) - 1).max())
    state = models.to_jax_state(model)
    model.save_model(os.path.join(tmp, "resnet50"))
    loaded = keras.load_model(os.path.join(tmp, "resnet50"))
    load_err = float(np.abs(loaded.predict(
        x[:R["predict_rows"]], batch_size=R["batch"]) - probs).max())
    loaded_state = models.to_jax_state(loaded)
    state_restored = all(
        np.array_equal(loaded_state[n][k], state[n][k])
        for n in state for k in state[n])
    del loaded
    rows = R["serve_rows"]
    serve_err = float(np.abs(serve_predict(model, x[:rows],
                                           R["serve_threads"])
                             - probs[:rows]).max())
    stats = dict(
        step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
        images_per_s=R["batch"] / step, peak_gib=peak_gib,
        train_flops=flops, flop_share_bf16=flops / step / BF16_PEAK,
        bench_analytic_flops=bench_flops,
        bench_analytic_share_bf16=bench_flops / step / BF16_PEAK,
        batch=R["batch"], size=R["size"], losses=losses,
        bn_layers=len(bns), bn_counts=sorted(counts),
        f32_master_weights_and_momentum=f32_master,
        stats_off_init=stats_moved,
        cpu_predict_rel_err=cpu_pred, cpu_moving_stats_rel_err=cpu_stats,
        cpu_weight_change_rel_err=cpu_change,
        cpu_weight_change_worst=cpu_worst, row_sum_err=row_err,
        load_model_err=load_err, load_state_restored=state_restored,
        serve_err=serve_err, launches=launches, card=smi_card())
    log("resnet:", json.dumps(stats))
    ok = (len(losses) == steps and all(math.isfinite(v) for v in losses)
          and len(bns) == 53 and counts == {float(steps)} and stats_moved
          and f32_master
          and probs.shape == (R["predict_rows"], R["classes"])
          and cpu_pred <= RESNET_TOL["cpu_predict"]
          and cpu_stats <= RESNET_TOL["cpu_stats"]
          and cpu_change <= RESNET_TOL["cpu_change"]
          and row_err <= RESNET_TOL["row_sum"]
          and load_err <= RESNET_TOL["load"] and state_restored
          and serve_err <= RESNET_TOL["serve"])
    return bool(ok), stats


def phase_registry(torch, models, kernels):
    """The other eight architectures of the registry at their registry
    input size (REGISTRY), batch 16: one predict and two bf16 fit steps
    each ((16, 1000) softmax rows, the first step's loss finite), timed;
    then the space-to-depth ResNet-50 stem with
    space_to_depth_stem_kernel's weights against the standard stem (f32
    predict)."""
    import numpy as np
    from analytics_zoo_tpu_torch.models.image import classification as zoo
    b = REGISTRY["batch"]
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    archs, ok = {}, True
    for name in zoo._ARCHITECTURES:
        if name == "resnet-50":
            continue
        size = REGISTRY["sizes"].get(name, 224)
        x = rng.normal(size=(b, size, size, 3)).astype(np.float32)
        y = rng.integers(0, 1000, b).astype(np.int32)
        m = models.ImageClassifier(name, input_shape=(size, size, 3),
                                   num_classes=1000)
        m.compile(RESNET_OPTIMIZER, "sparse_categorical_crossentropy",
                  compute_dtype=torch.bfloat16)
        # predict first: one sgd step at 0.1 from these random inits
        # moves the weights by up to ~1e3 (their gradients' norms reach
        # 1e4 on noise images), which eval mode's moving statistics,
        # taken before the step, do not follow
        torch.cuda.synchronize()
        t = time.perf_counter()
        probs = m.predict(x, batch_size=b)
        t_predict = time.perf_counter() - t
        fits, losses = [], []
        for _ in range(2):  # the first call includes cuDNN's choices
            t = time.perf_counter()
            losses += m.fit(x, y, batch_size=b)["loss"]
            torch.cuda.synchronize()
            fits.append(time.perf_counter() - t)
        # the second step starts from the first's ~1e3 moves: its loss
        # is reported, the first's checked
        good = (len(losses) == 2 and math.isfinite(losses[0])
                and probs.shape == (b, 1000)
                and bool(np.isfinite(probs).all())
                and float(np.abs(probs.sum(axis=1) - 1).max()) <= 1e-4)
        archs[name] = dict(size=size, losses=losses,
                           first_fit_step_ms=fits[0] * 1e3,
                           fit_step_ms=fits[1] * 1e3,
                           predict_ms=t_predict * 1e3,
                           params=sum(p.numel() for p in m.parameters()),
                           bn_layers=len(bn_layers(m)), ok=good)
        ok = ok and good
        del m
    shape = (224, 224, 3)
    std = zoo.resnet50(input_shape=shape, num_classes=1000, seed=0)
    s2d = zoo.resnet50(input_shape=shape, num_classes=1000,
                       space_to_depth=True, seed=1)
    w = std.get_weights()
    w["conv1"] = {"W": zoo.space_to_depth_stem_kernel(w["conv1"]["W"])}
    s2d.set_weights(w)
    x = rng.normal(size=(REGISTRY["s2d_rows"],) + shape).astype(np.float32)
    ref = std.predict(x, batch_size=len(x))
    s2d_err = float(np.abs(s2d.predict(x, batch_size=len(x)) - ref).max()
                    / np.abs(ref).max())
    stats = dict(archs=archs, batch=b, s2d_stem_rel_err=s2d_err,
                 launches=kernels.launch_counts(), card=smi_card())
    log("registry:", json.dumps(stats))
    return bool(ok and s2d_err <= REGISTRY["s2d_tol"]), stats


def device_launches(torch, fn):
    """Kernels the card runs for ``fn()`` (torch.profiler's CUDA events,
    copies and fills left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def timed(torch, fn, reps):
    """``fn()``'s result and its synchronised wall seconds, ``reps``
    times, after one warm-up call."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return out, times


def phase_detect(torch, models, kernels):
    """SSD-VGG16-300 (DETECT) on the card: f32 ``predict`` of 8 images
    and ``decode_output`` on the card, timed, the decode's kernel
    launches counted, the decode of ``predict``'s numpy with the model's
    priors (on the card, equal), ``ScaleDetection`` to 480x640; an f32
    copy on the CPU with the same weights (raw head within 1e-4 of its largest
    entry, the same detections); padding rows all -1, scaled boxes
    inside the image; then ssd-mobilenet-300 and ssd-vgg16-512 predict
    and decode at batch 2."""
    import statistics
    import numpy as np
    D = DETECT
    post = dict(conf_threshold=D["conf_threshold"],
                nms_threshold=D["nms_threshold"], top_k=D["top_k"],
                max_detections=D["max_detections"])
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (D["batch"], D["size"], D["size"], 3)).astype(
        np.float32)
    kernels.reset_launch_counts()
    det = models.ObjectDetector(
        D["name"], num_classes=D["classes"],
        conf_threshold=D["conf_threshold"],
        nms_threshold=D["nms_threshold"],
        max_detections=D["max_detections"], seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raw, predict_s = timed(torch, lambda: det.predict(
        x, batch_size=D["batch"]), D["reps"])
    raw_dev = torch.from_numpy(raw).cuda()

    def decode():
        return models.decode_output(raw_dev, det.priors, D["classes"],
                                    **post)

    dets, decode_s = timed(torch, decode, D["reps"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = device_launches(torch, decode)
    # predict's numpy with the model's priors decodes on the card
    natural = models.decode_output(raw, det.priors, D["classes"], **post)
    follows = (natural.device.type == "cuda"
               and bool(torch.equal(natural, dets)))
    dets = dets.cpu().numpy()
    h, w = D["scaled"]
    scaled = models.ScaleDetection()(dets, [h] * len(dets),
                                     [w] * len(dets))
    real = scaled[..., 0] >= 0
    pad_ok = bool((dets[~real] == -1).all())
    inside = bool((scaled[real][:, [2, 4]] >= 0).all()
                  and (scaled[real][:, [2, 4]] <= w).all()
                  and (scaled[real][:, [3, 5]] >= 0).all()
                  and (scaled[real][:, [3, 5]] <= h).all())

    cpu = models.ObjectDetector(D["name"], num_classes=D["classes"],
                                device="cpu")
    models.from_jax_params(cpu, det.get_weights())
    rows = D["cpu_rows"]
    cpu_raw = cpu.predict(x[:rows], batch_size=rows)
    cpu_err = float(np.abs(raw[:rows] - cpu_raw).max()
                    / np.abs(cpu_raw).max())
    cpu_dets = models.decode_output(torch.from_numpy(cpu_raw), cpu.priors,
                                    D["classes"], **post).numpy()
    same = (cpu_dets.shape == dets[:rows].shape
            and bool(np.array_equal(dets[:rows, :, 0], cpu_dets[..., 0]))
            and float(np.abs(dets[:rows, :, 1:] - cpu_dets[..., 1:]).max())
            <= DETECT_TOL)
    del cpu

    predict = statistics.median(predict_s)
    flops = forward_flops(det, D["batch"])
    others, others_ok = {}, True
    for name, (size, n_priors) in D["others"].items():
        m = models.ObjectDetector(name, num_classes=D["classes"], seed=0)
        xb = rng.uniform(0, 255, (D["other_batch"], size, size, 3)).astype(
            np.float32)
        out, p_s = timed(torch, lambda: m.predict(
            xb, batch_size=D["other_batch"]), 2)
        out_dev = torch.from_numpy(out).cuda()
        d, d_s = timed(torch, lambda: models.decode_output(
            out_dev, m.priors, D["classes"], **post), 2)
        d = d.cpu().numpy()
        good = (tuple(m.priors.shape) == (n_priors, 4)
                and out.shape == (D["other_batch"], n_priors,
                                  4 + D["classes"])
                and d.shape == (D["other_batch"], D["max_detections"], 6)
                and bool(np.isfinite(out).all() and np.isfinite(d).all()))
        others[name] = dict(priors=n_priors, predict_ms=min(p_s) * 1e3,
                            decode_ms=min(d_s) * 1e3,
                            detections=int((d[..., 0] >= 0).sum()), ok=good)
        others_ok = others_ok and good
        del m
    stats = dict(
        model=D["name"], batch=D["batch"], priors=int(det.priors.shape[0]),
        predict_ms=predict * 1e3,
        predict_ms_all=[t * 1e3 for t in predict_s],
        decode_ms=statistics.median(decode_s) * 1e3,
        decode_ms_all=[t * 1e3 for t in decode_s],
        images_per_s=D["batch"] / predict, decode_launches=launches,
        peak_gib=peak_gib, forward_gflop_per_image=flops / D["batch"] / 1e9,
        flop_share_f32=flops / predict / F32_PEAK,
        f32_peak="67 TFLOP/s (H100 SXM f32 outside the tensor cores, "
                 "TF32 off)",
        detections=int(real.sum()), cpu_rows=rows,
        cpu_raw_rel_err=cpu_err, cpu_same_detections=same,
        decode_follows_model=follows,
        padding_all_minus_one=pad_ok, scaled_inside_image=inside,
        others=others, launches=kernels.launch_counts(), card=smi_card())
    log("detect:", json.dumps(stats))
    ok = (raw.shape == (D["batch"], D["priors"], 4 + D["classes"])
          and dets.shape == (D["batch"], D["max_detections"], 6)
          and bool(np.isfinite(raw).all()) and cpu_err <= DETECT_TOL
          and same and follows and pad_ok and inside and others_ok)
    return bool(ok), stats


def ncf_data(seed=0):
    """_bench_ncf's draw: 1-based (user, item) ids and 0-based labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, NCF["users"] + 1, NCF["batch"]),
                  rng.integers(1, NCF["items"] + 1, NCF["batch"])],
                 axis=1).astype(np.int32)
    return x, rng.integers(0, NCF["classes"], NCF["batch"]).astype(np.int32)


def build_ncf(models, device, seed=0):
    return models.NeuralCF(
        user_count=NCF["users"], item_count=NCF["items"],
        num_classes=NCF["classes"], user_embed=NCF["embed"],
        item_embed=NCF["embed"], hidden_layers=NCF["hidden"],
        include_mf=True, mf_embed=NCF["mf"], device=device, seed=seed)


def ncf_vs_cpu(torch, models, weights, x, y):
    """NCF_OPTIMIZER steps from ``weights`` on the card and on the CPU:
    the largest parameter difference over the largest change the CPU's
    steps made, and the two loss lists."""
    import numpy as np
    runs = []
    for dev in ("cuda", "cpu"):
        m = build_ncf(models, dev)
        models.from_jax_params(m, weights)
        m.compile(NCF_OPTIMIZER, "class_nll")
        losses = m.fit(np.concatenate([x] * NCF["cpu_steps"]),
                       np.concatenate([y] * NCF["cpu_steps"]),
                       batch_size=NCF["batch"], shuffle=False)["loss"]
        runs.append((m.get_weights(), losses))
    (w, losses), (w_ref, ref_losses) = runs
    return rel_err(w, w_ref, weights), losses, ref_losses


def custom_models_step(torch, models, keras):
    """One fit step on the card of a Dense under a CustomLoss of each
    form, and of a graph with a Parameter bias (wide_out + bias); the
    losses and whether the bias moved."""
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = x[:, :2].sum(axis=1, keepdims=True).astype(np.float32)
    yt, yp = A.Input((1,), name="cl_true"), A.Input((1,), name="cl_pred")
    losses = {}
    for form, loss in (
            ("lambda", A.CustomLoss(lambda t, p: A.mean(A.abs(p - t),
                                                        axis=1))),
            ("from_variables", A.CustomLoss.from_variables(
                yt, yp, A.mean(A.square(yp - yt), axis=1)))):
        m = keras.Sequential(seed=0)
        m.add(keras.layers.Dense(1, input_shape=(8,)))
        m.compile({"name": "sgd", "lr": 0.1}, loss)
        losses[form] = m.fit(x, y, batch_size=64)["loss"]
    inp = A.Input((8,), name="p_in")
    bias = A.Parameter((1,), init_method="zero", name="p_bias")
    m = keras.Model(input=inp, output=keras.layers.Dense(1)(inp) + bias)
    m.compile({"name": "sgd", "lr": 0.1}, "mse")
    losses["parameter"] = m.fit(x, y, batch_size=64)["loss"]
    moved = bool(np.abs(m.get_weights()["p_bias"]["weight"]).max() > 0)
    return losses, moved


def phase_recommend(torch, models, keras, kernels):
    """NeuralCF on bench.py's plan (NCF): a warm-up fit and
    NCF["timed_steps"] synchronised one-step fits, timed, then one fit of
    the same number of epochs over the batch; losses finite and falling;
    an f32 copy on the CPU after 3 steps within NCF_TOL of the largest
    change; predict_user_item_pair probabilities in [0, 1] and recommend_for_user
    sorted; WideAndDeep wide_n_deep (test_wide_and_deep_variants'
    columns) through one fit and one predict (exp rows sum to 1 within
    1e-5); a CustomLoss model of each form and a Parameter model through
    a fit step."""
    import statistics
    import numpy as np
    x, y = ncf_data()
    kernels.reset_launch_counts()
    model = build_ncf(models, "cuda")
    weights = model.get_weights()
    model.compile(NCF_OPTIMIZER, "class_nll")
    losses = model.fit(x, y, batch_size=NCF["batch"])["loss"]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(NCF["timed_steps"]):
        t = time.perf_counter()
        losses += model.fit(x, y, batch_size=NCF["batch"])["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    losses += model.fit(x, y, batch_size=NCF["batch"],
                        nb_epoch=NCF["timed_steps"])["loss"]
    torch.cuda.synchronize()
    epochs_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = statistics.median(step_s)

    cpu_err, card_losses, cpu_losses = ncf_vs_cpu(torch, models, weights,
                                                  x, y)
    pairs = [models.UserItemFeature(int(u), int(i), row)
             for (u, i), row in zip(x[:NCF["pairs"]], x[:NCF["pairs"]])]
    preds = model.predict_user_item_pair(pairs)
    probs_ok = (len(preds) == NCF["pairs"]
                and all(0.0 <= p.probability <= 1.0 for p in preds)
                and all(1 <= p.prediction <= NCF["classes"] for p in preds))
    recs = model.recommend_for_user(pairs, max_items=NCF["top"])
    by_user = {}
    for r in recs:
        by_user.setdefault(r.user_id, []).append(r.probability)
    sorted_ok = bool(recs) and all(
        len(v) <= NCF["top"] and v == sorted(v, reverse=True)
        for v in by_user.values())

    ci = models.ColumnFeatureInfo(
        wide_base_dims=(5, 7), wide_cross_dims=(9,), indicator_dims=(4,),
        embed_in_dims=(10, 6), embed_out_dims=(4, 3),
        continuous_cols=("age",))
    rng = np.random.default_rng(0)
    n = 128
    wide = np.stack([rng.integers(1, 6, n), 5 + rng.integers(1, 8, n),
                     12 + rng.integers(1, 10, n)], axis=1).astype(np.int32)
    deep = np.concatenate([rng.integers(0, 2, (n, 4)),
                           np.stack([rng.integers(1, 11, n),
                                     rng.integers(1, 7, n)], axis=1),
                           rng.normal(size=(n, 1))], axis=1).astype(
        np.float32)
    wy = rng.integers(0, 2, n).astype(np.int32)
    wnd = models.WideAndDeep(model_type="wide_n_deep", num_classes=2,
                             column_info=ci, hidden_layers=(16, 8), seed=0)
    wnd.compile({"name": "adam", "lr": 1e-3}, "class_nll")
    wnd_loss = wnd.fit((wide, deep), wy, batch_size=n)["loss"]
    wnd_out = wnd.predict((wide, deep), batch_size=n)
    wnd_err = float(np.abs(np.exp(wnd_out).sum(axis=1) - 1).max())
    custom_losses, bias_moved = custom_models_step(torch, models, keras)

    stats = dict(
        step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
        steps_per_s=1.0 / step, samples_per_s=NCF["batch"] / step,
        fit_ms_per_step=epochs_s * 1e3 / NCF["timed_steps"],
        peak_gib=peak_gib, batch=NCF["batch"], users=NCF["users"],
        items=NCF["items"], losses=losses,
        cpu_param_rel_err=cpu_err, cpu_losses=cpu_losses,
        card_losses=card_losses, probs_in_unit=probs_ok,
        recommend_sorted=sorted_ok, wnd_loss=wnd_loss,
        wnd_row_sum_err=wnd_err, custom_losses=custom_losses,
        parameter_moved=bias_moved, launches=kernels.launch_counts(),
        card=smi_card())
    log("recommend:", json.dumps(stats))
    finite = all(math.isfinite(v) for v in losses + wnd_loss + sum(
        custom_losses.values(), []))
    ok = (finite and losses[-1] < losses[0]
          and len(losses) == 1 + 2 * NCF["timed_steps"]
          and cpu_err <= NCF_TOL and probs_ok and sorted_ok
          and wnd_out.shape == (n, 2) and wnd_err <= WND_TOL and bias_moved)
    return bool(ok), stats


def glove_file(directory, seed=0):
    """A GloVe-format file of TEXTCLASS["words"] words (w1, w2, ...) with
    TEXTCLASS["token_length"]-d vectors drawn from N(0, 0.5) at
    ``seed``, written into ``directory``; returns its path."""
    import numpy as np
    T = TEXTCLASS
    vecs = np.random.default_rng(seed).normal(
        0, 0.5, (T["words"], T["token_length"]))
    path = os.path.join(directory, "glove.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i, v in enumerate(vecs):
            f.write(f"w{i + 1} " + " ".join(f"{a:.5f}" for a in v) + "\n")
    return path


def textclass_data(seed=0):
    """Token ids (batch, sequence_length) in [0, words] (0 pads) and
    labels, from ``seed``."""
    import numpy as np
    T = TEXTCLASS
    rng = np.random.default_rng(seed)
    x = rng.integers(0, T["words"] + 1, (T["batch"], T["sequence_length"]))
    return x.astype(np.int32), rng.integers(0, T["classes"],
                                            T["batch"]).astype(np.int32)


def build_textclass(models, encoder, path, device, seed=0):
    T = TEXTCLASS
    return models.TextClassifier(
        class_num=T["classes"], token_length=T["token_length"],
        sequence_length=T["sequence_length"], encoder=encoder,
        encoder_output_dim=T["encoder_output_dim"], embedding_file=path,
        device=device, seed=seed)


def build_sentiment(keras, device, seed=0):
    """The sentiment app's --data model: Embedding(20000, 64),
    Bidirectional(LSTM(32)), Dense(2, softmax), built in a name scope so
    that every build names its layers alike."""
    from analytics_zoo_tpu_torch.core.module import name_scope
    L, S = keras.layers, SENTIMENT
    with name_scope("sentiment"):
        model = keras.Sequential(name="sentiment_bilstm", device=device,
                                 seed=seed)
        model.add(L.Embedding(S["vocab"], S["embed"],
                              input_shape=(S["seq"],)))
        model.add(L.Bidirectional(L.LSTM(S["units"])))
        model.add(L.Dense(2, activation="softmax"))
    return model


def two_level(tree):
    """{layer: {name: array}} of a weight tree that may nest deeper
    (Bidirectional's forward/backward), deeper keys joined by '/'."""
    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v
    return {layer: dict(leaves(sub)) for layer, sub in tree.items()}


def one_step_fits(torch, model, x, y, steps):
    """A warm-up fit, then ``steps`` synchronised one-step fits on (x,
    y): the losses, each step's seconds, the peak GiB over them, and the
    kernels the card runs for one more step."""
    losses = model.fit(x, y, batch_size=len(x))["loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        losses += model.fit(x, y, batch_size=len(x))["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = device_launches(torch, lambda: model.fit(
        x, y, batch_size=len(x)))
    return losses, step_s, peak, launches


def text_vs_cpu(torch, models, build, weights, state, x, y, optimizer):
    """The card and an f32 CPU copy from the same weights (and
    WordEmbedding table), dropout off on both (their random streams
    differ): predict on ``x`` (the largest difference over the CPU's
    largest entry), then TEXTCLASS["check_steps"] epochs of one step on
    (x, y): the losses of both, and the largest parameter difference
    over the largest change the CPU's steps made.  A GlobalMaxPooling1D
    sends each window's gradient to its argmax, and where two positions
    tie within rounding the devices can pick differently, moving a whole
    window's term; so the CPU copy's pools take the card's picks (the
    picks it would have made otherwise are counted)."""
    import numpy as np
    runs, card_picks, differing = [], [], []
    for dev in ("cuda", "cpu"):
        m = build(dev)
        models.from_jax_params(m, weights, state)
        layers = m.to_graph().layers
        for layer in layers:
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0
        pools = [l for l in layers if type(l).__name__ == "GlobalMaxPooling1D"]
        if dev == "cuda":
            for pool in pools:
                pool.register_forward_hook(
                    lambda mod, args, out: card_picks.append(
                        args[0].argmax(dim=1).cpu()))
        else:
            picks = iter(card_picks)

            def take_card_pick(x):
                idx = next(picks)
                differing.append(int((x.argmax(dim=1) != idx).sum()))
                return x.gather(1, idx[:, None, :]).squeeze(1)

            for pool in pools:
                pool.forward = take_card_pick
        pred = m.predict(x, batch_size=len(x))
        m.compile(optimizer, "sparse_categorical_crossentropy")
        losses = m.fit(x, y, batch_size=len(x),
                       nb_epoch=TEXTCLASS["check_steps"],
                       shuffle=False)["loss"]
        runs.append((pred, losses, two_level(m.get_weights())))
        del m
    (p, losses, w), (p_ref, ref_losses, w_ref) = runs
    base = two_level(weights)
    return dict(
        cpu_predict_rel_err=float(np.abs(p - p_ref).max()
                                  / np.abs(p_ref).max()),
        cpu_param_rel_err=rel_err(w, w_ref, base),
        cpu_param_worst=worst_tensors(w, w_ref, base),
        cpu_argmax_picks_differing=sum(differing),
        card_check_losses=losses, cpu_check_losses=ref_losses)


def phase_textclass(torch, models, keras, kernels):
    """TextClassifier (TEXTCLASS) for each encoder: a warm-up fit and
    TEXTCLASS["timed_steps"] synchronised one-step fits on one batch,
    timed (ms a step, samples/s, kernels a step, peak GiB; losses finite
    and falling), then the f32 CPU check of :func:`text_vs_cpu`; then
    the sentiment model (SENTIMENT) the same way."""
    import statistics
    import tempfile
    import numpy as np
    T, S = TEXTCLASS, SENTIMENT
    kernels.reset_launch_counts()
    x, y = textclass_data()
    stats, ok = {}, True
    with tempfile.TemporaryDirectory() as d:
        path = glove_file(d)
        runs = [(enc, (lambda dev, enc=enc: build_textclass(
            models, enc, path, dev)), x, y, TEXTCLASS_OPTIMIZER)
            for enc in T["encoders"]]
        rng = np.random.default_rng(1)
        xs = rng.integers(0, S["vocab"], (S["batch"], S["seq"])).astype(
            np.int32)
        ys = rng.integers(0, 2, S["batch"]).astype(np.int32)
        runs.append(("sentiment", lambda dev: build_sentiment(keras, dev),
                     xs, ys, "adam"))
        for name, build, bx, by, optimizer in runs:
            model = build("cuda")
            weights = model.get_weights()
            state = models.to_jax_state(model)
            model.compile(optimizer, "sparse_categorical_crossentropy")
            losses, step_s, peak, launches = one_step_fits(
                torch, model, bx, by, T["timed_steps"])
            del model
            torch.cuda.empty_cache()
            check = text_vs_cpu(torch, models, build, weights, state, bx,
                                by, optimizer)
            step = statistics.median(step_s)
            stats[name] = dict(
                step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                samples_per_s=len(bx) / step, launches_per_step=launches,
                peak_gib=peak, batch=len(bx), losses=losses, **check)
            card_l = check["card_check_losses"]
            finite = all(math.isfinite(v) for v in losses + card_l
                         + check["cpu_check_losses"])
            good = (finite and losses[-1] < losses[0]
                    and card_l[-1] < card_l[0]
                    and check["cpu_predict_rel_err"] <= TEXT_TOL["predict"]
                    and check["cpu_param_rel_err"] <= TEXT_TOL["change"])
            if not good:
                log(f"textclass: FAIL {name}: {json.dumps(stats[name])}")
            ok &= good
    stats["summary"] = {k: {f: v[f] for f in ("step_ms", "samples_per_s",
                                              "launches_per_step",
                                              "peak_gib")}
                        for k, v in stats.items()}
    stats.update(launches=kernels.launch_counts(), card=smi_card(),
                 sequence_length=T["sequence_length"])
    log("textclass:", json.dumps(stats))
    return bool(ok), stats


def moe_layers(model):
    return [getattr(model, f"moe_{i}")
            for i in range(model.hyper["n_layers"]) if model.is_moe_block(i)]


def record_routing(torch, model, routes):
    """Forward hooks on ``model``'s SwitchMoE layers appending each call's
    routing (expert ids, kept) to ``routes``; returns the handles."""
    from analytics_zoo_tpu_torch.parallel import expert

    def hook(layer, args, out):
        with torch.no_grad():
            flat = args[0].reshape(-1, args[0].shape[-1])
            r = expert._route(flat, layer.gate, layer.n_experts,
                              expert.expert_capacity(
                                  flat.shape[0], layer.n_experts,
                                  layer.capacity_factor))
            routes.append((r.expert, r.keep))

    return [m.register_forward_hook(hook) for m in moe_layers(model)]


class ExpertMasks:
    """Within ``record()``, each call of ``expert._apply_experts`` keeps
    the relu mask of its hidden pre-activations; within ``replay()``,
    each call applies the next kept mask instead of the sign of its own
    pre-activations (the same function and gradient wherever the two
    agree), and counts the entries where they differ."""

    def __init__(self, torch, expert):
        self.torch, self.expert = torch, expert
        self.masks, self.differing = [], 0

    def _swap(self, apply):
        import contextlib
        orig = self.expert._apply_experts

        @contextlib.contextmanager
        def swapped():
            self.expert._apply_experts = apply
            try:
                yield self
            finally:
                self.expert._apply_experts = orig
        return swapped()

    def _pre(self, blocks, w1, b1):
        return self.torch.bmm(blocks, w1) + b1[:, None, :]

    def record(self):
        def apply(blocks, w1, b1, w2, b2):
            pre = self._pre(blocks, w1, b1)
            self.masks.append(pre.detach() > 0)
            return self.torch.bmm(self.torch.relu(pre), w2) + b2[:, None, :]
        return self._swap(apply)

    def replay(self):
        masks = iter(self.masks)

        def apply(blocks, w1, b1, w2, b2):
            pre = self._pre(blocks, w1, b1)
            mask = next(masks)
            self.differing += int(((pre.detach() > 0) != mask).sum())
            return self.torch.bmm(pre * mask, w2) + b2[:, None, :]
        return self._swap(apply)


def moe_gradient_check(torch, model, objectives, x, y):
    """The kernels' gradients of the MoE model against blockwise
    attention's, per tensor by the largest entry, with two references
    held to the kernels' run's discrete decisions: blockwise at f32 (the
    train phase's comparison) and blockwise at f64 (the exact gradient
    to f32's eyes).  Where an expert's hidden pre-activation lies within
    rounding of 0 the forwards can fall on either side of the relu's
    kink, and that token and unit's term leaves or joins the gradient
    (~1e-2 of ``w1``'s largest entry from a 1e-6 change of the input);
    so both references take the kernels' run's relu masks (the entries
    the f32 reference's own would have flipped are counted, and its
    error without the masks reported).  No routing decision may differ;
    every tensor's kernels' gradient lies within GRAD_TOL of the f64
    reference, or within twice the f32 reference's own distance from
    it (a gradient that is a small difference of large terms, such as
    ``Wk``'s, carries f32 rounding of that size whatever computes it)."""
    from analytics_zoo_tpu_torch.parallel import expert
    routes = []
    handles = record_routing(torch, model, routes)
    masks = ExpertMasks(torch, expert)
    try:
        with masks.record():
            flash = gradient_pairs(torch, model, objectives, x, y,
                                   impls=("flash",))
        free = gradient_pairs(torch, model, objectives, x, y,
                              impls=("blockwise",))
        with masks.replay():
            held = gradient_pairs(torch, model, objectives, x, y,
                                  impls=("blockwise",))
        flips = masks.differing
        model.double()
        try:
            with masks.replay():
                exact = gradient_pairs(torch, model, objectives, x, y,
                                       impls=("blockwise",))
        finally:
            model.float()
    finally:
        for h in handles:
            h.remove()
    n = len(moe_layers(model))
    routing_flips = sum(int((a[0] != b[0]).sum())
                        for a, b in zip(routes[:n], routes[n:2 * n]))

    def errs(got, ref):
        return {k: max_entry_err(got[k][0].double(), ref[k][0])
                for k in flash}

    def worst(e):
        return sorted(e.items(), key=lambda kv: -kv[1])[:3]

    vs_f32, vs_f64 = errs(flash, held), errs(flash, exact)
    f32_vs_f64 = errs(held, exact)
    unheld = errs(flash, free)
    bad = [k for k in flash
           if vs_f64[k] > max(GRAD_TOL, 2 * f32_vs_f64[k])]
    stats = dict(
        grad_max_rel_err=max(vs_f32.values()), grad_worst=worst(vs_f32),
        grad_max_rel_err_vs_f64=max(vs_f64.values()),
        grad_worst_vs_f64=worst(vs_f64),
        grad_f32_reference_vs_f64=worst(f32_vs_f64),
        grad_outside_bound=bad, routing_flips=routing_flips,
        relu_kink_flips=flips,
        grad_max_rel_err_unheld=max(unheld.values()),
        grad_worst_unheld=worst(unheld), tensors=len(flash))
    return routing_flips == 0 and not bad, stats


def drop_free(model):
    """Set every MoE layer's capacity factor to its expert count (capacity
    = the token count: a full forward drops nothing, as decoding does);
    returns the factors to restore."""
    layers = moe_layers(model)
    old = [m.capacity_factor for m in layers]
    for m in layers:
        m.capacity_factor = float(m.n_experts)
    return old


def restore_capacity(model, factors):
    for m, f in zip(moe_layers(model), factors):
        m.capacity_factor = f


def moe_aux_check(torch, model, objectives, x, y):
    """The trainer's loss on one batch at aux weight MOE_AUX minus the
    loss at 0 (sgd at rate 0 leaves the weights where they are), against
    the layers' summed aux_loss state."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import optimizers
    from analytics_zoo_tpu_torch.train.trainer import (TrainState,
                                                       build_train_step)
    opt = optimizers.get({"name": "sgd", "lr": 0.0})
    params = list(model.parameters())
    ids = torch.as_tensor(x, device="cuda")
    labels = torch.as_tensor(y, device="cuda")
    losses, auxes = {}, {}
    try:
        for w in (MOE_AUX, 0.0):
            for m in moe_layers(model):
                m.aux_weight = w
            step = build_train_step(model, objectives.class_nll, opt)
            state = TrainState(params, {}, opt.init(params))
            losses[w] = float(step(state, ids, labels))
            auxes[w] = sum(float(m.aux_loss) for m in moe_layers(model))
    finally:
        for m in moe_layers(model):
            m.aux_weight = MOE_AUX
    diff = losses[MOE_AUX] - losses[0.0]
    return dict(loss=losses[MOE_AUX], loss_no_aux=losses[0.0],
                difference=diff, summed_aux=auxes[MOE_AUX],
                summed_aux_at_0=auxes[0.0],
                abs_err=abs(diff - auxes[MOE_AUX]))


def moe_dispatch_check(torch):
    """The index dispatch (switch_moe) against the dense one-hot
    (switch_moe_plain) on the card at MOE_DISPATCH, seeded weights at
    the train width: the largest difference over the largest entry, the
    aux losses, and each one's ms."""
    from analytics_zoo_tpu_torch.parallel import expert
    t, d = MOE_DISPATCH
    g = torch.Generator("cuda").manual_seed(0)
    p = expert.init_moe_params(g, d, FULL["d_ff"], MOE["n_experts"])
    x = torch.randn((t, d), generator=g, device="cuda")
    with torch.no_grad():
        out, aux = expert.switch_moe(x, p, MOE["capacity_factor"])
        ref, aux_ref = expert.switch_moe_plain(x, p, MOE["capacity_factor"])
        err = float((out - ref).abs().max() / ref.abs().max())
        ms = cuda_ms(lambda: expert.switch_moe(x, p, MOE["capacity_factor"]),
                     20)
        plain_ms = cuda_ms(lambda: expert.switch_moe_plain(
            x, p, MOE["capacity_factor"]), 20)
    return dict(tokens=t, d_model=d, rel_err=err, aux=float(aux),
                aux_plain=float(aux_ref), ms=ms, plain_ms=plain_ms)


def graph_vs_eager_step(torch, engine):
    """One replay of the engine's captured single step against the same
    step run eagerly from the same slot state (the engine idle): whether
    the selected tokens and positions are equal, and the largest K/V
    cache difference over the largest cache entry."""
    state = [engine._tok, engine._pos, engine._stepc]
    caches = [c for kv in engine._caches for c in kv]
    with engine._on_device():
        saved = [t.clone() for t in state + caches]
        engine._step_plan.graph.replay()
        graph = [t.clone() for t in state + caches]
        for t, v in zip(state + caches, saved):
            t.copy_(v)
        engine._step_body()
        eager = [t.clone() for t in state + caches]
        for t, v in zip(state + caches, saved):
            t.copy_(v)
        torch.cuda.synchronize()
    n = len(state)
    same = all(bool(torch.equal(a, b)) for a, b in zip(graph[:n], eager[:n]))
    scale = max(float(c.abs().max()) for c in eager[n:]) or 1.0
    cache_err = max(float((a - b).abs().max())
                    for a, b in zip(graph[n:], eager[n:])) / scale
    return same, cache_err


def moe_serve(torch, model, kernels, inference):
    """``InferenceModel(decode_capacity=8)`` serving MOE_SERVE_REQUESTS
    mixed requests of the serve phase's shape from its threads: every
    greedy token against a drop-free forward's argmax, the flash forward
    once a layer an admission, no capture after warm-up; the graph step
    against the eager step; the same requests through a step_fuse=1
    engine, equal streams."""
    import numpy as np
    cfg = model.hyper
    handle = inference.InferenceModel(
        decode_capacity=SERVE["capacity"], decode_max_len=SERVE["max_len"],
        decode_prompt_buckets=SERVE["buckets"])
    stats, checks = {}, {}
    try:
        t = time.perf_counter()
        handle.load_keras_net(model)
        stats["warmup_s"] = time.perf_counter() - t
        engine = handle.decode_engine
        before = engine.stats()
        prompts, news = mixed_requests(cfg, np.random.default_rng(2),
                                       MOE_SERVE_REQUESTS)
        kernels.reset_launch_counts()
        outs, wall, ttft, itl, tpot = serve_stream(handle.generate_stream,
                                                   prompts, news)
        launches = kernels.launch_counts()
        after = engine.stats()
        admitted = after["admitted"] - before["admitted"]
        stats.update(stream_metrics(outs, wall, ttft, itl, tpot))
        same, cache_err = graph_vs_eager_step(torch, engine)
        stats.update(step_times(torch, engine))
        unfused = inference.DecodeEngine(
            model, capacity=SERVE["capacity"], max_len=SERVE["max_len"],
            prompt_buckets=SERVE["buckets"], step_fuse=1)
        try:
            unfused.warmup()
            unfused_outs = unfused.generate(prompts, news, timeout=300)
        finally:
            unfused.close()
    finally:
        handle.close()
    factors = drop_free(model)
    try:
        checked, ties, mismatched = greedy_oracle(torch, model, prompts,
                                                  outs)
        res = compare_streams(torch, model, prompts, outs, unfused_outs)
    finally:
        restore_capacity(model, factors)
    tokens = sum(len(o) for o in outs)
    stats.update(
        oracle=dict(checked=checked, ties=ties, mismatched=mismatched),
        admitted=admitted, launches=launches,
        captures=after["captures"], captures_at_warmup=before["captures"],
        fused_dispatches=(after["fused_dispatches"]
                          - before["fused_dispatches"]),
        graph_step_equals_eager=same, graph_step_cache_rel_err=cache_err,
        fused_vs_unfused=dict(zip(("equal", "tied", "differing"), res)))
    checks["stream"] = (all(len(o) == m for o, m in zip(outs, news))
                        and mismatched == 0 and checked >= tokens // 2
                        and launches["flash_fwd"]
                        == cfg["n_layers"] * admitted
                        and after["captures"] == before["captures"])
    checks["graph"] = same and cache_err <= MOE_TOL["cache"]
    checks["fused"] = res[2] == 0
    stats["checks"] = checks
    return all(checks.values()), stats


def phase_moe(torch, TransformerLM, kernels, inference, objectives):
    """TransformerLM with Switch-MoE blocks (MOE) on the train phase's
    plan at f32: a warm-up fit and TRAIN_STEPS synchronised one-step
    fits (ms, tokens/s, peak GiB, each kernel's launches: n_layers a
    step), the share of tokens dropped at capacity, the gradients
    against blockwise attention (:func:`moe_gradient_check`), the aux
    term in the loss, the index
    dispatch against the dense one-hot; then ``generate`` (the path
    phase's prompts) against a drop-free forward's argmax and the
    serving checks of :func:`moe_serve`; then the same model at bf16 with
    MIXED_ACCUM microbatches: 2 x n_layers bf16 launches a step of each
    kernel, none at f32, losses within MIXED_LOSS_TOL of the f32 ones."""
    import gc
    import statistics
    import numpy as np
    cfg = dict(FULL, seq_len=TRAIN_SEQ, **MOE)
    n_layers, B = cfg["n_layers"], TRAIN_BATCH
    x, y = periodic_tokens(B * (TRAIN_STEPS + 1), cfg["vocab_size"],
                           TRAIN_SEQ, seed=1)
    stats, checks = {}, {}

    def train(model, **compile_args):
        model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                      **compile_args)
        model.fit(x[:B], y[:B], batch_size=B)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, step_s, aux = [], [], []
        for i in range(1, TRAIN_STEPS + 1):
            rows = slice(i * B, (i + 1) * B)
            t = time.perf_counter()
            losses += model.fit(x[rows], y[rows], batch_size=B)["loss"]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            aux.append(sum(float(m.aux_loss) for m in moe_layers(model)))
        return (losses, aux, step_s, kernels.launch_counts_by_dtype(),
                kernels.launch_counts_by_design(),
                torch.cuda.max_memory_allocated() / 2 ** 30)

    model = TransformerLM(**cfg, device="cuda", seed=0)
    stats["parameters"] = sum(p.numel() for p in model.parameters())
    losses, aux, step_s, counts, designs, peak = train(model)
    step = statistics.median(step_s)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
    stats.update(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 tokens_per_s=B * TRAIN_SEQ / step, peak_gib=peak,
                 losses=losses, summed_aux=aux, launches=counts,
                 launches_by_design=designs, launches_per_step=per_step)
    # no "falling" here: while the router rebalances from its seeded
    # start, tokens that were dropped (passed through) reach untrained
    # experts, and the first steps' losses may rise
    checks["train"] = (all(math.isfinite(v) for v in losses + aux)
                       and len(losses) == TRAIN_STEPS
                       and all(counts[f"{k}[f32]"] == n_layers * TRAIN_STEPS
                               for k in KERNELS))

    routes = []
    handles = record_routing(torch, model, routes)
    try:
        with torch.no_grad():
            model(torch.as_tensor(x[:B], device="cuda"))
    finally:
        for h in handles:
            h.remove()
    kept = torch.cat([r[1] for r in routes])
    stats["dropped_share"] = 1.0 - float(kept.float().mean())
    del routes, kept
    checks["gradients"], grads = moe_gradient_check(
        torch, model, objectives, x[:2], y[:2])
    stats.update(grads)
    stats["aux"] = moe_aux_check(torch, model, objectives, x[B:2 * B],
                                 y[B:2 * B])
    checks["aux"] = (stats["aux"]["abs_err"] <= MOE_TOL["aux"]
                     and stats["aux"]["summed_aux"] > 0
                     and stats["aux"]["summed_aux_at_0"] == 0.0)
    stats["dispatch"] = moe_dispatch_check(torch)
    checks["dispatch"] = stats["dispatch"]["rel_err"] <= MOE_TOL["dispatch"]

    # generate at the path phase's plan
    model.eval()
    prompt = torch.randint(0, cfg["vocab_size"], (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1)).numpy()
    model.generate(prompt, 2)  # warm-up
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = model.generate(prompt, NEW)
    gen_s = time.perf_counter() - t
    gen_counts = kernels.launch_counts()
    factors = drop_free(model)
    try:
        oracle = argmax_oracle(torch, model, out, PROMPT)
    finally:
        restore_capacity(model, factors)
    stats.update(generate_ms=gen_s * 1e3, generate_tokens_per_s=BATCH * NEW
                 / gen_s, generate_launches=gen_counts, oracle=oracle)
    checks["generate"] = (out.shape == (BATCH, PROMPT + NEW)
                          and oracle["finite"] and oracle["mismatched"] == 0
                          and oracle["checked"] >= oracle["total"] // 2
                          and gen_counts["flash_fwd"] == n_layers)
    checks["serve"], stats["serve"] = moe_serve(torch, model, kernels,
                                                inference)
    stats["serve_tokens_per_s"] = stats["serve"]["tokens_per_s"]
    del model
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()

    bf = TransformerLM(**cfg, device="cuda", seed=0)
    bf_losses, _, bf_s, bf_counts, bf_designs, bf_peak = train(
        bf, compute_dtype=torch.bfloat16, accum_steps=MIXED_ACCUM)
    del bf
    torch.cuda.empty_cache()
    stats.update(bf16_step_ms=statistics.median(bf_s) * 1e3,
                 bf16_step_ms_all=[t * 1e3 for t in bf_s],
                 bf16_peak_gib=bf_peak,
                 bf16_losses=bf_losses, bf16_launches=bf_counts,
                 bf16_launches_by_design=bf_designs)
    checks["bf16"] = (
        all(math.isfinite(v) for v in bf_losses)
        and np.allclose(bf_losses, losses, **MIXED_LOSS_TOL)
        and all(bf_counts[f"{k}[bf16]"]
                == n_layers * MIXED_ACCUM * TRAIN_STEPS
                and not bf_counts[f"{k}[f32]"] for k in KERNELS))
    stats.update(checks=checks, card=smi_card())
    log("moe:", json.dumps(stats))
    for name, good in checks.items():
        if not good:
            log(f"moe: FAIL {name}")
    return all(checks.values()), stats


def write_png(path, rgb):
    """``rgb`` (h, w, 3) uint8 as an 8-bit RGB PNG, with the standard
    library's zlib and struct only (no imaging package needed)."""
    import struct
    import zlib
    import numpy as np
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def image_folder(root):
    """IMAGE["images"] smooth random RGB images of IMAGE["sides"] px a
    side from IMAGE["seed"], written as PNG into IMAGE["classes"] class
    folders; returns the folder and {path: rgb}."""
    import numpy as np
    I = IMAGE
    rng = np.random.default_rng(I["seed"])
    folder = os.path.join(root, "images")
    written = {}
    for i in range(I["images"]):
        h, w = (int(v) for v in rng.integers(I["sides"][0],
                                             I["sides"][1] + 1, 2))
        # a coarse random field, upsampled: image-like gradients
        coarse = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2, 3))
        ys = np.linspace(0, coarse.shape[0] - 1.001, h)
        xs = np.linspace(0, coarse.shape[1] - 1.001, w)
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        c = coarse
        img = ((c[y0][:, x0] * (1 - fx) + c[y0][:, x0 + 1] * fx) * (1 - fy)
               + (c[y0 + 1][:, x0] * (1 - fx) + c[y0 + 1][:, x0 + 1] * fx)
               * fy)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
            np.uint8)
        d = os.path.join(folder, f"class{i % I['classes']}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"img{i:03d}.png")
        write_png(path, img)
        written[path] = img
    return folder, written


def decode_images(torch, folder, written):
    """The image set of ``folder`` by the route the host has: the port's
    native library (libjpeg/libpng), else PIL through ``ImageSet.read``,
    else ``ImageSet.from_arrays`` of the written pixels; the native and
    PIL routes are held to the written pixels exactly (PNG is lossless).
    Also ``ImageLoader.from_folder`` where a decoder exists.  Returns
    the set and the route's numbers."""
    import numpy as np
    from analytics_zoo_tpu_torch import native
    from analytics_zoo_tpu_torch.data.image_loader import ImageLoader
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    route = ("native" if native.available() else
             "pil" if has_pil else "arrays")
    out = dict(route=route, native_build_error=native.build_error(),
               pil=has_pil)
    log(f"image: decode route {route}; native build error: "
        f"{native.build_error()}")
    t = time.perf_counter()
    if route == "arrays":
        paths = sorted(written)
        classes = sorted({os.path.basename(os.path.dirname(p))
                          for p in paths})
        iset = ImageSet.from_arrays(
            [written[p][:, :, ::-1].astype(np.float32) for p in paths],
            labels=np.asarray([[classes.index(os.path.basename(
                os.path.dirname(p))) + 1] for p in paths], np.float32))
        for f, p in zip(iset.features, paths):
            f["uri"] = p
    else:
        iset = ImageSet.read(folder, with_label=True)
    out["read_ms_per_image"] = (time.perf_counter() - t) * 1e3 / len(iset)
    out["pixels_exact"] = all(
        np.array_equal(f["image"][:, :, ::-1], written[f["uri"]])
        for f in iset.features)
    out["labels"] = sorted(set(iset.labels()[:, 0].tolist()))
    if route != "arrays":
        t = time.perf_counter()
        loaded = ImageLoader.from_folder(
            folder, batch_size=16, size=224, mean=(123.68, 116.779, 103.939),
            num_threads=8).as_dataset()
        out["loader_ms_per_image"] = (time.perf_counter() - t) * 1e3 \
            / loaded.size
        out["loader_shape"] = list(loaded.x.shape)
    else:
        out["loader_ms_per_image"] = None
        log("image: ImageLoader skipped: no decoder on this host "
            "(native build failed, PIL missing)")
    return iset, out


def int8_accumulators(torch, qmodel):
    """conv_accumulate / int_matmul on the card against the CPU on the
    same int8 operands (the model's int8 weights, activations quantized
    from N(0, 1) at each layer's input shape): the stem convolution, a
    3x3 64->64 and a 1x1 256->64 convolution, and the fc at batches 1, 2
    and 32.  Returns {case: max |card - cpu|} (int32, so 0 when
    equal)."""
    from analytics_zoo_tpu_torch.ops import quantize as Q
    g = torch.Generator().manual_seed(0)
    convs = [l for l in qmodel.to_graph().layers
             if isinstance(l, Q.QuantizedConv)]
    fc = next(l for l in qmodel.to_graph().layers
              if isinstance(l, Q.QuantizedDense))

    def pick(kh, cin, cout):
        return next(l for l in convs if tuple(l.Wq.shape) ==
                    (kh, kh, cin, cout))

    cases = {"stem 7x7 3->64 s2": (pick(7, 3, 64), 224),
             "3x3 64->64": (pick(3, 64, 64), 56),
             "1x1 256->64": (pick(1, 256, 64), 56)}
    errs = {}
    for name, (layer, size) in cases.items():
        cin = layer.Wq.shape[2]
        xq, _ = Q.dynamic_quantize(torch.randn(2, size, size, cin,
                                               generator=g))
        src = layer.src
        pads = src._pads((size, size))
        on_card = Q.conv_accumulate(xq.cuda(), layer.Wq, src.subsample,
                                    pads, src.dilation)
        on_cpu = Q.conv_accumulate(xq, layer.Wq.cpu(), src.subsample, pads,
                                   src.dilation)
        errs[name] = int((on_card.cpu().long() - on_cpu.long()).abs().max())
    for rows in IMAGE["fc_batches"]:
        xq, _ = Q.dynamic_quantize(torch.randn(rows, fc.Wq.shape[0],
                                               generator=g))
        on_card = Q.int_matmul(xq.cuda(), fc.Wq)
        on_cpu = Q.int_matmul(xq, fc.Wq.cpu())
        errs[f"fc 2048->1000 batch {rows}"] = int(
            (on_card.cpu().long() - on_cpu.long()).abs().max())
    return errs


def int8_layers_vs_cpu(torch, card_net, cpu_net, x):
    """Each layer of an int8 net on the card against the same layer of
    its CPU copy, both given the card's own input to that layer
    (captured by forward hooks over one predict of ``x``): how many int8
    layers give the CPU's bits (every one whose activation does not sum,
    when the quantize pass, the int32 product and the rescale agree),
    and the largest |card - cpu| over max |cpu| of the int8 layers and
    of the float ones (pooling and softmax sums)."""
    from analytics_zoo_tpu_torch.ops.quantize import _QuantizedLayer
    calls = []
    hooks = [layer.register_forward_hook(
        lambda m, args, out: calls.append((m.name, args[0], out)))
        for layer in card_net.to_graph().layers]
    try:
        card_net.predict(x, batch_size=len(x))
    finally:
        for h in hooks:
            h.remove()
    cpu_of = {layer.name: layer for layer in cpu_net.to_graph().layers}
    cpu_net.eval()
    int8, exact, worst = 0, 0, {"int8": 0.0, "float": 0.0}
    with torch.no_grad():
        for name, ins, out in calls:
            ref = cpu_of[name]([t.cpu() for t in ins]
                               if isinstance(ins, list) else ins.cpu())
            err = float((out.cpu() - ref).abs().max())
            kind = ("int8" if isinstance(cpu_of[name], _QuantizedLayer)
                    else "float")
            if kind == "int8":
                int8 += 1
                exact += err == 0
            worst[kind] = max(worst[kind],
                              err / (float(ref.abs().max()) or 1.0))
    return dict(layers=len(calls), int8_layers=int8, int8_exact=exact,
                int8_max_rel_err=worst["int8"],
                float_max_rel_err=worst["float"])


def unmatched_detections(a, b, tol, scale):
    """Rows of ``a`` ([label, score, x1, y1, x2, y2]) with no row of ``b``
    of the same label, score within ``tol`` and box within ``tol *
    scale``, each row of ``b`` used once: near-tied scores may list the
    same detections in another order on another device."""
    import numpy as np
    free = list(range(len(b)))
    missing = 0
    for row in a:
        hit = next((j for j in free if b[j, 0] == row[0]
                    and abs(b[j, 1] - row[1]) <= tol
                    and np.abs(b[j, 2:] - row[2:]).max() <= tol * scale),
                   None)
        if hit is None:
            missing += 1
        else:
            free.remove(hit)
    return missing


def serve_image_requests(im, x, threads, per_request, requests):
    """``requests`` requests of ``per_request`` rows of ``x`` (in turn,
    wrapping round) sent to ``im.predict`` from ``threads`` threads.
    Each thread makes one predict of its own first (its per-thread
    library handles and workspaces), and the clock starts when all are
    done; (each request's rows in order, requests/s)."""
    import threading
    import numpy as np
    starts = [j * per_request % len(x) for j in range(requests)]
    out, errors = [None] * requests, []
    barrier = threading.Barrier(threads + 1)

    def client(k):
        try:
            im.predict(x[:per_request])
            barrier.wait()
            for j in range(k, requests, threads):
                out[j] = im.predict(x[starts[j]:starts[j] + per_request])
        except Exception as e:  # re-raised below
            errors.append(e)
            barrier.abort()

    workers = [threading.Thread(target=client, args=(k,))
               for k in range(threads)]
    for w in workers:
        w.start()
    try:
        barrier.wait(300)
    except threading.BrokenBarrierError:
        pass  # a client failed: its error is raised below
    t = time.perf_counter()
    for w in workers:
        w.join(600)
    wall = time.perf_counter() - t
    if errors:
        raise errors[0]
    return np.concatenate(out), requests / wall


def torch_import_check(torch, models, keras):
    """A plain torch.nn CNN from seed (Conv2d, BatchNorm2d, ReLU, Conv2d,
    Flatten, Dropout, Linear; eval mode, moving statistics set) loaded
    with ``load_torch_state_dict`` into the matching port Sequential on
    the card: max |port - torch| over max |torch| at batch 8."""
    import numpy as np
    from analytics_zoo_tpu_torch.models.weight_loading import (
        load_torch_state_dict)
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    nn = torch.nn
    torch.manual_seed(0)
    tm = nn.Sequential(nn.Conv2d(3, 16, 3, padding=1), nn.BatchNorm2d(16),
                       nn.ReLU(), nn.Conv2d(16, 8, 3), nn.Flatten(),
                       nn.Dropout(0.5), nn.Linear(8 * 30 * 30, 10))
    with torch.no_grad():
        tm[1].running_mean.uniform_(-0.5, 0.5)
        tm[1].running_var.uniform_(0.5, 1.5)
    tm = tm.eval().cuda()
    m = keras.Sequential(seed=0)
    m.add(L.Convolution2D(16, 3, 3, border_mode="same",
                          input_shape=(32, 32, 3)))
    m.add(L.BatchNormalization(epsilon=1e-5))
    m.add(L.Activation("relu"))
    m.add(L.Convolution2D(8, 3, 3))
    m.add(L.Flatten())
    m.add(L.Dropout(0.5))
    m.add(L.Dense(10))
    load_torch_state_dict(m, tm.state_dict())
    x = np.random.default_rng(0).uniform(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x).cuda().permute(0, 3, 1, 2))
    want = want.cpu().numpy()
    got = m.predict(x, batch_size=8)
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_image(torch, models, keras, kernels, inference, tmp):
    """The image-inference path (IMAGE): 64 PNG images of 180-500 px
    written from seed 0 into 4 class folders and read back
    (:func:`decode_images`); ResNet-50 (224x224x3, 1000 classes, f32,
    seed 0) through ``predict_image_set`` with
    ``ImageConfigure.parse("resnet-50")`` (host preprocessing ms, predict
    ms, end-to-end images/s, top-5 by ``label_output``; a CPU copy on the
    same preprocessed tensors: probabilities within 1e-4, top-1 equal
    unless the CPU's top-2 gap is below that); ``resnet-50-quantize`` from
    the same weights (images/s, weight bytes under a third of f32's,
    probabilities within 0.05 of f32's with top-1 equal on at least
    half; a CPU int8 copy on the first 8 images: probabilities within
    1e-5, top-1 equal unless its top-2 gap is below that, and each layer
    on the card equal to the copy's on the same input
    (:func:`int8_layers_vs_cpu`, within 1e-5); the int32 accumulators on the card equal to the CPU's,
    :func:`int8_accumulators`); SSD-VGG16-300
    with VOC's 21 classes through ``predict_image_set`` with its parsed
    configure (detections in each image's pixels; a CPU copy at 2 images
    finding every detection, :func:`unmatched_detections` at 1e-4; the
    '-quantize' raw head within 0.12 of f32's);
    ``InferenceModel(quantize=True)`` on a ``save_model`` of the ResNet-50
    from 4 threads, at a concurrency of 1 and of 4 (3 passes of 96
    requests of 4 images each, each thread warmed first: requests/s of
    each pass; ``reload`` stays int8); and a torch CNN imported by
    ``load_torch_state_dict`` within 1e-5."""
    import statistics
    import numpy as np
    from analytics_zoo_tpu_torch.feature.image import resize_branch
    from analytics_zoo_tpu_torch.ops.quantize import (quantize_graph,
                                                      quantized_size_bytes)
    I = IMAGE
    stats, ok = {}, True
    kernels.reset_launch_counts()
    folder, written = image_folder(tmp)
    iset, stats["decode"] = decode_images(torch, folder, written)
    d = stats["decode"]
    ok = ok and d["pixels_exact"] and len(iset) == I["images"] \
        and d["labels"] == list(range(1, I["classes"] + 1))
    stats["resize_branch"] = resize_branch(iset.features[0]["image"])
    log(f"image: {len(iset)} images, resize branch "
        f"{stats['resize_branch']}, read {d['read_ms_per_image']:.2f} ms "
        f"an image, ImageLoader {d['loader_ms_per_image']} ms an image")

    # ---- ResNet-50, f32
    cfg = models.ImageConfigure.parse("resnet-50")
    net = models.ImageClassifier("resnet-50", seed=0)
    t = time.perf_counter()
    ready = iset.copy().transform(cfg.pre_processor).to_array()
    prep_ms = (time.perf_counter() - t) * 1e3
    batch = cfg.batch_per_partition * 8
    net.predict(ready[:batch], batch_size=batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probs, predict_s = timed(torch, lambda: net.predict(ready, batch), 3)
    peak_f32 = torch.cuda.max_memory_allocated() / 2 ** 30
    t = time.perf_counter()
    net.predict_image_set(iset, configure=cfg)
    e2e_s = time.perf_counter() - t
    via_set = np.stack([p for _, p in iset.get_predicts()])
    top5 = models.label_output(via_set[:1])[0]
    launches_f32 = device_launches(torch, lambda: net.predict(
        ready[:batch], batch))
    cpu = models.ImageClassifier("resnet-50", device="cpu")
    models.from_jax_params(cpu, net.get_weights(), models.to_jax_state(net))
    rows = I["cpu_rows"]
    cpu_probs = cpu.predict(ready[:rows], batch_size=rows)
    # every input nudged up by one ulp, on the CPU: how far rounding
    # noise alone moves this net's probabilities
    nudged = np.nextafter(ready[:2], np.float32(np.inf))
    ulp_f32 = float(np.abs(cpu.predict(nudged, batch_size=2)
                           - cpu_probs[:2]).max())
    del cpu
    cpu_err = float(np.abs(probs[:rows] - cpu_probs).max())
    srt = np.sort(cpu_probs, axis=-1)
    gaps = srt[:, -1] - srt[:, -2]
    top1_same = (np.argmax(probs[:rows], -1) == np.argmax(cpu_probs, -1))
    ties = int((~top1_same & (gaps < I["prob_tol"])).sum())
    stats["resnet50"] = dict(
        images=len(iset), host_preprocess_ms=prep_ms,
        host_preprocess_ms_per_image=prep_ms / len(iset),
        predict_ms=min(predict_s) * 1e3,
        predict_ms_all=[s * 1e3 for s in predict_s],
        predict_images_per_s=len(ready) / min(predict_s),
        end_to_end_ms=e2e_s * 1e3, end_to_end_images_per_s=len(iset) / e2e_s,
        set_equals_predict=float(np.abs(via_set - probs).max()),
        top5=top5, launches_per_batch=launches_f32, batch=batch,
        peak_gib=peak_f32, cpu_rows=rows, cpu_prob_err=cpu_err,
        cpu_top1_equal=int(top1_same.sum()), cpu_top1_ties=ties,
        cpu_one_ulp_prob_change=ulp_f32)
    ok = ok and cpu_err <= I["prob_tol"] and bool(
        (top1_same | (gaps < I["prob_tol"])).all()) \
        and stats["resnet50"]["set_equals_predict"] <= I["prob_tol"] \
        and np.isfinite(probs).all() and probs.shape == (len(iset), 1000)
    log("image: resnet-50 f32", json.dumps(stats["resnet50"]))

    # ---- resnet-50-quantize
    q = models.ImageClassifier("resnet-50-quantize", seed=0)
    q.set_weights(net.get_weights())
    q.predict(ready[:batch], batch_size=batch)  # builds the int8 twin
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qprobs, q_s = timed(torch, lambda: q.predict(ready, batch), 3)
    peak_q = torch.cuda.max_memory_allocated() / 2 ** 30
    t = time.perf_counter()
    qset = iset.copy()
    q.predict_image_set(qset, configure=cfg)
    q_e2e = time.perf_counter() - t
    f32_bytes = quantized_size_bytes(models.to_jax_params(net))
    _, qparams, _ = quantize_graph(net.to_graph())
    q_bytes = quantized_size_bytes(qparams)
    acc = int8_accumulators(torch, q._quantized_net)
    launches_q = device_launches(torch, lambda: q.predict(ready[:batch],
                                                          batch))
    q_err = float(np.abs(qprobs - probs).max())
    # the same int8 net on the CPU, from the card's weights and state,
    # end to end and layer by layer on the card's own inputs; the
    # one-ulp nudge shows how far a last-bit difference in a float
    # layer carries (it flips int8 roundings, and the flips grow)
    cq = models.ImageClassifier("resnet-50-quantize", device="cpu")
    models.from_jax_params(cq, q.get_weights(), models.to_jax_state(q))
    cq_probs = cq.predict(ready[:rows], batch_size=rows)
    ulp_int8 = float(np.abs(cq.predict(nudged, batch_size=2)
                            - cq_probs[:2]).max())
    by_layer = int8_layers_vs_cpu(torch, q._quantized_net,
                                  cq._quantized_net, ready[:2])
    del cq
    q_cpu_err = float(np.abs(qprobs[:rows] - cq_probs).max())
    q_top1 = np.argmax(qprobs[:rows], -1) == np.argmax(cq_probs, -1)
    srt = np.sort(cq_probs, axis=-1)
    q_gaps = srt[:, -1] - srt[:, -2]
    top1_vs_f32 = float((np.argmax(qprobs, -1)
                         == np.argmax(probs, -1)).mean())
    stats["resnet50_int8"] = dict(
        predict_ms=min(q_s) * 1e3, predict_ms_all=[s * 1e3 for s in q_s],
        predict_images_per_s=len(ready) / min(q_s),
        f32_predict_images_per_s=len(ready) / min(predict_s),
        end_to_end_images_per_s=len(iset) / q_e2e,
        weight_bytes=q_bytes, f32_weight_bytes=f32_bytes,
        bytes_ratio=q_bytes / f32_bytes, prob_err_vs_f32=q_err,
        top1_agree_vs_f32=top1_vs_f32, cpu_rows=rows,
        cpu_int8_prob_err=q_cpu_err, cpu_int8_top1_equal=int(q_top1.sum()),
        cpu_int8_one_ulp_prob_change=ulp_int8, cpu_int8_by_layer=by_layer,
        accumulators_card_vs_cpu=acc, launches_per_batch=launches_q,
        peak_gib=peak_q)
    ok = ok and q_bytes < f32_bytes / 3 and q_err <= I["int8_prob_tol"] \
        and q_cpu_err <= I["int8_cpu_tol"] \
        and bool((q_top1 | (q_gaps < I["int8_cpu_tol"])).all()) \
        and top1_vs_f32 >= I["int8_top1_floor"] \
        and by_layer["int8_layers"] > 0 \
        and max(by_layer["int8_max_rel_err"],
                by_layer["float_max_rel_err"]) <= I["layer_tol"] \
        and all(v == 0 for v in acc.values()) and np.isfinite(qprobs).all()
    log("image: resnet-50-quantize", json.dumps(stats["resnet50_int8"]))

    # ---- SSD-VGG16-300, VOC
    D = DETECT
    det = models.ObjectDetector(D["name"], num_classes=D["classes"],
                                conf_threshold=D["conf_threshold"],
                                nms_threshold=D["nms_threshold"],
                                max_detections=D["max_detections"], seed=0)
    scfg = models.ImageConfigure.parse(D["name"])
    sset = iset.copy()
    det.predict_image_set(sset.copy(), batch_size=D["batch"],
                          configure=scfg)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    det.predict_image_set(sset, batch_size=D["batch"], configure=scfg)
    torch.cuda.synchronize()
    ssd_s = time.perf_counter() - t
    dets = [np.asarray(p) for _, p in sset.get_predicts()]
    inside = all(
        ((d[d[:, 0] >= 0][:, [2, 4]] >= 0) & (d[d[:, 0] >= 0][:, [2, 4]]
                                               <= f["image"].shape[1])).all()
        and ((d[d[:, 0] >= 0][:, [3, 5]] >= 0)
             & (d[d[:, 0] >= 0][:, [3, 5]] <= f["image"].shape[0])).all()
        for d, f in zip(dets, sset.features))
    untouched = all(np.array_equal(a["image"], b["image"])
                    for a, b in zip(sset.features, iset.features))
    srows = D["cpu_rows"]
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    small = ImageSet.from_arrays([f["image"] for f in iset.features[:srows]])
    cdet = models.ObjectDetector(D["name"], num_classes=D["classes"],
                                 conf_threshold=D["conf_threshold"],
                                 nms_threshold=D["nms_threshold"],
                                 max_detections=D["max_detections"],
                                 device="cpu")
    models.from_jax_params(cdet, det.get_weights())
    cdet.predict_image_set(small, batch_size=srows, configure=scfg)
    del cdet
    cpu_dets = [np.asarray(p) for _, p in small.get_predicts()]
    unmatched = sum(unmatched_detections(a, b, DETECT_TOL,
                                         max(f["image"].shape))
                    for a, b, f in zip(dets, cpu_dets, iset.features))
    in_order = all(np.array_equal(a[:, 0], b[:, 0])
                   for a, b in zip(dets, cpu_dets))
    qdet = models.ObjectDetector(D["name"] + "-quantize",
                                 num_classes=D["classes"], seed=0)
    qdet.set_weights(det.get_weights())
    sready = iset.copy().transform(scfg.pre_processor).to_array()[:D["batch"]]
    raw_f = det.predict(sready, batch_size=D["batch"])
    raw_q = qdet.predict(sready, batch_size=D["batch"])
    head_err = float(np.abs(raw_f - raw_q).max() / np.abs(raw_f).max())
    stats["ssd"] = dict(
        model=D["name"], classes=D["classes"], images=len(sset),
        end_to_end_ms=ssd_s * 1e3, end_to_end_images_per_s=len(sset) / ssd_s,
        detections=int(sum((d[:, 0] >= 0).sum() for d in dets)),
        inside_original=bool(inside), originals_untouched=bool(untouched),
        cpu_rows=srows, cpu_unmatched=unmatched,
        cpu_labels_in_order=bool(in_order), int8_head_rel_err=head_err)
    ok = ok and inside and untouched and unmatched == 0 \
        and head_err < I["int8_head_tol"]
    log("image: ssd", json.dumps(stats["ssd"]))
    del det, qdet

    # ---- serving the int8 ResNet-50 from 4 threads
    path = os.path.join(tmp, "resnet50_image")
    net.save_model(path)
    rps, serve_err = {}, 0.0
    want = np.concatenate([qprobs] * (I["requests"] * I["per_request"]
                                      // len(qprobs)))
    for concurrent in (1, I["threads"]):
        im = inference.InferenceModel(supported_concurrent_num=concurrent
                                      ).load(path, quantize=True)
        try:
            rps[concurrent] = []
            for _ in range(I["passes"]):
                served, r = serve_image_requests(
                    im, ready, I["threads"], I["per_request"],
                    I["requests"])
                rps[concurrent].append(r)
                serve_err = max(serve_err,
                                float(np.abs(served - want).max()))
            im.reload(path)
            again = im.predict(ready[:I["per_request"]])
            stays_int8 = bool(im._quantize_flag)
        finally:
            im.close()
    reload_err = float(np.abs(again - served[:I["per_request"]]).max())
    stats["serve"] = dict(requests=I["requests"], passes=I["passes"],
                          rows_per_request=I["per_request"],
                          threads=I["threads"],
                          requests_per_s=statistics.median(
                              rps[I["threads"]]),
                          requests_per_s_passes=rps[I["threads"]],
                          requests_per_s_concurrent_1=statistics.median(
                              rps[1]),
                          requests_per_s_concurrent_1_passes=rps[1],
                          vs_predict_err=serve_err, reload_int8=stays_int8,
                          reload_err=reload_err)
    ok = ok and stays_int8 and serve_err <= I["prob_tol"] \
        and reload_err <= I["prob_tol"]
    log("image: serve", json.dumps(stats["serve"]))

    stats["torch_import_rel_err"] = torch_import_check(torch, models, keras)
    ok = ok and stats["torch_import_rel_err"] <= I["import_tol"]
    stats.update(
        images=len(iset), decode_route=d["route"],
        resize_branch=stats["resize_branch"],
        host_preprocess_ms_per_image=prep_ms / len(iset),
        f32_images_per_s=stats["resnet50"]["end_to_end_images_per_s"],
        int8_images_per_s=stats["resnet50_int8"]["end_to_end_images_per_s"],
        launches=kernels.launch_counts(), card=smi_card())
    log("image:", json.dumps(stats))
    return bool(ok), stats


#: the conv VAE of the reference's faces app (apps/variational-
#: autoencoder), at its widths: 64x64x3 images, a 4-block strided encoder,
#: a 128-d latent, a 4-block resize-and-convolve decoder; adam 1e-3,
#: batch 64 of seeded images in [0, 1]
VAE = dict(size=64, widths=(32, 64, 128, 256), dec_widths=(128, 64, 32, 16),
           latent=128, batch=64, lr=1e-3, timed_steps=20, check_steps=3)


def conv_vae(L, A, Model, size, widths, dec_widths, latent, **model_kw):
    """The conv VAE from a package's Keras layers ``L``, autograd ``A``
    and ``Model`` (the port's or the JAX package's: the two share names
    and signatures): per encoder width ``Convolution2D(f, 4, 4,
    subsample=(2, 2), border_mode="same")``, ``BatchNormalization``,
    ``LeakyReLU(0.2)``; ``Flatten``; ``Dense(latent)`` for the mean and
    the log-variance; ``GaussianSampler``; ``Dense``, ``Reshape`` to the
    encoder's last map; per decoder width ``ResizeBilinear`` to twice the
    side, ``Convolution2D(f, 3, 3, border_mode="same")``,
    ``BatchNormalization``, ``LeakyReLU(0.2)``; a sigmoid
    ``Convolution2D(3, 3, 3)``.  One packed output ``[image | mean |
    log_var]`` (vae.py's), so that one loss sees all three.

    The convolutions before a BatchNormalization have no bias: the
    normalization removes it, so its gradient is rounding noise, which
    adam turns into steps of the learning rate's size in a direction
    that differs between devices and packages (0.02 apart in eval
    predictions after 3 steps, on the CPU between the two packages)."""
    x = L.Input((size, size, 3))
    h = x
    for f in widths:
        h = L.Convolution2D(f, 4, 4, subsample=(2, 2), border_mode="same",
                            bias=False)(h)
        h = L.LeakyReLU(0.2)(L.BatchNormalization()(h))
    h = L.Flatten()(h)
    mean, log_var = L.Dense(latent)(h), L.Dense(latent)(h)
    z = L.GaussianSampler()([mean, log_var])
    side = size // 2 ** len(widths)
    d = L.Dense(side * side * widths[-1])(z)
    d = L.Reshape((side, side, widths[-1]))(d)
    for f in dec_widths:
        side *= 2
        d = L.ResizeBilinear(side, side)(d)
        d = L.Convolution2D(f, 3, 3, border_mode="same", bias=False)(d)
        d = L.LeakyReLU(0.2)(L.BatchNormalization()(d))
    out = L.Convolution2D(3, 3, 3, border_mode="same",
                          activation="sigmoid")(d)
    packed = A.concat([L.Flatten()(out), mean, log_var], axis=1)
    return Model(input=x, output=packed, **model_kw)


def vae_loss(A, size, latent):
    """vae.py's loss, a ``CustomLoss``: the summed squared error of the
    image plus the KL term of the latent, each sample."""
    n = size * size * 3

    def loss(y_true, y_pred):
        rec = A.sum(A.square(y_true[:, :n] - y_pred[:, :n]), axis=1)
        mu = y_pred[:, n:n + latent]
        lv = y_pred[:, n + latent:]
        kl = -0.5 * A.sum(1 + lv - A.square(mu) - A.exp(lv), axis=1)
        return rec + kl

    return A.CustomLoss(loss)


def vae_data(size, latent, batch, seed=0):
    """A batch of seeded images in [0, 1] and its target, the image
    padded to the packed width (the padding is ignored)."""
    import numpy as np
    x = np.random.default_rng(seed).random(
        (batch, size, size, 3), dtype=np.float32)
    y = np.concatenate([x.reshape(batch, -1),
                        np.zeros((batch, 2 * latent), np.float32)], axis=1)
    return x, y


#: the sweep's per-sample input shapes (batch LAYER_BATCH): 64x64 images
#: of 64 channels, 16^3 volumes of 16 channels, sequences of 128 x 256
#: (``seq+`` positive, ``seq0`` with whole steps of zeros)
LAYER_BATCH = 32
LAYER_INPUTS = {"img": (64, 64, 64), "vol": (16, 16, 16, 16),
                "seq": (128, 256), "seq+": (128, 256), "seq0": (128, 256),
                "vec": (256,), "col": (128, 1, 256)}
LAYER_TOL = 1e-5            # max |card - cpu| over max |cpu|, f32
#: cuDNN takes a 3x3 stride-1 f32 convolution's weight gradient by
#: Winograd: 3.6e-5 of an f64 reference where the CPU is within 3.2e-7
#: (scripts/profile_torch_conv_precision.py, H100 at 700 W); the
#: dilated, strided and 3-D ones stay within 6e-6
LAYER_TOL_BY_CLASS = {"LRN2D": 2e-5, "ShareConvolution2D": 1e-4,
                      "keras2.Conv2D": 1e-4}
VAE_TOL = dict(losses=1e-4, predict=1e-5)


def layer_sweep_specs(L, K2):
    """(class name, factory, input kinds, exact) for every class the
    layer set's last slice ported, at the sweep's sizes; ``exact`` where
    the card must give the CPU's bits (pads, crops, permutes, the
    upsampling forward, the mask).  The random layers run in eval
    mode."""
    steps, width = LAYER_INPUTS["seq"]
    merges = [(f"Merge[{m}]", (lambda m=m: L.Merge(mode=m)), ("seq", "seq"),
               False) for m in ("sum", "mul", "max", "min", "ave", "sub",
                                "div", "concat", "dot", "cosine")]
    return [
        ("ELU", lambda: L.ELU(0.7), ("seq",), False),
        ("LeakyReLU", lambda: L.LeakyReLU(0.2), ("seq",), False),
        ("ThresholdedReLU", lambda: L.ThresholdedReLU(0.5), ("seq",),
         False),
        ("PReLU", lambda: L.PReLU(), ("seq",), False),
        ("SReLU", lambda: L.SReLU(), ("seq",), False),
        ("GaussianNoise", lambda: L.GaussianNoise(0.2), ("seq",), True),
        ("GaussianDropout", lambda: L.GaussianDropout(0.2), ("seq",), True),
        ("Convolution3D", lambda: L.Convolution3D(
            16, 3, 3, 3, border_mode="same"), ("vol",), False),
        ("AtrousConvolution1D", lambda: L.AtrousConvolution1D(
            64, 3, atrous_rate=2), ("seq",), False),
        ("AtrousConvolution2D", lambda: L.AtrousConvolution2D(
            64, 3, 3, atrous_rate=(2, 2), border_mode="same"), ("img",),
         False),
        ("ShareConvolution2D", lambda: L.ShareConvolution2D(
            64, 3, 3, border_mode="same"), ("img",), False),
        ("Deconvolution2D", lambda: L.Deconvolution2D(
            64, 4, 4, subsample=(2, 2), border_mode="same"), ("img",),
         False),
        ("LocallyConnected1D", lambda: L.LocallyConnected1D(64, 3),
         ("seq",), False),
        ("LocallyConnected2D", lambda: L.LocallyConnected2D(16, 3, 3),
         ("img",), False),
        ("ZeroPadding1D", lambda: L.ZeroPadding1D((2, 3)), ("seq",), True),
        ("ZeroPadding3D", lambda: L.ZeroPadding3D((1, 2, 1)), ("vol",),
         True),
        ("Cropping1D", lambda: L.Cropping1D((3, 2)), ("seq",), True),
        ("Cropping2D", lambda: L.Cropping2D(((2, 1), (0, 3))), ("img",),
         True),
        ("Cropping3D", lambda: L.Cropping3D(), ("vol",), True),
        ("UpSampling1D", lambda: L.UpSampling1D(2), ("seq",), True),
        ("UpSampling2D", lambda: L.UpSampling2D((2, 2)), ("img",), True),
        ("UpSampling3D", lambda: L.UpSampling3D((2, 2, 2)), ("vol",), True),
        ("ResizeBilinear[up]", lambda: L.ResizeBilinear(128, 128),
         ("img",), False),
        ("ResizeBilinear[down]", lambda: L.ResizeBilinear(24, 40),
         ("img",), False),
        ("MaxPooling1D", lambda: L.MaxPooling1D(3, 2, border_mode="same"),
         ("seq",), False),
        ("AveragePooling1D", lambda: L.AveragePooling1D(
            3, 2, border_mode="same"), ("seq",), False),
        ("MaxPooling3D", lambda: L.MaxPooling3D(
            (3, 3, 3), (2, 2, 2), border_mode="same"), ("vol",), False),
        ("AveragePooling3D", lambda: L.AveragePooling3D(
            (3, 3, 3), (2, 2, 2), border_mode="same"), ("vol",), False),
        ("SparseDense", lambda: L.SparseDense(256), ("seq",), False),
        ("SpatialDropout1D", lambda: L.SpatialDropout1D(0.3), ("seq",),
         True),
        ("SpatialDropout2D", lambda: L.SpatialDropout2D(0.3), ("img",),
         True),
        ("SpatialDropout3D", lambda: L.SpatialDropout3D(0.3), ("vol",),
         True),
        ("Permute", lambda: L.Permute((2, 1)), ("seq",), True),
        ("RepeatVector", lambda: L.RepeatVector(16), ("vec",), False),
        ("Masking", lambda: L.Masking(0.0), ("seq0",), True),
        ("Highway", lambda: L.Highway(), ("seq",), False),
        ("MaxoutDense", lambda: L.MaxoutDense(256, 4), ("vec",), False),
        ("TimeDistributed", lambda: L.TimeDistributed(L.Dense(256)),
         ("seq",), False),
        ("LRN2D", lambda: L.LRN2D(), ("img",), False),
        ("WithinChannelLRN2D", lambda: L.WithinChannelLRN2D(), ("img",),
         False),
        *merges,
        ("AddConstant", lambda: L.AddConstant(2.0), ("seq",), False),
        ("MulConstant", lambda: L.MulConstant(-1.5), ("seq",), False),
        ("BinaryThreshold", lambda: L.BinaryThreshold(0.1), ("seq",),
         True),
        ("Threshold", lambda: L.Threshold(0.1, -2.0), ("seq",), False),
        ("HardShrink", lambda: L.HardShrink(0.4), ("seq",), False),
        ("SoftShrink", lambda: L.SoftShrink(0.4), ("seq",), False),
        ("HardTanh", lambda: L.HardTanh(-0.5, 0.7), ("seq",), False),
        ("RReLU", lambda: L.RReLU(), ("seq",), False),
        ("Exp", lambda: L.Exp(), ("seq",), False),
        ("Log", lambda: L.Log(), ("seq+",), False),
        ("Sqrt", lambda: L.Sqrt(), ("seq+",), False),
        ("Square", lambda: L.Square(), ("seq",), False),
        ("Negative", lambda: L.Negative(), ("seq",), True),
        ("Identity", lambda: L.Identity(), ("seq",), True),
        ("Power", lambda: L.Power(2.5, 0.5, 0.2), ("seq+",), False),
        ("Mul", lambda: L.Mul(), ("seq",), False),
        ("CAdd", lambda: L.CAdd([1, 1, width]), ("seq",), False),
        ("CMul", lambda: L.CMul([1, steps, 1]), ("seq",), False),
        ("Scale", lambda: L.Scale([1, 1, width]), ("seq",), False),
        ("GaussianSampler", lambda: L.GaussianSampler(), ("seq", "seq"),
         True),
        ("KerasLayerWrapper", lambda: L.KerasLayerWrapper(
            lambda x: x[:, 1:] * 2.0), ("seq",), False),
        ("Narrow", lambda: L.Narrow(1, 3, steps // 2), ("seq",), True),
        ("Select", lambda: L.Select(1, 5), ("seq",), True),
        ("Squeeze", lambda: L.Squeeze(2), ("col",), True),
        ("keras2.Dense", lambda: K2.Dense(256), ("seq",), False),
        ("keras2.Dropout", lambda: K2.Dropout(0.3), ("seq",), True),
        ("keras2.Conv1D", lambda: K2.Conv1D(64, 3, padding="same"),
         ("seq",), False),
        ("keras2.Conv2D", lambda: K2.Conv2D(64, 3, padding="same"),
         ("img",), False),
        ("keras2.Cropping1D", lambda: K2.Cropping1D((1, 2)), ("seq",),
         True),
        ("keras2.LocallyConnected1D", lambda: K2.LocallyConnected1D(64, 3),
         ("seq",), False),
        ("keras2.MaxPooling1D", lambda: K2.MaxPooling1D(2), ("seq",),
         False),
        ("keras2.AveragePooling1D", lambda: K2.AveragePooling1D(2),
         ("seq",), False),
        ("keras2.Maximum", lambda: K2.Maximum(), ("seq", "seq"), False),
        ("keras2.Minimum", lambda: K2.Minimum(), ("seq", "seq"), False),
        ("keras2.Average", lambda: K2.Average(), ("seq", "seq"), False),
    ]


def sweep_inputs(torch, kinds, g):
    """The batch for each input kind, from the CPU generator ``g``; the
    second of two inputs is positive (a ``div``'s divisor)."""
    xs = []
    for i, kind in enumerate(kinds):
        x = torch.randn((LAYER_BATCH,) + LAYER_INPUTS[kind], generator=g)
        if kind == "seq+" or i == 1:
            x = x.abs() + 0.5
        if kind == "seq0":
            x[:, ::7] = 0.0  # whole steps of zeros: Masking's mask
        xs.append(x)
    return xs


def sweep_one(torch, make, kinds, exact, g):
    """One layer on the card and an f32 copy on the CPU with the same
    parameters (perturbed from the init by a seeded draw), both in eval
    mode: the forward, every input's gradient and every parameter's
    gradient of sum(out * cot).  Returns the worst error over all of
    them, max|card - cpu| over max|cpu| (an exact layer's forward and,
    unless it upsamples, its gradients must be equal: their worst
    absolute difference is returned, 0 or a failure)."""
    shapes = [(None,) + LAYER_INPUTS[k] for k in kinds]
    layers = []
    for dev in ("cuda", "cpu"):
        layer = make()
        layer.build(shapes[0] if len(shapes) == 1 else shapes,
                    torch.Generator(dev).manual_seed(0))
        layer.eval()
        layers.append(layer)
    card, cpu = layers
    with torch.no_grad():
        for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
            p.add_(0.1 * torch.randn(p.shape, generator=g).to(p.device))
            q.copy_(p.cpu())
    xs = sweep_inputs(torch, kinds, g)
    runs = []
    for layer, dev in ((card, "cuda"), (cpu, "cpu")):
        ins = [x.to(dev).requires_grad_() for x in xs]
        out = layer(ins[0] if len(ins) == 1 else ins)
        runs.append((layer, ins, out))
    cot = torch.randn(runs[1][2].shape, generator=g)
    grads = []
    for layer, ins, out in runs:
        wrt = ins + list(layer.parameters())
        if out.requires_grad:
            got = torch.autograd.grad((out * cot.to(out.device)).sum(), wrt,
                                      allow_unused=True)
        else:
            got = [None] * len(wrt)
        grads.append([None if t is None else t.detach().cpu() for t in got])
    pairs = [(runs[0][2].detach().cpu(), runs[1][2].detach())]
    pairs += [(a, b) for a, b in zip(*grads) if b is not None]
    upsamples = type(card).__name__.startswith("UpSampling")
    worst = 0.0
    for i, (a, b) in enumerate(pairs):
        if a is None:
            return math.inf
        diff = float((a - b).abs().max()) if a.numel() else 0.0
        if exact and (i == 0 or not upsamples):
            worst = max(worst, math.inf if diff else 0.0)
            continue
        scale = float(b.abs().max()) if b.numel() else 0.0
        worst = max(worst, diff / scale if scale else diff)
    return worst


def vae_noise(model):
    """The VAE's GaussianSampler."""
    return next(l for l in model.to_graph().layers
                if type(l).__name__ == "GaussianSampler")


def vae_profile(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: its kernels, their
    device ms in all and by kind (cuDNN convolutions, cuBLAS GEMMs, the
    rest), the wall ms and the device's idle share of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda
               and not e.key.startswith(("Memcpy", "Memset"))]
    by_kind = {}
    for e in kernels:
        kind = ("conv" if re.search(r"conv|fprop|dgrad|wgrad", e.key,
                                    re.IGNORECASE)
                else "gemm" if re.search(r"gemm|gemv|cutlass|xmma|nvjet",
                                         e.key, re.IGNORECASE)
                else "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.self_device_time_total / 1e3
    device_ms = sum(by_kind.values())
    return dict(launches=sum(e.count for e in kernels), device_ms=device_ms,
                device_ms_by_kind=by_kind, wall_ms=wall * 1e3,
                idle_share=1.0 - device_ms / (wall * 1e3))


def vae_vs_cpu(torch, keras, A, card, weights, state, x, y):
    """An f32 CPU copy of the VAE from the card model's initial weights
    and state: the card model takes VAE["check_steps"] one-step fits with
    its sampler's draws recorded, the copy the same steps with those
    draws given to it.  Returns both losses and the eval predictions'
    error (max|card - cpu| over max|cpu|) with the card's trained weights
    and state loaded into the copy, and, as a measurement that checks
    nothing, from each side's own weights and statistics: adam's first
    steps move by the sign of each gradient entry, so entries near 0
    part the two trajectories, and the debias at count 3 magnifies the
    statistics' last bits."""
    import numpy as np
    from analytics_zoo_tpu_torch.models import (from_jax_params,
                                                to_jax_state)
    V = VAE
    drawn = []
    sampler = vae_noise(card)
    draw = sampler.draw

    def recording(like):
        eps = draw(like)
        drawn.append(eps.cpu())
        return eps

    sampler.draw = recording
    try:
        card_losses = []
        for _ in range(V["check_steps"]):
            card_losses += card.fit(x, y, batch_size=V["batch"],
                                    shuffle=False)["loss"]
    finally:
        sampler.draw = draw
    cpu = conv_vae(keras.layers, A, keras.Model, V["size"], V["widths"],
                   V["dec_widths"], V["latent"], device="cpu")
    from_jax_params(cpu, weights, state)
    feed = iter(drawn)
    vae_noise(cpu).draw = lambda like: next(feed).to(like)
    cpu.compile({"name": "adam", "lr": V["lr"]},
                vae_loss(A, V["size"], V["latent"]))
    cpu_losses = []
    for _ in range(V["check_steps"]):
        cpu_losses += cpu.fit(x, y, batch_size=V["batch"],
                              shuffle=False)["loss"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses))

    def predict_err():
        got = card.predict(x, batch_size=V["batch"])
        ref = cpu.predict(x, batch_size=V["batch"])
        return float(np.abs(got - ref).max() / np.abs(ref).max())

    own = predict_err()
    from_jax_params(cpu, card.get_weights(), to_jax_state(card))
    same = predict_err()
    return dict(card_check_losses=card_losses, cpu_check_losses=cpu_losses,
                loss_rel_err=loss_err, predict_rel_err=same,
                own_state_predict_rel_err=own)


def phase_layers(torch, keras, kernels, tmp):
    """(a) Every class the layer set's last slice ported (LAYER_INPUTS'
    sizes, batch 32) on the card against an f32 CPU copy: forward, input
    and parameter gradients within LAYER_TOL of the largest entry
    (LAYER_TOL_BY_CLASS), exact where nothing is summed.  (b) The conv
    VAE (VAE) at full width on the card: VAE["check_steps"] adam steps
    against a CPU copy given the same noise (losses within 1e-4), eval
    predictions against the copy with the card's weights and state
    (1e-5; from each side's own, measured), then a warm-up fit and
    VAE["timed_steps"]
    timed one-step fits (ms a step, images/s, peak GiB), one profiled
    step (launches, device ms by kind, idle share), and a save_model/
    load_model round trip on the card predicting the same bits."""
    import statistics
    import numpy as np
    from analytics_zoo_tpu_torch.models import to_jax_state
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api import keras2
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    sweep, failed = {}, []
    for name, make, kinds, exact in layer_sweep_specs(keras.layers,
                                                      keras2.layers):
        err = sweep_one(torch, make, kinds, exact, g)
        sweep[name] = err
        tol = LAYER_TOL_BY_CLASS.get(name, LAYER_TOL)
        if not err <= tol:  # an exact mismatch is inf
            failed.append(name)
        torch.cuda.empty_cache()
    if failed:
        log(f"layers: FAIL sweep {failed}: "
            f"{json.dumps({k: sweep[k] for k in failed})}")

    V = VAE
    x, y = vae_data(V["size"], V["latent"], V["batch"])
    model = conv_vae(keras.layers, A, keras.Model, V["size"], V["widths"],
                     V["dec_widths"], V["latent"], seed=0)
    weights, state = model.get_weights(), to_jax_state(model)
    model.compile({"name": "adam", "lr": V["lr"]},
                  vae_loss(A, V["size"], V["latent"]))
    check = vae_vs_cpu(torch, keras, A, model, weights, state, x, y)
    losses = model.fit(x, y, batch_size=V["batch"])["loss"]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(V["timed_steps"]):
        t = time.perf_counter()
        losses += model.fit(x, y, batch_size=V["batch"])["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = vae_profile(torch, lambda: model.fit(x, y,
                                                batch_size=V["batch"]))
    step = statistics.median(step_s)
    pred = model.predict(x, batch_size=V["batch"])
    n = V["size"] ** 2 * 3
    infer = model.new_graph([model.outputs[0].name])
    path = os.path.join(tmp, "vae")
    infer.save_model(path)
    loaded = keras.load_model(path)
    same_after_load = bool(np.array_equal(
        loaded.predict(x, batch_size=V["batch"]), pred))
    stats = dict(
        sweep_worst_rel_err=sweep, sweep_failed=failed,
        sweep_batch=LAYER_BATCH, sweep_inputs=LAYER_INPUTS,
        step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
        images_per_s=V["batch"] / step, peak_gib=peak,
        launches_per_step=prof["launches"],
        device_ms_per_step=prof["device_ms"],
        device_ms_by_kind=prof["device_ms_by_kind"],
        profiled_wall_ms=prof["wall_ms"], idle_share=prof["idle_share"],
        batch=V["batch"], size=V["size"], latent=V["latent"],
        losses=losses, **check, save_load_equal=same_after_load,
        launches=kernels.launch_counts(), card=smi_card())
    log("layers:", json.dumps(stats))
    recon = pred[:, :n]
    ok = (not failed and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0]
          and check["loss_rel_err"] <= VAE_TOL["losses"]
          and check["predict_rel_err"] <= VAE_TOL["predict"]
          and pred.shape == (V["batch"], n + 2 * V["latent"])
          and bool(np.isfinite(pred).all())
          and float(recon.min()) >= 0.0 and float(recon.max()) <= 1.0
          and same_after_load)
    return bool(ok), stats


def initial_weights(torch, TransformerLM, cfg):
    model = TransformerLM(**cfg, device="cuda", seed=0)
    return [p.detach().clone() for p in model.parameters()]


def accumulation_check(torch, TransformerLM, x, y):
    """At f32 and ACCUM_LAYERS layers, one ACCUM_OPTIMIZER step with
    accum_steps=2 and one with accum_steps=1, from the same seeded
    weights and batch: the losses within ACCUM_TOL["loss_rtol"], every
    weight within isclose(rtol, atol)."""
    cfg = dict(FULL, seq_len=TRAIN_SEQ, n_layers=ACCUM_LAYERS)
    runs = {}
    for accum in (1, MIXED_ACCUM):
        model = TransformerLM(**cfg, device="cuda", seed=0)
        model.compile(ACCUM_OPTIMIZER, "class_nll", accum_steps=accum)
        loss = model.fit(x, y, batch_size=len(x))["loss"]
        runs[accum] = (loss, [p.detach().clone()
                              for p in model.parameters()])
        del model
    (l1, w1), (l2, w2) = runs[1], runs[MIXED_ACCUM]
    loss_err = abs(l2[0] - l1[0]) / abs(l1[0])
    bad = sum(int((~torch.isclose(b, a, rtol=ACCUM_TOL["rtol"],
                                  atol=ACCUM_TOL["atol"])).sum())
              for a, b in zip(w1, w2))
    weight_err = max(float((b - a).abs().max()) for a, b in zip(w1, w2))
    moved = max(float((a - b).abs().max())
                for a, b in zip(w1, initial_weights(torch, TransformerLM,
                                                    cfg)))
    stats = dict(losses={"accum_1": l1, f"accum_{MIXED_ACCUM}": l2},
                 loss_rel_err=loss_err, weights_outside_tol=bad,
                 weight_max_abs_err=weight_err,
                 largest_weight_move=moved, optimizer=ACCUM_OPTIMIZER,
                 tol=ACCUM_TOL)
    # the step must move the weights well past the bound, or the
    # comparison says nothing
    ok = (len(l1) == len(l2) == 1 and loss_err <= ACCUM_TOL["loss_rtol"]
          and bad == 0 and moved > 10 * ACCUM_TOL["atol"])
    return ok, stats


def phase_mixed(torch, TransformerLM, kernels, f32_losses):
    """The train phase's model and data at bf16 compute with
    MIXED_ACCUM microbatches a step: a warm-up fit, then TRAIN_STEPS
    synchronised one-step fits with the launch counts by dtype read
    around them; then the accumulation check at f32."""
    import statistics
    import numpy as np
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                  compute_dtype=torch.bfloat16, accum_steps=MIXED_ACCUM)
    x, y = periodic_tokens(TRAIN_BATCH * (TRAIN_STEPS + 1),
                           cfg["vocab_size"], TRAIN_SEQ, seed=1)
    model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH], batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    log(f"mixed: model built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(1, TRAIN_STEPS + 1):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        t = time.perf_counter()
        hist = model.fit(x[rows], y[rows], batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses += hist["loss"]
    counts = kernels.launch_counts_by_dtype()
    by_design = kernels.launch_counts_by_design()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    adam = model.trainer.state.opt_state.states[0]
    f32_state = (all(p.dtype == torch.float32 for p in model.parameters())
                 and all(t.dtype == torch.float32
                         for t in adam["mu"] + adam["nu"]))
    step = statistics.median(step_s)
    per_step = cfg["n_layers"] * MIXED_ACCUM
    stats = dict(step_ms=step * 1e3, step_ms_all=[t * 1e3 for t in step_s],
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step,
                 peak_gib=peak_gib, losses=losses, f32_losses=f32_losses,
                 launches=counts, launches_by_design=by_design,
                 launches_per_step={n: c / TRAIN_STEPS
                                    for n, c in counts.items()},
                 f32_master_weights_and_moments=f32_state,
                 accum_steps=MIXED_ACCUM, card=smi_card())
    del model, adam
    torch.cuda.empty_cache()
    ok = (len(losses) == TRAIN_STEPS
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0] and f32_state)
    for name in KERNELS:
        if (counts[f"{name}[bf16]"] < per_step * TRAIN_STEPS
                or counts[f"{name}[f32]"]):
            ok = False
            log(f"mixed: FAIL {name} launched {counts[f'{name}[bf16]']} "
                f"times at bf16 and {counts[f'{name}[f32]']} at f32 in "
                f"{TRAIN_STEPS} steps, expected >= {per_step} a step at "
                "bf16 and none at f32")
    if not f32_losses or len(f32_losses) != len(losses) or not np.allclose(
            losses, f32_losses, **MIXED_LOSS_TOL):
        ok = False
        log(f"mixed: FAIL losses {losses} do not track the train phase's "
            f"f32 losses {f32_losses} within {MIXED_LOSS_TOL}")
    rows = slice(TRAIN_BATCH, 2 * TRAIN_BATCH)
    accum_ok, stats["accumulation"] = accumulation_check(
        torch, TransformerLM, x[rows], y[rows])
    log("mixed:", json.dumps(stats))
    return bool(ok and accum_ok), stats


# the resume phase: the train phase's model and plan with dropout 0.1,
# 6 batches an epoch, 8 steps; snapshots every 2 steps, tag 6 corrupted
# after its commit and a SIGKILL after step 7 in the first incarnation
RESUME = dict(batch=8, batches_per_epoch=6, steps=8, lr=3e-4, dropout=0.1,
              every=2, corrupt_tag=6, crash_step=7, async_every=4,
              restore_tag=4)
REMAT_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_remat.py's

#: the worker of the resume phase, run as its own process (the
#: supervisor's incarnations): ``python worker.py REPO MODE OUT``
RESUME_WORKER = r"""
import json, os, sys, time
t_script = time.time()
repo, mode, out = sys.argv[1:4]
sys.path.insert(0, repo)
import torch
from analytics_zoo_tpu_torch.data.dataset import Dataset
from analytics_zoo_tpu_torch.models import TransformerLM
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.train import checkpoint, faults, triggers
from chip_smoke import FULL, RESUME, TRAIN_SEQ, periodic_tokens
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t_import = time.time()
R = RESUME
cfg = dict(FULL, seq_len=TRAIN_SEQ, dropout=R["dropout"])
lm = TransformerLM(**cfg, device="cuda", seed=0)
lm.compile({"name": "adam", "lr": R["lr"]}, "class_nll")
tr = lm.trainer
tr.ensure_initialized()
x, y = periodic_tokens(R["batch"] * R["batches_per_epoch"],
                       cfg["vocab_size"], TRAIN_SEQ, seed=2)
ds = Dataset.from_ndarray(x, y)
torch.cuda.synchronize()
t_built = time.time()
timing = {"restore_s": 0.0, "verify_s": 0.0, "copy_s": [], "write_s": [],
          "commit_s": []}


def timed(key, fn, append=False):
    def wrapped(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            dt = time.perf_counter() - t
            if append:
                timing[key].append(dt)
            else:
                timing[key] += dt
    return wrapped


def deep_only(fn):
    def wrapped(d, tag, deep=False):
        if not deep:
            return fn(d, tag, deep)
        t = time.perf_counter()
        try:
            return fn(d, tag, deep)
        finally:
            timing["verify_s"] += time.perf_counter() - t
    return wrapped


checkpoint.verify_commit = deep_only(checkpoint.verify_commit)
checkpoint._snapshot_shards = timed("copy_s", checkpoint._snapshot_shards,
                                    True)
checkpoint._write_shards = timed("write_s", checkpoint._write_shards, True)
checkpoint._commit_sharded = timed("commit_s", checkpoint._commit_sharded,
                                   True)
tr.load_weights = timed("restore_s", tr.load_weights)


real_fault = faults.maybe_fault


def reporting_fault(step):
    # each completed step, reported before the fault hook may kill us
    torch.cuda.synchronize()
    print("STEP", json.dumps({
        "step": step, "launches": _kernels.launch_counts(),
        "launches_by_design": _kernels.launch_counts_by_design()}),
        flush=True)
    real_fault(step)


faults.maybe_fault = reporting_fault


class Clock(triggers.Trigger):
    # an end trigger that stops at ``last`` and stamps each step's end
    def __init__(self, last):
        self.last, self.stamps = last, []

    def __call__(self, record):
        if "loss" in record:
            torch.cuda.synchronize()
            self.stamps.append((record["iteration"], time.time()))
        return record["iteration"] >= self.last


def fit(last):
    clock = Clock(last)
    t = time.time()
    tr.fit(ds, R["batch"], end_trigger=clock)
    torch.cuda.synchronize()
    return t, clock.stamps


res = {"mode": mode, "import_s": t_import - t_script,
       "build_s": t_built - t_import, "t_script": t_script}
if mode == "async":
    fit(1)  # warm-up
    for every in (None, R["async_every"]):
        if every:
            tr.set_checkpoint(out, trigger=triggers.SeveralIteration(every))
        start = tr.state.step
        _kernels.reset_launch_counts()
        t0, stamps = fit(start + R["steps"])
        checkpoint.wait_pending(out)
        times = [b - a for a, b in zip([t0] + [t for _, t in stamps],
                                       [t for _, t in stamps])]
        key = "async" if every else "none"
        res[key] = {"step_s": times, "steps": [s for s, _ in stamps],
                    "launches": _kernels.launch_counts()}
    tag = tr.state.step - tr.state.step % R["async_every"]  # the last
    t = time.perf_counter()
    ok, why = checkpoint.verify_commit(out, tag, deep=True)
    res["deep_verify_s"] = time.perf_counter() - t
    res["deep_verify_ok"] = ok
    res["snapshot_bytes"] = sum(
        os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)
        if f.startswith(f"ckpt_{tag}."))
else:
    if mode in ("crash", "resume"):
        tr.set_checkpoint(out, trigger=triggers.SeveralIteration(R["every"]))
    _kernels.reset_launch_counts()
    t0, stamps = fit(R["steps"])
    res.update(steps=[s for s, _ in stamps], t_fit=t0,
               t_first_step=stamps[0][1] if stamps else None,
               launches=_kernels.launch_counts(),
               launches_by_design=_kernels.launch_counts_by_design(),
               final_step=tr.state.step)
    if mode == "full":
        tr.save_weights(out, "final")
    from analytics_zoo_tpu_torch.train import metrics
    res["ckpt_restores"] = metrics.snapshot()["ckpt_restores"]
res.update(timing)
print("RESUME_WORKER", json.dumps(res), flush=True)
"""


def run_worker(tmp, mode, out, env=None, timeout=600):
    """One incarnation of the resume worker: (returncode, its result or
    None, its last STEP record, wall s from its start)."""
    path = os.path.join(tmp, "resume_worker.py")
    with open(path, "w") as f:
        f.write(RESUME_WORKER)
    repo = os.path.dirname(os.path.abspath(__file__))
    full_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("ZOO_RESUME", "ZOO_FAULT_",
                                     "ZOO_CKPT_SYNC", "ZOO_RESTART"))}
    full_env["PYTHONPATH"] = repo
    full_env.update(env or {})
    t = time.time()
    proc = subprocess.run([sys.executable, path, repo, mode, out],
                          env=full_env, capture_output=True, text=True,
                          timeout=timeout)
    result, last_step = None, None
    for line in proc.stdout.splitlines():
        if line.startswith("RESUME_WORKER "):
            result = json.loads(line[len("RESUME_WORKER "):])
        elif line.startswith("STEP "):
            last_step = json.loads(line[len("STEP "):])
    if proc.returncode not in (0, -9) or result is None and \
            proc.returncode == 0:
        log(f"resume: worker {mode} rc {proc.returncode}\n"
            f"{proc.stderr[-3000:]}")
    if result is not None:
        result["t_spawn"] = t
    return proc.returncode, result, last_step, time.time() - t


def state_diff(dir_a, tag_a, dir_b, tag_b):
    """Two saved training states (sharded, one process) leaf by leaf:
    (leaves that differ, largest |a - b| over the largest |a| of its
    leaf, names compared)."""
    import numpy as np

    def load(d, tag):
        with open(os.path.join(d, f"ckpt_{tag}.json")) as f:
            names = json.load(f)["names"]
        return names, np.load(os.path.join(d, f"ckpt_{tag}.shard-p0.npz"))

    na, fa = load(dir_a, tag_a)
    nb, fb = load(dir_b, tag_b)
    ia = {n: i for i, n in enumerate(na)}
    ib = {n: i for i, n in enumerate(nb)}
    keys_a = {int(k.split("|")[0]): k for k in fa.files}
    keys_b = {int(k.split("|")[0]): k for k in fb.files}
    differ, worst = [], 0.0
    try:
        for name in sorted(set(ia) | set(ib)):
            if name not in ia or name not in ib:
                differ.append(name)
                worst = math.inf
                continue
            a = fa[keys_a[ia[name]]]
            b = fb[keys_b[ib[name]]]
            if not np.array_equal(a, b):
                differ.append(name)
                scale = float(np.abs(a.astype(np.float64)).max()) or 1.0
                worst = max(worst, float(np.abs(
                    a.astype(np.float64) - b).max()) / scale)
    finally:
        fa.close()
        fb.close()
    return differ, worst, len(set(ia) | set(ib))


def remat_check(torch, TransformerLM, kernels):
    """One forward and backward of the full-width train model with and
    without remat on every attention and MLP sublayer, same weights and
    batch, dropout 0: peak GiB, ms, flash_fwd launches, and the largest
    gradient difference."""
    import numpy as np
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    x, y = periodic_tokens(RESUME["batch"], cfg["vocab_size"], TRAIN_SEQ,
                           seed=3)
    ids = torch.as_tensor(x, device="cuda")
    labels = torch.as_tensor(y, device="cuda")
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    out, grads = {}, {}
    for remat in (False, True):
        model = TransformerLM(**cfg, remat=remat, device="cuda",
                              seed=0).train()
        params = list(model.parameters())

        def step():
            loss = objectives.class_nll(labels, model(ids)).mean()
            return torch.autograd.grad(loss, params)

        step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        g = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        key = "remat" if remat else "plain"
        out[key] = dict(step_ms=ms,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        launches=kernels.launch_counts(),
                        launches_by_design=kernels.launch_counts_by_design())
        grads[key] = [t.detach().cpu().numpy() for t in g]
        del model, params, g
        torch.cuda.empty_cache()
    worst, bad = 0.0, 0
    for a, b in zip(grads["plain"], grads["remat"]):
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        bad += int(not np.all(d <= REMAT_TOL["atol"]
                              + REMAT_TOL["rtol"] * np.abs(a)))
    out.update(grad_max_abs_diff=worst, grad_tensors_off_tol=bad,
               grad_tensors=len(grads["plain"]))
    return out


def phase_resume(torch, TransformerLM, kernels, tmp):
    """Crash and resume at full width through the supervisor's
    environment contract; the cost of asynchronous snapshots; remat."""
    import gc
    import signal
    R = RESUME
    n_layers = FULL["n_layers"]
    stats = {"card": smi_card()}
    ok = True
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(tmp, "resume")
    dirs = {k: os.path.join(root, k) for k in ("full_a", "full_b", "ckpt",
                                               "async", "flightrec")}
    try:
        runs = {}
        for key in ("full_a", "full_b"):
            rc, res, _, wall = run_worker(tmp, "full", dirs[key])
            runs[key] = res
            ok &= rc == 0 and res is not None
            if not ok:
                return False, stats
        differ, spread, n = state_diff(dirs["full_a"], "final",
                                       dirs["full_b"], "final")
        stats["uninterrupted_runs_differ"] = len(differ)
        stats["uninterrupted_spread"] = spread
        shutil.rmtree(dirs["full_b"])
        env1 = {"ZOO_CKPT_SYNC": "1",
                "ZOO_FAULT_CORRUPT_TAG": str(R["corrupt_tag"]),
                "ZOO_FAULT_CRASH_STEP": str(R["crash_step"]),
                "ZOO_FAULT_CRASH_RANK": "0",
                "ZOO_FLIGHTREC_DIR": dirs["flightrec"]}
        rc1, res1, last1, wall1 = run_worker(tmp, "crash", dirs["ckpt"],
                                             env1)
        killed = rc1 == -signal.SIGKILL
        # the supervisor's post-mortem of the SIGKILLed incarnation, from
        # its flight recorder
        from analytics_zoo_tpu_torch.observability import flightrec
        pm = flightrec.write_postmortem(
            dirs["flightrec"], os.path.join(root, "pod_postmortem.json"),
            reason="exit", failed_rank=0, incarnation=0,
            supervisor={0: {"rc": rc1}})
        pm_rank = pm["ranks"].get("0") or {}
        stats["postmortem"] = dict(
            last_step=pm_rank.get("last_step"), rc=pm_rank.get("rc"),
            heartbeats=[h["step"] for h in pm_rank.get("heartbeats", [])],
            meta={k: (pm_rank.get("meta") or {}).get(k)
                  for k in ("torch", "cuda", "device")})
        if pm_rank.get("last_step") != R["crash_step"]:
            log(f"resume: FAIL the post-mortem names step "
                f"{pm_rank.get('last_step')} as the last completed, "
                f"expected {R['crash_step']}")
            ok = False
        stats["incarnation1"] = dict(rc=rc1, last_step=(last1 or {}).get(
            "step"), launches=(last1 or {}).get("launches"),
            launches_by_design=(last1 or {}).get("launches_by_design"),
            wall_s=wall1,
            tags=sorted(f for f in os.listdir(dirs["ckpt"])
                        if f.endswith(".commit.json")))
        if not killed or (last1 or {}).get("step") != R["crash_step"]:
            log(f"resume: FAIL incarnation 1 ended rc {rc1} after step "
                f"{(last1 or {}).get('step')}, expected SIGKILL after "
                f"{R['crash_step']}")
            ok = False
        env2 = {"ZOO_CKPT_SYNC": "1", "ZOO_RESUME": "1",
                "ZOO_RESTART_COUNT": "1"}
        rc2, res2, _, wall2 = run_worker(tmp, "resume", dirs["ckpt"], env2)
        if rc2 != 0 or res2 is None:
            log(f"resume: FAIL incarnation 2 rc {rc2}")
            return False, stats
        to_script = res2["t_script"] - res2["t_spawn"]
        restore_s = res2["restore_s"]
        first_step = res2["t_first_step"] - res2["t_fit"] - restore_s
        stats["incarnation2"] = dict(
            rc=rc2, steps=res2["steps"], replayed=len(res2["steps"]),
            final_step=res2["final_step"], launches=res2["launches"],
            restores=res2["ckpt_restores"], wall_s=wall2,
            spawn_to_script_s=to_script, import_s=res2["import_s"],
            build_s=res2["build_s"], restore_s=restore_s,
            deep_verify_s=res2["verify_s"], first_step_s=first_step,
            to_first_resumed_step_s=res2["t_first_step"] - res2["t_spawn"])
        want_steps = list(range(R["restore_tag"] + 1, R["steps"] + 1))
        if res2["steps"] != want_steps or res2["ckpt_restores"] != {
                "corrupt_discarded": 1, "ok": 1}:
            log(f"resume: FAIL incarnation 2 replayed {res2['steps']} "
                f"(expected {want_steps}) with restores "
                f"{res2['ckpt_restores']}")
            ok = False
        differ, err, n = state_diff(dirs["full_a"], "final", dirs["ckpt"],
                                    R["steps"])
        stats["resumed_vs_uninterrupted"] = dict(
            leaves=n, differ=len(differ), max_rel_err=err)
        if differ and not (stats["uninterrupted_runs_differ"]
                           and err <= 2 * stats["uninterrupted_spread"]):
            log(f"resume: FAIL the resumed state differs from the "
                f"uninterrupted run in {len(differ)} of {n} leaves "
                f"(max rel err {err:.3g}; two uninterrupted runs: "
                f"{stats['uninterrupted_runs_differ']} leaves, "
                f"{stats['uninterrupted_spread']:.3g})")
            ok = False
        launch_runs = {"uninterrupted": runs["full_a"]["launches"],
                       "incarnation1": stats["incarnation1"]["launches"]
                       or {}, "incarnation2": res2["launches"]}
        design_runs = {
            "uninterrupted": runs["full_a"].get("launches_by_design") or {},
            "incarnation1": stats["incarnation1"]["launches_by_design"]
            or {}, "incarnation2": res2.get("launches_by_design") or {}}
        for run, counts in launch_runs.items():
            steps = (R["steps"] if run == "uninterrupted"
                     else R["crash_step"] if run == "incarnation1"
                     else len(want_steps))
            for name in KERNELS:
                if counts.get(name, 0) < n_layers * steps:
                    log(f"resume: FAIL {run}: {name} launched "
                        f"{counts.get(name, 0)} times in {steps} steps")
                    ok = False
            # the workers train at f32, d = 64: every backward on sm90
            for name in BWD_KERNELS:
                by = design_runs[run]
                if by.get(f"{name}[f32,base]", 0) or not by.get(
                        f"{name}[f32,sm90]", 0):
                    mine = {k: n for k, n in by.items()
                            if k.startswith(name + "[")}
                    log(f"resume: FAIL {run}: {name} launches by design "
                        f"{json.dumps(mine)}")
                    ok = False
        stats["launches"] = launch_runs
        stats["launches_by_design"] = design_runs
        shutil.rmtree(dirs["full_a"])
        shutil.rmtree(dirs["ckpt"])

        rc3, res3, _, _ = run_worker(tmp, "async", dirs["async"])
        if rc3 != 0 or res3 is None:
            log(f"resume: FAIL async worker rc {rc3}")
            return False, stats
        import statistics
        none_ms = [t * 1e3 for t in res3["none"]["step_s"]]
        async_ms = [t * 1e3 for t in res3["async"]["step_s"]]
        snap_steps = [i for i, s in enumerate(res3["async"]["steps"])
                      if s % R["async_every"] == 0]
        stats["async"] = dict(
            step_ms_none=statistics.median(none_ms),
            step_ms_async=statistics.median(async_ms),
            step_ms_none_all=none_ms, step_ms_async_all=async_ms,
            snapshot_step_ms=[async_ms[i] for i in snap_steps],
            copy_block_ms=[t * 1e3 for t in res3["copy_s"]],
            write_s=res3["write_s"], commit_s=res3["commit_s"],
            snapshot_bytes=res3["snapshot_bytes"],
            deep_verify_s=res3["deep_verify_s"])
        ok &= bool(res3["deep_verify_ok"])
        shutil.rmtree(dirs["async"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    stats["remat"] = remat_check(torch, TransformerLM, kernels)
    rm = stats["remat"]
    fwd = rm["remat"]["launches"]["flash_fwd"]
    if fwd != 2 * n_layers or rm["plain"]["launches"]["flash_fwd"] != \
            n_layers:
        log(f"resume: FAIL flash_fwd launched {fwd} times a remat step "
            f"(expected {2 * n_layers})")
        ok = False
    if rm["grad_tensors_off_tol"]:
        log(f"resume: FAIL {rm['grad_tensors_off_tol']} remat gradients "
            f"off the plain ones beyond {REMAT_TOL}")
        ok = False
    log("resume:", json.dumps(stats))
    return bool(ok), stats


def parallel_fit(torch, TransformerLM, kernels, x, y, **compile_kw):
    """The train plan from seed 0: a warm-up fit and TRAIN_STEPS
    one-step fits, each synchronised; (model, losses, step seconds,
    launches over the timed steps, the same by design, peak GiB)."""
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                  **compile_kw)
    losses = model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH],
                       batch_size=TRAIN_BATCH)["loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_s = []
    for i in range(1, TRAIN_STEPS + 1):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        t = time.perf_counter()
        losses += model.fit(x[rows], y[rows], batch_size=TRAIN_BATCH)["loss"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    return (model, losses, step_s, kernels.launch_counts(),
            kernels.launch_counts_by_design(),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_parallel(torch, TransformerLM, kernels, tmp):
    """The parallel strategies on a world of one: an NCCL group and a
    six-axis mesh, the train plan under fsdp_tp against the plain
    Trainer (bit for bit), the sharded save restored onto the mesh, the
    ring layer against the flash kernels, moe_sharded against
    switch_moe."""
    import statistics
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.expert import (
        init_moe_params, moe_sharded, switch_moe)
    from analytics_zoo_tpu_torch.parallel.sharding import spec_to_placements
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        MultiHeadSelfAttention)
    from analytics_zoo_tpu_torch.train import checkpoint

    stats = dict(card=smi_card())
    mesh = mesh_lib.create_mesh({a: 1 for a in mesh_lib.AXES},
                                device="cuda")
    try:
        probe = torch.ones(4, device="cuda")
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        stats["backend"] = dist.get_backend()
        stats["mesh"] = mesh_lib.axis_sizes(mesh)
        ok = (stats["backend"] == "nccl" and float(probe.sum()) == 4.0
              and tuple(mesh.mesh_dim_names) == mesh_lib.AXES)
        x, y = periodic_tokens(TRAIN_BATCH * (TRAIN_STEPS + 1),
                               FULL["vocab_size"], TRAIN_SEQ, seed=1)
        plain, plain_losses, plain_s, plain_counts, _, plain_peak = \
            parallel_fit(torch, TransformerLM, kernels, x, y)
        plain_w = {n: p.detach().cpu() for n, p in plain.named_parameters()}
        del plain
        torch.cuda.empty_cache()
        model, losses, step_s, counts, by_design, peak = parallel_fit(
            torch, TransformerLM, kernels, x, y, mesh=mesh,
            strategy="fsdp_tp", tp_rules=PARALLEL_RULES)
        plan = model.trainer.state.plan
        stats["split_leaves"] = sum(any(e is not None for e in s)
                                    for s in plan.specs)
        log(f"parallel: {len(plan.specs)} leaves under fsdp_tp on "
            f"{stats['mesh']}: every axis has size 1, so every rule table "
            f"replicates every leaf ({stats['split_leaves']} split)")
        same_w = [n for n, p in model.named_parameters()
                  if torch.equal(p.detach().cpu(), plain_w[n])]
        stats["fit_bitwise"] = (losses == plain_losses
                                and len(same_w) == len(plain_w))
        stats.update(
            losses=losses, plain_losses=plain_losses,
            weights_equal=f"{len(same_w)}/{len(plain_w)}",
            sharded_step_ms=statistics.median(step_s) * 1e3,
            plain_step_ms=statistics.median(plain_s) * 1e3,
            sharded_step_ms_all=[t * 1e3 for t in step_s],
            plain_step_ms_all=[t * 1e3 for t in plain_s],
            sharded_peak_gib=peak, plain_peak_gib=plain_peak,
            launches=counts, launches_by_design=by_design,
            plain_launches=plain_counts)
        stats["step_ratio"] = (stats["sharded_step_ms"]
                               / stats["plain_step_ms"])
        ok &= stats["fit_bitwise"]
        for name in KERNELS:
            if counts[name] != FULL["n_layers"] * TRAIN_STEPS:
                ok = False
                log(f"parallel: FAIL {name} launched {counts[name]} times "
                    f"in {TRAIN_STEPS} sharded steps, expected "
                    f"{FULL['n_layers']} a step")
        # the sharded save, restored onto the mesh into a fresh model
        ckpt = os.path.join(tmp, "parallel_ckpt")
        model.trainer.save_weights(ckpt)
        other = TransformerLM(**dict(FULL, seq_len=TRAIN_SEQ),
                              device="cuda", seed=1)
        other.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll",
                      mesh=mesh, strategy="fsdp_tp",
                      tp_rules=PARALLEL_RULES)
        other.trainer.load_weights(ckpt)
        want = checkpoint.flatten(model.trainer.state_tree())
        got = checkpoint.flatten(other.trainer.state_tree())
        placed = [l for _, l in got if isinstance(l, DTensor)]
        specs = {tuple(spec_to_placements(s, mesh)) for s in plan.specs}
        equal = sum(
            (a.to_local().equal(b.to_local()) if isinstance(a, DTensor)
             else bool(np.array_equal(np.asarray(a), np.asarray(b))))
            for (_, a), (_, b) in zip(got, want))
        stats["restore_bitwise"] = equal == len(want)
        stats["restore"] = dict(leaves=len(want), equal=equal,
                                dtensor_leaves=len(placed),
                                placements_as_rules=all(
                                    tuple(l.placements) in specs
                                    for l in placed))
        ok &= (stats["restore_bitwise"] and len(placed) > 0
               and stats["restore"]["placements_as_rules"]
               and other.trainer.state.step == model.trainer.state.step)
        del model, other
        torch.cuda.empty_cache()
        ok &= parallel_ring(torch, MultiHeadSelfAttention, mesh_lib, mesh,
                            stats)
        # moe_sharded on an expert axis of one is switch_moe
        g = torch.Generator("cuda").manual_seed(0)
        d = FULL["d_model"]
        params = init_moe_params(g, d, 4 * d, PARALLEL["moe_experts"])
        xt = torch.randn((PARALLEL["moe_tokens"], d), generator=g,
                         device="cuda")
        got_moe, want_moe = moe_sharded(xt, params, mesh), switch_moe(
            xt, params)
        stats["moe_equal"] = bool(torch.equal(got_moe[0], want_moe[0])
                                  and torch.equal(got_moe[1], want_moe[1]))
        ok &= stats["moe_equal"]
    finally:
        mesh_lib.set_default_mesh(None)
        dist.destroy_process_group()
    log("parallel:", json.dumps(stats))
    return bool(ok), stats


def parallel_ring(torch, MultiHeadSelfAttention, mesh_lib, mesh, stats):
    """The ring layer on the seq axis against the same weights through
    the flash kernels: values and input and weight gradients over their
    largest entry."""
    d, heads = FULL["d_model"], FULL["n_heads"]
    shape = (PARALLEL["ring_batch"], TRAIN_SEQ, d)
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(shape, generator=g, device="cuda")
    w = torch.randn(shape, generator=g, device="cuda")
    layers = [MultiHeadSelfAttention(heads, causal=True, implementation=impl,
                                     input_shape=shape[1:], device="cuda",
                                     generator=torch.Generator(
                                         "cuda").manual_seed(3))
              for impl in ("ring", "flash")]
    outs, grads = [], []
    with mesh_lib.active_mesh(mesh):
        for layer in layers:
            xi = x.clone().requires_grad_(True)
            out = layer(xi)
            params = [xi] + [getattr(layer, n) for n in ("Wq", "Wk", "Wv",
                                                          "Wo")]
            grads.append(torch.autograd.grad((out * w).sum(), params))
            outs.append(out.detach())
    stats["ring_rel_err"] = max_entry_err(outs[0], outs[1])
    stats["ring_grad_rel_err"] = max(max_entry_err(a, b)
                                     for a, b in zip(*grads))
    log(f"parallel: ring layer against flash, values "
        f"{stats['ring_rel_err']:.3g} (tol {PARALLEL_TOL['ring']}), "
        f"gradients {stats['ring_grad_rel_err']:.3g} "
        f"(tol {PARALLEL_TOL['ring_grad']})")
    return (stats["ring_rel_err"] <= PARALLEL_TOL["ring"]
            and stats["ring_grad_rel_err"] <= PARALLEL_TOL["ring_grad"])


# the observe phase: the train plan's 4-step fits with the step profiler
# and flight recorder off and on, in turns; then a traced serve
OBSERVE = dict(runs=3, steps=4, profile_steps=2, requests=8, threads=4,
               max_new=(8, 16, 32, 64), gap_ms=1e-3)
OBSERVE_PREDICT_PHASES = ["coalesce_wait", "pad", "device_put", "execute",
                          "depad"]
OBSERVE_DECODE_PHASES = ["decode_wait", "prefill", "decode_step"]


def observe_fits(torch, TransformerLM, kernels, tmp):
    """The train plan from one set of weights: a warm-up fit, then
    OBSERVE["runs"] pairs of 4-step fits, untraced and traced in turns
    (the step profiler with its timeline and the flight recorder), each
    timed by CUDA events around the whole fit; then one fit under
    ``set_tensorboard(profile=True)``.  Returns (ok, stats)."""
    import gc
    import statistics
    from analytics_zoo_tpu_torch.observability import (
        flightrec, parse_prometheus_text, render_prometheus)
    from analytics_zoo_tpu_torch.train import metrics as train_metrics
    steps = OBSERVE["steps"]
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    model = TransformerLM(**cfg, device="cuda", seed=0)
    init = [p.detach().clone() for p in model.parameters()]
    x, y = periodic_tokens(TRAIN_BATCH * steps, cfg["vocab_size"],
                           TRAIN_SEQ, seed=1)
    root = os.path.join(tmp, "observe")
    ok, stats, runs = True, {}, []

    def fresh():
        with torch.no_grad():
            for p, v in zip(model.parameters(), init):
                p.copy_(v)
        model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll")
        gc.collect()
        return model.trainer

    def one_fit(traced, i):
        tr = fresh()
        prof = recorder = None
        if traced:
            prof = tr.enable_step_profiler(
                os.path.join(root, f"timeline{i}.jsonl"))
            recorder = flightrec.configure(os.path.join(root, f"fr{i}"),
                                           rank=0, incarnation=0)
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        try:
            start.record()
            hist = model.fit(x, y, batch_size=TRAIN_BATCH, shuffle=False)
            end.record()
            torch.cuda.synchronize()
        finally:
            if traced:
                flightrec.shutdown()
        run = dict(traced=traced, losses=hist["loss"],
                   step_ms=start.elapsed_time(end) / steps,
                   launches=kernels.launch_counts(),
                   launches_by_design=kernels.launch_counts_by_design(),
                   weights=[p.detach().clone() for p in model.parameters()])
        if traced:
            with open(prof.timeline_path) as f:
                run["timeline"] = [json.loads(ln) for ln in f]
            run["harvest"] = flightrec.harvest(
                os.path.join(root, f"fr{i}"))
            run["families"] = parse_prometheus_text(render_prometheus(
                train_metrics.train_families() + prof.families()))
        return run

    try:
        os.makedirs(root, exist_ok=True)
        one_fit(False, -1)  # warm-up
        for i in range(OBSERVE["runs"]):
            for traced in (False, True):
                runs.append(one_fit(traced, i))
        off = [r for r in runs if not r["traced"]]
        on = [r for r in runs if r["traced"]]
        ref = off[0]
        stats["step_ms_off"] = [r["step_ms"] for r in off]
        stats["step_ms_on"] = [r["step_ms"] for r in on]
        med_off = statistics.median(stats["step_ms_off"])
        med_on = statistics.median(stats["step_ms_on"])
        stats["step_ms_off_median"], stats["step_ms_on_median"] = (
            med_off, med_on)
        # the JAX drill's ratio: the traced step rate over the untraced
        stats["rate_ratio_on_off"] = med_off / med_on
        bits = all(r["losses"] == ref["losses"]
                   and all(torch.equal(a, b)
                           for a, b in zip(r["weights"], ref["weights"]))
                   for r in runs)
        stats["bitwise"] = bits
        if not bits:
            log("observe: FAIL traced and untraced fits differ")
            ok = False
        per_step = [{k: c / steps for k, c in r["launches"].items()}
                    for r in runs]
        stats["launches_per_step"] = per_step[1]
        stats["launches"] = on[0]["launches"]
        stats["launches_by_design"] = on[0]["launches_by_design"]
        for r in runs:
            for name in KERNELS:
                if r["launches"].get(name, 0) != cfg["n_layers"] * steps:
                    log(f"observe: FAIL {name} launched "
                        f"{r['launches'].get(name, 0)} times in {steps} "
                        f"{'traced' if r['traced'] else 'untraced'} steps")
                    ok = False
        keys = [f"{p}_ms" for p in ("data_wait", "h2d", "grad_accum",
                                    "step_compute", "ckpt_save")]
        for r in on:
            rows = r["timeline"]
            if [e["step"] for e in rows] != list(range(1, steps + 1)) \
                    or not all(k in e for e in rows for k in keys):
                log(f"observe: FAIL timeline {rows}")
                ok = False
            h = r["harvest"].get(0) or {}
            if h.get("last_step") != steps or len(h.get("steps", [])) \
                    != steps:
                log(f"observe: FAIL flight recorder {h.get('last_step')}, "
                    f"{len(h.get('steps', []))} step entries")
                ok = False
            samples = r["families"]["samples"]
            if samples.get(("zoo_train_step_seconds_count",
                            (("phase", "step_compute"),))) != steps \
                    or not any(k[0] == "zoo_train_steps_total"
                               for k in samples):
                log("observe: FAIL step families")
                ok = False
        stats["timeline_step_compute_ms"] = [
            e["step_compute_ms"] for e in on[-1]["timeline"]]
        stats["timeline_data_wait_ms"] = [
            e["data_wait_ms"] for e in on[-1]["timeline"]]
        stats["timeline_h2d_ms"] = [e["h2d_ms"] for e in on[-1]["timeline"]]

        # one torch.profiler trace of the first steps of a fit
        tr = fresh()
        tr.set_tensorboard(root, "profiled", profile=True,
                           profile_steps=OBSERVE["profile_steps"])
        model.fit(x, y, batch_size=TRAIN_BATCH, shuffle=False)
        found = sorted(
            os.path.join(d, f)
            for d, _, files in os.walk(os.path.join(root, "profiled",
                                                    "plugins", "profile"))
            for f in files if f.endswith(".pt.trace.json"))
        names = set()
        if found:
            with open(found[0]) as f:
                events = json.load(f).get("traceEvents", [])
            names = {e.get("name", "") for e in events
                     if e.get("cat") == "kernel"}
        stats["profile_trace_files"] = len(found)
        stats["profile_kernel_names"] = len(names)
        # the forward's kernel is flash_fwd_sm90_kernel at d = 64
        stats["profile_hand_kernels"] = {
            k: sum(1 for n in names
                   if f"{k}_kernel" in n or f"{k}_sm90_kernel" in n)
            for k in KERNELS}
        if len(found) != 1 or not all(stats["profile_hand_kernels"]
                                      .values()):
            log(f"observe: FAIL profiler trace files {found}, hand kernels "
                f"{stats['profile_hand_kernels']}")
            ok = False
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del model, init, runs
        gc.collect()
        torch.cuda.empty_cache()
    return ok, stats


def span_medians(spans):
    """{phase: median ms} over finished span dicts."""
    import statistics
    by = {}
    for d in spans:
        for p in d["phases"]:
            by.setdefault(p["name"], []).append(p["dur_ms"])
    return {k: statistics.median(v) for k, v in by.items()}


def observe_serve(torch, TransformerLM, keras, kernels, inference):
    """A traced serve at the serve phase's settings: OBSERVE["requests"]
    generate requests from OBSERVE["threads"] threads, each under a span
    of its own, then the same requests untraced; then one traced
    coalesced LeNet predict.  Returns (ok, stats)."""
    import gc
    import itertools
    import threading
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer, profile
    handle_profile = profile.install()
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    model = TransformerLM(**cfg, device="cuda", seed=0).eval()
    handle = inference.InferenceModel(
        decode_capacity=SERVE["capacity"], decode_max_len=SERVE["max_len"],
        decode_prompt_buckets=SERVE["buckets"],
        decode_prefix_pool=SERVE["pool"])
    ok, stats = True, {}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg["vocab_size"], int(n)) for n in
               rng.integers(16, max(SERVE["buckets"]), OBSERVE["requests"])]
    news = [OBSERVE["max_new"][i % len(OBSERVE["max_new"])]
            for i in range(len(prompts))]
    tracer = Tracer(capacity=64)
    try:
        handle.load_keras_net(model)
        engine = handle.decode_engine
        compiles_warm = handle_profile.snapshot()["compiles"]

        def serve(traced):
            outs, errors = [None] * len(prompts), []

            def client(t):
                try:
                    for i in range(t, len(prompts), OBSERVE["threads"]):
                        if traced:
                            with tracer.request("generate", request=i):
                                outs[i] = handle.generate(
                                    [prompts[i]], news[i], timeout=120)[0]
                        else:
                            outs[i] = handle.generate(
                                [prompts[i]], news[i], timeout=120)[0]
                except Exception as e:  # re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(OBSERVE["threads"])]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            if errors:
                raise errors[0]
            return outs

        # traced first, on a prefix pool that has not seen the prompts:
        # every admission computes its prefill (a pool hit would copy the
        # prefix block and launch no kernel); the untraced pass after it
        # hits, and a hit gives a miss's stream
        before = engine.stats()
        kernels.reset_launch_counts()
        traced = serve(True)
        launches = kernels.launch_counts()
        after = engine.stats()
        plain = serve(False)
        admitted = after["admitted"] - before["admitted"]
        spans = [d for d in tracer.recent() if d["name"] == "generate"]
        gaps = [abs(a["start_ms"] + a["dur_ms"] - b["start_ms"])
                for d in spans for a, b in zip(d["phases"], d["phases"][1:])]
        chains = [[k for k, _ in itertools.groupby(
            p["name"] for p in d["phases"])] for d in spans]
        stats.update(
            requests=len(spans), admitted=admitted,
            flash_fwd_launches=launches.get("flash_fwd", 0),
            launches=launches,
            compiles_at_warmup=compiles_warm,
            compiles_after=handle_profile.snapshot()["compiles"],
            captures=after["captures"],
            max_gap_ms=max(gaps) if gaps else None,
            decode_phase_median_ms=span_medians(spans),
            coverage_min=min(d["coverage"] for d in spans) if spans
            else None,
            streams_equal=all(np.array_equal(a, b)
                              for a, b in zip(plain, traced)))
        checks = dict(
            chains=len(spans) == len(prompts)
            and all(c == OBSERVE_DECODE_PHASES for c in chains),
            gap_free=bool(gaps) and max(gaps) <= OBSERVE["gap_ms"],
            launches=admitted == len(prompts)
            and stats["flash_fwd_launches"] == cfg["n_layers"] * admitted,
            no_capture=stats["compiles_after"] == compiles_warm
            and after["captures"] == before["captures"],
            streams=stats["streams_equal"])
    finally:
        handle.close()
    del handle, model
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()

    net = build_lenet(keras, "cuda")
    coal = net.to_serving(supported_concurrent_num=2, max_batch_size=32,
                          coalescing=True, warmup_shapes=(28, 28, 1))
    try:
        x = rng.normal(size=(5, 28, 28, 1)).astype(np.float32)
        want = coal.predict(x)
        with tracer.request("predict") as span:
            got = coal.predict(x)
        d = span.to_dict()
    finally:
        coal.close()
    chain = [k for k, _ in itertools.groupby(p["name"]
                                             for p in d["phases"])]
    stats["predict_chain"] = chain
    stats["predict_phase_ms"] = {p["name"]: p["dur_ms"]
                                 for p in d["phases"]}
    stats["predict_bucket"] = d["labels"].get("bucket")
    checks["predict"] = (chain == OBSERVE_PREDICT_PHASES
                         and np.array_equal(got, want))
    stats["checks"] = checks
    for name, good in checks.items():
        if not good:
            log(f"observe: FAIL serve {name}")
            ok = False
    return ok, stats


def phase_observe(torch, TransformerLM, keras, kernels, inference, tmp):
    """Observability on the train and serve paths at full width: the
    step profiler and flight recorder's cost and neutrality, the
    torch.profiler trace, and traced generate and predict requests."""
    stats = {"card": smi_card()}
    ok_fit, stats["fit"] = observe_fits(torch, TransformerLM, kernels, tmp)
    ok_serve, stats["serve"] = observe_serve(torch, TransformerLM, keras,
                                             kernels, inference)
    fit, serve = stats["fit"], stats["serve"]
    stats.update(
        step_ms_off=fit.get("step_ms_off_median"),
        step_ms_on=fit.get("step_ms_on_median"),
        rate_ratio_on_off=fit.get("rate_ratio_on_off"),
        bitwise=fit.get("bitwise"),
        profile_hand_kernels=fit.get("profile_hand_kernels"),
        decode_phase_median_ms=serve.get("decode_phase_median_ms"),
        predict_chain=serve.get("predict_chain"),
        launches=fit.get("launches"),
        launches_by_design=fit.get("launches_by_design"))
    log("observe:", json.dumps(stats))
    return ok_fit and ok_serve, stats


# the control phase: the serving control plane on the serve phase's
# handle (full-width TransformerLM), three pageable ResNet-50s and a
# LeNet on two replicas of one card
CONTROL = dict(requests=16, threads=4, prompt=(16, 511), new=(8, 64),
               max_queue=16, max_concurrency=8, saturate=32,
               saturate_new=8, canary=0.25, canary_requests=40,
               reject_s=0.1, resnet_size=224, resnet_classes=1000,
               pager_rows=(1, 32), pager_resident=2, replica_threads=8,
               replica_requests=12, replica_rows=(1, 4),
               replica_bucket=32, hedge_delay_s=0.02, hedge_seed=40,
               hedge_requests=64, freed_share=0.95)


def control_swap(torch, TransformerLM, kernels, serving, inference):
    """(a) A hot swap under traffic and (b) admission on the registry's
    full-width TransformerLM: v1 (seed 0) deployed, each prompt's solo
    greedy stream from v1 and from v2 (seed 1) computed first, then
    CONTROL["threads"] clients cycle through CONTROL["requests"] prompts
    with generate_ex while v2 deploys, until v2 has served as many
    requests as there are prompts.  Then a saturating burst against the
    bounded queue.  Returns (checks, {"swap": ..., "admission": ...})."""
    import threading
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer
    C = CONTROL
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    engine_kw = dict(decode_capacity=SERVE["capacity"],
                     decode_max_len=SERVE["max_len"],
                     decode_prompt_buckets=SERVE["buckets"])
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg["vocab_size"], int(n))
               for n in rng.integers(C["prompt"][0], C["prompt"][1] + 1,
                                     C["requests"])]
    news = [int(n) for n in rng.integers(C["new"][0], C["new"][1] + 1,
                                         C["requests"])]
    v1 = TransformerLM(**cfg, device="cuda", seed=0).eval()
    v2 = TransformerLM(**cfg, device="cuda", seed=1).eval()
    tracer = Tracer(capacity=256)
    reg = serving.ModelRegistry(max_queue=C["max_queue"],
                                max_concurrency=C["max_concurrency"],
                                tracer=tracer)
    checks, stats = {}, {}
    try:
        reg.deploy("lm", v1, **engine_kw)
        solo = {1: [reg.generate("lm", [p], n)[0]
                    for p, n in zip(prompts, news)]}
        alone = inference.InferenceModel(**engine_kw).load_keras_net(v2)
        try:
            solo[2] = [alone.generate([p], n, timeout=120)[0]
                       for p, n in zip(prompts, news)]
        finally:
            alone.close()
        engine1 = reg._entry("lm").active.model.decode_engine
        admitted1 = engine1.stats()["admitted"]
        done, errors = [], []  # (prompt index, stream, info)
        go, stop = threading.Event(), threading.Event()

        def client(t):
            go.wait(10)
            i = t
            while not stop.is_set():
                k = i % len(prompts)
                try:
                    out, info = reg.generate_ex("lm", [prompts[k]],
                                                news[k])
                    done.append((k, out[0], info))
                except Exception as e:  # counted as a failed request
                    errors.append(f"{type(e).__name__}: {e}")
                i += C["threads"]

        def served_by(v):
            return sum(1 for _, _, info in done if info["version"] == v)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(C["threads"])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        go.set()
        # mid-traffic: once a quarter of the prompts came back
        while (len(done) < len(prompts) // 4 and not errors
               and time.perf_counter() - t0 < 120):
            time.sleep(0.005)
        t_deploy = time.time()
        try:
            reg.deploy("lm", v2, **engine_kw)
            swap_at = reg._entry("lm").active.deployed_at
            while (served_by(2) < len(prompts) and not errors
                   and time.perf_counter() - t0 < 300):
                time.sleep(0.005)
        finally:
            stop.set()
            for t in threads:
                t.join(300)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        engine2 = reg._entry("lm").active.model.decode_engine
        admitted = (engine1.stats()["admitted"] - admitted1
                    + engine2.stats()["admitted"])
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        versions = [info["version"] for _, _, info in done]
        own = [np.array_equal(out, solo[info["version"]][k])
               for k, out, info in done]
        ids = {info["request_id"]: k for k, _, info in done}
        spans = [(d, news[ids[d["trace_id"]]]) for d in tracer.recent()
                 if d["trace_id"] in ids]

        def through(d, phase):
            total = 0.0
            for p in d["phases"]:
                total += p["dur_ms"]
                if p["name"] == phase:
                    return total
            return None

        ttft = [through(d, "prefill") for d, _ in spans]
        itl = [sum(p["dur_ms"] for p in d["phases"]
                   if p["name"] == "decode_step") / (n - 1)
               for d, n in spans if n > 1]
        stats["swap"] = dict(
            prompts=len(prompts), requests=len(done), failed=len(errors),
            errors=errors[:3], served_by={v: versions.count(v)
                                          for v in (1, 2)},
            requests_per_s=len(done) / wall, wall_s=wall,
            ttft_ms_median=percentile([t for t in ttft if t is not None],
                                      50),
            itl_ms_median=percentile(itl, 50),
            v2_warmup_s=swap_at - t_deploy, peak_gib=peak_gib,
            admitted=admitted, warm_admissions=len(SERVE["buckets"]),
            flash_fwd_launches=launches.get("flash_fwd", 0),
            launches=launches)
        checks["swap_zero_failed"] = not errors
        checks["swap_each_stream_one_version"] = all(own)
        checks["swap_both_versions_served"] = set(versions) == {1, 2}
        checks["swap_flash_fwd_12_an_admission"] = (
            launches.get("flash_fwd", 0)
            == cfg["n_layers"] * (admitted + len(SERVE["buckets"]))
            and admitted == len(done))

        # (b) a saturating burst: every request at once, the queue bound
        # holds, a rejection is an Overloaded with its payload, at once
        got, rejected, other = [], [], []
        go = threading.Event()

        def burst(i):
            go.wait(10)
            t1 = time.perf_counter()
            try:
                reg.generate("lm", [prompts[i % len(prompts)][:16]],
                             C["saturate_new"])
                got.append(i)
            except serving.Overloaded as e:
                rejected.append((time.perf_counter() - t1, e.to_dict(),
                                 serving.error_response(e)))
            except Exception as e:
                other.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=burst, args=(i,))
                   for i in range(C["saturate"])]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(300)
        adm = reg.metrics("lm")["lm"]["admission"]
        stats["admission"] = dict(
            sent=C["saturate"], served=len(got), rejected=len(rejected),
            other=other[:3], queue_high_water=adm["queue_high_water"],
            max_queue=adm["max_queue"],
            reject_ms_max=(max(r[0] for r in rejected) * 1e3
                           if rejected else None),
            payload=rejected[0][1] if rejected else None)
        checks["admission_queue_bound"] = (
            adm["queue_high_water"] <= C["max_queue"])
        checks["admission_rejections_structured_and_immediate"] = (
            bool(rejected) and not other
            and all(r[1]["error"] == "Overloaded" and r[2][0] == 429
                    and r[0] <= C["reject_s"] for r in rejected)
            and adm["max_queue"] == C["max_queue"]
            and len(got) + len(rejected) == C["saturate"])
    finally:
        reg.shutdown()
    del v1, v2, reg
    return checks, stats


def control_canary(torch, keras, serving):
    """(b) A canary at CONTROL["canary"] on a LeNet registry entry (two
    seeds), and a deploy whose warm-up raises.  Returns (checks, stats)."""
    import numpy as np
    C = CONTROL
    reg = serving.ModelRegistry(device="cuda")
    checks, stats = {}, {}
    x = np.random.default_rng(5).normal(size=(2, 28, 28, 1)).astype(
        np.float32)
    try:
        reg.deploy("lenet", build_lenet(keras, "cuda", seed=0),
                   warmup_shapes=(28, 28, 1))
        want1 = reg.predict("lenet", x)
        reg.deploy("lenet", build_lenet(keras, "cuda", seed=1),
                   warmup_shapes=(28, 28, 1),
                   canary_fraction=C["canary"])
        routed = [reg.predict_ex("lenet", x)[1]["canary"]
                  for _ in range(C["canary_requests"])]
        stats["canary_hits"] = sum(routed)
        stats["canary_requests"] = len(routed)
        checks["canary_exact_share"] = (
            sum(routed) == round(C["canary"] * C["canary_requests"]))
        reg.clear_canary("lenet")

        def broken(p, xb):
            raise RuntimeError("injected warm-up failure")

        try:
            reg.deploy("lenet", fn=broken, params={},
                       warmup_shapes=(28, 28, 1))
            failed = None
        except serving.DeployError as e:
            failed = e.to_dict()
        stats["failed_deploy"] = failed
        out, info = reg.predict_ex("lenet", x)
        checks["failed_warmup_keeps_active"] = (
            failed is not None and failed["stage"] == "warmup"
            and info["version"] == 1 and np.array_equal(out, want1))
    finally:
        reg.shutdown()
    return checks, stats


def control_pager(torch, models, serving):
    """(c) Three pageable ResNet-50 f32 handles (coalescing, buckets to
    32) under pager={"max_resident": 2}, a pinned handle of model 0's
    weights beside them.  Returns (checks, stats)."""
    import gc
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer
    C = CONTROL
    shape = (C["resnet_size"], C["resnet_size"], 3)
    tracer = Tracer(capacity=16)
    reg = serving.ModelRegistry(
        device="cuda", max_batch_size=C["pager_rows"][1], tracer=tracer,
        pager={"max_resident": C["pager_resident"]})
    checks, stats = {}, {}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3,) + shape).astype(np.float32)
    try:
        pinned = models.ImageClassifier(
            "resnet-50", input_shape=shape,
            num_classes=C["resnet_classes"], device="cuda", seed=0)
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in pinned.state_dict().values())
        for i in range(3):
            net = models.ImageClassifier(
                "resnet-50", input_shape=shape,
                num_classes=C["resnet_classes"], device="cuda", seed=i)
            if i == 0:
                pinned.load_state_dict(net.state_dict())
            reg.deploy(f"r{i}", net, warmup_shapes=shape)
            del net  # the registry holds the only reference
        reg.deploy("pinned", pinned, warmup_shapes=shape, pageable=False)
        del pinned
        gc.collect()
        states = {f"r{i}": reg.metrics(f"r{i}")[f"r{i}"]["pager"]["state"]
                  for i in range(3)}
        want = reg.predict("pinned", x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, info = reg.predict_ex("r0", x)  # r0 is cold: a fault-in
        fault_ms = (time.perf_counter() - t0) * 1e3
        fault_phases = {}
        for ph in tracer.find(info["request_id"])["phases"]:
            fault_phases[ph["name"]] = (fault_phases.get(ph["name"], 0.0)
                                        + ph["dur_ms"])
        warm_t0 = time.perf_counter()
        again = reg.predict("r0", x)
        warm_ms = (time.perf_counter() - warm_t0) * 1e3
        entry = reg._entry("r0")
        recipe_bytes = entry.pager_recipe.host_bytes
        # page r0 out now (the pressure path's own demotion, called
        # directly so that no fault-in overlaps the reading) and read
        # what leaves the card
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        evicted = reg.pager._try_evict("r0", entry, "pressure")
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        refault = reg.predict("r0", x)
        pm = reg.metrics("r0")["r0"]["pager"]
        stats.update(states_after_deploys=states, fault_in_ms=fault_ms,
                     fault_phase_ms=fault_phases,
                     warm_predict_ms=warm_ms, bytes_per_fault=recipe_bytes,
                     weight_bytes=weight_bytes, freed_bytes=freed,
                     freed_share=freed / weight_bytes,
                     faults=pm["fault_ok"], evictions=pm["evict_pressure"])
        checks["pager_cold_after_deploys"] = states["r0"] == "cold"
        checks["pager_fault_in_bit_equal"] = (
            np.array_equal(got, want) and np.array_equal(again, want)
            and np.array_equal(refault, want))
        checks["pager_frees_weights"] = (
            evicted and freed >= C["freed_share"] * weight_bytes)
    finally:
        reg.shutdown()
    return checks, stats


def control_replicas(torch, keras, inference, profile):
    """(d) LeNet on two replicas of one card (each on its own stream),
    coalesced and hedged: results against solo runs, a failing replica,
    its re-probe, a slowed replica's hedges and an elastic resize.
    Returns (checks, stats)."""
    import threading
    import numpy as np
    C = CONTROL
    net = build_lenet(keras, "cuda", seed=3)
    net.eval()
    solo = inference.InferenceModel(
        max_batch_size=C["replica_bucket"],
        buckets=[C["replica_bucket"]]).load_keras_net(net)
    im = inference.InferenceModel(
        supported_concurrent_num=2, max_batch_size=C["replica_bucket"],
        buckets=[C["replica_bucket"]], coalescing=True, max_wait_ms=1.0,
        replicas=["cuda:0", "cuda:0"], hedging=True, hedge_quantile=0.5,
        hedge_min_ms=0.5).load_keras_net(net)
    handle = profile.install()
    checks, stats = {}, {}
    rng = np.random.default_rng(12)
    xs = [rng.normal(size=(int(n), 28, 28, 1)).astype(np.float32)
          for n in rng.integers(C["replica_rows"][0],
                                C["replica_rows"][1] + 1,
                                C["replica_threads"] * C["replica_requests"])]

    def run_all(timed=False):
        outs, lat, errors = [None] * len(xs), [None] * len(xs), []

        def client(t):
            for i in range(t, len(xs), C["replica_threads"]):
                t1 = time.perf_counter()
                try:
                    outs[i] = im.predict(xs[i])
                except Exception as e:
                    errors.append(f"{type(e).__name__}: {e}")
                lat[i] = time.perf_counter() - t1

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(C["replica_threads"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        return outs, lat, errors

    try:
        compiles0 = handle.snapshot()["compiles"]
        im.warmup((28, 28, 1))
        stats["builds_at_warmup"] = handle.snapshot()["compiles"] - compiles0
        solo.warmup((28, 28, 1))
        want = [solo.predict(x) for x in xs]
        rs = im._cache.replica_set
        coal = im._coalescer
        streams = [r.stream for r in rs.replicas]

        def exact(outs):
            return all(o is not None and np.array_equal(o, w)
                       for o, w in zip(outs, want))

        outs, _, errors = run_all()
        d0 = {r.index: r.dispatches for r in rs.replicas}
        checks["replicas_bit_identical"] = not errors and exact(outs)
        stats["max_abs_err"] = max(
            float(np.abs(o - w).max()) for o, w in zip(outs, want)
            if o is not None)
        checks["replicas_own_streams"] = (
            all(s is not None for s in streams)
            and streams[0] != streams[1])
        checks["replicas_both_serve"] = all(v > 0 for v in d0.values())

        # a replica that raises: marked unhealthy, its groups re-routed
        placed = dict(rs._exes)

        class Crashing:
            def execute(self, args):
                raise RuntimeError("injected replica crash")

        rs.probe_backoff_s = 3600.0
        for key, exes in placed.items():
            rs._exes[key] = (exes[0], Crashing())
        outs, _, errors = run_all()
        sick = rs.replicas[1]
        checks["failover_rerouted_exact"] = not errors and exact(outs)
        checks["failover_marked_unhealthy"] = not sick.healthy
        # the fault clears: a re-probe heals it
        with rs._lock:
            for key, exes in placed.items():
                rs._exes[key] = exes
            rs.probe_backoff_s = 0.01
            sick.probe_at = 0.0
        end = time.monotonic() + 30
        while not sick.healthy and time.monotonic() < end:
            im.predict(xs[0])
            time.sleep(0.01)
        checks["reprobe_heals"] = sick.healthy

        # a replica slowed by an injected wait: hedges fire and win
        for x in xs[:C["hedge_seed"]]:
            im.predict(x)
        fetch = coal._fetch_slot

        def slow_fetch(dev, n, slot):
            if slot == 1:
                time.sleep(C["hedge_delay_s"])
            return fetch(dev, n, slot)

        coal._fetch_slot = slow_fetch
        h0 = coal.hedge_stats()
        outs, lat_on, errors = run_all()
        h1 = coal.hedge_stats()
        checks["hedges_fire_and_win_exact"] = (
            not errors and exact(outs)
            and h1["hedge_won"] > h0["hedge_won"])
        coal.hedging = False
        outs, lat_off, errors_off = run_all()
        coal.hedging = True
        coal._fetch_slot = fetch
        checks["unhedged_exact"] = not errors_off and exact(outs)
        stats["hedges"] = {k: h1[k] - h0[k] for k in h1}
        stats["hedged_ms"] = dict(p50=percentile(lat_on, 50) * 1e3,
                                  p99=percentile(lat_on, 99) * 1e3)
        stats["unhedged_ms"] = dict(p50=percentile(lat_off, 50) * 1e3,
                                    p99=percentile(lat_off, 99) * 1e3)

        # elastic: down to one replica and back costs no build
        compiles = handle.snapshot()["compiles"]
        misses = dict(im.serving_stats()["misses"])
        im.set_active_replicas(1)
        outs1, _, e1 = run_all()
        im.set_active_replicas(2)
        outs2, _, e2 = run_all()
        checks["elastic_no_build"] = (
            handle.snapshot()["compiles"] == compiles
            and im.serving_stats()["misses"] == misses
            and im.active_replicas == 2)
        checks["elastic_exact"] = (not e1 and not e2 and exact(outs1)
                                   and exact(outs2))
        stats["replica_dispatches"] = im.serving_stats()[
            "replica_dispatches"]
        stats["bucket"] = C["replica_bucket"]
    finally:
        im.close()
        solo.close()
    return checks, stats


def phase_control(torch, TransformerLM, keras, models, kernels, inference):
    """The serving control plane on the card: (a) a hot swap of the
    full-width TransformerLM under traffic, (b) admission and canary,
    (c) the weight pager and (d) two replicas with failover and
    hedging."""
    import gc
    from analytics_zoo_tpu_torch import serving
    from analytics_zoo_tpu_torch.observability import profile
    stats, checks, seconds = {"card": smi_card()}, {}, {}
    for part, run in (
            ("swap", lambda: control_swap(torch, TransformerLM, kernels,
                                          serving, inference)),
            ("canary", lambda: control_canary(torch, keras, serving)),
            ("pager", lambda: control_pager(torch, models, serving)),
            ("replicas", lambda: control_replicas(torch, keras, inference,
                                                  profile))):
        t = time.perf_counter()
        c, s = run()
        checks.update(c)
        stats.update(s if part == "swap" else {part: s})
        seconds[part] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    swap = stats.get("swap", {})
    stats.update(
        seconds=seconds, requests_per_s=swap.get("requests_per_s"),
        ttft_ms_median=swap.get("ttft_ms_median"),
        itl_ms_median=swap.get("itl_ms_median"),
        v2_warmup_s=swap.get("v2_warmup_s"), peak_gib=swap.get("peak_gib"),
        fault_in_ms=stats["pager"].get("fault_in_ms"),
        bytes_per_fault=stats["pager"].get("bytes_per_fault"),
        hedged_ms=stats["replicas"].get("hedged_ms"),
        unhedged_ms=stats["replicas"].get("unhedged_ms"),
        launches=swap.get("launches"), checks=checks)
    for name, good in checks.items():
        if not good:
            log(f"control: FAIL {name}")
    log("control:", json.dumps(stats, default=str))
    return all(checks.values()), stats


SHARD = dict(spec={"axes": {"tensor": 2}}, devices=["cuda:0"] * 4,
             decode_devices=["cuda:0"] * 2, max_batch=4, rows=(1, 4),
             requests=24, decode_requests=16, decode_runs=2,
             gather_share=0.5, freed_share=0.95, logit_tol=1e-5,
             rest_slack=0.02,
             worker_lm=dict(vocab_size=1000, seq_len=128, n_layers=2,
                            d_model=128, n_heads=2),
             tag="shard-lm-small")

STORE_WORKER = r"""
# One process of the shard phase's store check: imports the port from
# the copy given as argv[1] (its own empty build/), serves a small
# TransformerLM (InferenceModel(store_tag=...), warmed: its first
# forward builds or loads the kernel libraries), runs flash_fwd on seeded
# inputs, saves the outputs to argv[3] and prints one RESULT line.
import json
import sys
import time

t_start = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from analytics_zoo_tpu_torch.observability import profile
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.models import TransformerLM
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.serving import execstore

assert _kernels.__file__.startswith(sys.argv[1]), _kernels.__file__
torch.backends.cuda.matmul.allow_tf32 = False
cfg = json.loads(sys.argv[2])
handle = profile.install()
# the worker's compiles are its nvcc runs: the handle's bucket builds
# (signature_build events) are not the store's business
keys = []
note = profile.note_compile
profile.note_compile = lambda s, key, **kw: (
    kw.get("kind") == "kernel_build" and keys.append(key),
    note(s, key, **kw))
lm = TransformerLM(**cfg["lm"], device="cuda", seed=0).eval()
seq = cfg["lm"]["seq_len"]
x = np.random.default_rng(0).integers(
    0, cfg["lm"]["vocab_size"], (2, seq)).astype(np.int32)
im = InferenceModel(max_batch_size=2, store_tag=cfg["tag"])
im.load_keras_net(lm)
t0 = time.perf_counter()
im.warmup((seq,), np.int32)
warmup_s = time.perf_counter() - t0
y = im.predict(x)
first_answer_s = time.perf_counter() - t_start
g = torch.Generator("cuda").manual_seed(0)
q, k, v = (torch.randn((12, 256, 64), generator=g, device="cuda")
           for _ in range(3))
o, lse = _kernels.flash_fwd(q, k, v, None, True, 0.125)
np.savez(sys.argv[3], y=y, o=o.cpu().numpy(), lse=lse.cpu().numpy())
snap = handle.snapshot()
print("RESULT " + json.dumps({
    "compiles": snap["by_kind"]["kernel_build"], "compile_keys": keys,
    "compile_s": snap["compile_seconds"], "warmup_s": warmup_s,
    "first_answer_s": first_answer_s,
    "launches": _kernels.launch_counts(),
    "store": execstore.current().stats()}))
"""


def store_worker(tmp, name, store_dir, timeout=900):
    """One store worker from a fresh copy ``tmp/name`` of the package
    (no build directory) with ``ZOO_EXECSTORE_DIR=store_dir``: (its
    RESULT, its outputs, wall s)."""
    import numpy as np
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "analytics_zoo_tpu_torch"),
                    os.path.join(root, "analytics_zoo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = os.path.join(tmp, "store_worker.py")
    with open(script, "w") as f:
        f.write(STORE_WORKER)
    out = os.path.join(tmp, f"{name}.npz")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZOO_EXECSTORE")}
    env.update(ZOO_EXECSTORE_DIR=store_dir, PYTHONPATH=root)
    cfg = {"lm": SHARD["worker_lm"], "tag": SHARD["tag"]}
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, script, root, json.dumps(cfg),
                           out], env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not line:
        raise RuntimeError(f"store worker {name} rc {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(line[0][len("RESULT "):]), arrays, wall


def shard_predict(torch, lm, kernels, inference, profile, tmp):
    """(a) The serve model, saved and loaded again under the mesh (read
    onto the host, only the blocks reaching the card), through a
    ShardGroupSet over SHARD["devices"] (two groups of two on one card),
    coalesced, against the single-device handle.  Returns (checks,
    stats)."""
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        module_tensors
    from analytics_zoo_tpu_torch.pipeline.inference.serving import fetch_rows
    S = SHARD
    seq = lm.hyper["seq_len"]
    vocab = lm.hyper["vocab_size"]
    checks, stats = {}, {}
    path = os.path.join(tmp, "shard_lm")
    lm.save_model(path)
    solo = inference.InferenceModel(max_batch_size=S["max_batch"])
    solo.load_keras_net(lm)
    handle = profile.install()
    compiles0 = handle.snapshot()["compiles"]
    im = inference.InferenceModel(max_batch_size=S["max_batch"],
                                  coalescing=True, mesh=S["spec"],
                                  replicas=S["devices"])
    # the bytes the load asked the allocator for (its block rounding
    # left out), and what the allocator holds for them
    torch.cuda.synchronize()
    base = (torch.cuda.memory_stats()["requested_bytes.all.current"],
            torch.cuda.memory_allocated())
    im.load(path)
    torch.cuda.synchronize()
    at_rest = torch.cuda.memory_stats()[
        "requested_bytes.all.current"] - base[0]
    at_rest_allocated = torch.cuda.memory_allocated() - base[1]
    try:
        im.warmup((seq,), np.int32)
        # the sharded set's builds, before the solo handle's own
        builds = handle.snapshot()["compiles"] - compiles0
        solo.warmup((seq,), np.int32)
        rs = im._cache.replica_set
        buckets = im._cache.buckets
        checks["shard_one_build_a_signature"] = (
            builds == len(buckets) and rs.compiled_keys() == len(buckets)
            and rs.placement_complete())
        rng = np.random.default_rng(21)
        exact, launches = True, []
        for b in buckets:
            x = rng.integers(0, vocab, (b, seq)).astype(np.int32)
            want = solo.predict(x)
            for g in rs.groups:
                kernels.reset_launch_counts()
                got = fetch_rows(rs.dispatch(g, x), b)
                launches.append(kernels.launch_counts()["flash_fwd"])
                exact = exact and np.array_equal(got, want)
        checks["shard_bit_equal_every_bucket_and_group"] = exact
        checks["shard_flash_fwd_12_a_dispatch"] = all(
            n == lm.hyper["n_layers"] for n in launches)
        whole = sum(t.numel() * t.element_size()
                    for t in module_tensors(lm).values())
        layer = {}
        for name, t in module_tensors(lm).items():
            key = name.rsplit(".", 1)[0]
            layer[key] = layer.get(key, 0) + t.numel() * t.element_size()
        members = rs.member_bytes()
        checks["shard_members_hold_blocks"] = all(
            max(m) < whole and sum(m) >= whole for m in members)
        # the card's allocation after the load is the groups' blocks:
        # no whole model stays behind on it
        blocks = sum(sum(m) for m in members)
        checks["shard_card_holds_only_the_blocks"] = (
            blocks <= at_rest < blocks + S["rest_slack"] * whole)
        # the dispatch peak over what is resident, against the solo
        # handle's at the same bucket: the difference is what gathering
        # costs (one layer at a time, not the whole model)
        x = rng.integers(0, vocab, (buckets[-1], seq)).astype(np.int32)
        peaks = {}
        for name, run in (("solo", lambda: solo.predict(x)),
                          ("shard", lambda: fetch_rows(
                              rs.dispatch(rs.groups[0], x), len(x)))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
        gather = peaks["shard"] - peaks["solo"]
        checks["shard_gathers_a_layer_not_the_model"] = (
            gather < S["gather_share"] * whole)
        # latency: the same requests through either handle, in turns
        reqs = [rng.integers(0, vocab, (int(n), seq)).astype(np.int32)
                for n in rng.integers(S["rows"][0], S["rows"][1] + 1,
                                      S["requests"])]
        lat = {"solo": [], "shard": []}
        for x in reqs:
            for name, h in (("shard", im), ("solo", solo)):
                t = time.perf_counter()
                out = h.predict(x)
                lat[name].append(time.perf_counter() - t)
                if name == "shard":
                    shard_out = out
                else:
                    exact = exact and np.array_equal(shard_out, out)
        checks["shard_coalesced_bit_equal"] = exact
        group_disp = rs.stats()["group_dispatches"]
        checks["shard_both_groups_serve"] = all(
            v > 0 for v in group_disp.values())
        stats.update(
            buckets=list(buckets), builds=builds,
            flash_fwd_a_dispatch=launches,
            whole_model_bytes=whole, member_bytes=members,
            at_rest_bytes=at_rest, at_rest_allocated_bytes=at_rest_allocated,
            block_bytes=blocks,
            largest_layer_bytes=max(layer.values()),
            dispatch_peak_bytes=peaks["shard"],
            solo_peak_bytes=peaks["solo"], gather_bytes=gather,
            predict_ms={k: dict(p50=percentile(v, 50) * 1e3,
                                p99=percentile(v, 99) * 1e3)
                        for k, v in lat.items()},
            group_dispatches=group_disp)
    finally:
        im.close()
        solo.close()
    return checks, stats


def probe_logits(torch, engine, prompts):
    """Admit ``prompts`` into the engine's slots 0, 1, ... (a mesh
    engine's members in turn, ``capacity / group size`` each) and return,
    on the host, the logits each member's next decode step selects from,
    computed eagerly by the step's body at the member's step batch (not
    the captured graph; the streams check the served path).  Runs before
    the engine serves; the slots stay on the free list."""
    import numpy as np
    from analytics_zoo_tpu_torch.models.generation import (_decode_step,
                                                           _embed_token)
    from analytics_zoo_tpu_torch.pipeline.inference.decode import (
        TokenStream, _DecodeRequest)
    members = getattr(engine, "members", [engine])
    per = engine.capacity // len(members)
    parts = []
    for j, m in enumerate(members):
        rows = prompts[j * per:(j + 1) * per]
        if not rows:
            continue
        m._after_caller()
        with m._on_device():
            for slot, ids in enumerate(rows):
                prompt, n, bucket, _, _ = m._validate(ids, 1)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :n] = prompt
                m._admit_monolithic(_DecodeRequest(
                    padded, n, bucket, 1, None, TokenStream(0)), slot)
            posc = m._pos.clamp(max=m.max_len - 1)
            logits = _decode_step(m._model, m._caches,
                                  _embed_token(m._model, m._tok, posc), posc)
            parts.append(logits[:len(rows)].float().cpu())
    return torch.cat(parts)


def shard_decode(torch, lm, kernels, inference):
    """(b) The mesh decode engine (slots split over two members on one
    card) against the unsplit engine on the serve phase's mixed prompts:
    probe logits first, then the streams, in turns.  Returns (checks,
    stats)."""
    import numpy as np
    S = SHARD
    engine_kw = dict(decode_capacity=SERVE["capacity"],
                     decode_max_len=SERVE["max_len"],
                     decode_prompt_buckets=SERVE["buckets"])
    checks, stats = {}, {}
    rng = np.random.default_rng(22)
    prompts, news = mixed_requests(lm.hyper, rng, S["decode_requests"])
    plain = inference.InferenceModel(**engine_kw).load_keras_net(lm)
    mesh = inference.InferenceModel(
        mesh=S["spec"], replicas=S["decode_devices"], **engine_kw)
    mesh.load_keras_net(lm)
    try:
        pe, me = plain.decode_engine, mesh.decode_engine
        probe = prompts[:SERVE["capacity"]]
        want = probe_logits(torch, pe, probe)
        got = probe_logits(torch, me, probe)
        diff = float((got - want).abs().max())
        stats.update(logit_max_abs_diff=diff,
                     logit_bits_equal=bool(torch.equal(got, want)),
                     members=[m.capacity for m in me.members])
        checks["shard_decode_logits_within_tol"] = diff <= S["logit_tol"]
        runs = {"plain": [], "mesh": []}
        outs = {}
        launches, admitted = {}, 0
        for turn in range(S["decode_runs"]):
            for name, eng in (("mesh", me), ("plain", pe)):
                a0 = eng.stats()["admitted"]
                kernels.reset_launch_counts()
                res = serve_stream(eng.submit, prompts, news)
                if name == "mesh":
                    launches = kernels.launch_counts()
                    admitted = eng.stats()["admitted"] - a0
                m = stream_metrics(*res)
                runs[name].append(m["tokens_per_s"])
                outs.setdefault(name, []).append(res[0])
        equal = all(np.array_equal(a, b) for run_m, run_p in
                    zip(outs["mesh"], outs["plain"])
                    for a, b in zip(run_m, run_p))
        checks["shard_decode_streams_equal"] = equal
        checks["shard_decode_flash_fwd_12_an_admission"] = (
            launches.get("flash_fwd", 0) == lm.hyper["n_layers"] * admitted
            and admitted == len(prompts))
        checks["shard_decode_both_members_admit"] = all(
            m.stats()["admitted"] > 0 for m in me.members)
        stats.update(tokens_per_s=runs, admitted=admitted,
                     launches=launches,
                     member_admitted=[m.stats()["admitted"]
                                      for m in me.members])
    finally:
        mesh.close()
        plain.close()
    return checks, stats


def shard_registry(torch, lm, serving):
    """(c) A sharded deploy of the serve model through the registry with
    a pager of one resident model: paged out and faulted in, installed
    only with its placement complete, bit-equal after.  Returns (checks,
    stats)."""
    import gc
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.inference import inference_model
    S = SHARD
    seq = lm.hyper["seq_len"]
    reg = serving.ModelRegistry(device="cuda", max_batch_size=2,
                                replicas=S["devices"],
                                pager={"max_resident": 1,
                                       "quiesce_timeout_s": 5.0})
    checks, stats = {}, {}
    x = np.random.default_rng(23).integers(
        0, lm.hyper["vocab_size"], (2, seq)).astype(np.int32)
    try:
        reg.deploy("shard", lm, mesh=S["spec"], warmup_shapes=(seq,),
                   warmup_dtypes=np.int32)
        entry = reg._entry("shard")
        model = entry.active.model
        want = reg.predict("shard", x)
        held = sum(sum(m) for m in
                   model._cache.replica_set.member_bytes())
        del model
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        evicted = reg.pager._try_evict("shard", entry, "pressure")
        gc.collect()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        cold = entry.pager_state == "cold"
        # a fault-in whose placement reads incomplete is refused
        real = inference_model.InferenceModel.placement_complete
        inference_model.InferenceModel.placement_complete = \
            lambda self: False
        try:
            reg.predict("shard", x)
            refused = False
        except Exception:  # the refusal: the entry stays cold
            refused = entry.pager_state != "resident"
        finally:
            inference_model.InferenceModel.placement_complete = real
        t = time.perf_counter()
        got = reg.predict("shard", x)
        fault_ms = (time.perf_counter() - t) * 1e3
        checks["shard_pager_refuses_partial_placement"] = refused
        checks["shard_pager_resident_with_placement_complete"] = (
            entry.pager_state == "resident"
            and entry.active.model.placement_complete())
        checks["shard_pager_fault_in_bit_equal"] = np.array_equal(got, want)
        checks["shard_pager_frees_blocks"] = (
            evicted and cold and freed >= S["freed_share"] * held)
        stats.update(group_block_bytes=held, freed_bytes=freed,
                     fault_in_ms=fault_ms,
                     groups=entry.active.model.serving_stats()["groups"])
    finally:
        reg.shutdown()
    return checks, stats


def shard_store(tmp):
    """(d) The kernel-library store across processes: a cold worker
    builds and writes, a warm one (another fresh copy) builds nothing and
    gives the same bits, a third after a flipped byte counts the entry
    invalid, rebuilds and gives the same bits; ``stat`` lists the
    entries with their tag.  Returns (checks, stats)."""
    import numpy as np
    from analytics_zoo_tpu_torch.ops import _kernels
    libs = len(_kernels._SIGNATURES)  # one library a source
    store = os.path.join(tmp, "store")
    shutil.rmtree(store, ignore_errors=True)
    checks, stats = {}, {}
    cold, a_cold, wall_cold = store_worker(tmp, "copy_cold", store)
    warm, a_warm, wall_warm = store_worker(tmp, "copy_warm", store)
    entries = sorted(os.listdir(store))
    # flip a byte in the payload of flash_fwd.cu's entry
    flipped = None
    for name in entries:
        path = os.path.join(store, name)
        raw = open(path, "rb").read()
        head = json.loads(raw[:raw.index(b"\n")])
        if head["meta"].get("source") == "flash_fwd.cu":
            mid = raw.index(b"\n") + (len(raw) - raw.index(b"\n")) // 2
            with open(path, "wb") as f:
                f.write(raw[:mid] + bytes([raw[mid] ^ 0xFF]) + raw[mid + 1:])
            flipped = head["meta"]
    bad, a_bad, wall_bad = store_worker(tmp, "copy_corrupt", store)
    repo = os.path.dirname(os.path.abspath(__file__))
    stat = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.execstore",
         "--root", store, "stat"], env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=120)

    def same(a, b):
        return all(np.array_equal(a[k], b[k]) for k in ("y", "o", "lse"))

    checks["store_cold_builds_and_writes"] = (
        cold["compiles"] == 1 and cold["store"]["write"] == libs
        and cold["launches"]["flash_fwd"] > 0)
    checks["store_warm_runs_no_nvcc"] = (
        warm["compiles"] == 0 and warm["store"]["hit"] == libs
        and warm["store"]["write"] == 0)
    checks["store_warm_same_bits"] = same(a_cold, a_warm)
    checks["store_corrupt_invalid_rebuilt_same_bits"] = (
        flipped is not None and bad["store"]["invalid"] == 1
        and bad["compile_keys"] == ["nvcc:flash_fwd.cu"]
        and bad["store"]["hit"] == libs - 1 and same(a_cold, a_bad))
    checks["store_stat_lists_tagged_entries"] = (
        stat.returncode == 0 and f"{libs} entries" in stat.stdout
        and stat.stdout.count(SHARD["tag"]) == libs)
    stats.update(
        cold_build_s=cold["compile_s"], cold_first_answer_s=cold[
            "first_answer_s"], warm_first_answer_s=warm["first_answer_s"],
        corrupt_first_answer_s=bad["first_answer_s"],
        cold_warmup_s=cold["warmup_s"], warm_warmup_s=warm["warmup_s"],
        wall_s=dict(cold=wall_cold, warm=wall_warm, corrupt=wall_bad),
        store=dict(cold=cold["store"], warm=warm["store"],
                   corrupt=bad["store"]),
        compile_keys=dict(cold=cold["compile_keys"],
                          warm=warm["compile_keys"],
                          corrupt=bad["compile_keys"]),
        stat=stat.stdout.strip().splitlines())
    return checks, stats


def phase_shard(torch, TransformerLM, kernels, inference, tmp):
    """Sharded serving groups and the kernel-library store on the card:
    (a) the full-width serve model through two groups of two on one
    card, (b) the mesh decode engine, (c) a sharded registry deploy
    through the pager, (d) the store across three processes."""
    import gc
    from analytics_zoo_tpu_torch import serving
    from analytics_zoo_tpu_torch.observability import profile
    stats, checks, seconds = {"card": smi_card()}, {}, {}
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    lm = TransformerLM(**cfg, device="cuda", seed=0).eval()
    launches = {}
    for part, run in (
            ("predict", lambda: shard_predict(torch, lm, kernels, inference,
                                              profile, tmp)),
            ("decode", lambda: shard_decode(torch, lm, kernels, inference)),
            ("registry", lambda: shard_registry(torch, lm, serving)),
            ("store", lambda: shard_store(tmp))):
        t = time.perf_counter()
        try:
            c, s = run()
        except Exception as e:  # the part fails; the others still run
            import traceback
            traceback.print_exc()
            c, s = {f"{part}_ran": False}, {"error": f"{type(e).__name__}: "
                                                     f"{e}"}
        checks.update(c)
        stats[part] = s
        seconds[part] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    pred, dec = stats["predict"], stats["decode"]
    for name in kernels.KERNELS:
        launches[name] = (sum(pred.get("flash_fwd_a_dispatch", []))
                          if name == "flash_fwd" else 0) + dec.get(
                              "launches", {}).get(name, 0)
    stats.update(
        seconds=seconds, launches=launches,
        member_bytes=pred.get("member_bytes"),
        at_rest_bytes=pred.get("at_rest_bytes"),
        whole_model_bytes=pred.get("whole_model_bytes"),
        dispatch_peak_bytes=pred.get("dispatch_peak_bytes"),
        gather_bytes=pred.get("gather_bytes"),
        predict_ms=pred.get("predict_ms"),
        decode_tokens_per_s=dec.get("tokens_per_s"),
        logit_max_abs_diff=dec.get("logit_max_abs_diff"),
        logit_bits_equal=dec.get("logit_bits_equal"),
        freed_bytes=stats["registry"].get("freed_bytes"),
        store_cold_build_s=stats["store"].get("cold_build_s"),
        store_warm_first_answer_s=stats["store"].get("warm_first_answer_s"),
        checks=checks)
    for name, good in checks.items():
        if not good:
            log(f"shard: FAIL {name}")
    log("shard:", json.dumps(stats, default=str))
    return all(checks.values()), stats


# the fleet phase: the serve phase's full-width TransformerLM served by a
# supervised fleet of two worker processes on the one card, the workers
# running from a fresh copy of the package (no kernel build directory),
# so that the first activation runs nvcc and fills the shared store
FLEET = dict(workers=2, requests=16, threads=4, sampled=dict(
                 temperature=0.8, top_k=50, top_p=0.95),
             predict_rows=(1, 2), predict_reps=4, oversize_rows=4,
             upgrade_served=16, kill_after=4, after_recovery=8,
             traced_requests=48, traced_prompt=32, traced_new=8,
             traced_rounds=2, attribution=0.95, traced_ratio=0.95,
             start_timeout=600, call_timeout=600, wait_s=600)
FLEET_BUILDER = "analytics_zoo_tpu_torch.serving.fleet.builders:lm"


def fleet_args(seed):
    """The ``lm`` builder's args: the serve phase's model and engine."""
    return dict(vocab_size=FULL["vocab_size"], seq_len=SERVE["max_len"],
                n_layers=FULL["n_layers"], d_model=FULL["d_model"],
                n_heads=FULL["n_heads"], d_ff=FULL["d_ff"], seed=seed,
                capacity=SERVE["capacity"],
                prompt_buckets=list(SERVE["buckets"]),
                prefix_pool=SERVE["pool"])


#: the deploy keywords every copy of the model gets: a predict ladder of
#: buckets 1 and 2, warmed at (640,) int32 token ids
FLEET_DEPLOY = dict(max_batch_size=2, warmup_dtypes="int32")


def fleet_package(root):
    """A fresh copy of the package under ``root/pkg`` (no build
    directory): the PYTHONPATH of the fleet's workers."""
    repo = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "pkg")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "analytics_zoo_tpu_torch"),
                    os.path.join(pkg, "analytics_zoo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return pkg


def fleet_drop_builds(pkg):
    """Remove the package copy's kernel build directory and return the
    libraries it held.  The workers on one host import one copy, so they
    share that directory: a later worker loads the first one's libraries
    from it and never reads the store.  Without it a restarted worker
    must load them from the store."""
    root = os.path.join(pkg, "build")
    libs = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(root, "torch_kernels", "*", "*.so")))
    shutil.rmtree(root, ignore_errors=True)
    return libs


def fleet_env(pkg):
    """The workers' environment: the package copy first on the path and
    the working directory (this checkout) off it, which ``python -m``
    would otherwise put first."""
    return {"PYTHONPATH": pkg, "PYTHONSAFEPATH": "1"}


def fleet_sampling(i):
    """Request i's sampling: even requests greedy, odd ones sampled with
    a seed of their own."""
    if i % 2 == 0:
        return {}
    return dict(FLEET["sampled"], seed=1000 + i)


def fleet_drive(call, n, threads, stop=None):
    """``call(i)`` for i in 0..n-1 (or cycling until ``stop`` is set)
    from ``threads`` clients at once: ([(i, out, info, t0, t1)], errors,
    wall s)."""
    import threading
    done, errors = [], []
    go = threading.Event()

    def client(t):
        go.wait(10)
        i = t
        while (i < n) if stop is None else not stop.is_set():
            t0 = time.perf_counter()
            try:
                out, info = call(i % n)
                done.append((i % n, out, info, t0, time.perf_counter()))
            except Exception as e:  # counted as a failed request
                errors.append(f"{type(e).__name__}: {e}")
            i += threads

    workers = [threading.Thread(target=client, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    t0 = time.perf_counter()
    go.set()
    return done, errors, workers, t0


def fleet_join(workers, t0, timeout):
    for w in workers:
        w.join(timeout)
    return time.perf_counter() - t0


def phase_timings(phases, n_new):
    """(TTFT ms, ITL ms) of one generate span's phases (dicts or
    ``[name, start, dur]`` triples): the time through ``prefill``, and
    the decode steps' time over the tokens after the first."""
    rows = [(p["name"], p["dur_ms"]) if isinstance(p, dict)
            else (p[0], p[2]) for p in phases or ()]
    total, ttft = 0.0, None
    for name, dur in rows:
        total += dur
        if name == "prefill":
            ttft = total
            break
    itl = (sum(d for name, d in rows if name == "decode_step")
           / (n_new - 1)) if n_new > 1 else None
    return ttft, itl


def fleet_reference(torch, serving, builders, prompts, news, xs):
    """The single-process registry built in this process from the same
    spec: v1's and v2's streams for every prompt, v1's predict replies,
    and requests/s, TTFT and ITL medians of v1 served from
    FLEET["threads"] clients.  Returns (streams, predicts, stats)."""
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer
    tracer = Tracer(capacity=256)
    reg = serving.ModelRegistry(tracer=tracer)
    try:
        for v in (1, 2):
            reg.deploy(f"v{v}", warmup_shapes=(SERVE["max_len"],),
                       **builders.lm(fleet_args(v - 1), None,
                                     device="cuda"), **FLEET_DEPLOY)

        def gen(name):
            return lambda i: reg.generate_ex(name, [prompts[i]], news[i],
                                             **fleet_sampling(i))

        done, errors, workers, t0 = fleet_drive(gen("v1"), len(prompts),
                                                FLEET["threads"])
        wall = fleet_join(workers, t0, FLEET["wait_s"])
        if errors:
            raise RuntimeError(f"reference generate failed: {errors[:3]}")
        streams = {1: {i: out[0] for i, out, _, _, _ in done}}
        timings = [phase_timings(tracer.find(info["request_id"])["phases"],
                                 len(out[0]))
                   for i, out, info, _, _ in done]
        streams[2] = {i: reg.generate("v2", [prompts[i]], news[i],
                                      **fleet_sampling(i))[0]
                      for i in range(len(prompts))}
        predicts = {rows: np.asarray(reg.predict("v1", x))
                    for rows, x in xs.items()}
    finally:
        reg.shutdown()
    stats = dict(requests_per_s=len(done) / wall, wall_s=wall,
                 ttft_ms_median=percentile(
                     [t for t, _ in timings if t is not None], 50),
                 itl_ms_median=percentile(
                     [t for _, t in timings if t is not None], 50))
    return streams, predicts, stats


def fleet_flash(router, ranks):
    """Each worker's flash_fwd count (its process's, read by ``ping``)."""
    return {rk: router.ping(rk)["launches"]["flash_fwd"] for rk in ranks}


def fleet_scrape(router):
    from analytics_zoo_tpu_torch.observability.metrics import \
        parse_prometheus_text
    return parse_prometheus_text(router.metrics_text())


def fleet_prefix_hits(parsed, rank):
    return sum(v for (name, labels), v in parsed["samples"].items()
               if name == "zoo_decode_prefix_hits_total"
               and ("rank", str(rank)) in labels)


def fleet_log_tail(router, n=3000):
    """The workers' stderr tails, for a failure's diagnosis."""
    run = router.supervisor.run_dir
    for name in sorted(os.listdir(run)):
        if name.startswith("stderr_"):
            with open(os.path.join(run, name), errors="replace") as f:
                log(f"fleet: {name}:\n{f.read()[-n:]}")


def fleet_generate(torch, r, kernels, prompts, news, ref, checks, stats):
    """(2) The generate path through the router from FLEET["threads"]
    clients, traced: streams against the reference, 12 flash_fwd
    launches in the workers an admission that computed its prompt."""
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer
    ranks = range(FLEET["workers"])
    r.tracer = Tracer(capacity=256)
    scrape0 = fleet_scrape(r)
    flash0 = fleet_flash(r, ranks)
    done, errors, workers, t0 = fleet_drive(
        lambda i: r.generate_ex("lm", [prompts[i]], news[i],
                                **fleet_sampling(i)),
        len(prompts), FLEET["threads"])
    wall = fleet_join(workers, t0, FLEET["wait_s"])
    flash1 = fleet_flash(r, ranks)
    scrape1 = fleet_scrape(r)
    spans = {info["request_id"]: r.tracer.find(info["request_id"])
             for _, _, info, _, _ in done}
    served = {rk: sum(1 for sd in spans.values()
                      if sd["labels"].get("worker") == rk) for rk in ranks}
    per_rank = {rk: dict(
        admissions=served[rk],
        prefix_hits=fleet_prefix_hits(scrape1, rk)
        - fleet_prefix_hits(scrape0, rk),
        flash_fwd=flash1[rk] - flash0[rk]) for rk in ranks}
    timings = [phase_timings((spans[info["request_id"]].get("children")
                              or [{}])[0].get("phases"), len(out[0]))
               for _, out, info, _, _ in done]
    nested = [sd.get("children") or [] for sd in spans.values()]
    checks["generate_zero_failed"] = not errors and len(done) == len(prompts)
    checks["generate_streams_equal_single_process"] = all(
        np.array_equal(out[0], ref[1][i]) for i, out, _, _, _ in done)
    checks["generate_flash_fwd_12_an_admission_per_worker"] = all(
        p["flash_fwd"] == FULL["n_layers"] * (p["admissions"]
                                              - p["prefix_hits"])
        and p["admissions"] > 0 for p in per_rank.values())
    checks["generate_worker_leg_nested_under_worker_call"] = all(
        len(ch) == 1 and ch[0].get("_phase") == "worker_call"
        for ch in nested)
    checks["generate_info_fleet_gap_ms"] = all(
        "fleet_gap_ms" in info for _, _, info, _, _ in done)
    stats["generate"] = dict(
        requests=len(done), errors=errors[:3], wall_s=wall,
        requests_per_s=len(done) / wall, per_rank=per_rank,
        ttft_ms_median=percentile([t for t, _ in timings
                                   if t is not None], 50),
        itl_ms_median=percentile([t for _, t in timings
                                  if t is not None], 50),
        fleet_gap_ms_median=percentile(
            [info.get("fleet_gap_ms", 0.0) for _, _, info, _, _ in done],
            50))
    r.tracer = None
    return sum(p["flash_fwd"] for p in per_rank.values())


def fleet_predict(torch, r, xs, ref, checks, stats):
    """(3) Predict of 1 and 2 rows at 640 tokens on the binary wire, then
    the JSON wire: replies bit-equal to each other and to the
    single-process handle, 12 flash_fwd launches a dispatch; a 4-row
    reply over the frame bound comes back structured and the connection
    serves on."""
    import numpy as np
    from analytics_zoo_tpu_torch.serving import ServingError
    from analytics_zoo_tpu_torch.serving.fleet import protocol
    ranks = range(FLEET["workers"])
    out, flash = {}, 0
    for wire in ("binary", "json"):
        r.set_wire(wire)
        lat, nbytes, got = {}, {}, {}
        f0 = fleet_flash(r, ranks)
        sent = 0
        for rows in FLEET["predict_rows"]:
            for _ in range(FLEET["predict_reps"]):
                wb0 = r.wire_bytes
                t = time.perf_counter()
                y, _ = r.predict_ex("lm", xs[rows])
                lat.setdefault(rows, []).append(
                    (time.perf_counter() - t) * 1e3)
                wb1 = r.wire_bytes
                nbytes[rows] = sum(wb1.get(k, 0) - wb0.get(k, 0)
                                   for k in wb1)
                got.setdefault(rows, []).append(np.asarray(y))
                sent += 1
        f1 = fleet_flash(r, ranks)
        launched = sum(f1[rk] - f0[rk] for rk in ranks)
        flash += launched
        out[wire] = got
        stats[f"predict_{wire}"] = dict(
            bytes_a_request={rows: nbytes[rows] for rows in nbytes},
            ms_p50={rows: percentile(v, 50) for rows, v in lat.items()},
            ms_p99={rows: percentile(v, 99) for rows, v in lat.items()},
            requests=sent, flash_fwd=launched)
        checks[f"predict_{wire}_flash_fwd_12_a_dispatch"] = (
            launched == FULL["n_layers"] * sent)
    r.set_wire("binary")
    checks["predict_bit_equal_both_wires_and_single_process"] = all(
        y.tobytes() == ref[rows].tobytes()
        for wire in out for rows in out[wire] for y in out[wire][rows])
    retries = r.retries_total
    err = None
    x4 = np.concatenate([xs[2], xs[2]])[:FLEET["oversize_rows"]]
    try:
        r.predict_ex("lm", x4)
    except ServingError as e:
        err = dict(e.details)
    y, _ = r.predict_ex("lm", xs[1])
    stats["oversize"] = dict(
        rows=FLEET["oversize_rows"], error=err and err.get("error"),
        attempted_bytes=err and err.get("attempted_bytes"),
        max_frame_bytes=err and err.get("max_frame_bytes"))
    checks["predict_oversize_structured"] = (
        err is not None and err.get("error") == "FrameError"
        and err.get("attempted_bytes", 0) > protocol.MAX_FRAME_BYTES
        and err.get("max_frame_bytes") == protocol.MAX_FRAME_BYTES)
    checks["predict_connection_usable_after_oversize"] = (
        y.tobytes() == ref[1].tobytes() and r.retries_total == retries)
    return flash


def fleet_upgrade(r, prompts, news, ref, checks, stats):
    """(4) v2 (seed 1) deployed while FLEET["threads"] clients cycle
    through the prompts, until v2 served FLEET["upgrade_served"]."""
    import threading
    import numpy as np
    stop = threading.Event()
    done, errors, workers, t0 = fleet_drive(
        lambda i: r.generate_ex("lm", [prompts[i]], news[i],
                                **fleet_sampling(i)),
        len(prompts), FLEET["threads"], stop=stop)
    try:
        while (len(done) < FLEET["kill_after"] and not errors
               and time.perf_counter() - t0 < FLEET["wait_s"]):
            time.sleep(0.01)
        rep = r.deploy("lm", None, FLEET_BUILDER, fleet_args(1),
                       warmup_shapes=(SERVE["max_len"],),
                       deploy_kwargs=FLEET_DEPLOY)
        while (sum(1 for d in done if d[2]["version"] == 2)
               < FLEET["upgrade_served"] and not errors
               and time.perf_counter() - t0 < FLEET["wait_s"]):
            time.sleep(0.01)
    finally:
        stop.set()
        wall = fleet_join(workers, t0, FLEET["wait_s"])
    acts = rep["activations"]
    versions = [d[2]["version"] for d in done]
    checks["upgrade_zero_failed"] = not errors
    checks["upgrade_each_reply_its_versions_reference"] = all(
        np.array_equal(out[0], ref[info["version"]][i])
        for i, out, info, _, _ in done)
    checks["upgrade_both_versions_served"] = set(versions) == {1, 2}
    checks["upgrade_activations_no_nvcc"] = (
        len(acts) == FLEET["workers"]
        and all("error" not in a and a["kernel_builds"] == 0
                and a["store_misses"] == 0 for a in acts))
    stats["upgrade"] = dict(
        requests=len(done), errors=errors[:3], wall_s=wall,
        served_by={v: versions.count(v) for v in (1, 2)},
        fanout_s=rep["fanout_s"], activations=acts)


def fleet_kill(r, prompts, news, ref, checks, stats):
    """(5) SIGKILL worker 1 while it holds a request, under traffic and a
    router tracer: no failed request, a retry, a postmortem, and the
    restarted worker replaying v2 without nvcc and serving equal
    replies.  Returns the killed request's trace id (or None)."""
    import threading
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer
    r.tracer = Tracer(capacity=1024)
    stop = threading.Event()
    retries0 = r.retries_total
    done, errors, workers, t0 = fleet_drive(
        lambda i: r.generate_ex("lm", [prompts[i]], news[i],
                                **fleet_sampling(i)),
        len(prompts), FLEET["threads"], stop=stop)
    recovery_s = t_kill = None
    try:
        while ((len(done) < FLEET["kill_after"]
                or r.handles[1].outstanding == 0) and not errors
               and time.perf_counter() - t0 < FLEET["wait_s"]):
            time.sleep(0.001)
        t_kill = time.perf_counter()
        r.supervisor.kill(1)
        while time.perf_counter() - t_kill < FLEET["wait_s"]:
            w = r.supervisor.worker(1)
            if w.incarnation >= 1 and r.handles[1].routable:
                recovery_s = time.perf_counter() - t_kill
                break
            time.sleep(0.01)
        n_at = len(done)
        while (len(done) < n_at + FLEET["after_recovery"] and not errors
               and time.perf_counter() - t0 < FLEET["wait_s"]):
            time.sleep(0.01)
    finally:
        stop.set()
        wall = fleet_join(workers, t0, FLEET["wait_s"])
    spans = [r.tracer.find(info["request_id"]) for _, _, info, _, _ in done]
    after = [sd for (_, _, _, ts, _), sd in zip(done, spans)
             if recovery_s is not None and ts > t_kill + recovery_s]
    retried = [sd for sd in spans if sd and sd["labels"].get("retried")]
    pm = os.path.join(r.supervisor.run_dir, "worker_postmortem.r1.i0.json")
    replay = r.replays.get(1) or []
    checks["kill_zero_failed"] = not errors
    checks["kill_replies_equal_reference"] = all(
        np.array_equal(out[0], ref[info["version"]][i])
        for i, out, info, _, _ in done)
    checks["kill_retried_on_sibling"] = r.retries_total - retries0 >= 1
    checks["kill_postmortem_written"] = (
        pm in r.supervisor.postmortems and os.path.exists(pm))
    # the package copy's build directory is gone (fleet_drop_builds):
    # the restarted worker's libraries come from the store
    checks["kill_replay_loads_the_store_no_nvcc"] = (
        recovery_s is not None and len(replay) == 1
        and replay[0]["model"] == "lm" and replay[0]["version"] == 2
        and replay[0]["kernel_builds"] == 0
        and replay[0]["store_misses"] == 0
        and replay[0]["store_hits"] > 0)
    checks["kill_restarted_worker_serves_equal"] = any(
        sd["labels"].get("worker") == 1 for sd in after if sd)
    stats["kill"] = dict(
        requests=len(done), errors=errors[:3], wall_s=wall,
        recovery_s=recovery_s, retries=r.retries_total - retries0,
        replay=replay, retried_requests=len(retried),
        served_by_restarted=sum(1 for sd in after
                                if sd and sd["labels"].get("worker") == 1))
    return retried[0] if retried else None


def fleet_trace(r, killed, checks, stats, tmp):
    """(6) The killed request stitched offline from the flight directory
    (``harvest_legs`` + ``stitch``, then the CLI once), and the traced
    closed-loop rate against the untraced."""
    import numpy as np
    from analytics_zoo_tpu_torch.observability import Tracer, tracefleet
    flight = r.supervisor.flight_dir()
    st, cli = None, None
    if killed is not None:
        tid = killed["trace_id"]
        deadline = time.monotonic() + 60
        legs = []
        while not legs and time.monotonic() < deadline:
            legs = tracefleet.harvest_legs(flight, trace_id=tid)
            if not legs:
                time.sleep(0.1)
        st = tracefleet.stitch(killed, legs)
        ring = os.path.join(tmp, "fleet", "router_ring.json")
        tracefleet.dump_ring(r.tracer, ring)
        repo = os.path.dirname(os.path.abspath(__file__))
        cli = subprocess.run(
            [sys.executable, "-m",
             "analytics_zoo_tpu_torch.observability.tracefleet", flight,
             "--router", ring, "--trace", tid],
            env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
            text=True, timeout=120)
        log("fleet: waterfall of the killed request:\n" + cli.stdout)
    checks["trace_killed_request_attributed"] = (
        st is not None and st["stitched_legs"] >= 1
        and st["attributed_fraction"] >= FLEET["attribution"])
    checks["trace_cli_stitches"] = (
        cli is not None and cli.returncode == 0
        and f"trace {killed['trace_id']}" in cli.stdout)
    # closed-loop rate, untraced and traced in turns (ABBA)
    rng = np.random.default_rng(9)
    short = [rng.integers(0, FULL["vocab_size"], FLEET["traced_prompt"])
             for _ in range(FLEET["traced_requests"])]
    rates = {"untraced": [], "traced": []}
    for _ in range(FLEET["traced_rounds"]):
        for mode in ("untraced", "traced", "traced", "untraced"):
            r.tracer = Tracer(capacity=256) if mode == "traced" else None
            done, errors, workers, t0 = fleet_drive(
                lambda i: r.generate_ex("lm", [short[i]],
                                        FLEET["traced_new"]),
                len(short), FLEET["threads"])
            wall = fleet_join(workers, t0, FLEET["wait_s"])
            if errors:
                raise RuntimeError(f"closed loop failed: {errors[:3]}")
            rates[mode].append(len(done) / wall)
    r.tracer = None
    ratio = sum(rates["traced"]) / sum(rates["untraced"])
    checks["trace_traced_rate_at_least_0_95"] = ratio >= FLEET["traced_ratio"]
    stats["trace"] = dict(
        killed_trace_id=killed and killed["trace_id"],
        attributed_fraction=st and st["attributed_fraction"],
        stitched_legs=st and st["stitched_legs"],
        partial=st and st["partial"], skew_s=st and st["skew_s"],
        cli_rc=cli and cli.returncode, rates=rates, traced_ratio=ratio)


def phase_fleet(torch, kernels, tmp):
    """The serving fleet on the card: the serve phase's full-width
    TransformerLM deployed through ``FleetRouter(n_workers=2,
    device="cuda")`` (workers from a fresh copy of the package): deploy,
    generate, predict on both wires, a rolling upgrade, a SIGKILL,
    tracing and the scrape, each held to the single-process registry."""
    import gc
    import numpy as np
    from analytics_zoo_tpu_torch import serving
    from analytics_zoo_tpu_torch.serving.fleet import FleetRouter, builders
    stats, checks = {"card": smi_card()}, {}
    root = os.path.join(tmp, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    pkg = fleet_package(root)
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    prompts, news = mixed_requests(cfg, np.random.default_rng(2))
    prompts, news = prompts[:FLEET["requests"]], news[:FLEET["requests"]]
    rng = np.random.default_rng(4)
    x2 = rng.integers(0, FULL["vocab_size"],
                      (2, SERVE["max_len"])).astype(np.int32)
    xs = {1: x2[:1].copy(), 2: x2}
    t = time.perf_counter()
    ref_streams, ref_predict, stats["reference"] = fleet_reference(
        torch, serving, builders, prompts, news, xs)
    stats["reference_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    r = FleetRouter(os.path.join(root, "share"), n_workers=FLEET["workers"],
                    device="cuda", env=fleet_env(pkg),
                    max_restarts=2, restart_backoff=0.5,
                    call_timeout_s=FLEET["call_timeout"])
    launches = dict.fromkeys(kernels.KERNELS, 0)
    try:
        t = time.perf_counter()
        r.start(timeout=FLEET["start_timeout"])
        stats["start_s"] = time.perf_counter() - t
        # (1) deploy: the first activation builds, the second does not
        rep = r.deploy("lm", None, FLEET_BUILDER, fleet_args(0),
                       warmup_shapes=(SERVE["max_len"],),
                       deploy_kwargs=FLEET_DEPLOY)
        acts = rep["activations"]
        stats["deploy"] = dict(fanout_s=rep["fanout_s"], activations=acts)
        for a in acts:
            log(f"fleet: activation rank {a['rank']}: "
                + json.dumps({k: a.get(k) for k in (
                    "warm_ms", "kernel_builds", "signature_builds",
                    "graph_captures", "store_hits", "store_misses",
                    "error")}))
        log(f"fleet: fanout_s {rep['fanout_s']}")
        checks["deploy_all_activated"] = (
            len(acts) == FLEET["workers"]
            and all("error" not in a for a in acts))
        checks["deploy_first_builds_with_store_miss"] = bool(acts) and (
            acts[0].get("kernel_builds", 0) > 0
            and acts[0].get("store_misses", 0) > 0)
        checks["deploy_second_no_nvcc_no_store_miss"] = all(
            a.get("kernel_builds") == 0 and a.get("store_misses") == 0
            for a in acts[1:])
        # rank 1 loaded rank 0's libraries from the shared build
        # directory; drop it so that the SIGKILL's replay reads the store
        stats["dropped_libraries"] = fleet_drop_builds(pkg)
        checks["deploy_built_in_the_package_copy"] = (
            len(stats["dropped_libraries"]) == len(kernels._SIGNATURES))
        kernels.reset_launch_counts()
        launches["flash_fwd"] += fleet_generate(
            torch, r, kernels, prompts, news, ref_streams, checks, stats)
        launches["flash_fwd"] += fleet_predict(torch, r, xs, ref_predict,
                                               checks, stats)
        stats["router_launches"] = kernels.launch_counts()
        checks["router_process_launched_nothing"] = not any(
            stats["router_launches"].values())
        fleet_upgrade(r, prompts, news, ref_streams, checks, stats)
        killed = fleet_kill(r, prompts, news, ref_streams, checks, stats)
        fleet_trace(r, killed, checks, stats, tmp)
        # (7) the scrape: both ranks' families and the fleet's own
        parsed = fleet_scrape(r)
        names = {name for name, _ in parsed["samples"]}
        ranks = {dict(labels).get("rank")
                 for name, labels in parsed["samples"]
                 if name == "zoo_model_requests_total"}
        checks["scrape_both_ranks_and_fleet_families"] = (
            {"0", "1"} <= ranks
            and {"zoo_fleet_workers", "zoo_fleet_router_retries_total",
                 "zoo_fleet_deploy_fanout_seconds",
                 "zoo_fleet_wire_bytes_total",
                 "zoo_fleet_affinity_total"} <= names)
        stats["scrape"] = dict(families=len(parsed["types"]),
                               samples=len(parsed["samples"]),
                               ranks=sorted(r for r in ranks if r))
    except Exception:
        fleet_log_tail(r)
        raise
    finally:
        r.close()
    if not all(checks.values()):
        fleet_log_tail(r)
    gen, ref = stats.get("generate", {}), stats["reference"]
    stats.update(
        launches=launches, checks=checks,
        requests_per_s=gen.get("requests_per_s"),
        ref_requests_per_s=ref["requests_per_s"],
        ttft_ms_median=gen.get("ttft_ms_median"),
        ref_ttft_ms_median=ref["ttft_ms_median"],
        itl_ms_median=gen.get("itl_ms_median"),
        ref_itl_ms_median=ref["itl_ms_median"],
        first_activation_kernel_builds=(stats.get("deploy", {}).get(
            "activations") or [{}])[0].get("kernel_builds"),
        warm_ms=[a.get("warm_ms") for a in stats.get("deploy", {}).get(
            "activations", [])],
        fanout_s=stats.get("deploy", {}).get("fanout_s"),
        predict_ms_p50={w: stats.get(f"predict_{w}", {}).get("ms_p50")
                        for w in ("binary", "json")},
        recovery_s=stats.get("kill", {}).get("recovery_s"),
        attributed_fraction=stats.get("trace", {}).get(
            "attributed_fraction"),
        traced_ratio=stats.get("trace", {}).get("traced_ratio"))
    for name, good in checks.items():
        if not good:
            log(f"fleet: FAIL {name}")
    log("fleet:", json.dumps(stats, default=str))
    return all(checks.values()), stats


STREAM = dict(chunk=3, shuffle_buffer=32, steps=4, data_seed=2)


def stream_factory(x, y, chunk, pulls):
    """A zero-argument factory of (x, y) chunks of ``chunk`` rows (the
    stream a user's reader yields); each chunk's host seconds go to
    ``pulls``."""
    def make():
        for i in range(0, len(x), chunk):
            t = time.perf_counter()
            part = x[i:i + chunk].copy(), y[i:i + chunk].copy()
            pulls.append(time.perf_counter() - t)
            yield part
    return make


def recorded(ds, store):
    """``ds`` whose ``batches()`` copies every batch it emits to
    ``store`` (the fit's own batches, in order)."""
    emit = ds.batches

    def batches(*a, **kw):
        for bx, by in emit(*a, **kw):
            store.append((bx.copy(), by.copy()))
            yield bx, by

    ds.batches = batches
    return ds


def stream_fit(torch, TransformerLM, kernels, data, steps):
    """A full-width model (the train phase's: seed 0, adam) after one
    warm-up step, then one epoch of ``data`` (a Dataset); the losses,
    the wall seconds of the epoch, the launch counts of the epoch (and
    the same by design) and the model."""
    cfg = dict(FULL, seq_len=TRAIN_SEQ)
    model = TransformerLM(**cfg, device="cuda", seed=0)
    model.compile({"name": "adam", "lr": TRAIN_LR}, "class_nll")
    wx, wy = periodic_tokens(TRAIN_BATCH, cfg["vocab_size"], TRAIN_SEQ,
                             seed=1)
    model.fit(wx, wy, batch_size=TRAIN_BATCH, shuffle=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(data, batch_size=TRAIN_BATCH, nb_epoch=1,
                     shuffle=data.__class__.__name__ == "StreamingDataset")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (hist["loss"], wall, kernels.launch_counts(),
            kernels.launch_counts_by_design(), model)


def phase_stream(torch, TransformerLM, kernels):
    """The train phase's model fitted from a stream: one warm-up step,
    then 4 steps from ``Dataset.from_batch_iterable`` over
    ``periodic_tokens`` rows in ragged chunks of 3 with a windowed
    shuffle of 32 rows; then a second model from the same weights fitted
    from ``Dataset.from_ndarray`` over the batches the stream emitted
    (collected on the host, ``shuffle=False``), whose losses and weights
    must equal the stream's bit for bit.  Each kernel 12 times a step in
    both."""
    import numpy as np
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    steps, chunk = STREAM["steps"], STREAM["chunk"]
    x, y = periodic_tokens(TRAIN_BATCH * steps, FULL["vocab_size"],
                           TRAIN_SEQ, seed=STREAM["data_seed"])
    pulls, emitted = [], []
    ds = recorded(Dataset.from_batch_iterable(
        stream_factory(x, y, chunk, pulls),
        shuffle_buffer=STREAM["shuffle_buffer"]), emitted)
    losses, wall, counts, by_design, stream_model = stream_fit(
        torch, TransformerLM, kernels, ds, steps)
    n_pulls = len(pulls)
    # the host side alone: pulling and rebatching one epoch, no device
    t = time.perf_counter()
    host = list(Dataset.from_batch_iterable(
        stream_factory(x, y, chunk, []),
        shuffle_buffer=STREAM["shuffle_buffer"]).batches(
            TRAIN_BATCH, shuffle=True, seed=0, epoch=1))
    host_s = time.perf_counter() - t
    same_order = len(host) == len(emitted) and all(
        np.array_equal(a[0], b[0]) for a, b in zip(host, emitted))
    bx = np.concatenate([b[0] for b in emitted])
    by = np.concatenate([b[1] for b in emitted])
    ref_losses, ref_wall, ref_counts, _, ref_model = stream_fit(
        torch, TransformerLM, kernels, Dataset.from_ndarray(bx, by), steps)
    weights_equal = all(torch.equal(a, b) for a, b in zip(
        stream_model.parameters(), ref_model.parameters()))
    del stream_model, ref_model
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = dict(
        steps=len(losses), losses=losses, memory_losses=ref_losses,
        losses_bitwise=losses == ref_losses, weights_bitwise=weights_equal,
        emitted_batches=len(emitted), emitted_rows=int(len(bx)),
        chunks_pulled=n_pulls, stream_order_replayed=same_order,
        step_ms=wall / max(len(losses), 1) * 1e3,
        memory_step_ms=ref_wall / steps * 1e3,
        tokens_per_s=tokens * len(losses) / wall,
        memory_tokens_per_s=tokens * steps / ref_wall,
        host_pull_ms_per_batch=host_s / max(len(host), 1) * 1e3,
        host_chunk_ms=sum(pulls) / max(len(pulls), 1) * 1e3,
        launches=counts, launches_by_design=by_design,
        memory_launches=ref_counts, launches_per_step={n: c / steps for n, c in counts.items()},
        card=smi_card())
    log("stream:", json.dumps(stats))
    checks = {
        "steps": len(losses) == steps and len(ref_losses) == steps,
        "finite_and_falling": all(math.isfinite(v) for v in losses)
        and losses[-1] < losses[0],
        "losses_bitwise": losses == ref_losses,
        "weights_bitwise": weights_equal,
        "stream_order_replayed": same_order,
        "rows": sorted(map(tuple, bx.tolist())) == sorted(
            map(tuple, x.tolist())),
    }
    for name in KERNELS:
        want = FULL["n_layers"] * steps
        checks[f"{name}_12_a_step"] = counts[name] == want \
            and ref_counts[name] == want
    for k, v in checks.items():
        if not v:
            log(f"stream: FAIL {k}")
    stats["checks"] = checks
    return all(checks.values()), stats


# ---- interop: ONNX, a TF GraphDef and nnframes on the card ----------------

INTEROP = dict(batch=32, size=224, classes=1000, tune_batch=8, tune_lr=0.01,
               frame_rows=2048, frame_features=784, frame_classes=10,
               frame_hidden=200, frame_epochs=2, frame_batch=128,
               reps=10)
#: predictions within 1e-4 of the CPU (Queue 3's Winograd note); a
#: fine-tuning step's change, each f32 path's, within 5e-4 of the f64
#: change over its largest entry (13 chained convolutions' weight
#: gradients, each summing up to 100,352 products in f32)
INTEROP_TOL = dict(onnx=1e-4, tune=5e-4, tf=1e-4, frame=1e-5)


def resnet_stage1_onnx(P, size, classes, seed=0):
    """ResNet-50's stem and stage 1 at its widths, as an ONNX model built
    with the port's codec: 7x7/2 conv 64, BN, ReLU, 3x3/2 max pool; three
    bottlenecks 64-64-256 (a projection shortcut on the first); global
    average pool, Gemm 256 -> ``classes``, softmax.  Weights from
    ``seed`` (He-scaled convolutions, a head of std 0.01); BN statistics
    near 0 and 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    inits, nodes = [], []

    def conv(name, x, cin, cout, k, stride=1, pad=0):
        w = (rng.normal(size=(cout, cin, k, k))
             * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
        inits.append(P.numpy_to_tensor(w, f"{name}_w"))
        nodes.append(P.make_node("Conv", [x, f"{name}_w"], [name],
                                 kernel_shape=[k, k], strides=[stride] * 2,
                                 pads=[pad] * 4))
        return name

    def bn(name, x, c, relu=True):
        for part, v in (("s", rng.uniform(0.5, 1.5, c)),
                        ("b", rng.normal(0, 0.1, c)),
                        ("m", rng.normal(0, 0.1, c)),
                        ("v", rng.uniform(0.5, 1.5, c))):
            inits.append(P.numpy_to_tensor(v.astype(np.float32),
                                           f"{name}_{part}"))
        nodes.append(P.make_node(
            "BatchNormalization",
            [x] + [f"{name}_{p}" for p in "sbmv"], [f"{name}_bn"],
            epsilon=1e-5))
        if not relu:
            return f"{name}_bn"
        nodes.append(P.make_node("Relu", [f"{name}_bn"], [f"{name}_r"]))
        return f"{name}_r"

    h = bn("conv1", conv("conv1", "x", 3, 64, 7, 2, 3), 64)
    nodes.append(P.make_node("MaxPool", [h], ["pool1"], kernel_shape=[3, 3],
                             strides=[2, 2], pads=[1, 1, 1, 1]))
    h, cin = "pool1", 64
    for b in range(3):
        p = f"res2{'abc'[b]}"
        a = bn(f"{p}_1", conv(f"{p}_1", h, cin, 64, 1), 64)
        a = bn(f"{p}_2", conv(f"{p}_2", a, 64, 64, 3, pad=1), 64)
        a = bn(f"{p}_3", conv(f"{p}_3", a, 64, 256, 1), 256, relu=False)
        short = (bn(f"{p}_proj", conv(f"{p}_proj", h, cin, 256, 1), 256,
                    relu=False) if b == 0 else h)
        nodes.append(P.make_node("Add", [a, short], [f"{p}_sum"]))
        nodes.append(P.make_node("Relu", [f"{p}_sum"], [f"{p}_out"]))
        h, cin = f"{p}_out", 256
    nodes.append(P.make_node("GlobalAveragePool", [h], ["gap"]))
    nodes.append(P.make_node("Flatten", ["gap"], ["flat"], axis=1))
    # a small head: the softmax stays off the loss's clip, so a step has
    # gradients
    fc = (rng.normal(size=(classes, 256)) * 0.01).astype(np.float32)
    inits += [P.numpy_to_tensor(fc, "fc_w"),
              P.numpy_to_tensor(np.zeros(classes, np.float32), "fc_b")]
    nodes.append(P.make_node("Gemm", ["flat", "fc_w", "fc_b"], ["logits"],
                             transB=1))
    nodes.append(P.make_node("Softmax", ["logits"], ["probs"], axis=-1))
    graph = P.make_graph(nodes, "resnet50_stage1",
                         [P.make_value_info("x", ("N", 3, size, size))],
                         [P.make_value_info("probs", ("N", classes))],
                         initializer=inits)
    return P.encode(P.make_model(graph))


def nhwc_graph_def(TP, classes, seed=0):
    """An NHWC GraphDef built with the port's codec: Conv2D SAME stride 2
    (7x7, 32), FusedBatchNormV3, Relu, MaxPool SAME 3x3/2, Conv2D 3x3 64
    with BiasAdd, Mean over H and W, MatMul 64 -> ``classes``,
    Softmax."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def w(*shape, fan):
        return (rng.normal(size=shape) * np.sqrt(2.0 / fan)).astype(f32)

    nodes = [
        TP.placeholder("image", (None, None, None, 3)),
        TP.const("k1", w(7, 7, 3, 32, fan=147)),
        TP.make_node("Conv2D", "conv1", ["image", "k1"], T=f32,
                     strides=[1, 2, 2, 1], padding="SAME",
                     data_format="NHWC", dilations=[1, 1, 1, 1]),
        TP.const("bn_s", rng.uniform(0.5, 1.5, 32).astype(f32)),
        TP.const("bn_b", rng.normal(0, 0.1, 32).astype(f32)),
        TP.const("bn_m", rng.normal(0, 0.1, 32).astype(f32)),
        TP.const("bn_v", rng.uniform(0.5, 1.5, 32).astype(f32)),
        TP.make_node("FusedBatchNormV3", "bn1",
                     ["conv1", "bn_s", "bn_b", "bn_m", "bn_v"], T=f32,
                     U=f32, epsilon=1e-3, data_format="NHWC",
                     is_training=False),
        TP.make_node("Relu", "relu1", ["bn1"], T=f32),
        TP.make_node("MaxPool", "pool1", ["relu1"], T=f32,
                     ksize=[1, 3, 3, 1], strides=[1, 2, 2, 1],
                     padding="SAME", data_format="NHWC"),
        TP.const("k2", w(3, 3, 32, 64, fan=288)),
        TP.make_node("Conv2D", "conv2", ["pool1", "k2"], T=f32,
                     strides=[1, 1, 1, 1], padding="SAME",
                     data_format="NHWC", dilations=[1, 1, 1, 1]),
        TP.const("b2", rng.normal(0, 0.1, 64).astype(f32)),
        TP.make_node("BiasAdd", "bias2", ["conv2", "b2"], T=f32,
                     data_format="NHWC"),
        TP.const("axes", np.array([1, 2], np.int32)),
        TP.make_node("Mean", "gap", ["bias2", "axes"], T=f32, Tidx=np.int32,
                     keep_dims=False),
        TP.const("fc", w(64, classes, fan=64)),
        TP.make_node("MatMul", "logits", ["gap", "fc"], T=f32,
                     transpose_a=False, transpose_b=False),
        TP.make_node("Softmax", "probs", ["logits"], T=f32),
    ]
    return TP.encode(TP.make_graph(nodes))


def split_ms(torch, fn, reps):
    """Host ms of one call (the launches queued, not waited for) and its
    device ms (CUDA events around it), medians of ``reps``."""
    import statistics
    host, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def predict_timing(torch, fn, rows, reps):
    """Median synchronised ms of ``fn()`` and the rows a second."""
    import statistics
    _, times = timed(torch, fn, reps)
    ms = statistics.median(times) * 1e3
    return ms, rows / ms * 1e3


def max_rel(a, b):
    """max|a - b| / max|b| over numpy arrays."""
    import numpy as np
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def interop_onnx(torch, inference, tmp, stats, checks):
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.api.net import Net
    from analytics_zoo_tpu_torch.pipeline.api.onnx import proto as P
    from analytics_zoo_tpu_torch.pipeline.api.keras import (objectives,
                                                            optimizers)
    from analytics_zoo_tpu_torch.train.trainer import Trainer
    cfg = INTEROP
    path = os.path.join(tmp, "resnet50_stage1.onnx")
    with open(path, "wb") as f:
        f.write(resnet_stage1_onnx(P, cfg["size"], cfg["classes"]))
    x = np.random.default_rng(0).normal(
        size=(cfg["batch"], 3, cfg["size"], cfg["size"])).astype(np.float32)
    net = Net.load_onnx(path)
    cpu = Net.load_onnx(path, device="cpu")
    on_card = all(p.device.type == "cuda" for p in net.parameters())
    got = net.predict(x, batch_per_thread=cfg["batch"])
    ref = cpu.predict(x, batch_per_thread=cfg["batch"])
    im = inference.InferenceModel().load_keras_net(net)
    try:
        served = im.predict(x)
        ms, rows_s = predict_timing(
            torch, lambda: im.predict(x), cfg["batch"], cfg["reps"])
    finally:
        im.close()
    xt = torch.as_tensor(x, device="cuda")
    net.eval()
    with torch.no_grad():
        host_ms, dev_ms = split_ms(torch, lambda: net(xt), cfg["reps"])
    # one fine-tuning step from the same weights on the card, on the CPU
    # and in f64 on the CPU (the exact change the two f32 paths are held
    # to)
    from analytics_zoo_tpu_torch.data.dataset import Dataset
    labels = np.random.default_rng(1).integers(
        0, cfg["classes"], cfg["tune_batch"]).astype(np.int32)
    exact = Net.load_onnx(path, device="cpu").double()
    xb = x[:cfg["tune_batch"]]
    losses, changes = [], []
    for model, xs in ((net, xb), (cpu, xb), (exact, xb.astype(np.float64))):
        before = [p.detach().cpu().clone() for p in model.parameters()]
        tr = Trainer(model, objectives.get("sparse_categorical_crossentropy"),
                     optimizers.get({"name": "sgd", "lr": cfg["tune_lr"]}))
        hist = tr.fit(Dataset.from_ndarray(xs, labels), cfg["tune_batch"],
                      shuffle=False)
        losses.append(hist["loss"][0])
        changes.append([(p.detach().cpu() - b).double().numpy()
                        for p, b in zip(model.parameters(), before)])

    def change_err(got, ref):
        return max(max_rel(a, b) for a, b in zip(got, ref)
                   if np.abs(b).max() > 0)

    tune = dict(card_vs_f64=change_err(changes[0], changes[2]),
                cpu_vs_f64=change_err(changes[1], changes[2]),
                card_vs_cpu=change_err(changes[0], changes[1]))
    stats["onnx"] = dict(
        ops=sorted({n.op_type for n in P.load_model(path).graph.node}),
        params=sum(p.numel() for p in net.parameters()),
        predict_max_abs_err=float(np.abs(got - ref).max()),
        served_max_abs_err=float(np.abs(served - got).max()),
        predict_ms=ms, rows_per_s=rows_s, graph_call_host_ms=host_ms,
        graph_call_device_ms=dev_ms, tune_loss=losses[0],
        tune_loss_cpu=losses[1], tune_loss_f64=losses[2],
        tune_change_rel_err=tune)
    checks["onnx_params_on_card"] = on_card
    checks["onnx_vs_cpu"] = float(np.abs(got - ref).max()) <= \
        INTEROP_TOL["onnx"]
    checks["onnx_served"] = float(np.abs(served - got).max()) <= \
        INTEROP_TOL["onnx"]
    checks["onnx_tune_vs_f64"] = (
        max(tune["card_vs_f64"], tune["cpu_vs_f64"]) <= INTEROP_TOL["tune"]
        and all(abs(v - losses[2]) <= 1e-5 * abs(losses[2])
                for v in losses[:2]))
    del net, cpu, exact


def interop_tf(torch, inference, tmp, stats, checks):
    import numpy as np
    from analytics_zoo_tpu_torch.pipeline.api.net import Net
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph import proto as TP
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph.net import write_meta
    cfg = INTEROP
    folder = os.path.join(tmp, "nhwc_graph")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "frozen_inference_graph.pb"), "wb") as f:
        f.write(nhwc_graph_def(TP, cfg["classes"]))
    write_meta(folder, ["image:0"], ["probs:0"])
    x = np.random.default_rng(2).normal(
        size=(cfg["batch"], cfg["size"], cfg["size"], 3)).astype(np.float32)
    net = Net.load_tf(folder)
    ref = Net.load_tf(folder, device="cpu").predict(x)
    got = net.predict(x)
    im = inference.InferenceModel().load_tf(folder)
    try:
        served = im.predict(x)
        ms, rows_s = predict_timing(
            torch, lambda: im.predict(x), cfg["batch"], cfg["reps"])
    finally:
        im.close()
    xt = torch.as_tensor(x, device="cuda")
    with torch.no_grad():
        host_ms, dev_ms = split_ms(torch, lambda: net(xt), cfg["reps"])
    stats["tf"] = dict(
        predict_max_abs_err=float(np.abs(got - ref).max()),
        served_max_abs_err=float(np.abs(served - ref).max()),
        predict_ms=ms, rows_per_s=rows_s, graph_call_host_ms=host_ms,
        graph_call_device_ms=dev_ms)
    checks["tf_vs_cpu"] = float(np.abs(got - ref).max()) <= \
        INTEROP_TOL["tf"]
    checks["tf_served_vs_cpu"] = float(np.abs(served - ref).max()) <= \
        INTEROP_TOL["tf"]
    checks["tf_shape"] = got.shape == (cfg["batch"], cfg["classes"])


class ColumnFrame(dict):
    """A dataframe of numpy columns: what ``NNEstimator`` reads of a
    frame (``df[col].tolist()``, ``columns``, ``copy()``), where pandas
    is absent."""

    @property
    def columns(self):
        return list(self)

    def copy(self):
        return ColumnFrame(self)


def mnist_like(rows, features, classes, seed=0):
    """Rows of ``features`` values in [0, 1], a noisy prototype a class
    (learnable in a few epochs), and their labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, (classes, features))
    labels = rng.integers(0, classes, rows)
    x = np.clip(protos[labels] + rng.normal(0, 0.3, (rows, features)), 0, 1)
    return x.astype(np.float32), labels.astype(np.float32)


def mnist_mlp(keras, cfg, device):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    m = keras.Sequential(device=device, seed=0)
    m.add(Dense(cfg["frame_hidden"], activation="relu",
                input_shape=(cfg["frame_features"],), name="fc1"))
    m.add(Dense(cfg["frame_classes"], activation="softmax", name="fc2"))
    return m


def interop_frame(torch, keras, tmp, stats, checks):
    import numpy as np
    from analytics_zoo_tpu_torch.models.jax_params import (from_jax_params,
                                                           to_jax_params)
    from analytics_zoo_tpu_torch.pipeline.estimator import (NNClassifier,
                                                            NNModel)
    cfg = INTEROP
    x, y = mnist_like(cfg["frame_rows"], cfg["frame_features"],
                      cfg["frame_classes"])
    frame = ColumnFrame(features=x, label=y)
    model = mnist_mlp(keras, cfg, "cuda")
    clf = (NNClassifier(model, "sparse_categorical_crossentropy")
           .set_batch_size(cfg["frame_batch"])
           .set_max_epoch(cfg["frame_epochs"])
           .set_optim_method("adam").set_learning_rate(1e-3))
    torch.cuda.synchronize()
    t = time.perf_counter()
    fitted = clf.fit(frame)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    out = fitted.transform(frame)
    preds = np.asarray(out["prediction"])
    probs = fitted.trainer.predict(x, cfg["frame_batch"])
    cpu = mnist_mlp(keras, cfg, "cpu")
    from_jax_params(cpu, to_jax_params(model))
    cpu_probs = cpu.predict(x, batch_size=cfg["frame_batch"])
    fitted.save(os.path.join(tmp, "nnmodel"))
    loaded = NNModel.load(os.path.join(tmp, "nnmodel"))
    loaded_probs = loaded.trainer.predict(x, cfg["frame_batch"])
    loaded_preds = np.asarray(loaded.transform(frame)["prediction"])
    ms, rows_s = predict_timing(
        torch, lambda: fitted.transform(frame), cfg["frame_rows"],
        cfg["reps"])
    xt = torch.as_tensor(x[:cfg["frame_batch"]], device="cuda")
    model.eval()
    with torch.no_grad():
        host_ms, dev_ms = split_ms(torch, lambda: model(xt), cfg["reps"])
    acc = float(np.mean(preds == y))
    stats["frame"] = dict(
        rows=cfg["frame_rows"], accuracy=acc, fit_s=fit_s,
        fit_rows_per_s=cfg["frame_rows"] * cfg["frame_epochs"] / fit_s,
        cpu_max_abs_err=float(np.abs(probs - cpu_probs).max()),
        cpu_labels_equal=bool(np.array_equal(preds, np.argmax(
            cpu_probs, 1).astype(np.float32))),
        saved_bits_equal=bool(np.array_equal(loaded_probs, probs)),
        transform_ms=ms, rows_per_s=rows_s, graph_call_host_ms=host_ms,
        graph_call_device_ms=dev_ms)
    checks["frame_learned"] = acc > 0.5
    checks["frame_vs_cpu"] = float(np.abs(probs - cpu_probs).max()) <= \
        INTEROP_TOL["frame"]
    checks["frame_cpu_labels"] = stats["frame"]["cpu_labels_equal"]
    checks["frame_save_load_bits"] = stats["frame"]["saved_bits_equal"] \
        and np.array_equal(loaded_preds, preds)


def phase_interop(torch, keras, kernels, inference, tmp):
    """Model interop on the card: an ONNX ResNet-50 stem and stage 1
    (batch 32 at 224x224) built with the port's codec, through
    ``Net.load_onnx`` and an InferenceModel handle, against the port's
    CPU conversion of the same bytes, and one fine-tuning step on the
    card and on the CPU against one in f64; an NHWC GraphDef through ``Net.load_tf`` and
    ``InferenceModel.load_tf`` against the CPU; an ``NNClassifier`` on a
    frame of numpy columns (2,048 rows of 784 features, the MNIST MLP)
    for 2 epochs, its predictions against a CPU copy of the trained
    weights and a save/load.  Predict ms, rows/s, and a converted-graph
    call's host ms beside its device ms for each.  No flash kernel is on
    these paths: their launches are counted and must be 0."""
    stats, checks = {}, {}
    kernels.reset_launch_counts()
    for part in (interop_onnx, interop_tf):
        part(torch, inference, tmp, stats, checks)
    interop_frame(torch, keras, tmp, stats, checks)
    stats["launches"] = kernels.launch_counts()
    checks["no_flash_launch"] = not any(stats["launches"].values())
    torch.cuda.empty_cache()
    stats["card"] = smi_card()
    stats["checks"] = checks
    log("interop:", json.dumps(stats))
    for k, v in checks.items():
        if not v:
            log(f"interop: FAIL {k}")
    return all(checks.values()), stats


SANITIZE = dict(seq=128, rows=(1, 4), max_batch=4, predict_requests=32,
                threads=4, decode_requests=16, max_new=8, bad_seq=64)


def sanitize_predict(handle, kernels, sanitize, closed_loop, xs):
    """One predict window unsanitized (it also fills the staging rings),
    then the same window under ``sanitize(max_compiles=0,
    invariants=...)``: (requests/s off, on, the report, flash_fwd
    launches on, outputs well-formed and in pageable memory, errors,
    host memory before the windows and after them with the replies
    held)."""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.tools.zoolint.sanitizer import host_memory

    def gauges():
        st = handle.serving_stats()
        return {"pending": st["coalescer_pending"],
                "unhealthy": sum(st.get("replica_unhealthy", {}).values())}

    mem = [host_memory()]
    _, off_s, err_off = closed_loop(handle.predict, xs, SANITIZE["threads"])
    kernels.reset_launch_counts()
    with sanitize(max_compiles=0, invariants=gauges,
                  label="sanitize predict") as rep:
        outs, on_s, err_on = closed_loop(handle.predict, xs,
                                         SANITIZE["threads"])
    launches = kernels.launch_counts()["flash_fwd"]
    by_design = kernels.launch_counts_by_design()
    mem.append(dict(host_memory(), replies_bytes=sum(
        o.nbytes for o in outs if o is not None)))
    good = not err_on and all(
        o is not None and o.shape == x.shape + (FULL["vocab_size"],)
        and np.isfinite(o).all() and not torch.from_numpy(o).is_pinned()
        for o, x in zip(outs, xs))
    return (len(xs) / off_s, len(xs) / on_s, rep, launches, by_design,
            good, err_off + err_on, mem)


def phase_sanitize(torch, TransformerLM, kernels, inference):
    """The runtime sanitizer on the card at full width (the serve phase's
    model): warmed predict windows (one card, and two replicas of it)
    and a warmed decode window under ``sanitize(max_compiles=0)`` — no
    build of any kind, level invariants, no implicit sync under
    ``set_sync_debug_mode("error")`` — then the negatives: a new bucket
    raises ``RecompileDetected`` naming ``signature_build``, an injected
    ``.item()`` raises, and the sync mode and the listener are gone
    after."""
    import collections
    import gc
    import numpy as np
    from analytics_zoo_tpu_torch.observability import profile
    from analytics_zoo_tpu_torch.tools.zoolint import closed_loop, sanitize
    S = SANITIZE
    cfg = dict(FULL, seq_len=SERVE["max_len"])
    model = TransformerLM(**cfg, device="cuda", seed=0).eval()
    mode0 = torch.cuda.get_sync_debug_mode()
    rng = np.random.default_rng(21)
    xs = [rng.integers(0, cfg["vocab_size"], (int(n), S["seq"]),
                       dtype=np.int32)
          for n in rng.integers(S["rows"][0], S["rows"][1] + 1,
                                S["predict_requests"])]
    checks, stats = {}, {}
    handles = {
        "solo": inference.InferenceModel(
            supported_concurrent_num=S["threads"],
            max_batch_size=S["max_batch"], coalescing=True,
            decode_capacity=SERVE["capacity"],
            decode_max_len=SERVE["max_len"],
            decode_prompt_buckets=SERVE["buckets"]),
        "replicas": inference.InferenceModel(
            supported_concurrent_num=S["threads"],
            max_batch_size=S["max_batch"], coalescing=True,
            replicas=["cuda:0", "cuda:0"])}
    launches, by_design = {}, collections.Counter()
    try:
        for name, h in handles.items():
            h.load_keras_net(model)
            h.warmup((S["seq"],), np.int32)
            off, on, rep, n, designs, good, errors, mem = sanitize_predict(
                h, kernels, sanitize, closed_loop, xs)
            launches[f"predict_{name}"] = n
            by_design.update(designs)
            stats[f"predict_{name}"] = dict(
                requests_per_s_unsanitized=off, requests_per_s=on,
                compiles=rep.by_kind, flash_fwd_launches=n, errors=errors,
                host_memory=mem)
            checks[f"predict_{name}"] = (good and not errors
                                         and rep.compiles == 0 and n > 0)

        # (b) the decode engine, warmed at every occupancy 1..capacity
        h = handles["solo"]
        engine = h.decode_engine
        for k in range(1, SERVE["capacity"] + 1):
            h.generate([rng.integers(0, cfg["vocab_size"], 16 + i)
                        for i in range(k)], [4] * k, timeout=120)
        prompts = [rng.integers(0, cfg["vocab_size"], int(L))
                   for L in rng.integers(16, SERVE["buckets"][-1] + 1,
                                         S["decode_requests"])]
        news = [S["max_new"]] * len(prompts)

        def decode_window():
            t = time.perf_counter()
            outs = h.generate(prompts, news, timeout=300)
            return outs, sum(len(o) for o in outs) / (time.perf_counter()
                                                      - t)

        ref, tps_off = decode_window()
        before = engine.stats()
        kernels.reset_launch_counts()
        with sanitize(max_compiles=0, label="sanitize decode",
                      invariants=lambda: {
                          "slots": engine.stats()["slots_active"]}) as rep:
            outs, tps_on = decode_window()
        flash = kernels.launch_counts()["flash_fwd"]
        by_design.update(kernels.launch_counts_by_design())
        after = engine.stats()
        admitted = after["admitted"] - before["admitted"]
        launches["decode"] = flash
        same = all(np.array_equal(a, b) for a, b in zip(outs, ref))
        stats["decode"] = dict(tokens_per_s_unsanitized=tps_off,
                               tokens_per_s=tps_on, compiles=rep.by_kind,
                               admitted=admitted, flash_fwd_launches=flash,
                               greedy_equal_unsanitized=same,
                               captures=after["captures"])
        checks["decode"] = (same and rep.compiles == 0
                            and admitted == len(prompts)
                            and flash == cfg["n_layers"] * admitted
                            and after["captures"] == before["captures"])

        # (c) negatives: a new bucket (a signature never warmed) under
        # the full guard, and an injected implicit fetch
        bad = rng.integers(0, cfg["vocab_size"], (1, S["bad_seq"]),
                           dtype=np.int32)
        try:
            with sanitize(max_compiles=0, label="sanitize new bucket"):
                handles["replicas"].predict(bad)
            caught = "nothing raised"
        except Exception as e:  # RecompileDetected is the one wanted
            caught = f"{type(e).__name__}: {e}"
        stats["new_bucket"] = " ".join(caught.split())[:300]
        checks["new_bucket_recompile"] = (
            caught.startswith("RecompileDetected")
            and "signature_build" in caught)
        try:
            with sanitize(max_compiles=0, label="sanitize .item()"):
                torch.ones(4, device="cuda").sum().item()
            injected = "nothing raised"
        except RuntimeError as e:
            injected = f"{type(e).__name__}: {e}"
        stats["injected_item"] = injected[:160]
        checks["injected_item_raises"] = "synchroniz" in injected
    finally:
        for h in handles.values():
            h.close()
        del handles, model
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    stats["sync_mode"] = dict(before=mode0,
                              after=torch.cuda.get_sync_debug_mode())
    checks["sync_mode_restored"] = stats["sync_mode"]["after"] == mode0
    checks["listener_gone"] = profile.compile_listeners() == ()
    stats["launches"] = {"flash_fwd": sum(launches.values())}
    stats["launches_by_design"] = dict(by_design)
    stats["launches_by_window"] = launches
    stats["checks"] = checks
    stats["card"] = smi_card()
    log("sanitize:", json.dumps(stats))
    for name, ok in checks.items():
        if not ok:
            log(f"sanitize: FAIL {name}")
    return all(checks.values()), stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from analytics_zoo_tpu_torch import models
        from analytics_zoo_tpu_torch.models import (
            TransformerLM, from_jax_params, to_jax_params)
        from analytics_zoo_tpu_torch.models import generation
        from analytics_zoo_tpu_torch.pipeline import inference
        from analytics_zoo_tpu_torch.ops import _kernels as kernels
        from analytics_zoo_tpu_torch.ops import attention as ops_attn
        from analytics_zoo_tpu_torch.pipeline.api import keras
        from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    except ImportError as e:
        print(f"chip_smoke: analytics_zoo_tpu_torch is not importable "
              f"beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # saved models go under build/ (git ignores it), beside the kernels
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    failed = []

    t0 = time.perf_counter()
    try:
        kernels.build()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        for line in kernels.LIBRARY.build_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log("build:", line.strip())
        sass = sass_counts(kernels)
    except (RuntimeError, subprocess.SubprocessError) as e:
        log(f"build: FAIL {e}")
        return 1
    log("build: sass", json.dumps(sass))
    # the kernels' design: no atomics anywhere; the sm90 kernels on wgmma
    # and TMA, the sm90 backward (its f32 instantiations among them)
    # without mma.sync; the mma.sync kernels on
    # tensor-core MMA and cp.async, the baseline forward with ldmatrix
    # (its Q.K^T operands at both dtypes, P.V's V at bf16)
    bad = [fn for fn, c in (sass or {}).items() if "_kernel<" in fn and (
        c["ATOM"] or c["RED"] or (
            (not c["HGMMA"] or not c["UTMALDG"]
             or ("bwd" in fn and c["HMMA"])) if "sm90" in fn else (
                not c["HMMA"] or not c["LDGSTS"]
                or ("fwd" in fn and not c["LDSM"]))))]
    missing = [k for k in (*KERNELS, *(f"{k}_sm90" for k in KERNELS),
                           *(f"{k}_sm90_kernel<f32" for k in BWD_KERNELS))
               if sass is not None and not any(
                   (k if "<" in k else f"{k}_kernel<") in fn for fn in sass)]
    if bad or missing:
        log(f"build: FAIL instantiations off their design: {bad}; "
            f"kernels not found: {missing}")
        return 1

    phases = [
        ("kernels", lambda: phase_kernels(torch, ops_attn, kernels)),
        ("path", lambda: phase_path(torch, TransformerLM, kernels)),
        ("serve", lambda: phase_serve(torch, TransformerLM, keras, kernels,
                                      inference, generation)),
        ("train", lambda: phase_train(torch, TransformerLM, kernels,
                                      objectives)),
        ("small", lambda: (phase_small(torch, TransformerLM,
                                       from_jax_params, to_jax_params),
                           None)),
        ("lenet", lambda: phase_lenet(torch, keras, kernels, tmp)),
        ("graph", lambda: phase_graph(torch, keras, kernels)),
        ("mixed", lambda: phase_mixed(
            torch, TransformerLM, kernels,
            (results.get("train") or {}).get("losses"))),
        ("resnet", lambda: phase_resnet(torch, models, keras, kernels, tmp)),
        ("registry", lambda: phase_registry(torch, models, kernels)),
        ("detect", lambda: phase_detect(torch, models, kernels)),
        ("recommend", lambda: phase_recommend(torch, models, keras,
                                              kernels)),
        ("textclass", lambda: phase_textclass(torch, models, keras,
                                              kernels)),
        ("moe", lambda: phase_moe(torch, TransformerLM, kernels, inference,
                                  objectives)),
        ("image", lambda: phase_image(torch, models, keras, kernels,
                                      inference, tmp)),
        ("layers", lambda: phase_layers(torch, keras, kernels, tmp)),
        ("resume", lambda: phase_resume(torch, TransformerLM, kernels,
                                        tmp)),
        ("parallel", lambda: phase_parallel(torch, TransformerLM, kernels,
                                            tmp)),
        ("observe", lambda: phase_observe(torch, TransformerLM, keras,
                                          kernels, inference, tmp)),
        ("control", lambda: phase_control(torch, TransformerLM, keras,
                                          models, kernels, inference)),
        ("shard", lambda: phase_shard(torch, TransformerLM, kernels,
                                      inference, tmp)),
        ("fleet", lambda: phase_fleet(torch, kernels, tmp)),
        ("stream", lambda: phase_stream(torch, TransformerLM, kernels)),
        ("interop", lambda: phase_interop(torch, keras, kernels, inference,
                                          tmp)),
        ("sanitize", lambda: phase_sanitize(torch, TransformerLM, kernels,
                                            inference)),
    ]
    if sys.argv[1:2] == ["--phases"]:  # e.g. --phases kernels,resume
        wanted = sys.argv[2].split(",")
        phases = [p for p in phases if p[0] in wanted]
    results = {}
    for name, run in phases:
        t = time.perf_counter()
        totals = dict(kernels.flash_fwd.total_by_design)
        bwd_totals = {k: dict(kernels.KERNELS[k].total_by_dtype_design)
                      for k in BWD_KERNELS}
        try:
            ok, results[name] = run()
            if name in SM90_PHASES:
                ok &= all_sm90(kernels, name, totals)
            if name in BWD_SM90_PHASES:
                ok &= bwd_all_sm90(kernels, name, bwd_totals,
                                   BWD_SM90_PHASES[name])
        except Exception as e:  # a phase's crash fails that phase only
            import traceback
            traceback.print_exc()
            ok = False
            log(f"{name}: raised {type(e).__name__}: {e}")
        log(f"phase {name}: {'ok' if ok else 'FAIL'} "
            f"({time.perf_counter() - t:.1f} s)")
        if not ok:
            failed.append(name)

    log(smi_card())
    for name, keys in SUMMARIES.items():
        res = results.get(name) or {}
        log(f"{name}: " + json.dumps({k: res.get(k) for k in keys}))

    # every kernel at the shape of the mixed phase's microbatch, bf16,
    # with its launches there; the f32 numbers at the training shape and
    # each path's own count beside them
    path_launches = {
        path: (results.get(path) or {}).get("launches") or {}
        for path in ("path", "serve", "train", "graph", "mixed", "resnet",
                     "registry", "detect", "recommend", "textclass",
                     "image", "layers")}
    moe = results.get("moe") or {}
    path_launches["moe"] = moe.get("launches") or {}
    path_launches["moe_bf16"] = moe.get("bf16_launches") or {}
    path_launches["moe_generate"] = moe.get("generate_launches") or {}
    path_launches["moe_serve"] = (moe.get("serve") or {}).get(
        "launches") or {}
    resume = results.get("resume") or {}
    path_launches["resume"] = (resume.get("launches") or {}).get(
        "incarnation2") or {}
    path_launches["resume_uninterrupted"] = (resume.get("launches")
                                             or {}).get("uninterrupted") or {}
    path_launches["resume_remat"] = ((resume.get("remat") or {}).get(
        "remat") or {}).get("launches") or {}
    path_launches["parallel"] = (results.get("parallel") or {}).get(
        "launches") or {}
    path_launches["observe"] = (results.get("observe") or {}).get(
        "launches") or {}
    path_launches["control"] = (results.get("control") or {}).get(
        "launches") or {}
    path_launches["shard"] = (results.get("shard") or {}).get(
        "launches") or {}
    # the fleet's workers (summed over them) and the router's own process
    path_launches["fleet"] = (results.get("fleet") or {}).get(
        "launches") or {}
    path_launches["fleet_router"] = (results.get("fleet") or {}).get(
        "router_launches") or {}
    path_launches["stream"] = (results.get("stream") or {}).get(
        "launches") or {}
    path_launches["interop"] = (results.get("interop") or {}).get(
        "launches") or {}
    path_launches["sanitize"] = (results.get("sanitize") or {}).get(
        "launches") or {}

    def timed_row(name, case, dtype, sq=None, design="sm90"):
        row = next((r for r in results.get("kernels") or []
                    if r["kernel"] == name and r["case"] == case
                    and r["dtype"] == dtype and r.get("ms") is not None
                    and sq in (None, r["sq"]) and r["design"] == design),
                   None)
        if row is None:
            return {}
        return dict(max_abs_err=row["abs_err"], ms=row["ms"],
                    ms_min=row["ms_min"], ms_max=row["ms_max"],
                    eager_ms=row["eager_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    bound_f32_cuda_ms=row["bound_f32_cuda_ms"],
                    bound_share=row["bound_share"],
                    library_ms=row["library_ms"],
                    library_eager_ms=row["library_eager_ms"],
                    library_backend=row["library_backend"],
                    shape=[row["bh"], row["sq"], row["d"]], dtype=dtype)

    def row_at(name, case, bh, design="sm90"):
        row = next((r for r in results.get("kernels") or []
                    if r["kernel"] == name and r["case"] == case
                    and r["bh"] == bh and r.get("ms") is not None
                    and r["design"] == design), None)
        return {} if row is None else dict(
            max_abs_err=row["abs_err"], ms=row["ms"], ms_min=row["ms_min"],
            ms_max=row["ms_max"], eager_ms=row["eager_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library_eager_ms=row["library_eager_ms"],
            library_backend=row["library_backend"],
            shape=[row["bh"], row["sq"], row["d"]])

    # every kernel's launches by design in each checked phase's own run,
    # read where its launches are, after its own reset (the resume
    # workers' runs each in its own process)
    designs = {p: (results.get(p) or {}).get("launches_by_design") or {}
               for p in (*SM90_PHASES, "graph", "moe", "parallel",
                         "observe", "stream")}
    designs["moe_bf16"] = moe.get("bf16_launches_by_design") or {}
    resume_designs = resume.get("launches_by_design") or {}
    designs["resume"] = resume_designs.get("incarnation2") or {}
    designs["resume_uninterrupted"] = resume_designs.get(
        "uninterrupted") or {}
    designs["resume_remat"] = ((resume.get("remat") or {}).get(
        "remat") or {}).get("launches_by_design") or {}

    def of(name, counts):
        return {k: n for k, n in counts.items() if k.startswith(name + "[")}

    entries = []
    for name, (source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "design": "sm90",
                 "launches": designs["mixed"].get(f"{name}[bf16,sm90]", 0),
                 "launches_by_design": {p: of(name, c)
                                        for p, c in designs.items()},
                 "launches_by_path": {
                     "generate": path_launches["path"].get(name, 0),
                     "serve": path_launches["serve"].get(name, 0),
                     "train": path_launches["train"].get(name, 0),
                     "graph": path_launches["graph"].get(name, 0),
                     "mixed": path_launches["mixed"].get(f"{name}[bf16]",
                                                         0),
                     "resnet": path_launches["resnet"].get(name, 0),
                     "registry": path_launches["registry"].get(name, 0),
                     "detect": path_launches["detect"].get(name, 0),
                     "recommend": path_launches["recommend"].get(name, 0),
                     "textclass": path_launches["textclass"].get(name, 0),
                     "moe": path_launches["moe"].get(f"{name}[f32]", 0),
                     "moe_bf16": path_launches["moe_bf16"].get(
                         f"{name}[bf16]", 0),
                     "moe_generate": path_launches["moe_generate"].get(
                         name, 0),
                     "moe_serve": path_launches["moe_serve"].get(name, 0),
                     "image": path_launches["image"].get(name, 0),
                     "layers": path_launches["layers"].get(name, 0),
                     "resume": path_launches["resume"].get(name, 0),
                     "resume_uninterrupted": path_launches[
                         "resume_uninterrupted"].get(name, 0),
                     "resume_remat": path_launches["resume_remat"].get(
                         name, 0),
                     "parallel": path_launches["parallel"].get(name, 0),
                     "observe": path_launches["observe"].get(name, 0),
                     "control": path_launches["control"].get(name, 0),
                     "shard": path_launches["shard"].get(name, 0),
                     "fleet": path_launches["fleet"].get(name, 0),
                     "fleet_router": path_launches["fleet_router"].get(
                         name, 0),
                     "stream": path_launches["stream"].get(name, 0),
                     "interop": path_launches["interop"].get(name, 0),
                     "sanitize": path_launches["sanitize"].get(name, 0)}}
        entry.update(timed_row(name, "mixed", "bfloat16"))
        # the f32 main path runs every kernel at sm90
        entry["f32"] = timed_row(name, "train", "float32")
        entry["bf16_batch8"] = timed_row(name, "train", "bfloat16")
        # the baseline design, timed at the same shapes in this run; the
        # main path's bf16 launches run none of it
        base = {"name": f"{name}_base", "route": "cuda",
                "source": SOURCES[name]["base"], "replaces": replaces,
                "design": "base",
                "launches": designs["mixed"].get(f"{name}[bf16,base]", 0),
                "launches_by_path": {
                    p: sum(n for k, n in of(name, c).items()
                           if k.endswith(",base]"))
                    for p, c in designs.items()}}
        base.update(timed_row(name, "mixed", "bfloat16", design="base"))
        base["f32"] = timed_row(name, "train", "float32", design="base")
        base["bf16_batch8"] = timed_row(name, "train", "bfloat16",
                                        design="base")
        if name == "flash_fwd":  # the serve phase's prefill shapes
            for e, design in ((entry, "sm90"), (base, "base")):
                e["serve"] = [timed_row(name, "serve admit", "float32", s,
                                        design=design)
                              for s in SERVE["buckets"]]
                # the shard phase's and the fleet's predicts at 640
                # positions
                e["shard_predict"] = timed_row(name, "shard predict",
                                               "float32", design=design)
                e["fleet_predict"] = [
                    r for r in (row_at(name, "fleet predict", bh, design)
                                for bh in (12, 24)) if r]
        entries += [entry, base]
    log(json.dumps({"kernels": entries}))
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
