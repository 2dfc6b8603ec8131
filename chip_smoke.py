#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepsense6g_tii_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --parent PATH    # also times PATH's flash and scan
                                           # kernels

Phases, in order; any failure exits non-zero and prints no result:

1. device   CUDA must be present; prints the card's name and power limit.
2. build    compiles every CUDA kernel of the port from csrc/ with nvcc
            (one process per source, all started together) and the native
            C++ data loader with g++, prints ptxas's
            registers and spills, and checks the SASS (cuobjdump -sass):
            every head-dim instantiation of the bf16 flash forward, merged
            backward and split pair (dq, dk/dv) holds tensor-core
            instructions (HMMA/HGMMA).
3. kernels  holds each kernel against its plain PyTorch version at the
            shapes of the serving and training paths, in f32 and bf16, and
            times the kernel, the plain version and the one PyTorch call
            that computes the same function where there is one (timed here
            only, never called by the port) by their device time in
            torch.profiler, beside the card's bound for the work:
            - flash forward, dropout 0 and 0.1 (the hash stream);
            - the dropout mask export, equal element for element to the
              plain stream for four seeds;
            - flash backward, merged and split, dropout 0 and 0.1, against
              the plain backward and against each other, two split calls
              equal bit for bit; the split pair's dq and dk/dv kernels
              each timed alone;
            - the bf16 flash forward and merged backward at batch 1 (T =
              962) and at T = 70 and 1, every head dim;
            - the selective scan forward in both directions (its split
              into groups of chunks as the wrapper picks it, two calls
              equal bit for bit);
            - the selective scan backward in both directions, on the
              forward kernel's chunk-entry states (held against the plain
              scan's states), with B and C column slices of a wider tensor
              and one grouped-A case, two calls equal bit for bit;
            - both scan kernels at the edges of their chunk layout (L = 1,
              63, 64, 65, 129 at d = 40 and 1024; batch 1 at L = 962), the
              forward at every group size that differs, f32 and bf16,
              grouped A, two calls of each equal bit for bit;
            - the sequential selective-scan forward (variant="sequential")
              at batch 8 and 1 (and 16 at L = 962, d = 1024) against its
              plain loop and against the chunked forward on the same
              inputs, its chunk-entry states against the plain states, its
              gradient (through the chunked backward) against the chunked
              variant's, and reverse=True refused;
            - the roofline calibration chain, k multiplies (equal to the
              plain chain element for element) or k exponentials, at both
              chain lengths, each at least twice its bytes' time; the SASS
              of each instantiation is a loop body of exactly 16·U FMULs
              (and 16·U MUFU.EX2): 16 elements a thread, U steps a body.
4. gpt      serves the full-width GPT TransFuser (random weights from a
            seed, bf16) through Predictor with buckets (1, 8); checks the
            outputs, that padding leaves rows unchanged, that every forward
            launched the flash kernel 32 times and the scan kernel never,
            and that f32 logits with the kernel equal those of the plain
            attention path within 1e-3; prints p50/p90 latency at batch 1
            and 8, and one profiled request at each (device busy share and
            the kernels taking most time).
5. mamba    the same for the full-width MambaFuser (FFM=1, TFM=1): 67 scan
            launches (4 stages x 8 MambaBlocks x 2 directions + 3 TimeMamba
            scans) and no flash launch per forward; f32 logits with the
            scan kernel against the plain-scan path, with reverse_scan_kernel
            off and on, each within the larger of 1e-3 and twice the model's
            f32 noise floor (the plain path's own shift between the two
            settings, measured in the same run; see PERF.md).
6. train    trains the full-width GPT TransFuser (bf16, dropouts 0.1, seed-0
            weights) with make_train_step(use_ema=True) at batch 8 on one
            fixed synthetic batch for 20 steps at lr 1e-4: every step
            launches exactly 32 flash forwards and 32 merged backwards and
            nothing else; the loss is finite and falls; prints step-time
            p50/p90, samples/s, peak memory and one profiled step.  Then the
            same weights in f32 take one step through the kernels and one
            through the plain attention path, at dropouts 0.1 and 0, and the
            losses, gradients and new BatchNorm statistics must agree.  Then
            the bf16 step through the split backward (DEEPSENSE_FLASH_BWD=
            split) from the same weights for 5 steps: every step launches
            exactly 32 flash forwards, 32 dq and 32 dk/dv kernels and no
            merged backward; the first loss equal to the merged leg's, each
            later one within TRAIN_SPLIT_FALL_RTOL of the merged leg's fall;
            its step p50 beside the merged leg's.
7. mamba train  the same for the full-width MambaFuser, the main path of
            the selective-scan backward: every step launches exactly 67
            scan forwards and 67 scan backwards and nothing else.  Then the
            same weights in f32, cut to one MambaBlock per stage, take one
            step through the scan kernels and one through the plain scan,
            with reverse_scan_kernel off and on, held to the GPT step's
            limits.
8. cli      the training entry point users call, python -m
            deepsense6g_tii_tpu_torch.cli.train, through its main in-process,
            on a DeepSense-layout tree that the port's utils/demo_data.py
            writes under build/cli (960x540 camera frames, 5 frames a
            sample; 16 development, 8 adaptation and 8 test samples): the
            full-width MambaFuser with the CLI's defaults (bf16) and --ema 1
            trains 2 epochs at batch 8 (batches of 8, 8 and 5), validating
            and checkpointing each; every train step launches exactly 67
            scan forwards and 67 scan backwards; the loss is finite and the
            model, best-model, optimizer and run-record files exist; a
            second main resumes to epoch 3; --Test 1 --load_model_path
            <logdir>/best_model writes beam_pred.csv (8 rows of beams in
            1..64) and the confidence CSV.  Then --FFM 0 --TFM 0 --n_layer 2
            for one epoch and a test: 8 flash forwards and 8 merged
            backwards a step.  Prints each epoch's samples/s, share of the
            epoch spent waiting for data, peak memory and read-backs, and
            the loader's ms a batch and the camera reader's ms a frame.
8b. cache   the pre-featurized data path on the cli phase's tree: the train
            CLI with --cache_dir build/cli/cache trains the full-width
            MambaFuser one epoch and validates (the train and validation
            sets featurized into memmaps, every cloud through the native
            C++ loader, counted; 67 scan forwards and 67 backwards a step),
            then a second main finds the cache (the manifest's mtime
            unchanged, no cloud decoded); each run's samples/s and
            data-wait share beside the cli phase's uncached epochs; ms a
            batch of 8 for CachedDataset+DataLoader and CachedBatchLoader
            beside the decode loader; a CachedBatchLoader batch (uint8 image
            and lidar, radar float16, and again with a uint8-radar cache)
            against the same rows upcast on the host: the MambaFuser's
            eval logits and first train loss bit-equal, the dtypes the
            engine's copy put on the card, and one batch's copy (CUDA
            events) compact against float32; native BEV maps equal to the
            Python path's for every cloud of the tree; bench_io at 16
            samples; the convergence smoke (full width, bf16, B=8, 40 steps:
            the loss halves); the DBA regression at its small geometry with
            the kernels (the JAX slow test's thresholds).
9. roofline  the kernel-tool path: python -m deepsense6g_tii_tpu_torch.tools.
            scan_roofline's main (the chain calibration, the chunked and
            sequential scan forwards and the backward at B=16, L=962,
            d=1024), its JSON line printed; it must launch the chain, both
            forwards and the backward, and its calibrated FMUL rate must not
            exceed 105% of SMs x 128 lanes x the SM clock.
10. serve   the serving entry point users call, python -m
            deepsense6g_tii_tpu_torch.serve CHECKPOINT, through its main
            in-process (batch 8, 10 timed requests): the cli phase's
            best_model.pt (MambaFuser), whose top-3 on the 8 test samples
            must equal the beam_pred.csv its --Test wrote (or tie on equal
            probabilities); then the seed-0 GPT TransFuser and MambaFuser
            written as reference-layout .pth files by the port's exporter,
            served by main (--FFM 0 --TFM 0 for the GPT) and loaded by
            Predictor.from_torch, whose logits at batch 1 and 8 must equal
            the source model's bit for bit.  Every run of main launches the
            kernel of its model once per forward at the gpt and mamba
            phases' counts (32 flash, 67 scan) and nothing else.  Prints
            main's p50/p90 and whether the msgpack module is installed
            (information only: the port's msgpack reader needs none).
10b. export the serving artifact: the custom ops of the flash forward
            and the chunked scan forward pass torch.library.opcheck on the
            card (bf16, one small shape, the scan both ways); both
            full-width models (seed-0 weights, bf16, 962 tokens) exported
            by Predictor.export_artifact at batch 8 under build/export, each
            graph holding 32 flash or 67 scan custom-op nodes and none of
            the plain versions' ops (matmul and a softmax per attention,
            the doubling scan's addcmul); a fresh process (this script with
            --serve-exported) loads them by ExportedPredictor alone, no
            model built and no checkpoint, and serves the same seeded
            requests: 32 flash or 67 scan launches a forward, top-k equal
            to the live Predictor's, confidences within 1e-3 (the largest
            error printed), a ragged request padded and an oversize one
            refused.  Prints export, save and load seconds, the artifact's
            MB, and the exported against the live p50/p90 at batch 1 and 8.
11. 30to5   the 30-to-5 variant (config_30to5: 10 frames, 5 predicted
            beams, 1922 tokens), full width, bf16, as phases 4-7 run the
            5-frame models.  First kernels #1, #2 (and the split pair #3,
            #4), #6 and #9 at its shapes (T = L = 1922 and L = 10), held
            against their plain versions in f32 and bf16 and timed beside
            their bounds in bf16; their sums join the kernels line's rows
            1-4, 6 and 9 (per_*_30to5),
            and every row gives its launches on this path
            (launches_30to5).  Then both models served at buckets (1, 8)
            ((B, 5, 3) beams, the first step's top-3 confidences; 32 flash
            launches per GPT forward, 67 scan launches per Mamba forward),
            f32 logits through the kernels held to the plain path (within
            1e-3, or 1e-5 of the largest logit for the GPT and 1e-4 for
            the MambaFuser cut to one block a stage); the MambaFuser
            trained 5 steps at batch 8, dropouts 0.1 (67 scan forwards and
            67 backwards a step, the loss finite and falling; step p50/p90,
            samples/s, peak memory) and the GPT TransFuser 3 (32 flash
            forwards and 32 merged backwards a step).
12. rebuild the modality-rebuild subsystem (lidar + radar rebuild the
            image's stage-1 features), full width, bf16, batch 8: the
            MambaFuser's RebuildTrainer (mambafuser_config(modality_missing=
            "image")) takes 5 steps with the fusion model in eval mode and
            gradients (67 scan forwards writing h_in and 67 scan backwards a
            step) and 20 eval steps (67 scan forwards each); the stage-1 tap
            and the heads launch nothing; prints the five losses a step,
            step p50/p90, samples/s, peak memory, the device's busy time
            (device_ms) and idle share.  The f32 step cut to one block a
            stage through the scan kernels and the plain scan from the same
            state: losses, the heads' BatchNorm statistics and gradients
            within the REBUILD_* bounds.  The GPT TransFuser's rebuild step
            3 times: 32 flash forwards and 32 merged backwards a step, every
            attention call at dropout 0.  python -m deepsense6g_tii_tpu_torch
            .cli.rebuild through its main on the cli phase's tree from its
            best_model.pt: one epoch, the 5-way best and final files, then
            --Val 1 --load_model_dir with a finite DBA.  The VFA trainer 10
            steps at the reference widths (2304, 2048, 512): the loss falls.
13. tools   the measuring tools: tools/bench_serve.py's run for both
            full-width models at buckets (1, 8), 10 requests each (p50/p90,
            pipelined samples/s); tools/profile_step.py's run of each
            model's train step at its card defaults (B=8, bf16), 3 steps
            traced: ms a step by category (the port's kernels by their
            KERNEL names, where #1 and #2 must stand at 32 launches a GPT
            step, #6 and #9 at 67 a Mamba step), the top kernels, the
            convolutions by site and direction, the dropped events;
            tools/bench_matrix.py's gpt_serve item in its own process,
            without error.
14. preprocess  the offline data path under build/preprocess at real
            sizes: 128 raw radar cubes (4, 256, 250) through
            data/preprocess/radar.py on the card, every map within 1e-4 of
            the numpy chain (cubes/s, one 64-cube call by CUDA events); a
            ~18,500-point static scene in 8 jittered frames with a car in
            the last through the LiDAR filter's cuda, native and kdtree
            backends (frames/s each; equal clouds, the car kept, every
            neighbour that differs from the k-d tree's a tie at f32
            rounding); csv_builder's root CSV; radar maps, filtered clouds,
            augmented variants and scenario CSVs on a demo tree, and the
            train CLI one epoch on it at the debug geometry with
            --filtered 1 --augmentation 1 (11 scan forwards and backwards
            a step; the filtered and augmented files read).
15. quickstart  python -m deepsense6g_tii_tpu_torch.examples.quickstart
            through its main on the card: every artifact, one beam_pred.csv
            row per test sample, 11 scan forwards and backwards a step.

16. dp      data parallelism: serving, the train step and the train CLI over
            several devices.  With at least 2 cards the mesh is the cards
            and the ranks run on NCCL, one card each; with one, two
            replicas share cuda:0 and two ranks share it on gloo (NCCL
            refuses two ranks on one device); the phase prints which.
            dp serve: Predictor(use_mesh=...) on both full-width models
            (bf16, seed-0 weights), a request of 8 rows and a ragged one
            of 3: 67 scan (32 flash) launches a replica a forward; top-3
            and confidences against one device on each replica's rows
            (the same shapes: bit for bit) and against one device at batch
            8 (within DP_ONE_DEVICE_ATOL); p50/p90 of both at batch 8,
            bench_serve.ITERS requests each.  dp train: this script with
            --dp-train as the
            ranks of a process group and as a one-process reference under
            a one-rank NCCL group, all started together: the full-width
            MambaFuser in bf16, global batch 8, 3 steps, every parameter,
            buffer and EMA tensor bit-equal across the ranks after every
            step (hashes), 67 scan forwards and 67 backwards a rank a
            step; in f32 at one MambaBlock a stage, the ranks' step
            against the reference's on the whole batch, and with the last
            row invalid against the reference's on the first 7 rows:
            loss, gradients, BatchNorm statistics and the share of
            updated parameters that moved apart, within DP_SHIFT_FACTOR
            times the reference's own shift (the largest of the scan
            kernel's against the plain scan and of its step against itself
            on the rows in DP_ORDERS; never below DP_FLOOR), every
            reading printed before any is held to its bound.  dp cli:
            python -m torch.distributed.run --standalone --nproc_per_node
            <cards> running the train CLI's main (--multihost 1; this
            script with --dp-cli counts each step's launches) on a demo
            tree under build/dp: the GPT
            TransFuser at --n_layer 2 one epoch, then --Test 1 in the same
            launch (main again, a second process group): one
            logdir, written by rank 0 alone, the DBA equal on every rank,
            8 flash forwards and 8 merged backwards a rank a step, the
            test CSVs.  dp rebuild: this script with --dp-rebuild as the
            ranks and the one-process reference, started when the train
            leg ends: RebuildTrainer(mesh=...) on the full-width
            MambaFuser (modality_missing="image") in bf16, global batch 8,
            3 steps, the heads, fusion model, head statistics and AdamW
            state bit-equal across the ranks after every step (hashes), the
            five losses equal and finite, 67 scan forwards and 67 backwards
            a rank a step, each rank's step p50 beside the reference's at
            the global batch; in f32 at one MambaBlock a stage (the heads'
            dropout 0), rank 0's losses, heads' and fusion model's
            gradients and head statistics against the reference's on the
            whole batch, within DP_SHIFT_FACTOR times its own shift (never
            below DP_REBUILD_FLOOR); beside them the planted-fault reading,
            the contrastive term of rank 0's rows alone (a port without
            the gather), which must lie outside the loss's bound.  dp
            rebuild cli: python -m torch.distributed.run --nproc_per_node
            <cards> running the rebuild CLI's main (this script with
            --dp-rebuild-cli counts each step's launches) on the demo tree:
            the full-width MambaFuser cut to --n_layer 2, random weights,
            one epoch, then --Val 1 --load_model_dir on its logdir in the
            same launch: one logdir written by rank 0 alone, the 5-way
            files, the DBA equal on every rank, a finite --Val DBA, 19 scan
            forwards and backwards a rank a step.  Each kernel's row of the
            kernels line gives its launches on these legs (launches_dp).
            --dp-only runs the device, build and dp phases alone (a call
            with several cards).

With --parent PATH, after the last phase, the flash forward, merged
backward, split backward and each split kernel alone of the checkout at
PATH are timed against this one's, per GPT training step, and its scan
forward, sequential forward and backward per MambaFuser step and serving
forward, in turns on this card (their numbers join the kernels line's rows
1-4, 6, 8 and 9), and the sequential kernel's states are held against
PATH's on the same inputs.  The line before the last is a JSON object with one
entry per kernel; the last line is {"ok": true, "device": {...}}.  TF32 is switched off for
matmuls and convolutions, so the f32 comparisons are exact f32 on both
sides; the bf16 serving path is unaffected by it.
"""

import csv
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCRIPT = os.path.abspath(__file__)      # what the dp phase's processes run
if os.path.isdir(os.path.join(REPO, "deepsense6g_tii_tpu_torch")):
    # the trace helpers (tools/trace.py); without the package,
    # phase_device fails
    from deepsense6g_tii_tpu_torch.tools.trace import (device_ms,
                                                       profile_call,
                                                       short_name, traced)
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


BATCH = 8            # serving bucket
HEADS = 4
TOKENS = 962         # 3 modalities x 5 frames x 8x8 anchors + 2 GPS
HEAD_DIMS = (16, 32, 64, 128)   # n_embd 64..512 over 4 heads
N_LAYER = 8
TOL = {"float32": (1e-5, 1e-5),     # (O, lse) max abs error vs plain
       # bf16: the kernel rounds P to bf16 before P.V (as the TPU kernel
       # does), the plain version does not: 2 bf16 ulps of O at the
       # largest |O| (ulp 1.95e-3 for |O| in [0.25, 0.5))
       "bfloat16": (4e-3, 1e-4)}
LOGIT_TOL = 1e-3     # f32 logits, kernel vs plain path, TF32 off
# the full-depth MambaFuser's f32 logits, kernel vs plain path, as a share
# of the largest logit: 4x the largest shift measured between two roundings
# of the plain path itself (3.5e-3 on 142, NVIDIA H100 80GB HBM3; PERF.md)
MAMBA_LOGIT_RTOL = 1e-4
# the 30-to-5 GPT's f32 logits, kernel vs plain path: LOGIT_TOL or this
# share of the largest logit, whichever is larger.  LOGIT_TOL is ~1e-5 of
# the 5-frame models' largest logits (109-146); the 30-to-5 decoder adds up
# five steps to logits of ~550, whose f32 spacing is 6.1e-5, and there the
# flash and plain GPT paths differed by 17 spacings (1.04e-3, 1.9e-6 of the
# largest logit) at full depth and cut to one block a stage alike (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md).  The kernels themselves are held
# at T = L = 1922 in f32 and bf16 by phase_kernels_30to5.
LOGIT_RTOL_30TO5 = 1e-5
# the f32 rebuild step (MambaFuser cut to one block a stage, fusion model in
# eval mode with gradients), scan kernels against the plain scan from the
# same state: the tap and the heads see the same inputs on both paths, so
# the contrastive, distance and translation losses are equal; the fusion
# loss and every gradient differ by the scans' rounding alone (eval-mode
# BatchNorm: no batch-statistics cancellation).  The train step's bounds.
REBUILD_LOSS_RTOL = 1e-6        # each of the five losses, relative
REBUILD_GRAD_RTOL = 1e-2        # heads' and fusion's gradients, of the norm
REBUILD_GRAD_TENSOR_RTOL = 0.1  # per tensor, of its largest |g|
# tensors whose gradient is 0 in exact arithmetic, held to 1e-6 of the
# largest |g| in the f32 comparisons: the attention key biases (softmax
# ignores a shift shared by all keys) and the rebuild heads' Linear biases
# before a train-mode BatchNorm (which removes a shift shared by all rows)
EXACT_ZERO_GRADS = ("attn.key.bias", "_l1.fc1.bias", "_l1.fc2.bias")

# selective scan: the fusion stages' d_inner at L = 962 tokens, and the
# TimeMamba head's d_inner at L = 5 frames
SCAN_SHAPES = tuple((TOKENS, d) for d in (128, 256, 512, 1024)) + ((5, 1024),)
D_STATE = 16
SCAN_LAUNCHES = {(TOKENS, d): 2 * N_LAYER for d in (128, 256, 512, 1024)}
SCAN_LAUNCHES[(5, 1024)] = 3
# y and h_out, max abs error over max |plain|: kernel and plain version read
# the same inputs widened to f32 and compute in f32; only the order of the
# sums differs (a sequential recurrence and a 16-term dot in the kernel, a
# 10-level doubling tree and einsum in the plain version), and the kernel's
# ex2.approx decay is within ~1e-6 relative of torch.exp's where it is not
# ~0.  Measured ~1e-7 at every shape (NVIDIA H100 80GB HBM3; PERF.md).  The
# forward's chunk-entry states h_in are held to the same bound.
SCAN_RTOL = 1e-5
# selective-scan backward: du, ddt, dA, dB and dC, each as max abs error
# over max |plain|.  The kernel and the plain backward read the same inputs
# widened to f32 and sum in f32 in other orders: step by step along the
# recurrences and in 16-channel partials added in a second pass, against
# doubling scans and whole-axis reductions; no atomics, so the kernel's
# result does not change from run to run.  f32 gradients: 1e-4.  du, dB
# and dC in bf16 are rounded from f32 on both sides, and a last-bit
# difference moves a rounding by one bf16 ulp (2^-8 relative): 2 ulps of
# the largest value.
SCAN_BWD_RTOL = 1e-4
SCAN_BWD_BF16_RTOL = 2.0 ** -7
SCAN_GRADS = ("du", "ddt", "dA", "dB", "dC")
# the device kernels of the scan's wrappers, by name: each call of the
# forward runs its output pass and, where L is split, its state and carry
# passes; each call of the backward its main pass and the sums of its
# partials and, for more than one chunk, its local-gradient and carry
# passes
SCAN_FWD_PASSES = ("scan_fwd_kernel", "scan_carry_kernel")
SCAN_BWD_PASSES = ("scan_bwd_kernel", "scan_bwd_local_kernel",
                   "scan_carry_kernel", "scan_bwd_sums_kernel")
# the kernel checks' edge shapes: L around one and two chunks at a d that
# is no multiple of the blocks' channels, and at the widest d_inner
SCAN_EDGE_L = (1, 63, 64, 65, 129)
SCAN_EDGE_D = (40, 1024)
# the sequential forward's gradients against the chunked forward's, f32, of
# each gradient's largest element: the same backward kernel on the same
# inputs, given chunk-entry states that differ by rounding alone
SEQ_GRAD_RTOL = 1e-5
# the exp chain against its plain version, relative: ex2.approx is within
# ~2^-22 of exp2 and each step's map contracts (|slope| < 0.42)
CHAIN_EXP_RTOL = 1e-5


# flash backward: largest error over the largest |plain| of dq, dk, dv.
# f32: the kernels and the plain version read the same inputs and sum in f32
# in other orders (and the merged kernel adds dq with atomics, in an order
# that changes from run to run); measured ~1.5e-6 (PERF.md).  bf16: P and dS
# are rounded to bf16 before their products on both sides, and a last-bit
# difference in f32 moves a rounding by one bf16 ulp (2^-8 relative), then
# the output is rounded to bf16 itself: 2 ulps of the largest value.
BWD_RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
DROP_P = 0.1
MASK_SEEDS = (0, 1, -7, 2 ** 31 - 1)
TRAIN_STEPS, TRAIN_LR = 20, 1e-4
# f32 training step, flash kernels against the plain attention path on the
# same weights, generators and masks; they differ only in rounding
# (phase_train_f32 says what each bound covers; measured values in PERF.md)
TRAIN_LOSS_RTOL = 1e-6
TRAIN_STATS_RTOL = 1e-5     # per statistic tensor, of its largest value
TRAIN_GRAD_RTOL = 1e-2      # all gradients, of their norm
TRAIN_GRAD_TENSOR_RTOL = 0.1    # per tensor, of its largest |g|
TRAIN_SPLIT_RTOL = 1e-4     # merged against split backward, of the norm
# the bf16 GPT training leg through the split backward (SPLIT_STEPS steps)
# against the merged leg, step by step.  Both start from the same weights,
# batch and generators and run the same forward kernels, so their first
# losses are one computation: held equal.  The two backwards compute the
# same gradients but round dq apart (its f32 sums run in another order,
# within BWD_RTOL; two runs of the merged kernel, whose atomics sum dq in
# another order each run, differ the same way), and from the first update
# on, bf16 training carries such last-bit differences forward: the two
# losses drift apart by a share of how far training has moved the loss.
# Each later step's gap is held to TRAIN_SPLIT_FALL_RTOL of the merged
# leg's fall since its first step (measured up to 1.0% of the fall, 1.9%
# of the loss, at 5 steps; PERF.md).  The check shows that the leg
# trains as the merged one does; it cannot tell a wrong attention gradient
# (zeroing dq moved the small model's losses by < 0.5% of their fall over 5
# steps): the kernel checks (BWD_RTOL) and the f32 step (TRAIN_SPLIT_RTOL)
# hold the gradients themselves.
SPLIT_STEPS = 5
TRAIN_SPLIT_FALL_RTOL = 0.1
ATTN_F64_RTOL = 1e-5        # attention kernels against f64, of max |ref|
# the cli phase's demo tree: the DeepSense camera's 960x540 frames (so the
# reader's resize to 256 runs), 5 frames a sample, and per scenario (2 a
# split) 8 development, 4 adaptation and 4 test samples: 16, 8 and 8
CLI_FRAME = (540, 960)
CLI_SPLITS = (8, 4, 4)
CLI_BATCH, CLI_EPOCHS, CLI_GPT_LAYERS = 8, 2, 2
# the cache phase: bench_io's samples; the convergence smoke (steps, batch,
# lr) and its bar, the JAX tool's: the loss at least halves; the DBA
# regression's bars, tests/test_dba_regression.py's: the random floor below
# DBA_FLOOR_MAX, raw and EMA DBA at least DBA_MIN, EMA no worse than raw by
# DBA_EMA_SLACK, the last three of the curve above its first three by
# DBA_CURVE_RISE
BENCH_IO_SAMPLES = 16
CONVERGE_STEPS, CONVERGE_BATCH, CONVERGE_LR = 40, 8, 1e-4
DBA_FLOOR_MAX, DBA_MIN, DBA_EMA_SLACK, DBA_CURVE_RISE = 0.3, 0.8, 0.02, 0.3
# the serve phase: serve.main's request batch and latency requests
SERVE_BATCH, SERVE_ITERS = 8, 10
# the export phase: timed requests a leg, the rows of its ragged request,
# and the bound on the artifact's confidences against the live Predictor's
EXPORT_ITERS, EXPORT_RAGGED, EXPORT_CONF_ATOL = 10, 3, 1e-3
# in the order they are exported: the MambaFuser's artifact loads while the
# GPT TransFuser's is traced and saved
EXPORT_MODELS = ("mamba", "gpt")
# the 30to5 phase's training steps, MambaFuser and GPT TransFuser
STEPS_30TO5, GPT_STEPS_30TO5 = 5, 3
# the rebuild phase: MambaFuser rebuild steps and eval steps, GPT rebuild
# steps, rebuild-CLI epochs, VFA steps at the reference widths
REBUILD_STEPS, REBUILD_EVAL_STEPS, REBUILD_GPT_STEPS = 5, 20, 3
REBUILD_CLI_EPOCHS, VFA_STEPS, VFA_BATCH = 1, 10, 16
# the tools phase: profile_step's traced steps (bench_serve runs its own
# default of requests a bucket), the calls in each attribution trace
PROFILE_STEPS, ATTRIBUTION_CALLS = 3, 20
# the preprocess phase.  Radar: raw cubes (antennas, samples, chirps),
# complex64, and the maps' bound against the numpy chain (f64).  LiDAR: a
# static scene of a scenario32-sized cloud (its min_points is 18000) in
# the scenario's field of view, jittered frames, a car in the last; the
# car's box (x, y, z lo and hi) has no static point within CAR_MARGIN in x
# and y
RADAR_CUBES, RADAR_CUBE = 128, (4, 256, 250)
RADAR_MAP_ATOL = 1e-4
LIDAR_GROUND, LIDAR_WALLS, LIDAR_FRAMES = 12_000, 6_500, 8
LIDAR_JITTER, CAR_POINTS, CAR_MARGIN = 0.02, 300, 1.5
CAR_BOX = ((-14.0, -10.0), (-7.0, -5.0), (-1.5, 0.0))
# the quickstart's debug geometry (n_layer 1): scan launches a train step,
# each direction of 4 stages and TimeMamba's 3
DEBUG_SCAN_LAUNCHES = 2 * 4 + 3
# the dp phase: the global batch of every leg, the bf16 leg's steps, the
# time limit of its processes (seconds).  The f32 legs against one
# process's step: each gap within DP_SHIFT_FACTOR times that run's own
# shift, the largest of the scan kernel's against the plain scan and the
# step's against itself on its rows in DP_ORDERS (BatchNorm's and the
# loss's sums taken in another order, as the ranks' are: the random-weight
# model turns that into 0.4-1.1% of the gradient's norm on the card;
# sound runs read 0.19-1.2 times the largest, PERF.md), and never held
# below DP_FLOOR, the train phases' limits on kernel against plain.  AdamW's
# first step moves an element by about lr·sign(g), whatever the
# gradient's size, so the updated parameters are held by the share of
# elements more than 1% of lr apart (at most 1% of them in
# tests/test_torch_train.py): the elements whose gradient's sign differs.
# Serving over the mesh: against one device on each replica's rows (the
# same shapes and kernels) top-k and confidences bit for bit; against one
# device at batch 8 (other shapes, so other bf16 roundings) confidences
# within DP_ONE_DEVICE_ATOL, 2.5x the largest reading (3.9e-4 on one
# card, 1.5e-4 on four, PERF.md: about one bf16 rounding of a logit), and
# beams equal but where the reference's probabilities of the two lie within it
DP_BATCH, DP_STEPS, DP_TIMEOUT = 8, 3, 600
DP_SHIFT_FACTOR = 3.0
DP_ORDERS = ("reversed", "rolled")
DP_FLOOR = {"loss_rel": TRAIN_LOSS_RTOL, "grad_global_rel": TRAIN_GRAD_RTOL,
            "stats_worst": TRAIN_STATS_RTOL, "params_share": 0.01}
DP_ONE_DEVICE_ATOL = 1e-3
# the rebuild legs: the f32 step's floors (the rebuild phase's limits on
# kernel against plain), and the rebuild CLI's depth (full widths)
DP_REBUILD_FLOOR = {"loss_rel": REBUILD_LOSS_RTOL,
                    "grad_global_rel": REBUILD_GRAD_RTOL,
                    "stats_worst": TRAIN_STATS_RTOL}
DP_REBUILD_CLI_LAYERS = 2
REBUILD_LOSSES = ("loss", "trans", "contrast", "distance", "fusion")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, iters=20, warmup=3):
    """Milliseconds per call of ``fn`` on the card by CUDA events, the calls
    queued behind a spin kernel (tools/timing.py)."""
    from deepsense6g_tii_tpu_torch.tools import timing
    return timing.time_ms(fn, DEVICE, iters=iters, warmup=warmup)


def phase_device():
    if not os.path.isdir(os.path.join(REPO, "deepsense6g_tii_tpu_torch")):
        fail("deepsense6g_tii_tpu_torch not found beside chip_smoke.py: "
             "run from the root of a checkout")
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from deepsense6g_tii_tpu_torch.tools import timing
    card = timing.card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the SMs' exp2 and FMUL rates at the largest SM clock (16 and 128 a
    # clock per SM on an H100: CUDA C programming guide, compute capability
    # 9.0)
    rates = timing.datasheet_rates()
    print(f"data-sheet rates: {json.dumps(rates)}")
    return card, rates["exp_per_s"], rates["fmul_per_s"]


def phase_build():
    from deepsense6g_tii_tpu_torch.ops import (_build, flash_attention,
                                               selective_scan)
    from deepsense6g_tii_tpu_torch.tools import scan_roofline
    kernels = [*flash_attention.LIBRARIES, *selective_scan.LIBRARIES,
               *scan_roofline.LIBRARIES]
    t0 = time.perf_counter()
    logs = _build.build(kernels)
    print(f"build: {kernels} in {time.perf_counter() - t0:.1f} s")
    # the native PLY/BEV loader (host C++, g++), before any phase reads
    # a cloud, so no timed loader pays for its build
    from deepsense6g_tii_tpu_torch.runtime import native
    t0 = time.perf_counter()
    check(native.available(), "the native loader did not build")
    print(f"build: native loader {native.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  {name} ptxas (registers, spill stores, spill loads) a "
              f"kernel: {json.dumps(ptxas_usage(log))}")
    for name in kernels:
        _build.load(name)
    chain_sass(_build.library_path(scan_roofline.LIBRARY))
    flash_sass({lib: _build.library_path(lib)
                for lib in (flash_attention.KERNEL,
                            flash_attention.BWD_LIBRARY)})


def ptxas_usage(log):
    """{kernel: [registers, spill store bytes, spill load bytes]} from
    nvcc's -Xptxas -v output, each kernel by its name and template
    arguments (kernel_label)."""
    import re
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            name = kernel_label(m.group(1))
            usage.setdefault(name, [None, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage[name][0] = int(m.group(1))
    return usage


def kernel_label(mangled):
    """``name<args>`` of a mangled kernel name, its namespaces dropped and
    its integer, bool, float and bf16 template arguments kept, e.g.
    flash_bwd_dq_mma_kernel<64>."""
    import re
    pos = 3 if mangled.startswith("_ZN") else 2
    name = None
    while (m := re.match(r"\d+", mangled[pos:])):
        n = int(m.group(0))
        name = mangled[pos + m.end():pos + m.end() + n]
        pos += m.end() + n
    if not mangled.startswith("_Z") or name is None:
        return mangled
    rest = mangled[pos:]
    tpl = rest.split("EE")[0] + "E" if rest.startswith("I") else ""
    args = [a or b or c for a, b, c in re.findall(
        r"L[ib](\d+)E|__nv_(bfloat16)|(?<=I)(f)(?=L)", tpl)]
    return name + (f"<{', '.join(args)}>" if args else "")


def sass_functions(library):
    """{mangled name: SASS text} of every kernel in ``library``
    (cuobjdump -sass)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {fn.split("\n")[0].strip(): fn
            for fn in re.split(r"\n\s*Function : ", sass)[1:]}


FLASH_MMA_KERNELS = ("fwd", "bwd", "bwd_dq", "bwd_dkv")


def flash_sass(libraries):
    """The bf16 flash forward, merged backward and the split pair run on
    the tensor cores: each head-dim instantiation of flash_fwd_mma_kernel,
    flash_bwd_mma_kernel, flash_bwd_dq_mma_kernel and
    flash_bwd_dkv_mma_kernel holds HMMA (mma.sync) or HGMMA (wgmma)
    instructions."""
    import re
    found = {}
    for lib, path in libraries.items():
        for name, text in sass_functions(path).items():
            m = re.search(r"flash_(fwd|bwd|bwd_dq|bwd_dkv)_mma_kernelILi(\d+)E",
                          name)
            if m:
                found[f"{m.group(1)} d={m.group(2)}"] = (
                    len(re.findall(r"\bHMMA\b", text)),
                    len(re.findall(r"\bHGMMA\b", text)))
    print(f"flash bf16 SASS (HMMA, HGMMA) a kernel: {found}")
    want = {f"{kind} d={d}" for kind in FLASH_MMA_KERNELS for d in HEAD_DIMS}
    check(set(found) == want and all(sum(c) > 0 for c in found.values()),
          f"flash SASS: expected HMMA or HGMMA in each of {sorted(want)}, "
          f"got {found}")


def chain_sass(library):
    """The SASS of each chain instantiation (cuobjdump -sass): a loop body
    of exactly 16·U FMULs, and 16·U MUFU.EX2 for the exp chain (16 elements
    a thread, U steps a body, k / U trips), so that the calibration counts
    what the card issues."""
    import re
    found = {}
    for name, fn in sass_functions(library).items():
        m = re.search(r"chain_kernelILi(\d+)ELb([01])E", name)
        if m:
            found[(int(m.group(1)), m.group(2) == "1")] = (
                len(re.findall(r"\bFMUL\b", fn)),
                len(re.findall(r"MUFU\.EX2", fn)))
    from deepsense6g_tii_tpu_torch.ops import _build
    body = 16 * _build.header_constants("scan_roofline_chain.cu")["U"]
    print(f"chain SASS (k, exp): (FMUL, MUFU.EX2) a loop body: {found}")
    check(len(found) == 4 and all(
        counts == (body, body if use_exp else 0)
        for (k, use_exp), counts in found.items()),
        f"chain SASS: expected {body} FMUL (and MUFU.EX2) a body, got "
        f"{found}")


def phase_flash_kernel(sfu_rate):
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for d in HEAD_DIMS:
            q, k, v = (torch.randn(BATCH, HEADS, TOKENS, d, device=DEVICE,
                                   generator=gen).to(dtype)
                       for _ in range(3))
            sm = d ** -0.5
            for p in (0.0, DROP_P):
                seed = 12345 if p else None
                o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm, dropout_p=p,
                                          seed=seed)
                torch.cuda.synchronize()
                ro, rlse = fa.flash_mha_reference(q, k, v, sm, p, seed or 0)
                err_o = (o.float() - ro.float()).abs().max().item()
                err_l = (lse - rlse).abs().max().item()
                tol_o, tol_l = TOL[dname]
                if dname == "bfloat16":
                    # 2 bf16 ulps at the largest |O| (dropout scales O up)
                    tol_o = max(tol_o, 2 * bf16_ulp(ro.float().abs().max()))
                check(err_o <= tol_o and err_l <= tol_l,
                      f"flash kernel {dname} d={d} p={p}: max |O err| "
                      f"{err_o:.3g} (tol {tol_o:.3g}), max |lse err| "
                      f"{err_l:.3g} (tol {tol_l})")
                if not p:
                    # a seed without dropout leaves the stream untouched
                    o2, _ = fa.flash_mha_fwd(q, k, v, sm_scale=sm, seed=99)
                    check(torch.equal(o, o2), f"flash kernel {dname} d={d}: "
                          f"p = 0 output depends on the seed")
                bh = BATCH * HEADS
                flops = 4.0 * bh * TOKENS * TOKENS * d
                nbytes = (4 * bh * TOKENS * d * q.element_size()
                          + bh * TOKENS * 4)
                bound_ms = 1e3 * max(flops / PEAK_FLOPS[dname],
                                     nbytes / PEAK_BYTES)
                kernel = lambda: fa.flash_mha_fwd(  # noqa: E731
                    q, k, v, sm_scale=sm, dropout_p=p, seed=seed)
                row = dict(
                    dtype=dname, d=d, p=p, max_abs_err=err_o, lse_err=err_l,
                    ms=device_ms(kernel), event_ms=time_ms(kernel),
                    plain_ms=device_ms(lambda: fa.flash_mha_reference(
                        q, k, v, sm, p, seed or 0)),
                    # SDPA without dropout: no PyTorch call draws this
                    # stream, and its own dropout costs the same
                    library_ms=device_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v,
                                                               scale=sm)),
                    bound_ms=bound_ms, bound_us=1e3 * bound_ms,
                    bound_by="operations" if flops / PEAK_FLOPS[dname]
                    >= nbytes / PEAK_BYTES else "bytes",
                    exp_sfu_ms=exp_sfu_ms(bh, TOKENS, sfu_rate))
                rows.append(row)
                print("kernel flash_attention_fwd " + json.dumps(row))
    return rows


def exp_sfu_ms(bh, t, sfu_rate):
    """One exponential per attention element, bh·T² a launch, at the
    special-function units' rate alone: not in the bound, printed beside
    it (as for the scan kernels)."""
    return 1e3 * bh * t * t / sfu_rate


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(float(x))) - 7)


def phase_mask():
    """The mask export equals the plain stream bit for bit; its keep rate
    and time against its bound (it writes 4·bh·T² bytes)."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    bh = BATCH * HEADS
    for seed in MASK_SEEDS:
        m = fa.dropout_mask(seed, bh, TOKENS, DROP_P, device=DEVICE)
        torch.cuda.synchronize()
        ref = fa.dropout_scale_reference(seed, bh, TOKENS, DROP_P,
                                         device=DEVICE)
        diff = int((m != ref).sum().item())
        keep = (m > 0).float().mean().item()
        check(diff == 0, f"mask kernel, seed {seed}: {diff} elements differ "
              f"from the plain stream")
        print(f"mask seed {seed}: equal to the plain stream over "
              f"{m.numel()} elements; keep rate {keep:.6f} (1 - p = "
              f"{1 - DROP_P})")
    nbytes = 4.0 * bh * TOKENS * TOKENS
    # murmur3-fmix32 and the id: ~15 integer operations an element
    int_ops = 15.0 * bh * TOKENS * TOKENS
    row = dict(
        bh=bh, t=TOKENS, p=DROP_P, max_abs_err=0.0,
        ms=device_ms(lambda: fa.dropout_mask(0, bh, TOKENS, DROP_P,
                                             device=DEVICE)),
        plain_ms=device_ms(lambda: fa.dropout_scale_reference(
            0, bh, TOKENS, DROP_P, device=DEVICE), iters=5, warmup=1),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", bytes=nbytes,
        int_ops=int_ops, library_ms=None)
    print("kernel flash_dropout_mask " + json.dumps(row))
    return row


def phase_flash_bwd(sfu_rate):
    """Merged and split backward against the plain backward and each other,
    at the training path's shapes, dropout 0 and 0.1, and a second split
    call equal to the first bit for bit; timed with the plain version and
    SDPA's backward (dropout 0) beside the bound, and the split pair's dq
    and dk/dv kernels each alone by CUDA events."""
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    bh = BATCH * HEADS
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for d in HEAD_DIMS:
            q, k, v, do = (torch.randn(BATCH, HEADS, TOKENS, d, device=DEVICE,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            sm = d ** -0.5
            for p in (0.0, DROP_P):
                seed = -7 if p else None
                o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm, dropout_p=p,
                                          seed=seed)
                kw = dict(sm_scale=sm, dropout_p=p, seed=seed)
                got = {mode: fa.flash_mha_bwd(q, k, v, o, lse, do, mode=mode,
                                              **kw)
                       for mode in ("merged", "split")}
                torch.cuda.synchronize()
                ref = fa.flash_mha_bwd_reference(q, k, v, o, lse, do, sm, p,
                                                 (seed or 0) & 0xFFFFFFFF)
                scale = [r.float().abs().max().item() for r in ref]
                err = {mode: [(g.float() - r.float()).abs().max().item()
                              for g, r in zip(got[mode], ref)]
                       for mode in got}
                err["merged_vs_split"] = [
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(got["merged"], got["split"])]
                for what, errs in err.items():
                    check(all(e <= BWD_RTOL[dname] * s
                              for e, s in zip(errs, scale)),
                          f"flash backward {dname} d={d} p={p} {what}: max "
                          f"|d(q,k,v) err| {errs} of max |plain| {scale} "
                          f"(rtol {BWD_RTOL[dname]})")
                # the split pair has no atomics: the same bits every call
                again = fa.flash_mha_bwd(q, k, v, o, lse, do, mode="split",
                                         **kw)
                check(all(torch.equal(a, b)
                          for a, b in zip(got["split"], again)),
                      f"flash backward {dname} d={d} p={p}: two split calls "
                      f"differ")
                del again
                esize = q.element_size()
                n_el = bh * TOKENS * d
                # q, k, v, o, dO, lse, dvec in; dq, dk, dv out
                nbytes = 8 * n_el * esize + 2 * bh * TOKENS * 4
                flops = 10.0 * bh * TOKENS * TOKENS * d
                bounds = {}
                for name, fl, nb in (
                        ("merged", flops, nbytes),
                        # S, dP, dq / S, dP, dv, dk, each 2·bh·T²·d
                        ("dq", 6.0 * flops / 10, nbytes - 2 * n_el * esize),
                        ("dkv", 8.0 * flops / 10, nbytes - n_el * esize)):
                    t_ops = fl / PEAK_FLOPS[dname]
                    t_bytes = nb / PEAK_BYTES
                    bounds[name] = (1e3 * max(t_ops, t_bytes),
                                    "operations" if t_ops >= t_bytes
                                    else "bytes")
                row = dict(
                    dtype=dname, d=d, p=p, err=err, max_abs=scale,
                    max_abs_err=max(err["merged"]),
                    ms=device_ms(lambda: fa.flash_mha_bwd(
                        q, k, v, o, lse, do, mode="merged", **kw)),
                    split_ms=device_ms(lambda: fa.flash_mha_bwd(
                        q, k, v, o, lse, do, mode="split", **kw)),
                    plain_ms=device_ms(lambda: fa.flash_mha_bwd_reference(
                        q, k, v, o, lse, do, sm, p, (seed or 0) & 0xFFFFFFFF),
                        iters=5, warmup=1),
                    bound_ms=bounds["merged"][0],
                    bound_by=bounds["merged"][1],
                    split_flops_ms=1e3 * 1.4 * flops / PEAK_FLOPS[dname],
                    dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
                    dkv_bound_ms=bounds["dkv"][0],
                    dkv_bound_by=bounds["dkv"][1],
                    exp_sfu_ms=exp_sfu_ms(bh, TOKENS, sfu_rate))
                row.update(split_kernel_ms(q, k, v, o, lse, do, kw))
                if not p:
                    row["library_ms"] = sdpa_backward_ms(F, q, k, v, do, sm)
                rows.append(row)
                print("kernel flash_attention_bwd " + json.dumps(row))
            del q, k, v, do, o, lse, got, ref
            torch.cuda.empty_cache()
    return rows


def phase_flash_shapes():
    """The bf16 forward and merged backward at the other shapes of the
    path and at the ragged edges of their tiles: batch 1 at T = 962 (a
    serving request of one sample, BH = 4: 16 q tiles, 64 blocks), and T =
    70 and 1 (one full and one 6-row tile; a single key), each head dim,
    dropout 0 and 0.1.  Held as phase_flash_kernel and phase_flash_bwd hold
    them (merged and split against the plain backward and each other), with
    one floor added to the backward's bound: at T = 1, dq and dk are exactly
    0 without dropout (a softmax over one key), and both sides then return
    the f32 rounding of dP - dvec, two D-term dot products of terms up to
    max |dO|·max |c v|, each taken as rounded by D·2^-24 of that (a sum of
    D terms rounds by about sqrt(D)·2^-24 of its terms' size), times scale
    and max |q|, |k|.  Returns the batch-1 forward's ms per launch by head
    dim (dropout 0)."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    batch1 = {}
    for b, t in ((1, TOKENS), (2, 70), (2, 1)):
        for d in HEAD_DIMS:
            q, k, v, do = (torch.randn(b, HEADS, t, d, device=DEVICE,
                                       generator=gen).to(torch.bfloat16)
                           for _ in range(4))
            sm = d ** -0.5
            for p in (0.0, DROP_P):
                seed = 77 if p else None
                kw = dict(sm_scale=sm, dropout_p=p, seed=seed)
                o, lse = fa.flash_mha_fwd(q, k, v, **kw)
                got = {mode: fa.flash_mha_bwd(q, k, v, o, lse, do, mode=mode,
                                              **kw)
                       for mode in ("merged", "split")}
                torch.cuda.synchronize()
                ro, rlse = fa.flash_mha_reference(q, k, v, sm, p, seed or 0)
                err_o = (o.float() - ro.float()).abs().max().item()
                err_l = (lse - rlse).abs().max().item()
                tol_o = max(TOL["bfloat16"][0],
                            2 * bf16_ulp(ro.float().abs().max()))
                check(err_o <= tol_o and err_l <= TOL["bfloat16"][1],
                      f"flash kernel bf16 B={b} T={t} d={d} p={p}: max |O "
                      f"err| {err_o:.3g} (tol {tol_o:.3g}), max |lse err| "
                      f"{err_l:.3g}")
                ref = fa.flash_mha_bwd_reference(q, k, v, o, lse, do, sm, p,
                                                 seed or 0)
                amax = lambda x: x.float().abs().max().item()  # noqa: E731
                c = 1.0 / (1.0 - p)
                floor = (2 * d * 2.0 ** -24 * amax(do) * amax(v) * c * sm
                         * max(amax(q), amax(k)))
                scale = [amax(r) for r in ref]
                err = {mode: [amax(g.float() - r.float())
                              for g, r in zip(got[mode], ref)]
                       for mode in got}
                err["merged_vs_split"] = [
                    amax(a.float() - b_.float())
                    for a, b_ in zip(got["merged"], got["split"])]
                for what, errs in err.items():
                    check(all(e <= BWD_RTOL["bfloat16"] * s_ + floor
                              for e, s_ in zip(errs, scale)),
                          f"flash backward bf16 B={b} T={t} d={d} p={p} "
                          f"{what}: max |d(q,k,v) err| {errs} of max |plain| "
                          f"{scale} (rtol {BWD_RTOL['bfloat16']}, floor "
                          f"{floor:.3g})")
                print(f"flash bf16 B={b} T={t} d={d} p={p}: O err {err_o:.3g},"
                      f" lse err {err_l:.3g}, d(q,k,v) err {err}")
                if b == 1 and not p:
                    batch1[d] = time_ms(lambda: fa.flash_mha_fwd(q, k, v,
                                                                 **kw))
    print("flash forward at batch 1 (BH = 4, T = 962, bf16, dropout 0), ms "
          "a launch: " + json.dumps(batch1) + f"; per serving forward "
          f"(8 at each head dim): {N_LAYER * sum(batch1.values())}")
    return batch1


def split_kernel_ms(q, k, v, o, lse, do, kw):
    """The split pair's dq kernel (flash_bwd_dq_mma_kernel in bf16,
    flash_bwd_dq_kernel in f32) and dk/dv kernel (flash_bwd_dkv_mma_kernel,
    flash_bwd_dkv_kernel) each alone, through their own C entries
    (tools/bench_flash.split_kernels), timed by CUDA events."""
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.tools import bench_flash
    dq, dkv = bench_flash.split_kernels(fa, q, k, v, o, lse, do, **kw)
    return {"dq_ms": time_ms(dq), "dkv_ms": time_ms(dkv)}


def sdpa_backward_ms(F, q, k, v, do, sm, timer=None):
    """Device time (``timer``, by default device_ms) of the backward of one
    scaled_dot_product_attention call (no dropout): timed only, never
    called by the port."""
    import torch
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, scale=sm)
    ms = (timer or device_ms)(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    del out
    return ms


def phase_scan_kernel(sfu_rate):
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for L, d in SCAN_SHAPES:
            # model-like inputs: dt = softplus(N(0, 1)), A = -(1..16)
            rnd = lambda *s: torch.randn(*s, device=DEVICE, generator=gen)  # noqa: E731
            u = rnd(BATCH, L, d).to(dtype)
            dt = F.softplus(rnd(BATCH, L, d))
            A = -torch.arange(1, D_STATE + 1, dtype=torch.float32,
                              device=DEVICE).expand(d, D_STATE).contiguous()
            B, C = (rnd(BATCH, L, D_STATE).to(dtype) for _ in range(2))
            for reverse in (False, True):
                y, h = ss.selective_scan_fwd(u, dt, A, B, C, reverse=reverse)
                y2, h2 = ss.selective_scan_fwd(u, dt, A, B, C,
                                               reverse=reverse)
                torch.cuda.synchronize()
                check(torch.equal(y, y2) and torch.equal(h, h2),
                      f"scan kernel {dname} L={L} d={d} reverse={reverse}: "
                      f"two calls on the same inputs differ")
                ry, rh = ss.selective_scan_reference(u, dt, A, B, C, reverse)
                err_y = (y - ry).abs().max().item()
                err_h = (h - rh).abs().max().item()
                scale_y = ry.abs().max().item()
                scale_h = rh.abs().max().item()
                check(err_y <= SCAN_RTOL * scale_y
                      and err_h <= SCAN_RTOL * scale_h,
                      f"scan kernel {dname} L={L} d={d} reverse={reverse}: "
                      f"max |y err| {err_y:.3g} of max |y| {scale_y:.3g}, "
                      f"max |h_out err| {err_h:.3g} of {scale_h:.3g} "
                      f"(rtol {SCAN_RTOL})")
                nbytes, flops, exps = scan_fwd_work(L, d, u.element_size())
                t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[
                    "float32"]
                kernel = lambda: ss.selective_scan_fwd(  # noqa: E731
                    u, dt, A, B, C, reverse=reverse)
                plain = lambda: ss.selective_scan_reference(  # noqa: E731
                    u, dt, A, B, C, reverse)
                row = dict(
                    dtype=dname, L=L, d=d, reverse=reverse, max_abs_err=err_y,
                    h_err=err_h, max_abs_y=scale_y, ms=device_ms(kernel),
                    chunks_per_group=ss.fwd_chunks_per_group(BATCH, L, d),
                    kernels_per_call=kernels_per_call(kernel),
                    event_ms=time_ms(kernel),
                    plain_ms=device_ms(plain, iters=5, warmup=1),
                    bytes=nbytes, flops=flops, bytes_ms=1e3 * t_bytes,
                    ops_ms=1e3 * t_ops, bound_ms=1e3 * max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    exps=exps, exp_sfu_ms=1e3 * exps / sfu_rate)
                rows.append(row)
                print("kernel selective_scan_fwd " + json.dumps(row))
            del u, dt, A, B, C, y, h, y2, h2, ry, rh
            torch.cuda.empty_cache()
    return rows


def scan_fwd_work(L, d, esize, batch=BATCH):
    """The scan forward's work at ``batch`` rows: the bytes it must move
    (u, dt, B, C and A read once, y and h_out written once), its f32
    operations and its exponentials."""
    nbytes = (batch * L * d * (esize + 4 + 4) + 2 * batch * L * D_STATE * esize
              + d * D_STATE * 4 + batch * D_STATE * d * 4)
    return (nbytes, batch * L * d * (7 * D_STATE + 1),
            batch * L * d * D_STATE)


def scan_inputs(gen, dtype, L, d, groups=0, batch=BATCH):
    """Scan inputs shaped as the MambaFuser gives them: u, dt and dy
    (batch, L, d), dt = softplus(N(0, 1)), A = -(1..16) per channel (halved
    for a second group when ``groups`` is 2), and B and C as column slices
    of an x_dbl (batch, L, d/32 + 32) after its dt_rank columns (at least
    one)."""
    import torch
    import torch.nn.functional as F
    rnd = lambda *s: torch.randn(*s, device=DEVICE, generator=gen)  # noqa: E731
    u = rnd(batch, L, d).to(dtype)
    dt = F.softplus(rnd(batch, L, d))
    A = -torch.arange(1, D_STATE + 1, dtype=torch.float32,
                      device=DEVICE).expand(d, D_STATE).contiguous()
    if groups:
        A = torch.stack([A, 0.5 * A])
    r = max(d // 32, 1)
    x_dbl = rnd(batch, L, r + 2 * D_STATE).to(dtype)
    B, C = x_dbl[..., r:r + D_STATE], x_dbl[..., r + D_STATE:]
    return u, dt, A, B, C, rnd(batch, L, d)


def phase_scan_bwd(sfu_rate):
    """The backward kernel in both directions against the plain backward,
    on the forward kernel's chunk-entry states (themselves held against the
    plain scan's states at the chunk boundaries), at the training path's
    shapes in f32 and bf16, plus a grouped-A (G = 2) case; B and C are
    column slices of a wider tensor throughout.  Timed with the plain
    backward beside the bound."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    cases = [(dtype, L, d, 0) for dtype in (torch.float32, torch.bfloat16)
             for L, d in SCAN_SHAPES]
    cases += [(dtype, TOKENS, 256, 2)
              for dtype in (torch.float32, torch.bfloat16)]
    rows = []
    for dtype, L, d, groups in cases:
        dname = str(dtype).split(".")[1]
        u, dt, A, B, C, dy = scan_inputs(gen, dtype, L, d, groups)
        for reverse in (False, True):
            _, _, h_in = ss._launch_fwd(u, dt, A, B, C, reverse, True)
            got = ss.selective_scan_bwd(u, dt, A, B, C, dy, h_in,
                                        reverse=reverse)
            again = ss.selective_scan_bwd(u, dt, A, B, C, dy, h_in,
                                          reverse=reverse)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"scan backward {dname} L={L} d={d} G={groups} "
                  f"reverse={reverse}: two calls on the same inputs differ")
            ref_h = ss.chunk_states_reference(u, dt, A, B, C, reverse)
            err_h = (h_in - ref_h).abs().max().item()
            scale_h = ref_h.abs().max().item()
            ref = ss.selective_scan_bwd_reference(u, dt, A, B, C, dy, reverse)
            err, scale = {}, {}
            for name, g, r in zip(SCAN_GRADS, got, ref):
                check(g.shape == r.shape and g.dtype == r.dtype,
                      f"scan backward {name}: {g.shape} {g.dtype}, plain "
                      f"{r.shape} {r.dtype}")
                err[name] = (g.float() - r.float()).abs().max().item()
                scale[name] = r.float().abs().max().item()
            tol = {k: SCAN_BWD_BF16_RTOL if (dname == "bfloat16" and k in (
                "du", "dB", "dC")) else SCAN_BWD_RTOL for k in SCAN_GRADS}
            label = (f"scan backward {dname} L={L} d={d} G={groups} "
                     f"reverse={reverse}")
            check(err_h <= SCAN_RTOL * scale_h, f"{label}: max |h_in err| "
                  f"{err_h:.3g} of {scale_h:.3g} (rtol {SCAN_RTOL})")
            check(all(err[k] <= tol[k] * scale[k] for k in SCAN_GRADS),
                  f"{label}: max |err| {err} of max |plain| {scale} (rtol "
                  f"{tol})")
            row = dict(dtype=dname, L=L, d=d, groups=groups, reverse=reverse,
                       rel_err={k: err[k] / scale[k] for k in SCAN_GRADS},
                       h_in_rel_err=err_h / scale_h if scale_h else err_h,
                       max_abs_err=max(err.values()))
            if not groups:
                row.update(scan_bwd_times(ss, u, dt, A, B, C, dy, h_in,
                                          reverse, sfu_rate))
            rows.append(row)
            print("kernel selective_scan_bwd " + json.dumps(row))
            del got, again, ref, ref_h, h_in
        del u, dt, A, B, C, dy
        torch.cuda.empty_cache()
    return rows


def phase_scan_edges():
    """The scan kernels at the edges of their chunk layout: L = 1, 63, 64,
    65 and 129 at d = 40 (no multiple of a block's channels) and d = 1024,
    and batch 1 at L = 962 (the forward's split into groups of one chunk),
    in both directions, f32 and bf16, with B and C column slices of x_dbl
    and grouped A (G = 2 at batch 2).  The forward at every group size
    that differs (one chunk a group, two, all) against the plain scan and
    its chunk-entry states (SCAN_RTOL), the backward against the plain
    backward (SCAN_BWD_RTOL, bf16 du/dB/dC SCAN_BWD_BF16_RTOL); two calls of
    each on the same inputs equal bit for bit."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    cases = [(2, L, d, 2) for L in SCAN_EDGE_L for d in SCAN_EDGE_D]
    cases.append((1, TOKENS, 256, 0))
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for b, L, d, groups in cases:
            u, dt, A, B, C, dy = scan_inputs(gen, dtype, L, d, groups, b)
            nc = ss.num_chunks(L)
            for reverse in (False, True):
                label = (f"scan edge {dname} b={b} L={L} d={d} G={groups} "
                         f"reverse={reverse}")
                ry, rh = ss.selective_scan_reference(u, dt, A, B, C, reverse)
                rh_in = ss.chunk_states_reference(u, dt, A, B, C, reverse)
                for G in sorted({1, 2, nc}):
                    outs = [ss._launch_fwd(u, dt, A, B, C, reverse, True, G)
                            for _ in range(2)]
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, c) for a, c in zip(*outs)),
                          f"{label} groups of {G}: two calls differ")
                    rel = {k: rel_gap(a, r) for k, a, r in zip(
                        ("y", "h_out", "h_in"), outs[0], (ry, rh, rh_in))}
                    check(max(rel.values()) <= SCAN_RTOL,
                          f"{label} groups of {G}: {rel} (rtol {SCAN_RTOL})")
                    worst["fwd"] = max(worst.get("fwd", 0),
                                       *rel.values())
                h_in = outs[0][2]
                got, again = (ss.selective_scan_bwd(
                    u, dt, A, B, C, dy, h_in, reverse=reverse)
                    for _ in range(2))
                torch.cuda.synchronize()
                check(all(torch.equal(a, c) for a, c in zip(got, again)),
                      f"{label}: two backward calls differ")
                ref = ss.selective_scan_bwd_reference(u, dt, A, B, C, dy,
                                                      reverse)
                rel = {k: rel_gap(g, r)
                       for k, g, r in zip(SCAN_GRADS, got, ref)}
                tol = {k: SCAN_BWD_BF16_RTOL if (
                    dname == "bfloat16" and k in ("du", "dB", "dC"))
                    else SCAN_BWD_RTOL for k in SCAN_GRADS}
                check(all(rel[k] <= tol[k] for k in SCAN_GRADS),
                      f"{label}: backward {rel} (rtol {tol})")
                key = f"bwd {dname}"
                worst[key] = max(worst.get(key, 0), *rel.values())
            del u, dt, A, B, C, dy
    torch.cuda.empty_cache()
    print(f"scan edges: {len(cases)} shapes x 2 dtypes x 2 directions, "
          f"largest error over largest value: {json.dumps(worst)}")
    return worst


def scan_bwd_times(ss, u, dt, A, B, C, dy, h_in, reverse, sfu_rate):
    """Device time of the backward (the whole wrapper), the kernel alone
    (its passes: local gradients, carry, main, the partials' sums), its
    device kernels a call, and the plain backward, beside the
    bound, the larger of: the bytes the function must move (u, dt, dy, B,
    C, A and h_in read once, du, ddt, dA, dB, dC written once) at the HBM
    rate, and about 16 f32 operations per (t, d, n) at the CUDA-core rate.
    Printed beside it, not part of it: the f32 partials of dB, dC and dA,
    which this design writes and reads once more (partials_ms), and the
    b·L·d·n exponentials at the SFU rate alone (exp_sfu_ms)."""
    wrapper = lambda: ss.selective_scan_bwd(  # noqa: E731
        u, dt, A, B, C, dy, h_in, reverse=reverse)
    return dict(
        ms=device_ms(wrapper),
        kernel_ms=passes_ms(wrapper, SCAN_BWD_PASSES),
        kernels_per_call=kernels_per_call(wrapper),
        event_ms=time_ms(wrapper),
        plain_ms=device_ms(lambda: ss.selective_scan_bwd_reference(
            u, dt, A, B, C, dy, reverse), iters=3, warmup=1),
        **scan_bwd_work(ss, u, A, h_in, sfu_rate))


def scan_bwd_work(ss, u, A, h_in, sfu_rate):
    """The scan backward's bound and what is printed beside it (see
    scan_bwd_times)."""
    b, L, d = u.shape
    es = u.element_size()
    nd = -(-d // ss.CHANNELS_PER_BLOCK)
    nbytes = (b * L * d * (es + 4 + 4) + 2 * b * L * D_STATE * es
              + A.numel() * 4 + h_in.numel() * 4              # read
              + b * L * d * (es + 4) + 2 * b * L * D_STATE * es
              + A.numel() * 4)                                # written
    partials = 2 * (2 * b * nd * L * D_STATE + b * d * D_STATE) * 4
    flops = b * L * d * (16 * D_STATE + 4)
    exps = b * L * d * D_STATE
    times = {"bytes_ms": 1e3 * nbytes / PEAK_BYTES,
             "ops_ms": 1e3 * flops / PEAK_FLOPS["float32"]}
    bound = max(times, key=times.get)
    return dict(
        bytes=nbytes, flops=flops, exps=exps, **times,
        partials_bytes=partials, partials_ms=1e3 * partials / PEAK_BYTES,
        exp_sfu_ms=1e3 * exps / sfu_rate, bound_ms=times[bound],
        bound_by="bytes" if bound == "bytes_ms" else "operations")


def phase_scan_seq(sfu_rate):
    """The sequential forward (#8) at the scan shapes in f32 and bf16, at
    batch 8 and 1, and at batch 16, L = 962, d = 1024 (the roofline tool's
    launch, two channels a lane: with the others, every launch split the
    kernel holds), with B and C column slices of x_dbl, plus a grouped-A (G
    = 2) case: y and h_out against its plain loop and against the chunked
    kernel (#6) on the same inputs, within SCAN_RTOL of their largest value;
    h_in against the plain chunk-entry states; y without h_in equal to y
    with it; in f32 the gradients through SelectiveScan(variant="sequential") against
    variant="chunked" (the same backward kernel) within SEQ_GRAD_RTOL; and
    reverse=True refused.  Timed by CUDA events queued behind a spin kernel
    (tools/timing.py; the profiler's traces of this kernel dropped
    launches), the chunked kernel and the plain loop (host-bound: ~8 small
    launches a step) beside, against the bound (the chunked forward's
    bytes)."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    cases = [(dtype, L, d, 0, b) for dtype in (torch.float32, torch.bfloat16)
             for b in (BATCH, 1) for L, d in SCAN_SHAPES]
    cases += [(dtype, TOKENS, 1024, 0, 2 * BATCH)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(dtype, TOKENS, 256, 2, BATCH)
              for dtype in (torch.float32, torch.bfloat16)]
    check({ss.seq_launch(b, d) for _, _, d, _, b in cases}
          == set(ss.SEQ_SPLITS), "sequential scan: the cases miss a split")
    rows = []
    for dtype, L, d, groups, b in cases:
        dname = str(dtype).split(".")[1]
        label = f"sequential scan {dname} b={b} L={L} d={d} G={groups}"
        u, dt, A, B, C, dy = scan_inputs(gen, dtype, L, d, groups, b)
        y, h, h_in = ss._launch_seq(u, dt, A, B, C, True)
        y0, h0 = ss.selective_scan_fwd(u, dt, A, B, C, variant="sequential")
        cy, ch = ss.selective_scan_fwd(u, dt, A, B, C)
        torch.cuda.synchronize()
        check(torch.equal(y, y0) and torch.equal(h, h0),
              f"{label}: writing h_in changed y or h_out")
        ry, rh, rh_in = ss.selective_scan_sequential_reference(u, dt, A, B, C)
        ref_h_in = ss.chunk_states_reference(u, dt, A, B, C)
        err = {"y_plain": (y, ry), "h_out_plain": (h, rh),
               "y_chunked": (y, cy), "h_out_chunked": (h, ch),
               "h_in": (h_in, ref_h_in), "h_in_loop": (h_in, rh_in)}
        rel = {k: rel_gap(a, b) for k, (a, b) in err.items()}
        check(all(v <= SCAN_RTOL for v in rel.values()),
              f"{label}: max |err| over max |ref| {rel} (rtol {SCAN_RTOL})")
        row = dict(dtype=dname, batch=b, L=L, d=d, groups=groups, rel_err=rel,
                   split=list(ss.seq_launch(b, d)),
                   max_abs_err=(y - ry).abs().max().item())
        if dtype == torch.float32:
            row["grad_rel_err"] = seq_grad_gap(ss, u, dt, A, B, C, dy)
            check(max(row["grad_rel_err"].values()) <= SEQ_GRAD_RTOL,
                  f"{label}: gradients, sequential against chunked forward: "
                  f"{row['grad_rel_err']} (rtol {SEQ_GRAD_RTOL})")
        try:
            ss.selective_scan_fwd(u, dt, A, B, C, reverse=True,
                                  variant="sequential")
            fail(f"{label}: reverse=True was not refused")
        except ValueError:
            pass
        if not groups:
            nbytes, flops, exps = scan_fwd_work(L, d, u.element_size(), b)
            t_bytes = nbytes / PEAK_BYTES
            t_ops = flops / PEAK_FLOPS["float32"]
            row.update(
                ms=time_ms(lambda: ss.selective_scan_fwd(
                    u, dt, A, B, C, variant="sequential")),
                chunked_ms=time_ms(lambda: ss.selective_scan_fwd(
                    u, dt, A, B, C)),
                plain_ms=time_ms(lambda: ss.selective_scan_sequential_reference(
                    u, dt, A, B, C), iters=2, warmup=1),
                bytes=nbytes, flops=flops, bytes_ms=1e3 * t_bytes,
                ops_ms=1e3 * t_ops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                exps=exps, exp_sfu_ms=1e3 * exps / sfu_rate)
        rows.append(row)
        print("kernel selective_scan_seq " + json.dumps(row))
        del u, dt, A, B, C, dy, y, h, h_in, ry, rh, rh_in, ref_h_in, cy, ch
        torch.cuda.empty_cache()
    return rows


def seq_grad_gap(ss, u, dt, A, B, C, dy):
    """Each gradient of y (for dy) through the sequential forward against
    the chunked forward's, as max |gap| over max |chunked|."""
    import torch
    grads = {}
    for variant in ("sequential", "chunked"):
        leaves = [x.detach().requires_grad_() for x in (u, dt, A, B, C)]
        y, _ = ss.selective_scan_fwd(*leaves, variant=variant)
        grads[variant] = torch.autograd.grad(y, leaves, dy)
    return {k: rel_gap(a, b) for k, a, b in zip(
        SCAN_GRADS, grads["sequential"], grads["chunked"])}


def rel_gap(a, b):
    """max |a - b| over max |b| (max |a - b| where b is all 0)."""
    err = (a.float() - b.float()).abs().max().item()
    scale = b.float().abs().max().item()
    return err / scale if scale else err


def phase_chain(fmul_rate, sfu_rate):
    """The calibration chain (#11) at both chain lengths, mul and exp, on
    the tool's (4096, 8, 1024) f32 array: the mul chain equal to the plain
    chain element for element, the exp chain within CHAIN_EXP_RTOL; each
    length at least twice its bytes' time.  Timed by CUDA events queued
    behind a spin kernel (tools/timing.py), with the plain chain beside the
    bound (tools/scan_roofline.chain_bound_ms): the k FMULs an element at
    the SMs' FMUL issue rate (half the data sheet's FMA-counting f32 rate)
    and, for the exp chain, the k exponentials at the SFU rate beside them
    (the larger of the two pipes), the bytes as the floor.  Printed beside
    it: the rates the two lengths imply."""
    import torch
    from deepsense6g_tii_tpu_torch.tools import scan_roofline as sr

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = 0.25 + 1.75 * torch.rand(sr.CHAIN_SHAPE, device=DEVICE, generator=gen)
    n_el = x.numel()
    rows, rates = [], {}
    for use_exp, lengths in ((False, sr.MUL_K), (True, sr.EXP_K)):
        what = "exp" if use_exp else "mul"
        for k in lengths:
            got = sr.chain(x, k, use_exp)
            torch.cuda.synchronize()
            ref = sr.chain_reference(x, k, use_exp)
            if use_exp:
                err = ((got - ref).abs() / ref.abs()).max().item()
                check(err <= CHAIN_EXP_RTOL, f"chain exp k={k}: max relative "
                      f"error {err:.3g} (rtol {CHAIN_EXP_RTOL})")
            else:
                err = (got - ref).abs().max().item()
                check(torch.equal(got, ref), f"chain mul k={k}: not equal to "
                      f"the plain chain (max |err| {err:.3g})")
            bound = sr.chain_bound_ms(k, use_exp, n_el, fmul_rate, sfu_rate)
            row = dict(
                op=what, k=k, max_abs_err=(got - ref).abs().max().item(),
                rel_err=err if use_exp else 0.0,
                ms=time_ms(lambda: sr.chain(x, k, use_exp)),
                plain_ms=time_ms(lambda: sr.chain_reference(x, k, use_exp),
                                 iters=2, warmup=1),
                bytes_ms=bound["bytes_ms"], ops_ms=bound["ops_ms"],
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                fmul_issue_ms=bound["fmul_ms"], exp_sfu_ms=bound["exp_ms"])
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            check(row["ms"] >= 2 * row["bytes_ms"], f"chain {what} k={k}: "
                  f"{row['ms']:.4g} ms is less than twice its bytes' time "
                  f"{row['bytes_ms']:.4g} ms: the calibration would be "
                  f"memory-bound")
            rows.append(row)
            print("kernel scan_roofline_chain " + json.dumps(row))
            del got, ref
        lo, hi = rows[-2], rows[-1]
        rates[what] = (hi["k"] - lo["k"]) * n_el / (hi["ms"] - lo["ms"]) * 1e3
    print("chain rates on the card: " + json.dumps(
        {"mul_per_s": rates["mul"], "exp_per_s": rates["exp"],
         "datasheet_fmul_per_s": fmul_rate, "datasheet_exp_per_s": sfu_rate,
         "datasheet_f32_flops": PEAK_FLOPS["float32"],
         "mul_share_of_fmul": rates["mul"] / fmul_rate,
         "exp_share_of_sfu": rates["exp"] / sfu_rate}))
    check(rates["mul"] <= 1.05 * fmul_rate, f"calibrated FMUL rate "
          f"{rates['mul']:.4g}/s above 105% of {fmul_rate:.4g}/s")
    del x
    torch.cuda.empty_cache()
    return rows


def phase_roofline(fmul_rate):
    """A main path: the roofline tool's main (the chain calibration and
    the scan forward, sequential forward and backward at B=16, L=962,
    d=1024), which prints its JSON line; the counts at 0 just before, read
    just after.  Returns its result and launches."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.tools import scan_roofline as sr

    _build.reset_launch_counts()
    out = sr.main([])
    torch.cuda.synchronize()
    counts = dict(_build.KERNEL_LAUNCHES)
    print(f"roofline launches: {counts}")
    check(all(counts.get(k, 0) > 0 for k in (
        sr.KERNEL_CHAIN, ss.KERNEL, ss.KERNEL_SEQ, ss.KERNEL_BWD)),
        f"roofline: a kernel of the path was not launched: {counts}")
    cal = out["calibration"]
    for what in ("mul", "exp"):
        c = cal[what]
        check(min(c["ms_lo"], c["ms_hi"]) >= 2 * c["bytes_ms"],
              f"roofline {what} chain: {c['ms_lo']:.4g} / {c['ms_hi']:.4g} ms "
              f"against a bytes bound of {c['bytes_ms']:.4g} ms")
    check(cal["mul_Tops"] * 1e12 <= 1.05 * fmul_rate,
          f"roofline: calibrated FMUL rate {cal['mul_Tops']:.4g} Tops above "
          f"105% of {fmul_rate / 1e12:.4g}")
    check(all(math.isfinite(out[k]["ms"]) and out[k]["ms"] > 0
              for k in ("fwd", "bwd", "fwd_sequential")),
          f"roofline: scan times {out}")
    return out, counts


def passes_ms(fn, tags, iters=10, tries=3):
    """Device time per call of ``fn`` of all the kernels whose names hold
    one of ``tags`` (a kernel's passes: it may run one, or several, a
    call), from a trace of ``iters`` calls.  The passes' launches must be a
    multiple of ``iters``; a trace where they are not (the profiler on the
    card's machine now and then drops device events) is taken again, up to
    ``tries`` times; if the last still is not, the passes' mean time times
    their launches a call (rounded) is taken, provided that the trace
    holds at least 90% of them."""
    import torch
    fn()
    for _ in range(tries):
        _, kernels, _ = traced(lambda: [fn() for _ in range(iters)])
        torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in kernels
                 if any(tag in e.name for tag in tags)]
        if times and len(times) % iters == 0:
            return sum(times) / iters / 1e3
    per_call = max(1, round(len(times) / iters))
    check(len(times) >= 0.9 * per_call * iters, f"{tries} traces hold "
          f"{len(times)} launches of {tags} for {iters} calls")
    print(f"passes_ms: {tries} traces dropped launches of {tags}; the last "
          f"holds {len(times)} for {iters} calls, timed by the mean")
    return sum(times) / len(times) * per_call / 1e3


def kernels_per_call(fn, tries=3):
    """The device kernels one call of ``fn`` launches, by name, from a
    trace of one call (the most of ``tries`` traces, as the profiler now
    and then drops events)."""
    from collections import Counter
    fn()
    best = Counter()
    for _ in range(tries):
        _, kernels, _ = traced(fn)
        counts = Counter(short_name(e.name) for e in kernels)
        if sum(counts.values()) > sum(best.values()):
            best = counts
    return dict(best)


def phase_slice(card, name, cfg, expect, f32_runs, f32_checks,
                tokens=None):
    """Serves ``cfg`` at full width (``tokens`` fused tokens) through
    Predictor; ``expect`` maps each kernel to its launches per forward (0:
    never launched).  Then runs the same weights in f32 under each of
    ``f32_runs`` (label: config overrides; a run with a smaller ``n_layer``
    keeps the first blocks of each stage) and holds each (a, b, tol) of
    ``f32_checks`` to max |logits a - logits b| <= tol, where a callable tol
    takes the dict of logits.  With ``pred_len`` P > 1 the beams are (B, P,
    3), the confidences the first step's top 3 and the logits (B, P, 64).
    Returns the launches per forward of the main path."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.serve import Predictor
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    check(cfg.n_tokens == (tokens or TOKENS) and cfg.n_layer == N_LAYER,
          f"{name}: unexpected served geometry {cfg}")
    steps = (cfg.pred_len,) if cfg.pred_len > 1 else ()
    conf_shape = (3,) if steps else ()
    model = BeamFuser(cfg, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, cfg, batch_buckets=(1, BATCH), device=DEVICE)
    pred.warmup()
    b = make_synth_batch(cfg, BATCH, seed=1, with_labels=False)
    arrs = [b[k] for k in ("image", "lidar", "radar", "gps")]

    # the main path: counts at 0 just before each request, read just after
    launches, results = [], {}
    for case, n in (("full", BATCH), ("ragged", 3), ("single", 1)):
        _build.reset_launch_counts()
        results[case] = pred.predict(*(a[:n] for a in arrs))
        torch.cuda.synchronize()
        launches.append(dict(_build.KERNEL_LAUNCHES))
    for counts in launches:
        check(set(counts) <= set(expect) and all(
            counts.get(k, 0) == v for k, v in expect.items()),
            f"{name}: expected launches per forward {expect}, got {counts}")
    for case, n in (("full", BATCH), ("ragged", 3), ("single", 1)):
        idx, conf = results[case]
        check(idx.shape == (n, *steps, 3) and conf.shape == (n, *conf_shape),
              f"{name} {case}: shapes {idx.shape}, {conf.shape}")
        check(idx.min() >= 1 and idx.max() <= cfg.num_beams,
              f"{name} {case}: beams outside 1..{cfg.num_beams}")
        check(np.isfinite(conf).all() and (conf > 0).all()
              and (conf <= 1).all(), f"{name} {case}: conf outside (0, 1]")
    (fi, fc), (ri, rc) = results["full"], results["ragged"]
    check(np.abs(rc - fc[:3]).max() <= 1e-3 and (ri[:, 0] == fi[:3, 0]).all(),
          f"{name}: ragged rows differ from the full batch: {rc} vs {fc[:3]}")
    print(f"{name}: top-1 beams {fi[..., 0].tolist()}, conf "
          f"{np.round(fc, 4).tolist()}; launches per forward {launches}")

    # f32: the kernels against the plain path on the same weights
    cfg32 = cfg.replace(compute_dtype="float32")
    sd = model.state_dict()
    x = [torch.from_numpy(a).to(DEVICE) for a in arrs]
    logits = {}
    for label, knobs in f32_runs.items():
        m = BeamFuser(cfg32.replace(**knobs), device=DEVICE)
        own = m.state_dict()
        m.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=True)
        _build.reset_launch_counts()
        with torch.inference_mode():
            logits[label] = m(*x).float()
        torch.cuda.synchronize()
        check(torch.isfinite(logits[label]).all().item()
              and logits[label].shape == (BATCH, *steps, cfg.num_beams),
              f"{name}: f32 logits ({label}) not finite or of the wrong "
              f"shape")
        print(f"{name} f32 {label}: launches {dict(_build.KERNEL_LAUNCHES)}, "
              f"max |logit| {logits[label].abs().max().item():.6g}")
        del m
    diff = lambda a, b: (logits[a] - logits[b]).abs().max().item()  # noqa: E731
    for a, b, tol in f32_checks:
        tol = tol(logits) if callable(tol) else tol
        err = diff(a, b)
        check(err <= tol, f"{name} f32 logits, {a} vs {b}: max |err| "
              f"{err:.3g} (tol {tol:.3g})")
        print(f"{name} f32 logits {a} vs {b}: max |err| {err:.6g} (tol "
              f"{tol:.6g})")
    del x

    lat = {bs: pred.latency_benchmark(bs, iters=20) for bs in (1, BATCH)}
    print(f"{name} serving latency on {card}: " + json.dumps(lat))
    for bs in (1, BATCH):
        profile_request(pred, [a[:bs] for a in arrs], card, name)
    del pred, model
    torch.cuda.empty_cache()
    return launches[0]


def profile_request(pred, arrs, card, name, top=8):
    """One traced request: device busy share of the host wall time and the
    kernels that take the most device time."""
    pred.predict(*arrs)
    profile_call(lambda: pred.predict(*arrs),
                 f"{name} profile batch {arrs[0].shape[0]} on {card}", top)


def phase_train(card, name, cfg, expect, tokens=None, steps=TRAIN_STEPS,
                falls=True):
    """A main path: ``steps`` full-width training steps of ``cfg`` (with
    ``tokens`` fused tokens) through make_train_step; ``expect`` is the
    exact launches of every step; with ``falls`` the loss must fall (the
    mean of the last quarter of the steps below that of the first, and the
    last loss below the first).  Returns the step's numbers and the
    initial weights and batch (for the f32 comparisons)."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    check(cfg.n_tokens == (tokens or TOKENS) and cfg.n_layer == N_LAYER
          and min(cfg.embd_pdrop, cfg.attn_pdrop, cfg.resid_pdrop) == DROP_P,
          f"{name}: unexpected geometry {cfg}")
    model = BeamFuser(cfg, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model)
    step = make_train_step(model, cfg, state, use_ema=True, device=DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in make_synth_batch(cfg, BATCH, seed=1).items()}
    losses, times, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        # the main path: counts at 0 just before each step, read just after
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = step(batch, TRAIN_LR)
        losses.append(out["loss"].item())        # waits for the step
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(dict(_build.KERNEL_LAUNCHES))
    peak = torch.cuda.max_memory_allocated()
    for i, counts in enumerate(launches):
        check(counts == expect, f"{name} step {i}: launches {counts}, "
              f"expected exactly {expect}")
    check(all(np.isfinite(losses)), f"{name}: loss not finite: {losses}")
    k = max(1, steps // 4)
    check(not falls or (np.mean(losses[-k:]) < np.mean(losses[:k])
                        and losses[-1] < losses[0]),
          f"{name}: loss does not fall over {steps} steps: {losses}")
    check(out["ranks"].shape == (BATCH, *((cfg.pred_len,) if cfg.pred_len
                                          > 1 else ()), cfg.num_beams),
          f"{name}: ranks shape {tuple(out['ranks'].shape)}")
    t = np.asarray(times[1:])
    p50 = float(np.percentile(t, 50))
    result = {"batch": BATCH, "steps": steps, "lr": TRAIN_LR,
              "loss": losses, "first_step_ms": times[0],
              "step_ms_p50": p50, "step_ms_p90": float(np.percentile(t, 90)),
              "samples_per_s": 1e3 * BATCH / p50,
              "peak_memory_gib": peak / 2 ** 30,
              "launches_per_step": launches[0]}
    print(f"{name} on {card}: " + json.dumps(result))
    result["profile"] = profile_call(
        lambda: step(batch, TRAIN_LR)["loss"].item(),
        f"{name} profile step batch {BATCH} on {card}", top=10)
    del step, state, model
    torch.cuda.empty_cache()
    return result, init, batch


class counted_train_steps:
    """Within it, every train step the engine makes (``train.engine.
    make_train_step``) appends its launches (counts at 0 just before the
    step, read just after) to ``step_counts``."""

    def __init__(self, step_counts):
        self.step_counts = step_counts

    def __enter__(self):
        from deepsense6g_tii_tpu_torch.ops import _build
        from deepsense6g_tii_tpu_torch.train import engine
        self.real = real = engine.make_train_step

        def counting(*a, **k):
            step = real(*a, **k)

            def counted(batch, lr):
                _build.reset_launch_counts()
                out = step(batch, lr)
                self.step_counts.append(dict(_build.KERNEL_LAUNCHES))
                return out
            return counted

        engine.make_train_step = counting
        return self

    def __exit__(self, *exc):
        from deepsense6g_tii_tpu_torch.train import engine
        engine.make_train_step = self.real


def cli_run(argv, step_counts, label):
    """One in-process run of the train CLI's main; every train step's
    launches (counts at 0 just before the step, read just after) go to
    ``step_counts``.  Returns the run's seconds."""
    from deepsense6g_tii_tpu_torch.cli import train as cli

    t0 = time.perf_counter()
    with counted_train_steps(step_counts):
        check(cli.main(argv) == 0, f"cli {label}: main did not return 0")
    return time.perf_counter() - t0


def epoch_perf(logdir):
    """The engine's per-epoch numbers from the run's scalars.jsonl."""
    out = {}
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["tag"].startswith("perf/") and "dispatch" not in r["tag"]:
                out.setdefault(r["step"], {})[r["tag"][5:]] = r["value"]
    return [out[e] for e in sorted(out)]


def check_test_csvs(out_dir, n, label):
    with open(os.path.join(out_dir, "beam_pred.csv"), newline="") as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["index", "top-1 beam", "top-2 beam", "top-3 beam"]
          and len(rows) == 1 + n, f"cli {label}: beam_pred.csv {rows[:2]}, "
          f"{len(rows) - 1} rows, expected {n}")
    check(all(1 <= int(b) <= 64 for r in rows[1:] for b in r[1:]),
          f"cli {label}: beams outside 1..64: {rows}")
    with open(os.path.join(out_dir, "beam_pred_confidence_seq.csv"),
              newline="") as f:
        conf = list(csv.reader(f))
    check(len(conf) == 1 + n and all(0 < float(r[1]) <= 1
                                     for r in conf[1:]),
          f"cli {label}: confidence CSV {conf}")


def phase_cli(card):
    """The training entry point users call, python -m deepsense6g_tii_tpu_
    torch.cli.train, driven in-process through its main on a DeepSense-
    layout tree that the port's utils/demo_data.py writes under build/.
    The full-width MambaFuser (defaults: FFM 1, TFM 1, bf16, scheduler,
    dropouts 0.1) trains 2 epochs with --ema 1 at batch 8 (21 training
    samples: batches of 8, 8 and 5), validates and checkpoints each epoch;
    a second main resumes to epoch 3 from the run record; --Test 1 with
    --load_model_path writes the test CSVs.  Every train step launches
    exactly 67 scan forwards and 67 scan backwards.  Then the GPT
    TransFuser (--FFM 0 --TFM 0) at --n_layer 2 for one epoch and a test:
    4 x n_layer flash forwards and merged backwards a step.  Also times the
    loader alone (ms a batch) and the camera reader (ms a frame)."""
    import shutil
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    from deepsense6g_tii_tpu_torch.data.dataset import build_train_val_sets
    from deepsense6g_tii_tpu_torch.data.loader import DataLoader
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.utils import image
    from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root

    base = os.path.join(REPO, "build", "cli")
    shutil.rmtree(base, ignore_errors=True)
    root = os.path.join(base, "data")
    t0 = time.perf_counter()
    make_demo_root(root, *CLI_SPLITS, seq_len=5, seed=0,
                   frame_shape=CLI_FRAME)
    tree_s = time.perf_counter() - t0
    common = ["--data_root", root, "--augmentation", "0",
              "--batch_size", str(CLI_BATCH), "--num_workers", "8"]
    # the 90% training share of development and adaptation, 2 scenarios
    n_train = int(0.9 * 2 * (CLI_SPLITS[0] + CLI_SPLITS[1]))
    n_test = 2 * CLI_SPLITS[2]
    n_scan = sum(SCAN_LAUNCHES.values())
    result = {"tree_s": tree_s}

    # the host side alone: the training loader over one epoch, and frames
    cfg = GlobalConfig()
    train_set, _ = build_train_val_sets(
        cfg, trainval_root=root + "/Multi_Modal/",
        train_root_csv="ml_challenge_dev_multi_modal.csv",
        adaptation_root=root + "/Adaptation_dataset_multi_modal/",
        adaptation_csv="ml_challenge_data_adaptation_multi_modal.csv",
        augmentation=False)
    check(len(train_set) == n_train, f"cli: {len(train_set)} training "
          f"samples, expected {n_train}")
    loader = DataLoader(train_set, CLI_BATCH, shuffle=True, num_workers=8)
    t0 = time.perf_counter()
    sizes = [len(b["image"]) for b in loader]
    result["loader_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / len(
        sizes)
    dev = train_set.dataset.datasets[0]
    frame = dev.root + dev.columns["unit1_rgb_1"][0]
    t0 = time.perf_counter()
    for _ in range(20):
        image.read_frame(frame, 256)
    result["frame_read_ms"] = 1e3 * (time.perf_counter() - t0) / 20

    legs = {}
    for name, flags, epochs, expect in (
            ("mamba", ["--ema", "1"], CLI_EPOCHS,
             {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}),
            ("gpt", ["--FFM", "0", "--TFM", "0",
                     "--n_layer", str(CLI_GPT_LAYERS)], 1,
             {fa.KERNEL: 4 * CLI_GPT_LAYERS,
              fa.KERNEL_MERGED: 4 * CLI_GPT_LAYERS})):
        logdir = os.path.join(base, name)
        counts, leg = [], {}
        argv = common + flags + ["--logdir", logdir]
        torch.cuda.synchronize()
        leg["train_s"] = cli_run(argv + ["--epochs", str(epochs)], counts,
                                 f"{name} train")
        steps = -(-n_train // CLI_BATCH)
        check(len(counts) == steps * epochs, f"cli {name}: {len(counts)} "
              f"train steps, expected {steps * epochs}")
        for i, c in enumerate(counts):
            check(c == expect, f"cli {name} step {i}: launches {c}, "
                  f"expected exactly {expect}")
        with open(os.path.join(logdir, "recent.log")) as f:
            rec = json.load(f)
        check(rec["epoch"] == epochs and len(rec["train_loss"]) == epochs
              and np.isfinite(rec["train_loss"]).all()
              and np.isfinite(rec["val_loss"]).all(),
              f"cli {name}: run record {rec}")
        for stem in ("final_model", "best_model", "best_optim"):
            check(os.path.isfile(os.path.join(logdir, stem + ".pt")),
                  f"cli {name}: {stem}.pt missing")
        leg["launches_per_step"] = counts[0]
        leg["train_loss"] = rec["train_loss"]
        leg["val_loss"] = rec["val_loss"]
        leg["DBA"] = rec["DBA"]
        if name == "mamba":
            counts = []
            leg["resume_s"] = cli_run(argv + ["--epochs", str(epochs + 1)],
                                      counts, f"{name} resume")
            with open(os.path.join(logdir, "recent.log")) as f:
                rec = json.load(f)
            check(rec["epoch"] == epochs + 1 and len(counts) == steps
                  and all(c == expect for c in counts)
                  and np.isfinite(rec["train_loss"]).all(),
                  f"cli {name}: resume to epoch {epochs + 1}: {rec}, "
                  f"launches {counts}")
            leg["resumed_train_loss"] = rec["train_loss"][-1]
        out_dir = os.path.join(base, name + "_test")
        os.makedirs(out_dir)
        cwd = os.getcwd()
        os.chdir(out_dir)            # the test CSVs land in the cwd
        try:
            leg["test_s"] = cli_run(
                common + flags + ["--logdir", os.path.join(base, name + "_t"),
                                  "--Test", "1", "--load_model_path",
                                  os.path.join(logdir, "best_model")],
                [], f"{name} test")
        finally:
            os.chdir(cwd)
        check_test_csvs(out_dir, n_test, name)
        leg["epochs"] = epoch_perf(logdir)
        print(f"cli {name} on {card}: " + json.dumps(leg))
        legs[name] = leg
        torch.cuda.empty_cache()
    result.update(legs)
    print(f"cli host side on {card}: " + json.dumps(
        {k: result[k] for k in ("tree_s", "loader_ms_per_batch",
                                "frame_read_ms")}))
    return result


def compact_vs_host(card, cache_dir, ru8_dir):
    """A compact batch (CachedBatchLoader: uint8 image and lidar, radar in
    float16 or uint8) against the same rows as CachedDataset upcasts them
    on the host, through the full-width MambaFuser on the card: the eval
    step's logits and the first train step's loss bit-equal (the steps
    upcast on the card).  Also the dtypes the engine's copy puts on the
    card, and one batch's copy time, compact against float32."""
    import torch
    from deepsense6g_tii_tpu_torch.data.cache import (CachedBatchLoader,
                                                      CachedDataset)
    from deepsense6g_tii_tpu_torch.data.loader import collate
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.serve import mambafuser_config
    from deepsense6g_tii_tpu_torch.tools import timing
    from deepsense6g_tii_tpu_torch.train.engine import (DEVICE_KEYS, Engine,
                                                        TrainOptions)
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import (make_eval_step,
                                                       make_train_step)

    cfg = mambafuser_config()
    out = {}

    def seeded():
        model = BeamFuser(cfg, device=DEVICE,
                          generator=torch.Generator().manual_seed(0))
        return model, create_train_state(model)

    model, state = seeded()
    eval_step = make_eval_step(model, cfg, state, device=DEVICE)
    logits = []
    hook = model.register_forward_hook(
        lambda mod, args, res: logits.append(res.detach().clone()))
    for name, d in (("radar float16", cache_dir), ("radar uint8", ru8_dir)):
        compact = next(iter(CachedBatchLoader(d, CLI_BATCH)))
        host = collate([CachedDataset(d)[i] for i in range(CLI_BATCH)])
        want = {"image": "uint8", "lidar": "uint8",
                "radar": "uint8" if d == ru8_dir else "float16"}
        got = {k: str(compact[k].dtype) for k in want}
        check(got == want, f"cache {name}: compact batch dtypes {got}, "
              f"expected {want}")
        logits.clear()
        eval_step(compact)
        eval_step(host)
        check(torch.equal(logits[0], logits[1]),
              f"cache {name}: eval logits of the compact batch differ from "
              f"the host-upcast batch's by "
              f"{(logits[0].float() - logits[1].float()).abs().max().item()}")
        out[name] = {"eval_logits_equal": True,
                     "max_abs_logit": logits[0].float().abs().max().item()}
        if d == cache_dir:
            losses = []
            for batch in (compact, host):
                m, st = seeded()
                step = make_train_step(m, cfg, st, use_ema=True,
                                       device=DEVICE)
                losses.append(step(batch, 1e-4)["loss"].item())
                del m, st, step
            check(losses[0] == losses[1], f"cache {name}: first train loss "
                  f"{losses[0]!r} (compact) against {losses[1]!r} (host)")
            out[name]["first_loss"] = losses[0]
            engine = Engine(model, cfg, TrainOptions(
                logdir=os.path.join(REPO, "build", "cli", "cache_engine")),
                device=DEVICE)
            dev, event = engine._to_device(compact)
            if event is not None:
                event.synchronize()
            out["dtypes_on_card"] = {k: str(t.dtype).removeprefix("torch.")
                                     for k, t in dev.items()}
            check(all(out["dtypes_on_card"][k] == v for k, v in want.items()),
                  f"cache: the engine put {out['dtypes_on_card']} on the "
                  f"card, expected the storage dtypes {want}")
            out["h2d"] = {
                kind: timing.h2d({k: b[k] for k in DEVICE_KEYS if k in b},
                                 DEVICE)
                for kind, b in (("compact", compact), ("f32", host))}
        torch.cuda.empty_cache()
    hook.remove()
    print(f"cache compact batch on {card}: " + json.dumps(out))
    return out


def phase_cache(card, cli):
    """The pre-featurized data path on the cli phase's tree: python -m
    deepsense6g_tii_tpu_torch.cli.train --cache_dir through its main for
    one epoch and validation on the full-width MambaFuser (the train and
    validation sets featurized into build/cli/cache, every cloud through
    the native loader; 67 scan forwards and 67 backwards a step), then a
    second main that finds the cache and builds nothing; the readers' ms a
    batch beside the cli phase's decode loader; compact batches against
    host-upcast ones on the card (compact_vs_host); native BEV maps equal
    the Python path's; bench_io, the convergence smoke and the DBA
    regression."""
    import shutil
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    from deepsense6g_tii_tpu_torch.data import cache as dcache
    from deepsense6g_tii_tpu_torch.data import features as F
    from deepsense6g_tii_tpu_torch.data.dataset import build_train_val_sets
    from deepsense6g_tii_tpu_torch.data.loader import DataLoader
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.runtime import native
    from deepsense6g_tii_tpu_torch.serve import mambafuser_config
    from deepsense6g_tii_tpu_torch.tools import (bench_io, convergence_smoke,
                                                 dba_regression)
    from deepsense6g_tii_tpu_torch.utils import ply

    base = os.path.join(REPO, "build", "cli")
    root = os.path.join(base, "data")
    cache_dir = os.path.join(base, "cache")
    check(native.available(), "cache: the native loader did not build")
    n_scan = sum(SCAN_LAUNCHES.values())
    expect = {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}
    result = {"native": True}

    # the CLI through the cache: a first main featurizes, a second finds it
    builds = []
    real_build = dcache.build_cache

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        out = real_build(*a, **k)
        builds.append(time.perf_counter() - t0)
        return out

    manifest = os.path.join(cache_dir, "train", "manifest.json")
    legs = {}
    dcache.build_cache = timed_build
    try:
        for leg in ("build", "reuse"):
            builds.clear()
            native.reset_calls()
            counts = []
            logdir = os.path.join(base, f"cache_{leg}")
            mtime = (os.stat(manifest).st_mtime_ns
                     if os.path.exists(manifest) else None)
            torch.cuda.synchronize()
            run_s = cli_run(["--data_root", root, "--augmentation", "0",
                             "--batch_size", str(CLI_BATCH),
                             "--num_workers", "8", "--ema", "1",
                             "--epochs", "1", "--cache_dir", cache_dir,
                             "--logdir", logdir], counts, f"cache {leg}")
            with open(os.path.join(logdir, "recent.log")) as f:
                rec = json.load(f)
            check(rec["epoch"] == 1 and np.isfinite(rec["train_loss"]).all()
                  and np.isfinite(rec["val_loss"]).all(),
                  f"cache {leg}: run record {rec}")
            check(counts and all(c == expect for c in counts),
                  f"cache {leg}: launches a step {counts}, expected "
                  f"exactly {expect}")
            legs[leg] = {"run_s": run_s, "build_s": list(builds),
                         "native_clouds": native.CALLS.get(
                             "batch_ply_to_bev", 0),
                         "launches_per_step": counts[0],
                         "train_loss": rec["train_loss"],
                         "val_loss": rec["val_loss"], "DBA": rec["DBA"],
                         "epochs": epoch_perf(logdir)}
            if leg == "reuse":
                check(os.stat(manifest).st_mtime_ns == mtime,
                      "cache reuse: the second main rewrote the manifest")
                check(legs[leg]["native_clouds"] == 0,
                      f"cache reuse: {legs[leg]['native_clouds']} clouds "
                      "decoded, expected none")
            torch.cuda.empty_cache()
    finally:
        dcache.build_cache = real_build
    train_set, val_set = build_train_val_sets(
        GlobalConfig(), trainval_root=root + "/Multi_Modal/",
        train_root_csv="ml_challenge_dev_multi_modal.csv",
        adaptation_root=root + "/Adaptation_dataset_multi_modal/",
        adaptation_csv="ml_challenge_data_adaptation_multi_modal.csv",
        augmentation=False)
    # build_cache reads sample 0 once more to size the memmaps
    clouds = 5 * (len(train_set) + 1 + len(val_set) + 1)
    check(legs["build"]["native_clouds"] == clouds,
          f"cache build: {legs['build']['native_clouds']} clouds through "
          f"the native loader, expected {clouds}")
    result.update(legs)
    result["uncached_epochs"] = cli["mamba"]["epochs"]

    # the readers alone, a batch of 8, beside the cli phase's decode loader
    def ms_per_batch(loader):
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        return 1e3 * (time.perf_counter() - t0) / n

    train_cache = os.path.join(cache_dir, "train")
    result["loader_ms_per_batch"] = {
        "decode (cli phase)": cli["loader_ms_per_batch"],
        "CachedDataset+DataLoader": ms_per_batch(DataLoader(
            dcache.CachedDataset(train_cache), CLI_BATCH, shuffle=True,
            num_workers=8)),
        "CachedBatchLoader": ms_per_batch(dcache.CachedBatchLoader(
            train_cache, CLI_BATCH, shuffle=True))}

    # compact batches against host-upcast ones, radar f16 and uint8
    ru8_dir = os.path.join(base, "cache_radar_uint8")
    dcache.build_cache(train_set, ru8_dir, radar_dtype="uint8")
    result["compact"] = compact_vs_host(card, train_cache, ru8_dir)

    # native BEV maps against the Python path, every cloud of the tree
    clouds = sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                    for f in fs if f.endswith(".ply"))
    fovs = np.asarray([F.fov_for_address(p, True) for p in clouds])
    got = native.batch_ply_to_bev(clouds, fovs)
    want = np.stack([F.lidar_to_bev_np(ply.read_points(p), fov)[0]
                     for p, fov in zip(clouds, fovs)])
    check(got is not None and np.array_equal(got, want),
          f"cache: native BEV maps differ from the Python path's on "
          f"{len(clouds)} clouds")
    result["native_bev_equal_clouds"] = len(clouds)

    # the host-side benchmark at realistic sizes
    io_root = os.path.join(base, "bench_io")
    os.makedirs(io_root)
    result["bench_io"] = bench_io.run(io_root + "/", BENCH_IO_SAMPLES,
                                      device=DEVICE)
    shutil.rmtree(io_root)

    # the convergence smoke: full width, bf16, the scan kernels
    t0 = time.perf_counter()
    conv = convergence_smoke.run(mambafuser_config(), CONVERGE_STEPS,
                                 CONVERGE_BATCH, CONVERGE_LR, DEVICE,
                                 verbose=False)
    conv["s"] = time.perf_counter() - t0
    check(conv["halved"], f"convergence smoke: the loss did not halve: "
          f"{conv['first']} -> {conv['last']}")
    result["convergence"] = {k: conv[k] for k in ("first", "last", "top1",
                                                  "s")}
    torch.cuda.empty_cache()

    # the DBA regression at its default small geometry, the kernels on
    t0 = time.perf_counter()
    dba = dba_regression.run(verbose=False, device=DEVICE)
    dba["s"] = time.perf_counter() - t0
    curve = dba["val_curve"]
    check(dba["dba_floor"] < DBA_FLOOR_MAX and dba["dba_raw"] >= DBA_MIN
          and dba["dba_ema"] >= DBA_MIN
          and dba["dba_ema"] >= dba["dba_raw"] - DBA_EMA_SLACK
          and np.mean(curve[-3:]) > np.mean(curve[:3]) + DBA_CURVE_RISE,
          f"DBA regression below the JAX thresholds: {json.dumps(dba)}")
    result["dba_regression"] = dba
    torch.cuda.empty_cache()
    print(f"cache on {card}: " + json.dumps(
        {k: v for k, v in result.items() if k != "compact"}))
    return result


def serve_main(argv, label):
    """One in-process run of ``python -m deepsense6g_tii_tpu_torch.serve``'s
    main; returns its JSON line and the kernel launches of the whole run
    (counts at 0 just before it, read just after)."""
    import contextlib
    import io
    import torch
    from deepsense6g_tii_tpu_torch import serve
    from deepsense6g_tii_tpu_torch.ops import _build

    buf = io.StringIO()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        check(serve.main(argv) == 0, f"serve {label}: main did not return 0")
    torch.cuda.synchronize()
    counts = dict(_build.KERNEL_LAUNCHES)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(out["batch"] == SERVE_BATCH and out["device"]
          == torch.cuda.get_device_name(0) and 0 < out["p50_ms"]
          <= out["p90_ms"], f"serve {label}: main printed {out}")
    return out, counts


def phase_serve(card, served):
    """Serving trained checkpoints through the serve CLI's main, at full
    width: the cli phase's best_model.pt (MambaFuser), whose top-3 on the
    8 test samples must equal the beam_pred.csv its --Test wrote; then the
    seed-0 GPT TransFuser and MambaFuser written as reference-layout .pth
    files by the port's exporter, each served by serve.main and loaded by
    Predictor.from_torch, whose logits at batch 1 and 8 must equal the
    source model's bit for bit, with the launches per forward of the gpt
    and mamba phases (``served``: name -> (config, launches per
    forward))."""
    import importlib.util
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch import serve
    from deepsense6g_tii_tpu_torch.data.dataset import BeamDataset
    from deepsense6g_tii_tpu_torch.data.loader import DataLoader
    from deepsense6g_tii_tpu_torch.models.checkpoint_import import (
        save_reference_checkpoint)
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    t0 = time.perf_counter()
    base = os.path.join(REPO, "build", "serve")
    os.makedirs(base, exist_ok=True)
    flags = ["--batch", str(SERVE_BATCH), "--iters", str(SERVE_ITERS)]
    result = {"msgpack_module_on_this_machine":
              importlib.util.find_spec("msgpack") is not None}

    # the cli phase's checkpoint, through serve.main and on the test split
    cli_dir = os.path.join(REPO, "build", "cli")
    ckpt = os.path.join(cli_dir, "mamba", "best_model.pt")
    per_forward = served["mamba"][1]
    out, counts = serve_main([ckpt] + flags, "best_model.pt")
    # a run of main's forwards: a warm-up at each of the Predictor's two
    # buckets, one request, the latency benchmark's warm-up and requests
    n = 2 + 1 + 1 + SERVE_ITERS
    check(counts == {k: v * n for k, v in per_forward.items() if v},
          f"serve best_model.pt: launches {counts}, expected {n} forwards "
          f"of {per_forward}")
    result["best_model.pt"] = {k: out[k] for k in ("p50_ms", "p90_ms",
                                                   "mean_ms", "batch")}
    pred = serve.Predictor.from_checkpoint(ckpt, serve.serving_config(
        1, 1, 1, True), batch_buckets=(1, CLI_BATCH), device=DEVICE)
    test_set = BeamDataset(os.path.join(cli_dir, "data", "Multi_Modal_Test")
                           + "/", "ml_challenge_test_multi_modal.csv",
                           pred.config, test=True)
    batch = next(iter(DataLoader(test_set, CLI_BATCH, num_workers=8)))
    arrs = [batch[k] for k in ("image", "lidar", "radar", "gps")]
    idx, _ = pred.predict(*arrs)
    with torch.inference_mode():
        probs = torch.softmax(pred.model(*(torch.from_numpy(a).to(DEVICE)
                                           for a in arrs)).float(), -1)
    probs = probs.cpu().numpy()
    with open(os.path.join(cli_dir, "mamba_test", "beam_pred.csv"),
              newline="") as f:
        rows = [[int(b) for b in r[1:]] for r in list(csv.reader(f))[1:]]
    check(len(rows) == len(idx) == 2 * CLI_SPLITS[2],
          f"serve: {len(rows)} CSV rows, {len(idx)} predictions")
    # equal beams, or beams of equal probability (a tie ordered otherwise)
    ties = 0
    for row, got, p in zip(rows, idx.tolist(), probs):
        if row != got:
            check(np.array_equal(p[np.asarray(row) - 1],
                                 p[np.asarray(got) - 1]),
                  f"serve: top-3 {got} of best_model.pt differ from the "
                  f"--Test CSV's {row}")
            ties += 1
    result["best_model.pt"]["test_rows_equal"] = len(rows) - ties
    result["best_model.pt"]["test_rows_tied"] = ties
    del pred
    torch.cuda.empty_cache()

    # seed-0 models as reference .pth files
    for name in ("gpt", "mamba"):
        cfg, per_forward = served[name]
        source = BeamFuser(cfg, device=DEVICE,
                           generator=torch.Generator().manual_seed(0))
        path = os.path.join(base, f"{name}.pth")
        save_reference_checkpoint(source, path)
        leg = {"pth_mib": os.path.getsize(path) / 2 ** 20}
        argv = [path] + flags + (["--FFM", "0", "--TFM", "0"]
                                 if not cfg.FFM else [])
        out, counts = serve_main(argv, f"{name}.pth")
        check(counts == {k: v * n for k, v in per_forward.items() if v},
              f"serve {name}.pth: launches {counts}, expected {n} forwards "
              f"of {per_forward}")
        leg.update({k: out[k] for k in ("p50_ms", "p90_ms", "mean_ms")})
        pred = serve.Predictor.from_torch(path, cfg, device=DEVICE)
        b = make_synth_batch(cfg, BATCH, seed=1, with_labels=False)
        for bs in (1, BATCH):
            x = [torch.from_numpy(b[k][:bs]).to(DEVICE)
                 for k in ("image", "lidar", "radar", "gps")]
            with torch.inference_mode():
                want = source(*x)
                _build.reset_launch_counts()
                got = pred.model(*x)
                torch.cuda.synchronize()
                launches = dict(_build.KERNEL_LAUNCHES)
            check(launches == {k: v for k, v in per_forward.items() if v},
                  f"serve {name}.pth batch {bs}: launches {launches}, "
                  f"expected {per_forward}")
            check(torch.equal(got, want), f"serve {name}.pth batch {bs}: "
                  f"logits differ from the source model's by "
                  f"{(got - want).abs().max().item():.3g}")
        leg["logits_bit_equal"] = True
        result[f"{name}.pth"] = leg
        del source, pred
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t0
    print(f"serve on {card}: " + json.dumps(result))
    return result


def scan_launches(cfg):
    """The scan launches per forward by (L, d_inner): each fusion stage's
    MambaBlocks in both directions at L = n_tokens (d_inner twice the
    stage's 64..512 channels), and the TimeMamba head's 3 at L = seq_len
    (d_inner 1024)."""
    out = {(cfg.n_tokens, 2 * c): 2 * cfg.n_layer for c in (64, 128, 256,
                                                            512)}
    out[(cfg.seq_len, 1024)] = 3
    return out


def phase_30to5(card, gpt_cfg, mamba_cfg):
    """The 30-to-5 variant (config_30to5: 10 frames, 5 predicted beams,
    1922 tokens) at full width in bf16: both models served at buckets (1,
    8) (32 flash launches per GPT forward, 67 scan launches per Mamba
    forward and none of the other kernel), f32 logits through the kernels
    held to the plain path (the GPT within LOGIT_TOL or LOGIT_RTOL_30TO5
    of the largest logit; the MambaFuser cut to one block a stage, as in
    the mamba phase, within LOGIT_TOL or MAMBA_LOGIT_RTOL of it); the
    MambaFuser trained 5 steps
    (67 scan forwards and 67 backwards a step, the loss finite and
    falling) and the GPT TransFuser 3 (32 flash forwards and 32 merged
    backwards a step, the loss finite).  Returns the launches and numbers
    of each leg."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    t0 = time.perf_counter()
    tokens = mamba_cfg.n_tokens
    check(gpt_cfg.n_tokens == tokens and gpt_cfg.pred_len
          == mamba_cfg.pred_len > 1, f"30to5: geometries {gpt_cfg}, "
          f"{mamba_cfg}")
    n_scan = sum(scan_launches(mamba_cfg).values())
    out = {"tokens": tokens}

    out["gpt_serve"] = phase_slice(
        card, "30to5 gpt", gpt_cfg, {fa.KERNEL: 4 * N_LAYER, ss.KERNEL: 0},
        {"flash": dict(use_flash_attention=True),
         "plain": dict(use_flash_attention=False)},
        [("flash", "plain", lambda lg: max(
            LOGIT_TOL, LOGIT_RTOL_30TO5 * lg["plain"].abs().max().item()))],
        tokens=tokens)
    # the MambaFuser cut to one block a stage: 4.93e-3 on logits of 439
    # (1.1e-5 of the largest) between the scan and the plain path, where
    # the 5-frame model cut so sits at 1.7e-6 (NVIDIA H100 80GB HBM3, 700
    # W; PERF.md): held to MAMBA_LOGIT_RTOL of the largest logit, the
    # bound of the MambaFuser's f32 rounding; the plain path's own shift
    # between two roundings (reverse_scan_kernel off and on) is printed
    out["mamba_serve"] = phase_slice(
        card, "30to5 mamba", mamba_cfg, {ss.KERNEL: n_scan, fa.KERNEL: 0},
        {"scan x1": dict(use_pallas_scan=True, n_layer=1),
         "plain x1": dict(use_pallas_scan=False, n_layer=1),
         "plain reverse x1": dict(use_pallas_scan=False, n_layer=1,
                                  reverse_scan_kernel=True)},
        [("plain reverse x1", "plain x1", float("inf")),
         ("scan x1", "plain x1", lambda lg: max(
             LOGIT_TOL, MAMBA_LOGIT_RTOL
             * lg["plain x1"].abs().max().item()))],
        tokens=tokens)
    torch.cuda.empty_cache()
    out["mamba_train"], _, _ = phase_train(
        card, "30to5 mamba train", mamba_cfg,
        {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}, tokens=tokens,
        steps=STEPS_30TO5)
    torch.cuda.empty_cache()
    out["gpt_train"], _, _ = phase_train(
        card, "30to5 gpt train", gpt_cfg,
        {fa.KERNEL: 4 * N_LAYER, fa.KERNEL_MERGED: 4 * N_LAYER},
        tokens=tokens, steps=GPT_STEPS_30TO5, falls=False)
    torch.cuda.empty_cache()
    out["scan_shapes"] = scan_launches(mamba_cfg)
    out["seconds"] = time.perf_counter() - t0
    print(f"30to5 on {card}: " + json.dumps(
        {k: out[k] for k in ("tokens", "seconds")}))
    return out


def rebuild_trainer(cfg, seed=0):
    """A RebuildTrainer (lidar + radar to image) over a seed-``seed``
    BeamFuser of ``cfg``, its state initialised."""
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.rebuild.trainer import (RebuildOptions,
                                                          RebuildTrainer)
    model = BeamFuser(cfg, device=DEVICE,
                      generator=torch.Generator().manual_seed(seed))
    trainer = RebuildTrainer(model, cfg, RebuildOptions(), device=DEVICE)
    trainer.init_state()
    return trainer


def counted(fn):
    """``fn()``'s result and the kernel launches it made (counts at 0 just
    before it, read just after)."""
    from deepsense6g_tii_tpu_torch.ops import _build
    _build.reset_launch_counts()
    out = fn()
    return out, dict(_build.KERNEL_LAUNCHES)


def phase_rebuild(card):
    """The modality-rebuild subsystem (lidar + radar rebuild the image's
    stage-1 features), full width, bf16, batch 8:

    - the MambaFuser (mambafuser_config(modality_missing="image")): the
      frozen stage-1 tap and the rebuilt features launch no kernel;
      REBUILD_STEPS RebuildTrainer steps (the fusion model in eval mode
      with gradients, the heads in train mode: 67 scan forwards with h_in
      and 67 scan backwards a step), the five losses finite; step p50/p90,
      samples/s, peak memory, and the device's busy time (device_ms) and
      idle share of the step; REBUILD_EVAL_STEPS eval steps (67 scan
      forwards each);
    - the f32 step cut to one block a stage through the scan kernels and
      through the plain scan from the same state: losses, heads' BatchNorm
      statistics and gradients within the REBUILD_* bounds;
    - the GPT TransFuser: REBUILD_GPT_STEPS steps, 32 flash forwards and 32
      merged backwards a step, every attention call at dropout 0;
    - the rebuild CLI on the cli phase's demo tree from its best_model.pt:
      one epoch (67 + 67 scan launches a step), the 5-way best and final
      files, then --Val 1 --load_model_dir on the run: a finite DBA;
    - the VFA trainer: VFA_STEPS steps on random features at the reference
      widths (2304, 2048, 512); the loss falls.

    Returns each leg's launches and numbers."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.cli import rebuild as rcli
    from deepsense6g_tii_tpu_torch.models import fusion
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.rebuild import video_flow_audio as vfa
    from deepsense6g_tii_tpu_torch.rebuild.trainer import (HEAD_KEYS,
                                                          RebuildTrainer)
    from deepsense6g_tii_tpu_torch.serve import (gpt_transfuser_config,
                                                 mambafuser_config)
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    t_phase = time.perf_counter()
    n_scan = sum(SCAN_LAUNCHES.values())
    out = {}
    losses_names = ("loss", "trans", "contrast", "distance", "fusion")

    # -- the MambaFuser: tap, steps, eval steps ----------------------------
    cfg = mambafuser_config(modality_missing="image")
    check(cfg.n_tokens == TOKENS and cfg.n_layer == N_LAYER,
          f"rebuild: unexpected geometry {cfg}")
    trainer = rebuild_trainer(cfg)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in make_synth_batch(cfg, BATCH, seed=3).items()}
    rebuilt, tap = counted(lambda: trainer.rebuild_features(batch))
    side = cfg.input_resolution // 4          # stage 1: stride 4
    check(tap == {} and tuple(rebuilt.shape) == (BATCH * cfg.seq_len, side,
                                                 side, 64)
          and bool(torch.isfinite(rebuilt).all()),
          f"rebuild: rebuilt features {tuple(rebuilt.shape)}, launches {tap}"
          f" (the tap and the heads launch no kernel)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = [], [], []
    for _ in range(REBUILD_STEPS):
        t0 = time.perf_counter()
        aux, counts = counted(lambda: trainer.train_step(batch, TRAIN_LR,
                                                         floats=True))
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(aux)
        launches.append(counts)
        print("rebuild mamba step: " + json.dumps(aux))
    peak = torch.cuda.max_memory_allocated()
    want = {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}
    for i, counts in enumerate(launches):
        check(counts == want, f"rebuild mamba step {i}: launches {counts}, "
              f"expected exactly {want}")
    check(all(np.isfinite(list(a.values())).all() for a in losses),
          f"rebuild mamba: losses not finite: {losses}")
    t = np.asarray(times[1:])
    p50 = float(np.percentile(t, 50))
    busy = device_ms(lambda: trainer.train_step(batch, TRAIN_LR), iters=2,
                     warmup=0)
    evals, eval_counts = [], []
    for i in range(REBUILD_EVAL_STEPS):
        t0 = time.perf_counter()
        ev, counts = counted(lambda: trainer.eval_step(batch, i))
        ev["ranks"].cpu()
        evals.append(1e3 * (time.perf_counter() - t0))
        eval_counts.append(counts)
    check(all(c == {ss.KERNEL: n_scan} for c in eval_counts),
          f"rebuild mamba eval: launches {eval_counts[0]}, expected "
          f"{ {ss.KERNEL: n_scan} }")
    check(tuple(ev["ranks"].shape) == (BATCH, cfg.num_beams)
          and bool(torch.isfinite(ev["loss"])), f"rebuild mamba eval: "
          f"ranks {tuple(ev['ranks'].shape)}, loss {ev['loss']}")
    out["mamba"] = {
        "batch": BATCH, "steps": REBUILD_STEPS, "lr": TRAIN_LR,
        "losses": {k: [a[k] for a in losses] for k in losses_names},
        "first_step_ms": times[0], "step_ms_p50": p50,
        "step_ms_p90": float(np.percentile(t, 90)),
        "samples_per_s": 1e3 * BATCH / p50,
        "peak_memory_gib": peak / 2 ** 30, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / p50,
        "eval_ms_p50": float(np.percentile(evals[1:], 50)),
        "tap_launches": tap, "launches_per_step": launches[0],
        "launches_per_eval": eval_counts[0]}
    print(f"rebuild mamba on {card}: " + json.dumps(out["mamba"]))
    del trainer, batch
    torch.cuda.empty_cache()

    # -- f32, one block a stage: scan kernels against the plain scan --------
    res = {}
    batch = make_synth_batch(cfg, BATCH, seed=4)
    for path in ("scan", "plain"):
        tr = rebuild_trainer(mambafuser_config(
            modality_missing="image", compute_dtype="float32", n_layer=1,
            use_pallas_scan=path == "scan"))
        aux, counts = counted(lambda: tr.train_step(batch, TRAIN_LR,
                                                    floats=True))
        check(counts == ({ss.KERNEL: 11, ss.KERNEL_BWD: 11}
                         if path == "scan" else {}),
              f"rebuild f32 {path}: launches {counts}")
        params = (list(tr.heads.named_parameters(prefix="heads"))
                  + list(tr.fusion_model.named_parameters(prefix="fusion")))
        res[path] = (aux, {k: q.grad.detach().clone() for k, q in params},
                     {k: b.clone() for k, b in tr.heads.named_buffers()})
        del tr
        torch.cuda.empty_cache()
    gap = f32_gaps((res["scan"][0]["loss"],) + res["scan"][1:],
                   (res["plain"][0]["loss"],) + res["plain"][1:])
    gap["losses_rel"] = {k: abs(res["scan"][0][k] - res["plain"][0][k])
                         / abs(res["plain"][0][k]) for k in losses_names}
    print("rebuild f32 step, scan vs plain (one block a stage): "
          + json.dumps(gap))
    check(max(gap["losses_rel"].values()) <= REBUILD_LOSS_RTOL,
          f"rebuild f32: losses {gap['losses_rel']}")
    check(gap["stats_worst"] <= TRAIN_STATS_RTOL, f"rebuild f32: heads' "
          f"BatchNorm statistics off by {gap['stats_worst']:.3g}")
    check(gap["grad_global_rel"] <= REBUILD_GRAD_RTOL
          and gap["grad_worst"] <= REBUILD_GRAD_TENSOR_RTOL
          and gap["zero_leaves"] == 0.0 and gap["exact_zero"] <= 1e-6,
          f"rebuild f32: gradients off by {gap['grad_global_rel']:.3g} of "
          f"their norm, {gap['grad_worst_name']} by {gap['grad_worst']:.3g}"
          f" of its largest |g|, gradient-free tensors by "
          f"{gap['zero_leaves']:.3g}, biases before BatchNorm by "
          f"{gap['exact_zero']:.3g} of the largest |g|")
    out["f32"] = gap

    # -- the GPT TransFuser: flash forward and merged backward at p = 0 ----
    gcfg = gpt_transfuser_config(modality_missing="image")
    trainer = rebuild_trainer(gcfg)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in make_synth_batch(gcfg, BATCH, seed=5).items()}
    drops, real = [], fusion.flash_mha

    def recording_p(q, k, v, **kw):
        drops.append(kw["dropout_p"])
        return real(q, k, v, **kw)

    fusion.flash_mha = recording_p
    gpt, times = [], []
    try:
        for _ in range(REBUILD_GPT_STEPS):
            t0 = time.perf_counter()
            aux, counts = counted(lambda: trainer.train_step(
                batch, TRAIN_LR, floats=True))
            times.append(1e3 * (time.perf_counter() - t0))
            gpt.append((aux, counts))
    finally:
        fusion.flash_mha = real
    want = {fa.KERNEL: 4 * N_LAYER, fa.KERNEL_MERGED: 4 * N_LAYER}
    check(all(c == want for _, c in gpt), f"rebuild gpt: launches "
          f"{[c for _, c in gpt]}, expected exactly {want} a step")
    check(len(drops) == 4 * N_LAYER * REBUILD_GPT_STEPS
          and set(drops) == {0.0}, f"rebuild gpt: attention dropout "
          f"{sorted(set(drops))} (the fusion model runs in eval mode)")
    check(all(np.isfinite(a["loss"]) for a, _ in gpt),
          f"rebuild gpt: losses {[a for a, _ in gpt]}")
    out["gpt"] = {"losses": [a for a, _ in gpt], "step_ms": times,
                  "launches_per_step": gpt[0][1]}
    print(f"rebuild gpt on {card}: " + json.dumps(out["gpt"]))
    del trainer, batch
    torch.cuda.empty_cache()

    # -- the rebuild CLI on the cli phase's tree and best model ------------
    base = os.path.join(REPO, "build", "rebuild")
    shutil.rmtree(base, ignore_errors=True)
    root = os.path.join(REPO, "build", "cli", "data")
    fusion_path = os.path.join(REPO, "build", "cli", "mamba", "best_model.pt")
    check(os.path.isfile(fusion_path), f"rebuild cli: {fusion_path} missing")
    common = ["-s", "lidar", "radar", "-t", "image", "--data_root", root,
              "--fusion_model_path", fusion_path, "--batch_size",
              str(CLI_BATCH), "--num_workers", "8"]
    logdir = os.path.join(base, "run")
    step_counts, real_step = [], RebuildTrainer.train_step

    def counting_step(self, *a, **k):
        res, counts = counted(lambda: real_step(self, *a, **k))
        step_counts.append(counts)
        return res

    RebuildTrainer.train_step = counting_step
    t0 = time.perf_counter()
    try:
        check(rcli.main(common + ["--logdir", logdir, "--epochs",
                                  str(REBUILD_CLI_EPOCHS)]) == 0,
              "rebuild cli: main did not return 0")
    finally:
        RebuildTrainer.train_step = real_step
    train_s = time.perf_counter() - t0
    n_train = int(0.9 * 2 * (CLI_SPLITS[0] + CLI_SPLITS[1]))
    check(len(step_counts) == -(-n_train // CLI_BATCH)
          and all(c == {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}
                  for c in step_counts),
          f"rebuild cli: {len(step_counts)} steps, launches {step_counts}")
    files = sorted(os.listdir(logdir))
    for name in [f"{p}_{k}.pt" for p in ("best", "final")
                 for k in HEAD_KEYS + ("fusion_model",)] + ["best_optim.pt"]:
        check(name in files, f"rebuild cli: {name} missing from {files}")
    with open(os.path.join(logdir, "recent.log")) as f:
        rec = json.load(f)
    check(rec["epoch"] == REBUILD_CLI_EPOCHS
          and np.isfinite(rec["train_loss"]).all()
          and np.isfinite(rec["DBA"]).all(), f"rebuild cli: record {rec}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        check(rcli.main(common + ["--logdir", os.path.join(base, "val"),
                                  "--Val", "1", "--load_model_dir",
                                  logdir]) == 0,
              "rebuild cli --Val: main did not return 0")
    val_s = time.perf_counter() - t0
    text = buf.getvalue()
    check("Val DBA:" in text, f"rebuild cli --Val: no DBA in {text!r}")
    val_dba = float(text.split("Val DBA:")[1].split()[0])
    check(np.isfinite(val_dba) and 0.0 <= val_dba <= 1.0,
          f"rebuild cli --Val: DBA {val_dba}")
    out["cli"] = {"train_s": train_s, "val_s": val_s,
                  "train_loss": rec["train_loss"], "DBA": rec["DBA"],
                  "val_dba": val_dba, "launches_per_step": step_counts[0],
                  "files": files}
    print(f"rebuild cli on {card}: " + json.dumps(out["cli"]))
    torch.cuda.empty_cache()

    # -- the VFA trainer at the reference widths ---------------------------
    opts = vfa.VFAOptions()
    gen = np.random.default_rng(6)
    feats = {m: gen.normal(size=(VFA_BATCH, d)).astype(np.float32)
             for m, d in zip(opts.modalities, opts.emd_dims)}
    labels = gen.integers(0, opts.n_classes, VFA_BATCH)
    vt = vfa.VFATrainer(opts, device=DEVICE)
    vt.init_state(feats)
    vlosses, vcounts = [], []
    for _ in range(VFA_STEPS):
        aux, counts = counted(lambda: vt.train_step(feats, labels))
        vlosses.append(aux["loss"].item())
        vcounts.append(counts)
    check(all(c == {} for c in vcounts) and np.isfinite(vlosses).all()
          and vlosses[-1] < vlosses[0], f"rebuild vfa: losses {vlosses}, "
          f"launches {vcounts}")
    out["vfa"] = {"losses": vlosses, "batch": VFA_BATCH,
                  "emd_dims": list(opts.emd_dims)}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"rebuild vfa on {card}: " + json.dumps(out["vfa"]))
    print(f"rebuild on {card}: {out['seconds']:.1f} s")
    return out


def check_port_rows(prof, expect, label):
    """Each launched wrapper of ``expect`` (KERNEL name: launches a step)
    stands in the category table at its launches and, unless the trace
    is empty, with device time; and no device time goes to a wrapper that
    did not launch (a kernel renamed, or its template flag read wrong)."""
    rows = {c["category"]: c for c in prof["categories"]}
    for name, n in expect.items():
        row = rows.get("port: " + name)
        check(row is not None and row["launches_per_step"] == n,
              f"{label}: {name} not in the category table at {n} a step: "
              f"{row}")
        check(prof["trace_empty"] or row["ms_per_step"] > 0,
              f"{label}: {name} launched but has no device time: {row}")
    for c, row in rows.items():
        check(not c.startswith("port: ") or row["ms_per_step"] == 0
              or set(c[len("port: "):].split(" + ")) <= set(expect),
              f"{label}: device time of {c}, which did not launch: {row}")


def attributed(label, fn):
    """Traces ATTRIBUTION_CALLS calls of ``fn`` (after a first, untraced
    one; a trace of one short call is often empty on the card's machine),
    the wrappers' launches counted from 0, and holds profile_step's
    category table to it: the port's device kernels in the trace go to the wrappers
    that launched, and to all of them (a renamed kernel, or a template flag
    read wrong, fails).  Returns the categories, or None where the
    profiler recorded no device event (printed; nothing to hold)."""
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.tools import profile_step
    fn()
    _build.reset_launch_counts()
    _, kernels, _ = traced(lambda: [fn() for _ in range(ATTRIBUTION_CALLS)])
    launched = set(_build.KERNEL_LAUNCHES)
    if not kernels:
        print(f"{label}: the trace holds no device event; not checked")
        return None
    cats = sorted({profile_step.category(e.name, launched) for e in kernels
                   if short_name(e.name) in profile_step.PORT_KERNELS})
    named = {n for c in cats for n in c[len("port: "):].split(" + ")}
    check(named == launched, f"{label}: the kernels went to {cats}; the "
                             f"wrappers that launched: {sorted(launched)}")
    print(f"{label}: " + json.dumps(cats))
    return cats


def attribution_legs():
    """profile_step's categories for the wrappers the profiled steps do
    not launch, at training shapes in bf16: the split flash backward (#3,
    #4) at dropout DROP_P and the reverse scan forward and backward (#7,
    #10) through autograd."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    q, k, v, do = (torch.randn(BATCH, HEADS, TOKENS, 64, device=DEVICE,
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(sm_scale=64 ** -0.5, dropout_p=DROP_P, seed=-7)
    o, lse = fa.flash_mha_fwd(q, k, v, **kw)
    u, dt, A, B, C, dy = scan_inputs(gen, torch.bfloat16, TOKENS, 256)
    u.requires_grad_()

    def reverse_scan():
        y, _ = ss.selective_scan_fwd(u, dt, A, B, C, reverse=True)
        y.backward(dy)
        torch.cuda.synchronize()

    return {"split": attributed(
                "tools attribution split backward", lambda: fa.flash_mha_bwd(
                    q, k, v, o, lse, do, mode="split", **kw)),
            "reverse": attributed("tools attribution reverse scan",
                                  reverse_scan)}


def phase_tools(card):
    """The tools users call to measure the port: tools/bench_serve.py's run
    for the full-width GPT TransFuser and MambaFuser at buckets (1, 8),
    the tool's default bench_serve.ITERS requests each (p50/p90 and
    pipelined samples/s), and tools/profile_step.py's run of each model's
    train step at the tool's card defaults (B=8, bf16), PROFILE_STEPS
    steps traced: ms a step by category, the top kernels, the convolutions
    by site, the dropped events.  The profiled steps are a main path: the
    wrappers' launches are counted from 0 over the traced steps, and #1
    and #2 (GPT) or #6 and #9 (MambaFuser) must stand in the category
    table at 32 or 67 a step with device time.  attribution_legs holds
    the table's mapping for the wrappers these steps do not launch (#3,
    #4, #7, #10) to the kernel names of a traced call.  Then
    tools/bench_matrix.py's main runs its gpt_serve item in a process of
    its own, whose entry must hold no error."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.serve import (gpt_transfuser_config,
                                                 mambafuser_config)
    from deepsense6g_tii_tpu_torch.tools import (bench_matrix, bench_serve,
                                                 profile_step)

    t_start = time.perf_counter()
    n_scan = sum(SCAN_LAUNCHES.values())
    out = {}
    for arch, make in (("gpt", gpt_transfuser_config),
                       ("mamba", mambafuser_config)):
        serve = bench_serve.run(make(), (1, BATCH), iters=bench_serve.ITERS,
                                device=DEVICE)
        for b in (1, BATCH):
            r = serve[f"b{b}"]
            check(0 < r["p50_ms"] <= r["p90_ms"] < float("inf"),
                  f"tools bench_serve {arch} batch {b}: {r}")
        check(serve["pipelined"]["samples_per_sec"] > 0,
              f"tools bench_serve {arch}: {serve['pipelined']}")
        print(f"tools bench_serve {arch} on {card}: " + json.dumps(serve))
        out[arch] = {"serve": serve}
        torch.cuda.empty_cache()
    for arch, expect in (
            ("gpt", {fa.KERNEL: 4 * N_LAYER, fa.KERNEL_MERGED: 4 * N_LAYER}),
            ("mamba", {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan})):
        label = f"tools profile_step {arch}"
        cfg, B, K, GA = profile_step.step_config(
            {"DEEPSENSE_BENCH_ARCH": arch}, on_card=True)
        check((B, K, GA) == (BATCH, 1, 1) and cfg.n_tokens == TOKENS
              and cfg.compute_dtype == "bfloat16",
              f"{label}: unexpected step {cfg}, {B}, {K}, {GA}")
        torch.cuda.empty_cache()
        prof = profile_step.run(cfg, B, K, GA, dispatches=PROFILE_STEPS,
                                device=DEVICE)
        profile_step.print_summary(prof, f"{label} on {card}: ")
        check(prof["launches_per_step"] == expect,
              f"{label}: launches a step {prof['launches_per_step']}, "
              f"expected exactly {expect}")
        check_port_rows(prof, expect, label)
        print(f"{label}: " + json.dumps(
            {k: prof[k] for k in prof if k != "top"}))
        out[arch]["profile"] = prof
        torch.cuda.empty_cache()
    out["attribution"] = attribution_legs()
    path = os.path.join(REPO, "build", "tools", "bench_matrix.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    check(bench_matrix.main(["--only", "gpt_serve", "--out", path]) == 0,
          "tools bench_matrix: main did not return 0")
    with open(path) as f:
        item = json.load(f)["items"]["gpt_serve"]
    check("error" not in item and item.get("arch") == "gpt"
          and "pipelined" in item, f"tools bench_matrix gpt_serve: {item}")
    out["bench_matrix_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_start
    print(f"tools on {card}: bench_matrix gpt_serve in "
          f"{out['bench_matrix_s']:.1f} s: " + json.dumps(item)
          + f"; phase {out['seconds']:.1f} s")
    return out


def radar_cube(rng, target):
    """A raw radar cube (antennas, samples, chirps), complex64: noise and
    one point target at ``target`` (angle, range, velocity bins), scaled
    by a factor of 0.1 to 1000 (each map is scaled by its own cube)."""
    import numpy as np
    n_rx, n_s, n_c = RADAR_CUBE
    noise = (rng.standard_normal(RADAR_CUBE, dtype=np.float32)
             + 1j * rng.standard_normal(RADAR_CUBE, dtype=np.float32))
    phase = 2 * np.pi * (
        target[0] * np.arange(n_rx)[:, None, None] / n_rx
        + target[1] * np.arange(n_s)[None, :, None] / n_s
        + target[2] * np.arange(n_c)[None, None, :] / n_c)
    cube = noise + 8.0 * np.exp(1j * phase)
    return (cube * 10.0 ** rng.uniform(-1, 3)).astype(np.complex64)


def radar_map_errors(paths):
    """(shapes and dtype right, max |err| of the range-angle map, of the
    range-velocity map) of one written cube's maps against the numpy
    chain: a worker of phase_preprocess's process pool."""
    import numpy as np
    from deepsense6g_tii_tpu_torch.data import features as F
    raw, ang, vel = paths
    cube = np.load(raw)
    ra = F.minmax_np(F.range_angle_map_np(cube))
    rv = F.minmax_np(F.range_velocity_map_np(cube))
    a, v = np.load(ang), np.load(vel)
    ok = (a.shape == ra.shape == v.shape == rv.shape == RADAR_CUBE[1:2] * 2
          and a.dtype == v.dtype == np.float32)
    return ok, float(np.abs(a - ra).max()), float(np.abs(v - rv).max())


def lidar_scene(rng):
    """The static scene (ground with a hole around the car's box, walls),
    ~18,500 points in scenario32's field of view, and the car's points."""
    import numpy as np
    (cx0, cx1), (cy0, cy1), (cz0, cz1) = CAR_BOX
    g = np.stack([rng.uniform(-60, -2, 3 * LIDAR_GROUND),
                  rng.uniform(-40, 5.5, 3 * LIDAR_GROUND),
                  rng.normal(-1.8, 0.02, 3 * LIDAR_GROUND)], 1)
    hole = ((g[:, 0] > cx0 - CAR_MARGIN) & (g[:, 0] < cx1 + CAR_MARGIN)
            & (g[:, 1] > cy0 - CAR_MARGIN) & (g[:, 1] < cy1 + CAR_MARGIN))
    ground = g[~hole][:LIDAR_GROUND]
    n = LIDAR_WALLS // 2
    walls = np.concatenate([
        np.stack([rng.uniform(-60, -2, n), np.full(n, -38.0),
                  rng.uniform(-1.8, 6.0, n)], 1),
        np.stack([np.full(LIDAR_WALLS - n, -58.0),
                  rng.uniform(-40, 5.5, LIDAR_WALLS - n),
                  rng.uniform(-1.8, 6.0, LIDAR_WALLS - n)], 1)])
    car = np.stack([rng.uniform(cx0, cx1, CAR_POINTS),
                    rng.uniform(cy0, cy1, CAR_POINTS),
                    rng.uniform(cz0, cz1, CAR_POINTS)], 1)
    return np.concatenate([ground, walls]), car


def nn_ties_ok(queries, points, got, want):
    """The queries whose neighbour ``got`` (f32 search) differs from
    ``want`` (f64), and how many of them do not tie: their two candidates'
    squared distances, in f64, differ by more than the f32 rounding of the
    inputs can move them (each coordinate by |x| 2^-24)."""
    import numpy as np
    diff = np.nonzero(got != want)[0]
    q = queries[diff]
    d_got = ((q - points[got[diff]]) ** 2).sum(1)
    d_want = ((q - points[want[diff]]) ** 2).sum(1)
    scale = np.abs(np.concatenate([queries, points])).max()
    tol = 8 * 2.0 ** -24 * scale * (np.sqrt(d_got) + np.sqrt(d_want)) \
        + 4 * 2.0 ** -24 * (d_got + d_want)
    return len(diff), int((np.abs(d_got - d_want) > tol).sum())


def write_raw_scenario(root, scenario, ids, rng):
    """The raw layout the index-CSV builder reads (file names only, for
    the sensors; 64 power lines for the beams) for frame ids ``ids``."""
    import numpy as np
    u1 = os.path.join(root, scenario, "unit1")
    u2 = os.path.join(root, scenario, "unit2")
    names = {"camera_data": "image_BS1_{}.jpg", "radar_data": "radar_{}.npy",
             "lidar_data": "lidar_{}.ply", "mmWave_data": "mmWave_power_{}.txt"}
    for sub, pattern in names.items():
        os.makedirs(os.path.join(u1, sub), exist_ok=True)
        for i in ids:
            path = os.path.join(u1, sub, pattern.format(i))
            with open(path, "w") as f:
                if sub == "mmWave_data":
                    # one width, so the text's max is the power's max
                    f.write("".join(f"{v:.6f}\n" for v in
                                    rng.uniform(0.1, 0.9, 64)))
    os.makedirs(os.path.join(u2, "GPS_data"), exist_ok=True)
    os.makedirs(os.path.join(u1, "GPS_data"), exist_ok=True)
    for i in ids:
        np.savetxt(os.path.join(u2, "GPS_data", f"gps_location_{i}.txt"),
                   [33.42, -111.93])


def phase_preprocess(card):
    """The offline data path on a synthetic raw scenario under
    build/preprocess, at real sizes:

    - radar: RADAR_CUBES raw cubes (4, 256, 250) complex64 through
      data/preprocess/radar.py's process_scenario on the card (64 a device
      call); every written map held to the numpy chain within
      RADAR_MAP_ATOL; cubes/s end to end, and one 64-cube radar_maps call
      by CUDA events;
    - LiDAR: a static scene of ~18,500 points, LIDAR_FRAMES jittered
      frames and a car in the last, through lidar_filter.process_scenario
      with the cuda, native and kdtree backends (frames/s each): the
      written clouds equal, the car kept whole, the static points dropped;
      the cuda search's neighbours against the k-d tree's on the filter's
      queries, every difference a tie at f32 rounding (checked in f64);
    - writers: csv_builder's root CSV of a raw layout (its rows and
      labels), and, on a demo tree, radar maps from raw cubes, filtered
      clouds (cuda), augment's camera, LiDAR and radar variants of the
      adaptation split, and its scenario CSVs;
    - training: the train CLI's main one epoch on that tree at the
      quickstart's debug geometry with --filtered 1 --augmentation 1: the
      dataset reads filtered and augmented files, and every train step
      launches DEBUG_SCAN_LAUNCHES scan forwards and backwards."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.data import dataset as ds
    from deepsense6g_tii_tpu_torch.data import features as F
    from deepsense6g_tii_tpu_torch.data.preprocess import augment, csv_builder
    from deepsense6g_tii_tpu_torch.data.preprocess import lidar_filter as LF
    from deepsense6g_tii_tpu_torch.data.preprocess import radar
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.tools import timing
    from deepsense6g_tii_tpu_torch.utils import ply
    from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root

    t_start = time.perf_counter()
    base = os.path.join(REPO, "build", "preprocess")
    shutil.rmtree(base, ignore_errors=True)
    rng = np.random.default_rng(0)
    out = {}

    # -- radar ----------------------------------------------------------------
    raw = os.path.join(base, "radar", "unit1", "radar_data")
    os.makedirs(raw)
    for i in range(RADAR_CUBES):
        target = (rng.integers(0, 4), rng.integers(0, 256),
                  rng.integers(0, 250))
        np.save(os.path.join(raw, f"{i}.npy"), radar_cube(rng, target))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = radar.process_scenario(raw, device=DEVICE)
    secs = time.perf_counter() - t0
    check(len(written) == RADAR_CUBES, f"preprocess radar: {len(written)} "
          f"of {RADAR_CUBES} cubes written")
    parent = os.path.dirname(raw)
    jobs = [(os.path.join(raw, f), os.path.join(parent, "radar_data_ang", f),
             os.path.join(parent, "radar_data_vel", f)) for f in written]
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as pool:
        errs = list(pool.map(radar_map_errors, jobs))
    check(all(ok for ok, _, _ in errs), "preprocess radar: a written map "
          "has the wrong shape or dtype")
    ra_err = max(e for _, e, _ in errs)
    rv_err = max(e for _, _, e in errs)
    check(max(ra_err, rv_err) <= RADAR_MAP_ATOL, f"preprocess radar: maps "
          f"off the numpy chain by {ra_err:.3g} (range-angle), {rv_err:.3g} "
          f"(range-velocity), bound {RADAR_MAP_ATOL}")
    cubes = torch.from_numpy(np.stack(
        [np.load(j[0]) for j in jobs[:64]])).to(DEVICE)
    call_ms = timing.time_ms(lambda: F.radar_maps(cubes), DEVICE, iters=5,
                             warmup=1)
    del cubes
    torch.cuda.empty_cache()
    out["radar"] = {"cubes": RADAR_CUBES, "seconds": secs,
                    "cubes_per_s": RADAR_CUBES / secs,
                    "max_abs_err_ra": ra_err, "max_abs_err_rv": rv_err,
                    "radar_maps_64_ms": call_ms}
    print(f"preprocess radar on {card}: " + json.dumps(out["radar"]))

    # -- LiDAR ----------------------------------------------------------------
    static, car = lidar_scene(rng)
    src = os.path.join(base, "lidar", "scenario32", "unit1", "lidar_data")
    os.makedirs(src)
    frames = []
    for i in range(LIDAR_FRAMES):
        f = static + rng.normal(0, LIDAR_JITTER, static.shape)
        if i == LIDAR_FRAMES - 1:
            f = np.concatenate([f, car])
        ply.write_points(os.path.join(src, f"{i}.ply"), f)
        frames.append(ply.read_points(os.path.join(src, f"{i}.ply")))
    check(all(len(f) >= LF.SCENARIO_MIN_POINTS["scenario32"]
              for f in frames), "preprocess lidar: a frame below min_points")
    lidar, clouds = {}, {}
    for backend in LF.BACKENDS:
        dst = src + f"_filtered_{backend}"
        t0 = time.perf_counter()
        bg = LF.process_scenario([src], [dst], "scenario32", backend=backend,
                                 device=DEVICE)
        secs = time.perf_counter() - t0
        clouds[backend] = {f: open(os.path.join(dst, f), "rb").read()
                           for f in sorted(os.listdir(dst))}
        lidar[backend] = {"seconds": secs, "frames_per_s": LIDAR_FRAMES / secs,
                          "background_points": len(bg)}
    check(clouds["cuda"] == clouds["native"] == clouds["kdtree"],
          "preprocess lidar: the backends wrote different clouds")
    last = ply.read_points(os.path.join(src + "_filtered_cuda",
                                        f"{LIDAR_FRAMES - 1}.ply"))
    (cx0, cx1), (cy0, cy1), (cz0, cz1) = CAR_BOX
    in_box = ((last[:, 0] >= cx0) & (last[:, 0] <= cx1) & (last[:, 1] >= cy0)
              & (last[:, 1] <= cy1) & (last[:, 2] >= cz0)
              & (last[:, 2] <= cz1)).sum()
    kept = [len(ply.read_points(os.path.join(src + "_filtered_cuda",
                                             f"{i}.ply")))
            for i in range(LIDAR_FRAMES)]
    check(in_box == CAR_POINTS and kept[-1] <= CAR_POINTS
          + 0.01 * len(static) and max(kept[:-1]) <= 0.01 * len(static),
          f"preprocess lidar: kept {kept} points a frame, {in_box} of the "
          f"car's {CAR_POINTS}")
    # the filter pass's queries: the last frame against the background
    bg = LF.build_background(frames, 0, "kdtree")
    want = LF.nearest_neighbors_kdtree(frames[-1], bg)
    nn_ms = {}
    for backend in LF.BACKENDS:
        t0 = time.perf_counter()
        got = LF._nn(frames[-1], bg, backend, DEVICE)
        nn_ms[backend] = 1e3 * (time.perf_counter() - t0)
        if backend == "cuda":
            n_diff, n_bad = nn_ties_ok(frames[-1], bg, got, want)
    check(n_bad == 0, f"preprocess lidar: {n_bad} of {n_diff} cuda "
          f"neighbours that differ from the k-d tree's are no ties")
    out["lidar"] = {"points": [len(f) for f in frames], "kept": kept,
                    "car_kept": int(in_box), "backends": lidar,
                    "nn_queries": len(frames[-1]), "nn_points": len(bg),
                    "nn_ms": nn_ms, "nn_differ": n_diff, "nn_not_ties": n_bad}
    print(f"preprocess lidar on {card}: " + json.dumps(out["lidar"]))

    # -- the writers ----------------------------------------------------------
    raw_root = os.path.join(base, "raw")
    write_raw_scenario(raw_root, "scenario32", range(60), rng)
    n_rows = csv_builder.create_root_csv(raw_root, "root.csv", 5, 1,
                                         ["scenario32"])
    with open(os.path.join(raw_root, "root.csv"), newline="") as f:
        rows = list(csv.reader(f))
    # a row for every beam id but the last whose GPS ids (12 and 6 back)
    # exist: ids 12..58
    check(rows[0] == csv_builder.create_row_head(5, 1)
          and len(rows) - 1 == n_rows == 60 - 1 - 12,
          f"preprocess csv_builder: {n_rows} rows, header {rows[0]}")
    for r in rows[1:]:
        power = np.loadtxt(os.path.join(raw_root, r[-2]))
        check(r[-1] == str(int(power.argmax()) + 1),
              f"preprocess csv_builder: label {r[-1]} of {r[-2]}")

    tree = os.path.join(base, "tree")
    make_demo_root(tree, n_train=3, n_adapt=2, n_test=2, seq_len=2)
    splits = ("Multi_Modal", "Adaptation_dataset_multi_modal")
    n_cubes = 0
    for split in splits:
        for scen in ("scenario31", "scenario32"):
            unit = os.path.join(tree, split, scen, "unit1")
            raw_dir = os.path.join(unit, "radar_data")
            os.makedirs(raw_dir)
            for f in sorted(os.listdir(os.path.join(unit, "radar_data_ang"))):
                np.save(os.path.join(raw_dir, f), radar_cube(
                    rng, (1, rng.integers(0, 256), rng.integers(0, 250))))
            n_cubes += len(radar.process_scenario(raw_dir, device=DEVICE))
            LF.process_scenario([os.path.join(unit, "lidar_data")],
                                [os.path.join(unit, "lidar_data_filtered")],
                                scen, backend="cuda", min_points=0,
                                device=DEVICE)
    adapt = os.path.join(tree, splits[1])
    n_aug = {"camera": 0, "lidar": 0, "radar": 0}
    for scen in ("scenario31", "scenario32"):
        unit = os.path.join(adapt, scen, "unit1")
        n_aug["camera"] += augment.augment_image_dir(
            os.path.join(unit, "camera_data"),
            os.path.join(unit, "camera_data_aug"))
        n_aug["lidar"] += augment.augment_lidar_dir(
            os.path.join(unit, "lidar_data"),
            os.path.join(unit, "lidar_data_aug"))
        n_aug["radar"] += augment.augment_radar_dirs(
            os.path.join(unit, "radar_data_ang"),
            os.path.join(unit, "radar_data_vel"))
    per_scen = {}
    for i in (1, 2, 3):
        per_scen[f"scenario3{i}"] = csv_builder.create_scenario_csv(
            os.path.join(adapt, "ml_challenge_data_adaptation_multi_modal.csv"),
            os.path.join(adapt, f"scenario3{i}"), f"scenario3{i}")
    check(min(n_aug.values()) > 0 and per_scen["scenario31"] > 0
          and per_scen["scenario32"] > 0, f"preprocess writers: {n_aug}, "
          f"{per_scen}")
    out["writers"] = {"root_csv_rows": n_rows, "tree_radar_cubes": n_cubes,
                      "augmented": n_aug, "scenario_csv_rows": per_scen}
    print("preprocess writers: " + json.dumps(out["writers"]))

    # -- training on the tree -------------------------------------------------
    seen = {"lidar_data_filtered/": 0, "lidar_data_aug/": 0,
            "camera_data_aug/": 0, "radar_data_ang_aug/": 0}
    real = {m: getattr(ds.BeamDataset, m)
            for m in ("_camera_path", "_lidar_path", "_radar_path")}

    def seeing(method):
        def path(self, t, index):
            p = method(self, t, index)
            for k in seen:
                seen[k] += k in p
            return p
        return path

    counts = []
    logdir = os.path.join(base, "log")
    argv = ["--data_root", tree, "--logdir", logdir, "--device", DEVICE,
            "--seq_len", "2", "--batch_size", "4", "--filtered", "1",
            "--augmentation", "1", "--scheduler", "0", "--num_workers", "2",
            "--compute_dtype", "bfloat16", "--input_resolution", "64",
            "--vert_anchors", "2", "--horz_anchors", "2", "--n_layer", "1",
            "--backbone_blocks", "1,1,1,1", "--epochs", "1"]
    for m, f in real.items():
        setattr(ds.BeamDataset, m, seeing(f))
    try:
        secs = cli_run(argv, counts, "preprocess")
    finally:
        for m, f in real.items():
            setattr(ds.BeamDataset, m, f)
    expect = {ss.KERNEL: DEBUG_SCAN_LAUNCHES, ss.KERNEL_BWD:
              DEBUG_SCAN_LAUNCHES}
    check(counts and all(c == expect for c in counts),
          f"preprocess train: launches a step {counts}, expected {expect}")
    check(min(seen.values()) > 0, f"preprocess train: files read {seen}")
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        losses = [json.loads(ln)["value"] for ln in f
                  if json.loads(ln)["tag"] == "curr_loss_train"]
    check(losses and all(math.isfinite(v) for v in losses),
          f"preprocess train: losses {losses}")
    out["train"] = {"seconds": secs, "steps": len(counts),
                    "launches_per_step": counts[0], "files_read": seen,
                    "loss": losses}
    out["seconds"] = time.perf_counter() - t_start
    print(f"preprocess train on {card}: " + json.dumps(out["train"])
          + f"; phase {out['seconds']:.1f} s")
    return out


def phase_quickstart(card):
    """The zero-data entry point: python -m deepsense6g_tii_tpu_torch.
    examples.quickstart through its main (--device cuda, 2 epochs) in a
    work directory under build/: every artifact exists, beam_pred.csv has
    one row of beams in 1..64 per test sample, the working directory is
    restored, and every train step launches DEBUG_SCAN_LAUNCHES scan
    forwards and backwards."""
    import shutil
    from deepsense6g_tii_tpu_torch.examples import quickstart
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    work = os.path.join(REPO, "build", "quickstart")
    shutil.rmtree(work, ignore_errors=True)
    counts, cwd = [], os.getcwd()
    t0 = time.perf_counter()
    with counted_train_steps(counts):
        rc = quickstart.main(["--device", DEVICE, "--workdir", work])
    secs = time.perf_counter() - t0
    check(rc == 0 and os.getcwd() == cwd, f"quickstart: main returned {rc}, "
          f"working directory {os.getcwd()}")
    logdir = os.path.join(work, "log", "quickstart")
    missing = [f for f in quickstart.ARTIFACTS
               if not os.path.exists(os.path.join(logdir, f))]
    check(not missing, f"quickstart: missing {missing}")
    with open(os.path.join(work, "beam_pred.csv"), newline="") as f:
        rows = list(csv.reader(f))[1:]
    n_test = 2 * 2                 # 2 test samples in each of 2 scenarios
    check(len(rows) == n_test and all(1 <= int(b) <= 64 for r in rows
                                      for b in r[1:]),
          f"quickstart: beam_pred.csv rows {rows}")
    expect = {ss.KERNEL: DEBUG_SCAN_LAUNCHES, ss.KERNEL_BWD:
              DEBUG_SCAN_LAUNCHES}
    check(counts and all(c == expect for c in counts),
          f"quickstart: launches a step {counts}, expected {expect}")
    out = {"seconds": secs, "steps": len(counts),
           "launches_per_step": counts[0], "test_rows": len(rows)}
    print(f"quickstart on {card}: " + json.dumps(out))
    return out


def opcheck_ops():
    """torch.library.opcheck of the serving kernels' custom ops on the
    card at one small shape each (bf16, as they serve): the schema, the
    fake implementation's shapes, dtypes and strides against the kernel's
    real outputs, and the op under AOT dispatch with dynamic shapes.  The
    kernels' launches here are not counted on any path."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rnd = lambda *s: torch.randn(*s, device=DEVICE,  # noqa: E731
                                 generator=gen)
    q, k, v = (rnd(2, HEADS, 70, 64).bfloat16() for _ in range(3))
    results = {"flash": torch.library.opcheck(
        fa.flash_fwd_op, (q, k, v, 0.125, 0.0, 0, fa.DEFAULT_BLOCK))}
    d = 64
    u, x_dbl = rnd(2, 130, d).bfloat16(), rnd(2, 130, 2 + 2 * D_STATE)
    dt = torch.nn.functional.softplus(rnd(2, 130, d))
    A = -torch.arange(1, D_STATE + 1, dtype=torch.float32,
                      device=DEVICE).expand(2, d, D_STATE).contiguous()
    x_dbl = x_dbl.bfloat16()
    B, C = x_dbl[..., 2:2 + D_STATE], x_dbl[..., 2 + D_STATE:]
    for reverse in (False, True):
        results[f"scan reverse={reverse}"] = torch.library.opcheck(
            ss.scan_fwd_op, (u, dt, A, B, C, reverse))
    for name, r in results.items():
        check(set(r.values()) == {"SUCCESS"}, f"export: opcheck {name}: {r}")
    return {name: sorted(r) for name, r in results.items()}


def export_graph_checks(label, ops, kernel, n):
    """The exported serving graph's ops (``ops``: serve.graph_ops): ``n``
    nodes of ``kernel``'s custom op, none of the other serving kernel's,
    and none of the ops that the plain versions trace to (the attention's
    matmuls and softmax, the serving softmax alone staying; the doubling
    scan's addcmul)."""
    from deepsense6g_tii_tpu_torch import serve
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    op = serve.KERNEL_OPS[kernel]
    other = [v for k, v in serve.KERNEL_OPS.items() if k != kernel]
    check(ops.get(op, 0) == n and not any(o in ops for o in other),
          f"export {label}: {ops.get(op, 0)} nodes of {op} (expected {n}), "
          f"{[(o, ops[o]) for o in other if o in ops]} of the other kernel")
    if kernel == fa.KERNEL:
        check("aten.matmul.default" not in ops
              and ops.get("aten.softmax.int") == 1,
              f"export {label}: the plain attention's ops in the graph: "
              f"matmul {ops.get('aten.matmul.default')}, softmax "
              f"{ops.get('aten.softmax.int')}")
    else:
        check("aten.addcmul.default" not in ops,
              f"export {label}: the plain scan's addcmul in the graph")


def wait_for(path, what, alive, timeout=900):
    """Polls for ``path``, which the other process of the export phase
    writes; fails after ``timeout`` seconds or once ``alive()``, whether
    that process still runs, is false."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        check(time.perf_counter() - t0 < timeout and alive(),
              f"export: no {what} after {time.perf_counter() - t0:.0f} s")
        time.sleep(0.05)


def serve_exported(folder, device):
    """The fresh process of the export phase (``--serve-exported``): serves
    the artifacts of EXPORT_MODELS in ``folder`` by ExportedPredictor
    alone, with no checkpoint and no BeamFuser built, on their seeded
    requests, each loaded as soon as the phase has written it.  Writes
    ``loaded`` once both are loaded and checked, and times them only after
    the phase writes ``go`` (its own timings done): what it served, the
    launches of one forward, the loaded graph's ops, the load time and the
    p50/p90 of a request of 1 and of BATCH rows."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch import serve
    from deepsense6g_tii_tpu_torch.models import fuser
    from deepsense6g_tii_tpu_torch.ops import _build

    def no_model(*a, **k):
        raise AssertionError("the artifact's process built a BeamFuser")

    fuser.BeamFuser.__init__ = no_model
    phase_alive = lambda: os.getppid() != 1  # noqa: E731
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()       # while the phase exports
    out, preds = {}, {}
    for name in EXPORT_MODELS:
        path = os.path.join(folder, f"{name}.pt2")
        wait_for(path, f"{name}.pt2", phase_alive)
        req = np.load(os.path.join(folder, f"{name}.npz"))
        x = [req[k] for k in ("image", "lidar", "radar", "gps")]
        t0 = time.perf_counter()
        pred = serve.ExportedPredictor(path, device=device)
        load_s = time.perf_counter() - t0
        pred.predict(*x)                                       # warm
        sync()
        _build.reset_launch_counts()
        idx, conf = pred.predict(*x)
        sync()
        leg = {"load_s": load_s, "batch": pred.batch,
               "launches": dict(_build.KERNEL_LAUNCHES),
               "ops": serve.graph_ops(pred.program)}
        ragged = pred.predict(*(a[:EXPORT_RAGGED] for a in x))
        try:
            pred.predict(*(np.concatenate([a, a[:1]]) for a in x))
            leg["oversize"] = None
        except ValueError as e:
            leg["oversize"] = str(e)
        np.savez(os.path.join(folder, f"{name}.served.npz"), idx=idx,
                 conf=conf, ragged_idx=ragged[0], ragged_conf=ragged[1])
        out[name], preds[name] = leg, (pred, x)
    open(os.path.join(folder, "loaded"), "w").close()
    wait_for(os.path.join(folder, "go"), "go", phase_alive)
    for name, (pred, x) in preds.items():
        for rows in (1, pred.batch):
            times = []
            for _ in range(EXPORT_ITERS):
                t0 = time.perf_counter()
                pred.predict(*(a[:rows] for a in x))
                times.append((time.perf_counter() - t0) * 1e3)
            out[name][f"b{rows}"] = {
                "p50_ms": float(np.percentile(times, 50)),
                "p90_ms": float(np.percentile(times, 90))}
    with open(os.path.join(folder, "served.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_export(card):
    """The serving artifact: both full-width models (bf16, seed-0 weights,
    962 tokens) exported by Predictor.export_artifact at batch 8 under
    build/export, each graph holding one custom-op node per kernel call
    (32 flash, 67 scan) and none of the plain versions' ops; a fresh
    process (this script with --serve-exported, started first so that its
    start-up and each load overlap the next export) loads each artifact by
    ExportedPredictor with no model and no checkpoint and serves the same
    seeded requests: the launches of a forward, top-k indices equal to the
    live Predictor's and confidences within EXPORT_CONF_ATOL (the largest
    error printed), a ragged request padded, an oversize one refused.
    Prints export_s, save_s, load_s, artifact_mb and the exported against
    the live p50/p90 at batch 1 and 8 (the artifact pads a request of 1 to
    its 8; the live predictor serves it at its bucket of 1 and, padded, at
    8), the live timings first and the exported ones after, with nothing
    else running.  The custom ops pass torch.library.opcheck on the card
    first."""
    import shutil
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch import serve
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    t_start = time.perf_counter()
    base = os.path.join(REPO, "build", "export")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    log_path = os.path.join(base, "serving.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--serve-exported", base, DEVICE],
                                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)

    def child_log():
        with open(log_path) as f:
            return f.read()[-4000:]

    def child_alive():
        check(proc.poll() is None,
              f"export: the serving process ended:\n{child_log()}")
        return True

    try:
        result, live, preds = {"opcheck": opcheck_ops()}, {}, {}
        models = {"gpt": (serve.gpt_transfuser_config(), fa.KERNEL,
                          4 * N_LAYER),
                  "mamba": (serve.mambafuser_config(), ss.KERNEL,
                            sum(SCAN_LAUNCHES.values()))}
        for name in EXPORT_MODELS:
            cfg, kernel, n = models[name]
            model = BeamFuser(cfg, device=DEVICE,
                              generator=torch.Generator().manual_seed(0))
            pred = serve.Predictor(model, cfg, batch_buckets=(1, BATCH),
                                   device=DEVICE)
            b = make_synth_batch(cfg, BATCH, seed=1, with_labels=False)
            x = [b[k] for k in ("image", "lidar", "radar", "gps")]
            np.savez(os.path.join(base, f"{name}.npz"), **dict(zip(
                ("image", "lidar", "radar", "gps"), x)))
            path = os.path.join(base, f"{name}.pt2")
            t0 = time.perf_counter()
            program = pred.export_program(BATCH)
            export_s = time.perf_counter() - t0
            part = os.path.join(base, f"{name}.part.pt2")
            torch.export.save(program, part)
            os.replace(part, path)
            save_s = time.perf_counter() - t0 - export_s
            ops = serve.graph_ops(program)
            export_graph_checks(name, ops, kernel, n)
            del program
            live[name] = {
                "export_s": export_s, "save_s": save_s,
                "artifact_mb": os.path.getsize(path) / 1e6,
                "graph_nodes": sum(ops.values()),
                "assert_nodes": ops.get(
                    "aten._assert_tensor_metadata.default", 0),
                "out": pred.predict(*x),
                "ragged": pred.predict(*(a[:EXPORT_RAGGED] for a in x))}
            preds[name] = (pred, serve.Predictor(
                model, cfg, batch_buckets=(BATCH,), device=DEVICE))
            del model
        wait_for(os.path.join(base, "loaded"), "loaded artifacts",
                 child_alive)
        for name, (pred, padded) in preds.items():
            live[name]["live"] = {
                f"b{r}": pred.latency_benchmark(r, EXPORT_ITERS)
                for r in (1, BATCH)}
            live[name]["live_b1_padded"] = padded.latency_benchmark(
                1, EXPORT_ITERS)
        del preds, pred, padded
        torch.cuda.empty_cache()
        open(os.path.join(base, "go"), "w").close()
        t0 = time.perf_counter()
        proc.wait(timeout=600)
        tail_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0,
          f"export: the serving process failed:\n{child_log()}")
    with open(os.path.join(base, "served.json")) as f:
        served = json.load(f)
    for name in EXPORT_MODELS:
        cfg, kernel, n = models[name]
        leg, lv = served[name], live[name]
        got = np.load(os.path.join(base, f"{name}.served.npz"))
        check(leg["batch"] == BATCH, f"export {name}: batch {leg['batch']}")
        check(leg["launches"] == {kernel: n},
              f"export {name}: launches of an exported forward "
              f"{leg['launches']}, expected {{{kernel!r}: {n}}}")
        export_graph_checks(f"{name} (loaded)", leg["ops"], kernel, n)
        errs = {}
        for key, (idx, conf) in (("b8", lv["out"]),
                                 ("ragged", lv["ragged"])):
            pre = "ragged_" if key == "ragged" else ""
            check(np.array_equal(got[pre + "idx"], idx),
                  f"export {name} {key}: top-k {got[pre + 'idx'].tolist()} "
                  f"differ from the live Predictor's {idx.tolist()}")
            errs[key] = float(np.abs(got[pre + "conf"] - conf).max())
            check(errs[key] <= EXPORT_CONF_ATOL,
                  f"export {name} {key}: confidences differ from the live "
                  f"Predictor's by {errs[key]:.3g}")
        check(leg["oversize"] is not None and "exceeds" in leg["oversize"],
              f"export {name}: an oversize request was served")
        result[name] = {
            **{k: lv[k] for k in ("export_s", "save_s", "artifact_mb",
                                  "graph_nodes", "assert_nodes")},
            "load_s": leg["load_s"], "launches": leg["launches"],
            "custom_op_nodes": leg["ops"][serve.KERNEL_OPS[kernel]],
            "conf_max_abs_err": errs,
            "bit_equal": all(v == 0.0 for v in errs.values()),
            "exported": {k: leg[k] for k in ("b1", f"b{BATCH}")},
            "live": lv["live"], "live_b1_padded": lv["live_b1_padded"]}
        print(f"export {name}: conf max abs err {errs} (bit equal: "
              f"{result[name]['bit_equal']})")
    result["exported_timing_s"] = tail_s
    result["seconds"] = time.perf_counter() - t_start
    print(f"export on {card}: " + json.dumps(result))
    return result


def phase_kernels_30to5(sfu_rate, tokens, scan_shapes):
    """Kernels #1, #2, #6 and #9 at the 30-to-5 path's shapes (B = 8, bf16;
    T = ``tokens`` at each head dim, dropout 0 and 0.1; the scan at each
    of ``scan_shapes``), each held against its plain version as the kernel
    phases hold it (the scan's B and C column slices of x_dbl, as the model
    gives them), in f32 and bf16, and timed in bf16 by CUDA events
    (time_ms: the profiler on the card's machine drops launches now and
    then) with the plain version, the one PyTorch call where there is one,
    and the bound.  Returns the bf16 rows by kernel."""
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    bh = BATCH * HEADS
    rows = {"fwd": [], "bwd": [], "scan_fwd": {}, "scan_bwd": {}}

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")

    for dtype, d in [(dt, d) for dt in (torch.float32, torch.bfloat16)
                     for d in HEAD_DIMS]:
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(BATCH, HEADS, tokens, d, device=DEVICE,
                                   generator=gen).to(dtype)
                       for _ in range(4))
        sm, n_el = d ** -0.5, bh * tokens * d
        for p in (0.0, DROP_P):
            seed = 4321 if p else None
            kw = dict(sm_scale=sm, dropout_p=p, seed=seed)
            o, lse = fa.flash_mha_fwd(q, k, v, **kw)
            dq = fa.flash_mha_bwd(q, k, v, o, lse, do, mode="merged", **kw)
            split = fa.flash_mha_bwd(q, k, v, o, lse, do, mode="split", **kw)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_mha_reference(q, k, v, sm, p, seed or 0)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_l = (lse - rlse).abs().max().item()
            tol_o, tol_l = TOL[dname]
            if dname == "bfloat16":
                tol_o = max(tol_o, 2 * bf16_ulp(ro.float().abs().max()))
            check(err_o <= tol_o and err_l <= tol_l,
                  f"flash kernel {dname} T={tokens} d={d} p={p}: max |O "
                  f"err| {err_o:.3g} (tol {tol_o:.3g}), max |lse err| "
                  f"{err_l:.3g} (tol {tol_l})")
            ref = fa.flash_mha_bwd_reference(q, k, v, o, lse, do, sm, p,
                                             (seed or 0) & 0xFFFFFFFF)
            scale = [r.float().abs().max().item() for r in ref]
            err, err_split = ([(g.float() - r.float()).abs().max().item()
                               for g, r in zip(got, ref)]
                              for got in (dq, split))
            for what, errs in (("merged", err), ("split", err_split)):
                check(all(e <= BWD_RTOL[dname] * s_
                          for e, s_ in zip(errs, scale)),
                      f"flash backward {what} {dname} T={tokens} d={d} "
                      f"p={p}: max |d(q,k,v) err| {errs} of max |plain| "
                      f"{scale}")
            del dq, split, ref, ro, rlse
            if dname == "float32":
                print(f"flash f32 T={tokens} d={d} p={p}: O err "
                      f"{err_o:.3g}, lse err {err_l:.3g}, d(q,k,v) err "
                      f"{err}, split {err_split} of {scale}")
                continue
            fwd = dict(d=d, p=p, max_abs_err=err_o, lse_err=err_l,
                       ms=time_ms(lambda: fa.flash_mha_fwd(q, k, v, **kw)),
                       plain_ms=time_ms(lambda: fa.flash_mha_reference(
                           q, k, v, sm, p, seed or 0), iters=5, warmup=1),
                       library_ms=None if p else time_ms(
                           lambda: F.scaled_dot_product_attention(
                               q, k, v, scale=sm)),
                       exp_sfu_ms=exp_sfu_ms(bh, tokens, sfu_rate),
                       **bound(4.0 * bh * tokens * tokens * d,
                               4 * n_el * 2 + bh * tokens * 4))
            bwd = dict(d=d, p=p, max_abs_err=max(err), max_abs=scale,
                       ms=time_ms(lambda: fa.flash_mha_bwd(
                           q, k, v, o, lse, do, mode="merged", **kw)),
                       plain_ms=time_ms(lambda: fa.flash_mha_bwd_reference(
                           q, k, v, o, lse, do, sm, p,
                           (seed or 0) & 0xFFFFFFFF), iters=3, warmup=1),
                       library_ms=None if p else sdpa_backward_ms(
                           F, q, k, v, do, sm, timer=time_ms),
                       exp_sfu_ms=exp_sfu_ms(bh, tokens, sfu_rate),
                       **bound(10.0 * bh * tokens * tokens * d,
                               8 * n_el * 2 + 2 * bh * tokens * 4))
            # the split pair: the whole call and each kernel alone, with
            # its err and bound (dq: S, dP, dS k; dk/dv: S, dP, dv, dk)
            bwd.update(split_err=err_split,
                       split_ms=time_ms(lambda: fa.flash_mha_bwd(
                           q, k, v, o, lse, do, mode="split", **kw)),
                       **split_kernel_ms(q, k, v, o, lse, do, kw))
            for name, ops, els in (("dq", 6.0, 6), ("dkv", 8.0, 7)):
                b_ = bound(ops * bh * tokens * tokens * d,
                           els * n_el * 2 + 2 * bh * tokens * 4)
                bwd[f"{name}_bound_ms"] = b_["bound_ms"]
                bwd[f"{name}_bound_by"] = b_["bound_by"]
            rows["fwd"].append(fwd)
            rows["bwd"].append(bwd)
            print(f"kernel flash_attention_fwd T={tokens} " + json.dumps(fwd))
            print(f"kernel flash_attention_bwd T={tokens} " + json.dumps(bwd))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    for dtype, (L, d) in [(dt, sh) for dt in (torch.float32, torch.bfloat16)
                          for sh in scan_shapes]:
        dname = str(dtype).split(".")[1]
        u, dt, A, B, C, dy = scan_inputs(gen, dtype, L, d)
        y, h = ss.selective_scan_fwd(u, dt, A, B, C)
        _, _, h_in = ss._launch_fwd(u, dt, A, B, C, False, True)
        got = ss.selective_scan_bwd(u, dt, A, B, C, dy, h_in)
        torch.cuda.synchronize()
        ry, rh = ss.selective_scan_reference(u, dt, A, B, C, False)
        ref_h = ss.chunk_states_reference(u, dt, A, B, C, False)
        err_y = (y - ry).abs().max().item()
        errs = {"y": err_y / ry.abs().max().item(),
                "h_out": (h - rh).abs().max().item() / rh.abs().max().item(),
                "h_in": ((h_in - ref_h).abs().max().item()
                         / max(ref_h.abs().max().item(), 1e-30))}
        check(all(e <= SCAN_RTOL for e in errs.values()),
              f"scan kernel {dname} L={L} d={d}: relative errors {errs} "
              f"(rtol {SCAN_RTOL})")
        ref = ss.selective_scan_bwd_reference(u, dt, A, B, C, dy, False)
        rel, err = {}, {}
        for name, g, r in zip(SCAN_GRADS, got, ref):
            err[name] = (g.float() - r.float()).abs().max().item()
            rel[name] = err[name] / r.float().abs().max().item()
            tol = (SCAN_BWD_BF16_RTOL if dname == "bfloat16" and name in (
                "du", "dB", "dC") else SCAN_BWD_RTOL)
            check(rel[name] <= tol, f"scan backward {dname} L={L} d={d}: "
                  f"{name} off by {rel[name]:.3g} of its largest value "
                  f"(rtol {tol})")
        del got, ref, ry, rh, ref_h
        if dname == "float32":
            print(f"scan f32 L={L} d={d}: relative errors {errs}, "
                  f"backward {rel}")
            del u, dt, A, B, C, dy, y, h, h_in
            continue
        nbytes, flops, exps = scan_fwd_work(L, d, u.element_size())
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float32"]
        kernel = lambda: ss.selective_scan_fwd(u, dt, A, B, C)  # noqa: E731
        fwd = dict(L=L, d=d, rel_err=errs, max_abs_err=err_y,
                   ms=time_ms(kernel),
                   chunks_per_group=ss.fwd_chunks_per_group(BATCH, L, d),
                   kernels_per_call=kernels_per_call(kernel),
                   plain_ms=time_ms(lambda: ss.selective_scan_reference(
                       u, dt, A, B, C, False), iters=3, warmup=1),
                   bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops,
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   exp_sfu_ms=1e3 * exps / sfu_rate)
        wrapper = lambda: ss.selective_scan_bwd(  # noqa: E731
            u, dt, A, B, C, dy, h_in)
        bwd = dict(L=L, d=d, rel_err=rel, ms=time_ms(wrapper),
                   kernels_per_call=kernels_per_call(wrapper),
                   plain_ms=time_ms(lambda: ss.selective_scan_bwd_reference(
                       u, dt, A, B, C, dy, False), iters=3, warmup=1),
                   **scan_bwd_work(ss, u, A, h_in, sfu_rate))
        bwd["max_abs_err"] = max(err.values())
        rows["scan_fwd"][(L, d)] = fwd
        rows["scan_bwd"][(L, d)] = bwd
        print(f"kernel selective_scan_fwd L={L} " + json.dumps(fwd))
        print(f"kernel selective_scan_bwd L={L} " + json.dumps(bwd))
        del u, dt, A, B, C, dy, y, h, h_in
        torch.cuda.empty_cache()
    print(f"kernels at the 30-to-5 shapes: "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


def phase_train_split(card, merged):
    """The bf16 GPT TransFuser training leg through the split backward
    (DEEPSENSE_FLASH_BWD=split): SPLIT_STEPS steps of phase_train from the
    same seed-0 weights, batch and generators as the merged leg (``merged``,
    phase_train's result).  Every step launches exactly 32 flash forwards,
    32 dq and 32 dk/dv kernels and no merged backward (the counts at 0 just
    before each step, read just after); each step's loss is finite (as
    phase_train checks) and off the merged leg's at the same step by at
    most TRAIN_SPLIT_FALL_RTOL of the merged leg's fall since its first
    step (so the first losses are equal).  Prints its step p50 beside the
    merged leg's; returns phase_train's result."""
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.serve import gpt_transfuser_config
    n = 4 * N_LAYER
    os.environ["DEEPSENSE_FLASH_BWD"] = "split"
    try:
        result, _, _ = phase_train(
            card, "train split", gpt_transfuser_config(),
            {fa.KERNEL: n, fa.KERNEL_DQ: n, fa.KERNEL_DKV: n},
            steps=SPLIT_STEPS, falls=False)
    finally:
        del os.environ["DEEPSENSE_FLASH_BWD"]
    ref = merged["loss"][:SPLIT_STEPS]
    gaps = [abs(a - b) for a, b in zip(result["loss"], ref)]
    falls = [abs(ref[0] - b) for b in ref]
    print(f"train split against merged on {card}: " + json.dumps(
        {"step_ms_p50": {"split": result["step_ms_p50"],
                         "merged": merged["step_ms_p50"]},
         "loss": {"split": result["loss"], "merged": ref},
         "loss_rel_gap": [g / abs(b) for g, b in zip(gaps, ref)],
         "gap_of_fall": [g / f if f else None for g, f in zip(gaps, falls)],
         "launches_per_step": result["launches_per_step"]}))
    check(all(g <= TRAIN_SPLIT_FALL_RTOL * f for g, f in zip(gaps, falls)),
          f"train split: losses {result['loss']} off the merged leg's "
          f"{ref} by {gaps}, beyond {TRAIN_SPLIT_FALL_RTOL} of the merged "
          f"leg's fall {falls} (the first step's must be equal)")
    return result


def phase_train_f32(init, batch):
    """One f32 training step through the flash kernels, one through the
    plain attention path and one through the split backward, from the same
    weights with the same generators, at dropouts 0.1 and 0.  All three
    draw the same attention masks from the same seeds and the same
    elementwise masks, so they differ by rounding alone.

    - Kernels against plain: the forwards agree to rounding (the loss to
      TRAIN_LOSS_RTOL, the new BatchNorm statistics to TRAIN_STATS_RTOL of
      each tensor's largest value).  The gradients of this random-weight
      model amplify those last-bit differences of the forward (train-mode
      BatchNorm's backward and the ReLU kinks), so they are held as a whole
      to TRAIN_GRAD_RTOL of their norm and each tensor to
      TRAIN_GRAD_TENSOR_RTOL of its largest |g|.  Beside that, each
      stage's first attention call is taken at its own inputs (q, k, v,
      dO, the seed) and the kernels' O, dq, dk and dv are held to
      ATTN_F64_RTOL of an f64 autograd reference, as accurate as the plain
      f32 path (printed beside).
    - Merged against split backward: the forward is the same computation,
      only dq's sum runs in another order, so the gradients are held to
      TRAIN_SPLIT_RTOL of their norm.
    - The key biases' gradient is 0 in exact arithmetic (softmax ignores a
      shift shared by all keys): it is held to 1e-6 of the largest |g|."""
    import os
    import torch
    from deepsense6g_tii_tpu_torch.models import fusion
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.serve import gpt_transfuser_config
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step

    n = 4 * N_LAYER
    runs = {"flash": ({fa.KERNEL: n, fa.KERNEL_MERGED: n}, "merged"),
            "plain": ({}, "merged"),
            "split": ({fa.KERNEL: n, fa.KERNEL_DQ: n, fa.KERNEL_DKV: n},
                      "split")}
    for p in (DROP_P, 0.0):
        res, calls = {}, []
        for path, (want, mode) in runs.items():
            cfg = gpt_transfuser_config(
                compute_dtype="float32", use_flash_attention=path != "plain",
                embd_pdrop=p, attn_pdrop=p, resid_pdrop=p)
            model = BeamFuser(cfg, device=DEVICE)
            model.load_state_dict(init, strict=True)
            step = make_train_step(model, cfg, create_train_state(model),
                                   rng_seed=7, device=DEVICE)
            os.environ["DEEPSENSE_FLASH_BWD"] = mode
            if path == "flash":
                fusion.flash_mha = recording(fa.flash_mha, calls)
            _build.reset_launch_counts()
            try:
                loss = step(batch, TRAIN_LR)["loss"].item()
            finally:
                del os.environ["DEEPSENSE_FLASH_BWD"]
                fusion.flash_mha = fa.flash_mha
            counts = dict(_build.KERNEL_LAUNCHES)
            check(counts == want, f"f32 train {path} p={p}: launches "
                  f"{counts}, expected {want}")
            res[path] = (loss,
                         {k: q.grad.detach().clone()
                          for k, q in model.named_parameters()},
                         {k: b.clone() for k, b in model.named_buffers()})
            del model, step
            torch.cuda.empty_cache()
        gap, split = (f32_gaps(res["flash"], res[other])
                      for other in ("plain", "split"))
        attn = [attention_vs_f64(fa, c) for c in calls[::N_LAYER]]
        calls.clear()
        print(f"f32 train step, dropout {p}: " + json.dumps(
            {"flash_vs_plain": gap, "merged_vs_split": split,
             "attention_vs_f64": attn}))
        check(gap["loss_rel"] <= TRAIN_LOSS_RTOL, f"f32 train p={p}: loss "
              f"{gap['loss']} (flash, plain)")
        check(gap["stats_worst"] <= TRAIN_STATS_RTOL, f"f32 train p={p}: "
              f"BatchNorm statistics off by {gap['stats_worst']:.3g}")
        check(gap["grad_global_rel"] <= TRAIN_GRAD_RTOL
              and gap["grad_worst"] <= TRAIN_GRAD_TENSOR_RTOL,
              f"f32 train p={p}: gradients off by {gap['grad_global_rel']:.3g}"
              f" of their norm, {gap['grad_worst_name']} by "
              f"{gap['grad_worst']:.3g} of its largest |g|")
        check(split["grad_global_rel"] <= TRAIN_SPLIT_RTOL
              and split["loss_rel"] <= TRAIN_LOSS_RTOL, f"f32 train p={p}: "
              f"merged and "
              f"split backward differ by {split['grad_global_rel']:.3g}")
        check(max(gap["exact_zero"], split["exact_zero"]) <= 1e-6,
              f"f32 train p={p}: key-bias gradient {gap['exact_zero']:.3g} "
              f"of the largest |g|")
        for a in attn:
            check(max(a["kernels"]) <= ATTN_F64_RTOL, f"f32 train p={p}: "
                  f"attention kernels at the model's inputs against f64: "
                  f"{a}")


def recording(flash_mha, calls):
    """``flash_mha`` that keeps each call's q, k, v, arguments and output
    gradient, for attention_vs_f64."""
    def record(q, k, v, **kw):
        o = flash_mha(q, k, v, **kw)
        call = dict(q=q.detach(), k=k.detach(), v=v.detach(), kw=kw)
        o.register_hook(lambda g: call.__setitem__("do", g.detach()))
        calls.append(call)
        return o
    return record


def attention_vs_f64(fa, call):
    """The kernels' O, dq, dk, dv and the plain f32 version's at one call's
    own inputs, each as max |err| over max |ref| against f64 autograd
    through the plain forward with the same dropout mask."""
    import torch
    q, k, v, do, kw = (call[x] for x in ("q", "k", "v", "do", "kw"))
    do = do.contiguous()
    sm, p, seed = kw["sm_scale"], kw["dropout_p"], kw["seed"] or 0

    def plain(dtype):
        x = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        o, _ = fa.flash_mha_reference(*x, sm, p, seed)
        return [o.detach()] + list(torch.autograd.grad(o, x, do.to(dtype)))

    ref = plain(torch.float64)
    o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm, dropout_p=p, seed=seed)
    kern = [o] + list(fa.flash_mha_bwd(q, k, v, o, lse, do, sm_scale=sm,
                                       dropout_p=p, seed=seed))

    def rel(xs):
        return [(a.double() - r).abs().max().item() / r.abs().max().item()
                for a, r in zip(xs, ref)]
    return {"d": q.shape[-1], "kernels": rel(kern),
            "plain_f32": rel(plain(torch.float32))}


def f32_gaps(a, b):
    """Loss, gradients and BatchNorm statistics of two f32 training steps:
    relative loss gap, each gradient tensor's max |gap| over its max |g|
    (the worst and its name, and the median), the max |gap| over the
    model's max |g| of the tensors whose gradient is 0 in exact arithmetic
    (EXACT_ZERO_GRADS: rounding noise on both sides) and of the
    gradient-free ones (0 on the second side), the
    gradients' global relative gap, and each statistic tensor's max |gap|
    over its max value (the worst)."""
    import numpy as np
    import torch
    (la, ga, sa), (lb, gb, sb) = a, b
    top = max(g.abs().max().item() for g in gb.values())
    rel, exact_zero, zero = {}, 0.0, 0.0
    for name, g in gb.items():
        err = (ga[name] - g).abs().max().item()
        if name.endswith(EXACT_ZERO_GRADS):
            exact_zero = max(exact_zero, err / top)
        elif g.abs().max().item() == 0.0:
            # no gradient reaches the tensor (the rebuild step's live image
            # stem and stage1): the other side's, of the largest |g|
            zero = max(zero, err / top)
        else:
            rel[name] = err / g.abs().max().item()
    worst = max(rel, key=rel.get)
    num = torch.sqrt(sum(((ga[k] - g).double() ** 2).sum()
                         for k, g in gb.items())).item()
    den = torch.sqrt(sum((g.double() ** 2).sum() for g in gb.values())).item()
    return {"loss": [la, lb], "loss_rel": abs(la - lb) / abs(lb),
            "grad_worst": rel[worst], "grad_worst_name": worst,
            "grad_median": float(np.median(list(rel.values()))),
            "grad_global_rel": num / den, "exact_zero": exact_zero,
            "zero_leaves": zero,
            "stats_worst": max((sa[k] - s).abs().max().item()
                               / s.abs().max().item()
                               for k, s in sb.items())}


def phase_train_mamba_f32(init, batch):
    """One f32 MambaFuser training step through the scan kernels and one
    through the plain scan, from the same weights with the same generators
    (dropout 0.1: the same masks), with reverse_scan_kernel off and on, cut
    to one MambaBlock per stage: at full depth the random-weight model is
    ill-conditioned in f32 (PERF.md).  The losses, new BatchNorm
    statistics and gradients are held to the GPT step's limits
    (phase_train_f32)."""
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.serve import mambafuser_config
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step

    # one block a stage: 4 x 2 fusion scans, 3 TimeMamba scans
    want = {False: {ss.KERNEL: 11, ss.KERNEL_BWD: 11},
            True: {ss.KERNEL: 7, ss.KERNEL_REV: 4, ss.KERNEL_BWD: 7,
                   ss.KERNEL_BWD_REV: 4}}
    for rev in (False, True):
        res = {}
        for path in ("scan", "plain"):
            cfg = mambafuser_config(compute_dtype="float32", n_layer=1,
                                    use_pallas_scan=path == "scan",
                                    reverse_scan_kernel=rev)
            model = BeamFuser(cfg, device=DEVICE)
            own = model.state_dict()
            model.load_state_dict({k: v for k, v in init.items() if k in own},
                                  strict=True)
            step = make_train_step(model, cfg, create_train_state(model),
                                   rng_seed=7, device=DEVICE)
            _build.reset_launch_counts()
            loss = step(batch, TRAIN_LR)["loss"].item()
            counts = dict(_build.KERNEL_LAUNCHES)
            check(counts == (want[rev] if path == "scan" else {}),
                  f"f32 mamba train {path} reverse={rev}: launches {counts}")
            res[path] = (loss,
                         {k: q.grad.detach().clone()
                          for k, q in model.named_parameters()},
                         {k: b.clone() for k, b in model.named_buffers()})
            del model, step
            torch.cuda.empty_cache()
        gap = f32_gaps(res["scan"], res["plain"])
        print(f"f32 mamba train step, reverse_scan_kernel={rev}: "
              + json.dumps({"scan_vs_plain": gap}))
        check(gap["loss_rel"] <= TRAIN_LOSS_RTOL, f"f32 mamba train "
              f"reverse={rev}: loss {gap['loss']} (scan, plain)")
        check(gap["stats_worst"] <= TRAIN_STATS_RTOL, f"f32 mamba train "
              f"reverse={rev}: BatchNorm statistics off by "
              f"{gap['stats_worst']:.3g}")
        check(gap["grad_global_rel"] <= TRAIN_GRAD_RTOL
              and gap["grad_worst"] <= TRAIN_GRAD_TENSOR_RTOL,
              f"f32 mamba train reverse={rev}: gradients off by "
              f"{gap['grad_global_rel']:.3g} of their norm, "
              f"{gap['grad_worst_name']} by {gap['grad_worst']:.3g} of its "
              f"largest |g|")


def per_forward(rows, launches, key):
    """Sum of ``key`` over the rows, each row weighted by its launches per
    forward."""
    return sum(launches[shape] * r[key] for shape, r in rows.items())


def summed(rows, key):
    """Sum of ``key`` over the rows (one per head dim), each taken N_LAYER
    times: per training step or per forward, 8 launches at each stage."""
    return sum(N_LAYER * r[key] for r in rows)


def bound_by(rows, key="bound_by"):
    return ("operations" if all(r[key] == "operations" for r in rows)
            else "bytes")


def phase_flash_parent(root):
    """With ``--parent PATH``: the flash forward, the merged backward, the
    split backward and each kernel of the split pair alone of the checkout
    at PATH (e.g. a ``git archive`` of the parent commit) against this
    checkout's, per GPT training step (tools/bench_flash.per_step: B=8,
    bf16, 8 launches at each head dim, dropout 0 and 0.1), timed on this
    card in the order parent, change, change, parent.  Returns each side's
    mean of its two runs, or None without a parent."""
    if not root:
        return None
    from deepsense6g_tii_tpu_torch.tools import bench_flash
    check(os.path.isdir(os.path.join(root, "deepsense6g_tii_tpu_torch")),
          f"--parent {root}: no deepsense6g_tii_tpu_torch there")
    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        runs[who].append(bench_flash.per_step(
            DEVICE, bench_flash.load_flash(root if who == "parent" else None)))
    out = {who: {key: {m: (r[0][key][m] + r[1][key][m]) / 2
                       for m in bench_flash.MEASURES} for key in r[0]}
           for who, r in runs.items()}
    out["runs"] = runs
    print("flash per GPT training step, parent vs change (B=8, bf16; "
          "parent, change, change, parent): " + json.dumps(
              {who: out[who] for who in ("parent", "change")}))
    return out


def phase_scan_parent(root):
    """With ``--parent PATH``: the scan forward and backward wrappers of the
    checkout at PATH against this checkout's, per MambaFuser step and
    serving forward (tools/bench_scan.per_step: the five scan shapes,
    bf16, each wrapper's every pass and partial sum, 16 launches at each
    L = 962 shape and 3 at L = 5; the sequential forward at B=8 and 1 as
    if the serving forward ran it), timed on this card in the order parent,
    change, change, parent; then the sequential kernel's states against
    PATH's (seq_states_vs_parent).  Returns each side's mean of its two
    runs, or None without a parent."""
    if not root:
        return None
    from deepsense6g_tii_tpu_torch.tools import bench_scan
    check(os.path.isdir(os.path.join(root, "deepsense6g_tii_tpu_torch")),
          f"--parent {root}: no deepsense6g_tii_tpu_torch there")
    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        runs[who].append(bench_scan.per_step(
            DEVICE, bench_scan.load_scan(root if who == "parent" else None)))
    out = {who: {k: (r[0][k] + r[1][k]) / 2 for k in r[0]
                 if k != "launch_ms"} for who, r in runs.items()}
    out["runs"] = runs
    print("scan per Mamba step and serving forward, parent vs change (bf16; "
          "parent, change, change, parent): " + json.dumps(
              {who: out[who] for who in ("parent", "change")}))
    out["seq_states"] = seq_states_vs_parent(bench_scan.load_scan(root))
    return out


def seq_states_vs_parent(parent):
    """The sequential forward's h_out and h_in against the parent
    checkout's sequential kernel on the same inputs, at the scan shapes,
    bf16 and f32, batch 8 and 1: held equal bit for bit (both kernels
    compute a state by the same arithmetic), their largest gap over the
    largest value printed; y's gap beside, not held (its order of
    summation may differ)."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (BATCH, 1):
            for L, d in SCAN_SHAPES:
                u, dt, A, B, C, _ = scan_inputs(gen, dtype, L, d, 0, b)
                mine = ss._launch_seq(u, dt, A, B, C, True)
                theirs = parent._launch_seq(u, dt, A, B, C, True)
                torch.cuda.synchronize()
                out[f"{str(dtype).split('.')[1]} b={b} L={L} d={d}"] = {
                    k: [torch.equal(m, t), rel_gap(m, t)]
                    for k, m, t in zip(("y", "h_out", "h_in"), mine, theirs)}
    equal = all(v[k][0] for v in out.values() for k in ("h_out", "h_in"))
    print(f"sequential scan states against the parent's (equal bit for bit: "
          f"{equal}): " + json.dumps(out))
    check(equal, "sequential scan: h_out or h_in differ from the parent "
          "kernel's")
    return out


# -- the dp phase: data parallelism ---------------------------------------------

class Children:
    """Processes this script starts, each writing to its own log under
    ``folder``; :meth:`wait` fails the run, after killing them all, when
    one exits non-zero or ``timeout`` seconds pass."""

    def __init__(self, cmds, folder, name, env=None, cwd=REPO,
                 timeout=DP_TIMEOUT):
        self.name, self.logs, self.procs = name, [], []
        for i, (cmd, extra) in enumerate(zip(cmds, env or [{}] * len(cmds))):
            log = os.path.join(folder, f"{name}{i}.log")
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                    env={**os.environ, **extra}, start_new_session=True))
            self.logs.append(log)
        self.deadline = time.perf_counter() + timeout

    def kill(self):
        import signal
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def wait(self):
        try:
            while any(p.poll() is None for p in self.procs):
                if (any(p.poll() not in (None, 0) for p in self.procs)
                        or time.perf_counter() > self.deadline):
                    break
                time.sleep(0.2)
        finally:
            self.kill()
        for p, log in zip(self.procs, self.logs):
            with open(log) as f:
                tail = f.read()[-3000:]
            check(p.returncode == 0, f"dp {self.name}: a process exited "
                  f"{p.returncode}:\n{tail}")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_hash(model, ema):
    """sha256 over the bytes of every parameter, buffer and EMA tensor, in
    name order."""
    return tensors_hash({**model.state_dict(),
                         **{f"ema.{k}": v for k, v in ema.items()}})


def rebuild_hash(trainer):
    """sha256 over a RebuildTrainer's heads (parameters and statistics),
    fusion model and AdamW state."""
    tensors = {**{f"heads.{k}": v for k, v in
                  trainer.heads.state_dict().items()},
               **{f"fusion.{k}": v for k, v in
                  trainer.fusion_model.state_dict().items()}}
    for i, st in enumerate(trainer.state.optimizer.state.values()):
        tensors.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return tensors_hash(tensors)


def tensors_hash(tensors):
    """sha256 over the names and bytes of ``tensors``, in name order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().contiguous().reshape(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_child(folder, rank, world, port, backend):
    """A process of the dp phase's train legs (``--dp-train``): rank
    ``rank`` of ``world`` in a ``backend`` group, or with world 1 the
    reference, one process under a one-rank NCCL group.  Ranks run the
    full-width bf16 leg (DP_STEPS steps, the state's hash after each) and
    the f32 legs on their rows of the global batch; the reference runs the
    f32 legs on the whole batch through the scan kernel and the plain scan.
    Rank 0 and the reference save each f32 step's loss, gradients, new
    BatchNorm statistics and parameters for the phase to compare."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.parallel.mesh import make_mesh
    from deepsense6g_tii_tpu_torch.serve import mambafuser_config
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", world, rank, require=True,
                           backend=backend)
    mesh = make_mesh()
    role = "ref" if world == 1 else f"rank{rank}"
    out = {"role": role, "device": str(mesh.device),
           "backend": torch.distributed.get_backend(), "world": world}

    def local(batch):
        rows = mesh.rows(len(batch["image"]))
        return {k: torch.from_numpy(v[rows]).to(mesh.device)
                for k, v in batch.items()}

    def run(cfg, batch, steps, save=None):
        model = BeamFuser(cfg, device=mesh.device,
                          generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, mesh=mesh)
        step = make_train_step(model, cfg, state, use_ema=True,
                               device=mesh.device)
        rec = []
        for _ in range(steps):
            _build.reset_launch_counts()
            loss = step(batch, TRAIN_LR)["loss"].item()
            rec.append({"loss": loss,
                        "launches": dict(_build.KERNEL_LAUNCHES),
                        "hash": state_hash(model, state.ema)})
        if save is not None:
            torch.save({"loss": loss,
                        "grads": {k: p.grad.detach().cpu()
                                  for k, p in model.named_parameters()},
                        "stats": {k: b.detach().cpu()
                                  for k, b in model.named_buffers()},
                        "params": {k: p.detach().cpu()
                                   for k, p in model.named_parameters()}},
                       save)
        del step, state, model
        torch.cuda.empty_cache()
        return rec

    if world > 1:
        cfg = mambafuser_config()
        out["bf16"] = run(cfg, local(make_synth_batch(cfg, DP_BATCH, seed=1)),
                          DP_STEPS)
    # the f32 legs' MambaFuser: one MambaBlock a stage (well conditioned in
    # f32, ROADMAP.md Queue 3), dropout 0 (each rank draws its own)
    cfg = mambafuser_config(compute_dtype="float32", n_layer=1,
                            embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    batch = make_synth_batch(cfg, DP_BATCH, seed=2)
    # the last row of the global batch invalid: the step of the first
    # DP_BATCH - 1 rows
    masked = {**batch, "valid": np.asarray([1.0] * (DP_BATCH - 1) + [0.0],
                                           np.float32)}
    first = {k: v[:DP_BATCH - 1] for k, v in batch.items()}
    legs = ({"f32": batch, "invalid": masked} if world > 1 else
            {"f32": batch, "invalid": first})
    for leg, b in legs.items():
        # the reference also steps through the plain scan, and through the
        # scan on its rows in DP_ORDERS (BatchNorm's and the loss's sums
        # taken in other orders, as the ranks' are)
        for path in (("scan",) if world > 1 else
                     ("scan", "plain") + DP_ORDERS):
            c = cfg.replace(use_pallas_scan=path != "plain")
            save = (os.path.join(folder, f"{role}_{leg}_{path}.pt")
                    if rank == 0 else None)
            if world > 1:
                rows = local(b)
            else:
                n = len(b["image"])
                order = {"reversed": np.arange(n)[::-1],
                         "rolled": np.roll(np.arange(n), n // 2)}.get(
                             path, np.arange(n))
                rows = {k: torch.from_numpy(v[order]).to(mesh.device)
                        for k, v in b.items()}
            out[f"{leg}_{path}"] = run(c, rows, 1, save)
    distributed.barrier("dp-train")
    with open(os.path.join(folder, f"{role}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    return 0


def dp_cli_child(folder, test_dir, argv, test_argv):
    """A rank of the dp phase's train CLI (``--dp-cli``, under
    torch.distributed.run): cli.train's main on ``argv`` in ``folder``
    (every train step's launches counted, every epoch's train and
    validation DBA kept, written to ``folder``/rank<RANK>.json), then
    main on ``test_argv`` with --load_model_path of the run's
    best_model in ``test_dir``, where the test CSVs land.  One launch for
    both: the first main leaves the process group up (its shutdown is held
    back) and the second joins it as it stands, since a group set up again
    on the launcher's store can hang (seen with 4 gloo ranks)."""
    from deepsense6g_tii_tpu_torch.cli import train as cli
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.train import engine

    counts, dba = [], {"train": [], "val": []}
    real = {"train": engine.Engine.train, "val": engine.Engine.validate}

    def keeping(kind):
        def call(self, loader):
            d = real[kind](self, loader)
            dba[kind].append(d)
            return d
        return call

    engine.Engine.train, engine.Engine.validate = (keeping("train"),
                                                   keeping("val"))
    shutdown, distributed.shutdown = distributed.shutdown, lambda: None
    try:
        with counted_train_steps(counts):
            check(cli.main(argv) == 0, "dp cli: main did not return 0")
    finally:
        engine.Engine.train, engine.Engine.validate = (real["train"],
                                                       real["val"])
        distributed.shutdown = shutdown
    with open(os.path.join(folder, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump({"launches": counts, "dba": dba}, f)
    (run,) = os.listdir(os.path.join(folder, "log"))
    os.chdir(test_dir)
    return cli.main(test_argv + ["--load_model_path", os.path.join(
        folder, "log", run, "best_model")])


def dp_rebuild_child(folder, rank, world, port, backend):
    """A process of the dp phase's rebuild leg (``--dp-rebuild``): rank
    ``rank`` of ``world`` in a ``backend`` group, or with world 1 the
    reference, one process under a one-rank NCCL group.  Each runs the
    full-width bf16 RebuildTrainer for DP_STEPS steps (the ranks on their
    rows of the global batch, the reference on all of it; each step's
    losses, ms, launches and state hash), then the f32 step at one block a
    stage with the heads' dropout 0 (the reference through the scan kernel,
    the plain scan and the rows in DP_ORDERS).  Rank 0 and the reference
    save each f32 step's losses, gradients and head statistics; every f32
    step also keeps the contrastive term of its own rows alone."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.parallel.mesh import make_mesh
    from deepsense6g_tii_tpu_torch.rebuild import trainer as rtrainer
    from deepsense6g_tii_tpu_torch.serve import mambafuser_config
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    rank, world = int(rank), int(world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"127.0.0.1:{port}", world, rank, require=True,
                           backend=backend)
    mesh = make_mesh()
    role = "ref" if world == 1 else f"rank{rank}"
    out = {"role": role, "device": str(mesh.device),
           "backend": torch.distributed.get_backend(), "world": world}

    def rows(batch, path="scan"):
        if world > 1:
            order = np.arange(len(batch["image"]))[mesh.rows(len(
                batch["image"]))]
        else:
            n = len(batch["image"])
            order = {"reversed": np.arange(n)[::-1],
                     "rolled": np.roll(np.arange(n), n // 2)}.get(
                         path, np.arange(n))
        return {k: torch.from_numpy(v[order]).to(mesh.device)
                for k, v in batch.items()}

    def make(cfg):
        model = BeamFuser(cfg, device=mesh.device,
                          generator=torch.Generator().manual_seed(0))
        tr = rtrainer.RebuildTrainer(model, cfg, rtrainer.RebuildOptions(),
                                     device=mesh.device, mesh=mesh)
        tr.init_state()
        return tr

    # the flat all-reduce of the gradients and losses, timed on its own
    # (synchronised before and after; ranks only)
    real_reduce, reduce_ms = rtrainer._flat_all_reduce, []

    def timed_reduce(tensors, group):
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        real_reduce(tensors, group)
        torch.cuda.synchronize(mesh.device)
        reduce_ms.append(1e3 * (time.perf_counter() - t0))

    rtrainer._flat_all_reduce = timed_reduce
    cfg = mambafuser_config(modality_missing="image")
    batch = rows(make_synth_batch(cfg, DP_BATCH, seed=7))
    tr, rec = make(cfg), []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize(mesh.device)
        _build.reset_launch_counts()
        reduce_ms.clear()
        t0 = time.perf_counter()
        aux = tr.train_step(batch, TRAIN_LR, floats=True)   # one read-back
        rec.append({"aux": aux, "ms": 1e3 * (time.perf_counter() - t0),
                    "allreduce_ms": sum(reduce_ms),
                    "launches": dict(_build.KERNEL_LAUNCHES),
                    "hash": rebuild_hash(tr)})
    out["bf16"] = rec
    rtrainer._flat_all_reduce = real_reduce
    del tr, batch
    torch.cuda.empty_cache()

    # f32, one MambaBlock a stage, the heads' dropout 0 (each rank draws
    # its own masks); the contrastive terms also as a port without the
    # gather computes them, from this process's rows alone
    real, local = rtrainer.contrastive_loss, []

    def recording(x1, x2, seq_len, temperature, group=None):
        local.append(real(x1.detach(), x2.detach(), seq_len,
                          temperature=temperature))
        return real(x1, x2, seq_len, temperature=temperature, group=group)

    rtrainer.contrastive_loss = recording
    cfg = mambafuser_config(modality_missing="image", compute_dtype="float32",
                            n_layer=1)
    batch = make_synth_batch(cfg, DP_BATCH, seed=8)
    for path in (("scan",) if world > 1 else
                 ("scan", "plain") + DP_ORDERS):
        tr = make(cfg.replace(use_pallas_scan=path != "plain"))
        tr.heads.feat_trans_l1.p = 0.0
        local.clear()
        _build.reset_launch_counts()
        aux = tr.train_step(rows(batch, path), TRAIN_LR, floats=True)
        out[f"f32_{path}"] = {
            "aux": aux, "launches": dict(_build.KERNEL_LAUNCHES),
            "hash": rebuild_hash(tr),
            "local_contrast": float(sum(local) / len(local))}
        if rank == 0:
            named = (list(tr.heads.named_parameters(prefix="heads"))
                     + list(tr.fusion_model.named_parameters(
                         prefix="fusion")))
            torch.save({"aux": aux,
                        "grads": {k: p.grad.detach().cpu() for k, p in named},
                        "stats": {k: b.detach().cpu() for k, b in
                                  tr.heads.named_buffers()}},
                       os.path.join(folder, f"{role}_f32_{path}.pt"))
        del tr
        torch.cuda.empty_cache()
    rtrainer.contrastive_loss = real
    distributed.barrier("dp-rebuild")
    with open(os.path.join(folder, f"{role}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    return 0


def dp_rebuild_cli_child(folder, argv, val_argv):
    """A rank of the dp phase's rebuild CLI leg (``--dp-rebuild-cli``, under
    torch.distributed.run): the rebuild CLI's main on ``argv`` (every train
    step's launches counted, every DBA it computes kept), then main on
    ``val_argv`` in the same process group (the first main's shutdown held
    back, as ``dp_cli_child`` does); writes ``folder``/rank<RANK>.json."""
    from deepsense6g_tii_tpu_torch.cli import rebuild as rcli
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.rebuild.trainer import RebuildTrainer
    from deepsense6g_tii_tpu_torch.train import metrics

    counts, dbas = [], []
    real_step, real_dba = RebuildTrainer.train_step, metrics.compute_dba_score

    def counting_step(self, *a, **k):
        res, c = counted(lambda: real_step(self, *a, **k))
        counts.append(c)
        return res

    def keeping_dba(*a, **k):
        d = real_dba(*a, **k)
        dbas.append(float(d))
        return d

    RebuildTrainer.train_step = counting_step
    metrics.compute_dba_score = keeping_dba
    shutdown, distributed.shutdown = distributed.shutdown, lambda: None
    try:
        check(rcli.main(argv) == 0, "dp rebuild cli: main did not return 0")
        n_train = len(dbas)
        distributed.shutdown = shutdown
        check(rcli.main(val_argv) == 0,
              "dp rebuild cli --Val: main did not return 0")
    finally:
        RebuildTrainer.train_step, metrics.compute_dba_score = (real_step,
                                                                real_dba)
        distributed.shutdown = shutdown
    with open(os.path.join(folder, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump({"launches": counts, "dba": {"train": dbas[:n_train],
                                               "val": dbas[n_train:]}}, f)
    return 0


def replica_reference(pred, model, arrays):
    """``pred``'s (a mesh Predictor's) answer to a request as ``model``
    gives it on one device, one replica's rows of the padded request at a
    time (the shapes each replica ran), through predict's softmax and
    top-k: (1-indexed top-k, confidences)."""
    import numpy as np
    import torch
    n, b = len(arrays[0]), pred._bucket(len(arrays[0]))
    per = b // pred.n_devices
    padded = [np.pad(np.asarray(a, np.float32),
                     ((0, b - n),) + ((0, 0),) * (a.ndim - 1))
              for a in arrays]
    with torch.inference_mode():
        logits = torch.cat([model(*(
            torch.from_numpy(a[i * per:(i + 1) * per]).to(pred.device)
            for a in padded)) for i in range(pred.n_devices)])
        conf, idx = torch.topk(torch.softmax(logits.float(), -1),
                               pred.top_k, dim=-1)
    return idx[:n].cpu().numpy() + 1, conf[:n, 0].cpu().numpy()


def beams_agree(idx, want_probs, label):
    """1-indexed top-k ``idx`` against probabilities ``want_probs``: each
    beam equal to the reference's at its rank, or the reference's
    probabilities of the two within DP_ONE_DEVICE_ATOL (a near-tie ordered
    otherwise).  Returns the rows that differ."""
    import numpy as np
    k = idx.shape[1]
    want = np.argsort(-want_probs, axis=-1, kind="stable")[:, :k] + 1
    differ = 0
    for got_row, want_row, p in zip(idx, want, want_probs):
        if not np.array_equal(got_row, want_row):
            differ += 1
            check(np.abs(p[got_row - 1] - p[want_row - 1]).max()
                  <= DP_ONE_DEVICE_ATOL, f"dp serve {label}: top-{k} "
                  f"{got_row} against {want_row} (probabilities "
                  f"{p[got_row - 1]}, {p[want_row - 1]})")
    return differ


def dp_serve(card, mesh):
    """Predictor(use_mesh=mesh) on both full-width models (bf16, seed-0
    weights): a request of DP_BATCH rows (DP_BATCH / replicas a replica)
    and a ragged one of 3."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.serve import (Predictor,
                                                 gpt_transfuser_config,
                                                 mambafuser_config)
    from deepsense6g_tii_tpu_torch.tools import bench_serve
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    def sync():
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)

    n_rep = len(mesh.devices)
    out = {}
    for name, cfg, per_forward in (
            ("mamba", mambafuser_config(), {ss.KERNEL: sum(
                SCAN_LAUNCHES.values())}),
            ("gpt", gpt_transfuser_config(), {fa.KERNEL: 4 * N_LAYER})):
        model = BeamFuser(cfg, device=mesh.device,
                          generator=torch.Generator().manual_seed(0))
        dp = Predictor(model, cfg, batch_buckets=(1, DP_BATCH // n_rep),
                       device=mesh.device, use_mesh=mesh)
        one = Predictor(model, cfg, batch_buckets=(1, DP_BATCH),
                        device=mesh.device)
        b = make_synth_batch(cfg, DP_BATCH, seed=3, with_labels=False)
        x = [b[k] for k in ("image", "lidar", "radar", "gps")]
        dp.predict(*x)                                          # warm
        sync()
        _build.reset_launch_counts()
        idx, conf = dp.predict(*x)
        sync()
        launches = dict(_build.KERNEL_LAUNCHES)
        check(launches == {k: v * n_rep for k, v in per_forward.items()},
              f"dp serve {name}: launches {launches}, expected "
              f"{per_forward} on each of {n_rep} replicas")
        leg = {"replicas": n_rep, "launches_per_replica": {
            k: v // n_rep for k, v in launches.items()}}
        for label, req in (("b8", x), ("ragged3", [a[:3] for a in x])):
            got_idx, got_conf = (idx, conf) if label == "b8" else (
                dp.predict(*req))
            check(got_idx.shape == (len(req[0]), 3) and np.isfinite(
                got_conf).all(), f"dp serve {name} {label}: shapes "
                f"{got_idx.shape}")
            want_idx, want_conf = replica_reference(dp, model, req)
            err = float(np.abs(got_conf - want_conf).max())
            check(np.array_equal(got_idx, want_idx) and np.array_equal(
                got_conf, want_conf), f"dp serve {name} {label}: top-3 or "
                f"confidences ({err:.3g} off) not bit-equal to one "
                f"device's on the replicas' rows")
            leg[label] = {"rows": len(req[0]), "bucket": dp._bucket(len(
                req[0])), "conf_err_vs_replica_rows": err}
        # one device at batch 8: the Predictor a user would run without the
        # mesh
        with torch.inference_mode():
            p8 = torch.softmax(one.model(*(torch.from_numpy(a).to(
                one.device) for a in x)).float(), -1).cpu().numpy()
        err8 = float(np.abs(conf - p8.max(-1)).max())
        check(err8 <= DP_ONE_DEVICE_ATOL, f"dp serve {name}: confidences "
              f"{err8:.3g} from one device's at batch {DP_BATCH}")
        leg["b8"].update(conf_err_vs_one_device=err8,
                         differ_vs_one_device=beams_agree(
                             idx, p8, f"{name} (one device)"))
        # latency at batch 8 as tools/bench_serve.py takes it, the mesh's
        # and one device's in turn
        for label, pred in (("dp", dp), ("one_device", one)):
            r = pred.latency_benchmark(batch=DP_BATCH,
                                       iters=bench_serve.ITERS)
            leg[f"{label}_p50_ms"], leg[f"{label}_p90_ms"] = (
                r["p50_ms"], r["p90_ms"])
        leg["dp_over_one_device_p50"] = (leg["dp_p50_ms"]
                                         / leg["one_device_p50_ms"])
        out[name] = leg
        del dp, one, model
        torch.cuda.empty_cache()
    print(f"dp serve on {card}: " + json.dumps(out))
    return out


def dp_gap(a, b):
    """f32_gaps of two saved f32 steps and the share of their updated
    parameters' elements more than 1% of lr apart."""
    gap = f32_gaps(*((s["loss"], s["grads"], s["stats"]) for s in (a, b)))
    diffs = [(a["params"][k] - v).abs() for k, v in b["params"].items()]
    gap["params_share"] = (sum(int((d > 0.01 * TRAIN_LR).sum())
                               for d in diffs)
                           / sum(d.numel() for d in diffs))
    return gap


def phase_dp(card):
    """Data parallelism on the card, three legs (ROADMAP.md Queue 1 item
    7); with at least 2 cards the mesh is the cards and the ranks run on
    NCCL, one card each; with one, two replicas or two gloo ranks share
    cuda:0 (NCCL refuses two ranks on one device)."""
    import shutil
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.parallel.mesh import Mesh
    from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root

    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    base = os.path.join(REPO, "build", "dp")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(os.path.join(base, "train"))
    os.makedirs(os.path.join(base, "cli_run"))
    os.makedirs(os.path.join(base, "cli_test"))
    os.makedirs(os.path.join(base, "rebuild"))
    os.makedirs(os.path.join(base, "rebuild_cli"))
    world = max(2, n_cards)
    backend = "nccl" if n_cards >= 2 else "gloo"
    devices = ([f"{DEVICE}:{i}" for i in range(n_cards)] if n_cards >= 2
               else [f"{DEVICE}:0"] * 2)
    print(f"dp on {card}: {n_cards} card(s); serving mesh {devices}; train "
          f"legs {world} ranks on {backend}"
          + (" (both on cuda:0)" if n_cards < 2 else "")
          + "; reference: one process, a one-rank NCCL group; cli: "
          f"{n_cards} rank(s) under torch.distributed.run on NCCL")
    root = os.path.join(base, "data")
    make_demo_root(root, *CLI_SPLITS, seq_len=5, seed=0)
    n_train = int(0.9 * 2 * (CLI_SPLITS[0] + CLI_SPLITS[1]))
    torch.cuda.empty_cache()

    # dp train: the ranks and the reference, started together
    folder = os.path.join(base, "train")
    port, ref_port = free_port(), free_port()
    me = SCRIPT
    train = Children(
        [[sys.executable, me, "--dp-train", folder, str(r), str(world),
          str(port), backend] for r in range(world)]
        + [[sys.executable, me, "--dp-train", folder, "0", "1",
            str(ref_port), "nccl"]], folder, "train",
        env=[{"LOCAL_RANK": str(r if n_cards >= 2 else 0)}
             for r in range(world)] + [{"LOCAL_RANK": "0"}])
    # dp cli: one epoch of the GPT TransFuser at --n_layer 2, then a test
    cli_common = ["--data_root", root, "--FFM", "0", "--TFM", "0",
                  "--n_layer", str(CLI_GPT_LAYERS), "--batch_size",
                  str(CLI_BATCH), "--augmentation", "0", "--num_workers",
                  "4", "--multihost", "1"]

    cli_run = os.path.join(base, "cli_run")
    cli_test_dir = os.path.join(base, "cli_test")
    # dp rebuild cli: one epoch of the MambaFuser at --n_layer 2 (random
    # weights), then --Val 1 on its logdir
    rb_cli_dir = os.path.join(base, "rebuild_cli")
    rb_logdir = os.path.join(rb_cli_dir, "run")
    rb_common = ["-s", "lidar", "radar", "-t", "image", "--data_root", root,
                 "--n_layer", str(DP_REBUILD_CLI_LAYERS), "--batch_size",
                 str(CLI_BATCH), "--num_workers", "4"]
    children = [train, Children(
        [[sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc_per_node", str(n_cards), me, "--dp-cli", cli_run,
          cli_test_dir, "--", *cli_common, "--epochs", "1", "--",
          *cli_common, "--Test", "1"]], cli_run, "cli", cwd=cli_run),
        Children([[sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", str(n_cards), me,
                   "--dp-rebuild-cli", rb_cli_dir, "--", *rb_common,
                   "--logdir", rb_logdir, "--epochs", "1", "--", *rb_common,
                   "--logdir", os.path.join(rb_cli_dir, "val"), "--Val", "1",
                   "--load_model_dir", rb_logdir]], rb_cli_dir,
                 "rebuild_cli", cwd=rb_cli_dir)]
    rb_folder = os.path.join(base, "rebuild")
    times = {}
    try:
        # dp serve in this process meanwhile
        serve_out = dp_serve(card, Mesh(devices))
        times["serve_s"] = time.perf_counter() - t_start
        train.wait()
        times["train_s"] = time.perf_counter() - t_start
        # dp rebuild: the ranks and the reference, once the train leg has
        # left the card's memory to them
        rb_port, rb_ref_port = free_port(), free_port()
        children.append(Children(
            [[sys.executable, me, "--dp-rebuild", rb_folder, str(r),
              str(world), str(rb_port), backend] for r in range(world)]
            + [[sys.executable, me, "--dp-rebuild", rb_folder, "0", "1",
                str(rb_ref_port), "nccl"]], rb_folder, "rebuild",
            env=[{"LOCAL_RANK": str(r if n_cards >= 2 else 0)}
                 for r in range(world)] + [{"LOCAL_RANK": "0"}]))
        for name, c in zip(("cli_s", "rebuild_cli_s", "rebuild_s"),
                           children[1:]):
            c.wait()
            times[name] = time.perf_counter() - t_start
    finally:
        for c in children:
            c.kill()
    (run,) = os.listdir(os.path.join(cli_run, "log"))
    logdir = os.path.join(cli_run, "log", run)

    # dp train: the ranks bit-equal, their launches, and the f32 legs
    # against the reference's step
    ranks = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(folder, "ref.json")) as f:
        ref = json.load(f)
    n_scan = sum(SCAN_LAUNCHES.values())
    for i in range(DP_STEPS):
        steps = [r["bf16"][i] for r in ranks]
        check(len({s["hash"] for s in steps}) == 1, f"dp train bf16 step "
              f"{i}: the ranks' parameters, buffers and EMA differ")
        check(len({s["loss"] for s in steps}) == 1 and np.isfinite(
            steps[0]["loss"]), f"dp train bf16 step {i}: losses "
            f"{[s['loss'] for s in steps]}")
        for r, s in enumerate(steps):
            check(s["launches"] == {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan},
                  f"dp train bf16 step {i} rank {r}: launches "
                  f"{s['launches']}")
    train_out = {"world": world, "backend": ranks[0]["backend"],
                 "devices": [r["device"] for r in ranks],
                 "ref": {"backend": ref["backend"], "device": ref["device"]},
                 "bf16_losses": [s["loss"] for s in ranks[0]["bf16"]],
                 "launches_per_rank_step": ranks[0]["bf16"][0]["launches"]}
    one_block = {ss.KERNEL: 2 * 4 + 3, ss.KERNEL_BWD: 2 * 4 + 3}
    for leg in ("f32", "invalid"):
        check(len({r[f"{leg}_scan"][0]["hash"] for r in ranks}) == 1,
              f"dp train {leg}: the ranks' state differs")
        for r in ranks + [ref]:
            check(r[f"{leg}_scan"][0]["launches"] == one_block,
                  f"dp train {leg} {r['role']}: launches "
                  f"{r[f'{leg}_scan'][0]['launches']}")
        check(ref[f"{leg}_plain"][0]["launches"] == {},
              f"dp train {leg}: the plain scan launched a kernel")
        saved = {f"{who}_{path}": torch.load(os.path.join(
            folder, f"{who}_{leg}_{path}.pt"), weights_only=True)
            for who, path in (("rank0", "scan"), ("ref", "scan"),
                              ("ref", "plain"))
            + tuple(("ref", o) for o in DP_ORDERS)}
        gap = dp_gap(saved["rank0_scan"], saved["ref_scan"])
        shifts = {"plain_shift": dp_gap(saved["ref_scan"],
                                        saved["ref_plain"])}
        for o in DP_ORDERS:
            shifts[f"{o}_shift"] = dp_gap(saved["ref_scan"], saved[f"ref_{o}"])
        train_out[leg] = {k: {"gap": gap[k], **{
            name: sh[k] for name, sh in shifts.items()}, "bound": max(
                DP_SHIFT_FACTOR * max(sh[k] for sh in shifts.values()),
                floor)} for k, floor in DP_FLOOR.items()}
        train_out[leg]["loss"] = gap["loss"]
    # every reading printed before any is held to its bound
    print(f"dp train on {card}: " + json.dumps(train_out))
    for leg in ("f32", "invalid"):
        for k in DP_FLOOR:
            r = train_out[leg][k]
            check(r["gap"] <= r["bound"], f"dp train {leg}: {k} "
                  f"{r['gap']:.3g} from the one-process step, bound "
                  f"{r['bound']:.3g} ({r})")

    # dp cli: one logdir, written by rank 0 alone; every rank's DBA equal
    cli_ranks = []
    for r in range(n_cards):
        with open(os.path.join(cli_run, f"rank{r}.json")) as f:
            cli_ranks.append(json.load(f))
    per_rank = n_train // n_cards
    local_batch = CLI_BATCH // n_cards
    n_steps = -(-per_rank // local_batch)
    expect = {fa.KERNEL: 4 * CLI_GPT_LAYERS,
              fa.KERNEL_MERGED: 4 * CLI_GPT_LAYERS}
    for r, c in enumerate(cli_ranks):
        check(len(c["launches"]) == n_steps and all(
            x == expect for x in c["launches"]), f"dp cli rank {r}: "
            f"launches {c['launches']}, expected {n_steps} steps of {expect}")
        check(c["dba"] == cli_ranks[0]["dba"] and len(c["dba"]["val"]) == 1,
              f"dp cli: rank {r}'s DBA {c['dba']} against rank 0's "
              f"{cli_ranks[0]['dba']}")
    files = os.listdir(logdir)
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    check(tags.count("DBA_score_train") == 1
          and sum(f.startswith("events.out") for f in files) == 1
          and all(f"{s}.pt" in files for s in ("final_model", "best_model",
                                                "best_optim")),
          f"dp cli: logdir {files}, {tags.count('DBA_score_train')} train "
          f"DBA lines")
    check_test_csvs(cli_test_dir, 2 * CLI_SPLITS[2], "dp cli")
    with open(os.path.join(logdir, "recent.log")) as f:
        rec = json.load(f)
    check(rec["epoch"] == 1 and np.isfinite(rec["train_loss"]).all(),
          f"dp cli: run record {rec}")
    cli_out = {"ranks": n_cards, "steps_per_rank": n_steps,
               "launches_per_rank_step": cli_ranks[0]["launches"][0],
               "dba": cli_ranks[0]["dba"], "train_loss": rec["train_loss"]}
    print(f"dp cli on {card}: " + json.dumps(cli_out))
    rebuild_out = dp_rebuild_readings(card, rb_folder, world, one_block)
    rebuild_cli_out = dp_rebuild_cli_readings(card, rb_cli_dir, rb_logdir,
                                              n_cards, n_train)
    seconds = time.perf_counter() - t_start
    # each leg's end, seconds from the phase's start (the legs overlap)
    print(f"dp on {card}: {seconds:.1f} s; " + json.dumps(times))
    for d in (folder, rb_folder, rb_cli_dir):   # f32 steps, checkpoints
        shutil.rmtree(d, ignore_errors=True)
    return {"serve": serve_out, "train": train_out, "cli": cli_out,
            "rebuild": rebuild_out, "rebuild_cli": rebuild_cli_out,
            "seconds": seconds}


def rebuild_gap(a, b):
    """f32_gaps of two saved f32 rebuild steps (the total loss, the heads'
    and fusion model's gradients, the heads' statistics), with the largest
    relative gap of the five losses as ``loss_rel``."""
    gap = f32_gaps(*((s["aux"]["loss"], s["grads"], s["stats"])
                     for s in (a, b)))
    gap["losses_rel"] = {k: abs(a["aux"][k] - b["aux"][k]) / abs(b["aux"][k])
                         for k in REBUILD_LOSSES}
    gap["loss_rel"] = max(gap["losses_rel"].values())
    return gap


def dp_rebuild_readings(card, folder, world, one_block):
    """The dp rebuild leg's checks: the ranks bit-equal after every bf16
    step, their losses equal and finite, their launches; the f32 step of
    rank 0 against the reference's, each gap within DP_SHIFT_FACTOR times
    the largest of the reference's shifts (never below DP_REBUILD_FLOOR);
    and the contrastive term of rank 0's rows alone outside the losses'
    bound.  Every reading is printed before any is held to its bound."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    ranks = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(folder, "ref.json")) as f:
        ref = json.load(f)
    n_scan = sum(SCAN_LAUNCHES.values())
    want = {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}
    for i in range(DP_STEPS):
        steps = [r["bf16"][i] for r in ranks]
        check(len({s["hash"] for s in steps}) == 1, f"dp rebuild bf16 step "
              f"{i}: the ranks' heads, fusion model, statistics or AdamW "
              f"state differ")
        check(all(s["aux"] == steps[0]["aux"] for s in steps)
              and np.isfinite(list(steps[0]["aux"].values())).all(),
              f"dp rebuild bf16 step {i}: losses "
              f"{[s['aux'] for s in steps]}")
        for s in steps + [ref["bf16"][i]]:
            check(s["launches"] == want, f"dp rebuild bf16 step {i}: "
                  f"launches {s['launches']}, expected {want}")

    def p50(rec):
        return float(np.percentile([s["ms"] for s in rec[1:]], 50))

    out = {"world": world, "backend": ranks[0]["backend"],
           "devices": [r["device"] for r in ranks],
           "ref": {"backend": ref["backend"], "device": ref["device"]},
           "global_batch": DP_BATCH,
           "bf16_losses": [s["aux"] for s in ranks[0]["bf16"]],
           "launches_per_rank_step": ranks[0]["bf16"][0]["launches"],
           "step_ms_p50_per_rank": [p50(r["bf16"]) for r in ranks],
           "ref_step_ms_p50": p50(ref["bf16"]),
           # the gradients' flat all-reduce within a rank's step
           "allreduce_ms_p50_per_rank": [float(np.percentile(
               [s["allreduce_ms"] for s in r["bf16"][1:]], 50))
               for r in ranks]}
    check(len({r["f32_scan"]["hash"] for r in ranks}) == 1,
          "dp rebuild f32: the ranks' state differs")
    for r in ranks + [ref]:
        check(r["f32_scan"]["launches"] == one_block, f"dp rebuild f32 "
              f"{r['role']}: launches {r['f32_scan']['launches']}")
    check(ref["f32_plain"]["launches"] == {},
          "dp rebuild f32: the plain scan launched a kernel")
    saved = {f"{who}_{path}": torch.load(os.path.join(
        folder, f"{who}_f32_{path}.pt"), weights_only=True)
        for who, path in (("rank0", "scan"), ("ref", "scan"),
                          ("ref", "plain"))
        + tuple(("ref", o) for o in DP_ORDERS)}
    gap = rebuild_gap(saved["rank0_scan"], saved["ref_scan"])
    shifts = {"plain_shift": rebuild_gap(saved["ref_scan"],
                                         saved["ref_plain"])}
    for o in DP_ORDERS:
        shifts[f"{o}_shift"] = rebuild_gap(saved["ref_scan"],
                                           saved[f"ref_{o}"])
    f32 = {k: {"gap": gap[k], **{name: sh[k] for name, sh in
                                 shifts.items()},
               "bound": max(DP_SHIFT_FACTOR * max(sh[k] for sh in
                                                  shifts.values()), floor)}
           for k, floor in DP_REBUILD_FLOOR.items()}
    f32["losses"] = {"rank0": saved["rank0_scan"]["aux"],
                     "ref": saved["ref_scan"]["aux"]}
    f32["losses_rel"] = gap["losses_rel"]
    f32["grad_worst"] = [gap["grad_worst_name"], gap["grad_worst"]]
    # the planted fault: NT-Xent over rank 0's rows alone, as a port
    # without the gather computes it
    local = ranks[0]["f32_scan"]["local_contrast"]
    ref_c = saved["ref_scan"]["aux"]["contrast"]
    f32["planted_local_contrast"] = {
        "rank0_rows_alone": local, "gathered": saved["rank0_scan"]["aux"][
            "contrast"], "ref": ref_c, "rel": abs(local - ref_c) / abs(ref_c),
        "bound": f32["loss_rel"]["bound"]}
    out["f32"] = f32
    print(f"dp rebuild on {card}: " + json.dumps(out))
    for k in DP_REBUILD_FLOOR:
        check(f32[k]["gap"] <= f32[k]["bound"], f"dp rebuild f32: {k} "
              f"{f32[k]['gap']:.3g} from the one-process step, bound "
              f"{f32[k]['bound']:.3g} ({f32[k]})")
    planted = f32["planted_local_contrast"]
    check(planted["rel"] > planted["bound"], f"dp rebuild: the contrastive "
          f"term of rank 0's rows alone lies within the bound ({planted}): "
          f"the leg would not see a missing gather")
    return out


def dp_rebuild_cli_readings(card, folder, logdir, n_cards, n_train):
    """The dp rebuild cli leg's checks: the launches of every rank's step,
    every rank's DBA equal, one logdir written by rank 0 alone with the
    5-way files, and a finite --Val DBA."""
    import numpy as np
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.rebuild.trainer import HEAD_KEYS

    ranks = []
    for r in range(n_cards):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    n_steps = -(-(n_train // n_cards) // (CLI_BATCH // n_cards))
    n_scan = 4 * 2 * DP_REBUILD_CLI_LAYERS + 3
    want = {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan}
    for r, c in enumerate(ranks):
        check(len(c["launches"]) == n_steps
              and all(x == want for x in c["launches"]),
              f"dp rebuild cli rank {r}: launches {c['launches']}, expected "
              f"{n_steps} steps of {want}")
        check(c["dba"] == ranks[0]["dba"] and ranks[0]["dba"]["val"],
              f"dp rebuild cli: rank {r}'s DBA {c['dba']} against rank 0's "
              f"{ranks[0]['dba']}")
    files = os.listdir(logdir)
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    needed = [f"{p}_{k}.pt" for p in ("best", "final")
              for k in HEAD_KEYS + ("fusion_model",)] + ["best_optim.pt"]
    check(tags.count("curr_loss_train") == 1
          and sum(f.startswith("events.out") for f in files) == 1
          and not [f for f in files if f.endswith(".tmp")]
          and all(f in files for f in needed),
          f"dp rebuild cli: logdir {files}, "
          f"{tags.count('curr_loss_train')} train loss lines")
    with open(os.path.join(logdir, "recent.log")) as f:
        rec = json.load(f)
    val_dba = ranks[0]["dba"]["val"][-1]
    check(rec["epoch"] == 1 and np.isfinite(rec["train_loss"]).all()
          and np.isfinite(rec["DBA"]).all() and 0.0 <= val_dba <= 1.0,
          f"dp rebuild cli: run record {rec}, --Val DBA {val_dba}")
    out = {"ranks": n_cards, "n_layer": DP_REBUILD_CLI_LAYERS,
           "steps_per_rank": n_steps,
           "launches_per_rank_step": ranks[0]["launches"][0],
           "dba": ranks[0]["dba"], "val_dba": val_dba,
           "train_loss": rec["train_loss"]}
    print(f"dp rebuild cli on {card}: " + json.dumps(out))
    return out


# each phase's seconds, for the summary line: outermost calls only (a
# phase run inside another counts in that one), repeated calls summed
PHASE_SECONDS = {}
_PHASE_DEPTH = [0]


def timed_phase(fn):
    import functools

    @functools.wraps(fn)
    def call(*args, **kwargs):
        _PHASE_DEPTH[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _PHASE_DEPTH[0] -= 1
            if not _PHASE_DEPTH[0]:
                name = fn.__name__[len("phase_"):]
                PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                                       + time.perf_counter() - t0)
    return call


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = timed_phase(globals()[_name])


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, metavar="PATH",
                    help="a checkout whose flash and scan kernels to time "
                         "against this one's (e.g. a git archive of the "
                         "parent)")
    ap.add_argument("--serve-exported", nargs=2, metavar=("DIR", "DEVICE"),
                    help=argparse.SUPPRESS)    # the export phase's process
    ap.add_argument("--dp-train", nargs=5, help=argparse.SUPPRESS,
                    metavar=("DIR", "RANK", "WORLD", "PORT", "BACKEND"))
    ap.add_argument("--dp-rebuild", nargs=5, help=argparse.SUPPRESS,
                    metavar=("DIR", "RANK", "WORLD", "PORT", "BACKEND"))
    ap.add_argument("--dp-only", action="store_true",
                    help="only the device, build and dp phases (for a "
                         "call with several cards)")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dp-cli"]:        # a rank of the dp phase's CLI leg
        i = argv.index("--")
        j = argv.index("--", i + 1)
        return dp_cli_child(argv[1], argv[2], argv[i + 1:j], argv[j + 1:])
    if argv[:1] == ["--dp-rebuild-cli"]:    # a rank of the rebuild CLI leg
        i = argv.index("--")
        j = argv.index("--", i + 1)
        return dp_rebuild_cli_child(argv[1], argv[i + 1:j], argv[j + 1:])
    args = ap.parse_args(argv)
    if args.serve_exported:
        return serve_exported(*args.serve_exported)
    if args.dp_train:
        return dp_train_child(*args.dp_train)
    if args.dp_rebuild:
        return dp_rebuild_child(*args.dp_rebuild)
    t_start = time.perf_counter()
    card, sfu_rate, fmul_rate = phase_device()
    phase_build()
    if args.dp_only:
        phase_dp(card)
        print(f"chip_smoke --dp-only on {card}: "
              f"{time.perf_counter() - t_start:.1f} s")
        print_ok()
        return 0
    flash_rows = phase_flash_kernel(sfu_rate)
    mask_row = phase_mask()
    bwd_rows = phase_flash_bwd(sfu_rate)
    batch1 = phase_flash_shapes()
    scan_rows = phase_scan_kernel(sfu_rate)
    scan_bwd_rows = phase_scan_bwd(sfu_rate)
    phase_scan_edges()
    seq_rows = phase_scan_seq(sfu_rate)
    chain_rows = phase_chain(fmul_rate, sfu_rate)
    _, roofline_launches = phase_roofline(fmul_rate)

    import torch
    from deepsense6g_tii_tpu_torch.config import config_30to5
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.serve import (gpt_transfuser_config,
                                                 mambafuser_config)
    ref30 = config_30to5()
    gpt = phase_slice(card, "gpt", gpt_transfuser_config(),
                      {fa.KERNEL: 4 * N_LAYER, ss.KERNEL: 0},
                      {"flash": dict(use_flash_attention=True),
                       "plain": dict(use_flash_attention=False)},
                      [("flash", "plain", LOGIT_TOL)])
    # Full depth, the random-weight MambaFuser is ill-conditioned in f32:
    # its blocks multiply two branches and have no residual path, so a
    # last-bit change in any layer grows to 1e-3..4e-3 on logits of ~140.
    # The run measures that floor as the plain path's own shift between
    # reverse_scan_kernel off and on (the same math, rounded otherwise) and
    # holds the kernel to MAMBA_LOGIT_RTOL of the largest logit there; cut
    # to one MambaBlock per stage, the model is well conditioned and the
    # kernel is held to LOGIT_TOL.
    runs, checks = {}, []
    for depth in (N_LAYER, 1):
        for rev in ("", " reverse"):
            for path in ("scan", "plain"):
                runs[f"{path}{rev} x{depth}"] = dict(
                    use_pallas_scan=path == "scan", n_layer=depth,
                    reverse_scan_kernel=bool(rev))
            checks.append((f"scan{rev} x{depth}", f"plain{rev} x{depth}",
                           LOGIT_TOL if depth == 1 else
                           lambda lg: MAMBA_LOGIT_RTOL * lg[
                               f"plain x{N_LAYER}"].abs().max().item()))
    checks.insert(0, (f"plain reverse x{N_LAYER}", f"plain x{N_LAYER}",
                      float("inf")))
    phase_slice(card, "mamba", mambafuser_config(),
                {ss.KERNEL: sum(SCAN_LAUNCHES.values()), fa.KERNEL: 0},
                runs, checks)
    train, init, batch = phase_train(
        card, "train", gpt_transfuser_config(),
        {fa.KERNEL: 4 * N_LAYER, fa.KERNEL_MERGED: 4 * N_LAYER})
    phase_train_f32(init, batch)
    del init, batch
    # the split pair's main path: the same training step through it
    train_split = phase_train_split(card, train)
    # this slice's main path: 67 forward and 67 backward scans a step
    n_scan = sum(SCAN_LAUNCHES.values())
    mtrain, init, batch = phase_train(
        card, "mamba train", mambafuser_config(),
        {ss.KERNEL: n_scan, ss.KERNEL_BWD: n_scan})
    phase_train_mamba_f32(init, batch)
    del init, batch
    # the train CLI, MambaFuser then GPT TransFuser
    cli = phase_cli(card)
    # this slice's main path: the train CLI through the memmap cache, the
    # native loader and the tools that train through them
    cache = phase_cache(card, cli)
    # this slice's main paths: the serve CLI on trained and reference
    # checkpoints, and the 30-to-5 variant served and trained
    serve_result = phase_serve(card, {
        "gpt": (gpt_transfuser_config(), {fa.KERNEL: 4 * N_LAYER,
                                          ss.KERNEL: 0}),
        "mamba": (mambafuser_config(), {ss.KERNEL: sum(
            SCAN_LAUNCHES.values()), fa.KERNEL: 0})})
    # this slice's main path: the serving artifact, exported and served
    # in a fresh process
    export = phase_export(card)
    cfg30 = {name: make(seq_len=ref30.seq_len, pred_len=ref30.pred_len)
             for name, make in (("gpt", gpt_transfuser_config),
                                ("mamba", mambafuser_config))}
    k30 = phase_kernels_30to5(sfu_rate, cfg30["mamba"].n_tokens,
                              scan_launches(cfg30["mamba"]))
    v30 = phase_30to5(card, cfg30["gpt"], cfg30["mamba"])
    # this slice's main path: the modality-rebuild subsystem (the trainer's
    # steps through the fusion model in eval mode, the rebuild CLI, VFA)
    reb = phase_rebuild(card)
    # this slice's main paths: the tools (bench_serve, profile_step,
    # bench_matrix), the offline data path with a training epoch on the
    # tree it wrote, and the quickstart
    tools = phase_tools(card)
    prep = phase_preprocess(card)
    quick = phase_quickstart(card)
    # this slice's main paths: serving over a mesh, the train step over a
    # process group, and the train CLI under torch.distributed.run
    dp = phase_dp(card)

    # Per forward of the serving path at batch 8 in bf16: the flash kernel's
    # 8 launches at each of the four stage shapes (dropout 0); the scan's 16
    # launches at each stage's d_inner (L = 962) and 3 in the TimeMamba head
    # (L = 5), forward direction (reverse_scan_kernel off).
    serve_fwd = [r for r in flash_rows
                 if r["dtype"] == "bfloat16" and r["p"] == 0.0]
    print("flash forward per serving forward (dropout 0): " + json.dumps(
        {"launches": gpt[fa.KERNEL],
         **{k: summed(serve_fwd, k)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                      "exp_sfu_ms")},
         "batch1_ms": N_LAYER * sum(batch1.values())}))
    # The scan kernels at batch 8 in bf16: per serving forward or training
    # step, 16 launches at each stage's d_inner (L = 962) and 3 in the
    # TimeMamba head (L = 5) with reverse_scan_kernel off, the forward (#6)
    # and the backward (#9) alike; with it on, the 8 backward branches of
    # each stage run the reverse kernels (#7, #10) instead.  Bounds: the
    # larger of bytes and f32 operations at each shape.
    def scan_rows_by_shape(rows, reverse):
        return {(r["L"], r["d"]): r for r in rows
                if r["dtype"] == "bfloat16" and r["reverse"] == reverse
                and not r.get("groups") and (not reverse or r["L"] == TOKENS)}

    scan_main, scan_rev = (scan_rows_by_shape(scan_rows, rev)
                           for rev in (False, True))
    bwd_main, bwd_rev = (scan_rows_by_shape(scan_bwd_rows, rev)
                         for rev in (False, True))
    rev_n = {shape: N_LAYER for shape in scan_rev}
    scan_sums = {}
    for label, rows, n in (("scan forward per forward", scan_main,
                            SCAN_LAUNCHES),
                           ("scan reverse per forward (reverse_scan_kernel)",
                            scan_rev, rev_n),
                           ("scan backward per training step", bwd_main,
                            SCAN_LAUNCHES),
                           ("scan backward reverse per training step "
                            "(reverse_scan_kernel)", bwd_rev, rev_n)):
        keys = ["ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
                "exp_sfu_ms", "exps"] + (["kernel_ms", "partials_ms"]
                                         if rows is bwd_main
                                         or rows is bwd_rev else [])
        scan_sums[label] = {"launches": sum(n.values()),
                            **{k: per_forward(rows, n, k) for k in keys}}
        print(f"{label}: " + json.dumps(scan_sums[label]))

    # Per training step at batch 8 in bf16, dropout 0.1: 8 launches at each
    # stage shape.  The default step runs the merged backward; the split
    # pair (dq + dkv) runs on the train split leg (DEEPSENSE_FLASH_BWD=
    # split), 32 launches of each kernel a step.  The plain backward and
    # SDPA's backward (dropout 0) compute dq, dk and dv together.
    fwd = [r for r in flash_rows
           if r["dtype"] == "bfloat16" and r["p"] == DROP_P]
    bwd = [r for r in bwd_rows
           if r["dtype"] == "bfloat16" and r["p"] == DROP_P]
    sdpa_bwd = summed([r for r in bwd_rows if r["dtype"] == "bfloat16"
                       and r["p"] == 0.0], "library_ms")
    steps = train["launches_per_step"]
    split_steps = train_split["launches_per_step"]

    def split_pair(rows, sdpa):
        """The split pair against the merged kernel and SDPA's backward,
        per training step (rows at one dropout p)."""
        pair = summed(rows, "dq_ms") + summed(rows, "dkv_ms")
        return {"merged_ms": summed(rows, "ms"),
                "split_ms": summed(rows, "split_ms"),
                "dq_ms": summed(rows, "dq_ms"),
                "dkv_ms": summed(rows, "dkv_ms"), "pair_ms": pair,
                "pair_vs_merged": pair / summed(rows, "ms"),
                "pair_vs_sdpa_bwd": pair / sdpa if sdpa else None,
                "dq_bound_ms": summed(rows, "dq_bound_ms"),
                "dkv_bound_ms": summed(rows, "dkv_bound_ms"),
                "split_flops_ms": summed(rows, "split_flops_ms")}

    print("flash backward per training step: " + json.dumps(
        {**split_pair(bwd, None), "plain_ms": summed(bwd, "plain_ms"),
         "sdpa_bwd_ms": sdpa_bwd, "bound_ms": summed(bwd, "bound_ms"),
         "exp_sfu_ms": summed(bwd, "exp_sfu_ms")}))
    # after every traced phase: the parent's kernels load beside this
    # checkout's
    parent = phase_flash_parent(args.parent)
    scan_parent = phase_scan_parent(args.parent)
    # per training step at dropout 0 too: the kernels against SDPA
    fwd0, bwd0 = ([r for r in rows if r["dtype"] == "bfloat16"
                   and r["p"] == 0.0] for rows in (flash_rows, bwd_rows))
    print("flash per training step, dropout 0: " + json.dumps(
        {"fwd_ms": summed(fwd0, "ms"), "sdpa_ms": summed(fwd0, "library_ms"),
         "merged_ms": summed(bwd0, "ms"), "sdpa_bwd_ms": sdpa_bwd,
         "fwd_bound_ms": summed(fwd0, "bound_ms"),
         "bwd_bound_ms": summed(bwd0, "bound_ms"),
         "exp_sfu_ms": summed(fwd0, "exp_sfu_ms"),
         "split": split_pair(bwd0, sdpa_bwd)}))

    def cli_launches(name):
        """A train step's launches on the train CLI's path (cli phase)."""
        return (cli["mamba"]["launches_per_step"].get(name, 0)
                + cli["gpt"]["launches_per_step"].get(name, 0))

    def cache_launches(name):
        """A train step's launches on the cached train CLI's path (cache
        phase)."""
        return cache["build"]["launches_per_step"].get(name, 0)

    def launches_30to5(name):
        """Launches per forward or step on the 30-to-5 path (30to5 phase):
        GPT serving forward and training step, MambaFuser serving forward
        and training step."""
        return {leg: (v30[leg] if "serve" in leg
                      else v30[leg]["launches_per_step"]).get(name, 0)
                for leg in ("gpt_serve", "gpt_train", "mamba_serve",
                            "mamba_train")}

    def launches_rebuild(name):
        """Launches per step or call on the rebuild path (rebuild phase):
        the MambaFuser rebuild step, eval step and tap, the GPT rebuild
        step, the rebuild CLI's train step."""
        return {"mamba_step": reb["mamba"]["launches_per_step"].get(name, 0),
                "mamba_eval": reb["mamba"]["launches_per_eval"].get(name, 0),
                "tap": reb["mamba"]["tap_launches"].get(name, 0),
                "gpt_step": reb["gpt"]["launches_per_step"].get(name, 0),
                "cli_step": reb["cli"]["launches_per_step"].get(name, 0)}

    def launches_tools_data(name):
        """Launches a step on the tools and data paths: the profiled GPT
        and MambaFuser steps (tools phase), the train step on the
        preprocessed tree (preprocess phase), the quickstart's."""
        return {"profile_step_gpt": tools["gpt"]["profile"][
                    "launches_per_step"].get(name, 0),
                "profile_step_mamba": tools["mamba"]["profile"][
                    "launches_per_step"].get(name, 0),
                "preprocess_train": prep["train"][
                    "launches_per_step"].get(name, 0),
                "quickstart": quick["launches_per_step"].get(name, 0)}

    def launches_dp(name):
        """Launches a replica a request, or a rank a step, on the dp
        phase's legs: serving over the mesh (MambaFuser and GPT
        TransFuser), the bf16 train leg, the train CLI's GPT TransFuser
        at --n_layer 2 under torch.distributed.run, the bf16 rebuild leg
        and the rebuild CLI's MambaFuser at --n_layer 2."""
        return {"serve_mamba": dp["serve"]["mamba"][
                    "launches_per_replica"].get(name, 0),
                "serve_gpt": dp["serve"]["gpt"][
                    "launches_per_replica"].get(name, 0),
                "train": dp["train"]["launches_per_rank_step"].get(name, 0),
                "cli": dp["cli"]["launches_per_rank_step"].get(name, 0),
                "rebuild": dp["rebuild"]["launches_per_rank_step"].get(
                    name, 0),
                "rebuild_cli": dp["rebuild_cli"][
                    "launches_per_rank_step"].get(name, 0)}

    def launches_export(name):
        """Launches a forward of the exported serving artifacts, GPT
        TransFuser and MambaFuser (export phase)."""
        return {m: export[m]["launches"].get(name, 0)
                for m in ("gpt", "mamba")}

    def at_30to5(rows, n, p=None):
        """The 30-to-5 rows' sums: per training step (``p`` = DROP_P) or
        serving forward (``p`` = 0) for the flash rows, 8 launches at each
        head dim; per forward or step for the scan rows (``n`` launches at
        each shape)."""
        if isinstance(rows, dict):
            pick = rows.values()
            weight = lambda r: n[(r["L"], r["d"])]  # noqa: E731
        else:
            pick = [r for r in rows if r["p"] == p]
            weight = lambda r: N_LAYER  # noqa: E731
        pick = list(pick)
        out = {k: sum(weight(r) * r[k] for r in pick)
               for k in ("ms", "plain_ms", "bound_ms", "exp_sfu_ms")}
        libs = [r["library_ms"] for r in (rows if isinstance(rows, list)
                                          else pick) if r.get("library_ms")]
        out["library_ms"] = (N_LAYER * sum(libs) if libs else None)
        out["bound_by"] = bound_by(pick)
        out["max_abs_err"] = max(r["max_abs_err"] for r in pick)
        out["tokens"] = v30["tokens"]
        return out

    def split_30to5(name, pick_err):
        """Kernel ``name`` ("dq" or "dkv") of the split pair per 30-to-5
        GPT training step (p = DROP_P, 8 launches at each head dim); the
        plain time is the whole plain backward's."""
        rows = [r for r in k30["bwd"] if r["p"] == DROP_P]
        return {"ms": summed(rows, f"{name}_ms"),
                "split_ms": summed(rows, "split_ms"),
                "plain_ms": summed(rows, "plain_ms"),
                "bound_ms": summed(rows, f"{name}_bound_ms"),
                "bound_by": bound_by(rows, f"{name}_bound_by"),
                "library_ms": None,
                "max_abs_err": max(pick_err(r["split_err"]) for r in rows),
                "tokens": v30["tokens"]}

    def entry(name, source, replaces, ms, bound, by, plain, library, err,
              launches=None, **extra):
        """A kernel's row; ``launches`` a training step's (default: the
        merged leg's)."""
        return {"name": name, "route": "cuda",
                "source": f"deepsense6g_tii_tpu_torch/csrc/{source}",
                "replaces": f"deepsense6g_tii_tpu/ops/{replaces}",
                "launches": (steps.get(name, 0) if launches is None
                             else launches),
                "cli_launches_per_step": cli_launches(name),
                "cache_launches_per_step": cache_launches(name),
                "launches_30to5": launches_30to5(name),
                "launches_rebuild": launches_rebuild(name),
                "launches_tools_data": launches_tools_data(name),
                "launches_export": launches_export(name),
                "launches_dp": launches_dp(name),
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": library,
                **extra}

    def vs_parent(m):
        """The kernel's per-step ms, parent and change, from --parent."""
        if parent is None:
            return {"parent_ms": None, "vs_parent": None}
        return {"parent_ms": parent["parent"][f"p={DROP_P}"][m],
                "vs_parent": {key: {"parent_ms": parent["parent"][key][m],
                                    "ms": parent["change"][key][m]}
                              for key in parent["change"]}}

    kernels = [
        entry(fa.KERNEL, "flash_attention_fwd.cu", "flash_attention.py:160",
              summed(fwd, "ms"), summed(fwd, "bound_ms"), bound_by(fwd),
              summed(fwd, "plain_ms"), summed(fwd, "library_ms"),
              max(r["max_abs_err"] for r in fwd),
              exp_sfu_ms=summed(fwd, "exp_sfu_ms"), **vs_parent("fwd_ms"),
              per_step_30to5=at_30to5(k30["fwd"], None, DROP_P),
              per_serving_forward_30to5=at_30to5(k30["fwd"], None, 0.0)),
        entry(fa.KERNEL_MASK, "flash_dropout_mask.cu",
              "flash_attention.py:615", mask_row["ms"],
              mask_row["bound_ms"], "bytes", mask_row["plain_ms"], None, 0.0),
        entry(fa.KERNEL_MERGED, "flash_attention_bwd.cu",
              "flash_attention.py:344", summed(bwd, "ms"),
              summed(bwd, "bound_ms"), bound_by(bwd), summed(bwd, "plain_ms"),
              sdpa_bwd, max(r["max_abs_err"] for r in bwd),
              exp_sfu_ms=summed(bwd, "exp_sfu_ms"), **vs_parent("bwd_ms"),
              per_step_30to5=at_30to5(k30["bwd"], None, DROP_P)),
        # the split pair: launches a step of the train split leg
        entry(fa.KERNEL_DQ, "flash_attention_bwd.cu",
              "flash_attention.py:265", summed(bwd, "dq_ms"),
              summed(bwd, "dq_bound_ms"), bound_by(bwd, "dq_bound_by"),
              summed(bwd, "plain_ms"), None,
              max(r["err"]["split"][0] for r in bwd),
              launches=split_steps.get(fa.KERNEL_DQ, 0),
              exp_sfu_ms=summed(bwd, "exp_sfu_ms"), **vs_parent("dq_ms"),
              per_step_30to5=split_30to5("dq", lambda e: e[0])),
        entry(fa.KERNEL_DKV, "flash_attention_bwd.cu",
              "flash_attention.py:297", summed(bwd, "dkv_ms"),
              summed(bwd, "dkv_bound_ms"), bound_by(bwd, "dkv_bound_by"),
              summed(bwd, "plain_ms"), None,
              max(max(r["err"]["split"][1:]) for r in bwd),
              launches=split_steps.get(fa.KERNEL_DKV, 0),
              exp_sfu_ms=summed(bwd, "exp_sfu_ms"), **vs_parent("dkv_ms"),
              per_step_30to5=split_30to5("dkv", lambda e: max(e[1:]))),
    ]
    msteps = mtrain["launches_per_step"]

    def scan_vs_parent(keys):
        """The scan rows' per-step ms, parent and change, from --parent:
        the first key is the row's own measure."""
        if scan_parent is None:
            return {"parent_ms": None, "vs_parent": None}
        return {"parent_ms": scan_parent["parent"][keys[0]],
                "vs_parent": {k: {"parent_ms": scan_parent["parent"][k],
                                  "ms": scan_parent["change"][k]}
                              for k in keys}}

    scan_parent_keys = {
        ss.KERNEL: ("fwd_per_serving_forward_b8_ms",
                    "fwd_per_serving_forward_b1_ms",
                    "fwd_h_in_per_mamba_step_ms"),
        ss.KERNEL_BWD: ("bwd_per_mamba_step_ms",)}
    for name, line, rows, n in (
            (ss.KERNEL, 206, scan_main, SCAN_LAUNCHES),
            (ss.KERNEL_REV, 234, scan_rev, rev_n),
            (ss.KERNEL_BWD, 354, bwd_main, SCAN_LAUNCHES),
            (ss.KERNEL_BWD_REV, 449, bwd_rev, rev_n)):
        source = "fwd" if name in (ss.KERNEL, ss.KERNEL_REV) else "bwd"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepsense6g_tii_tpu_torch/csrc/selective_scan_"
                      f"{source}.cu",
            "replaces": f"deepsense6g_tii_tpu/ops/selective_scan.py:{line}",
            "launches": msteps.get(name, 0),
            "cli_launches_per_step": cli_launches(name),
            "cache_launches_per_step": cache_launches(name),
            "launches_30to5": launches_30to5(name),
            "launches_rebuild": launches_rebuild(name),
            "launches_tools_data": launches_tools_data(name),
            "launches_export": launches_export(name),
            "launches_dp": launches_dp(name),
            **({f"per_{'forward' if name == ss.KERNEL else 'step'}_30to5":
                at_30to5(k30["scan_fwd" if name == ss.KERNEL
                             else "scan_bwd"], v30["scan_shapes"])}
               if name in (ss.KERNEL, ss.KERNEL_BWD) else {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": per_forward(rows, n, "ms"),
            "plain_ms": per_forward(rows, n, "plain_ms"),
            "bound_ms": per_forward(rows, n, "bound_ms"),
            "bound_by": ("bytes" if per_forward(rows, n, "bytes_ms")
                         >= per_forward(rows, n, "ops_ms")
                         else "operations"),
            "library_ms": None,
            "exp_sfu_ms": per_forward(rows, n, "exp_sfu_ms"),
            "kernels_per_call": {f"L={L} d={d}": r["kernels_per_call"]
                                 for (L, d), r in rows.items()},
            **(scan_vs_parent(scan_parent_keys[name])
               if name in scan_parent_keys else {})})
    # #8 per serving forward, had the fusion stages and TimeMamba run the
    # sequential variant (the shapes and launches of #6), at batch 8 and,
    # beside it, batch 1 (#6 beside each, timed in the same phase); #11 one
    # launch at each chain length, mul and exp.  Their launches are the
    # roofline tool's, the path that runs them.
    seq_main, seq_b1 = ({(r["L"], r["d"]): r for r in seq_rows
                         if r["dtype"] == "bfloat16" and not r["groups"]
                         and r["batch"] == b} for b in (BATCH, 1))
    seq_keys = ("ms", "chunked_ms", "plain_ms", "bound_ms", "exp_sfu_ms")
    kernels.append({
        "name": ss.KERNEL_SEQ, "route": "cuda",
        "source": "deepsense6g_tii_tpu_torch/csrc/selective_scan_seq.cu",
        "replaces": "deepsense6g_tii_tpu/ops/selective_scan.py:268",
        "launches": roofline_launches.get(ss.KERNEL_SEQ, 0),
        "cli_launches_per_step": cli_launches(ss.KERNEL_SEQ),
        "cache_launches_per_step": cache_launches(ss.KERNEL_SEQ),
        "launches_30to5": launches_30to5(ss.KERNEL_SEQ),
        "launches_rebuild": launches_rebuild(ss.KERNEL_SEQ),
        "launches_tools_data": launches_tools_data(ss.KERNEL_SEQ),
        "launches_export": launches_export(ss.KERNEL_SEQ),
        "launches_dp": launches_dp(ss.KERNEL_SEQ),
        "max_abs_err": max(r["max_abs_err"] for r in seq_rows),
        **{k: per_forward(seq_main, SCAN_LAUNCHES, k)
           for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": ("bytes" if per_forward(seq_main, SCAN_LAUNCHES,
                                            "bytes_ms")
                     >= per_forward(seq_main, SCAN_LAUNCHES, "ops_ms")
                     else "operations"),
        "library_ms": None,
        **{k: per_forward(seq_main, SCAN_LAUNCHES, k)
           for k in ("chunked_ms", "exp_sfu_ms")},
        "batch1": {k: per_forward(seq_b1, SCAN_LAUNCHES, k)
                   for k in seq_keys},
        "split": {f"b={r['batch']} L={r['L']} d={r['d']}": r["split"]
                  for r in seq_rows
                  if r["dtype"] == "bfloat16" and not r["groups"]},
        **scan_vs_parent(("seq_per_serving_forward_b8_ms",
                          "seq_per_serving_forward_b1_ms",
                          "fwd_per_serving_forward_b8_ms",
                          "fwd_per_serving_forward_b1_ms"))})
    print("sequential scan per serving forward: " + json.dumps(
        {f"b={b}": {k: per_forward(rows, SCAN_LAUNCHES, k) for k in seq_keys}
         for b, rows in ((BATCH, seq_main), (1, seq_b1))}))
    from deepsense6g_tii_tpu_torch.tools import scan_roofline as sr
    kernels.append({
        "name": sr.KERNEL_CHAIN, "route": "cuda",
        "source": "deepsense6g_tii_tpu_torch/csrc/scan_roofline_chain.cu",
        "replaces": "tools/scan_roofline.py:82",
        "launches": roofline_launches.get(sr.KERNEL_CHAIN, 0),
        "cli_launches_per_step": cli_launches(sr.KERNEL_CHAIN),
        "cache_launches_per_step": cache_launches(sr.KERNEL_CHAIN),
        "launches_30to5": launches_30to5(sr.KERNEL_CHAIN),
        "launches_rebuild": launches_rebuild(sr.KERNEL_CHAIN),
        "launches_tools_data": launches_tools_data(sr.KERNEL_CHAIN),
        "launches_export": launches_export(sr.KERNEL_CHAIN),
        "launches_dp": launches_dp(sr.KERNEL_CHAIN),
        "max_abs_err": max(r["max_abs_err"] for r in chain_rows),
        **{k: sum(r[k] for r in chain_rows)
           for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": ("bytes" if sum(r["bytes_ms"] for r in chain_rows)
                     >= sum(r["ops_ms"] for r in chain_rows)
                     else "operations"),
        "library_ms": None})
    print(f"chip_smoke on {card}: {time.perf_counter() - t_start:.1f} s; "
          "seconds a phase: " + json.dumps(
              {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    print(json.dumps({"kernels": kernels}))
    print_ok()
    return 0


def print_ok():
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
