#!/usr/bin/env python3
"""Chip smoke test of cmx_torch, the PyTorch/CUDA port of cmx, on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  0. build every CUDA kernel of the port from cmx_torch/csrc (nvcc, sm_90a,
     one process per source, in parallel); ptxas registers and spills of
     each kernel, every kernel's SASS digest (_build.sass_digests: equal
     digests, equal machine code), and the tensor-core instructions
     (HMMA/HGMMA) that cuobjdump --dump-sass finds in K1's and K7's conv and
     in K2's and K8's dX and dW kernels (fails if one has none); the
     registers and spills of K3's (forward and backward), K4's and K6's
     kernels by name, and K6's grid (one wave of its resident blocks).
SparK (task.name=spark, model.fused_conv=True, task.pallas_loss=True, full
widths, 256^2, bf16, batch 32, LAMB lr 2e-4 wd 0.04 clip 5), as the CLI
builds it:
  1. one step with the kernel wrappers recording their calls
     (cmx_torch.ops._build.recorded); every recorded call replayed through
     its public wrapper and through its plain PyTorch version on the same
     operands: error and tolerance, kernel / plain / library time (CUDA
     events), and the least time the card could take for the same work
     (bound); K1's and K2's times by call, the stem (Cin = 1) apart; K3's
     forward (the loss to rel 1e-5, and a second launch's bits equal to the
     first's) and its backward (drec within one ulp of rec's dtype at its
     largest entry, eight in fp32) with their kernels' registers and
     spills, each also profiled on the device beside its plain version;
  2. the main path: launch counters zeroed, SPARK_STEPS steps, every
     kernel's count checked against the recorded calls per step (K4 none),
     finite loss and grad norm, step time; a torch.profiler window of two
     steps (device time by kernel, the device's busy share, the port's
     kernels against everything else and each of them, the device time
     inside the fused DoubleConv's autograd ranges, and the kernels inside
     SparkLoss's: K3's two alone, one launch each way); then the same
     step with model.fused_conv=False task.pallas_loss=False (no kernel of
     the port), timed and profiled the same way;
  3. the fused step against the unfused plain-PyTorch model from the same
     weights and draws (loss and BN running stats within bf16 margins).
  BNV. the BatchNorm moment variants (CMX_BN_VARIANT, read at call time
     from cmx_torch.models.blocks.BN_VARIANT): for shift_ra, shift_max,
     two_pass and naive, the global set before the step is built, phase 2's
     step from the same weights, images and draws: one recorded step whose
     kernel calls must equal phase 1's (K1 4, K2 4, K3 1 + 1) and whose
     norms in the fused stages (down1, down2) take no moment in PyTorch; its
     first loss within 2e-2 of phase 1's; every unfused BN moment of that
     step in a stage of BNV_MAX_HW^2 or less, and every densify norm's,
     held against a float64 two-pass of the same activations (the largest
     relative var error printed); then the step as GRAPH runs it
     (`graph_case`: eager and graph step time, every tensor bit for bit,
     the capture's calls an eager step's; the capture fails on a host
     sync, so shift_max's max and two_pass's second pass make none).
The same SparK step with cmx_torch.ops.fused_conv.FUSED_IMPL="nhwc" (the
NHWC strip kernels K6-K8 in place of K1/K2):
  A. one step recorded: exactly K6 1, K7 3, K8 3, K3 1 + 1 backward calls,
     its loss
     within 1e-3 of the flat step's recorded first step (same weights,
     images and draws); every call replayed as in phase 1, the library
     yardsticks F.conv2d bf16 (K6 on the (B,1,H,W) image, K7 channels_last)
     and aten.convolution_backward bf16 channels_last (K8);
  K5. bn_relu_mask_pallas (no caller on any path) driven once on the
     operands of the recorded pre-norm K7 call at down1 (src, inv, shift,
     mask), held to its plain version, timed, library null;
  B. counters zeroed, SPARK_STEPS steps, launches K6 1, K7 3, K8 3, K3 1 +
     1 backward a step and K1, K2, K4, K5 none, finite, step time and img/s
     beside the
     flat fused and unfused steps, a two-step profile;
  the NHWC model against the plain model as in phase 3.
MoCo v2 (PRESETS["moco"] + task.crop_impl=pallas: full widths, 256^2 images,
224^2 views, bf16, batch MOCO_BATCH, SGD lr 0.03 momentum 0.9 wd 1e-4,
queue 65536 x 1024, T 0.07):
  4. one step recorded; its two K4 calls (q and k views) replayed through
     the wrapper, the plain version and the library yardstick (two torch.bmm
     on precomputed weights); K4's bound from the pixels inside the calls'
     windows and the non-zero taps of their weights (roofline.crop_work),
     and the widths of the bands the kernel sums over
     (pallas_crop.crop_bands);
  5. the main path: counters zeroed, MOCO_STEPS steps, each
     synchronize-bounded and checked (finite loss and grad norm, acc1/acc5
     in [0, 1], queue_ptr advanced by B mod K, the key encoder equal to the
     EMA of itself and the updated online encoder, and moved toward it),
     K4 at 2 launches a step and K1-K3 at none; step time, img/s,
     peak memory, a two-step profile; then the same run with
     task.crop_impl=scale_translate (no kernel of the port) from the same
     weights, queue, images and draws, checked, timed and profiled the same
     way, its loss equal to the K4 run's step for step (bf16 margin).
MoCo's fast view pipeline (PRESETS["moco_fast"]: task.rotation_method
shear3, task.crop_impl bank_fused) and the view options, after the CLI
phase (MF-CLI reads its corpus):
  MF. PRESETS["moco_fast"] at MOCO_BATCH, full widths, 256^2 -> 224^2,
     bf16, from phase 5's weights, queue and images: one step recorded
     with no kernel of the port called, MOCO_STEPS steps checked as phase 5
     checks its steps, no launch; step time, img/s, peak memory, a two-step
     profile, beside phase 5's K4 step (moco + crop_impl=pallas) from this
     call; then LIB's profiling.trace of one MF step, its Chrome trace read
     back (fails without device kernels);
  VIEWS. the view pipeline alone at MOCO_BATCH for every rotation_method
     (nearest, shear3, bilinear) x crop_impl (scale_translate, pallas,
     einsum, einsum_bf16, bank, bank_fused), and CM-UNet's views (the chain,
     bank, bank_fused) at CM_BATCH, each timed by CUDA events; the first
     VIEW_CHECK images held against the CPU with the same draws: the
     rotation (nearest and shear3 at most PIXEL_SHARE of the pixels apart,
     an ulp of sin/cos can flip a rounding; bilinear within the bound of
     `bilinear_rot_tol`, derived from the images' neighbour steps and the
     shift an ulp of sin/cos gives its sample coordinates), then the
     CPU's crop, blur, flips and noise on the card's rotation (rel 1e-5,
     einsum_bf16 2e-2); each pallas view's whole batch held against the
     same view through the plain crop on the card (rel 1e-5); the bank rows
     fetched on the card equal the numpy bank bit for bit (linear 256 ->
     224, cubic 256 -> 256); K4 launched once by each pallas view, never by
     the others (those launches count in K4's row); each view timed
     VIEW_REPEATS times (median, min, max);
  CMB. CM1's step with task.crop_impl=bank_fused at CM_BATCH: 2 steps,
     finite losses, no kernel of the port launched;
  MF-CLI. `cmx_torch.cli.pretrain.main` with --task moco_fast --preset, one
     epoch at batch CM_CLI_BATCH on the CLI phase's corpus, with validation
     (`one_epoch_cli`): no launch, log.jsonl finite, encoder.npz reloaded
     bit for bit, its seconds. `python3 chip_smoke.py --views` builds the
     kernels and runs MF (timing phase 5's K4 step itself), VIEWS, CMB and
     MF-CLI (on a corpus of its own) alone;
  LIB. every op of cmx_torch.ops.augment_extra and auto_augment (the
     fourteen ops through apply_op at level 7, auto_augment, rand_augment)
     at MOCO_BATCH of 256^2 with draws made on the card, timed, its first
     LIB_CHECK images against the CPU with the same draws (rel 1e-5; the
     nearest geometric ops and the policies by the share of pixels apart,
     PIXEL_SHARE); s2d's phase_conv5 against F.conv2d at S2D_SHAPE (fp32,
     rel S2D_TOL), both timed.
The pretrain CLI (FUSED_IMPL "flat"):
  CLI. `cmx_torch.cli.pretrain.main` run twice in this process, as a user
     runs it (`cli_phase`): SparK at full width through K1-K3 on a synthetic
     corpus read by the native loader into the device feed, with validation,
     2 epochs, then a call to 3 that resumes; launch counts, log.jsonl, the
     encoder.npz reloaded bit for bit, the stamp; each epoch's img/s. The
     corpus and the exported encoder.npz stay for FT-CLI.
The supervised fine-tune (the UNet with model.fused_conv=True, its decoder
fused as cmx's, FUSED_IMPL "flat": K1/K2 at down1, down2 and up1; the
Dice+CE loss, the fine-tune augmentation on the device, Adam lr 1e-3, as
cmx_torch.cli.finetune builds them; full widths, 256^2, bf16, batch 32,
random images and one-hot masks from a seed):
  FT1. one step recorded; every K1/K2 call replayed as in phase 1 (up1's
     128 -> 64 and 64 -> 64 pre-norm stages with dX, and down1/down2 with
     an all-ones mask: the fine-tune path's new shapes); counters zeroed,
     SPARK_STEPS steps with launches equal to the recorded calls, finite
     loss and grad norm, step time and img/s, a two-step profile; then the
     same step with model.fused_conv=False (no kernel of the port), timed
     and profiled the same way; the fused model against the plain one from
     the same weights and draws (loss and BN running stats within phase 3's
     bf16 margins);
  FT-NHWC. one step recorded with FUSED_IMPL="nhwc" (K6 1, K7 5, K8 5), its
     loss within 1e-3 of FT1's recorded step, K7's and K8's up1 calls (Cin
     128 -> 64 and 64 -> 64, 256^2) replayed against their plain versions;
     FUSED_IMPL set back to "flat";
  FT-CLI. `cmx_torch.cli.finetune.main` in this process on the card
     (`finetune_cli_phase`): the CLI phase's encoder.npz and corpus,
     data.ratio=0.3 (29 fine-tune images, 20 test), model.fused_conv=True,
     --lrs 1e-3 --epochs 2 --batches 8: the encoder loaded bit for bit,
     finite train and valid logs in every fold and the final fit, K1/K2
     launches equal to FT1's per-step calls times the training steps (the
     frozen-BN evaluations add none), test_<tag>.json with a finite dice.
  FT-HOST. `cmx_torch.train.harness.fit` with host_metrics_every=1 (cmx's
     host loop: eager steps, `evaluate` with the host metrics each epoch)
     on the fused bf16 UNet (as FT-DP builds it), FT_HOST_EPOCHS epochs at
     batch FT_CLI_BATCH over FT-CLI's fine-tune set less FT_HOST_VALID
     validation images: K1/K2 launches = FT1's per-step calls x the steps,
     finite logs with hausdorff and radius_arteries; then the same fit
     with NaN validation images and masks (no epoch's dice_loss below inf):
     a finite state that moved from the initial one (cmx's host loop keeps
     the last epoch's). Both fits timed.
CM-UNet pretraining (PRESETS["cmunet"]: full widths, 256^2 images, 224^2
views, bf16, AdamW at lr 1.5e-4 * batch/256 on the preset's warm-up, wd
0.05, clip 5, mask 0.65, T 0.07, EMA 0.996; cmx builds it unfused, so it
runs no kernel of the port) and MAE (PRESETS["mae"] with
model.fused_conv=True: the UNet(out_classes=1) through K1/K2 at down1,
down2 and up1, SGD lr 1e-2 momentum 0.9, mask 0.5, 256^2, bf16):
  CM1. counters zeroed, SPARK_STEPS steps at batch CM_BATCH (random images,
     the target and reduce kernel from seed 0), each synchronize-bounded
     and checked (finite loss, loss_ct, loss_rc and grad norm; a leaf of the
     target's encoder and one of its projector equal m * old + (1 - m) *
     the updated online leaf; the reduce kernel unchanged bit for bit);
     then the target's BN running stats moved, no kernel of the port
     launched, step time, img/s, peak memory, a two-step profile.
     `python3 chip_smoke.py --cm1-batch N` builds nothing and runs CM1 alone
     at batch N (the batch-128 attempt: its peak, or the out-of-memory
     error);
  MAE1. at batch MAE_BATCH: one step recorded (K1 6, K2 6) and every call
     replayed as in phase 1; counters zeroed, SPARK_STEPS steps with
     launches equal to the recorded calls, step time, a two-step profile;
     the unfused step timed and profiled the same way; the fused model
     against the plain one at batch 2 (phase 3's margins);
  CM-CLI. `cmx_torch.cli.pretrain.main` in this process on the CLI phase's
     corpus (`cm_cli_phase`): --task cmunet --preset at batch CM_CLI_BATCH
     with validation, 2 epochs, then a call to 3 that resumes (no kernel of
     the port launched; log.jsonl with finite losses; encoder.npz reloaded
     into a fresh UNet bit for bit); --task mae_tuned --preset with
     model.fused_conv=True for one epoch, K1/K2 launches equal to MAE1's
     per-step calls times its steps (K1 also for the validation forwards);
     then FT-CLI again from the CM-UNet encoder.npz: the paper's pipeline,
     CM-UNet then fine-tune, with its test Dice.
Model Genesis (PRESETS["genesis"] with model.fused_conv=True: the
UNet(out_classes=1) through K1/K2 at down1, down2 and up1, SGD lr 1e-2
momentum 0.9, the distortion chain of cmx_torch.ops.genesis on the card,
256^2, bf16) and the decoder variants:
  G1. at batch GENESIS_BATCH (the preset's): one step recorded (K1 6, K2 6)
     and every call replayed as in phase 1; counters zeroed, SPARK_STEPS
     steps with launches equal to the recorded calls, a two-step profile,
     peak memory; genesis_batch alone at the step's batch by CUDA events and
     by the profiler, with its share of the step, and once under
     torch.cuda.set_sync_debug_mode("error") (fails on any host
     synchronisation); the unfused step timed and profiled the same way;
     the fused model against the plain one at batch 2 from the same weights
     and injected draws (phase 3's margins);
  G-CLI. `cmx_torch.cli.pretrain.main` with --task genesis_tuned --preset
     model.fused_conv=True for one epoch on the CLI phase's corpus at batch
     CM_CLI_BATCH: K1 launches G1's per-step calls times (steps +
     validation batches), K2 times the steps; log.jsonl finite;
     encoder.npz reloaded into a fresh UNet bit for bit;
  DV. at batch DV_BATCH, each with a recorded step whose calls must equal
     the gate's prediction, SPARK_STEPS steps with launches equal to them,
     a two-step profile (with K3, its loss tail checked as in phase 2), and
     the fused model against the plain one at batch 2: SparK with
     task.full_unet=False (LightDecoder, decoder_width 768: K1 4, K2 4, K3
     1 + 1); SparKModel(fused=True, fused_decoder=True), built directly (K1
     6, K2 6, K3 1 + 1); the fine-tune UNet with up_sample_mode="bilinear"
     (K1 4, K2 4: up1's concat 128 + 64 fails the gate).
Selective rematerialization (model.remat) at bench.py's headline batch,
and the evaluate entry point (both on the CLI phase's corpus):
  RM. SparK (phase 2's step: flat fused, K3, LAMB) at RM_BATCH (128),
     256^2, bf16, with model.remat="" and with RM_LEVELS (e1,e2,d1,d2),
     from the same weights, images and step draws (`rm_pair`): each a
     recorded step whose calls must equal the prediction (K1 4, K2 4, K3
     1 + 1 without remat; K1 8 with it: down1 and down2 recomputed, SparK's
     up1/up2 unfused), SPARK_STEPS steps with launches checked, step time,
     img/s, peak memory, a two-step profile; the run without remat also
     replays every K1/K2/K3 call as in phase 1 (the batch-128 times). The
     remat run's first loss and every BN running statistic after its first
     step equal the run's without remat bit for bit, its grad norm within
     2e-2, its peak lower. The same for MAE1's model (PRESETS["mae"],
     fused; K1 6, K2 6 without remat, K1 12, K2 6 with: down1, down2 and
     up1 recomputed). A run without remat that does not fit at 128 is
     printed as the finding and both run at 64;
  RM-CLI. `cmx_torch.cli.pretrain.main` with --task mae_tuned --preset
     model.fused_conv=True model.remat=e1,e2,d1,d2 train.tensorboard=True,
     one epoch at batch CM_CLI_BATCH (`rm_cli_phase`): K1 = 12 x steps + 6
     x validation batches (validation recomputes nothing), K2 = 6 x steps;
     encoder.npz bit for bit; the CLI's TensorBoard line;
  EV. `cmx_torch.cli.evaluate.main` with the CLI phase's encoder.npz,
     --probe and --vis (`ev_phase`): finite metrics, probe accuracies in
     [0, 1], the visualization file, no kernel launched, its seconds;
     apis.inference_model on 4 images of 300^2: (4, 256, 256, 2)
     probabilities summing to 1 within 1e-5.
Data parallel (cmx_torch.parallel; the card machine has one card, so
nothing past world size 1 on NCCL is claimed):
  DP1. phase 2's step (SparK fused flat with K3, LAMB, batch BATCH, the
     same weights and images) under a real NCCL group of one process made
     by cmx_torch.parallel.dist from the launcher's variables: its first
     step bit for bit the step without a group (loss, grad norm, every
     parameter and BN buffer; both with cuDNN's deterministic algorithms),
     the collectives counted (all-reduces a step and their bytes; the
     gradients alone 4 bytes a parameter), launches K1 4, K2 4, K3 1 + 1 a
     step; SPARK_STEPS steps timed beside phase 2's;
  DP2. two spawned ranks of a gloo group on the one card
     (`--dp-rank R --dp-out PATH`, each with a timeout), each at DP2_BATCH
     against one process at 2 x DP2_BATCH from the same weights, images and
     draws: launches K1 4, K2 4, K3 1 + 1 a step on each rank, losses
     within 2e-2 and BN stats within 5e-2 (phase 3's bands), the ranks'
     states bit for bit equal; step time per rank (gloo stages every
     collective through the host: it shows the path runs, not its speed);
  DP-CLI. the pretrain CLI for one epoch on the CLI phase's corpus, in this
     process without a group and under `torchrun --standalone
     --nproc_per_node 1` (NCCL; `--cli-run` runs the CLI's main there; the
     launcher's variables set by hand where torchrun is missing), both with
     cuDNN's deterministic algorithms: encoder.npz bit for bit, the same
     losses. `python3 chip_smoke.py --dp` builds the kernels and runs the
     DP phases alone.
  FT-DP. the fine-tune harness and CLI under data parallel (`ftdp_phase`):
     (a) the fine-tune CLI for one epoch at batch FT_CLI_BATCH on FT-CLI's
     corpus and encoder.npz (model.fused_conv=True), in this process
     without a group and under `torchrun --standalone --nproc_per_node 1`
     (NCCL, world 1, the sub group of k = 1 the world; `--ft-cli-run` runs
     the CLI's main there), both with cuDNN's deterministic algorithms and
     through their graphs: test_<tag>.json and the grid pickle's logs bit
     for bit, the launcher's fits replayed from graphs that captured their
     all-reduces (the reports' `capture_collectives`), K1/K2 launches =
     eager calls + capture calls x replays = FT1's per-step calls x the
     steps; (b) two spawned gloo ranks on the one card (`--ftdp-rank R
     --dp-out PATH`) run `harness.fit` of the fused bf16 UNet at
     FTDP_BATCH (4 a rank, k = 2), FTDP_EPOCHS epochs over FTDP_IMAGES
     images with injected permutations, against one process at FTDP_BATCH
     from the same weights (its graph): every train loss within 2e-2
     relative and validation dice_loss within 2e-2 absolute (it is
     thresholded), the ranks' states bit for bit, K1 6 + K2 6
     launches a step on each rank, each rank printing that gloo ran its
     steps eagerly; then the gcd case at FTDP_GCD_BATCH (k = 1): rank 1
     launches nothing, both return rank 0's state bit for bit. Both parts
     timed (gloo goes through the host: the path runs, not NCCL's speed).
     `python3 chip_smoke.py --ftdp` builds the kernels and runs FT-DP
     alone (its own corpus, no encoder).
The train step captured once as a CUDA graph (cmx_torch.train.graph, the
counterpart of cmx's train.scan), with cuDNN's deterministic algorithms:
  GRAPH. for SparK at BATCH (flat fused, K3; and with FUSED_IMPL="nhwc",
     whose replays must launch K6 1, K7 3, K8 3, K3 1 + 1 a step by the
     profile's kernels, `nhwc_launches`), FT1 at BATCH, MAE1 at
     MAE_BATCH, G1 at GENESIS_BATCH, MoCo at MOCO_BATCH (crop_impl pallas,
     and PRESETS["moco_fast"]), CM1 at CM_BATCH and at 2 x CM_BATCH (the
     tightest fit on one card) and RM's SparK at RM_BATCH without remat,
     each from two states made from the same seeds
     (`graph_case`): GRAPH_STEPS eager steps on the first (its tensors
     kept, then two profiled steps; the state freed), then the same steps
     through a StepGraph on the second (a warm-up step, the capture, and
     GRAPH_STEPS - 1 replays), each step's rows gathered from one corpus by
     one permutation: every parameter, BN buffer, optimizer state, `extra`
     tensor and metric bit for bit; two profiled replays: the port's
     kernels by name (the profiler) equal to an eager step's, and the
     wrapper calls seen at the capture equal to an eager step's (a replay
     calls no wrapper); step time eager and with the graph (the last
     GRAPH_STEPS - 2 steps of each, back to back), busy shares, capture
     seconds, the pool and the peak memory (a profile window whose device
     time is under half of the step lost events and is taken again).
     `python3 chip_smoke.py --graph` builds the kernels and runs GRAPH
     alone; `python3 chip_smoke.py --bnv` builds them and runs BNV, FT-HOST
     (on a corpus of its own) and GRAPH's NHWC case alone.
  The CLI phases (CLI, FT-CLI, CM-CLI, G-CLI, RM-CLI, MF-CLI, DP-CLI) run
     the CLIs as a user does, so their steps replay a graph (the first
     step of each run eager, the second captured; each fine-tune fit has
     its own graph): their launch checks count each kernel as its
     wrapper's calls less each graph's capture calls plus those calls
     times the graph's replays (`graph_launches`, from the graphs'
     reports), and fail unless every graph captured exactly one step's
     calls and each run replayed all its steps but the first. The CLI
     phase runs with cuDNN's deterministic algorithms and adds the same
     2-epoch run with train.scan=False (every step eager): encoder.npz
     bit for bit and log.jsonl equal, both runs' epoch img/s.
  NORM. (after CM1; `python3 chip_smoke.py --norm` builds the kernels and
     runs it alone) one eager step of the programs of cmunet-b128 (CM-UNet
     at batch 128), moco-b256-graph (MoCo at batch 256), spark-b128-unfused
     and spark-b128-fused (SparK at batch 128, 256^2: the masked 256^2 rows
     and the fused path's channel-major densify norms), the norm kernels'
     calls recorded, the first of each signature replayed through
     its wrapper and its plain version (`norm_phase`): time, bytes bound,
     plain time, sums within rel 1e-5 of float64 sums of the same fp32
     terms and element-wise outputs bit for bit, and
     F.batch_norm's forward and backward beside the unmasked norms; each
     pass's ms a step. Phases that record a step keep the calls of K1-K8
     only (`KernelCalls`); `wrapper_calls` leaves the norms' counters out
     of the graphs' capture calls.
Then the K1-K8 bounds at the recorded shapes, and three lines: the kernels
as JSON (the SparK/MoCo paths' rows, as before, K4's launches counting
VIEWS' pallas views too, K1's and K2's launches
counting MAE1's, G1's, DV's and RM's 8-step runs too, K3's DV's and RM's;
K3's row sums its forward and backward, which it also lists under "parts"),
the card's name and power limit (nvidia-smi), and {"ok": true, "device":
{...}} last. K1-K3's launches there count DP1's 8 steps and DP2's 4 on
each rank too, K1/K2's FT-DP (b)'s fits on both ranks; each row's
"launches_in_replays" counts its kernel's launches inside graph replays
(GRAPH, the CLI phases, FT-CLI's fits and FT-DP (a)'s, the launcher's
included: each graph's capture calls times its replays).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BATCH = 32        # the SparK step's batch on one card
SPARK_STEPS = 8   # steps of a SparK run (the first two are warm-up)
MOCO_BATCH = 256  # the moco preset's batch
MOCO_STEPS = 8    # steps of a MoCo run (the first two are warm-up)
ITERS = 5         # timed launches per kernel measurement

# The tensor-core kernels behind K1, K2, K7 and K8
# (cmx_torch/csrc/conv3x3_mma.cuh), by wrapper: (library, kernel label as
# _build.kernel_label gives it).
TC_KERNELS = {
    "flat_conv3x3_mask_stats": [
        ("flat_conv_fwd", "cmx::flat_conv3x3_mma_kernel<true,true>"),
        ("flat_conv_fwd", "cmx::flat_conv3x3_mma_kernel<false,true>")],
    "flat_bwd_mega": [
        ("flat_conv_bwd", "cmx::flat_conv3x3_mma_kernel<false,false>"),
        ("flat_conv_bwd", "cmx::flat_dw_mma_kernel<true>"),
        ("flat_conv_bwd", "cmx::flat_dw_mma_kernel<false>")],
    "conv3x3_mask_stats": [("nhwc_conv_fwd", "cmx::conv3x3_mma_kernel<true,true>"),
                           ("nhwc_conv_fwd", "cmx::conv3x3_mma_kernel<false,true>")],
    "bwd_mega": [("nhwc_conv_bwd", "cmx::conv3x3_mma_kernel<false,false>"),
                 ("nhwc_conv_bwd", "cmx::conv3x3_dw_mma_kernel<true>"),
                 ("nhwc_conv_bwd", "cmx::conv3x3_dw_mma_kernel<false>")],
}
# label -> {"registers", "spill_stores", "spill_loads", "HMMA", "HGMMA"} of
# the TC_KERNELS, filled by phase 0.
TC_RESOURCES: dict = {}
# The CUDA-core kernels behind K3, K4 and K6, by wrapper, as TC_KERNELS
# (K3: the instances for bf16 rec, the main path's, and fp32 rec, with an
# fp32 active grid).
CORE_KERNELS = {
    "spark_loss_pallas": [
        ("spark_loss", "cmx::spark_loss_fwd_kernel<__nv_bfloat16,float>"),
        ("spark_loss", "cmx::spark_loss_fwd_kernel<float,float>")],
    "spark_loss_bwd": [
        ("spark_loss", "cmx::spark_loss_bwd_kernel<__nv_bfloat16,float>"),
        ("spark_loss", "cmx::spark_loss_bwd_kernel<float,float>")],
    "crop_resize_pallas": [("crop_resize", "cmx::crop_resize_kernel<false>"),
                           ("crop_resize", "cmx::crop_resize_kernel<true>")],
    "conv_stem_stats": [("nhwc_conv_fwd", "cmx::stem_kernel")],
}
# label -> {"registers", "spill_stores", "spill_loads"} of the CORE_KERNELS.
CORE_RESOURCES: dict = {}


def _k3_bwd_ulps():
    """K3 backward's tolerance against its plain version, in ulps of rec's
    dtype at the largest |drec|: one in bf16; eight in fp32 (the main path's
    rec: the decoder's head returns fp32), where the patch mean and variance,
    summed in another order, move norm by an ulp or two of its magnitude,
    more than one ulp of the largest |drec|."""
    import torch

    return {torch.bfloat16: 1, torch.float32: 8}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 8) -> tuple:
    """(device ms a call, device kernels a call) of fn from the profiler
    over `calls` calls after one warm-up call: each kernel's mean time times
    its launches a call (its count over `calls`, rounded, so that an event
    the profiler drops does not move the sum)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [(round(e.count / calls), e.self_device_time_total / e.count)
          for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    return sum(n * us for n, us in ks) / 1e3, sum(n for n, _ in ks)


def rel_err(a, b) -> tuple:
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / max(scale, 1e-12)


def kernels():
    """wrapper name -> (wrapper, plain version, route, source, TPU kernel).
    K3's backward (`spark_loss_bwd`) has an entry of its own for the replay
    and the launch counts; the kernels line folds it into K3's row."""
    from cmx_torch.ops import fused_conv as fc
    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.ops import pallas_crop as pc
    from cmx_torch.ops import pallas_ops as po

    return {
        "flat_conv3x3_mask_stats": (
            ff.flat_conv3x3_mask_stats, ff.flat_conv3x3_mask_stats_plain,
            "cuda", "cmx_torch/csrc/flat_conv_fwd.cu",
            "cmx/ops/fused_conv_flat.py:115"),
        "flat_bwd_mega": (
            ff.flat_bwd_mega, ff.flat_bwd_mega_plain, "cuda",
            "cmx_torch/csrc/flat_conv_bwd.cu",
            "cmx/ops/fused_conv_flat.py:271"),
        "spark_loss_pallas": (
            po.spark_loss_pallas, po.spark_loss_pallas_plain, "cuda",
            "cmx_torch/csrc/spark_loss.cu", "cmx/ops/pallas_ops.py:68"),
        "spark_loss_bwd": (
            po.spark_loss_bwd,
            lambda rec, imgs, act, g, denom, patch: po.spark_loss_bwd_plain(
                rec, imgs, act, g, patch),
            "cuda", "cmx_torch/csrc/spark_loss.cu",
            "cmx/ops/pallas_ops.py:137"),
        "crop_resize_pallas": (
            pc.crop_resize_pallas, pc.crop_resize_plain, "cuda",
            "cmx_torch/csrc/crop_resize.cu", "cmx/ops/pallas_crop.py:103"),
        "bn_relu_mask_pallas": (
            po.bn_relu_mask_pallas, po.bn_relu_mask_plain, "triton",
            "cmx_torch/ops/pallas_ops.py", "cmx/ops/pallas_ops.py:163"),
        "conv_stem_stats": (
            fc.conv_stem_stats, fc.conv_stem_stats_plain, "cuda",
            "cmx_torch/csrc/nhwc_conv_fwd.cu", "cmx/ops/fused_conv.py:110"),
        "conv3x3_mask_stats": (
            fc.conv3x3_mask_stats, fc.conv3x3_mask_stats_plain, "cuda",
            "cmx_torch/csrc/nhwc_conv_fwd.cu", "cmx/ops/fused_conv.py:239"),
        "bwd_mega": (
            fc.bwd_mega, fc.bwd_mega_plain, "cuda",
            "cmx_torch/csrc/nhwc_conv_bwd.cu", "cmx/ops/fused_conv.py:354"),
    }


def make_cfg(batch: int, fused: bool = True):
    from cmx_torch.config.config import Config, apply_overrides

    cfg = Config()
    apply_overrides(cfg, [
        "task.name=spark", f"model.fused_conv={fused}",
        f"task.pallas_loss={fused}", "data.image_size=256",
        f"train.batch_size={batch}", "optim.name=lamb", "optim.lr=2e-4",
        "optim.weight_decay=0.04", "optim.clip_norm=5.0",
    ])
    return cfg


def make_step(cfg, lr=None, seed: int = 1):
    """(state, step, imgs): the CLI's step for `cfg` on the card (a task's
    `extra` made by its init_extra, as for MoCo and CM-UNet); `lr` (a
    schedule) in place of cfg.optim.lr; the images and `extra` from
    `seed`."""
    import torch

    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    task, model = build_task(cfg, torch.bfloat16, "cuda")
    o = cfg.optim
    tx = make_optimizer(o.name, o.lr if lr is None else lr, o.weight_decay,
                        momentum=o.momentum, clip_norm=o.clip_norm,
                        named_params=model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    extra = task.init_extra(gen) if task.init_extra else None
    state = TrainState.create(model=model, tx=tx, seed=cfg.train.seed,
                              extra=extra)
    S = cfg.data.image_size
    imgs = torch.randn((cfg.train.batch_size, S, S), generator=gen,
                       device="cuda")
    return state, make_train_step(task, tx), imgs


def record_step(state, step, imgs):
    """(the recorded kernel calls, the step's loss): one step with the
    wrappers recording their calls (also the warm-up that compiles the
    Triton kernel); the calls of kernels()' wrappers, the norm kernels'
    left to phase NORM (`KernelCalls`)."""
    import torch

    from cmx_torch.ops import _build

    _build.recorded = KernelCalls()
    try:
        m = step(state, imgs)
        torch.cuda.synchronize()
        return list(_build.recorded), float(m["loss"])
    finally:
        _build.recorded = None


class KernelCalls(list):
    """A `_build.recorded` that keeps the calls of kernels()' wrappers (K1-K8)
    and drops the norm kernels' (phase NORM records those)."""

    def append(self, item):
        if item[0] in kernels():
            super().append(item)


def stage_of(args) -> tuple:
    """(H, W, Cin, Cout, need_dx) of a recorded flat_bwd_mega call."""
    y, src, H, W, need_dx = args[1], args[2], args[12], args[13], args[15]
    return H, W, src.shape[1], y.shape[1], need_dx


def nhwc_shape(name, args) -> tuple:
    """(H, W, Cin, Cout) of a recorded K6, K7 or K8 call (NHWC operands)."""
    if name == "conv_stem_stats":
        return (*args[0].shape[1:3], 1, args[2].shape[1])
    if name == "conv3x3_mask_stats":
        return (*args[0].shape[1:], args[2].shape[3])
    return (*args[1].shape[1:3], args[2].shape[3], args[1].shape[3])


def conv_check(out, ref):
    """(ok, max abs error, message) of a (y, sum, sumsq) forward call."""
    ey, ry = rel_err(out[0], ref[0])
    _, rs = rel_err(out[1], ref[1])
    _, rq = rel_err(out[2], ref[2])
    msg = (f"y max_abs_err={ey:.3e} rel_err={ry:.3e} (tol 1e-2, bf16 store) "
           f"sum rel_err={rs:.3e} sumsq rel_err={rq:.3e} (tol 1e-3, sum "
           f"order)")
    return ry <= 1e-2 and rs <= 1e-3 and rq <= 1e-3, ey, msg


def bwd_check(out, ref, need_dx):
    """(ok, max abs error, message) of a (dX, dW) backward call."""
    ew, rw = rel_err(out[1], ref[1])
    ok, err = rw <= 1e-3, ew
    msg = f"dW max_abs_err={ew:.3e} rel_err={rw:.3e} (tol 1e-3, sum order)"
    if need_dx:
        eh, rh = rel_err(out[0], ref[0])
        ok = ok and rh <= 1e-2
        msg += f" dX max_abs_err={eh:.3e} rel_err={rh:.3e} (tol 1e-2, bf16)"
    return ok, err, msg


def tensor_core_phase() -> None:
    """Phase 0's look at the built code: every kernel's SASS digest (equal
    digests, equal machine code), for the tensor-core kernels ptxas
    registers/spills (from the build's log) and SASS tensor-core
    instruction counts, and the registers/spills of K4's and K6's kernels
    with K6's grid."""
    import torch

    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as fc

    tc_libs = {lib for ks in TC_KERNELS.values() for lib, _ in ks}
    for lib in sorted(_build.build_all()):
        dump = _build.dump_sass(lib)
        print(f"  SASS digests {lib}: {json.dumps(_build.sass_digests(dump))}",
              flush=True)
        usage = _build.ptxas_usage(_build.build_log(lib))
        for name, ks in CORE_KERNELS.items():
            for klib, label in ks:
                if klib != lib:
                    continue
                regs, st, ld = usage.get(label, (None, None, None))
                CORE_RESOURCES[label] = {"registers": regs,
                                         "spill_stores": st, "spill_loads": ld}
                print(f"  {name} kernel {label} in {lib}: registers={regs} "
                      f"spill stores={st} loads={ld} bytes", flush=True)
                if regs is None:
                    fail(f"no ptxas line for {label} in {lib}'s build log")
        if lib not in tc_libs:
            continue
        sass = _build.sass_counts(dump)
        for name, ks in TC_KERNELS.items():
            for klib, label in ks:
                if klib != lib:
                    continue
                regs, st, ld = usage.get(label, (None, None, None))
                ops = sass.get(label, {})
                TC_RESOURCES[label] = {"registers": regs, "spill_stores": st,
                                       "spill_loads": ld, **ops}
                print(f"  {name} kernel {label} in {lib}: registers={regs} "
                      f"spill stores={st} loads={ld} bytes; SASS {ops}",
                      flush=True)
                if not sum(ops.values()):
                    fail(f"{label} has no tensor-core instruction in its SASS")
    dev = torch.device("cuda", 0)
    stem = _build.load("nhwc_conv_fwd")
    wave = fc._resident("nhwc_conv_fwd", "cmx_stem_blocks_per_sm", dev)
    print(f"  conv_stem_stats grid: {stem.cmx_stem_blocks_per_sm()} resident "
          f"blocks a multiprocessor x {fc._sms(dev)} = {wave} blocks at most, "
          f"of {stem.cmx_stem_run()} pixels a staged run", flush=True)


def tc_summary(name: str) -> str:
    """The registers, spills and SASS counts of a wrapper's tensor-core
    kernels, for its call lines."""
    return "; ".join(
        f"{label}: {r['registers']} regs, spill {r['spill_stores']}/"
        f"{r['spill_loads']} B, HMMA {r.get('HMMA')}, HGMMA {r.get('HGMMA')}"
        for label, r in ((lb, TC_RESOURCES.get(lb, {}))
                         for _, lb in TC_KERNELS.get(name, [])))


def kernel_phase(calls, iters: int):
    """Every recorded call through its wrapper and its plain version on the
    same operands; per kernel name, the sums over the calls (one step's)."""
    import torch
    import torch.nn.functional as F

    from cmx_torch.ops import pallas_crop as pc
    from cmx_torch.ops import pallas_ops as po
    from cmx_torch.ops.augment import _resize_weight_mat
    from cmx_torch.utils import roofline as rl

    bf16, cl = torch.bfloat16, torch.channels_last
    conv_what = "F.conv2d bf16: conv only, does less work"
    bwd_what = "aten.convolution_backward bf16: conv only, does less work"
    res = {}
    for i, (name, args) in enumerate(calls):
        fn, plain = kernels()[name][:2]
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        lib_ms, lib_what, peak = None, "", rl.PEAK_BF16
        if name == "flat_conv3x3_mask_stats":
            src, w, H, W = args[0], args[2], args[4], args[5]
            B, Cin = src.shape[:2]
            C = w.shape[3]
            ok, err, msg = conv_check(out, ref)
            msg = f"{Cin}->{C} pre_norm={args[6] is not None}: {msg}"
            nbytes, flops = rl.conv3x3_fwd_work(B, H, W, Cin, C)
            xin = src.reshape(B, Cin, H, W)
            wl = w.permute(3, 2, 0, 1).to(bf16).contiguous()
            lib_ms = time_ms(lambda: F.conv2d(xin, wl, padding=1), iters)
            lib_what = conv_what
        elif name in ("conv_stem_stats", "conv3x3_mask_stats"):
            H, W, Cin, C = nhwc_shape(name, args)
            B = args[0].shape[0]
            ok, err, msg = conv_check(out, ref)
            if name == "conv_stem_stats":
                msg = f"1->{C} 9-tap patches: {msg}"
                nbytes, flops = rl.stem_work(B, H, W, C)
                xin = args[0][..., 4][:, None].contiguous()  # the image
                wl = args[2].t().reshape(C, 1, 3, 3).to(bf16).contiguous()
                lib_what = ("F.conv2d bf16 on the (B,1,H,W) image: conv only, "
                            "does less work")
            else:
                msg = f"{Cin}->{C} pre_norm={args[4] is not None}: {msg}"
                nbytes, flops = rl.conv3x3_fwd_work(B, H, W, Cin, C)
                xin = args[0].permute(0, 3, 1, 2)  # a channels_last view
                wl = args[2].permute(3, 2, 0, 1).to(bf16).contiguous(
                    memory_format=cl)
                lib_what = ("F.conv2d bf16 channels_last: conv only, does less "
                            "work")
            lib_ms = time_ms(lambda: F.conv2d(xin, wl, padding=1), iters)
        elif name in ("flat_bwd_mega", "bwd_mega"):
            if name == "flat_bwd_mega":
                H, W, Cin, C, need_dx = stage_of(args)
                B = args[1].shape[0]
                pre = args[14] is not None
                gy = args[0].to(bf16).reshape(B, C, H, W)
                xin = args[2].to(bf16).reshape(B, Cin, H, W)
                wl = args[11].permute(3, 2, 0, 1).to(bf16).contiguous()
                what, extra = bwd_what, ""
            else:
                H, W, Cin, C = nhwc_shape(name, args)
                B, need_dx = args[1].shape[0], True
                pre = args[12] is not None
                gy = args[0].to(bf16).permute(0, 3, 1, 2)
                xin = args[2].to(bf16).permute(0, 3, 1, 2)
                wl = args[11].permute(3, 2, 0, 1).to(bf16).contiguous(
                    memory_format=cl)
                what = "channels_last " + bwd_what
                extra = f"g NHWC-contiguous={args[0].is_contiguous()} "
            ok, err, msg = bwd_check(out, ref, need_dx)
            msg = f"{Cin}->{C} pre_h={pre} need_dx={need_dx}: {extra}{msg}"
            nbytes, flops = rl.conv3x3_bwd_work(B, H, W, Cin, C, need_dx)
            lib_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
                gy, xin, wl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [need_dx, True, False]), iters)
            lib_what = what
        elif name == "bn_relu_mask_pallas":
            B, H, W, C = args[0].shape
            err, rc = rel_err(out, ref)
            ok = rc <= 1e-2
            msg = (f"(B,H,W,{C}) {args[0].dtype}: max_abs_err={err:.3e} "
                   f"rel_err={rc:.3e} (tol 1e-2, one bf16 ulp: Triton fuses "
                   f"x*scale+bias into one FMA)")
            nbytes, flops = rl.bn_relu_mask_work(B, H, W, C)
            peak = rl.PEAK_FP32
        elif name == "crop_resize_pallas":
            imgs, params, out_size, method = args
            B, H, W = imgs.shape
            err, rc = rel_err(out, ref)
            ok = rc <= 1e-5
            msg = (f"-> {out_size}^2 {method}: max_abs_err={err:.3e} "
                   f"rel_err={rc:.3e} (tol 1e-5, fp32 sum order)")
            peak = rl.PEAK_FP32
            p = params.float()
            wyt = _resize_weight_mat(H, out_size, p[:, 0], p[:, 1], method)
            wyt = wyt.transpose(1, 2).contiguous()  # (B, out, H)
            wx = _resize_weight_mat(W, out_size, p[:, 2], p[:, 3], method)
            nzy, nzx = wyt != 0, wx != 0  # (B, out, H), (B, W, out)
            crop = (out_size, nzy.any(1).sum(1).tolist(),
                    nzx.any(2).sum(1).tolist(), nzy.sum((1, 2)).tolist(),
                    nzx.sum((1, 2)).tolist())
            del nzy, nzx
            nbytes, flops = rl.crop_work(*crop)
            rows = B * out_size
            read = sum(r * c for r, c in zip(crop[1], crop[2]))
            bands = [hi - lo + 1 for lo, hi in (
                pc.crop_bands(H, out_size, p[:, 0], p[:, 1], method),
                pc.crop_bands(W, out_size, p[:, 2], p[:, 3], method))]
            msg += (f"; the windows need {read / (B * H * W):.3f} of the "
                    f"images' pixels (the bound reads those), the kernel's y "
                    f"pass reads {sum(crop[1]) / (B * H):.3f} (whole rows); "
                    f"non-zero taps a weight row: {sum(crop[3]) / rows:.2f} of "
                    f"{H} (y), {sum(crop[4]) / rows:.2f} of {W} (x), the "
                    f"kernel's products run over them; the bands its row "
                    f"totals sum over: mean {bands[0].float().mean():.2f} max "
                    f"{int(bands[0].max())} taps (y), mean "
                    f"{bands[1].float().mean():.2f} max {int(bands[1].max())} "
                    f"(x)")
            x = imgs.float().contiguous()
            lib_ms = time_ms(lambda: torch.bmm(torch.bmm(wyt, x), wx), iters)
            lib_what = ("two torch.bmm fp32 on precomputed weights: products "
                        "only, does less work")
            del wyt, wx
        elif name == "spark_loss_pallas":
            rec, imgs, act, patch = args
            B, H, W = imgs.shape
            err, rc = rel_err(out, ref)
            again = fn(*args)
            same = bool(torch.equal(again, out))
            ok = rc <= 1e-5 and same
            msg = (f"rec {rec.dtype} act {act.dtype}: loss max_abs_err="
                   f"{err:.3e} rel_err={rc:.3e} (tol 1e-5, sum order); a "
                   f"second launch gives the same bits: {same}")
            nbytes, flops = rl.spark_loss_work(B, H, W, rec.element_size(),
                                               act.element_size(), patch)
            peak = rl.PEAK_FP32
        else:  # spark_loss_bwd
            rec, imgs, act, g, denom, patch = args
            B, H, W = imgs.shape
            err = float((out.float() - ref.float()).abs().max())
            big = float(ref.float().abs().max())
            ulps = _k3_bwd_ulps()[rec.dtype]
            tol = ulps * torch.finfo(rec.dtype).eps * big
            ok = out.dtype == rec.dtype and err <= tol
            msg = (f"drec {out.dtype}: max_abs_err={err:.3e} = "
                   f"{err / (torch.finfo(rec.dtype).eps * big):.2f} ulps of "
                   f"{rec.dtype} at the largest |drec| {big:.3e} (tol "
                   f"{tol:.3e}: {ulps} ulp(s); the patch statistics sum in "
                   f"another order than the plain version's)")
            nbytes, flops = rl.spark_loss_bwd_work(
                B, H, W, rec.element_size(), act.element_size(), patch)
            peak = rl.PEAK_FP32
        if name in ("spark_loss_pallas", "spark_loss_bwd"):
            (dk, nk), (dp, np_) = (device_ms(lambda: fn(*args)),
                                   device_ms(lambda: plain(*args)))
            msg += (f"; on the device (profiler, one call): kernel {dk:.4f} "
                    f"ms in {nk} launch(es), plain version {dp:.4f} ms in "
                    f"{np_} launches")
        if name in CORE_KERNELS:
            msg += " [" + "; ".join(
                f"{label}: {r['registers']} regs, spill {r['spill_stores']}/"
                f"{r['spill_loads']} B" for label, r in (
                    (lb, CORE_RESOURCES.get(lb, {}))
                    for _, lb in CORE_KERNELS[name])) + "]"
        short = name in ("spark_loss_pallas", "spark_loss_bwd",
                         "bn_relu_mask_pallas")
        n = iters * (4 if short else 1)
        t_k = time_ms(lambda: fn(*args), n)
        t_p = time_ms(lambda: plain(*args), n)
        bms, _ = rl.bound_ms(nbytes, flops, peak)
        lib = ("library_ms=null" if lib_ms is None else
               f"library_ms={lib_ms:.4f} ({lib_what})")
        tc = ""
        if name in TC_KERNELS:
            tc = (f" tflop_s={flops / t_k / 1e9:.1f} (the call's flops over "
                  f"kernel_ms) [{tc_summary(name)}]")
        print(f"call {i} {name} B={B} {H}x{W} {msg} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} {lib} bound_ms={bms:.4f}{tc}", flush=True)
        if not ok:
            fail(f"call {i}: {name} disagrees with its plain version")
        r = res.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      library_ms=None, flops=0.0, nbytes=0.0,
                                      peak=peak))
        if name in FLAT_KERNELS:
            r.setdefault("calls", []).append(
                (Cin == 1, f"{Cin}->{C} {H}x{W}", t_k, lib_ms))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += t_k
        r["plain_ms"] += t_p
        r["flops"] += flops
        r["nbytes"] += nbytes
        if name == "crop_resize_pallas":
            r.setdefault("crops", []).append(crop)
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        del out, ref
    return res


def run_steps(state, step, imgs, steps: int, label: str, check=None):
    """(mean step time in ms over the steps after 2 warm-up steps, each
    step's metrics as floats); every step's loss and grad norm finite.
    Without `check` the timed steps run back to back, timed as one span.
    With it each step is bounded by torch.cuda.synchronize() and timed
    alone: `check()` runs before the step, outside the timed span, and
    returns the function that checks the step's metrics and the state
    after it."""
    import torch

    def report(i, m):
        vals = {k: float(v) for k, v in m.items()}
        print(f"{label} step {i}: "
              + " ".join(f"{k}={v:.6g}" for k, v in vals.items()), flush=True)
        if not (math.isfinite(vals["loss"]) and math.isfinite(vals["grad_norm"])
                and vals["nonfinite"] == 0.0):
            fail(f"{label} step {i} is not finite: {vals}")
        return vals

    metrics, times = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        if check is None:
            metrics.append(step(state, imgs))
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            continue
        after = check()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(report(i, m))
        after(i, metrics[-1])
    torch.cuda.synchronize()
    if check is None:
        dt = (time.perf_counter() - t0) / (steps - 2) * 1e3
        metrics = [report(i, m) for i, m in enumerate(metrics)]
    else:
        dt = sum(times[2:]) / (steps - 2) * 1e3
    B, S = (imgs[0] if isinstance(imgs, tuple) else imgs).shape[:2]
    how = "synchronize-bounded steps" if check else "steps back to back"
    print(f"{label}: step_ms={dt:.3f} img_per_s={B / dt * 1e3:.2f} (batch {B}, "
          f"{S}^2, bf16, mean of {steps - 2} {how} after 2 warm-up steps)",
          flush=True)
    return dt, metrics


# Device kernels of the port (CUDA kernels in cmx_torch/csrc, Triton kernels
# in cmx_torch/ops), as the profiler names them.
PORT_KERNEL_NAMES = ("cmx::", "bn_relu_mask_kernel")


def core_ranges(core) -> dict:
    """The profiler's names of an autograd Function's forward and backward
    ranges -> "forward" / "backward"."""
    return {core.__name__: "forward",
            f"autograd::engine::evaluate_function: {core.__name__}Backward":
                "backward"}


def kernels_under(event):
    """(name, device us) of every kernel launched inside a profiler CPU
    event and its children."""
    for k in event.kernels:
        yield k.name, k.duration
    for child in event.cpu_children:
        yield from kernels_under(child)


def busy_ms_a_step(prof, n: int) -> float:
    """The device's busy ms a step in a profile of n steps: the union of
    its operations' intervals, so kernels that overlap count once (a sum of
    their device times counts them twice and can pass the step's time)."""
    from torch.autograd import DeviceType

    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / n


def profile_steps(run_step, n: int, step_ms: float, label: str,
                  core=None):
    """Device time by kernel over n steps (torch.profiler / CUPTI), and the
    device's busy share of the step time measured without the profiler.
    With `core`, the fused DoubleConv's autograd Function, also the device
    time inside its forward and backward ranges (fails if either is not in
    the profile). Returns the profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = busy_ms_a_step(prof, n)
    port_ms = sum(e.self_device_time_total for e in kernels
                  if any(k in e.key for k in PORT_KERNEL_NAMES)) / 1e3 / n
    print(f"{label} profile of {n} steps: device busy {busy_ms:.3f} ms/step "
          f"of step_ms={step_ms:.3f} ({100 * busy_ms / step_ms:.1f}%); "
          f"the port's kernels {port_ms:.3f} ms/step, everything else "
          f"{busy_ms - port_ms:.3f}; {sum(e.count for e in kernels) // n} "
          f"device operations/step; top by device time:", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / n
        print(f"  {ms:9.3f} ms/step {100 * ms / busy_ms:5.1f}%  "
              f"x{e.count // n:<4d} {e.key[:100]}", flush=True)
    print("  the port's kernels:", flush=True)
    for e in sorted((e for e in kernels
                     if any(k in e.key for k in PORT_KERNEL_NAMES)),
                    key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3 / n
        print(f"  {ms:9.3f} ms/step x{e.count // n:<4d} {e.key[:100]}",
              flush=True)
    if core is None:
        return prof
    ranges = core_ranges(core)
    inside = {"forward": 0.0, "backward": 0.0, "port": 0.0}
    seen = set()
    for e in prof.events():
        if e.name in ranges:
            seen.add(e.name)
            ks = list(kernels_under(e))
            inside[ranges[e.name]] += sum(us for _, us in ks) / 1e3 / n
            inside["port"] += sum(us for k, us in ks if any(
                p in k for p in PORT_KERNEL_NAMES)) / 1e3 / n
    if seen != set(ranges):
        fail(f"the {label} profile has no range named "
             f"{sorted(set(ranges) - seen)}")
    in_core = inside["forward"] + inside["backward"]
    print(f"  inside the fused DoubleConv cores ({core.__name__}): forward "
          f"{inside['forward']:.3f}, backward {inside['backward']:.3f} "
          f"device ms/step, of which the port's kernels "
          f"{inside['port']:.3f} and other kernels "
          f"{in_core - inside['port']:.3f}; outside the cores "
          f"{busy_ms - in_core:.3f}", flush=True)
    return prof


def loss_tail(prof, n: int, label: str) -> None:
    """The device kernels inside SparkLoss's forward and backward ranges of
    a profile of n fused SparK steps: fails unless they are K3's two kernels
    alone, one launch each a step (no eager sum, divide or copy around
    them)."""
    from cmx_torch.ops.pallas_ops import SparkLoss

    ranges = core_ranges(SparkLoss)
    found = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.name in ranges:
            for k, us in kernels_under(e):
                found[(ranges[e.name], k)][0] += 1
                found[(ranges[e.name], k)][1] += us / 1e3 / n
    print(f"  inside SparkLoss ({label}): " + "; ".join(
        f"{part} x{c // n} {ms:.4f} device ms/step {k[:60]}"
        for (part, k), (c, ms) in sorted(found.items())), flush=True)
    names = {part: [k for (p, k), (c, _) in found.items() if p == part
                    for _ in range(c // n)] for part in ("forward",
                                                         "backward")}
    if not (len(names["forward"]) == len(names["backward"]) == 1
            and "spark_loss_fwd_kernel" in names["forward"][0]
            and "spark_loss_bwd_kernel" in names["backward"][0]):
        fail(f"the {label} step's loss tail ran {dict(names)}, not one K3 "
             f"launch each way")


def step_phase(state, step, imgs, per_step: dict, steps: int, label: str,
               core):
    """Phases 2 and B: the main path, its launch counts, time and profile
    (`core`: the fused DoubleConv's autograd Function)."""
    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    step_ms, _ = run_steps(state, step, imgs, steps, label)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: per_step.get(name, 0) * steps for name in wrappers}
    print(f"launches in {steps} steps: {launches} (expected from the recorded "
          f"step: {expect})", flush=True)
    if launches != expect or 0 in [launches[name] for name in per_step]:
        fail(f"the {label} step did not run every kernel the expected number "
             f"of times")
    prof = profile_steps(lambda: step(state, imgs), 2, step_ms, label, core)
    if "spark_loss_pallas" in per_step:
        loss_tail(prof, 2, label)
    return launches, step_ms


def unfused_phase(cfg, steps: int, label: str, imgs=None):
    """The step of `cfg`, whose model.fused_conv (and task.pallas_loss) is
    False: no kernel of the port runs (checked), cuDNN convs and eager BN
    instead; on `imgs` if given, else on make_step's. Timed and profiled.
    Returns (state, step, step_ms)."""
    wrappers = [k[0] for k in kernels().values()]
    before = [fn.launches for fn in wrappers]
    state, step, own = make_step(cfg)
    imgs = own if imgs is None else imgs
    step_ms, _ = run_steps(state, step, imgs, steps, label)
    if [fn.launches for fn in wrappers] != before:
        fail(f"the {label} step launched a kernel of the port")
    profile_steps(lambda: step(state, imgs), 2, step_ms, label)
    return state, step, step_ms


def compare_plain(label: str, fused_model, plain_model, loss_of) -> None:
    """A fused model against the plain one from the same weights: the plain
    model takes the fused one's state; `loss_of(model, fused)` gives the
    loss on fixed inputs and draws (train mode); the loss within 2e-2
    relative and every BN running stat within 5e-2 after the forward
    (phase 3's margins)."""
    plain_model.load_state_dict(fused_model.state_dict())
    losses = {}
    for name, model in (("fused", fused_model), ("plain", plain_model)):
        model.train()
        loss = loss_of(model, name == "fused")
        loss.backward()
        losses[name] = float(loss.detach())
    d_loss = abs(losses["fused"] - losses["plain"]) / abs(losses["plain"])
    bs_f = dict(fused_model.named_buffers())
    d_bs = max(float((b - bs_f[n]).abs().max())
               for n, b in plain_model.named_buffers())
    print(f"{label} reference: loss fused={losses['fused']:.6f} plain="
          f"{losses['plain']:.6f} rel diff={d_loss:.3e} (tol 2e-2); BN "
          f"running stats max abs diff={d_bs:.3e} (tol 5e-2)", flush=True)
    if not (math.isfinite(losses["fused"]) and d_loss <= 2e-2
            and d_bs <= 5e-2):
        fail(f"the fused {label} model disagrees with the plain one")


def reference_phase(label: str):
    """Phase 3: the fused step's forward/BN stats against the unfused
    plain-PyTorch model from the same weights and draws (batch 2, 256^2);
    the fused model takes the impl FUSED_IMPL names (`label`)."""
    import torch

    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.ops.augment import _crop_window_params
    from cmx_torch.ops.masking import spark_active_mask
    from cmx_torch.ssl.spark import make_spark_task

    _, fused_model = build_task(make_cfg(2), torch.bfloat16, "cuda")
    _, plain_model = build_task(make_cfg(2, fused=False), torch.bfloat16,
                                "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    imgs = torch.randn((2, 256, 256), generator=gen, device="cuda")
    draws = {"crop": _crop_window_params(gen, 2, 256, 256, 256, (0.67, 1.0),
                                         (3 / 4, 4 / 3)),
             "flip": torch.tensor([True, False], device="cuda"),
             "active": spark_active_mask(gen, 2, 16, 0.6)}

    def loss_of(model, fused):
        task, _ = make_spark_task(model, augment=True, input_size=256,
                                  pallas_loss=fused)
        return task.loss_fn(model, imgs, gen, draws)[0]

    compare_plain(f"SparK ({label})", fused_model, plain_model, loss_of)


SPARK_KERNELS = ("flat_conv3x3_mask_stats", "flat_bwd_mega",
                 "spark_loss_pallas", "spark_loss_bwd")
FLAT_KERNELS = ("flat_conv3x3_mask_stats", "flat_bwd_mega")
NHWC_PER_STEP = {"conv_stem_stats": 1, "conv3x3_mask_stats": 3,
                 "bwd_mega": 3, "spark_loss_pallas": 1, "spark_loss_bwd": 1}
NHWC_KERNELS = ("conv_stem_stats", "conv3x3_mask_stats", "bwd_mega")
MOCO_KERNELS = ("crop_resize_pallas",)


def bn_relu_mask_phase(calls, iters: int):
    """Phase K5: bn_relu_mask_pallas, which no path calls, driven once on the
    operands of the recorded pre-norm K7 call at down1 -- the activation K7
    builds in its prologue -- then held to its plain version and timed.
    Returns (kernel_phase's sums, the launches of the drive)."""
    from cmx_torch.ops import pallas_ops as po

    src, m, _, _, inv, shift = next(
        args for name, args in calls
        if name == "conv3x3_mask_stats" and args[4] is not None)
    args = (src, inv, shift, m[..., None])
    po.bn_relu_mask_pallas.launches = 0
    po.bn_relu_mask_pallas(*args)
    launches = po.bn_relu_mask_pallas.launches
    print(f"K5 phase: bn_relu_mask_pallas on down1's pre-norm K7 operands "
          f"{tuple(src.shape)} {src.dtype}: {launches} launch (no caller on "
          f"any path)", flush=True)
    if launches != 1:
        fail("bn_relu_mask_pallas did not launch its kernel")
    return kernel_phase([("bn_relu_mask_pallas", args)], iters), launches


def nhwc_phase(flat_loss: float, steps: int, iters: int):
    """Phases A, K5 and B: the SparK step with FUSED_IMPL="nhwc"."""
    import torch

    from cmx_torch.ops import fused_conv as fc

    state, step, imgs = make_step(make_cfg(BATCH))
    calls, loss = record_step(state, step, imgs)
    per_step = collections.Counter(name for name, _ in calls)
    d_loss = abs(loss - flat_loss) / abs(flat_loss)
    print(f"nhwc recorded step: kernel calls per step {dict(per_step)}; "
          f"loss {loss:.6f} against the flat step's {flat_loss:.6f} (same "
          f"weights, images and draws): rel diff {d_loss:.3e} (tol 1e-3)",
          flush=True)
    if dict(per_step) != NHWC_PER_STEP:
        fail(f"the NHWC step called {dict(per_step)}, expected "
             f"{NHWC_PER_STEP}")
    if not d_loss <= 1e-3:
        fail("the NHWC step's loss disagrees with the flat step's")
    shapes = [(name, nhwc_shape(name, args)) for name, args in calls
              if name in NHWC_KERNELS]
    kern = kernel_phase(calls, iters)
    k5, k5_launches = bn_relu_mask_phase(calls, iters)
    kern.update(k5)
    del calls
    torch.cuda.empty_cache()
    launches, step_ms = step_phase(state, step, imgs, per_step, steps, "nhwc",
                                   fc.FusedDoubleConv)
    launches["bn_relu_mask_pallas"] = k5_launches
    del state, step, imgs
    torch.cuda.empty_cache()
    return kern, launches, step_ms, shapes


def make_moco_cfg(batch: int, crop_impl: str):
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS

    cfg = PRESETS["moco"](Config())
    apply_overrides(cfg, [f"task.crop_impl={crop_impl}",
                          f"train.batch_size={batch}", "data.image_size=256"])
    return cfg


def moco_run(state, step, imgs, steps: int, label: str):
    """run_steps with phase 5's check after each step: acc1/acc5 in [0, 1],
    queue_ptr advanced by B mod K, the key encoder exactly the EMA (m 0.999)
    of itself and the updated online encoder, and moved toward it."""
    import torch

    extra = state.extra
    key_params = list(extra["key_model"].parameters())
    online = list(state.model.parameters())
    K = extra["queue"].shape[0]
    B = imgs.shape[0]
    moved = []

    def check():
        ptr0 = int(extra["queue_ptr"])
        key0 = [p.detach().clone() for p in key_params]

        def after(i, vals):
            ptr = int(extra["queue_ptr"])
            ema_err = dot = gap = 0.0
            with torch.no_grad():
                for k1, k0, p in zip(key_params, key0, online):
                    ema_err = max(ema_err, float(
                        (k1 - (0.999 * k0 + (1.0 - 0.999) * p)).abs().max()))
                    # fp64: the key's move along online - key0, 1 - m = 0.001
                    d = p.double() - k0.double()
                    dot += float(((k1.double() - k0.double()) * d).sum())
                    gap += float(d.square().sum())
            frac = dot / max(gap, 1e-300)
            gap = math.sqrt(gap)
            print(f"  queue_ptr {ptr0}->{ptr} |online-key| {gap:.6g} key "
                  f"moved {frac:.6g} of it (0.001) ema_err={ema_err:.3e}",
                  flush=True)
            if not 0.0 <= vals["acc1"] <= vals["acc5"] <= 1.0:
                fail(f"{label} step {i}: acc1/acc5 out of [0, 1]: {vals}")
            if ptr != (ptr0 + B) % K:
                fail(f"{label} step {i}: queue_ptr {ptr0} -> {ptr}, expected "
                     f"{(ptr0 + B) % K}")
            # Below a gap of ~0.1 (over ~1.9e7 weights) the EMA's move, 0.001
            # of the gap, is under the fp32 rounding of the key weights.
            if ema_err > 1e-6 or (gap > 0.1 and not 5e-4 < frac < 2e-3):
                fail(f"{label} step {i}: the key encoder is not the EMA (m "
                     f"0.999) toward the updated online encoder")
            moved.append(gap > 0.1)

        return after

    dt, metrics = run_steps(state, step, imgs, steps, label, check)
    if not any(moved):
        fail(f"{label}: the online encoder never moved 0.1 away from the key "
             f"encoder, so no step could show the EMA's move")
    return dt, metrics


def moco_phase(batch: int, steps: int, iters: int):
    """Phases 4-5: MoCo with crop_impl=pallas, then scale_translate."""
    import torch

    wrappers = {name: k[0] for name, k in kernels().items()}
    state, step, imgs = make_step(make_moco_cfg(batch, "pallas"))
    print(f"moco model params: "
          f"{sum(p.numel() for p in state.model.parameters())}; queue "
          f"{tuple(state.extra['queue'].shape)}", flush=True)
    calls, _ = record_step(state, step, imgs)
    per_step = collections.Counter(name for name, _ in calls)
    print(f"moco recorded step: kernel calls per step {dict(per_step)}",
          flush=True)
    if dict(per_step) != {"crop_resize_pallas": 2}:
        fail("the MoCo step did not call K4 twice (q and k views)")
    kern = kernel_phase(calls, iters)
    del calls
    torch.cuda.empty_cache()

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = moco_run(state, step, imgs, steps, "moco pallas")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: per_step.get(name, 0) * steps for name in wrappers}
    print(f"moco launches in {steps} steps: {launches} (expected {expect}); "
          f"peak memory {peak:.2f} GiB (max_memory_allocated)", flush=True)
    if launches != expect:
        fail("the MoCo step did not run K4 2 times a step and K1-K3 never")
    profile_steps(lambda: step(state, imgs), 2, step_ms, "moco pallas")
    del state, step, imgs
    torch.cuda.empty_cache()

    # The same run through the plain crop, from the same weights, queue,
    # images and step draws; its first step stands for the recorded one.
    before = {name: fn.launches for name, fn in wrappers.items()}
    state, step, imgs = make_step(make_moco_cfg(batch, "scale_translate"))
    record_step(state, step, imgs)
    torch.cuda.reset_peak_memory_stats()
    base_ms, base = moco_run(state, step, imgs, steps, "moco scale_translate")
    base_peak = torch.cuda.max_memory_allocated() / 2**30
    if {name: fn.launches for name, fn in wrappers.items()} != before:
        fail("the scale_translate MoCo step launched a kernel of the port")
    profile_steps(lambda: step(state, imgs), 2, base_ms,
                  "moco scale_translate")
    d_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(losses, base))
    print(f"moco pallas step_ms={step_ms:.3f} peak {peak:.2f} GiB; "
          f"scale_translate step_ms={base_ms:.3f} peak {base_peak:.2f} GiB "
          f"(pallas/scale_translate {step_ms / base_ms:.3f}); loss through "
          f"K4 against the plain crop step for step: max rel diff "
          f"{d_loss:.3e} (tol 2e-2, bf16 model)", flush=True)
    if not d_loss <= 2e-2:
        fail("the MoCo step through K4 disagrees with the plain crop")
    del state, step, imgs
    torch.cuda.empty_cache()
    return kern, launches, step_ms


CLI_EPOCHS = (2, 3)  # the first call's epochs, then the resumed call's
CLI_IMAGES = 96      # the synthetic corpus (its pretrain split: 66 images)
CLI_SIZE = 256       # data.image_size


class _Tee:
    """stdout to the real stream and a buffer (the CLI's own lines)."""

    def __init__(self, stream):
        self.stream, self.lines = stream, []

    def write(self, text):
        self.lines.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def wrapper_calls(calls: dict) -> dict:
    """A graph report's capture calls of the port's kernel wrappers: its
    `capture_calls` less the library convolutions' counts by layout
    (cmx_torch.models.blocks.LIBRARY_CONV_CALLS) and the batch norms'
    (the norm kernels' wrappers and blocks.NORM_CALLS: phase NORM's)."""
    return {n: c for n, c in calls.items()
            if not n.startswith(("library_conv_", "norm_"))}


def graph_launches(wrappers: dict, since: int, per_step: dict,
                   label: str) -> dict:
    """Each kernel's launches in the runs since cmx_torch.train.graph's
    REPORTS held `since` reports: the wrappers' counts (eager steps,
    validation forwards, and each capture once) less each graph's capture
    calls, plus those calls times the graph's replays. Fails unless every
    graph captured exactly one step's calls (`per_step`)."""
    from cmx_torch.train.graph import REPORTS

    counts = {n: fn.launches for n, fn in wrappers.items()}
    want = {n: c for n, c in per_step.items() if c}
    for rep in REPORTS[since:]:
        calls = wrapper_calls(rep["capture_calls"])
        if calls != want:
            fail(f"{label}: a graph captured the calls {calls}, not one "
                 f"step's {want}")
        for n, c in calls.items():
            counts[n] += c * (rep["replays"] - 1)
    return counts


def graphs_since(since: int) -> str:
    """The graphs captured since REPORTS held `since` reports, in words."""
    from cmx_torch.train.graph import REPORTS

    return "; ".join(
        f"{r['label']}: {r['eager_steps']} eager step(s), {r['replays']} "
        f"replays, captured in {r['capture_s']:.3f} s"
        for r in REPORTS[since:]) or "no graph"


def cli_phase(work: Path, per_step: dict):
    """Phase CLI: `cmx_torch.cli.pretrain.main` in this process, as a user
    runs it, in the directory `work`: SparK with
    model.fused_conv=True task.pallas_loss=True at full width, CLI_SIZE^2,
    bf16, batch BATCH, LAMB as phase 2's step, a synthetic corpus of
    CLI_IMAGES images (at batch 32: 32 of its pretrain split of 66 for
    validation with patience 5, 34 for training, 2 steps an epoch),
    train.save_every_epoch=True, cuDNN's deterministic algorithms;
    CLI_EPOCHS[0] epochs, the same run with train.scan=False (eager steps)
    in another directory, then a call to CLI_EPOCHS[1] epochs that resumes
    the first. Fails unless the native loader read the corpus and the
    device feed ran in both calls, every step but a call's first was
    replayed from its graph, the train.scan=False run wrote the same
    encoder.npz and log.jsonl, log.jsonl holds epochs 0..CLI_EPOCHS[1]-1
    with finite losses and validation losses, each kernel's launches
    (`graph_launches`) equal phase 2's per-step calls times the training
    steps (plus, for the forward kernels K1 and K3, the validation
    forwards), encoder.npz reloads through load_encoder into
    a fresh SparKModel whose encoder equals the run's final one bit for bit,
    and the stamp's sha256 is the file's. Returns (the phase's seconds, the
    exported encoder.npz, the corpus directory); both stay in `work`."""
    import contextlib
    import hashlib

    import numpy as np
    import torch

    from cmx_torch.ckpt.checkpoint import load_encoder
    from cmx_torch.cli.pretrain import main as pretrain_main
    from cmx_torch.ssl.spark import SparKModel
    from cmx_torch.train.graph import REPORTS

    t0 = time.perf_counter()
    wrappers = {name: k[0] for name, k in kernels().items()}
    fwd_only = ("flat_conv3x3_mask_stats", "spark_loss_pallas")
    tmp = str(work)
    base = ["--task", "spark", "data.synthetic=True",
            f"data.synthetic_n={CLI_IMAGES}", f"data.data_dir={tmp}/data",
            "model.fused_conv=True",
            "task.pallas_loss=True", f"data.image_size={CLI_SIZE}",
            f"train.batch_size={BATCH}", "optim.name=lamb",
            "optim.lr=2e-4", "optim.weight_decay=0.04",
            "optim.clip_norm=5.0", "train.patience=5",
            "train.save_every_epoch=True"]

    def call(args, label):
        """One CLI call: (its summary, its stdout, each kernel's launches,
        its epochs' img/s)."""
        for fn in wrappers.values():
            fn.launches = 0
        since = len(REPORTS)
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            out = pretrain_main(base + args)
        torch.cuda.synchronize()
        rates = re.findall(r"epoch (\d+): .*?\(([\d.]+)s, ([\d.]+) img/s\)",
                           "".join(tee.lines))
        print(f"CLI {label}: graphs {graphs_since(since)}", flush=True)
        return (out, "".join(tee.lines),
                graph_launches(wrappers, since, per_step, "CLI"), rates)

    # cuDNN's deterministic algorithms: the run through the graph and the
    # eager one (train.scan=False) must write the same encoder.npz
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        done, prev_step, results, noscan = 0, 0, [], None
        for epochs in CLI_EPOCHS:
            out, _, launches, rates = call(
                [f"train.epochs={epochs}", f"train.ckpt_dir={tmp}/ckpt"],
                f"to {epochs} epochs")
            ran = epochs - done
            steps = out["state"].step - prev_step
            val = out["val_batches"] * ran
            expect = {n: per_step.get(n, 0) * (
                steps + (val if n in fwd_only else 0)) for n in wrappers}
            g = out["graph"]
            print(f"CLI call to {epochs} epochs: loader {out['loader']}, "
                  f"device feed {out['device_feed']}, {steps} training steps "
                  f"({g['eager_steps']} eager, {g['replays']} replayed from "
                  f"the graph) and {val} validation batches; epoch "
                  f"img/s (the CLI's own lines, host clock, the epoch's steps "
                  f"and its one metrics transfer): "
                  + ", ".join(f"epoch {e}: {r} img/s in {t} s"
                              for e, t, r in rates)
                  + f"; launches (eager calls + capture calls x replays) "
                  f"{launches} (expected {expect})", flush=True)
            if out["loader"] != "native" or not out["device_feed"]:
                fail("the CLI did not load the corpus natively into the "
                     "device feed")
            if (launches != expect or not val
                    or steps != out["steps_per_epoch"] * ran):
                fail("the CLI's steps did not run each kernel the expected "
                     "number of times")
            if (g["eager_steps"], g["replays"]) != (1, steps - 1):
                fail(f"the CLI's steps were not replayed from its graph: {g}")
            results.append(out)
            done, prev_step = epochs, out["state"].step
            if noscan is None:  # the same run with train.scan=False
                with np.load(out["encoder"]) as z:
                    enc = {k: z[k] for k in z.files}
                out2, _, launches2, rates2 = call(
                    [f"train.epochs={epochs}", "train.scan=False",
                     f"train.ckpt_dir={tmp}/ckpt_noscan"], "train.scan=False")
                with np.load(out2["encoder"]) as z:
                    same = sorted(z.files) == sorted(enc) and all(
                        np.array_equal(z[k], v) for k, v in enc.items())
                logs = [[{k: v for k, v in json.loads(line).items()
                          if k != "time"} for line in Path(
                              o["ckpt_dir"], "log.jsonl").read_text(
                              ).splitlines()] for o in (out, out2)]
                print(f"CLI train.scan=False to {epochs} epochs: "
                      f"{out2['state'].step} eager steps, graph "
                      f"{out2['graph']}; encoder.npz bit for bit the graph "
                      f"run's {same}, log.jsonl equal {logs[0] == logs[1]}; "
                      f"epoch img/s eager " + ", ".join(
                          f"epoch {e}: {r}" for e, _, r in rates2)
                      + " / graph " + ", ".join(f"epoch {e}: {r}"
                                                for e, _, r in rates)
                      + f"; launches {launches2}", flush=True)
                if (not same or logs[0] != logs[1] or out2["graph"]
                        is not None or launches2 != expect):
                    fail("the CLI with train.scan=False is not the run "
                         "through the graph")
                noscan = out2
                del out2
    finally:
        torch.backends.cudnn.deterministic = saved
    ckpt = results[-1]["ckpt_dir"]
    with open(Path(ckpt) / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    print(f"CLI log.jsonl: epochs {[r['epoch'] for r in log]}, loss "
          f"{[round(r['loss'], 6) for r in log]}, val_loss "
          f"{[round(r['val_loss'], 6) for r in log]}", flush=True)
    if [r["epoch"] for r in log] != list(range(CLI_EPOCHS[-1])) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["val_loss"])
            for r in log):
        fail("the CLI's log.jsonl lacks an epoch or holds a non-finite "
             "loss")
    state = results[-1]["state"]
    fresh = SparKModel(dtype=torch.bfloat16, fused=True).to("cuda")
    load_encoder(results[-1]["encoder"], fresh)
    final = state.model.encoder.state_dict()
    same = all(torch.equal(t, final[n])
               for n, t in fresh.encoder.state_dict().items())
    stamp = json.loads(Path(results[-1]["stamp"]).read_text())
    digest = hashlib.sha256(
        Path(results[-1]["encoder"]).read_bytes()).hexdigest()
    print(f"CLI export: encoder.npz reloaded into a fresh SparKModel: "
          f"encoder equal bit for bit {same}; stamp sha256 matches "
          f"{stamp['encoder_sha256'] == digest}; final step "
          f"{stamp['final_step']}, epochs_run {stamp['epochs_run']}",
          flush=True)
    if not same or stamp["encoder_sha256"] != digest:
        fail("the CLI's encoder.npz does not reload to the run's encoder")
    encoder = results[-1]["encoder"]
    del state, results, fresh
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"CLI phase took {secs:.1f} s (corpus generation, both calls, "
          f"exports and checks)", flush=True)
    return secs, encoder, f"{tmp}/data"


FT_LR = 1e-3        # FT1's Adam learning rate (one point of the CLI's grid)
FT_CLI_EPOCHS = 2   # FT-CLI: --epochs
FT_CLI_BATCH = 8    # FT-CLI: --batches
FT_CLI_RATIO = 0.3  # FT-CLI: data.ratio (29 fine-tune and 20 test images)


def make_ft_step(fused: bool, batch: int,
                 up_sample_mode: str = "conv_transpose"):
    """(state, step, (imgs, masks)): the fine-tune step as
    cmx_torch.cli.finetune builds it (UNet out_classes 2 with
    `up_sample_mode`, bf16, weights from seed 0, the supervised task with
    augmentation, Adam lr FT_LR) on the card, and a batch of random images
    and one-hot masks from a seed."""
    import torch

    from cmx_torch.models.unet import UNet
    from cmx_torch.train.optim import Adam
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.supervised import make_supervised_task
    from cmx_torch.train.trainer import make_train_step

    model = UNet(out_classes=2, dtype=torch.bfloat16, fused=fused,
                 up_sample_mode=up_sample_mode)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to("cuda")
    task, _ = make_supervised_task(model, augment=True)
    tx = Adam(model.named_parameters(), FT_LR)
    state = TrainState.create(model=model, tx=tx, seed=42)
    gen = torch.Generator(device="cuda").manual_seed(5)
    imgs = torch.randn((batch, CLI_SIZE, CLI_SIZE), generator=gen,
                       device="cuda")
    fg = torch.randn((batch, CLI_SIZE, CLI_SIZE), generator=gen,
                     device="cuda") > 1.0
    masks = torch.stack([~fg, fg], dim=1).float()
    return state, make_train_step(task, tx), (imgs, masks)


def up1_calls(calls, fwd: str, bwd: str):
    """The recorded calls of decoder/up1's DoubleConv: the last two forward
    calls (up1 runs last) and the first two backward ones (the backward runs
    in reverse)."""
    return ([c for c in calls if c[0] == fwd][-2:]
            + [c for c in calls if c[0] == bwd][:2])


def finetune_phase(batch: int, steps: int, iters: int):
    """Phases FT1 and FT-NHWC (see the module docstring). Returns (the
    per-step calls of the flat fused step, its step_ms, the unfused step's,
    the K1/K2 replay sums)."""
    import torch

    from cmx_torch.ops import fused_conv as fc
    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.ops.augment import finetune_draws

    state, step, batch_t = make_ft_step(True, batch)
    calls, ft_loss = record_step(state, step, batch_t)
    per_step = collections.Counter(name for name, _ in calls)
    shapes = [f"{stage_of(a)[2]}->{stage_of(a)[3]} {stage_of(a)[0]}^2 "
              f"dX={stage_of(a)[4]}" for n, a in calls if n == "flat_bwd_mega"]
    print(f"FT1 recorded step: kernel calls per step {dict(per_step)} "
          f"(predicted K1 6, K2 6); loss {ft_loss:.6f}; K2 stages in the "
          f"order the backward runs them: {shapes}", flush=True)
    if set(per_step) != set(FLAT_KERNELS):
        fail(f"the fine-tune step called {sorted(per_step)}, expected "
             f"{sorted(FLAT_KERNELS)}")
    C, cin = state.model.decoder.up1.double_conv.conv0.kernel.shape[:2]
    up1 = up1_calls(calls, *FLAT_KERNELS)
    if [stage_of(a)[2:] for n, a in up1[2:]] != [(C, C, True),
                                                 (cin, C, True)]:
        fail("the fine-tune step did not run decoder/up1 through K1/K2 with "
             "dX")
    print("FT1 replay of every K1/K2 call of the recorded step (up1: the "
          "last two K1 calls and the first two K2 calls):", flush=True)
    kern = kernel_phase(calls, iters)
    del calls
    torch.cuda.empty_cache()
    launches, step_ms = step_phase(state, step, batch_t, per_step, steps,
                                   "finetune fused", ff.FlatDoubleConv)
    del state, step
    torch.cuda.empty_cache()

    wrappers = [k[0] for k in kernels().values()]
    before = [fn.launches for fn in wrappers]
    state, step, _ = make_ft_step(False, batch)
    plain_ms, _ = run_steps(state, step, batch_t, steps, "finetune unfused")
    if [fn.launches for fn in wrappers] != before:
        fail("the unfused fine-tune step launched a kernel of the port")
    profile_steps(lambda: step(state, batch_t), 2, plain_ms,
                  "finetune unfused")
    print(f"finetune fused step_ms={step_ms:.3f} unfused step_ms="
          f"{plain_ms:.3f} (fused/unfused {step_ms / plain_ms:.3f}; batch "
          f"{batch}, {CLI_SIZE}^2, bf16, Adam)", flush=True)

    # the fused model against the plain one from the same weights and draws
    from cmx_torch.train.supervised import make_supervised_task

    fused, _, _ = make_ft_step(True, 2)
    plain = state
    gen = torch.Generator(device="cuda").manual_seed(3)
    draws = finetune_draws(gen, 2, CLI_SIZE, CLI_SIZE)
    sub = tuple(t[:2] for t in batch_t)
    compare_plain("finetune", fused.model, plain.model, lambda m, _: (
        make_supervised_task(m, augment=True)[0].loss_fn(m, sub, gen,
                                                         draws)[0]))
    del fused, plain, state, step
    torch.cuda.empty_cache()

    fc.FUSED_IMPL = "nhwc"
    try:
        state, step, _ = make_ft_step(True, batch)
        calls, nhwc_loss = record_step(state, step, batch_t)
    finally:
        fc.FUSED_IMPL = "flat"
    nhwc_per_step = collections.Counter(name for name, _ in calls)
    d = abs(nhwc_loss - ft_loss) / abs(ft_loss)
    print(f"FT-NHWC recorded step: kernel calls per step "
          f"{dict(nhwc_per_step)} (predicted K6 1, K7 5, K8 5); loss "
          f"{nhwc_loss:.6f} against FT1's {ft_loss:.6f}: rel diff {d:.3e} "
          f"(tol 1e-3)", flush=True)
    if set(nhwc_per_step) != set(NHWC_KERNELS):
        fail(f"the NHWC fine-tune step called {sorted(nhwc_per_step)}")
    if not d <= 1e-3:
        fail("the NHWC fine-tune step's loss disagrees with the flat one's")
    up1 = up1_calls(calls, "conv3x3_mask_stats", "bwd_mega")
    if [nhwc_shape(n, a)[2:] for n, a in up1] != [(cin, C), (C, C), (C, C),
                                                  (cin, C)]:
        fail("the NHWC fine-tune step did not run up1 through K7/K8")
    print("FT-NHWC replay of K7's and K8's up1 calls:", flush=True)
    kernel_phase(up1, iters)
    del state, step, calls, up1, batch_t
    torch.cuda.empty_cache()
    return dict(per_step), step_ms, plain_ms, kern


def finetune_cli_phase(work: Path, encoder: str, data_dir: str,
                       per_step: dict) -> float:
    """Phase FT-CLI: `cmx_torch.cli.finetune.main` in this process on the
    card, as a user runs it, with the CLI phase's encoder.npz and corpus
    (see the module docstring). Returns the phase's seconds."""
    import numpy as np
    import torch

    from cmx_torch.ckpt.checkpoint import to_flax
    from cmx_torch.cli.finetune import main as finetune_main
    from cmx_torch.data.splits import KFold

    from cmx_torch.train.graph import REPORTS

    t0 = time.perf_counter()
    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    since = len(REPORTS)
    out = finetune_main([
        "--device", "cuda", "--pretrained", encoder, "--lrs", str(FT_LR),
        "--epochs", str(FT_CLI_EPOCHS), "--batches", str(FT_CLI_BATCH),
        "--out", str(work / "ft_results"), "data.synthetic=True",
        f"data.synthetic_n={CLI_IMAGES}", f"data.data_dir={data_dir}",
        f"data.image_size={CLI_SIZE}", f"data.ratio={FT_CLI_RATIO}",
        "model.fused_conv=True"])
    torch.cuda.synchronize()
    launches = graph_launches(wrappers, since, per_step, "FT-CLI")
    fits = REPORTS[since:]
    n_ft = out["n_finetune"]
    folds = [len(tr) for tr, _ in KFold(3, random_state=42).split(range(n_ft))]
    steps = FT_CLI_EPOCHS * sum(-(-n // FT_CLI_BATCH) for n in folds + [n_ft])
    expect = {n: per_step.get(n, 0) * steps for n in wrappers}
    enc = to_flax(out["model"])
    with np.load(encoder) as f:
        same = all(np.array_equal(
            functools.reduce(lambda t, k: t[k], k.split("/")[1:],
                             enc[k.split("/")[0]]["encoder"]), f[k])
            for k in f.files)
    logs = [fold[part] for fold in out["grid"][0]["folds"]
            for part in ("train_logs", "valid_logs")]
    logs += [out["final"].train_logs, out["final"].valid_logs]
    finite = all(math.isfinite(v) for lg in logs for vs in lg.values()
                 for v in vs)
    saved = json.loads(Path(out["test_path"]).read_text())
    tag = Path(encoder).parent.name
    print(f"FT-CLI: {n_ft} fine-tune images (folds train {folds}), "
          f"{out['n_test']} test images; encoder loaded bit for bit {same}; "
          f"every fold's and the final fit's logs finite {finite}; "
          f"{steps} training steps ({len(fits)} fits replayed from their "
          f"graphs, {sum(r['replays'] for r in fits)} replays, capture "
          f"seconds {[round(r['capture_s'], 3) for r in fits]}), launches "
          f"(eager calls + capture calls x replays) {launches} (expected "
          f"{expect}, the frozen-BN evaluations add none); tag {out['tag']!r} "
          f"(expected {tag!r}); test metrics {saved['test_metrics']}",
          flush=True)
    if not same:
        fail("the fine-tune CLI's UNet encoder does not equal encoder.npz")
    if not finite:
        fail("the fine-tune CLI logged a non-finite metric")
    if launches != expect or len(fits) != len(folds) + 1:
        fail("the fine-tune CLI did not run K1/K2 the expected number of "
             "times, or a fit ran no graph")
    if (out["tag"] != tag or Path(out["test_path"]).name != f"test_{tag}.json"
            or not math.isfinite(saved["dice"])):
        fail("the fine-tune CLI's test json lacks a finite dice under its tag")
    del out
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"FT-CLI test dice={saved['dice']:.6f} (a smoke value: a "
          f"synthetic corpus and {FT_CLI_EPOCHS} epochs, not a result); the "
          f"phase took {secs:.1f} s (grid of 3 folds, the final fit, the "
          f"host metrics)", flush=True)
    return secs


CM_BATCH = 64      # CM1's batch (the preset's 256 does not fit one card)
CM_CLI_BATCH = 16  # CM-CLI's and G-CLI's batch: 4 steps an epoch
MAE_BATCH = 64     # the mae preset's batch


def make_cm_cfg(batch: int):
    """PRESETS["cmunet"] at full width: 256^2 images, 224^2 views, bf16,
    AdamW (wd 0.05, clip 5), mask 0.65, T 0.07, EMA 0.996."""
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS

    cfg = PRESETS["cmunet"](Config())
    apply_overrides(cfg, [f"train.batch_size={batch}", "data.image_size=256"])
    return cfg


def cm_run(state, step, imgs, steps: int, label: str):
    """run_steps with CM1's check after each step: loss_ct and loss_rc
    finite, a leaf of the target's encoder and one of its projector equal
    m * old + (1 - m) * the updated online leaf (m 0.996, fp32 rounding),
    the reduce kernel unchanged bit for bit. Returns (step_ms, metrics, the
    largest move of a target BN running stat over the run)."""
    import torch

    extra = state.extra
    m = 0.996
    target, online = extra["target_model"], state.model
    leaves = ("encoder.down1.double_conv.conv0.kernel", "projector.fc0.kernel")
    tp = dict(target.named_parameters())
    op = dict(online.named_parameters())
    kernel0 = extra["reduce_kernel"].clone()
    stats0 = [b.clone() for b in target.buffers()]

    def check():
        old = {n: tp[n].detach().clone() for n in leaves}

        def after(i, vals):
            for k in ("loss_ct", "loss_rc"):
                if not math.isfinite(vals[k]):
                    fail(f"{label} step {i}: {k} is not finite")
            errs = {}
            with torch.no_grad():
                for n in leaves:
                    want = m * old[n] + (1.0 - m) * op[n]
                    errs[n] = float((tp[n] - want).abs().max()
                                    / want.abs().max())
            print(f"  target EMA (m {m}) rel err {errs}", flush=True)
            if max(errs.values()) > 1e-6:
                fail(f"{label} step {i}: the target is not the EMA of the "
                     f"updated online parameters")
            if not torch.equal(extra["reduce_kernel"], kernel0):
                fail(f"{label} step {i}: the reduce kernel changed")

        return after

    dt, metrics = run_steps(state, step, imgs, steps, label, check)
    moved = max(float((b - b0).abs().max())
                for b, b0 in zip(target.buffers(), stats0))
    return dt, metrics, moved


def cm_phase(batch: int, steps: int) -> dict:
    """Phase CM1 (see the module docstring). Returns its numbers."""
    import torch

    from cmx_torch.train.schedules import scaled_base_lr, warmup_cosine

    cfg = make_cm_cfg(batch)
    # the preset's warm-up (40 of 300 epochs), one step an epoch
    lr = warmup_cosine(scaled_base_lr(cfg.optim.lr, batch),
                       cfg.train.epochs, cfg.optim.warmup_epochs)
    torch.cuda.reset_peak_memory_stats()
    state, step, imgs = make_step(cfg, lr=lr, seed=0)
    model = state.model
    print(f"CM1: CMUNetOnline params "
          f"{sum(p.numel() for p in model.parameters())} (projector fc0 "
          f"{tuple(model.projector.fc0.kernel.shape)}), batch {batch}, "
          f"images {tuple(imgs.shape)}, AdamW peak lr "
          f"{scaled_base_lr(cfg.optim.lr, batch):.4g} warm-up "
          f"{cfg.optim.warmup_epochs} steps, clip {cfg.optim.clip_norm}",
          flush=True)
    from cmx_torch.models import blocks

    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    norms0 = dict(blocks.NORM_CALLS)
    step_ms, _, moved = cm_run(state, step, imgs, steps, "CM1")
    launches = {n: fn.launches for n, fn in wrappers.items()}
    norms = {k: v - norms0[k] for k, v in blocks.NORM_CALLS.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"CM1: launches of the port's K1-K8 in {steps} steps {launches} "
          f"(expected none: cmx builds CM-UNet unfused); batch norms by "
          f"path {norms} (expected every one through the norm kernels); "
          f"target BN running stats moved (largest change {moved:.3e}); "
          f"peak memory {peak:.2f} GiB (max_memory_allocated over set-up "
          f"and the steps)", flush=True)
    if any(launches.values()):
        fail("the CM-UNet step launched a kernel of the port")
    if norms["norm_plain"] or not norms["norm_kernel_channels_last"]:
        fail(f"the CM-UNet step ran a batch norm outside the norm kernels: "
             f"{norms}")
    if not moved > 0.0:
        fail("the CM-UNet target's BN running stats did not move")
    profile_steps(lambda: step(state, imgs), 2, step_ms, "CM1")
    del state, step, imgs, model
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "img_per_s": batch / step_ms * 1e3,
            "peak_gib": peak}


# phase NORM's programs by the cell whose shapes they give: CM-UNet and
# MoCo (channels-last rows), SparK unfused (its masked 256^2 levels) and
# fused (the flat path's channel-major densify norms), each at full width
NORM_CELLS = {
    "cmunet-b128": lambda: make_cm_cfg(128),
    "moco-b256-graph": lambda: make_moco_cfg(256, "pallas"),
    "spark-b128-unfused": lambda: make_cfg(128, fused=False),
    "spark-b128-fused": lambda: make_cfg(128, fused=True),
}
NORM_PASSES = ("norm_moments", "norm_apply", "norm_grad_sums",
               "norm_grad_input")


def _operand_key(a):
    import torch

    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.stride(), str(a.dtype)
    return a


class NormCalls(list):
    """A `_build.recorded` for phase NORM: the first call of each norm
    kernel's wrapper at each operand signature (shapes, strides, dtypes,
    the epilogue's flags), and in `counts` the step's calls of each."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def append(self, item):
        name, args = item
        if name not in NORM_PASSES:
            return
        key = (name,) + tuple(_operand_key(a) for a in args)
        if key not in self.counts:
            super().append(item)
        self.counts[key] += 1


def norm_bytes(name: str, args) -> int:
    """The bytes a norm pass must move: x (and dy) read once, the output
    written once, the mask read once (the C-sized constants and partials
    left out)."""
    grad = name.startswith("norm_grad")
    x, mask = (args[1], args[2]) if grad else (args[0], args[1])
    nx = x.numel() * x.element_size()
    moved = {"norm_moments": 1, "norm_apply": 2, "norm_grad_sums": 2,
             "norm_grad_input": 3}[name] * nx
    return moved + (0 if mask is None else mask.numel() * mask.element_size())


def norm_exact_sums(name: str, args) -> list:
    """The float64 sums per channel of the fp32 terms a sum pass adds up
    (the plain version's terms: moments d = (x - shift) m and d^2; grad
    sums g and g (x - mean)): what its sums are off from is their order
    alone."""
    import torch

    from cmx_torch.ops import batch_norm as bo

    if name == "norm_moments":
        x, mask, shift = args
        m = bo._mask4(mask, torch.float32)
        d = x.float() - shift.float()[:, None, None]
        terms = (d if m is None else d * m,)
        terms += (terms[0] * terms[0],)
    else:
        dy, x, mask, inv_t, shift_t, mean, relu = args
        g = bo._grad_in(dy, x, mask, inv_t, shift_t, relu)
        terms = (g, g * (x.float() - mean[:, None, None]))
    return [t.double().sum((0, 2, 3)) for t in terms]


def sums_off(sums, exact) -> float:
    """The largest relative error, each over its largest exact sum, of a
    sum pass's (2 C [+ 1]) sums against `norm_exact_sums`'s two C-vectors."""
    c = exact[0].numel()
    return max(float((sums[i * c:(i + 1) * c].double() - e).abs().max()
                     / e.abs().max().clamp(min=1e-30))
               for i, e in enumerate(exact))


def _batch_norm_library_ms(x, iters: int) -> tuple:
    """(forward ms, backward ms) of one F.batch_norm in training mode on x
    (bf16, its layout; fp32 weight and bias, cuDNN): the library's unmasked
    norm without the ReLU, the yardstick."""
    import torch
    import torch.nn.functional as F

    x = x.detach().clone().requires_grad_()
    c = x.shape[1]
    w = torch.ones(c, device=x.device, requires_grad=True)
    b = torch.zeros(c, device=x.device, requires_grad=True)
    fwd = time_ms(lambda: F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5),
                  iters)
    y = F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5)
    dy = torch.randn_like(y)
    bwd = time_ms(lambda: torch.autograd.grad(y, (x, w, b), dy,
                                              retain_graph=True), iters)
    return fwd, bwd


def norm_phase(iters: int) -> dict:
    """Phase NORM: one eager step of each program in NORM_CELLS (CM-UNet
    at batch 128, MoCo at 256, SparK unfused and fused at 128), its norm
    kernels' calls recorded (`NormCalls`); the first call
    of each signature replayed through its wrapper and its plain version:
    the wrapper's device time (its kernels by the profiler: the eager
    wrapper's host time, which a graph replay does not pay, left out; the
    wall clock beside it), its bytes bound at 3.35 TB/s, the plain
    version's time, the sums held to float64 sums of the same fp32 terms
    (`norm_exact_sums`) at rel 1e-5 of the largest sum, with the plain
    version's fp32 sums' error beside them (where the terms cancel to
    1/2000 of their magnitudes, as in SparK's masked bottleneck, torch's
    fp32 sums are off by 1.8e-5 themselves, so they cannot be the
    yardstick), the count exact, and the element-wise outputs bit for
    bit; for an
    unmasked norm the library's F.batch_norm forward (on the moments row)
    and backward (on the grad sums row) as the yardstick, which the port
    never calls. Per cell, the step's norms by path (none plain) and each
    pass's ms a step (a signature's time times its calls)."""
    import gc

    import torch

    from cmx_torch.models import blocks
    from cmx_torch.ops import _build
    from cmx_torch.ops import batch_norm as bo

    t0 = time.perf_counter()
    out = {}
    for cell, make in NORM_CELLS.items():
        state, step, imgs = make_step(make(), seed=0)
        norms0 = dict(blocks.NORM_CALLS)
        _build.recorded = NormCalls()
        try:
            step(state, imgs)
            torch.cuda.synchronize()
            calls = _build.recorded
        finally:
            _build.recorded = None
        norms = {k: v - norms0[k] for k, v in blocks.NORM_CALLS.items()}
        print(f"NORM {cell} the step's norms by path: {norms}", flush=True)
        if norms["norm_plain"]:
            fail(f"NORM {cell}: {norms['norm_plain']} norms ran plain")
        del state, step, imgs
        gc.collect()
        torch.cuda.empty_cache()
        totals = {n: [0.0, 0.0, 0.0, 0] for n in NORM_PASSES}
        for (name, args), (key, count) in zip(calls, calls.counts.items()):
            fn, plain = getattr(bo, name), getattr(bo, name + "_plain")
            got, ref = fn(*args), plain(*args)
            if name in ("norm_moments", "norm_grad_sums"):
                c = (ref.numel() - ref.numel() % 2) // 2
                exact = norm_exact_sums(name, args)
                err, plain_err = sums_off(got, exact), sums_off(ref, exact)
                vs_plain = max(rel_err(got[:c], ref[:c])[1],
                               rel_err(got[c:2 * c], ref[c:2 * c])[1])
                ok = err <= 1e-5 and torch.equal(got[2 * c:], ref[2 * c:])
                what = (f"sums rel_err {err:.2e} to float64 sums of the "
                        f"same terms (tol 1e-5; the plain version's "
                        f"{plain_err:.2e}), {vs_plain:.2e} to the plain "
                        f"version's")
                del exact
            else:
                ok = torch.equal(got, ref)
                what = f"bits equal {ok}"
            wall = time_ms(lambda: fn(*args), iters)
            ms, kernels_a_call = device_ms(lambda: fn(*args), iters)
            plain_ms = time_ms(lambda: plain(*args), max(2, iters // 5))
            bound = norm_bytes(name, args) / 3.35e12 * 1e3
            x = args[1] if name.startswith("norm_grad") else args[0]
            mask = args[2] if name.startswith("norm_grad") else args[1]
            flags = [a for a in args if isinstance(a, bool)]
            lib = ""
            if mask is None and name == "norm_moments":
                lib = (f"; F.batch_norm forward "
                       f"{_batch_norm_library_ms(x, iters)[0]:.3f} ms")
            elif mask is None and name == "norm_grad_sums":
                lib = (f"; F.batch_norm backward "
                       f"{_batch_norm_library_ms(x, iters)[1]:.3f} ms")
            print(f"NORM {cell} {name} {tuple(x.shape)} "
                  f"{bo.layout_of(x)} {'masked' if mask is not None else 'unmasked'}"
                  f" relu {flags or '-'} x{count} a step: {ms:.4f} device ms "
                  f"({kernels_a_call} kernels; {wall:.4f} ms by the wall "
                  f"clock, eager), bound {bound:.4f} ms "
                  f"({100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms; "
                  f"{what}{lib}", flush=True)
            if not ok:
                fail(f"NORM {cell}: {name} at {tuple(x.shape)} differs from "
                     f"its plain version ({what})")
            t = totals[name]
            t[0] += count * ms
            t[1] += count * bound
            t[2] += count * plain_ms
            t[3] += count
            del got, ref
        del calls
        gc.collect()
        torch.cuda.empty_cache()
        out[cell] = totals
        print(f"NORM {cell} a step, by pass (calls: kernel / bound / plain "
              f"ms): " + "; ".join(
                  f"{n} ({t[3]}): {t[0]:.3f} / {t[1]:.3f} / {t[2]:.3f}"
                  for n, t in totals.items())
              + f"; all four: {sum(t[0] for t in totals.values()):.3f} / "
              f"{sum(t[1] for t in totals.values()):.3f} / "
              f"{sum(t[2] for t in totals.values()):.3f}", flush=True)
    print(f"NORM took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def make_mae_cfg(batch: int, fused: bool):
    """PRESETS["mae"] at full width: UNet(out_classes=1), 256^2, bf16, SGD
    lr 1e-2 momentum 0.9, mask 0.5, patch 16; model.fused_conv=`fused`."""
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS

    cfg = PRESETS["mae"](Config())
    apply_overrides(cfg, [f"train.batch_size={batch}", "data.image_size=256",
                          f"model.fused_conv={fused}"])
    return cfg


def mae_phase(batch: int, steps: int, iters: int):
    """Phase MAE1 (see the module docstring). Returns (the per-step calls,
    the launches of the 8-step run, the fused and unfused step_ms, the
    K1/K2 replay sums)."""
    import torch

    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.ops.masking import random_patch_mask
    from cmx_torch.ssl.reconstruction import make_mae_task

    state, step, imgs = make_step(make_mae_cfg(batch, True))
    calls, loss = record_step(state, step, imgs)
    per_step = collections.Counter(name for name, _ in calls)
    print(f"MAE1 recorded step: kernel calls per step {dict(per_step)} "
          f"(expected K1 6, K2 6); loss {loss:.6f}", flush=True)
    if dict(per_step) != {n: 6 for n in FLAT_KERNELS}:
        fail(f"the MAE step called {dict(per_step)}, expected K1 6 and K2 6")
    print("MAE1 replay of every K1/K2 call of the recorded step:", flush=True)
    kern = kernel_phase(calls, iters)
    del calls
    torch.cuda.empty_cache()
    launches, step_ms = step_phase(state, step, imgs, per_step, steps,
                                   "mae fused", ff.FlatDoubleConv)
    del state, step
    torch.cuda.empty_cache()

    plain, pstep, plain_ms = unfused_phase(make_mae_cfg(batch, False), steps,
                                           "mae unfused", imgs)
    print(f"mae fused step_ms={step_ms:.3f} unfused step_ms={plain_ms:.3f} "
          f"(fused/unfused {step_ms / plain_ms:.3f}; batch {batch}, "
          f"{imgs.shape[-1]}^2, bf16, SGD)", flush=True)

    # the fused model against the plain one from the same weights and mask
    fused, _, _ = make_step(make_mae_cfg(2, True))
    gen = torch.Generator(device="cuda").manual_seed(3)
    draws = {"active": random_patch_mask(gen, 2, imgs.shape[-1], 16, 0.5)}
    compare_plain("mae", fused.model, plain.model, lambda m, _: (
        make_mae_task(m)[0].loss_fn(m, imgs[:2], gen, draws)[0]))
    del fused, plain, pstep, imgs
    torch.cuda.empty_cache()
    return dict(per_step), launches, step_ms, plain_ms, kern


def cm_cli_phase(work: Path, data_dir: str, mae_per_step: dict):
    """Phase CM-CLI (see the module docstring). Returns (the phase's
    seconds, the exported encoder.npz)."""
    import contextlib

    import numpy as np
    import torch

    from cmx_torch.ckpt.checkpoint import load_encoder
    from cmx_torch.cli.pretrain import main as pretrain_main
    from cmx_torch.models.unet import UNet
    from cmx_torch.train.graph import REPORTS

    t0 = time.perf_counter()
    wrappers = {name: k[0] for name, k in kernels().items()}
    base = ["data.synthetic=True", f"data.synthetic_n={CLI_IMAGES}",
            f"data.data_dir={data_dir}", f"data.image_size={CLI_SIZE}",
            f"train.batch_size={CM_CLI_BATCH}", "train.patience=5"]
    runs = []
    for task, args in (("cmunet", ["train.epochs=2",
                                   "train.save_every_epoch=True"]),
                       ("cmunet", ["train.epochs=3",
                                   "train.save_every_epoch=True"]),
                       ("mae_tuned", ["train.epochs=1",
                                      "model.fused_conv=True"])):
        for fn in wrappers.values():
            fn.launches = 0
        since = len(REPORTS)
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            out = pretrain_main(["--task", task, "--preset"] + base + args
                                + [f"train.ckpt_dir={work}/cm_ckpt"])
        torch.cuda.synchronize()
        launches = graph_launches(
            wrappers, since, {} if task == "cmunet" else mae_per_step,
            "CM-CLI")
        steps = out["steps_per_epoch"] * (out["epochs_run"] - (
            runs[-1][1]["epochs_run"] if task == "cmunet" and runs else 0))
        val = out["val_batches"] * (1 if task == "mae_tuned" else 0)
        # MAE: validation forwards run K1 too (train-mode BN, as cmx's)
        expect = ({n: 0 for n in wrappers} if task == "cmunet" else
                  {n: mae_per_step.get(n, 0) * (
                      steps + (val if n == "flat_conv3x3_mask_stats" else 0))
                   for n in wrappers})
        rates = re.findall(r"epoch (\d+): .*?\(([\d.]+)s, ([\d.]+) img/s\)",
                           "".join(tee.lines))
        resumed = re.findall(r"resumed from step (\d+)", "".join(tee.lines))
        print(f"CM-CLI --task {task} --preset {' '.join(args)}: "
              f"{steps} training steps ({graphs_since(since)}), "
              f"{out['val_batches']} validation "
              f"batches an epoch, resumed from {resumed or 'none'}; epoch "
              f"img/s " + ", ".join(f"epoch {e}: {r} img/s in {t} s"
                                    for e, t, r in rates)
              + f"; launches (eager calls + capture calls x replays) "
              f"{launches} (expected {expect})", flush=True)
        g = out["graph"]
        if launches != expect or (g["eager_steps"], g["replays"]) != (
                1, steps - 1):
            fail(f"the {task} CLI run did not launch the expected kernels "
                 f"or was not replayed from its graph ({g})")
        runs.append((task, out))
    cm = runs[1][1]
    if [r[1]["state"].step for r in runs[:2]] != [
            2 * cm["steps_per_epoch"], 3 * cm["steps_per_epoch"]]:
        fail("the CM-UNet CLI did not resume to its third epoch")
    with open(Path(cm["ckpt_dir"]) / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    print(f"CM-CLI log.jsonl: epochs {[r['epoch'] for r in log]}, loss_ct "
          f"{[round(r['loss_ct'], 6) for r in log]}, loss_rc "
          f"{[round(r['loss_rc'], 6) for r in log]}, val_loss "
          f"{[round(r['val_loss'], 6) for r in log]}", flush=True)
    if [r["epoch"] for r in log] != [0, 1, 2] or not all(
            math.isfinite(r[k]) for r in log
            for k in ("loss", "loss_ct", "loss_rc", "val_loss")):
        fail("the CM-UNet CLI's log.jsonl lacks an epoch or holds a "
             "non-finite value")
    fresh = load_encoder(cm["encoder"], UNet(dtype=torch.bfloat16).to("cuda"))
    final = cm["state"].model.encoder.state_dict()
    same = all(torch.equal(t, final[n])
               for n, t in fresh.encoder.state_dict().items())
    with np.load(cm["encoder"]) as f:
        n_files = len(f.files)
    print(f"CM-CLI export: encoder.npz ({n_files} arrays) reloaded into a "
          f"fresh UNet: encoder equal bit for bit {same}", flush=True)
    if not same:
        fail("the CM-UNet CLI's encoder.npz does not reload to the run's "
             "encoder")
    encoder = cm["encoder"]
    del runs, cm, fresh
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"CM-CLI phase took {secs:.1f} s", flush=True)
    return secs, encoder


GENESIS_BATCH = 64  # the genesis preset's batch
DV_BATCH = 32       # DV's batch: the SparK phase's and FT1's


def make_genesis_cfg(batch: int, fused: bool):
    """PRESETS["genesis"] at full width: UNet(out_classes=1), 256^2, bf16,
    SGD lr 1e-2 momentum 0.9, the reference's distortion rates;
    model.fused_conv=`fused`."""
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS

    cfg = PRESETS["genesis"](Config())
    apply_overrides(cfg, [f"train.batch_size={batch}", "data.image_size=256",
                          f"model.fused_conv={fused}"])
    return cfg


def genesis_phase(batch: int, steps: int, iters: int):
    """Phase G1 (see the module docstring). Returns (the per-step calls,
    the launches of the timed run, the K1/K2 replay sums, its numbers)."""
    import torch

    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.ops.genesis import genesis_batch, genesis_draws
    from cmx_torch.ssl.reconstruction import make_genesis_task

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = make_genesis_cfg(batch, True)
    state, step, imgs = make_step(cfg)
    calls, loss = record_step(state, step, imgs)
    per_step = collections.Counter(name for name, _ in calls)
    print(f"G1 recorded step: kernel calls per step {dict(per_step)} "
          f"(predicted K1 6, K2 6: down1, down2 and up1); loss {loss:.6f}",
          flush=True)
    if dict(per_step) != {n: 6 for n in FLAT_KERNELS}:
        fail(f"the Genesis step called {dict(per_step)}, expected K1 6 and "
             f"K2 6")
    print("G1 replay of every K1/K2 call of the recorded step:", flush=True)
    kern = kernel_phase(calls, iters)
    del calls
    torch.cuda.empty_cache()
    launches, step_ms = step_phase(state, step, imgs, per_step, steps,
                                   "genesis fused", ff.FlatDoubleConv)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the distortion chain alone, at the step's batch
    t = cfg.task
    rates = dict(flip_rate=t.genesis_flip_rate,
                 local_rate=t.genesis_local_rate,
                 nonlinear_rate=t.genesis_nonlinear_rate,
                 paint_rate=t.genesis_paint_rate,
                 inpaint_rate=t.genesis_inpaint_rate)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def chain():
        return genesis_batch(imgs, gen, **rates)

    chain_ms = time_ms(chain, iters)
    chain_dev, chain_ops = device_ms(chain)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, y = chain()
    except RuntimeError as e:
        fail(f"genesis_batch synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (bool(torch.isfinite(x).all()) and x.shape == y.shape
            == imgs.shape):
        fail("genesis_batch gave a non-finite or misshapen pair")
    print(f"G1 chain: genesis_batch at batch {batch}, 256^2: {chain_ms:.3f} "
          f"ms a call (CUDA events, {iters} calls), {chain_dev:.3f} ms of "
          f"device time in {chain_ops} device operations (profiler); "
          f"{100 * chain_ms / step_ms:.1f}% of the fused step's "
          f"{step_ms:.3f} ms; no host synchronisation under "
          f"set_sync_debug_mode('error'); peak memory {peak:.2f} GiB "
          f"(max_memory_allocated over set-up, the recorded and the timed "
          f"steps)", flush=True)
    del state, step, x, y
    torch.cuda.empty_cache()

    plain, pstep, plain_ms = unfused_phase(make_genesis_cfg(batch, False),
                                           steps, "genesis unfused", imgs)
    print(f"genesis fused step_ms={step_ms:.3f} unfused step_ms="
          f"{plain_ms:.3f} (fused/unfused {step_ms / plain_ms:.3f}; batch "
          f"{batch}, 256^2, bf16, SGD)", flush=True)

    fused, _, _ = make_step(make_genesis_cfg(2, True))
    draws = genesis_draws(gen, 2, 256, 256)
    compare_plain("genesis", fused.model, plain.model, lambda m, _: (
        make_genesis_task(m, **rates)[0].loss_fn(m, imgs[:2], None,
                                                 draws)[0]))
    del fused, plain, pstep, imgs
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"G1 phase took {secs:.1f} s", flush=True)
    return dict(per_step), launches, kern, {
        "step_ms": step_ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
        "chain_device_ms": chain_dev, "peak_gib": peak}


def one_epoch_cli(label: str, work: Path, data_dir: str, task: str,
                  args: list, per_step: dict, val_calls: dict):
    """`cmx_torch.cli.pretrain.main --task <task> --preset` with the
    overrides `args` for one epoch on the CLI
    phase's corpus at batch CM_CLI_BATCH, with validation: each kernel's
    launches equal `per_step` times the training steps plus `val_calls`
    times the validation batches (the validation forwards run no backward);
    log.jsonl finite; encoder.npz reloaded into a fresh UNet bit for bit.
    Returns (its seconds, the CLI's stdout lines)."""
    import contextlib

    import torch

    from cmx_torch.ckpt.checkpoint import load_encoder
    from cmx_torch.cli.pretrain import main as pretrain_main
    from cmx_torch.models.unet import UNet

    from cmx_torch.train.graph import REPORTS

    t0 = time.perf_counter()
    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    since = len(REPORTS)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = pretrain_main([
            "--task", task, "--preset", "data.synthetic=True",
            f"data.synthetic_n={CLI_IMAGES}", f"data.data_dir={data_dir}",
            f"data.image_size={CLI_SIZE}",
            f"train.batch_size={CM_CLI_BATCH}", "train.patience=5",
            "train.epochs=1", f"train.ckpt_dir={work}/{label}_ckpt"] + args)
    torch.cuda.synchronize()
    launches = graph_launches(wrappers, since, per_step, label)
    steps, val = out["state"].step, out["val_batches"]
    expect = {n: per_step.get(n, 0) * steps + val_calls.get(n, 0) * val
              for n in wrappers}
    rates = re.findall(r"epoch (\d+): .*?\(([\d.]+)s, ([\d.]+) img/s\)",
                       "".join(tee.lines))
    print(f"{label} --task {task} --preset {' '.join(args)}: {steps} "
          f"training steps ({graphs_since(since)}), {val} validation "
          f"batches; epoch img/s "
          + ", ".join(f"epoch {e}: {r} img/s in {t} s" for e, t, r in rates)
          + f"; launches (eager calls + capture calls x replays) {launches} "
          f"(expected {expect})", flush=True)
    g = out["graph"]
    if (launches != expect or not steps or not val
            or (g["eager_steps"], g["replays"]) != (1, steps - 1)):
        fail(f"the {label} CLI run did not launch the expected kernels or "
             f"was not replayed from its graph ({g})")
    with open(Path(out["ckpt_dir"]) / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    if [r["epoch"] for r in log] != [0] or not all(
            math.isfinite(r[k]) for r in log for k in ("loss", "val_loss")):
        fail(f"the {label} CLI's log.jsonl lacks its epoch or holds a "
             f"non-finite loss")
    fresh = load_encoder(out["encoder"], UNet(dtype=torch.bfloat16).to("cuda"))
    final = out["state"].model.encoder.state_dict()
    same = all(torch.equal(t, final[n])
               for n, t in fresh.encoder.state_dict().items())
    print(f"{label} export: loss {log[0]['loss']:.6f} val_loss "
          f"{log[0]['val_loss']:.6f}; encoder.npz reloaded into a fresh UNet: "
          f"encoder equal bit for bit {same}", flush=True)
    if not same:
        fail(f"the {label} CLI's encoder.npz does not reload to the run's "
             f"encoder")
    del out, fresh, final
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"{label} phase took {secs:.1f} s", flush=True)
    return secs, "".join(tee.lines).splitlines()


def genesis_cli_phase(work: Path, data_dir: str, per_step: dict) -> float:
    """Phase G-CLI (see the module docstring). Returns its seconds."""
    # validation forwards run K1 too (train-mode BN, as cmx's)
    return one_epoch_cli(
        "G-CLI", work, data_dir, "genesis_tuned", ["model.fused_conv=True"],
        per_step,
        {"flat_conv3x3_mask_stats": per_step["flat_conv3x3_mask_stats"]})[0]


def dv_steps(label: str, state, step, batch_t, expect: dict, steps: int):
    """A decoder variant's recorded step, its calls per kernel equal to
    `expect` (the gate's prediction), then step_phase: `steps` steps with
    every kernel's launches equal to those calls times the steps, and a
    two-step profile. Returns (step_ms, the launches)."""
    from cmx_torch.ops import fused_conv_flat as ff

    calls, loss = record_step(state, step, batch_t)
    per_step = dict(collections.Counter(name for name, _ in calls))
    print(f"DV {label} recorded step: kernel calls per step {per_step} "
          f"(predicted {expect}); loss {loss:.6f}", flush=True)
    if per_step != expect:
        fail(f"the {label} step called {per_step}, expected {expect}")
    del calls
    launches, step_ms = step_phase(state, step, batch_t, per_step, steps,
                                   f"DV {label}", ff.FlatDoubleConv)
    return step_ms, launches


def make_spark_variant(batch: int, fused: bool, fused_decoder: bool):
    """(state, step, imgs): the SparK step of phase 2 (LAMB lr 2e-4 wd 0.04
    clip 5; K3 with `fused`) on SparKModel(fused=`fused`,
    fused_decoder=`fused_decoder`), built directly, as no config field
    reaches fused_decoder in cmx either; weights from the config's seed."""
    import torch

    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    cfg = make_cfg(batch, fused)
    model = SparKModel(mask_ratio=cfg.task.mask_ratio, dtype=torch.bfloat16,
                       fused=fused, fused_decoder=fused_decoder)
    model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    model = model.to("cuda")
    task, _ = make_spark_task(model, input_size=256, pallas_loss=fused)
    o = cfg.optim
    tx = make_optimizer(o.name, o.lr, o.weight_decay, clip_norm=o.clip_norm,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx, seed=cfg.train.seed)
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randn((batch, 256, 256), generator=gen, device="cuda")
    return state, make_train_step(task, tx), imgs


def decoder_variants_phase(batch: int, steps: int):
    """Phase DV (see the module docstring). Returns ({variant: step_ms},
    the launches of the three timed runs, summed)."""
    import torch

    from cmx_torch.ops.augment import _crop_window_params, finetune_draws
    from cmx_torch.ops.masking import spark_active_mask
    from cmx_torch.ssl.spark import make_spark_task
    from cmx_torch.train.supervised import make_supervised_task

    t0 = time.perf_counter()
    k1, k2 = FLAT_KERNELS
    k3 = {"spark_loss_pallas": 1, "spark_loss_bwd": 1}
    total = collections.Counter()
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    spark_draws = {"crop": _crop_window_params(gen, 2, 256, 256, 256,
                                               (0.67, 1.0), (3 / 4, 4 / 3)),
                   "flip": torch.tensor([True, False], device="cuda"),
                   "active": spark_active_mask(gen, 2, 16, 0.6)}

    def spark_loss_of(m, pallas_loss):
        task, _ = make_spark_task(m, input_size=256, pallas_loss=pallas_loss)
        return task.loss_fn(m, imgs[:2], None, spark_draws)[0]

    # SparK with LightDecoder: the CLI's spark task with task.full_unet=False
    from cmx_torch.config.config import apply_overrides

    cfgs = [apply_overrides(make_cfg(n, f), ["task.full_unet=False"])
            for n, f in ((batch, True), (2, True), (2, False))]
    state, step, imgs = make_step(cfgs[0])
    width = state.model.densify_proj0.kernel.shape[0]
    print(f"DV spark_light: SparKModel(full_unet=False), decoder_width "
          f"{width}, params {sum(p.numel() for p in state.model.parameters())}",
          flush=True)
    times["spark_light"], launches = dv_steps(
        "spark_light", state, step, imgs, {k1: 4, k2: 4, **k3}, steps)
    total.update(launches)
    del state, step
    fused, _, _ = make_step(cfgs[1])
    plain, _, _ = make_step(cfgs[2])
    compare_plain("DV spark_light", fused.model, plain.model, spark_loss_of)
    del fused, plain
    torch.cuda.empty_cache()

    # SparK with the fused UNet decoder: up1 joins down1 and down2
    state, step, imgs = make_spark_variant(batch, True, True)
    times["spark_fused_decoder"], launches = dv_steps(
        "spark_fused_decoder", state, step, imgs, {k1: 6, k2: 6, **k3}, steps)
    total.update(launches)
    del state, step
    fused, _, _ = make_spark_variant(2, True, True)
    plain, _, _ = make_spark_variant(2, False, False)
    compare_plain("DV spark_fused_decoder", fused.model, plain.model,
                  spark_loss_of)
    del fused, plain, imgs
    torch.cuda.empty_cache()

    # the fine-tune UNet in bilinear mode: up1's concat 128 + 64 > 128
    state, step, batch_t = make_ft_step(True, batch, "bilinear")
    times["unet_bilinear"], launches = dv_steps(
        "unet_bilinear", state, step, batch_t, {k1: 4, k2: 4}, steps)
    total.update(launches)
    del state, step
    fused, _, _ = make_ft_step(True, 2, "bilinear")
    plain, _, _ = make_ft_step(False, 2, "bilinear")
    draws = finetune_draws(gen, 2, CLI_SIZE, CLI_SIZE)
    sub = tuple(t[:2] for t in batch_t)
    compare_plain("DV unet_bilinear", fused.model, plain.model, lambda m, _: (
        make_supervised_task(m, augment=True)[0].loss_fn(m, sub, None,
                                                         draws)[0]))
    del fused, plain, batch_t
    torch.cuda.empty_cache()
    print(f"DV (batch {batch}, 256^2, bf16): " + ", ".join(
        f"{k} step_ms={v:.3f} img_per_s={batch / v * 1e3:.2f}"
        for k, v in times.items())
        + f"; the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return times, dict(total)


RM_BATCH = 128             # bench.py's headline batch (SparK)
RM_LEVELS = "e1,e2,d1,d2"  # model.remat of the RM runs


def make_rm_cfg(task: str, batch: int, remat: str):
    """Phase 2's SparK config (`task` "spark") or MAE1's fused one ("mae")
    at `batch`, with model.remat=`remat`."""
    cfg = make_cfg(batch) if task == "spark" else make_mae_cfg(batch, True)
    cfg.model.remat = remat
    return cfg


def rm_config(label: str, cfg, expect: dict, steps: int, iters: int = 0):
    """One RM configuration: the step of `cfg` (its weights from the
    config's seed, make_step's images; the step draws from (seed, step)),
    one recorded step whose calls per kernel must equal `expect`, with
    `iters` every call replayed as in phase 1; then step_phase (`steps`
    steps with the launches checked, step time, a two-step profile) and the
    peak device memory over it. Returns its numbers, the recorded step's
    loss, grad norm and BN running statistics, and the replay's sums."""
    import torch

    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv_flat as ff

    state, step, imgs = make_step(cfg)
    _build.recorded = KernelCalls()
    try:
        m = step(state, imgs)
        torch.cuda.synchronize()
        calls = list(_build.recorded)
    finally:
        _build.recorded = None
    per_step = dict(collections.Counter(name for name, _ in calls))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    buffers = {n: b.clone() for n, b in state.model.named_buffers()}
    print(f"RM {label} recorded step: kernel calls per step {per_step} "
          f"(predicted {expect}); loss {loss!r} grad_norm {gnorm!r}",
          flush=True)
    if per_step != expect:
        fail(f"the RM {label} step called {per_step}, expected {expect}")
    kern = kernel_phase(calls, iters) if iters else None
    del calls, m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, step_ms = step_phase(state, step, imgs, per_step, steps,
                                   f"RM {label}", ff.FlatDoubleConv)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = imgs.shape[0]
    print(f"RM {label}: batch {batch} step_ms={step_ms:.3f} img_per_s="
          f"{batch / step_ms * 1e3:.2f} peak {peak:.2f} GiB "
          f"(max_memory_allocated over the {steps} steps and the profile)",
          flush=True)
    del state, step, imgs
    torch.cuda.empty_cache()
    return {"batch": batch, "step_ms": step_ms, "peak_gib": peak,
            "loss": loss, "grad_norm": gnorm, "buffers": buffers,
            "per_step": per_step, "launches": launches, "kern": kern}


def rm_pair(task: str, expect: dict, steps: int, iters: int = 0):
    """A task at RM_BATCH without remat and with RM_LEVELS, from the same
    weights, images and draws: the remat run's first loss and every BN
    running statistic after its first step equal the run's without remat
    bit for bit, its grad norm within phase 3's 2e-2, its peak lower. A
    run without remat that does not fit at RM_BATCH is the finding: it is
    printed, and both run at RM_BATCH // 2. A failure of a remat run is
    never caught. Returns {"plain": ..., "remat": ...}."""
    import torch

    batch = RM_BATCH
    try:
        plain = rm_config(f"{task} remat=''", make_rm_cfg(task, batch, ""),
                          expect[""], steps, iters)
    except torch.cuda.OutOfMemoryError as e:
        print(f"RM {task}: without remat, batch {batch} does not fit the "
              f"card ({str(e).splitlines()[0]}); both configurations run "
              f"at batch {batch // 2}", flush=True)
        torch.cuda.empty_cache()
        batch //= 2
        plain = rm_config(f"{task} remat=''", make_rm_cfg(task, batch, ""),
                          expect[""], steps, iters)
    remat = rm_config(f"{task} remat={RM_LEVELS}",
                      make_rm_cfg(task, batch, RM_LEVELS), expect[RM_LEVELS],
                      steps)
    same_bn = [n for n, b in plain["buffers"].items()
               if not torch.equal(b, remat["buffers"][n])]
    d_gnorm = abs(remat["grad_norm"] - plain["grad_norm"]) / plain[
        "grad_norm"]
    print(f"RM {task} batch {batch}: step-1 loss without remat "
          f"{plain['loss']!r}, with {remat['loss']!r} (bit for bit "
          f"{plain['loss'] == remat['loss']}); BN running stats bit for bit "
          f"{not same_bn} ({len(plain['buffers'])} buffers); grad norm rel "
          f"diff {d_gnorm:.3e} (tol 2e-2); step_ms {plain['step_ms']:.3f} -> "
          f"{remat['step_ms']:.3f} ({remat['step_ms'] / plain['step_ms']:.3f}"
          f"x); peak {plain['peak_gib']:.2f} -> {remat['peak_gib']:.2f} GiB",
          flush=True)
    if plain["loss"] != remat["loss"] or same_bn or d_gnorm > 2e-2:
        fail(f"the RM {task} step with remat differs from the step without "
             f"(BN stats that differ: {same_bn[:4]})")
    if remat["peak_gib"] >= plain["peak_gib"]:
        fail(f"remat did not lower the {task} step's peak memory")
    for r in (plain, remat):
        del r["buffers"]
    return {"plain": plain, "remat": remat}


def rm_cli_phase(work: Path, data_dir: str, mae: dict) -> float:
    """Phase RM-CLI (see the module docstring): one_epoch_cli with --task
    mae_tuned model.fused_conv=True model.remat=RM_LEVELS
    train.tensorboard=True, K1/K2 per step RM's MAE remat step's, the
    validation forwards K1 as the MAE step without remat (validation runs
    no backward, so no recompute); the CLI's line that says whether a
    TensorBoard writer was made. Returns its seconds."""
    k1 = "flat_conv3x3_mask_stats"
    secs, lines = one_epoch_cli(
        "RM-CLI", work, data_dir, "mae_tuned",
        ["model.fused_conv=True", f"model.remat={RM_LEVELS}",
         "train.tensorboard=True"],
        mae["remat"]["per_step"], {k1: mae["plain"]["per_step"][k1]})
    tb = [line for line in lines if line.startswith("tensorboard:")]
    print(f"RM-CLI: the CLI's TensorBoard line: {tb}", flush=True)
    if len(tb) != 1:
        fail("the CLI did not say whether it made a TensorBoard writer")
    return secs


EV_IMAGES = (4, 300)  # apis.inference_model: 4 images of 300^2 -> 256^2


def ev_phase(encoder: str, data_dir: str) -> dict:
    """Phase EV: `cmx_torch.cli.evaluate.main` on the card, as a user runs
    it, with the CLI phase's encoder.npz and corpus at CLI_SIZE^2: --probe
    (the 512-wide MLP) and --vis on the CLI phase's checkpoint dir (its
    model.npz); its test metrics finite, the probe's accuracies in [0, 1],
    the reconstruction file written (PNG, or .npz without matplotlib), no
    kernel of the port launched (eval mode: the fused gate asks for
    training, in cmx too), its seconds. Then apis.init_model from the same
    encoder.npz and apis.inference_model on EV_IMAGES (a downscale):
    probabilities of shape (4, 256, 256, 2), class-last, that sum to 1
    within 1e-5. Returns its numbers."""
    import contextlib

    import numpy as np
    import torch

    from cmx_torch.apis import inference_model, init_model
    from cmx_torch.cli.evaluate import main as evaluate_main

    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    ckpt = str(Path(encoder).parent)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)):
        metrics = evaluate_main([
            "--encoder", encoder, "--probe", "--vis", ckpt,
            f"data.data_dir={data_dir}", f"data.image_size={CLI_SIZE}"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    vis = metrics.get("vis_path", "")
    numbers = {k: v for k, v in metrics.items() if k != "vis_path"}
    print(f"EV evaluate --encoder --probe --vis: {secs:.1f} s; metrics "
          f"{numbers}; visualization {Path(vis).suffix or 'none'} "
          f"({'written' if vis and Path(vis).is_file() else 'missing'}); "
          f"launches of the port's kernels {launches or 'none'}", flush=True)
    if not all(math.isfinite(v) for v in numbers.values()):
        fail("the evaluate CLI gave a non-finite metric")
    if not all(0.0 <= numbers[k] <= 1.0
               for k in ("probe_train_acc", "probe_test_acc")):
        fail("the probe's accuracies are not in [0, 1]")
    if not (vis and Path(vis).is_file()):
        fail("the evaluate CLI wrote no visualization")
    if launches:
        fail("the evaluate CLI launched a kernel of the port")

    model = init_model(encoder)
    n, size = EV_IMAGES
    gen = torch.Generator(device="cuda").manual_seed(11)
    imgs = torch.randn((n, size, size), generator=gen, device="cuda")
    probs = inference_model(model, imgs, size=CLI_SIZE)
    torch.cuda.synchronize()
    infer_ms = time_ms(lambda: inference_model(model, imgs, size=CLI_SIZE),
                       ITERS)
    err = float(np.abs(probs.sum(-1) - 1.0).max())
    print(f"EV apis.inference_model: {n} images of {size}^2 -> probabilities "
          f"{probs.shape} {probs.dtype}, sum over classes within {err:.2e} "
          f"of 1 (tol 1e-5), finite {bool(np.isfinite(probs).all())}; "
          f"{infer_ms:.3f} ms a call (CUDA events, {ITERS} calls: resize, "
          f"forward, softmax and the copy to the host)", flush=True)
    if probs.shape != (n, CLI_SIZE, CLI_SIZE, 2) or err > 1e-5 \
            or not np.isfinite(probs).all():
        fail("apis.inference_model gave wrong probabilities")
    del model, imgs
    torch.cuda.empty_cache()
    return {"secs": secs, "infer_ms": infer_ms, "vis": Path(vis).suffix}


# ---------------------------------------------------------------------------
# Data parallel (cmx_torch.parallel): DP1, DP2 and DP-CLI
# ---------------------------------------------------------------------------

DP2_BATCH = 16  # DP2: each of the two ranks' batch (the one process: 32)
DP2_STEPS = 4   # DP2: steps a rank takes (the first two are warm-up)
# ------------------------------------------------ MoCo's fast view pipeline

VIEW_ROTATIONS = ("nearest", "shear3", "bilinear")
VIEW_IMPLS = ("scale_translate", "pallas", "einsum", "einsum_bf16", "bank",
              "bank_fused")
VIEW_CHECK = 4  # images of each card view held against the CPU
VIEW_REPEATS = 5  # VIEWS times each view this many times: median, min, max
LIB_CHECK = 8   # images of each LIB op held against the CPU
# the CPU tests' tolerances: rel 1e-5 of the largest entry, einsum_bf16's
# bf16 margin 2e-2, the nearest rotations' share of differing pixels 1e-3
VIEW_TOL = {"einsum_bf16": 2e-2}
PIXEL_SHARE = 1e-3
# the bilinear rotation, card against CPU (`bilinear_rot_tol`): the source
# coordinate c*y - s*x + centre (|x|, |y| <= 127.5 at 256^2) takes cos and
# sin from each side's library, which may differ by up to 3 ulps (CUDA's
# sinf/cosf are within 2 ulps, the CPU's within 1; an ulp below 1 is at most
# 2^-24), so the coordinate moves by up to 2 * 127.5 * 3 * 2^-24 = 4.6e-5
# px, plus half an ulp of each product (127.5: 3.8e-6) and of each of the
# two sums (255: 7.6e-6): BILINEAR_SHIFT_PX in all. A bilinear sample moves
# by at most that shift times the largest step between neighbours along
# each axis of the zero-padded image, plus the rounding of its four terms
# (8 ulps of the largest value). The CPU test, both sides' sin/cos on the
# CPU, holds 1e-5.
BILINEAR_SHIFT_PX = 2 * 127.5 * 3 * 2.0 ** -24 + 2 * 3.8e-6 + 2 * 7.6e-6
# S2D's phase_conv5 against F.conv2d, fp32 (TF32 off): cuDNN may pick a
# Winograd or FFT algorithm, which rounds otherwise than a direct sum
S2D_TOL = 1e-4
S2D_SHAPE = (32, 64, 64, 256)  # batch, Cin, Cout, side


def make_moco_fast_cfg(batch: int):
    """PRESETS["moco_fast"] (shear3, bank_fused) at full width: 256^2
    images, 224^2 views, bf16, SGD, queue 65536."""
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS

    cfg = PRESETS["moco_fast"](Config())
    apply_overrides(cfg, [f"train.batch_size={batch}", "data.image_size=256"])
    return cfg


def mf_phase(batch: int, steps: int, k4_ms, work: Path) -> dict:
    """Phase MF (see the module docstring). `k4_ms` is phase 5's K4 step
    time from this call, or None (--views), when MF times that step first.
    Returns its numbers."""
    import torch

    from cmx_torch.utils.profiling import trace

    wrappers = {name: k[0] for name, k in kernels().items()}
    if k4_ms is None:
        state, step, imgs = make_step(make_moco_cfg(batch, "pallas"))
        record_step(state, step, imgs)
        k4_ms, _ = moco_run(state, step, imgs, steps, "MF: phase 5's K4 step")
        del state, step, imgs
        torch.cuda.empty_cache()
    cfg = make_moco_fast_cfg(batch)
    torch.cuda.reset_peak_memory_stats()
    state, step, imgs = make_step(cfg)  # phase 5's weights, queue, images
    print(f"MF: PRESETS['moco_fast'] rotation_method="
          f"{cfg.task.rotation_method} crop_impl={cfg.task.crop_impl}, "
          f"batch {batch}, images {tuple(imgs.shape)}, views "
          f"{cfg.task.view_size}^2", flush=True)
    calls, loss0 = record_step(state, step, imgs)
    print(f"MF recorded step: loss {loss0:.6f}, kernel calls "
          f"{[name for name, _ in calls]} (expected none)", flush=True)
    if calls:
        fail("the moco_fast step called a kernel of the port")
    for fn in wrappers.values():
        fn.launches = 0
    step_ms, _ = moco_run(state, step, imgs, steps, "MF moco_fast")
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches.values()):
        fail(f"the moco_fast steps launched kernels of the port: {launches}")
    profile_steps(lambda: step(state, imgs), 2, step_ms, "MF moco_fast")
    # LIB's profiling.trace: one MF step, its Chrome trace read back
    with trace(str(work / "mf_trace"), "mf_step.json",
               torch.device("cuda")) as path:
        step(state, imgs)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"LIB profiling.trace of one MF step: {path} ({len(events)} "
          f"events, {n_kernels} device kernels)", flush=True)
    if not n_kernels:
        fail("profiling.trace wrote no device kernel of the MF step")
    print(f"MF (same call): moco_fast step_ms={step_ms:.3f} img_per_s="
          f"{batch / step_ms * 1e3:.2f} peak {peak:.2f} GiB; phase 5's K4 "
          f"step (moco + crop_impl=pallas) step_ms={k4_ms:.3f} img_per_s="
          f"{batch / k4_ms * 1e3:.2f} (moco_fast/K4 {step_ms / k4_ms:.3f})",
          flush=True)
    del state, step, imgs
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "k4_ms": k4_ms, "peak_gib": peak}


def _check_view(label: str, got, ref, tol: float) -> float:
    import torch

    err = rel_err(got.cpu(), ref)[1]
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        fail(f"VIEWS {label}: the card's view is not the CPU's (rel "
             f"{err:.3e}, tolerance {tol:g})")
    return err


def _check_bank_rows(d: dict, size: int, out: int, method: str) -> None:
    """The rows bank_axis_weights fetches on the card for the windows of
    `d["box"]`, both axes, equal the numpy bank indexed on the host."""
    import numpy as np

    from cmx_torch.ops import augment as ta

    chi, y0i, cwi, x0i = ta.bank_windows(d["box"], size, size)
    for axis, ch, off in (("h", chi, y0i), ("w", cwi, x0i)):
        lo, hi = ta.crop_ch_range(size, ta.MOCO_SCALE, ta.MOCO_RATIO, size,
                                  axis=axis)
        got = ta.bank_axis_weights(size, out, method, ch, off, lo,
                                   hi).cpu().numpy()
        bank = ta._crop_weight_bank(size, out, method, lo, hi)
        rows = (np.arange(size)[None, :] - off.cpu().numpy()[:, None]
                + ta._BANK_PAD)
        inside = (rows >= 0) & (rows < bank.shape[1])
        want = bank[(ch.cpu().numpy() - lo)[:, None],
                    np.clip(rows, 0, bank.shape[1] - 1)]
        want = np.where(inside[:, :, None], want, np.float32(0.0))
        if not np.array_equal(got, want):
            fail(f"VIEWS: the bank rows fetched on the card ({method}, axis "
                 f"{axis}) are not the numpy bank's")
    print(f"VIEWS bank rows ({method}, {size} -> {out}, both axes, "
          f"{ch.shape[0]} windows): equal to the numpy bank bit for bit",
          flush=True)


def bilinear_rot_tol(imgs) -> tuple:
    """(rel bound, steps) for the bilinear rotation of the (B, H, W)
    `imgs`, card against CPU: BILINEAR_SHIFT_PX times the sum of the largest
    neighbour steps along y and x of the zero-padded images, plus 8 ulps of
    the largest value, over the largest value."""
    import torch
    import torch.nn.functional as F

    x = F.pad(imgs.float(), (1, 1, 1, 1))
    gy = float((x[:, 1:] - x[:, :-1]).abs().max())
    gx = float((x[:, :, 1:] - x[:, :, :-1]).abs().max())
    top = float(imgs.abs().max())
    eps = float(torch.finfo(torch.float32).eps)
    return (BILINEAR_SHIFT_PX * (gy + gx) + 8 * eps * top) / top, (gy, gx)


def _time_spread(fn, iters: int) -> tuple:
    """(median, min, max) ms of VIEW_REPEATS timings of fn (CUDA events)."""
    runs = sorted(time_ms(fn, iters) for _ in range(VIEW_REPEATS))
    return runs[len(runs) // 2], runs[0], runs[-1]


def views_phase(batch: int, cm_batch: int, iters: int) -> dict:
    """Phase VIEWS (see the module docstring). Returns {"ms": view ->
    ms, "k4": K4's launches in the checked pallas views}."""
    import torch

    from cmx_torch.ops import augment as ta
    from cmx_torch.ops import pallas_crop as pc

    gen = torch.Generator(device="cuda").manual_seed(3)
    imgs = torch.randn((batch, 256, 256), generator=gen, device="cuda") + 1.0
    d = ta.moco_view_draws(gen, batch, 256, 256, 224)
    small = {k: v[:VIEW_CHECK].cpu() for k, v in d.items()}
    cpu_imgs = imgs[:VIEW_CHECK].cpu()
    _check_bank_rows(d, 256, 224, "linear")
    ms, k4 = {}, 0
    for rot_m in VIEW_ROTATIONS:
        rot = ta.rotate_batch(imgs, d["angle"], d["rot_apply"], rot_m)
        rot_cpu = ta.rotate_batch(cpu_imgs, small["angle"], small["rot_apply"],
                                  rot_m)
        if rot_m == "bilinear":
            tol, (gy, gx) = bilinear_rot_tol(cpu_imgs)
            how = (f"rel {_check_view(rot_m, rot[:VIEW_CHECK], rot_cpu, tol):.3e}"
                   f" (bound {tol:.3e}: neighbour steps y {gy:.4f}, x "
                   f"{gx:.4f}, shift {BILINEAR_SHIFT_PX:.3e} px)")
        else:
            share = float((rot[:VIEW_CHECK].cpu() != rot_cpu).float().mean())
            how = f"{share:.3e} of the pixels differ"
            if share > PIXEL_SHARE:
                fail(f"VIEWS {rot_m} rotation: {how} (at most {PIXEL_SHARE})")
        print(f"VIEWS {rot_m} rotation on the card against the CPU: {how}",
              flush=True)
        for impl in VIEW_IMPLS:
            label = f"{rot_m}/{impl}"

            def view():
                return ta.moco_view_aug_batch(imgs, 224, rot_m, "linear",
                                              impl, draws=d)

            pc.crop_resize_pallas.launches = 0
            out = view()
            torch.cuda.synchronize()
            n = pc.crop_resize_pallas.launches
            if n != (impl == "pallas"):
                fail(f"VIEWS {label}: K4 launched {n} times, expected "
                     f"{int(impl == 'pallas')}")
            k4 += n
            # the CPU's tail on the card's rotation: the crop, blur, flips
            # and noise held alone (the rotation is held above)
            ref = ta.moco_view_tail(rot[:VIEW_CHECK].cpu(), small, 224,
                                    "linear", impl)
            err = _check_view(label, out[:VIEW_CHECK], ref,
                              VIEW_TOL.get(impl, 1e-5))
            how = f"rel err against the CPU {err:.3e}"
            if impl == "pallas":  # K4 over the whole batch, plain crop on card
                plain = ta.moco_view_tail(rot, d, 224, "linear",
                                          "scale_translate")
                how += (", whole batch against the plain crop on the card "
                        f"{_check_view(label, out, plain.cpu(), 1e-5):.3e}")
            ms[label], lo, hi = _time_spread(view, iters)
            print(f"VIEWS {label}: {ms[label]:.3f} ms (median of "
                  f"{VIEW_REPEATS}, {lo:.3f}-{hi:.3f}) for {batch} views of "
                  f"224^2 (CUDA events), {how}, K4 launches {n}", flush=True)
        del rot
    del d, small
    dc = ta.cmunet_view_draws(gen, cm_batch, 256, 256, 224)
    small = {k: v[:VIEW_CHECK].cpu() for k, v in dc.items()}
    _check_bank_rows(dc, 256, 256, "cubic")
    for impl in (None, "bank", "bank_fused"):
        label = f"cmunet/{impl or 'chain'}"

        def views():
            return ta.cmunet_two_views_batch(imgs[:cm_batch], 224, 31, impl,
                                             draws=dc)

        pc.crop_resize_pallas.launches = 0
        v1, v2 = views()
        r1, r2 = ta.cmunet_two_views_batch(cpu_imgs, 224, 31, impl,
                                           draws=small)
        err = max(_check_view(label, v1[:VIEW_CHECK], r1, 1e-5),
                  _check_view(label, v2[:VIEW_CHECK], r2, 1e-5))
        if pc.crop_resize_pallas.launches:
            fail(f"VIEWS {label} launched K4")
        ms[label], lo, hi = _time_spread(views, iters)
        print(f"VIEWS {label}: {ms[label]:.3f} ms (median of {VIEW_REPEATS}"
              f", {lo:.3f}-{hi:.3f}) for the two views of {cm_batch} images "
              f"(CUDA events), rel err against the CPU {err:.3e}", flush=True)
    del imgs
    torch.cuda.empty_cache()
    print("VIEWS (ms): " + json.dumps({k: round(v, 4) for k, v in ms.items()}),
          flush=True)
    return {"ms": ms, "k4": k4}


def cmb_phase(batch: int, steps: int = 2) -> dict:
    """Phase CMB (see the module docstring). Returns its numbers."""
    import torch

    from cmx_torch.config.config import apply_overrides
    from cmx_torch.train.schedules import scaled_base_lr, warmup_cosine

    cfg = make_cm_cfg(batch)
    apply_overrides(cfg, ["task.crop_impl=bank_fused"])
    lr = warmup_cosine(scaled_base_lr(cfg.optim.lr, batch),
                       cfg.train.epochs, cfg.optim.warmup_epochs)
    state, step, imgs = make_step(cfg, lr=lr, seed=0)
    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, imgs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        print(f"CMB step {i}: " + " ".join(f"{k}={v:.6g}"
                                          for k, v in vals.items()),
              flush=True)
        if not (all(math.isfinite(vals[k]) for k in
                    ("loss", "loss_ct", "loss_rc", "grad_norm"))
                and vals["nonfinite"] == 0.0):
            fail(f"CMB step {i} is not finite: {vals}")
    launches = {n: fn.launches for n, fn in wrappers.items()}
    if any(launches.values()):
        fail(f"the CM-UNet bank_fused step launched kernels: {launches}")
    print(f"CMB: CM-UNet task.crop_impl=bank_fused batch {batch}: {steps} "
          f"steps ({', '.join(f'{t:.3f}' for t in times)} ms, the first "
          f"with the bank's set-up), no kernel of the port launched",
          flush=True)
    del state, step, imgs
    torch.cuda.empty_cache()
    return {"step_ms": times}


def mf_cli_phase(work: Path, data_dir: str) -> float:
    """Phase MF-CLI (see the module docstring). Returns its seconds."""
    return one_epoch_cli("MF-CLI", work, data_dir, "moco_fast", [], {}, {})[0]


def _lib_ops(gen, batch: int, size: int) -> list:
    """(name, fn(imgs, draws), draws, how it is held) for every op of
    augment_extra and auto_augment, draws for `batch` images of size^2."""
    import torch

    from cmx_torch.ops import augment_extra as tx
    from cmx_torch.ops import auto_augment as taa

    n = batch
    views = [tx.apply_draws(gen, n, 0.5) for _ in range(3)]
    ops = [
        ("color_jitter", tx.color_jitter,
         tx.color_jitter_draws(gen, n, p=0.5), "rel"),
        ("random_erasing", tx.random_erasing, tx.random_erasing_draws(gen, n),
         "rel"),
        ("solarize", lambda x, d: tx.solarize(x, d["apply"]),
         tx.apply_draws(gen, n, 0.5), "rel"),
        ("posterize", lambda x, d: tx.posterize(x, d["apply"]),
         tx.apply_draws(gen, n, 0.5), "rel"),
        ("invert", lambda x, d: tx.invert(x, d["apply"]),
         tx.apply_draws(gen, n, 0.5), "rel"),
        ("resize_edge", lambda x, d: tx.resize_edge(x, size // 2), {}, "rel"),
        ("translate", tx.translate, tx.translate_draws(gen, n, size, size),
         "rel"),
        ("dual_resized_crop",
         lambda x, d: torch.cat([v.flatten(1) for v in tx.dual_resized_crop(
             x, 224, 112, d)], 1),
         tx.dual_resized_crop_draws(gen, n, size, size), "rel"),
        ("random_crop_padded",
         lambda x, d: tx.random_crop_padded(x, 224, d, padding=4),
         tx.random_crop_padded_draws(gen, n, size, size, 224, padding=4),
         "rel"),
        ("multi_view",
         lambda x, d: torch.stack(tx.multi_view(x, [
             lambda i, v: tx.invert(v, d[f"apply{i}"]),
             lambda i, v: tx.solarize(v, d[f"apply{i}"])], [2, 1])),
         {f"apply{i}": v["apply"] for i, v in enumerate(views)}, "rel"),
    ]
    geometric = ("shear_x", "shear_y", "translate_x", "translate_y", "rotate")
    for name in geometric + (
            "auto_contrast", "invert", "equalize", "solarize", "solarize_add",
            "posterize", "contrast", "color", "brightness", "sharpness",
            "cutout"):
        ops.append((f"aa.{name}",
                    functools.partial(lambda name, x, d: taa.apply_op(
                        name, 7, x, d), name),
                    taa.op_draws(gen, (n,), 0.5),
                    "pixels" if name in geometric else "rel"))
    ops += [("aa.auto_augment",
             lambda x, d: taa.auto_augment(x, draws=d),
             taa.auto_augment_draws(gen, n), "share"),
            ("aa.rand_augment",
             lambda x, d: taa.rand_augment(x, draws=d),
             taa.rand_augment_draws(gen, n), "share")]
    return ops


def lib_phase(batch: int, iters: int) -> dict:
    """Phase LIB (see the module docstring). Returns name -> ms."""
    import torch
    import torch.nn.functional as F

    from cmx_torch.ops import s2d as ts

    gen = torch.Generator(device="cuda").manual_seed(4)
    size = 256
    imgs = torch.rand((batch, size, size), generator=gen, device="cuda")
    cpu_imgs = imgs[:LIB_CHECK].cpu()
    ms = {}
    for name, fn, d, how in _lib_ops(gen, batch, size):
        out = fn(imgs, d)
        ref = fn(cpu_imgs, {k: v[:LIB_CHECK].cpu() for k, v in d.items()})
        got = out[:LIB_CHECK].cpu() if name != "multi_view" \
            else out[:, :LIB_CHECK].cpu()
        if how == "rel":
            err = rel_err(got, ref)[1]
            ok, shown = err <= 1e-5, f"rel err {err:.3e}"
        else:  # a rounding that an ulp of cos / sin flips moves a pixel
            diff = ((got != ref) if how == "pixels"
                    else ((got - ref).abs() > 1e-5)).float().mean()
            ok = float(diff) <= PIXEL_SHARE
            shown = f"{float(diff):.3e} of the pixels differ"
        if not (ok and bool(torch.isfinite(out).all())):
            fail(f"LIB {name}: the card disagrees with the CPU ({shown})")
        ms[name] = time_ms(lambda: fn(imgs, d), iters)
        print(f"LIB {name}: {ms[name]:.3f} ms at batch {batch} of {size}^2 "
              f"(CUDA events); {LIB_CHECK} images against the CPU: {shown}",
              flush=True)
    del imgs
    torch.cuda.empty_cache()
    b, cin, cout, side = S2D_SHAPE
    x = torch.randn((b, cin, side, side), generator=gen, device="cuda")
    w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * 0.05
    bias = torch.randn((cout,), generator=gen, device="cuda")
    x5 = ts.s2d5(x)
    got = ts.phase_conv5(x5, w, bias, torch.float32)
    ref = ts.s2d5(F.conv2d(x, w, bias, padding=1))
    err = rel_err(got, ref)[1]
    if not err <= S2D_TOL:
        fail(f"LIB s2d: phase_conv5 disagrees with F.conv2d (rel {err:.3e})")
    del got, ref
    ms["s2d.phase_conv5"] = time_ms(
        lambda: ts.phase_conv5(x5, w, bias, torch.float32), iters)
    ms["s2d.F.conv2d"] = time_ms(lambda: F.conv2d(x, w, bias, padding=1),
                                 iters)
    print(f"LIB s2d ({b}, {cin}->{cout}, {side}^2, fp32, TF32 off): "
          f"phase_conv5 {ms['s2d.phase_conv5']:.3f} ms, F.conv2d "
          f"{ms['s2d.F.conv2d']:.3f} ms (phase_conv5/F.conv2d "
          f"{ms['s2d.phase_conv5'] / ms['s2d.F.conv2d']:.3f}); rel err "
          f"{err:.3e} (tolerance {S2D_TOL:g})", flush=True)
    del x, x5
    torch.cuda.empty_cache()
    print("LIB (ms): " + json.dumps({k: round(v, 4) for k, v in ms.items()}),
          flush=True)
    return ms


def views_phases(work: Path, data_dir, k4_ms) -> dict:
    """MF, VIEWS, CMB, MF-CLI and LIB in turn (`--views`: all but LIB).
    `data_dir` is the CLI phase's corpus, or None for a new one in `work`;
    `k4_ms` phase 5's K4 step time, or None. Returns their numbers."""
    t0 = time.perf_counter()
    out = {"mf": mf_phase(MOCO_BATCH, MOCO_STEPS, k4_ms, work),
           "views": views_phase(MOCO_BATCH, CM_BATCH, ITERS),
           "cmb": cmb_phase(CM_BATCH),
           "mf_cli_s": mf_cli_phase(work, data_dir or str(work / "data"))}
    print(f"MF/VIEWS/CMB/MF-CLI phases took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


DP_TIMEOUT = 600  # seconds a spawned rank or launcher run may take


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_env(world: int, rank: int, port: int) -> dict:
    """torch's launcher variables for `rank` of `world` (every rank on
    cuda:0: the card machine has one card)."""
    return {"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": "0",
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


@functools.lru_cache(maxsize=None)
def _flat_launchers():
    return {name: kernels()[name][0] for name in SPARK_KERNELS}


def _zero_launches() -> None:
    for fn in _flat_launchers().values():
        fn.launches = 0


def _launches() -> dict:
    return {n: fn.launches for n, fn in _flat_launchers().items()}


def _deterministic_step(state, step, imgs):
    """(loss, grad norm, every parameter and buffer) after one step with
    cuDNN restricted to its deterministic algorithms (its default backward
    algorithms may sum with atomics, so two runs of a step need not agree
    bit for bit without it)."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m = step(state, imgs)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    return (m["loss"].clone(), m["grad_norm"].clone(),
            [t.detach().clone() for t in state.model.state_dict().values()])


def dp1_phase(step_ms, flat_loss, smi: str) -> dict:
    """Phase DP1: phase 2's step (SparK fused flat with K3, LAMB, batch
    BATCH, the same config, weights and images) under a real NCCL process
    group of one process, made by cmx_torch.parallel.dist from the
    launcher's variables. Its first step is held bit for bit to the same
    step without a group (loss, grad norm, every parameter and BN buffer;
    both with cuDNN's deterministic algorithms); the collectives are
    counted (all-reduces a step and their bytes: the gradients alone 4
    bytes a parameter) and the kernels' launches (K1 4, K2 4, K3 1 + 1);
    then SPARK_STEPS steps are timed beside phase 2's step."""
    import os

    import torch
    import torch.distributed as tdist

    from cmx_torch.parallel import dist as pdist
    from cmx_torch.parallel import mesh

    t0 = time.perf_counter()
    state, step, imgs = make_step(make_cfg(BATCH))
    ref = _deterministic_step(state, step, imgs)
    del state, step
    torch.cuda.empty_cache()
    env = _dp_env(1, 0, _free_port())
    os.environ.update(env)
    try:
        if not pdist.initialize_distributed("cuda"):
            fail("DP1: initialize_distributed made no process group")
        backend = tdist.get_backend()
        state, step, imgs = make_step(make_cfg(BATCH))
        n_params = sum(p.numel() for p in state.model.parameters())
        _zero_launches()
        mesh.reset_counts()
        loss, gnorm, tensors = _deterministic_step(state, step, imgs)
        counts, launches = dict(mesh.counts), _launches()
        same = (torch.equal(loss, ref[0]) and torch.equal(gnorm, ref[1])
                and all(torch.equal(a, b) for a, b in zip(tensors, ref[2])))
        print(f"DP1 ({backend}, world {tdist.get_world_size()}): first step "
              f"loss {float(loss):.9g} (without a group {float(ref[0]):.9g}; "
              f"phase 1's recorded step {flat_loss}), grad norm "
              f"{float(gnorm):.9g}; loss, grad norm, {len(tensors)} "
              f"parameters and BN buffers bit for bit the step without a "
              f"group: {same}; collectives a step {counts}; gradient bytes "
              f"{counts.get('grad_all_reduce_bytes')} = 4 x {n_params} "
              f"parameters; launches {launches}", flush=True)
        k1, k2 = FLAT_KERNELS
        want = {k1: 4, k2: 4, "spark_loss_pallas": 1, "spark_loss_bwd": 1}
        if backend != "nccl" or not same:
            fail("DP1: the NCCL step of one process is not the step without "
                 "a group bit for bit")
        if (counts.get("grad_all_reduce") != 1
                or counts.get("grad_all_reduce_bytes") != 4 * n_params
                or not counts.get("all_reduce") or launches != want):
            fail(f"DP1: collectives {counts} or launches {launches} "
                 f"(expected {want})")
        _zero_launches()
        dp_ms, _ = run_steps(state, step, imgs, SPARK_STEPS,
                             "DP1 (NCCL, world 1)")
        run_launches = _launches()
        per_step = {n: v / SPARK_STEPS for n, v in run_launches.items()}
        if per_step != want:
            fail(f"DP1: launches a step {per_step}, expected {want}")
    finally:
        pdist.shutdown()
        for k in env:
            os.environ.pop(k, None)
    del state, step, imgs
    torch.cuda.empty_cache()
    beside = ("" if step_ms is None else f" beside phase 2's {step_ms:.3f} "
              f"without a group ({dp_ms / step_ms:.3f}x)")
    print(f"DP1: step_ms={dp_ms:.3f} under NCCL (world 1){beside}, batch "
          f"{BATCH}; {smi}; the phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"step_ms": dp_ms, "counts": counts, "launches": run_launches}


def dp_rank_main(rank: int, out: str) -> int:
    """One of DP2's ranks (`python3 chip_smoke.py --dp-rank R --dp-out
    PATH`, the launcher's variables in the environment): a gloo group on
    the one card, phase 2's step at DP2_BATCH, the rank's rows of the
    global batch of 2 x DP2_BATCH images; DP2_STEPS steps, each one's
    launches counted; results to PATH.<rank>.json and .pt."""
    import hashlib

    import torch

    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from cmx_torch import resolve_device
    from cmx_torch.parallel import dist as pdist
    from cmx_torch.parallel import mesh

    resolve_device("cuda")
    pdist.initialize_distributed("cuda", backend="gloo")
    world = pdist.process_info()[1]
    state, step, imgs = make_step(make_cfg(DP2_BATCH * world))
    local = mesh.rank_slice(imgs)
    mesh.replicate(state.model, state.extra)
    losses, launches, times, bn = [], [], [], None
    for i in range(DP2_STEPS):
        _zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, local)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        launches.append(_launches())
        if i == 0:
            bn = {n: b.detach().cpu() for n, b in state.model.named_buffers()}
    h = hashlib.sha256()
    for t in (list(state.model.state_dict().values())
              + [x for v in state.opt.state_dict().values()
                 for x in (v if isinstance(v, list) else [v])]):
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    torch.save(bn, f"{out}.{rank}.pt")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"losses": losses, "launches": launches,
                   "step_ms": sum(times[2:]) / (DP2_STEPS - 2) * 1e3,
                   "digest": h.hexdigest(), "batch": local.shape[0]}, f)
    pdist.shutdown()
    return 0


def _run_ranks(label: str, cmds: list, envs: list, work: Path) -> None:
    """Start every command at once, each with its environment and log;
    wait DP_TIMEOUT seconds for each (killing any that runs past it, and the
    rest when one fails); fail with the logs' tails unless all exit 0."""
    import os

    procs = []
    for i, (cmd, env) in enumerate(zip(cmds, envs)):
        log = open(work / f"{label}.{i}.log", "w")
        procs.append((subprocess.Popen(cmd, env={**os.environ, **env},
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    bad = []
    for p, log in procs:
        try:
            p.wait(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        if p.returncode != 0:
            bad.append(f"[{label} {log.name}: exit {p.returncode}]\n"
                       + Path(log.name).read_text()[-3000:])
            for q, _ in procs:
                if q.poll() is None:
                    q.kill()
    for p, _ in procs:
        p.wait()
    if bad:
        print("\n".join(bad), flush=True)
        fail(f"{label}: a process failed")


def dp2_phase(work: Path, smi: str) -> dict:
    """Phase DP2: two ranks of a gloo group on the one card (two spawned
    processes, `dp_rank_main`), each at DP2_BATCH, against one process at
    2 x DP2_BATCH from the same weights, images and step draws. Each rank
    launches K1 4, K2 4 and K3 1 + 1 a step; every step's loss within 2e-2
    of the one process's and every BN running stat after the first step
    within 5e-2 (phase 3's bf16 bands); the ranks' parameters, BN buffers
    and LAMB state bit for bit equal after the steps. Gloo stages every
    collective through the host, so the step time shows that the path
    runs, not how fast NCCL across cards would be."""
    import torch

    t0 = time.perf_counter()
    state, step, imgs = make_step(make_cfg(2 * DP2_BATCH))
    ref_losses, ref_bn = [], None
    for i in range(DP2_STEPS):
        ref_losses.append(float(step(state, imgs)["loss"]))
        if i == 0:
            ref_bn = {n: b.detach().cpu() for n, b in
                      state.model.named_buffers()}
    del state, step, imgs
    torch.cuda.empty_cache()
    out = work / "dp2"
    port = _free_port()
    _run_ranks("DP2", [[sys.executable, str(Path(__file__).resolve()),
                        "--dp-rank", str(r), "--dp-out", str(out)]
                       for r in range(2)],
               [_dp_env(2, r, port) for r in range(2)], work)
    ranks = [json.loads(Path(f"{out}.{r}.json").read_text())
             for r in range(2)]
    bns = [torch.load(f"{out}.{r}.pt") for r in range(2)]
    k1, k2 = FLAT_KERNELS
    want = {k1: 4, k2: 4, "spark_loss_pallas": 1, "spark_loss_bwd": 1}
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref_losses))
    bn_err = max(float((bn[n] - ref_bn[n]).abs().max()) for bn in bns
                 for n in ref_bn)
    print(f"DP2 (gloo, 2 ranks on one card, batch {ranks[0]['batch']} each "
          f"against one process at {2 * DP2_BATCH}): losses rank 0 "
          f"{ranks[0]['losses']}, rank 1 {ranks[1]['losses']}, one process "
          f"{ref_losses} (largest relative difference {loss_err:.3e}); BN "
          f"stats after step 1 within {bn_err:.3e}; ranks' state bit for "
          f"bit equal {ranks[0]['digest'] == ranks[1]['digest']}; launches "
          f"a step {ranks[0]['launches']}; step_ms per rank "
          f"{ranks[0]['step_ms']:.3f} / {ranks[1]['step_ms']:.3f} (gloo "
          f"stages every collective through the host: the path runs, not "
          f"its speed); {smi}; the phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if any(la != want for r in ranks for la in r["launches"]):
        fail(f"DP2: a rank's launches a step differ from {want}")
    if loss_err > 2e-2 or bn_err > 5e-2:
        fail("DP2: two ranks do not equal one process within the bf16 bands")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        fail("DP2: the two ranks' states differ")
    launches = collections.Counter()
    for r in ranks:
        for la in r["launches"]:
            launches.update(la)
    return {"step_ms": [r["step_ms"] for r in ranks], "loss_err": loss_err,
            "bn_err": bn_err, "launches": dict(launches)}


def dp_cli_run(args: list) -> int:
    """`python3 chip_smoke.py --cli-run ARGS`: cmx_torch.cli.pretrain.main
    on ARGS with cuDNN's deterministic algorithms (DP-CLI's launcher run)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cmx_torch.cli.pretrain import main as pretrain_main

    torch.backends.cudnn.deterministic = True
    pretrain_main(args)
    return 0


def dp_phases(work: Path, data_dir, step_ms, flat_loss, smi: str) -> dict:
    """DP1, DP2 and DP-CLI (see the module docstring); `data_dir` None
    makes DP-CLI's corpus in `work`, step_ms and flat_loss None (with
    --dp) leave out phase 2's numbers."""
    t0 = time.perf_counter()
    out = {"dp1": dp1_phase(step_ms, flat_loss, smi),
           "dp2": dp2_phase(work, smi),
           "cli": dp_cli_phase(work, data_dir or f"{work}/data")}
    print(f"DP phases took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def dp_cli_phase(work: Path, data_dir: str) -> dict:
    """Phase DP-CLI: the pretrain CLI for one epoch on the CLI phase's
    corpus (SparK fused flat with K3, batch CM_CLI_BATCH, validation) twice
    with cuDNN's deterministic algorithms: in this process without a group,
    and under torch's launcher, `torchrun --nproc_per_node 1` (NCCL, world
    1; where torchrun is not on the PATH, the launcher's variables set by
    hand), both through their CUDA graphs (train.scan; the launcher's
    with its NCCL all-reduces captured). Its encoder.npz must equal the
    single-process run's bit for bit, its log.jsonl hold the same losses,
    and its log say that its steps were replayed from a graph."""
    import os
    import shutil

    import numpy as np
    import torch

    from cmx_torch.cli.pretrain import main as pretrain_main

    t0 = time.perf_counter()
    base = ["--task", "spark", "data.synthetic=True",
            f"data.synthetic_n={CLI_IMAGES}", f"data.data_dir={data_dir}",
            "model.fused_conv=True", "task.pallas_loss=True",
            f"data.image_size={CLI_SIZE}", f"train.batch_size={CM_CLI_BATCH}",
            "optim.name=lamb", "optim.lr=2e-4", "optim.weight_decay=0.04",
            "optim.clip_norm=5.0", "train.patience=5", "train.epochs=1"]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = pretrain_main(base + [f"train.ckpt_dir={work}/dp_one"])
    finally:
        torch.backends.cudnn.deterministic = saved
    del one
    torch.cuda.empty_cache()
    script = [str(Path(__file__).resolve()), "--cli-run", *base,
              f"train.ckpt_dir={work}/dp_run"]
    torchrun = shutil.which("torchrun")
    if torchrun:
        cmd = [torchrun, "--standalone", "--nproc_per_node", "1", *script]
        env = {}
    else:
        cmd, env = [sys.executable, *script], _dp_env(1, 0, _free_port())
    _run_ranks("DP-CLI", [cmd], [env], work)
    logs, same = [], True
    for d in ("dp_one", "dp_run"):
        with open(Path(work) / d / "spark" / "log.jsonl") as f:
            logs.append([json.loads(line) for line in f])
    with np.load(Path(work) / "dp_one" / "spark" / "encoder.npz") as a, \
            np.load(Path(work) / "dp_run" / "spark" / "encoder.npz") as b:
        same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)
    run_log = (Path(work) / "DP-CLI.0.log").read_text()
    group = re.search(r"process group: (\w+) rank (\d+) of (\d+)", run_log)
    replayed = re.search(r"train\.scan: 1 eager step\(s\), (\d+) replays",
                         run_log)
    how = ("torchrun --nproc_per_node 1" if torchrun
           else "the launcher's variables set by hand")
    print(f"DP-CLI: {how} ({group.group(0) if group else 'no group line'}):"
          f" encoder.npz bit for bit the single-process run's: {same}; loss "
          f"{logs[1][0]['loss']:.9g} / {logs[0][0]['loss']:.9g}, val_loss "
          f"{logs[1][0]['val_loss']:.9g} / {logs[0][0]['val_loss']:.9g}; "
          f"the launcher's steps replayed from a CUDA graph under the NCCL "
          f"group: {replayed.group(0) if replayed else 'no'}; the phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    losses = [[(r["loss"], r["val_loss"]) for r in log] for log in logs]
    if not same or losses[0] != losses[1]:
        fail("DP-CLI: the launcher's run is not the single-process run")
    if not group or group.group(1) != "nccl" or group.group(3) != "1":
        fail("DP-CLI: the launcher's run made no NCCL group of one process")
    if not replayed or not int(replayed.group(1)):
        fail("DP-CLI: the launcher's run replayed no step from its graph")
    return {"same": same, "torchrun": bool(torchrun)}



FTDP_BATCH = 8       # FT-DP (b): the global batch (4 a rank, k = 2)
FTDP_GCD_BATCH = 3   # FT-DP (b): the gcd case's global batch (k = 1)
FTDP_IMAGES = (8, 4)  # FT-DP (b): training and validation images
FTDP_EPOCHS = 2      # FT-DP (b): epochs of the batch-8 fit
# the fine-tune step's K1/K2 calls (down1, down2, up1; FT1 records them)
FT_PER_STEP = {"flat_conv3x3_mask_stats": 6, "flat_bwd_mega": 6}


def ftdp_inputs():
    """FT-DP (b)'s data: 8 training and 4 validation images of CLI_SIZE^2
    with one-hot masks (the synthetic corpus's generator, seed 0), and the
    injected epoch permutations (numpy, seeds 100 + epoch)."""
    import numpy as np

    from cmx_torch.data.synthetic import make_batch

    imgs, masks = make_batch(np.random.default_rng(0), sum(FTDP_IMAGES),
                             CLI_SIZE)
    n = FTDP_IMAGES[0]
    perms = [np.random.default_rng(100 + ep).permutation(n)
             for ep in range(FTDP_EPOCHS)]
    return (imgs[:n], masks[:n], imgs[n:], masks[n:]), perms


def ftdp_model():
    """The fine-tune UNet as the CLI builds it with model.fused_conv=True
    (full widths, bf16, weights from seed 0), on the host (fit copies it)."""
    import torch

    from cmx_torch.models.unet import UNet

    model = UNet(out_classes=2, dtype=torch.bfloat16, fused=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def ftdp_fit(data, perms, batch: int, epochs: int) -> dict:
    """`harness.fit` of FT-DP (b) in this process (a rank of the group, or
    alone): its logs, the digest of the returned state, the K1/K2 launches
    and its seconds."""
    import hashlib

    import torch

    from cmx_torch.train.harness import fit

    _zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fit(*data, lr=FT_LR, epochs=epochs, batch=batch, seed=42,
              model=ftdp_model(), device="cuda", perms=perms[:epochs])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    h = hashlib.sha256()
    st = res.state
    for x in (list(st.model.state_dict().values())
              + [y for v in st.opt.state_dict().values()
                 for y in (v if isinstance(v, list) else [v])]):
        h.update(x.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    out = {"train": res.train_logs, "valid": res.valid_logs,
           "best_epoch": res.best_epoch, "step": st.step,
           "digest": h.hexdigest(), "secs": secs,
           "launches": {n: _launches()[n] for n in FLAT_KERNELS}}
    del res, st
    torch.cuda.empty_cache()
    return out


def ftdp_rank_main(rank: int, out: str) -> int:
    """One of FT-DP (b)'s ranks (`python3 chip_smoke.py --ftdp-rank R
    --dp-out PATH`, the launcher's variables in the environment): a gloo
    group on the one card; the fit at global batch FTDP_BATCH, then the gcd
    case at FTDP_GCD_BATCH for one epoch; results to PATH.<rank>.json."""
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from cmx_torch import resolve_device
    from cmx_torch.parallel import dist as pdist

    resolve_device("cuda")
    pdist.initialize_distributed("cuda", backend="gloo")
    data, perms = ftdp_inputs()
    res = {"fit": ftdp_fit(data, perms, FTDP_BATCH, FTDP_EPOCHS),
           "gcd": ftdp_fit(data, perms, FTDP_GCD_BATCH, 1)}
    Path(f"{out}.{rank}.json").write_text(json.dumps(res))
    pdist.shutdown()
    return 0


def ft_cli_run(args: list) -> int:
    """`python3 chip_smoke.py --ft-cli-run OUT ARGS` (FT-DP (a)'s launcher
    run): cmx_torch.cli.finetune.main on ARGS with cuDNN's deterministic
    algorithms; the kernels' wrapper calls, each graph's report and the
    fine-tune set's size to OUT (JSON)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cmx_torch.cli.finetune import main as finetune_main
    from cmx_torch.train.graph import REPORTS

    torch.backends.cudnn.deterministic = True
    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    res = finetune_main(args[1:])
    torch.cuda.synchronize()
    Path(args[0]).write_text(json.dumps({
        "calls": {n: fn.launches for n, fn in wrappers.items()},
        "reports": REPORTS, "n_finetune": res["n_finetune"]}))
    return 0


def ftdp_cli(work: Path, encoder, data_dir: str, per_step: dict) -> dict:
    """FT-DP (a): the fine-tune CLI for one epoch at batch FT_CLI_BATCH on
    FT-CLI's corpus and encoder.npz, in this process without a group and
    under `torchrun --standalone --nproc_per_node 1` (NCCL, world 1; the
    launcher's variables set by hand where torchrun is missing), both with
    cuDNN's deterministic algorithms and through their CUDA graphs."""
    import pickle
    import shutil

    import torch

    from cmx_torch.cli.finetune import main as finetune_main
    from cmx_torch.data.splits import KFold

    def argv(out):
        return (["--device", "cuda", "--lrs", str(FT_LR), "--epochs", "1",
                 "--batches", str(FT_CLI_BATCH), "--out", str(work / out)]
                + (["--pretrained", encoder] if encoder else [])
                + ["data.synthetic=True", f"data.synthetic_n={CLI_IMAGES}",
                   f"data.data_dir={data_dir}",
                   f"data.image_size={CLI_SIZE}",
                   f"data.ratio={FT_CLI_RATIO}", "model.fused_conv=True"])

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        one = finetune_main(argv("ftdp_one"))
    finally:
        torch.backends.cudnn.deterministic = saved
    one_s = time.perf_counter() - t0
    tag = one["tag"]
    del one
    torch.cuda.empty_cache()
    report = work / "ftdp_run.json"
    script = [str(Path(__file__).resolve()), "--ft-cli-run", str(report),
              *argv("ftdp_run")]
    torchrun = shutil.which("torchrun")
    if torchrun:
        cmd = [torchrun, "--standalone", "--nproc_per_node", "1", *script]
        env = {}
    else:
        cmd, env = [sys.executable, *script], _dp_env(1, 0, _free_port())
    t0 = time.perf_counter()
    _run_ranks("FT-DP-CLI", [cmd], [env], work)
    run_s = time.perf_counter() - t0
    run = json.loads(report.read_text())
    files = {}
    for d in ("ftdp_one", "ftdp_run"):
        files[d] = (json.loads((work / d / f"test_{tag}.json").read_text()),
                    pickle.loads((work / d / f"result_finetuning_unet_{tag}"
                                  ".pkl").read_bytes()))
    logs = [[(f["train_logs"], f["valid_logs"], f["best_epoch"])
             for r in files[d][1] for f in r["folds"]] for d in files]
    same = (files["ftdp_one"][0] == files["ftdp_run"][0]
            and logs[0] == logs[1])
    # launches: eager calls + capture calls x replays (graph_launches)
    launches = dict(run["calls"])
    for rep in run["reports"]:
        for n, c in wrapper_calls(rep["capture_calls"]).items():
            launches[n] += c * (rep["replays"] - 1)
    n_ft = run["n_finetune"]
    folds = [len(tr) for tr, _ in KFold(3, random_state=42).split(
        range(n_ft))]
    steps = sum(-(-n // FT_CLI_BATCH) for n in folds + [n_ft])
    expect = {n: per_step.get(n, 0) * steps for n in launches}
    captured = [rep["capture_collectives"] for rep in run["reports"]]
    log = (work / "FT-DP-CLI.0.log").read_text()
    group = re.search(r"process group: (\w+) rank (\d+) of (\d+)", log)
    replayed = re.findall(r"fit: (\d+) steps replayed from one CUDA graph",
                          log)
    how = ("torchrun --nproc_per_node 1" if torchrun
           else "the launcher's variables set by hand")
    print(f"FT-DP (a): the fine-tune CLI under {how} "
          f"({group.group(0) if group else 'no group line'}), one epoch at "
          f"batch {FT_CLI_BATCH}: test_{tag}.json and the grid's logs bit "
          f"for bit the run without a group: {same}; test metrics "
          f"{files['ftdp_run'][0]['test_metrics']}; {len(replayed)} fits "
          f"replayed from their graphs ({replayed} replays), collectives "
          f"captured in each graph {captured}; launches (eager calls + "
          f"capture calls x replays) "
          f"{ {n: launches[n] for n in FLAT_KERNELS} } (expected "
          f"{ {n: expect[n] for n in FLAT_KERNELS} }, {steps} training "
          f"steps); without a group {one_s:.1f} s, under the launcher "
          f"{run_s:.1f} s (its start-up included)", flush=True)
    if not same:
        fail("FT-DP (a): the launcher's CLI run is not the run without a "
             "group")
    if not group or group.group(1) != "nccl" or group.group(3) != "1":
        fail("FT-DP (a): the launcher's run made no NCCL group of one")
    if (len(replayed) != len(folds) + 1 or len(captured) != len(replayed)
            or any(c.get("grad_all_reduce") != 1 or not c.get("all_reduce")
                   for c in captured)):
        fail("FT-DP (a): a fit replayed no graph, or a graph did not "
             "capture its all-reduces")
    if launches != expect:
        fail("FT-DP (a): the launcher's K1/K2 launches are not the steps' "
             "calls")
    return {"same": same, "one_s": one_s, "run_s": run_s,
            "replays": run["reports"]}


def ftdp_phase(work: Path, encoder, data_dir: str, per_step: dict,
               smi: str) -> dict:
    """Phase FT-DP: the fine-tune harness and CLI under data parallel (see
    the module docstring). Returns (b)'s ranks' launches and both parts'
    numbers."""
    import torch

    t0 = time.perf_counter()
    cli = ftdp_cli(work, encoder, data_dir, per_step)
    data, perms = ftdp_inputs()
    ref = ftdp_fit(data, perms, FTDP_BATCH, FTDP_EPOCHS)
    out = work / "ftdp"
    port = _free_port()
    _run_ranks("FT-DP", [[sys.executable, str(Path(__file__).resolve()),
                          "--ftdp-rank", str(r), "--dp-out", str(out)]
                         for r in range(2)],
               [_dp_env(2, r, port) for r in range(2)], work)
    ranks = [json.loads(Path(f"{out}.{r}.json").read_text())
             for r in range(2)]
    eager = ["steps run eagerly" in (work / f"FT-DP.{r}.log").read_text()
             for r in range(2)]
    fits = [r["fit"] for r in ranks]
    loss_err = max(abs(a - b) / abs(b) for f in fits
                   for a, b in zip(f["train"]["loss"], ref["train"]["loss"]))
    # dice_loss is thresholded: held in absolute terms, as the CPU tests'
    # _assert_logs_close holds thresholded logs (a pixel at 0.5 flips)
    dice_err = max(abs(a - b) for f in fits for a, b in zip(
        f["valid"]["dice_loss"], ref["valid"]["dice_loss"]))
    steps = FTDP_EPOCHS * -(-FTDP_IMAGES[0] // FTDP_BATCH)
    gcd_steps = -(-FTDP_IMAGES[0] // FTDP_GCD_BATCH)
    want = {n: c * steps for n, c in FT_PER_STEP.items()}
    gcd = [r["gcd"] for r in ranks]
    print(f"FT-DP (b): fit of the fused bf16 UNet ({CLI_SIZE}^2) on two "
          f"gloo ranks of one card at global batch {FTDP_BATCH} (k = 2), "
          f"{FTDP_EPOCHS} epochs over {FTDP_IMAGES[0]} + {FTDP_IMAGES[1]} "
          f"images, against one process at {FTDP_BATCH} (its graph): train "
          f"loss {[f['train']['loss'] for f in fits]} / "
          f"{ref['train']['loss']} (largest relative difference "
          f"{loss_err:.3e}), valid dice_loss "
          f"{[f['valid']['dice_loss'] for f in fits]} / "
          f"{ref['valid']['dice_loss']} (largest absolute difference "
          f"{dice_err:.3e}); ranks' states bit "
          f"for bit {fits[0]['digest'] == fits[1]['digest']}; launches "
          f"{[f['launches'] for f in fits]} over {steps} steps (expected "
          f"{want}); gloo's eager steps printed {eager}; fit seconds per "
          f"rank {[round(f['secs'], 3) for f in fits]}, one process "
          f"{ref['secs']:.3f} (gloo stages every collective through the "
          f"host: the path runs, not its speed). gcd case at batch "
          f"{FTDP_GCD_BATCH} (k = 1): launches rank 0 {gcd[0]['launches']}, "
          f"rank 1 {gcd[1]['launches']}, steps {gcd[0]['step']} / "
          f"{gcd[1]['step']}, states bit for bit "
          f"{gcd[0]['digest'] == gcd[1]['digest']}; {smi}; the phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if loss_err > 2e-2 or dice_err > 2e-2:
        fail("FT-DP (b): two ranks do not equal one process within the "
             "bf16 bands")
    if fits[0]["digest"] != fits[1]["digest"] or any(
            f["launches"] != want for f in fits):
        fail("FT-DP (b): the ranks' states differ, or a rank did not launch "
             "K1/K2 6 + 6 a step")
    if not all(eager):
        fail("FT-DP (b): a rank did not say that gloo ran its steps eagerly")
    if (gcd[0]["digest"] != gcd[1]["digest"]
            or not gcd[0]["step"] == gcd[1]["step"] == gcd_steps
            or any(gcd[1]["launches"].values())
            or gcd[0]["launches"] != {n: c * gcd_steps
                                      for n, c in FT_PER_STEP.items()}):
        fail("FT-DP (b): in the gcd case rank 1 stepped or the ranks differ")
    del ref
    torch.cuda.empty_cache()
    launches = collections.Counter()
    for r in ranks:
        for part in ("fit", "gcd"):
            launches.update(r[part]["launches"])
    return {"cli": cli, "loss_err": loss_err, "dice_err": dice_err,
            "secs": [f["secs"] for f in fits], "launches": dict(launches)}


GRAPH_STEPS = 6  # GRAPH: N eager steps against warm-up, capture, N-1 replays


def graph_cases():
    """(label, make, FUSED_IMPL) of the GRAPH phase: make() -> (state, step,
    batch) as the eager phases build them (the batch is the corpus the
    steps gather their rows from), run with fused_conv.FUSED_IMPL set to
    the third entry."""
    from cmx_torch.train.schedules import scaled_base_lr, warmup_cosine

    def cm(batch):
        cfg = make_cm_cfg(batch)
        lr = warmup_cosine(scaled_base_lr(cfg.optim.lr, batch),
                           cfg.train.epochs, cfg.optim.warmup_epochs)
        return make_step(cfg, lr=lr, seed=0)

    return [
        (f"SparK b{BATCH}", lambda: make_step(make_cfg(BATCH)), "flat"),
        # the NHWC strip kernels K6-K8 replayed
        (f"SparK-nhwc b{BATCH}", lambda: make_step(make_cfg(BATCH)), "nhwc"),
        (f"FT1 b{BATCH}", lambda: make_ft_step(True, BATCH), "flat"),
        (f"MAE1 b{MAE_BATCH}", lambda: make_step(make_mae_cfg(MAE_BATCH,
                                                              True)), "flat"),
        (f"G1 b{GENESIS_BATCH}", lambda: make_step(make_genesis_cfg(
            GENESIS_BATCH, True)), "flat"),
        (f"MoCo-pallas b{MOCO_BATCH}", lambda: make_step(make_moco_cfg(
            MOCO_BATCH, "pallas")), "flat"),
        (f"MoCo-fast b{MOCO_BATCH}", lambda: make_step(make_moco_fast_cfg(
            MOCO_BATCH)), "flat"),
        (f"CM1 b{CM_BATCH}", lambda: cm(CM_BATCH), "flat"),
        # the tightest fit on one card: CM-UNet at 128 (eager 53.25 GiB)
        (f"CM1 b{2 * CM_BATCH}", lambda: cm(2 * CM_BATCH), "flat"),
        (f"RM b{RM_BATCH}", lambda: make_step(make_rm_cfg("spark", RM_BATCH,
                                                          "")), "flat"),
    ]


def state_tensors(state) -> dict:
    """Every tensor of a train state by name: parameters and buffers, the
    optimizer's state, and the task's `extra` (its modules' too)."""
    import torch

    out = {f"model/{n}": t for n, t in state.model.state_dict().items()}
    for k, v in state.opt.state_dict().items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            out[f"opt/{k}/{i}"] = t
    for k, v in (state.extra or {}).items():
        if isinstance(v, torch.nn.Module):
            out.update({f"extra/{k}/{n}": t
                        for n, t in v.state_dict().items()})
        else:
            out[f"extra/{k}"] = v
    return out


def port_kernel_counts(prof, n: int) -> dict:
    """The port's device kernels in a profile of n steps, launches a step
    by kernel name, and the device's busy ms a step."""
    from torch.autograd import DeviceType

    ks = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = busy_ms_a_step(prof, n)
    return {e.key: e.count / n for e in ks
            if any(k in e.key for k in PORT_KERNEL_NAMES)}, busy


def graph_case(label: str, build, steps: int) -> dict:
    """One GRAPH case. N eager steps (make_train_step, a fresh generator a
    step) on a state, its tensors kept, then two profiled eager steps;
    that state freed, the same N steps through a StepGraph (warm-up,
    capture, N-1 replays) on a second state from the same seeds, each
    step's batch gathered from the same corpus by the same permutation:
    every tensor of the states and every metric bit for bit; then two
    profiled replays: the port's kernels by name equal to the eager steps',
    the capture's wrapper calls equal to an eager step's; step times (the
    last N-2 steps of each run, back to back), busy shares, capture
    seconds, peak memory. cuDNN runs its deterministic algorithms."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cmx_torch.train.graph import StepGraph, launch_counts

    t_case = time.perf_counter()
    out = {"label": label}
    for kind in ("eager", "graph"):
        state, step, corpus = build()
        c = corpus if isinstance(corpus, tuple) else (corpus,)

        def gather(idx, c=c):
            rows = tuple(t.index_select(0, idx) for t in c)
            return rows if len(rows) > 1 else rows[0]

        g = torch.Generator().manual_seed(7)
        idxs = torch.stack([torch.randperm(c[0].shape[0], generator=g)
                            for _ in range(steps + 2)]).to("cuda")
        graph = (StepGraph(step.body, gather, "cuda", label=label)
                 if kind == "graph" else None)

        def one(idx):
            if graph is not None:
                return graph.step(state, idx)
            m = step(state, gather(idx))
            return torch.stack([m[k].float() for k in m]), list(m)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for i in range(steps):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            r = one(idxs[i])
            if graph is None:
                r, names = r
            rows.append(r)
        torch.cuda.synchronize()
        out[f"{kind}_ms"] = (time.perf_counter() - t0) / (steps - 2) * 1e3
        out[f"peak_{kind}"] = torch.cuda.max_memory_allocated() / 2**30
        if kind == "eager":
            eager_rows = torch.stack(rows)
            kept = {n: t.clone() for n, t in state_tensors(state).items()}
        else:
            graph_rows = torch.stack(rows)
            differ = [n for n, t in state_tensors(state).items()
                      if not torch.equal(t, kept[n])]
        before = launch_counts()
        for window in range(1, 4):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for idx in idxs[steps:]:
                    one(idx)
                torch.cuda.synchronize()
            kernels_a_step, busy = port_kernel_counts(prof, 2)
            # a window whose device time is under half of the step lost
            # events in the profiler (seen once: 33.8% with half of K1's
            # launches missing): it is taken again, twice at most
            if busy / out[f"{kind}_ms"] >= 0.5:
                break
            print(f"GRAPH {label}: the {kind} profile holds "
                  f"{busy:.3f} device ms a step of {out[f'{kind}_ms']:.3f}: "
                  "events lost, taken again", flush=True)
        after = launch_counts()
        out[f"windows_{kind}"] = window
        out[f"kernels_{kind}"] = kernels_a_step
        out[f"busy_{kind}"] = busy / out[f"{kind}_ms"]
        out[f"calls_{kind}"] = {k: (after[k] - before[k]) // (2 * window)
                                for k in after if after[k] != before[k]}
        if graph is not None:
            rep = graph.report
            graph_names = graph.names
        del state, step, corpus, c, graph, prof, one, gather
        gc.collect()
        torch.cuda.empty_cache()
    same_m = torch.equal(eager_rows, graph_rows)
    finite = bool(torch.isfinite(graph_rows).all())
    out.update(ratio=out["graph_ms"] / out["eager_ms"],
               capture_s=rep["capture_s"],
               pool_gib=rep["pool_bytes"] / 2**30,
               capture_calls=rep["capture_calls"], replays=rep["replays"],
               bit_for_bit=not differ and same_m)
    print(f"GRAPH {label}: {steps} eager steps vs warm-up + capture + "
          f"{steps - 1} replays: {len(kept)} state tensors, "
          f"{len(kept) - len(differ)} equal bit for bit, metrics equal "
          f"{same_m}, finite {finite}; step_ms eager={out['eager_ms']:.3f} "
          f"graph={out['graph_ms']:.3f} (graph/eager {out['ratio']:.3f}); "
          f"busy eager {100 * out['busy_eager']:.1f}% graph "
          f"{100 * out['busy_graph']:.1f}%; capture {rep['capture_s']:.3f} s, "
          f"its pool {out['pool_gib']:.2f} GiB, peak "
          f"{out['peak_eager']:.2f} GiB eager / {out['peak_graph']:.2f} GiB "
          f"with the graph; wrapper calls at capture {rep['capture_calls']} "
          f"(an eager step's {out['calls_eager']}, a replay's "
          f"{out['calls_graph'] or 'none'}); the port's kernels a step "
          f"(profiler), {len(out['kernels_graph'])} kernels: a replay "
          f"{sum(out['kernels_graph'].values()):g} launches, an eager step "
          f"{sum(out['kernels_eager'].values()):g}; case "
          f"{time.perf_counter() - t_case:.1f} s", flush=True)
    if differ or not same_m or graph_names != names:
        fail(f"GRAPH {label}: the graph's steps differ from the eager ones: "
             f"{differ[:8]} ({len(differ)} tensors), metrics equal {same_m}")
    if not finite or rep["eager_steps"] != 1 or \
            rep["replays"] != steps - 1 + 2 * out["windows_graph"]:
        fail(f"GRAPH {label}: not finite, or {rep['eager_steps']} eager "
             f"steps and {rep['replays']} replays")
    if (rep["capture_calls"] != out["calls_eager"] or out["calls_graph"]
            or out["kernels_graph"] != out["kernels_eager"]):
        fail(f"GRAPH {label}: the replay's kernels {out['kernels_graph']} or "
             f"the capture's calls {rep['capture_calls']} are not an eager "
             f"step's ({out['kernels_eager']}, {out['calls_eager']})")
    return out


def nhwc_launches(kernels_a_step: dict) -> dict:
    """K6-K8's and K3's launches a step from a profile's device kernels (as
    port_kernel_counts gives them): a K6 call is one stem kernel; a K8 call
    one BN-backward dy kernel, one dX product and one dW product; a K7 call
    one forward product, the products of cmx::conv3x3_mma_kernel that are
    not K8's dX; K3 one kernel each way."""
    def count(*keys, unless=None):
        return sum(c for k, c in kernels_a_step.items()
                   if any(x in k for x in keys)
                   and not (unless and unless in k))

    k8 = count("bn_bwd_dy")
    return {"conv_stem_stats": count("stem_kernel"),
            "conv3x3_mask_stats": count("cmx::conv3x3_mma_kernel") - k8,
            "bwd_mega": k8,
            "spark_loss_pallas": count("spark_loss_fwd_kernel"),
            "spark_loss_bwd": count("spark_loss_bwd_kernel")}


def graph_phase(steps: int = GRAPH_STEPS, only=None) -> list:
    """Phase GRAPH (see the module docstring), or its cases whose labels
    start with one of `only`. Returns each case's numbers."""
    import gc

    import torch

    from cmx_torch.ops import fused_conv as fc

    t0 = time.perf_counter()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for label, build, impl in graph_cases():
            if only and not label.startswith(only):
                continue
            fc.FUSED_IMPL = impl
            try:
                out.append(graph_case(label, build, steps))
            finally:
                fc.FUSED_IMPL = "flat"
            if impl == "nhwc":
                r = out[-1]
                counted = nhwc_launches(r["kernels_graph"])
                print(f"GRAPH {label}: K6-K8 and K3 launches a replayed step "
                      f"from the profile {counted} (expected "
                      f"{NHWC_PER_STEP}); wrapper calls at the capture "
                      f"{r['capture_calls']}", flush=True)
                if counted != NHWC_PER_STEP or \
                        wrapper_calls(r["capture_calls"]) != NHWC_PER_STEP:
                    fail(f"GRAPH {label}: the replayed step did not run K6 "
                         "1, K7 3, K8 3 and K3 1 + 1")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = saved
    print("GRAPH (same call; step_ms eager / graph, ratio, busy eager / "
          "graph, capture s, peak GiB eager / graph): " + "; ".join(
              f"{r['label']} {r['eager_ms']:.3f} / {r['graph_ms']:.3f} "
              f"{r['ratio']:.3f} {100 * r['busy_eager']:.1f}% / "
              f"{100 * r['busy_graph']:.1f}% {r['capture_s']:.3f} s "
              f"{r['peak_eager']:.2f} / {r['peak_graph']:.2f}" for r in out)
          + f"; the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


BNV_VARIANTS = ("shift_ra", "shift_max", "two_pass", "naive")
BNV_MAX_HW = 64  # BNV holds the unfused moments of stages up to this size
# the phase-1 SparK step's kernel calls (K1 4, K2 4, K3 1 + 1), for --bnv
SPARK_PER_STEP = {"flat_conv3x3_mask_stats": 4, "flat_bwd_mega": 4,
                  "spark_loss_pallas": 1, "spark_loss_bwd": 1}


def moments_probe(model):
    """(taken, errors, a MaskedBatchNorm.moments to patch in): while it is
    patched in, `taken` lists the norms of `model` whose moments the norm
    kernels compute (every unfused norm on the card), and every such
    moment in a stage of BNV_MAX_HW^2 or less and every densify norm's is
    held against a float64 two-pass of the same activations and mask:
    errors[name] = (H, the largest relative error of the variant's batch
    variance over the channels)."""
    import torch

    from cmx_torch.models import blocks
    from cmx_torch.ops import batch_norm as bo

    names = {id(m): n for n, m in model.named_modules()}
    orig = blocks.MaskedBatchNorm.moments
    taken, errors = [], {}

    def moments(self, x, mask=None, sums=bo.norm_moments_plain):
        mean, var, denom = orig(self, x, mask, sums)
        if sums is not bo.norm_moments:  # the plain composition's
            return mean, var, denom
        name = names.get(id(self), "?")
        taken.append(name)
        if x.shape[-2] <= BNV_MAX_HW or "densify" in name:
            with torch.no_grad():
                x64 = x.detach().double()
                m64 = (torch.ones_like(x64[:, :1]) if mask is None
                       else (mask[:, None] if mask.dim() == 3 else mask)
                       .double())
                n = m64.sum((0, 2, 3)).clamp(min=1.0)
                mu = (x64 * m64).sum((0, 2, 3)) / n
                v = (((x64 - mu[:, None, None]) ** 2) * m64).sum((0, 2, 3)) / n
                rel = (var.detach().double() - v).abs() / v.clamp(min=1e-30)
                errors[name] = (x.shape[-2], float(rel.max()))
        return mean, var, denom

    return taken, errors, moments


def bnv_phase(per_step: dict, flat_loss=None) -> dict:
    """Phase BNV (see the module docstring): each CMX_BN_VARIANT value on
    phase 2's SparK step. `per_step`/`flat_loss`: phase 1's recorded calls
    and loss (None: the first variant's, for --bnv)."""
    import gc

    import torch

    from cmx_torch.models import blocks

    t0 = time.perf_counter()
    saved = (blocks.BN_VARIANT, torch.backends.cudnn.deterministic)
    orig_moments = blocks.MaskedBatchNorm.moments
    fused_bns = ("encoder.down1.", "encoder.down2.")
    out = {}
    try:
        torch.backends.cudnn.deterministic = True
        for variant in BNV_VARIANTS:
            blocks.BN_VARIANT = variant
            state, step, imgs = make_step(make_cfg(BATCH))
            taken, errors, moments = moments_probe(state.model)
            blocks.MaskedBatchNorm.moments = moments
            try:
                calls, loss = record_step(state, step, imgs)
            finally:
                blocks.MaskedBatchNorm.moments = orig_moments
            calls = dict(collections.Counter(n for n, _ in calls))
            del state, step, imgs
            gc.collect()
            torch.cuda.empty_cache()
            flat_loss = loss if flat_loss is None else flat_loss
            worst = max(errors.items(), key=lambda kv: kv[1][1])
            rg = graph_case(f"BNV {variant}", lambda: make_step(make_cfg(
                BATCH)), GRAPH_STEPS)
            d_loss = abs(loss - flat_loss) / abs(flat_loss)
            out[variant] = {"loss": loss, "d_loss": d_loss, "calls": calls,
                            "worst_var_err": worst[1][1],
                            "worst_at": f"{worst[0]} ({worst[1][0]}^2)",
                            "moments": len(errors),
                            "eager_ms": rg["eager_ms"],
                            "graph_ms": rg["graph_ms"]}
            print(f"BNV {variant}: recorded step's kernel calls {calls} "
                  f"(phase 1's {dict(per_step)}); first loss {loss:.6f}, rel "
                  f"diff to phase 1's (--bnv: the first variant's) "
                  f"{d_loss:.3e} (tol 2e-2); {len(taken)} unfused BN "
                  f"moments taken by the norm kernels, "
                  f"{len(errors)} held against a float64 two-pass (stages "
                  f"<= {BNV_MAX_HW}^2 and the densify norms): largest "
                  f"relative var error {worst[1][1]:.3e} at {worst[0]} "
                  f"({worst[1][0]}^2); step_ms eager={rg['eager_ms']:.3f} "
                  f"graph={rg['graph_ms']:.3f}", flush=True)
            if calls != dict(per_step) or wrapper_calls(rg["calls_eager"]) != dict(per_step):
                fail(f"BNV {variant}: the step's kernel calls {calls} / "
                     f"{rg['calls_eager']} are not phase 1's {dict(per_step)}")
            in_fused = [n for n in taken if n.startswith(fused_bns)]
            if in_fused:
                fail(f"BNV {variant}: a fused stage's norm took its moments "
                     f"outside K1/K2: {in_fused}")
            if not taken:
                fail(f"BNV {variant}: no unfused norm ran the norm kernels")
            if not (math.isfinite(loss) and d_loss <= 2e-2):
                fail(f"BNV {variant}: the first loss {loss} is not finite or "
                     f"not within 2e-2 of {flat_loss}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        blocks.BN_VARIANT, torch.backends.cudnn.deterministic = saved
    print("BNV (SparK batch %d, fused flat with K3; same call; step_ms eager "
          "/ graph, largest relative var error): " % BATCH + "; ".join(
              f"{v} {r['eager_ms']:.3f} / {r['graph_ms']:.3f} "
              f"{r['worst_var_err']:.3e}" for v, r in out.items())
          + f"; the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


FT_HOST_EPOCHS = 2  # FT-HOST: epochs of each fit
FT_HOST_VALID = 8   # FT-HOST: validation images (the host metrics' cost)


def ft_host_phase(data_dir: str, per_step: dict) -> dict:
    """Phase FT-HOST (see the module docstring). Returns its seconds."""
    import numpy as np
    import torch

    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.data.corpus import load_corpus
    from cmx_torch.data.splits import list_corpus, make_splits
    from cmx_torch.data.synthetic import resolve_corpus
    from cmx_torch.train.harness import fit

    t0 = time.perf_counter()
    cfg = Config()
    apply_overrides(cfg, ["data.synthetic=True",
                          f"data.synthetic_n={CLI_IMAGES}",
                          f"data.data_dir={data_dir}",
                          f"data.image_size={CLI_SIZE}"])
    sp = make_splits(*list_corpus(resolve_corpus(cfg.data)),
                     ratio=FT_CLI_RATIO)
    imgs, masks = load_corpus(sp.finetune_x, sp.finetune_y, size=CLI_SIZE)
    n = len(imgs) - FT_HOST_VALID
    data = (imgs[:n], masks[:n], imgs[n:], masks[n:])
    steps = FT_HOST_EPOCHS * -(-n // FT_CLI_BATCH)
    wrappers = {name: k[0] for name, k in kernels().items()}
    out = {}
    for kind in ("finite", "nan"):
        if kind == "nan":
            data = data[:2] + tuple(np.full_like(a, np.nan)
                                    for a in data[2:])
        model = ftdp_model()
        init = {k: t.clone() for k, t in model.state_dict().items()}
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fit(*data, lr=FT_LR, epochs=FT_HOST_EPOCHS, batch=FT_CLI_BATCH,
                  seed=42, model=model, device="cuda", host_metrics_every=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in wrappers.items()}
        expect = {k: per_step.get(k, 0) * steps for k in wrappers}
        final = {k: v.detach().cpu() for k, v in
                 res.state.model.state_dict().items()}
        finite = all(bool(torch.isfinite(v).all()) for v in final.values())
        moved = [k for k, v in final.items() if not torch.equal(v, init[k])]
        logs = {**res.train_logs, **res.valid_logs}
        out[kind] = {"secs": secs, "launches": launches, "moved": len(moved),
                     "valid": {k: res.valid_logs[k] for k in
                               ("dice_loss", "hausdorff", "radius_arteries")}}
        print(f"FT-HOST {kind} validation: fit of the fused bf16 UNet, "
              f"host_metrics_every=1, {FT_HOST_EPOCHS} epochs at batch "
              f"{FT_CLI_BATCH} over {n} training and {len(data[2])} "
              f"validation images of FT-CLI's corpus: {secs:.3f} s; launches "
              f"{launches} (expected {expect}: {steps} steps x phase FT1's "
              f"calls, the frozen-BN evaluations add none); validation "
              f"{out[kind]['valid']}; the returned state finite {finite}, "
              f"{len(moved)} of {len(final)} tensors moved from the initial "
              f"ones", flush=True)
        if launches != expect:
            fail(f"FT-HOST {kind}: K1/K2 did not run the expected number of "
                 "times")
        if not finite or not moved:
            fail(f"FT-HOST {kind}: the returned state is not finite or is "
                 "the initial one")
        if kind == "finite":
            need = ("hausdorff", "radius_arteries")
            if not (all(k in logs for k in need) and all(
                    math.isfinite(v) for vs in logs.values() for v in vs)):
                fail("FT-HOST: the host loop's logs lack the host metrics or "
                     f"are not finite: {logs}")
        elif not all(math.isnan(v) for v in res.valid_logs["dice_loss"]):
            fail("FT-HOST nan: a validation dice_loss was not NaN")
        del res, model, final, init
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"FT-HOST: the phase took {secs:.1f} s", flush=True)
    return {**out, "secs": secs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cm1-batch", type=int, default=None,
                   help="run phase CM1 alone at this batch and report its "
                        "peak memory (an out-of-memory error propagates)")
    p.add_argument("--dp", action="store_true",
                   help="build the kernels, then run phases DP1, DP2 and "
                        "DP-CLI alone")
    p.add_argument("--views", action="store_true",
                   help="build the kernels, then run phases MF, VIEWS, CMB "
                        "and MF-CLI alone")
    p.add_argument("--graph", action="store_true",
                   help="build the kernels, then run phase GRAPH alone")
    p.add_argument("--norm", action="store_true",
                   help="build the kernels, then run phase NORM alone")
    p.add_argument("--bnv", action="store_true",
                   help="build the kernels, then run phases BNV, FT-HOST (on "
                        "a corpus of its own) and GRAPH's NHWC case alone")
    p.add_argument("--dp-rank", type=int, default=None,
                   help="(spawned by DP2) run as this rank of the gloo group "
                        "its environment describes")
    p.add_argument("--dp-out", default=None, help="(with --dp-rank) results")
    p.add_argument("--cli-run", nargs=argparse.REMAINDER, default=None,
                   help="(run by DP-CLI under torchrun) the pretrain CLI on "
                        "the remaining arguments")
    p.add_argument("--ftdp", action="store_true",
                   help="build the kernels, then run phase FT-DP alone")
    p.add_argument("--ftdp-rank", type=int, default=None,
                   help="(spawned by FT-DP) run its fits as this rank of the "
                        "gloo group its environment describes")
    p.add_argument("--ft-cli-run", nargs=argparse.REMAINDER, default=None,
                   help="(run by FT-DP under torchrun) OUT, then the "
                        "fine-tune CLI on the remaining arguments")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "cmx_torch" / "csrc").is_dir():
        fail(f"cmx_torch/ is not beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(repo))
    from cmx_torch import resolve_device
    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as fc
    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.utils import roofline as rl

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.dp_out)
    if args.cli_run is not None:
        return dp_cli_run(args.cli_run)
    if args.ftdp_rank is not None:
        return ftdp_rank_main(args.ftdp_rank, args.dp_out)
    if args.ft_cli_run is not None:
        return ft_cli_run(args.ft_cli_run)
    if args.cm1_batch is not None:
        cm = cm_phase(args.cm1_batch, SPARK_STEPS)
        print(json.dumps({"cm1": {"batch": args.cm1_batch, **cm}}),
              flush=True)
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if args.graph:
        graph_phase()
        print(smi, flush=True)
        return 0
    if args.norm:
        norm_phase(ITERS)
        print(smi, flush=True)
        return 0
    if args.bnv:
        bnv_phase(SPARK_PER_STEP)
        scratch = repo / "_scratch"
        scratch.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as work:
            ft_host_phase(f"{work}/data", FT_PER_STEP)
        graph_phase(only=("SparK-nhwc",))
        print(smi, flush=True)
        return 0
    if args.dp or args.views or args.ftdp:
        scratch = repo / "_scratch"
        scratch.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as work:
            if args.dp:
                dp_phases(Path(work), None, None, None, smi)
            elif args.ftdp:
                ftdp_phase(Path(work), None, f"{work}/data", FT_PER_STEP,
                           smi)
            else:
                views_phases(Path(work), None, None)
        print(smi, flush=True)
        return 0
    for name in sorted(_build.build_all()):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    tensor_core_phase()

    t0 = time.perf_counter()
    state, step, imgs = make_step(make_cfg(BATCH))
    print(f"model params: {sum(p.numel() for p in state.model.parameters())}; "
          f"TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    calls, flat_loss = record_step(state, step, imgs)
    per_step = collections.Counter(name for name, _ in calls)
    print(f"recorded step: kernel calls per step {dict(per_step)}; loss "
          f"{flat_loss:.6f}", flush=True)
    if set(per_step) != set(SPARK_KERNELS):
        fail(f"the SparK step called {sorted(per_step)}, expected "
             f"{sorted(SPARK_KERNELS)}")
    stages = [stage_of(args) for name, args in reversed(calls)
              if name == "flat_bwd_mega"]  # the backward runs in reverse

    kern = kernel_phase(calls, ITERS)
    del calls
    torch.cuda.empty_cache()
    def show(cs):
        return ", ".join(f"{c[1]} {c[2]:.4f} / {c[3]:.4f}" for c in cs)

    for name in FLAT_KERNELS:
        calls = kern[name]["calls"]
        rest = [c for c in calls if not c[0]]
        print(f"{name} by call (kernel_ms / library_ms): stem "
              f"{show(c for c in calls if c[0])}; the rest "
              f"{sum(c[2] for c in rest):.4f} ms: {show(rest)}; the largest "
              f"call: {max(calls, key=lambda c: c[2])[1]}", flush=True)
    spark_launches, step_ms = step_phase(state, step, imgs, per_step,
                                         SPARK_STEPS, "fused",
                                         ff.FlatDoubleConv)
    del state, step, imgs
    torch.cuda.empty_cache()
    unfused_ms = unfused_phase(make_cfg(BATCH, fused=False), SPARK_STEPS,
                               "unfused")[2]
    torch.cuda.empty_cache()
    print(f"fused step_ms={step_ms:.3f} unfused step_ms={unfused_ms:.3f} "
          f"(fused/unfused {step_ms / unfused_ms:.3f})", flush=True)
    reference_phase("flat")
    print(f"SparK phases took {time.perf_counter() - t0:.1f} s", flush=True)
    bnv = bnv_phase(per_step, flat_loss)

    t0 = time.perf_counter()
    fc.FUSED_IMPL = "nhwc"
    try:
        nhwc_kern, nhwc_launches, nhwc_ms, nhwc_calls = nhwc_phase(
            flat_loss, SPARK_STEPS, ITERS)
        reference_phase("nhwc")
    finally:
        fc.FUSED_IMPL = "flat"
    for n in (*NHWC_KERNELS, "bn_relu_mask_pallas"):
        kern[n] = nhwc_kern[n]
    print(f"SparK steps (batch {BATCH}, bf16; same call): "
          + ", ".join(f"{label} step_ms={ms:.3f} img_per_s="
                      f"{BATCH / ms * 1e3:.2f}" for label, ms in (
                          ("flat fused", step_ms), ("nhwc fused", nhwc_ms),
                          ("unfused", unfused_ms)))
          + f" (nhwc/flat {nhwc_ms / step_ms:.3f}, nhwc/unfused "
          f"{nhwc_ms / unfused_ms:.3f})", flush=True)
    print(f"NHWC phases took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    moco_kern, moco_launches, moco_ms = moco_phase(MOCO_BATCH, MOCO_STEPS,
                                                   ITERS)
    kern.update(moco_kern)
    print(f"MoCo phases took {time.perf_counter() - t0:.1f} s", flush=True)

    scratch = repo / "_scratch"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as work:
        _, encoder, data_dir = cli_phase(Path(work), per_step)
        vp = views_phases(Path(work), data_dir, moco_ms)
        lib_phase(MOCO_BATCH, ITERS)
        t0 = time.perf_counter()
        ft_per_step, ft_ms, ft_plain_ms, ft_kern = finetune_phase(
            BATCH, SPARK_STEPS, ITERS)
        for name in FLAT_KERNELS:
            k = ft_kern[name]
            bms, by = rl.bound_ms(k["nbytes"], k["flops"], k["peak"])
            print(f"FT1 {name}: {ft_per_step[name]} calls a step, "
                  f"{k['ms']:.4f} ms a step = {k['ms'] / bms:.2f}x its bound "
                  f"({bms:.4f} ms, {by}), plain {k['plain_ms']:.4f}, library "
                  f"{k['library_ms']:.4f} ({k['ms'] / k['library_ms']:.2f}x), "
                  f"max_abs_err {k['max_abs_err']:.3e}; by call (kernel_ms / "
                  f"library_ms): {show(k['calls'])}", flush=True)
        print(f"FT1/FT-NHWC phases took {time.perf_counter() - t0:.1f} s",
              flush=True)
        finetune_cli_phase(Path(work), encoder, data_dir, ft_per_step)
        ft_host = ft_host_phase(data_dir, ft_per_step)

        t0 = time.perf_counter()
        cm = cm_phase(CM_BATCH, SPARK_STEPS)
        norm_phase(ITERS)
        mae_per_step, mae_launches, mae_ms, mae_plain_ms, mae_kern = \
            mae_phase(MAE_BATCH, SPARK_STEPS, ITERS)
        for name in FLAT_KERNELS:
            k = mae_kern[name]
            bms, by = rl.bound_ms(k["nbytes"], k["flops"], k["peak"])
            print(f"MAE1 {name}: {mae_per_step[name]} calls a step, "
                  f"{k['ms']:.4f} ms a step = {k['ms'] / bms:.2f}x its bound "
                  f"({bms:.4f} ms, {by}), plain {k['plain_ms']:.4f}, library "
                  f"{k['library_ms']:.4f} ({k['ms'] / k['library_ms']:.2f}x), "
                  f"max_abs_err {k['max_abs_err']:.3e}; by call (kernel_ms / "
                  f"library_ms): {show(k['calls'])}", flush=True)
        print(f"CM1/MAE1 (same call): CM-UNet batch {CM_BATCH} step_ms="
              f"{cm['step_ms']:.3f} img_per_s={cm['img_per_s']:.2f} peak "
              f"{cm['peak_gib']:.2f} GiB; MAE batch {MAE_BATCH} fused "
              f"step_ms={mae_ms:.3f} img_per_s={MAE_BATCH / mae_ms * 1e3:.2f}, "
              f"unfused {mae_plain_ms:.3f}; the phases took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _, cm_encoder = cm_cli_phase(Path(work), data_dir, mae_per_step)
        finetune_cli_phase(Path(work), cm_encoder, data_dir, ft_per_step)

        g_per_step, g_launches, g_kern, g1 = genesis_phase(
            GENESIS_BATCH, SPARK_STEPS, ITERS)
        for name in FLAT_KERNELS:
            k = g_kern[name]
            bms, by = rl.bound_ms(k["nbytes"], k["flops"], k["peak"])
            print(f"G1 {name}: {g_per_step[name]} calls a step, "
                  f"{k['ms']:.4f} ms a step = {k['ms'] / bms:.2f}x its bound "
                  f"({bms:.4f} ms, {by}), plain {k['plain_ms']:.4f}, library "
                  f"{k['library_ms']:.4f} ({k['ms'] / k['library_ms']:.2f}x), "
                  f"max_abs_err {k['max_abs_err']:.3e}; by call (kernel_ms / "
                  f"library_ms): {show(k['calls'])}", flush=True)
        print(f"G1 (batch {GENESIS_BATCH}): fused step_ms={g1['step_ms']:.3f} "
              f"img_per_s={GENESIS_BATCH / g1['step_ms'] * 1e3:.2f}, unfused "
              f"{g1['plain_ms']:.3f}; chain {g1['chain_ms']:.3f} ms "
              f"({100 * g1['chain_ms'] / g1['step_ms']:.1f}% of the step), "
              f"{g1['chain_device_ms']:.3f} device ms; peak "
              f"{g1['peak_gib']:.2f} GiB", flush=True)
        genesis_cli_phase(Path(work), data_dir, g_per_step)
        _, dv_launches = decoder_variants_phase(DV_BATCH, SPARK_STEPS)

        t0 = time.perf_counter()
        k1, k2 = FLAT_KERNELS
        k3 = {"spark_loss_pallas": 1, "spark_loss_bwd": 1}
        rm = {"spark": rm_pair("spark", {"": {k1: 4, k2: 4, **k3},
                                         RM_LEVELS: {k1: 8, k2: 4, **k3}},
                               SPARK_STEPS, ITERS),
              "mae": rm_pair("mae", {"": {k1: 6, k2: 6},
                                     RM_LEVELS: {k1: 12, k2: 6}},
                             SPARK_STEPS)}
        rm_kern = rm["spark"]["plain"]["kern"]
        for name in FLAT_KERNELS:
            k = rm_kern[name]
            bms, by = rl.bound_ms(k["nbytes"], k["flops"], k["peak"])
            print(f"RM {name} (SparK batch {rm['spark']['plain']['batch']}, "
                  f"without remat): {k['ms']:.4f} ms a step = "
                  f"{k['ms'] / bms:.2f}x its bound ({bms:.4f} ms, {by}), "
                  f"plain {k['plain_ms']:.4f}, library "
                  f"{k['library_ms']:.4f} ({k['ms'] / k['library_ms']:.2f}x), "
                  f"max_abs_err {k['max_abs_err']:.3e}; by call (kernel_ms / "
                  f"library_ms): {show(k['calls'])}", flush=True)
        print("RM (same call): " + "; ".join(
            f"{task} batch {r[c]['batch']} {c} step_ms={r[c]['step_ms']:.3f} "
            f"img_per_s={r[c]['batch'] / r[c]['step_ms'] * 1e3:.2f} peak "
            f"{r[c]['peak_gib']:.2f} GiB" for task, r in rm.items()
            for c in ("plain", "remat"))
            + f"; the phases took {time.perf_counter() - t0:.1f} s",
            flush=True)
        rm_cli_phase(Path(work), data_dir, rm["mae"])
        ev = ev_phase(encoder, data_dir)
        dp = dp_phases(Path(work), data_dir, step_ms, flat_loss, smi)
        ftdp = ftdp_phase(Path(work), encoder, data_dir, ft_per_step, smi)
        rm_launches = collections.Counter()
        for r in rm.values():
            for c in ("plain", "remat"):
                rm_launches.update(r[c]["launches"])
    graph = graph_phase()

    crops = kern["crop_resize_pallas"]["crops"]
    crop_px = [sum(r * c for r, c in zip(rows, cols))
               for _, rows, cols, _, _ in crops]
    print(f"bounds of every TPU kernel's work in one step (SparK batch {BATCH}; "
          f"flat stages {stages}; K4: the recorded MoCo crops, pixels inside "
          f"their windows {crop_px}; K6-K8: the NHWC step's calls "
          f"{nhwc_calls}):", flush=True)
    for r in rl.table(BATCH, stages, crops, nhwc_calls):
        print(f"  {r['kernel']} {r['name']}: {r['launches']} launch(es), "
              f"{r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP, "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    # K1-K3: the SparK run's launches, MAE1's, G1's, DV's, RM's, DP1's,
    # both DP2 ranks' and both FT-DP (b) ranks'
    dp_launches = collections.Counter(dp["dp1"]["launches"])
    dp_launches.update(dp["dp2"]["launches"])
    dp_launches.update(ftdp["launches"])
    launches = {**{n: spark_launches[n] + mae_launches.get(n, 0)
                   + g_launches.get(n, 0) + dv_launches.get(n, 0)
                   + rm_launches.get(n, 0) + dp_launches.get(n, 0)
                   for n in SPARK_KERNELS},
                # K4: phase 5's steps and VIEWS' checked pallas views
                **{n: moco_launches[n] + vp["views"]["k4"]
                   for n in MOCO_KERNELS},
                **{n: nhwc_launches[n]
                   for n in (*NHWC_KERNELS, "bn_relu_mask_pallas")}}
    # launches inside replays: every graph of this process (GRAPH's, the
    # CLI phases', FT-CLI's fits), its capture calls times its replays
    from cmx_torch.train.graph import REPORTS

    replayed = collections.Counter()
    for rep in REPORTS + ftdp["cli"]["replays"]:  # FT-DP's launcher's too
        for n, c in rep["capture_calls"].items():
            replayed[n] += c * rep["replays"]
    rows = []
    entries = kernels()
    for name, (_, _, route, source, replaces) in entries.items():
        if name == "spark_loss_bwd":
            continue  # folded into K3's row below
        k, n = kern[name], launches[name]
        resources = CORE_KERNELS.get(name, [])
        parts = None
        if name == "spark_loss_pallas":
            kb = kern["spark_loss_bwd"]
            parts = {}
            for part, kk, nn, rep in (
                    ("forward", k, n, replaces),
                    ("backward", kb, launches["spark_loss_bwd"],
                     entries["spark_loss_bwd"][4])):
                pms, pby = rl.bound_ms(kk["nbytes"], kk["flops"], kk["peak"])
                parts[part] = {"replaces": rep, "launches": nn,
                               "launches_in_replays": replayed[
                                   "spark_loss_pallas" if part == "forward"
                                   else "spark_loss_bwd"],
                               "max_abs_err": kk["max_abs_err"],
                               "ms": kk["ms"], "plain_ms": kk["plain_ms"],
                               "bound_ms": pms, "bound_by": pby,
                               "library_ms": None}
                print(f"spark_loss {part}: {kk['ms']:.4f} ms a step = "
                      f"{kk['ms'] / pms:.2f}x its bound ({pms:.4f} ms, "
                      f"{pby}), plain {kk['plain_ms']:.4f}, library none",
                      flush=True)
            k = {**k, **{f: k[f] + kb[f]
                         for f in ("ms", "plain_ms", "nbytes", "flops")},
                 "max_abs_err": max(k["max_abs_err"], kb["max_abs_err"])}
            n += launches["spark_loss_bwd"]
            resources = resources + CORE_KERNELS["spark_loss_bwd"]
        bms, by = rl.bound_ms(k["nbytes"], k["flops"], k["peak"])
        n_replayed = replayed[name] + (replayed["spark_loss_bwd"]
                                       if name == "spark_loss_pallas" else 0)
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": n,
                     "launches_in_replays": n_replayed,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": k["library_ms"]})
        if parts:
            rows[-1]["parts"] = parts
        if name == "bn_relu_mask_pallas":
            rows[-1]["path"] = ("none: no caller in cmx or the port; launches "
                                "are the K5 phase's")
        if resources:
            rows[-1]["kernel_resources"] = {
                label: CORE_RESOURCES.get(label) for _, label in resources}
            print(f"{name}: {k['ms']:.4f} ms a step = {k['ms'] / bms:.2f}x "
                  f"its bound ({bms:.4f} ms, {by}), plain {k['plain_ms']:.4f}"
                  f", library {k['library_ms']}", flush=True)
        if name in TC_KERNELS:
            rows[-1]["tflop_s"] = k["flops"] / k["ms"] / 1e9
            rows[-1]["tensor_core_kernels"] = {
                label: TC_RESOURCES.get(label) for _, label in TC_KERNELS[name]}
            print(f"{name}: {k['ms']:.4f} ms a step = "
                  f"{k['ms'] / k['library_ms']:.2f}x its library call "
                  f"({k['library_ms']:.4f} ms), {rows[-1]['tflop_s']:.1f} "
                  f"TFLOP/s, {k['ms'] / bms:.2f}x its bound", flush=True)
    print(f"per-step kernel times (ms, sum over one step's launches: SparK "
          f"batch {BATCH} for K1-K3 (FUSED_IMPL flat) and K6-K8 (nhwc), MoCo "
          f"batch {MOCO_BATCH} for K4, K5 once at down1's epilogue; "
          f"launches: {SPARK_STEPS} SparK steps of each impl, K1-K3 also "
          f"MAE1's, G1's, DV's, RM's and DP1's {SPARK_STEPS} steps each and "
          f"DP2's {DP2_STEPS} on each of its two ranks, K1/K2 FT-DP (b)'s "
          f"fits on its two ranks / "
          f"{MOCO_STEPS} MoCo steps and VIEWS' {vp['views']['k4']} checked "
          f"pallas views / the K5 phase); SparK step_ms flat="
          f"{step_ms:.3f} nhwc={nhwc_ms:.3f}; MF moco_fast step_ms="
          f"{vp['mf']['step_ms']:.3f} (K4 {vp['mf']['k4_ms']:.3f}); MF-CLI "
          f"{vp['mf_cli_s']:.1f} s; EV {ev['secs']:.1f} s; DP1 "
          f"(NCCL, world 1) step_ms={dp['dp1']['step_ms']:.3f}, DP2 (gloo, 2 "
          f"ranks on one card) step_ms per rank "
          f"{', '.join(f'{t:.3f}' for t in dp['dp2']['step_ms'])}; "
          f"FT-DP (a) the CLI {ftdp['cli']['one_s']:.1f} s without a group, "
          f"{ftdp['cli']['run_s']:.1f} s under torchrun (NCCL, world 1), "
          f"(b) fit seconds per gloo rank "
          f"{', '.join(f'{t:.3f}' for t in ftdp['secs'])}; "
          f"launches_in_replays: each graph's capture calls times its "
          f"replays (GRAPH's {len(graph)} cases, the CLI phases, FT-CLI's "
          f"and FT-DP (a)'s fits); GRAPH graph/eager step_ms "
          + ", ".join(f"{r['label']} {r['ratio']:.3f}" for r in graph)
          + "; BNV step_ms eager / graph " + ", ".join(
              f"{v} {r['eager_ms']:.3f} / {r['graph_ms']:.3f}"
              for v, r in bnv.items())
          + f"; FT-HOST fit seconds {ft_host['finite']['secs']:.3f} (NaN "
          f"validation {ft_host['nan']['secs']:.3f})", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
