#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA
GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure propagates and the script exits non-zero):

1. Print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``slim_switch_moe_vit_tpu_torch/csrc`` (one nvcc per
   source, in parallel).
2. Kernels: at the flagship shapes (B = 32 and 128, N = 197, D = 384,
   bf16) each of the twelve kernel wrappers (LayerNorm K1a/K1b/K2a in
   Triton; the LayerNorm backward K1c (plain and add forms) / K2b, MHA K5 /
   K6 and expert FFN K3 / K4, the fused AdamW + EMA K7 and the flash
   forward K11 in CUDA C++) is held against its plain PyTorch version on
   the card and both are timed, beside the card's bound for the same work
   and, where
   one exists, one PyTorch call computing the same function. Each time is
   the median over CUDA-event pairs that each span a loop of calls (about
   2 ms of device work), so the host's pace does not enter a
   sub-millisecond kernel's time. Elementwise outputs must be
   within ``ELEM_TOL`` (default ``ATOL``/``RTOL``); f32 sums over all rows
   (dgamma, dbeta, dW, db) within ``SUM_REL`` of their largest |ref|. K6's
   limit must reject planted faults in its plain form; K4 (dx, dW1, dW2;
   at B = 32 and 128, and at D = 768 and 192 in phase 13; K8 at cfg4,
   dropless B = 128, D = 768 and D = 192), K5, K6 and K11 (and K12
   in phase 13) may be no less accurate against the exact f32 function
   than their plain versions (``EXACT_RATIO``), and K1c's two forms and
   K2b (du, dgamma, dbeta, at B = 128) no less accurate against the
   exact function in f64; two calls of each of these three give
   bit-identical outputs.
3. Serving: ``moe_small_patch16_224_expert8`` at full width (ViT-S/16, 12
   blocks, 8 experts top-2), bf16, seeded random weights, exported through
   the export CLI with buckets 1, 8 and 32, loaded, and served over HTTP on
   127.0.0.1. Requests of 1, 5 and 40 images must come back finite, of the
   right shape and equal to the Predictor's own output, and the kernels'
   launch counters must rise by 25 LN (1 no-add, 23 add, 1 slim), 12 MHA
   and 12 expert-FFN launches per forward.
4. Cross-check: the same weights and 8 images through the port's plain
   path on the CPU in f32, with the card's expert choices imposed on it
   (``pinned_routing``), against the card's bf16 logits (``XCHECK_*``).
5. Speed: serving images/s at bucket 32, p50 latency at batch 1, device
   time per forward at B = 32 and 128, and the device-time breakdown of one
   B = 128 forward by kernel.
6. Training: ``moe_small_patch16_224_expert8`` at full width and depth,
   bf16, seed-0 weights, B = 128 (``bench.py``'s cfg2: label smoothing
   0.1, AdamW wd 0.05, EMA 0.99996, lr 1e-3), one warm-up step and then 10
   steps on the same batch through ``engine.make_train_step``. Every loss
   and gradient finite, the EMA moved, and the launch counters rise by
   exactly ``PER_TRAIN_STEP`` per step.
7. Training cross-check: the same weights and one B = 8 batch through 4
   steps at lr 1e-3 on the card (bf16) and on the port's CPU plain path in
   bf16 (also with the batch reversed, the witness of bf16 rounding alone)
   and in f32: per-step losses and the step-1 gradient's cosines within
   ``XTRAIN_PAIRS``.
8. Training speed: the B = 128 step on the device clock and images/s, the
   busy share and kernel profile of one step, and the peak memory.
9. ResMoE step: ``resmoe_small_patch16_224_expert8`` (the gated ResMoE
   ViT-S/16, 24 slim LNs a forward) at B = 128, bf16, 10 steps each with
   and without the fused optimizer (K7) on the device clock, with exact
   launch counts; then one step from the same state and gradients on both
   optimizer paths, whose parameters, moments and EMA must agree
   (``PATH_ULPS``, ``BC_REL``).
10. Driver: ``python -m slim_switch_moe_vit_tpu_torch.main``'s ``main()``
    on ``SYNTH`` at full width (``DRIVER_ARGS``: 2 tasks of 2 epochs, 3
    steps an epoch at B = 128, rehearsal, ``--fused-optimizer``, the gates
    disabled through each task's first epoch and enabled at 0.95 then 0.9).
    Every train step launches exactly ``PER_RESMOE_STEP`` and every eval
    forward ``PER_RESMOE_FORWARD``; losses are finite; the gate thresholds
    after each epoch equal the anneal plan's; the checkpoint restores
    parameters, moments and EMA bit for bit. Then ``--eval --resume
    <checkpoint> --use-flash-attention``: 12 K11 launches and no K5 per
    forward, and the flash logits within the serving limit (``XCHECK_*``)
    of K5's on the same checkpoint.

11. Capacity (``bench.py``'s cfg4: ``moe_small_patch16_224_expert8``,
    ``capacity_fused`` at factor 1.25, B = 128): (a) the gather-in-kernel
    expert FFN forward and backward (K9) and the deferred-dW backward (K8)
    against their plain versions at cfg4's layout (Tp = 63,488), the
    dropless B = 128 layout (Tp = 52,480) and a small layout with a
    starved expert and a skewed router that overflows the capacity, timed
    beside their bounds, K9's forward beside the dispatch gather + K3 and
    K8 beside K4; (b) one MoE layer at full width with a skewed router
    (``drop_fraction`` > 0.1) through ``capacity_fused`` three ways (K3/K4,
    ``SSMV_GATHER_IN_KERNEL=1``, ``SSMV_DEFER_DW=1``) against the
    scatter-buffer ``'capacity'`` oracle: ``keep`` and ``drop_fraction``
    identical, y, dx, dW1 and dW2 within the kernel limits; (c) cfg4's
    training step in the same three forms from the same weights on
    ``bench.py``'s batch, ``CAP_STEPS`` steps each with exact per-step
    launch counts (``PER_CAP_STEP``, ``CAP_DISPATCH_GATHERS``), finite
    losses within ``CAP_WITNESS`` times the gap of a witness (the default
    form with the batch reversed) of the default form's, images/s and one
    step's profile, whose LN-backward launches must equal the step's
    LN-backward wrapper calls (one launch a call). The knobs are set inside
    the phase and restored.

12. Expert parallelism, its ranks sharing the one card over gloo (NCCL
    takes one rank per card; the times are not NCCL exchange times): (a)
    the permuted-tile expert FFN (K10) forward and backward against their
    plain versions and the expert-major relayout + K3/K4 at the ep=4 layout
    of cfg4's a2a form (16,384 rows a rank, 64 steps over 2 experts, a
    permutation that is not the identity), timed beside their bounds; (b)
    one MoE layer (T = 25,216) on 4 ranks in the psum, a2a relayout, a2a
    K10 and sharded 'capacity' forms and the dropless 'fused' form (the
    experts gathered on every rank; K3/K4 once a rank; y, dx and every
    gradient bit-identical to the single-rank 'fused' layer: phase 20 (d)),
    against the single-rank
    ``capacity_fused`` at factor 2.0 (no drops; y, dx, dW within the
    kernel limits), and the two a2a forms against each other at 1.25;
    (c) cfg4's step at ep=4 in the relayout and K10 forms, ``EP_STEPS``
    steps with exact per-step launch counts on every rank (12 K10 forward
    and 12 backward launches a step), losses within the cfg4 witness rule,
    dense parameters bit-identical over the ranks; (d) the driver
    (``python -m slim_switch_moe_vit_tpu_torch.main --expert-parallel 2
    --moe-dispatch capacity_fused_a2a``, ``SSMV_A2A_PERMUTED=1``) on 4 ranks
    (dp 2 x ep 2), then ``--resume``: every rank exits 0, the dense
    parameters bit-identical over the ranks, the checkpoint restored on
    one rank.

13. Coverage kernels: K12 (attention with the proj folded in) at deit-tiny
    (B = 256, 3 heads) and ViT-S (B = 128, 6 heads) eval shapes against its
    plain version and the exact f32 function, beside K5 + the proj GEMM and
    SDPA + ``F.linear``; the LayerNorm backward (K1c's two forms, K2b) at
    6,301 rows (no ring stage divides them) and D = 192, 768, 1,280 and 100
    (the scalar form) in bf16 and D = 384 and 100 in f32 (``LN_COV``); K13's
    gather and scatter-add on the dropless B = 128 layout (52,480 rows of
    25,216 tokens) bit for bit against their plain versions (the
    scatter-add in bf16 and f32), beside ``index_select`` / ``index_add_``;
    K3, K4, K8, K9 and K10 at D = 768 (moe_base_patch16_224_expert32's
    layout at B = 32; K4 and K8 also against the exact f32 function) and in
    f32 at D = 384, K4 and K8 at D = 192 (moe_tiny_patch16_224_expert8's
    dropless layout at B = 128, both against the exact f32 function), K6
    in f32, K5 and K6 at
    N = 577 in bf16 and f32, K5, K6 and K11 at vit_huge_patch14_224's head
    (16 heads of 80, N = 257, ``HUGE``), K11 in f32 and K12 at N = 577 and
    C = 1024 (``K12_LONG``), against their plain versions (f32 within
    ``F32_TOL``).
14. D = 768: ``resmoe_base_patch16_224_expert8`` trains ``WIDE_STEPS`` steps
    at B = 32 on the kernels (exact launch counts, every attention on the
    K5 + K6 route); ``moe_base_patch16_224_expert32`` evaluates B = 32
    images, held to the card's plain path (``plain_versions``: every
    forward kernel wrapper replaced by its plain version) within the
    serving limit, in f32 and in bf16 (``pinned_routing``).
15. f32: the flagship in f32 trains ``F32_STEPS`` steps at B = 16 on the
    kernels, against the same steps on the plain versions, within
    ``F32_WITNESS`` times a batch-reversed witness (or ``F32_FLOOR``).
16. N = 577 (the flagship at 384 px): an eval at B = 8 on the K5 route,
    one train step at B = 4 on the K5 + K6 route, each held to the card's
    plain path.
17. Export: the driver's checkpoint (phase 10) through the export CLI with
    ``--use-ema`` at ``--img-size`` 256, serving one request. Then the op
    path: K12 and K13 as a user calls these ops (no model path calls them,
    as in the JAX package), their launches counted.

18. The DeiT / ViT zoo and the data pipeline at the driver's defaults
    (``zoo_phase``; bf16 activations, f32 params): (a) ``bench.py``'s cfg1,
    ``deit_tiny_patch16_224`` eval at B = 256, held to the card's plain
    path, images/s by events and one profiled forward's kernel sum; (b)
    ``deit_base_patch16_224`` (the driver's default model, D = 768, 12
    blocks) trains ``DEIT_STEPS`` steps at B = 128 through
    ``engine.make_train_step`` with the driver's default augmentation
    (RandAugment rand-m9-mstd0.5-inc1, color jitter 0.3, erasing 0.25) and
    mixup 0.8 / cutmix 1.0 / smoothing 0.1, the step by events and by its
    kernel sum, the augmentation and mixup alone by events, and one step on
    the kernels against the same step on the plain versions from the same
    generator seed (the same augmented batch) within XTRAIN's step-1 loss
    limit; (c) ``deit_small_distilled_patch16_224`` trains 2 steps at B = 64
    on its (logits, logits_dist) pair, evaluates B = 32 (the mean of the
    two heads) against the plain path, and its weights go through the
    export CLI, the Predictor and one HTTP request matching the eval; (d)
    ``vit_large_patch32_224_in21k`` (the pre-logits layer, 21,843 classes)
    evaluates B = 16 against the plain path; (e) the driver, ``python -m
    slim_switch_moe_vit_tpu_torch.main`` on SYNTH, with every flag at its
    default and with ``scripts/run_reference_recipe.sh``'s flags on
    ``deit_tiny_patch16_224``, 1 epoch of 4 steps and its evals each: exit
    0, finite losses, steps/s. Every forward and step of (a)-(d) launches
    exactly ``PER_DEIT_FORWARD`` / ``PER_DEIT_STEP`` (``PER_VIT_L_FORWARD``
    for the 24 blocks of (d)) with every attention on the K5 (+ K6) route.
19. Fine-tuning, distillation, the switchable and sparse ViTs
    (``distill_phase``; bf16 student activations, f32 parameters, the
    teacher in f32): (a) the DeiT distillation recipe through the driver
    as a process, ``--model deit_base_distilled_patch16_224 --finetune
    <student .pth at 384 px> --distillation-type hard --teacher-model
    regnety_160 --teacher-path <teacher .pth> --async-checkpoint`` on
    SYNTH at B = 64, 4 steps at the driver's default augmentation and
    mixup (both files in timm's names, from seeded weights): exit 0,
    finite losses; the driver's ``finetune_from`` on the same file gives
    the file's weights and ``resize_pos_embed``'s position embedding; its
    ``--eval --resume`` of the checkpoint holds the saved parameters, EMA
    and moments bit for bit; (b) the distilled DeiT-B step at B = 128,
    ``hard`` and ``soft``, on the kernels and on the card's plain path from
    one seed and one set of teacher logits (computed once), within XTRAIN's
    step-1 loss limit and gradient cosine, launches exact
    (``PER_DEIT_STEP``, none in the teacher); the hard step at the driver's augmentation and mixup with
    the teacher inside by events and by kernel sum, the teacher's forward
    alone and its share, the peak memory; (c) the teacher's logits on the
    card (TF32 convolutions) against the CPU f32 run of the same weights on
    4 images within ``TEACHER_REL``, which a bf16-activation teacher of the
    same weights must exceed; (d) ``deit_sw_tiny_patch16_224`` with
    4 buckets and ``route_capacity`` 98 of 197: a routed eval at B = 128
    against the card's plain path within the serving limit, N = 98 in the
    11 mid blocks, launches and routes exact (``PER_SW_FORWARD``), the
    routed and unrouted evals by events, 2 routed training steps against
    the plain path (``PER_SW_STEP``; each step's loss within XTRAIN's
    limit, the step-1 gradient within XTRAIN's cosine); (e) ``sparse_deit_tiny_patch16_224``
    in f32 with its zetas spread over [0, 1): 2 search steps with the L1
    zeta loss and ``compress`` at (0.5, 0.5, 0.5) on the card and on the
    CPU, every mask equal element for element, the compressed forward,
    ``get_remaining`` and the FLOP counts; (f) one distillation step under
    ``utils/profiling.trace``, ``summarize_trace``'s top rows.

20. The optimizer surface, ``expert_choice``, expert dropout, the dropless
    modes under expert parallelism and a gated artifact (``surface_phase``;
    each part prints its time beside the card's name and power limit): (a)
    the f32 gradients of one kernel step of the flagship at B = 32, and
    every ``--opt`` name's two steps from them on the card and on the CPU,
    every parameter within ``OPT_REL`` of its leaf's largest |ref| plus
    ``OPT_LR_SLACK`` lr; the driver with ``--opt lamb --clip-grad 1.0``
    (its checkpoint restored bit for bit, then ``--resume``) and with
    ``--finetune`` of a timm-format DeiT-S file and ``--attn-only`` (every
    frozen parameter bit-identical to the file's); (b) the flagship with
    ``--moe-dispatch expert_choice``: an eval at B = 32 against the card's
    plain path within the serving limit (f32, and bf16 with the expert
    choices imposed, ``pinned_expert_choice``) and 2 training steps within
    XTRAIN's limits, launches exact; (c) ``--drop 0.1``: a training step
    routed to ``'ragged'``, its loss finite, the kept share of the hidden
    activations within 5 binomial standard deviations of 0.9; (d) in the
    EP phase (12 (b)); (e) ``resmoe_small_patch16_224_expert8`` with its
    gates' eval targets lowered to 0.3, exported and served: a positive
    share of tokens skipped, the served logits held to the eval.

Each attention forward's route (``models/vit.py::attention_route``) is
counted in ``ROUTE_COUNTS``; phases 14, 16, 18, 19 and 20 assert it.

The kernel phase (2) also holds K7 (the fused AdamW + EMA over every
parameter of the ResMoE model) and K11 (the flash forward, at N = 197 and
577) against their plain versions. Each kernel's ``launches`` in the JSON
line is its count in the run of the path it belongs to: the 10 training
steps of phase 6 for K1a-K6, the driver run for K7, the flash eval for K11,
cfg4's steps in the K9 form for K9 and in the K8 form for K8 (phase 11),
rank 0's count in cfg4's ep=4 steps in the K10 form for K10 (phase 12),
the op path's calls for K12 and K13 (phase 17).

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

MODEL = "moe_small_patch16_224_expert8"
N_TOK, DIM, HEADS, EXPERTS, HIDDEN = 197, 384, 6, 8, 1536
BUCKETS = (1, 8, 32)
REQUESTS = (1, 5, 40)              # a padded bucket, a padded tail, chunking
PER_FORWARD = {"fused_ln": 1, "fused_add_ln": 23, "fused_sum_ln": 1,
               "fused_mha": 12, "fused_expert_ffn": 12}
PER_TRAIN_STEP = {**PER_FORWARD, "fused_ln_bwd": 1, "fused_add_ln_bwd": 23,
                  "fused_sum_ln_bwd": 1, "fused_mha_bwd": 12,
                  "fused_expert_ffn_bwd": 12}
# kernel vs plain version on the card, bf16 outputs: |d| <= atol + rtol*|ref|
# elementwise; 1.6e-2 is two bf16 ulps at 1.0 (the two sides round once
# each, with f32 sums taken in different orders)
ATOL = RTOL = 1.6e-2
# per-kernel (atol, rtol) where outputs sit far below 1: K6's dq/dk/dv
# are ~0.07 per element (max ~1.9 at B=128), so its atol is one bf16 ulp
# at 0.5-1 (2^-8 = 3.9e-3, the largest |d| measured). The smoke checks
# that this limit rejects the plain backward with its softmax delta term
# (e*linv*sum(e*dp)) dropped or off by 5% or 2% (PLANTED_DELTA).
ELEM_TOL = {"fused_mha_bwd": (4e-3, 1.6e-2)}
PLANTED_DELTA = (0.0, 0.95, 0.98)
# the bf16 tensor-core kernels K3-K6, K9's and K10's forwards, K11 and K12
# against the exact f32 function (their plain versions on the f32-cast
# inputs, no rounding to bf16 inside): the kernel's mean |d| may exceed its
# bf16 plain version's by at most this factor. Both round the same values
# at the same points, in other summation orders, so their mean errors
# agree closely; a kernel that rounds once more, or loses the f32 sums,
# reads well above it. K12 is checked at each of its shapes
# (``proj_case``), K4 (dx, dW1, dW2) at each of its layouts in
# ``kernel_phase`` and at D = 768 and 192, K8 (``check_defer``) at cfg4,
# dropless B = 128, D = 768 and 192, K3 at B = 128 and D = 768, K9's forward
# at cfg4 and K10's at ep=4 (``exact_ffn_fwd``), the rest at B = 128. The
# LN backward (K1c's two forms, K2b; du, dgamma and dbeta) is held to the
# exact function in f64 at B = 128 (``check_ln_bwd``): its f32 sums would
# equal the plain version's exact f32 run bit for bit.
EXACT_RATIO = 1.1
EXACT_CHECKED = ("fused_mha", "fused_mha_bwd", "flash_attention")
# f32 sums over all ~25k (LN) or an expert's ~6k (FFN) rows, in other
# orders on the two sides, of products that differ by an ulp where a bf16
# rounding flips; dW is rounded to bf16 on both sides (2^-9 relative):
# max |d| within 1e-2 of max |ref|
SUM_REL = 1e-2
# card bf16 logits vs CPU f32 logits: max |d| within 5% of max |ref| (a
# CPU-only bf16 run of this model differs by 1.4%), cosine >= 0.999 per
# image, and the same top-1 wherever the f32 top-1 margin exceeds twice
# the largest |d|. The serving cross-check imposes the card's expert
# choices on the f32 run: with random weights a near tie among the
# router's logits flips under any bf16 rounding (the unpinned gaps are
# printed: on the smoke's 8 images the card's plain path in bf16 is 30.2%
# of max |ref| from f32 on one of them; NVIDIA H100 80GB HBM3 at 700 W)
XCHECK_REL, XCHECK_COS = 5e-2, 0.999
# where the kernels' expert choices are imposed on a bf16 plain run
# (pinned_routing), the most of its gated tokens whose own top-k may differ
ROUTE_MOVED_MAX = 0.05
# the flash eval's logits vs the K5 eval's of the driver's checkpoint: the
# serving limit above, or FLASH_WITNESS times the gap between the K5 eval
# and the CPU bf16 plain path on the same 64 images (the witness of what
# bf16 rounding alone does to this checkpoint), whichever is wider; each
# block's K11 output on the checkpoint's own qkv within K5's limit. On an
# NVIDIA H100 80GB HBM3 at 700 W: flash vs K5 11.3% of max |ref| and
# cosine 0.9974, the witness 11.9% and 0.9974, both from the same three
# images (~1% of tokens routed to another expert pair by block 12 in both
# pairs); every other image within 1%; K11 within one bf16 ulp of K5 on
# every block
FLASH_WITNESS = 3.0
# card bf16 training vs the CPU plain path, 4 steps at B=8 and bench's lr
# 1e-3 from the same weights: (pair, (each step's loss rel diff, flattened
# step-1 gradient cosine, every tensor's cosine) or None where the pair is
# printed only). Adam memorizes the 8 images in a few steps and bf16
# rounding alone then moves the loss: the CPU bf16 run with its batch
# reversed parts from itself by 0, 0.44%, 1.6%, 2.2% and 7.6% per step
# (measured on an NVIDIA H100 80GB HBM3 host at 700 W). So:
# - vs CPU bf16: 1% for the first two steps (0.03%, 0.40% measured), 5%
#   at step 3 (1.7%), 10% after (3.6%, 2.4%); the step-1 gradient at
#   cosine >= 0.999 (0.999885), every tensor's >= 0.99 (0.9989);
# - vs CPU f32: the same 1%, 1%, 5% (0.29%, 0.13%, 0.90%), then 30%:
#   the CPU's own bf16 run is 19.2% and 10.3% from f32 at steps 4-5, the
#   card 22.1% and 12.4%; the step-1 gradient at cosine >= 0.99 (0.992;
#   block 10's router gradients, a difference of two bf16 rowsums in the
#   combine's backward as in the JAX package, sit at cosine 0.17-0.22 to
#   f32 on the card and 0.18-0.24 in the CPU bf16 run)
# (4 steps, to hold the smoke's run time; the limits of steps 1-4 as set)
XTRAIN_B, XTRAIN_STEPS, XTRAIN_LR = 8, 4, 1e-3
XTRAIN_PAIRS = (
    ("cuda bfloat16", "cpu bfloat16", ((1e-2, 1e-2, 5e-2, 0.1), 0.999,
                                       0.99)),
    ("cpu bfloat16 reversed", "cpu bfloat16", None),
    ("cuda bfloat16", "cpu float32", ((1e-2, 1e-2, 5e-2, 0.3), 0.99,
                                      None)),
    ("cpu bfloat16", "cpu float32", None))
TRAIN_B, TRAIN_STEPS, LR, EMA_DECAY = 128, 10, 1e-3, 0.99996
# the gated ResMoE ViT-S/16: block 0's norm1 the plain LN, every other norm
# the slim LN (K2a forward, K2b backward)
RESMOE = "resmoe_small_patch16_224_expert8"
PER_RESMOE_FORWARD = {"fused_ln": 1, "fused_sum_ln": 24, "fused_mha": 12,
                      "fused_expert_ffn": 12}
PER_RESMOE_STEP = {**PER_RESMOE_FORWARD, "fused_ln_bwd": 1,
                   "fused_sum_ln_bwd": 24, "fused_mha_bwd": 12,
                   "fused_expert_ffn_bwd": 12, "fused_adamw_ema": 1}
PER_FLASH_FORWARD = {"fused_ln": 1, "fused_sum_ln": 24, "flash_attention": 12,
                     "fused_expert_ffn": 12}
RESMOE_STEPS = 10
# the training driver at full width: 2 tasks of 2 epochs, 3 steps an epoch
# at B=128 (4 batches a task: SYNTH's 10 classes split 5/5 over 1024
# images), one rehearsal step after each epoch of task 2, the gates
# disabled through each task's first epoch
DRIVER_ARGS = ["--data-set", "SYNTH", "--synth-size", "1024", "--model",
               RESMOE, "--batch-size", "128", "--epochs", "2", "--num-tasks",
               "2", "--rehearsal", "--rehearsal-batch-size", "128",
               "--fused-optimizer", "--warmup-epochs", "0",
               "--gate-epoch-offset", "0", "--max-steps-per-epoch", "3",
               "--no-repeated-aug", "--mixup", "0", "--cutmix", "0", "--aa",
               "", "--color-jitter", "0", "--reprob", "0"]
DRIVER_TRAIN_STEPS = 2 * 3 + 2 * (3 + 1)
# cfg4 (bench.py:315-326): capacity_fused at factor 1.25, B=128, in three
# forms: the default (dispatch gather + K3, K4), the gather-in-kernel knob
# (K9 forward and backward, no dispatch gather) and the deferred-dW knob
# (K3, K8)
CAP_FACTOR, CAP_STEPS = 1.25, 4
CAP_FORMS = {"default": None, "K9": "SSMV_GATHER_IN_KERNEL",
             "K8": "SSMV_DEFER_DW"}
PER_CAP_STEP = {
    "default": PER_TRAIN_STEP,
    "K9": {**PER_TRAIN_STEP, "fused_expert_ffn": 0, "fused_expert_ffn_bwd": 0,
           "fused_expert_ffn_gather": 12, "fused_expert_ffn_gather_bwd": 12},
    "K8": {**PER_TRAIN_STEP, "fused_expert_ffn_bwd": 0,
           "fused_expert_ffn_bwd_defer": 12}}
CAP_DISPATCH_GATHERS = {"default": 12, "K9": 0, "K8": 12}
# the three forms' per-step losses vs the default form's, relative: within
# CAP_WITNESS times the witness's gap at the same step (the default form on
# the batch reversed: the same function in other summation orders, since
# random weights drop no pair at 1.25), or CAP_FLOOR, whichever is wider
CAP_WITNESS, CAP_FLOOR = 3.0, 1e-3
# the MoE layer check: a router bias that sends more pairs to experts 0
# and 1 than their capacity holds
CAP_ROUTER_SKEW = 1.5
# K7 vs its plain version, f32: the same operations in the same order, but
# nvcc contracts a*b + c into one FMA where torch rounds twice, so a value
# may be off by an ulp or two of its operands: |d| <= 4 ulps (4 * 2^-23)
# of |ref| plus 4 ulps of the leaf's largest |ref|
K7_ULPS = 4 * 2.0 ** -23
# one step of the fused optimizer vs torch.optim.AdamW + the foreach EMA
# from the same state and gradients: the same function in another order
# (torch decays p first and lerps the first moment), within 8 ulps (2^-20)
# of each leaf's largest value before or after the step (for the first
# moment also of (1-b1)*|g|: b1*mu + (1-b1)*g can cancel far below its
# terms, and the two forms round the terms differently); the JAX math's
# bias corrections are f32
# (1 - 0.999^t keeps up to ~3e-5/t of relative error, torch's are double),
# so parameters and EMA also get 1e-4 * lr (tests/test_torch_fused_adamw.py)
PATH_ULPS, BC_REL = 2.0 ** -20, 1e-4
# expert parallelism (phase 12): EP_RANKS ranks sharing the one card over
# gloo (NCCL takes one rank per card); cfg4's layout at ep=4; the K10 form
# of the a2a dispatch launches K10 where the relayout form launches K3/K4
EP_RANKS, EP_STEPS = 4, 2
EP_LAYER_FORMS = ("psum", "a2a", "a2a_perm", "sharded")
PER_EP_K10_STEP = {**PER_TRAIN_STEP, "fused_expert_ffn": 0,
                   "fused_expert_ffn_bwd": 0, "fused_expert_ffn_permuted": 12,
                   "fused_expert_ffn_permuted_bwd": 12}
# the driver on dp 2 x ep 2: 1 task x 1 epoch x 3 steps at B=32 a data
# shard (eval batches of 48: every token count splits over ep 2)
EP_DRIVER_ARGS = ["--data-set", "SYNTH", "--synth-size", "512", "--model",
                  RESMOE, "--batch-size", "32", "--expert-parallel", "2",
                  "--moe-dispatch", "capacity_fused_a2a", "--fused-optimizer",
                  "--warmup-epochs", "0", "--max-steps-per-epoch", "3",
                  "--no-repeated-aug", "--mixup", "0", "--cutmix", "0",
                  "--aa", "", "--color-jitter", "0", "--reprob", "0",
                  "--num_workers", "2"]
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SRC = "slim_switch_moe_vit_tpu_torch/"
JAX = "slim_switch_moe_vit_tpu/"
KERNELS = [  # name, route, source, TPU kernel it replaces
    ("fused_ln", "triton", SRC + "ops/_fused_ln_triton.py", JAX + "ops/fused_ln.py:123"),
    ("fused_add_ln", "triton", SRC + "ops/_fused_ln_triton.py", JAX + "ops/fused_ln.py:117"),
    ("fused_sum_ln", "triton", SRC + "ops/_fused_ln_triton.py", JAX + "ops/fused_ln.py:268"),
    ("fused_mha", "cuda", SRC + "csrc/mha_fwd.cu", JAX + "ops/attention.py:168"),
    ("fused_expert_ffn", "cuda", SRC + "csrc/expert_ffn_fwd.cu", JAX + "ops/fused_ffn.py:166"),
    ("fused_ln_bwd", "cuda", SRC + "csrc/ln_bwd.cu", JAX + "ops/fused_ln.py:159"),
    ("fused_add_ln_bwd", "cuda", SRC + "csrc/ln_bwd.cu", JAX + "ops/fused_ln.py:159"),
    ("fused_sum_ln_bwd", "cuda", SRC + "csrc/ln_bwd.cu", JAX + "ops/fused_ln.py:273"),
    ("fused_mha_bwd", "cuda", SRC + "csrc/mha_bwd.cu", JAX + "ops/attention.py:203"),
    ("fused_expert_ffn_bwd", "cuda", SRC + "csrc/expert_ffn_bwd.cu", JAX + "ops/fused_ffn.py:261"),
    ("fused_adamw_ema", "cuda", SRC + "csrc/fused_adamw.cu", JAX + "ops/fused_adamw.py:50"),
    ("flash_attention", "cuda", SRC + "csrc/flash_fwd.cu", JAX + "ops/attention.py:35"),
    ("fused_expert_ffn_gather", "cuda", SRC + "csrc/expert_ffn_fwd.cu", JAX + "ops/fused_ffn.py:605"),
    ("fused_expert_ffn_gather_bwd", "cuda", SRC + "csrc/expert_ffn_bwd.cu", JAX + "ops/fused_ffn.py:658"),
    ("fused_expert_ffn_bwd_defer", "cuda", SRC + "csrc/expert_ffn_bwd_defer.cu", JAX + "ops/fused_ffn.py:312"),
    ("fused_expert_ffn_permuted", "cuda", SRC + "csrc/expert_ffn_fwd.cu", JAX + "ops/fused_ffn.py:176"),
    ("fused_expert_ffn_permuted_bwd", "cuda", SRC + "csrc/expert_ffn_bwd.cu", JAX + "ops/fused_ffn.py:374"),
    ("fused_mha_proj", "cuda", SRC + "csrc/mha_proj_fwd.cu", JAX + "ops/attention.py:335"),
    ("gather_rows", "cuda", SRC + "csrc/gather_rows.cu", JAX + "ops/gather_pallas.py:43"),
    ("scatter_add_rows", "cuda", SRC + "csrc/gather_rows.cu", JAX + "ops/gather_pallas.py:72"),
]
# f32 kernels vs their plain versions, exact f32 on the card (TF32 off):
# the same function in other summation orders, |d| <= 1e-4 + 1e-4 |ref|
# elementwise (sums over rows included); single-pass TF32 (10 mantissa
# bits) would fail it
F32_TOL = (1e-4, 1e-4)
# K12 at deit-tiny eval (the shape the JAX package measured it at,
# attention.py:400-404) and at ViT-S: (B, N, heads)
K12_SHAPES = {"deit_tiny": (256, 197, 3), "vit_s": (128, 197, 6)}
# the D = 768 expert layout: moe_base_patch16_224_expert32 at B = 32
WIDE_MODEL, WIDE_B, WIDE_D, WIDE_E, WIDE_H = (
    "moe_base_patch16_224_expert32", 32, 768, 32, 3072)
RESMOE_BASE, WIDE_STEPS = "resmoe_base_patch16_224_expert8", 2
# K4 and K8 at D = 192: moe_tiny_patch16_224_expert8's dropless layout at
# B = 128
TINY_B, TINY_D, TINY_E, TINY_H = 128, 192, 8, 768
PER_RESMOE_BASE_STEP = dict(PER_RESMOE_STEP, fused_adamw_ema=0)
# the f32 path: moe_small_patch16_224_expert8 in f32, B = 16, 2 steps on
# the kernels against the same steps on the plain versions; each step's
# loss within F32_WITNESS times the gap of a witness (the plain steps on
# the batch reversed: the same function in other summation orders) or
# F32_FLOOR, and the step-1 gradient at cosine >= F32_COS
F32_B, F32_STEPS, F32_WITNESS, F32_FLOOR, F32_COS = 16, 2, 3.0, 1e-5, 0.9999
# N = 577: moe_small at 384 px; eval at B = 8 (K5 route), one train step
# at B = 4 (K5 + K6 route)
LONG_IMG, LONG_EVAL_B, LONG_TRAIN_B = 384, 8, 4
# vit_huge_patch14_224's attention (16 heads of 80, N = 257) at B = 8, and
# K12 at N = 577 and C = 1024 (16 heads of 64) at B = 2: (B, N, heads, d)
HUGE, K12_LONG = (8, 257, 16, 80), (2, 577, 16, 64)
# the driver checkpoint served through the export CLI at this size
EXPORT_IMG = 256
# phase 18, the DeiT / ViT zoo and the data pipeline at the driver's
# defaults: the dense models' launches (block 0's norm1 the plain LN, every
# later norm the add+LN, the final norm the slim LN; no expert FFN: the
# dense MLP is cuBLAS, as the JAX package computes it in XLA)
DEIT_TINY, DEIT_BASE = "deit_tiny_patch16_224", "deit_base_patch16_224"
DEIT_DISTILLED = "deit_small_distilled_patch16_224"
VIT_L21K = "vit_large_patch32_224_in21k"  # 24 blocks, pre-logits, 21,843
PER_DEIT_FORWARD = {"fused_ln": 1, "fused_add_ln": 23, "fused_sum_ln": 1,
                    "fused_mha": 12}
PER_DEIT_STEP = {**PER_DEIT_FORWARD, "fused_ln_bwd": 1,
                 "fused_add_ln_bwd": 23, "fused_sum_ln_bwd": 1,
                 "fused_mha_bwd": 12}
PER_VIT_L_FORWARD = {"fused_ln": 1, "fused_add_ln": 47, "fused_sum_ln": 1,
                     "fused_mha": 24}
# cfg1 (bench.py:305-308) eval at B=256; DeiT-B steps at B=128; the
# distilled model's steps at B=64 and eval at B=32; the in21k eval at B=16
CFG1_B, DEIT_B, DEIT_STEPS = 256, 128, 4
DIST_B, DIST_STEPS, DIST_EVAL_B, VIT_L_B = 64, 2, 32, 16
# the driver's default augmentation and mixup (config.py)
DEIT_AUG = dict(aa="rand-m9-mstd0.5-inc1", color_jitter=0.3, reprob=0.25)
DEIT_MIX = dict(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1)
# the driver as a user runs it, 1 epoch of 4 steps and its evals: every
# other flag at its default (deit_base_patch16_224, B=64, SYNTH's 512
# images), then scripts/run_reference_recipe.sh's flags on SYNTH
ZOO_DRIVER_RUNS = {
    "defaults": ["--data-set", "SYNTH", "--epochs", "1",
                 "--max-steps-per-epoch", "4"],
    "reference recipe": [
        "--data-set", "SYNTH", "--model", DEIT_TINY, "--batch-size", "128",
        "--lr", "1e-3", "--epochs", "1", "--weight-decay", "0.05", "--sched",
        "cosine", "--input-size", "224", "--eval-crop-ratio", "1.0",
        "--reprob", "0.0", "--smoothing", "0.1", "--warmup-epochs", "5",
        "--drop", "0.0", "--seed", "0", "--opt", "adamw", "--warmup-lr",
        "1e-6", "--mixup", ".8", "--drop-path", "0.0", "--cutmix", "1.0",
        "--unscale-lr", "--no-repeated-aug", "--aa", "rand-m9-mstd0.5-inc1",
        "--starting-threshold", "1.0", "--target-threshold", "0.9",
        "--max-steps-per-epoch", "4"]}
# phase 19, fine-tuning, distillation and the switchable and sparse ViTs:
# the DeiT recipe's student and teacher (timm-format files written from
# seeded weights; the student's at 384 px, so the driver resizes its
# position embedding from 24 x 24 to 14 x 14), the driver's run at B=64
# and the step's at B=128
STUDENT, TEACHER, STUDENT_FILE_IMG = ("deit_base_distilled_patch16_224",
                                      "regnety_160", 384)
DISTILL_DRIVER_ARGS = ["--data-set", "SYNTH", "--synth-classes", "1000",
                       "--model", STUDENT, "--distillation-type", "hard",
                       "--teacher-model", TEACHER, "--async-checkpoint",
                       "--batch-size", "64", "--epochs", "1",
                       "--max-steps-per-epoch", "4"]
DISTILL_RESUME_ARGS = ["--data-set", "SYNTH", "--synth-classes", "1000",
                       "--model", STUDENT, "--batch-size", "64", "--eval",
                       "--max-steps-per-epoch", "1"]
DISTILL_B, DISTILL_STEPS = 128, 3
# the teacher's logits on the card, TF32 convolutions (the teacher's
# precision; the JAX teacher on the TPU runs its f32 convolutions as one
# bf16 pass) vs the CPU's f32, on this many images, in max |d| over max
# |ref|. On an NVIDIA H100 80GB HBM3 at 700 W: TF32 3.550e-4, full f32
# 7.049e-7, the same weights with bf16 activations 2.752e-3. The limit sits
# between TF32 and bf16, ~2.8x from each: TF32 passes, a teacher computing
# in bf16 fails
TEACHER_CPU_B, TEACHER_REL, TEACHER_COS = 4, 1e-3, 0.999
# deit_sw_tiny_patch16_224: 4 buckets, tokens of bucket >= 2 pass the
# router, 98 of 197 positions in the 11 mid blocks; every block's two LNs
# are the plain-LN kernel (the blocks run unchained, as the JAX model's do)
SW_MODEL, SW_BUCKETS, SW_THRESHOLD, SW_CAPACITY = ("deit_sw_tiny_patch16_224",
                                                   4, 2, 98)
SW_B, SW_STEPS = 128, 2
PER_SW_FORWARD = {"fused_ln": 25, "fused_mha": 12}
PER_SW_STEP = {**PER_SW_FORWARD, "fused_ln_bwd": 25, "fused_mha_bwd": 12}
# sparse_deit_tiny_patch16_224: the search's L1 weight and steps, the
# compress budgets; only the final norm is a kernel of the port
SPARSE = "sparse_deit_tiny_patch16_224"
SPARSE_B, SPARSE_STEPS, SPARSE_W = 16, 2, 2e-4
SPARSE_BUDGETS = (0.5, 0.5, 0.5)
PER_SPARSE_FORWARD = {"fused_ln": 1}
PER_SPARSE_STEP = {**PER_SPARSE_FORWARD, "fused_ln_bwd": 1}
# phase 20, the optimizer surface, expert_choice, expert dropout and a
# gated artifact: the optimizers' f32 gradients from one kernel step of the
# flagship at B=32, SURF_STEPS steps at SURF_LR on the card and on the CPU
# from the same parameters and gradients, every parameter within OPT_REL of
# its leaf's largest |ref| plus OPT_LR_SLACK lr (the limit of the CPU
# parity tests against the JAX package, tests/test_torch_optim_surface.py:
# the same f32 math in other orders); the driver runs at B=32, 2 steps an
# epoch; the flagship's moe_small and the distilled recipe's DeiT-S
SURF_B, SURF_EVAL_B, SURF_STEPS, SURF_LR = 32, 8, 2, 1e-3
OPT_REL, OPT_LR_SLACK = 1e-6, 1e-4
SURF_DRIVER_STEPS = 2
SURF_DRIVER_ARGS = ["--data-set", "SYNTH", "--synth-size", "256",
                    "--batch-size", str(SURF_B), "--epochs", "1",
                    "--max-steps-per-epoch", str(SURF_DRIVER_STEPS),
                    "--warmup-epochs", "0", "--no-repeated-aug", "--mixup",
                    "0", "--cutmix", "0", "--aa", "", "--color-jitter", "0",
                    "--reprob", "0", "--num_workers", "2"]
DEIT_SMALL = "deit_small_patch16_224"
EC_STEPS, DROP_RATE, GATED_TARGET = 2, 0.1, 0.3


def expected(per: dict, n: int) -> dict:
    """Launch counts of every wrapper after ``n`` runs of ``per``."""
    return {name: per.get(name, 0) * n for name, *_ in KERNELS}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SLEEP_CYCLES_PER_MS: list = []


def hold_device(ms: float) -> None:
    """Queue ~``ms`` of idle device time (``torch.cuda._sleep``) on the
    current stream, so the host can queue the calls that follow before the
    device reaches them."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:  # calibrate once
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def median_ms(fn, reps: int = 20, warmup: int = 3,
              window_ms: float = 2.0) -> float:
    """Median device ms of one call. Each event pair spans a loop of calls
    sized to ~``window_ms`` of device work, and the device is held idle
    (``hold_device``) for longer than the host takes to queue the loop, so
    the events read the device's time, not the host's pace between
    launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    hold_device(50.0)
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    loop = min(200, max(1, int(window_ms / max(start.elapsed_time(end),
                                               1e-3))))
    times = []
    for _ in range(reps):
        hold_device(1.0 + 2.0 * loop * host_ms)
        start.record()
        for _ in range(loop):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / loop)
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the operations over the peak rate for their type."""
    t_mem, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def kernel_cases(B: int, gen):
    """({name: (kernel call, plain call, one-call library equivalent or
    None, (bytes, flops, peak), per-output comparison modes)}, (qkv, do),
    K3's arguments, K4's arguments, {LN backward: (u, dy, du_out, gamma)})
    on random inputs at batch B. A mode is "elem" (ELEM_TOL elementwise) or
    "sum" (SUM_REL of max |ref|)."""
    import torch
    import torch.nn.functional as F

    from slim_switch_moe_vit_tpu_torch.ops import attention, fused_ffn
    from slim_switch_moe_vit_tpu_torch.ops import fused_ln as ln
    from slim_switch_moe_vit_tpu_torch.ops import moe

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    x, r, dy, du = (rnd(B, N_TOK, DIM) for _ in range(4))
    g = rnd(DIM, std=0.1, dtype=torch.float32) + 1.0
    b = rnd(DIM, std=0.1, dtype=torch.float32)
    qkv, do = rnd(B, N_TOK, 3 * DIM), rnd(B, N_TOK, DIM)
    hd = DIM // HEADS
    scale = hd ** -0.5
    # the expert FFN on a real layout: routed tokens, counting-sort slots,
    # the cotangent zero at padding slots as the combine backward gives it
    tokens = rnd(B * N_TOK, DIM)
    router_w = rnd(DIM, EXPERTS, std=DIM ** -0.5, dtype=torch.float32)
    gate_w, eidx = moe.naive_topk_gate(tokens.float() @ router_w, 2)
    gather_idx, pair_slot, e_of_tile, w_slot, _ = moe.aligned_expert_layout(
        eidx, EXPERTS, gate_w=gate_w)
    xs = moe.dispatch_gather(tokens, gather_idx, pair_slot)
    w1, b1 = rnd(EXPERTS, DIM, HIDDEN, std=DIM ** -0.5), rnd(
        EXPERTS, HIDDEN, std=0.1, dtype=torch.float32)
    w2, b2 = rnd(EXPERTS, HIDDEN, DIM, std=HIDDEN ** -0.5), rnd(
        EXPERTS, DIM, std=0.1, dtype=torch.float32)
    ffn = (xs, w1, b1, w2, b2, e_of_tile)
    dys = rnd(*xs.shape) * w_slot[:, None]
    ffn_bwd = (xs, w1, b1, w2, e_of_tile, dys)

    # one-call equivalents, timed as yardsticks and used nowhere in the port
    gb = g.to(torch.bfloat16)
    bb = b.to(torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, (DIM,), gb, bb, 1e-6)
    q4 = qkv.view(B, N_TOK, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    qkv_leaf = qkv.detach().requires_grad_()
    q4g = qkv_leaf.view(B, N_TOK, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    sdpa_out = F.scaled_dot_product_attention(q4g[0], q4g[1], q4g[2],
                                              scale=scale)
    do4 = do.view(B, N_TOK, HEADS, hd).transpose(1, 2)

    n = B * N_TOK * DIM
    Tp = xs.shape[0]
    ln_cost = lambda rows_io: (rows_io * n * 2 + 2 * DIM * 4, 10 * n,  # noqa: E731
                               F32_FLOPS)
    mha_f = 2 * B * HEADS * N_TOK * N_TOK * hd  # one N x N x d product
    w_bytes = 2 * EXPERTS * DIM * HIDDEN * 2    # w1 and w2, bf16
    return ({
        "fused_ln": (lambda: ln.fused_ln(x, g, b),
                     lambda: ln.reference_add_ln(x, None, g, b)[1],
                     lambda: F.layer_norm(x, (DIM,), gb, bb, 1e-6),
                     ln_cost(2), ("elem",)),
        "fused_add_ln": (lambda: ln.fused_add_ln(x, r, g, b),
                         lambda: ln.reference_add_ln(x, r, g, b), None,
                         ln_cost(4), ("elem", "elem")),
        "fused_sum_ln": (lambda: ln.fused_sum_ln(x, r, g, b),
                         lambda: ln.reference_add_ln(x, r, g, b)[1], None,
                         ln_cost(3), ("elem",)),
        "fused_mha": (lambda: attention.fused_mha(qkv, HEADS, scale),
                      lambda: attention.fused_mha_reference(qkv, HEADS, scale),
                      lambda: F.scaled_dot_product_attention(
                          q4[0], q4[1], q4[2], scale=scale),
                      (4 * n * 2, 2 * mha_f, BF16_FLOPS), ("elem",)),
        "fused_expert_ffn": (lambda: fused_ffn.fused_expert_ffn(*ffn),
                             lambda: fused_ffn.fused_expert_ffn_reference(*ffn),
                             None, (2 * Tp * DIM * 2 + w_bytes,
                                    4 * Tp * DIM * HIDDEN, BF16_FLOPS),
                             ("elem",)),
        "fused_ln_bwd": (lambda: ln.fused_ln_bwd(x, dy, g),
                         lambda: ln.reference_ln_bwd(x, dy, None, g),
                         lambda: torch.ops.aten.native_layer_norm_backward(
                             dy, x, (DIM,), mean, rstd, gb, bb,
                             [True, True, True]),
                         ln_cost(3), ("elem", "sum", "sum")),
        "fused_add_ln_bwd": (lambda: ln.fused_add_ln_bwd(x, dy, du, g),
                             lambda: ln.reference_ln_bwd(x, dy, du, g), None,
                             ln_cost(4), ("elem", "sum", "sum")),
        "fused_sum_ln_bwd": (lambda: ln.fused_sum_ln_bwd(x, r, dy, g),
                             lambda: ln.reference_ln_bwd(x + r, dy, None, g),
                             None, ln_cost(4), ("elem", "sum", "sum")),
        "fused_mha_bwd": (lambda: attention.fused_mha_bwd(qkv, do, HEADS, scale),
                          lambda: attention.reference_mha_bwd(qkv, do, HEADS,
                                                              scale),
                          lambda: torch.autograd.grad(sdpa_out, qkv_leaf, do4,
                                                      retain_graph=True),
                          (7 * n * 2, 5 * mha_f, BF16_FLOPS), ("elem",)),
        "fused_expert_ffn_bwd": (
            lambda: fused_ffn.fused_expert_ffn_bwd(*ffn_bwd),
            lambda: fused_ffn.reference_expert_ffn_bwd(*ffn_bwd), None,
            (3 * Tp * DIM * 2 + 2 * w_bytes + EXPERTS * (HIDDEN + DIM) * 4,
             10 * Tp * DIM * HIDDEN, BF16_FLOPS),
            ("elem", "sum", "sum", "sum", "sum")),
        "flash_attention": (lambda: attention.flash_attention(qkv, HEADS, scale),
                            lambda: attention.flash_attention_reference(
                                qkv, HEADS, scale),
                            lambda: F.scaled_dot_product_attention(
                                q4[0], q4[1], q4[2], scale=scale),
                            (4 * n * 2, 2 * mha_f, BF16_FLOPS), ("elem",)),
    }, (qkv, do), ffn, ffn_bwd, {
        "fused_ln_bwd": (x, dy, None, g),
        "fused_add_ln_bwd": (x, dy, du, g),
        "fused_sum_ln_bwd": ((x + r), dy, None, g)})


def flash_long_case(gen) -> tuple:
    """K11 at B = 32, N = 577 (ViT-S/16 at 384 px): (kernel, plain,
    library, cost, modes) as in ``kernel_cases``."""
    import torch
    import torch.nn.functional as F

    from slim_switch_moe_vit_tpu_torch.ops import attention

    B, N = 32, 577
    qkv = torch.randn(B, N, 3 * DIM, generator=gen).to("cuda", torch.bfloat16)
    hd = DIM // HEADS
    q4 = qkv.view(B, N, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    return (lambda: attention.flash_attention(qkv, HEADS, hd ** -0.5),
            lambda: attention.flash_attention_reference(qkv, HEADS,
                                                        hd ** -0.5),
            lambda: F.scaled_dot_product_attention(q4[0], q4[1], q4[2],
                                                   scale=hd ** -0.5),
            (4 * B * N * DIM * 2, 4 * B * HEADS * N * N * hd, BF16_FLOPS),
            ("elem",))


def k7_phase(results: dict) -> None:
    """K7 over every parameter of the ResMoE model (~121M f32 values in 176
    leaves, their weight-decay and gate flags as the optimizer sets them)
    at step t = 3, against its plain version (``K7_ULPS``); timed beside
    its bound (9 f32 streams: p, g, mu, nu, ema read, p, mu, nu, ema
    written), one ``torch.optim.AdamW(fused=True).step()`` on the same
    tensors (its library call, which computes no EMA), and the unfused
    path the port takes without ``--fused-optimizer``: the foreach AdamW
    step and the foreach EMA."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, optim
    from slim_switch_moe_vit_tpu_torch.ops import fused_adamw

    named = [(n, p.detach().to("cuda"))
             for n, p in create_model(RESMOE).named_parameters()]
    wd, gate = optim.wd_mask(named), optim.gate_mask(named)
    flags = ([wd[n] for n, _ in named], [gate[n] for n, _ in named])
    gen = torch.Generator(device="cuda").manual_seed(1)

    def like(p, std):
        return torch.randn(p.shape, generator=gen, device="cuda") * std

    params = [p for _, p in named]
    base = (params, [like(p, 1e-2) for p in params],
            [like(p, 1e-3) for p in params],
            [like(p, 1e-3).square() for p in params],
            [p + like(p, 1e-3) for p in params])
    sets = [[[t.clone() for t in group] for group in base] for _ in range(2)]
    bc1, bc2 = fused_adamw.bias_corrections(0.9, 0.999, 3)
    kw = dict(lr_base=LR, lr_gate=2 * LR, bc1=bc1, bc2=bc2,
              weight_decay=0.05, ema_decay=EMA_DECAY)
    fused_adamw.fused_adamw_ema(*sets[0], *flags, **kw)
    torch.cuda.synchronize()
    fused_adamw.fused_adamw_ema_reference(*sets[1], *flags, **kw)
    err, worst = 0.0, 0.0
    for what, got, want in zip(("p", "g", "mu", "nu", "ema"), *sets):
        for a, b in zip(got, want):
            d = (a - b).abs()
            lim = K7_ULPS * (b.abs() + b.abs().max())
            err = max(err, d.max().item())
            worst = max(worst, (d / lim).max().item())
            if not (d <= lim).all():
                raise AssertionError(f"fused_adamw_ema: {what} max |d| "
                                     f"{d.max().item():.3e} beyond {K7_ULPS:.3e}"
                                     " * (|ref| + max |ref|)")
    n = sum(p.numel() for p in params)
    ms = median_ms(lambda: fused_adamw.fused_adamw_ema(*sets[0], *flags, **kw))
    plain_ms = median_ms(lambda: fused_adamw.fused_adamw_ema_reference(
        *sets[1], *flags, **kw), reps=3, warmup=1)
    del sets
    yard = {}
    for how in ("fused", "foreach"):
        leaves = [torch.nn.Parameter(p.clone()) for p in params]
        for q, g in zip(leaves, base[1]):
            q.grad = g
        opt = torch.optim.AdamW(leaves, lr=LR, weight_decay=0.05,
                                **{how: True})
        yard[how] = median_ms(opt.step)
        del opt, leaves
    ema = [e.clone() for e in base[4]]

    def ema_foreach():
        torch._foreach_mul_(ema, EMA_DECAY)
        torch._foreach_add_(ema, params, alpha=1.0 - EMA_DECAY)

    ema_ms = median_ms(ema_foreach)
    bound_ms, bound_by = bound(36 * n, 15 * n, F32_FLOPS)
    results["fused_adamw_ema"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": yard["fused"], "adamw_foreach_ms": yard["foreach"],
        "ema_foreach_ms": ema_ms, "params": n}
    log(f"kernel fused_adamw_ema {n} params in {len(params)} leaves: max|d| "
        f"{err:.3e}, largest |d| / limit {worst:.3f}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library AdamW(fused=True).step() "
        f"{yard['fused']:.4f} ms (no EMA), unfused path: AdamW(foreach).step()"
        f" {yard['foreach']:.4f} ms + foreach EMA {ema_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    del base, ema, params, named
    torch.cuda.empty_cache()


def compare(name: str, got, want, modes, tol=None) -> tuple:
    """(max |got - want|, max |want|, the largest ratio of |d| to max |ref|)
    across every output; raises beyond ``tol`` or else the kernel's
    ELEM_TOL (default ATOL/RTOL; "elem"), or SUM_REL ("sum")."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    atol, rtol = tol or ELEM_TOL.get(name, (ATOL, RTOL))
    worst, top, rel = 0.0, 0.0, 0.0
    for a, b, mode in zip(got, want, modes, strict=True):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)} or non-finite output")
        d = (a - b).abs()
        peak = b.abs().max().item()
        worst, top = max(worst, d.max().item()), max(top, peak)
        rel = max(rel, d.max().item() / peak)
        ok = ((d <= atol + rtol * b.abs()).all() if mode == "elem"
              else d.max().item() <= SUM_REL * peak)
        if not ok:
            raise AssertionError(
                f"{name}: max |d| {d.max().item():.3e} (max |ref| {peak:.3e})"
                f" beyond " + (f"atol {atol} + rtol {rtol} * |ref|"
                               if mode == "elem" else f"{SUM_REL} * max |ref|"))
    return worst, top, rel


def mha_bwd_planted(qkv, do, num_heads: int, scale: float, delta: float):
    """The plain MHA backward with a planted fault: the softmax's delta
    term e*linv*sum(e*dp) scaled by ``delta`` (the right value is 1)."""
    import torch

    B, N, C3 = qkv.shape
    q, k, v = (t.reshape(B, N, num_heads, -1).transpose(1, 2).float()
               for t in qkv.split(C3 // 3, dim=-1))
    do = do.reshape(B, N, num_heads, -1).transpose(1, 2).float()
    e = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)  # e*linv
    dv = e.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2) * scale
    ds = e * (dp - delta * (e * dp).sum(-1, keepdim=True))
    return torch.cat([t.transpose(1, 2).reshape(B, N, C3 // 3)
                      for t in (ds @ k, ds.transpose(-1, -2) @ q, dv)],
                     dim=-1).to(qkv.dtype)


def check_planted_faults(qkv, do, plain_out) -> None:
    """K6's limit must reject each planted fault of PLANTED_DELTA; the
    unplanted form (delta 1) must pass it. What the global ATOL/RTOL would
    say is printed beside it."""
    hd = DIM // HEADS

    def rejects(bad, tol=None) -> bool:
        try:
            compare("fused_mha_bwd", bad, plain_out, ("elem",), tol)
            return False
        except AssertionError:
            return True

    verdict = {True: "rejected", False: "passed"}
    for delta in (1.0, *PLANTED_DELTA):
        bad = mha_bwd_planted(qkv, do, HEADS, hd ** -0.5, delta)
        rejected = rejects(bad)
        log(f"  planted fault in K6's plain form, delta term x{delta}: "
            f"{verdict[rejected]} by K6's limit, "
            f"{verdict[rejects(bad, (ATOL, RTOL))]} by the global one")
        if rejected != (delta != 1.0):
            raise AssertionError(f"K6's limit {verdict[rejected]} the plain "
                                 f"form with delta x{delta}")


def exact_attention(name: str, qkv, do):
    """The exact f32 function of K5, K6 or K11 at the flagship's heads: its
    plain version on the f32-cast inputs, nothing rounded to bf16 inside."""
    from slim_switch_moe_vit_tpu_torch.ops import attention

    scale = (DIM // HEADS) ** -0.5
    if name == "fused_mha_bwd":
        return attention.reference_mha_bwd(qkv.float(), do.float(), HEADS,
                                           scale)
    return attention.fused_mha_reference(qkv.float(), HEADS, scale)


def exact_ffn_bwd(name: str, got, want, args) -> None:
    """``exact_error`` for K4's (or K9's, K10's) dx, dW1 and dW2: the exact
    f32 function is the plain backward on f32 copies of ``args`` (xs, w1,
    b1, w2, e_of_tile, dy)."""
    from slim_switch_moe_vit_tpu_torch.ops import fused_ffn

    xs, w1, b1, w2, eot, dy = args
    exact = fused_ffn.reference_expert_ffn_bwd(xs.float(), w1.float(), b1,
                                               w2.float(), eot, dy.float())
    for part, i in (("dx", 0), ("dw1", 1), ("dw2", 3)):
        exact_error(f"{name} {part}", got[i], want[i], exact[i])


def check_defer(res: dict, label: str, sfx: str, kernel, got, want,
                args) -> None:
    """K8 at one layout: dx, dW1 and dW2 against the exact f32 function
    (``exact_ffn_bwd``), a second call bit-identical, and its launches
    timed apart (``profile_call``): the dgrad kernel under ``ms_dgrad``,
    the dW kernel under ``ms_dw``, any other launch of the wrapper under
    ``ms_other`` (each with ``sfx``)."""
    import torch

    name = "fused_expert_ffn_bwd_defer"
    exact_ffn_bwd(f"{name} ({label})", got, want, args)
    again = kernel()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} ({label}): two calls on the same "
                             "inputs differ")
    log(f"  {name} ({label}): a second call bit-identical (dx, dW, db)")
    # ten calls, each launch's mean over the events seen: a profiling
    # session that follows a large one misses its last few device events
    parts = {"dgrad": 0.0, "dw": 0.0, "other": 0.0}
    for k, (us, n) in profile_call(lambda: [kernel() for _ in range(10)],
                                   f"K8 ({label}), 10 calls").items():
        parts["dgrad" if "dgrad" in k else "dw" if "defer" in k
              else "other"] += us / n / 1e3
    if not parts["dgrad"] or not parts["dw"]:
        raise AssertionError(f"{name} ({label}): the profile shows no dgrad "
                             "or no dW launch")
    res.update({f"ms_{k}{sfx}": v for k, v in parts.items()})
    log(f"  {name} ({label}) by launch (profiler, ms a call): "
        + ", ".join(f"{k} {ms:.4f}" for k, ms in parts.items()))


def exact_ffn_fwd(name: str, got, want, args, perm=None) -> None:
    """``exact_error`` for K3's (or K9's, K10's with ``perm``) y: the exact
    f32 function is the plain forward on f32 copies of ``args`` (xs, w1,
    b1, w2, b2, e_of_tile; K9's xs are its gathered rows)."""
    from slim_switch_moe_vit_tpu_torch.ops import fused_ffn

    xs, w1, b1, w2, b2, eot = args
    f32 = (xs.float(), w1.float(), b1, w2.float(), b2, eot)
    exact = (fused_ffn.fused_expert_ffn_reference(*f32) if perm is None else
             fused_ffn.reference_expert_ffn_permuted(*f32, perm))
    exact_error(name, got, want, exact)


def dense_yardstick(args) -> None:
    """Two ``torch.matmul`` calls and ``F.gelu`` on K3's rows with one
    expert's weights: the tensor-core rate cuBLAS reaches on the same
    products, logged beside K3. Not the same function (no routing of rows
    to experts), so it is no ``library_ms``; used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    xs, w1, _, w2, _, _ = args
    ms = median_ms(lambda: torch.matmul(F.gelu(torch.matmul(xs, w1[0])),
                                        w2[0]))
    log(f"kernel fused_expert_ffn: dense cuBLAS yardstick, not the same "
        f"function ({xs.shape[0]} rows x one expert's W1 and W2, "
        f"torch.matmul + F.gelu): {ms:.4f} ms")


def exact_error(name: str, got, want, exact, what: str = "f32") -> None:
    """A bf16 kernel's mean |d| from the exact function (in ``what``)
    beside its bf16 plain version's, held to ``EXACT_RATIO``."""
    err = [(t.to(exact.dtype) - exact).abs().mean().item()
           for t in (got, want)]
    log(f"  {name} vs the exact {what} function: mean |d| kernel {err[0]:.4e}, "
        f"plain version {err[1]:.4e} (ratio {err[0] / err[1]:.4f}, limit "
        f"{EXACT_RATIO}; mean |exact| {exact.abs().mean().item():.4e})")
    if err[0] > EXACT_RATIO * err[1]:
        raise AssertionError(f"{name}: less accurate than its plain version")


LN_BWD = ("fused_ln_bwd", "fused_add_ln_bwd", "fused_sum_ln_bwd")


def exact_ln_bwd(u, dy, du_out, g) -> tuple:
    """The LayerNorm backward's exact function: the plain version's steps
    in f64 on the same inputs (u = a + b already rounded, as the forward
    rounds it). In f32 the plain version's dgamma and dbeta would equal
    its bf16 run's bit for bit (both sum f32 terms of the same bf16
    inputs), so the sums are held to f64."""
    u, dy = u.double(), dy.double()
    d = u - u.mean(-1, keepdim=True)
    rstd = ((d * d).mean(-1, keepdim=True) + 1e-6).rsqrt()
    xhat = d * rstd
    dyg = dy * g.double()
    du = (dyg - dyg.mean(-1, keepdim=True)
          - xhat * (dyg * xhat).mean(-1, keepdim=True)) * rstd
    if du_out is not None:
        du = du + du_out.double()
    D = u.shape[-1]
    return (du, (dy * xhat).reshape(-1, D).sum(0), dy.reshape(-1, D).sum(0))


def check_ln_bwd(name: str, kernel, got, want, args) -> None:
    """K1c's or K2b's outputs against the exact function (``exact_error``
    for du, dgamma and dbeta) and a second call: bit-identical."""
    import torch

    exact = exact_ln_bwd(*args)
    for part, k, w, e in zip(("du", "dgamma", "dbeta"), got, want, exact):
        exact_error(f"{name} {part}", k, w, e, "f64")
    again = kernel()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    log(f"  {name}: a second call bit-identical (du, dgamma, dbeta)")


def kernel_phase(results: dict) -> None:
    """Each kernel against its plain version at B = 32 and 128; times, the
    bound and the library call's time at B = 128 (the training path's
    batch) go under the JSON keys, B = 32's under ``*_b32``."""
    import torch

    gen = torch.Generator().manual_seed(0)
    for B in (32, 128):
        t_batch = time.perf_counter()
        cases, mha_inputs, ffn_inputs, ffn_bwd_inputs, ln_inputs = (
            kernel_cases(B, gen))
        for name, (kernel, plain, library, cost, modes) in cases.items():
            t0 = time.perf_counter()
            got = kernel()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            want = plain()
            err, peak, rel = compare(name, got, want, modes)
            if name == "fused_mha_bwd":
                check_planted_faults(*mha_inputs, want)
            if name in EXACT_CHECKED and B == 128:
                exact_error(name, got, want,
                            exact_attention(name, *mha_inputs))
            if name == "fused_expert_ffn_bwd":
                exact_ffn_bwd(f"{name} B={B}", got, want, ffn_bwd_inputs)
            if name == "fused_expert_ffn" and B == 128:
                exact_ffn_fwd(name, got, want, ffn_inputs)
            if name in LN_BWD and B == 128:
                check_ln_bwd(name, kernel, got, want, ln_inputs[name])
            # the plain versions are timed at B = 128 only, the batch of
            # the training path (they are no yardstick of speed)
            ms = median_ms(kernel)
            plain_ms = (median_ms(plain, reps=3, warmup=1) if B == 128
                        else None)
            lib_ms = median_ms(library) if library is not None else None
            bound_ms, bound_by = bound(*cost)
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            sfx = "" if B == 128 else "_b32"
            res.update({"ms" + sfx: ms, "bound_ms" + sfx: bound_ms,
                        "bound_by": bound_by, "library_ms" + sfx: lib_ms})
            if plain_ms is not None:
                res["plain_ms"] = plain_ms
            lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            plain_txt = ("" if plain_ms is None
                         else f", plain {plain_ms:.4f} ms")
            log(f"kernel {name:20s} B={B:3d}: max|d| {err:.3e}, max|ref| "
                f"{peak:.3e}, largest max|d|/max|ref| {rel:.2e}; kernel "
                f"{ms:.4f} ms{plain_txt}, library {lib}, bound "
                f"{bound_ms:.4f} ms ({bound_by}), first call {first_s:.2f} s")
        # K11 against K5 on the same input, to K5's limit
        err, peak, _ = compare("flash_attention", cases["flash_attention"][0](),
                               cases["fused_mha"][0](), ("elem",))
        log(f"kernel flash_attention vs fused_mha B={B}: max|d| {err:.3e} "
            f"(max|ref| {peak:.3e}); [kernels at B={B}: "
            f"{time.perf_counter() - t_batch:.1f} s]")
        if B == 128:
            dense_yardstick(ffn_inputs)
        del cases, mha_inputs, ffn_inputs, ffn_bwd_inputs, ln_inputs
        torch.cuda.empty_cache()
    kernel, plain, library, cost, modes = flash_long_case(gen)
    err, peak, _ = compare("flash_attention", kernel(), plain(), modes)
    res = results["flash_attention"]
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res.update({"ms_n577_b32": median_ms(kernel),
                "plain_ms_n577_b32": median_ms(plain, reps=3, warmup=1),
                "library_ms_n577_b32": median_ms(library),
                "bound_ms_n577_b32": bound(*cost)[0]})
    log(f"kernel flash_attention B=32 N=577: max|d| {err:.3e}, max|ref| "
        f"{peak:.3e}; kernel {res['ms_n577_b32']:.4f} ms, plain "
        f"{res['plain_ms_n577_b32']:.4f} ms, library "
        f"{res['library_ms_n577_b32']:.4f} ms, bound "
        f"{res['bound_ms_n577_b32']:.4f} ms ({bound(*cost)[1]})")
    k7_phase(results)


def forwards_for(n: int) -> int:
    """Forwards the Predictor runs for n images (the bucket rule)."""
    count = 0
    while n > 0:
        fits = [b for b in BUCKETS if b >= n]
        n -= min(n, min(fits) if fits else max(BUCKETS))
        count += 1
    return count


def post(port: int, images: np.ndarray) -> np.ndarray:
    body = json.dumps({"instances": images.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return np.asarray(json.loads(resp.read())["predictions"], np.float32)


def serving_phase(artifact: str, rs) -> tuple:
    from slim_switch_moe_vit_tpu_torch import ops
    from slim_switch_moe_vit_tpu_torch.serving import export
    from slim_switch_moe_vit_tpu_torch.serving.export import load_predictor
    from slim_switch_moe_vit_tpu_torch.serving.server import make_server

    t0 = time.perf_counter()
    manifest = export.main(["--model", MODEL, "--output", artifact,
                            "--dtype", "bfloat16",
                            "--batch-sizes", ",".join(map(str, BUCKETS))])
    assert manifest["platform"] == "cuda", manifest
    pred = load_predictor(artifact)
    log(f"export + load {time.perf_counter() - t0:.1f} s")
    for b in BUCKETS:  # warm every bucket before counting
        pred.predict(np.zeros((b, 224, 224, 3), np.uint8))
    requests = [rs.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
                for n in REQUESTS]
    server, batcher = make_server(pred, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ops.reset_launch_counts()
        answers = [post(server.server_address[1], x) for x in requests]
        counts = ops.launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    forwards = sum(forwards_for(n) for n in REQUESTS)
    want = expected(PER_FORWARD, forwards)
    log(f"launch counts over {forwards} forwards: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for x, logits in zip(requests, answers):
        if logits.shape != (len(x), 1000) or not np.isfinite(logits).all():
            raise AssertionError(f"bad logits {logits.shape} for {len(x)} images")
        direct = pred.predict(x)
        if not np.array_equal(logits, direct):
            raise AssertionError(f"HTTP logits differ from the Predictor's: "
                                 f"max |d| {np.abs(logits - direct).max()}")
    log(f"served requests of {list(REQUESTS)} images over HTTP: finite, "
        "(n, 1000), equal to Predictor.predict")
    return pred, requests[-1][:8]


def cross_check(artifact: str, pred, images: np.ndarray) -> None:
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model
    from slim_switch_moe_vit_tpu_torch.serving.export import make_serve_fn

    model = create_model(MODEL, dtype=torch.float32).eval()
    model.load_state_dict(torch.load(os.path.join(artifact, "params.pt"),
                                     weights_only=True))
    serve = make_serve_fn(model)
    routes: list = []
    with pinned_routing(routes, replay=False):
        got = pred.predict(images)
    with pinned_routing(routes, replay=True) as moved:
        ref = serve(torch.from_numpy(images)).numpy()
    _xcheck(got, ref, "cross-check: card bf16 serving vs the CPU f32 plain "
            "path (the card's expert choices on both; "
            + check_moved(moved, "cross-check") + ")")
    # unpinned, printed beside the card's plain path in bf16 (the witness of
    # what bf16 rounding alone does to these weights' near ties)
    free = serve(torch.from_numpy(images)).numpy()
    with plain_versions():
        witness = pred.predict(images)
    top = np.abs(free).max()
    log("  unpinned, max |d| / max |ref| per image: kernels "
        + " ".join(f"{v:.4f}" for v in np.abs(got - free).max(1) / top)
        + "; the card's plain path in bf16 "
        + " ".join(f"{v:.4f}" for v in np.abs(witness - free).max(1) / top))


def speed_phase(pred, card: str) -> None:
    import torch

    x32 = np.random.RandomState(5).randint(0, 256, (32, 224, 224, 3)).astype(np.uint8)
    for _ in range(3):
        pred.predict(x32)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(x32)
    ips = 32 * reps / (time.perf_counter() - t0)
    x1 = x32[:1]
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        pred.predict(x1)
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"serving: {ips:.1f} images/s at bucket 32 (Predictor.predict, host "
        f"clock, uint8 upload included), p50 latency at batch 1 "
        f"{statistics.median(lat):.3f} ms; card {card}")
    serve = pred.serve
    for B in (32, 128):
        xb = torch.from_numpy(np.random.RandomState(B).randint(
            0, 256, (B, 224, 224, 3)).astype(np.uint8)).cuda()
        ms = median_ms(lambda: serve(xb), reps=10)
        log(f"device forward B={B}: {ms:.3f} ms ({B / ms * 1e3:.1f} images/s "
            f"on the device clock); card {card}")
    profile_call(lambda: serve(xb), f"one forward B={xb.shape[0]}")


def profile_call(fn, what: str) -> dict:
    """Device time of one call of ``fn`` by kernel name, from
    torch.profiler, and its busy share (kernel time over wall time);
    returns {kernel name: (us, launches)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():  # device-side kernels; not the optimizer's
        # annotation, which spans kernels already counted
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("Optimizer.")):
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    total = sum(r[0] for r in rows) / 1e3
    log(f"profile, {what}: wall {wall_ms:.3f} ms, "
        f"device kernels {total:.3f} ms in {sum(r[1] for r in rows)} launches "
        f"(busy share {total / wall_ms:.3f})")
    for us, n, name in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms {n:5d}x  {name[:90]}")
    return by_name


def _train_setup(dtype, device, model=None):
    """The flagship with seed-0 weights (or ``model``), AdamW + EMA, and its
    train step."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, losses, optim
    from slim_switch_moe_vit_tpu_torch.engine import make_train_step
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    if model is None:
        model = create_model(MODEL, num_classes=1000, dtype=dtype)
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device=device, opt_init=opt_init,
                               use_ema=True)
    step = make_train_step(model, opt_update,
                           losses.make_base_criterion(False, 0.1, False),
                           ema_decay=EMA_DECAY)
    return model, state, step


def _batch(B: int, seed: int, device):
    import torch

    x = np.random.RandomState(seed).randn(B, 224, 224, 3).astype(np.float32)
    y = np.random.RandomState(seed + 1).randint(0, 1000, B)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def train_phase(card: str) -> dict:
    """10 B=128 steps on the card through the kernels; returns the launch
    counts of those steps."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops

    model, state, step = _train_setup(torch.bfloat16, "cuda")
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    x, y = _batch(TRAIN_B, 0, "cuda")  # bench.py:93-95: seeds 0 and 1
    t0 = time.perf_counter()
    state, m = step(state, x, y, LR, LR)
    log(f"train warm-up step B={TRAIN_B}: loss {m['loss'].item():.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    start.record()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, x, y, LR, LR)
        losses.append(m["loss"])
    end.record()
    end.synchronize()
    counts = ops.launch_counts()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expected(PER_TRAIN_STEP, TRAIN_STEPS)
    log(f"train launch counts over {TRAIN_STEPS} steps: {counts}")
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != {want}")
    losses = torch.stack(losses).tolist()
    log(f"train losses: {[round(v, 5) for v in losses]}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    if bad:
        raise AssertionError(f"missing or non-finite gradients: {bad[:5]}")
    moved = sum(bool((state.ema_params[n] != init[n]).any()) for n in init)
    log(f"EMA moved in {moved} of {len(init)} tensors")
    if not moved:
        raise AssertionError("the EMA did not move")
    log(f"train step B={TRAIN_B}: {step_ms:.3f} ms on the device clock "
        f"({TRAIN_B / step_ms * 1e3:.1f} images/s), peak memory allocated "
        f"{peak_gib:.2f} GiB; card {card}")
    profile_call(lambda: step(state, x, y, LR, LR),
                 f"one train step B={TRAIN_B}")
    del model, state, step, init, x, y
    torch.cuda.empty_cache()
    return counts


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm() + 1e-300)).item()


def train_cross_check() -> None:
    """4 steps at B=8 from the same seed-0 weights on the card (bf16), on
    the CPU plain path in bf16 (the same precision, other summation
    orders), again with the batch's samples in reverse order (the same
    math in other summation orders: the witness of what bf16 rounding
    alone does to the run), and in f32. The card's expert choices at every
    step are imposed on the CPU runs (``pinned_routing``; reordered for the
    reversed batch): with random weights a near tie among the router's
    logits flips under any change of summation order, and after an Adam
    step that moves the loss far more than the arithmetic does. Every pair
    is printed before any limit is checked."""
    import torch

    runs, routes = {}, []
    for device, dtype, rev in (("cuda", torch.bfloat16, False),
                               ("cpu", torch.bfloat16, False),
                               ("cpu", torch.bfloat16, True),
                               ("cpu", torch.float32, False)):
        model, state, step = _train_setup(dtype, device)
        x, y = _batch(XTRAIN_B, 2, device)
        if rev:
            x, y = x.flip(0), y.flip(0)
        replay = device == "cpu"
        pinned = routes if not (replay and rev) else [
            idx.view(XTRAIN_B, -1, idx.shape[-1]).flip(0).reshape(idx.shape)
            for idx in routes]
        losses, grads = [], None
        t0 = time.perf_counter()
        with pinned_routing(pinned, replay=replay) as moved:
            for _ in range(XTRAIN_STEPS):
                state, m = step(state, x, y, XTRAIN_LR, XTRAIN_LR)
                losses.append(m["loss"].item())
                if grads is None:
                    grads = {n: p.grad.detach().float().cpu()
                             for n, p in model.named_parameters()}
        key = f"{device} {str(dtype)[6:]}" + (" reversed" if rev else "")
        runs[key] = (losses, grads)
        log(f"cross-check {key}: losses {[round(v, 5) for v in losses]} in "
            f"{time.perf_counter() - t0:.1f} s"
            + (f"; {check_moved(moved, key)}" if replay else ""))
        del model, state, step
    failed = []
    for a, b, limits in XTRAIN_PAIRS:
        (la, ga), (lb, gb) = runs[a], runs[b]
        rel = [abs(u - w) / abs(w) for u, w in zip(la, lb)]
        cos = _cos(torch.cat([ga[n].flatten() for n in gb]),
                   torch.cat([gb[n].flatten() for n in gb]))
        per = {n: _cos(ga[n], gb[n]) for n in gb}
        lowest = sorted(per, key=per.get)[:5]
        router = [per[n] for n in per if "router" in n]
        log(f"train cross-check {a} vs {b}, B={XTRAIN_B}, lr {XTRAIN_LR:g}: "
            f"loss rel diff per step {[float(f'{v:.3e}') for v in rel]}, "
            f"step-1 gradient cosine {cos:.6f}, lowest per-tensor cosines "
            + ", ".join(f"{n} {per[n]:.4f}" for n in lowest)
            + f"; router tensors {min(router):.4f}-{max(router):.4f}"
            + (f" (limits: loss {limits[0]}, cosine {limits[1]}, per tensor "
               f"{limits[2]})" if limits else " (printed only)"))
        if limits and (any(r > t for r, t in zip(rel, limits[0], strict=True))
                       or cos < limits[1]
                       or (limits[2] and per[lowest[0]] < limits[2])):
            failed.append(f"{a} vs {b}")
    if failed:
        raise AssertionError(f"card bf16 training disagrees: {failed}")


def resmoe_phase(card: str) -> None:
    """The ResMoE B=128 step on the device clock with and without the fused
    optimizer (exact launch counts), then one step from the same state and
    gradients on both optimizer paths (``PATH_ULPS``, ``BC_REL``)."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, engine, losses, ops, optim
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    model = create_model(RESMOE, num_classes=1000, dtype=torch.bfloat16)
    opt_init, update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cuda", opt_init=opt_init,
                               use_ema=True)
    crit = losses.make_base_criterion(False, 0.1, False)
    steps = {fused: engine.make_train_step(model, update, crit,
                                           ema_decay=EMA_DECAY,
                                           use_fused_optimizer=fused)
             for fused in (False, True)}
    x, y = _batch(TRAIN_B, 0, "cuda")
    for fused in (False, True):
        state, m = steps[fused](state, x, y, LR, LR)  # warm-up
        ops.reset_launch_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        losses_ = []
        start.record()
        for _ in range(RESMOE_STEPS):
            state, m = steps[fused](state, x, y, LR, LR)
            losses_.append(m["loss"])
        end.record()
        end.synchronize()
        counts = ops.launch_counts()
        per = dict(PER_RESMOE_STEP, fused_adamw_ema=int(fused))
        if counts != expected(per, RESMOE_STEPS):
            raise AssertionError(f"ResMoE launch counts {counts} != "
                                 f"{expected(per, RESMOE_STEPS)}")
        losses_ = torch.stack(losses_).tolist()
        if not all(np.isfinite(losses_)):
            raise AssertionError(f"non-finite ResMoE loss {losses_}")
        ms = start.elapsed_time(end) / RESMOE_STEPS
        what = ("fused optimizer (K7)" if fused
                else "torch AdamW + foreach EMA")
        log(f"ResMoE train step B={TRAIN_B}, {what}: {ms:.3f} ms on the "
            f"device clock ({TRAIN_B / ms * 1e3:.1f} images/s), losses "
            f"{[round(v, 4) for v in losses_]}, launches per step exact; "
            f"card {card}")
        # the device's own time: the profile's kernel sum (the events
        # above also count the device's idle gaps behind a slow host)
        profile_call(lambda: steps[fused](state, x, y, LR, LR),
                     f"one ResMoE train step B={TRAIN_B}, {what}")

    # one step on each optimizer path from the same state and gradients
    state.optimizer.zero_grad(set_to_none=True)
    model.train()
    crit(model(x, state.generator), y).backward()
    named = list(model.named_parameters())

    def snapshot():
        out = {"param": {n: p.detach().clone() for n, p in named},
               "ema": {n: e.clone() for n, e in state.ema_params.items()}}
        for key in ("exp_avg", "exp_avg_sq", "step"):
            out[key] = {n: state.optimizer.state[p][key].clone()
                        for n, p in named}
        return out

    def restore(snap):
        with torch.no_grad():
            for n, p in named:
                p.copy_(snap["param"][n])
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    state.optimizer.state[p][key].copy_(snap[key][n])
            for n, e in state.ema_params.items():
                e.copy_(snap["ema"][n])

    start_state = snapshot()
    grads = {n: p.grad for n, p in named}
    update.fused_apply(model, state.optimizer, state.ema_params, LR, LR,
                       EMA_DECAY)
    fused_state = snapshot()
    restore(start_state)
    update(state.optimizer, LR, LR)
    engine.ema_update(state.ema_params, model, EMA_DECAY)
    torch_state = snapshot()
    worst = {}
    for what in ("param", "ema", "exp_avg", "exp_avg_sq"):
        extra = BC_REL * LR if what in ("param", "ema") else 0.0
        for n, want in torch_state[what].items():
            # ulps of the leaf's largest value before or after the step
            # (and of (1-b1)*g for the first moment, which can cancel)
            scale = max(want.abs().max().item(),
                        start_state[what][n].abs().max().item())
            if what == "exp_avg":
                scale = max(scale, 0.1 * grads[n].abs().max().item())
            d = (fused_state[what][n] - want).abs().max().item()
            lim = PATH_ULPS * scale + extra
            worst[what] = max(worst.get(what, 0.0), d / lim)
            if d > lim:
                raise AssertionError(f"fused vs torch AdamW: {what} {n} max "
                                     f"|d| {d:.3e} beyond {lim:.3e}")
    if fused_state["step"] != torch_state["step"]:
        steps_seen = {float(v) for v in fused_state["step"].values()}
        raise AssertionError(f"optimizer step counts differ: {steps_seen}")
    log("one step, fused vs torch AdamW + foreach EMA, from the same state "
        f"(t={int(float(next(iter(torch_state['step'].values()))))}): "
        "largest |d| / limit " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in worst.items()))
    del model, state, steps, start_state, fused_state, torch_state, named
    torch.cuda.empty_cache()


@contextlib.contextmanager
def ffn_knob(name):
    """Run with only the expert-FFN knob ``name`` (or none) set to 1; the
    environment is restored afterwards."""
    keys = [k for k in CAP_FORMS.values() if k]
    saved = {k: os.environ.pop(k, None) for k in keys}
    if name:
        os.environ[name] = "1"
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def capacity_kernel_phase(results: dict) -> None:
    """K9 forward and backward and K8 against their plain versions at
    cfg4's layout, the dropless B=128 layout and a small skewed capacity
    layout with a starved expert; timed at the first two beside their
    bounds, K9's forward beside the dispatch gather + K3 and K8 beside
    K4; at the first two K8 also against the exact f32 function, call to
    call bit for bit and launch by launch (``check_defer``)."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn
    from slim_switch_moe_vit_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    T = TRAIN_B * N_TOK
    x = rnd(T, DIM)
    router_w = rnd(DIM, EXPERTS, std=DIM ** -0.5, dtype=torch.float32)
    weights = (rnd(EXPERTS, DIM, HIDDEN, std=DIM ** -0.5),
               rnd(EXPERTS, HIDDEN, std=0.1, dtype=torch.float32),
               rnd(EXPERTS, HIDDEN, DIM, std=HIDDEN ** -0.5),
               rnd(EXPERTS, DIM, std=0.1, dtype=torch.float32))
    w1, b1, w2, b2 = weights
    w_bytes = 2 * EXPERTS * DIM * HIDDEN * 2 + EXPERTS * (HIDDEN + DIM) * 4
    # a small layout: expert 0 favoured past its capacity, expert 7 starved
    Ts = 2000
    skew = torch.zeros(EXPERTS, device="cuda")
    skew[0], skew[-1] = 1.5, -1e9
    layouts = {
        "cfg4": (x, x.float() @ router_w,
                 moe.compute_capacity(T, EXPERTS, 2, CAP_FACTOR)),
        "dropless": (x, x.float() @ router_w, None),
        "skewed": (x[:Ts], x[:Ts].float() @ router_w + skew,
                   moe.compute_capacity(Ts, EXPERTS, 2, CAP_FACTOR))}
    for label, (xt, logits, cap) in layouts.items():
        gate_w, eidx = moe.naive_topk_gate(logits, 2)
        gidx, pslot, eot, w_slot, keep = moe.aligned_expert_layout(
            eidx, EXPERTS, gate_w=gate_w, capacity=cap)
        keep_in = None if cap is None else keep
        xs = moe.dispatch_gather(xt, gidx, pslot, keep_in)
        dy = rnd(gidx.shape[0], DIM) * w_slot[:, None]
        Tp, n = gidx.shape[0], xt.shape[0]
        flags = ffn.bwd_flags(eot)
        log(f"capacity layout {label}: T={n}, capacity {cap}, Tp={Tp} "
            f"({Tp // 256} tiles), pairs dropped {int((~keep).sum())}, "
            "tiles per expert "
            f"{torch.bincount(eot.long(), minlength=EXPERTS).tolist()}, K8 "
            f"flushes {int((flags & 1).sum())}, of which single-tile "
            f"{int(((flags & 1) & ~(flags >> 1) & 1).sum())}")
        cases = {
            "fused_expert_ffn_gather": (
                lambda: ffn.fused_expert_ffn_gather(xt, gidx, pslot, keep_in,
                                                    *weights, eot),
                lambda: ffn.fused_expert_ffn_reference(
                    xt.index_select(0, gidx), *weights, eot),
                (n * DIM * 2 + Tp * 8 + Tp * DIM * 2 + w_bytes,
                 4 * Tp * DIM * HIDDEN, BF16_FLOPS), ("elem",),
                ("dispatch gather + K3", "gather_k3",
                 lambda: ffn.fused_expert_ffn(
                     moe.dispatch_gather(xt, gidx, pslot, keep_in), *weights,
                     eot))),
            "fused_expert_ffn_gather_bwd": (
                lambda: ffn.fused_expert_ffn_gather_bwd(xt, gidx, w1, b1, w2,
                                                        eot, dy),
                lambda: ffn.reference_expert_ffn_bwd(
                    xt.index_select(0, gidx), w1, b1, w2, eot, dy),
                (n * DIM * 2 + Tp * 8 + 2 * Tp * DIM * 2 + 2 * w_bytes,
                 10 * Tp * DIM * HIDDEN, BF16_FLOPS),
                ("elem", "sum", "sum", "sum", "sum"),
                ("K4", "k4", lambda: ffn.fused_expert_ffn_bwd(xs, w1, b1, w2,
                                                              eot, dy))),
            "fused_expert_ffn_bwd_defer": (
                lambda: ffn.fused_expert_ffn_bwd_defer(xs, w1, b1, w2, eot,
                                                       dy),
                lambda: ffn.reference_expert_ffn_bwd_defer(xs, w1, b1, w2,
                                                           eot, dy),
                (3 * Tp * DIM * 2 + 2 * w_bytes, 10 * Tp * DIM * HIDDEN,
                 BF16_FLOPS),
                ("elem", "sum", "sum", "sum", "sum"),
                ("K4", "k4", lambda: ffn.fused_expert_ffn_bwd(xs, w1, b1, w2,
                                                              eot, dy)))}
        for name, (kernel, plain, cost, modes, (other, key, beside)) in \
                cases.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err, peak, rel = compare(name, got, want, modes)
            if name == "fused_expert_ffn_gather" and label == "cfg4":
                exact_ffn_fwd(f"{name} ({label})", got, want,
                              (xt.index_select(0, gidx), *weights, eot))
            if name == "fused_expert_ffn_bwd_defer" and label != "skewed":
                check_defer(results.setdefault(name, {"max_abs_err": 0.0,
                                                      "library_ms": None}),
                            label, "" if label == "cfg4" else "_" + label,
                            kernel, got, want, (xs, w1, b1, w2, eot, dy))
            if label == "skewed" and isinstance(got, tuple):
                # the starved expert's dW1 and dW2: exact zeros
                if any(g[-1].abs().max().item() != 0.0
                       for g in (got[1], got[3])):
                    raise AssertionError(f"{name}: the starved expert's dW "
                                         "is not zero")
            res = results.setdefault(name, {"max_abs_err": 0.0,
                                            "library_ms": None})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            line = (f"kernel {name} ({label}, Tp={Tp}): max|d| {err:.3e}, "
                    f"max|ref| {peak:.3e}, largest max|d|/max|ref| {rel:.2e}")
            if label != "skewed":
                sfx = "" if label == "cfg4" else "_" + label
                ms, beside_ms = median_ms(kernel), median_ms(beside)
                bound_ms, bound_by = bound(*cost)
                res.update({"ms" + sfx: ms, "bound_ms" + sfx: bound_ms,
                            "bound_by": bound_by,
                            f"ms_{key}{sfx}": beside_ms})
                line += (f"; kernel {ms:.4f} ms, {other} {beside_ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by})")
                if label == "cfg4":
                    res["plain_ms"] = median_ms(plain, reps=3, warmup=1)
                    line += f", plain {res['plain_ms']:.4f} ms"
            log(line)
        del cases, xs, dy
    del x, weights, w1, b1, w2, b2
    torch.cuda.empty_cache()


def capacity_layer_check() -> None:
    """One MoE layer at full width (T = 25,216 tokens), a router skewed so
    that more than a tenth of the pairs drop, through ``capacity_fused`` in
    the three forms against the scatter-buffer ``'capacity'`` oracle on the
    card: the same ``keep`` and ``drop_fraction``; y elementwise within the
    kernel limit; dW1, dW2 and dx within SUM_REL of max |ref|. dx is a sum
    over the token's two experts' bf16 rows and the router's term, which
    cancel in places: one ulp of a summand near max |ref| (2^-5 at 4.4)
    then lands on a sum far below it, beyond the elementwise limit (3.1e-2
    at |ref| < 1, 0.71% of max |ref|, on an NVIDIA H100 80GB HBM3 at
    700 W)."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops
    from slim_switch_moe_vit_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(4)

    def rnd(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    T = TRAIN_B * N_TOK
    x = rnd(T, DIM, dtype=torch.bfloat16)
    router_w = rnd(DIM, EXPERTS, std=DIM ** -0.5)
    router_b = torch.zeros(EXPERTS, device="cuda")
    router_b[:2] = CAP_ROUTER_SKEW
    w1, b1 = rnd(EXPERTS, DIM, HIDDEN, std=DIM ** -0.5), rnd(
        EXPERTS, HIDDEN, std=0.1)
    w2, b2 = rnd(EXPERTS, HIDDEN, DIM, std=HIDDEN ** -0.5), rnd(
        EXPERTS, DIM, std=0.1)
    c = rnd(T, DIM, dtype=torch.bfloat16)
    cap = moe.compute_capacity(T, EXPERTS, 2, CAP_FACTOR)
    _, eidx = moe.naive_topk_gate(moe._router_logits(x, router_w, router_b), 2)
    _, keep = moe.make_dispatch(eidx, EXPERTS, cap)
    keep_fused = moe.aligned_expert_layout(eidx, EXPERTS, capacity=cap)[4]
    if not torch.equal(keep, keep_fused):
        raise AssertionError("the fused capacity layout keeps other pairs "
                             "than the scatter buffers")

    def run(fn):
        xl, w1l, w2l = (t.detach().clone().requires_grad_()
                        for t in (x, w1, w2))
        y, aux = fn(xl, router_w, router_b, w1l, b1, w2l, b2, top_k=2,
                    capacity_factor=CAP_FACTOR)
        (y.float() * c.float()).sum().backward()
        return (y.detach(), xl.grad, w1l.grad, w2l.grad), aux

    want, aux = run(moe.moe_forward)
    drop = aux["drop_fraction"].item()
    log(f"capacity layer, T={T}, capacity {cap}, router bias "
        f"+{CAP_ROUTER_SKEW} on experts 0-1: drop_fraction {drop:.6f} "
        f"({int((~keep).sum())} of {keep.numel()} pairs dropped)")
    if not drop > 0.1:
        raise AssertionError(f"drop_fraction {drop} <= 0.1: the skew did "
                             "not overflow the capacity")
    for form, knob in CAP_FORMS.items():
        with ffn_knob(knob):
            ops.reset_launch_counts()
            got, aux_f = run(moe.moe_forward_fused)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
        want_ffn = {k: v // 12 for k, v in PER_CAP_STEP[form].items()
                    if "expert_ffn" in k and v}
        if counts != want_ffn:
            raise AssertionError(f"capacity layer {form}: launches {counts}"
                                 f" != {want_ffn}")
        if aux_f["drop_fraction"].item() != drop:
            raise AssertionError(f"{form}: drop_fraction "
                                 f"{aux_f['drop_fraction'].item()} != {drop}")
        err = [compare(f"capacity layer {form} {what}", g, w, (mode,))
               for what, g, w, mode in zip(("y", "dx", "dW1", "dW2"), got,
                                           want, ("elem", "sum", "sum",
                                                  "sum"))]
        log(f"capacity layer {form} vs 'capacity' oracle: max|d| / max|ref| "
            + ", ".join(f"{w} {e[0]:.3e}/{e[1]:.3e}"
                        for w, e in zip(("y", "dx", "dW1", "dW2"), err))
            + f"; launches {counts}")
    del x, w1, w2, c, want
    torch.cuda.empty_cache()


def check_ln_bwd_launches(prof: dict, per: dict, form: str) -> None:
    """One profiled step's LN-backward launches (``csrc/ln_bwd.cu``'s
    ``ln_bwd_kernel``) equal its LN-backward wrapper calls: one launch a
    call, no second pass."""
    calls = sum(per.get(name, 0) for name in LN_BWD)
    launched = sum(n for name, (_, n) in prof.items() if "ln_bwd" in name)
    others = [name for name in prof if "col_sum" in name]
    log(f"  cfg4 {form} form: {launched} LN-backward launches in the profiled"
        f" step for {calls} wrapper calls")
    if launched != calls or others:
        raise AssertionError(f"cfg4 {form}: {launched} LN-backward launches "
                             f"({others}) for {calls} wrapper calls")


def capacity_train_phase(card: str) -> dict:
    """cfg4's training step in the three forms and the witness, from the
    same weights, CAP_STEPS steps each with exact per-step launch counts;
    returns the K9 launches of the K9 form and the K8 launches of the K8
    form."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, ops
    from slim_switch_moe_vit_tpu_torch.ops import moe as moe_ops

    base = create_model(MODEL, num_classes=1000, dtype=torch.bfloat16,
                        dispatch_mode="capacity_fused",
                        capacity_factor=CAP_FACTOR)
    x, y = _batch(TRAIN_B, 0, "cuda")  # bench.py:93-95: seeds 0 and 1
    gathers = []
    real_gather = moe_ops.dispatch_gather

    def counted_gather(*a, **kw):
        gathers.append(1)
        return real_gather(*a, **kw)

    losses, launched, peak = {}, {}, {}
    moe_ops.dispatch_gather = counted_gather
    try:
        for form, knob in (*CAP_FORMS.items(), ("witness", None)):
            per = PER_CAP_STEP.get(form, PER_CAP_STEP["default"])
            n_gather = CAP_DISPATCH_GATHERS.get(form, 12)
            with ffn_knob(knob):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                model, state, step = _train_setup(
                    torch.bfloat16, "cuda", model=copy.deepcopy(base))
                xb, yb = (x.flip(0), y.flip(0)) if form == "witness" else (x, y)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                run, drops, total = [], [], {}
                for i in range(CAP_STEPS):
                    if i == 1:
                        start.record()
                    ops.reset_launch_counts()
                    gathers.clear()
                    state, m = step(state, xb, yb, LR, LR)
                    counts = ops.launch_counts()
                    if counts != expected(per, 1) or len(gathers) != n_gather:
                        raise AssertionError(
                            f"cfg4 {form} step {i}: launches {counts}, "
                            f"{len(gathers)} dispatch gathers; expected "
                            f"{expected(per, 1)}, {n_gather}")
                    total = {k: total.get(k, 0) + v for k, v in counts.items()}
                    run.append(m["loss"])
                    drops.append(m["drop_fraction"])
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / (CAP_STEPS - 1)
                losses[form] = torch.stack(run).tolist()
                launched[form] = total
                log(f"cfg4 train step B={TRAIN_B}, capacity_fused "
                    f"{CAP_FACTOR}, {form} form: {ms:.3f} ms on the device "
                    f"clock over steps 2-{CAP_STEPS} "
                    f"({TRAIN_B / ms * 1e3:.1f} images/s), losses "
                    f"{[round(v, 5) for v in losses[form]]}, drop_fraction "
                    f"{[round(v.item(), 6) for v in drops]}, launches per "
                    f"step exact ({n_gather} dispatch gathers); card {card}")
                if not all(np.isfinite(losses[form])):
                    raise AssertionError(f"cfg4 {form}: non-finite loss")
                if form != "witness":
                    prof = profile_call(lambda: step(state, xb, yb, LR, LR),
                                        f"one cfg4 train step B={TRAIN_B}, "
                                        f"{form} form")
                    check_ln_bwd_launches(prof, per, form)
                peak[form] = torch.cuda.max_memory_allocated()
                log(f"  cfg4 {form} form: peak device memory "
                    f"{peak[form] / 2 ** 30:.3f} GiB "
                    "(max_memory_allocated over the model's set-up and "
                    "its steps)")
                del model, state, step
                torch.cuda.empty_cache()
    finally:
        moe_ops.dispatch_gather = real_gather
    ref = losses["default"]

    def gaps(a):
        return [abs(u - w) / abs(w) for u, w in zip(a, ref)]

    witness = gaps(losses["witness"])
    limit = [max(CAP_WITNESS * w, CAP_FLOOR) for w in witness]
    log(f"cfg4 losses vs the default form, relative per step: witness "
        f"(batch reversed) {[float(f'{v:.3e}') for v in witness]}; limits "
        f"{[float(f'{v:.3e}') for v in limit]}; "
        + "; ".join(f"{f} {[float(f'{v:.3e}') for v in gaps(losses[f])]}"
                    for f in ("K9", "K8")))
    for form in ("K9", "K8"):
        if any(g > t for g, t in zip(gaps(losses[form]), limit)):
            raise AssertionError(f"cfg4 {form} form's losses part from the "
                                 "default form's beyond the limit")
    # K8 keeps no (Tp, H) workspace (K4's is 2 x Tp x H bf16 a call); the
    # step's peak need not fall with it, since it lies elsewhere
    log(f"cfg4 peak device memory, K8 form vs default: "
        f"{peak['K8'] / 2 ** 30:.3f} vs {peak['default'] / 2 ** 30:.3f} GiB")
    del base
    return {"fused_expert_ffn_gather": launched["K9"]["fused_expert_ffn_gather"],
            "fused_expert_ffn_gather_bwd":
                launched["K9"]["fused_expert_ffn_gather_bwd"],
            "fused_expert_ffn_bwd_defer":
                launched["K8"]["fused_expert_ffn_bwd_defer"]}


def capacity_phase(results: dict, card: str) -> dict:
    """Phase 11: K9 and K8 against their plain versions, the MoE layer
    against the 'capacity' oracle, and cfg4's training step in three forms;
    returns the new kernels' launches on cfg4's path."""
    t0 = time.perf_counter()
    capacity_kernel_phase(results)
    log(f"[capacity kernels: {time.perf_counter() - t0:.1f} s]")
    capacity_layer_check()
    return capacity_train_phase(card)


def eval_decisions(model, x) -> tuple:
    """(logits, each MoE call's chosen expert pairs, each gate's skip
    decisions) of one eval forward, on the host."""
    import torch

    from slim_switch_moe_vit_tpu_torch.models import gates
    from slim_switch_moe_vit_tpu_torch.ops import moe as moe_ops

    routes, skips = [], []
    real = moe_ops.naive_topk_gate

    def spy(logits, top_k):
        w, idx = real(logits, top_k)
        routes.append(idx.sort(-1).values.cpu())
        return w, idx

    hooks = [g.register_forward_hook(
        lambda mod, i, o: skips.append((o[..., 0] > 0.5).cpu()))
        for g in gates.gate_modules(model).values()]
    moe_ops.naive_topk_gate = spy
    try:
        with torch.no_grad():
            logits = model(x).float().cpu().numpy()
    finally:
        moe_ops.naive_topk_gate = real
        for h in hooks:
            h.remove()
    return logits, routes, skips


def logit_gap(got: tuple, ref: tuple) -> dict:
    """How far two ``eval_decisions`` results lie apart: the logits as in
    ``cross_check``, and the routing and gate decisions that differ."""
    a, b = got[0], ref[0]
    d = np.abs(a - b)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    top2 = np.sort(b, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 2 * d.max()
    agree = a.argmax(1) == b.argmax(1)
    per_image = np.sort(d.max(1))[::-1][:5] / np.abs(b).max()
    return {"rel": float(d.max() / np.abs(b).max()), "cos": float(cos.min()),
            "per_image": [float(f"{v:.2e}") for v in per_image],
            "n": len(a), "agree": int(agree.sum()),
            "decisive": int(decisive.sum()),
            "decisive_agree": int(agree[decisive].sum()),
            "route_flips": [round(float((u != w).any(-1).float().mean()), 4)
                            for u, w in zip(got[1], ref[1])],
            "skip_flips": int(sum(int((u != w).sum())
                                  for u, w in zip(got[2], ref[2]))),
            "skips": int(sum(w.numel() for w in ref[2])),
            "skipped": int(sum(int(w.sum()) for w in ref[2]))}


def driver_phase(card: str, tmp: str) -> dict:
    """The training driver's ``main()`` at full width, then ``--eval
    --use-flash-attention`` from its checkpoint; returns the launches of
    K7 (training run) and K11 (eval run)."""
    import argparse

    import torch

    from slim_switch_moe_vit_tpu_torch import config, engine, ops, optim
    from slim_switch_moe_vit_tpu_torch import main as driver
    from slim_switch_moe_vit_tpu_torch.data import (
        build_dataset,
        build_eval_normalize,
    )
    from slim_switch_moe_vit_tpu_torch.models import gates
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import restore_checkpoint

    parser = argparse.ArgumentParser(parents=[config.get_args_parser()])
    out = os.path.join(tmp, "driver")
    os.makedirs(out)
    rec = {"train": [], "eval": [], "losses": [], "loop_s": 0.0,
           "anneals": []}

    def counting(make, key):
        def make_counted(*a, **kw):
            fn = make(*a, **kw)

            def run(*fa, **fkw):
                before = ops.launch_counts()
                res = fn(*fa, **fkw)
                after = ops.launch_counts()
                rec[key].append({k: after[k] - before[k] for k in after})
                if key == "train":
                    rec["losses"].append(res[1]["loss"])
                return res
            return run
        return make_counted

    def timed_epoch(*a, **kw):
        t0 = time.perf_counter()
        res = real["train_one_epoch"](*a, **kw)
        rec["loop_s"] += time.perf_counter() - t0
        return res

    def anneal_spy(model, plan, epoch):
        mods = gates.gate_modules(model)
        before = {p: (g.threshold.item(), g.enabled.item())
                  for p, g in mods.items()}
        real["apply_epoch_anneal"](model, plan, epoch)
        rec["anneals"].append((epoch, plan, before, {
            p: (g.threshold.item(), g.enabled.item(),
                g.target_threshold.item()) for p, g in mods.items()}))

    real = {"make_train_step": engine.make_train_step,
            "make_eval_step": engine.make_eval_step,
            "train_one_epoch": engine.train_one_epoch,
            "apply_epoch_anneal": driver.apply_epoch_anneal}
    engine.make_train_step = counting(real["make_train_step"], "train")
    engine.make_eval_step = counting(real["make_eval_step"], "eval")
    engine.train_one_epoch = timed_epoch
    driver.apply_epoch_anneal = anneal_spy
    try:
        args = parser.parse_args(DRIVER_ARGS + ["--output_dir", out])
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = driver.main(args)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        ckpt = os.path.join(out, "checkpoint")
        eargs = parser.parse_args(DRIVER_ARGS + [
            "--eval", "--resume", ckpt, "--use-flash-attention"])
        train_evals, rec["eval"] = rec["eval"], []
        ops.reset_launch_counts()
        estate = driver.main(eargs)
        flash_counts = ops.launch_counts()
    finally:
        engine.make_train_step = real["make_train_step"]
        engine.make_eval_step = real["make_eval_step"]
        engine.train_one_epoch = real["train_one_epoch"]
        driver.apply_epoch_anneal = real["apply_epoch_anneal"]

    # every train step and eval forward through exactly its kernels
    bad = [d for d in rec["train"] if d != expected(PER_RESMOE_STEP, 1)]
    bad += [d for d in train_evals if d != expected(PER_RESMOE_FORWARD, 1)]
    want = {k: PER_RESMOE_STEP.get(k, 0) * len(rec["train"])
            + PER_RESMOE_FORWARD.get(k, 0) * len(train_evals)
            for k in counts}
    log(f"driver: {len(rec['train'])} train steps, {len(train_evals)} eval "
        f"forwards, launches {counts}")
    if bad or counts != want or len(rec["train"]) != DRIVER_TRAIN_STEPS:
        raise AssertionError(f"driver launch counts: {counts} != {want}, "
                             f"{len(rec['train'])} steps, off: {bad[:2]}")
    losses_ = torch.stack(rec["losses"]).tolist()
    if not all(np.isfinite(losses_)):
        raise AssertionError(f"non-finite driver loss: {losses_}")
    loop_steps = DRIVER_TRAIN_STEPS - 2  # the rehearsal steps run outside
    log(f"driver: losses {[round(v, 4) for v in losses_]}; {wall:.1f} s for "
        f"the whole run, {DRIVER_TRAIN_STEPS / wall:.3f} train steps/s over "
        f"it (data, eval, checkpoints included), {loop_steps / rec['loop_s']:.3f}"
        f" steps/s in the epoch loops (host data loading included); card "
        f"{card}")

    # the gates: disabled through each task's first epoch, then the plan
    f32 = np.float32
    for epoch, plan, before, after in rec["anneals"]:
        if epoch == 0 and any(en != 0.0 for _, en in before.values()):
            raise AssertionError("gates not disabled through a task's first "
                                 "epoch")
        for path, (delta, start) in plan.items():
            thr, en = before[path]
            if epoch >= start:
                thr = float(np.maximum(f32(thr) - f32(delta),
                                       f32(after[path][2])))
                en = 1.0
            if after[path][:2] != (thr, en):
                raise AssertionError(f"gate {path} after epoch {epoch}: "
                                     f"{after[path][:2]} != {(thr, en)}")
    log("driver: gate thresholds after each epoch (task, epoch -> values): "
        + "; ".join(f"{i // 2}, {e} -> "
                    f"{sorted({round(v[0], 6) for v in a.values()})} "
                    f"enabled {sorted({v[1] for v in a.values()})}"
                    for i, (e, _, _, a) in enumerate(rec["anneals"]))
        + ", as planned")

    # the checkpoint restores parameters, moments and EMA bit for bit
    fresh = driver.build_model(args, args.nb_classes, args.seed)
    opt_init, _ = optim.make_optimizer(weight_decay=args.weight_decay)
    restored, epoch = restore_checkpoint(ckpt, create_train_state(
        fresh, device="cuda", seed=args.seed, opt_init=opt_init,
        use_ema=True))
    same = [torch.equal(a, b) for a, b in zip(
        state.model.state_dict().values(),
        restored.model.state_dict().values())]
    same += [torch.equal(e, restored.ema_params[n])
             for n, e in state.ema_params.items()]
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            same.append(torch.equal(state.optimizer.state[p][key].cpu(),
                                    restored.optimizer.state[q][key].cpu()))
    if not all(same) or restored.step != state.step:
        raise AssertionError(f"--resume: {same.count(False)} tensors differ")
    log(f"driver: --resume restored epoch {epoch}, step {restored.step}: "
        f"{len(same)} tensors (parameters and gate buffers, EMA, moments) "
        "bit-identical")
    del fresh, restored, state

    # --eval --use-flash-attention: K11 in every forward, K5 in none
    bad = [d for d in rec["eval"] if d != expected(PER_FLASH_FORWARD, 1)]
    if bad or flash_counts != expected(PER_FLASH_FORWARD, len(rec["eval"])):
        raise AssertionError(f"flash eval launch counts {flash_counts}")
    log(f"driver --eval --use-flash-attention: {len(rec['eval'])} forwards, "
        f"launches {flash_counts}")
    ds, _ = build_dataset(False, eargs)
    imgs = torch.from_numpy(np.stack([ds[i][0] for i in range(64)])).cuda()
    x = build_eval_normalize(dtype=torch.bfloat16)(imgs)
    model = estate.model.eval()
    flash = eval_decisions(model, x)
    for blk in model.blocks:
        blk.attn.use_flash = False
    qkvs = []  # each block's qkv as the K5 eval computes it
    hooks = [blk.attn.qkv.register_forward_hook(
        lambda mod, i, o: qkvs.append(o.detach())) for blk in model.blocks]
    k5 = eval_decisions(model, x)
    for h in hooks:
        h.remove()
    # the witness: the same checkpoint's K5 eval against the port's plain
    # path on the CPU in bf16 (the same precision, other roundings)
    plain = eval_decisions(copy.deepcopy(model).cpu(), x.cpu())
    gaps = {"flash vs K5": logit_gap(flash, k5),
            "K5 vs CPU bf16 plain (witness)": logit_gap(k5, plain)}
    for what, g in gaps.items():
        log(f"eval logits, {what}, 64 images: max |d| / max |ref| "
            f"{g['rel']:.4e} (per image, largest five: {g['per_image']}), "
            f"min cosine {g['cos']:.6f}, top-1 agree {g['agree']}/{g['n']} "
            f"({g['decisive']} decisive, {g['decisive_agree']} of them "
            f"agree); tokens routed to another expert pair per block "
            f"{g['route_flips']}; gate decisions flipped {g['skip_flips']} "
            f"of {g['skips']} ({g['skipped']} skipped)")
    # K11 against K5 and the plain version on the checkpoint's own qkv
    from slim_switch_moe_vit_tpu_torch.ops import attention

    hd = DIM // HEADS
    rows = []
    for qkv in qkvs:
        f = attention.flash_attention(qkv, HEADS, hd ** -0.5)
        k = attention.fused_mha(qkv, HEADS, hd ** -0.5)
        p = attention.flash_attention_reference(qkv, HEADS, hd ** -0.5)
        rows.append((compare("flash_attention", f, k, ("elem",))[:2],
                     compare("flash_attention", f, p, ("elem",))[0],
                     compare("fused_mha", k, p, ("elem",))[0]))
    log("K11 on each block's qkv of the checkpoint (max |d| flash-K5 / "
        "flash-plain / K5-plain, max |ref|): " + "; ".join(
            f"{i}: {fk[0]:.2e}/{fp:.2e}/{kp:.2e}, {fk[1]:.2f}"
            for i, (fk, fp, kp) in enumerate(rows)))
    g, w = gaps["flash vs K5"], gaps["K5 vs CPU bf16 plain (witness)"]
    rel_lim = max(XCHECK_REL, FLASH_WITNESS * w["rel"])
    cos_lim = min(XCHECK_COS, 1.0 - FLASH_WITNESS * (1.0 - w["cos"]))
    if (g["rel"] > rel_lim or g["cos"] < cos_lim
            or g["decisive_agree"] != g["decisive"]):
        raise AssertionError(f"flash eval logits disagree with K5's beyond "
                             f"max |d| / max |ref| {rel_lim:.3e}, cosine "
                             f"{cos_lim:.6f}")
    del model, estate
    torch.cuda.empty_cache()
    export_checkpoint(ckpt, args.nb_classes, tmp)
    return {"fused_adamw_ema": counts["fused_adamw_ema"],
            "flash_attention": flash_counts["flash_attention"]}


def export_checkpoint(ckpt: str, num_classes: int, tmp: str) -> None:
    """Phase 17: the driver's checkpoint through the export CLI with
    ``--use-ema`` at ``--img-size`` EXPORT_IMG: the artifact holds the EMA,
    the gates' buffers and the bicubically resized ``pos_embed``, and
    serves one request."""
    import torch

    from slim_switch_moe_vit_tpu_torch.models.vit import resize_pos_embed
    from slim_switch_moe_vit_tpu_torch.serving import export

    art = os.path.join(tmp, "export")
    t0 = time.perf_counter()
    export.main(["--model", RESMOE, "--output", art, "--checkpoint", ckpt,
                 "--use-ema", "--img-size", str(EXPORT_IMG), "--num-classes",
                 str(num_classes), "--batch-sizes", "2"])
    served = torch.load(os.path.join(art, "params.pt"), weights_only=True)
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    want = {**payload["model"], **payload["ema_params"]}
    grid = EXPORT_IMG // 16
    want["pos_embed"] = resize_pos_embed(want["pos_embed"], 1, grid)
    differ = [n for n, t in want.items()
              if not torch.equal(served[n], t.float())]
    if differ or served.keys() != want.keys():
        raise AssertionError(f"exported artifact differs from the "
                             f"checkpoint's EMA: {differ[:5]}")
    pred = export.load_predictor(art)
    logits = pred.predict(np.random.RandomState(11).randint(
        0, 256, (1, EXPORT_IMG, EXPORT_IMG, 3), dtype=np.uint8))
    if logits.shape != (1, num_classes) or not np.isfinite(logits).all():
        raise AssertionError(f"exported checkpoint served {logits.shape}")
    log(f"export CLI: the driver's checkpoint with --use-ema at "
        f"--img-size {EXPORT_IMG} (pos_embed 14x14 -> {grid}x{grid}): EMA "
        f"and gate buffers served as saved, one request finite, "
        f"{time.perf_counter() - t0:.1f} s")


def shared(card: str) -> str:
    """The tag of every time the EP phase prints."""
    return (f"({EP_RANKS} ranks sharing one card over gloo, not NCCL "
            f"exchange times; card {card})")


def ep_kernel_phase(results: dict, card: str) -> None:
    """K10 forward and backward against their plain versions at the ep=4
    layout a rank receives in cfg4's a2a form (Tc 6,304, capacity 1,976,
    Cp 2,048: 16,384 source-major rows, 64 steps over 2 local experts),
    with a permutation that is not the identity; each timed beside its
    bound and beside the expert-major relayout + K3 (K4) on the same
    rows."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn
    from slim_switch_moe_vit_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    ep, E_local = EP_RANKS, EXPERTS // EP_RANKS
    Tc = TRAIN_B * N_TOK // ep
    cap = moe.compute_capacity(Tc, EXPERTS, 2, CAP_FACTOR)
    Cp = moe.capacity_region_rows(cap)
    n_per = Cp // ffn.TILE_ROWS
    Tp = ep * E_local * Cp
    xr, dy = rnd(Tp, DIM), rnd(Tp, DIM)
    w1, b1 = rnd(E_local, DIM, HIDDEN, std=DIM ** -0.5), rnd(
        E_local, HIDDEN, std=0.1, dtype=torch.float32)
    w2, b2 = rnd(E_local, HIDDEN, DIM, std=HIDDEN ** -0.5), rnd(
        E_local, DIM, std=0.1, dtype=torch.float32)
    e_of_step = torch.arange(E_local, dtype=torch.int32,
                             device="cuda").repeat_interleave(ep * n_per)
    perm = torch.arange(ep * E_local * n_per, dtype=torch.int32,
                        device="cuda").reshape(ep, E_local, n_per).transpose(
                            0, 1).reshape(-1)
    if torch.equal(perm, torch.arange(perm.numel(), device="cuda",
                                      dtype=torch.int32)):
        raise AssertionError("K10's permutation is the identity")
    log(f"K10 layout (cfg4 a2a form, ep={ep}): Tc={Tc}, capacity {cap}, "
        f"Cp={Cp} ({n_per} tiles), {Tp} rows a rank, "
        f"{e_of_step.numel()} steps over {E_local} local experts")

    def relayout(t):
        return t.reshape(ep, E_local, Cp, DIM).transpose(0, 1).reshape(-1, DIM)

    def back(t):
        return t.reshape(E_local, ep, Cp, DIM).transpose(0, 1).reshape(-1, DIM)

    def k3_relayout():
        return back(ffn.fused_expert_ffn(relayout(xr), w1, b1, w2, b2,
                                         e_of_step))

    def k4_relayout():
        dx, *g = ffn.fused_expert_ffn_bwd(relayout(xr), w1, b1, w2,
                                          e_of_step, relayout(dy))
        return (back(dx), *g)

    w_bytes = 2 * E_local * DIM * HIDDEN * 2 + E_local * (HIDDEN + DIM) * 4
    cases = {
        "fused_expert_ffn_permuted": (
            lambda: ffn.fused_expert_ffn_permuted(xr, w1, b1, w2, b2,
                                                  e_of_step, perm),
            lambda: ffn.reference_expert_ffn_permuted(xr, w1, b1, w2, b2,
                                                      e_of_step, perm),
            (2 * Tp * DIM * 2 + w_bytes, 4 * Tp * DIM * HIDDEN, BF16_FLOPS),
            ("elem",), ("relayout + K3", k3_relayout)),
        "fused_expert_ffn_permuted_bwd": (
            lambda: ffn.fused_expert_ffn_permuted_bwd(xr, w1, b1, w2,
                                                      e_of_step, perm, dy),
            lambda: ffn.reference_expert_ffn_bwd_permuted(
                xr, w1, b1, w2, e_of_step, perm, dy),
            (3 * Tp * DIM * 2 + 2 * w_bytes, 10 * Tp * DIM * HIDDEN,
             BF16_FLOPS),
            ("elem", "sum", "sum", "sum", "sum"),
            ("relayout + K4", k4_relayout))}
    for name, (kernel, plain, cost, modes, (other, beside)) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err, peak, rel = compare(name, got, want, modes)
        if name == "fused_expert_ffn_permuted":
            exact_ffn_fwd(f"{name} (ep={ep})", got, want,
                          (xr, w1, b1, w2, b2, e_of_step), perm)
        # the relayout + K3/K4 path computes the same rows in the same order
        err_k, _, _ = compare(name, got, beside(), modes)
        ms, beside_ms = median_ms(kernel), median_ms(beside)
        bound_ms, bound_by = bound(*cost)
        results[name] = {"max_abs_err": err, "ms": ms,
                         "plain_ms": median_ms(plain, reps=3, warmup=1),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None, "ms_relayout_k3_k4": beside_ms}
        log(f"kernel {name} (ep={ep} layout, Tp={Tp}): max|d| {err:.3e} vs "
            f"plain, {err_k:.3e} vs {other}, max|ref| {peak:.3e}, largest "
            f"max|d|/max|ref| {rel:.2e}; kernel {ms:.4f} ms, {other} "
            f"{beside_ms:.4f} ms, plain {results[name]['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); card {card}")
    del cases, xr, dy, w1, w2
    torch.cuda.empty_cache()


def _read_ranks(out: str, n: int) -> tuple:
    arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
              for r in range(n)]
    records = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return arrays, records


def ep_layer_check(card: str, tmp: str) -> None:
    """One MoE layer (T = 25,216 tokens, D 384, H 1536, E 8, top-2) on
    EP_RANKS ranks sharing the card (dp 1), bf16 activations, in the psum,
    a2a relayout, a2a permuted (K10) and sharded 'capacity' forms and the
    dropless 'fused' form (the experts gathered on every rank): at
    factor 2.0 (nothing drops) each against the single-rank
    ``capacity_fused`` on the same tokens (y elementwise within the kernel
    limit, dx, dW1 and dW2 within SUM_REL of max |ref|), and the 'fused'
    form bit for bit against the single-rank dropless 'fused' layer (y,
    dx and every parameter's gradient); at factor 1.25,
    with a router skewed past the capacity, the two a2a forms against each
    other (the same drops, more than a tenth of the pairs; y within the
    kernel limit). Each rank's expert-FFN launches are exact."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import moe
    from slim_switch_moe_vit_tpu_torch.parallel import launch

    rs = np.random.RandomState(6)
    T = TRAIN_B * N_TOK
    data = dict(
        x=rs.randn(T, DIM).astype(np.float32),
        c=rs.randn(T, DIM).astype(np.float32),
        router_w=(rs.randn(DIM, EXPERTS) * DIM ** -0.5).astype(np.float32),
        router_b=np.zeros(EXPERTS, np.float32),
        w1=(rs.randn(EXPERTS, DIM, HIDDEN) * DIM ** -0.5).astype(np.float32),
        b1=(rs.randn(EXPERTS, HIDDEN) * 0.1).astype(np.float32),
        w2=(rs.randn(EXPERTS, HIDDEN, DIM) * HIDDEN ** -0.5).astype(
            np.float32),
        b2=(rs.randn(EXPERTS, DIM) * 0.1).astype(np.float32))
    # a router skewed onto experts 0-1 past their capacity at 1.25
    data["router_b_skewed"] = np.zeros(EXPERTS, np.float32)
    data["router_b_skewed"][:2] = CAP_ROUTER_SKEW
    out = os.path.join(tmp, "ep_layer")
    os.makedirs(out)
    path = os.path.join(out, "in.npz")
    np.savez(path, top_k=2, **data)
    runs = [(f, 2.0) for f in EP_LAYER_FORMS + ("fused",)] + [
        (f, CAP_FACTOR, "router_b_skewed") for f in ("a2a", "a2a_perm")]
    t0 = time.perf_counter()
    launch.spawn(launch.moe_layer_worker, EP_RANKS,
                 (path, out, 1, EP_RANKS, runs, "bfloat16", "cuda", 2),
                 init_file=os.path.join(out, "store"), device="cuda",
                 env={"SSMV_DIST_BACKEND": "gloo"})
    log(f"EP layer: {EP_RANKS} ranks ran {len(runs)} forms in "
        f"{time.perf_counter() - t0:.1f} s {shared(card)}")
    arrays, records = _read_ranks(out, EP_RANKS)

    # the single-rank capacity_fused on the same tokens, factor 2.0
    x = torch.from_numpy(data["x"]).to("cuda", torch.bfloat16).requires_grad_()
    params = {k: torch.from_numpy(data[k]).cuda().requires_grad_()
              for k in ("router_w", "router_b", "w1", "b1", "w2", "b2")}
    y, aux = moe.moe_forward_fused(x, *params.values(), top_k=2,
                                   capacity_factor=2.0)
    c = torch.from_numpy(data["c"]).to("cuda", torch.bfloat16)
    (y.float() * c.float()).sum().backward()
    if aux["drop_fraction"].item() != 0.0:
        raise AssertionError("the single-rank reference drops pairs at 2.0")
    want = (y.detach(), x.grad, params["w1"].grad, params["w2"].grad)
    # the single-rank dropless 'fused' layer on the same tokens: the
    # gathered form's ranks run the same kernels on the same inputs
    xd = x.detach().clone().requires_grad_()
    pd = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    yd, _ = moe.moe_forward_fused(xd, *pd.values(), top_k=2)
    (yd.float() * c.float()).sum().backward()
    dropless = {"y": yd.detach(), "dx": xd.grad,
                **{"d" + k: v.grad for k, v in pd.items()}}
    launches = {"psum": {"fused_expert_ffn": 1, "fused_expert_ffn_bwd": 1},
                "fused": {"fused_expert_ffn": 1, "fused_expert_ffn_bwd": 1},
                "a2a": {"fused_expert_ffn": 1, "fused_expert_ffn_bwd": 1},
                "a2a_perm": {"fused_expert_ffn_permuted": 1,
                             "fused_expert_ffn_permuted_bwd": 1},
                "sharded": {}}
    for form, factor, *bias in runs:
        key = f"{form}@{factor}" + (f"/{bias[0]}" if bias else "")
        for r, rec in enumerate(records):
            if rec[key]["launches"] != launches[form]:
                raise AssertionError(f"EP layer {key} rank {r}: launches "
                                     f"{rec[key]['launches']}")
            if not np.array_equal(arrays[r][f"{key}/y"], arrays[0][f"{key}/y"]):
                raise AssertionError(f"EP layer {key}: y differs on rank {r}")
        ms = [rec[key]["fwd_bwd_ms"] for rec in records]
        drop = float(arrays[0][f"{key}/drop_fraction"])
        line = (f"EP layer {key}: drop_fraction {drop:.6f}, balance_loss "
                f"{float(arrays[0][f'{key}/balance_loss']):.6f}, fwd+bwd per "
                f"rank {[round(v, 3) for v in ms]} ms {shared(card)}")
        if factor == 2.0:
            if drop != 0.0:
                raise AssertionError(f"EP layer {key}: drop_fraction {drop}")
            got = (torch.from_numpy(arrays[0][f"{key}/y"]),
                   torch.from_numpy(arrays[0][f"{key}/dx"]),
                   torch.from_numpy(np.concatenate(
                       [a[f"{key}/dw1"] for a in arrays])),
                   torch.from_numpy(np.concatenate(
                       [a[f"{key}/dw2"] for a in arrays])))
            err = [compare(f"EP layer {key} {w}", g.cuda(), v, (m,))
                   for w, g, v, m in zip(("y", "dx", "dW1", "dW2"), got, want,
                                         ("elem", "sum", "sum", "sum"))]
            line += ("; vs single-rank capacity_fused, max|d| / max|ref|: "
                     + ", ".join(f"{w} {e[0]:.3e}/{e[1]:.3e}" for w, e in
                                 zip(("y", "dx", "dW1", "dW2"), err)))
        if form == "fused":
            same = {}
            for k, ref in dropless.items():
                ref = ref.float().cpu().numpy()
                if k in ("dw1", "db1", "dw2", "db2"):  # each rank's experts
                    got_k = np.concatenate([a[f"{key}/{k}"] for a in arrays])
                else:
                    got_k = arrays[0][f"{key}/{k}"]
                same[k] = bool(np.array_equal(got_k.astype(np.float32), ref))
            line += (f"; the gathered dropless form vs the single-rank "
                     f"'fused' layer, bit-identical: {same}")
            if not all(same.values()):
                raise AssertionError(f"EP layer {key}: not bit-identical to "
                                     f"the single-rank 'fused' layer: {same}")
        log(line)
    a, b = (f"{f}@{CAP_FACTOR}/router_b_skewed" for f in ("a2a", "a2a_perm"))
    drop = float(arrays[0][f"{a}/drop_fraction"])
    if drop != float(arrays[0][f"{b}/drop_fraction"]) or not drop > 0.1:
        raise AssertionError(f"the a2a forms at {CAP_FACTOR}: drop_fraction "
                             f"{drop} vs {arrays[0][f'{b}/drop_fraction']}")
    err = compare("EP layer a2a forms", torch.from_numpy(arrays[0][f"{b}/y"]),
                  torch.from_numpy(arrays[0][f"{a}/y"]), ("elem",))
    same = all(np.array_equal(arrays[0][f"{a}/{k}"], arrays[0][f"{b}/{k}"])
               for k in ("y", "dx", "dw1", "dw2"))
    log(f"EP layer at {CAP_FACTOR}, router bias +{CAP_ROUTER_SKEW} on "
        f"experts 0-1: both a2a forms drop {drop:.6f} of the pairs; K10 vs "
        f"relayout y max|d| {err[0]:.3e}; y, dx, dW1, dW2 bit-identical: "
        f"{same}; peak memory "
        f"per rank {[rec['max_memory_allocated'] / 2**30 for rec in records]}"
        f" GiB")
    del x, params, y, want, xd, pd, yd, dropless
    torch.cuda.empty_cache()


def ep_train_check(card: str, tmp: str) -> dict:
    """cfg4's model step at ep=EP_RANKS, dp=1 (moe_small, capacity_fused_a2a
    at 1.25, B=128, EP_STEPS steps) in the relayout and the K10 form, and
    the relayout form on the batch reversed (the witness), with exact
    per-step launch counts on every rank; returns rank 0's K10 launches of
    the K10 form."""
    from slim_switch_moe_vit_tpu_torch.parallel import launch

    out = os.path.join(tmp, "ep_train")
    os.makedirs(out)
    forms = {"relayout": ({"SSMV_A2A_PERMUTED": "0"}, False),
             "K10": ({"SSMV_A2A_PERMUTED": "1"}, False),
             "witness": ({"SSMV_A2A_PERMUTED": "0"}, True)}
    kw = {"num_classes": 1000, "dispatch_mode": "capacity_fused_a2a",
          "capacity_factor": CAP_FACTOR}
    t0 = time.perf_counter()
    launch.spawn(launch.train_steps_worker, EP_RANKS,
                 (out, 1, EP_RANKS, MODEL, kw, TRAIN_B, EP_STEPS, forms,
                  "cuda"),
                 init_file=os.path.join(out, "store"), device="cuda",
                 env={"SSMV_DIST_BACKEND": "gloo"})
    _, records = _read_ranks(out, EP_RANKS)
    per = {"relayout": PER_TRAIN_STEP, "witness": PER_TRAIN_STEP,
           "K10": PER_EP_K10_STEP}
    for form in forms:
        want = {k: v for k, v in per[form].items() if v}
        for r, rec in enumerate(records):
            if any(c != want for c in rec[form]["launches"]):
                raise AssertionError(f"cfg4 ep={EP_RANKS} {form} rank {r}: "
                                     f"launches {rec[form]['launches']} != "
                                     f"{want} a step")
            if rec[form]["losses"] != records[0][form]["losses"]:
                raise AssertionError(f"{form}: rank {r}'s losses differ")
            if rec[form]["dense_digest"] != records[0][form]["dense_digest"]:
                raise AssertionError(f"{form}: rank {r}'s dense parameters "
                                     "differ")
        if not all(np.isfinite(records[0][form]["losses"])):
            raise AssertionError(f"cfg4 ep {form}: non-finite loss")
        log(f"cfg4 step at ep={EP_RANKS}, dp=1, B={TRAIN_B}, {form} form: "
            f"losses {records[0][form]['losses']}, ms per step (steps 2-"
            f"{EP_STEPS}) per rank "
            f"{[round(rec[form]['ms_per_step'], 1) for rec in records]}, "
            f"peak memory per rank "
            f"{[round(rec[form]['max_memory_allocated'] / 2**30, 2) for rec in records]}"
            f" GiB; launches per step exact, dense parameters bit-identical "
            f"over the ranks {shared(card)}")
    ref = records[0]["relayout"]["losses"]

    def gaps(a):
        return [abs(u - w) / abs(w) for u, w in zip(a, ref)]

    limit = [max(CAP_WITNESS * w, CAP_FLOOR)
             for w in gaps(records[0]["witness"]["losses"])]
    k10 = gaps(records[0]["K10"]["losses"])
    log(f"cfg4 ep={EP_RANKS} K10 form's losses vs the relayout form's, "
        f"relative per step: {k10}; limits {limit}; these steps took "
        f"{time.perf_counter() - t0:.1f} s {shared(card)}")
    if any(g > t for g, t in zip(k10, limit)):
        raise AssertionError("the K10 form's losses part from the relayout "
                             "form's beyond the limit")
    k10_counts = records[0]["K10"]["launches"]
    return {name: sum(c.get(name, 0) for c in k10_counts)
            for name in ("fused_expert_ffn_permuted",
                         "fused_expert_ffn_permuted_bwd")}


def ep_driver_check(card: str, tmp: str) -> None:
    """``python -m slim_switch_moe_vit_tpu_torch.main --expert-parallel 2
    --moe-dispatch capacity_fused_a2a`` with ``SSMV_A2A_PERMUTED=1`` on 4
    ranks (dp 2 x ep 2) sharing the card over gloo, at full width on SYNTH:
    1 task x 1 epoch x 3 steps, then ``--resume`` for one step of a second
    epoch. Every rank exits 0, the driver finds the dense parameters
    bit-identical over the 4 ranks after each epoch, and the checkpoint
    restores on a single rank to the same dense parameters."""
    import argparse

    import torch

    from slim_switch_moe_vit_tpu_torch import config, optim
    from slim_switch_moe_vit_tpu_torch import main as driver
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import restore_checkpoint

    out = os.path.join(tmp, "ep_driver")
    os.makedirs(out)
    ckpt = os.path.join(out, "checkpoint")
    digests = []
    for i, extra in enumerate(
            (["--epochs", "1"],
             ["--epochs", "2", "--max-steps-per-epoch", "1", "--resume",
              ckpt])):
        env = {**os.environ, "SSMV_DIST_BACKEND": "gloo",
               "SSMV_A2A_PERMUTED": "1", "WORLD_SIZE": "4",
               "LOCAL_WORLD_SIZE": "4"}
        store = os.path.join(out, f"store{i}")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "slim_switch_moe_vit_tpu_torch.main",
             *EP_DRIVER_ARGS, *extra, "--output_dir", out, "--dist_url",
             f"file://{store}"],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(4)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"EP driver run {i}: ranks {bad} failed:\n"
                                 + outs[bad[0]][-3000:])
        lines = [ln for ln in outs[0].splitlines()
                 if "bit-identical over 4 rank(s)" in ln]
        if not lines:
            raise AssertionError(f"EP driver run {i}: no replica check")
        digests.append(int(lines[-1].split()[-1]))
        losses = [ln for ln in outs[0].splitlines()
                  if "Averaged stats" in ln or "Training time" in ln]
        log(f"EP driver run {i} (dp 2 x ep 2, {' '.join(extra)}): every rank "
            f"exited 0 in {time.perf_counter() - t0:.1f} s; {lines[-1]}; "
            f"{'; '.join(losses)} {shared(card)}")
    # the checkpoint on a single rank: every expert, the same dense weights
    args = argparse.ArgumentParser(parents=[config.get_args_parser()]) \
        .parse_args(EP_DRIVER_ARGS)
    model = driver.build_model(args, 10, args.seed)
    opt_init, _ = optim.make_optimizer(weight_decay=args.weight_decay)
    state = create_train_state(model, device="cuda", opt_init=opt_init,
                               use_ema=True)
    state, epoch = restore_checkpoint(ckpt, state)
    if epoch != 1 or driver.dense_digest(model) != digests[-1]:
        raise AssertionError(f"the EP checkpoint restored on one rank: epoch "
                             f"{epoch}, dense digest "
                             f"{driver.dense_digest(model)} != {digests[-1]}")
    log(f"EP checkpoint (written by the {EP_RANKS} ranks sharing one card "
        f"over gloo) restored on a single rank: epoch {epoch}, "
        f"{model.blocks[1].mlp.w1.shape[0]} experts a block, dense digest "
        f"{digests[-1]} as on the 4 ranks")
    del model, state
    torch.cuda.empty_cache()


def ep_phase(results: dict, card: str, tmp: str) -> dict:
    """Phase 12: K10 against its plain version, one MoE layer on EP_RANKS
    ranks sharing the card in four forms, cfg4's step at ep=EP_RANKS in
    two forms, and the driver on dp 2 x ep 2; returns K10's launches."""
    t0 = time.perf_counter()
    ep_kernel_phase(results, card)
    log(f"[EP kernels: {time.perf_counter() - t0:.1f} s]")
    ep_layer_check(card, tmp)
    launched = ep_train_check(card, tmp)
    ep_driver_check(card, tmp)
    return launched


# ---------------------------------------------------------------------------
# coverage: f32, D = 768, N beyond the kernels' caps, K12, K13 (phases 13-17)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions():
    """Run the port's model code on its plain versions on the card: every
    binding of a forward kernel wrapper in the port's modules is replaced
    by its plain PyTorch version (differentiable through autograd) and
    restored afterwards. No kernel launches inside (checked by callers)."""
    from slim_switch_moe_vit_tpu_torch.ops import attention, fused_ffn
    from slim_switch_moe_vit_tpu_torch.ops import fused_ln as ln

    plain = {
        ln.fused_ln: lambda x, g, b, eps=1e-6: ln.reference_add_ln(
            x, None, g, b, eps)[1],
        ln.fused_add_ln: lambda x, r, g, b, eps=1e-6: ln.reference_add_ln(
            x, r, g, b, eps),
        ln.fused_sum_ln: lambda a, r, g, b, eps=1e-6: ln.reference_add_ln(
            a, r, g, b, eps)[1],
        attention.fused_mha: attention.fused_mha_reference,
        attention.flash_attention: attention.flash_attention_reference,
        fused_ffn.fused_expert_ffn: fused_ffn.fused_expert_ffn_reference,
    }
    saved = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("slim_switch_moe_vit_tpu_torch") or mod is None:
            continue
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in plain:
                saved.append((mod, attr, val))
                setattr(mod, attr, plain[val])
    try:
        yield
    finally:
        for mod, attr, val in saved:
            setattr(mod, attr, val)


@contextlib.contextmanager
def pinned_routing(routes: list, replay: bool):
    """Record every top-k gate's expert choices into ``routes`` (in call
    order), or with ``replay`` impose the recorded ones, the gate weights
    the softmax of this run's own logits at them. A bf16 run and the plain
    path in bf16 round differently, and with random weights a near tie
    among the router's logits then picks another expert pair for a token;
    pinned, a comparison of the two sees the arithmetic, not those flips.
    Yields ``moved``: on replay, the tokens gated and those whose imposed
    choice differs from the run's own top-k (``check_moved`` holds their
    share to near ties, ``ROUTE_MOVED_MAX``)."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import moe as moe_ops

    real = moe_ops.naive_topk_gate
    recorded = iter(list(routes))
    moved = {"tokens": 0, "moved": 0}

    def gate(logits, top_k):
        if not replay:
            weights, idx = real(logits, top_k)
            routes.append(idx)
            return weights, idx
        idx = next(recorded).to(logits.device)
        own = real(logits, top_k)[1]
        moved["tokens"] += idx.shape[0]
        moved["moved"] += int((own.sort(-1).values != idx.sort(-1).values)
                              .any(-1).sum())
        return torch.softmax(logits.float().gather(-1, idx), dim=-1), idx

    moe_ops.naive_topk_gate = gate
    try:
        yield moved
    finally:
        moe_ops.naive_topk_gate = real


def check_moved(moved: dict, what: str) -> str:
    """The share of gated tokens whose imposed expert choice differs from
    the plain run's own: at most ``ROUTE_MOVED_MAX`` (near ties only; a
    fault that moves routing broadly fails here). Returns it as text."""
    share = moved["moved"] / max(moved["tokens"], 1)
    if share > ROUTE_MOVED_MAX:
        raise AssertionError(f"{what}: {moved['moved']} of {moved['tokens']} "
                             f"gated tokens ({share:.4f}) chose other experts "
                             f"than the kernels' run (limit {ROUTE_MOVED_MAX})")
    return (f"imposed choices differing from the plain run's own "
            f"{moved['moved']}/{moved['tokens']} ({share:.4f}, limit "
            f"{ROUTE_MOVED_MAX})")


def _timed_case(results, name, kernel, plain, library, cost, modes, sfx,
                tol=None, reps=20, extra=None):
    """Hold ``kernel()`` against ``plain()`` (``compare``), time both (and
    ``library``, and each of ``extra``: {key: call}) and record them under
    ``<key><sfx>`` of ``results[name]``; returns the max |d|."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    err, peak, rel = compare(name, got, plain(), modes, tol)
    ms = median_ms(kernel, reps=reps)
    plain_ms = median_ms(plain, reps=3, warmup=1)
    lib_ms = median_ms(library) if library is not None else None
    bound_ms, bound_by = bound(*cost)
    # the JSON line's keys for a kernel no earlier phase recorded (a later
    # phase fills in its own)
    res = results.setdefault(name, {"max_abs_err": 0.0, "library_ms": None})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                "bound_ms" + sfx: bound_ms, "library_ms" + sfx: lib_ms})
    res.setdefault("bound_by" + sfx, bound_by)
    more = {k: median_ms(f) for k, f in (extra or {}).items()}
    res.update({k + sfx: v for k, v in more.items()})
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"kernel {name}{sfx}: max|d| {err:.3e}, max|ref| {peak:.3e}, "
        f"largest max|d|/max|ref| {rel:.2e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib}, bound {bound_ms:.4f} ms "
        f"({bound_by})" + "".join(f", {k} {v:.4f} ms"
                                  for k, v in more.items()))
    return err


def proj_case(results: dict, qkv, wp, bp, H: int, sfx: str) -> None:
    """K12 on (qkv, wp, bp) in bf16 against its plain version, beside SDPA +
    ``F.linear`` (its library call) and K5 + ``F.linear`` (``k5_gemm_ms``:
    the two launches K12 folds into one); then its mean |d| from the exact
    f32 function beside the plain version's (``exact_error``)."""
    import torch
    import torch.nn.functional as F

    from slim_switch_moe_vit_tpu_torch.ops import attention

    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // H
    scale = d ** -0.5
    w_lin, b_lin = wp.t().contiguous(), bp.to(torch.bfloat16)
    q4 = qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)

    def kernel():
        return attention.fused_mha_proj(qkv, wp, bp, H, scale)

    def plain():
        return attention.fused_mha_proj_reference(qkv, wp, bp, H, scale)

    _timed_case(
        results, "fused_mha_proj", kernel, plain,
        lambda: F.linear(F.scaled_dot_product_attention(
            q4[0], q4[1], q4[2], scale=scale).transpose(1, 2).reshape(
                B, N, C), w_lin, b_lin),
        ((B * N * 4 * C + C * C) * 2 + C * 4,
         4 * B * H * N * N * d + 2 * B * N * C * C, BF16_FLOPS),
        ("elem",), sfx,
        extra={"k5_gemm_ms": lambda: F.linear(
            attention.fused_mha(qkv, H, scale), w_lin, b_lin)})
    exact_error(f"fused_mha_proj{sfx}", kernel(), plain(),
                attention.fused_mha_proj_reference(qkv.float(), wp.float(),
                                                   bp, H, scale))


def proj_and_rows_kernel_phase(results: dict) -> None:
    """K12 at deit-tiny and ViT-S eval shapes against its plain version,
    beside K5 + the proj GEMM and SDPA + ``F.linear``; K13's gather and
    scatter-add on the flagship's dropless layout (T = 25,216 tokens,
    52,480 layout rows) against their plain versions (bit for bit) beside
    ``index_select`` and ``index_add_``, the scatter-add also in f32."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import gather, moe

    gen = torch.Generator().manual_seed(6)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    hd = 64
    for label, (B, N, H) in K12_SHAPES.items():
        C = H * hd
        proj_case(results, rnd(B, N, 3 * C), rnd(C, C, std=C ** -0.5),
                  rnd(C, std=0.1, dtype=torch.float32), H,
                  "" if label == "deit_tiny" else "_vit_s")

    T = TRAIN_B * N_TOK
    x = rnd(T, DIM)
    router_w = rnd(DIM, EXPERTS, std=DIM ** -0.5, dtype=torch.float32)
    gate_w, eidx = moe.naive_topk_gate(x.float() @ router_w, 2)
    gidx = moe.aligned_expert_layout(eidx, EXPERTS, gate_w=gate_w)[0]
    M = gidx.shape[0]
    log(f"K13 layout: T={T} tokens, {M} layout rows (the dropless B={TRAIN_B} "
        "layout)")
    g = rnd(M, DIM)
    # the layout's padding slots all name token 0, one row of ~2,000
    # sources; the same sizes with each row's sources spread evenly
    spread = torch.arange(M, device="cuda") % T
    log(f"K13 scatter: the busiest row takes "
        f"{int(torch.bincount(gidx, minlength=T).max())} sources")
    _timed_case(results, "gather_rows", lambda: gather.gather_rows(x, gidx),
                lambda: gather.reference_gather_rows(x, gidx),
                lambda: x.index_select(0, gidx),
                (2 * M * DIM * 2 + M * 8, 0, BF16_FLOPS), ("elem",), "",
                tol=(0.0, 0.0))
    zeros = torch.zeros(T, DIM, dtype=torch.bfloat16, device="cuda")
    _timed_case(results, "scatter_add_rows",
                lambda: gather.scatter_add_rows(g, gidx, T),
                lambda: gather.reference_scatter_add_rows(g, gidx, T),
                lambda: zeros.clone().index_add_(0, gidx, g),
                (M * DIM * 2 + M * 8 + T * DIM * 2, M * DIM, F32_FLOPS),
                ("elem",), "", tol=(0.0, 0.0),
                extra={"plan_ms": lambda: gather.scatter_plan(gidx, T),
                       "spread_idx_ms": lambda: gather.scatter_add_rows(
                           g, spread, T)})
    g32 = g.float()
    _timed_case(results, "scatter_add_rows",
                lambda: gather.scatter_add_rows(g32, gidx, T),
                lambda: gather.reference_scatter_add_rows(g32, gidx, T),
                lambda: zeros.float().index_add_(0, gidx, g32),
                (M * DIM * 4 + M * 8 + T * DIM * 4, M * DIM, F32_FLOPS),
                ("elem",), "_f32", tol=(0.0, 0.0))
    log("K13: the gather equals index_select and the scatter-add its "
        "index-order plain version bit for bit (bf16 and f32)")


def _ffn_family(results, label, dtype, T, D, H, E, peak, gen, only=None):
    """K3, K4, K8, K9 and K10 (or the kernels named in ``only``) on one
    routed layout of T tokens against their plain versions, timed beside
    their bounds, under ``_<label>``."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn
    from slim_switch_moe_vit_tpu_torch.ops import moe

    def rnd(*shape, std=1.0, dt=dtype):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dt)

    x = rnd(T, D)
    router_w = rnd(D, E, std=D ** -0.5, dt=torch.float32)
    gate_w, eidx = moe.naive_topk_gate(x.float() @ router_w, 2)
    gidx, pslot, eot, w_slot, keep = moe.aligned_expert_layout(
        eidx, E, gate_w=gate_w)
    xs = moe.dispatch_gather(x, gidx, pslot)
    w1, b1 = rnd(E, D, H, std=D ** -0.5), rnd(E, H, std=0.1, dt=torch.float32)
    w2, b2 = rnd(E, H, D, std=H ** -0.5), rnd(E, D, std=0.1, dt=torch.float32)
    dy = rnd(*xs.shape) * w_slot[:, None].to(dtype)
    perm = torch.arange(eot.shape[0], dtype=torch.int32,
                        device="cuda").flip(0)
    Tp, item = xs.shape[0], xs.element_size()
    w_bytes = 2 * E * D * H * item
    fwd_cost = (2 * Tp * D * item + w_bytes, 4 * Tp * D * H, peak)
    bwd_cost = (3 * Tp * D * item + 2 * w_bytes + E * (H + D) * 4,
                10 * Tp * D * H, peak)
    log(f"expert layout {label}: {str(dtype)[6:]}, T={T}, D={D}, H={H}, "
        f"E={E}, Tp={Tp} ({Tp // 256} tiles)")
    sums = ("elem", "sum", "sum", "sum", "sum")
    tol = F32_TOL if dtype == torch.float32 else None
    modes = (("elem",) * 5 if dtype == torch.float32 else sums)
    bwd = (xs, w1, b1, w2, eot, dy)
    cases = {
        "fused_expert_ffn": (
            lambda: ffn.fused_expert_ffn(xs, w1, b1, w2, b2, eot),
            lambda: ffn.fused_expert_ffn_reference(xs, w1, b1, w2, b2, eot),
            fwd_cost, ("elem",)),
        "fused_expert_ffn_bwd": (
            lambda: ffn.fused_expert_ffn_bwd(*bwd),
            lambda: ffn.reference_expert_ffn_bwd(*bwd), bwd_cost, modes),
        "fused_expert_ffn_bwd_defer": (
            lambda: ffn.fused_expert_ffn_bwd_defer(*bwd),
            lambda: ffn.reference_expert_ffn_bwd_defer(*bwd), bwd_cost,
            modes),
        "fused_expert_ffn_gather": (
            lambda: ffn.fused_expert_ffn_gather(x, gidx, pslot, None, w1, b1,
                                                w2, b2, eot),
            lambda: ffn.fused_expert_ffn_reference(x.index_select(0, gidx),
                                                   w1, b1, w2, b2, eot),
            fwd_cost, ("elem",)),
        "fused_expert_ffn_gather_bwd": (
            lambda: ffn.fused_expert_ffn_gather_bwd(x, gidx, w1, b1, w2, eot,
                                                    dy),
            lambda: ffn.reference_expert_ffn_bwd(x.index_select(0, gidx), w1,
                                                 b1, w2, eot, dy),
            bwd_cost, modes),
        "fused_expert_ffn_permuted": (
            lambda: ffn.fused_expert_ffn_permuted(xs, w1, b1, w2, b2, eot,
                                                  perm),
            lambda: ffn.reference_expert_ffn_permuted(xs, w1, b1, w2, b2, eot,
                                                      perm),
            fwd_cost, ("elem",)),
        "fused_expert_ffn_permuted_bwd": (
            lambda: ffn.fused_expert_ffn_permuted_bwd(xs, w1, b1, w2, eot,
                                                      perm, dy),
            lambda: ffn.reference_expert_ffn_bwd_permuted(xs, w1, b1, w2, eot,
                                                          perm, dy),
            bwd_cost, modes),
    }
    if only is not None:
        cases = {k: v for k, v in cases.items() if k in only}
    for name, (kernel, plain, cost, mode) in cases.items():
        _timed_case(results, name, kernel, plain, None, cost, mode,
                    "_" + label, tol=tol, reps=5)
    if dtype == torch.bfloat16:
        if "fused_expert_ffn" in cases:
            exact_ffn_fwd(f"fused_expert_ffn_{label}",
                          cases["fused_expert_ffn"][0](),
                          cases["fused_expert_ffn"][1](),
                          (xs, w1, b1, w2, b2, eot))
        exact_ffn_bwd(f"fused_expert_ffn_bwd_{label}",
                      cases["fused_expert_ffn_bwd"][0](),
                      cases["fused_expert_ffn_bwd"][1](), bwd)
        k8, k8_plain = cases["fused_expert_ffn_bwd_defer"][:2]
        check_defer(results["fused_expert_ffn_bwd_defer"], label,
                    "_" + label, k8, k8(), k8_plain(), bwd)


# the LayerNorm backward's coverage: (dtype, D) at LN_COV_ROWS rows, which
# no ring stage of 8, 16 or 32 rows divides; D = 100 takes the kernel's
# scalar form (its rows are not a multiple of 16 bytes), 1,280 is
# vit_huge's width
LN_COV_ROWS = 6301
LN_COV = (("bf16", 192), ("bf16", 768), ("bf16", 1280), ("bf16", 100),
          ("f32", 384), ("f32", 100))


def ln_bwd_coverage(results: dict, gen) -> None:
    """K1c's two forms and K2b at each of LN_COV against their plain
    versions (bf16 to the kernel limits, f32 to F32_TOL), timed beside
    their bounds under ``*_<dtype>_d<D>``."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import fused_ln as ln

    for dt, D in LN_COV:
        dtype, item = ((torch.bfloat16, 2) if dt == "bf16"
                       else (torch.float32, 4))
        a, b, dy, du = (torch.randn(LN_COV_ROWS, D, generator=gen).to(
            "cuda", dtype) for _ in range(4))
        g = (torch.randn(D, generator=gen) * 0.1 + 1.0).cuda()
        n = LN_COV_ROWS * D
        cost = lambda streams: (streams * n * item + 2 * D * 4, 10 * n,  # noqa: E731
                                F32_FLOPS)
        tol = None if dt == "bf16" else F32_TOL
        modes = ("elem", "sum", "sum")
        sfx = f"_{dt}_d{D}"
        _timed_case(results, "fused_ln_bwd", lambda: ln.fused_ln_bwd(a, dy, g),
                    lambda: ln.reference_ln_bwd(a, dy, None, g), None, cost(3),
                    modes, sfx, tol=tol, reps=5)
        _timed_case(results, "fused_add_ln_bwd",
                    lambda: ln.fused_add_ln_bwd(a, dy, du, g),
                    lambda: ln.reference_ln_bwd(a, dy, du, g), None, cost(4),
                    modes, sfx, tol=tol, reps=5)
        _timed_case(results, "fused_sum_ln_bwd",
                    lambda: ln.fused_sum_ln_bwd(a, b, dy, g),
                    lambda: ln.reference_ln_bwd(a + b, dy, None, g), None,
                    cost(4), modes, sfx, tol=tol, reps=5)
        del a, b, dy, du
    torch.cuda.empty_cache()


def coverage_kernel_phase(results: dict) -> None:
    """Phase 13: K12 and K13 (``proj_and_rows_kernel_phase``); the LayerNorm
    backward at other widths, an odd width and f32 (``ln_bwd_coverage``);
    the expert
    family at D = 768 in bf16 (moe_base_patch16_224_expert32's layout at
    B = 32) and in f32 at D = 384 (the flagship's at B = 32), K4 and K8 at
    D = 192 (moe_tiny_patch16_224_expert8's at B = 128); K6 in f32 at
    N = 197 against the exact-f32 plain backward and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from slim_switch_moe_vit_tpu_torch.ops import attention

    proj_and_rows_kernel_phase(results)
    gen = torch.Generator().manual_seed(7)
    ln_bwd_coverage(results, gen)
    _ffn_family(results, "d768", torch.bfloat16, WIDE_B * N_TOK, WIDE_D,
                WIDE_H, WIDE_E, BF16_FLOPS, gen)
    torch.cuda.empty_cache()
    _ffn_family(results, "d192", torch.bfloat16, TINY_B * N_TOK, TINY_D,
                TINY_H, TINY_E, BF16_FLOPS, gen,
                only=("fused_expert_ffn_bwd", "fused_expert_ffn_bwd_defer"))
    torch.cuda.empty_cache()
    _ffn_family(results, "f32", torch.float32, 32 * N_TOK, DIM, HIDDEN,
                EXPERTS, F32_FLOPS, gen)
    torch.cuda.empty_cache()
    B, hd = 32, DIM // HEADS
    qkv = torch.randn(B, N_TOK, 3 * DIM, generator=gen).cuda()
    do = torch.randn(B, N_TOK, DIM, generator=gen).cuda()
    leaf = qkv.detach().requires_grad_()
    q4 = leaf.view(B, N_TOK, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    sdpa = F.scaled_dot_product_attention(q4[0], q4[1], q4[2],
                                          scale=hd ** -0.5)
    do4 = do.view(B, N_TOK, HEADS, hd).transpose(1, 2)
    n = B * N_TOK * DIM
    _timed_case(results, "fused_mha_bwd",
                lambda: attention.fused_mha_bwd(qkv, do, HEADS, hd ** -0.5),
                lambda: attention.reference_mha_bwd(qkv, do, HEADS,
                                                    hd ** -0.5),
                lambda: torch.autograd.grad(sdpa, leaf, do4,
                                            retain_graph=True),
                (7 * n * 4, 10 * B * HEADS * N_TOK * N_TOK * hd, F32_FLOPS),
                ("elem",), "_f32", tol=F32_TOL)
    long_attention_cases(results, gen)
    head_and_k12_cases(results, gen)


def _mha_calls(name: str, qkv, do, H: int, d: int, peak: float) -> tuple:
    """(kernel, plain, library, cost) of K5 (``fused_mha``), K6
    (``fused_mha_bwd``) or K11 (``flash_attention``) on qkv (B, N, 3 H d)
    and do, beside SDPA forward or backward."""
    import torch
    import torch.nn.functional as F

    from slim_switch_moe_vit_tpu_torch.ops import attention

    B, N, _ = qkv.shape
    scale = d ** -0.5
    leaf = qkv.detach().requires_grad_()
    q4 = leaf.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    n, prod = B * N * H * d, 2 * B * H * N * N * d
    item = qkv.element_size()
    if name == "fused_mha_bwd":
        sdpa = F.scaled_dot_product_attention(q4[0], q4[1], q4[2],
                                              scale=scale)
        do4 = do.view(B, N, H, d).transpose(1, 2)
        return (lambda: attention.fused_mha_bwd(qkv, do, H, scale),
                lambda: attention.reference_mha_bwd(qkv, do, H, scale),
                lambda: torch.autograd.grad(sdpa, leaf, do4,
                                            retain_graph=True),
                (7 * n * item, 5 * prod, peak))
    fn, plain = ((attention.fused_mha, attention.fused_mha_reference)
                 if name == "fused_mha" else
                 (attention.flash_attention,
                  attention.flash_attention_reference))
    q4 = q4.detach()
    return (lambda: fn(qkv, H, scale), lambda: plain(qkv, H, scale),
            lambda: F.scaled_dot_product_attention(q4[0], q4[1], q4[2],
                                                   scale=scale),
            (4 * n * item, 2 * prod, peak))


def long_attention_cases(results: dict, gen) -> None:
    """K5 and K6 at N = 577 (the flagship at 384 px): K5 at phase 16's eval
    shape (B = 8) and K6 at its step's (B = 4) in bf16, and both at B = 4
    in f32, against their plain versions, beside SDPA forward and
    backward."""
    import torch

    N, hd = 577, DIM // HEADS
    for dt, B_fwd, B_bwd, sfx, peak, tol in (
            (torch.bfloat16, LONG_EVAL_B, LONG_TRAIN_B, "_n577", BF16_FLOPS,
             None),
            (torch.float32, LONG_TRAIN_B, LONG_TRAIN_B, "_n577_f32",
             F32_FLOPS, F32_TOL)):
        for name, B in (("fused_mha", B_fwd), ("fused_mha_bwd", B_bwd)):
            qkv = torch.randn(B, N, 3 * DIM, generator=gen).to("cuda", dt)
            do = torch.randn(B, N, DIM, generator=gen).to("cuda", dt)
            _timed_case(results, name, *_mha_calls(name, qkv, do, HEADS, hd,
                                                   peak),
                        ("elem",), sfx, tol=tol)
            del qkv, do
    torch.cuda.empty_cache()


def head_and_k12_cases(results: dict, gen) -> None:
    """K5, K6 and K11 at vit_huge_patch14_224's head (HUGE: 16 heads of 80,
    N = 257) in bf16 (``_d80``); K11 in f32 at the flagship's shape at
    B = 32 (``_f32``); K12 at N = 577 and C = 1024 (K12_LONG: 16 heads of
    64, ``_n577_c1024``, ``proj_case``): each against its plain version."""
    import torch

    B, N, H, d = HUGE
    qkv = torch.randn(B, N, 3 * H * d, generator=gen).to("cuda",
                                                          torch.bfloat16)
    do = torch.randn(B, N, H * d, generator=gen).to("cuda", torch.bfloat16)
    for name in ("fused_mha", "fused_mha_bwd", "flash_attention"):
        _timed_case(results, name, *_mha_calls(name, qkv, do, H, d,
                                               BF16_FLOPS),
                    ("elem",), "_d80")
    qkv = torch.randn(32, N_TOK, 3 * DIM, generator=gen).cuda()
    _timed_case(results, "flash_attention",
                *_mha_calls("flash_attention", qkv, None, HEADS,
                            DIM // HEADS, F32_FLOPS),
                ("elem",), "_f32", tol=F32_TOL)
    B, N, H, d = K12_LONG
    C = H * d
    proj_case(results,
              torch.randn(B, N, 3 * C, generator=gen).to("cuda",
                                                         torch.bfloat16),
              (torch.randn(C, C, generator=gen) * C ** -0.5).to(
                  "cuda", torch.bfloat16),
              (torch.randn(C, generator=gen) * 0.1).cuda(), H, "_n577_c1024")
    del qkv, do
    torch.cuda.empty_cache()


def op_path_launches() -> dict:
    """The ops no model path calls (as in the JAX package), driven as a
    user calls them: K12 on a deit-tiny eval batch, and a row gather of
    the flagship layout with its backward (the scatter-add) and a
    scatter-add with its backward (the gather). Returns their launches."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops

    gen = torch.Generator().manual_seed(8)
    B, N, H = K12_SHAPES["deit_tiny"]
    C = 64 * H
    qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda", torch.bfloat16)
    wp = (torch.randn(C, C, generator=gen) * C ** -0.5).cuda()
    bp = torch.zeros(C, device="cuda")
    x = torch.randn(TRAIN_B * N_TOK, DIM, generator=gen).to(
        "cuda", torch.bfloat16).requires_grad_()
    idx = torch.randint(0, x.shape[0], (2 * x.shape[0],), generator=gen).cuda()
    ops.reset_launch_counts()
    y = ops.fused_mha_proj(qkv, wp, bp, H, 64 ** -0.5)
    rows = ops.gather_rows(x, idx)
    rows.float().sum().backward()
    back = ops.scatter_add_rows(rows.detach().requires_grad_(), idx,
                                x.shape[0])
    back.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if not (torch.isfinite(y.float()).all() and torch.isfinite(
            x.grad.float()).all()):
        raise AssertionError("the op path's outputs are not finite")
    want = {"fused_mha_proj": 1, "gather_rows": 2, "scatter_add_rows": 2}
    if counts != expected(want, 1):
        raise AssertionError(f"op path launches {counts} != {want}")
    log(f"op path (K12 on a deit-tiny eval batch, K13 gather and scatter-add "
        f"with their backwards): launches {want}")
    return {k: counts[k] for k in want}


def _xcheck(got, ref, what: str) -> None:
    """Logits against a plain path's: the serving limit (XCHECK_REL of max
    |ref|, cosine >= XCHECK_COS, the decisive top-1 equal)."""
    d = np.abs(got - ref)
    tol = XCHECK_REL * np.abs(ref).max()
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(
        ref, axis=1)
    top2 = np.sort(ref, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 2 * d.max()
    agree = got.argmax(1) == ref.argmax(1)
    log(f"{what}, {len(got)} images: max |d| {d.max():.4e} (tol "
        f"{tol:.4e}), max |ref| {np.abs(ref).max():.4e}, min cosine "
        f"{cos.min():.6f}, top-1 agree {int(agree.sum())}/{len(got)} "
        f"({int(decisive.sum())} decisive, all must agree)")
    if (not np.isfinite(got).all() or d.max() > tol or cos.min() < XCHECK_COS
            or not agree[decisive].all()):
        raise AssertionError(f"{what}: the logits disagree")


def _eval_vs_plain(model, model_f32, x, what: str) -> None:
    """The kernels' eval logits against the card's plain path within the
    serving limit (``_xcheck``): in f32, and in bf16 with the kernels' run's
    expert choices imposed on the plain run (``pinned_routing``)."""
    import torch

    routes: list = []
    with torch.no_grad(), pinned_routing(routes, replay=False):
        got = model(x).float().cpu().numpy()
    with torch.no_grad():
        got32 = model_f32(x).float().cpu().numpy()
    _xcheck(got32, _plain_logits(model_f32, x),
            what + ", f32, vs the card's plain path")
    with pinned_routing(routes, replay=True) as moved:
        plain = _plain_logits(model, x)
    _xcheck(got, plain, what + ", bf16, vs the card's plain path (the "
            "kernels' expert choices on both; "
            + check_moved(moved, what) + ")")


def _model_on_card(name: str, **kw):
    """A registered model built on the card, its weights drawn there from a
    seed-0 CUDA generator (a CPU draw of a billion weights takes long)."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model

    with torch.device("cuda"):
        return create_model(name, generator=torch.Generator(
            "cuda").manual_seed(0), **kw)


def _plain_logits(model, x):
    """Eval logits on the plain versions, with no kernel launched."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops

    ops.reset_launch_counts()
    with plain_versions(), torch.no_grad():
        out = model(x).float().cpu().numpy()
    if any(ops.launch_counts().values()):
        raise AssertionError(f"plain path launched {ops.launch_counts()}")
    return out


def wide_phase(card: str) -> None:
    """Phase 14, D = 768: the gated ResMoE ViT-B (resmoe_base, 8 experts)
    trains WIDE_STEPS steps at B = 32 on the kernels (exact launch counts,
    finite losses); moe_base_patch16_224_expert32 evaluates B = 32 images
    on the kernels, held to the card's plain path within the serving
    limit."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops
    from slim_switch_moe_vit_tpu_torch.models import vit

    model = _model_on_card(RESMOE_BASE, num_classes=1000,
                           dtype=torch.bfloat16)
    _, state, step = _train_setup(torch.bfloat16, "cuda", model)
    x, y = _batch(WIDE_B, 0, "cuda")
    ops.reset_launch_counts()
    vit.ROUTE_COUNTS.clear()
    losses_ = []
    t0 = time.perf_counter()
    for _ in range(WIDE_STEPS):
        state, m = step(state, x, y, LR, LR)
        losses_.append(m["loss"].item())
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if (counts != expected(PER_RESMOE_BASE_STEP, WIDE_STEPS)
            or dict(vit.ROUTE_COUNTS) != {"k5_k6": 12 * WIDE_STEPS}
            or not all(np.isfinite(losses_))):
        raise AssertionError(f"{RESMOE_BASE}: launches {counts}, routes "
                             f"{dict(vit.ROUTE_COUNTS)}, losses {losses_}")
    log(f"{RESMOE_BASE} (D=768) train B={WIDE_B}: losses "
        f"{[round(v, 4) for v in losses_]}, {wall / WIDE_STEPS:.3f} s a step "
        f"(host clock), launches per step exact {PER_RESMOE_BASE_STEP}, "
        f"routes {dict(vit.ROUTE_COUNTS)}; card {card}")
    del model, state, step
    torch.cuda.empty_cache()

    model, model_f32 = (
        _model_on_card(WIDE_MODEL, num_classes=1000, dtype=dt).eval()
        for dt in (torch.bfloat16, torch.float32))
    images = torch.from_numpy(np.random.RandomState(9).randn(
        WIDE_B, 224, 224, 3).astype(np.float32)).cuda()
    ops.reset_launch_counts()
    with torch.no_grad():
        model(images)
    counts = ops.launch_counts()
    if counts != expected(PER_FORWARD, 1):
        raise AssertionError(f"{WIDE_MODEL} eval launches {counts}")
    _eval_vs_plain(model, model_f32, images,
                   f"{WIDE_MODEL} (D=768, 32 experts) eval B={WIDE_B}")
    del model, model_f32
    torch.cuda.empty_cache()


def f32_phase(card: str) -> None:
    """Phase 15: the flagship in f32 trains F32_STEPS steps at B = F32_B on
    the kernels (exact launch counts), against the same steps from the same
    weights on the plain versions and, as the witness of f32 summation
    order alone, the plain steps on the batch reversed."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, ops

    runs = {}
    base = create_model(MODEL, num_classes=1000, dtype=torch.float32)
    for label, rev in (("kernels", False), ("plain", False),
                       ("plain reversed", True)):
        model = copy.deepcopy(base)
        _, state, step = _train_setup(torch.float32, "cuda", model)
        x, y = _batch(F32_B, 3, "cuda")
        if rev:
            x, y = x.flip(0), y.flip(0)
        losses_, grads = [], None
        ops.reset_launch_counts()
        ctx = plain_versions() if label != "kernels" else contextlib.nullcontext()
        with ctx:
            for _ in range(F32_STEPS):
                state, m = step(state, x, y, XTRAIN_LR, XTRAIN_LR)
                losses_.append(m["loss"].item())
                if grads is None:
                    grads = torch.cat([p.grad.detach().flatten()
                                       for p in model.parameters()])
        counts = ops.launch_counts()
        want = (expected(PER_TRAIN_STEP, F32_STEPS) if label == "kernels"
                else expected({}, 1))
        if counts != want:
            raise AssertionError(f"f32 {label}: launches {counts} != {want}")
        runs[label] = (losses_, grads.cpu())
        log(f"f32 {MODEL} B={F32_B}, {label}: losses "
            f"{[float(f'{v:.7f}') for v in losses_]}")
        del model, state, step
    (lk, gk), (lp, gp), (lr, _) = runs.values()
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    wit = [abs(a - b) / abs(b) for a, b in zip(lr, lp)]
    cos = _cos(gk, gp)
    log(f"f32 training, kernels vs plain: loss rel diff per step "
        f"{[float(f'{v:.3e}') for v in rel]} (witness "
        f"{[float(f'{v:.3e}') for v in wit]}; limit {F32_WITNESS} x witness "
        f"or {F32_FLOOR}), step-1 gradient cosine {cos:.8f} (limit "
        f"{F32_COS}); card {card}")
    if (any(r > max(F32_WITNESS * w, F32_FLOOR) for r, w in zip(rel, wit))
            or cos < F32_COS):
        raise AssertionError("f32 training on the kernels disagrees with the "
                             "plain path")
    torch.cuda.empty_cache()


def long_phase(card: str) -> None:
    """Phase 16, N = 577: the flagship at 384 px. An eval at B = 8 and one
    train step at B = 4, on K5 and K5 + K6 with the
    rest of the kernels; each held to the card's plain path with the
    kernels' expert choices imposed on it (``_eval_vs_plain``; the step's
    loss and gradient within XTRAIN's first-step limits)."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, ops
    from slim_switch_moe_vit_tpu_torch.models import vit

    base = create_model(MODEL, num_classes=1000, img_size=LONG_IMG,
                        dtype=torch.bfloat16)
    model = copy.deepcopy(base).cuda().eval()
    rs = np.random.RandomState(10)
    images = torch.from_numpy(rs.randn(LONG_EVAL_B, LONG_IMG, LONG_IMG,
                                       3).astype(np.float32)).cuda()
    ops.reset_launch_counts()
    vit.ROUTE_COUNTS.clear()
    with torch.no_grad():
        model(images)
    counts, routes = ops.launch_counts(), dict(vit.ROUTE_COUNTS)
    if counts != expected(PER_FORWARD, 1) or routes != {"k5": 12}:
        raise AssertionError(f"N=577 eval: launches {counts}, routes {routes}")
    base32 = create_model(MODEL, num_classes=1000, img_size=LONG_IMG,
                          dtype=torch.float32)
    base32.load_state_dict(base.state_dict())
    _eval_vs_plain(model, base32.cuda().eval(), images,
                   f"{MODEL} at {LONG_IMG} px (N=577) eval B={LONG_EVAL_B}, "
                   f"bf16 routes {routes}")
    runs, routes = {}, []
    x = torch.from_numpy(rs.randn(LONG_TRAIN_B, LONG_IMG, LONG_IMG,
                                  3).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.randint(0, 1000, LONG_TRAIN_B)).cuda()
    for label in ("kernels", "plain"):
        m = copy.deepcopy(base)
        _, state, step = _train_setup(torch.bfloat16, "cuda", m)
        ops.reset_launch_counts()
        vit.ROUTE_COUNTS.clear()
        plain = label == "plain"
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx, pinned_routing(routes, replay=plain) as moved:
            state, met = step(state, x, y, XTRAIN_LR, XTRAIN_LR)
        runs[label] = (met["loss"].item(), torch.cat(
            [p.grad.detach().float().flatten() for p in m.parameters()]))
        counts, routes_taken = ops.launch_counts(), dict(vit.ROUTE_COUNTS)
        if not plain:
            if (counts != expected(PER_TRAIN_STEP, 1)
                    or routes_taken != {"k5_k6": 12}):
                raise AssertionError(f"N=577 train step: launches {counts}, "
                                     f"routes {routes_taken}")
            launched = {k: v for k, v in counts.items() if v}
            log(f"N=577 train step B={LONG_TRAIN_B}: routes {routes_taken}, "
                f"launches {launched}")
        elif any(counts.values()):
            raise AssertionError(f"plain path launched {counts}")
        else:
            moved_txt = check_moved(moved, "N=577 train step")
        del m, state, step
    (lk, gk), (lp, gp) = runs["kernels"], runs["plain"]
    rel, cos = abs(lk - lp) / abs(lp), _cos(gk, gp)
    lim = XTRAIN_PAIRS[0][2]
    log(f"N=577 train step, kernels vs the card's plain path (the kernels' "
        f"expert choices on both; {moved_txt}): loss {lk:.5f} vs {lp:.5f} "
        f"(rel {rel:.3e}, limit {lim[0][0]}), gradient cosine {cos:.6f} "
        f"(limit {lim[1]}); card {card}")
    if rel > lim[0][0] or cos < lim[1]:
        raise AssertionError("N=577 train step disagrees with the plain path")
    del model, base, base32
    torch.cuda.empty_cache()


def _counted(fn, per: dict, n: int, routes: dict, what: str):
    """Run ``fn`` with the launch and route counters zeroed; they must read
    ``n`` times ``per`` and exactly ``routes``."""
    from slim_switch_moe_vit_tpu_torch import ops
    from slim_switch_moe_vit_tpu_torch.models import vit

    ops.reset_launch_counts()
    vit.ROUTE_COUNTS.clear()
    out = fn()
    counts, taken = ops.launch_counts(), dict(vit.ROUTE_COUNTS)
    if counts != expected(per, n) or taken != routes:
        raise AssertionError(f"{what}: launches {counts}, routes {taken}")
    log(f"{what}: launches exact ({n} x {per}), routes {taken}")
    return out


def _kernel_ms(by_name: dict) -> float:
    return sum(us for us, _ in by_name.values()) / 1e3


def _deit_training(model, seed: int):
    """A train state and step with the driver's defaults: AdamW wd 0.05,
    EMA, RandAugment + color jitter + erasing, mixup / cutmix with
    smoothing 0.1 and the soft-target loss."""
    from slim_switch_moe_vit_tpu_torch import losses, optim
    from slim_switch_moe_vit_tpu_torch.data import (build_device_augment,
                                                    make_mixup_fn)
    from slim_switch_moe_vit_tpu_torch.engine import make_train_step
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cuda", seed=seed,
                               opt_init=opt_init, use_ema=True)
    augment = build_device_augment(input_size=224, **DEIT_AUG)
    mixup_fn = make_mixup_fn(num_classes=1000, **DEIT_MIX)
    step = make_train_step(model, opt_update,
                           losses.make_base_criterion(True, 0.1, False),
                           ema_decay=EMA_DECAY, augment_fn=augment,
                           mixup_fn=mixup_fn)
    return state, step, augment, mixup_fn


def _u8_batch(B: int, seed: int):
    import torch

    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (B, 224, 224, 3)).astype(np.uint8)
    y = rs.randint(0, 1000, B)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def cfg1_eval(card: str) -> None:
    """(a) cfg1: deit_tiny_patch16_224 eval at B = 256 in bf16 on the
    kernels, held to the card's plain path; images/s by events and the
    kernel sum of one profiled forward."""
    import torch

    model, model_f32 = (
        _model_on_card(DEIT_TINY, num_classes=1000, dtype=dt).eval()
        for dt in (torch.bfloat16, torch.float32))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        CFG1_B, 224, 224, 3).astype(np.float32)).cuda()
    xb = x.bfloat16()  # bench.py's cfg1 input: the model's compute dtype

    def forward():
        with torch.inference_mode():
            return model(xb)

    logits = _counted(forward, PER_DEIT_FORWARD, 1, {"k5": 12},
                      f"cfg1 {DEIT_TINY} eval B={CFG1_B}")
    if logits.shape != (CFG1_B, 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"cfg1 logits {tuple(logits.shape)}")
    _eval_vs_plain(model, model_f32, x, f"cfg1 {DEIT_TINY} eval B={CFG1_B}")
    ms = median_ms(forward, reps=10)
    by_name = profile_call(forward, f"cfg1 {DEIT_TINY} eval B={CFG1_B}")
    log(f"cfg1 {DEIT_TINY} eval B={CFG1_B}: {ms:.3f} ms a forward on the "
        f"device clock ({CFG1_B / ms * 1e3:.1f} images/s), kernel sum "
        f"{_kernel_ms(by_name):.3f} ms; card {card}")
    del model, model_f32
    torch.cuda.empty_cache()


def deit_base_training(card: str) -> None:
    """(b) deit_base_patch16_224, the driver's default model at full width:
    one step on the kernels against the same step on the plain versions
    (the same generator seed, so the same augmented and mixed batch), then
    DEIT_STEPS steps at B = 128 with exact launch counts, the step by
    events and by its kernel sum, and the augmentation and mixup alone."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops

    base = _model_on_card(DEIT_BASE, num_classes=1000, dtype=torch.bfloat16,
                          drop_path_rate=0.1)
    x, y = _u8_batch(DEIT_B, 12)
    runs = {}
    for label in ("kernels", "plain"):
        m = copy.deepcopy(base)
        state, step, _, _ = _deit_training(m, seed=7)
        ops.reset_launch_counts()
        ctx = plain_versions() if label == "plain" else contextlib.nullcontext()
        with ctx:
            state, met = step(state, x, y, XTRAIN_LR, XTRAIN_LR)
        counts = ops.launch_counts()
        want = (expected(PER_DEIT_STEP, 1) if label == "kernels"
                else expected({}, 1))
        if counts != want:
            raise AssertionError(f"{DEIT_BASE} {label} step: launches {counts}")
        runs[label] = (met["loss"].item(), torch.cat(
            [p.grad.detach().float().flatten() for p in m.parameters()]))
        del m, state, step
    (lk, gk), (lp, gp) = runs["kernels"], runs["plain"]
    rel, lim = abs(lk - lp) / abs(lp), XTRAIN_PAIRS[0][2][0][0]
    log(f"{DEIT_BASE} B={DEIT_B} step 1 at the driver's augmentation and "
        f"mixup, kernels vs the card's plain path from one seed: loss "
        f"{lk:.5f} vs {lp:.5f} (rel {rel:.3e}, limit {lim}), gradient "
        f"cosine {_cos(gk, gp):.6f}; card {card}")
    if rel > lim or not np.isfinite(lk):
        raise AssertionError(f"{DEIT_BASE} step on the kernels disagrees with "
                             "the plain path")
    del runs, gk, gp

    model = base
    state, step, augment, mixup_fn = _deit_training(model, seed=0)
    state, m = step(state, x, y, LR, LR)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses_ = []

    def steps():
        nonlocal state
        start.record()
        for _ in range(DEIT_STEPS):
            state, met = step(state, x, y, LR, LR)
            losses_.append(met["loss"])
        end.record()
        end.synchronize()

    _counted(steps, PER_DEIT_STEP, DEIT_STEPS, {"k5_k6": 12 * DEIT_STEPS},
             f"{DEIT_BASE} train, {DEIT_STEPS} steps B={DEIT_B}")
    losses_ = torch.stack(losses_).tolist()
    if not all(np.isfinite(losses_)):
        raise AssertionError(f"{DEIT_BASE}: non-finite losses {losses_}")
    step_ms = start.elapsed_time(end) / DEIT_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_name = profile_call(lambda: step(state, x, y, LR, LR),
                           f"one {DEIT_BASE} train step B={DEIT_B}")
    gen = torch.Generator("cuda").manual_seed(3)
    aug_ms = median_ms(lambda: augment(gen, x), reps=10)
    xa = augment(gen, x)
    mix_ms = median_ms(lambda: mixup_fn(gen, xa, y), reps=10)
    both_ms = median_ms(lambda: mixup_fn(gen, augment(gen, x), y), reps=10)
    log(f"{DEIT_BASE} train B={DEIT_B} (drop path 0.1, RandAugment "
        f"rand-m9-mstd0.5-inc1, color jitter 0.3, erasing 0.25, mixup 0.8 / "
        f"cutmix 1.0, smoothing 0.1, AdamW + EMA): losses "
        f"{[round(v, 4) for v in losses_]}, {step_ms:.3f} ms a step on the "
        f"device clock ({DEIT_B / step_ms * 1e3:.1f} images/s), kernel sum "
        f"{_kernel_ms(by_name):.3f} ms, peak memory allocated {peak:.2f} "
        f"GiB; augmentation + mixup alone {both_ms:.3f} ms (augmentation "
        f"{aug_ms:.3f}, mixup {mix_ms:.3f}) = {both_ms / step_ms:.3f} of the "
        f"step; card {card}")
    del model, base, state, step
    torch.cuda.empty_cache()


def distilled_phase(card: str, tmp: str) -> None:
    """(c) deit_small_distilled_patch16_224: DIST_STEPS training steps at
    B = 64 whose forwards return (logits, logits_dist); an eval at B = 32
    (the mean of the two heads) held to the card's plain path; its weights
    through the export CLI, the Predictor and one HTTP request, whose
    logits match the eval."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model
    from slim_switch_moe_vit_tpu_torch.serving import export
    from slim_switch_moe_vit_tpu_torch.serving.export import make_serve_fn
    from slim_switch_moe_vit_tpu_torch.serving.server import make_server
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import save_checkpoint

    model = _model_on_card(DEIT_DISTILLED, num_classes=1000,
                           dtype=torch.bfloat16)
    state, step, _, _ = _deit_training(model, seed=1)
    outs = []
    hook = model.register_forward_hook(lambda mod, i, o: outs.append(
        isinstance(o, tuple) and len(o) == 2 and o[0].shape == o[1].shape))
    x, y = _u8_batch(DIST_B, 14)
    losses_ = []

    def steps():
        nonlocal state
        for _ in range(DIST_STEPS):
            state, met = step(state, x, y, LR, LR)
            losses_.append(met["loss"].item())

    _counted(steps, PER_DEIT_STEP, DIST_STEPS, {"k5_k6": 12 * DIST_STEPS},
             f"{DEIT_DISTILLED} train, {DIST_STEPS} steps B={DIST_B} (N=198)")
    hook.remove()
    if outs != [True] * DIST_STEPS or not all(np.isfinite(losses_)):
        raise AssertionError(f"{DEIT_DISTILLED} training: pairs {outs}, "
                             f"losses {losses_}")
    log(f"{DEIT_DISTILLED} train: each forward returned (logits, "
        f"logits_dist); losses {[round(v, 4) for v in losses_]}")

    model.eval()
    model_f32 = create_model(DEIT_DISTILLED, num_classes=1000,
                             dtype=torch.float32)
    model_f32.load_state_dict(model.state_dict())
    model_f32 = model_f32.cuda().eval()
    imgs = np.random.RandomState(15).randint(
        0, 256, (DIST_EVAL_B, 224, 224, 3)).astype(np.uint8)
    xe = torch.from_numpy(imgs).cuda()
    from slim_switch_moe_vit_tpu_torch.data import build_eval_normalize

    _eval_vs_plain(model, model_f32, build_eval_normalize()(xe),
                   f"{DEIT_DISTILLED} eval B={DIST_EVAL_B} (the mean of the "
                   f"two heads)")
    evaluated = _counted(lambda: make_serve_fn(model)(xe).cpu().numpy(),
                         PER_DEIT_FORWARD, 1, {"k5": 12},
                         f"{DEIT_DISTILLED} eval B={DIST_EVAL_B}")
    ckpt, art = os.path.join(tmp, "distilled.ckpt"), os.path.join(tmp, "art")
    save_checkpoint(ckpt, state, 0)
    export.main(["--model", DEIT_DISTILLED, "--output", art, "--checkpoint",
                 ckpt, "--num-classes", "1000", "--batch-sizes",
                 str(DIST_EVAL_B)])
    pred = export.load_predictor(art)
    server, batcher = make_server(pred, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        served = post(server.server_address[1], imgs)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    _xcheck(served, evaluated, f"{DEIT_DISTILLED} served over HTTP from the "
            f"export CLI's artifact vs the eval (bit-identical: "
            f"{np.array_equal(served, evaluated)})")
    del model, model_f32, state, step, pred
    torch.cuda.empty_cache()


def vit_large_eval(card: str) -> None:
    """(d) vit_large_patch32_224_in21k (24 blocks of D = 1024, the
    pre-logits layer, 21,843 classes) eval at B = 16 on the kernels, held
    to the card's plain path."""
    import torch

    model, model_f32 = (_model_on_card(VIT_L21K, dtype=dt).eval()
                        for dt in (torch.bfloat16, torch.float32))
    if model.pre_logits is None or model.head.weight.shape != (21843, 1024):
        raise AssertionError(f"{VIT_L21K}: no pre-logits layer or head "
                             f"{tuple(model.head.weight.shape)}")
    x = torch.from_numpy(np.random.RandomState(13).randn(
        VIT_L_B, 224, 224, 3).astype(np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            return model(x)

    _counted(forward, PER_VIT_L_FORWARD, 1, {"k5": 24},
             f"{VIT_L21K} eval B={VIT_L_B} (N=50)")
    _eval_vs_plain(model, model_f32, x, f"{VIT_L21K} (pre-logits, 21,843 "
                   f"classes) eval B={VIT_L_B}")
    del model, model_f32
    torch.cuda.empty_cache()


def zoo_driver_runs(card: str) -> None:
    """(e) ``python -m slim_switch_moe_vit_tpu_torch.main`` on SYNTH at its
    default size, with every flag at its default and with the reference
    recipe's flags: each exits 0 (the engine aborts on a non-finite loss),
    and its epoch's steps/s and loss are read from its output."""
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    for what, argv in ZOO_DRIVER_RUNS.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "slim_switch_moe_vit_tpu_torch.main",
             *argv], cwd=here, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        out = proc.stdout
        pace = re.search(r"(\d+) train steps in ([\d.]+) s \(([\d.]+) "
                         r"steps/s\)", out)
        loss = re.search(r"Averaged stats:.*loss: (\S+) \((\S+)\)", out)
        acc = re.search(r"Accuracy of the network on the (\d+) test images: "
                        r"(\S+)%", out)
        if (proc.returncode != 0 or not pace or not loss or not acc
                or int(pace.group(1)) != 4
                or not np.isfinite(float(loss.group(2)))):
            raise AssertionError(
                f"driver, {what}: exit {proc.returncode}\n{out[-3000:]}\n"
                f"{proc.stderr[-3000:]}")
        log(f"driver, {what} ({' '.join(argv)}): exit 0, {pace.group(1)} "
            f"train steps in {pace.group(2)} s ({pace.group(3)} steps/s, host "
            f"clock, data loading and the first step's warm-up included), "
            f"mean loss {loss.group(2)}, eval on {acc.group(1)} images "
            f"{acc.group(2)}%, {wall:.1f} s for the whole process; card "
            f"{card}")


def zoo_phase(card: str, tmp: str) -> None:
    """Phase 18: the DeiT / ViT zoo and the data pipeline at the driver's
    defaults, (a) to (e)."""
    cfg1_eval(card)
    deit_base_training(card)
    distilled_phase(card, tmp)
    vit_large_eval(card)
    zoo_driver_runs(card)


# ---------------------------------------------------------------------------
# phase 19: fine-tuning and distillation through the driver, the switchable
# and sparse ViTs, the profiler
# ---------------------------------------------------------------------------

def timm_state_dict(model) -> dict:
    """A port ``VisionTransformer``'s weights under timm's names and
    layouts, on the host: the patch GEMM's (D, p * p * C) weight as the
    convolution's (D, C, p, p), ``pre_logits`` as ``pre_logits.fc``."""
    out = {}
    p = model.patch_embed.patch_size
    for name, t in model.state_dict().items():
        t = t.detach().float().cpu()
        if name == "patch_embed.proj.weight":
            t = t.reshape(t.shape[0], p, p, -1).permute(0, 3, 1, 2)
        out[name.replace("pre_logits.", "pre_logits.fc.")] = t.contiguous()
    return out


def _distill_files(tmp: str) -> tuple:
    """The seeded timm-format files of phase 19 (a): a regnety_160 teacher
    and a deit_base_distilled student at 384 px (a 24 x 24 grid + 2
    tokens)."""
    import torch

    teacher = _model_on_card(TEACHER, num_classes=1000)
    t_path = os.path.join(tmp, "teacher.pth")
    torch.save({"model": {k: v.cpu() for k, v in
                          teacher.state_dict().items()}}, t_path)
    student = _model_on_card(STUDENT, num_classes=1000,
                             img_size=STUDENT_FILE_IMG)
    s_path = os.path.join(tmp, "student.pth")
    torch.save({"model": timm_state_dict(student)}, s_path)
    del teacher, student
    torch.cuda.empty_cache()
    return t_path, s_path


def distill_driver_run(card: str, tmp: str, t_path: str, s_path: str) -> None:
    """(a) The DeiT distillation recipe through the driver as a process:
    ``--finetune`` of the 384 px student, ``--distillation-type hard``
    against the RegNetY-160 teacher, ``--async-checkpoint``, 4 steps at
    B = 64 at the driver's default augmentation and mixup. The driver's
    own ``finetune_from`` on the same file gives the file's weights, the
    position embedding as ``resize_pos_embed`` gives it; ``--eval
    --resume`` of the checkpoint restores the saved state bit for bit."""
    import argparse
    import re

    import torch

    from slim_switch_moe_vit_tpu_torch import config
    from slim_switch_moe_vit_tpu_torch import main as driver
    from slim_switch_moe_vit_tpu_torch.models.vit import resize_pos_embed
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    out = os.path.join(tmp, "out")
    argv = DISTILL_DRIVER_ARGS + ["--finetune", s_path, "--teacher-path",
                                  t_path, "--output_dir", out]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "slim_switch_moe_vit_tpu_torch.main", *argv],
        cwd=here, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    pace = re.search(r"(\d+) train steps in ([\d.]+) s \(([\d.]+) steps/s\)",
                     proc.stdout)
    loss = re.search(r"Averaged stats:.*loss: (\S+) \((\S+)\)", proc.stdout)
    ckpt = os.path.join(out, "checkpoint")
    if (proc.returncode != 0 or not pace or not loss
            or int(pace.group(1)) != 4 or not os.path.exists(ckpt)
            or not np.isfinite(float(loss.group(2)))
            or f"Creating teacher model: {TEACHER}" not in proc.stdout):
        raise AssertionError(f"distillation driver: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"distillation driver (--model {STUDENT} --finetune <384 px .pth> "
        f"--distillation-type hard --teacher-model {TEACHER} "
        f"--async-checkpoint, B=64, default augmentation and mixup): exit 0, "
        f"{pace.group(1)} train steps in {pace.group(2)} s ({pace.group(3)} "
        f"steps/s, host clock, the first step's warm-up included), mean loss "
        f"{loss.group(2)}, {wall:.1f} s for the whole process; card {card}")

    # the driver's import of the file, in this process
    model = _model_on_card(STUDENT, num_classes=1000)
    driver.finetune_from(s_path, model)
    sd = torch.load(s_path, weights_only=True)["model"]
    got = model.state_dict()
    grid = model.img_size // model.patch_embed.patch_size
    want = dict(sd, pos_embed=resize_pos_embed(sd["pos_embed"], 2, grid))
    pw = sd["patch_embed.proj.weight"]
    want["patch_embed.proj.weight"] = pw.permute(0, 2, 3, 1).reshape(
        pw.shape[0], -1)
    diff = [n for n, t in got.items() if not torch.equal(t.cpu(), want[n])]
    file_grid = STUDENT_FILE_IMG // model.patch_embed.patch_size
    if diff or sd["pos_embed"].shape[1] != file_grid ** 2 + 2:
        raise AssertionError(f"--finetune: {diff[:5]} differ from the file")
    log(f"--finetune: {len(got)} tensors equal the file's, pos_embed "
        f"{tuple(sd['pos_embed'].shape)} -> {tuple(got['pos_embed'].shape)} "
        f"equal to resize_pos_embed's")
    del model

    # --eval --resume through the driver: the saved state, bit for bit
    payload = torch.load(ckpt, weights_only=True)
    args = argparse.ArgumentParser(parents=[config.get_args_parser()]) \
        .parse_args(DISTILL_RESUME_ARGS + ["--resume", ckpt])
    state = driver.main(args)
    restore_checkpoint(ckpt, state)  # the moments, into its fresh optimizer
    same = [torch.equal(t.cpu(), payload["model"][n])
            for n, t in state.model.state_dict().items()]
    same += [torch.equal(t.cpu(), payload["ema_params"][n])
             for n, t in state.ema_params.items()]
    saved = payload["optimizer"]["state"]
    for i, st in state.optimizer.state_dict()["state"].items():
        same += [torch.equal(st[k].cpu(), saved[i][k]) for k in st]
    if not all(same) or state.step != payload["step"] or state.step != 4:
        raise AssertionError(f"--resume: {same.count(False)} of {len(same)} "
                             f"tensors differ, step {state.step}")
    log(f"--eval --resume: {len(same)} tensors (parameters, EMA, moments) "
        f"bit-identical to the asynchronous save, step {state.step}")
    del state
    torch.cuda.empty_cache()


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN's TF32 switch set to ``allow`` for the calls inside, restored
    after. ``main`` turns TF32 off for the f32 references; the teacher runs
    at its own precision, TF32, PyTorch's default, which the driver keeps.
    (``torch.backends.cudnn.flags`` would also reset every cuDNN flag it is
    not given, ``enabled`` among them.)"""
    import torch

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _teacher_on_card(t_path: str):
    from slim_switch_moe_vit_tpu_torch.models.regnet import \
        import_torch_regnet

    return import_torch_regnet(t_path, _model_on_card(
        TEACHER, num_classes=1000)).eval().requires_grad_(False)


def distilled_steps(card: str, teacher, tmp: str) -> None:
    """(b) The distilled DeiT-B step at B = 128 with the RegNetY-160
    teacher: for ``hard`` and ``soft``, one step on the kernels and one on
    the card's plain path from one seed and one set of teacher logits
    (computed once), within XTRAIN's step-1 loss limit and gradient
    cosine, launches exact and none in the teacher; the hard step at the driver's augmentation and
    mixup by events and by kernel sum, the teacher's forward alone and its
    share, the peak memory; (f) one step under ``utils/profiling.trace``."""
    import torch

    from slim_switch_moe_vit_tpu_torch import losses, ops, optim
    from slim_switch_moe_vit_tpu_torch.engine import make_train_step
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils import profiling

    from slim_switch_moe_vit_tpu_torch.data import (build_device_augment,
                                                    make_mixup_fn)

    base = _model_on_card(STUDENT, num_classes=1000, dtype=torch.bfloat16,
                          drop_path_rate=0.1)
    augment = build_device_augment(input_size=224, **DEIT_AUG)
    mixup_fn = make_mixup_fn(num_classes=1000, **DEIT_MIX)
    x8, y = _u8_batch(DISTILL_B, 16)
    gen = torch.Generator("cuda").manual_seed(5)
    xa, ysoft = mixup_fn(gen, augment(gen, x8), y)
    def t_apply(images):
        with cudnn_tf32(True):
            return teacher(images)

    ops.reset_launch_counts()
    with torch.no_grad():
        t_logits = t_apply(xa)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the teacher launched {ops.launch_counts()}")
    crit = losses.make_base_criterion(True, 0.1, False)
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)

    def make(model, kind, teacher_apply, **kw):
        state = create_train_state(model, device="cuda", seed=7,
                                   opt_init=opt_init, use_ema=True)
        return state, make_train_step(
            model, opt_update, crit, distillation_type=kind, alpha=0.5,
            tau=1.0, teacher_apply=teacher_apply, ema_decay=EMA_DECAY, **kw)

    lim, cos_lim = XTRAIN_PAIRS[0][2][0][0], XTRAIN_PAIRS[0][2][1]
    for kind in ("hard", "soft"):
        runs = {}
        for label in ("kernels", "plain"):
            m = copy.deepcopy(base)
            state, step = make(m, kind, lambda images: t_logits)
            ops.reset_launch_counts()
            ctx = (plain_versions() if label == "plain"
                   else contextlib.nullcontext())
            with ctx:
                state, met = step(state, xa, ysoft, XTRAIN_LR, XTRAIN_LR)
            want = (expected(PER_DEIT_STEP, 1) if label == "kernels"
                    else expected({}, 1))
            if ops.launch_counts() != want:
                raise AssertionError(f"{kind} {label} step: launches "
                                     f"{ops.launch_counts()}")
            runs[label] = (met["loss"].item(), torch.cat(
                [p.grad.detach().float().flatten() for p in m.parameters()]))
            del m, state, step
        (lk, gk), (lp, gp) = runs["kernels"], runs["plain"]
        rel, cos = abs(lk - lp) / abs(lp), _cos(gk, gp)
        log(f"{STUDENT} B={DISTILL_B} {kind} distillation step from one seed "
            f"and one set of {TEACHER} logits, kernels vs the card's plain "
            f"path: loss {lk:.5f} vs {lp:.5f} (rel {rel:.3e}, limit {lim}), "
            f"gradient cosine {cos:.6f} (limit {cos_lim}); launches exact "
            f"{PER_DEIT_STEP}, none in the teacher")
        if rel > lim or cos < cos_lim or not np.isfinite(lk):
            raise AssertionError(f"{kind} distillation step disagrees")
        del runs, gk, gp

    model = base
    state, step = make(model, "hard", t_apply,
                       augment_fn=augment, mixup_fn=mixup_fn)
    state, _ = step(state, x8, y, LR, LR)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses_ = []

    def steps():
        nonlocal state
        start.record()
        for _ in range(DISTILL_STEPS):
            state, met = step(state, x8, y, LR, LR)
            losses_.append(met["loss"])
        end.record()
        end.synchronize()

    _counted(steps, PER_DEIT_STEP, DISTILL_STEPS,
             {"k5_k6": 12 * DISTILL_STEPS},
             f"{STUDENT} hard distillation, {DISTILL_STEPS} steps "
             f"B={DISTILL_B} (the teacher inside)")
    losses_ = torch.stack(losses_).tolist()
    if not all(np.isfinite(losses_)):
        raise AssertionError(f"distillation losses {losses_}")
    step_ms = start.elapsed_time(end) / DISTILL_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_name = profile_call(lambda: step(state, x8, y, LR, LR),
                           f"one {STUDENT} hard distillation step "
                           f"B={DISTILL_B}")
    with torch.no_grad():
        t_ms = median_ms(lambda: t_apply(xa), reps=5, warmup=1)
    log(f"{STUDENT} hard distillation B={DISTILL_B} (the driver's "
        f"augmentation and mixup, AdamW + EMA, {TEACHER} teacher in f32 with "
        f"TF32 convolutions): losses {[round(v, 4) for v in losses_]}, "
        f"{step_ms:.3f} ms a step on the device clock ({DISTILL_B / step_ms * 1e3:.1f} "
        f"images/s), kernel sum {_kernel_ms(by_name):.3f} ms, peak memory "
        f"allocated {peak:.2f} GiB; the teacher's forward alone {t_ms:.3f} ms "
        f"= {t_ms / step_ms:.3f} of the step; card {card}")

    # (f) one step under the port's profiler
    log_dir = os.path.join(tmp, "trace")
    with profiling.trace(log_dir):
        step(state, x8, y, LR, LR)
    rows = profiling.summarize_trace(log_dir, top=8)
    if not rows or not any("mha_fwd" in r[2] for r in profiling.summarize_trace(
            log_dir, top=10 ** 6)):
        raise AssertionError(f"summarize_trace: {rows}")
    log(f"utils/profiling.trace of one hard distillation step, "
        f"summarize_trace's top rows (ms a step, launches, kernel):")
    for ms, n, name in rows:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:90]}")
    del model, state, step, base
    torch.cuda.empty_cache()
    return xa[:TEACHER_CPU_B].float().cpu()


def teacher_check(card: str, teacher, t_path: str, images) -> None:
    """(c) The teacher's logits on the card (TF32 convolutions, the
    teacher's precision) against the CPU f32 run of the same weights on
    TEACHER_CPU_B augmented images: max |d| within TEACHER_REL of max
    |ref|, cosine at least TEACHER_COS. Two controls from the same file:
    the card in full f32 (printed), and the teacher built with bf16
    activations, which must fall outside TEACHER_REL, so the limit tells
    TF32 from a lower precision."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model
    from slim_switch_moe_vit_tpu_torch.models.regnet import \
        import_torch_regnet

    cpu = import_torch_regnet(t_path, create_model(TEACHER, num_classes=1000))
    bf16 = import_torch_regnet(t_path, _model_on_card(
        TEACHER, num_classes=1000, dtype=torch.bfloat16)).eval()
    with torch.no_grad():
        ref = cpu.eval()(images)
        with cudnn_tf32(True):
            got = teacher(images.cuda()).cpu()
            low = bf16(images.cuda()).cpu()
        with cudnn_tf32(False):
            full = teacher(images.cuda()).cpu()
    del bf16
    top = ref.abs().max().item()
    d, d32, d16 = ((t - ref).abs().max().item() for t in (got, full, low))
    cos = min(_cos(a, b) for a, b in zip(got, ref))
    log(f"{TEACHER} logits, card (TF32) vs CPU f32, {len(images)} images: max "
        f"|d| {d:.4e} = {d / top:.3e} of max |ref| {top:.4e} (limit "
        f"{TEACHER_REL}), min cosine {cos:.6f} (limit {TEACHER_COS}); "
        f"controls: the card in full f32 {d32 / top:.3e}, bf16 activations "
        f"{d16 / top:.3e} (must exceed the limit); top-1 agree "
        f"{int((got.argmax(1) == ref.argmax(1)).sum())}/{len(images)}; card "
        f"{card}")
    if not torch.isfinite(got).all() or d > TEACHER_REL * top \
            or cos < TEACHER_COS:
        raise AssertionError("the teacher's logits on the card disagree")
    if d16 <= TEACHER_REL * top:
        raise AssertionError("TEACHER_REL passes the bf16-activation teacher")


def _routed(model, threshold: int):
    """``model`` (a switchable ViT) called in routing mode by the engine's
    ``model(images, generator)``."""
    import torch

    class Routed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x, generator=None):
            return self.m(x, generator, threshold=threshold, routing=True)

    return Routed()


def switchable_check(card: str) -> None:
    """(d) deit_sw_tiny_patch16_224 with SW_BUCKETS buckets (centroids set
    from pre-router tokens) and route_capacity SW_CAPACITY of 197: a routed
    eval at B = 128 against the card's plain path within the serving limit,
    launches and routes exact and N = SW_CAPACITY in the mid blocks; the
    routed and unrouted evals by events; SW_STEPS routed training steps on
    the kernels against the card's plain path from one seed (each step's
    loss within XTRAIN's limit for it, the step-1 gradient within XTRAIN's
    cosine), launches exact."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops
    from slim_switch_moe_vit_tpu_torch.models import vit

    base = _model_on_card(SW_MODEL, num_classes=1000, dtype=torch.bfloat16,
                          buckets=SW_BUCKETS, route_capacity=SW_CAPACITY)
    x, y = _batch(SW_B, 17, "cuda")
    with torch.no_grad():
        pre = base.forward_pre(x).float()
    base.router.set_centroids(pre[[0, 1, 2, 3], [5, 60, 120, 190]])
    model = base.eval()
    routed = _routed(model, SW_THRESHOLD).eval()
    seen = []
    hooks = [blk.attn.register_forward_hook(
        lambda mod, i, o: seen.append(i[0].shape[1])) for blk in model.blocks]

    def forward():
        with torch.inference_mode():
            return routed(x)

    got = _counted(forward, PER_SW_FORWARD, 1, {"k5": 12},
                   f"{SW_MODEL} routed eval B={SW_B}")
    for h in hooks:
        h.remove()
    _, sel = model.router(pre)
    passing = (sel >= SW_THRESHOLD).sum(1).float()
    if seen != [SW_CAPACITY] * 11 + [197]:
        raise AssertionError(f"attention N per block {seen}")
    _xcheck(got.float().cpu().numpy(), _plain_logits(routed, x),
            f"{SW_MODEL} routed eval B={SW_B} vs the card's plain path "
            f"(tokens passing the router per image: mean "
            f"{passing.mean().item():.1f}, min {passing.min().item():.0f}, "
            f"max {passing.max().item():.0f}; capacity {SW_CAPACITY})")
    r_ms = median_ms(forward, reps=10)
    with torch.inference_mode():
        u_ms = median_ms(lambda: model(x), reps=10)
    log(f"{SW_MODEL} eval B={SW_B}: routed {r_ms:.3f} ms (N={SW_CAPACITY} in "
        f"the 11 mid blocks), unrouted {u_ms:.3f} ms, ratio "
        f"{r_ms / u_ms:.3f}; card {card}")

    runs = {}
    for label in ("kernels", "plain"):
        m = copy.deepcopy(base)
        _, state, step = _train_setup(torch.bfloat16, "cuda",
                                      _routed(m, SW_THRESHOLD))
        ctx = plain_versions() if label == "plain" else contextlib.nullcontext()
        losses_, grads = [], []

        def steps():
            nonlocal state
            for _ in range(SW_STEPS):
                state, met = step(state, x, y, XTRAIN_LR, XTRAIN_LR)
                losses_.append(met["loss"].item())
                if not grads:  # step 1's gradient
                    grads.append(torch.cat([
                        (p.grad if p.grad is not None else
                         torch.zeros_like(p)).detach().float().flatten()
                        for p in m.parameters()]))

        with ctx:
            if label == "kernels":
                _counted(steps, PER_SW_STEP, SW_STEPS, {"k5_k6": 12 * SW_STEPS},
                         f"{SW_MODEL} routed train, {SW_STEPS} steps B={SW_B}")
            else:
                ops.reset_launch_counts()
                steps()
                if any(ops.launch_counts().values()):
                    raise AssertionError(f"plain path launched "
                                         f"{ops.launch_counts()}")
        runs[label] = (losses_, grads[0])
        del m, state, step
    (lk, gk), (lp, gp) = runs["kernels"], runs["plain"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    lim, cos_lim = XTRAIN_PAIRS[0][2][0][:SW_STEPS], XTRAIN_PAIRS[0][2][1]
    cos = _cos(gk, gp)
    log(f"{SW_MODEL} routed training, kernels vs the card's plain path from "
        f"one seed: losses {[round(v, 5) for v in lk]} vs "
        f"{[round(v, 5) for v in lp]} (rel per step "
        f"{[float(f'{r:.3e}') for r in rel]}, limits {list(lim)}), step-1 "
        f"gradient cosine {cos:.6f} (limit {cos_lim})")
    if (any(r > t for r, t in zip(rel, lim)) or cos < cos_lim
            or not all(np.isfinite(lk))):
        raise AssertionError("switchable routed training disagrees")
    del base, model, routed
    torch.cuda.empty_cache()


def _sparse_search(device: str, base, x, y) -> tuple:
    """SPARSE_STEPS search steps (label-smoothed CE + SPARSE_W x the L1
    zeta loss, AdamW) and compress at SPARSE_BUDGETS, in f32 on
    ``device``; returns (model, losses, launches)."""
    import torch

    from slim_switch_moe_vit_tpu_torch import losses, ops
    from slim_switch_moe_vit_tpu_torch.models import sparse

    m = copy.deepcopy(base).to(device)
    opt = torch.optim.AdamW(m.parameters(), lr=XTRAIN_LR, weight_decay=0.0,
                            foreach=False)
    crit = losses.make_base_criterion(False, 0.1, False)
    x, y = x.to(device), y.to(device)
    ops.reset_launch_counts()
    out = []
    for _ in range(SPARSE_STEPS):
        m.train()
        opt.zero_grad()
        loss = crit(m(x, torch.Generator(device)), y) + SPARSE_W * sum(
            sparse.get_sparsity_loss(m))
        loss.backward()
        opt.step()
        out.append(loss.item())
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    sparse.compress(m, *SPARSE_BUDGETS)
    return m, out, launches


def sparse_check(card: str) -> None:
    """(e) sparse_deit_tiny_patch16_224 (N = 197) in f32 with its zetas
    spread over [0, 1) (the JAX golden test's jittered init, seeded):
    SPARSE_STEPS search steps and compress at SPARSE_BUDGETS on the card
    and on the CPU from the same weights and batch; every searched mask
    equal element for element; the compressed forward on the card; the
    remaining fractions and the FLOP counts."""
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model, ops
    from slim_switch_moe_vit_tpu_torch.models import sparse
    from slim_switch_moe_vit_tpu_torch.ops import flops

    base = create_model(SPARSE, num_classes=1000)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for _, mod, _ in sparse.sparse_modules(base):
            for p in (mod.zeta, getattr(mod, "patch_zeta", None)):
                if p is not None:
                    p.copy_(torch.from_numpy(rng.rand(*p.shape).astype(
                        np.float32)))
    x, y = _batch(SPARSE_B, 18, "cpu")
    card_m, card_losses, launches = _sparse_search("cuda", base, x, y)
    if launches != {k: v * SPARSE_STEPS for k, v in PER_SPARSE_STEP.items()}:
        raise AssertionError(f"{SPARSE} launches {launches}")
    cpu_m, cpu_losses, _ = _sparse_search("cpu", base, x, y)
    masks = [n for n in cpu_m.state_dict() if "searched" in n]
    differ = [n for n in masks if not torch.equal(
        card_m.state_dict()[n].cpu(), cpu_m.state_dict()[n])]
    kept = sum(int(cpu_m.state_dict()[n].sum()) for n in masks)
    total = sum(cpu_m.state_dict()[n].numel() for n in masks)
    log(f"{SPARSE} search, {SPARSE_STEPS} steps B={SPARSE_B} f32: losses card "
        f"{[round(v, 6) for v in card_losses]}, CPU "
        f"{[round(v, 6) for v in cpu_losses]}; launches {launches} (the "
        f"final norm's; the sparse blocks keep plain norms and attention); "
        f"compress at {SPARSE_BUDGETS}: {len(masks)} masks, {kept} of {total} "
        f"entries kept, {len(differ)} differing from the CPU's")
    if differ or not 0 < kept < total:
        raise AssertionError(f"sparse masks differ: {differ[:5]}")
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = card_m.eval()(x.cuda())
    if (logits.shape != (SPARSE_B, 1000) or not torch.isfinite(logits).all()
            or {k: v for k, v in ops.launch_counts().items() if v}
            != PER_SPARSE_FORWARD):
        raise AssertionError(f"compressed forward: {tuple(logits.shape)}, "
                             f"launches {ops.launch_counts()}")
    ra, rm, rp = sparse.get_remaining(card_m, 197)
    attn = [b.attn for b in card_m.blocks]
    f_total = f_active = 0.0
    for a in attn:
        t, act = sparse.sparse_attention_flops(
            192, 3, a.searched_zeta.cpu().numpy(), 197,
            float(a.searched_patch_zeta.sum()))
        f_total, f_active = f_total + t, f_active + act
    counted = flops.cost_analysis(cpu_m.eval(), x[:1])["flops"]
    log(f"{SPARSE} compressed: remaining attention {ra:.4f}, MLP {rm:.4f}, "
        f"patches {rp:.4f}; attention FLOPs a forward (one image, analytic) "
        f"{f_active:.4e} of {f_total:.4e}; the dense ViT-tiny's analytic "
        f"{flops.vit_flops(1, 224, 16, 192, 12):.4e}, counted by "
        f"FlopCounterMode on the CPU (the masked products included) "
        f"{counted:.4e}; card {card}")
    del card_m, cpu_m, base
    torch.cuda.empty_cache()


def distill_phase(card: str, tmp: str) -> None:
    """Phase 19, (a) to (f)."""
    t0 = time.perf_counter()
    t_path, s_path = _distill_files(tmp)
    log(f"[phase 19 files written in {time.perf_counter() - t0:.1f} s]")
    distill_driver_run(card, tmp, t_path, s_path)
    teacher = _teacher_on_card(t_path)
    images = distilled_steps(card, teacher, tmp)
    teacher_check(card, teacher, t_path, images)
    del teacher
    switchable_check(card)
    sparse_check(card)


def _param_module(tensors: dict):
    """A module whose ``named_parameters()`` are ``tensors`` under their
    names (``blocks.0.mlp.w1`` ...), for an optimizer over a copy of a
    model's parameters on another device."""
    import torch

    root = torch.nn.Module()
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            if part not in node._modules:
                node.add_module(part, torch.nn.Module())
            node = node._modules[part]
        node.register_parameter(leaf, torch.nn.Parameter(t))
    return root


def _driver_args(argv: list):
    import argparse

    from slim_switch_moe_vit_tpu_torch import config

    return argparse.ArgumentParser(
        parents=[config.get_args_parser()]).parse_args(argv)


def optimizer_surface_check(card: str, tmp: str) -> None:
    """(a) Every ``--opt`` name: the f32 gradients of one kernel step of
    the flagship at B = SURF_B, two steps of the port's optimizer from the
    same parameters and gradients on the card and on the CPU, in f32,
    every parameter within OPT_REL of its leaf's largest |ref| plus
    OPT_LR_SLACK lr. Then the driver with ``--opt lamb --clip-grad 1.0``: its checkpoint
    restores the parameters, moments and EMA bit for bit and ``--resume``
    trains on; and ``--finetune`` of a timm-format DeiT-S file with
    ``--attn-only``: every frozen parameter bit-identical to the file's
    after the steps."""
    import torch

    from slim_switch_moe_vit_tpu_torch import losses, ops, optim
    from slim_switch_moe_vit_tpu_torch import main as driver
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    t0 = time.perf_counter()
    model = _model_on_card(MODEL, num_classes=1000, dtype=torch.bfloat16)
    x, y = _batch(SURF_B, 23, "cuda")
    crit = losses.make_base_criterion(False, 0.1, False)
    model.train()
    ops.reset_launch_counts()
    crit(model(x, torch.Generator("cuda").manual_seed(0)), y).backward()
    if ops.launch_counts() != expected(PER_TRAIN_STEP, 1):
        raise AssertionError(f"gradient step launched {ops.launch_counts()}")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model
    # the CPU side in f32 too: in f64, adam's L2 term g + wd * p cancels
    # to within an f32 ulp of 0 in places, where eps amplifies the rounding
    # into the update (131x the limit on an NVIDIA H100 80GB HBM3, 700 W)
    host = ({n: t.cpu() for n, t in params.items()},
            {n: t.cpu() for n, t in grads.items()})
    log(f"optimizers: f32 gradients of one kernel step of {MODEL} at "
        f"B={SURF_B} ({sum(t.numel() for t in params.values())} parameters"
        f", launches exact) in {time.perf_counter() - t0:.1f} s")
    for opt in optim.SUPPORTED_OPTIMIZERS:
        out, ms = {}, 0.0
        for dev, (p0, g) in (("cuda", (params, grads)), ("cpu", host)):
            shell = _param_module({n: t.clone() for n, t in p0.items()})
            init, update = optim.make_optimizer(opt=opt, weight_decay=0.05)
            optimizer = init(shell)
            for s in range(SURF_STEPS):
                for n, p in shell.named_parameters():
                    p.grad = g[n].clone()
                if dev == "cuda" and s == SURF_STEPS - 1:
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    update(optimizer, SURF_LR, SURF_LR)
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end)
                else:
                    update(optimizer, SURF_LR, SURF_LR)
            out[dev] = {n: p.detach().cpu() for n, p in
                        shell.named_parameters()}
            del shell, optimizer
        worst, moved, leaf = 0.0, 0.0, ""
        for n, ref in out["cpu"].items():
            d = (out["cuda"][n] - ref).abs().max().item()
            tol = OPT_REL * ref.abs().max().item() + OPT_LR_SLACK * SURF_LR
            if d / tol >= worst:
                worst, leaf = d / tol, n
            moved = max(moved, (ref - host[0][n]).abs().max().item())
        log(f"optimizer {opt}: {SURF_STEPS} steps, card vs CPU in f32, "
            f"worst leaf max |d| {worst:.3f} of its limit ({OPT_REL} max "
            f"|ref| + {OPT_LR_SLACK} lr; {leaf}); largest move "
            f"{moved:.3e}; the card's step {ms:.3f} ms (one step, events, "
            f"host launches included) {card}")
        if not worst <= 1.0 or not moved > 0.0:
            raise AssertionError(f"optimizer {opt}: card vs CPU {worst}")
    del params, grads, host
    torch.cuda.empty_cache()

    # the driver: --opt lamb --clip-grad 1.0, restored and resumed
    t0 = time.perf_counter()
    out = os.path.join(tmp, "lamb")
    argv = SURF_DRIVER_ARGS + ["--model", MODEL, "--opt", "lamb",
                               "--clip-grad", "1.0", "--output_dir", out]
    args = _driver_args(argv)
    state = driver.main(args)
    init, _ = optim.make_optimizer(opt="lamb", clip_grad=1.0)
    restored, epoch = restore_checkpoint(
        os.path.join(out, "checkpoint"), create_train_state(
            driver.build_model(args, 10, args.seed + 1), device="cuda",
            opt_init=init, use_ema=True))
    same = epoch == 0 and restored.step == state.step == SURF_DRIVER_STEPS
    for (n, a), b in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        same &= torch.equal(a, b) and torch.equal(state.ema_params[n],
                                                  restored.ema_params[n])
        for key in ("exp_avg", "exp_avg_sq", "step"):
            same &= torch.equal(state.optimizer.state[a][key].cpu(),
                                restored.optimizer.state[b][key].cpu())
    if not same:
        raise AssertionError("the lamb checkpoint does not restore bit for "
                             "bit")
    del state, restored
    resumed = driver.main(_driver_args(argv + [
        "--epochs", "2", "--resume", os.path.join(out, "checkpoint")]))
    with open(os.path.join(out, "log.txt")) as f:
        logged = [json.loads(line) for line in f]
    if (resumed.step != 2 * SURF_DRIVER_STEPS
            or [r["epoch"] for r in logged] != [0, 1]
            or not all(np.isfinite(r["train_loss"]) for r in logged)):
        raise AssertionError(f"lamb resume: step {resumed.step}, {logged}")
    log(f"driver --opt lamb --clip-grad 1.0 ({MODEL}, B={SURF_B}): "
        f"{SURF_DRIVER_STEPS} steps, the checkpoint restored bit for bit "
        f"(parameters, Lamb moments and steps, EMA), --resume trained epoch "
        f"1 to step {resumed.step}; train losses "
        f"{[round(r['train_loss'], 5) for r in logged]}; "
        f"{time.perf_counter() - t0:.1f} s {card}")
    del resumed
    torch.cuda.empty_cache()

    # --finetune of a timm-format DeiT-S file with --attn-only
    t0 = time.perf_counter()
    src = _model_on_card(DEIT_SMALL, num_classes=1000)
    path = os.path.join(tmp, "deit_small.pth")
    torch.save({"model": timm_state_dict(src)}, path)
    del src
    argv = SURF_DRIVER_ARGS + ["--model", DEIT_SMALL, "--finetune", path,
                               "--attn-only", "--output_dir",
                               os.path.join(tmp, "attn_only")]
    args = _driver_args(argv)
    ref = driver.build_model(args, 10, args.seed)
    driver.finetune_from(path, ref)
    state = driver.main(args)
    trained = optim.attn_only_mask(state.model.named_parameters())
    start = dict(ref.named_parameters())
    frozen = moved = 0
    for n, p in state.model.named_parameters():
        same = torch.equal(p.detach().cpu(), start[n].detach())
        if same == trained[n]:
            raise AssertionError(f"--attn-only: {n} (trained "
                                 f"{trained[n]}) moved {not same}")
        frozen += same
        moved += not same
    log(f"driver --finetune (timm-format {DEIT_SMALL}) --attn-only: "
        f"{state.step} steps at B={SURF_B}, {frozen} frozen tensors "
        f"bit-identical to the file's, {moved} trained tensors moved; "
        f"{time.perf_counter() - t0:.1f} s {card}")
    del state, ref
    torch.cuda.empty_cache()


@contextlib.contextmanager
def pinned_expert_choice(routes: list, replay: bool):
    """``pinned_routing`` for ``expert_choice``: record each expert's
    chosen tokens into ``routes``, or with ``replay`` impose them, the gate
    weights this run's own probabilities at them. Yields ``moved``: the
    chosen slots, and those whose imposed token is not among the run's own
    top-C of its expert."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import moe as moe_ops

    real = moe_ops.expert_choice_gate
    recorded = iter(list(routes))
    moved = {"tokens": 0, "moved": 0}

    def gate(probs, capacity):
        if not replay:
            weights, idx = real(probs, capacity)
            routes.append(idx)
            return weights, idx
        idx = next(recorded).to(probs.device)
        own = real(probs, capacity)[1]
        hit = (own[:, :, None] == idx[:, None, :]).any(1)
        moved["tokens"] += idx.numel()
        moved["moved"] += int((~hit).sum())
        return probs.t().gather(1, idx), idx

    moe_ops.expert_choice_gate = gate
    try:
        yield moved
    finally:
        moe_ops.expert_choice_gate = real


def expert_choice_check(card: str) -> None:
    """(b) The flagship with ``--moe-dispatch expert_choice``: an eval at
    B = SURF_B against the card's plain path within the serving limit (in
    f32, and in bf16 with the kernels' run's expert choices imposed), and
    EC_STEPS training steps on the kernels against the plain path from one
    seed, the kernels' run's expert choices imposed on the plain run (each
    step's loss within XTRAIN's limit, the step-1 gradient within XTRAIN's
    cosine), launches exact (no expert-FFN kernel: the buffer's FFN is
    plain, as in the JAX package)."""
    import torch

    from slim_switch_moe_vit_tpu_torch import ops

    t0 = time.perf_counter()
    kw = dict(num_classes=1000, dispatch_mode="expert_choice")
    model = _model_on_card(MODEL, dtype=torch.bfloat16, **kw).eval()
    model32 = _model_on_card(MODEL, dtype=torch.float32, **kw).eval()
    x, y = _batch(SURF_B, 29, "cuda")
    routes: list = []

    def forward():
        with torch.no_grad(), pinned_expert_choice(routes, replay=False):
            return model(x).float().cpu().numpy()

    got = _counted(forward, PER_DEIT_FORWARD, 1, {"k5": 12},
                   f"{MODEL} expert_choice eval B={SURF_B}")
    drop = float(torch.stack([blk.mlp.aux["drop_fraction"]
                              for blk in model.blocks]).mean())
    with torch.no_grad():
        got32 = model32(x).float().cpu().numpy()
    _xcheck(got32, _plain_logits(model32, x),
            f"{MODEL} expert_choice eval, f32, vs the card's plain path")
    with pinned_expert_choice(routes, replay=True) as moved:
        plain = _plain_logits(model, x)
    _xcheck(got, plain, f"{MODEL} expert_choice eval, bf16, vs the card's "
            f"plain path (the kernels' expert choices on both; "
            + check_moved(moved, "expert_choice") + ")")
    del model32
    runs, train_routes = {}, []
    for label in ("kernels", "plain"):
        m = copy.deepcopy(model)
        _, state, step = _train_setup(torch.bfloat16, "cuda", m)
        ctx = contextlib.ExitStack()
        moved = ctx.enter_context(pinned_expert_choice(
            train_routes, replay=label == "plain"))
        if label == "plain":
            ctx.enter_context(plain_versions())
        losses_, grads = [], []

        def steps():
            nonlocal state
            for _ in range(EC_STEPS):
                state, met = step(state, x, y, XTRAIN_LR, XTRAIN_LR)
                losses_.append(met["loss"].item())
                if not grads:  # step 1's gradient
                    grads.append(torch.cat([
                        (p.grad if p.grad is not None else
                         torch.zeros_like(p)).detach().float().flatten()
                        for p in m.parameters()]))

        with ctx:
            if label == "kernels":
                _counted(steps, PER_DEIT_STEP, EC_STEPS,
                         {"k5_k6": 12 * EC_STEPS},
                         f"{MODEL} expert_choice train, {EC_STEPS} steps "
                         f"B={SURF_B}")
            else:
                ops.reset_launch_counts()
                steps()
                if any(ops.launch_counts().values()):
                    raise AssertionError(f"plain path launched "
                                         f"{ops.launch_counts()}")
        runs[label] = (losses_, grads[0])
        del m, state, step
    pinned = check_moved(moved, "expert_choice training")
    (lk, gk), (lp, gp) = runs["kernels"], runs["plain"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    lim, cos_lim = XTRAIN_PAIRS[0][2][0][:EC_STEPS], XTRAIN_PAIRS[0][2][1]
    cos = _cos(gk, gp)
    log(f"{MODEL} expert_choice training, kernels vs the card's plain path "
        f"from one seed, the kernels' expert choices on both ({pinned}): "
        f"losses {[round(v, 5) for v in lk]} vs "
        f"{[round(v, 5) for v in lp]} (rel per step "
        f"{[float(f'{r:.3e}') for r in rel]}, limits {list(lim)}), step-1 "
        f"gradient cosine {cos:.6f} (limit {cos_lim}); eval drop_fraction "
        f"{drop:.4f}; {time.perf_counter() - t0:.1f} s {card}")
    if (any(r > t for r, t in zip(rel, lim)) or cos < cos_lim
            or not all(np.isfinite(lk))):
        raise AssertionError("expert_choice training disagrees")
    del model
    torch.cuda.empty_cache()


def expert_dropout_check(card: str) -> None:
    """(c) The flagship with ``--drop DROP_RATE`` (default dispatch,
    ``'fused'``): one training step at B = SURF_B runs ``'ragged'`` in
    every block (no expert-FFN launch, the LN and attention kernels
    exact), its loss is finite, and the kept share of the hidden
    activations over the step's masks is within 5 binomial standard
    deviations of 1 - DROP_RATE."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import moe as moe_ops

    t0 = time.perf_counter()
    model = _model_on_card(MODEL, num_classes=1000, dtype=torch.bfloat16,
                           drop_rate=DROP_RATE)
    _, state, step = _train_setup(torch.bfloat16, "cuda", model)
    x, y = _batch(SURF_B, 31, "cuda")
    real, kept = moe_ops.expert_dropout_mask, []

    def recording(shape, drop_rate, device):
        mask = real(shape, drop_rate, device)
        kept.append((mask.sum(), mask.numel()))
        return mask

    moe_ops.expert_dropout_mask = recording
    try:
        model.train()
        modes = {blk.mlp.dispatch() for blk in model.blocks}
        state, met = _counted(lambda: step(state, x, y, LR, LR),
                              PER_DEIT_STEP, 1, {"k5_k6": 12},
                              f"{MODEL} --drop {DROP_RATE} train step "
                              f"B={SURF_B}")
    finally:
        moe_ops.expert_dropout_mask = real
    loss = met["loss"].item()
    n = sum(k[1] for k in kept)
    share = float(sum(k[0] for k in kept)) / n
    sd = np.sqrt(DROP_RATE * (1 - DROP_RATE) / n)
    log(f"{MODEL} --drop {DROP_RATE}: dispatch {sorted(modes)} in training, "
        f"loss {loss:.5f}, {len(kept)} masks over {n} hidden activations "
        f"kept {share:.6f} (1 - p = {1 - DROP_RATE}, 5 sd = {5 * sd:.2e}); "
        f"{time.perf_counter() - t0:.1f} s {card}")
    if (modes != {"ragged"} or not np.isfinite(loss) or len(kept) != 12
            or abs(share - (1 - DROP_RATE)) > 5 * sd):
        raise AssertionError("expert dropout step")
    del model, state, step
    torch.cuda.empty_cache()


def gated_artifact_check(card: str, tmp: str) -> None:
    """(e) ``resmoe_small_patch16_224_expert8`` with every gate's eval
    target lowered to GATED_TARGET, exported and served through the
    Predictor: the served logits within the serving limit of the model's
    eval on the same images (the same kernels on the same inputs: max |d|
    printed), the eval skips a positive share of the tokens, launches
    exact; the same model at the default targets gives other logits (an
    artifact that lost its gates' buffers would show)."""
    import torch

    from slim_switch_moe_vit_tpu_torch.models import gates
    from slim_switch_moe_vit_tpu_torch.serving import (export_model,
                                                       load_predictor,
                                                       make_serve_fn)

    t0 = time.perf_counter()
    model = _model_on_card(RESMOE, num_classes=1000).eval()
    images = np.random.RandomState(37).randint(
        0, 256, (SURF_EVAL_B, 224, 224, 3)).astype(np.uint8)
    x = torch.from_numpy(images).cuda()
    default = make_serve_fn(model)(x).cpu().numpy()
    with torch.no_grad():
        for g in gates.gate_modules(model).values():
            g.target_threshold.fill_(GATED_TARGET)
    want = make_serve_fn(model)(x).cpu().numpy()
    skipped = float(torch.stack([g.skip_fraction for g in
                                 gates.gate_modules(model).values()]).mean())
    artifact = os.path.join(tmp, "gated")
    export_model(model, artifact, model_name=RESMOE,
                 batch_sizes=(SURF_EVAL_B,), device="cuda")
    pred = load_predictor(artifact, device="cuda")
    got = _counted(lambda: pred.predict(images), PER_RESMOE_FORWARD, 1,
                   {"k5": 12}, f"{RESMOE} gated artifact served, "
                   f"{SURF_EVAL_B} images")
    d = float(np.abs(got - want).max())
    gap = float(np.abs(default - want).max())
    _xcheck(got, want, f"{RESMOE} gated artifact (targets {GATED_TARGET}) "
            "served vs the model's eval")
    log(f"{RESMOE} gated artifact: tokens skipped at target {GATED_TARGET} "
        f"{skipped:.4f} of every gate's (mean over the 24 gates), served "
        f"vs eval max |d| {d:.3e}, eval at the default targets max |d| "
        f"{gap:.3e} from it; {time.perf_counter() - t0:.1f} s {card}")
    if not skipped > 0.0 or not gap > 0.0:
        raise AssertionError(f"gated artifact: skipped {skipped}, served vs "
                             f"eval {d}, default gap {gap}")
    del model, pred
    torch.cuda.empty_cache()


def surface_phase(card: str, tmp: str) -> None:
    """Phase 20, (a) to (c) and (e); (d) runs in the EP phase
    (``ep_layer_check``)."""
    for what, fn in (("(a) optimizers", lambda: optimizer_surface_check(
            card, tmp)), ("(b) expert_choice", lambda: expert_choice_check(
                card)), ("(c) expert dropout", lambda: expert_dropout_check(
                    card)), ("(e) gated artifact",
                             lambda: gated_artifact_check(card, tmp))):
        t0 = time.perf_counter()
        fn()
        log(f"[phase 20 {what}: {time.perf_counter() - t0:.1f} s] {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    from slim_switch_moe_vit_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"built CUDA kernels (nvcc, sm_90a) in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(_build.build()),
                           _build.PTXAS_LOG)) as f:
        for line in f:  # registers and spills of each kernel instance
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    results: dict = {}
    t_phase = time.perf_counter()

    def phase_done(what: str) -> None:
        nonlocal t_phase
        log(f"[{what}: {time.perf_counter() - t_phase:.1f} s]")
        t_phase = time.perf_counter()

    kernel_phase(results)
    phase_done("kernel phase")
    coverage_kernel_phase(results)
    phase_done("coverage kernel phase (K12, K13, D=768, f32)")
    rs = np.random.RandomState(0)
    tmp = tempfile.mkdtemp(prefix="ssmv_smoke_")
    try:
        artifact = os.path.join(tmp, "artifact")
        pred, images = serving_phase(artifact, rs)
        cross_check(artifact, pred, images)
        speed_phase(pred, card)
        del pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done("serving phases")
    trained = train_phase(card)
    phase_done("training phase")
    trained.update(capacity_phase(results, card))
    phase_done("capacity phase")
    train_cross_check()
    phase_done("training cross-check")
    resmoe_phase(card)
    phase_done("ResMoE phase")
    tmp = tempfile.mkdtemp(prefix="ssmv_driver_")
    try:
        trained.update(driver_phase(card, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("driver phase")
    tmp = tempfile.mkdtemp(prefix="ssmv_ep_")
    try:
        trained.update(ep_phase(results, card, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("EP phase")
    wide_phase(card)
    phase_done("D=768 phase")
    f32_phase(card)
    phase_done("f32 phase")
    long_phase(card)
    phase_done("N=577 phase")
    trained.update(op_path_launches())
    phase_done("op path (K12, K13)")
    tmp = tempfile.mkdtemp(prefix="ssmv_zoo_")
    try:
        zoo_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("zoo phase (cfg1, DeiT-B, distilled, ViT-L in21k, driver)")
    tmp = tempfile.mkdtemp(prefix="ssmv_distill_")
    try:
        distill_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("distillation phase (driver, DeiT-B + RegNetY-160, "
               "switchable, sparse)")
    tmp = tempfile.mkdtemp(prefix="ssmv_surface_")
    try:
        surface_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_done("phase 20 (optimizers, expert_choice, expert dropout, gated "
               "artifact)")

    # launches: K1a-K6 in the 10 training steps of phase 6, which run all
    # ten (the serving run's counts are checked in serving_phase); K7 in the
    # driver's training run, K11 in its flash eval; K9 and K8 in cfg4's
    # steps in their forms (phase 11); K10 in rank 0's cfg4 steps at ep=4
    # in the K10 form (phase 12); K12 and K13, ops on no model path as in
    # the JAX package, in the op path's calls (op_path_launches)
    if any(trained[name] == 0 for name, *_ in KERNELS):
        raise AssertionError(f"a kernel never launched on its path: {trained}")
    summary = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": trained[name], **results[name]}
        for name, route, source, replaces in KERNELS]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
