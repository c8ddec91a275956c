#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pixelrec_multimodal_tpu_torch/ops/
csrc`` and its probes from ``pixelrec_multimodal_tpu_torch/probes/csrc``
into ``build/kernels/``, runs the probes (P1: the FFMA and expf rates; P2:
the broadcast multiply-accumulate, fused and in K4's unfused pattern; P3: the pair kernels' bf16 and int8 product
loop; beside the library's square bf16 and int8 products) against their
plain versions and measures the card's peaks, which every kernel's bound
then divides by, holds each kernel against its plain PyTorch
version on the card, drives the main paths (full-catalog top-K serving at
bench.py's geometry, random weights from a seed: the flagship
concatenate-fusion model through kernel K1, then in int8 through K1q
(``precision='int8!'``), with the int8 flip point measured against K1,
then its gated-fusion twin through K2, exact, and K3, factored, and in
int8 through K2q and K3q, then its attention-fusion twin through K4,
stream, and K5, gram, then the attention cascade at
scripts/bench_cascade.py's geometry: its screens through K6, token 0, and
K1, additive, each tier of ``top_k_cascade`` and ``auto_cascade``, then
the chain alone of K1, K4, K6, K2, K3, K2q, K3q and K1q (the kernel whole
less the kernel cut after the assembly), then the wide models that take
smaller blocks: attention at d 512, K4 and the token-0 screen K6, and
concat and gated chains [1024, 512, 256] in bf16 and int8), then trains:
the frozen train step at the JAX package's training profile geometry and
against the CPU, and the ``Trainer`` at that geometry from synthetic
interactions through the data path, with checkpoints and a resume, whose
best checkpoint then serves through K1 and K1q, then the same data split
and trained through the port's command-line entry points (CSV files, a
YAML config), whose best checkpoint serves through K1, then through the
generate entry point (bf16 through K1, MMR, int8 through K1q), with the
checkpoint tools run on the same workspace, then through the evaluate
entry point (sampled candidates against the port's CPU run, the full
catalog through K1, int8 through K1q, ranking, the four baselines), then
runs the nine frozen encoder towers on the card against the CPU, makes a
catalog's language table through the precompute entry point and its
vision table through ResNet-50, and serves the flagship head on those
tables through K1, then runs the meshed paths in rank processes that
share the card (the flagship's top-K through K1 on a 1x1 NCCL mesh and
2x2 and 1x2 gloo meshes against the single-process K1, the token-0
cascade through K6, the generate, evaluate and precompute entry points
across two ranks against their single-process outputs), then searches
hyperparameters on the cli workspace (the training subsets,
then five trials of the search entry point from its default seed on the
5% subset, each trial's best checkpoint served with seen items masked:
three concat heads through K1, a gated head through K2, an attention
head through K4, and the concat and gated heads in int8 through K1q and
K2q), then preprocesses raw files, then trains the towers inside the
step (the unfrozen path at scripts/bench_training.py's geometry: a
small model card against CPU, the augmentation card against CPU,
ResNet-50 and MiniLM-L6 in bf16 with remat, without it, augmented and
frozen, CLIP with contrastive learning) and serves the fine-tuned
scorer on the fine-tuned towers' tables through K1; it checks what comes
out against the plain versions and the exact scan, and times the kernels.
Every phase prints one JSON line; any failure raises and exits non-zero. The second-to-last line is the
``kernels`` JSON object and the last line is ``{"ok": true, "device":
{...}}``.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pixelrec_multimodal_tpu_torch.probes import cuda_ms  # noqa: E402

# bench.py's geometry: the flagship model and the served catalog.
N_ITEMS, N_USERS, N_MODEL_USERS, TOP_K = 65536, 8192, 4096, 50
EMB, VISION_DIM, LANG_DIM, NUM_FEAT, N_TAGS = 64, 2048, 384, 7, 64
HIDDEN = (512, 256, 128)
SEED = 0

# NVIDIA H100 SXM data sheet (dense): bf16 and int8 tensor-core rates,
# float32 rate outside the tensor cores (one FFMA counted as two operations:
# 33.5T FFMA/s, 132 SMs x 128 lanes x 1.98 GHz), HBM rate; and the exp2 rate
# of the special-function units at the same clock, 16 a cycle per SM (CUDA C++
# Programming Guide, throughput of arithmetic instructions, compute
# capability 9.0), which bounds P1's exp chain. Every ``bound_ms`` divides
# by these rates; ``bound_ms_measured`` divides the same operations by the
# rates the probes measure in the same run (PEAKS, set by the probes
# phase), and a measured rate above its data-sheet figure is an error.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
DATASHEET = {'bf16': PEAK_BF16_FLOPS, 'int8': PEAK_INT8_OPS,
             'ffma': PEAK_F32_FLOPS / 2, 'exp': 132 * 16 * 1.98e9}
PEAKS: dict = {}
T_START = time.time()
# The whole script's wall time: the limit it must end within, and the
# target each full run keeps to, so that a host whose build and host-bound
# phases run slow still ends inside the limit (``phase_seconds`` line).
SCRIPT_LIMIT, SCRIPT_TARGET = 1200, 1000

# Kernel-vs-plain tolerance, relative to max(1, |score|): each kernel and
# its plain bf16 version round at the same points and differ only in the
# order of the float32 sums (and, in the gated kernels, in exp by an ulp);
# a hidden activation may then round to the neighbouring bf16 value
# (2**-8 relative), which moves a score by well under 2e-3 of its scale.
KERNEL_TOL = 2e-3
# The attention kernels, as tests/test_torch_cuda.py holds K2 to K5: their
# assemblies round where the plain versions do (the fused vector equals the
# plain version's bit for bit), so a pair differs by more than AGREE only
# where a hidden activation lands on the neighbouring bf16 value, the
# tensor-core sums running in another order than the plain version's. That
# happens to 0.25% to 0.46% of the pairs per hidden layer (w1 alone, d 32
# and 64, NVIDIA H100), so at most MAX_DIFFERING_PER_LAYER of the pairs per
# hidden layer of the chain may differ by more than AGREE (the float32 plain
# version differs in nearly all), and none by more than FLIP_TOL, both
# relative to max(1, |score|). At the flagship KERNEL_TOL holds for every
# pair too.
AGREE, MAX_DIFFERING_PER_LAYER, FLIP_TOL = 1e-6, 0.0075, 1e-2
# On a trained concat head one flipped bf16 rounding can move a score past
# FLIP_TOL (ROADMAP C4). There a top-50 pair past FLIP_TOL passes only
# where such roundings account for it (``flip_explanation``): at most
# FLIP_EXPLAIN_MOST of its hidden roundings that a float32 sum in another
# order may flip, taken the other way in the chain with exact sums, bring
# that chain within FLIP_MATCH of the kernel's score (relative to
# max(1, |score|), as FLIP_TOL).
FLIP_EXPLAIN_MOST, FLIP_MATCH = 2, 1e-5
# The int8 chain's codes that an activation computed another way may flip
# (ROADMAP C5; derived in ``exact_chain_int8``): how far the card's
# activation of a value may lie from the exact one, relative to
# |z| + |act(z)|; the largest slope of any activation (gelu's 1.13, rounded
# up); how far K2q's assembled first layer may lie from the plain
# version's, relative to sum_m g_m |part_m|.
ACT_REACH, ACT_SLOPE, GATE_REACH = 2.0 ** -20, 1.2, 2.0 ** -19
# Pairs of each trained int8 head whose kernel score is moved on purpose,
# log-uniformly between 10 AGREE and FLIP_TOL, to count how many the code
# flips would wrongly explain.
INT8_DECOYS = 32
# Wide heads sum more products per hidden activation (w1 at d 512 sums 512,
# where the d 64 head sums 64; h1 1,024 and 2,048 likewise), so more of
# their bf16 activations round to the other neighbour when the tensor cores
# sum in another order than the plain version. Shares of pairs past AGREE
# read on an H100: the d 512 flagship model 3.4% (the d 64 flagship: 1.3%),
# a random gelu/tanh d 512 head 7.2%, random gelu heads at h1 1,024 up to
# 12.9% and at h1 2,048 up to 22.0% (K1, chain [2048, 512, 256]), every
# pair within FLIP_TOL. Wide heads are held to WIDE_MAX_DIFFERING, above the
# largest share read and well below half (tests/test_torch_cuda.py holds
# its wide heads to the same constant); a wide head whose chain cannot flip
# (w1 = I, then the last dot) is held to MAX_DIFFERING_PER_LAYER, which
# shows its assembly exact.
WIDE_MAX_DIFFERING = 0.3
# Main path against the plain bf16 version at the full catalog: mean top-50
# overlap. The 50th and 51st of 65,536 scores can lie closer together than
# the kernel's rounding differences, so an item may swap at the boundary.
MIN_OVERLAP = 0.95
# The kernels' sources by id (ops/csrc/<name>.cu).
SOURCES = {'K1': 'pairwise_mlp', 'K2': 'gated_pairwise_mlp',
           'K3': 'gated_factored_mlp', 'K4': 'attention_mlp',
           'K5': 'attention_gram_mlp', 'K6': 'attention_screen_mlp'}
# Timed block of every kernel: the flagship widths, 256 users x 8,192 items.
TIME_B, TIME_C = 256, 8192
# The int8 flip point's chains (widths from h1 on, relu, sigmoid): one
# hidden layer of 32 to 256 at h1 32, 128 and 512 (hidden-chain operations
# per first-layer lane 2 * width, from 64, the least of any head the int8
# mode takes), then deeper chains up to 2,560, the flagship's 640 among
# them; the widest fit K1's shared memory. The flip point counts the chains
# whose h1 is a multiple of 128, as every head the scorer builds has
# (ops/pairwise_mlp.py:pack_mlp_chain pads to 128 lanes); h1 32 shows the
# kernels' fixed costs.
FLIP_CHAINS = tuple((h1, n) for h1 in (32, 128, 512)
                    for n in (32, 64, 128, 256)) + (
    (512, 128, 128), (512, 256, 128), (128, 512, 128), (128, 640, 128))
# The wide models' phases: 1,024 users (8,192 at bench.py's geometry) over
# the full catalog, one warm-up and one timed call, so that the run stays
# within its time limit; attention at d 512 (the JAX package's HPO draws
# embedding_dim from 64 to 512) and concat and gated at the hidden widths
# [1024, 512, 256].
WIDE_USERS, WIDE_EMB, WIDE_HIDDEN = 1024, 512, (1024, 512, 256)
# The int8 modes take one hidden layer at least: the `chain` phase cuts
# K1q, K2q and K3q after the assembly's quantize to one layer of this
# width, the narrowest they take.
INT8_CUT_WIDTH = 32
# The probes against their plain versions: P1's FMA rounds once where the
# plain a*x + 1 rounds twice and its exp is the card's expf against
# torch.exp, each an ulp or so per step of a contracting chain: 1e-5 of the
# value's scale; P2's fused instance likewise rounds each multiply-add once
# where its plain version rounds the product and the sum (an ulp or so per
# step; on the CPU, the fused steps emulated in float64 land within 2e-7 of
# the scale of the plain version's at K 16 to 48): 1e-5 of the value's
# scale, as P1; P2's unfused instance rounds where its plain version does:
# equal; P3's int8 modes multiply exactly on both sides and round once per
# step: equal; its bf16 mode sums in another order than the plain float32
# products, which moves a bf16 rounding of h or of the fold now and then:
# 2e-2 of the output's scale.
PROBE_TOL = {'P1': 1e-5, 'P2': 1e-5, 'P2 unfused': 0.0, 'P3 bf16': 2e-2}
# Small int8 widths for the kernel checks (multiples of 32, at least one
# hidden layer).
INT8_WIDTHS = ((96, 64, 32), (128, 256), (64, 32, 96, 32))
# The train phase: the JAX package's own frozen training profile
# (scripts/profile_frozen_roofline.py:40-50, 105-116, 160): the flagship
# widths over 4,096 users, 65,536 items and 64 tags, MLP [512, 256, 128]
# with BatchNorm, dropout 0.1, bf16 compute; AdamW at 1e-3, weight decay
# 0.01, clip 1.0; 16 batches of 32,768 an epoch, features in one packed
# table on the card, data from SEED. Timed: the median of TRAIN_EPOCHS
# epochs after a warm-up epoch.
TRAIN_USERS, TRAIN_BATCH, TRAIN_BATCHES, TRAIN_EPOCHS = 4096, 32768, 16, 3
TRAIN_LR, TRAIN_WD, TRAIN_CLIP, TRAIN_DROPOUT = 1e-3, 0.01, 1.0, 0.1
# Then the card against the CPU: TRAIN_CHECK_STEPS steps at batch
# TRAIN_CHECK_BATCH, float32, dropout 0, TF32 off, from the same weights,
# once with SGD and once with AdamW (the phase's optimizer). The float32
# sums run in other orders on the two sides. The losses hold TRAIN_TOL in
# both. SGD's update is linear in the gradient, so every parameter and
# BatchNorm statistic holds TRAIN_TOL too. AdamW divides each moment by its
# own root, and an entry whose moment changes sign between steps turns a
# rounding difference into an lr-sized one: on the CPU alone, the same 3
# steps on the same rows in another order (so other summation orders) put
# 0.0%-1.0% of the entries past 1e-5, at most 2.6e-3 apart (lr 1e-3). An
# AdamW step moves an entry by at most about lr, so AdamW's entries hold
# 2 lr a step: TRAIN_ADAM_DRIFT.
TRAIN_CHECK_BATCH, TRAIN_CHECK_STEPS = 1024, 3
TRAIN_TOL = 1e-5
TRAIN_ADAM_DRIFT = 2 * TRAIN_LR * TRAIN_CHECK_STEPS
# The trainer phase: the train phase's model and geometry driven through
# the port's data path and Trainer, from interactions made from SEED.
# TRAIN_USERS users, N_ITEMS items with a tag of N_TAGS, NUM_FEAT numerical
# columns and a description; each user prefers TRAINER_LIKED tags and has
# TRAINER_TRAIN_POS training and TRAINER_VAL_POS validation positives drawn
# from items of those tags; random negatives at ratio 1.0: 524,288
# training samples (16 batches of TRAIN_BATCH) and 65,536 validation ones.
# TRAINER_EPOCHS epochs at early-stopping patience TRAINER_PATIENCE, then
# one more after a resume; then the best checkpoint serves TOP_K for
# N_USERS users, and SEEN_USERS of them with their histories masked.
TRAINER_LIKED, TRAINER_TRAIN_POS, TRAINER_VAL_POS = 2, 64, 8
TRAINER_EPOCHS, TRAINER_PATIENCE, SEEN_USERS = 5, 2, 1024
# The cli phase: the trainer phase's items and interactions (all 72
# positives a user, split by the config's 'stratified' strategy at 0.8)
# through the port's split and train entry points, CLI_EPOCHS epochs in the
# JAX train script's float32, then CLI_SERVE_USERS users served.
CLI_EPOCHS, CLI_SERVE_USERS = 5, 1024
# The recommend phase: the cli phase's checkpoint served through the
# generate entry point for RECOMMEND_USERS users sampled by its seed, top-K
# TOP_K (the config's default), in bf16, with MMR and in int8.
RECOMMEND_USERS = 1024
# The evaluate phase: the same checkpoint through the evaluate entry point
# on a test file of the validation rows of RECOMMEND_USERS users drawn by
# EVALUATE_SEED, the workspace's train file as --train_data: the CLI's
# defaults (20 random negatives a user, the float32 candidate chain), then
# --full_catalog (K1); then, on that run's dataset, int8 over the full
# catalog (K1q), ranking and the four baselines. The card's default run
# against the port's CPU run of the same evaluation: the lists equal but
# where two scores lie within EVALUATE_TIE of each other (the float32
# chain sums in another order on each side: 4 of about 36,000 positions
# swapped on an H100), every metric within EVALUATE_TOL of the CPU
# evaluator's on those lists.
EVALUATE_SEED = SEED + 23
EVALUATE_TOL, EVALUATE_TIE = 1e-6, 1e-5
BASELINES = ('random', 'popularity', 'item_knn', 'user_knn')
# The hpo phase: the search entry point on the cli phase's workspace, its
# first HPO_TRIALS trials from the default seed (42) on the 5% subset,
# which draw three concat heads, one gated and one attention head
# (tests/test_torch_hpo.py holds the draws). Beside the cli workspace's
# resnet/sentence-bert tables they need these vision/language pairs'
# tables (and the clip pairs a clip_text_emb table, trials 0 and 3 being
# contrastive), written from SEED before the search. Each trial's best
# checkpoint then serves HPO_SERVE_USERS users over the full catalog,
# top-K, seen items masked; the concat and gated heads again in int8.
# Each trial trains HPO_EPOCHS epochs (cut from the config's 5 for the
# script's time; its int8 gate allows code flips, ROADMAP C5) and
# validates on HPO_VAL_SHARE of the split's validation rows, drawn from a
# seed (cut for the script's time: the trials train on the 5% subset, and
# the whole validation split took as long as the training). The subsets
# are cut from HPO_TRAIN_SHARE of the split's training rows, drawn from a
# seed (cut for the script's time: the trials' batches of 16 to 64 took
# 1,460 host-bound steps an epoch on the whole split's 5%).
HPO_TRIALS, HPO_EPOCHS = 5, 1
HPO_TRAIN_SHARE, HPO_VAL_SHARE = 0.1, 0.05
HPO_NEW_TABLES = (('clip', 'sentence-bert'), ('resnet', 'bert'),
                  ('clip', 'bert'), ('convnext', None))
HPO_SERVE_USERS = 1024
# The keys of JAX's meta.json (pixelrec_multimodal_tpu/training/
# trainer.py:355-369, with a config).
META_KEYS = {'epoch', 'best_early_stopping_score', 'early_stopping_metric',
             'early_stopping_direction', 'training_history', 'best_metrics',
             'scheduler_state', 'model_config'}
# The JAX package's bound for the top-50 agreement of int8 with the
# unquantized scores (tests/unit/test_pairwise_mlp.py:274-312); printed
# beside the int8 main paths, not held.
INT8_FIDELITY = 0.9
# The precompute phase: each of the nine frozen towers at its published
# geometry (random weights from SEED, the constant-initialized layer
# scales and BatchNorm statistics drawn too, so every block counts) on
# TOWER_CHECK_ITEMS items on the card and on the CPU in this process,
# float32 with TF32 off, pooled outputs within TOWER_TOL (the JAX
# package's full-size tolerance, tests/unit/test_encoders_fullsize.py:58)
# and within TOWER_FP32_TOL, which holds the card to float32 without TF32:
# the same forward with TF32 on lies past it (its reading is printed as
# tf32_max_scaled_err); then its items/s on the card at batch
# TOWER_RATE_BATCH. Then a
# PRECOMPUTE_ITEMS workspace through the precompute entry point on cuda
# (resnet + sentence-bert, no image folder: language_emb at 512 tokens),
# ResNet-50 over as many seeded uint8 224 x 224 frames through the same
# batching and device-side normalize (vision_emb), and the flagship head
# served on those two tables to PRECOMPUTE_USERS users through K1.
TOWERS = (('vision', 'resnet'), ('vision', 'clip'), ('clip_text', 'clip'),
          ('vision', 'dino'), ('vision', 'convnext'),
          ('language', 'sentence-bert'), ('language', 'bert'),
          ('language', 'roberta'), ('language', 'mpnet'))
TOWER_CHECK_ITEMS, TOWER_RATE_BATCH, TOWER_TOL = 4, 64, 2e-3
TOWER_FP32_TOL = 1e-4
# The workspace's items are cut by half for the script's time
# (SCRIPT_TARGET): at 16,384 the phase took 56.2 s on an NVIDIA H100 80GB
# HBM3 at 700.00 W, the entry point and the vision table 28.3 s of it.
PRECOMPUTE_ITEMS, PRECOMPUTE_USERS = 8192, 1024
# The e2e phase: the unfrozen path (models/end_to_end.py,
# training/e2e_steps.py) at scripts/bench_training.py:191-265's geometry:
# ResNet-50 at 224 px and MiniLM-L6 at E2E_TEXT_LEN tokens inside the step,
# embedding EMB, head HIDDEN with BatchNorm, no numerical features, no
# contrastive loss, dropout TRAIN_DROPOUT, TRAIN_USERS users, N_ITEMS items,
# N_TAGS tags, bf16 towers under remat, AdamW E2E_LR (weight decay
# TRAIN_WD, clip TRAIN_CLIP), one batch of E2E_BATCH seeded pixels and
# tokens made on the card (as the JAX bench keeps one): a warm-up step and
# E2E_STEPS timed, with remat, without it, and with both towers frozen.
# The utilization's FLOPs a sample: the towers' forward, E2E_FORWARD_FLOPS
# (ResNet-50 at 224 px about 8.2 GFLOP, MiniLM-L6 at 64 tokens about 1.4,
# a multiply-add counted as two), times 3 when trained (the forward and
# the backward's two products a forward product), plus 1 under remat (the
# recompute), times 1 when frozen; the head's 1 MFLOP or so is left out.
# Before that the card against the CPU (e2e_card_vs_cpu) and the
# augmentation with every op on at E2E_BATCH x 3 x 224 x 224, its draws
# made on the card and fed to the CPU, within E2E_AUG_TOL of the image
# scale; after it the fine-tuned towers make the catalog's tables in eval
# mode, served to E2E_SERVE_USERS users through K1, and E2E_PAIRS pairs of
# the model's own forward against the scorer's; last CLIP ViT-B/32 with
# contrastive learning (its text tower at E2E_CLIP_TEXT_LEN tokens).
E2E_BATCH, E2E_STEPS, E2E_TEXT_LEN, E2E_LR = 256, 8, 64, 1e-4
E2E_FORWARD_FLOPS = 8.2e9 + 1.4e9
E2E_CLIP_STEPS, E2E_CLIP_TEXT_LEN = 3, 77
E2E_SERVE_USERS, E2E_PAIRS = 1024, 4096
E2E_AUG_TOL = 1e-5
# The card against the CPU: a 2-stage ResNet (embedding 8, stages 16 and
# 32, two blocks each) on E2E_CHECK_PX px and a 1-layer text tower at 8
# tokens, unfrozen, batch E2E_CHECK_BATCH, float32, TF32 off, dropout 0,
# one SGD step and one AdamW step (lr TRAIN_LR) from the same weights: the
# losses within TRAIN_TOL, SGD's parameters within TRAIN_TOL, and remat on
# within TRAIN_TOL of remat off (SGD). AdamW's first step moves an entry by
# about lr either way, so a card that applied no update would lie within
# 2 lr of the CPU: AdamW's parameters are held as tests/_torch_e2e.py
# holds them against JAX, at most E2E_ADAM_MAX_SHARE of the entries past
# TRAIN_TOL and none past lr, but for the entries whose gradient is
# analytically zero (E2E_ZERO_GRADIENT: the attention key bias, softmax
# being shift invariant), which Adam moves by about lr on the sign of a
# rounding and which hold 2.1 lr. Each step on the CPU must move more
# entries past TRAIN_TOL than its gate lets through, so that a card that
# did not update fails the gate.
E2E_CHECK_PX, E2E_CHECK_BATCH = 64, 16
E2E_ADAM_MAX_SHARE = 2e-3
E2E_ZERO_GRADIENT = ('language_encoder.layer_0.attention.key.bias',)
# The preprocess phase: raw files for PREPROCESS_ITEMS items and
# PREPROCESS_USERS users, with TRAINER_LIKED preferred tags of N_TAGS and 72
# positives a user, a timestamp each (trainer_tables); titles with HTML,
# every PREPROCESS_NO_TAG-th item without a tag, every PREPROCESS_RARE_TAG-th
# with a tag of its own, grouped below PREPROCESS_TAG_THRESHOLD items) and
# one image per item, copied from the committed fixtures (JPEG_FIXTURES) by
# a permutation drawn from SEED: PREPROCESS_SHARES of the items get no file,
# a truncated one (baseline, progressive) or one under the minimum side
# PREPROCESS_MIN_SIDE (the repo's configurations' 64 pixels: the 16 x 16
# and the 41 x 35 fixture), the rest the photo-sized fixtures (384-800
# pixels on the longest edge) in turn, so the valid-item set is known in
# advance. Then the preprocess entry point on cuda (nvJPEG, compression
# off; its valid-item set equal to the prediction), the image step on the
# first PREPROCESS_COMPARE_ITEMS items again with each decoder the machine
# has (nvJPEG, then PIL where it is installed: the checks alone and the
# whole step, the valid sets equal), the cli phase's split,
# PREPROCESS_EPOCHS epochs of train and the best checkpoint served through
# K1. The card's machine has PIL, which the decoder rule would take first,
# so the entry point runs with PIL hidden (``pil_hidden``): the images are
# validated by nvJPEG, as on a machine without PIL, and the compression
# run raises for want of PIL's encoder. Before that nvJPEG against the
# fixtures' manifest (PIL's verdicts, sizes and frames): verdicts and
# sizes equal, frames within JPEG_FRAME_MAX_ERR uint8 levels at any pixel
# and JPEG_FRAME_MEAN_ERR on average (the IDCT and the chroma upsampling
# differ: at most 5 and 0.97 on an NVIDIA H100 80GB HBM3 at 700.00 W, 4:2:0
# the farthest; the photo-sized crops at most 3 and 0.62), and each frame's
# inversion must fail that gate (49-115 on average).
JPEG_FIXTURES = Path(__file__).resolve().parent / 'tests' / 'data' / 'jpeg'
JPEG_FRAME_MAX_ERR, JPEG_FRAME_MEAN_ERR = 8, 2.0
PREPROCESS_NO_TAG, PREPROCESS_RARE_TAG, PREPROCESS_TAG_THRESHOLD = 64, 97, 5
PREPROCESS_SHARES = {None: 1 / 64, 'truncated.jpg': 1 / 128,
                     'truncated_progressive.jpg': 1 / 128,
                     'small_16.jpg': 1 / 128, 'baseline_420.jpg': 1 / 128}
PREPROCESS_MIN_SIDE, PREPROCESS_EPOCHS = 64, 2
# A sixteenth of the cli phase's items and users. At its full geometry
# the phase took 325.8 s alone on an NVIDIA H100 80GB HBM3 at 700.00 W
# (the image step 2.9 ms an item, mostly the file system's copies); at
# half of it the whole script took 1,054 s of its 1,200 s on a host where
# the build and the hpo phase ran 40 s and 75 s slower than the run
# before; at a quarter, with the mesh_train phase, 1,258.7 s on a host
# where the build took 90.4 s (57.1 s on the faster host of a 924.8 s
# run); at an eighth the phase took 66.3 s of a 1,147.2 s run, whose
# target is SCRIPT_TARGET.
PREPROCESS_ITEMS, PREPROCESS_USERS = N_ITEMS // 16, TRAIN_USERS // 16
# For the script's time (SCRIPT_TARGET): the two decoders' image steps on
# 1,024 items took 10.2 s.
PREPROCESS_COMPARE_ITEMS = 512
# The mesh phase: the port's meshed paths (parallel/mesh.py) in MESH_RANKS
# spawned rank processes that share the machine's one card. NCCL refuses
# two ranks of one communicator on one device ("Duplicate GPU detected",
# ncclInvalidUsage, NCCL 2.28.9 on an NVIDIA H100 80GB HBM3 at 700.00 W),
# so NCCL runs at world size 1, through a forced 1x1 mesh that takes the
# sharded path, and 4 ranks (2x2) and 2 ranks (1x2) run gloo, whose
# collectives take the CUDA tensors as they are. Each mesh serves the
# flagship's top-K at bench.py's geometry, a warm-up and MESH_CALLS timed
# calls, held against the concat main path's single-process K1 top-K;
# at 1x2 the token-0 cascade, then the generate and evaluate entry points
# on the cli workspace and the precompute entry point on the precompute
# phase's workspace. Ranks that share a card take turns on it: their
# pairs/s is no scaling figure.
MESH_RANKS, MESH_CALLS, MESH_TIMEOUT = 4, 3, 900
# The mesh_train phase: training over the mesh (parallel/mesh.py,
# parallel/tensor_parallel.py, the meshed steps, the Trainer) in MESH_RANKS
# rank processes sharing the card (``--mesh-train-rank``), as the mesh
# phase's: NCCL for a world of one, gloo for 2 and 4 ranks. The Trainer at
# the flagship's widths (``train_model``: bf16, dropout TRAIN_DROPOUT, AdamW
# TRAIN_LR, batch TRAIN_BATCH) on the trainer phase's data cut to
# MESH_TRAIN_POS training positives a user (MESH_TRAIN_BATCHES batches an
# epoch where the trainer phase has TRAIN_BATCHES), MESH_TRAIN_EPOCHS
# epochs, on a 1x1 NCCL mesh and on 2x1 and 2x2 gloo meshes, each held
# against one process on the card: at 1x1 bit for bit (else the AdamW
# gate); at 2x1 and 2x2 the first step's loss within TRAIN_TOL and its
# parameters within 2 lr (the gradient summed in another order flips
# AdamW's first update, lr * sign(g), where g is near 0), the last
# validation loss within MESH_VAL_BOUND (bf16 and other summation orders
# let later epochs drift; PERF.md). The train entry point at 2x1 on the cli
# workspace, MESH_CLI_EPOCHS epochs, its best checkpoint served through K1
# (``cli_serve``). The unfrozen step at 2x1 at the e2e phase's geometry,
# its towers in float32 with TF32 off (in bf16 each rank rounds its
# partial weight gradients to bf16 before the sum), MESH_E2E_STEPS steps
# against one process under the e2e phase's card-against-CPU gates: the
# losses within TRAIN_TOL, the parameters at most E2E_ADAM_MAX_SHARE past
# TRAIN_TOL and none past 2 E2E_LR a step. The Trainer's comparisons keep
# bf16 products' split-K sums in float32 (``full_precision_bf16_sums``).
# ``parallel/dryrun.dryrun_multichip(MESH_RANKS)`` runs first, while the
# ranks start and load their data; then the one-process references, alone
# on the card, while the ranks wait; then the ranks' timed stages, which
# share the card with one another only.
MESH_TRAIN_POS, MESH_TRAIN_EPOCHS, MESH_VAL_BOUND = 16, 3, 5e-3
MESH_TRAIN_BATCHES = TRAIN_USERS * MESH_TRAIN_POS * 2 // TRAIN_BATCH
MESH_CLI_EPOCHS, MESH_E2E_STEPS = 2, 2


def emit(phase: str, **fields):
    """One JSON line; ``t`` is the host seconds since the script began,
    so consecutive lines bound each phase's wall time."""
    print(json.dumps({'phase': phase, 't': round(time.time() - T_START, 3),
                      **fields}), flush=True)


class PhaseClock:
    """Wall seconds of each phase of ``main``, for the ``phase_seconds``
    line: ``lap(name)`` books the seconds since the last lap (or since the
    clock was made) under ``name``."""

    def __init__(self):
        self.seconds, self._t = {}, time.time()

    def lap(self, name: str):
        now = time.time()
        self.seconds[name] = round(now - self._t, 3)
        self._t = now


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def flagship_model(seed: int = SEED, device='cuda',
                   fusion_type: str = 'concatenate', emb: int = EMB,
                   hidden: tuple = HIDDEN, n_items: int = N_ITEMS):
    """The flagship model of ``n_items`` items: random weights from
    ``seed``, BatchNorm with non-trivial running statistics, bf16
    compute."""
    from pixelrec_multimodal_tpu_torch.models.multimodal import (
        MultimodalRecommender,
    )
    gen = torch.Generator().manual_seed(seed)
    model = MultimodalRecommender(
        n_users=N_MODEL_USERS, n_items=n_items, n_tags=N_TAGS,
        num_numerical_features=NUM_FEAT, embedding_dim=emb,
        vision_feature_dim=VISION_DIM, language_feature_dim=LANG_DIM,
        use_contrastive=False, fusion_hidden_dims=hidden,
        fusion_type=fusion_type, use_batch_norm=True, dropout_rate=0.0,
        dtype=torch.bfloat16, generator=gen, device=device)
    with torch.no_grad():
        for i in range(len(hidden)):
            bn = getattr(model.prediction_network, f'BatchNorm_{i}')
            n = bn.num_features
            bn.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
            bn.weight.copy_(torch.rand(n, generator=gen) + 0.5)
            bn.bias.copy_(torch.randn(n, generator=gen) * 0.1)
    return model


def build_flagship(seed: int = SEED, device='cuda',
                   fusion_type: str = 'concatenate', emb: int = EMB,
                   hidden: tuple = HIDDEN):
    """(model, store) at bench.py's geometry: ``flagship_model`` and random
    item tables from ``seed``; ``emb`` and ``hidden`` change the embedding
    width and the MLP's widths."""
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    model = flagship_model(seed, device, fusion_type, emb, hidden)
    rng = np.random.default_rng(seed)
    store = ItemFeatureStore(N_ITEMS, np.arange(N_ITEMS).astype(str))
    store.tables['tag_idx'] = rng.integers(0, N_TAGS, N_ITEMS).astype(np.int32)
    store.tables['numerical'] = rng.standard_normal(
        (N_ITEMS, NUM_FEAT), dtype=np.float32)
    store.tables['vision_emb'] = rng.standard_normal(
        (N_ITEMS, VISION_DIM), dtype=np.float32)
    store.tables['language_emb'] = rng.standard_normal(
        (N_ITEMS, LANG_DIM), dtype=np.float32)
    return model, store


def attention_ops(head: dict, kernel: str) -> int:
    """Float32 operations per pair of an attention kernel's assembly,
    counted from its code (exps and divisions as one each):
      K6: token 0 alone, the Mi*H logit dots over dh, its softmax per head,
          5*Mi + 4, its weighted sum, 2*H*(1 + Mi)*d, plus the residual d,
          one LayerNorm, 7*d, the affine, 2*d, and the tail, d;
      both: the 2*Mi*H logit dots over dh; token 0's softmax per head,
          5*Mi + 4; the clamped exp, a and b per item token and head, 6;
      K4: token 0's weighted sum, 2*H*(1 + Mi)*d, and each item token's,
          4*H*d, each plus the residual d; LayerNorm per token, 7*d; the
          affine, 2*d;
      K5: the cross-Grams, 2*d per entry of (1 + H)*Mi*H + H*(Mi*H + Mi);
          the statistics (token 0: 5*H + 3*H*H + (2*H + 6)*Mi*H +
          2*(Mi*H)**2; each item token 9*H*H + 8*H + 9); the combination
          weights, H*(1 + 2*Mi) + Mi*H*(1 + 3*Mi) + 2*Mi; the combination
          pass, 2*d*(1 + H + Mi*H + Mi) plus d, and the affine, 2*d."""
    d, H, Mi, dh = head['d'], head['H'], head['n_item_mods'], head['dh']
    n_vo = Mi * H
    if kernel == 'K6':
        return (2 * n_vo * dh + H * (5 * Mi + 4) + 2 * H * (1 + Mi) * d
                + d + 7 * d + 3 * d)
    ops = 2 * (2 * n_vo) * dh + H * (5 * Mi + 4) + 6 * n_vo
    if kernel == 'K4':
        return (ops + 2 * H * (1 + Mi) * d + d + Mi * (4 * H * d + d)
                + (1 + Mi) * 7 * d + 2 * d)
    return (ops + 2 * d * (n_vo * (1 + H) + (n_vo + Mi) * H)
            + 5 * H + 3 * H * H + (2 * H + 6) * n_vo + 2 * n_vo * n_vo
            + Mi * (9 * H * H + 8 * H + 9)
            + H * (1 + 2 * Mi) + n_vo * (1 + 3 * Mi) + 2 * Mi
            + 2 * d * (1 + H + n_vo + Mi) + 3 * d)


def pair_ops(head: dict, h1: int, kernel: str = 'K1') -> tuple:
    """Operations per pair, split by the unit that runs them: (the hidden
    products, on the tensor cores; the assembly and the one-column dot, in
    float32 outside them). The assemblies, per pair:
      K1: add + act + bf16 rounding over h1, 3*h1 (with the products and
          the dot, bench.py's formula: 329,472 at the flagship head);
      K2: the softmax over M gates, ~6*M, and the weighted sum of M rows
          plus the activation, 2*M*h1 + h1;
      K3: Z and p0 from M products, 2*M + 2, and per column the Mi-term
          contraction, the user term, the 1/Z scale and the activation,
          (2*Mi + 4)*h1;
      K4, K5, K6: ``attention_ops``, with w1 [d, h1] among the products.
    The int8 modes K1q, K2q, K3q: their bf16 mode's assembly, and in
    float32 besides, the quantize of every hidden layer's input (multiply,
    add, floor, clamp: 4 per input element) and the rescale of its output
    (convert, multiply, add, act: 4 per output element); their products
    are int8 operations."""
    hidden = head['layers'][:-1]
    dot = 2 * head['layers'][-1][0].shape[0]
    if kernel.endswith('q'):
        prod, f32 = pair_ops(head, h1, kernel[:-1])
        return prod, f32 + sum(4 * (w.shape[0] + w.shape[1])
                               for w, _ in hidden)
    if kernel in ('K4', 'K5', 'K6'):
        hidden = [(head['w1'], head['b1'])] + list(hidden)
        assembly = attention_ops(head, kernel)
    elif kernel == 'K1':
        assembly = 3 * h1
    else:
        n_mod = head['n_item_mods'] + 1
        assembly = (2 * n_mod * h1 + h1 + 6 * n_mod if kernel == 'K2'
                    else (2 * (n_mod - 1) + 4) * h1 + 2 * n_mod + 2)
    return (sum(2 * w.shape[0] * w.shape[1] for w, _ in hidden),
            assembly + dot)


def pair_exps(head: dict, kernel: str) -> int:
    """The exps among ``pair_ops``'s float32 operations per pair, which run
    at P1's expf rate: the final sigmoid's; K2's softmax over its M gates;
    the attention kernels' token-0 softmax, H*(1 + Mi), and (K4, K5) each
    item token's clamped exp per head, Mi*H. The activations' own
    transcendentals stay among the other operations (relu at the
    flagship)."""
    kernel = kernel.rstrip('q')
    n = int(head['final_activation'] == 'sigmoid')
    if kernel == 'K2':
        n += head['n_item_mods'] + 1
    elif kernel in ('K4', 'K5', 'K6'):
        H, Mi = head['H'], head['n_item_mods']
        n += H * (1 + Mi) + (0 if kernel == 'K6' else Mi * H)
    return n


def random_head(widths, activation, final, gen, device, n_item_mods=None):
    """A folded head of the given widths with random weights (the kernel
    checks at widths other than the flagship's); ``n_item_mods`` makes it
    a gated head."""
    layers = []
    for k, n in zip(widths[:-1], widths[1:]):
        layers.append(((torch.randn(k, n, generator=gen) / k ** 0.5),
                       torch.randn(n, generator=gen) * 0.05))
    w_last = torch.zeros(widths[-1], 128)
    w_last[:, 0] = torch.randn(widths[-1], generator=gen) / widths[-1] ** 0.5
    layers.append((w_last, torch.randn(128, generator=gen) * 0.1))
    head = {'layers': [(w.to(device), b.to(device)) for w, b in layers],
            'activation': activation, 'final_activation': final,
            'b1': torch.zeros(widths[0], device=device), 'b1_folded': True}
    if n_item_mods:
        head.update(n_item_mods=n_item_mods, h1=widths[0])
    return head


def int8_head(widths, activation, final, gen, device, n_item_mods=None):
    """A ``random_head`` and its int8 twin (the same weights, quantized on
    ranges calibrated over seeded rows of 64 users x 512 items)."""
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        calibrate_head_ranges,
        calibrate_head_ranges_gated,
        quantize_head,
    )
    head = random_head(widths, activation, final, gen, device, n_item_mods)
    if n_item_mods:
        exact, _ = random_gated_rows(head, 64, 512, gen, device)
        ranges = calibrate_head_ranges_gated(head, exact[:2], exact[2:])
    else:
        ranges = calibrate_head_ranges(
            head, torch.randn(64, widths[0], generator=gen).to(device),
            torch.randn(512, widths[0], generator=gen).to(device))
    return head, quantize_head(dict(head), ranges)


def random_gated_rows(head, B, C, gen, device):
    """Seeded rows of a gated head: (exact (uf, ug, itf, ig), factored
    (uf, a, T, igb)), the factored ones derived from the exact ones as the
    scorer derives them."""
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        GATE_PAD,
        factor_gated_tables,
        factor_gated_user,
    )
    h1, mi = head['h1'], head['n_item_mods']
    gates = torch.zeros(B + C, GATE_PAD)
    gates[:, :mi + 1] = torch.randn(B + C, mi + 1, generator=gen)
    exact = (torch.randn(B, h1, generator=gen), gates[:B],
             torch.randn(C, mi * h1, generator=gen), gates[B:])
    exact = tuple(t.to(device).contiguous() for t in exact)
    return exact, (factor_gated_user(head, *exact[:2])
                   + factor_gated_tables(head, *exact[2:]))


def random_attention_head(d, heads, widths, activation, final, gen, device):
    """An attention head of embedding width d with random weights: the
    folded chain of ``random_head`` after w1 [d, widths[0]], the LayerNorm
    affine and the attention projections (Mi = 5 item tokens)."""
    head = random_head(widths, activation, final, gen, device)
    del head['b1_folded']

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    head.update(fusion='attention', d=d, H=heads, dh=d // heads,
                n_item_mods=5, h1=widths[0],
                w1=rnd(d, widths[0], scale=d ** -0.5),
                b1=rnd(widths[0], scale=0.05),
                ln_scale=(torch.rand(d, generator=gen) + 0.5).to(device),
                ln_bias=rnd(d, scale=0.1), b_out=rnd(d, scale=0.1))
    for name in ('query', 'key', 'value', 'out'):
        head[f'w_{name}'] = rnd(d, d, scale=d ** -0.5)
        head[f'b_{name}'] = rnd(d, scale=0.1)
    return head


def random_attention_rows(head, B, C, gen, device, with_gram):
    """Attention tables of seeded towers: (user side, item side)."""
    from pixelrec_multimodal_tpu_torch.ops.attention_scorer import (
        compute_item_side_attention,
        compute_user_side_attention,
    )
    d = head['d']
    users = torch.randn(B, d, generator=gen).to(device)
    feats = torch.randn(C, head['n_item_mods'], d, generator=gen).to(device)
    return (compute_user_side_attention(head, users, with_gram),
            compute_item_side_attention(head, feats, with_gram))


def screen_call(fn):
    """K6's wrapper or plain version, (head, user_side, item_side, tail),
    called as the other kernels are: (head, 5 user tensors, k, vo, tail);
    K6 reads only k and vo of the item tables."""
    def call(head, *t, **kw):
        return fn(head, t[:5], (None, None) + t[5:7], t[7], **kw)
    return call


def topc_overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Mean share of row a's entries found in row b."""
    return float(np.mean([len(set(x) & set(y)) / len(x)
                          for x, y in zip(a, b)]))


def user_item_call(fn, n_user: int):
    """An attention wrapper or plain version, (head, user_side, item_side),
    called as the other kernels are: (head, *user tensors, *item
    tensors)."""
    def call(head, *tensors, **kw):
        return fn(head, tensors[:n_user], tensors[n_user:], **kw)
    return call


def kernel_diff(kernel, plain, head, users: tuple, items: tuple,
                slice_items: int = 2048) -> tuple:
    """(max |kernel - plain bf16|, the share of pairs that differ by more
    than AGREE, the score scale max(1, |plain|)) over a block; the plain
    version runs in item slices of ``slice_items`` to bound its memory."""
    out = kernel(head, *users, *items)
    torch.cuda.synchronize()
    ref = torch.cat([plain(head, *users,
                           *(t[c:c + slice_items] for t in items),
                           compute_dtype=torch.bfloat16)
                     for c in range(0, items[0].shape[0], slice_items)],
                    dim=1)
    if not torch.isfinite(out).all():
        raise AssertionError('kernel produced non-finite scores')
    scale = max(1.0, ref.abs().max().item())
    diff = (out - ref).abs()
    return (diff.max().item(),
            (diff > AGREE * scale).float().mean().item(), scale)


def kernel_error(kernel, plain, head, users: tuple, items: tuple) -> tuple:
    """(max |kernel - plain bf16|, tolerance) over a block."""
    err, _, scale = kernel_diff(kernel, plain, head, users, items)
    return err, KERNEL_TOL * scale


def reset_launches():
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    for fn in (tpm.pairwise_scores, tpm.pairwise_scores_gated,
               tpm.pairwise_scores_gated_factored, tas.attention_scores,
               tas.attention_scores_gram, tac.attention_screen_scores):
        fn.launches = 0
    for fn in (tpm.pairwise_scores, tpm.pairwise_scores_gated,
               tpm.pairwise_scores_gated_factored):
        fn.launches_int8 = 0


def launch_counts() -> dict:
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    return {'K1': tpm.pairwise_scores.launches,
            'K2': tpm.pairwise_scores_gated.launches,
            'K3': tpm.pairwise_scores_gated_factored.launches,
            'K4': tas.attention_scores.launches,
            'K5': tas.attention_scores_gram.launches,
            'K6': tac.attention_screen_scores.launches,
            'K1q': tpm.pairwise_scores.launches_int8,
            'K2q': tpm.pairwise_scores_gated.launches_int8,
            'K3q': tpm.pairwise_scores_gated_factored.launches_int8}


def drive_top_k(scorer, users, kernel: str, phase: str, calls: int = 3,
                **fields):
    """One warm-up ``top_k``, then ``calls`` timed calls with every launch
    count set to 0 just before them and read just after; fails unless
    ``kernel`` and no other launched once per (user block, item chunk) of
    each call, or if the output is malformed. Returns (scores, items,
    launches, median seconds)."""
    scorer.top_k(users, TOP_K)  # warm-up
    reset_launches()
    times = []
    for _ in range(calls):
        t0 = time.time()
        v, i = scorer.top_k(users, TOP_K)
        times.append(time.time() - t0)
    counts = launch_counts()
    per_call = (-(-len(users) // scorer.user_chunk)
                * (scorer.n_pad // scorer.item_chunk))
    expected = {k: calls * per_call if k == kernel else 0 for k in counts}
    if counts != expected:
        raise AssertionError(f'{phase}: kernel launches {counts} != '
                             f'expected {expected}')
    if v.shape != (len(users), TOP_K) or not np.isfinite(v).all() \
            or (i < 0).any() or (i >= scorer.n_items).any() \
            or (np.diff(v, axis=1) > 0).any():
        raise AssertionError(f'{phase}: top_k output malformed')
    median = statistics.median(times)
    emit(phase, users=len(users), items=scorer.n_items, k=TOP_K,
         seconds=times, median_seconds=median,
         pairs_per_sec=len(users) * scorer.n_items / median,
         kernel_launches=counts, expected_launches=expected,
         launches_per_call=per_call, block_rows=scorer.block_rows, **fields)
    return v, i, counts[kernel], median


def plain_bf16_other_order(head: dict, user_first: torch.Tensor,
                           item_first: torch.Tensor,
                           seed: int = SEED) -> torch.Tensor:
    """K1's plain bf16 version (``pairwise_scores_plain``) with every
    float32 sum of the chain taken in another order (the products' k
    permuted, the last dot reversed): the same rounding points, so it
    shows how far two valid summation orders put the scores apart."""
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    act = tpm.activation_fn(head['activation'])
    x = (user_first.to(bf16).float()[:, None, :]
         + item_first.to(bf16).float()[None, :, :]).to(bf16)
    x = act(x.float()).to(bf16).reshape(-1, x.shape[-1])
    for w, b in head['layers'][:-1]:
        p = torch.randperm(w.shape[0], generator=gen).to(x.device)
        acc = x.float()[:, p] @ w.to(bf16).float()[p]
        x = act((acc + b.to(bf16).float()).to(bf16).float()).to(bf16)
    w_last, b_last = head['layers'][-1]
    s = (x.float() * w_last[:, 0].to(bf16).float()).flip(1).sum(1) \
        + b_last[0].float()
    return tpm.final_activation_fn(s, head['final_activation']).reshape(
        user_first.shape[0], -1)


def _bf16_other_side(z: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The bf16 neighbour of ``h`` (``z`` rounded to bf16) on ``z``'s side
    of it: what ``z`` rounds to when its rounding falls the other way."""
    bits = h.view(torch.int16).to(torch.int32)
    step = torch.where((z > h.double()) ^ (bits < 0), 1, -1)
    return ((bits + step + 32768) % 65536 - 32768).to(torch.int16).view(
        torch.bfloat16)


def exact_chain(chain: dict, x: torch.Tensor, forced=None):
    """``_chain_scores_bf16`` on the bf16 rows ``x`` with every sum exact
    (float64): the plain bf16 version's roundings, none of them moved by a
    summation order. ``forced`` (one bool mask [rows, width] per hidden
    layer): those roundings fall the other way. Returns the scores [rows]
    (float64) and, per hidden layer, the mask of the roundings that a
    float32 sum in another order may flip: the exact sum lies within
    (K + 1) 2**-23 sum|terms| of the tie between its two bf16 neighbours,
    the reach of a K-term float32 sum plus the bias's add when each addition
    truncates (round to nearest reaches half as far)."""
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    bf16 = torch.bfloat16
    act = tpm.activation_fn(chain['activation'])
    flippable = []
    for layer, (w, b) in enumerate(chain['layers'][:-1]):
        w, b, xd = w.to(bf16).double(), b.to(bf16).double(), x.double()
        z = xd @ w + b
        h = z.to(bf16)
        other = _bf16_other_side(z, h)
        reach = (w.shape[0] + 1) * 2.0 ** -23 * (xd.abs() @ w.abs()
                                                 + b.abs())
        flippable.append((z - (h.double() + other.double()) / 2).abs()
                         <= reach)
        if forced is not None:
            h = torch.where(forced[layer], other, h)
        x = act(h.float()).to(bf16)
    w_last, b_last = chain['layers'][-1]
    s = x.double() @ w_last[:, 0].to(bf16).double() + b_last[0].double()
    return tpm.final_activation_fn(s, chain['final_activation']), flippable


def _quantize(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The int8 codes of float32 values under a quantized layer's
    ``params``: clamp(floor(v * inv_a + off), -128, 127), each step
    rounded to float32 (``_chain_scores_int8``)."""
    return torch.clamp(torch.floor(v * p[2, 0] + p[2, 1]), -128, 127)


def _code_flips(v64: torch.Tensor, reach: torch.Tensor, p: torch.Tensor,
                bf16_in: bool) -> tuple:
    """(codes, their other values, the mask of the codes that may flip) of
    the exact activations ``v64`` (float64) under the quantize of ``p``,
    where the card's activations may lie ``reach`` from them. The codes
    are the plain version's of ``v64`` rounded to float32 (then to bf16
    where ``bf16_in``). ``bf16_in``: a code flips where ``v64`` lies within
    ``reach`` of the tie between its two bf16 neighbours and the other one
    quantizes to another code. Otherwise where the value before floor,
    u = v64 inv_a + off (float64), lies within inv_a reach + 2**-24
    (|v64 inv_a| + |u|) (the float32 product's and sum's roundings) of an
    integer n in [-127, 127]: the code then takes n's other side (at the
    clamp's ends both sides give the same code)."""
    if bf16_in:
        h = v64.float().to(torch.bfloat16)
        other = _bf16_other_side(v64, h)
        codes, flipped = _quantize(h.float(), p), _quantize(other.float(), p)
        tie = (h.double() + other.double()) / 2
        return codes, flipped, ((v64 - tie).abs() <= reach) & (
            codes != flipped)
    codes = _quantize(v64.float(), p)
    inv_a, off = p[2, 0].double(), p[2, 1].double()
    u = v64 * inv_a + off
    n = torch.round(u)
    reach_u = inv_a.abs() * reach + 2.0 ** -24 * ((v64 * inv_a).abs()
                                                  + u.abs())
    return codes, (2 * n - 1 - codes.double()).float(), (
        ((u - n).abs() <= reach_u) & (n.abs() <= 127))


def exact_chain_int8(head: dict, x: torch.Tensor, forced=None):
    """The plain int8 chain (``_chain_scores_int8`` after the bf16 rounding
    of the activated first layer) from the first-layer pre-activations
    ``x[:, 0]`` [rows, h1] (float32), with every activation exact (float64,
    rounded to float32), every value before ``floor`` in float64 and the
    last dot exact (float64). ``x[:, 1]``: how far the kernel's
    pre-activations may lie from ``x[:, 0]``. ``forced`` (one bool mask
    [rows, width] per int8 layer): those codes take their other value.
    Returns the scores [rows] (float64) and, per int8 layer, the mask of
    the codes that the kernel may take otherwise (``_code_flips``).

    Kernel and plain version round at the same points: the quantize
    fl(fl(v inv_a) + off), the exact integer products, the rescale
    fl(fl(f32(acc) out_scale) + bias_eff). They part where each computes
    an activation: CUDA's tanhf and expf (2 ulp each) in ``act_fn`` against
    PyTorch's, and gelu's polynomial (six more roundings). Each side lies
    within 8 ulp of |z| + |v| of the exact v = act(z), so the reach of a
    value is ACT_REACH (|z| + |v|) = 2**-20 (|z| + |v|), plus ACT_SLOPE
    times how far the kernel's z may lie from the plain version's; relu is
    exact on both sides (reach 0 but for that). In a hidden layer the z are
    equal. In the first, K1q's rows are the plain version's (the bf16 add
    of the bf16 rows); K2q's softmax gates take the card's expf against
    torch.exp (3 ulp apart), and the weighted sum of at most 8 parts rounds
    each product and sum again: its rows lie within 31 ulp of
    sum_m g_m |part_m| of the plain version's, GATE_REACH = 2**-19 of it,
    which ``int8_chain_inputs`` puts in ``x[:, 1]``. The last dot differs
    only in its float32 order (about 1e-7)."""
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    act = tpm.activation_fn(head['activation'])
    act_reach = 0.0 if tpm.ACTIVATIONS.get(
        head['activation'].lower(), 0) == 0 else ACT_REACH
    z, dz = x[:, 0].double(), x[:, 1].double()
    flippable = []
    for layer, q in enumerate(head['qlayers']):
        v64 = act(z)
        reach = act_reach * (z.abs() + v64.abs()) + ACT_SLOPE * dz
        codes, flipped, mask = _code_flips(v64, reach, q['params'],
                                           bf16_in=layer == 0)
        flippable.append(mask)
        if forced is not None:
            codes = torch.where(forced[layer], flipped, codes)
        p = q['params']
        acc = (codes.double() @ q['wq'].double()).float()
        z, dz = (acc * p[0] + p[1]).double(), torch.zeros_like(z[:, :1])
    w_last, b_last = head['layers'][-1]
    s = act(z).float().double() @ w_last[:, 0].double() + b_last[0].double()
    return tpm.final_activation_fn(s, head['final_activation']), flippable


def flip_explanation(chain: dict, x: torch.Tensor, target: np.ndarray,
                     scale: np.ndarray, explain,
                     most: int = FLIP_EXPLAIN_MOST,
                     exact=exact_chain) -> dict:
    """How far roundings that fall the other way move the scores of the
    rows ``x`` (one pair each) through ``chain``, from the chain with exact
    sums (``exact``, ``exact_chain`` for bf16 roundings on bf16 rows,
    ``exact_chain_int8`` for int8 codes; its scores are ``exact``).
    ``single_move`` [rows]: the largest move, over ``scale``, that one
    flippable rounding of the row makes alone; ``flippable`` [rows]: their
    number. For each row in ``explain``, greedy, the flips that bring the
    exact chain nearest the kernel's score ``target``, at most ``most`` of
    them, each step over the roundings flippable on the path with the
    flips taken so far: ``residuals`` (|target - score| / scale after 0,
    1, ... flips) and ``flips`` ((layer, unit) each)."""
    base, flippable = exact(chain, x)
    widths = [m.shape[1] for m in flippable]
    found = [m.nonzero().cpu().numpy() for m in flippable]
    none = [np.zeros(0, np.int64)]  # a head with no hidden layer
    cand_row = np.concatenate([f[:, 0] for f in found] + none)
    cand_layer = np.concatenate([np.full(len(f), k)
                                 for k, f in enumerate(found)] + none)
    cand_unit = np.concatenate([f[:, 1] for f in found] + none)

    def forced_masks(n, var, layer, unit):
        """Masks for ``n`` variants, variant ``var[j]`` with the rounding
        (``layer[j]``, ``unit[j]``) forced the other way."""
        forced = [torch.zeros(n, w, dtype=torch.bool, device=x.device)
                  for w in widths]
        for k in range(len(widths)):
            sel = layer == k
            forced[k][torch.as_tensor(var[sel], device=x.device),
                      torch.as_tensor(unit[sel], device=x.device)] = True
        return forced

    def scores(rows, var, layer, unit):
        """Exact-sum scores of ``x[rows]`` with ``forced_masks``'s
        flips."""
        return exact(chain, x[torch.as_tensor(rows, device=x.device)],
                     forced_masks(len(rows), var, layer, unit)
                     )[0].cpu().numpy()

    base_np = base.cpu().numpy()
    single, batch = np.zeros(x.shape[0]), 4096
    for s0 in range(0, len(cand_row), batch):
        rows = cand_row[s0:s0 + batch]
        moved = np.abs(scores(rows, np.arange(len(rows)),
                              cand_layer[s0:s0 + batch],
                              cand_unit[s0:s0 + batch]) - base_np[rows])
        np.maximum.at(single, rows, moved / scale[rows])
    explained = {}
    for r in explain:
        flips, res = [], [abs(target[r] - base_np[r]) / scale[r]]
        for _ in range(most):
            # the roundings flippable on the path with ``flips`` taken:
            # a flip moves the next layer's sums
            now = exact(chain, x[r:r + 1], forced_masks(
                1, np.zeros(len(flips), np.int64),
                np.array([f[0] for f in flips], np.int64),
                np.array([f[1] for f in flips], np.int64)))[1]
            tries = [(k, u) for k, m in enumerate(now)
                     for u in m[0].nonzero()[:, 0].tolist()
                     if (k, u) not in flips]
            if not tries:
                break
            picks = [flips + [t] for t in tries]
            got = np.abs(target[r] - scores(
                np.full(len(picks), r),
                np.repeat(np.arange(len(picks)), len(flips) + 1),
                np.array([f[0] for p in picks for f in p], np.int64),
                np.array([f[1] for p in picks for f in p], np.int64))
            ) / scale[r]
            best = int(np.argmin(got))
            if got[best] >= res[-1]:
                break
            flips.append(tries[best])
            res.append(float(got[best]))
        explained[int(r)] = {'residuals': res, 'flips': flips}
    return {'single_move': single, 'exact': base_np,
            'flippable': np.bincount(cand_row, minlength=x.shape[0]),
            'explained': explained}


def concat_first_layer(scorer, user_first: torch.Tensor,
                       items: torch.Tensor) -> torch.Tensor:
    """The bf16 first-layer pre-activations that K1's plain bf16 version
    (``pairwise_scores_plain``) forms for user row r of ``user_first``
    against the items ``items[r]`` (positions, [users, k]), in that order:
    [users * k, h1]."""
    bf16 = torch.bfloat16
    x = (user_first.to(bf16).float()[:, None, :]
         + scorer._scan_tables[0][items].to(bf16).float()).to(bf16)
    return x.reshape(-1, x.shape[-1])


def concat_chain_inputs(scorer, user_first: torch.Tensor,
                        items: torch.Tensor) -> torch.Tensor:
    """The bf16 rows that K1's plain bf16 version feeds its hidden chain:
    ``concat_first_layer`` activated and rounded to bf16."""
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    x = concat_first_layer(scorer, user_first, items)
    return tpm.activation_fn(scorer._head['activation'])(x.float()).to(
        torch.bfloat16)


def int8_chain_inputs(scorer, side: tuple, items: torch.Tensor
                      ) -> torch.Tensor:
    """``exact_chain_int8``'s rows [users * k, 2, h1] for user row r of
    ``side`` (``_fast_user_side``) against the items ``items[r]``
    (positions, [users, k]): the first-layer pre-activations that the
    plain int8 version activates and rounds to bf16 before its chain
    (``concat_first_layer``; a gated head's float32 assembly, as
    ``pairwise_scores_gated_plain`` forms it), and how far the kernel's
    may lie from them (0; gated: GATE_REACH sum_m g_m |part_m|)."""
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    head = scorer._head
    if head['fusion'] == 'concatenate':
        z = concat_first_layer(scorer, side[0], items).float()
        return torch.stack([z, torch.zeros_like(z)], dim=1)
    (uf, ug), (itf, ig) = side, (t[items] for t in scorer._scan_tables)
    z = tpm._gated_first_layer(head, uf[:, None], ug[:, None], itf, ig)
    parts = tpm._gated_first_layer(head, uf.abs()[:, None], ug[:, None],
                                   itf.abs(), ig)
    return torch.stack([z, GATE_REACH * parts], dim=2).reshape(
        -1, 2, z.shape[-1])


def check_against_plain(scorer, plain, users, v, i, phase, f32=True,
                        gate='raw', seen=None):
    """The main path's top-50 over 64 users against the plain bf16 version
    of the same tables at the full catalog: overlap >= MIN_OVERLAP, values
    and ``score_full`` within KERNEL_TOL. Optionally reports the overlap
    with the plain float32 version too (bf16 against f32, not a fault).
    ``seen`` ([users, N_ITEMS] bool, True = excluded): the main path ran
    with these items masked, so the plain versions' top-50 is taken over
    the rest too.

    ``gate='score_full_vs_f32'`` (a concat head of a trained model):
    KERNEL_TOL was read on random weights. On the trained flagship head one
    bf16 rounding that falls the other way moves a score further: two plain
    bf16 versions summing in other orders (``plain_bf16_other_order``)
    already lie past KERNEL_TOL on a few pairs of ``score_full`` (9.9e-3 on
    an NVIDIA H100). There ``score_full`` is held instead to lie no farther
    from the plain float32 version than the plain bf16 version does, plus
    KERNEL_TOL; every distance is printed. Overlap and top-50 values keep
    their gates.

    ``gate='score_full_vs_f32_top50_flips'`` (the cli phase's float32-trained
    head served in bf16): ``score_full`` as above, and the top-50 values
    held pair by pair against the plain bf16 scores of the same items. On
    that head two plain bf16 summation orders put top-50 values up to
    2.79e-3 apart (NVIDIA H100), past KERNEL_TOL, so a bf16 rounding that
    falls the other way may move a top-50 value past it too: at most
    MAX_DIFFERING_PER_LAYER of the pairs per hidden layer may lie past
    KERNEL_TOL, and none past FLIP_TOL (both relative to max(1, |score|)),
    the same share and bound that hold the flips of the attention kernels.
    On a concat head one flipped rounding can move a score past FLIP_TOL
    (ROADMAP C4), so there a pair past it passes only where
    ``flip_explanation`` accounts for it to FLIP_MATCH; every pair past
    KERNEL_TOL is explained and printed, with the largest move one
    flippable rounding makes on a top-50 pair.
    The two plain orders' count on the same pairs is printed beside the
    kernel's. The hpo phase holds its trained gated and attention heads
    (K2, K4) by the same gate: their other-order plain version is not
    computed (``plain_bf16_other_order`` is K1's chain), and an attention
    head's w1 counts as a hidden layer (its products round to bf16 before
    the chain, as K1's hidden layers' do)."""
    if gate not in ('raw', 'score_full_vs_f32',
                    'score_full_vs_f32_top50_flips'):
        raise ValueError(f'unknown gate {gate!r}')
    trained = gate != 'raw'
    n_items = scorer.n_items
    with torch.no_grad():
        side = scorer._fast_user_side(
            torch.from_numpy(users[:64].astype(np.int64)).to(
                scorer._scan_tables[0].device))

        def scores(dtype, fn=plain):
            kw = {} if fn is plain_bf16_other_order else \
                {'compute_dtype': dtype}
            return torch.cat([fn(scorer._head, *side,
                                 *(t[c:min(c + 4096, n_items)]
                                   for t in scorer._scan_tables), **kw)
                              for c in range(0, n_items, 4096)], dim=1)
        masked = (lambda t: t) if seen is None else (
            lambda t: t.masked_fill(torch.from_numpy(seen[:64]).to(t.device),
                                    float('-inf')))
        ref = scores(torch.bfloat16)
        ref_v, ref_i = (t.cpu().numpy()
                        for t in torch.topk(masked(ref), TOP_K, 1))
        extra = {}
        if f32 or trained:
            exact = scores(torch.float32)
            f32_i = torch.topk(masked(exact), TOP_K, 1)[1]
            extra['top50_overlap_vs_plain_f32'] = float(np.mean(
                [len(set(a) & set(b)) / TOP_K
                 for a, b in zip(i[:64], f32_i.cpu().numpy())]))
        other = None
        if trained and scorer._head.get('fusion') == 'concatenate':
            other = scores(torch.bfloat16, plain_bf16_other_order)
    overlap = float(np.mean([len(set(a) & set(b)) / TOP_K
                             for a, b in zip(i[:64], ref_i)]))
    value_err = float(np.abs(v[:64] - ref_v).max())
    full = scorer.score_full(users[:64])
    full_err = float(np.abs(full - ref.cpu().numpy()).max())
    tol = KERNEL_TOL * max(1.0, float(np.abs(ref_v).max()))
    values_ok = value_err <= tol
    full_ok = full_err <= tol
    if gate == 'score_full_vs_f32_top50_flips':
        with torch.no_grad():
            at = torch.from_numpy(i[:64].astype(np.int64)).to(ref.device)
            ref_at = ref.gather(1, at).cpu().numpy()
        scale = np.maximum(1.0, np.abs(ref_at))
        rel = np.abs(v[:64] - ref_at) / scale
        hidden = len(scorer._head['layers']) - 1 + (
            scorer._head.get('fusion') == 'attention')
        allowed = int(MAX_DIFFERING_PER_LAYER * hidden * rel.size)
        past = int((rel > KERNEL_TOL).sum())
        over = rel.ravel() > FLIP_TOL
        if scorer._head.get('fusion') == 'concatenate':
            with torch.no_grad():
                flips = flip_explanation(
                    scorer._head, concat_chain_inputs(scorer, side[0], at),
                    v[:64].ravel(), scale.ravel(),
                    np.flatnonzero(rel.ravel() > KERNEL_TOL))
            ex = flips['explained']
            over &= np.array([r not in ex
                              or ex[r]['residuals'][-1] > FLIP_MATCH
                              for r in range(rel.size)])
            extra.update(
                top50_exact_sums_vs_plain_max_rel_diff=float(np.max(
                    np.abs(flips['exact'] - ref_at.ravel()) / scale.ravel())),
                top50_max_single_flip_move=float(flips['single_move'].max()),
                top50_flippable_per_pair_mean=float(
                    flips['flippable'].mean()),
                top50_flippable_per_pair_max=int(flips['flippable'].max()),
                top50_pairs_past_tol_explained=[
                    {'pair': r, 'rel_diff': float(rel.ravel()[r]), **e}
                    for r, e in sorted(ex.items(),
                                       key=lambda kv: -rel.ravel()[kv[0]])],
                flip_explain_most=FLIP_EXPLAIN_MOST, flip_match=FLIP_MATCH)
        values_ok = past <= allowed and not over.any()
        extra.update(
            top50_pairs_past_flip_tol_unexplained=int(over.sum()),
            top50_same_item_max_abs_diff=float(np.abs(v[:64] - ref_at).max()),
            top50_pairs=int(rel.size), top50_pairs_past_tol=past,
            top50_pairs_allowed_past_tol=allowed, flip_tol=FLIP_TOL,
            hidden_layers=hidden,
            top50_values_gate='pairs past tol <= MAX_DIFFERING_PER_LAYER x '
                              'hidden layers, none past FLIP_TOL unless '
                              'flipped roundings account for it (concat)')
        if other is not None:
            with torch.no_grad():
                other_at = other.gather(1, at).cpu().numpy()
            extra.update(
                plain_other_order_top50_pairs_past_tol=int(
                    (np.abs(other_at - ref_at) / scale > KERNEL_TOL).sum()),
                plain_other_order_top50_same_item_max_abs_diff=float(
                    np.abs(other_at - ref_at).max()))
    if trained:
        exact = exact.cpu().numpy()
        kernel_f32 = np.abs(full - exact)
        plain_f32 = np.abs(ref.cpu().numpy() - exact)
        full_ok = kernel_f32.max() <= plain_f32.max() + tol
        if other is not None:
            order = (other - ref).abs().cpu().numpy()
            extra.update(
                plain_other_order_max_abs_diff=float(order.max()),
                plain_other_order_pairs_past_tol=int((order > tol).sum()))
        extra.update(
            score_full_pairs_past_tol=int((np.abs(full - ref.cpu().numpy())
                                           > tol).sum()),
            score_full_vs_plain_f32_max_abs_diff=float(kernel_f32.max()),
            plain_bf16_vs_plain_f32_max_abs_diff=float(plain_f32.max()),
            score_full_gate='vs plain f32 <= plain bf16 vs plain f32 + tol')
    emit(phase, users=64, items=n_items, seen_masked=seen is not None,
         top50_overlap_vs_plain_bf16=overlap, min_overlap=MIN_OVERLAP,
         top50_value_max_abs_diff=value_err,
         score_full_max_abs_diff=full_err, tol=tol, **extra)
    if overlap < MIN_OVERLAP or not values_ok or not full_ok:
        raise AssertionError(f'{phase}: main path disagrees with the plain '
                             f'version')
    if v.min() <= -1e30 / 2:
        raise AssertionError(f'{phase}: masked scores in the top-k')


def kernel_line(name, kernel_id, source, replaces, tpu, head, h1, args,
                kernel, plain, launches, err, tol, library_note,
                tpu_module='pairwise_mlp', function_of=None):
    """The ``kernels`` entry of one kernel, timed at the TIME_B x TIME_C
    flagship block ``args`` (users first, then items); ``replaces`` is the
    line of the TPU kernel in ``pixelrec_multimodal_tpu/ops/<tpu_module>.py``.
    The bound counts the operations of kernel ``function_of`` where that
    kernel computes the same function with less work (K5 computes K4's
    scores): ``bound_ms_algorithm`` is then the bound of this kernel's own
    operations. An int8 mode (K1q, K2q, K3q) counts its products at the
    int8 rate and times its plain version in int8 too. The float32
    operations count a multiply and an add as two, one FFMA for the pair:
    the function needs no more, though the kernels write them unfused.
    ``bound_ms`` divides by the data sheet's rates (the float32 operations,
    exps among them, at 67 TFLOP/s); ``bound_ms_measured`` by the probes'
    (PEAKS): products at the measured bf16 or int8 peak, each pair of
    float32 operations at P1's FFMA rate and the exps at P1's expf rate.
    """
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import kernel_chain
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(head, *args), reps=20)
        plain_ms = cuda_ms(lambda: plain(head, *args,
                                         compute_dtype=torch.bfloat16),
                           reps=3)

    def ops_ms(kid, peaks):  # (tensor-core ms, f32 ms) at the timed block
        prod, f32 = pair_ops(head, h1, kid)
        exps = 0 if peaks is DATASHEET else pair_exps(head, kid)
        tensor = peaks['int8' if kid.endswith('q') else 'bf16']
        f32_s = (f32 - exps) / (2 * peaks['ffma']) + (
            exps / peaks['exp'] if exps else 0.0)
        return (TIME_B * TIME_C * prod / tensor * 1e3,
                TIME_B * TIME_C * f32_s * 1e3)

    mma_ms, f32_ms = ops_ms(function_of or kernel_id, DATASHEET)
    chain = kernel_chain(head)  # the tensors the kernel reads (its mode's)
    n_bytes = (sum(t.numel() * t.element_size() for t in args)
               + TIME_B * TIME_C * 4
               + sum(chain[k].numel() * chain[k].element_size()
                     for k in ('w', 'b', 'w_last', 'b_last')))
    op_ms = max(mma_ms, f32_ms)
    byte_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    line = {
        'name': name, 'route': 'cuda',
        'source': f'pixelrec_multimodal_tpu_torch/ops/csrc/{source}',
        'replaces': f'pixelrec_multimodal_tpu/ops/{tpu_module}.py:{replaces}',
        'tpu': f'ops/{tpu_module}.py:{tpu}', 'kernel': kernel_id,
        'launches': launches, 'max_abs_err': err, 'tol': tol,
        'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': max(op_ms, byte_ms),
        'bound_by': 'operations' if op_ms >= byte_ms else 'bytes',
        'bound_ms_tensor_ops': mma_ms, 'bound_ms_f32_ops': f32_ms,
        'bound_ms_bytes': byte_ms,
        'bound_ms_measured': max(max(ops_ms(function_of or kernel_id,
                                            PEAKS)), byte_ms),
        'exps_per_pair': pair_exps(head, function_of or kernel_id),
        'library_ms': None, 'library_note': library_note,
        'shape': [TIME_B, TIME_C],
        'tflops': TIME_B * TIME_C * sum(pair_ops(head, h1, kernel_id))
        / (ms * 1e-3) / 1e12,
        **block_of(kernel_id, head),
    }
    if function_of:
        line['bound_ops_of'] = function_of
        line['bound_ms_algorithm'] = max(max(ops_ms(kernel_id, DATASHEET)),
                                         byte_ms)
    return line


def probe_checks(dev) -> dict:
    """Each probe against its plain version on the card at a small grid
    (three passes; P3 on 1,000 rows, in its block and, where that is 128
    rows, in a 64-row block too), PROBE_TOL relative to the output's scale
    (int8 modes: equal). Returns (max_abs_err, tol) per probe."""
    from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
    from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr
    out = {}

    def hold(key, got, ref, tol_rel, **fields):
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f'{key}: non-finite output')
        err = (got - ref).abs().max().item()
        tol = tol_rel * max(1.0, ref.abs().max().item())
        emit('probe_vs_plain', probe=key, max_abs_err=err, tol=tol,
             bit_equal=bool(torch.equal(got, ref)), **fields)
        if not err <= tol:
            raise AssertionError(f'{key}: error {err} > {tol}')
        out[key] = (err, tol)

    x = tvr.chain_inputs(dev, SEED)
    for kind in tvr.KINDS:
        hold(f'P1 {kind}', tvr.vpu_chain(x, tvr.K_LO, kind, steps=3),
             tvr.chain_plain(x, tvr.K_LO, kind), PROBE_TOL['P1'],
             shape=list(x.shape), k=tvr.K_LO)
    w, v = tvr.bcast_inputs(dev, SEED)
    ref = tvr.bcast_plain(w, v, tvr.BC_K_HI)
    for key, fused in (('P2', True), ('P2 unfused', False)):
        hold(key, tvr.vpu_bcast(w, v, tvr.BC_K_HI, steps=3, fused=fused),
             ref, PROBE_TOL[key], shape=[tvr.BC_TB, tvr.BC_TC, tvr.BC_DP],
             k=tvr.BC_K_HI, fused=fused)
    for mode in tmx.MODES:
        t = tmx.inputs(mode, dev, rows=1000, seed=SEED)
        ref = tmx.chain_plain(*t, mode)
        hold(f'P3 {mode}', tmx.mxu_chain(*t, mode, instances=3), ref,
             PROBE_TOL.get(f'P3 {mode}', 0.0), rows=1000, k=tmx.K,
             block_rows=tmx.block_rows(mode))
        if tmx.block_rows(mode) != 64:  # the block probe_rates times too
            hold(f'P3 {mode} block 64', tmx.mxu_chain(
                *t, mode, instances=3, _block_rows=64), ref,
                PROBE_TOL.get(f'P3 {mode}', 0.0), rows=1000, k=tmx.K,
                block_rows=64)
    return out


def probe_rates(smi) -> dict:
    """The probes' rates at the Pallas scripts' sizes, with every probe's
    launch count set to 0 just before and read just after, and the library's
    square products; P3 in the block its library chooses by fit, and its
    modes whose chosen block is 128 rows (int8) in the 64-row block beside
    it (``P3_block_64``). Sets PEAKS: bf16 and int8 the higher of P3's rate
    in its chosen block and the square product's, ffma and exp P1's;
    raises if one passes its data-sheet figure. Returns the measurements by
    probe."""
    from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
    from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr
    for fn in (tvr.vpu_chain, tvr.vpu_bcast, tmx.mxu_chain):
        fn.launches = 0
    with torch.no_grad():
        rates = {'P1': {k: tvr.measure_chain(k) for k in tvr.KINDS},
                 'P2': tvr.measure_bcast(),
                 'P2_unfused': tvr.measure_bcast(fused=False),
                 'P3': {m: tmx.measure(m) for m in tmx.MODES}}
        rates['P3_block_64'] = {m: tmx.measure(m, block=64)
                                for m in tmx.MODES
                                if tmx.block_rows(m) != 64}
    launches = {'P1': tvr.vpu_chain.launches, 'P2': tvr.vpu_bcast.launches,
                'P3': tmx.mxu_chain.launches}
    if not all(launches.values()):
        raise AssertionError(f'a probe was not launched: {launches}')
    rates['square'] = tmx.measure_square()
    for key in ('P1', 'P2', 'P3'):
        emit(f'probe_{key}', launches=launches[key], nvidia_smi=smi,
             **({'rates': rates[key]} if key != 'P2' else
                {**rates[key], 'unfused': rates['P2_unfused']}),
             **({'rates_block_64': rates['P3_block_64']} if key == 'P3'
                else {}))
    sq = rates['square']
    PEAKS.update(
        bf16=max(rates['P3']['bf16']['ops_per_s'],
                 sq['matmul_bf16_ops_per_s']),
        int8=max(rates['P3']['int8_raw']['ops_per_s'],
                 sq['int_mm_ops_per_s']),
        ffma=rates['P1']['fma']['ffma_per_s'],
        exp=rates['P1']['exp']['exp_per_s'])
    p2_ffma = rates['P2']['instructions_per_s']
    emit('peaks', measured=PEAKS, datasheet=DATASHEET, square=sq,
         p2_ffma_per_s=p2_ffma,
         units='bf16, int8: tensor-core operations/s; ffma: FFMA '
               'instructions/s (two operations each on the data sheet), '
               "P1's chain; p2_ffma_per_s: P2's fused multiply-adds/s; "
               'exp: expf calls/s', nvidia_smi=smi)
    for key, limit in DATASHEET.items():
        if PEAKS[key] > limit:
            raise AssertionError(f'measured {key} rate {PEAKS[key]} passes '
                                 f'its data-sheet figure {limit}')
    if p2_ffma > DATASHEET['ffma']:
        raise AssertionError(f'P2 measured {p2_ffma} FFMA/s, past the data '
                             f"sheet's {DATASHEET['ffma']}")
    rates['launches'] = launches
    return rates


def probe_lines(rates: dict, errs: dict, dev) -> list:
    """The ``kernels`` entries of P1-P3 at the Pallas scripts' sizes: each
    launch's time and its plain version's on the same work (P1: the FMA
    chain at K_HI, the exp chain beside it; P2 fused at BC_K_HI, the
    unfused instance beside it; P3 the bf16 mode,
    the int8 modes beside it, with the torch.matmul chain of the same work
    as the library's time), the bound of that work at the data sheet's
    rates (P1: an FFMA, or an exp on the special-function units, per
    element-op; P2: one FFMA per multiply-add) and at the measured ones."""
    from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
    from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr
    lines = []
    x = tvr.chain_inputs(dev, SEED)
    steps = tvr.STEPS
    n_chain = x.numel() * steps * tvr.K_HI
    with torch.no_grad():
        wide = x.expand((steps,) + tuple(x.shape))
        p1 = {}
        for kind in tvr.KINDS:
            p1[kind] = (rates['P1'][kind]['ms'][1],
                        cuda_ms(lambda: tvr.chain_plain(wide, tvr.K_HI, kind),
                                reps=1))
        rate_key = {'fma': 'ffma', 'exp': 'exp'}

        def chain_ms(peaks):  # one FFMA, or one exp, per element-op
            return {k: n_chain / peaks[rate_key[k]] * 1e3 for k in tvr.KINDS}

        bound, measured = chain_ms(DATASHEET), chain_ms(PEAKS)
        lines.append({
            'name': 'vpu_roofline_chain', 'route': 'cuda', 'kernel': 'P1',
            'source': 'pixelrec_multimodal_tpu_torch/probes/csrc/'
                      'vpu_roofline.cu',
            'replaces': 'scripts/profile_vpu_roofline.py:90',
            'launches': rates['launches']['P1'],
            'max_abs_err': errs['P1 fma'][0], 'tol': errs['P1 fma'][1],
            'ms': p1['fma'][0], 'plain_ms': p1['fma'][1],
            'bound_ms': bound['fma'], 'bound_by': 'operations',
            'bound_ms_measured': measured['fma'],
            'library_ms': None,
            'library_note': 'no PyTorch call computes an FMA chain',
            'shape': [steps] + list(x.shape), 'k': tvr.K_HI,
            'ffma_per_s': PEAKS['ffma'],
            'exp_ms': p1['exp'][0], 'exp_plain_ms': p1['exp'][1],
            'exp_bound_ms': bound['exp'],
            'exp_bound_ms_measured': measured['exp'],
            'exp_per_s': PEAKS['exp'],
            'exp_max_abs_err': errs['P1 exp'][0]})
        w, v = tvr.bcast_inputs(dev, SEED)
        wide_w = w.expand((steps,) + tuple(w.shape))
        p2_plain = cuda_ms(lambda: tvr.bcast_plain(wide_w, v, tvr.BC_K_HI),
                           reps=1)
        # one FFMA per multiply-add of an entry and step
        n_bcast = steps * w.numel() * tvr.BC_DP * tvr.BC_K_HI
        lines.append({
            'name': 'vpu_roofline_bcast', 'route': 'cuda', 'kernel': 'P2',
            'source': 'pixelrec_multimodal_tpu_torch/probes/csrc/'
                      'vpu_roofline.cu',
            'replaces': 'scripts/profile_vpu_roofline.py:121',
            'launches': rates['launches']['P2'],
            'max_abs_err': errs['P2'][0], 'tol': errs['P2'][1],
            'ms': rates['P2']['ms'][1], 'plain_ms': p2_plain,
            'unfused_ms': rates['P2_unfused']['ms'][1],
            'unfused_max_abs_err': errs['P2 unfused'][0],
            'bound_ms': n_bcast / DATASHEET['ffma'] * 1e3,
            'bound_by': 'operations',
            'bound_ms_measured': n_bcast / PEAKS['ffma'] * 1e3,
            'library_ms': None,
            'library_note': 'no PyTorch call computes the dependent chain',
            'shape': [steps, tvr.BC_TB, tvr.BC_TC, tvr.BC_DP],
            'k': tvr.BC_K_HI,
            'entries_per_thread': rates['P2']['entries_per_thread'],
            'ffma_per_s': rates['P2']['instructions_per_s'],
            'unfused_instructions_per_s':
                rates['P2_unfused']['instructions_per_s'],
            'share_of_ffma_rate': rates['P2']['instructions_per_s']
            / PEAKS['ffma']})
        n_mxu = tmx.flops()
        modes = {}
        for mode in tmx.MODES:
            t = tmx.inputs(mode, dev, seed=SEED)
            plain = cuda_ms(lambda: [tmx.chain_plain(*t, mode)
                                     for _ in range(tmx.INSTANCES)], reps=1)
            peak = PEAKS['bf16' if mode == 'bf16' else 'int8']
            ds = DATASHEET['bf16' if mode == 'bf16' else 'int8']
            r = rates['P3'][mode]
            modes[mode] = {'ms': r['ms'], 'plain_ms': plain,
                           'ops_per_s': r['ops_per_s'],
                           'block_rows': r['block_rows'],
                           'block_bytes': r['block_bytes'],
                           'ms_block_64': rates['P3_block_64'].get(
                               mode, r)['ms'],
                           'bound_ms': n_mxu / ds * 1e3,
                           'bound_ms_measured': n_mxu / peak * 1e3,
                           'library_chain_ms': r['library_chain_ms'],
                           'max_abs_err': errs[f'P3 {mode}'][0]}
        b = modes['bf16']
        lines.append({
            'name': 'int8_mxu_chain', 'route': 'cuda', 'kernel': 'P3',
            'source': 'pixelrec_multimodal_tpu_torch/probes/csrc/int8_mxu.cu',
            'replaces': 'scripts/profile_int8_mxu.py:95',
            'launches': rates['launches']['P3'],
            'max_abs_err': b['max_abs_err'], 'tol': errs['P3 bf16'][1],
            'ms': b['ms'], 'plain_ms': b['plain_ms'],
            'bound_ms': b['bound_ms'], 'bound_by': 'operations',
            'bound_ms_measured': b['bound_ms_measured'],
            'library_ms': None,
            'library_chain_ms': b['library_chain_ms'],
            'library_note': 'no single PyTorch call computes the chain; '
                            'library_chain_ms: torch.matmul per product of '
                            'the same chain (int8 modes: torch._int_mm), a '
                            'yardstick',
            'shape': [tmx.ROWS, tmx.H1, tmx.H2, tmx.H3], 'k': tmx.K,
            'instances': tmx.INSTANCES, 'modes': modes})
    return lines


def int8_kernel_checks(kernels: dict, flag: dict, gen, dev) -> dict:
    """Each int8 kernel against its plain version in int8 (bf16 mode) on
    ``flag`` (kernel id: (head, users, items)) and on small int8 heads x
    every activation x final. Both round where the other does and multiply
    exactly, so a pair differs by more than AGREE only where a code flips,
    an input lying within an ulp (of a transcendental, or of K2's and K3's
    exp) of a boundary: at most MAX_DIFFERING_PER_LAYER of the pairs per
    int8 layer, none by more than FLIP_TOL, and at the flagship every pair
    within KERNEL_TOL. ``kernels``: kernel id -> (wrapper, plain version,
    gated or not). Returns the flagship's (max_abs_err, tol) per kernel."""
    out = {}
    for kid, (head, users, items) in flag.items():
        kernel, plain, _ = kernels[kid]
        err, frac, scale = kernel_diff(kernel, plain, head, users, items)
        max_share = MAX_DIFFERING_PER_LAYER * len(head['qlayers'])
        out[kid] = (err, KERNEL_TOL * scale)
        emit('kernel_vs_plain', kernel=kid, widths='flagship',
             B=users[0].shape[0], C=items[0].shape[0], max_abs_err=err,
             tol=KERNEL_TOL * scale, share_over_agree=frac,
             agree=AGREE * scale, max_share=max_share)
        if not (err <= KERNEL_TOL * scale and frac <= max_share):
            raise AssertionError(f'{kid} flagship error {err} or share '
                                 f'{frac} past its gates')
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import ACTIVATIONS
    t0 = time.time()
    worst = {k: 0.0 for k in kernels}
    share = {k: 0.0 for k in kernels}
    gated = any(g for *_, g in kernels.values())
    combos = 0
    for widths in INT8_WIDTHS:
        for act in ACTIVATIONS:
            for final in ('sigmoid', 'tanh', 'none'):
                combos += 1
                _, head = int8_head(widths, act, final, gen, dev,
                                    n_item_mods=5 if gated else None)
                rows = {}
                if gated:
                    rows[True] = random_gated_rows(head, 37, 301, gen, dev)
                else:
                    rows[False] = ((torch.randn(37, widths[0], generator=gen)
                                    .to(dev), torch.randn(
                                        301, widths[0], generator=gen)
                                    .to(dev)),)
                max_share = MAX_DIFFERING_PER_LAYER * (len(widths) - 1)
                for kid, (kernel, plain, g) in kernels.items():
                    r = rows[g][1 if kid == 'K3q' else 0]
                    n_user = 1 if kid == 'K1q' else 2
                    err, frac, scale = kernel_diff(kernel, plain, head,
                                                   r[:n_user], r[n_user:])
                    worst[kid] = max(worst[kid], err / (FLIP_TOL * scale))
                    share[kid] = max(share[kid], frac / max_share)
                    if not (err <= FLIP_TOL * scale and frac <= max_share):
                        raise AssertionError(
                            f'{kid} error {err} (share {frac} over '
                            f'{AGREE * scale}) at widths {widths}, '
                            f'{act}/{final}')
    for kid in kernels:
        emit('kernel_vs_plain', kernel=kid,
             widths='small int8 heads x every activation x final',
             combos=combos, worst_err_over_flip_tol=worst[kid],
             worst_share_over_max_share=share[kid],
             max_share_per_int8_layer=MAX_DIFFERING_PER_LAYER,
             seconds=round(time.time() - t0, 3))
    return out


def int8_main_path(scorer, plain, users, kid, phase, bf16_items, **fields):
    """An int8 scorer's main path: ``drive_top_k`` (8 launches of ``kid``
    per call, no bf16 launch), its top-50 against the plain int8 version
    (``check_against_plain``), and, printed without a gate, its top-50
    overlap with the bf16 scan of the same model (``bf16_items``). Returns
    the launches."""
    v, i, launches, _ = drive_top_k(scorer, users, kid, phase, **fields)
    check_against_plain(scorer, plain, users, v, i, f'{phase}_vs_plain',
                        f32=False)
    emit(f'{phase}_vs_bf16', users=len(users), items=N_ITEMS, k=TOP_K,
         top50_overlap_vs_bf16_scan=topc_overlap(i, bf16_items),
         jax_package_bound=INT8_FIDELITY)
    return launches


def flip_of(rows: list, kid: str):
    """The flip point of int8 mode ``kid``q against ``kid`` in ``rows``
    (``int8_flip_point``'s): the smallest measured ratio from which the
    int8 mode is the faster on every chain of that ratio and of every
    larger one whose h1 is a multiple of 128; None where the bf16 mode wins
    at the largest."""
    flip = None
    padded = [r for r in rows if r['widths'][0] % 128 == 0]
    for ratio in sorted({r['ratio'] for r in padded}, reverse=True):
        if any(r[f'{kid}q_over_{kid}'] >= 1 for r in padded
               if r['ratio'] == ratio):
            break
        flip = ratio
    return flip


def int8_flip_point(smi, gen, dev) -> dict:
    """Each bf16 pair kernel against its int8 mode at the timed block on
    FLIP_CHAINS (the same random weights, relu, sigmoid): K1 against K1q on
    concat rows, then K2 against K2q and K3 against K3q on the gated rows
    (M = 6) of a gated head of the same widths, in turns (bf16, int8, int8,
    bf16; 20 launches each). Prints the flip point of each (``flip_of``)
    beside the gate's constant: the concat one beside
    INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT, and the gated one, the larger of
    K2's and K3's (None if either has none), beside
    INT8_MIN_CHAIN_FLOPS_PER_LANE."""
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        INT8_MIN_CHAIN_FLOPS_PER_LANE,
        INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT,
        int8_chain_flops_per_lane,
        kernel_chain,
        pairwise_scores,
        pairwise_scores_gated,
        pairwise_scores_gated_factored,
    )
    rows = []
    with torch.no_grad():
        for widths in FLIP_CHAINS:
            head, qhead = int8_head(widths, 'relu', 'sigmoid', gen, dev)
            uf = torch.randn(TIME_B, widths[0], generator=gen).to(dev)
            itf = torch.randn(TIME_C, widths[0], generator=gen).to(dev)
            ghead, gqhead = int8_head(widths, 'relu', 'sigmoid', gen, dev,
                                      n_item_mods=5)
            # the bf16 chains built (and packed) once, as a scorer's, as
            # quantize_head builds the int8 ones
            head['kernel'], ghead['kernel'] = (kernel_chain(head),
                                               kernel_chain(ghead))
            exact, factored = random_gated_rows(ghead, TIME_B, TIME_C, gen,
                                                dev)
            row = {'widths': list(widths),
                   'ratio': int8_chain_flops_per_lane(head)}
            for kid, fn, heads, args in (
                    ('K1', pairwise_scores, (head, qhead), (uf, itf)),
                    ('K2', pairwise_scores_gated, (ghead, gqhead), exact),
                    ('K3', pairwise_scores_gated_factored, (ghead, gqhead),
                     factored)):
                ms = {'bf16': [], 'int8': []}
                for mode in ('bf16', 'int8', 'int8', 'bf16'):
                    h = heads[mode == 'int8']
                    ms[mode].append(cuda_ms(
                        lambda: fn(h, *args), reps=20))
                bf, q = (statistics.mean(ms[m]) for m in ('bf16', 'int8'))
                row.update({f'{kid}_ms': bf, f'{kid}q_ms': q,
                            f'{kid}q_over_{kid}': q / bf})
            rows.append(row)
            del exact, factored, uf, itf
    flips = {kid: flip_of(rows, kid) for kid in ('K1', 'K2', 'K3')}
    gated = (None if flips['K2'] is None or flips['K3'] is None
             else max(flips['K2'], flips['K3']))
    emit('int8_flip_point', shape=[TIME_B, TIME_C], chains=rows,
         flip_point=flips['K1'],
         constant_in_code=INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT,
         gated_flip_point=gated, gated_flip_point_exact=flips['K2'],
         gated_flip_point_factored=flips['K3'],
         gated_constant_in_code=INT8_MIN_CHAIN_FLOPS_PER_LANE,
         nvidia_smi=smi)
    return {'flip_point': flips['K1'], 'gated_flip_point': gated,
            'chains': rows}


def block_of(kernel_id: str, head: dict) -> dict:
    """The block a kernel takes for ``head`` (its mode's): the pair rows
    chosen (``ops/pairwise_mlp.py:block_rows``), the shared memory the
    kernel's launch set-up counts for them (``<source>_block_bytes``) and
    the tensor-core chain it runs there (``chain_kind``: wgmma or
    mma.sync)."""
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    chain = tpm.kernel_chain(head)
    base = kernel_id.rstrip('q')
    widths = tuple(int(w) for w in chain['widths'])
    mode = ((head['H'], head['n_item_mods']) if base in ('K4', 'K5', 'K6')
            else (int(chain['int8']),))
    rows = tpm.block_rows(SOURCES[base], widths, mode)
    return {'block_rows': rows,
            'block_bytes': tpm.block_bytes(SOURCES[base], widths, rows, mode),
            'chain': tpm.chain_kind(SOURCES[base], rows, widths, mode)}


def assembly_only_chain(d: int, gen, dev) -> dict:
    """An attention head's kernel chain cut after the assembly: no hidden
    layer, the last dot (random bf16 weights, relu, sigmoid) on the fused
    d-vector itself."""
    return {'int8': False, 'n_hidden': 0, 'widths': np.asarray([d], np.int32),
            'w': torch.zeros(8, dtype=torch.bfloat16, device=dev),
            'b': torch.zeros(1, device=dev),
            'w_last': torch.randn(d, generator=gen).to(dev).bfloat16().float(),
            'b_last': torch.zeros(1, device=dev), 'act': 0, 'final': 0}


def chain_phase(smi, dev) -> list:
    """The chain of K1, K4, K6, K2, K3, K2q, K3q and K1q alone: each kernel
    at the TIME_B x TIME_C block with the flagship chain whole and cut
    after the assembly (K1, K2, K3: h1 512 -> 1, K2 and K3 on seeded gated
    rows of M = 6; K4, K6: the last dot on the fused vector, d 64 -> 1;
    K2q and K3q, which take one hidden layer at least, on the same gated
    rows, and K1q on K1's rows: cut after the assembly's quantize to the
    narrowest chain, h1 512 -> INT8_CUT_WIDTH -> 1), relu, sigmoid, random
    weights and rows from a generator of its own (K1q last, so that the
    others draw what they drew before it); the chain's time is the
    difference (its products, epilogues and last dot), its rate the hidden
    products of the difference over that time (tera-operations per second:
    bf16 FLOP, int8 OP in K1q, K2q and K3q). Prints one ``chain`` line per
    kernel with the chain kind and block rows of the whole chain and
    returns the lines."""
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    gen = torch.Generator().manual_seed(SEED + 9)
    uf = torch.randn(TIME_B, HIDDEN[0], generator=gen).to(dev)
    itf = torch.randn(TIME_C, HIDDEN[0], generator=gen).to(dev)
    d, heads = EMB, 4
    gated_rows = None
    lines = []
    for kid in ('K1', 'K4', 'K6', 'K2', 'K3', 'K2q', 'K3q', 'K1q'):
        ms, prods = {}, 0
        for cut in (False, True):
            if kid in ('K1q', 'K2q', 'K3q'):  # after K2, K3: gated_rows set
                _, head = int8_head(
                    (HIDDEN[0], INT8_CUT_WIDTH) if cut else HIDDEN, 'relu',
                    'sigmoid', gen, dev, None if kid == 'K1q' else 5)
                fn, args = {
                    'K1q': (tpm.pairwise_scores, (uf, itf)),
                    'K2q': (tpm.pairwise_scores_gated, gated_rows[0]),
                    'K3q': (tpm.pairwise_scores_gated_factored,
                            gated_rows[1])}[kid]
                call = (lambda f, h, a: lambda: f(h, *a))(fn, head, args)
            elif kid in ('K1', 'K2', 'K3'):
                head = random_head(HIDDEN[:1] if cut else HIDDEN, 'relu',
                                   'sigmoid', gen, dev,
                                   None if kid == 'K1' else 5)
                if kid == 'K1':
                    fn, args = tpm.pairwise_scores, (uf, itf)
                else:
                    if gated_rows is None:  # one set for K2 and K3
                        gated_rows = random_gated_rows(head, TIME_B, TIME_C,
                                                       gen, dev)
                    fn, args = ((tpm.pairwise_scores_gated, gated_rows[0])
                                if kid == 'K2' else
                                (tpm.pairwise_scores_gated_factored,
                                 gated_rows[1]))
                call = (lambda f, h, a: lambda: f(h, *a))(fn, head, args)
            else:
                head = random_attention_head(d, heads, HIDDEN, 'relu',
                                             'sigmoid', gen, dev)
                if cut:
                    head['kernel'] = assembly_only_chain(d, gen, dev)
                u, it = random_attention_rows(head, TIME_B, TIME_C, gen, dev,
                                              False)
                if kid == 'K4':
                    call = (lambda h, u, it: lambda: tas.attention_scores(
                        h, u[:5], it[:6]))(head, u, it)
                else:
                    tail = tac.compute_screen_tail(head, it)
                    call = (lambda h, u, it, t: lambda:
                            tac.attention_screen_scores(h, u[:5], it, t))(
                        head, u, it, tail)
            if 'kernel' not in head:  # built once, as a scorer's
                head['kernel'] = tpm.kernel_chain(head)
            cut_widths = [int(w) for w in head['kernel']['widths']]
            prods += (-1 if cut else 1) * sum(
                2 * k * n for k, n in zip(cut_widths[:-1], cut_widths[1:]))
            if not cut:
                widths = cut_widths
                block = block_of(kid, head)
            with torch.no_grad():
                ms[cut] = cuda_ms(call, reps=20)
        chain_ms = ms[False] - ms[True]
        line = dict(kernel=kid, widths=list(widths), shape=[TIME_B, TIME_C],
                    cut_widths=list(cut_widths),
                    ms=ms[False], ms_cut_after_assembly=ms[True],
                    chain_ms=chain_ms,
                    chain_tflops=TIME_B * TIME_C * prods / (chain_ms * 1e-3)
                    / 1e12, **block, nvidia_smi=smi)
        emit('chain', **line)
        lines.append(line)
    return lines


def wide_main_paths(users, smi, dev):
    """The models the kernels serve in blocks of fewer than 128 pair rows,
    each through ``CatalogScorer`` at the full catalog, k = 50, one warm-up
    and one timed call (``drive_top_k``), the launch counts set to 0 just
    before it: bench.py's flagship at embedding_dim WIDE_EMB (attention,
    'stream', K4, then the token-0 screen through K6, with K4 and K6 held to
    their plain versions at the timed block and K5 on random rows of the
    same head), and at WIDE_HIDDEN (concat
    K1 and gated exact K2, in bf16 and in int8, K1q and K2q). Each prints
    the block rows its scorer chose and its top-50 overlap with the plain
    version on 64 users (>= MIN_OVERLAP)."""
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm

    # attention at d 512
    t0 = time.time()
    model, store = build_flagship(fusion_type='attention', emb=WIDE_EMB)
    scorer = CatalogScorer(model, store)
    scorer._ensure_screen('token0')
    torch.cuda.synchronize()
    head = scorer._head
    blocks = {kid: block_of(kid, head) for kid in ('K4', 'K5', 'K6')}
    rows = {kid: b['block_rows'] for kid, b in blocks.items()}
    if rows['K4'] != scorer.block_rows:
        raise AssertionError(f'K4 rows {rows} != the scorer\'s '
                             f'{scorer.block_rows}')
    emit('setup_attention_d512', seconds=round(time.time() - t0, 3),
         d=head['d'], heads=head['H'], h1=head['h1'],
         chain_widths=head['kernel']['widths'].tolist(), blocks=blocks,
         table_bytes=sum(t.numel() * t.element_size()
                         for t in scorer._scan_tables))
    k4 = user_item_call(tas.attention_scores, 5)
    k4_plain = user_item_call(tas.attention_scores_plain, 5)
    k5 = user_item_call(tas.attention_scores_gram, 6)
    k5_plain = user_item_call(tas.attention_scores_gram_plain, 6)
    k6, k6_plain = (screen_call(tac.attention_screen_scores),
                    screen_call(tac.attention_screen_scores_plain))
    it_k, it_vo, tail = (scorer._item_fast[2], scorer._item_fast[3],
                         scorer._screen_tail)
    # a d 512 head whose chain cannot flip: w1 = I, then the last dot
    gen = torch.Generator().manual_seed(SEED + 8)
    exact = random_attention_head(WIDE_EMB, 4, (WIDE_EMB,), 'gelu', 'tanh',
                                  gen, dev)
    exact['w1'] = torch.eye(WIDE_EMB, device=dev)
    eu, ei = random_attention_rows(exact, TIME_B, 2048, gen, dev, True)
    # K5 on random rows of the d 512 head (the stream scorer builds no
    # scalar tables)
    gu, gi = random_attention_rows(head, TIME_B, 2048, gen, dev, True)
    from pixelrec_multimodal_tpu_torch.ops.attention_cascade import (
        compute_screen_tail,
    )
    with torch.no_grad():
        side = scorer._fast_user_side(
            torch.from_numpy(users[:TIME_B].astype(np.int64)).to(dev))
        for kid, kernel, plain, h, u, items, gate, what in (
                ('K4', k4, k4_plain, head, side,
                 tuple(t[:TIME_C] for t in scorer._scan_tables),
                 WIDE_MAX_DIFFERING, 'd 512'),
                ('K6', k6, k6_plain, head, side,
                 (it_k[:TIME_C], it_vo[:TIME_C], tail[:TIME_C]),
                 WIDE_MAX_DIFFERING, 'd 512'),
                ('K5', k5, k5_plain, head, gu, gi, WIDE_MAX_DIFFERING,
                 'd 512, random rows'),
                ('K4', k4, k4_plain, exact, eu[:5], ei[:6],
                 MAX_DIFFERING_PER_LAYER, 'd 512, w1 = I'),
                ('K5', k5, k5_plain, exact, eu, ei,
                 MAX_DIFFERING_PER_LAYER, 'd 512, w1 = I'),
                ('K6', k6, k6_plain, exact, eu[:5],
                 (ei[2], ei[3], compute_screen_tail(exact, ei)),
                 MAX_DIFFERING_PER_LAYER, 'd 512, w1 = I')):
            # the plain attention holds [users, items, tokens, d] f32
            # intermediates: slices of 256 items at d 512
            err, frac, scale = kernel_diff(kernel, plain, h, u, items,
                                           slice_items=256)
            rows_h = tas.check_kernel_fits(h, kid == 'K5', kid == 'K6')
            emit('kernel_vs_plain', kernel=kid, widths=what,
                 B=u[0].shape[0], C=items[0].shape[0], block_rows=rows_h,
                 chain=tpm.chain_kind(SOURCES[kid], rows_h),
                 max_abs_err=err, tol=FLIP_TOL * scale,
                 share_over_agree=frac, agree=AGREE * scale, max_share=gate)
            if not (err <= FLIP_TOL * scale and frac <= gate):
                raise AssertionError(f'{kid} at {what}: error {err} or share '
                                     f'{frac} past its gates')
    v, i, launches, _ = drive_top_k(scorer, users, 'K4',
                                    'main_path_attention_d512', calls=1,
                                    nvidia_smi=smi)
    check_against_plain(scorer, k4_plain, users, v, i,
                        'main_path_attention_d512_vs_plain', f32=False)
    scorer.top_k_cascade(users, TOP_K, screen='token0')  # warm-up
    reset_launches()
    t0 = time.time()
    cv, ci = scorer.top_k_cascade(users, TOP_K, screen='token0')
    seconds = time.time() - t0
    counts = launch_counts()
    expected = {k: (scorer.n_pad // scorer.item_chunk if k == 'K6' else 0)
                for k in counts}
    emit('main_path_attention_d512_token0', users=len(users),
         items=N_ITEMS, k=TOP_K, seconds=seconds,
         effective_pairs_per_sec=len(users) * N_ITEMS / seconds,
         kernel_launches=counts, expected_launches=expected,
         block_rows=rows['K6'],
         recall_vs_exact_top50=topc_overlap(i, ci), nvidia_smi=smi)
    if counts != expected or not np.isfinite(cv).all():
        raise AssertionError(f'main_path_attention_d512_token0: launches '
                             f'{counts} or output malformed')
    del scorer, model, store, side, it_k, it_vo, tail, exact, eu, ei, gu, gi
    torch.cuda.empty_cache()

    # concat and gated at [1024, 512, 256], bf16 and int8
    plains = {'K1': tpm.pairwise_scores_plain,
              'K2': tpm.pairwise_scores_gated_plain}
    for fusion, kid in (('concatenate', 'K1'), ('gated', 'K2')):
        model, store = build_flagship(fusion_type=fusion,
                                      hidden=WIDE_HIDDEN)
        for precision in ('bf16', 'int8!'):
            t0 = time.time()
            scorer = CatalogScorer(model, store, precision=precision)
            torch.cuda.synchronize()
            k = kid + ('q' if precision == 'int8!' else '')
            block = block_of(k, scorer._head)
            emit('setup_wide_chain', fusion=fusion, precision=precision,
                 kernel=k, seconds=round(time.time() - t0, 3),
                 widths=scorer._head['kernel']['widths'].tolist(),
                 scorer_block_rows=scorer.block_rows, **block)
            if scorer.block_rows != block['block_rows'] \
                    or block['block_rows'] != 64:
                raise AssertionError(f'{k}: rows {scorer.block_rows} / '
                                     f'{block}')
            v, i, _, _ = drive_top_k(
                scorer, users, k, f'main_path_wide_chain_{fusion}_{k}',
                calls=1, precision=scorer.precision, nvidia_smi=smi)
            check_against_plain(scorer, plains[kid], users, v, i,
                                f'main_path_wide_chain_{fusion}_{k}_vs_plain',
                                f32=False)
            del scorer
            torch.cuda.empty_cache()
        del model, store


def train_data(gen: torch.Generator, dev, n_items: int = N_ITEMS,
               n_users: int = TRAIN_USERS, batch: int = TRAIN_BATCH,
               n_batches: int = TRAIN_BATCHES):
    """(tables, batches) of the train phase, drawn on ``dev`` from ``gen``
    (a generator on ``dev``): the item features in one packed table
    [n_items, 2048 + 384 + 7], and ``n_batches`` stacked batches of (user,
    item, the item's tag, label, weight)."""
    key = (f'packed::vision_emb={VISION_DIM}+language_emb={LANG_DIM}'
           f'+numerical={NUM_FEAT}')
    tags = torch.randint(0, N_TAGS, (n_items,), generator=gen, device=dev)
    tables = {key: torch.randn(n_items, VISION_DIM + LANG_DIM + NUM_FEAT,
                               generator=gen, device=dev)}
    shape = (n_batches, batch)
    items = torch.randint(0, n_items, shape, generator=gen, device=dev)
    batches = {
        'user_idx': torch.randint(0, n_users, shape, generator=gen,
                                  device=dev).to(torch.int32),
        'item_idx': items.to(torch.int32),
        'tag_idx': tags[items].to(torch.int32),
        'label': torch.randint(0, 2, shape, generator=gen,
                               device=dev).to(torch.float32),
        'weight': torch.ones(shape, device=dev)}
    return tables, batches


def train_model(dev, dtype=torch.bfloat16, dropout: float = TRAIN_DROPOUT,
                seed: int = SEED, **kw):
    """The train phase's model: the flagship widths at TRAIN_USERS users,
    random weights from ``seed``; ``kw`` overrides the widths."""
    from pixelrec_multimodal_tpu_torch.models.multimodal import (
        MultimodalRecommender,
    )
    args = dict(n_users=TRAIN_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
                num_numerical_features=NUM_FEAT, embedding_dim=EMB,
                vision_feature_dim=VISION_DIM, language_feature_dim=LANG_DIM,
                use_contrastive=False, fusion_hidden_dims=HIDDEN,
                fusion_type='concatenate', use_batch_norm=True,
                dropout_rate=dropout)
    args.update(kw)
    return MultimodalRecommender(**args, dtype=dtype, device=dev,
                                 generator=torch.Generator().manual_seed(seed))


def train_card_vs_cpu(model, tables: dict, batches: dict, dev) -> dict:
    """``model`` (float32, on the CPU) and a copy of it on ``dev`` each
    take the stacked ``batches``' steps, TF32 off, once with SGD and once
    with AdamW (the train phase's settings, each from ``model``'s
    weights); returns by optimizer each side's losses and how far the
    parameters and BatchNorm statistics lie apart, and raises unless the
    losses hold TRAIN_TOL and the rest TRAIN_TOL (SGD) or TRAIN_ADAM_DRIFT
    (AdamW)."""
    import copy
    from pixelrec_multimodal_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_step_fns,
    )
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for kind, tol in (('sgd', TRAIN_TOL), ('adamw', TRAIN_ADAM_DRIFT)):
            sides = {'cpu': copy.deepcopy(model),
                     'card': copy.deepcopy(model).to(dev)}
            losses = {}
            for side, m in sides.items():
                state = init_train_state(m, build_optimizer(
                    kind, TRAIN_LR, TRAIN_WD, gradient_clip=TRAIN_CLIP))
                _, _, train_epoch, _ = make_step_fns(
                    m, {k: v.to(m.device) for k, v in tables.items()},
                    use_contrastive=False, return_epoch_fns=True)
                _, metrics = train_epoch(state, batches)
                losses[side] = metrics['total_loss'].cpu().numpy().tolist()
            ref = sides['cpu'].state_dict()
            got = {k: v.cpu() for k, v in sides['card'].state_dict().items()}
            past = total = 0
            worst = 0.0
            for k, r in ref.items():
                if k.endswith('num_batches_tracked'):
                    continue
                d = (r - got[k]).abs()
                past += int((d > TRAIN_TOL).sum())
                total += d.numel()
                worst = max(worst, d.max().item())
            loss_diff = float(np.abs(np.subtract(losses['card'],
                                                 losses['cpu'])).max())
            out[kind] = {
                'losses_card': losses['card'], 'losses_cpu': losses['cpu'],
                'loss_max_abs_diff': loss_diff, 'loss_tol': TRAIN_TOL,
                'param_max_abs_diff': worst, 'param_tol': tol,
                'entries_past_1e-5': past, 'entries': total}
            if not (np.isfinite(losses['card']).all()
                    and loss_diff <= TRAIN_TOL and worst <= tol):
                raise AssertionError(f'train: the card and the CPU disagree '
                                     f'({kind}): {out[kind]}')
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return out


def train_phase(smi, dev) -> dict:
    """The port's frozen train path on the card at the JAX package's
    training profile geometry (``train_epoch`` over 16 batches of 32,768):
    samples/s and ms a step over the median of TRAIN_EPOCHS epochs after a
    warm-up, finite losses, peak device memory, no kernel of the serving
    path launched; then 3 steps at batch 1,024 against the CPU."""
    from pixelrec_multimodal_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_step_fns,
    )
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tables, batches = train_data(gen, dev)
    model = train_model(dev)
    state = init_train_state(model, build_optimizer(
        'adamw', TRAIN_LR, TRAIN_WD, gradient_clip=TRAIN_CLIP))
    _, _, train_epoch, _ = make_step_fns(model, tables,
                                         use_contrastive=False,
                                         return_epoch_fns=True)
    drop = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    reset_launches()
    state, metrics = train_epoch(state, batches, drop)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for _ in range(TRAIN_EPOCHS):
        t0 = time.time()
        state, metrics = train_epoch(state, batches, drop)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(metrics['total_loss'].cpu().numpy().tolist())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    median = statistics.median(times)
    samples = TRAIN_BATCHES * TRAIN_BATCH
    fields = dict(
        users=TRAIN_USERS, items=N_ITEMS, batch=TRAIN_BATCH,
        batches_per_epoch=TRAIN_BATCHES, dropout=TRAIN_DROPOUT,
        optimizer='adamw', lr=TRAIN_LR, weight_decay=TRAIN_WD,
        clip=TRAIN_CLIP, setup_seconds=setup_s, epoch_seconds=times,
        median_epoch_seconds=median, samples_per_sec=samples / median,
        ms_per_step=median / TRAIN_BATCHES * 1e3, losses=losses,
        steps_taken=int(state.step), peak_memory_bytes=peak,
        kernel_launches=counts, nvidia_smi=smi)
    emit('train', **fields)
    if not np.isfinite(losses).all() or int(state.step) != \
            (TRAIN_EPOCHS + 1) * TRAIN_BATCHES:
        raise AssertionError(f'train: non-finite losses or skipped steps: '
                             f'{losses}, {int(state.step)} steps')
    if any(counts.values()):
        raise AssertionError(f'train: the train path launched serving '
                             f'kernels: {counts}')
    del state, model, metrics
    # the card against the CPU, from the same weights, on the same data
    check = {k: v[:TRAIN_CHECK_STEPS, :TRAIN_CHECK_BATCH].cpu()
             for k, v in batches.items()}
    cpu_tables = {k: v.cpu() for k, v in tables.items()}
    del tables, batches
    torch.cuda.empty_cache()
    out = train_card_vs_cpu(train_model('cpu', torch.float32, 0.0),
                            cpu_tables, check, dev)
    emit('train_card_vs_cpu', batch=TRAIN_CHECK_BATCH,
         steps=TRAIN_CHECK_STEPS, dtype='float32', dropout=0.0, tf32=False,
         **out, nvidia_smi=smi)
    return fields


def trainer_tables(seed: int = SEED, n_users: int = TRAIN_USERS,
                   n_items: int = N_ITEMS, n_tags: int = N_TAGS,
                   train_pos: int = TRAINER_TRAIN_POS,
                   val_pos: int = TRAINER_VAL_POS):
    """(items, train interactions, validation interactions) as dicts of
    numpy columns, drawn from ``seed``: each item a tag, NUM_FEAT
    numerical columns (one with a few NaN) and a description; each user
    TRAINER_LIKED preferred tags and ``train_pos + val_pos`` distinct
    positives from items of those tags."""
    rng = np.random.default_rng(seed)
    item_tag = rng.integers(0, n_tags, n_items)
    words = np.array(['red', 'soft', 'large', 'cheap', 'classic', 'wooden',
                      'bright', 'summer', 'travel', 'kids'])
    pick = rng.integers(0, len(words), (n_items, 3))
    items = {
        'item_id': np.array([f'i{j}' for j in range(n_items)]),
        'tag': np.array([f't{t}' for t in item_tag]),
        'description': np.array([f'{a} {b} {c} item, number {j}'
                                 for j, (a, b, c) in
                                 enumerate(words[pick])])}
    for c in range(NUM_FEAT):
        col = rng.lognormal(c % 3, 1.0, n_items)
        if c == 0:
            col[rng.integers(0, n_items, 16)] = np.nan
        items[f'num_{c}'] = col
    by_tag = [np.flatnonzero(item_tag == t) for t in range(n_tags)]
    train, val = {'user_id': [], 'item_id': []}, {'user_id': [], 'item_id': []}
    for u in range(n_users):
        liked = rng.choice(n_tags, TRAINER_LIKED, replace=False)
        pos = rng.choice(np.concatenate([by_tag[t] for t in liked]),
                         train_pos + val_pos, replace=False)
        for part, chosen in ((train, pos[:train_pos]),
                             (val, pos[train_pos:])):
            part['user_id'].append(np.full(len(chosen), f'u{u}'))
            part['item_id'].append(items['item_id'][chosen])
    return items, *({k: np.concatenate(v) for k, v in part.items()}
                    for part in (train, val))


def trainer_datasets(items, train, val, numerical_cols):
    """(full, train, val) as the JAX package's train script builds them
    (scripts/train.py:192-234): a scaler fitted on the items first, the
    full dataset fitting the encoders, the others sharing them; returns
    them with each build's host seconds."""
    import contextlib
    from pixelrec_multimodal_tpu_torch.data.dataset import MultimodalDataset
    from pixelrec_multimodal_tpu_torch.data.processors.numerical_processor \
        import NumericalProcessor
    scaler = NumericalProcessor().fit_scaler(items, numerical_cols,
                                             'standardization')
    common = dict(item_info_df=items, image_folder='/nonexistent',
                  vision_model_name='resnet',
                  language_model_name='sentence-bert',
                  numerical_feat_cols=numerical_cols,
                  categorical_feat_cols=['tag'], numerical_scaler=scaler,
                  numerical_normalization_method='standardization')
    seconds = {}
    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.time()
        full = MultimodalDataset(
            interactions_df={k: np.concatenate([train[k], val[k]])
                             for k in train},
            create_negative_samples=False, **common)
        seconds['full'] = time.time() - t0
        enc = dict(user_encoder=full.user_encoder,
                   item_encoder=full.item_encoder,
                   tag_encoder=full.tag_encoder)
        out = [full]
        for name, inter, mode in (('train', train, True),
                                  ('val', val, False)):
            t0 = time.time()
            out.append(MultimodalDataset(
                interactions_df=inter, create_negative_samples=True,
                negative_sampling_strategy='random',
                negative_sampling_ratio=1.0, is_train_mode=mode, **enc,
                **common))
            seconds[name] = time.time() - t0
    return (*out, seconds)


def trainer_phase(smi, dev, bare_samples_per_sec: float) -> dict:
    """The Trainer on the card at the train phase's geometry: interactions
    -> datasets -> TRAINER_EPOCHS epochs with best and last checkpoints ->
    a resume -> the best checkpoint served by ``top_k`` through K1 (held
    against the plain version, seen items excluded) and in int8 through
    K1q (its overlap with the bf16 scan printed)."""
    import contextlib
    import tempfile
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.training import Trainer
    from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
        load_checkpoint,
        load_model_state,
    )

    # ---- 1. data: interactions, the three datasets, the encoder tables
    t0 = time.time()
    items, train, val = trainer_tables()
    cols = [f'num_{c}' for c in range(NUM_FEAT)]
    gen_s = time.time() - t0
    full, train_ds, val_ds, build_s = trainer_datasets(items, train, val,
                                                       cols)
    t0 = time.time()
    rng = np.random.default_rng(SEED + 7)
    store = train_ds.feature_store
    store.set_embedding_table('vision_emb', rng.standard_normal(
        (store.n_items, VISION_DIM), dtype=np.float32))
    store.set_embedding_table('language_emb', rng.standard_normal(
        (store.n_items, LANG_DIM), dtype=np.float32))
    tables_s = time.time() - t0
    emit('trainer_data', users=full.n_users, items=full.n_items,
         tags=full.n_tags, numerical=len(cols),
         train_samples=len(train_ds), val_samples=len(val_ds),
         train_batches=train_ds.num_batches(TRAIN_BATCH),
         interactions_seconds=gen_s, build_seconds=build_s,
         embedding_tables_seconds=tables_s,
         host_tables=sorted(store.tables))
    if (full.n_users, full.n_items, full.n_tags) != \
            (TRAIN_USERS, N_ITEMS, N_TAGS) or len(train_ds) != \
            TRAIN_BATCHES * TRAIN_BATCH:
        raise AssertionError('trainer: the datasets miss the geometry')

    # ---- 2. train: TRAINER_EPOCHS epochs, best and last checkpoints
    cfg = Config()
    cfg.model.vision_model, cfg.model.language_model = 'resnet', \
        'sentence-bert'
    train_args = dict(lr=TRAIN_LR, weight_decay=TRAIN_WD,
                      patience=TRAINER_PATIENCE, gradient_clip=TRAIN_CLIP,
                      optimizer_type='adamw',
                      lr_scheduler_type='reduce_on_plateau',
                      batch_size=TRAIN_BATCH)
    n = dict(n_users=full.n_users, n_items=full.n_items, n_tags=full.n_tags)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        model = train_model(dev, **n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = Trainer(model, config=cfg, checkpoint_dir=ckpt_dir,
                          use_contrastive=False, seed=SEED)
        lrs = []  # the LR after each epoch that ran to its summary
        summary = trainer._print_epoch_summary
        trainer._print_epoch_summary = lambda *a: (
            lrs.append(trainer.get_learning_rate()), summary(*a))
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            train_losses, val_losses = trainer.train(
                train_ds, val_ds, epochs=TRAINER_EPOCHS, **train_args)
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        serving = launch_counts()
        hist = trainer.training_history
        epochs = [{
            'train_loss': tm['total_loss'], 'val_loss': vm['total_loss'],
            'train_accuracy': tm['accuracy'], 'val_accuracy': vm['accuracy'],
            'train_f1': tm['f1_score'], 'val_f1': vm['f1_score'],
            'seconds': sec,
            'trainer_samples_per_sec': len(train_ds) / sec['train']}
            for tm, vm, sec in zip(hist['train_metrics'],
                                   hist['val_metrics'],
                                   trainer.epoch_seconds)]
        root = trainer.get_model_checkpoint_dir()
        sizes = {name: (root / name / 'state.pt').stat().st_size
                 for name in ('best_model', 'last_model')
                 if (root / name / 'state.pt').exists()}
        totals = {k: sum(e[k] for e in trainer.epoch_seconds)
                  for k in trainer.epoch_seconds[0]}
        emit('trainer', epochs=epochs, epochs_run=len(epochs),
             lr_after_epoch=lrs, lr=trainer.get_learning_rate(),
             wall_seconds=wall,
             seconds_by_part=totals,
             checkpoint_share=totals['checkpoint'] / wall,
             trainer_samples_per_sec_median=statistics.median(
                 e['trainer_samples_per_sec'] for e in epochs),
             bare_train_epoch_samples_per_sec=bare_samples_per_sec,
             state_file_bytes=sizes, peak_memory_bytes=peak,
             best_score=trainer.best_early_stopping_score,
             kernel_launches=serving, nvidia_smi=smi)
        metas = {name: json.loads((root / name / 'meta.json').read_text())
                 for name in ('best_model', 'last_model')
                 if (root / name / 'meta.json').exists()}
        if not (np.isfinite(train_losses).all()
                and np.isfinite(val_losses).all()):
            raise AssertionError(f'trainer: non-finite losses '
                                 f'{train_losses}, {val_losses}')
        if not min(val_losses) < val_losses[0]:
            raise AssertionError(f'trainer: the validation loss never fell '
                                 f'below epoch 0\'s: {val_losses}')
        if sorted(metas) != ['best_model', 'last_model'] or any(
                set(m) != META_KEYS for m in metas.values()):
            raise AssertionError(f'trainer: checkpoints or meta.json keys '
                                 f'wrong: { {k: sorted(m) for k, m in metas.items()} }')
        if any(serving.values()):
            raise AssertionError(f'trainer: the train path launched serving '
                                 f'kernels: {serving}')

        # ---- 3. resume: a fresh model and Trainer load last_model and
        # train one more epoch
        saved = load_checkpoint(root, 'last_model', device=dev)
        meta = saved['meta']
        resumed = Trainer(train_model(dev, seed=SEED + 9, **n), config=cfg,
                          checkpoint_dir=ckpt_dir, use_contrastive=False,
                          seed=SEED)
        with contextlib.redirect_stdout(sys.stderr):
            resumed.load_checkpoint('last_model')
        same = all(torch.equal(p, saved['state']['params'][k])
                   for k, p in resumed.model.named_parameters()) and all(
            torch.equal(b, saved['state']['batch_stats'][k])
            for k, b in resumed.model.named_buffers()
            if k in saved['state']['batch_stats'])
        came_back = {
            'epoch': resumed.epoch == meta['epoch'] == trainer.epoch,
            'history': resumed.training_history == hist,
            'scheduler': resumed._pending_scheduler ==
            trainer.scheduler.state_dict() == meta['scheduler_state'],
            'parameters_bit_for_bit': same}
        with contextlib.redirect_stdout(sys.stderr):
            more = resumed.train(train_ds, val_ds, epochs=meta['epoch'] + 1,
                                 **train_args)
        came_back['scheduler_continued'] = \
            resumed.scheduler.state_dict()['epoch'] == \
            meta['scheduler_state']['epoch'] + 1
        came_back['optimizer_continued'] = int(resumed.state.step) == \
            int(saved['state']['step']) + TRAIN_BATCHES
        emit('trainer_resume', epoch=meta['epoch'], losses=more,
             seconds=resumed.epoch_seconds[-1], checks=came_back)
        if not all(came_back.values()) or not np.isfinite(more).all():
            raise AssertionError(f'trainer: the resume lost state: '
                                 f'{came_back}, {more}')
        del trainer, resumed, model

        # ---- 4. serve the best checkpoint through K1, then K1q
        t0 = time.time()
        served = train_model(dev, seed=SEED + 11, **n)
        best = load_checkpoint(root, 'best_model', device=dev)
        load_model_state(served, best['state'])
    scorer = CatalogScorer(served, store, device=dev)
    torch.cuda.synchronize()
    emit('trainer_serve_setup', seconds=time.time() - t0,
         best_epoch=best['meta']['epoch'])
    users = np.random.default_rng(SEED + 12).integers(
        0, full.n_users, N_USERS).astype(np.int32)
    v, i, _, _ = drive_top_k(scorer, users, 'K1', 'trainer_main_path',
                             nvidia_smi=smi)
    check_against_plain(scorer, pairwise_scores_plain, users, v, i,
                        'trainer_main_path_vs_plain',
                        gate='score_full_vs_f32')
    indptr, hist_items = train_ds.user_history_matrix()
    few = users[:SEEN_USERS]
    seen = np.zeros((len(few), full.n_items), dtype=bool)
    for row, u in enumerate(few):
        seen[row, hist_items[indptr[u]:indptr[u + 1]]] = True
    sv, si = scorer.top_k(few, TOP_K, seen_mask=seen)
    hits = int(seen[np.arange(len(few))[:, None], np.maximum(si, 0)][
        si >= 0].sum())
    emit('trainer_seen_mask', users=len(few), k=TOP_K,
         seen_items=int(seen.sum()), seen_items_returned=hits,
         unseen_overlap_with_unmasked=topc_overlap(si, i[:len(few)]))
    if hits or not np.isfinite(sv).all():
        raise AssertionError(f'trainer: {hits} seen items returned')
    del scorer
    torch.cuda.empty_cache()
    qscorer = CatalogScorer(served, store, precision='int8!', device=dev)
    int8_main_path(qscorer, pairwise_scores_plain, users, 'K1q',
                   'trainer_main_path_int8', i,
                   precision=qscorer.precision, nvidia_smi=smi)
    del qscorer, served
    torch.cuda.empty_cache()
    return {'epochs': epochs}


def cli_config(ws: Path, batch: int = TRAIN_BATCH,
               epochs: int = CLI_EPOCHS) -> dict:
    """The cli phase's config for the workspace ``ws``: the flagship
    concat model on random resnet and sentence-bert tables, the train
    phase's AdamW in the JAX train script's float32 with
    ``reduce_on_plateau``, batch ``batch``, ``epochs`` epochs, the
    processed CSV files under ``ws/processed``, a stratified split at 0.8,
    the tables' cache under ``ws/cache``."""
    proc, split = ws / 'processed', ws / 'splits' / 'split_1'
    return {
        'model': {'vision_model': 'resnet',
                  'language_model': 'sentence-bert',
                  'embedding_dim': EMB, 'fusion_type': 'concatenate',
                  'fusion_hidden_dims': list(HIDDEN),
                  'use_contrastive': False, 'use_batch_norm': True,
                  'dropout_rate': TRAIN_DROPOUT},
        'training': {'batch_size': batch,
                     'epochs': epochs,
                     'learning_rate': TRAIN_LR,
                     'weight_decay': TRAIN_WD,
                     'gradient_clip': TRAIN_CLIP,
                     'patience': TRAINER_PATIENCE,
                     'optimizer_type': 'adamw',
                     'use_lr_scheduler': True,
                     'lr_scheduler_type': 'reduce_on_plateau'},
        'data': {
            'processed_item_info_path': str(proc / 'item_info.csv'),
            'processed_interactions_path':
                str(proc / 'interactions.csv'),
            'scaler_path': str(proc / 'numerical_scaler.pkl'),
            'split_data_path': str(split),
            'train_data_path': str(split / 'train.csv'),
            'val_data_path': str(split / 'val.csv'),
            'test_data_path': str(split / 'test.csv'),
            'numerical_features_cols': [f'num_{c}' for c in range(NUM_FEAT)],
            'categorical_features_cols': ['tag'],
            'negative_sampling_ratio': 1.0,
            'cache_config': {'enabled': True, 'use_disk': True,
                             'cache_directory': str(ws / 'cache')},
            'splitting': {'strategy': 'stratified',
                          'train_final_ratio': 0.8,
                          'min_interactions_per_user': 1,
                          'min_interactions_per_item': 1,
                          'random_state': SEED}},
        'checkpoint_dir': str(ws / 'checkpoints'),
        'results_dir': str(ws / 'results')}


def random_embedding_tables(store, rng):
    """Random float32 ``vision_emb`` and ``language_emb`` tables (VISION_DIM
    and LANG_DIM wide) set on ``store``, as the precompute entry point
    would set the towers' tables."""
    store.set_embedding_table('vision_emb', rng.standard_normal(
        (store.n_items, VISION_DIM), dtype=np.float32))
    store.set_embedding_table('language_emb', rng.standard_normal(
        (store.n_items, LANG_DIM), dtype=np.float32))


def cli_workspace(ws: Path, n_users: int = TRAIN_USERS,
                  n_items: int = N_ITEMS, n_tags: int = N_TAGS,
                  batch: int = TRAIN_BATCH) -> dict:
    """Step 1 of the cli phase in ``ws``: ``trainer_tables`` at the given
    size (train and validation positives together, a timestamp each)
    written as the processed CSV files by the port's ``write_csv``, random
    vision and language tables written as ``feature_tables.npz`` by
    ``ItemFeatureStore.save`` (as scripts/precompute_cache.py:97 does), and
    ``cli_config`` as ``ws/config.yaml``. Returns the config's path, the
    interactions' count and the seconds and bytes of each part."""
    from pixelrec_multimodal_tpu_torch.data.columns import write_csv
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.utils import yaml_io
    proc, cache = ws / 'processed', ws / 'cache'
    t0 = time.time()
    items, train_pos, val_pos = trainer_tables(n_users=n_users,
                                               n_items=n_items, n_tags=n_tags)
    rng = np.random.default_rng(SEED + 21)
    inter = {k: np.concatenate([train_pos[k], val_pos[k]])
             for k in train_pos}
    inter['timestamp'] = rng.integers(0, 10 ** 6, len(inter['user_id']))
    tables_s = time.time() - t0
    t0 = time.time()
    write_csv(items, proc / 'item_info.csv')
    write_csv(inter, proc / 'interactions.csv')
    write_s = time.time() - t0
    t0 = time.time()
    store = ItemFeatureStore(n_items, np.unique(items['item_id']),
                             'resnet', 'sentence-bert')
    random_embedding_tables(store, rng)
    store.save(str(cache))
    npz_s = time.time() - t0
    cfg_path = ws / 'config.yaml'
    yaml_io.dump_file(cli_config(ws, batch=batch), cfg_path)
    return {'config': cfg_path, 'interactions': len(inter['user_id']),
            'tables_seconds': tables_s, 'write_csv_seconds': write_s,
            'feature_tables_npz_seconds': npz_s,
            'bytes': {p.name: p.stat().st_size
                      for p in (proc / 'item_info.csv',
                                proc / 'interactions.csv',
                                cache / 'vision_resnet_lang_sentence-bert' /
                                'feature_tables.npz')}}


def cli_phase(smi, dev, trainer_samples_per_sec: float,
              workspace: Path = None) -> dict:
    """The command line on the card at the trainer phase's geometry: the
    workspace of ``cli_workspace`` (processed CSV files, random tables, the
    config), then ``cli_split_train`` and ``cli_serve`` on it. The
    workspace is a temporary directory, or ``workspace``, which then
    outlives the phase. Returns K1's launches."""
    import tempfile
    with (tempfile.TemporaryDirectory() if workspace is None
          else contextlib.nullcontext(workspace)) as tmp:
        ws = Path(tmp)
        made = cli_workspace(ws)
        emit('cli_workspace', items=N_ITEMS,
             **{k: v for k, v in made.items() if k != 'config'})
        res = cli_split_train(smi, dev, made['config'], made['interactions'],
                              trainer_samples_per_sec)
        return cli_serve(smi, dev, made['config'], res)


def cli_split_train(smi, dev, cfg_path: Path, n_interactions: int,
                    trainer_samples_per_sec: float,
                    phase: str = 'cli') -> dict:
    """The port's ``create_splits.main`` and ``train.main(['--config', ...,
    '--device', 'cuda'])`` in this process on the processed files of the
    config at ``cfg_path`` (``n_interactions`` rows): host seconds by step,
    the losses, samples/s against ``trainer_samples_per_sec``, peak memory,
    no serving kernel launched; the text tokenizer timed (every
    ``feature_store.batch_encode`` call) inside the dataset builds. Emits
    ``phase``; returns ``train.main``'s result."""
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.data import feature_store
    from pixelrec_multimodal_tpu_torch.scripts import create_splits, train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        split_out = create_splits.main(str(cfg_path))
    split_wall = time.time() - t0
    # the text tokenizer's share of the dataset builds: every call of
    # feature_store.batch_encode during train.main, timed
    encode, tokenize = feature_store.batch_encode, {
        'seconds': 0.0, 'calls': 0, 'texts': 0, 'tokenizers': []}

    def timed_encode(tok, texts, *args, **kwargs):
        t = time.time()
        try:
            return encode(tok, texts, *args, **kwargs)
        finally:
            tokenize['seconds'] += time.time() - t
            tokenize['calls'] += 1
            tokenize['texts'] += len(texts)
            tokenize['tokenizers'].append(type(tok).__name__)
    feature_store.batch_encode = timed_encode
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            res = train.main(['--config', str(cfg_path), '--device',
                              'cuda'])
    finally:
        feature_store.batch_encode = encode
    train_wall = time.time() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    serving = launch_counts()
    stats = split_out['stats']
    per_epoch = [res['train_samples'] / e['train']
                 for e in res['epoch_seconds']]
    emit(phase, split_seconds=split_out['seconds'],
         split_wall_seconds=split_wall, split_rows=split_out['rows'],
         split_stats=stats, train_seconds=res['seconds'],
         train_wall_seconds=train_wall,
         tokenize=tokenize, tokenize_share_of_datasets=(
             tokenize['seconds'] / res['seconds']['datasets']),
         epochs_run=res['epochs_completed'],
         train_losses=res['train_losses'], val_losses=res['val_losses'],
         epoch_seconds=res['epoch_seconds'],
         train_samples=res['train_samples'],
         cli_trainer_samples_per_sec=per_epoch,
         cli_trainer_samples_per_sec_median=statistics.median(
             per_epoch),
         trainer_phase_samples_per_sec_median=trainer_samples_per_sec,
         share_of_trainer_phase=statistics.median(per_epoch) /
         trainer_samples_per_sec,
         model_dtype='float32', trainer_phase_dtype='bfloat16',
         peak_memory_bytes=peak, kernel_launches=serving,
         device_info=res['metadata']['device_info'], nvidia_smi=smi)
    cfg = Config.from_yaml(str(cfg_path))
    ckpt, results = Path(cfg.checkpoint_dir), Path(cfg.results_dir)
    split = Path(cfg.data.split_data_path)
    model_dir = ckpt / 'resnet_sentence-bert'
    enc_dir = ckpt / 'encoders'
    wanted = [results / 'training_metadata.json',
              results / 'training_run_config.yaml',
              results / 'training_run_config_validated.yaml',
              enc_dir / 'user_encoder.pkl', enc_dir / 'item_encoder.pkl',
              enc_dir / 'tag_encoder.pkl',
              model_dir / 'best_model' / 'state.pt',
              model_dir / 'last_model' / 'state.pt',
              split / 'train.csv', split / 'val.csv']
    absent = [str(p) for p in wanted if not p.exists()]
    if absent:
        raise AssertionError(f'{phase}: files not written: {absent}')
    if not (np.isfinite(res['train_losses']).all()
            and np.isfinite(res['val_losses']).all()):
        raise AssertionError(f'{phase}: non-finite losses '
                             f'{res["train_losses"]}, '
                             f'{res["val_losses"]}')
    if stats['user_overlap_ratio_val'] != 1.0 or \
            stats['user_overlap_val'] != stats['val_users']:
        raise AssertionError(f'{phase}: validation users missing from '
                             f'train: {stats}')
    if sum(split_out['rows'].values()) != n_interactions:
        raise AssertionError(f'{phase}: the split lost rows: '
                             f'{split_out["rows"]}')
    if any(serving.values()):
        raise AssertionError(f'{phase}: the train path launched serving '
                             f'kernels: {serving}')
    return res


def cli_serve(smi, dev, cfg_path: Path, res: dict, phase: str = 'cli',
              serve_users: int = CLI_SERVE_USERS) -> dict:
    """The best checkpoint of ``train.main``'s run ``res`` served as a user
    would: the model rebuilt from ``training_run_config_validated.yaml``,
    ``best_model`` loaded, the encoders and the scaler unpickled, the
    tables built from the item file plus the precomputed ones; then
    ``serve_users`` users through K1 (launches counted, ``score_full`` held
    against the plain float32 version as the trainer phase holds it, the
    top-50 values pair by pair against the plain bf16 version's,
    ``check_against_plain``), their seen items masked, the ids mapped back.
    Emits ``<phase>_main_path``, ``_vs_plain`` and ``<phase>_seen_mask``;
    returns K1's launches."""
    import pickle
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.data.columns import read_csv
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.data.processors import (
        NumericalProcessor,
    )
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.models.multimodal import build_model
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
        load_checkpoint,
        load_model_state,
    )

    t0 = time.time()
    written = Config.from_yaml(str(cfg_path))
    ckpt, results = Path(written.checkpoint_dir), Path(written.results_dir)
    model_dir, enc_dir = ckpt / 'resnet_sentence-bert', ckpt / 'encoders'
    cfg = Config.from_yaml(str(results /
                               'training_run_config_validated.yaml'))
    ds = res['metadata']['data_stats']
    model = build_model(cfg.model, ds['total_users'], ds['total_items'],
                        ds['total_tags'], ds['numerical_features'],
                        device=dev)
    best = load_checkpoint(model_dir, 'best_model', device=dev)
    load_model_state(model, best['state'])
    encoders = {name: pickle.loads((enc_dir / f'{name}_encoder.pkl')
                                   .read_bytes())
                for name in ('user', 'item', 'tag')}
    numerical = NumericalProcessor(
        numerical_cols=cfg.data.numerical_features_cols,
        normalization_method=cfg.data.numerical_normalization_method)
    numerical.load_scaler(cfg.data.scaler_path)
    item_rows = read_csv(cfg.data.processed_item_info_path)
    store = ItemFeatureStore.build(
        item_rows, encoders['item'],
        tag_encoder=encoders['tag'], vision_model=cfg.model.vision_model,
        language_model=cfg.model.language_model,
        numerical_processor=numerical)
    if not store.load_tables(cfg.data.cache_config.cache_directory):
        raise AssertionError(f'{phase}: the precomputed tables did not load')
    scorer = CatalogScorer(model, store, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    train_rows = read_csv(cfg.data.train_data_path)
    seen_u = encoders['user'].transform(train_rows['user_id'].astype(str))
    seen_i = encoders['item'].transform(train_rows['item_id'].astype(str))
    users = np.sort(np.random.default_rng(SEED + 22).choice(
        np.unique(seen_u), serve_users, replace=False)).astype(np.int32)
    v, i, launches, _ = drive_top_k(scorer, users, 'K1',
                                    f'{phase}_main_path',
                                    setup_seconds=setup_s,
                                    best_epoch=best['meta']['epoch'],
                                    nvidia_smi=smi)
    check_against_plain(scorer, pairwise_scores_plain, users, v, i,
                        f'{phase}_main_path_vs_plain',
                        gate='score_full_vs_f32_top50_flips')
    row_of = np.full(ds['total_users'], -1)
    row_of[users] = np.arange(len(users))
    seen = np.zeros((len(users), ds['total_items']), dtype=bool)
    hit = row_of[seen_u] >= 0
    seen[row_of[seen_u[hit]], seen_i[hit]] = True
    sv, si = scorer.top_k(users, TOP_K, seen_mask=seen)
    hits = int(seen[np.arange(len(users))[:, None], np.maximum(si, 0)][
        si >= 0].sum())
    ids = encoders['item'].inverse_transform(si.reshape(-1))
    known = set(item_rows['item_id'].astype(str).tolist())
    mapped = all(x in known for x in ids.tolist())
    emit(f'{phase}_seen_mask', users=len(users), k=TOP_K,
         seen_items=int(seen.sum()), seen_items_returned=hits,
         ids_mapped_back=mapped, first_user_top5=ids[:5].tolist(),
         unseen_overlap_with_unmasked=topc_overlap(si, i))
    if hits or not mapped or (si < 0).any() or not np.isfinite(sv).all():
        raise AssertionError(f'{phase}: {hits} seen items returned, ids '
                             f'mapped back: {mapped}')
    del scorer, model, store
    torch.cuda.empty_cache()
    return {'launches': launches}


@contextlib.contextmanager
def pil_hidden():
    """PIL unimportable for the block (``sys.modules`` entries set to
    None, then restored), as on a machine without it."""
    names = [n for n in sys.modules if n == 'PIL' or n.startswith('PIL.')]
    saved = {n: sys.modules[n] for n in names}
    for n in set(names) | {'PIL', 'PIL.Image'}:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n in set(names) | {'PIL', 'PIL.Image'}:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def jpeg_fixture_check(dev) -> dict:
    """nvJPEG on ``dev`` against the committed fixtures' manifest (PIL's
    verdicts, sizes and decoded frames, ``tests/data/jpeg``): per file the
    verdict, the size and, for a valid file, the frame's largest and mean
    absolute difference in uint8 levels (over the manifest's crops for a
    photo-sized file); ``ok`` when every verdict and size is PIL's, every
    frame is within JPEG_FRAME_MAX_ERR and JPEG_FRAME_MEAN_ERR, and each
    frame's inversion lies outside them. For a file PIL finds corrupt,
    ``nvjpeg_status`` is what nvJPEG's own decode returns, without the
    end-of-image check the decoder adds. ``rate``: the photo-sized files'
    decodes from memory (``decode_rate``)."""
    from pixelrec_multimodal_tpu_torch.data.image_codecs import (
        NvjpegDecoder,
    )
    manifest = json.loads((JPEG_FIXTURES / 'manifest.json').read_text())
    decoder = NvjpegDecoder(dev)
    files, ok = {}, True
    with np.load(JPEG_FIXTURES / 'frames.npz') as frames:
        for name, want in sorted(manifest.items()):
            path = str(JPEG_FIXTURES / name)
            data = (JPEG_FIXTURES / name).read_bytes()
            info = decoder.info(data, name)
            got = {'corrupted': decoder.corrupted(path),
                   'size': None if info is None else list(info[:2])}
            same = (got['corrupted'] == want['corrupted']
                    and got['size'] == want['size'])
            if want['corrupted']:
                got['nvjpeg_status'] = decoder.library_status(data, name)
            frame = None if want['corrupted'] else decoder.decode(data, name)
            if frame is not None:
                frame = frame.cpu().numpy()
                if 'crops' in want:
                    s = want['crop']
                    frame = np.stack([frame[y:y + s, x:x + s]
                                      for y, x in want['crops']])
                ref = frames[name].astype(np.int16)
                diff = np.abs(frame.astype(np.int16) - ref)
                inverted = np.abs(255 - 2 * ref)
                got.update(max_abs_err=int(diff.max()),
                           mean_abs_err=float(diff.mean()),
                           inverted_max_abs_err=int(inverted.max()),
                           inverted_mean_abs_err=float(inverted.mean()))
                same = same and (got['max_abs_err'] <= JPEG_FRAME_MAX_ERR
                                 and got['mean_abs_err']
                                 <= JPEG_FRAME_MEAN_ERR) and not (
                    got['inverted_max_abs_err'] <= JPEG_FRAME_MAX_ERR
                    and got['inverted_mean_abs_err'] <= JPEG_FRAME_MEAN_ERR)
            got['ok'] = bool(same)
            ok = ok and same
            files[name] = got
    photos = [(JPEG_FIXTURES / n).read_bytes() for n in sorted(manifest)
              if 'crops' in manifest[n]]
    return {'files': files, 'decodes': decoder.decodes,
            'max_abs_err': max(f.get('max_abs_err', 0)
                               for f in files.values()),
            'mean_abs_err': max(f.get('mean_abs_err', 0.0)
                                for f in files.values()),
            'tol': {'max': JPEG_FRAME_MAX_ERR, 'mean': JPEG_FRAME_MEAN_ERR},
            'rate': decode_rate(decoder, photos), 'ok': ok}


def decode_rate(decoder, blobs: list, n: int = 512) -> dict:
    """``n`` full decodes of ``blobs`` in turn from memory, as the offline
    mode's checks make them (``check``: the header, the end-of-image
    walk and a scratch decode, waited for),
    on 1 thread and on OFFLINE_WORKERS threads: microseconds a decode and
    megapixels a second each."""
    from concurrent.futures import ThreadPoolExecutor

    from pixelrec_multimodal_tpu_torch.data.processors.image_processor \
        import OFFLINE_WORKERS
    heads = [decoder.info(b) for b in blobs]
    pixels = sum(h[0] * h[1] for h in heads) / len(heads)

    def one(k):
        if decoder.check(blobs[k % len(blobs)], 'fixture') is None:
            raise AssertionError('nvJPEG failed a valid fixture')
    for k in range(2 * OFFLINE_WORKERS):  # every slot made, warm
        one(k)
    out = {'decodes': n, 'mean_pixels': pixels}
    for workers in (1, OFFLINE_WORKERS):
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, range(OFFLINE_WORKERS)))
            t0 = time.perf_counter()
            list(pool.map(one, range(n)))
            dt = time.perf_counter() - t0
        out[f'threads_{workers}'] = {'us_per_decode': dt / n * 1e6,
                                     'megapixels_per_sec':
                                         n * pixels / dt / 1e6}
    return out


def preprocess_raw_files(ws: Path, n_users: int = PREPROCESS_USERS,
                         n_items: int = PREPROCESS_ITEMS,
                         n_tags: int = N_TAGS) -> dict:
    """The raw workspace of the preprocess phase in ``ws/raw``:
    ``item_info.csv`` (``trainer_tables``' items, titles with HTML, every
    PREPROCESS_NO_TAG-th tag missing, every PREPROCESS_RARE_TAG-th a tag of
    its own), ``interactions.csv`` (every positive, a timestamp each) and
    ``images/`` with each item's fixture (PREPROCESS_SHARES; the rest the
    valid fixtures in turn), all from SEED. Returns the item ids, those
    predicted valid (a file, not truncated, not too small), the count of
    each fixture, the interactions' count and the seconds."""
    from pixelrec_multimodal_tpu_torch.data.columns import write_csv
    t0 = time.time()
    items, train_pos, val_pos = trainer_tables(n_users=n_users,
                                               n_items=n_items, n_tags=n_tags)
    rng = np.random.default_rng(SEED + 24)
    inter = {k: np.concatenate([train_pos[k], val_pos[k]])
             for k in train_pos}
    inter['timestamp'] = rng.integers(0, 10 ** 6, len(inter['user_id']))
    j = np.arange(n_items)
    tags = items['tag'].astype(object)
    tags[j % PREPROCESS_RARE_TAG == 3] = np.array(
        [f'only{k}' for k in j[j % PREPROCESS_RARE_TAG == 3]], dtype=object)
    tags[j % PREPROCESS_NO_TAG == 5] = None
    items = {'item_id': items['item_id'],
             'title': np.array([f'<b>Item {k}</b> &amp; <i>co</i>'
                                for k in j]),
             'tag': tags,
             **{k: v for k, v in items.items() if k not in
                ('item_id', 'tag')}}
    raw = ws / 'raw'
    write_csv(items, raw / 'item_info.csv')
    write_csv(inter, raw / 'interactions.csv')
    valid_names = sorted(n for n, v in json.loads(
        (JPEG_FIXTURES / 'manifest.json').read_text()).items()
        if not v['corrupted'] and min(v['size']) >= PREPROCESS_MIN_SIDE)
    counts = {k: int(round(share * n_items))
              for k, share in PREPROCESS_SHARES.items()}
    kinds = [k for k, c in counts.items() for _ in range(c)]
    rest = n_items - len(kinds)
    kinds += [valid_names[r % len(valid_names)] for r in range(rest)]
    kinds = [kinds[r] for r in rng.permutation(n_items)]
    folder = raw / 'images'
    folder.mkdir(parents=True)
    blobs = {n: (JPEG_FIXTURES / n).read_bytes()
             for n in set(kinds) if n is not None}
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=8) as pool:  # the writes wait on IO
        list(pool.map(lambda pair: (folder / f'{pair[0]}.jpg').write_bytes(
            blobs[pair[1]]), [(item, kind) for item, kind in zip(
                items['item_id'].tolist(), kinds) if kind is not None]))
    valid = {item for item, kind in zip(items['item_id'].tolist(), kinds)
             if kind in valid_names}
    return {'valid': valid, 'item_ids': items['item_id'].tolist(),
            'interactions': len(inter['user_id']),
            'fixtures': {str(k): kinds.count(k) for k in sorted(
                set(kinds), key=str)},
            'seconds': time.time() - t0}


def preprocess_config(ws: Path, compress: bool = False) -> dict:
    """``cli_config`` with the raw files of ``ws/raw`` as the preprocess
    entry point's input, the processed images under ``ws/processed``,
    validation at PREPROCESS_MIN_SIDE, compression on or off (1 KB,
    quality 85), rare tags grouped below PREPROCESS_TAG_THRESHOLD and
    PREPROCESS_EPOCHS epochs."""
    config = cli_config(ws, epochs=PREPROCESS_EPOCHS)
    raw = ws / 'raw'
    config['data'].update(
        item_info_path=str(raw / 'item_info.csv'),
        interactions_path=str(raw / 'interactions.csv'),
        image_folder=str(raw / 'images'),
        processed_image_destination_folder=str(ws / 'processed' / 'images'),
        image_validation_config={'check_corrupted': True,
                                 'min_width': PREPROCESS_MIN_SIDE,
                                 'min_height': PREPROCESS_MIN_SIDE},
        image_compression_config={'enabled': compress,
                                  'compress_if_kb_larger_than': 1,
                                  'target_quality': 85})
    config['data']['splitting']['tag_grouping_threshold'] = \
        PREPROCESS_TAG_THRESHOLD
    return config


def preprocess_compression_raises(ws: Path) -> str:
    """A tiny run with compression on and one item's file over the 1 KB
    threshold: PIL (the encoder) is missing here, so the entry point must
    raise ``ImageCodecMissing`` naming A12; returns its message."""
    from pixelrec_multimodal_tpu_torch.data.columns import write_csv
    from pixelrec_multimodal_tpu_torch.data.image_codecs import (
        ImageCodecMissing,
    )
    from pixelrec_multimodal_tpu_torch.scripts import preprocess_data
    from pixelrec_multimodal_tpu_torch.utils import yaml_io
    raw = ws / 'raw'
    write_csv({'item_id': np.array(['a', 'b']), 'tag': np.array(['t', 't']),
               'description': np.array(['x', 'y'])}, raw / 'item_info.csv')
    write_csv({'user_id': np.array(['u', 'u']), 'item_id': np.array(['a',
                                                                     'b']),
               'timestamp': np.array([1, 2])}, raw / 'interactions.csv')
    (raw / 'images').mkdir(parents=True)
    # a valid photo-sized file over the 1 KB threshold, and one too small
    (raw / 'images' / 'a.jpg').write_bytes(
        (JPEG_FIXTURES / 'photo_baseline_444.jpg').read_bytes())
    (raw / 'images' / 'b.jpg').write_bytes(
        (JPEG_FIXTURES / 'gray.jpg').read_bytes())
    cfg = ws / 'config.yaml'
    yaml_io.dump_file(preprocess_config(ws, compress=True), cfg)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            preprocess_data.main(['--config', str(cfg), '--device', 'cuda'])
    except ImageCodecMissing as e:
        if 'A12' not in str(e):
            raise
        return str(e)
    raise AssertionError('preprocess: compression without PIL did not '
                         'raise')


def image_step_timed(config, ids: list, src: Path, dest: Path, dev
                     ) -> Tuple[dict, set]:
    """The image step on ``ids`` with the decoder the rule picks here:
    first the checks alone (``is_image_corrupted`` and
    ``check_image_dimensions`` on each item's ``.jpg`` on OFFLINE_WORKERS
    threads), then the whole step (``process_items_images`` into ``dest``:
    the checks and the copies). Returns milliseconds an item and the valid
    set, which both must agree on."""
    from concurrent.futures import ThreadPoolExecutor

    from pixelrec_multimodal_tpu_torch.data import preprocessing
    from pixelrec_multimodal_tpu_torch.data.image_codecs import (
        image_decoder,
    )
    from pixelrec_multimodal_tpu_torch.data.processors.image_processor \
        import OFFLINE_WORKERS, ImageProcessor
    vc = config.image_validation_config
    decoder = image_decoder(dev)
    paths = [p for p in (src / f'{i}.jpg' for i in ids) if p.exists()]

    def checks(path) -> bool:
        return not preprocessing.is_image_corrupted(str(path), decoder) and \
            preprocessing.check_image_dimensions(str(path), vc.min_width,
                                                 vc.min_height, decoder)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=OFFLINE_WORKERS) as pool:
        passed = list(pool.map(checks, paths))
    t_checks = time.perf_counter() - t0
    proc = ImageProcessor(validation_config=vc,
                          compression_config=config.image_compression_config,
                          device=dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        valid = proc.process_items_images(ids, src, dest)
    t_step = time.perf_counter() - t0
    if {p.stem for p, ok in zip(paths, passed) if ok} != valid:
        raise AssertionError(f'preprocess: {decoder.name}\'s checks and '
                             f'its image step disagree')
    return {'decoder': proc.decoder.name, 'items': len(ids),
            'files': len(paths), 'valid': len(valid),
            'checks_ms_per_file': t_checks / len(paths) * 1e3,
            'step_ms_per_item': t_step / len(ids) * 1e3,
            'step_images_per_sec': len(ids) / t_step}, valid


def preprocess_phase(smi, dev, trainer_samples_per_sec: float,
                     n_items: int = PREPROCESS_ITEMS,
                     n_users: int = PREPROCESS_USERS) -> dict:
    """Raw files to a served model on the card: nvJPEG against the
    fixtures (``jpeg_fixture_check``), the raw workspace
    (``preprocess_raw_files``), ``preprocess_data.main([..., '--device',
    'cuda'])`` in this process with PIL hidden (``pil_hidden``: the
    decoder nvJPEG, the valid-item set the predicted one, seconds by step,
    images/s, row counts), the compression run's A12 raise, the image
    step again on the first PREPROCESS_COMPARE_ITEMS items with nvJPEG and
    then PIL where the machine has it (``image_step_timed``; the valid
    sets equal), random vision and language tables added to the packed
    ones, then ``cli_split_train`` and ``cli_serve`` on the processed
    files. Without the toolkit's libnvjpeg the phase holds the entry
    point's A12 raise instead and serves nothing. Returns K1's
    launches."""
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.data.columns import read_csv
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.data.image_codecs import (
        ImageCodecMissing,
        pil_image,
    )
    from pixelrec_multimodal_tpu_torch.ops import _build
    from pixelrec_multimodal_tpu_torch.scripts import preprocess_data
    from pixelrec_multimodal_tpu_torch.utils import yaml_io

    library = _build.toolkit_library('nvjpeg')
    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp) / 'main'
        made = preprocess_raw_files(ws, n_users=n_users, n_items=n_items)
        cfg = ws / 'config.yaml'
        yaml_io.dump_file(preprocess_config(ws), cfg)
        emit('preprocess_workspace', items=n_items, users=n_users,
             interactions=made['interactions'], fixtures=made['fixtures'],
             predicted_valid=len(made['valid']), seconds=made['seconds'],
             libnvjpeg=None if library is None else str(library),
             nvidia_smi=smi)
        if library is None:
            try:
                with contextlib.redirect_stdout(sys.stderr), pil_hidden():
                    preprocess_data.main(['--config', str(cfg), '--device',
                                          'cuda'])
            except ImageCodecMissing as e:
                if 'A12' not in str(e):
                    raise
                emit('preprocess', libnvjpeg=None, raised=str(e),
                     nvidia_smi=smi)
                return {'launches': 0}
            raise AssertionError('preprocess: no libnvjpeg and no PIL, and '
                                 'the entry point did not raise')

        fixtures = jpeg_fixture_check(dev)
        emit('preprocess_nvjpeg_fixtures', **fixtures, nvidia_smi=smi)
        if not fixtures['ok']:
            raise AssertionError(f'preprocess: nvJPEG against the fixtures: '
                                 f'{fixtures["files"]}')

        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr), pil_hidden():
            pipeline = preprocess_data.main(['--config', str(cfg),
                                             '--device', 'cuda'])
        wall = time.time() - t0
        decoder = pipeline.image_processor.decoder
        valid = {p.stem for p in (ws / 'processed' / 'images').iterdir()}
        items = read_csv(ws / 'processed' / 'item_info.csv')
        inter = read_csv(ws / 'processed' / 'interactions.csv')
        n_inter = len(inter['user_id'])
        images_s = pipeline.seconds['images']
        emit('preprocess', wall_seconds=wall, seconds=pipeline.seconds,
             decoder=decoder.name, nvjpeg_decodes=getattr(decoder,
                                                          'decodes', None),
             images=n_items, images_per_sec=n_items / images_s,
             ms_per_item=images_s / n_items * 1e3,
             valid_items=len(valid), predicted_valid=len(made['valid']),
             processed_items=len(items['item_id']),
             processed_interactions=n_inter,
             raw_interactions=made['interactions'],
             rare_tag_items=int((items['tag'].astype(str) ==
                                 'rare_tag').sum()),
             nvidia_smi=smi)
        if decoder.name != 'nvJPEG':
            raise AssertionError(f'preprocess: validated with '
                                 f'{decoder.name}, not nvJPEG')
        if valid != made['valid']:
            raise AssertionError(
                f'preprocess: {len(valid ^ made["valid"])} items differ from '
                f'the predicted valid set, e.g. '
                f'{sorted(valid ^ made["valid"])[:5]}')
        if not set(items['item_id'].astype(str).tolist()) <= valid:
            raise AssertionError('preprocess: an item without a valid image '
                                 'was kept')

        with pil_hidden():
            message = preprocess_compression_raises(Path(tmp) / 'compress')
        emit('preprocess_compression', raised=message, nvidia_smi=smi)

        # the image step by decoder, on the same files (warm: the entry
        # point read them all)
        config = Config.from_yaml(str(cfg)).data
        ids = made['item_ids'][:PREPROCESS_COMPARE_ITEMS]
        steps = {}
        with pil_hidden():
            steps['nvJPEG'], want = image_step_timed(
                config, ids, ws / 'raw' / 'images', Path(tmp) / 'nvjpeg', dev)
        try:
            pil_image()
        except ImageCodecMissing:
            steps['PIL'] = None
        else:
            steps['PIL'], got = image_step_timed(
                config, ids, ws / 'raw' / 'images', Path(tmp) / 'pil', dev)
            if got != want:
                raise AssertionError(f'preprocess: PIL and nvJPEG disagree '
                                     f'on {len(got ^ want)} items')
        emit('preprocess_decoders', **steps, nvidia_smi=smi)
        if steps['nvJPEG']['decoder'] != 'nvJPEG' or (
                steps['PIL'] and steps['PIL']['decoder'] != 'PIL'):
            raise AssertionError(f'preprocess: decoders {steps}')

        # the towers' tables, random, beside the packed input tables
        npz = ws / 'cache' / 'vision_resnet_lang_sentence-bert' / \
            'feature_tables.npz'
        with np.load(npz) as z:
            ids = z['item_ids']
        store = ItemFeatureStore(len(ids), ids, 'resnet', 'sentence-bert')
        if not store.load_tables(str(ws / 'cache')):
            raise AssertionError('preprocess: the packed tables did not load')
        random_embedding_tables(store, np.random.default_rng(SEED + 25))
        store.save(str(ws / 'cache'))
        del store

        res = cli_split_train(smi, dev, cfg, n_inter,
                              trainer_samples_per_sec,
                              phase='preprocess_cli')
        return cli_serve(smi, dev, cfg, res, phase='preprocess',
                         serve_users=min(n_users, CLI_SERVE_USERS))


@contextlib.contextmanager
def timed_calls(seconds: dict, targets):
    """Wrap each ``(owner, attribute, key)`` so that its calls add their
    host seconds to ``seconds[key]``; restored on exit."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             targets]

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[key] = seconds.get(key, 0.0) + time.time() - t0
        return wrapper
    for (owner, name, key), (_, _, fn) in zip(targets, saved):
        setattr(owner, name, timed(fn, key))
    try:
        yield seconds
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def load_step_targets() -> list:
    """``timed_calls`` targets of the steps that rebuild a dataset and a
    recommender from a training run's artifacts (``scripts/evaluate.py``:
    ``load_dataset``, ``create_recommender``), which both the generate and
    the evaluate entry point call."""
    from pixelrec_multimodal_tpu_torch.data import feature_store
    from pixelrec_multimodal_tpu_torch.scripts import evaluate as ev
    return [(ev, 'read_csv', 'csv_reads'),
            (ev, 'MultimodalDataset', 'dataset_build'),
            (feature_store, 'batch_encode', 'batch_encode'),
            (ev, 'load_precomputed_tables', 'tables_load'),
            (ev, 'build_model', 'model_build'),
            (ev, 'load_checkpoint', 'checkpoint_load'),
            (ev, 'load_model_state', 'checkpoint_load'),
            (ev, 'Recommender', 'scorer_setup')]


def run_generate(cfg_path: Path, out: Path, *flags) -> tuple:
    """``generate_recommendations.main`` on the card (the default device)
    for RECOMMEND_USERS sampled users, its stdout to stderr: (the returned
    report, the Recommender it built, host seconds by step, the launch
    counts of the run). Every launch count is set to 0 just before."""
    from pixelrec_multimodal_tpu_torch.inference import recommender as rmod
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.scripts import (
        generate_recommendations as gr,
    )
    built, load = {}, gr.load_model_and_data

    def capture(*args, **kwargs):
        built['recommender'], built['dataset'] = load(*args, **kwargs)
        return built['recommender'], built['dataset']
    targets = load_step_targets() + [
        (rmod.Recommender, '_seen_mask', 'seen_mask'),
        (CatalogScorer, 'top_k', 'top_k'),
        (rmod.Recommender, 'get_diverse_recommendations_batch', 'mmr_total'),
        (rmod, 'mmr_select', 'mmr_select'),
        (gr, 'dump_json', 'json_write')]
    seconds = {}
    torch.cuda.synchronize()
    reset_launches()
    gr.load_model_and_data = capture
    try:
        with timed_calls(seconds, targets), \
                contextlib.redirect_stdout(sys.stderr):
            t0 = time.time()
            report = gr.main(['--config', str(cfg_path), '--sample_users',
                              str(RECOMMEND_USERS), '--output', str(out),
                              *flags])
            torch.cuda.synchronize()
            seconds['wall'] = time.time() - t0
    finally:
        gr.load_model_and_data = load
    counts = launch_counts()
    if json.loads(out.read_text()) != json.loads(json.dumps(report)):
        raise AssertionError(f'recommend {flags}: the written report is not '
                             'the returned one')
    return report, built['recommender'], seconds, counts


def report_arrays(report: dict, dataset) -> tuple:
    """(user positions [U], item positions [U, k], scores [U, k]) of a
    report; raises unless every list holds TOP_K known items."""
    recs = report['recommendations']
    lists = list(recs.values())
    if any(len(items) != TOP_K for items in lists):
        raise AssertionError(f'recommend: lists of lengths '
                             f'{sorted({len(x) for x in lists})}, not '
                             f'{TOP_K}')
    users = dataset.user_encoder.transform(list(recs)).astype(np.int32)
    items = dataset.item_encoder.transform(
        [e['item_id'] for x in lists for e in x]).reshape(len(lists), TOP_K)
    scores = np.asarray([[e['score'] for e in x] for x in lists],
                        dtype=np.float32)
    return users, items, scores


def recommend_phase(smi, dev, ws: Path) -> dict:
    """Recommend from the command line on the cli phase's workspace
    ``ws``: ``generate_recommendations.main`` for RECOMMEND_USERS sampled
    users in bf16 (K1's launches counted through the entry point; the
    lists held against the plain bf16 version under the same seen mask by
    the cli phase's gate; no seen item, every id in the item file, TOP_K
    items each), with ``--use_diversity`` (MMR: no duplicate, the user's
    top item leads, every item in the user's bf16 pool of 5 TOP_K, no seen
    item) and with ``--precision int8`` (K1q and no K1 launched; its lists
    against the plain int8 version; the top-50 agreement with the bf16
    run printed beside INT8_FIDELITY); host seconds by step for each run.
    Then the checkpoint tools on the same workspace: the manager lists
    best_model and last_model and writes checkpoint_info.json, the
    inspector passes best_model, and extract_encoders writes the train
    script's classes. Returns K1's and K1q's launches over the three
    generate runs."""
    import pickle
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.data.columns import read_csv
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.scripts import (
        checkpoint_manager,
        extract_encoders,
        inspect_checkpoint,
    )

    t_phase = time.time()
    cfg_path, out_dir = ws / 'config.yaml', ws / 'recommend'
    config = Config.from_yaml(str(cfg_path))
    inter = read_csv(config.data.processed_interactions_path)
    seen_pairs = set(zip(inter['user_id'].astype(str).tolist(),
                         inter['item_id'].astype(str).tolist()))
    item_file = set(read_csv(config.data.processed_item_info_path)[
        'item_id'].astype(str).tolist())

    def check_lists(report, what):
        recs = report['recommendations']
        seen = sum((u, e['item_id']) in seen_pairs
                   for u, x in recs.items() for e in x)
        unknown = sum(e['item_id'] not in item_file
                      for x in recs.values() for e in x)
        dups = sum(len({e['item_id'] for e in x}) != len(x)
                   for x in recs.values())
        if len(recs) != RECOMMEND_USERS or seen or unknown or dups:
            raise AssertionError(f'recommend {what}: {len(recs)} users, '
                                 f'{seen} seen items, {unknown} ids not in '
                                 f'the item file, {dups} lists with '
                                 'duplicates')
        return {'seen_items_returned': seen, 'ids_not_in_item_file': unknown}

    # ---- bf16: K1 through the entry point, against the plain version
    report, rec, secs, counts = run_generate(cfg_path, out_dir / 'bf16.json')
    scorer, dataset = rec.scorer, rec.dataset
    users, items, scores = report_arrays(report, dataset)
    per_call = (-(-len(users) // scorer.user_chunk)
                * (scorer.n_pad // scorer.item_chunk))
    expected = {k: per_call if k == 'K1' else 0 for k in counts}
    if counts != expected or scorer.precision != 'bf16':
        raise AssertionError(f'recommend: kernel launches {counts} != '
                             f'expected {expected}')
    lists = check_lists(report, 'bf16')
    emit('recommend', users=len(users), items=scorer.n_items, k=TOP_K,
         host_seconds=secs, tokenize_share_of_dataset_build=(
             secs.get('batch_encode', 0.0) / secs['dataset_build']),
         top_k_pairs_per_sec=len(users) * scorer.n_items / secs['top_k'],
         top_k_share_of_wall=secs['top_k'] / secs['wall'],
         kernel_launches=counts, expected_launches=expected,
         block_rows=scorer.block_rows, **lists, nvidia_smi=smi)
    seen_mask = rec._seen_mask(users)
    check_against_plain(scorer, pairwise_scores_plain, users, scores, items,
                        'recommend_vs_plain',
                        gate='score_full_vs_f32_top50_flips', seen=seen_mask)
    pool = 5 * TOP_K
    pools = rec.get_recommendations_batch(list(report['recommendations']),
                                          top_k=pool)
    k1_launches = counts['K1']
    del scorer, rec
    torch.cuda.empty_cache()

    # ---- MMR: the same users with --use_diversity
    mmr, rec, secs, counts = run_generate(cfg_path, out_dir / 'mmr.json',
                                          '--use_diversity')
    lists = check_lists(mmr, 'mmr')
    report_arrays(mmr, rec.dataset)
    lead = outside = 0
    for user, x in mmr['recommendations'].items():
        ranked = [i for i, _ in pools[user]]
        lead += x[0]['item_id'] != ranked[0]
        outside += len({e['item_id'] for e in x} - set(ranked))
    emit('recommend_mmr', users=RECOMMEND_USERS, k=TOP_K, pool=pool,
         host_seconds=secs,
         mmr_host_seconds=secs['mmr_total'] - secs['top_k']
         - secs.get('seen_mask', 0.0),
         lists_not_led_by_top_item=lead, items_outside_pool=outside,
         kernel_launches=counts, **lists)
    if lead or outside or counts['K1'] == 0:
        raise AssertionError(f'recommend mmr: {lead} lists not led by the '
                             f'top item, {outside} items outside the pool')
    k1_launches += counts['K1']
    del rec
    torch.cuda.empty_cache()

    # ---- int8: K1q and no K1 through the entry point
    q, rec, secs, counts = run_generate(cfg_path, out_dir / 'int8.json',
                                        '--precision', 'int8')
    lists = check_lists(q, 'int8')
    q_users, q_items, q_scores = report_arrays(q, rec.dataset)
    agree = topc_overlap(q_items, items)
    emit('recommend_int8', users=RECOMMEND_USERS, k=TOP_K,
         precision=rec.scorer.precision, host_seconds=secs,
         kernel_launches=counts,
         top50_overlap_vs_bf16_run=agree, jax_package_bound=INT8_FIDELITY,
         **lists)
    if rec.scorer.precision != 'int8' or counts['K1'] \
            or not counts['K1q'] or (q_users != users).any():
        raise AssertionError(f'recommend int8: precision '
                             f'{rec.scorer.precision}, launches {counts}')
    check_against_plain(rec.scorer, pairwise_scores_plain, q_users,
                        q_scores, q_items, 'recommend_int8_vs_plain',
                        f32=False, seen=seen_mask)
    k1q_launches = counts['K1q']
    del rec
    torch.cuda.empty_cache()

    # ---- the checkpoint tools
    t0 = time.time()
    ckpt = Path(config.checkpoint_dir)
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        checkpoint_manager.main(['list', '--checkpoint_dir', str(ckpt)])
    with contextlib.redirect_stdout(sys.stderr):
        checkpoint_manager.main(['info', '--checkpoint_dir', str(ckpt)])
        inspected = inspect_checkpoint.main(
            [str(Path(config.model_specific_checkpoint_dir) / 'best_model')])
    info = json.loads((ckpt / 'checkpoint_info.json').read_text())
    enc_dir = Path(config.shared_encoders_dir)
    trained = {n: pickle.loads((enc_dir / f'{n}_encoder.pkl').read_bytes())
               for n in ('user', 'item', 'tag')}
    with contextlib.redirect_stdout(sys.stderr):
        extract_encoders.main(['--config', str(cfg_path)])
    extracted = {n: pickle.loads((enc_dir / f'{n}_encoder.pkl').read_bytes())
                 for n in trained}
    same = {n: bool(np.array_equal(extracted[n].classes_,
                                   trained[n].classes_)) for n in trained}
    found = {c['path'].split('/')[-1] for c in info['checkpoints']}
    emit('recommend_checkpoint_tools', seconds=time.time() - t0,
         listed=listing.getvalue().count('combo='), info=info,
         inspect_exit_code=inspected, encoders_equal_train=same)
    if not {'best_model', 'last_model'} <= found or inspected \
            or not all(same.values()) \
            or 'best_model' not in listing.getvalue():
        raise AssertionError(f'recommend: checkpoint tools: found {found}, '
                             f'inspect exit {inspected}, encoders {same}')
    emit('recommend_phase', seconds=time.time() - t_phase)
    return {'launches': k1_launches, 'launches_int8': k1q_launches}


def run_evaluate(args: list, out_dir: Path, name: str) -> dict:
    """``evaluate.main(args)`` on the card (the default device), its stdout
    to stderr, the results to ``out_dir/<name>.json`` and the predictions
    to ``out_dir/<name>_predictions.json``: the returned results, the
    predictions, the dataset and the recommender it built, host seconds by
    step and the launch counts of the run (every count set to 0 just
    before)."""
    from pixelrec_multimodal_tpu_torch.evaluation import tasks
    from pixelrec_multimodal_tpu_torch.inference import recommender as rmod
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.scripts import evaluate as ev
    built, load, create = {}, ev.load_dataset, ev.create_recommender

    def capture_dataset(*a, **kw):
        built['dataset'] = load(*a, **kw)
        return built['dataset']

    def capture_recommender(*a, **kw):
        built['recommender'] = create(*a, **kw)
        return built['recommender']
    retrieval = tasks.TopKRetrievalEvaluator
    targets = load_step_targets() + [
        (retrieval, '_candidate_set', 'candidate_sets'),
        (rmod.Recommender, 'score_candidates_batch', 'scoring'),
        (CatalogScorer, 'top_k', 'top_k'),
        (retrieval, '_accuracy_metrics', 'metric_pass'),
        (retrieval, '_novelty_metrics', 'novelty_pass'),
        (ev, 'dump_json', 'json_write')]
    out = out_dir / f'{name}.json'
    preds = out_dir / f'{name}_predictions.json'
    seconds = {}
    torch.cuda.synchronize()
    reset_launches()
    ev.load_dataset, ev.create_recommender = capture_dataset, \
        capture_recommender
    try:
        with timed_calls(seconds, targets), \
                contextlib.redirect_stdout(sys.stderr):
            t0 = time.time()
            results = ev.main([*args, '--output', str(out),
                               '--save_predictions', str(preds)])
            torch.cuda.synchronize()
            seconds['wall'] = time.time() - t0
    finally:
        ev.load_dataset, ev.create_recommender = load, create
    counts = launch_counts()
    if json.loads(out.read_text()) != json.loads(json.dumps(results)):
        raise AssertionError(f'evaluate {name}: the written results are not '
                             'the returned ones')
    return dict(results=results, predictions=json.loads(preds.read_text()),
                dataset=built['dataset'], recommender=built['recommender'],
                seconds=seconds, counts=counts)


def checked_metrics(results: dict, what: str) -> dict:
    """The metrics of an evaluation (its numbers); raises unless it
    evaluated RECOMMEND_USERS users and every metric is finite."""
    metrics = {k: v for k, v in results.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if results['num_users_evaluated'] != RECOMMEND_USERS or bad:
        raise AssertionError(f'evaluate {what}: '
                             f'{results["num_users_evaluated"]} users, '
                             f'non-finite {bad}')
    return metrics


def prediction_arrays(predictions: dict, dataset) -> tuple:
    """``report_arrays`` of an evaluation's predictions (user -> [[item,
    score], ...])."""
    return report_arrays({'recommendations': {
        u: [{'item_id': i, 'score': s} for i, s in x]
        for u, x in predictions.items()}}, dataset)


def evaluate_phase(smi, dev, ws: Path) -> dict:
    """Evaluate from the command line on the cli phase's workspace ``ws``.
    A test file of the validation rows of RECOMMEND_USERS users (drawn by
    EVALUATE_SEED, written by the port's ``write_csv``), the workspace's
    train file as ``--train_data``. ``evaluate.main`` on the card: with the
    CLI's defaults (retrieval, 20 random negatives a user, the float32
    candidate chain, no pair kernel), held against the port's CPU run of
    the same evaluation on the same dataset and checkpoint (the lists
    equal but where two scores lie within EVALUATE_TIE, every metric
    within EVALUATE_TOL of the CPU evaluator's on those lists); with ``--full_catalog`` (K1 once per chunk of one
    top-K over the users and no other kernel, the lists against the plain
    bf16 version by the cli phase's gate). Then, through
    ``create_recommender`` and ``create_evaluator`` on that run's dataset:
    int8 over the full catalog (K1q and no K1, the lists against the plain
    int8 version, the top-50 agreement with the bf16 run printed), ranking,
    and the four baselines on sampled retrieval. Host seconds by step for
    both entry-point runs, seconds for the rest. Returns K1's launches of
    the full-catalog run and K1q's of the int8 one."""
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.data.columns import (
        read_csv,
        take,
        write_csv,
    )
    from pixelrec_multimodal_tpu_torch.evaluation.tasks import (
        create_evaluator,
        get_task_from_string,
    )
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.scripts import evaluate as ev

    t_phase = time.time()
    cfg_path, out_dir = ws / 'config.yaml', ws / 'evaluate'
    config = Config.from_yaml(str(cfg_path))
    val = read_csv(config.data.val_data_path)
    chosen = np.random.default_rng(EVALUATE_SEED).choice(
        np.unique(val['user_id']), RECOMMEND_USERS, replace=False)
    test_csv = out_dir / 'test.csv'
    write_csv(take(val, np.isin(val['user_id'], chosen)), test_csv)
    test = read_csv(test_csv)
    train_csv = config.data.train_data_path
    args = ['--config', str(cfg_path), '--test_data', str(test_csv),
            '--train_data', str(train_csv)]
    retrieval = get_task_from_string('retrieval')

    def device_share(secs):
        return (secs.get('scoring', 0.0) + secs.get('top_k', 0.0)) \
            / secs['wall']

    # ---- 1. the CLI's defaults: sampled candidates, the float32 chain
    run = run_evaluate(args, out_dir, 'defaults')
    metrics = checked_metrics(run['results'], 'defaults')
    if any(run['counts'].values()):
        raise AssertionError(f'evaluate defaults: kernel launches '
                             f'{run["counts"]} on the candidate path')
    emit('evaluate', run='defaults', users=RECOMMEND_USERS,
         test_rows=len(test['user_id']), host_seconds=run['seconds'],
         device_call_share=device_share(run['seconds']), metrics=metrics,
         kernel_launches=run['counts'], nvidia_smi=smi)
    dataset, train_rows = run['dataset'], read_csv(train_csv)
    del run['recommender']
    torch.cuda.empty_cache()

    # ... against the port's CPU run on the same dataset and checkpoint
    # ... against the port's CPU run on the same dataset and checkpoint:
    # the lists equal but where two scores lie within EVALUATE_TIE, and
    # every metric within EVALUATE_TOL of the CPU evaluator's on the
    # card's lists. That is the CPU run's own metrics where no list
    # differs; a near tie that swaps a test positive with a negative
    # moves MRR and NDCG by up to 1/users, so the metrics of a run with
    # swaps are held to what its lists give, and the gap to the CPU run
    # is printed.
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        cpu_rec = ev.create_recommender('multimodal', config, dataset,
                                        train_rows, 'best_model.pth',
                                        device='cpu')
        cpu_eval = create_evaluator(retrieval, cpu_rec, test, config,
                                    num_negatives=20)
        cpu = cpu_eval.evaluate()
    cpu_s = time.time() - t0
    cpu_preds, card_preds = cpu.pop('predictions'), run['predictions']
    swapped = far = 0
    for user, ref in cpu_preds.items():
        got = card_preds.get(user, [])
        if len(got) != len(ref):
            far += 1
            continue
        for (item, _), (ref_item, ref_score) in zip(got, ref):
            if item != ref_item:
                swapped += 1
                far += abs(cpu_rec.get_item_score(user, item)
                           - ref_score) > EVALUATE_TIE
    reference = cpu
    if swapped and not far:
        with contextlib.redirect_stdout(sys.stderr):
            reference = cpu_eval._accuracy_metrics(
                [(u, card_preds[u], pos, [i for i, _ in card_preds[u]])
                 for u, pos in cpu_eval._user_groups()])
            reference.update(cpu_eval._novelty_metrics(
                reference.pop('predictions')))
    worst = max(abs(metrics[k] - v) for k, v in reference.items()
                if isinstance(v, float))
    same = all(run['results'][k] == v for k, v in reference.items()
               if not isinstance(v, float))
    emit('evaluate_vs_cpu', cpu_seconds=cpu_s,
         metric_max_abs_diff=worst, metric_tol=EVALUATE_TOL,
         metric_max_abs_diff_vs_cpu_run=max(
             abs(metrics[k] - v) for k, v in cpu.items()
             if isinstance(v, float)),
         positions_swapped=swapped, swaps_past_tie=far,
         tie=EVALUATE_TIE, users=len(cpu_preds))
    if worst > EVALUATE_TOL or not same or far \
            or list(cpu_preds) != list(card_preds):
        raise AssertionError(f'evaluate: the card run disagrees with the '
                             f'CPU run: metrics {worst}, {far} swaps past '
                             'the tie')
    del cpu_rec, cpu_eval

    # ---- 2. --full_catalog: one top-K over the users through K1
    full = run_evaluate(args + ['--full_catalog'], out_dir, 'full_catalog')
    full_metrics = checked_metrics(full['results'], 'full_catalog')
    dataset, rec = full['dataset'], full['recommender']
    scorer = rec.scorer
    users, items, scores = prediction_arrays(full['predictions'], dataset)
    per_call = (-(-len(users) // scorer.user_chunk)
                * (scorer.n_pad // scorer.item_chunk))
    expected = {k: per_call if k == 'K1' else 0 for k in full['counts']}
    if full['counts'] != expected or scorer.precision != 'bf16':
        raise AssertionError(f'evaluate full catalog: kernel launches '
                             f'{full["counts"]} != expected {expected}')
    emit('evaluate', run='full_catalog', users=len(users),
         items=scorer.n_items, k=TOP_K, host_seconds=full['seconds'],
         device_call_share=device_share(full['seconds']),
         top_k_pairs_per_sec=len(users) * scorer.n_items
         / full['seconds']['top_k'],
         metrics=full_metrics, defaults_metrics=metrics,
         kernel_launches=full['counts'], expected_launches=expected,
         block_rows=scorer.block_rows, nvidia_smi=smi)
    check_against_plain(scorer, pairwise_scores_plain, users, scores, items,
                        'evaluate_full_catalog_vs_plain',
                        gate='score_full_vs_f32_top50_flips')

    # ---- 3. int8 over the full catalog: K1q and no K1
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        rec8 = ev.create_recommender('multimodal', config, dataset,
                                     train_rows, 'best_model.pth',
                                     precision='int8', device=dev)
    setup8 = time.time() - t0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        res8 = create_evaluator(retrieval, rec8, test, config,
                                full_catalog=True).evaluate()
    secs8 = time.time() - t0
    counts8 = launch_counts()
    q_users, q_items, q_scores = prediction_arrays(res8.pop('predictions'),
                                                   dataset)
    expected8 = {k: per_call if k == 'K1q' else 0 for k in counts8}
    emit('evaluate_int8', users=len(q_users), precision=rec8.scorer.precision,
         setup_seconds=setup8, evaluate_seconds=secs8,
         metrics=checked_metrics(res8, 'int8'),
         bf16_metrics=full_metrics, kernel_launches=counts8,
         expected_launches=expected8,
         top50_overlap_vs_bf16_run=topc_overlap(q_items, items),
         jax_package_bound=INT8_FIDELITY)
    if rec8.scorer.precision != 'int8' or counts8 != expected8 \
            or (q_users != users).any():
        raise AssertionError(f'evaluate int8: precision '
                             f'{rec8.scorer.precision}, launches {counts8}')
    check_against_plain(rec8.scorer, pairwise_scores_plain, q_users,
                        q_scores, q_items, 'evaluate_int8_vs_plain',
                        f32=False)
    del rec8
    torch.cuda.empty_cache()

    # ---- 4. ranking on the learned recommender, then the baselines
    ranking = get_task_from_string('ranking')
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        ranked = create_evaluator(ranking, rec, test, config).evaluate()
    emit('evaluate_ranking', seconds=time.time() - t0,
         metrics=checked_metrics(ranked, 'ranking'),
         kernel_launches=launch_counts())
    k1_launches = full['counts']['K1']
    del rec, scorer, full
    torch.cuda.empty_cache()
    for kind in BASELINES:
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            base = ev.create_recommender(kind, config, dataset, train_rows)
        build_s = time.time() - t0
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            res = create_evaluator(retrieval, base, test, config,
                                   num_negatives=20).evaluate()
        sims = getattr(base, 'item_similarities',
                       getattr(base, 'user_similarities', None))
        emit('evaluate_baseline', recommender=kind, build_seconds=build_s,
             evaluate_seconds=time.time() - t0,
             similarity_shape=None if sims is None else list(sims.shape),
             similarity_nnz=None if sims is None else int(sims.nnz),
             metrics=checked_metrics(res, kind))
        del base
    emit('evaluate_phase', seconds=time.time() - t_phase)
    return {'launches': k1_launches, 'launches_int8': counts8['K1q']}


def hpo_tables(ws: Path) -> dict:
    """Random precomputed tables from SEED for the HPO_NEW_TABLES pairs
    (and a CLIP text table for a CLIP vision model, the trials that draw
    one being contrastive), written into the cli workspace's cache by
    ``ItemFeatureStore.save`` in the cli phase's item order; returns the
    seconds and bytes."""
    from pixelrec_multimodal_tpu_torch.config import MODEL_CONFIGS
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
        cache_subdir_name,
    )
    t0 = time.time()
    cache = ws / 'cache'
    with np.load(cache / cache_subdir_name('resnet', 'sentence-bert') /
                 'feature_tables.npz') as z:
        ids = z['item_ids']
    rng = np.random.default_rng(SEED + 31)
    written = {}
    for vision, language in HPO_NEW_TABLES:
        store = ItemFeatureStore(len(ids), ids, vision, language)
        for name, kind, model in (('vision_emb', 'vision', vision),
                                  ('language_emb', 'language', language)):
            if model:
                store.set_embedding_table(name, rng.standard_normal(
                    (len(ids), MODEL_CONFIGS[kind][model]['dim']),
                    dtype=np.float32))
        if vision == 'clip':
            store.set_embedding_table('clip_text_emb', rng.standard_normal(
                (len(ids), MODEL_CONFIGS['vision']['clip']['text_dim']),
                dtype=np.float32))
        store.save(str(cache))
        path = cache / cache_subdir_name(vision, language) / \
            'feature_tables.npz'
        written[path.parent.name] = path.stat().st_size
    return {'seconds': time.time() - t0, 'bytes': written}


HPO_PLAIN = {'concatenate': ('K1', 'pairwise_scores_plain'),
             'gated': ('K2', 'pairwise_scores_gated_plain'),
             'attention': ('K4', 'attention_scores_plain')}


def hpo_serve(scorer, users, seen, kid, phase, **fields):
    """One warm-up and one timed ``top_k`` of ``users`` with ``seen``
    masked, the launch counts set to 0 just before the timed call and read
    just after it (then the same call unmasked is timed beside it): fails
    unless ``kid`` and no other kernel launched once per (user block, item
    chunk), or if the lists are malformed or hold a seen item. Returns
    (scores, items, launches, seconds)."""
    scorer.top_k(users, TOP_K, seen_mask=seen)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    v, i = scorer.top_k(users, TOP_K, seen_mask=seen)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = launch_counts()
    t0 = time.time()  # the same call with no mask, for the mask's share
    scorer.top_k(users, TOP_K)
    torch.cuda.synchronize()
    unmasked = time.time() - t0
    per_call = (-(-len(users) // scorer.user_chunk)
                * (scorer.n_pad // scorer.item_chunk))
    expected = {k: per_call if k == kid else 0 for k in counts}
    hits = int(seen[np.arange(len(users))[:, None],
                    np.maximum(i, 0)].sum())
    emit(phase, users=len(users), items=scorer.n_items, k=TOP_K,
         seconds=seconds, pairs_per_sec=len(users) * scorer.n_items / seconds,
         unmasked_seconds=unmasked,
         unmasked_pairs_per_sec=len(users) * scorer.n_items / unmasked,
         kernel_launches=counts, expected_launches=expected,
         block_rows=scorer.block_rows, seen_items_returned=hits, **fields)
    if counts != expected:
        raise AssertionError(f'{phase}: kernel launches {counts} != '
                             f'expected {expected}')
    if v.shape != (len(users), TOP_K) or not np.isfinite(v).all() \
            or (i < 0).any() or (np.diff(v, axis=1) > 0).any() or hits:
        raise AssertionError(f'{phase}: top_k output malformed or {hits} '
                             'seen items returned')
    return v, i, counts[kid], seconds


def hpo_int8_vs_plain(scorer, users, v, i, phase) -> dict:
    """The int8 lists' top-50 values for 64 users against the plain int8
    version (bf16 mode, the kernels' rounding points) of the same items,
    relative to max(1, |score|), both fed the same user rows (those of
    ``top_k``'s first block): at most MAX_DIFFERING_PER_LAYER of the
    pairs per int8 layer past AGREE, as ``int8_kernel_checks`` allows,
    none past FLIP_TOL, and each pair past AGREE explained by at most
    FLIP_EXPLAIN_MOST code flips (``flip_explanation`` over
    ``exact_chain_int8``) to FLIP_MATCH. A code flips where an activation
    computed another way crosses a quantize boundary; on trained heads one
    flip moves a score past AGREE (ROADMAP C5). Prints the explained pairs
    with their residuals and flips, the largest move one flippable code
    makes alone, the flippable codes per pair, and how many of
    INT8_DECOYS pairs moved on purpose the flips would explain."""
    from pixelrec_multimodal_tpu_torch.inference.scorer import _exact_f32
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    head = scorer._head
    plain = (tpm.pairwise_scores_plain if head['fusion'] == 'concatenate'
             else tpm.pairwise_scores_gated_plain)
    with _exact_f32():
        # the user rows as ``top_k`` formed them, from its first block of
        # users: the user tower's float32 products over another number of
        # rows may round otherwise, and a user row's bf16 rounding then
        # moves every pair of that user
        side = tuple(t[:64] for t in scorer._fast_user_side(
            torch.from_numpy(users[:scorer.user_chunk].astype(np.int64)).to(
                scorer._scan_tables[0].device)))
        ref = torch.cat([plain(head, *side,
                               *(t[c:c + 4096] for t in scorer._scan_tables),
                               compute_dtype=torch.bfloat16)
                         for c in range(0, scorer.n_items, 4096)], dim=1)
        at = torch.from_numpy(i[:64].astype(np.int64)).to(ref.device)
        ref_at = ref.gather(1, at).cpu().numpy().ravel()
        x = int8_chain_inputs(scorer, side, at)
    target = v[:64].ravel().astype(np.float64)
    scale = np.maximum(1.0, np.abs(ref_at))
    rel = np.abs(target - ref_at) / scale
    layers = len(head['qlayers'])
    allowed = int(MAX_DIFFERING_PER_LAYER * layers * rel.size)
    past = np.flatnonzero(rel > AGREE)
    rng = np.random.default_rng(SEED + 43)
    decoys = rng.choice(rel.size, INT8_DECOYS, replace=False)
    moved = target[decoys] + rng.choice([-1, 1], INT8_DECOYS) * np.exp(
        rng.uniform(np.log(10 * AGREE), np.log(FLIP_TOL), INT8_DECOYS)
    ) * scale[decoys]
    with torch.no_grad():
        flips = flip_explanation(head, x, target, scale, past,
                                 exact=exact_chain_int8)
        fake = flip_explanation(
            head, x[torch.as_tensor(decoys, device=x.device)], moved,
            scale[decoys], range(INT8_DECOYS),
            exact=exact_chain_int8)['explained']
    ex = flips['explained']
    unexplained = [int(r) for r in past
                   if ex[r]['residuals'][-1] > FLIP_MATCH]
    emit(phase, users=min(64, len(users)), pairs=int(rel.size),
         int8_layers=layers,
         top50_max_rel_diff_vs_plain_int8=float(rel.max()),
         top50_pairs_past_agree=len(past),
         top50_share_past_agree=len(past) / rel.size,
         top50_pairs_allowed_past_agree=allowed,
         top50_pairs_past_flip_tol=int((rel > FLIP_TOL).sum()),
         top50_pairs_past_agree_explained=[
             {'pair': int(r), 'rel_diff': float(rel[r]), **ex[r]}
             for r in sorted(ex, key=lambda r: -rel[r])],
         top50_pairs_past_agree_unexplained=len(unexplained),
         top50_exact_vs_plain_max_rel_diff=float(np.max(
             np.abs(flips['exact'] - ref_at) / scale)),
         top50_max_single_flip_move=float(flips['single_move'].max()),
         top50_flippable_per_pair_mean=float(flips['flippable'].mean()),
         top50_flippable_per_pair_max=int(flips['flippable'].max()),
         decoys=INT8_DECOYS, decoys_explained=int(sum(
             e['residuals'][-1] <= FLIP_MATCH for e in fake.values())),
         agree=AGREE, flip_tol=FLIP_TOL, flip_explain_most=FLIP_EXPLAIN_MOST,
         flip_match=FLIP_MATCH,
         gate='pairs past AGREE <= MAX_DIFFERING_PER_LAYER x int8 layers, '
              'none past FLIP_TOL, each explained by code flips')
    if len(past) > allowed or rel.max() > FLIP_TOL or unexplained:
        raise AssertionError(
            f'{phase}: {len(past)} pairs past {AGREE} (allowed {allowed}), '
            f'largest {rel.max()}, {len(unexplained)} unexplained by code '
            f'flips')
    return {'max_rel_diff': float(rel.max()), 'past_agree': len(past)}


def hpo_phase(smi, dev, ws: Path) -> dict:
    """Hyperparameter search from the command line on the cli phase's
    workspace ``ws``. Random tables for the pairs the trials draw
    (``hpo_tables``); ``create_training_subsets.create_subsets`` on a copy
    of the cli config at HPO_EPOCHS that trains on HPO_TRAIN_SHARE of the
    training rows and validates on HPO_VAL_SHARE of the validation rows
    (timed; 5% within 20% within 50%, each within 2 rows of its share);
    then ``hyperparameter_search.main`` on the
    card, HPO_TRIALS trials on the 5% subset from the default seed, every
    trial COMPLETE with a finite value (the objective turns any failure
    into the worst value, so a device or kernel failure fails here), with
    ``run_training``'s host seconds by step, the Trainer's epoch split,
    samples/s and ms a step at each trial's batch. Each trial's best
    checkpoint then serves HPO_SERVE_USERS users over the full catalog,
    top-K, their training items masked: concat heads through K1, the gated
    head through K2 (exact) and the attention head through K4 (stream),
    each kernel and no other (``hpo_serve``), each held against its plain
    version by the cli phase's gate (``check_against_plain``,
    'score_full_vs_f32_top50_flips'); then the concat and gated heads in
    int8 (``precision='int8'``, else 'int8!' where the flip point keeps a
    head in bf16; a head with no hidden layer has nothing to quantize and
    is refused): K1q or K2q and no bf16 kernel, the top-50 values held
    against the plain int8 version (``hpo_int8_vs_plain``: a pair past
    AGREE passes where code flips explain it), the top-50 agreement with
    the bf16 lists printed beside INT8_FIDELITY. Last, the search's files
    parse, the best trial is the study's minimum, and whether PNGs were
    written.
    Returns the launches by kernel."""
    import pickle
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.data.columns import (
        n_rows,
        read_csv,
        take,
        write_csv,
    )
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.data.processors import (
        NumericalProcessor,
    )
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.models.multimodal import build_model
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    from pixelrec_multimodal_tpu_torch.scripts import (
        create_training_subsets,
    )
    from pixelrec_multimodal_tpu_torch.scripts import (
        hyperparameter_search as hps,
    )
    from pixelrec_multimodal_tpu_torch.utils import yaml_io
    from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
        load_checkpoint,
        load_model_state,
    )
    t_phase = time.time()
    tables = hpo_tables(ws)
    emit('hpo_tables', **tables)

    # ---- the subsets, from a copy of the cli config at HPO_EPOCHS that
    # trains on HPO_TRAIN_SHARE of the training rows and validates on
    # HPO_VAL_SHARE of the validation rows
    config = yaml_io.load_file(ws / 'config.yaml')
    config['training']['epochs'] = HPO_EPOCHS
    rng = np.random.default_rng(SEED + 44)
    for key, share in (('train_data_path', HPO_TRAIN_SHARE),
                       ('val_data_path', HPO_VAL_SHARE)):
        table = read_csv(config['data'][key])
        n = n_rows(table)
        path = Path(config['data'][key])
        path = path.with_name(f'{path.stem}_hpo.csv')
        write_csv(take(table, np.sort(rng.choice(n, round(share * n),
                                                 replace=False))), path)
        config['data'][key] = str(path)
    cfg_path = ws / 'hpo_config.yaml'
    yaml_io.dump_file(config, cfg_path)
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        subsets = create_training_subsets.create_subsets(str(cfg_path))
    subsets_wall = time.time() - t0
    rows = subsets['rows']
    keys = {frac: {tuple(r) for r in zip(*(read_csv(path)[c] for c in (
        'user_id', 'item_id', 'timestamp')))}
        for frac, path in subsets['paths'].items()}
    nested = keys['05'] <= keys['20'] <= keys['50']
    shares = {'50': 0.5, '20': 0.2, '05': 0.05}
    off = {f: rows[f] - shares[f] * rows['full'] for f in shares}
    emit('hpo_subsets', wall_seconds=subsets_wall,
         seconds=subsets['seconds'], rows=rows, rows_off_share=off,
         nested=nested, monthly_drift=subsets['drift'])
    if not nested or any(abs(x) > 2 for x in off.values()):
        raise AssertionError(f'hpo: subsets not nested or off their shares: '
                             f'{rows}')

    # ---- the search on the card
    out = ws / 'hpo'
    results, real = {}, hps.run_training

    def run_training(config, args):
        t = time.time()
        res = real(config, args)
        results[args.trial_info['trial_number']] = dict(
            res, wall=time.time() - t, batch=config.training.batch_size)
        return res
    torch.cuda.synchronize()
    reset_launches()
    hps.run_training = run_training
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            study = hps.main([
                '--config', str(cfg_path), '--n_trials', str(HPO_TRIALS),
                '--trials_on_5_percent', str(HPO_TRIALS), '--device', 'cuda',
                '--output_dir', str(out), '--study_name', 'chip_smoke',
                '--storage', str(ws / 'hpo_study.json')])
    finally:
        hps.run_training = real
    search_wall = time.time() - t0
    during = launch_counts()
    trials = study.trials
    for t in trials:
        res = results.get(t.number)
        p = t.params
        if res is None:
            emit('hpo_trial', trial=t.number, state=t.state, value=t.value,
                 params=p, failed=True)
            continue
        steps = -(-res['train_samples'] // res['batch'])
        epoch_train = [e['train'] for e in res['epoch_seconds']]
        emit('hpo_trial', trial=t.number, state=t.state, value=t.value,
             params=p, data_fraction=t.user_attrs.get('data_fraction'),
             wall_seconds=res['wall'], seconds=res['seconds'],
             epoch_seconds=res['epoch_seconds'],
             train_samples=res['train_samples'], batch=res['batch'],
             steps_per_epoch=steps,
             samples_per_sec=[res['train_samples'] / s for s in epoch_train],
             ms_per_step=[s / steps * 1e3 for s in epoch_train],
             train_losses=res['train_losses'], val_losses=res['val_losses'],
             best_val_loss=res['best_val_loss'], nvidia_smi=smi)
    bad = [(t.number, t.state, t.value) for t in trials
           if t.state != 'COMPLETE' or t.value is None
           or not np.isfinite(t.value) or t.number not in results]
    emit('hpo_search', trials=len(trials), wall_seconds=search_wall,
         kernel_launches_during_training=during, failed_trials=bad)
    if len(trials) != HPO_TRIALS or bad:
        raise AssertionError(f'hpo: trials not COMPLETE and finite: {bad}')
    if any(during.values()):
        raise AssertionError(f'hpo: training launched serving kernels: '
                             f'{during}')

    # ---- serve each trial's best checkpoint
    items = read_csv(config['data']['processed_item_info_path'])
    train_rows = read_csv(config['data']['train_data_path'])
    launches = {'K1': 0, 'K2': 0, 'K4': 0}
    launches_int8 = {'K1q': 0, 'K2q': 0}
    int8_taken = {}
    for t in trials:
        trial_dir = out / f'trial_{t.number}'
        t0 = time.time()
        cfg = Config.from_yaml(str(trial_dir / 'results' /
                                   'training_run_config_validated.yaml'))
        ds = results[t.number]['metadata']['data_stats']
        model = build_model(cfg.model, ds['total_users'], ds['total_items'],
                            ds['total_tags'], ds['numerical_features'],
                            device=dev)
        combo = f'{cfg.model.vision_model}_{cfg.model.language_model}'
        best = load_checkpoint(trial_dir / 'checkpoints' / combo,
                               'best_model', device=dev)
        load_model_state(model, best['state'])
        enc_dir = trial_dir / 'checkpoints' / 'encoders'
        encoders = {name: pickle.loads((enc_dir / f'{name}_encoder.pkl')
                                       .read_bytes())
                    for name in ('user', 'item', 'tag')}
        numerical = NumericalProcessor(
            numerical_cols=cfg.data.numerical_features_cols,
            normalization_method=cfg.data.numerical_normalization_method)
        numerical.load_scaler(cfg.data.scaler_path)
        store = ItemFeatureStore.build(
            items, encoders['item'], tag_encoder=encoders['tag'],
            vision_model=cfg.model.vision_model,
            language_model=cfg.model.language_model,
            numerical_processor=numerical, tokenize_text=False)
        if not store.load_tables(cfg.data.cache_config.cache_directory):
            raise AssertionError(f'hpo trial {t.number}: the tables did not '
                                 'load')
        scorer = CatalogScorer(model, store, device=dev)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        seen_u = encoders['user'].transform(
            train_rows['user_id'].astype(str))
        seen_i = encoders['item'].transform(
            train_rows['item_id'].astype(str))
        users = np.sort(np.random.default_rng(SEED + 32).choice(
            np.unique(seen_u), HPO_SERVE_USERS, replace=False)
        ).astype(np.int32)
        row_of = np.full(ds['total_users'], -1)
        row_of[users] = np.arange(len(users))
        seen = np.zeros((len(users), ds['total_items']), dtype=bool)
        hit = row_of[seen_u] >= 0
        seen[row_of[seen_u[hit]], seen_i[hit]] = True
        fusion = cfg.model.fusion_type
        kid, plain_name = HPO_PLAIN[fusion]
        plain = (user_item_call(tas.attention_scores_plain, 5)
                 if fusion == 'attention' else getattr(tpm, plain_name))
        phase = f'hpo_main_path_trial_{t.number}'
        v, i, n, _ = hpo_serve(
            scorer, users, seen, kid, phase, trial=t.number, fusion=fusion,
            embedding_dim=cfg.model.embedding_dim,
            hidden=list(cfg.model.fusion_hidden_dims),
            activation=cfg.model.fusion_activation,
            heads=cfg.model.num_attention_heads, setup_seconds=setup_s,
            best_epoch=best['meta'].get('epoch'), nvidia_smi=smi)
        launches[kid] += n
        check_against_plain(scorer, plain, users, v, i, f'{phase}_vs_plain',
                            gate='score_full_vs_f32_top50_flips', seen=seen)
        del scorer
        torch.cuda.empty_cache()
        if fusion == 'attention':
            del model, store
            continue
        # ---- int8: 'int8', or 'int8!' where the flip point keeps bf16
        taken = 'int8'
        qscorer = CatalogScorer(model, store, precision='int8', device=dev)
        if qscorer.precision != 'int8':
            del qscorer
            taken = 'int8!'
            try:
                qscorer = CatalogScorer(model, store, precision='int8!',
                                        device=dev)
            except ValueError as e:  # no hidden layer to quantize
                int8_taken[t.number] = f'refused: {e}'
                emit(f'{phase}_int8', trial=t.number, refused=str(e),
                     hidden=list(cfg.model.fusion_hidden_dims))
                del model, store
                continue
        int8_taken[t.number] = taken
        qkid = kid + 'q'
        qv, qi, qn, _ = hpo_serve(qscorer, users, seen, qkid,
                                  f'{phase}_int8', trial=t.number,
                                  precision_asked=taken,
                                  precision=qscorer.precision,
                                  nvidia_smi=smi)
        launches_int8[qkid] += qn
        hpo_int8_vs_plain(qscorer, users, qv, qi, f'{phase}_int8_vs_plain')
        check_against_plain(qscorer, plain, users, qv, qi,
                            f'{phase}_int8_vs_plain_overlap', f32=False,
                            seen=seen)
        emit(f'{phase}_int8_vs_bf16', users=len(users), k=TOP_K,
             top50_overlap_vs_bf16=topc_overlap(qi, i),
             jax_package_bound=INT8_FIDELITY)
        del qscorer, model, store
        torch.cuda.empty_cache()

    # ---- the search's files
    best_params = json.loads((out / 'best_params.json').read_text())
    yaml_io.load_file(out / 'best_config.yaml')
    table = json.loads((out / 'study_results.json').read_text())
    summaries = [json.loads((out / f'trial_{t.number}' /
                             'trial_summary.json').read_text())
                 for t in trials]
    minimum = min(trials, key=lambda t: t.value)
    pngs = sorted(p.name for p in out.glob('*.png'))
    emit('hpo_files', best_trial=best_params['trial_number'],
         best_value=best_params['value'], study_minimum=minimum.number,
         study_results_rows=len(table), trial_summaries=len(summaries),
         pngs_written=bool(pngs), pngs=pngs, int8_taken=int8_taken,
         launches=launches, launches_int8=launches_int8)
    if best_params['trial_number'] != minimum.number \
            or best_params['value'] != minimum.value \
            or len(table) != HPO_TRIALS:
        raise AssertionError(f'hpo: best trial {best_params} is not the '
                             f'study minimum {minimum.number}')
    if not all(launches.values()) or not all(launches_int8.values()):
        raise AssertionError(f'hpo: a kernel was not launched: {launches}, '
                             f'{launches_int8}')
    emit('hpo_phase', seconds=time.time() - t_phase)
    return {'launches': launches, 'launches_int8': launches_int8}


def tower_model(modality: str, key: str, seed: int = SEED):
    """One frozen tower at its published geometry on the CPU, in eval
    mode: random weights from ``seed`` (``encoders.common.random_init_``,
    as the precompute draws them without a checkpoint), then its layer
    scales and frozen BatchNorm statistics drawn from ``seed + 1``."""
    from pixelrec_multimodal_tpu_torch.encoders import registry
    from pixelrec_multimodal_tpu_torch.encoders.common import random_init_
    model = (registry.build_clip_text_encoder() if modality == 'clip_text'
             else registry.build_vision_encoder(key) if modality == 'vision'
             else registry.build_language_encoder(key))
    random_init_(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    stats = ('running_mean', 'running_var')
    with torch.no_grad():
        # the statistics last, in module order, as when they were buffers
        for name, t in sorted(model.named_parameters(),
                              key=lambda nt: nt[0].endswith(stats)):
            leaf = name.rsplit('.', 1)[-1]
            if leaf in ('layerscale1', 'layerscale2', 'layer_scale',
                        'running_var'):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif leaf == 'running_mean':
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return model.eval()


def tower_inputs(modality: str, key: str, n: int, seed: int = SEED) -> tuple:
    """``n`` items' inputs from ``seed``: uint8 224 x 224 frames, or token
    ids and masks at the tower's length (512; CLIP text 77), the first row
    full, the others with padded tails; a CLIP row closes with its EOT,
    the highest id."""
    from pixelrec_multimodal_tpu_torch.encoders.clip import CLIPTextConfig
    from pixelrec_multimodal_tpu_torch.encoders.text_models import (
        TEXT_CONFIGS,
    )
    rng = np.random.default_rng(seed)
    if modality == 'vision':
        return (rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),)
    if modality == 'clip_text':
        length, vocab, pad = 77, CLIPTextConfig().vocab_size, 0
    else:
        cfg = TEXT_CONFIGS[key]
        length, vocab, pad = 512, cfg.vocab_size, cfg.pad_token_id
    ids = rng.integers(pad + 2, vocab - 1, (n, length))
    lengths = rng.integers(length // 4, length + 1, n)
    lengths[0] = length
    mask = np.arange(length)[None, :] < lengths[:, None]
    if modality == 'clip_text':
        ids[np.arange(n), lengths - 1] = vocab - 1
    ids[~mask] = pad
    return ids.astype(np.int32), mask.astype(np.int32)


def tower_forward(model, modality: str, key: str, dev):
    """The tower's pooled forward as the precompute runs it (vision: uint8
    frames normalized on ``dev``)."""
    from pixelrec_multimodal_tpu_torch.data.processors.image_processor \
        import PREPROCESS_SPECS
    from pixelrec_multimodal_tpu_torch.encoders.precompute import (
        vision_pooled_fn,
    )
    if modality == 'vision':
        return vision_pooled_fn(model, PREPROCESS_SPECS[key], dev)
    return model.pooled


def held_to_tower_tol(got: np.ndarray, ref: np.ndarray) -> dict:
    """``got`` against ``ref`` at rtol = atol = TOWER_TOL and at
    TOWER_FP32_TOL: ``max_scaled_err`` is the largest
    |got - ref| / (1 + |ref|)."""
    err = np.abs(got - ref)
    scaled = float((err / (1 + np.abs(ref))).max())
    return {'max_abs_err': float(err.max()),
            'max_excess': float((err - TOWER_TOL * (1 + np.abs(ref))).max()),
            'max_scaled_err': scaled, 'fp32_tol': TOWER_FP32_TOL,
            'ref_max_abs': float(np.abs(ref).max()),
            'ok': bool(np.isfinite(got).all() and got.shape == ref.shape
                       and (err <= TOWER_TOL * (1 + np.abs(ref))).all()
                       and scaled <= TOWER_FP32_TOL)}


@contextlib.contextmanager
def tf32_on():
    """TF32 allowed in float32 products and convolutions for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tower_card_vs_cpu(modality: str, key: str, dev,
                      n: int = TOWER_CHECK_ITEMS, seed: int = SEED):
    """The tower (``tower_model``) on the CPU and a copy of it on ``dev``
    over the same ``n`` items, float32 with TF32 off: (the pooled outputs
    held to TOWER_TOL and TOWER_FP32_TOL, the tower on ``dev``). The
    check also reads the card's forward with TF32 on
    (``tf32_max_scaled_err``), the error the TF32 gate is to catch."""
    from pixelrec_multimodal_tpu_torch.encoders.common import no_tf32
    from pixelrec_multimodal_tpu_torch.encoders.registry import pooled_dim
    cpu = tower_model(modality, key, seed)
    card = copy.deepcopy(cpu).to(dev)
    inputs = [torch.from_numpy(a) for a in tower_inputs(modality, key, n,
                                                        seed)]
    with torch.no_grad(), no_tf32():
        ref = tower_forward(cpu, modality, key, torch.device('cpu'))(*inputs)
        got = tower_forward(card, modality, key, dev)(
            *(t.to(dev) for t in inputs))
    with torch.no_grad(), tf32_on():
        got_tf32 = tower_forward(card, modality, key, dev)(
            *(t.to(dev) for t in inputs))
    ref, got = ref.numpy(), got.float().cpu().numpy()
    out = held_to_tower_tol(got, ref)
    out['tf32_max_scaled_err'] = held_to_tower_tol(
        got_tf32.float().cpu().numpy(), ref)['max_scaled_err']
    out['ok'] &= got.shape == (n, pooled_dim(modality, key))
    return out, card


def precompute_phase(smi, dev, workspace: Optional[Path] = None) -> dict:
    """The precompute on the card (the entry point's workspace in
    ``workspace`` where given, kept for the mesh phase). 1. Each of the
    nine towers (TOWERS) card against CPU (``tower_card_vs_cpu``), then
    its items/s on the card
    at batch TOWER_RATE_BATCH (median of 3 after a warm-up). 2. A
    PRECOMPUTE_ITEMS workspace (an item file with tags, NUM_FEAT
    numerical columns and descriptions; resnet + sentence-bert, no image
    folder) through ``precompute_cache.main`` on its default device,
    cuda: ``language_emb`` at 512 tokens, timed by part (the tokenizer,
    the forwards, the npz write), its first rows against the same tower
    on the CPU. 3. ResNet-50 over as many seeded uint8 frames through
    ``_batched_pooled`` and ``vision_pooled_fn``, installed as
    ``vision_emb``, its first rows against the CPU. 4. The flagship head
    (``flagship_model`` over these items) served on the two tables to
    PRECOMPUTE_USERS users through K1 (``drive_top_k``,
    ``check_against_plain``). Returns K1's launches."""
    from pixelrec_multimodal_tpu_torch.data import feature_store
    from pixelrec_multimodal_tpu_torch.data.columns import write_csv
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.encoders import precompute as tpre
    from pixelrec_multimodal_tpu_torch.encoders.common import no_tf32
    from pixelrec_multimodal_tpu_torch.encoders.registry import (
        build_language_encoder,
        build_vision_encoder,
    )
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.scripts import precompute_cache
    from pixelrec_multimodal_tpu_torch.utils import yaml_io

    t_phase = time.time()
    # ---- 1. the nine towers, card against CPU, then items/s on the card
    towers = {}
    for modality, key in TOWERS:
        t0 = time.time()
        check, card = tower_card_vs_cpu(modality, key, dev)
        check_s = time.time() - t0
        fwd = tower_forward(card, modality, key, dev)
        batch = [torch.from_numpy(a).to(dev) for a in tower_inputs(
            modality, key, TOWER_RATE_BATCH, SEED + 1)]
        times = []
        with torch.no_grad(), no_tf32():
            fwd(*batch)
            torch.cuda.synchronize()
            for _ in range(3):
                t = time.time()
                fwd(*batch)
                torch.cuda.synchronize()
                times.append(time.time() - t)
        name = f'{modality}/{key}'
        towers[name] = TOWER_RATE_BATCH / statistics.median(times)
        emit('precompute_tower', tower=name, items=TOWER_CHECK_ITEMS,
             tol=TOWER_TOL, **check, check_seconds=check_s,
             batch=TOWER_RATE_BATCH, batch_seconds=times,
             items_per_sec=towers[name], dtype='float32', tf32=False,
             nvidia_smi=smi)
        del card, fwd, batch
        torch.cuda.empty_cache()
        if not check['ok']:
            raise AssertionError(f'precompute: the {name} tower on the card '
                                 f'disagrees with the CPU: {check}')

    n = PRECOMPUTE_ITEMS
    rng = np.random.default_rng(SEED + 31)
    with (contextlib.nullcontext(str(workspace)) if workspace is not None
          else tempfile.TemporaryDirectory()) as tmp:
        # ---- 2. the entry point: language_emb on the card
        ws = Path(tmp)
        proc, cache = ws / 'processed', ws / 'cache'
        cols = [f'num_{c}' for c in range(NUM_FEAT)]
        words = np.array([f'word{k}' for k in range(20000)])
        items = {'item_id': np.array([f'item{j:05d}' for j in range(n)]),
                 'tag': np.array([f'tag{t}' for t in
                                  rng.integers(0, N_TAGS, n)]),
                 'description': np.array(
                     [' '.join(rng.choice(words, k))
                      for k in rng.integers(8, 160, n)], dtype=object),
                 **{c: rng.standard_normal(n) for c in cols}}
        write_csv(items, proc / 'item_info.csv')
        config = {
            'model': {'vision_model': 'resnet',
                      'language_model': 'sentence-bert'},
            'data': {'processed_item_info_path': str(proc / 'item_info.csv'),
                     'scaler_path': str(proc / 'numerical_scaler.pkl'),
                     'image_folder': None,
                     'processed_image_destination_folder': None,
                     'numerical_features_cols': cols,
                     'categorical_features_cols': ['tag'],
                     'cache_config': {'enabled': True, 'use_disk': True,
                                      'cache_directory': str(cache)}}}
        cfg_path = ws / 'config.yaml'
        yaml_io.dump_file(config, cfg_path)
        seconds = {}
        torch.cuda.synchronize()
        t0 = time.time()
        with timed_calls(seconds, [
                (precompute_cache, 'read_csv', 'read_csv'),
                (precompute_cache, 'MultimodalDataset', 'dataset_build'),
                (feature_store, 'batch_encode', 'tokenizer'),
                (precompute_cache, 'precompute_embedding_tables',
                 'embedding_tables'),
                (tpre, 'params_or_random', 'weights'),
                (tpre, '_batched_pooled', 'forwards'),
                (ItemFeatureStore, 'save', 'npz_write')]), \
                contextlib.redirect_stdout(sys.stderr):
            store = precompute_cache.main(['--config', str(cfg_path)])
        entry_s = time.time() - t0
        # tokenizer lies inside dataset_build; weights and forwards inside
        # embedding_tables, whose rest is the towers' build and copy to
        # the card.
        seconds['tables_rest'] = seconds['embedding_tables'] - seconds[
            'weights'] - seconds['forwards']
        seconds['other'] = entry_s - sum(
            seconds[k] for k in ('read_csv', 'dataset_build',
                                 'embedding_tables', 'npz_write'))
        npz = cache / 'vision_resnet_lang_sentence-bert' / 'feature_tables.npz'
        with np.load(npz, allow_pickle=False) as z:
            saved = {k: z[k].shape for k in z.files}
            saved_equal = np.array_equal(z['language_emb'],
                                         store.tables['language_emb'])
        npz_bytes = npz.stat().st_size
    language = store.tables['language_emb']
    ids = store.tables['text_input_ids']
    with torch.no_grad(), contextlib.redirect_stdout(sys.stderr):
        ref = tpre.params_or_random(
            'language', 'sentence-bert',
            build_language_encoder('sentence-bert')).eval().pooled(
                torch.from_numpy(ids[:TOWER_CHECK_ITEMS]),
                torch.from_numpy(store.tables['text_attention_mask'][
                    :TOWER_CHECK_ITEMS])).numpy()
    lang_check = held_to_tower_tol(language[:TOWER_CHECK_ITEMS], ref)
    host_s = seconds.get('tokenizer', 0.0) + seconds.get('npz_write', 0.0)
    emit('precompute_entry_point', items=n, device='cuda',
         dataset_build_includes_tokenizer=True,
         tables=saved, npz_bytes=npz_bytes, text_tokens=ids.shape[1],
         seconds=entry_s, seconds_by_part=seconds,
         language_emb_items_per_sec=n / seconds['forwards'],
         host_share=host_s / entry_s,
         forwards_share=seconds['forwards'] / entry_s,
         language_vs_cpu=lang_check, nvidia_smi=smi)
    expected = {'item_ids', 'tag_idx', 'numerical', 'text_input_ids',
                'text_attention_mask', 'language_emb'}
    if set(saved) != expected or saved['language_emb'] != (n, LANG_DIM) \
            or ids.shape != (n, 512) or not saved_equal:
        raise AssertionError(f'precompute: the entry point wrote {saved}')
    if not (np.isfinite(language).all() and np.abs(language).max() <= 1.0
            and lang_check['ok']):
        raise AssertionError(f'precompute: language_emb malformed or off '
                             f'the CPU: {lang_check}')

    # ---- 3. vision_emb: ResNet-50 over seeded uint8 frames, the same
    # batching and device-side normalize
    frame_s = [0.0]

    def frames(idx):
        t = time.time()
        out = np.random.default_rng(SEED + 32 + int(idx[0])).integers(
            0, 256, (len(idx), 224, 224, 3), dtype=np.uint8)
        frame_s[0] += time.time() - t
        return (out,)
    with contextlib.redirect_stdout(sys.stderr):
        model = tpre.params_or_random('vision', 'resnet',
                                      build_vision_encoder('resnet'))
    card = copy.deepcopy(model).to(dev).eval()
    fwd = tower_forward(card, 'vision', 'resnet', dev)
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr), no_tf32():
        vision = tpre._batched_pooled(fwd, n, VISION_DIM, TOWER_RATE_BATCH,
                                      frames, dev)
    vision_s = time.time() - t0
    store.set_embedding_table('vision_emb', vision)
    with torch.no_grad():
        ref = tower_forward(model.eval(), 'vision', 'resnet',
                            torch.device('cpu'))(torch.from_numpy(frames(
                                np.arange(TOWER_RATE_BATCH))[0][
                                    :TOWER_CHECK_ITEMS])).numpy()
    vision_check = held_to_tower_tol(vision[:TOWER_CHECK_ITEMS], ref)
    emit('precompute_vision', items=n, batch=TOWER_RATE_BATCH,
         seconds=vision_s, vision_emb_items_per_sec=n / vision_s,
         frame_seconds_on_the_worker=frame_s[0], vision_vs_cpu=vision_check,
         nvidia_smi=smi)
    del model, card, fwd
    torch.cuda.empty_cache()
    if not (np.isfinite(vision).all() and vision.min() >= 0.0
            and vision.shape == (n, VISION_DIM) and vision_check['ok']):
        raise AssertionError(f'precompute: vision_emb malformed or off the '
                             f'CPU: {vision_check}')

    # ---- 4. the flagship head served on the two tables through K1
    t0 = time.time()
    model = flagship_model(SEED + 33, dev, n_items=n)
    scorer = CatalogScorer(model, store, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    users = np.sort(np.random.default_rng(SEED + 34).choice(
        N_MODEL_USERS, PRECOMPUTE_USERS, replace=False)).astype(np.int32)
    v, i, launches, _ = drive_top_k(scorer, users, 'K1',
                                    'precompute_main_path',
                                    setup_seconds=setup_s, nvidia_smi=smi)
    check_against_plain(scorer, pairwise_scores_plain, users, v, i,
                        'precompute_main_path_vs_plain')
    emit('precompute', seconds=time.time() - t_phase,
         tower_items_per_sec=towers, nvidia_smi=smi)
    del scorer, model, store
    torch.cuda.empty_cache()
    return {'launches': launches}


def e2e_tiny_model(remat: bool = False, seed: int = SEED):
    """The card-against-CPU model on the CPU: a small scorer with BatchNorm
    behind a 2-stage ResNet and a 1-layer text tower, weights from
    ``seed``, the ResNet's frozen BatchNorm statistics drawn too."""
    from pixelrec_multimodal_tpu_torch.encoders.common import random_init_
    from pixelrec_multimodal_tpu_torch.encoders.resnet import (
        ResNetConfig,
        ResNetTower,
    )
    from pixelrec_multimodal_tpu_torch.encoders.text_models import (
        TextEncoderConfig,
        TextTransformer,
    )
    from pixelrec_multimodal_tpu_torch.models.end_to_end import (
        EndToEndRecommender,
    )
    from pixelrec_multimodal_tpu_torch.models.multimodal import (
        MultimodalRecommender,
    )
    gen = torch.Generator().manual_seed(seed)
    scorer = MultimodalRecommender(
        64, 256, 8, 0, embedding_dim=16, vision_feature_dim=32,
        language_feature_dim=16, use_contrastive=False,
        fusion_hidden_dims=(32, 16), use_batch_norm=True, dropout_rate=0.0,
        generator=gen, device='cpu')
    vision = random_init_(ResNetTower(ResNetConfig(8, (16, 32), (2, 2))),
                          seed)
    text = random_init_(TextTransformer(TextEncoderConfig(
        1000, 16, 1, 2, 32, 16)), seed)
    with torch.no_grad():
        for name, p in vision.named_parameters():
            if name.endswith('running_var'):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            elif name.endswith('running_mean'):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return EndToEndRecommender(scorer, vision_encoder=vision,
                               language_encoder=text, remat_encoders=remat)


def e2e_tiny_batch(seed: int = SEED) -> dict:
    """E2E_CHECK_BATCH rows of the tiny model's inputs, numpy, from
    ``seed``; row 1's tokens padded after 5."""
    rng = np.random.default_rng(seed)
    b = E2E_CHECK_BATCH
    mask = np.ones((b, 8), np.int64)
    mask[1, 5:] = 0
    return {'user_idx': rng.integers(0, 64, b), 'item_idx':
            rng.integers(0, 256, b), 'tag_idx': rng.integers(0, 8, b),
            'label': rng.integers(0, 2, b).astype(np.float32),
            'weight': np.ones(b, np.float32),
            'image': rng.standard_normal(
                (b, 3, E2E_CHECK_PX, E2E_CHECK_PX)).astype(np.float32),
            'text_input_ids': rng.integers(1, 1000, (b, 8)) * mask,
            'text_attention_mask': mask}


def e2e_card_vs_cpu(dev) -> dict:
    """The tiny end-to-end model (``e2e_tiny_model``), unfrozen, one step
    on ``e2e_tiny_batch`` on the CPU and on the card from the same
    weights, TF32 off: with SGD and with AdamW, and on the card with SGD
    under remat beside it. Returns each run's loss and how far the
    parameters lie apart; raises unless the losses hold TRAIN_TOL, the
    parameters their gate (SGD TRAIN_TOL; AdamW the share rule above
    E2E_ADAM_MAX_SHARE), the CPU's step moves more entries past TRAIN_TOL
    than the gate lets through, and remat holds TRAIN_TOL of no remat."""
    from pixelrec_multimodal_tpu_torch.encoders.common import no_tf32
    from pixelrec_multimodal_tpu_torch.training import build_optimizer
    from pixelrec_multimodal_tpu_torch.training.e2e_steps import (
        init_e2e_train_state,
        make_e2e_step_fns,
    )
    batch = e2e_tiny_batch()

    def weights(model):
        return {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()
                if not k.endswith('num_batches_tracked')}

    def one_step(kind, device, remat=False):
        model = e2e_tiny_model(remat).to(device)
        before = weights(model)
        state = init_e2e_train_state(model, build_optimizer(
            kind, TRAIN_LR, TRAIN_WD, gradient_clip=TRAIN_CLIP))
        step = make_e2e_step_fns(model, {})[0]
        _, m = step(state, batch, torch.Generator(device=device))
        return float(m['total_loss']), before, weights(model)

    def apart(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    def held(kind, before, cpu, card):
        adam = kind == 'adamw'
        past = moved = total = 0
        worst = excused = 0.0
        for k, ref in cpu.items():
            d = (card[k] - ref).abs()
            if adam and k in E2E_ZERO_GRADIENT:
                excused = max(excused, float(d.max()))
                continue
            past += int((d > TRAIN_TOL).sum())
            moved += int(((ref - before[k]).abs() > TRAIN_TOL).sum())
            total += d.numel()
            worst = max(worst, float(d.max()))
        allowed = int(E2E_ADAM_MAX_SHARE * total) if adam else 0
        tol = TRAIN_LR if adam else TRAIN_TOL
        return {'param_max_abs_diff': worst, 'param_tol': tol,
                'entries': total, 'past_tol': past,
                'allowed_past_tol': allowed, 'moved_past_tol_cpu': moved,
                'zero_gradient_max_abs_diff': excused if adam else None,
                'ok': (past <= allowed and worst <= tol
                       and excused <= 2.1 * TRAIN_LR and moved > allowed)}

    out = {}
    with no_tf32():
        for kind in ('sgd', 'adamw'):
            cpu_loss, before, cpu = one_step(kind, 'cpu')
            card_loss, _, card = one_step(kind, dev)
            out[kind] = {'loss_cpu': cpu_loss, 'loss_card': card_loss,
                         'loss_abs_diff': abs(card_loss - cpu_loss),
                         **held(kind, before, cpu, card)}
            if not (np.isfinite(card_loss) and out[kind]['ok']
                    and out[kind]['loss_abs_diff'] <= TRAIN_TOL):
                raise AssertionError(f'e2e: the card and the CPU disagree '
                                     f'({kind}): {out[kind]}')
        remat_loss, _, remat = one_step('sgd', dev, remat=True)
        plain_loss, _, plain = one_step('sgd', dev)
    out['remat'] = {'loss_abs_diff': abs(remat_loss - plain_loss),
                    'param_max_abs_diff': apart(remat, plain),
                    'tol': TRAIN_TOL}
    if not (out['remat']['loss_abs_diff'] <= TRAIN_TOL
            and out['remat']['param_max_abs_diff'] <= TRAIN_TOL):
        raise AssertionError(f'e2e: remat changes the step: {out["remat"]}')
    return out


def augment_card_vs_cpu(dev, shape, seed: int = SEED) -> dict:
    """``augment_batch`` with every op on (noise too) over seeded images
    of ``shape`` on the card, its draws made on the card, against the same
    images and draws on the CPU: the largest difference over the image
    scale (max |image|), ``ok`` within E2E_AUG_TOL, and the card's ms a
    batch (CUDA events, after a warm-up)."""
    from pixelrec_multimodal_tpu_torch.config import ImageAugmentationConfig
    from pixelrec_multimodal_tpu_torch.ops.augment import (
        augment_batch,
        augment_draws,
    )
    cfg = ImageAugmentationConfig(enabled=True, gaussian_noise=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev)
    draws = augment_draws(gen, shape, cfg)
    card = augment_batch(None, x, cfg, draws).cpu()
    ms = cuda_ms(lambda: augment_batch(None, x, cfg, draws), 5)
    ref = augment_batch(None, x.cpu(), cfg, {
        op: {k: v.cpu() for k, v in d.items()} for op, d in draws.items()})
    scale = float(x.abs().max())
    err = float((card - ref).abs().max())
    return {'shape': list(shape), 'ops': sorted(draws), 'ms': ms,
            'max_abs_err': err, 'image_scale': scale,
            'max_scaled_err': err / scale, 'tol': E2E_AUG_TOL,
            'ok': bool(torch.isfinite(card).all()) and err <= E2E_AUG_TOL
            * scale}


def e2e_batch(gen, dev, clip: bool = False) -> dict:
    """One E2E_BATCH batch on the card from ``gen``, as the JAX bench's:
    normal pixels at 224 px, token ids in [1, 30000) with full masks,
    random labels; ``clip`` adds CLIP text ids at E2E_CLIP_TEXT_LEN, each
    row closed by the EOT id (the highest)."""
    from pixelrec_multimodal_tpu_torch.encoders.clip import CLIPTextConfig
    b = E2E_BATCH

    def ints(high, size):
        return torch.randint(0, high, size, generator=gen, device=dev)
    batch = {'user_idx': ints(TRAIN_USERS, (b,)),
             'item_idx': ints(N_ITEMS, (b,)), 'tag_idx': ints(N_TAGS, (b,)),
             'label': ints(2, (b,)).float(),
             'weight': torch.ones(b, device=dev),
             'image': torch.randn((b, 3, 224, 224), generator=gen,
                                  device=dev),
             'text_input_ids': 1 + ints(29999, (b, E2E_TEXT_LEN)),
             'text_attention_mask': torch.ones((b, E2E_TEXT_LEN),
                                               dtype=torch.int64,
                                               device=dev)}
    if clip:
        eot = CLIPTextConfig().vocab_size - 1
        ids = 1 + ints(eot - 1, (b, E2E_CLIP_TEXT_LEN))
        ids[:, -1] = eot
        batch['clip_text_input_ids'] = ids
        batch['clip_text_attention_mask'] = torch.ones_like(ids)
    return batch


def e2e_steps(model, tx, batch, steps: int,
              flops_per_sample: Optional[float], peak: float,
              augmentation=None) -> dict:
    """A warm-up step, then ``steps`` timed ones (a synchronize at each
    end, ``utils/profiling.ThroughputMeter``), dropout and augmentation
    drawn from a card generator seeded per step; ms a step, samples/s,
    the utilization at ``flops_per_sample`` (None: not counted) against
    ``peak``, the peak
    bytes of the timed steps (``device_memory_stats``), the losses."""
    from pixelrec_multimodal_tpu_torch.training.e2e_steps import (
        init_e2e_train_state,
        make_e2e_step_fns,
    )
    from pixelrec_multimodal_tpu_torch.utils.profiling import (
        ThroughputMeter,
        device_memory_stats,
    )
    dev = model.device
    state = init_e2e_train_state(model, tx)
    step = make_e2e_step_fns(model, {},
                             augmentation_config=augmentation)[0]
    gen = torch.Generator(device=dev)
    t0 = time.time()
    state, m = step(state, batch, gen.manual_seed(SEED))
    warm = [float(m['total_loss'])]
    first_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    meter = ThroughputMeter(unit='samples', peak_flops=peak,
                            flops_per_unit=flops_per_sample)
    metrics = []
    for s in range(steps):
        with meter.measure(E2E_BATCH):
            state, m = step(state, batch, gen.manual_seed(SEED + 1 + s))
        metrics.append(m)
    mem = device_memory_stats()[f'cuda:{torch.cuda.current_device()}']
    losses = [float(m['total_loss']) for m in metrics]
    return {'steps': steps, 'batch': E2E_BATCH,
            'first_step_seconds': first_s, 'warm_up_loss': warm[0],
            'ms_per_step': meter.total_seconds / steps * 1e3,
            'samples_per_sec': meter.rate,
            'flops_per_sample': flops_per_sample,
            'utilization_vs_measured_bf16_peak': meter.utilization(),
            'peak_bytes': mem['peak_bytes_in_use'],
            'losses': losses,
            'contrastive_losses': [float(m['contrastive_loss'])
                                   for m in metrics],
            'finite': bool(np.isfinite(warm + losses).all())}


# Kinds of the kernels of a traced step, by the first pattern their
# lowercased name holds: cuDNN's layout transposes first, then GEMMs and
# convolutions (cuBLAS's Hopper GEMMs are `nvjet_*`), reductions, copies
# and casts, other elementwise ops.
KERNEL_KINDS = (('layout', ('nchwtonhwc', 'nhwctonchw')),
                ('matrix', ('gemm', 'conv', 'xmma', 'cutlass', 'wgrad',
                            'dgrad', 'fprop', 'implicit', 'sm90', 'nvjet')),
                ('reduction', ('reduce',)),
                ('copy_cast', ('copy',)),
                ('elementwise', ('elementwise',)))


def kernel_kind(name: str) -> str:
    name = name.lower()
    return next((kind for kind, marks in KERNEL_KINDS
                 if any(m in name for m in marks)), 'other')


def e2e_trace(model, tx, batch, top: int = 12) -> dict:
    """One train step of ``model`` (after a warm-up step) under
    ``utils/profiling.trace``: the card's time by kernel from
    ``key_averages()`` (self device time of the CUDA events that are not
    annotations), the ``top`` largest kernels and their shares of it, the
    shares of each kind (``KERNEL_KINDS``), the card's busy share of the
    step's wall time (synchronized at each end; the profiler's overhead
    in it) and the Chrome trace's size."""
    from pixelrec_multimodal_tpu_torch.training.e2e_steps import (
        init_e2e_train_state,
        make_e2e_step_fns,
    )
    from pixelrec_multimodal_tpu_torch.utils.profiling import (
        TRACE_FILE,
        step_annotation,
        trace,
    )
    state = init_e2e_train_state(model, tx)
    step = make_e2e_step_fns(model, {})[0]
    gen = torch.Generator(device=model.device)
    step(state, batch, gen.manual_seed(SEED))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with trace(d) as prof:
            t0 = time.perf_counter()
            with step_annotation('e2e_train_step'):
                step(state, batch, gen.manual_seed(SEED + 1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace_bytes = (Path(d) / TRACE_FILE).stat().st_size

    def device_us(e):
        return e.self_device_time_total
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith('CUDA')
                      and not e.is_user_annotation and device_us(e) > 0),
                     key=device_us, reverse=True)
    total = sum(device_us(e) for e in kernels)
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS + (('other', ()),)}
    for e in kernels:
        kinds[kernel_kind(e.key)] += device_us(e)
    return {'remat': model.remat_encoders, 'batch': E2E_BATCH,
            'step_wall_ms': wall * 1e3, 'device_ms': total / 1e3,
            'device_busy_share': total / 1e3 / (wall * 1e3),
            'kernel_names': len(kernels),
            'kernel_launches': sum(e.count for e in kernels),
            'kind_ms': {k: v / 1e3 for k, v in kinds.items()},
            'kind_share': {k: v / total if total else None
                           for k, v in kinds.items()},
            'top': [{'kernel': e.key[:120], 'kind': kernel_kind(e.key),
                     'launches': e.count, 'ms': device_us(e) / 1e3,
                     'share': device_us(e) / total} for e in kernels[:top]],
            'trace_bytes': trace_bytes}


def e2e_phase(smi, dev) -> dict:
    """The unfrozen path on the card (constants above E2E_BATCH). 1. The
    card against the CPU (``e2e_card_vs_cpu``). 2. The augmentation card
    against CPU (``augment_card_vs_cpu``). 3. Full width: remat, no remat,
    one augmented step, frozen towers (bit for bit unchanged). 4. The
    fine-tuned towers make the catalog's tables in eval mode, batch by
    batch from seeded frames and tokens made on the card; the scorer
    subtree serves E2E_SERVE_USERS users through K1, against plain bf16;
    the model's own forward on E2E_PAIRS pairs against the scorer's. 5.
    CLIP ViT-B/32 with contrastive learning. After the remat run, a
    tower weight, a ResNet convolution and a ResNet statistic must have
    moved, and one remat step is traced (``e2e_trace``). Returns K1's
    launches."""
    from pixelrec_multimodal_tpu_torch.config import (
        ImageAugmentationConfig,
        ModelConfig,
    )
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.models.end_to_end import (
        build_end_to_end_model,
        trainable_mask,
    )
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
    from pixelrec_multimodal_tpu_torch.training import (
        build_optimizer,
        with_frozen,
    )

    t_phase = time.time()
    # ---- 1. the card against the CPU at a small geometry
    t0 = time.time()
    check = e2e_card_vs_cpu(dev)
    emit('e2e_card_vs_cpu', **check, seconds=time.time() - t0,
         nvidia_smi=smi)

    # ---- 2. the augmentation, card against CPU, at full size
    aug = augment_card_vs_cpu(dev, (E2E_BATCH, 3, 224, 224))
    emit('e2e_augment', **aug, nvidia_smi=smi)
    if not aug['ok']:
        raise AssertionError(f'e2e: the augmentation on the card disagrees '
                             f'with the CPU: {aug}')
    torch.cuda.empty_cache()

    # ---- 3. full width: remat, no remat, augmented, frozen
    peak = PEAKS.get('bf16') or tmx.measure_square()['matmul_bf16_ops_per_s']
    mc = ModelConfig(vision_model='resnet', language_model='sentence-bert',
                     embedding_dim=EMB, fusion_hidden_dims=list(HIDDEN),
                     use_contrastive=False, dropout_rate=TRAIN_DROPOUT)
    t0 = time.time()
    model = build_end_to_end_model(mc, TRAIN_USERS, N_ITEMS, N_TAGS, 0,
                                   encoder_dtype=torch.bfloat16,
                                   remat_encoders=True, seed=SEED, device=dev)
    build_s = time.time() - t0

    def adamw():
        return build_optimizer('adamw', E2E_LR, TRAIN_WD,
                               gradient_clip=TRAIN_CLIP)
    batch = e2e_batch(torch.Generator(device=dev).manual_seed(SEED + 40), dev)
    runs = {}

    def run(name, tx, steps, flops, **kw):
        runs[name] = e2e_steps(model, tx, batch, steps, flops, peak, **kw)
        emit(f'e2e_train_{name}', **runs[name], model_build_seconds=build_s,
             vision='resnet', language='sentence-bert',
             text_len=E2E_TEXT_LEN, encoder_dtype='bfloat16',
             remat=model.remat_encoders, measured_bf16_peak=peak,
             nvidia_smi=smi)
        if not runs[name]['finite']:
            raise AssertionError(f'e2e: a loss of {name} is not finite: '
                                 f'{runs[name]["losses"]}')
    sd = model.state_dict()
    watched = [next(k for k in sd if k.startswith('vision_encoder.')
                    and k.endswith('running_var')),
               next(k for k in sd if k.startswith('vision_encoder.')
                    and sd[k].dim() == 4),
               next(k for k in sd if k.startswith('language_encoder.')
                    and sd[k].dim() == 2 and '.layer_' in k)]
    watched = {k: sd[k].detach().clone() for k in watched}
    run('remat', adamw(), E2E_STEPS, 4 * E2E_FORWARD_FLOPS)
    sd = model.state_dict()
    moved = {k: float((sd[k] - v).abs().max()) for k, v in watched.items()}
    emit('e2e_unfrozen_moved', max_abs_change=moved)
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f'e2e: the unfrozen steps left a tower tensor '
                             f'or a ResNet statistic where it was: {moved}')
    del sd, watched
    trace = e2e_trace(model, adamw(), batch)
    emit('e2e_trace', **trace, nvidia_smi=smi)
    model.remat_encoders = False
    run('no_remat', adamw(), E2E_STEPS, 3 * E2E_FORWARD_FLOPS)
    model.remat_encoders = True
    run('augmented', adamw(), 1, 4 * E2E_FORWARD_FLOPS,
        augmentation=ImageAugmentationConfig(enabled=True,
                                             gaussian_noise=True))
    towers = {k: v.detach().clone() for k, v in model.state_dict().items()
              if not k.startswith('scorer.')}
    scorer_before = {k: v.detach().clone()
                     for k, v in model.scorer.state_dict().items()}
    run('frozen', with_frozen(adamw(), trainable_mask(model)), E2E_STEPS,
        E2E_FORWARD_FLOPS)
    unchanged = all(torch.equal(v, model.state_dict()[k])
                    for k, v in towers.items())
    scorer_moved = any(not torch.equal(v, model.scorer.state_dict()[k])
                       for k, v in scorer_before.items())
    emit('e2e_frozen_towers', towers_bit_for_bit_unchanged=unchanged,
         tower_tensors=len(towers), scorer_moved=scorer_moved,
         ms_per_step=runs['frozen']['ms_per_step'])
    if not (unchanged and scorer_moved):
        raise AssertionError(f'e2e: the frozen run moved a tower '
                             f'({not unchanged}) or left the scorer '
                             f'({not scorer_moved})')
    del towers, scorer_before
    del batch
    torch.cuda.empty_cache()

    # ---- 4. the fine-tuned towers make the catalog's tables; the scorer
    # subtree serves them through K1
    model.eval()
    n_batches = N_ITEMS // E2E_BATCH

    def catalog_inputs(b):
        gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + b)
        ids = 1 + torch.randint(0, 29999, (E2E_BATCH, E2E_TEXT_LEN),
                                generator=gen, device=dev)
        return (torch.randn((E2E_BATCH, 3, 224, 224), generator=gen,
                            device=dev), ids, torch.ones_like(ids))
    vision = torch.empty((N_ITEMS, VISION_DIM), device=dev)
    language = torch.empty((N_ITEMS, LANG_DIM), device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        for b in range(n_batches):
            frames, ids, mask = catalog_inputs(b)
            rows = slice(b * E2E_BATCH, (b + 1) * E2E_BATCH)
            vision[rows] = model.vision_encoder.pooled(frames).float()
            language[rows] = model.language_encoder.pooled(ids, mask).float()
    torch.cuda.synchronize()
    tables_s = time.time() - t0
    rng = np.random.default_rng(SEED + 41)
    store = ItemFeatureStore(N_ITEMS, np.arange(N_ITEMS).astype(str))
    store.tables['tag_idx'] = rng.integers(0, N_TAGS, N_ITEMS).astype(
        np.int32)
    store.tables['vision_emb'] = vision.cpu().numpy()
    store.tables['language_emb'] = language.cpu().numpy()
    del vision, language
    emit('e2e_tables', items=N_ITEMS, batch=E2E_BATCH, seconds=tables_s,
         items_per_sec=N_ITEMS / tables_s, encoder_dtype='bfloat16',
         finite=bool(np.isfinite(store.tables['vision_emb']).all()
                     and np.isfinite(store.tables['language_emb']).all()),
         nvidia_smi=smi)
    t0 = time.time()
    scorer = CatalogScorer(model.scorer, store, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    users = np.sort(rng.choice(TRAIN_USERS, E2E_SERVE_USERS,
                               replace=False)).astype(np.int32)
    v, i, launches, _ = drive_top_k(scorer, users, 'K1', 'e2e_main_path',
                                    setup_seconds=setup_s, nvidia_smi=smi)
    check_against_plain(scorer, pairwise_scores_plain, users, v, i,
                        'e2e_main_path_vs_plain')
    # the model's own eval forward on E2E_PAIRS pairs (the items of
    # E2E_PAIRS / E2E_BATCH catalog batches, made again) against the
    # scorer's float32 scores of the same pairs
    picked = np.sort(rng.choice(n_batches, E2E_PAIRS // E2E_BATCH,
                                replace=False))
    pair_users = rng.integers(0, TRAIN_USERS, E2E_PAIRS).astype(np.int32)
    pair_items = np.concatenate([np.arange(b * E2E_BATCH,
                                           (b + 1) * E2E_BATCH)
                                 for b in picked]).astype(np.int32)
    own = []
    with torch.no_grad():
        for k, b in enumerate(picked):
            frames, ids, mask = catalog_inputs(int(b))
            rows = slice(k * E2E_BATCH, (k + 1) * E2E_BATCH)
            it = torch.from_numpy(pair_items[rows].astype(np.int64)).to(dev)
            own.append(model(
                torch.from_numpy(pair_users[rows].astype(np.int64)).to(dev),
                it, torch.from_numpy(store.tables['tag_idx'][
                    pair_items[rows]].astype(np.int64)).to(dev),
                image=frames, text_input_ids=ids,
                text_attention_mask=mask)[:, 0].float().cpu().numpy())
    own = np.concatenate(own)
    served = scorer.score_candidates(pair_users, pair_items[:, None])[:, 0]
    pair_err = float(np.abs(own - served).max())
    pair_tol = KERNEL_TOL * max(1.0, float(np.abs(served).max()))
    emit('e2e_model_vs_scorer', pairs=E2E_PAIRS, max_abs_err=pair_err,
         tol=pair_tol, finite=bool(np.isfinite(own).all()))
    if not (np.isfinite(own).all() and pair_err <= pair_tol):
        raise AssertionError(f'e2e: the model and its served scorer '
                             f'disagree: {pair_err} > {pair_tol}')
    del scorer, store, model
    torch.cuda.empty_cache()

    # ---- 5. contrastive: CLIP ViT-B/32, its text tower in the step
    mc.vision_model, mc.use_contrastive = 'clip', True
    model = build_end_to_end_model(mc, TRAIN_USERS, N_ITEMS, N_TAGS, 0,
                                   encoder_dtype=torch.bfloat16,
                                   remat_encoders=True, seed=SEED + 1,
                                   device=dev)
    temp0 = model.scorer.temperature.item()
    clip = e2e_steps(model, adamw(), e2e_batch(torch.Generator(
        device=dev).manual_seed(SEED + 42), dev, clip=True),
        E2E_CLIP_STEPS, None, peak)
    emit('e2e_train_contrastive', **clip, vision='clip',
         language='sentence-bert', clip_text_len=E2E_CLIP_TEXT_LEN,
         temperature_before=temp0,
         temperature_after=model.scorer.temperature.item(), nvidia_smi=smi)
    if not (clip['finite'] and all(np.isfinite(clip['contrastive_losses']))
            and min(clip['contrastive_losses']) > 0):
        raise AssertionError(f'e2e: the contrastive run is not finite or '
                             f'has no contrastive loss: {clip}')
    del model
    torch.cuda.empty_cache()
    emit('e2e', seconds=time.time() - t_phase, nvidia_smi=smi)
    return {'launches': launches}


def mesh_rank(job: Path, rank: int) -> int:
    """One rank of the mesh phase (``chip_smoke.py --mesh-rank JOB RANK``),
    on cuda:0 with the others. Rank 0 first serves the flagship through a
    1x1 mesh over an NCCL group of one; then all MESH_RANKS ranks join a
    gloo group and serve it at 2x2; then ranks 0 and 1 join another and
    serve it at 1x2, run the attention flagship's token-0 cascade, the
    generate, evaluate and precompute entry points (``--model_parallel 2``,
    ``--data_parallel 2``), and last try an NCCL group of two on the one
    card, whose refusal is recorded. Every call counts its launches; the
    results go to ``JOB/rank<r>.json`` and ``.npz``."""
    import torch.distributed as dist
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.parallel import make_mesh
    from pixelrec_multimodal_tpu_torch.scripts import evaluate as ev
    from pixelrec_multimodal_tpu_torch.scripts import (
        generate_recommendations as gr,
    )
    from pixelrec_multimodal_tpu_torch.scripts import precompute_cache

    spec = json.loads((job / 'job.json').read_text())
    dev = torch.device('cpu')
    if spec['device'] == 'cuda':
        dev = torch.device('cuda', 0)
        torch.cuda.set_device(dev)
    users = np.load(job / 'users.npy')
    out, arrays = {}, {}

    def join(name, backend, world):
        dist.init_process_group(backend, init_method=f'file://{job / name}',
                                rank=rank, world_size=world)

    def counted(name, fn, expected=None):
        """``fn()`` with every launch count set to 0 just before and read
        just after, and its host seconds."""
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        out[name] = {'seconds': time.time() - t0,
                     'launches': launch_counts()}
        if expected is not None and out[name]['launches'] != expected:
            raise AssertionError(f'{name} on rank {rank}: launches '
                                 f'{out[name]["launches"]} != {expected}')
        return result

    def expected(kernel, scorer, calls):
        blocks = len(list(scorer._user_blocks(len(users))))
        per_call = blocks * (scorer.n_local // scorer.item_chunk)
        return {k: calls * per_call if k == kernel else 0
                for k in launch_counts()}

    def serve(name, model, store, mesh):
        t0 = time.time()
        scorer = CatalogScorer(model, store, mesh=mesh, device=dev)
        torch.cuda.synchronize()
        setup = time.time() - t0
        scorer.top_k(users, TOP_K)  # warm-up
        times = []

        def calls():
            for _ in range(MESH_CALLS):
                t = time.time()
                v, i = scorer.top_k(users, TOP_K)
                times.append(time.time() - t)
            return v, i
        v, i = counted(name, calls, expected('K1', scorer, MESH_CALLS))
        out[name].update(
            call_seconds=times, setup_seconds=setup, shape=mesh.shape,
            backend=dist.get_backend(), n_local=scorer.n_local,
            block_rows=scorer.block_rows, traffic_bytes=dict(mesh.traffic))
        arrays[f'{name}_v'], arrays[f'{name}_i'] = v, i
        del scorer
        torch.cuda.empty_cache()

    model, store = build_flagship(device=dev)
    if rank == 0:
        join('nccl_1', 'nccl' if dev.type == 'cuda' else 'gloo', 1)
        serve('1x1_nccl', model, store, make_mesh(data_parallel=1,
                                                   model_parallel=1))
        dist.destroy_process_group()
    join('gloo_4', 'gloo', MESH_RANKS)
    serve('2x2_gloo', model, store, make_mesh(data_parallel=2,
                                              model_parallel=2))
    dist.destroy_process_group()
    if rank < 2:
        join('gloo_2', 'gloo', 2)
        mesh = make_mesh(data_parallel=1, model_parallel=2)
        serve('1x2_gloo', model, store, mesh)
        del model, store
        amodel, astore = build_flagship(device=dev, fusion_type='attention')
        s = CatalogScorer(amodel, astore, mesh=mesh, device=dev)
        s.top_k_cascade(users, TOP_K, screen='token0')  # warm-up
        v, i = counted('cascade_token0', lambda: s.top_k_cascade(
            users, TOP_K, screen='token0'), expected('K6', s, 1))
        arrays['cascade_token0_v'], arrays['cascade_token0_i'] = v, i
        del s, amodel, astore
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(sys.stderr):
            counted('generate', lambda: gr.main(spec['generate']))
            counted('evaluate', lambda: ev.main(spec['evaluate']))
            counted('precompute', lambda: precompute_cache.main(
                spec['precompute']))
        dist.destroy_process_group()
        if dev.type == 'cuda':
            out['nccl_two_ranks_one_card'] = nccl_two_ranks(join, dev)
    np.savez(job / f'rank{rank}.npz', **arrays)
    (job / f'rank{rank}.json').write_text(json.dumps(out))
    return 0


def nccl_two_ranks(join, dev) -> str:
    """Two ranks of one NCCL group on the one card: what NCCL answers."""
    import torch.distributed as dist
    join('nccl_2', 'nccl', 2)
    t = torch.ones(4, device=dev)
    try:
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        torch.cuda.synchronize()
        answer = 'accepted'
    except Exception as e:  # the refusal is the finding, not a fault
        answer = f'{type(e).__name__}: {e}'
    dist.destroy_process_group()
    return answer


def mesh_rank_command(job: Path, rank: int) -> list:
    return [sys.executable, str(Path(__file__).resolve()), '--mesh-rank',
            str(job), str(rank)]


def same_top_k(v, i, ref_v, ref_i) -> dict:
    """A meshed top-K against the single-process one: bit for bit (the
    values, and the ids as sets a row), else the overlap of the lists and
    the largest difference of a shared item's score."""
    rows = [(set(a.tolist()), dict(zip(b.tolist(), c.tolist())),
             dict(zip(a.tolist(), d.tolist())))
            for a, b, c, d in zip(i, ref_i, ref_v, v)]
    shared = [abs(got[x] - ref[x]) for ids, ref, got in rows
              for x in ids if x in ref]
    return {'bit_equal': bool(np.array_equal(v, ref_v) and all(
                ids == set(ref) for ids, ref, _ in rows)),
            'overlap': float(np.mean([len(ids & set(ref)) / len(ids)
                                      for ids, ref, _ in rows])),
            'shared_max_abs_diff': float(max(shared, default=0.0)),
            'scale': float(max(1.0, np.abs(ref_v).max()))}


def held_or_gated(what: str, check: dict):
    """Bit for bit, or the overlap and KERNEL_TOL that hold a main path
    against its plain version (``check_against_plain``)."""
    if check['bit_equal']:
        return
    if check['overlap'] < MIN_OVERLAP or check['shared_max_abs_diff'] > \
            KERNEL_TOL * check['scale']:
        raise AssertionError(f'{what}: the meshed lists disagree with the '
                             f'single-process ones: {check}')


def mesh_phase(smi, dev, ws: Path, pre_ws: Path, flagship: dict,
               cascade: dict) -> dict:
    """The meshed paths on the one card (``mesh_rank`` in MESH_RANKS
    spawned processes; any rank's failure fails the phase). The flagship's
    top-K through a 1x1 NCCL mesh and 2x2 and 1x2 gloo meshes against the
    concat main path's (``flagship``: users, v, i, median seconds): bit for
    bit, else by ``check_against_plain`` on a scorer rebuilt here; K1
    launched on every rank. The token-0 cascade at 1x2 against the
    single-process one (``cascade``: v, i), K6 launched on both ranks. The
    generate and evaluate entry points at 1x2 on the cli workspace ``ws``
    against the recommend and evaluate phases' reports, and the precompute
    entry point at 2x1 on the precompute workspace ``pre_ws`` against its
    single-process tables (the towers' card gate). Returns K1's and K6's
    launches over the ranks."""
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.utils import yaml_io

    t_phase = time.time()
    users = flagship['users']
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp)
        np.save(job / 'users.npy', users)
        cfg = str(ws / 'config.yaml')
        pre_cfg = yaml_io.load_file(pre_ws / 'config.yaml')
        pre_cfg['data']['cache_config']['cache_directory'] = str(
            pre_ws / 'cache_mesh')
        yaml_io.dump_file(pre_cfg, pre_ws / 'config_mesh.yaml')
        evaluate_args = ['--config', cfg, '--test_data',
                         str(ws / 'evaluate' / 'test.csv'), '--train_data',
                         yaml_io.load_file(ws / 'config.yaml')['data'][
                             'train_data_path'], '--full_catalog']
        device = ['--device', dev.type]
        (job / 'job.json').write_text(json.dumps({
            'device': dev.type,
            'generate': ['--config', cfg, '--sample_users',
                         str(RECOMMEND_USERS), '--output',
                         str(job / 'generate.json'), '--model_parallel',
                         '2', *device],
            'evaluate': evaluate_args + [
                '--output', str(job / 'evaluate.json'), '--save_predictions',
                str(job / 'evaluate_predictions.json'), '--model_parallel',
                '2', *device],
            'precompute': ['--config', str(pre_ws / 'config_mesh.yaml'),
                           '--data_parallel', '2', *device]}))
        procs = []
        try:
            for r in range(MESH_RANKS):
                with open(job / f'log{r}.txt', 'w') as rank_log:
                    procs.append(subprocess.Popen(
                        mesh_rank_command(job, r), stdout=rank_log,
                        stderr=subprocess.STDOUT))
            deadline = time.time() + MESH_TIMEOUT
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = {r: (job / f'log{r}.txt').read_text()[-4000:]
                for r in range(MESH_RANKS)}
        if any(p.returncode for p in procs):
            for r, text in logs.items():
                log(f'--- mesh rank {r} exited {procs[r].returncode}\n{text}')
            raise AssertionError(f'mesh: rank exit codes '
                                 f'{[p.returncode for p in procs]}')
        outs = [json.loads((job / f'rank{r}.json').read_text())
                for r in range(MESH_RANKS)]
        arrays = [dict(np.load(job / f'rank{r}.npz'))
                  for r in range(MESH_RANKS)]
        generated = json.loads((job / 'generate.json').read_text())
        evaluated = (json.loads((job / 'evaluate.json').read_text()),
                     json.loads((job / 'evaluate_predictions.json')
                                .read_text()))
        mesh_npz = pre_ws / 'cache_mesh' / \
            'vision_resnet_lang_sentence-bert' / 'feature_tables.npz'
        one_npz = pre_ws / 'cache' / 'vision_resnet_lang_sentence-bert' / \
            'feature_tables.npz'
        with np.load(mesh_npz) as a, np.load(one_npz) as b:
            tables = ({k: a[k] for k in a.files}, {k: b[k] for k in b.files})

    # ---- the flagship's top-K on each mesh
    k1 = k6 = 0
    for name, ranks in (('1x1_nccl', [0]), ('2x2_gloo', range(MESH_RANKS)),
                        ('1x2_gloo', [0, 1])):
        v, i = arrays[0][f'{name}_v'], arrays[0][f'{name}_i']
        for r in ranks:
            if not (np.array_equal(arrays[r][f'{name}_v'], v)
                    and np.array_equal(arrays[r][f'{name}_i'], i)):
                raise AssertionError(f'mesh {name}: rank {r} returned '
                                     'another top-K than rank 0')
        check = same_top_k(v, i, flagship['v'], flagship['i'])
        launches = {r: outs[r][name]['launches']['K1'] for r in ranks}
        k1 += sum(launches.values())
        median = statistics.median(outs[0][name]['call_seconds'])
        emit(f'mesh_top_k_{name}', shape=outs[0][name]['shape'],
             backend=outs[0][name]['backend'], ranks=len(ranks),
             users=len(users), items=N_ITEMS, k=TOP_K,
             seconds=outs[0][name]['call_seconds'], median_seconds=median,
             pairs_per_sec=len(users) * N_ITEMS / median,
             single_process_pairs_per_sec=len(users) * N_ITEMS
             / flagship['median'],
             note='the ranks take turns on one card: no scaling figure',
             setup_seconds=[outs[r][name]['setup_seconds'] for r in ranks],
             n_local=outs[0][name]['n_local'],
             block_rows=outs[0][name]['block_rows'],
             k1_launches_by_rank=launches,
             traffic_bytes_rank0=outs[0][name]['traffic_bytes'],
             vs_single_process_k1=check, nvidia_smi=smi)
        if not check['bit_equal']:
            model, store = build_flagship()
            from pixelrec_multimodal_tpu_torch.inference.scorer import (
                CatalogScorer,
            )
            check_against_plain(CatalogScorer(model, store), 
                                pairwise_scores_plain, users, v, i,
                                f'mesh_top_k_{name}_vs_plain')
            del model, store
            torch.cuda.empty_cache()

    # ---- the token-0 cascade at 1x2
    v, i = arrays[0]['cascade_token0_v'], arrays[0]['cascade_token0_i']
    if not (np.array_equal(arrays[1]['cascade_token0_v'], v)
            and np.array_equal(arrays[1]['cascade_token0_i'], i)):
        raise AssertionError('mesh cascade: the ranks disagree')
    check = same_top_k(v, i, cascade['v'], cascade['i'])
    launches = {r: outs[r]['cascade_token0']['launches'] for r in (0, 1)}
    k6 = sum(c['K6'] for c in launches.values())
    emit('mesh_cascade_token0', shape={'data': 1, 'model': 2},
         backend='gloo', users=len(users), items=N_ITEMS, k=TOP_K,
         seconds=outs[0]['cascade_token0']['seconds'],
         effective_pairs_per_sec=len(users) * N_ITEMS
         / outs[0]['cascade_token0']['seconds'],
         note='the ranks take turns on one card: no scaling figure',
         launches_by_rank=launches, vs_single_process=check,
         nvidia_smi=smi)
    held_or_gated('mesh cascade token0', check)
    if any(c['K6'] == 0 or c['K4'] for c in launches.values()):
        raise AssertionError(f'mesh cascade: launches {launches}')

    # ---- the generate and evaluate entry points at 1x2
    ref = json.loads((ws / 'recommend' / 'bf16.json').read_text())
    gen = [generated['recommendations'], ref['recommendations']]
    check = report_check(*gen)
    entry = {r: {n: outs[r][n]['launches']['K1']
                 for n in ('generate', 'evaluate')} for r in (0, 1)}
    k1 += sum(sum(e.values()) for e in entry.values())
    ev_ref = (json.loads((ws / 'evaluate' / 'full_catalog.json')
                         .read_text()),
              json.loads((ws / 'evaluate' / 'full_catalog_predictions.json')
                         .read_text()))
    ev_check = report_check(
        {u: [{'item_id': a, 'score': b} for a, b in x]
         for u, x in evaluated[1].items()},
        {u: [{'item_id': a, 'score': b} for a, b in x]
         for u, x in ev_ref[1].items()})
    metric_diff = max(abs(evaluated[0][k] - v) for k, v in ev_ref[0].items()
                      if isinstance(v, float))
    others_equal = all(evaluated[0][k] == v for k, v in ev_ref[0].items()
                       if not isinstance(v, float))
    emit('mesh_entry_points', shape={'data': 1, 'model': 2},
         backend='gloo', generate_seconds=[outs[r]['generate']['seconds']
                                           for r in (0, 1)],
         evaluate_seconds=[outs[r]['evaluate']['seconds'] for r in (0, 1)],
         k1_launches_by_rank=entry, generate_vs_recommend_phase=check,
         evaluate_vs_evaluate_phase=ev_check,
         metric_max_abs_diff=metric_diff, metric_tol=EVALUATE_TOL,
         other_results_equal=others_equal, nvidia_smi=smi)
    held_or_gated('mesh generate', check)
    held_or_gated('mesh evaluate', ev_check)
    if metric_diff > EVALUATE_TOL or not others_equal or any(
            e['generate'] == 0 or e['evaluate'] == 0
            for e in entry.values()):
        raise AssertionError(f'mesh evaluate: metrics {metric_diff}, '
                             f'launches {entry}')

    # ---- the precompute entry point at 2x1
    got, ref_tables = tables
    lang = held_to_tower_tol(got['language_emb'], ref_tables['language_emb'])
    same = {k: bool(np.array_equal(got[k], ref_tables[k]))
            for k in ref_tables if k != 'language_emb'}
    emit('mesh_precompute', shape={'data': 2, 'model': 1}, backend='gloo',
         items=PRECOMPUTE_ITEMS,
         seconds=[outs[r]['precompute']['seconds'] for r in (0, 1)],
         language_emb_vs_single_process=lang, other_tables_equal=same,
         nvidia_smi=smi)
    if sorted(got) != sorted(ref_tables) or not lang['ok'] \
            or not all(same.values()):
        raise AssertionError(f'mesh precompute: {lang}, {same}')
    emit('mesh_nccl_two_ranks_one_card',
         result=[outs[r].get('nccl_two_ranks_one_card') for r in (0, 1)])
    emit('mesh_phase', seconds=time.time() - t_phase, nvidia_smi=smi)
    return {'launches': k1, 'launches_k6': k6}


def report_check(got: dict, ref: dict) -> dict:
    """``same_top_k`` of two reports' lists (user -> [{item_id, score}]):
    the same users; -1-free id arrays by the item ids' order of first
    appearance."""
    if list(got) != list(ref):
        raise AssertionError('mesh: the reports hold other users')
    ids = {}
    def arr(rep):
        i = np.array([[ids.setdefault(e['item_id'], len(ids)) for e in x]
                      for x in rep.values()])
        v = np.array([[e['score'] for e in x] for x in rep.values()],
                     dtype=np.float64)
        return v, i
    (v, i), (rv, ri) = arr(got), arr(ref)
    return same_top_k(v, i, rv, ri)


MESH_TRAIN_ARGS = dict(lr=TRAIN_LR, weight_decay=TRAIN_WD,
                       patience=TRAINER_PATIENCE, gradient_clip=TRAIN_CLIP,
                       optimizer_type='adamw',
                       lr_scheduler_type='reduce_on_plateau',
                       batch_size=TRAIN_BATCH)


@contextlib.contextmanager
def full_precision_bf16_sums():
    """bf16 products with their split-K partial sums kept in float32
    (PyTorch's default lets cuBLAS reduce them in bf16, and its choice of
    split depends on the product's rows, so 16,384 rows of a 32,768-row
    batch may round otherwise than the whole batch does)."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def mesh_train_data():
    """The trainer phase's datasets cut to MESH_TRAIN_POS training
    positives a user, without their vision and language tables (set by
    ``mesh_train_tables``)."""
    items, train, val = trainer_tables(train_pos=MESH_TRAIN_POS)
    full, train_ds, val_ds, seconds = trainer_datasets(
        items, train, val, [f'num_{c}' for c in range(NUM_FEAT)])
    if len(train_ds) != MESH_TRAIN_BATCHES * TRAIN_BATCH:
        raise AssertionError('mesh_train: the datasets miss the geometry')
    return full, train_ds, val_ds, seconds


def mesh_train_tables(train_ds):
    """The trainer phase's random vision and language tables on the
    training dataset's store (the Trainer gathers from it)."""
    random_embedding_tables(train_ds.feature_store,
                            np.random.default_rng(SEED + 7))


def mesh_trainer_run(dev, train_ds, val_ds, mesh, ckpt_dir) -> dict:
    """On ``mesh`` (None: one process): the first step of the Trainer's
    step function from the train phase's weights on the epoch-0 shuffle's
    first global batch (this rank's rows), its loss and parameters; then
    the Trainer, MESH_TRAIN_EPOCHS epochs, from the same weights: the
    losses, the final state, seconds and samples/s a rank, the bytes this
    rank handed to each kind of collective. bf16 products sum in float32
    (``full_precision_bf16_sums``)."""
    with full_precision_bf16_sums():
        return _mesh_trainer_run(dev, train_ds, val_ds, mesh, ckpt_dir)


def _mesh_trainer_run(dev, train_ds, val_ds, mesh, ckpt_dir) -> tuple:
    from pixelrec_multimodal_tpu_torch.config import Config
    from pixelrec_multimodal_tpu_torch.parallel import batch_sharding
    from pixelrec_multimodal_tpu_torch.training import (
        Trainer,
        build_optimizer,
        init_train_state,
        make_step_fns,
    )
    model = train_model(dev)
    tables = train_ds.feature_store.device_tables(
        device=dev, pack=True, dtype=torch.bfloat16)
    step, _ = make_step_fns(model, tables, use_contrastive=False, mesh=mesh)
    first = {k: v[0] for k, v in train_ds.stacked_batches(
        TRAIN_BATCH, shuffle=True, seed=SEED).items()}
    if mesh is not None:
        rows = batch_sharding(mesh, TRAIN_BATCH)
        first = {k: v[rows] for k, v in first.items()}
    state = init_train_state(model, build_optimizer(
        'adamw', TRAIN_LR, TRAIN_WD, gradient_clip=TRAIN_CLIP))
    state, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in first.items()},
                    torch.Generator(device=dev).manual_seed(SEED + 5))
    first_loss = float(m['total_loss'])
    first_params = {k: p.detach().float().cpu().numpy()
                    for k, p in model.named_parameters()}
    del state, model, step
    cfg = Config()
    cfg.model.vision_model, cfg.model.language_model = 'resnet', \
        'sentence-bert'
    model = train_model(dev)
    trainer = Trainer(model, config=cfg, checkpoint_dir=str(ckpt_dir),
                      use_contrastive=False, seed=SEED, mesh=mesh)
    before = dict(mesh.traffic) if mesh is not None else {}
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        losses, val_losses = trainer.train(train_ds, val_ds,
                                           epochs=MESH_TRAIN_EPOCHS,
                                           **MESH_TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    train_s = [e['train'] for e in trainer.epoch_seconds]
    local_rows = TRAIN_BATCH // (mesh.shape['data'] if mesh else 1)
    out = {'first_loss': first_loss, 'losses': losses,
           'val_losses': val_losses, 'wall_seconds': wall,
           'epoch_seconds': trainer.epoch_seconds,
           'ms_per_step': [1e3 * t / MESH_TRAIN_BATCHES for t in train_s],
           'samples_per_sec_rank': [MESH_TRAIN_BATCHES * local_rows / t
                                    for t in train_s],
           'traffic_bytes': {k: v - before.get(k, 0) for k, v in
                             (mesh.traffic if mesh else {}).items()},
           'steps': int(trainer.state.step)}
    state = {k: v.detach().float().cpu().numpy()
             for k, v in model.state_dict().items()}
    del trainer, model
    torch.cuda.empty_cache()
    return out, first_params, state


def mesh_e2e_run(dev, mesh) -> tuple:
    """The unfrozen step at the e2e phase's geometry (ResNet-50 and
    MiniLM-L6 under remat, the flagship head, AdamW E2E_LR), its towers in
    float32 with TF32 off, as the e2e phase's card-against-CPU check: in
    bf16 each rank would round its partial weight gradients to bf16
    before they sum, which one process does not. On ``mesh`` (None: one
    process): MESH_E2E_STEPS steps on this rank's rows of the e2e phase's
    seeded global batch, dropout from a card generator seeded a step;
    (losses, seconds a step, the trainable parameters, the model's build
    seconds)."""
    from pixelrec_multimodal_tpu_torch.encoders.common import no_tf32
    with no_tf32():
        return _mesh_e2e_run(dev, mesh)


def _mesh_e2e_run(dev, mesh) -> tuple:
    from pixelrec_multimodal_tpu_torch.config import ModelConfig
    from pixelrec_multimodal_tpu_torch.models.end_to_end import (
        build_end_to_end_model,
    )
    from pixelrec_multimodal_tpu_torch.parallel import shard_batch
    from pixelrec_multimodal_tpu_torch.training import build_optimizer
    from pixelrec_multimodal_tpu_torch.training.e2e_steps import (
        init_e2e_train_state,
        make_e2e_step_fns,
    )
    mc = ModelConfig(vision_model='resnet', language_model='sentence-bert',
                     embedding_dim=EMB, fusion_hidden_dims=list(HIDDEN),
                     use_contrastive=False, dropout_rate=TRAIN_DROPOUT)
    t0 = time.time()
    model = build_end_to_end_model(mc, TRAIN_USERS, N_ITEMS, N_TAGS, 0,
                                   encoder_dtype=torch.float32,
                                   remat_encoders=True, seed=SEED, device=dev)
    build_s = time.time() - t0
    state = init_e2e_train_state(model, build_optimizer(
        'adamw', E2E_LR, TRAIN_WD, gradient_clip=TRAIN_CLIP))
    step = make_e2e_step_fns(model, {}, mesh=mesh)[0]
    batch = e2e_batch(torch.Generator(device=dev).manual_seed(SEED + 40), dev)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    gen = torch.Generator(device=dev)
    losses, seconds = [], []
    for s in range(MESH_E2E_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = step(state, batch, gen.manual_seed(SEED + 1 + s))
        losses.append(float(m['total_loss']))
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    trained = set(state.opt_state.names)
    params = {k: p.detach().cpu() for k, p in model.named_parameters()
              if k in trained}
    del state, model, step
    torch.cuda.empty_cache()
    return losses, seconds, params, build_s


def adam_gate(ref: dict, got: dict, tol: float, most: float) -> dict:
    """Parameters against a reference: the largest difference, the share
    of entries past TRAIN_TOL, and whether none passes ``tol`` and at most
    ``most`` of them pass TRAIN_TOL."""
    past = total = 0
    worst = 0.0
    for k, r in ref.items():
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(r, np.float64))
        past += int((d > TRAIN_TOL).sum())
        total += d.size
        worst = max(worst, float(d.max()))
    return {'max_abs_diff': worst, 'share_past_train_tol': past / total,
            'entries': total, 'tol': tol,
            'ok': worst <= tol and past <= most * total}


def mesh_train_rank(job: Path, rank: int) -> int:
    """One rank of the mesh_train phase (``chip_smoke.py
    --mesh-train-rank JOB RANK``), on cuda:0 with the others: rank 0 first
    trains on a 1x1 mesh over an NCCL group of one; all MESH_RANKS ranks
    then on a 2x2 gloo mesh; ranks 0 and 1 on a 2x1 gloo mesh, then run the
    train entry point at 2x1 (``--data_parallel 2``) and the unfrozen step
    at 2x1, rank 0 holding it against the one-process run in
    ``JOB/e2e_ref.pt``. Each rank loads its data, writes ``JOB/ready<r>``
    and waits for ``JOB/go``, which the parent writes once its one-process
    references are done: no timed stage of a rank shares the card with
    them. Results go to ``JOB/rank<r>.json`` and ``.npz``."""
    import pickle

    import torch.distributed as dist
    from pixelrec_multimodal_tpu_torch.parallel import make_mesh
    from pixelrec_multimodal_tpu_torch.scripts import train

    spec = json.loads((job / 'job.json').read_text())
    dev = torch.device('cpu')
    if spec['device'] == 'cuda':
        dev = torch.device('cuda', 0)
        torch.cuda.set_device(dev)
    t_rank = time.time()
    train_ds, val_ds = pickle.loads((job / 'datasets.pkl').read_bytes())
    mesh_train_tables(train_ds)
    out, arrays = {'stage_seconds': {'data': time.time() - t_rank}}, {}
    (job / f'ready{rank}').touch()
    if not wait_for_files([job / 'go']):
        raise TimeoutError('mesh_train: no go from the parent')
    out['stage_seconds']['waited_for_references'] = (
        time.time() - t_rank - out['stage_seconds']['data'])

    def join(name, backend, world):
        dist.init_process_group(backend, init_method=f'file://{job / name}',
                                rank=rank, world_size=world)

    def trainer(name, mesh):
        t0 = time.time()
        res, first, state = mesh_trainer_run(dev, train_ds, val_ds, mesh,
                                             job / f'ckpt_{name}')
        out['stage_seconds'][name] = time.time() - t0
        out[name] = dict(res, shape=mesh.shape, backend=dist.get_backend())
        if rank == 0:
            arrays.update({f'{name}/first/{k}': v for k, v in first.items()})
            arrays.update({f'{name}/state/{k}': v for k, v in state.items()})

    if rank == 0:
        join('nccl_1', 'nccl' if dev.type == 'cuda' else 'gloo', 1)
        trainer('1x1_nccl', make_mesh(data_parallel=1, model_parallel=1))
        dist.destroy_process_group()
    join('gloo_4', 'gloo', MESH_RANKS)
    trainer('2x2_gloo', make_mesh(data_parallel=2, model_parallel=2))
    dist.destroy_process_group()
    if rank < 2:
        join('gloo_2', 'gloo', 2)
        mesh = make_mesh(data_parallel=2, model_parallel=1)
        trainer('2x1_gloo', mesh)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            res = train.main(spec['train'])
        torch.cuda.synchronize()
        out['entry'] = {'seconds': time.time() - t0,
                        'launches': launch_counts(),
                        'train_losses': res['train_losses'],
                        'val_losses': res['val_losses'],
                        'epoch_seconds': res['epoch_seconds']}
        out['stage_seconds']['entry'] = out['entry']['seconds']
        before = dict(mesh.traffic)
        t0 = time.time()
        losses, seconds, params, build_s = mesh_e2e_run(dev, mesh)
        out['stage_seconds']['e2e'] = time.time() - t0
        out['e2e'] = {'losses': losses, 'seconds': seconds,
                      'build_seconds': build_s,
                      'traffic_bytes': {k: v - before.get(k, 0)
                                        for k, v in mesh.traffic.items()}}
        if rank == 0:
            ref = torch.load(job / 'e2e_ref.pt', weights_only=True)
            out['e2e']['vs_one_process'] = adam_gate(
                {k: v.float().numpy() for k, v in ref['params'].items()},
                {k: v.float().numpy() for k, v in params.items()},
                2 * E2E_LR * MESH_E2E_STEPS, E2E_ADAM_MAX_SHARE)
        dist.destroy_process_group()
    out['stage_seconds']['rank'] = time.time() - t_rank
    np.savez(job / f'rank{rank}.npz', **arrays)
    (job / f'rank{rank}.json').write_text(json.dumps(out))
    return 0


def wait_for_files(paths, procs=()) -> bool:
    """Wait up to MESH_TIMEOUT seconds until every file of ``paths``
    exists; False when the time runs out or a process of ``procs``
    exits first."""
    deadline = time.time() + MESH_TIMEOUT
    while not all(p.exists() for p in paths):
        if time.time() > deadline or any(p.poll() is not None
                                         for p in procs):
            return False
        time.sleep(0.1)
    return True


def mesh_train_rank_command(job: Path, rank: int) -> list:
    return [sys.executable, str(Path(__file__).resolve()),
            '--mesh-train-rank', str(job), str(rank)]


def mesh_train_phase(smi, dev, ws: Path) -> dict:
    """Training over the mesh on the one card (MESH_TRAIN_POS and the
    constants beside it; ``mesh_train_rank`` in MESH_RANKS spawned
    processes, any rank's failure fails the phase).
    ``dryrun_multichip(MESH_RANKS)`` runs first, in its own rank
    processes, while this phase builds its datasets and its ranks start
    and load their data (host work only, nothing timed). Once both are
    done the one-process references run here, alone on the card: the
    unfrozen steps, then the Trainer. Then the ranks run their stages
    (they take turns on the card with one another and with nothing
    else); after they exit, the meshed entry point's best checkpoint (the
    cli workspace ``ws``) is served through K1 by ``cli_serve``. Returns
    K1's launches."""
    from pixelrec_multimodal_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )

    t_phase = time.time()
    dry = {}

    def dryrun():
        t0 = time.time()
        try:
            dry['line'] = dryrun_multichip(MESH_RANKS, device=dev)
        except Exception as e:  # re-raised by the phase after the join
            dry['error'] = e
        dry['seconds'] = time.time() - t0
    dry_thread = threading.Thread(target=dryrun, name='mesh-train-dryrun')
    dry_thread.start()
    try:
        return _mesh_train_phase(smi, dev, ws, t_phase, dry, dry_thread)
    finally:
        dry_thread.join()


def _mesh_train_phase(smi, dev, ws, t_phase, dry, dry_thread) -> dict:
    import pickle

    from pixelrec_multimodal_tpu_torch.utils import yaml_io

    full, train_ds, val_ds, build_s = mesh_train_data()
    cfg = yaml_io.load_file(ws / 'config.yaml')
    cfg['training']['epochs'] = MESH_CLI_EPOCHS
    cfg['checkpoint_dir'] = str(ws / 'mesh_checkpoints')
    cfg['results_dir'] = str(ws / 'mesh_results')
    cfg_path = ws / 'config_mesh_train.yaml'
    yaml_io.dump_file(cfg, cfg_path)
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp)
        (job / 'datasets.pkl').write_bytes(pickle.dumps((train_ds, val_ds)))
        (job / 'job.json').write_text(json.dumps({
            'device': dev.type,
            'train': ['--config', str(cfg_path), '--data_parallel', '2',
                      '--device', dev.type]}))
        t0 = time.time()
        procs = []
        try:
            for r in range(MESH_RANKS):
                with open(job / f'log{r}.txt', 'w') as rank_log:
                    procs.append(subprocess.Popen(
                        mesh_train_rank_command(job, r), stdout=rank_log,
                        stderr=subprocess.STDOUT))
            ready = wait_for_files([job / f'ready{r}'
                                    for r in range(MESH_RANKS)], procs)
            ready_s = time.time() - t0
            dry_thread.join()
            if 'error' in dry:
                raise dry['error']
            if ready:
                t1 = time.time()
                e2e_losses, e2e_seconds, e2e_params, _ = mesh_e2e_run(
                    dev, None)
                torch.save({'params': e2e_params}, job / 'e2e_ref.pt')
                del e2e_params
                e2e_ref_s = time.time() - t1
                t1 = time.time()
                mesh_train_tables(train_ds)
                ref, ref_first, ref_state = mesh_trainer_run(
                    dev, train_ds, val_ds, None, job / 'ckpt_one')
                trainer_ref_s = time.time() - t1
                (job / 'go').touch()
                deadline = time.time() + MESH_TIMEOUT
                for p in procs:
                    p.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.time() - t0
        if not ready or any(p.returncode for p in procs):
            for r in range(MESH_RANKS):
                log(f'--- mesh_train rank {r} exited {procs[r].returncode}\n'
                    + (job / f'log{r}.txt').read_text()[-4000:])
            raise AssertionError(f'mesh_train: rank exit codes '
                                 f'{[p.returncode for p in procs]}')
        outs = [json.loads((job / f'rank{r}.json').read_text())
                for r in range(MESH_RANKS)]
        with np.load(job / 'rank0.npz') as z:
            arrays = {k: z[k] for k in z.files}

    failures = []

    # ---- the Trainer on each mesh against one process
    def part(name, what):
        pre = f'{name}/{what}/'
        return {k[len(pre):]: v for k, v in arrays.items()
                if k.startswith(pre)}
    for name, ranks in (('1x1_nccl', [0]), ('2x1_gloo', [0, 1]),
                        ('2x2_gloo', range(MESH_RANKS))):
        got = outs[0][name]
        for r in ranks:
            if outs[r][name]['losses'] != got['losses'] or \
                    outs[r][name]['val_losses'] != got['val_losses']:
                failures.append(f'{name}: rank {r} saw other losses than '
                                'rank 0')
        state = part(name, 'state')
        bit = got['losses'] == ref['losses'] and \
            got['val_losses'] == ref['val_losses'] and all(
                np.array_equal(state[k], v) for k, v in ref_state.items())
        first = adam_gate(ref_first, part(name, 'first'), 2 * TRAIN_LR, 1.0)
        steps = got['steps']
        whole = adam_gate(ref_state, state, 2 * TRAIN_LR * steps, 1.0)
        check = {
            'bit_for_bit': bit,
            'first_loss_diff': abs(got['first_loss'] - ref['first_loss']),
            'first_step_params': first,
            'last_val_loss_diff': abs(got['val_losses'][-1]
                                      - ref['val_losses'][-1]),
            'last_val_loss_bound': MESH_VAL_BOUND,
            'final_params': whole}
        emit(f'mesh_train_trainer_{name}', shape=got['shape'],
             backend=got['backend'], ranks=len(ranks),
             epochs=MESH_TRAIN_EPOCHS, batches_per_epoch=MESH_TRAIN_BATCHES,
             global_batch=TRAIN_BATCH, cut=f'{MESH_TRAIN_POS} training '
             f'positives a user of the trainer phase\'s {TRAINER_TRAIN_POS}',
             losses=got['losses'], val_losses=got['val_losses'],
             one_process_losses=ref['losses'],
             one_process_val_losses=ref['val_losses'],
             ms_per_step_by_rank={r: outs[r][name]['ms_per_step']
                                  for r in ranks},
             samples_per_sec_by_rank={r: outs[r][name]['samples_per_sec_rank']
                                      for r in ranks},
             one_process_ms_per_step=ref['ms_per_step'],
             traffic_bytes_rank0=got['traffic_bytes'],
             wall_seconds=got['wall_seconds'],
             note='the ranks take turns on one card: no scaling figure',
             vs_one_process=check, nvidia_smi=smi)
        if name == '1x1_nccl':
            ok = bit or whole['ok']
        else:
            ok = (check['first_loss_diff'] <= TRAIN_TOL and first['ok']
                  and check['last_val_loss_diff'] <= MESH_VAL_BOUND)
        if not (ok and np.isfinite(got['losses']).all()):
            failures.append(f'{name}: against one process {check}')

    # ---- the dry run on the card, beside the ranks' start-up
    emit('mesh_train_dryrun', line=dry['line'], seconds=dry['seconds'],
         note='ran while the phase built its datasets and its ranks '
         'started and loaded their data (host work)', nvidia_smi=smi)

    # ---- the train entry point at 2x1, served through K1
    entry = {r: outs[r]['entry'] for r in (0, 1)}
    if entry[0]['train_losses'] != entry[1]['train_losses'] or any(
            any(e['launches'].values()) for e in entry.values()):
        failures.append(f'entry point: the ranks disagree or launched '
                        f'serving kernels: {entry}')
    meta = json.loads((ws / 'mesh_results' / 'training_metadata.json')
                      .read_text())
    emit('mesh_train_entry_point', shape={'data': 2, 'model': 1},
         backend='gloo', epochs=MESH_CLI_EPOCHS,
         seconds=[entry[r]['seconds'] for r in (0, 1)],
         train_losses=entry[0]['train_losses'],
         val_losses=entry[0]['val_losses'],
         epoch_seconds_rank0=entry[0]['epoch_seconds'],
         launches_by_rank={r: entry[r]['launches'] for r in (0, 1)},
         device_info=meta['device_info'], nvidia_smi=smi)
    served = cli_serve(smi, dev, cfg_path, {'metadata': meta},
                       phase='mesh_train_cli')

    # ---- the unfrozen step at 2x1
    e2e = outs[0]['e2e']
    loss_diff = max(abs(a - b) for a, b in zip(e2e['losses'], e2e_losses))
    emit('mesh_train_e2e', shape={'data': 2, 'model': 1}, backend='gloo',
         steps=MESH_E2E_STEPS, global_batch=E2E_BATCH,
         encoder_dtype='float32', tf32=False, losses=e2e['losses'],
         one_process_losses=e2e_losses, loss_max_abs_diff=loss_diff,
         seconds_by_rank={r: outs[r]['e2e']['seconds'] for r in (0, 1)},
         one_process_seconds=e2e_seconds,
         one_process_run_seconds=e2e_ref_s,
         build_seconds_rank0=e2e['build_seconds'],
         traffic_bytes_rank0=e2e['traffic_bytes'],
         params_vs_one_process=e2e['vs_one_process'], nvidia_smi=smi)
    if not (loss_diff <= TRAIN_TOL and e2e['vs_one_process']['ok']
            and e2e['losses'] == outs[1]['e2e']['losses']):
        failures.append(f'e2e: against one process {loss_diff}, '
                        f'{e2e["vs_one_process"]}')

    emit('mesh_train_phase', seconds=time.time() - t_phase,
         datasets_seconds=build_s, ranks_ready_seconds=ready_s,
         e2e_reference_seconds=e2e_ref_s,
         trainer_reference_seconds=trainer_ref_s, ranks_seconds=ranks_s,
         stage_seconds_by_rank={r: outs[r]['stage_seconds']
                                for r in range(MESH_RANKS)},
         failures=failures, nvidia_smi=smi)
    if failures:
        raise AssertionError('mesh_train: ' + '; '.join(failures))
    return {'launches': served['launches']}


def main() -> int:
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA device (torch.cuda.is_available() is '
            'False); nothing was run')
        return 2
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.ops import _build
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        ACTIVATIONS,
        compute_user_first,
        pairwise_scores,
        pairwise_scores_gated,
        pairwise_scores_gated_factored,
        pairwise_scores_gated_factored_plain,
        pairwise_scores_gated_plain,
        pairwise_scores_plain,
    )

    t_start = time.time()
    clock = PhaseClock()
    dev = torch.device('cuda')
    # ---- 1. card
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device_name = torch.cuda.get_device_name(0)
    emit('card', nvidia_smi=smi, name=device_name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    clock.lap('card')
    # ---- 2. build every kernel and probe source, one nvcc each, in
    # parallel
    t0 = time.time()
    libs = _build.build(_build.all_sources() + _build.probe_sources())
    for lib in libs.values():
        log(lib.with_suffix('.log').read_text())
    build_seconds = round(time.time() - t0, 3)
    emit('build', seconds=build_seconds,
         libraries=[str(p.relative_to(_build.BUILD_DIR.parents[1]))
                    for p in libs.values()])

    clock.lap('build')
    # ---- 2b. the probes: P1-P3 against their plain versions, then the
    # card's rates, which every kernel's bound below divides by
    t0 = time.time()
    probe_errs = probe_checks(dev)
    probe_rate = probe_rates(smi)
    emit('probes', seconds=round(time.time() - t0, 3))

    clock.lap('probes')
    # ---- set-up of the concat main path (catalog tables built on the card)
    t0 = time.time()
    model, store = build_flagship()
    scorer = CatalogScorer(model, store)
    torch.cuda.synchronize()
    head = scorer._head
    h1 = head['b1'].shape[0]
    item_first = scorer._item_fast[0]
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    with torch.no_grad():
        user_first = compute_user_first(head, model.user_tower(
            torch.from_numpy(users.astype(np.int64)).to(dev)))
    emit('setup', seconds=round(time.time() - t0, 3),
         item_chunk=scorer.item_chunk, user_chunk=scorer.user_chunk,
         n_pad=scorer.n_pad, h1=h1)

    # ---- 3. K1 against its plain version
    t0 = time.time()
    gen = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        flag_err, flag_tol = kernel_error(
            pairwise_scores, pairwise_scores_plain, head,
            (user_first[:200],), (item_first[:8000],))
        emit('kernel_vs_plain', kernel='K1', widths='flagship', B=200,
             C=8000, max_abs_err=flag_err, tol=flag_tol)
        if not flag_err <= flag_tol:
            raise AssertionError(f'flagship kernel error {flag_err} > '
                                 f'{flag_tol}')
        worst = 0.0
        for widths in ((48, 32, 16), (128, 256), (64,)):
            for act in ACTIVATIONS:
                for final in ('sigmoid', 'tanh', 'none'):
                    h = random_head(widths, act, final, gen, dev)
                    uf = torch.randn(37, widths[0], generator=gen).to(dev)
                    itf = torch.randn(301, widths[0], generator=gen).to(dev)
                    err, tol = kernel_error(pairwise_scores,
                                            pairwise_scores_plain, h,
                                            (uf,), (itf,))
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f'kernel error {err} > {tol} at widths '
                            f'{widths}, {act}/{final}')
        emit('kernel_vs_plain', kernel='K1',
             widths='small, every activation x final',
             combos=3 * len(ACTIVATIONS) * 3, worst_err_over_tol=worst,
             seconds=round(time.time() - t0, 3))

    # ---- 4. the concat main path: top_k for 8,192 users over 65,536 items
    v, i, k1_launches, k1_median = drive_top_k(scorer, users, 'K1',
                                               'main_path')
    check_against_plain(scorer, pairwise_scores_plain, users, v, i,
                        'main_path_vs_plain')
    flagship_top_k = {'users': users, 'v': v, 'i': i, 'median': k1_median}

    # ---- 5. K1's time at one flagship-width call
    lines = [kernel_line(
        'pairwise_mlp', 'K1', 'pairwise_mlp.cu', 421, '_pairwise_kernel',
        head, h1, (user_first[:TIME_B].contiguous(), item_first[:TIME_C]),
        pairwise_scores, pairwise_scores_plain, k1_launches, flag_err,
        flag_tol, 'no single PyTorch call computes the fused assembly + '
        'Dense chain + one-column reduce')]

    # ---- 5b. the concat model in int8 (precision='int8!': K1q), K1q
    # against its plain version, its main path, its time; then the int8
    # flip point against K1
    # (the int8 phases draw from a generator of their own, so the later
    # phases draw what they drew before them)
    qgen = torch.Generator().manual_seed(SEED + 5)
    t0 = time.time()
    qscorer = CatalogScorer(model, store, precision='int8!')
    torch.cuda.synchronize()
    qhead = qscorer._head
    emit('setup_int8_concat', seconds=round(time.time() - t0, 3),
         precision=qscorer.precision,
         int8_widths=qhead['kernel']['widths'].tolist(),
         inv_a_off=[q['params'][2, :2].tolist() for q in qhead['qlayers']])
    k1q = {'K1q': (pairwise_scores, pairwise_scores_plain, False)}
    with torch.no_grad():
        k1q_flag = int8_kernel_checks(
            k1q, {'K1q': (qhead, (user_first[:200],), (item_first[:8000],))},
            qgen, dev)['K1q']
    k1q_launches = int8_main_path(qscorer, pairwise_scores_plain, users,
                                  'K1q', 'main_path_int8_concat', i,
                                  precision=qscorer.precision, nvidia_smi=smi)
    lines.append(kernel_line(
        'pairwise_mlp_int8', 'K1q', 'pairwise_mlp.cu', 441,
        '_pairwise_kernel (n_quant > 0)', qhead, h1,
        (user_first[:TIME_B].contiguous(), item_first[:TIME_C]),
        pairwise_scores, pairwise_scores_plain, k1q_launches, *k1q_flag,
        'n/a: torch._int_mm computes one int8 product, not the fused '
        'assembly + quantize + int8 chain + one-column reduce'))
    int8_flip_point(smi, qgen, dev)
    del scorer, qscorer, item_first, user_first
    torch.cuda.empty_cache()

    clock.lap('concat')
    # ---- 6. set-up of the gated main paths: bench_fusion.py's gated model
    # (the flagship with fusion_type='gated'), one scorer per variant.
    t0 = time.time()
    gmodel, gstore = build_flagship(fusion_type='gated')
    gated = {v: CatalogScorer(gmodel, gstore, gated_variant=v)
             for v in ('exact', 'factored')}
    torch.cuda.synchronize()
    ghead = gated['exact']._head
    emit('setup_gated', seconds=round(time.time() - t0, 3),
         n_item_mods=ghead['n_item_mods'], h1=ghead['h1'],
         item_first_shape=list(gated['exact']._item_fast[0].shape),
         factored_table_shape=list(gated['factored']._scan_tables[0].shape),
         factored_table_bytes=sum(t.numel() * t.element_size()
                                  for t in gated['factored']._scan_tables))
    # variant: (kernel id, wrapper, plain version, source name, the TPU
    # kernel's def line in pixelrec_multimodal_tpu/ops/pairwise_mlp.py)
    kernels = {'exact': ('K2', pairwise_scores_gated,
                         pairwise_scores_gated_plain, 'gated_pairwise_mlp',
                         453, '_gated_pairwise_kernel'),
               'factored': ('K3', pairwise_scores_gated_factored,
                            pairwise_scores_gated_factored_plain,
                            'gated_factored_mlp', 780,
                            '_gated_factored_kernel')}

    # ---- 7. K2 and K3 against their plain versions
    t0 = time.time()
    flag = {}
    with torch.no_grad():
        for variant, s in gated.items():
            kid, kernel, plain = kernels[variant][:3]
            side = s._fast_user_side(
                torch.from_numpy(users[:200].astype(np.int64)).to(dev))
            err, tol = kernel_error(kernel, plain, ghead, side,
                                    tuple(t[:8000] for t in s._scan_tables))
            flag[variant] = (err, tol)
            emit('kernel_vs_plain', kernel=kid, widths='flagship', B=200,
                 C=8000, max_abs_err=err, tol=tol)
            if not err <= tol:
                raise AssertionError(f'{kid} flagship error {err} > {tol}')
        worst = {'exact': 0.0, 'factored': 0.0}
        for widths in ((48, 32, 16), (128, 256), (64,)):
            for act in ACTIVATIONS:
                for final in ('sigmoid', 'tanh', 'none'):
                    h = random_head(widths, act, final, gen, dev,
                                    n_item_mods=5)
                    rows = dict(zip(('exact', 'factored'),
                                    random_gated_rows(h, 37, 301, gen, dev)))
                    for variant, (kid, kernel, plain, *_) in \
                            kernels.items():
                        r = rows[variant]
                        err, tol = kernel_error(kernel, plain, h, r[:2],
                                                r[2:])
                        worst[variant] = max(worst[variant], err / tol)
                        if not err <= tol:
                            raise AssertionError(
                                f'{kid} error {err} > {tol} at widths '
                                f'{widths}, {act}/{final}')
        for variant, (kid, *_) in kernels.items():
            emit('kernel_vs_plain', kernel=kid,
                 widths='small, every activation x final',
                 combos=3 * len(ACTIVATIONS) * 3,
                 worst_err_over_tol=worst[variant],
                 seconds=round(time.time() - t0, 3))

    # ---- 8. the gated main paths, one per variant, then their kernels'
    # times at the flagship block
    gated_items = {}
    for variant, s in gated.items():
        kid, kernel, plain, source, line, tpu = kernels[variant]
        v, i, launches, _ = drive_top_k(s, users, kid,
                                        f'main_path_gated_{variant}',
                                        gated_variant=s.gated_variant)
        gated_items[variant] = i
        check_against_plain(s, plain, users, v, i,
                            f'main_path_gated_{variant}_vs_plain',
                            f32=False)
        with torch.no_grad():
            side = s._fast_user_side(
                torch.from_numpy(users[:TIME_B].astype(np.int64)).to(dev))
        lines.append(kernel_line(
            source, kid, f'{source}.cu', line, tpu, ghead, ghead['h1'],
            tuple(side) + tuple(t[:TIME_C] for t in s._scan_tables),
            kernel, plain, launches, *flag[variant],
            'no single PyTorch call computes the fused gated assembly + '
            'Dense chain + one-column reduce'))

    # ---- 8b. the gated model in int8 (precision='int8!'), one scorer per
    # variant: K2q and K3q against their plain versions, their main paths
    # and their times
    t0 = time.time()
    qgated = {v: CatalogScorer(gmodel, gstore, gated_variant=v,
                               precision='int8!')
              for v in ('exact', 'factored')}
    torch.cuda.synchronize()
    emit('setup_int8_gated', seconds=round(time.time() - t0, 3),
         precision=qgated['exact'].precision,
         int8_widths=qgated['exact']._head['kernel']['widths'].tolist())
    qkernels = {'exact': ('K2q', pairwise_scores_gated,
                          pairwise_scores_gated_plain, 517),
                'factored': ('K3q', pairwise_scores_gated_factored,
                             pairwise_scores_gated_factored_plain, 829)}
    with torch.no_grad():
        flag_rows = {}
        for variant, s in qgated.items():
            side = s._fast_user_side(
                torch.from_numpy(users[:200].astype(np.int64)).to(dev))
            flag_rows[qkernels[variant][0]] = (
                s._head, side, tuple(t[:8000] for t in s._scan_tables))
        qflag = int8_kernel_checks(
            {kid: (kernel, plain, True)
             for kid, kernel, plain, _ in qkernels.values()},
            flag_rows, qgen, dev)
    for variant, s in qgated.items():
        kid, kernel, plain, line = qkernels[variant]
        source = kernels[variant][3]
        launches = int8_main_path(
            s, plain, users, kid, f'main_path_int8_gated_{variant}',
            gated_items[variant], gated_variant=s.gated_variant,
            precision=s.precision, nvidia_smi=smi)
        with torch.no_grad():
            side = s._fast_user_side(
                torch.from_numpy(users[:TIME_B].astype(np.int64)).to(dev))
        lines.append(kernel_line(
            f'{source}_int8', kid, f'{source}.cu', line,
            f'{kernels[variant][5]} (n_quant > 0)', s._head, s._head['h1'],
            tuple(side) + tuple(t[:TIME_C] for t in s._scan_tables),
            kernel, plain, launches, *qflag[kid],
            'n/a: torch._int_mm computes one int8 product, not the fused '
            'gated assembly + quantize + int8 chain + one-column reduce'))

    del gated, qgated, gmodel, gstore, ghead, side
    torch.cuda.empty_cache()

    clock.lap('gated')
    # ---- 9. set-up of the attention main paths: bench_fusion.py's
    # attention model (the flagship with fusion_type='attention', 4 heads),
    # one scorer per variant
    t0 = time.time()
    amodel, astore = build_flagship(fusion_type='attention')
    attn = {v: CatalogScorer(amodel, astore, attention_variant=v)
            for v in ('stream', 'gram')}
    torch.cuda.synchronize()
    ahead = attn['stream']._head
    emit('setup_attention', seconds=round(time.time() - t0, 3),
         d=ahead['d'], heads=ahead['H'], n_item_mods=ahead['n_item_mods'],
         h1=ahead['h1'], chain_widths=ahead['kernel']['widths'].tolist(),
         **{f'{v}_tables': [list(t.shape) for t in s._scan_tables]
            for v, s in attn.items()},
         **{f'{v}_bytes_per_item': sum(t[0].numel() * t.element_size()
                                       for t in s._scan_tables)
            for v, s in attn.items()},
         **{f'{v}_table_bytes': sum(t.numel() * t.element_size()
                                    for t in s._scan_tables)
            for v, s in attn.items()})
    # variant: (kernel id, wrapper, plain version, source name, the TPU
    # kernel's def line in pixelrec_multimodal_tpu/ops/attention_scorer.py)
    akernels = {
        'stream': ('K4', user_item_call(tas.attention_scores, 5),
                   user_item_call(tas.attention_scores_plain, 5),
                   'attention_mlp', 368, '_attention_kernel'),
        'gram': ('K5', user_item_call(tas.attention_scores_gram, 6),
                 user_item_call(tas.attention_scores_gram_plain, 6),
                 'attention_gram_mlp', 525, '_attention_gram_kernel')}

    # ---- 10. K4 and K5 against their plain versions
    t0 = time.time()
    aflag = {}
    with torch.no_grad():
        for variant, s in attn.items():
            kid, kernel, plain = akernels[variant][:3]
            side = s._fast_user_side(
                torch.from_numpy(users[:200].astype(np.int64)).to(dev))
            err, frac, scale = kernel_diff(
                kernel, plain, ahead, side,
                tuple(t[:8000] for t in s._scan_tables))
            tol = KERNEL_TOL * scale
            max_share = (MAX_DIFFERING_PER_LAYER
                         * ahead['kernel']['n_hidden'])
            aflag[variant] = (err, tol)
            emit('kernel_vs_plain', kernel=kid, widths='flagship', B=200,
                 C=8000, max_abs_err=err, tol=tol,
                 share_over_agree=frac, agree=AGREE * scale,
                 max_share=max_share, **block_of(kid, ahead))
            if not (err <= tol and frac <= max_share):
                raise AssertionError(f'{kid} flagship error {err} > {tol} '
                                     f'or share {frac} > {max_share}')
        worst = {'stream': 0.0, 'gram': 0.0}
        share = {'stream': 0.0, 'gram': 0.0}
        combos = 0
        for d, heads in ((32, 1), (32, 2), (32, 4), (64, 1), (64, 2),
                         (64, 4)):
            for n, (act, final) in enumerate(
                    (a, f) for a in ACTIVATIONS
                    for f in ('sigmoid', 'tanh', 'none')):
                widths = ((64, 32), (128, 256), (48,))[n % 3]
                h = random_attention_head(d, heads, widths, act, final, gen,
                                          dev)
                u, it = random_attention_rows(h, 37, 301, gen, dev, True)
                # w1 and the len(widths) - 1 hidden layers after it
                max_share = MAX_DIFFERING_PER_LAYER * len(widths)
                combos += 1
                for variant, (kid, kernel, plain, *_) in akernels.items():
                    nu = 5 if variant == 'stream' else 6
                    err, frac, scale = kernel_diff(kernel, plain, h, u[:nu],
                                                   it[:nu + 1])
                    worst[variant] = max(worst[variant],
                                         err / (FLIP_TOL * scale))
                    share[variant] = max(share[variant], frac / max_share)
                    if not (err <= FLIP_TOL * scale and frac <= max_share):
                        raise AssertionError(
                            f'{kid} error {err} (share {frac} over '
                            f'{AGREE * scale}) at d={d}, heads={heads}, '
                            f'widths {widths}, {act}/{final}')
        for variant, (kid, *_) in akernels.items():
            emit('kernel_vs_plain', kernel=kid,
                 widths='small: d 32, 64 x heads 1, 2, 4 x every '
                        'activation x final', combos=combos,
                 worst_err_over_flip_tol=worst[variant],
                 worst_share_over_max_share=share[variant],
                 max_share_per_hidden_layer=MAX_DIFFERING_PER_LAYER,
                 seconds=round(time.time() - t0, 3))

    # ---- 11. the attention main paths, one per variant, then their
    # kernels' times at the flagship block
    exact = {}
    for variant, s in attn.items():
        kid, kernel, plain, source, line, tpu = akernels[variant]
        v, i, launches, exact[variant] = drive_top_k(
            s, users, kid, f'main_path_attention_{variant}',
            attention_variant=s.attention_variant, nvidia_smi=smi)
        if variant == 'stream':
            exact_v, exact_i = v, i
        check_against_plain(s, plain, users, v, i,
                            f'main_path_attention_{variant}_vs_plain',
                            f32=False)
        with torch.no_grad():
            side = s._fast_user_side(
                torch.from_numpy(users[:TIME_B].astype(np.int64)).to(dev))
        lines.append(kernel_line(
            source, kid, f'{source}.cu', line, tpu, ahead, ahead['h1'],
            tuple(side) + tuple(t[:TIME_C] for t in s._scan_tables),
            kernel, plain, launches, *aflag[variant],
            'no single PyTorch call computes the fused attention assembly '
            '+ LayerNorm + Dense chain + one-column reduce',
            tpu_module='attention_scorer',
            function_of='K4' if kid == 'K5' else None))

    clock.lap('attention')
    # ---- 12. set-up of the attention cascade: scripts/bench_cascade.py's
    # geometry, the stream scorer's tables plus the screens' (the tail and
    # the additive item rows), built on first use
    stream = attn['stream']
    del attn, side, s
    torch.cuda.empty_cache()
    t0 = time.time()
    stream._ensure_screen('additive')
    torch.cuda.synchronize()
    tail, add = stream._screen_tail, stream._screen_add
    emit('setup_cascade', seconds=round(time.time() - t0, 3),
         tail_shape=list(tail.shape),
         tail_bytes=tail.numel() * tail.element_size(),
         additive_shape=list(add.shape),
         additive_bytes=add.numel() * add.element_size())
    k6, k6_plain = (screen_call(tac.attention_screen_scores),
                    screen_call(tac.attention_screen_scores_plain))
    it_k, it_vo = stream._item_fast[2], stream._item_fast[3]

    # ---- 13. K6 against its plain version: at the flagship on the
    # scorer's tables, then over the small widths (K4's tolerances)
    t0 = time.time()
    with torch.no_grad():
        side = stream._fast_user_side(
            torch.from_numpy(users[:200].astype(np.int64)).to(dev))
        err, frac, scale = kernel_diff(
            k6, k6_plain, ahead, side,
            (it_k[:8000], it_vo[:8000], tail[:8000]))
        k6_flag = (err, KERNEL_TOL * scale)
        max_share = MAX_DIFFERING_PER_LAYER * ahead['kernel']['n_hidden']
        emit('kernel_vs_plain', kernel='K6', widths='flagship', B=200,
             C=8000, max_abs_err=err, tol=k6_flag[1], share_over_agree=frac,
             agree=AGREE * scale, max_share=max_share)
        if not (err <= k6_flag[1] and frac <= max_share):
            raise AssertionError(f'K6 flagship error {err} > {k6_flag[1]} '
                                 f'or share {frac} > {max_share}')
        worst = share = 0.0
        combos = 0
        for d, heads in ((32, 1), (32, 2), (32, 4), (64, 1), (64, 2),
                         (64, 4)):
            for n, (act, final) in enumerate(
                    (a, f) for a in ACTIVATIONS
                    for f in ('sigmoid', 'tanh', 'none')):
                widths = ((64, 32), (128, 256), (48,))[n % 3]
                h = random_attention_head(d, heads, widths, act, final, gen,
                                          dev)
                u, it = random_attention_rows(h, 37, 301, gen, dev, False)
                max_share = MAX_DIFFERING_PER_LAYER * len(widths)
                combos += 1
                err, frac, scale = kernel_diff(
                    k6, k6_plain, h, u,
                    (it[2], it[3], tac.compute_screen_tail(h, it)))
                worst = max(worst, err / (FLIP_TOL * scale))
                share = max(share, frac / max_share)
                if not (err <= FLIP_TOL * scale and frac <= max_share):
                    raise AssertionError(
                        f'K6 error {err} (share {frac} over {AGREE * scale})'
                        f' at d={d}, heads={heads}, widths {widths}, '
                        f'{act}/{final}')
        emit('kernel_vs_plain', kernel='K6',
             widths='small: d 32, 64 x heads 1, 2, 4 x every activation x '
                    'final', combos=combos, worst_err_over_flip_tol=worst,
             worst_share_over_max_share=share,
             max_share_per_hidden_layer=MAX_DIFFERING_PER_LAYER,
             seconds=round(time.time() - t0, 3))

    # ---- 14. the screens alone: top_k(_screen=) for 8,192 users over the
    # catalog at the tiers' default C, one launch per item chunk, against
    # the plain bf16 screen on 64 users
    with torch.no_grad():
        side64 = stream._fast_user_side(
            torch.from_numpy(users[:64].astype(np.int64)).to(dev))
        uf64 = tac.compute_screen_additive_user(ahead, side64)
    plain_screen = {
        'token0': lambda c: tac.attention_screen_scores_plain(
            ahead, side64, (None, None, it_k[c], it_vo[c]), tail[c],
            torch.bfloat16),
        'additive': lambda c: pairwise_scores_plain(
            stream._screen_head, uf64, add[c], torch.bfloat16)}
    screen_launches = {}
    for screen, n_cand, kid in (('token0', 400, 'K6'),
                                ('additive', 1024, 'K1')):
        stream.top_k(users, n_cand, _screen=screen)  # warm-up
        reset_launches()
        times = []
        for _ in range(3):
            t0 = time.time()
            v, i = stream.top_k(users, n_cand, _screen=screen)
            times.append(time.time() - t0)
        counts = launch_counts()
        per_call = stream.n_pad // stream.item_chunk
        expected = {k: 3 * per_call if k == kid else 0 for k in counts}
        if counts != expected:
            raise AssertionError(f'screen_{screen}: kernel launches '
                                 f'{counts} != expected {expected}')
        if v.shape != (N_USERS, n_cand) or not np.isfinite(v).all() \
                or (i < 0).any() or (np.diff(v, axis=1) > 0).any():
            raise AssertionError(f'screen_{screen}: output malformed')
        with torch.no_grad():
            ref = torch.cat([plain_screen[screen](slice(c, c + 4096))
                             for c in range(0, N_ITEMS, 4096)], dim=1)
        overlap = topc_overlap(i[:64], torch.topk(ref, n_cand, 1)[1]
                               .cpu().numpy())
        median = statistics.median(times)
        screen_launches[kid] = counts[kid]
        emit(f'screen_{screen}', users=N_USERS, items=N_ITEMS, C=n_cand,
             seconds=times, median_seconds=median,
             pairs_per_sec=N_USERS * N_ITEMS / median, kernel_launches=counts,
             launches_per_call=counts[kid] // 3,
             topc_overlap_vs_plain_bf16=overlap, min_overlap=MIN_OVERLAP,
             nvidia_smi=smi)
        if overlap < MIN_OVERLAP:
            raise AssertionError(f'screen_{screen}: top-{n_cand} overlap '
                                 f'{overlap} < {MIN_OVERLAP}')
    del ref, side64, uf64

    # ---- 15. the cascade's main paths: top_k_cascade for 8,192 users,
    # k = 50, at the tier defaults: one warm-up, then three timed calls with
    # the launch counts set to 0 just before them; against the exact stream
    # scan of phase 11
    cascade_launches = {}
    for tier, kid, n_cand in (('token0', 'K6', 400), ('additive', 'K1', 1024),
                              ('funnel', 'K1', 400)):
        stream.top_k_cascade(users, TOP_K, screen=tier)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        times = []
        for _ in range(3):
            t0 = time.time()
            v, i = stream.top_k_cascade(users, TOP_K, screen=tier)
            times.append(time.time() - t0)
        counts = launch_counts()
        expected = {k: (3 * stream.n_pad // stream.item_chunk
                        if k == kid else 0) for k in counts}
        if counts != expected:
            raise AssertionError(f'main_path_cascade_{tier}: kernel launches'
                                 f' {counts} != expected {expected}')
        if v.shape != (N_USERS, TOP_K) or not np.isfinite(v).all() \
                or (i < 0).any() or (np.diff(v, axis=1) > 0).any():
            raise AssertionError(f'main_path_cascade_{tier}: output '
                                 f'malformed')
        cascade_launches[kid] = counts[kid]
        if tier == 'token0':
            token0_cascade = {'v': v, 'i': i}
        # the rescore alone, on as many candidates per user
        _, cands = stream.top_k(users, n_cand, _screen=(
            'additive' if tier == 'additive' else 'token0'))
        with torch.no_grad():
            emb = stream.model.user_tower(
                torch.from_numpy(users.astype(np.int64)).to(dev))
            ct = torch.from_numpy(cands.astype(np.int64)).to(dev)
            stream._attention_candidates(emb, ct)
            torch.cuda.synchronize()
            t0 = time.time()
            stream._attention_candidates(emb, ct)
            torch.cuda.synchronize()
            rescore_s = time.time() - t0
        del emb, ct
        recall = topc_overlap(exact_i, i)
        ex = [dict(zip(a.tolist(), b.tolist()))
              for a, b in zip(exact_i, exact_v)]
        both = np.array([(ex[b][x], y) for b in range(N_USERS)
                         for x, y in zip(i[b].tolist(), v[b].tolist())
                         if x in ex[b]]).reshape(-1, 2)
        score_err = float(np.abs(both[:, 0] - both[:, 1]).max(initial=0.0))
        tol = KERNEL_TOL * max(1.0, float(np.abs(both).max(initial=0.0)))
        median = statistics.median(times)
        emit(f'main_path_cascade_{tier}', users=N_USERS, items=N_ITEMS,
             k=TOP_K, n_candidates=n_cand,
             **({'funnel_c1': max(8 * n_cand, 4096)}
                if tier == 'funnel' else {}),
             seconds=times, median_seconds=median,
             effective_pairs_per_sec=N_USERS * N_ITEMS / median,
             exact_scan_pairs_per_sec=N_USERS * N_ITEMS / exact['stream'],
             rescore_seconds=rescore_s, rescore_share=rescore_s / median,
             kernel_launches=counts, recall_vs_exact_top50=recall,
             shared_items=len(both), shared_score_max_abs_diff=score_err,
             tol=tol, nvidia_smi=smi)
        if not score_err <= tol:
            raise AssertionError(f'main_path_cascade_{tier}: scores of '
                                 f'shared items differ by {score_err} > '
                                 f'{tol}')

    # ---- 16. auto_cascade on a sample of those users: its recalls, timed
    # plans and decision; then a plan installed with both gates open, and
    # top_k routed through it (by launch counts)
    t0 = time.time()
    plan = stream.auto_cascade(users[:1024], TOP_K, sample_users=128)
    report = stream.auto_cascade_report
    emit('auto_cascade', users=1024, sample_users=report['sample_users'],
         grid=report['grid'], recall=report['recall'],
         funnel_recall=None if report['funnel_recall'] is None else {
             f'{c1}/{c2}': r for (c1, c2), r in
             report['funnel_recall'].items()},
         plans=report['plans'], exact_seconds=report['exact_seconds'],
         decision=plan or 'exact scan', seconds=round(time.time() - t0, 3),
         nvidia_smi=smi)
    forced = stream.auto_cascade(users[:1024], TOP_K, sample_users=128,
                                 recall_target=0.0, min_speedup=0.0)
    routed = {}
    for route, kw in (('plan', {}), ('exact', {'_exact': True})):
        reset_launches()
        v, i = stream.top_k(users[:256], TOP_K, **kw)
        routed[route] = launch_counts()
    stream.disable_cascade()
    kid = 'K6' if forced['screen'] == 'token0' else 'K1'
    emit('auto_cascade_routing', plan=forced, users=256,
         launches_through_plan=routed['plan'],
         launches_exact=routed['exact'])
    if routed['plan']['K4'] or not routed['plan'][kid] \
            or routed['exact']['K4'] != stream.n_pad // stream.item_chunk:
        raise AssertionError(f'auto_cascade: top_k did not route through '
                             f'the plan: {routed}')

    # ---- 17. K6's time at the flagship block
    with torch.no_grad():
        side = stream._fast_user_side(
            torch.from_numpy(users[:TIME_B].astype(np.int64)).to(dev))
    lines.append(kernel_line(
        'attention_screen_mlp', 'K6', 'attention_screen_mlp.cu', 406,
        '_attention_screen_kernel', ahead, ahead['h1'],
        tuple(side) + (it_k[:TIME_C], it_vo[:TIME_C], tail[:TIME_C]),
        k6, k6_plain, cascade_launches['K6'], *k6_flag,
        'no single PyTorch call computes the token-0 attention assembly + '
        'LayerNorm + Dense chain + one-column reduce',
        tpu_module='attention_cascade'))
    lines[-1]['launches_screen_token0'] = screen_launches['K6']
    lines[0]['launches_additive_cascade'] = cascade_launches['K1']

    clock.lap('cascade')
    # ---- 17b. the chain alone of K1, K4, K6, K2, K3, K2q, K3q and K1q
    # (whole less the cut after the assembly): its time and rate
    chains = {c['kernel']: c for c in chain_phase(smi, dev)}
    for line in lines:
        if line['kernel'] in chains:
            c = chains[line['kernel']]
            line.update(chain_ms=c['chain_ms'],
                        chain_tflops=c['chain_tflops'])

    del stream, amodel, astore, it_k, it_vo, tail, add, side
    torch.cuda.empty_cache()

    clock.lap('chain')
    # ---- 18. the wide models that take smaller blocks, at WIDE_USERS users
    wide_main_paths(users[:WIDE_USERS], smi, dev)
    torch.cuda.empty_cache()

    clock.lap('wide')
    # ---- 19. the frozen train path at the training profile's geometry,
    # then against the CPU
    bare = train_phase(smi, dev)

    clock.lap('train')
    # ---- 20. the Trainer and the data path at that geometry: datasets,
    # epochs, checkpoints, a resume, then the best checkpoint served
    # through K1 and K1q
    trained = trainer_phase(smi, dev, bare['samples_per_sec'])

    clock.lap('trainer')
    # ---- 21. the command line at that geometry: split and train through
    # the entry points, then serve the best checkpoint through K1; then
    # recommend from it through the generate entry point (K1, MMR, K1q)
    # and run the checkpoint tools on the same workspace; then evaluate it
    # through the evaluate entry point (candidates, full catalog through
    # K1; int8 through K1q, ranking and the baselines)
    trainer_rate = statistics.median(
        e['trainer_samples_per_sec'] for e in trained['epochs'])
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as pre_tmp:
        cli = cli_phase(smi, dev, trainer_rate, workspace=Path(tmp))
        clock.lap('cli')
        recommended = recommend_phase(smi, dev, Path(tmp))
        clock.lap('recommend')
        evaluated = evaluate_phase(smi, dev, Path(tmp))
        clock.lap('evaluate')
        # ---- 21b. the encoder towers card against CPU, then the item
        # tables made on the card (the precompute entry point's
        # language_emb, ResNet-50's vision_emb) and the flagship head
        # served on them through K1
        precomputed = precompute_phase(smi, dev, workspace=Path(pre_tmp))
        clock.lap('precompute')
        # ---- 21c. the meshed paths in rank processes on the one card: the
        # flagship's top-K at 1x1 (NCCL), 2x2 and 1x2 (gloo), the token-0
        # cascade, the generate, evaluate and precompute entry points
        meshed = mesh_phase(smi, dev, Path(tmp), Path(pre_tmp),
                            flagship_top_k, token0_cascade)
        clock.lap('mesh')
        # ---- 21d. training over the mesh in rank processes on the one
        # card: the Trainer at 1x1 (NCCL), 2x1 and 2x2 (gloo) against one
        # process, the train entry point at 2x1 served through K1, the
        # unfrozen step at 2x1, the dry run
        mesh_trained = mesh_train_phase(smi, dev, Path(tmp))
        clock.lap('mesh_train')
        # ---- 22. hyperparameter search on the cli workspace: the subsets,
        # five trials through the search entry point, each trial's best
        # checkpoint served through K1, K2 or K4, and K1q, K2q in int8
        searched = hpo_phase(smi, dev, Path(tmp))
        clock.lap('hpo')
    # ---- 22b. raw files through the preprocess entry point (nvJPEG on the
    # card validates the images), then split, train and serve through K1
    preprocessed = preprocess_phase(smi, dev, trainer_rate)
    clock.lap('preprocess')
    # ---- 24. the unfrozen path: towers trained inside the step (card
    # against CPU, remat, the augmentation, frozen towers, contrastive
    # CLIP), the fine-tuned scorer served through K1
    e2e = e2e_phase(smi, dev)
    clock.lap('e2e')
    lines[0]['launches_e2e'] = e2e['launches']
    lines[0]['launches_cli'] = cli['launches']
    lines[0]['launches_preprocess'] = preprocessed['launches']
    lines[0]['launches_precompute'] = precomputed['launches']
    lines[0]['launches_recommend'] = recommended['launches']
    lines[0]['launches_evaluate'] = evaluated['launches']
    lines[0]['launches_mesh'] = meshed['launches']
    lines[0]['launches_mesh_train'] = mesh_trained['launches']
    next(line for line in lines
         if line['kernel'] == 'K6')['launches_mesh'] = meshed['launches_k6']
    k1q = next(line for line in lines if line['kernel'] == 'K1q')
    k1q['launches_recommend_int8'] = recommended['launches_int8']
    k1q['launches_evaluate_int8'] = evaluated['launches_int8']
    for line in lines:
        if line['kernel'] in searched['launches']:
            line['launches_hpo'] = searched['launches'][line['kernel']]
        if line['kernel'] in searched['launches_int8']:
            line['launches_hpo_int8'] = \
                searched['launches_int8'][line['kernel']]

    lines += probe_lines(probe_rate, probe_errs, dev)
    clock.lap('probe_lines')
    emit('phase_seconds', build_seconds=build_seconds,
         seconds=clock.seconds, seconds_total=round(time.time() - t_start, 3),
         limit_seconds=SCRIPT_LIMIT, target_seconds=SCRIPT_TARGET)
    print(json.dumps({'kernels': lines}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--mesh-rank']:
        sys.exit(mesh_rank(Path(sys.argv[2]), int(sys.argv[3])))
    if sys.argv[1:2] == ['--mesh-train-rank']:
        sys.exit(mesh_train_rank(Path(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
