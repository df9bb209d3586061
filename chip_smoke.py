#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. repro-lint (python -m repro_torch.analysis, run in process: stdlib
   only, about 2 s) over src/repro_torch with tests/ as its test suite:
   any finding fails the run; a "lint" JSON line gives the findings,
   rules and files.
1. Environment: versions, the card's name and power limit, TF32 off, and
   the CUDA kernels built with nvcc from csrc/ (build seconds printed);
   the bf16 attention and scan kernels' SASS must hold HGMMA (wgmma),
   and its softcap division (csrc/div_by.cuh) must equal IEEE division
   bit for bit for the configs' caps (csrc/tools/check_division.cu).
2. Every kernel against its plain PyTorch version on the card, at ragged,
   unaligned and main-path shapes (ssd_scan also below and across its
   bf16 chunk of 128: l = 32 at the federated SSM run's folded shape,
   l = 200), with the tolerances stated below (the
   compression kernels bit for bit, fed_agg in fp32 also bit for bit at
   the char-LSTM's and the speech CNN's widths), and timed (CUDA events; device time,
   and as the host issues the calls) beside its memory bound and a
   library yardstick where one PyTorch call computes the same function.
   The sharded wrappers run on two- and three-slot meshes of the one card
   (P = 6,603,710 pads by 1 on three) and must equal the unsharded
   kernels bit for bit (the norm within 1e-6); flash_attention is also
   timed at Zamba2's shape and at llama-3.2-vision-11b's (d 128, GQA
   32 / 8), where SDPA computes the same function, and
   ssd_scan at one prompt, with its bf16 passes' device times
   (torch.profiler) and workspace bytes.  ssd_scan also on grouped B/C
   (b, l, g, n) at Nemotron-H's widths (SSD_GROUPED: one launch, equal
   bit for bit to the call on per-head copies, timed against it at the
   hybrid train cell's shape), and models.moe.moe_layer at its widths
   (MOE_SHAPE: every routed pair of the held experts computed, y against
   an expert-by-expert fp32 sum; a "moe_layer" JSON line).
3. The main paths on the full-width FEMNIST CNN (3 rounds, 8 clients a
   round, 30 % stragglers) through run_experiment on "cuda", whose
   default there is the vectorized executor.  First the executor against
   the eager loop client by client (one local epoch, local SGD; with
   cuDNN off within EXEC_TOL); then one more dispatch of that warmed
   executor with torch.cuda.set_sync_debug_mode("warn") around each
   vmap(grad_and_value(...)) call: no synchronizing CUDA operation may
   occur inside one (repro-lint's TORCH001, held on the card), and the
   count over the whole step loop is printed ("executor_syncs").  Then
   FedLesScan on the eager loop, again with cuDNN off (the spread of two
   valid roundings, printed), and on the executor; then FedAvg with the FedAdam server optimizer, FedLesScan
   with int8 and with top-k@1 % compressed client updates, and FedLesScan
   and FedAvg+FedAdam with executor and merge on two-slot meshes of the
   card (fed_agg_sharded / fed_agg_apply_sharded once a merge).  Runs of
   one configuration must agree per round (cohorts, EUR, trace bytes),
   and in training loss and params within the spread that rounding alone
   caused in the measured runs (FL_LOSS_RTOL, FL_PARAM_REL_L2).  The
   launch counts are set to 0 just before each run and read just after
   (every run's ``adam`` launches must equal its optimizer steps times
   the tree's launches a step: a client's step on the eager loop, each
   mesh slot's slice a step on the executor, none with SGD);
   the compressed runs' traces must carry the codec's compression ratio
   in every merge.  Then one client's local training
   and one vectorized round under torch.profiler: device operations a
   step and the card's busy share.  Then the rest of the paper's
   experiment, each run in the same 3-round setting: the char-LSTM
   (P = 818,402; local SGD at lr 0.8) client by client (executor against
   eager loop, one round) and FedLesScan on the executor, the eager loop
   and the eager loop from initial params one ulp apart (the LSTM is
   chaotic at that rate: the spread its params are held beside); the
   speech CNN (P = 67,267) on executor and eager loop, and one forward
   of it with training-time dropout from a CUDA generator at rate 0.25
   (each block's dropped share within 4 sigma, kept values exactly
   h / 0.75, rate 0 equal to no dropout bit for bit; "speech_dropout");
   FEMNIST with the
   clients round-robin on three FaaS providers (every attempt of the
   trace on its client's); semi-async FedLesScan on the LSTM checkpointed
   every round against a run stopped after round 2 and resumed (the
   resumed trace the uninterrupted one's tail, byte for byte).  Each run
   launches fed_agg once a merge; fed_agg is then checked bit for bit
   and timed at every (K, P) those runs merged, and one executor round of
   each model is profiled.  Then the federated SSM run
   (run_federated_ssm): examples/federated_pretrain.py's experiment
   (FedLesScan, 12 clients, 4 a round, 25 % stragglers, 6 rounds, batch
   16, local Adam 1e-3) with its ModelDef over mamba2-130m at full width
   and depth (fp32 params, bf16 activations, vocab 50,280), on the
   card's default path, the vectorized executor (every Mamba block's scan
   in the ssd_scan kernel under its vmap rule: one launch a layer a step
   at the folded (64, 32, 24, 64, 128), B/C head-broadcast views; no
   remat under torch.func; fed_agg once a merge at P = 128,983,488), and
   again on the eager loop: the same trace and cohorts, params and losses
   held as the FEMNIST runs are.  Before the runs one executor step
   client by client against the eager loop's grads (fp32 within twice
   what regrouping the plain scan moves them by; bf16 within twice what
   computing in bf16 at all moves them by), every scan call of the step
   held against the plain scan on the same folded inputs; after them one
   executor round profiled and fed_agg held and timed at the bucket's
   (4, 128,983,488).  Then the example CLIs quickstart and
   straggler_study (--ratios 0.3 --rounds 4) as subprocesses on the card,
   each exiting 0, their tables printed.  Then serving: Gemma 2 (2B) at
   full width and depth (random weights from a seed) prefills 2 prompts
   of 5120 tokens through the flash_attention kernel and decodes 32
   greedy tokens (launch.serve.generate), with exactly one kernel launch
   a layer; each call is held against the kernel's plain version on the
   model's own activations (the bf16 kernel element by element within
   2^-7·|want| + (2^-8 + 2^-11)·Σp|v|/l, the bound that rounding p to
   bf16 implies).  Its prefill
   logits are held against the same model with attention in the kernel's
   plain version (within twice what rounding p to bf16 in the plain
   version alone moves them by), against the plain attention
   path (printed) and against the model computed in fp32; and the model
   in fp32, kernel against plain path, at full depth and at two layers,
   within 1e-3.  Then four decode steps under torch.profiler.  Then the
   SSM models at full width and depth (random weights from a seed):
   mamba2-130m prefills 4 prompts of 4096 tokens with one ssd_scan launch
   a layer (24), and zamba2-1.2b prefills 2 prompts of 4096 with 38
   ssd_scan launches and 6 flash_attention launches (its weight-tied
   shared attention block, each call checked as above); both decode 32
   greedy tokens.  Each is held against the same model with both kernels
   in their plain versions (bf16 within twice what regrouping the plain
   versions alone moves the logits by, fp32 within 1e-3), and in fp32 prefill
   of S tokens plus one decode step against prefill of S + 1 tokens
   (within 1e-3: the kernel's final state against the recurrence).
   Then the rest of the zoo (run_zoo), each model freed before the next:
   llama-3.2-vision-11b at full width and depth (fp32 params, 40
   flash_attention launches a prefill, 8 gated cross blocks with xgate
   set to 1.0, 1024 patch embeddings), llama4-maverick-400b-a17b at full
   width cut to 2 layers and arctic-480b cut to 1 (bf16 params; one
   group of 4096 tokens at capacity factor 1.25), each 2 prompts of 2048
   tokens and 32 greedy new tokens, held as the Gemma 2 run is (an MoE
   model's bf16 logits printed, not gated: a routing flip makes them
   jump past any regrouping spread); the VLM's
   cross path live in fp32, its fp32 prefill-then-decode continuation and
   its decode cache's ck/cv equal to init_cross_cache's; each MoE block
   on its own activations against a per-token oracle (MOE_ORACLE_*), and
   router_load against the oracle's count expert by expert, the
   dropped share printed.  Then sharded_decode_attention on a two-slot
   mesh of the card at the VLM's decode shape against
   reference_decode_attention (fp32, within 2e-5).
4. Training (models.make_train_step, the decoders' train step; the scan's
   forward in the ssd_scan kernel under autograd, its backward the plain
   version's): the scan's Function at both training shapes against
   the plain version (its y and final state within the bounds of phase
   2, the grads of x, a_dt and the head-broadcast B/C views' bases
   against autograd through the plain version, and the plain backward
   timed);
   flash_attention refusing autograd; musicgen-medium (48 layers, d 1536,
   4 codebooks) serving 2 prompts of 1024 frames through flash_attention
   (48 launches) and 8 greedy tokens, held as the Gemma 2 run is; then
   mamba2-130m at full width and depth (8 × 4096 tokens, train_4k's
   sequence with its global batch of 256 cut to 8; 20 Adam steps at lr
   3e-4, remat, efficient_ce, fp32 params and bf16 activations, the loss
   falling), zamba2-1.2b (2 × 4096, 3 steps) and musicgen-medium (2 ×
   1024, 3 steps), each with its launches counted (ssd_scan twice a remat'd
   Mamba layer a step) and a profiled step (busy share, the scan's forward
   and plain backward shares).  Before mamba2-130m's steps its first
   step's grads in bf16 and in fp32, and zamba2-1.2b's in bf16, are held
   leaf by leaf against the plain scan's (within twice what regrouping the
   plain scan's sums moves each leaf by), every scan call of the kernel
   path's step is held against the plain scan on the model's own
   activations, and every Mamba layer's scan-only params (A_log, dt_bias,
   conv_w's and in_proj's x/B/C/dt parts) must get non-zero grads on the
   kernel path.
5. The dry run against the card (run_dry_run): launch/dryrun.py's
   prediction of each run, made on fake tensors on the host's CPU after
   the FL phases and before the runs it predicts, at the run's exact
   config and shape on a one-card mesh, is printed and held against what
   the card measured: the three train runs above, gemma2-2b's prefill of
   phase 3 (one prefill alone on the kernel path, and one with attention
   in the kernel's plain version, the aten ops the fake run counts), and
   two new train runs at full width cut for one card,
   llama-3.2-vision-11b (fp32 params, 5 layers: one cross block;
   1 × 2048 tokens, 1024 stub patch embeddings) and
   llama4-maverick-400b-a17b (bf16 params, 2 layers: one dense, one MoE;
   top-1; the expert count the largest whose predicted peak stays under
   DRY_PEAK_BUDGET, chosen by the dry run before the card runs), 20 Adam
   steps each, losses finite and falling, no kernel launched but the
   optimizer's ``adam`` (attention under autograd runs its plain
   version).  Gates: the argument bytes
   equal the bytes of the state and batch the run holds; the measured
   step time is at least the prediction's compute_s; the predicted peak
   over torch.cuda.max_memory_allocated() lies in DRY_PEAK_RATIO (the
   fake run's Adam step is ``adam_plain``, whose passes run in slices so
   that, as the kernel's, they hold little beside the new params and
   moments); in a run that launches no kernel but ``adam`` (elementwise:
   FlopCounterMode counts none of its work, on the card or in its plain
   version), the predicted FLOPs equal FlopCounterMode's over one extra
   untimed step on the card within DRY_FLOP_RTOL.  Where a step launches
   ssd_scan or flash_attention the card's count misses the kernels'
   work: the gap is printed.
6. The sharded train step (run_sharded_train; launch/sharded.py, run
   after phase 4's train runs and before phase 5's new ones): one NCCL
   rank in this process (a HashStore, world size 1), a (1, 1) ("data",
   "model") DeviceMesh, mamba2-130m at full width and depth with phase
   4's config and batches (8 × 4096, remat, bf16 activations), three
   steps through make_train_step and three through the sharded step from
   the same init.  Gates: losses within SHARDED_LOSS_RTOL step by step;
   the params after the three steps, and after the last sharded step
   against the plain step from the sharded state before it (gathered,
   its loss within SHARDED_LOSS_RTOL), as tests/test_torch_pretrain.py
   holds them (1e-3·lr plus one ulp, where m stands above
   SHARDED_GRAD_FLOOR of its leaf's largest); 144
   ssd_scan launches (2 a layer a step with remat), every one from the
   scan's local_map region (ssd_scan_sharded, counted by a wrapper the
   phase installs), and two more sharded steps under one torch.profiler
   session (CUDA only, no schedule), split by a device sleep between
   them, the second counted: 48 launches by the wrapper's count and each
   of the three bf16 scan kernels seen 48 times by the profiler on the
   card after the sleep.  The first step takes the records that CUPTI
   drops at a session's start (launch records whose correlation id has
   no record on the card, in the first milliseconds; a whole scan call
   among them late in the script).  47 passes only where the counted
   step's own launch records show 3 or more such; the counts of both
   steps are printed.
   Then launch/pretrain.py under torch.distributed.run on one rank
   (SHARDED_CLI): exit 0, every logged loss finite.  A "sharded_train" JSON line gives ms a step of both
   steps, peak GB, the torch version and the card's name and power
   limit.
7. A JSON line with every kernel's numbers, then, as the last line,
   {"ok": true, "device": {...}}.

It needs a card: without CUDA, or without the rest of the repository
beside it, it fails before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCES = ("fed_agg", "compress", "flash_attention",  # csrc/<name>.cu
                  "ssd_scan", "adam")
MAIN_P = 6_603_710                   # femnist_cnn parameters
# every FL model's params at Table I's width (launch/train.build_dataset):
# the char-LSTM's and the speech CNN's merges run fed_agg at ragged widths
MODEL_P = {"femnist": MAIN_P, "shakespeare": 818_402, "speech": 67_267,
           "mamba2-130m": 128_983_488}
PLATFORMS = ("gcf-gen2", "aws-lambda", "openfaas")   # round-robin fleet
MAIN_K = 8                           # clients per round on the main path
MAIN_CHUNK = 256                     # int8 values per scale (the default)
TOPK_RATIO = 0.01                    # top-k@1 % on the main path
CODEC_PS = (1, 255, 257, 4097, MAIN_P)
CODEC_CHUNKS = (8, MAIN_CHUNK)
CODEC_KS = (1, 41, round(MAIN_P * TOPK_RATIO))
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)   # one bf16 ulp
NORM_RTOL = 1e-5
SHARDED_NORM_RTOL = 1e-6     # sharded norm against the unsharded kernel's
# two FL runs of one configuration on two paths (eager loop against the
# executor, unsharded against two-slot meshes): training losses after the
# run within FL_LOSS_RTOL of each other and final params within
# FL_PARAM_REL_L2 (relative L2).  315 local Adam steps a client amplify
# rounding differences: on an H100 every pair of valid paths, the eager
# loop against itself with cuDNN off included (printed each run as the
# spread's yardstick), ended 1.4e-2 to 4.2e-2 apart, and the final losses
# of FedLesScan's runs spread over 1.448 to 1.606 (PERF.md, section 6)
FL_LOSS_RTOL = 0.2
FL_PARAM_REL_L2 = 0.1
# one local epoch of the full-width CNN with local SGD (no amplification),
# executor against the eager loop, client by client: with cuDNN off the
# params within EXEC_TOL (2.7e-6 measured on an H100, PERF.md), the
# mean losses within EXEC_LOSS_TOL with cuDNN on or off (2.8e-5 measured)
EXEC_TOL = dict(rtol=1e-4, atol=2e-5)
EXEC_LOSS_TOL = 1e-3
# the char-LSTM at Table I's local SGD (lr 0.8, no gradient clipping) is
# chaotic: in the JAX package on the CPU, initial params 1e-7 apart (relative)
# end 2 rounds 0.42 apart (relative L2) as its biases run to -17, so its
# FL runs are held to finite losses, not to a falling one, and its params
# beside the spread of the eager loop against itself from initial params
# one ulp apart (ROADMAP Queue 3).  On an H100 its 3 rounds ended 0.0197
# apart, executor against eager loop, and that spread was 0.0291: the
# bound is FL_PARAM_REL_L2, 5x the gap measured (PERF.md, section 6)
CHAOTIC = ("shakespeare",)
LSTM_PARAM_REL_L2 = FL_PARAM_REL_L2
# one round of the full-width char-LSTM, executor against eager loop, client
# by client: relative L2 of the params and the mean loss, 1.07e-6 and
# 7.6e-7 measured on an H100, 10x that allowed
LSTM_EXEC_TOL = {"rel_l2": 1e-5, "loss": 1e-5}
# a resumed run against the uninterrupted one: equal on an H100 (0.0); the
# bound admits rounding in the one replayed round, 100x the 1.07e-6 that
# executor and eager loop are apart after a round
RESUME_PARAM_REL_L2 = 1e-4
TIMED_RUNS = 20
HOLD_CYCLES = 100_000_000            # ~50 ms of device sleep (see time_ms)
# flash_attention checks: the kernel against its plain version
FLASH_HEADS = ((1, 2, 2), (2, 8, 4), (1, 8, 1))      # (B, H, Hkv)
FLASH_SEQS = (1, 100, 129, 1024)
FLASH_DIMS = (64, 128, 256)
# fp32 within the JAX tests' 2e-5; bf16 within the bound that rounding p
# to bf16 implies, element by element 2^-7·|want| + (2^-8 + 2^-11)·A with A
# the row's Σp|v|/l (bf16_bound, flash_bound)
FLASH_FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# the serve run: gemma2-2b at full width and depth
SERVE_ARCH = "gemma2-2b"
SERVE_B, SERVE_S, SERVE_NEW = 2, 5120, 32
# prefill logits of the bf16 models, kernel path against the same model with
# the kernels in their plain versions: within SERVE_REGROUP_FACTOR times
# what regrouping the plain versions alone moves them by (p rounded to bf16
# in the plain attention, the scan's fp32 sums in chunks of
# SSD_REGROUP_CHUNK against the kernel's TILE).  The random bf16 models turn
# 1-ulp differences into several % of max |logit| (PERF.md §6), so a fixed
# share says nothing.
SERVE_REGROUP_FACTOR = 2.0
SSD_REGROUP_CHUNK = 64       # not the bf16 scan kernel's chunk (TILE, 128)
FP32_LOGIT_TOL = 1e-3        # the model in fp32 (the JAX tests' bound)
# ssd_scan checks: the kernel against its plain version, inputs at the JAX
# tests' scales (x, B, C ~ 0.5·N(0, 1), a_dt = -0.3·|N(0, 1)|)
SSD_SHAPES = ((1, 1, 2, 16, 8), (2, 100, 3, 40, 16), (1, 129, 2, 64, 128),
              (2, 300, 4, 64, 64), (1, 1000, 2, 24, 100),  # (b, l, h, p, n)
              # below and across the bf16 kernel's chunk (TILE, 128): the
              # federated SSM run's folded executor call, a partial last
              # chunk at mamba2-130m's heads
              (64, 32, 24, 64, 128), (2, 200, 24, 64, 128))
SSD_FP32_TOL = 1e-4          # rtol and atol
SSD_BF16_ATOL = 1e-3         # plus one bf16 ulp of max |y|
# grouped B/C (b, l, g, n), head i reading group i // (h / g), at
# Nemotron-H's widths (b, l, h, p, n, g): a cut length in fp32 and bf16,
# and the hybrid train cell's shape in bf16, the main path's call
SSD_GROUPED = (((1, 2048, 64, 64, 128, 8), (torch.float32, torch.bfloat16)),
               ((4, 8192, 64, 64, 128, 8), (torch.bfloat16,)))
# moe_layer at Nemotron-H's widths (D, F, shared F, router experts, top-k,
# held) on T tokens in bf16: against the same routing's pairs summed expert
# by expert in fp32 from the same bf16 weights and inputs, within
# MOE_REL_TOL of max |y|: the layer rounds the hidden products, relu², the
# expert outputs and a bf16 sum of up to seven terms, a few bf16 ulps
# (2**-8) of max |y|, while a pair left out or sent to another expert moves
# y by a whole expert's output
MOE_SHAPE = dict(D=2688, F=1856, Fs=3712, E=128, k=6, held=16, T=8192)
MOE_REL_TOL = 3e-2
# in the serve runs, each scan call on the model's own activations: y as
# above, the fp32 state within SSD_FP32_TOL relative or SSD_FP32_TOL of
# max |state| (its sums over thousands of positions cancel)
# the two SSM serve runs: (arch, prompts, prompt length, use_pallas_attention)
SSM_SERVES = (("mamba2-130m", 4, 4096, False), ("zamba2-1.2b", 2, 4096, True))
# the train runs (arch, batch, sequence, Adam steps) through
# models.make_train_step at full width and depth (fp32 params, bf16
# activations, remat, efficient_ce, lr TRAIN_LR), on launch/pretrain.py's
# data: mamba2-130m at configs/shapes.py train_4k's sequence with its global
# batch of 256 cut to 8 for one card; zamba2-1.2b (the scan's second shape,
# the weight-tied shared block's grads summed over its 6 uses) and
# musicgen-medium (codebooks) take a few steps
TRAIN_RUNS = (("mamba2-130m", 8, 4096, 20), ("zamba2-1.2b", 2, 4096, 3),
              ("musicgen-medium", 2, 1024, 3))
TRAIN_LR = 3e-4
# one step's grads, the scan's forward in the kernel against the same step
# with the scan in its plain version: every leaf's relative L2 within
# TRAIN_GRAD_FACTOR times what regrouping only the plain scan's fp32 sums
# (chunks of SSD_REGROUP_CHUNK against TILE) moves that leaf by, measured in
# the same run on the same batch; the serve runs' rule for logits
TRAIN_GRAD_FACTOR = SERVE_REGROUP_FACTOR
# the ssd_scan Function's grads against autograd through ssd_scan_plain: the
# same fp32 graph on the same inputs, so equal but for cuBLAS's choice of
# algorithm: within SSD_GRAD_TOL of each input's max |grad|
SSD_GRAD_TOL = 1e-5
# the scan kernels' names as the profiler lists them (fp32; bf16 passes)
SSD_KERNEL_NAMES = ("ssd_kernel", "chunk_state_kernel", "state_pass_kernel",
                    "chunk_output_kernel")
# phase 6, the sharded train step on one NCCL rank: (arch, batch,
# sequence, steps) at phase 4's shape; losses within SHARDED_LOSS_RTOL of
# the plain step's (tests/torch_parity_common.py LOSS_RTOL), params held as
# tests/test_torch_pretrain.py holds them where m stands above
# SHARDED_GRAD_FLOOR of its leaf's largest; launch/pretrain.py's run under
# torch.distributed.run
SHARDED_RUN = ("mamba2-130m", 8, 4096, 3)
SHARDED_LOSS_RTOL = 1e-5
SHARDED_GRAD_FLOOR = 1e-2
SHARDED_CLI = ("--full", "--arch", "mamba2-130m", "--steps", "2", "--batch",
               "2", "--seq", "1024", "--log-every", "1")
# the federated SSM run: examples/federated_pretrain.py's experiment
# (FedLesScan, 12 clients, 4 a round, 25 % stragglers, 6 rounds, batch 16,
# local Adam 1e-3, sequences of 32 tokens) with its ModelDef over the full
# mamba2-130m config (fp32 params, bf16 activations, vocab 50,280; the
# token stream's ids lie below 256), on the executor and on the eager
# loop.  The executor's grads are held against the eager loop's within
# TRAIN_GRAD_FACTOR times what regrouping the plain scan's sums moves them
# by: at l = 32 the regrouping chunk must lie below the sequence
FED_SSM_ARCH = "mamba2-130m"
FED_SSM_CLIENTS, FED_SSM_ROUNDS, FED_SSM_STRAGGLERS = 12, 6, 0.25
FED_SSM_REGROUP_CHUNK = 16
# its two runs' final params: 138 local Adam steps of a bf16 model carry
# rounding further than the FEMNIST runs' FL_PARAM_REL_L2 (on an H100 the
# executor and the eager loop ended 0.121 apart): held, as the char-LSTM
# is, beside the spread of the executor against itself from initial
# params one ulp apart, within FED_SSM_PARAM_FACTOR times that spread;
# the step's grads are held for the first FED_SSM_GRAD_CLIENTS clients of
# the executor's group of 4
FED_SSM_PARAM_FACTOR = TRAIN_GRAD_FACTOR
FED_SSM_GRAD_CLIENTS = 2
# the example CLIs run once on the card, as subprocesses
EXAMPLE_RUNS = (("quickstart",),
                ("straggler_study", "--ratios", "0.3", "--rounds", "4"))
# musicgen-medium serve: prompts, codebook frames a prompt, new tokens
MUSICGEN_SERVE = (2, 1024, 8)
# the rest of the zoo, served at full width after the SSM models: the VLM
# at full depth (fp32 params), the MoE configs with depth cut to fit one
# card (bf16 params): (arch, layers or None for all, param dtype)
ZOO_B, ZOO_S, ZOO_NEW = 2, 2048, 32
ZOO_SERVES = (("llama-3.2-vision-11b", None, "float32"),
              ("llama4-maverick-400b-a17b", 2, "bfloat16"),
              ("arctic-480b", 1, "bfloat16"))
# the MoE block on the model's own activations against a per-token oracle
# (routing, slots and drops recomputed on the host, each kept pair's gated
# MLP in fp32 from the bf16 weights, weighted by the bf16-rounded w):
# within MOE_ORACLE_ATOL·A + MOE_ORACLE_RTOL·|want| element by element, A
# the sum over the token's kept pairs of w·Σ_f |h_f·wd_f| (and the dense
# MLP's Σ_f |h_f·wd_f|).  The block rounds a, u, act(a), h, the experts'
# outputs and the combine to bf16: four roundings of 2^-8 along h's chain
# give 2^-6·A, the outputs' 2^-8·(A + |want|); the bound doubles that.
# That bound holds whatever the rounding's signs, and at d_ff 8192 it is
# about twice |want|: a dropped or misrouted pair would pass it.  So each
# token's output is also held within MOE_ORACLE_REL_L2 relative L2 of the
# oracle's: rounding's random signs leave ~1 %, one pair of the token's
# k missing or misrouted moves it by tens of %.
MOE_ORACLE_TOKENS = 64
MOE_ORACLE_ATOL = 2.0 ** -5
MOE_ORACLE_RTOL = 2.0 ** -7
MOE_ORACLE_REL_L2 = 2.0 ** -4
# sharded_decode_attention on a two-slot mesh of the card at the VLM's
# decode shape (B, H, K, S, hd), fp32, against reference_decode_attention
# within FLASH_DECODE_TOL (tests/test_flash_decode.py's bound)
FLASH_DECODE_SHAPE = (2, 32, 8, ZOO_S + ZOO_NEW, 128)
FLASH_DECODE_TOL = 2e-5
# published peaks of the H100 (SXM / PCIe data sheets)
FP32_FLOPS = {"sxm": 67e12, "pcie": 51e12}
BF16_FLOPS = {"sxm": 989e12, "pcie": 756e12}     # dense tensor cores
MEM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
# the dry run against the card: two more train runs at full width, cut for
# one card (arch, batch, sequence, Adam steps, config overrides); the MoE's
# expert count is the largest of DRY_MOE_EXPERTS whose predicted peak stays
# under DRY_PEAK_BUDGET bytes (launch/dryrun.predict, before the card runs)
DRY_TRAIN_RUNS = (("llama-3.2-vision-11b", 1, 2048, 20, dict(n_layers=5)),
                  ("llama4-maverick-400b-a17b", 1, 2048, 20,
                   dict(n_layers=2, param_dtype="bfloat16")))
DRY_MOE_EXPERTS = (128, 64, 32, 16, 8, 4, 2, 1)
# an 80 GB card holds 85.0e9 bytes: 10e9 left for the CUDA context, the
# allocator's rounding and what earlier phases keep
DRY_PEAK_BUDGET = 75e9
# predicted peak (argument bytes + the fake step's peak live bytes) over
# torch.cuda.max_memory_allocated(): the allocator's rounding, cuBLAS's
# workspaces and tensors left from earlier phases stand between them
# (0.990-1.000 measured on an H100, PERF.md); a wrong reckoning of the
# optimizer's bytes (16 against 28 a param) is 1.75x
DRY_PEAK_RATIO = (0.9, 1.1)
# fake against the card's FlopCounterMode in a run that launches no kernel
# but adam (whose elementwise work neither side counts): the same
# matmul-class aten ops on the same shapes
DRY_FLOP_RTOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_part(name: str) -> str:
    return "pcie" if "pcie" in name.lower() else "sxm"


def bound_ms(n_bytes: float, n_flops: float, part: str, peak=FP32_FLOPS):
    """Least time for the work: bytes over the memory rate or operations
    over the peak for their type (fp32 unless ``peak`` says otherwise),
    whichever is larger."""
    by_bytes = n_bytes / MEM_BYTES_PER_S[part] * 1e3
    by_ops = n_flops / peak[part] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def time_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3,
            hold: bool = True) -> float:
    """Mean time of one call, by CUDA events around ``runs`` calls.

    With ``hold`` a device-side sleep holds the stream while the host
    queues the calls, so the events time the device work alone, not the
    host's launch overhead (which exceeds a ~10 µs kernel).  Without it
    the calls run as the host issues them: what a caller pays in a loop.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def flash_bound(q, k, v, want: torch.Tensor, kw: dict) -> torch.Tensor:
    """flash_attention's bound on each element against its plain version
    ``want``: FLASH_FP32_TOL in fp32, the bf16 kernel's derived bound
    (bf16_bound: 2^-7·|want| + (2^-8 + 2^-11)·Σp|v|/l) in bf16."""
    from repro_torch.kernels.flash_attention import bf16_bound

    if want.dtype == torch.float32:
        return FLASH_FP32_TOL["atol"] + FLASH_FP32_TOL["rtol"] * want.abs()
    return bf16_bound(q, k, v, want, **kw)


def err_over_bound(got: torch.Tensor, want: torch.Tensor,
                   bound: torch.Tensor) -> float:
    """max |got - want| / bound, element by element: at most 1 within the
    bound (nan counts as outside)."""
    err = (got.float() - want.float()).abs()
    ratio = err / bound.clamp(min=torch.finfo(torch.float32).tiny)
    return float(torch.where(torch.isnan(err), torch.inf, ratio).max())


def check_flash_call(got, q, k, v, want, kw: dict, label: str) -> dict:
    """Hold one flash_attention result against its plain version ``want``
    within flash_bound; fail outside it.  Returns the largest error, its
    ratio to the bound, and the medians of |want| and of the bound's part
    that does not scale with |want| (the atol), to read beside each other."""
    from repro_torch.kernels.flash_attention import BF16_RTOL

    bound = flash_bound(q, k, v, want, kw)
    ratio = err_over_bound(got, want, bound)
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: |got - want| reaches {ratio:.4g} of "
                             f"the bound")
    abs_want = want.float().abs()
    rtol = (FLASH_FP32_TOL["rtol"] if want.dtype == torch.float32
            else BF16_RTOL)
    return {"max_err": max_abs_err(got, want), "ratio": ratio,
            "median_want": float(abs_want.median()),
            "median_atol": float((bound - rtol * abs_want).median())}


# ------------------------------------------------------------ phase 0
def run_lint() -> dict:
    """repro-lint over src/repro_torch, in process (stdlib only): any
    finding not in the committed, empty baseline fails the run."""
    import io
    from repro_torch.analysis.__main__ import main as lint_main
    from repro_torch.analysis.rules import ALL_RULES

    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rc = lint_main([str(ROOT / "src" / "repro_torch"), "--format",
                        "json", "--tests-dir", str(ROOT / "tests")])
    summary = json.loads(report.getvalue())
    out = {"findings": summary["summary"]["new"],
           "baselined": summary["summary"]["baselined"],
           "rules": len(ALL_RULES), "files": summary["summary"]["files"],
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"lint": out}))
    if rc or out["findings"]:
        for f in summary["findings"]:
            log(f"  {f['path']}:{f['line']}: {f['rule']} {f['message']}")
        raise RuntimeError(f"repro-lint reports {out['findings']} "
                           f"finding(s) in src/repro_torch")
    return out


# ------------------------------------------------------------ phase 1
def phase_environment():
    from repro_torch.kernels import build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    checker = build.BUILD_DIR / "check_division"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    checker_nvcc = subprocess.Popen(        # alongside the kernels' builds
        [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-O3", "-o", str(checker),
         str(build.CSRC_DIR / "tools" / "check_division.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = build.build(KERNEL_SOURCES)
    log(f"built {list(KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", out)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", out)]
        log(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {max(spills)} bytes spilled at most (ptxas)")
    check_tensor_core_sass(build)
    out, _ = checker_nvcc.communicate()
    if checker_nvcc.returncode:
        raise RuntimeError(f"nvcc failed for csrc/tools/check_division.cu:"
                           f"\n{out}")
    check_softcap_division(checker)
    return smi


def check_softcap_division(checker: Path) -> None:
    """The bf16 attention kernel divides by the softcap through div_by.cuh
    (a hoisted reciprocal and one fma correction): hold it bit for bit
    against IEEE division over every float32 |x| in [2^-100, 2^100] for
    each softcap of the configs."""
    from repro_torch.configs import get_config, list_architectures

    caps = sorted({c for arch in list_architectures()
                   for c in (get_config(arch).attn_logit_softcap,
                             get_config(arch).final_logit_softcap) if c})
    run = subprocess.run([str(checker), *map(repr, caps)],
                         capture_output=True, text=True)
    log(f"  softcap division against IEEE division, caps {caps}: "
        f"{run.stdout.strip().splitlines()[-1] if run.stdout else ''}")
    if run.returncode:
        raise RuntimeError(f"div_by differs from IEEE division (exit "
                           f"{run.returncode}):\n{run.stdout}{run.stderr}")


def check_tensor_core_sass(build) -> None:
    """Every instantiation of the bf16 kernels (attention at d 64, 128 and
    256; the scan's chunk states and chunk outputs at n padded to 64 and
    128) must run its products as HGMMA (wgmma) in the compiled SASS."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    kernels = {"flash_attention": (r"(flash_wgmma)_kernelILi(\d+)E", 3),
               "ssd_scan": (r"(chunk_state|chunk_output)_kernelILi(\d+)E",
                            4)}
    for lib, (pattern, n_kernels) in kernels.items():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.library_path(lib))], check=True,
                              capture_output=True, text=True).stdout
        counts = {}
        for part in sass.split("Function : ")[1:]:
            match = re.search(pattern, part.split("\n")[0])
            if match:
                counts["_".join(match.groups())] = part.count("HGMMA.")
        log(f"  {lib} bf16 kernels, HGMMA instructions in their SASS: "
            f"{counts}")
        if len(counts) != n_kernels or not all(counts.values()):
            raise RuntimeError(f"the bf16 {lib} kernels lack HGMMA: {counts}")


# ------------------------------------------------------------ phase 2
def _randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def adam_launches_a_step(params) -> int:
    """``kernels.adam`` launches in one Adam step on ``params``: one a
    table of up to MAX_LEAVES leaves of one dtype (grads in the params')."""
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels.adam import MAX_LEAVES

    by_dtype = {}
    for t in tree_leaves(params):
        by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) + 1
    return sum(-(-n // MAX_LEAVES) for n in by_dtype.values())


ADAM_HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)   # TaskConfig's Adam


def _adam_leaves(shapes, gen, dtype=torch.float32):
    """params, grads, m, v (v ≥ 0) and the anchor (one row of each
    stacked leaf) at ``shapes`` on the card."""
    p = [_randn(s, gen, dtype) for s in shapes]
    g = [_randn(s, gen, dtype) * 0.01 for s in shapes]
    m = [_randn(s, gen) * 1e-3 for s in shapes]
    v = [_randn(s, gen).square() * 1e-5 for s in shapes]
    a = [t[0].clone() if t.dim() > 1 else t.clone() for t in p]
    return p, g, m, v, a


def time_adam(shapes, gen, part: str, label: str) -> dict:
    """kernels.adam against its plain version at ``shapes`` (fp32, count 3,
    no FedProx term, no weight decay): bit for bit, then each one's device
    time beside the bytes bound (read p, g, m, v; write p, m, v), the
    update-only kernel with PyTorch's apply after it (the path of an
    optimizer whose update a caller wrapped), PyTorch's own multi-tensor
    AdamW (``torch._fused_adamw_``, in place on copies, no FedProx term,
    not bit-equal: it divides by sqrt(bc2) after the root) with its
    largest param gap to the kernel after one call, and the launches a
    call."""
    import numpy as np

    from repro_torch.kernels.adam import adam, adam_plain

    p, g, m, v, _ = _adam_leaves(shapes, gen)
    n = sum(t.numel() for t in p)
    kw = dict(ADAM_HYPER, weight_decay=0.0,
              bc1=float(np.float32(1) - np.float32(0.9) ** np.float32(3)),
              bc2=float(np.float32(1) - np.float32(0.999) ** np.float32(3)))
    before = adam.launches
    got = adam(p, g, m, v, **kw)
    launches = adam.launches - before
    want = adam_plain(p, g, m, v, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("params", "m", "v"), got, want):
        for i, (a, b) in enumerate(zip(x, y)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"adam {label}: {name} of leaf {i} {tuple(a.shape)} not "
                    f"bit-equal to the plain passes (max |err| "
                    f"{max_abs_err(a, b):.3g})")
    del got, want
    bound, bound_by = bound_ms(7 * 4 * n, 15.0 * n, part)

    def split():
        upd, _, _ = adam(p, g, m, v, apply=False, **kw)
        return [a + b for a, b in zip(p, upd)]

    lib = [[t.clone() for t in ts] for ts in (p, m, v)]
    counts = [torch.full((), 3.0, device="cuda") for _ in p]

    def library():
        torch._fused_adamw_(
            *lib[:1], g, *lib[1:], [], counts, lr=kw["lr"],
            beta1=kw["b1"], beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"],
            amsgrad=False, maximize=False)

    library()
    library_gap = max(max_abs_err(a, b) for a, b in
                      zip(lib[0], adam(p, g, m, v, **kw)[0]))

    out = {"shape": label, "elements": n, "leaves": len(p),
           "ms": time_ms(lambda: adam(p, g, m, v, **kw), runs=10),
           "call_ms": time_ms(lambda: adam(p, g, m, v, **kw), runs=10,
                              hold=False),
           "bound_ms": bound, "bound_by": bound_by,
           "plain_ms": time_ms(lambda: adam_plain(p, g, m, v, **kw),
                               runs=5),
           "update_then_apply_ms": time_ms(split, runs=10),
           "library_ms": time_ms(library, runs=10),
           "library_param_max_abs_gap": library_gap,
           "launches_a_call": launches}
    out["roofline_pct"] = 100.0 * bound / out["ms"]
    return out


def check_adam(gen, part: str) -> dict:
    """kernels.adam bit for bit against its plain version on the card at
    ragged and bf16 leaves with the FedProx term and weight decay, then
    timed at the FEMNIST CNN's leaves stacked to the executor's bucket of
    64 and at mamba2-130m's leaves (what make_train_step steps)."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels.adam import adam, adam_plain
    from repro_torch.models.small import make_cnn
    from repro_torch.models.transformer import init_params

    for dtype in (torch.float32, torch.bfloat16):
        shapes = [(64, 62), (64, 1001), (7,), (3, 5, 5), (64, 2048)]
        p, g, m, v, a = _adam_leaves(shapes, gen, dtype)
        for apply in (True, False):
            kw = dict(ADAM_HYPER, weight_decay=0.01, bc1=0.1, bc2=0.001,
                      anchor=a, mu=0.01, apply=apply)
            got, want = adam(p, g, m, v, **kw), adam_plain(p, g, m, v, **kw)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                for i, (s, t) in enumerate(zip(x, y)):
                    if not torch.equal(s, t):
                        raise AssertionError(
                            f"adam {dtype} apply={apply}: leaf {i} "
                            f"{tuple(s.shape)} max |err| "
                            f"{max_abs_err(s, t):.3g}")
    cnn = make_cnn(28, 1, 62, 2048, "femnist_cnn").init(0, "cuda")
    cnn_shapes = [(64, *t.shape) for t in tree_leaves(cnn)]
    del cnn
    lm = init_params(get_config("mamba2-130m"),
                     torch.Generator(device="cuda").manual_seed(0))
    lm_shapes = [tuple(t.shape) for t in tree_leaves(lm)]
    del lm
    torch.cuda.empty_cache()
    cnn_k64 = time_adam(cnn_shapes, gen, part, "femnist_cnn K=64")
    lm_step = time_adam(lm_shapes, gen, part, "mamba2-130m")
    row = {"name": "adam", "route": "cuda",
           "source": "src/repro_torch/csrc/adam.cu",
           "replaces": "none (the JAX package's Adam is XLA-fused jnp)",
           **cnn_k64, **{f"lm_{k}": x for k, x in lm_step.items()}}
    torch.cuda.empty_cache()
    log(json.dumps({"kernel_check": row}))
    return row



def check_fed_agg(gen, part: str) -> dict:
    from repro_torch.kernels.fed_agg import fed_agg, fed_agg_plain

    main = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for K in (1, 8, 13):
            for P in (1, 4097, MAIN_P):
                u = _randn((K, P), gen, dtype)
                c = torch.rand(K, generator=gen, device="cuda")
                got = fed_agg(u, c)
                want = fed_agg_plain(u, c)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **tol)
                err = max_abs_err(got, want)
                log(f"fed_agg {str(dtype)[6:]} K={K} P={P}: "
                    f"max |err| {err:.3g}")
                if dtype == torch.float32 and (K, P) == (MAIN_K, MAIN_P):
                    main = dict(u=u, c=c, err=err)
    u, c = main["u"], main["c"]
    row = {
        "name": "fed_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg.py:68",
        "max_abs_err": main["err"],
        **time_fed_agg(u, c, part),
        "call_ms": time_ms(lambda: fed_agg(u, c), hold=False),
        "widths": [check_fed_agg_at(gen, part, MAIN_K, P)
                   for P in (MODEL_P["shakespeare"], MODEL_P["speech"])],
    }
    log(json.dumps({"kernel_check": row}))
    return row


def time_fed_agg(u: torch.Tensor, c: torch.Tensor, part: str) -> dict:
    """fed_agg's, its plain version's and torch.matmul's device times on
    (u, c) beside the bytes bound (U and c read once, the sum written)."""
    from repro_torch.kernels.fed_agg import fed_agg, fed_agg_plain

    K, P = u.shape
    n_bytes = (K + 1) * P * 4 + K * 4
    bound, bound_by = bound_ms(n_bytes, 2.0 * K * P, part)
    return {"ms": time_ms(lambda: fed_agg(u, c)),
            "plain_ms": time_ms(lambda: fed_agg_plain(u, c)),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.matmul(c, u)),
            "shape": f"K={K} P={P} fp32"}


def check_fed_agg_at(gen, part: str, K: int, P: int) -> dict:
    """fed_agg at one merge's (K, P) in fp32: bit for bit its plain
    version (both sum k in order with one rounding per operation), and
    timed."""
    from repro_torch.kernels.fed_agg import fed_agg, fed_agg_plain

    u = _randn((K, P), gen)
    c = torch.rand(K, generator=gen, device="cuda")
    got, want = fed_agg(u, c), fed_agg_plain(u, c)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"fed_agg K={K} P={P}: not bit-equal to its "
                             f"plain version (max |err| "
                             f"{max_abs_err(got, want):.3g})")
    out = time_fed_agg(u, c, part)
    log(json.dumps({"fed_agg_width": out}))
    return out


def check_fed_agg_apply(gen, part: str) -> dict:
    from repro_torch.kernels.fed_agg import (APPLY_OPTS, fed_agg_apply,
                                             fed_agg_apply_plain)

    hyper = (0.01, 0.8, 0.9, 0.99, 1e-3)         # lr, mix, b1, b2, eps
    main = {}
    for P in (4097, MAIN_P):
        u = _randn((MAIN_K, P), gen)
        c = torch.rand(MAIN_K, generator=gen, device="cuda")
        g = _randn(P, gen)
        m = _randn(P, gen) * 0.1
        v = torch.rand(P, generator=gen, device="cuda") * 0.1
        for opt in APPLY_OPTS:
            got = fed_agg_apply(u, c, g, m, v, *hyper, opt=opt)
            want = fed_agg_apply_plain(u, c, g, m, v, *hyper, opt=opt)
            torch.cuda.synchronize()
            for name, t, w in zip(("out", "m", "v"), got[:3], want[:3]):
                torch.testing.assert_close(t, w, **FP32_TOL,
                                           msg=f"{opt} {name}")
            torch.testing.assert_close(got[3], want[3], rtol=NORM_RTOL,
                                       atol=0.0, msg=f"{opt} norm")
            err = max(max_abs_err(t, w) for t, w in zip(got[:3], want[:3]))
            log(f"fed_agg_apply {opt} K={MAIN_K} P={P}: max |err| "
                f"{err:.3g}, norm {float(got[3]):.6g} vs "
                f"{float(want[3]):.6g}")
            if (opt, P) == ("fedadam", MAIN_P):
                main = dict(args=(u, c, g, m, v), err=err)
    args = main["args"]
    K, P = args[0].shape
    n_bytes = (K + 6) * P * 4 + K * 4
    bound, bound_by = bound_ms(n_bytes, (2.0 * K + 16) * P, part)
    row = {
        "name": "fed_agg_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg.py:192",
        "max_abs_err": main["err"],
        "ms": time_ms(lambda: fed_agg_apply(*args, *hyper, opt="fedadam")),
        "call_ms": time_ms(
            lambda: fed_agg_apply(*args, *hyper, opt="fedadam"), hold=False),
        "plain_ms": time_ms(
            lambda: fed_agg_apply_plain(*args, *hyper, opt="fedadam")),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,     # no single PyTorch call computes it
        "shape": f"K={K} P={P} fp32 fedadam",
    }
    log(json.dumps({"kernel_check": row}))
    return row


def _meshes():
    """The sharded checks' meshes of the one card: two slots (P splits
    evenly) and three (P = MAIN_P pads by 1)."""
    from repro_torch.launch.mesh import Mesh

    return [Mesh(("cuda:0",) * n, (("data", n), ("model", 1)))
            for n in (2, 3)]


def check_fed_agg_sharded(gen, part: str) -> dict:
    from repro_torch.kernels.fed_agg import (fed_agg, fed_agg_plain,
                                             fed_agg_sharded)

    err = 0.0
    for mesh in _meshes():
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            for K, P in ((1, 1), (13, 4097), (MAIN_K, MAIN_P)):
                u = _randn((K, P), gen, dtype)
                c = torch.rand(K, generator=gen, device="cuda")
                got = fed_agg_sharded(u, c, mesh)
                want = fed_agg(u, c)
                plain = fed_agg_plain(u, c)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"fed_agg_sharded {mesh.size} slots "
                                       f"{dtype} K={K} P={P}: differs from "
                                       f"fed_agg")
                torch.testing.assert_close(got, plain, **tol)
                err = max(err, max_abs_err(got, plain))
            log(f"fed_agg_sharded {mesh.size} slots {str(dtype)[6:]}: equal "
                f"to fed_agg, max |err| vs plain {err:.3g}")
    mesh = _meshes()[0]
    u = _randn((MAIN_K, MAIN_P), gen)
    c = torch.rand(MAIN_K, generator=gen, device="cuda")
    K, P = u.shape
    # the unsharded kernel's bytes: when every slot is the output's device
    # each slab writes its slice in place and nothing is gathered (slabs on
    # other devices would add their copies, at most 2·P·4 B)
    home_only = all(dev == mesh.devices[0] for dev in mesh.devices)
    n_bytes = (K + 1) * P * 4 + K * 4 + (0 if home_only else 2 * P * 4)
    bound, bound_by = bound_ms(n_bytes, 2.0 * K * P, part)
    row = {
        "name": "fed_agg_sharded", "route": "cuda",
        "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg.py:251",
        "max_abs_err": err,
        "ms": time_ms(lambda: fed_agg_sharded(u, c, mesh)),
        "call_ms": time_ms(lambda: fed_agg_sharded(u, c, mesh), hold=False),
        "unsharded_ms": time_ms(lambda: fed_agg(u, c)),
        "plain_ms": time_ms(lambda: fed_agg_plain(u, c)),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch.matmul(c, u)),
        "shape": f"K={K} P={P} fp32, mesh (cuda:0, cuda:0)",
    }
    log(json.dumps({"kernel_check": row}))
    return row


def check_fed_agg_apply_sharded(gen, part: str) -> dict:
    from repro_torch.kernels.fed_agg import (APPLY_OPTS, fed_agg_apply,
                                             fed_agg_apply_plain,
                                             fed_agg_apply_sharded)

    hyper = (0.01, 0.8, 0.9, 0.99, 1e-3)         # lr, mix, b1, b2, eps
    err, main = 0.0, {}
    for mesh in _meshes():
        for P in (4097, MAIN_P):
            u = _randn((MAIN_K, P), gen)
            c = torch.rand(MAIN_K, generator=gen, device="cuda")
            g = _randn(P, gen)
            m = _randn(P, gen) * 0.1
            v = torch.rand(P, generator=gen, device="cuda") * 0.1
            for opt in APPLY_OPTS:
                got = fed_agg_apply_sharded(u, c, g, m, v, *hyper, opt=opt,
                                            mesh=mesh)
                want = fed_agg_apply(u, c, g, m, v, *hyper, opt=opt)
                plain = fed_agg_apply_plain(u, c, g, m, v, *hyper, opt=opt)
                torch.cuda.synchronize()
                for name, t, w, p in zip(("out", "m", "v"), got[:3],
                                         want[:3], plain[:3]):
                    if not torch.equal(t, w):
                        raise RuntimeError(
                            f"fed_agg_apply_sharded {mesh.size} slots {opt} "
                            f"P={P} {name}: differs from fed_agg_apply")
                    torch.testing.assert_close(t, p, **FP32_TOL,
                                               msg=f"{opt} {name}")
                    err = max(err, max_abs_err(t, p))
                torch.testing.assert_close(got[3], want[3],
                                           rtol=SHARDED_NORM_RTOL, atol=0.0,
                                           msg=f"{opt} norm")
                torch.testing.assert_close(got[3], plain[3], rtol=NORM_RTOL,
                                           atol=0.0, msg=f"{opt} norm")
                if (mesh.size, opt, P) == (2, "fedadam", MAIN_P):
                    main = dict(args=(u, c, g, m, v), mesh=mesh)
            log(f"fed_agg_apply_sharded {mesh.size} slots P={P}: equal to "
                f"fed_agg_apply in out/m/v, norm within "
                f"{SHARDED_NORM_RTOL}; max |err| vs plain {err:.3g}")
    args, mesh = main["args"], main["mesh"]
    K, P = args[0].shape
    # the unsharded kernel's bytes plus the gathers of out, m and v
    n_bytes = (K + 6) * P * 4 + K * 4 + 3 * 2 * P * 4
    bound, bound_by = bound_ms(n_bytes, (2.0 * K + 16) * P, part)
    row = {
        "name": "fed_agg_apply_sharded", "route": "cuda",
        "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg.py:275",
        "max_abs_err": err,
        "ms": time_ms(lambda: fed_agg_apply_sharded(
            *args, *hyper, opt="fedadam", mesh=mesh)),
        "call_ms": time_ms(lambda: fed_agg_apply_sharded(
            *args, *hyper, opt="fedadam", mesh=mesh), hold=False),
        "unsharded_ms": time_ms(
            lambda: fed_agg_apply(*args, *hyper, opt="fedadam")),
        "plain_ms": time_ms(
            lambda: fed_agg_apply_plain(*args, *hyper, opt="fedadam")),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,     # no single PyTorch call computes it
        "shape": f"K={K} P={P} fp32 fedadam, mesh (cuda:0, cuda:0)",
    }
    log(json.dumps({"kernel_check": row}))
    return row


def _codec_inputs(P: int, gen) -> dict:
    """Inputs of the codec checks: random with chunk-to-chunk spread, a
    leading all-zero stretch, a representable grid (integer multiples of
    2^-3 with 127·2^-3 at every 8th place, so every chunk's scale is 2^-3
    and codes and decodes are exact), and a tie-heavy vector (values in
    -3..3, so many |x| share the top-k threshold)."""
    spread = torch.rand(P, generator=gen, device="cuda") * 10
    normal = _randn(P, gen) * spread
    zeros = normal.clone()
    zeros[:min(P, 2 * MAIN_CHUNK)] = 0
    grid = torch.randint(-127, 128, (P,), generator=gen,
                         device="cuda").float() * 2.0 ** -3
    grid[::8] = 127 * 2.0 ** -3
    ties = torch.randint(-3, 4, (P,), generator=gen, device="cuda").float()
    return {"normal": normal, "zero chunk": zeros, "grid": grid,
            "ties": ties}


def check_int8(gen, part: str) -> list:
    from repro_torch.kernels.compress import (int8_decode, int8_decode_plain,
                                              int8_encode, int8_encode_plain)

    errs = {"int8_encode": 0.0, "int8_decode": 0.0}
    for P in CODEC_PS:
        for label, x in _codec_inputs(P, gen).items():
            for chunk in CODEC_CHUNKS:
                q, s = int8_encode(x, chunk)
                q_w, s_w = int8_encode_plain(x, chunk)
                out = int8_decode(q, s, P)
                out_w = int8_decode_plain(q_w, s_w, P)
                torch.cuda.synchronize()
                if not (torch.equal(q, q_w) and torch.equal(s, s_w)):
                    raise RuntimeError(f"int8_encode P={P} chunk={chunk} "
                                       f"{label}: differs from plain")
                if not torch.equal(out, out_w):
                    raise RuntimeError(f"int8_decode P={P} chunk={chunk} "
                                       f"{label}: differs from plain")
                if label == "grid" and not torch.equal(out, x):
                    raise RuntimeError(f"int8 P={P} chunk={chunk}: the "
                                       f"grid does not round-trip")
                enc_err = max(max_abs_err(q, q_w), max_abs_err(s, s_w))
                dec_err = max_abs_err(out, out_w)
                errs["int8_encode"] = max(errs["int8_encode"], enc_err)
                errs["int8_decode"] = max(errs["int8_decode"], dec_err)
            log(f"int8 P={P} {label}: max |err| encode {enc_err:.3g} "
                f"decode {dec_err:.3g} (chunks {CODEC_CHUNKS})")
    P, chunk = MAIN_P, MAIN_CHUNK
    x = _randn(P, gen) * 1e-3
    q, s = int8_encode(x, chunk)
    n_chunks = q.shape[0]
    n_bytes = 4 * P + n_chunks * chunk + 4 * n_chunks
    rows = []
    for name, fn, plain, ops in (
            ("int8_encode", lambda: int8_encode(x, chunk),
             lambda: int8_encode_plain(x, chunk), 6.0 * n_chunks * chunk),
            ("int8_decode", lambda: int8_decode(q, s, P),
             lambda: int8_decode_plain(q, s, P), 1.0 * P)):
        bound, bound_by = bound_ms(n_bytes, ops, part)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/compress.cu",
            "replaces": ("src/repro/kernels/compress.py:67"
                         if name == "int8_encode"
                         else "src/repro/kernels/compress.py:95"),
            "max_abs_err": errs[name],
            "ms": time_ms(fn), "call_ms": time_ms(fn, hold=False),
            "plain_ms": time_ms(plain),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,     # no single PyTorch call computes it
            "shape": f"P={P} chunk={chunk} fp32",
        }
        log(json.dumps({"kernel_check": row}))
        rows.append(row)
    return rows


def check_topk_mask(gen, part: str) -> dict:
    from repro_torch.kernels.compress import (topk_decode, topk_encode,
                                              topk_mask, topk_mask_plain,
                                              topk_select)

    err = 0.0
    for P in CODEC_PS:
        for label, x in _codec_inputs(P, gen).items():
            picks = [(k, *topk_select(x, k)) for k in CODEC_KS if k < P]
            if P == 1:       # no k < P: keep and drop the one tie
                tau = x.abs().reshape(())
                picks = [(1, None, tau, torch.tensor(last, device="cuda"))
                         for last in (0, -1)]
            for k, idx, tau, last_keep in picks:
                got = topk_mask(x, tau, last_keep)
                want = topk_mask_plain(x, tau, last_keep)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"topk_mask P={P} k={k} {label}: "
                                       f"differs from plain")
                err = max(err, max_abs_err(got, want))
                if idx is not None:
                    i32, vals, dec = topk_encode(x, k)
                    if not (torch.equal(dec, got) and torch.equal(
                            topk_decode(i32, vals, P), got)
                            and torch.unique(idx).numel() == k):
                        raise RuntimeError(f"topk_encode P={P} k={k} "
                                           f"{label}: decode mismatch")
            log(f"topk_mask P={P} {label}: max |err| {err:.3g} "
                f"(k {[p[0] for p in picks]})")
    P, k = MAIN_P, CODEC_KS[-1]
    x = _randn(P, gen) * 1e-3
    _, tau, last_keep = topk_select(x, k)
    bound, bound_by = bound_ms(8.0 * P, 4.0 * P, part)
    row = {
        "name": "topk_mask", "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:138",
        "max_abs_err": err,
        "ms": time_ms(lambda: topk_mask(x, tau, last_keep)),
        "call_ms": time_ms(lambda: topk_mask(x, tau, last_keep), hold=False),
        "plain_ms": time_ms(lambda: topk_mask_plain(x, tau, last_keep)),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,         # no single PyTorch call computes it
        # the whole encode: torch.topk, the tie rule, the mask, the gather
        "topk_encode_ms": time_ms(lambda: topk_encode(x, k)),
        "topk_encode_call_ms": time_ms(lambda: topk_encode(x, k),
                                       hold=False),
        "shape": f"P={P} k={k} fp32",
    }
    log(json.dumps({"kernel_check": row}))
    return row


def _attended_pairs(S: int, window) -> int:
    """(row, col) pairs a causal attention of length S attends, with
    row - col < window when a window is set."""
    w = window or S
    return sum(min(r + 1, w) for r in range(S))


def check_flash_attention(gen, part: str) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    err, worst = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Hkv in FLASH_HEADS:
            for S in FLASH_SEQS:
                case_err, case_ratio, n_cases = 0.0, 0.0, 0
                for d in FLASH_DIMS:
                    for window in (None, 64):
                        for cap in (0.0, 50.0):
                            for causal in ((True, False) if d == 64
                                           else (True,)):
                                n_cases += 1
                                # every other case hands q over as the
                                # swapaxes view the model passes
                                q = (_randn((B, S, H, d), gen, dtype)
                                     .transpose(1, 2) if n_cases % 2
                                     else _randn((B, H, S, d), gen, dtype))
                                k = _randn((B, Hkv, S, d), gen, dtype)
                                v = _randn((B, Hkv, S, d), gen, dtype)
                                kw = dict(causal=causal, window=window,
                                          softcap=cap)
                                got = flash_attention(q, k, v, **kw)
                                want = flash_attention_plain(q, k, v, **kw)
                                torch.cuda.synchronize()
                                c = check_flash_call(
                                    got, q, k, v, want, kw,
                                    f"flash_attention {dtype} B={B} H={H} "
                                    f"Hkv={Hkv} S={S} d={d} {kw}")
                                case_err = max(case_err, c["max_err"])
                                case_ratio = max(case_ratio, c["ratio"])
                err = max(err, case_err)
                worst[dtype] = max(worst[dtype], case_ratio)
                log(f"flash_attention {str(dtype)[6:]} B={B} H={H} "
                    f"Hkv={Hkv} S={S}: {n_cases} cases (d {FLASH_DIMS}, "
                    f"window None/64, softcap 0/50), max |err| "
                    f"{case_err:.3g}, at most {case_ratio:.3f} of the bound "
                    f"(last case: median |want| {c['median_want']:.3g}, "
                    f"median atol {c['median_atol']:.3g})")

    # the main path's shape: (B, S, H, d) buffers seen as (B, H, S, d)
    B, H, Hkv, S, d = SERVE_B, 8, 4, SERVE_S, 256
    q = _randn((B, S, H, d), gen, torch.bfloat16).transpose(1, 2)
    k = _randn((B, S, Hkv, d), gen, torch.bfloat16).transpose(1, 2)
    v = _randn((B, S, Hkv, d), gen, torch.bfloat16).transpose(1, 2)
    n_bytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:100"}
    for window, prefix in ((None, ""), (4096, "local_")):
        kw = dict(window=window, softcap=50.0)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        c = check_flash_call(got, q, k, v, want, kw,
                             f"flash_attention Gemma 2 shape {kw}")
        log(f"flash_attention Gemma 2 shape window {window}: max |err| "
            f"{c['max_err']:.3g}, {c['ratio']:.3f} of the bound, median "
            f"|want| {c['median_want']:.3g}, median atol "
            f"{c['median_atol']:.3g}")
        err = max(err, c["max_err"])
        worst[torch.bfloat16] = max(worst[torch.bfloat16], c["ratio"])
        del got, want
        flops = 4.0 * d * _attended_pairs(S, window) * B * H
        bound, bound_by = bound_ms(n_bytes, flops, part, BF16_FLOPS)
        bound32, _ = bound_ms(n_bytes, flops, part)
        row.update({
            f"{prefix}ms": time_ms(lambda: flash_attention(q, k, v, **kw),
                                   runs=5, warmup=2),
            f"{prefix}call_ms": time_ms(
                lambda: flash_attention(q, k, v, **kw), runs=5, warmup=1,
                hold=False),
            f"{prefix}plain_ms": time_ms(
                lambda: flash_attention_plain(q, k, v, **kw), runs=3,
                warmup=1),
            f"{prefix}bound_ms": bound, f"{prefix}bound_by": bound_by,
            f"{prefix}bound_fp32_ms": bound32, f"{prefix}gflop": flops / 1e9,
        })
    # the global layer without softcap: what the cap's tanh and division cost
    row["nocap_ms"] = time_ms(lambda: flash_attention(q, k, v), runs=5,
                              warmup=2)
    # zamba2-1.2b's shared attention block: 32 heads (32 KV), d 64,
    # causal, no softcap, no window; SDPA computes the same function here
    zB, zH, zS, zd = SSM_SERVES[1][1], 32, SSM_SERVES[1][2], 64
    zq, zk, zv = (_randn((zB, zS, zH, zd), gen, torch.bfloat16)
                  .transpose(1, 2) for _ in range(3))
    got = flash_attention(zq, zk, zv)
    want = flash_attention_plain(zq, zk, zv)
    torch.cuda.synchronize()
    c = check_flash_call(got, zq, zk, zv, want, {},
                         "flash_attention Zamba2 shape")
    log(f"flash_attention Zamba2 shape: max |err| {c['max_err']:.3g}, "
        f"{c['ratio']:.3f} of the bound, median |want| "
        f"{c['median_want']:.3g}, median atol {c['median_atol']:.3g}")
    err = max(err, c["max_err"])
    worst[torch.bfloat16] = max(worst[torch.bfloat16], c["ratio"])
    del got, want
    flops = 4.0 * zd * _attended_pairs(zS, None) * zB * zH
    bound, bound_by = bound_ms(2.0 * 4 * zq.numel(), flops, part, BF16_FLOPS)
    zc = [t.contiguous() for t in (zq, zk, zv)]
    row.update({
        "zamba_ms": time_ms(lambda: flash_attention(zq, zk, zv), runs=5,
                            warmup=2),
        "zamba_call_ms": time_ms(lambda: flash_attention(zq, zk, zv),
                                 runs=5, warmup=1, hold=False),
        "zamba_plain_ms": time_ms(lambda: flash_attention_plain(zq, zk, zv),
                                  runs=3, warmup=1),
        "zamba_bound_ms": bound, "zamba_bound_by": bound_by,
        "zamba_bound_fp32_ms": bound_ms(2.0 * 4 * zq.numel(), flops,
                                        part)[0],
        "zamba_gflop": flops / 1e9,
        "zamba_library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *zc, is_causal=True), runs=5, warmup=2),
    })
    del zq, zk, zv, zc
    # llama-3.2-vision-11b's self attention (the MoE configs' too, with 40
    # and 56 heads): hd 128, GQA 32 / 8, causal, no softcap, no window;
    # SDPA computes the same function here
    vB, vH, vHkv, vS, vd = ZOO_B, 32, 8, ZOO_S, 128
    vq = _randn((vB, vS, vH, vd), gen, torch.bfloat16).transpose(1, 2)
    vk, vv = (_randn((vB, vS, vHkv, vd), gen, torch.bfloat16)
              .transpose(1, 2) for _ in range(2))
    got = flash_attention(vq, vk, vv)
    want = flash_attention_plain(vq, vk, vv)
    torch.cuda.synchronize()
    c = check_flash_call(got, vq, vk, vv, want, {},
                         "flash_attention llama-3.2-vision shape")
    log(f"flash_attention llama-3.2-vision shape: max |err| "
        f"{c['max_err']:.3g}, {c['ratio']:.3f} of the bound, median |want| "
        f"{c['median_want']:.3g}, median atol {c['median_atol']:.3g}")
    err = max(err, c["max_err"])
    worst[torch.bfloat16] = max(worst[torch.bfloat16], c["ratio"])
    del got, want
    flops = 4.0 * vd * _attended_pairs(vS, None) * vB * vH
    v_bytes = 2.0 * (2 * vq.numel() + vk.numel() + vv.numel())
    bound, bound_by = bound_ms(v_bytes, flops, part, BF16_FLOPS)
    vc_ = [t.contiguous() for t in (vq, vk, vv)]
    row.update({
        "vlm_ms": time_ms(lambda: flash_attention(vq, vk, vv), runs=5,
                          warmup=2),
        "vlm_call_ms": time_ms(lambda: flash_attention(vq, vk, vv), runs=5,
                               warmup=1, hold=False),
        "vlm_plain_ms": time_ms(lambda: flash_attention_plain(vq, vk, vv),
                                runs=3, warmup=1),
        "vlm_bound_ms": bound, "vlm_bound_by": bound_by,
        "vlm_gflop": flops / 1e9,
        "vlm_library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *vc_, is_causal=True, enable_gqa=True), runs=5, warmup=2),
    })
    del vq, vk, vv, vc_
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    row.update({
        "max_abs_err": err,
        "fp32_err_over_bound": worst[torch.float32],
        "bf16_err_over_bound": worst[torch.bfloat16],
        # no single PyTorch call computes soft-capped or windowed attention
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True),
            runs=5, warmup=2),
        "library": "scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True): causal only, no softcap, no window",
        "shape": f"B={B} H={H} Hkv={Hkv} S={S} d={d} bf16 softcap 50; "
                 f"ms = global layer, local_ms = window 4096, nocap_ms = "
                 f"global without softcap; zamba_ = "
                 f"B={zB} H=Hkv={zH} S={zS} d={zd} bf16 causal, library "
                 f"SDPA computes the same function there; vlm_ = B={vB} "
                 f"H={vH} Hkv={vHkv} S={vS} d={vd} bf16 causal, the same "
                 f"function as SDPA",
        "mbytes": n_bytes / 1e6,
    })
    log(json.dumps({"kernel_check": row}))
    return row


def _ssd_inputs(shape, gen, dtype, broadcast: bool):
    """x, a_dt, B, C at the JAX tests' scales; with ``broadcast`` B and C
    are head-broadcast views (head stride 0), as models/ssm.py passes
    them."""
    b, l, h, p, n = shape
    x = (_randn((b, l, h, p), gen) * 0.5).to(dtype)
    a = -_randn((b, l, h), gen).abs() * 0.3
    B, C = ((_randn((b, l, 1 if broadcast else h, n), gen) * 0.5).to(dtype)
            .expand(b, l, h, n) for _ in range(2))
    return x, a, B, C


def _check_ssd_grouped(gen, part: str) -> dict:
    """ssd_scan on grouped B/C (b, l, g, n) at SSD_GROUPED's shapes: one
    launch a call, y and the state bit-equal to the call on B and C
    copied to every head, and within the head-broadcast checks'
    tolerances of ssd_scan_plain; at the train cell's shape timed against
    the call on copies.  Returns the ssd_scan row's ``nemotron_``
    numbers."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    out, err = {}, 0.0
    for (b, l, h, p, n, g), dtypes in SSD_GROUPED:
        for dtype in dtypes:
            x = (_randn((b, l, h, p), gen) * 0.5).to(dtype)
            a = -_randn((b, l, h), gen).abs() * 0.3
            B, C = ((_randn((b, l, g, n), gen) * 0.5).to(dtype)
                    for _ in range(2))
            label = (f"ssd_scan {str(dtype)[6:]} grouped (b, l, h, p, n, g) "
                     f"= {(b, l, h, p, n, g)}")
            before = ssd_scan.launches
            y, state = ssd_scan(x, a, B, C, return_state=True)
            torch.cuda.synchronize()
            if ssd_scan.launches != before + 1:
                raise RuntimeError(f"{label}: {ssd_scan.launches - before} "
                                   f"launches, not 1")
            copies = [t.repeat_interleave(h // g, 2) for t in (B, C)]
            y2, state2 = ssd_scan(x, a, *copies, return_state=True)
            if not (torch.equal(y, y2) and torch.equal(state, state2)):
                raise RuntimeError(f"{label}: not bit-equal to the call on "
                                   f"per-head copies")
            want, want_state = ssd_scan_plain(x, a, B, C, return_state=True)
            torch.testing.assert_close(y, want, **_ssd_y_tol(want),
                                       msg=lambda m: f"{label}, y: {m}")
            torch.testing.assert_close(
                state, want_state, rtol=SSD_FP32_TOL, atol=SSD_FP32_TOL,
                msg=lambda m: f"{label}, state: {m}")
            case_err = max(max_abs_err(y, want),
                           max_abs_err(state, want_state))
            err = max(err, case_err)
            log(f"{label}: max |err| {case_err:.3g}; one launch, equal to "
                f"per-head copies")
            del y, state, y2, state2, want, want_state
            if (b, l, h, p, n, g) == SSD_GROUPED[-1][0]:
                flops, n_bytes = _ssd_work(x, a, B)
                bound, bound_by = bound_ms(n_bytes, flops, part, BF16_FLOPS)
                out.update({
                    "nemotron_ms": time_ms(
                        lambda: ssd_scan(x, a, B, C, return_state=True),
                        runs=10),
                    "nemotron_copies_ms": time_ms(
                        lambda: ssd_scan(x, a, *copies, return_state=True),
                        runs=10),
                    "nemotron_bound_ms": bound,
                    "nemotron_bound_by": bound_by,
                    "nemotron_shape": f"(b, l, h, p, n, g) = "
                                      f"{(b, l, h, p, n, g)} bf16"})
            del x, a, B, C, copies
    out["nemotron_max_abs_err"] = err
    return out


def check_moe_layer(gen) -> dict:
    """models.moe.moe_layer on the card at MOE_SHAPE (bf16, held experts
    from 0): every pair its router sends to a held expert is computed
    (moe.routed_pairs equals the pairs counted from ``route``), and y is
    the shared expert plus those pairs' weighted relu² experts, summed
    expert by expert in fp32 from the same bf16 inputs and weights, within
    MOE_REL_TOL of max |y|; its backward runs and gives finite
    gradients.  Logs a "moe_layer" JSON line."""
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_layer, route

    m = MOE_SHAPE
    cfg = get_config("nemotron-3-nano-30b-a3b").replace(
        d_model=m["D"], d_ff=m["F"], shared_expert_ff=m["Fs"],
        n_experts=m["E"], top_k=m["k"], held_experts=m["held"],
        dtype="bfloat16")
    bf = torch.bfloat16
    p = {"router": _randn((m["D"], m["E"]), gen) * m["D"] ** -0.5,
         "router_bias": torch.zeros(m["E"], device=gen.device),
         "up": (_randn((m["held"], m["D"], m["F"]), gen)
                * m["D"] ** -0.5).to(bf),
         "down": (_randn((m["held"], m["F"], m["D"]), gen)
                  * m["F"] ** -0.5).to(bf),
         "shared": {"up": (_randn((m["D"], m["Fs"]), gen)
                           * m["D"] ** -0.5).to(bf),
                    "down": (_randn((m["Fs"], m["D"]), gen)
                             * m["Fs"] ** -0.5).to(bf)}}
    x = _randn((1, m["T"], m["D"]), gen).to(bf)
    tracing.enable()
    try:
        with torch.no_grad():
            y = moe_layer(p, x, cfg)
        torch.cuda.synchronize()
    finally:
        tracing.enable(False)
    _, counts = tracing.drain()
    flat = x.reshape(-1, m["D"])
    with torch.no_grad():
        weights, experts = route(p, flat, cfg)
        relu2 = lambda t: torch.relu(t) ** 2  # noqa: E731
        want = relu2(flat.float() @ p["shared"]["up"].float()) \
            @ p["shared"]["down"].float()
        pairs = 0
        for e in range(m["held"]):
            tok, slot = (experts == e).nonzero(as_tuple=True)
            pairs += tok.numel()
            if tok.numel():
                h = relu2(flat[tok].float() @ p["up"][e].float())
                want.index_add_(0, tok, (h @ p["down"][e].float())
                                * weights[tok, slot, None])
    if counts.get("moe.routed_pairs") != pairs:
        raise RuntimeError(f"moe_layer: {counts.get('moe.routed_pairs')} "
                           f"routed pairs computed, the router sent {pairs}")
    gap = max_abs_err(y.reshape(-1, m["D"]).float(), want) / float(
        want.abs().max())
    if not gap < MOE_REL_TOL:
        raise RuntimeError(f"moe_layer: {gap:.3g} of max |y| from the "
                           f"expert-by-expert sum (tolerance {MOE_REL_TOL})")
    leaves = [p["up"], p["down"], p["shared"]["up"]]
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(moe_layer(p, x, cfg).float().square().mean(),
                                leaves)
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise RuntimeError("moe_layer: non-finite gradients")
    out = {"shape": m, "routed_pairs": pairs,
           "max_expert_rows": counts.get("moe.max_expert_rows"),
           "gap_over_max_y": gap, "tolerance": MOE_REL_TOL}
    log(json.dumps({"moe_layer": out}))
    return out


def _ssd_y_tol(want: torch.Tensor) -> dict:
    """The bound on the kernel's y: SSD_FP32_TOL in fp32; in bf16 one bf16
    ulp of max |y| plus SSD_BF16_ATOL."""
    if want.dtype == torch.float32:
        return dict(rtol=SSD_FP32_TOL, atol=SSD_FP32_TOL)
    return dict(rtol=0.0, atol=BF16_TOL["rtol"] * float(
        want.float().abs().max()) + SSD_BF16_ATOL)


def _ssd_work(x, a, B, q: int = 128):
    """(operations, bytes) of one scan: per token and head 2qn + 2qp for
    the masked products (counted in full, at the reference's chunk q) and
    4pn for the state's two products; x and y, a_dt, the final state and
    B and C (each group read once in place) moved once."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    flops = float(b * l * h) * (2 * q * n + 2 * q * p + 4 * p * n)
    bc_heads = 1 if B.stride(2) == 0 else B.shape[2]
    n_bytes = (2 * x.numel() * x.element_size() + 4 * a.numel()
               + 4 * b * h * p * n + 2 * b * l * bc_heads * n
               * B.element_size())
    return flops, n_bytes


def _ssd_pass_ms(fn, runs: int = 10) -> dict:
    """Device ms a call of each of the bf16 scan's three kernels, summed by
    name from torch.profiler over ``runs`` calls (None where the profiler
    saw none of them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(("chunk_state", "state_pass", "chunk_output"), 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in us:
                if f"{name}_kernel" in e.name:
                    us[name] += e.time_range.elapsed_us()
    if not all(us.values()):
        log(f"  the profiler saw no scan pass in {us}: passes not measured")
        return dict.fromkeys((f"{name}_ms" for name in us))
    return {f"{name}_ms": t / 1e3 / runs for name, t in us.items()}


def check_ssd_scan(gen, part: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_plain,
                                              workspace_floats)

    main_shapes = {}
    for cfg_name, batch, S, _ in SSM_SERVES:
        c = get_config(cfg_name)
        main_shapes[cfg_name] = (batch, S, c.ssm_heads, c.ssm_head_dim,
                                 c.ssm_state)
    # one prompt at mamba2-130m's width: the grid the chunk-parallel form
    # keeps full at b = 1
    main_shapes["mamba2-130m b1"] = (1,) + main_shapes["mamba2-130m"][1:]
    err = y_over_gate = 0.0
    for shape in SSD_SHAPES + tuple(main_shapes.values()):
        for dtype in (torch.float32, torch.bfloat16):
            for broadcast in (False, True):
                args = _ssd_inputs(shape, gen, dtype, broadcast)
                y, state = ssd_scan(*args, return_state=True)
                want, want_state = ssd_scan_plain(*args, return_state=True)
                torch.cuda.synchronize()
                label = (f"ssd_scan {str(dtype)[6:]} (b, l, h, p, n) = "
                         f"{shape} broadcast {broadcast}")
                torch.testing.assert_close(
                    y, want, **_ssd_y_tol(want),
                    msg=lambda m: f"{label}, y: {m}")
                torch.testing.assert_close(
                    state, want_state, rtol=SSD_FP32_TOL, atol=SSD_FP32_TOL,
                    msg=lambda m: f"{label}, state: {m}")
                case_err = max(max_abs_err(y, want),
                               max_abs_err(state, want_state))
                err = max(err, case_err)
                y_ratio = max_abs_err(y, want) / _ssd_y_tol(want)["atol"]
                if dtype == torch.bfloat16:
                    y_over_gate = max(y_over_gate, y_ratio)
                log(f"{label}: max |err| y {max_abs_err(y, want):.3g} "
                    f"({y_ratio:.3f} of its atol) state "
                    f"{max_abs_err(state, want_state):.3g}")
                del args, y, state, want, want_state

    grouped = _check_ssd_grouped(gen, part)

    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:84", **grouped}
    # the main path's calls: bf16, B and C broadcast over heads, the state
    for cfg_name, prefix in (("mamba2-130m", ""), ("zamba2-1.2b", "zamba_"),
                             ("mamba2-130m b1", "b1_")):
        args = _ssd_inputs(main_shapes[cfg_name], gen, torch.bfloat16, True)
        flops, n_bytes = _ssd_work(*args[:3])
        bound, bound_by = bound_ms(n_bytes, flops, part, BF16_FLOPS)
        bound32, _ = bound_ms(n_bytes, flops, part)
        row.update({
            f"{prefix}ms": time_ms(lambda: ssd_scan(*args, return_state=True),
                                   runs=10),
            f"{prefix}call_ms": time_ms(
                lambda: ssd_scan(*args, return_state=True), runs=10,
                hold=False),
            f"{prefix}plain_ms": time_ms(
                lambda: ssd_scan_plain(*args, return_state=True), runs=3,
                warmup=1),
            f"{prefix}bound_ms": bound, f"{prefix}bound_by": bound_by,
            f"{prefix}bound_fp32_ms": bound32, f"{prefix}gflop": flops / 1e9,
            f"{prefix}mbytes": n_bytes / 1e6,
            # the bf16 kernel's fp32 workspace (chunk states, decays),
            # written, read and rewritten, and read again
            f"{prefix}workspace_mbytes": 4 * workspace_floats(
                *main_shapes[cfg_name]) / 1e6,
            **{f"{prefix}{k}": v for k, v in _ssd_pass_ms(
                lambda: ssd_scan(*args, return_state=True)).items()},
        })
        del args
    row.update({
        "max_abs_err": err,
        "bf16_y_err_over_atol": y_over_gate,
        "library_ms": None,     # no single PyTorch call computes the scan
        "shape": (f"(b, l, h, p, n) = {main_shapes['mamba2-130m']} bf16, B/C "
                  f"broadcast over heads, return_state; zamba_ = "
                  f"{main_shapes['zamba2-1.2b']}; b1_ = "
                  f"{main_shapes['mamba2-130m b1']}"),
    })
    log(json.dumps({"kernel_check": row}))
    return row


# ------------------------------------------------------------ phase 3
def _train_loss(task, params, parts) -> float:
    """Mean cross-entropy of ``params`` over every client's training
    shard."""
    total, n = 0.0, 0
    for ds in parts.values():
        _, loss = task.evaluate(params, ds)
        total += loss * len(ds)
        n += len(ds)
    return total / n


def _check_platforms(label: str, trace_path: str, assignment: dict) -> None:
    """Every attempt of a multi-platform run names its client's provider,
    and every provider ran some."""
    attempts = [r for r in map(json.loads, Path(trace_path).read_text()
                               .splitlines()) if r["type"] == "attempt"]
    wrong = [r for r in attempts
             if r["platform"] != assignment[r["client_id"]]]
    if not attempts or wrong:
        raise RuntimeError(f"{label}: {len(wrong)} of {len(attempts)} "
                           f"attempts on the wrong platform")
    if {r["platform"] for r in attempts} != set(PLATFORMS):
        raise RuntimeError(f"{label}: not every platform ran")


def _check_ratios(label: str, trace_path: str, ratio) -> None:
    """Every merge of a compressed run carries the codec's ratio of dense
    to wire bytes, rounded as fl/controller.py rounds it."""
    merges = [r for r in map(json.loads, Path(trace_path).read_text()
                             .splitlines())
              if r["type"] == "aggregation" and r["merged"] > 0]
    if not merges:
        raise RuntimeError(f"{label}: no merge in the trace")
    got = {r.get("compression_ratio") for r in merges}
    if got != {ratio}:
        raise RuntimeError(f"{label}: compression ratios {got}, want "
                           f"{ratio}")


def run_main_path(label: str, ratio=None, meshes=None, cudnn: bool = True,
                  dataset: str = "femnist", platforms: bool = False,
                  nudge: bool = False, round_timeout_s: float = 120.0,
                  straggler_fraction: float = 0.3, setup=None,
                  **overrides) -> dict:
    """One FL run on "cuda" through run_experiment, the launch counts set
    to 0 just before it and read just after.  ``dataset`` picks the model
    at Table I's width (launch/train.build_dataset); ``platforms`` assigns
    the clients round-robin to PLATFORMS and checks that every attempt of
    the trace names its client's.  ``meshes`` = (merge mesh, executor
    mesh) are handed to run_experiment's own wiring (its make_host_mesh /
    make_clients_mesh return them) with merge_devices and
    executor_devices set to their sizes.  ``cudnn=False`` runs the
    convolutions in PyTorch's own kernels instead of cuDNN's; ``nudge``
    starts from the initial params moved up by one ulp each.  3 rounds
    of 120 s, MAIN_K clients a round, unless ``n_rounds``,
    ``round_timeout_s`` or ``clients_per_round`` say otherwise.  ``setup``
    = (task, parts, test_parts) replaces ``dataset``'s, which then only
    names the model (MODEL_P).  Peak device memory is printed too."""
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.fl import experiment
    from repro_torch.fl.client import ClientPool
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.train import build_dataset

    task, parts, test_parts = (build_dataset(dataset, n_clients=10)
                               if setup is None else setup)
    init = task.init_params(0)
    if nudge:
        init = tree_map(lambda t: torch.nextafter(
            t, torch.full_like(t, math.inf)), init)
    n_params = sum(t.numel() for t in tree_leaves(init))
    if n_params != MODEL_P[dataset]:
        raise RuntimeError(f"{task.model.name} has {n_params} params, not "
                           f"{MODEL_P[dataset]}")
    loss_before = _train_loss(task, init, parts)
    trace_dir = tempfile.TemporaryDirectory()
    trace_path = str(Path(trace_dir.name) / "trace.jsonl")
    if meshes is not None:
        overrides.update(merge_devices=meshes[0].size,
                         executor_devices=meshes[1].size)
    assignment = None
    if platforms:
        assignment = {cid: PLATFORMS[i % len(PLATFORMS)]
                      for i, cid in enumerate(sorted(parts))}
        overrides["platforms"] = assignment
    overrides.setdefault("n_rounds", 3)
    overrides.setdefault("clients_per_round", MAIN_K)
    overrides.setdefault("eval_every", 3)
    cfg = experiment.ExperimentConfig(
        scenario=experiment.ScenarioConfig(
            straggler_fraction=straggler_fraction,
            round_timeout_s=round_timeout_s),
        trace_path=trace_path, **overrides)
    # host time inside local training: the eager loop's local_train ends
    # by reading its loss back; the executor's batch_work_fn is followed
    # by a synchronize, so each span covers its device work
    # optimizer_steps: Optimizer.step calls, one a local step of a client
    # on the eager loop and of each mesh slot's slice on the executor
    spent = {"s": 0.0, "steps": 0, "client_steps": 0, "optimizer_steps": 0}

    def steps_of(ds):
        return task.config.epochs * -(-len(ds) // task.config.batch_size)

    local_train = task.local_train

    def timed_local_train(global_params, ds, **kw):
        t = time.perf_counter()
        out = local_train(global_params, ds, **kw)
        spent["s"] += time.perf_counter() - t
        spent["steps"] += steps_of(ds)
        spent["client_steps"] += steps_of(ds)
        spent["optimizer_steps"] += steps_of(ds)
        return out

    batch_work_fn = ClientPool.batch_work_fn

    def timed_batch_work_fn(pool, cids, global_params, round_number):
        t = time.perf_counter()
        out = batch_work_fn(pool, cids, global_params, round_number)
        torch.cuda.synchronize()
        spent["s"] += time.perf_counter() - t
        mesh = pool.executor.mesh
        for group in pool.executor._group(pool, cids).values():
            steps = steps_of(pool.clients[group[0]].dataset)
            spent["steps"] += steps
            spent["optimizer_steps"] += steps * (1 if mesh is None
                                                 else mesh.size)
        spent["client_steps"] += sum(steps_of(pool.clients[c].dataset)
                                     for c in cids)
        return out

    task.local_train = timed_local_train
    ClientPool.batch_work_fn = timed_batch_work_fn
    mesh_makers = (experiment.make_host_mesh, experiment.make_clients_mesh)
    if meshes is not None:
        experiment.make_host_mesh = lambda *a, **k: meshes[0]
        experiment.make_clients_mesh = lambda *a, **k: meshes[1]
    torch.backends.cudnn.enabled = cudnn
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        params, res = experiment.run_experiment(
            task, parts, test_parts, cfg, initial_params=init,
            device="cuda", return_params=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in KERNELS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.backends.cudnn.enabled = True
        ClientPool.batch_work_fn = batch_work_fn
        experiment.make_host_mesh, experiment.make_clients_mesh = \
            mesh_makers
    adam_a_step = (adam_launches_a_step(init)
                   if task.config.optimizer in ("adam", "adamw") else 0)
    if launches["adam"] != spent["optimizer_steps"] * adam_a_step:
        raise RuntimeError(f"{label}: {launches['adam']} adam launches for "
                           f"{spent['optimizer_steps']} optimizer steps of "
                           f"{adam_a_step} launches")
    if ratio is not None:
        _check_ratios(label, trace_path, ratio)
    if assignment is not None:
        _check_platforms(label, trace_path, assignment)
    trace = Path(trace_path).read_bytes()
    trace_dir.cleanup()
    leaves = tree_leaves(params)
    if not all(t.device.type == "cuda" for t in leaves):
        raise RuntimeError(f"{label}: a param left the card")
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        raise RuntimeError(f"{label}: non-finite params")
    loss_after = _train_loss(task, params, parts)
    if not math.isfinite(loss_after):
        raise RuntimeError(f"{label}: training loss {loss_after}")
    if dataset not in CHAOTIC and not loss_after < loss_before:
        raise RuntimeError(f"{label}: training loss did not fall "
                           f"({loss_before:.4f} -> {loss_after:.4f})")
    vectorized = (cfg.vectorized if cfg.vectorized is not None else True)
    out = {"run": label, "dataset": dataset, "params": n_params,
           "path": "executor" if vectorized else "eager",
           "rounds": len(res.rounds), "wall_s": wall,
           "wall_s_per_round": wall / len(res.rounds),
           "final_accuracy": res.final_accuracy, "mean_eur": res.mean_eur,
           "virtual_duration_s": res.total_duration_s,
           "train_loss_before": loss_before, "train_loss_after": loss_after,
           "merged_updates": [r.aggregated_updates for r in res.rounds],
           "local_train_s": spent["s"], "local_steps": spent["steps"],
           "client_steps": spent["client_steps"],
           "optimizer_steps": spent["optimizer_steps"],
           "adam_launches_a_step": adam_a_step,
           "ms_per_local_step": 1e3 * spent["s"] / max(1, spent["steps"]),
           "local_share_of_wall": spent["s"] / wall, "peak_gb": peak_gb,
           "compression_ratio": ratio, "launches": launches}
    log(json.dumps({"main_path": out}))
    out.update(_params=params, _trace=trace,
               _rounds=[(r.selected, r.successes, r.eur) for r in res.rounds])
    return out


def _param_gap(a: dict, b: dict) -> dict:
    """How far two runs' final params are apart: max |a - b|, the share of
    values more than 1e-4 apart, and ‖a - b‖ / ‖b‖."""
    from repro_torch.core.flatten import flatten_params

    fa, fb = flatten_params(a["_params"])[0], flatten_params(b["_params"])[0]
    diff = (fa - fb).abs()
    return {"runs": [a["run"], b["run"]], "max_abs": float(diff.max()),
            "share_over_1e-4": float((diff > 1e-4).float().mean()),
            "rel_l2": float(diff.norm() / fb.norm())}


def check_runs_agree(a: dict, b: dict, floor: dict = None,
                     same_trace: bool = True,
                     param_bound: float = FL_PARAM_REL_L2) -> dict:
    """Two FL runs of one configuration on two paths: per round the same
    cohort, successes and EUR; the same trace bytes where ``same_trace``;
    training losses after the run within FL_LOSS_RTOL and final params
    within FL_PARAM_REL_L2, printed beside the ``floor`` gap (the eager
    loop against itself with cuDNN off).  The paths round the
    convolutions' sums differently, and 315 local Adam steps a client
    turn such differences into step-sized ones wherever a gradient is
    near zero (ROADMAP Queue 3), so the params are held to the measured
    spread of that rounding, not to fp32 precision."""
    if a["_rounds"] != b["_rounds"]:
        raise RuntimeError(f"{a['run']} and {b['run']}: rounds differ: "
                           f"{a['_rounds']} vs {b['_rounds']}")
    if same_trace and a["_trace"] != b["_trace"]:
        raise RuntimeError(f"{a['run']} and {b['run']}: traces differ")
    gap = _param_gap(a, b)
    gap["train_loss_after"] = [a["train_loss_after"], b["train_loss_after"]]
    if floor is not None:
        gap["floor_rel_l2"] = floor["rel_l2"]
    gap["param_bound"] = param_bound
    log(json.dumps({"runs_agree": gap}))
    if abs(a["train_loss_after"] - b["train_loss_after"]) > (
            FL_LOSS_RTOL * b["train_loss_after"]):
        raise RuntimeError(f"training losses apart beyond {FL_LOSS_RTOL}: "
                           f"{gap}")
    if gap["rel_l2"] > param_bound:
        raise RuntimeError(f"final params apart beyond {param_bound} "
                           f"(relative L2): {gap}")
    return gap


def check_executor_full_width() -> dict:
    """The vectorized executor against the eager loop at full width: one
    round's MAIN_K clients, one local epoch with local SGD (lr 0.01, so
    that no Adam step amplifies rounding), client by client.  With cuDNN
    off both paths run PyTorch's own convolutions and must agree within
    EXEC_TOL; with cuDNN on, cuDNN picks other algorithms for the grouped
    convolutions vmap makes than for the eager ones, and only the losses
    are held (EXEC_LOSS_TOL), the params' gap is reported."""
    from repro_torch.core.flatten import flatten_params
    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.launch.train import build_dataset

    full_task, parts, _ = build_dataset("femnist", n_clients=10)
    task = ClassificationTask(full_task.model,
                              TaskConfig(epochs=1, batch_size=10,
                                         optimizer="sgd",
                                         learning_rate=0.01),
                              device="cuda")
    pool = ClientPool(task, parts, None, seed=0)
    cids = pool.client_ids[:MAIN_K]
    params = task.init_params(0)
    seeds = [pool.client_seed(c, 0) for c in cids]
    out = {"clients": len(cids), "tol": EXEC_TOL,
           "loss_tol": EXEC_LOSS_TOL}
    # the process's first executor call (cuDNN's plans for the grouped
    # convolutions, functorch's first dispatch) against a second one
    for key in ("first_call_s", "second_call_s"):
        t0 = time.perf_counter()
        VectorizedExecutor(task).run_group(cids, [parts[c] for c in cids],
                                           params, 0.0, seeds)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    executor = VectorizedExecutor(task)
    for cudnn in (False, True):
        torch.backends.cudnn.enabled = cudnn
        try:
            got = executor.run_group(
                cids, [parts[c] for c in cids], params, 0.0, seeds)
            err, loss_err = 0.0, 0.0
            for cid, seed in zip(cids, seeds):
                want, want_loss = task.local_train(params, parts[cid],
                                                   seed=seed)
                a, b = flatten_params(got[cid][0])[0], flatten_params(want)[0]
                err = max(err, max_abs_err(a, b))
                loss_err = max(loss_err, abs(got[cid][1] - want_loss))
                if not cudnn:
                    torch.testing.assert_close(a, b, **EXEC_TOL)
        finally:
            torch.backends.cudnn.enabled = True
        key = "cudnn" if cudnn else "cudnn_off"
        out[key] = {"max_abs_err": err, "max_loss_err": loss_err}
        if loss_err > EXEC_LOSS_TOL:
            raise RuntimeError(f"executor losses {loss_err} from the eager "
                               f"loop ({key})")
    log(json.dumps({"executor_vs_eager_full_width": out}))
    check_executor_syncs(executor, cids, [parts[c] for c in cids], params,
                         seeds)
    return out


@contextlib.contextmanager
def _recording_syncs(sites: list):
    """torch.cuda.set_sync_debug_mode("warn") inside the block; each
    "synchronizing CUDA operation" warning is appended to ``sites`` as
    the file:line that raised it and the innermost src/repro_torch frame
    that led there.  An inner block records its own warnings only."""
    import traceback
    import warnings

    def hook(message, category, filename, lineno, file=None, line=None):
        # not the mode's one-time "prototype feature" notice
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if "repro_torch" in f.filename]
        site = f"{'/'.join(Path(filename).parts[-2:])}:{lineno}"
        if ours:
            site += f" from {Path(ours[-1].filename).name}:{ours[-1].lineno}"
        sites.append(site)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def check_executor_syncs(executor, cids, datasets, params, seeds) -> dict:
    """TORCH001 held on the card: one more dispatch of the warmed
    executor (MAIN_K full-width FEMNIST clients, one local epoch) with
    torch.cuda.set_sync_debug_mode("warn") around each
    vmap(grad_and_value(...)) call only; no such call may synchronize
    with the host.  The count over the whole _train_slices loop (the
    step calls plus the proximal term, the optimizer and the loss stack
    between them) is printed, not gated.  First the instrument itself:
    one .item() inside it must count once."""
    import collections
    from repro_torch.fl import executor as executor_mod

    probe = []
    with _recording_syncs(probe):
        torch.ones(1, device="cuda").sum().item()
    if len(probe) != 1:
        raise RuntimeError(f"the sync recorder saw {len(probe)} syncs for "
                           f"one .item()")
    inside, loop, calls = [], [], [0]
    real_vmap, real_train = executor_mod.vmap, executor._train_slices

    def watched_vmap(fn, *args, **kwargs):
        step = real_vmap(fn, *args, **kwargs)

        def call(*a, **kw):
            calls[0] += 1
            with _recording_syncs(inside):
                return step(*a, **kw)
        return call

    def watched_train(*args, **kwargs):
        with _recording_syncs(loop):
            return real_train(*args, **kwargs)

    executor_mod.vmap, executor._train_slices = watched_vmap, watched_train
    try:
        executor.run_group(cids, datasets, params, 0.0, seeds)
        torch.cuda.synchronize()
    finally:
        executor_mod.vmap = real_vmap
        del executor._train_slices
    out = {"clients": len(cids), "vmapped_calls": calls[0],
           "syncs_in_vmapped_calls": len(inside),
           "syncs_in_train_slices": len(inside) + len(loop),
           "train_slices_sync_sites": dict(collections.Counter(
               inside + loop))}
    log(json.dumps({"executor_syncs": out}))
    if calls[0] < 1:
        raise RuntimeError("the executor made no vmapped call")
    if inside:
        raise RuntimeError(f"{len(inside)} synchronizing CUDA operations "
                           f"inside the executor's vmapped calls: "
                           f"{collections.Counter(inside)}")
    return out


def profile_local_training() -> dict:
    """One client's local training (full-width FEMNIST CNN) under
    torch.profiler: how much of a step the card spends in kernels.  The
    profiler adds host time, so the busy share it shows is a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_dataset

    task, parts, _ = build_dataset("femnist", n_clients=10)
    ds = parts[sorted(parts)[0]]
    params = task.init_params(0)
    task.local_train(params, ds, seed=1)          # warm-up
    steps = task.config.epochs * -(-len(ds) // task.config.batch_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.local_train(params, ds, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _profile_summary(prof, steps, wall)
    log(json.dumps({"local_training_profile": out}))
    return out


def _profile_summary(prof, steps: int, wall: float) -> dict:
    """Per step: the card's kernels (busy time, operations, the largest by
    name) and the host's operations by self time.  A record_function span
    shows on the card as an annotation over its kernels: counted apart
    (``spans_ms_per_step``), not as busy time."""
    on_card, spans = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if (getattr(e, "is_user_annotation", False)
                or e.name == "ssd_scan_plain_backward"):
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us()
        else:
            on_card.append(e)
    busy_us = sum(e.time_range.elapsed_us() for e in on_card)
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ops_per_step": len(on_card) / steps,
            "top_ms_per_step": [[name[:80], us / 1e3 / steps]
                                for name, us in top],
            "spans_ms_per_step": {name: us / 1e3 / steps
                                  for name, us in spans.items()},
            "host_top_ms_per_step": [
                [a.key[:60], a.self_cpu_time_total / 1e3 / steps,
                 a.count / steps] for a in host[:6]]}


def profile_vectorized_round(dataset: str = "femnist",
                             epochs: int = None, setup=None,
                             clients: int = MAIN_K) -> dict:
    """One round's cohort (``clients`` clients, a full-width model,
    FEMNIST's CNN by default) through the vectorized executor under
    torch.profiler: device operations and busy time per executor step (one
    step trains all K clients).  ``epochs`` shortens the round (the steps
    are alike); ``setup`` = (task, parts, _) replaces ``dataset``'s."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.tasks import ClassificationTask
    from repro_torch.launch.train import build_dataset

    task, parts, _ = (build_dataset(dataset, n_clients=10) if setup is None
                      else setup)
    if epochs is not None:
        task = ClassificationTask(task.model,
                                  replace(task.config, epochs=epochs),
                                  device=task.device)
    pool = ClientPool(task, parts, None, seed=0)
    cids = pool.client_ids[:clients]
    params = task.init_params(0)
    pool.batch_work_fn(cids, params, 0)           # warm-up
    steps = sum(task.config.epochs * -(-len(pool.clients[g[0]].dataset)
                                       // task.config.batch_size)
                for g in pool.executor._group(pool, cids).values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pool.batch_work_fn(cids, params, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = dict(_profile_summary(prof, steps, wall), clients=len(cids),
               dataset=dataset)
    log(json.dumps({"vectorized_round_profile": out}))
    return out


def check_merge_launches(run: dict, model_kernels=()) -> None:
    """An identity-merge run launches fed_agg once a merge, and no other
    kernel but the model's own (``model_kernels``) and the clients' local
    Adam (``adam``, whose count run_main_path holds to the run's optimizer
    steps)."""
    merges = sum(1 for m in run["merged_updates"] if m)
    launches = run["launches"]
    if merges < 1 or launches["fed_agg"] != merges:
        raise RuntimeError(f"{run['run']}: {launches['fed_agg']} fed_agg "
                           f"launches for {merges} merges")
    others = {k: n for k, n in launches.items()
              if k not in ("fed_agg", "adam", *model_kernels) and n}
    if others:
        raise RuntimeError(f"{run['run']}: other kernels launched: {others}")


def check_lstm_executor_full_width() -> dict:
    """The vectorized executor against the eager loop on the full-width
    char-LSTM, client by client: one round's MAIN_K clients with Table I's
    local SGD (lr 0.8, one epoch of 32-sample batches) from the same
    params.  Within LSTM_EXEC_TOL: the batched matmuls may sum in another
    order, and one round does not yet amplify that (three do; see
    run_small_models)."""
    from repro_torch.core.flatten import flatten_params
    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.launch.train import build_dataset

    task, parts, _ = build_dataset("shakespeare", n_clients=10)
    pool = ClientPool(task, parts, None, seed=0)
    cids = pool.client_ids[:MAIN_K]
    params = task.init_params(0)
    executor = VectorizedExecutor(task)
    out = {"clients": len(cids), "tol": LSTM_EXEC_TOL, "max_abs_err": 0.0,
           "max_rel_l2": 0.0, "max_loss_err": 0.0}
    for group in executor._group(pool, cids).values():
        seeds = [pool.client_seed(c, 0) for c in group]
        got = executor.run_group(group, [parts[c] for c in group], params,
                                 0.0, seeds)
        for cid, seed in zip(group, seeds):
            want, want_loss = task.local_train(params, parts[cid], seed=seed)
            a, b = flatten_params(got[cid][0])[0], flatten_params(want)[0]
            out["max_abs_err"] = max(out["max_abs_err"], max_abs_err(a, b))
            out["max_rel_l2"] = max(out["max_rel_l2"],
                                    float((a - b).norm() / b.norm()))
            out["max_loss_err"] = max(out["max_loss_err"],
                                      abs(got[cid][1] - want_loss))
    log(json.dumps({"lstm_executor_vs_eager_full_width": out}))
    if not (out["max_rel_l2"] <= LSTM_EXEC_TOL["rel_l2"]
            and out["max_loss_err"] <= LSTM_EXEC_TOL["loss"]):
        raise RuntimeError(f"the LSTM executor is apart from the eager "
                           f"loop: {out}")
    return out


def run_small_models() -> dict:
    """The paper's other two models at Table I's width, FedLesScan over
    3 rounds on the executor (the card's default) and on the eager loop:
    the char-LSTM (818,402 params, local SGD at lr 0.8) and the speech CNN
    (67,267 params, local Adam).  Per round the same cohorts, EUR and
    trace bytes; fed_agg once a merge.  The speech CNN's params within
    the FEMNIST runs' FL_PARAM_REL_L2.  The char-LSTM's training is
    chaotic at lr 0.8 (CHAOTIC): its params are held within
    LSTM_PARAM_REL_L2 beside the floor of the eager loop against itself
    from initial params one ulp apart, printed."""
    out = {}
    floor = None
    for dataset in ("shakespeare", "speech"):
        executor = run_main_path(f"{dataset} fedlesscan", dataset=dataset)
        eager = run_main_path(f"{dataset} fedlesscan (eager)",
                              dataset=dataset, vectorized=False)
        bound = FL_PARAM_REL_L2
        if dataset in CHAOTIC:
            nudged = run_main_path(f"{dataset} fedlesscan (eager, init + 1 "
                                   f"ulp)", dataset=dataset,
                                   vectorized=False, nudge=True)
            floor = check_runs_agree(nudged, eager,
                                     param_bound=LSTM_PARAM_REL_L2)
            bound = LSTM_PARAM_REL_L2
        gap = check_runs_agree(executor, eager, floor, param_bound=bound)
        for run in (executor, eager):
            check_merge_launches(run)
        out[dataset] = {"executor": executor, "eager": eager, "gap": gap}
    return out


def check_speech_dropout() -> dict:
    """The speech CNN's training-time dropout on the card: one forward at
    Table I's width (P = 67,267; batch 5 of 32 x 32 x 1) with a CUDA
    generator at rate 0.25.  Each block's dropped share within 4 sigma of
    the rate; kept values exactly h / 0.75 and dropped ones 0, the first
    block's h equal to the model's without dropout; rate 0 equal to
    dropout_rng=None bit for bit."""
    from repro_torch.models import small

    model = small.make_speech_cnn()
    params = model.init(0, torch.device("cuda"))
    n_params = sum(t.numel() for p in params.values() for t in p.values())
    if n_params != MODEL_P["speech"]:
        raise RuntimeError(f"speech CNN has {n_params} params")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((5, 32, 32, 1), generator=gen, device="cuda")
    calls, plain = [], small.dropout_plain

    def recording(h, keep, rate):
        out = plain(h, keep, rate)
        calls.append((h, keep, out))
        return out

    rate = 0.25
    small.dropout_plain = recording
    try:
        none = model.apply(params, x)
        zero = model.apply(params, x, rate=0.0, dropout_rng=torch.Generator(
            device="cuda").manual_seed(1))
        undropped = calls[0][0]
        calls.clear()
        dropped = model.apply(params, x, rate=rate,
                              dropout_rng=torch.Generator(
                                  device="cuda").manual_seed(1))
    finally:
        small.dropout_plain = plain
    out = {"params": n_params, "rate": rate,
           "rate0_equals_none": bool(torch.equal(zero, none)),
           "logits_finite": bool(torch.isfinite(dropped).all()),
           "blocks": []}
    if not out["rate0_equals_none"] or not out["logits_finite"]:
        raise RuntimeError(f"speech dropout: {out}")
    if len(calls) != 2 or not torch.equal(calls[0][0], undropped):
        raise RuntimeError("speech dropout: the first block's activations "
                           "differ from the model's without dropout")
    for h, keep, got in calls:
        n = keep.numel()
        share = 1.0 - float(keep.float().mean())
        sigma = math.sqrt(rate * (1 - rate) / n)
        block = {"shape": list(h.shape), "dropped_share": share,
                 "sigmas": abs(share - rate) / sigma,
                 "kept_exact": bool(torch.equal(got[keep],
                                                h[keep] / (1 - rate))),
                 "dropped_zero": not bool(got[~keep].any())}
        out["blocks"].append(block)
        if (block["sigmas"] > 4 or not block["kept_exact"]
                or not block["dropped_zero"]):
            raise RuntimeError(f"speech dropout block: {block}")
    log(json.dumps({"speech_dropout": out}))
    return out


def run_platforms() -> dict:
    """FEMNIST FedLesScan with the clients round-robin on three providers
    (faas/profiles.py), on the executor and on the eager loop: every
    attempt on its client's platform, the same trace bytes, params within
    FL_PARAM_REL_L2."""
    executor = run_main_path("femnist fedlesscan+platforms", platforms=True)
    eager = run_main_path("femnist fedlesscan+platforms (eager)",
                          platforms=True, vectorized=False)
    gap = check_runs_agree(executor, eager)
    for run in (executor, eager):
        check_merge_launches(run)
    return {"executor": executor, "eager": eager, "gap": gap}


def check_checkpoint_resume() -> dict:
    """Semi-async FedLesScan on the char-LSTM through the executor: 3
    rounds checkpointing every round against 2 rounds checkpointed and
    resumed to the third.  Rounds of 30 s, so that a slow client's update
    is in flight at the checkpoint.  The resumed trace is the
    uninterrupted one's tail byte for byte, its rounds the same, its
    params within RESUME_PARAM_REL_L2 (printed)."""
    kw = dict(dataset="shakespeare", mode="semi-async", round_timeout_s=30.0)
    with tempfile.TemporaryDirectory() as tmp:
        full = run_main_path("shakespeare semi-async checkpointed",
                             checkpoint_dir=f"{tmp}/full",
                             checkpoint_every=1, **kw)
        run_main_path("shakespeare semi-async stopped after round 2",
                      n_rounds=2, checkpoint_dir=f"{tmp}/cut",
                      checkpoint_every=1, **kw)
        state = json.loads(Path(f"{tmp}/cut/round_000002.json").read_text())
        in_flight = sum(len(r["work"]) for r in state["engine"]["rounds"])
        resumed = run_main_path("shakespeare semi-async resumed",
                                resume_from=f"{tmp}/cut", **kw)
    tail = b"".join(full["_trace"].splitlines(keepends=True)
                    [state["trace_offset"]:])
    if resumed["_trace"] != tail:
        raise RuntimeError("the resumed trace is not the uninterrupted "
                           "run's tail")
    if resumed["_rounds"] != full["_rounds"][2:]:
        raise RuntimeError(f"resumed rounds {resumed['_rounds']} differ "
                           f"from {full['_rounds'][2:]}")
    check_merge_launches(resumed)
    gap = dict(_param_gap(resumed, full), bound=RESUME_PARAM_REL_L2,
               cached_updates_at_checkpoint=in_flight,
               trace_offset=state["trace_offset"])
    log(json.dumps({"checkpoint_resume": gap}))
    if gap["rel_l2"] > RESUME_PARAM_REL_L2:
        raise RuntimeError(f"resumed params apart beyond "
                           f"{RESUME_PARAM_REL_L2}: {gap}")
    return gap


def check_merge_sizes(gen, part: str, runs) -> list:
    """fed_agg at every (K, P) that the runs merged, bit for bit against
    its plain version, and timed."""
    sizes = sorted({(k, run["params"]) for run in runs
                    for k in run["merged_updates"] if k})
    return [dict(check_fed_agg_at(gen, part, K, P), K=K, P=P)
            for K, P in sizes]


def _fed_ssm_task(dtype: str = None):
    """examples/federated_pretrain.py's task with its ModelDef over the
    full FED_SSM_ARCH config (activations in ``dtype`` if given), on
    "cuda"."""
    from repro_torch.configs import get_config
    from repro_torch.examples import federated_pretrain
    from repro_torch.fl.tasks import ClassificationTask

    cfg = get_config(FED_SSM_ARCH)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = federated_pretrain.cfg_as_model(cfg, f"{FED_SSM_ARCH}-lm")
    return ClassificationTask(model, federated_pretrain.TASK, device="cuda")


def check_ssm_executor_grads(parts) -> dict:
    """The first step of one executor group (4 clients, the example's
    cohort), its first FED_SSM_GRAD_CLIENTS clients one by one: the
    vmapped grads (the scan in the kernel
    under the vmap rule, one folded launch a layer) against the eager
    loop's (autograd, remat, the kernel unfolded) on each client's first
    batch, every scan call of the vmapped step held against the plain
    scan on the same folded inputs (_ssd_checked_per_call).  In fp32,
    check_train_grads' rule, with the matmuls' sums regrouped beside the
    scan's: every leaf within TRAIN_GRAD_FACTOR times the larger of what
    regrouping the plain scan's sums (chunks of FED_SSM_REGROUP_CHUNK
    against the sequence's 32) and what taking the batch in two halves
    (other GEMM shapes, so other cuBLAS sums) move the eager grads by.
    The executor's batched GEMMs differ from the eager loop's as the
    halves do: on an H100 80GB HBM3 (700 W) the scan's regrouping alone
    moved the grads by about half of the gap between the two paths.  In
    bf16 (the run's activations) the vmapped and the plain matmuls round
    each product to bf16 in their own way, which moves the grads far
    more; there every leaf is held within TRAIN_GRAD_FACTOR times what
    computing in bf16 at all moves the eager grads by (bf16 against fp32
    activations)."""
    from torch.func import grad_and_value, vmap

    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map, tree_paths
    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.executor import VectorizedExecutor, _bucket
    from repro_torch.kernels import reset_launches, ssd_scan

    n_layers = get_config(FED_SSM_ARCH).n_layers
    out, fp32_grads = {}, []
    for dtype in ("float32", "bfloat16"):
        task = _fed_ssm_task(dtype)
        params = task.init_params(0)
        pool = ClientPool(task, parts, None, seed=0)
        cids = pool.client_ids[:4]
        ex = VectorizedExecutor(task)
        xs, ys, ms = ex._stage([pool.clients[c].dataset for c in cids],
                               [pool.client_seed(c, 0) for c in cids],
                               _bucket(len(cids)))
        x, y, m = (torch.from_numpy(a[:, 0]).cuda() for a in (xs, ys, ms))
        stacked = tree_map(lambda t: t.unsqueeze(0).expand(
            len(cids), *t.shape).clone(), params)
        reset_launches()
        per_call = {"calls": 0, "max_err_y": 0.0, "max_err_state": 0.0}
        with _ssd_checked_per_call(per_call):
            grads, losses = vmap(grad_and_value(ex._masked_loss))(
                stacked, x, y, m)
        torch.cuda.synchronize()
        launches = ssd_scan.launches
        if per_call["calls"] != launches or launches != n_layers:
            raise RuntimeError(f"federated ssm {dtype} step: "
                               f"{per_call['calls']} scan calls checked of "
                               f"{launches} launches, {n_layers} layers")

        def eager_grads(k, halves=False):
            """Client k's grads as the eager loop takes them; with
            ``halves`` its batch in two halves, each weighted by its
            share of the samples."""
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            parts = ((slice(0, 8), slice(8, None)) if halves
                     else (slice(None),))
            total = 0.0
            for rows in parts:
                share = m[k][rows].sum() / m[k].sum()
                loss = ex._masked_loss(leaves, x[k][rows], y[k][rows],
                                       m[k][rows]) * share
                loss.backward()
                total += float(loss.detach())
            return total, tree_map(lambda t: t.grad, leaves)

        worst, clients = 0.0, []
        for k in range(FED_SSM_GRAD_CLIENTS):
            loss, eager = eager_grads(k)
            if dtype == "float32":
                with _ssd_in_plain_version():
                    _, base = eager_grads(k)
                with _ssd_in_plain_version(tile=FED_SSM_REGROUP_CHUNK):
                    _, moved = eager_grads(k)
                _, halved = eager_grads(k, halves=True)
                spreads = [(base, moved), (eager, halved)]
                fp32_grads.append(eager)
            else:
                spreads = [(fp32_grads[k], eager)]
            client = {"loss": loss, "executor_loss": float(losses[k]),
                      "worst_rel_l2_over_bound": 0.0}
            spread_leaves = list(zip(*(
                [_rel_l2(mv_t, b_t) for (_, b_t), (_, mv_t) in
                 zip(tree_paths(b), tree_paths(mv))] for b, mv in spreads)))
            for ((path, g), (_, e)), leaf_spreads in zip(
                    zip(tree_paths(grads), tree_paths(eager)),
                    spread_leaves):
                if not bool(torch.isfinite(g[k]).all()):
                    raise RuntimeError(f"federated ssm {dtype}: non-finite "
                                       f"executor grads at "
                                       f"{'/'.join(path)}")
                got, spread = _rel_l2(g[k], e), max(leaf_spreads)
                ratio = (got / (TRAIN_GRAD_FACTOR * spread) if spread
                         else 0.0 if got == 0.0 else math.inf)
                if ratio >= client["worst_rel_l2_over_bound"]:
                    client.update(worst_rel_l2_over_bound=ratio,
                                  worst_leaf="/".join(path), rel_l2=got,
                                  spread_rel_l2=list(leaf_spreads))
            clients.append(client)
            worst = max(worst, client["worst_rel_l2_over_bound"])
        out[dtype] = {"clients": clients, "ssd_launches": launches,
                      "per_call_check": per_call,
                      "spread": ("regrouping the plain scan or the batch"
                                 if dtype == "float32"
                                 else "bf16 against fp32"),
                      "worst_rel_l2_over_bound": worst}
        del grads, stacked
    log(json.dumps({"federated_ssm_grads": out}))
    for dtype, res in out.items():
        if not res["worst_rel_l2_over_bound"] <= 1.0:
            raise RuntimeError(
                f"federated ssm {dtype}: executor grads differ from the "
                f"eager loop's by {res['worst_rel_l2_over_bound']:.4g} of "
                f"the bound ({TRAIN_GRAD_FACTOR} x the spread of "
                f"{res['spread']})")
    return out


def run_federated_ssm(gen, part: str) -> dict:
    """examples/federated_pretrain.py's experiment at the full width and
    depth of mamba2-130m on the card's default path, the vectorized
    executor (every Mamba block's scan in the kernel under the vmap rule,
    fed_agg once a merge at P = 128,983,488), then on the eager loop: the
    same trace and cohorts and the losses held as check_runs_agree holds
    the FEMNIST runs, the params within FED_SSM_PARAM_FACTOR times the
    spread of the executor from initial params one ulp apart (a third
    run).  Before the runs one
    executor step client by client (check_ssm_executor_grads); after
    them one executor round profiled and fed_agg bit for bit and timed
    at the bucket's (K, P)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import federated_pretrain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    parts, test_parts = federated_pretrain.build_experiment(FED_SSM_CLIENTS)
    grads = check_ssm_executor_grads(parts)
    setup = (_fed_ssm_task(), parts, test_parts)
    config = federated_pretrain.config(FED_SSM_ROUNDS, FED_SSM_STRAGGLERS)
    kw = dict(dataset=FED_SSM_ARCH, setup=setup, strategy=config.strategy,
              n_rounds=config.n_rounds,
              clients_per_round=config.clients_per_round,
              eval_every=config.eval_every,
              straggler_fraction=config.scenario.straggler_fraction,
              round_timeout_s=config.scenario.round_timeout_s)
    executor = run_main_path("federated ssm", **kw)
    eager = run_main_path("federated ssm (eager)", vectorized=False, **kw)
    nudged = run_main_path("federated ssm (init + 1 ulp)", nudge=True, **kw)
    floor = check_runs_agree(nudged, executor, param_bound=math.inf)
    gap = check_runs_agree(executor, eager, floor,
                           param_bound=FED_SSM_PARAM_FACTOR * floor["rel_l2"])
    steps = executor["local_steps"]
    if executor["launches"]["ssd_scan"] < steps * get_config(
            FED_SSM_ARCH).n_layers:
        raise RuntimeError(f"federated ssm: {executor['launches']} for "
                           f"{steps} executor steps")
    for run in (executor, eager, nudged):
        check_merge_launches(run, model_kernels=("ssd_scan",))
    profile = profile_vectorized_round(FED_SSM_ARCH, setup=setup, clients=4)
    bucket = config.clients_per_round
    # the scan at the executor's folded shape: bf16, B/C head-broadcast
    cfg = get_config(FED_SSM_ARCH)
    folded = (bucket * federated_pretrain.TASK.batch_size,
              parts["client_0"].x.shape[1], cfg.ssm_heads, cfg.ssm_head_dim,
              cfg.ssm_state)
    args = _ssd_inputs(folded, gen, torch.bfloat16, True)
    flops, n_bytes = _ssd_work(*args[:3])
    scan = {"shape": f"(b, l, h, p, n) = {folded} bf16, B/C broadcast",
            "ms": time_ms(lambda: ssd_scan(*args, return_state=True),
                          runs=10),
            "plain_ms": time_ms(
                lambda: ssd_scan_plain(*args, return_state=True), runs=3,
                warmup=1),
            "bound_ms": bound_ms(n_bytes, flops, part, BF16_FLOPS)[0],
            "bound_by": bound_ms(n_bytes, flops, part, BF16_FLOPS)[1]}
    del args
    merge = dict(check_fed_agg_at(gen, part, bucket,
                                  MODEL_P[FED_SSM_ARCH]),
                 K=bucket, P=MODEL_P[FED_SSM_ARCH])
    out = {"arch": FED_SSM_ARCH, "params": executor["params"],
           "executor_wall_s_per_round": executor["wall_s_per_round"],
           "eager_wall_s_per_round": eager["wall_s_per_round"],
           "executor_ms_per_step": executor["ms_per_local_step"],
           "executor_steps": steps,
           "eager_ms_per_client_step": eager["ms_per_local_step"],
           "profiled_ms_per_step": profile["wall_ms_per_step"],
           "device_ops_per_step": profile["device_ops_per_step"],
           "device_busy_ms_per_step": profile["device_busy_ms_per_step"],
           "device_busy_share": profile["device_busy_share"],
           "scan_plain_backward_span_ms_per_step": profile[
               "spans_ms_per_step"].get("ssd_scan_plain_backward"),
           "executor_peak_gb": executor["peak_gb"],
           "eager_peak_gb": eager["peak_gb"],
           "executor_launches": executor["launches"],
           "eager_launches": eager["launches"],
           "scan_shapes": grads["bfloat16"]["per_call_check"]["shapes"],
           "scan_at_folded_shape": scan,
           "params_rel_l2": gap["rel_l2"],
           "floor_params_rel_l2": floor["rel_l2"], "fed_agg": merge,
           "train_loss": [executor["train_loss_before"],
                          executor["train_loss_after"],
                          eager["train_loss_after"]],
           "final_accuracy": [executor["final_accuracy"],
                              eager["final_accuracy"]]}
    log(json.dumps({"federated_ssm": out}))
    return out


def run_example_clis() -> dict:
    """The example CLIs of EXAMPLE_RUNS once each, as subprocesses on the
    card (their default device): each must exit 0; their tables are
    printed."""
    out = {}
    for name, *flags in EXAMPLE_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *flags],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        log(f"example {name} {' '.join(flags)}: exit {proc.returncode} in "
            f"{wall:.1f} s")
        for line in proc.stdout.splitlines():
            log(f"  | {line}")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            raise RuntimeError(f"example {name} exited {proc.returncode}")
        out[name] = {"flags": flags, "wall_s": wall}
    log(json.dumps({"example_clis": out}))
    return out


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in fp32, a row of the batch and 1024 positions at a
    time (the full difference of two logit tensors would need 10 GB)."""
    out = 0.0
    for i in range(a.shape[0]):
        for s in range(0, a.shape[1], 1024):
            d = a[i, s:s + 1024].float() - b[i, s:s + 1024].float()
            out = max(out, float(d.abs().max()))
    return out


def _plain_with_p_in_bf16(q, k, v, causal=True, window=None, softcap=0.0):
    """flash_attention_plain with its weights rounded to bf16 before p·v
    and l kept as the fp32 sum: the rounding that the bf16 kernel adds,
    without its tiling (the regrouped plain version)."""
    from repro_torch.kernels.flash_attention import MIN_L, NEG

    B, H, S, d = q.shape
    Hkv = k.shape[1]
    qf = (q.float() * (1.0 / (d ** 0.5))).reshape(B, Hkv, H // Hkv, S, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window:
        mask &= (idx[:, None] - idx[None, :]) < window
    s = torch.where(mask, s, NEG)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=MIN_L)
    p = p.to(torch.bfloat16).float()
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / l
    return out.reshape(B, H, S, d).to(q.dtype)


@contextlib.contextmanager
def _attention_in_plain_version(p_in_bf16: bool = False):
    """Route the model's kernel path through flash_attention_plain (fp32
    math, no kernel launch) for the length of the block; with
    ``p_in_bf16`` through _plain_with_p_in_bf16."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import attention

    plain = _plain_with_p_in_bf16 if p_in_bf16 else flash_attention_plain
    kernel = attention.flash_attention
    attention.flash_attention = plain
    try:
        yield
    finally:
        attention.flash_attention = kernel


@contextlib.contextmanager
def _flash_checked_per_call(report: dict):
    """Route the model's attention through the flash_attention kernel and,
    on the same inputs, its plain version: every call must agree within
    flash_bound.  The kernel's result goes on, so the model runs its main
    path; ``report`` gathers the calls and the largest errors."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models import attention

    def checked(q, k, v, causal=True, window=None, softcap=0.0):
        got = flash_attention(q, k, v, causal, window, softcap)
        want = flash_attention_plain(q, k, v, causal, window, softcap)
        c = check_flash_call(
            got, q, k, v, want,
            dict(causal=causal, window=window, softcap=softcap),
            f"flash_attention call {report['calls']} {tuple(q.shape)} "
            f"window {window}")
        report["calls"] += 1
        report["max_err"] = max(report["max_err"], c["max_err"])
        if c["ratio"] >= report["max_err_over_bound"]:
            report.update(max_err_over_bound=c["ratio"],
                          its_median_want=c["median_want"],
                          its_median_atol=c["median_atol"])
        return got

    kernel = attention.flash_attention
    attention.flash_attention = checked
    try:
        yield
    finally:
        attention.flash_attention = kernel


@contextlib.contextmanager
def _ssd_in_plain_version(tile=None):
    """Route models/ssm.py's scan through ssd_scan_plain (fp32 math, no
    kernel launch) for the length of the block, in chunks of the kernel's
    tile unless ``tile`` is given.  The random bf16 models' logits move by
    several % of max |logit| when only the chunk of the fp32 sums changes
    (the serve runs print it), so the kernel is held against the plain
    version that groups its sums as the kernel does."""
    from repro_torch.kernels.ssd_scan import TILE, ssd_scan_plain
    from repro_torch.models import ssm

    def plain(x, a_dt, B, C, chunk=128, return_state=False):
        return ssd_scan_plain(x, a_dt, B, C, tile or TILE, return_state)

    kernel = ssm.ssd_scan
    ssm.ssd_scan = plain
    try:
        yield
    finally:
        ssm.ssd_scan = kernel


@contextlib.contextmanager
def _ssd_checked_per_call(report: dict):
    """Route every call of the scan kernels (kernels/ssd_scan.py's
    ``_scan``, which the wrapper, its autograd Function and its vmap rule
    all reach: under ``torch.func.vmap`` with the vmapped dim folded into
    the batch) through a check against the plain version at the kernel's
    tile on the same inputs: every call's y must agree within _ssd_y_tol
    (in fp32 with its atol SSD_FP32_TOL of max(1, max |y|): the model's
    fp32 y reaches several hundred, where the fp32 rounding of the scan's
    sums passes an absolute 1e-4) and its state within SSD_FP32_TOL
    (relative, or of max |state|).  The kernel's result goes on, so the
    model runs its main path, under autograd and vmap too; ``report``
    gathers the calls, their shapes and the largest errors."""
    import importlib

    from repro_torch.kernels.ssd_scan import TILE, ssd_scan_plain

    module = importlib.import_module("repro_torch.kernels.ssd_scan")
    kernel = module._scan

    def checked(x, a_dt, B, C, chunk, return_state):
        y, state = kernel(x, a_dt, B, C, chunk, True)
        with torch.no_grad():
            want, want_state = ssd_scan_plain(x, a_dt, B, C, TILE, True)
        label = (f"ssd_scan call {report['calls']} {tuple(x.shape)} "
                 f"{str(x.dtype)[6:]}")
        max_y = float(want.float().abs().max())
        tol = _ssd_y_tol(want)
        if want.dtype == torch.float32:
            tol["atol"] = SSD_FP32_TOL * max(1.0, max_y)
        torch.testing.assert_close(y, want, **tol,
                                   msg=lambda m: f"{label}, y: {m}")
        torch.testing.assert_close(
            state, want_state, rtol=SSD_FP32_TOL,
            atol=SSD_FP32_TOL * float(want_state.abs().max()),
            msg=lambda m: f"{label}, state: {m}")
        report["calls"] += 1
        shape = (f"{tuple(x.shape)} {str(x.dtype)[6:]}, B/C head stride "
                 f"{B.stride(2)}")
        report.setdefault("shapes", [])
        if shape not in report["shapes"]:
            report["shapes"].append(shape)
        y_err = max_abs_err(y, want)
        report["max_err_y"] = max(report["max_err_y"], y_err)
        report["max_err_y_over_atol"] = max(
            report.get("max_err_y_over_atol", 0.0), y_err / tol["atol"])
        report["max_err_state"] = max(report["max_err_state"],
                                      max_abs_err(state, want_state))
        return (y, state) if return_state else y

    module._scan = checked
    try:
        yield
    finally:
        module._scan = kernel


def profile_decode(cfg, params, prompt, steps: int = 4,
                   image_embeds=None) -> dict:
    """``steps`` decode steps after a prefill (with the VLM's
    ``image_embeds``), under torch.profiler: host time a step against the
    card's busy time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill

    B, S = prompt.shape
    batch = {"tokens": prompt}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    logits, cache = prefill(cfg, params, batch, cache_len=S + steps + 1,
                            cache_dtype=torch.float32)
    del logits
    tok = prompt[:, -1:]
    pos = torch.full((B,), S, dtype=torch.int64, device="cuda")
    decode_step(cfg, params, cache, tok, pos)            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            decode_step(cfg, params, cache, tok, pos + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in on_card)
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ops_per_step": len(on_card) / steps,
            "top_ms_per_step": [[name[:80], us / 1e3 / steps]
                                for name, us in top]}


def _check_generation(arch: str, run, logits_shape: tuple) -> None:
    """Prefill logits of the expected (B, S, V) shape, all finite, and
    generated ids inside the vocabulary."""
    logits = run.prefill_logits
    if tuple(logits.shape) != logits_shape:
        raise RuntimeError(f"{arch} serve: logits shape "
                           f"{tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{arch} serve: non-finite prefill logits")
    if not (0 <= int(run.tokens.min())
            and int(run.tokens.max()) < logits_shape[2]):
        raise RuntimeError(f"{arch} serve: generated ids out of the "
                           f"vocabulary")


def _lone_prefill(cfg, params, batch) -> dict:
    """One prefill alone, for the dry run: its time, launches and peak
    bytes (the peak of the block less what else the process holds beside
    ``params`` and ``batch``, the bytes the prefill holds), then
    FlopCounterMode over one more (untimed; a kernel's work is not
    seen)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.cost_analysis import tree_bytes
    from repro_torch.models import prefill

    held = tree_bytes(params) + tree_bytes(batch)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    result = prefill(cfg, params, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - other
    launches = {k.__name__: k.launches for k in KERNELS}
    del result
    with FlopCounterMode(display=False) as counter:
        prefill(cfg, params, batch)
    return {"ms_per_step": 1e3 * step_s, "launches": launches,
            "held_bytes": held, "other_gb": other / 1e9,
            "peak_gb": peak / 1e9,
            "card_flops": float(counter.get_total_flops())}


def run_serve(flash_row: dict) -> dict:
    """Gemma 2 (2B) at full width and depth, random weights: prefill
    SERVE_B prompts of SERVE_S tokens through the flash_attention kernel
    and decode SERVE_NEW greedy tokens (the main path), then hold its
    prefill logits against

    - every flash_attention call of the bf16 prefill against its plain
      version on the model's own activations (_flash_checked_per_call);
    - the same bf16 model with attention in the kernel's plain version
      (fp32 math): within SERVE_REGROUP_FACTOR times what rounding p to
      bf16 in the plain version alone moves the logits by;
    - the query-chunked plain attention path (bf16 scores, as the JAX
      package computes them): reported, with the greedy tokens' agreement;
    - the model computed in fp32 on the plain path: the kernel path's
      error may not exceed the plain path's;

    and the model in fp32, kernel against plain path, at full depth and
    at two layers (one local, one global), within FP32_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, param_count, prefill

    cfg = get_config(SERVE_ARCH).replace(use_pallas_attention=True)
    plain_cfg = cfg.replace(use_pallas_attention=False)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"{SERVE_ARCH}: {n_params} params, not "
                           f"{param_count(cfg)}")
    # int32 tokens, as the dry run's batch holds them (launch/specs.py)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1)).int()
    batch = {"tokens": prompt}
    generate(cfg, params, prompt[:, :256], 2)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = generate(cfg, params, prompt, SERVE_NEW)
    launches = {k.__name__: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["flash_attention"] != cfg.n_layers:
        raise RuntimeError(f"serve: {launches['flash_attention']} "
                           f"flash_attention launches, want {cfg.n_layers} "
                           f"(one a layer)")
    logits = run.prefill_logits
    _check_generation(SERVE_ARCH, run, (SERVE_B, SERVE_S, cfg.vocab))
    max_logit = float(logits.abs().max())
    out = {
        "run": f"{SERVE_ARCH} serve", "arch": SERVE_ARCH,
        "batch": SERVE_B, "prompt_len": SERVE_S, "new": SERVE_NEW,
        "params": n_params, "init_s": init_s,
        "prefill_s": run.prefill_s,
        "prefill_tok_per_s": SERVE_B * SERVE_S / run.prefill_s,
        "decode_ms_per_step": 1e3 * run.decode_s / SERVE_NEW,
        "decode_tok_per_s": SERVE_B * SERVE_NEW / run.decode_s,
        "flash_ms_per_prefill": (cfg.n_layers // 2) * (
            flash_row["ms"] + flash_row["local_ms"]),
        "peak_gb": peak_gb, "max_abs_logit": max_logit,
        "launches": launches,
    }

    plain = generate(plain_cfg, params, prompt, SERVE_NEW)
    first = (run.tokens != plain.tokens).any(dim=0).nonzero()
    out.update({
        "plain_prefill_s": plain.prefill_s,
        "plain_decode_ms_per_step": 1e3 * plain.decode_s / SERVE_NEW,
        "greedy_agree_share": float((run.tokens == plain.tokens)
                                    .float().mean()),
        "first_disagreeing_step": int(first[0]) if len(first) else None,
    })
    held = {"kernel": logits, "plain": plain.prefill_logits}
    del run, plain, logits
    _serve_checks(cfg, params, batch, held, out, cfg.n_layers)

    # two layers (one local, one global) in fp32: kernel vs plain path
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    params2 = dict(params, blocks=tree_map(lambda t: t[:1],
                                           params["blocks"]))
    a, _ = prefill(cfg2, params2, batch)
    b, _ = prefill(cfg2.replace(use_pallas_attention=False), params2, batch)
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise RuntimeError("fp32 two-layer check: non-finite logits")
    out["fp32_2layer_max_abs_logit"] = float(a.abs().max())
    out["fp32_2layer_max_abs_diff"] = _max_abs_diff(a, b)
    del a, b
    out["decode_profile"] = profile_decode(cfg, params, prompt)
    # for the dry run: one prefill alone on the kernel path, and one with
    # attention in the kernel's plain version, the aten ops the dry run
    # counts
    out["lone_prefill"] = _lone_prefill(cfg, params, batch)
    with _attention_in_plain_version():
        out["lone_prefill_plain_version"] = _lone_prefill(cfg, params, batch)
    log(json.dumps({"serve": out}))

    _serve_gates(SERVE_ARCH, out, vs_fp32=True)
    if not out["fp32_2layer_max_abs_diff"] <= FP32_LOGIT_TOL:
        raise RuntimeError(f"serve: fp32_2layer_max_abs_diff "
                           f"{out['fp32_2layer_max_abs_diff']:.4g} > "
                           f"{FP32_LOGIT_TOL}")
    return out


def run_ssm_serve(arch: str, batch: int, S: int, pallas: bool) -> dict:
    """An SSM model (mamba2-130m, or the hybrid zamba2-1.2b with its shared
    attention in flash_attention) at full width and depth, random weights:
    prefill ``batch`` prompts of S tokens and decode SERVE_NEW greedy
    tokens (the main path), with one ssd_scan launch a Mamba layer and one
    flash_attention launch a shared block, all in prefill.  Then

    - every scan call of the bf16 model's prefill against its plain
      version on the same activations (_ssd_checked_per_call);
    - with the attention kernel, every flash_attention call of the bf16
      prefill against its plain version (_flash_checked_per_call);
    - the bf16 model against the same model with both kernels in their
      plain versions: within SERVE_REGROUP_FACTOR times the difference
      that regrouping the plain versions alone makes (the scan's fp32 sums
      in chunks of SSD_REGROUP_CHUNK = 64 against the kernel's TILE = 128,
      and p rounded to bf16 in the plain attention): the random bf16 models
      amplify 1-ulp flips
      (PERF.md §6, PR 14);
    - the model in fp32, kernel path against plain versions, at full
      depth: within FP32_LOGIT_TOL;
    - in fp32, prefill of S tokens and one decode step against prefill of
      S + 1 tokens at the last position (the kernel's final state against
      the recurrence): within FP32_LOGIT_TOL;

    and the bf16 kernel path's error against the fp32 model (printed)."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import (decode_step, init_params, param_count,
                                    prefill)

    cfg = get_config(arch).replace(use_pallas_attention=pallas)
    cfg32 = cfg.replace(dtype="float32")
    kinds = [k for k in cfg.pattern if k != "shared_attn"]
    n_mamba = sum(kinds[i % len(kinds)] == "mamba"
                  for i in range(cfg.n_layers))
    n_shared = cfg.n_super * cfg.pattern.count("shared_attn")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the reference's analytic count leaves out each Mamba block's conv_b
    want_params = param_count(cfg) + n_mamba * (cfg.d_inner
                                                + 2 * cfg.ssm_state)
    if n_params != want_params:
        raise RuntimeError(f"{arch}: {n_params} params, not {want_params}")
    prompt = torch.randint(0, cfg.vocab, (batch, S + 1), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    batch_in = {"tokens": prompt[:, :S]}
    generate(cfg, params, prompt[:, :256], 2)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = generate(cfg, params, prompt[:, :S], SERVE_NEW)
    launches = {k.__name__: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"ssd_scan": n_mamba, "flash_attention": n_shared if pallas else 0}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise RuntimeError(f"{arch} serve: launches {launches}, want {want}")
    logits = run.prefill_logits
    _check_generation(arch, run, (batch, S, cfg.vocab))
    max_logit = float(logits.abs().max())
    out = {
        "run": f"{arch} serve", "arch": arch, "batch": batch,
        "prompt_len": S, "new": SERVE_NEW, "pallas_attention": pallas,
        "params": n_params, "init_s": init_s, "prefill_s": run.prefill_s,
        "prefill_tok_per_s": batch * S / run.prefill_s,
        "decode_ms_per_step": 1e3 * run.decode_s / SERVE_NEW,
        "decode_tok_per_s": batch * SERVE_NEW / run.decode_s,
        "peak_gb": peak_gb, "max_abs_logit": max_logit,
        "launches": launches,
    }
    with _attention_in_plain_version(), _ssd_in_plain_version():
        twin, _ = prefill(cfg, params, batch_in)
    out["max_abs_logit_diff_vs_plain_version"] = _max_abs_diff(logits, twin)
    # the bf16 model's sensitivity: the plain versions against themselves
    # with the scan's fp32 sums grouped in chunks of SSD_REGROUP_CHUNK, not
    # the kernel's TILE, and p rounded to bf16 in the attention
    with _attention_in_plain_version(p_in_bf16=True), \
            _ssd_in_plain_version(tile=SSD_REGROUP_CHUNK):
        regrouped, _ = prefill(cfg, params, batch_in)
    out["plain_regrouped_vs_plain_max_abs_diff"] = _max_abs_diff(regrouped,
                                                                 twin)
    out["logit_diff_bound"] = (SERVE_REGROUP_FACTOR
                               * out["plain_regrouped_vs_plain_max_abs_diff"])
    del twin, regrouped, run
    if pallas:
        flash = {"calls": 0, "max_err": 0.0, "max_err_over_bound": 0.0}
        with _flash_checked_per_call(flash):
            prefill(cfg, params, batch_in)
        if flash["calls"] != n_shared:
            raise RuntimeError(f"{arch}: {flash['calls']} flash_attention "
                               f"calls checked, want {n_shared}")
        out["flash_per_call_check"] = flash
    report = {"calls": 0, "max_err_y": 0.0, "max_err_state": 0.0}
    with _ssd_checked_per_call(report):
        prefill(cfg, params, batch_in)
    if report["calls"] != n_mamba:
        raise RuntimeError(f"{arch}: {report['calls']} scan calls checked, "
                           f"want {n_mamba}")
    out["per_call_check"] = report
    k32, _ = prefill(cfg32, params, batch_in)
    with _attention_in_plain_version(), _ssd_in_plain_version():
        p32, _ = prefill(cfg32, params, batch_in)
    out["fp32_max_abs_logit"] = float(p32.abs().max())
    out["fp32_max_abs_diff"] = _max_abs_diff(k32, p32)
    out["kernel_path_max_err_vs_fp32"] = _max_abs_diff(logits, p32)
    del k32, p32, logits
    # the state after S tokens, continued by one decode step, against the
    # prefill of S + 1 tokens
    _, cache = prefill(cfg32, params, batch_in, cache_len=S + 1,
                       cache_dtype=torch.float32)
    pos = torch.full((batch,), S, dtype=torch.int64, device="cuda")
    step, _ = decode_step(cfg32, params, cache, prompt[:, S:], pos)
    del cache
    full, _ = prefill(cfg32, params, {"tokens": prompt})
    out["fp32_continuation_max_abs_diff"] = float(
        (step[:, 0].float() - full[:, -1].float()).abs().max())
    del step, full
    out["decode_profile"] = profile_decode(cfg, params, prompt[:, :S])
    log(json.dumps({"serve": out}))

    if not out["max_abs_logit_diff_vs_plain_version"] <= out[
            "logit_diff_bound"]:
        raise RuntimeError(
            f"{arch} serve: prefill logits differ from the kernels' plain "
            f"versions by {out['max_abs_logit_diff_vs_plain_version']:.4g} "
            f"> {out['logit_diff_bound']:.4g}")
    for key in ("fp32_max_abs_diff", "fp32_continuation_max_abs_diff"):
        if not out[key] <= FP32_LOGIT_TOL:
            raise RuntimeError(f"{arch} serve: {key} {out[key]:.4g} > "
                               f"{FP32_LOGIT_TOL}")
    return out


# ------------------------------------------------------------ the rest of
# the zoo: cross attention (VLM) and mixtures of experts
def _serve_checks(cfg, params, batch: dict, held: dict, out: dict,
                  n_attn: int) -> None:
    """The serve runs' checks of a bf16 model with attention in
    flash_attention, written into ``out`` (gated by _serve_gates): its
    prefill logits ``held["kernel"]`` against the same model with
    attention in the kernel's plain version, beside SERVE_REGROUP_FACTOR
    times what rounding p to bf16 in the plain version alone moves them
    by; every kernel call against its plain version on the model's own
    activations (held here); the kernel path's and the plain attention
    path's (``held["plain"]``, or a prefill of it) distance to the fp32
    model; and the fp32 model, kernel against plain path.  ``held`` is
    emptied before the fp32 kernel path runs, so that a caller who keeps
    no other reference frees the bf16 logits for it."""
    from repro_torch.models import prefill

    plain_cfg = cfg.replace(use_pallas_attention=False)
    with _attention_in_plain_version():
        twin, _ = prefill(cfg, params, batch)
    logits = held["kernel"]
    out["max_abs_logit_diff_vs_plain_version"] = _max_abs_diff(logits, twin)
    with _attention_in_plain_version(p_in_bf16=True):
        regrouped, _ = prefill(cfg, params, batch)
    out["plain_p_bf16_vs_plain_max_abs_diff"] = _max_abs_diff(regrouped, twin)
    out["logit_diff_bound"] = (SERVE_REGROUP_FACTOR
                               * out["plain_p_bf16_vs_plain_max_abs_diff"])
    del twin, regrouped
    report = {"calls": 0, "max_err": 0.0, "max_err_over_bound": 0.0}
    with _flash_checked_per_call(report):
        prefill(cfg, params, batch)
    if report["calls"] != n_attn:
        raise RuntimeError(f"{cfg.name}: {report['calls']} flash_attention "
                           f"calls checked, want {n_attn}")
    out["per_call_check"] = report
    plain_logits = held.get("plain")
    if plain_logits is None:
        plain_logits, _ = prefill(plain_cfg, params, batch)
    truth, _ = prefill(plain_cfg.replace(dtype="float32"), params, batch)
    out["max_abs_logit_diff_vs_plain_path"] = _max_abs_diff(logits,
                                                            plain_logits)
    out["kernel_path_max_err_vs_fp32"] = _max_abs_diff(logits, truth)
    out["plain_path_max_err_vs_fp32"] = _max_abs_diff(plain_logits, truth)
    held.clear()
    del logits, plain_logits
    k32, _ = prefill(cfg.replace(dtype="float32"), params, batch)
    out["fp32_max_abs_logit"] = float(truth.abs().max())
    out["fp32_max_abs_diff"] = _max_abs_diff(k32, truth)
    del k32, truth


def _serve_gates(name: str, out: dict, regroup: bool = True,
                 vs_fp32: bool = False) -> None:
    """Raise unless _serve_checks' numbers in ``out`` hold: the fp32 model's
    kernel path within FP32_LOGIT_TOL of its plain path; with ``regroup``,
    the bf16 logits within ``logit_diff_bound`` of the plain version's;
    with ``vs_fp32``, the kernel path no further from the fp32 model than
    the plain attention path."""
    if regroup and not out["max_abs_logit_diff_vs_plain_version"] <= out[
            "logit_diff_bound"]:
        raise RuntimeError(
            f"{name} serve: prefill logits differ from the kernel's plain "
            f"version by {out['max_abs_logit_diff_vs_plain_version']:.4g} "
            f"> {out['logit_diff_bound']:.4g}")
    if vs_fp32 and not out["kernel_path_max_err_vs_fp32"] <= out[
            "plain_path_max_err_vs_fp32"]:
        raise RuntimeError(
            f"{name} serve: the kernel path is further from the fp32 model "
            f"({out['kernel_path_max_err_vs_fp32']:.4g}) than the plain "
            f"path ({out['plain_path_max_err_vs_fp32']:.4g})")
    if not out["fp32_max_abs_diff"] <= FP32_LOGIT_TOL:
        raise RuntimeError(f"{name} serve: fp32 kernel against plain path "
                           f"{out['fp32_max_abs_diff']:.4g} > "
                           f"{FP32_LOGIT_TOL}")


@contextlib.contextmanager
def _moe_captured(calls: list):
    """Record each MoE block's params, input and output (the model's own
    activations) for the length of the block."""
    from repro_torch.models import transformer

    block = transformer.moe_block

    def recorded(p, x, cfg):
        y = block(p, x, cfg)
        calls.append((p, x, y))
        return y

    transformer.moe_block = recorded
    try:
        yield
    finally:
        transformer.moe_block = block


def _moe_oracle(p, x, y, cfg) -> dict:
    """Hold one MoE block's output y against a per-token oracle: the
    routing recomputed on the host (each token's top-k experts by the
    router's fp32 probs, ties to the lowest index; the slots in token
    order choice by choice, the occupancy running on; a slot at or past
    the capacity drops the pair), then for MOE_ORACLE_TOKENS tokens (up to
    half of them with a dropped pair, the rest drawn from seed 0) each
    kept pair's
    gated MLP in fp32 from the bf16 weights, weighted by the bf16-rounded
    w, plus the dense MLP; within MOE_ORACLE_ATOL·A + MOE_ORACLE_RTOL·|want|
    element by element and MOE_ORACLE_REL_L2 relative L2 a token.
    The capacity is the reference's rule written out here, and
    router_load is held expert by expert against the count of each
    token's top-k experts by its router logits.  Also the share of dropped
    (token, choice) pairs."""
    import numpy as np

    from repro_torch.models.moe import router_load

    B, S, D = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    if T > cfg.moe_group_size:
        raise RuntimeError(f"the oracle takes one group, not {T} tokens")
    capacity = max(1, int(T * k / E * cfg.capacity_factor))
    flat = x.reshape(T, D)
    logits = flat.float() @ p["router"].float()
    load_want = np.bincount(np.argsort(
        -logits.cpu().numpy(), axis=1, kind="stable")[:, :k].ravel(),
        minlength=E)
    probs_np = torch.softmax(logits, dim=-1).cpu().numpy()
    del logits
    order = np.argsort(-probs_np, axis=1, kind="stable")[:, :k]
    topv = np.take_along_axis(probs_np, order, axis=1)
    w = topv / np.maximum(topv.sum(axis=1, keepdims=True), np.float32(1e-9))
    slot = np.zeros((T, k), dtype=np.int64)
    occupancy = np.zeros(E, dtype=np.int64)
    for c in range(k):
        for t in range(T):
            slot[t, c] = occupancy[order[t, c]]
            occupancy[order[t, c]] += 1
    kept = slot < capacity
    dropped_tokens = np.nonzero(~kept.all(axis=1))[0]
    half = min(len(dropped_tokens), MOE_ORACLE_TOKENS // 2)
    pick = set(dropped_tokens[np.linspace(0, len(dropped_tokens) - 1,
                                          half).astype(int)].tolist())
    for t in np.random.default_rng(0).permutation(T).tolist():
        if len(pick) >= MOE_ORACLE_TOKENS:
            break
        pick.add(t)
    pick = torch.tensor(sorted(pick), device=x.device)
    w_bf16 = torch.from_numpy(w).to(x.device, torch.bfloat16).float()
    xs = flat[pick].float()                                # (n, D)
    want = torch.zeros_like(xs)
    scale = torch.zeros_like(xs)

    def mlp(wg, wu, wd, rows):
        a = rows @ wg.float()
        h = (torch.nn.functional.silu(a) if cfg.act == "silu" else
             torch.nn.functional.gelu(a, approximate="tanh")) * (
            rows @ wu.float())
        return h @ wd.float(), h.abs() @ wd.float().abs()

    order_t = torch.from_numpy(order).to(x.device)
    kept_t = torch.from_numpy(kept).to(x.device)
    for e in sorted({int(order[t, c]) for t in pick.tolist()
                     for c in range(k) if kept[t, c]}):
        for c in range(k):
            sel = ((order_t[pick, c] == e) & kept_t[pick, c]).nonzero()[:, 0]
            if not len(sel):
                continue
            out, mag = mlp(p["wg"][e], p["wu"][e], p["wd"][e], xs[sel])
            wt = w_bf16[pick[sel], c][:, None]
            want[sel] += wt * out
            scale[sel] += wt * mag
    if cfg.parallel_dense_mlp:
        out, mag = mlp(p["dense"]["wg"], p["dense"]["wu"], p["dense"]["wd"],
                       xs)
        want += out
        scale += mag
    got = y.reshape(T, D)[pick].float()
    bound = MOE_ORACLE_ATOL * scale + MOE_ORACLE_RTOL * want.abs()
    ratio = err_over_bound(got, want, bound)
    rel_l2 = float(((got - want).norm(dim=1) / want.norm(dim=1)).max())
    load = router_load(p, x, cfg).cpu().numpy()
    res = {"tokens": T, "capacity": capacity,
           "dropped_pair_share": float(1.0 - kept.mean()),
           "tokens_with_a_dropped_pair": int(len(dropped_tokens)),
           "router_load_sum": int(load.sum()),
           "router_load_max": int(load.max()),
           "oracle_tokens": int(len(pick)),
           "oracle_max_err": max_abs_err(got, want),
           "oracle_err_over_bound": ratio,
           "oracle_max_token_rel_l2": rel_l2,
           "oracle_median_abs_want": float(want.abs().median())}
    if res["router_load_sum"] != T * k or not np.array_equal(load,
                                                             load_want):
        raise RuntimeError(f"{cfg.name}: router_load (sum "
                           f"{res['router_load_sum']}, want {T * k}) is not "
                           f"the oracle's count at "
                           f"{np.nonzero(load != load_want)[0].tolist()}")
    if not (ratio <= 1.0 and rel_l2 <= MOE_ORACLE_REL_L2):
        raise RuntimeError(f"{cfg.name}: the MoE block is {ratio:.4g} of "
                           f"the oracle's bound away from it, a token "
                           f"{rel_l2:.4g} in relative L2")
    return res


def run_zoo_serve(arch: str, n_layers, param_dtype: str) -> dict:
    """One of the last three configs at full width, random weights from
    seed 0, bf16 activations, fp32 cache: prefill ZOO_B prompts of ZOO_S
    tokens with self attention in flash_attention (one launch a layer)
    and decode ZOO_NEW greedy tokens, then _serve_checks (an MoE model's
    bf16 logits not gated by the regrouping spread).

    The VLM (llama-3.2-vision-11b, full depth, fp32 params): its 8 cross
    blocks' xgate set to 1.0 (init's 0 would hide the cross path), 1024
    patch embeddings (normal × 0.1, seed 2, as launch/serve.py makes
    them).  The fp32 model's logits with the embeddings must differ from
    those with zero embeddings by more than FP32_LOGIT_TOL (in bf16 the
    difference is printed beside the regrouping spread: averaged over 1024
    random patches, the cross term moves the logits less than rounding p
    to bf16 does); in fp32, prefill of S tokens and one decode step must
    match prefill of S + 1 tokens within FP32_LOGIT_TOL; and the decode
    cache's ck/cv (after a decode step) must equal init_cross_cache of the
    embeddings and warm_cross_caches' bit for bit.

    The MoE configs (depth cut to ``n_layers``, bf16 params): one token
    group (ZOO_B·ZOO_S = moe_group_size) at capacity factor 1.25; each
    MoE block of a prefill held against _moe_oracle."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    param_count, prefill, warm_cross_caches)
    from repro_torch.models.attention import init_cross_cache

    cfg = get_config(arch).replace(use_pallas_attention=True,
                                   param_dtype=param_dtype)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_cross = cfg.n_super * cfg.pattern.count("cross")
    for i, kind in enumerate(cfg.pattern):
        if kind == "cross":
            params["blocks"][f"pos{i}"]["xgate"].fill_(1.0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the reference's analytic count leaves out each cross block's xgate
    if n_params != param_count(cfg) + n_cross:
        raise RuntimeError(f"{arch}: {n_params} params, not "
                           f"{param_count(cfg)} + {n_cross}")
    prompt_1 = torch.randint(0, cfg.vocab, (ZOO_B, ZOO_S + 1),
                             device="cuda", generator=torch.Generator(
                                 device="cuda").manual_seed(1))
    prompt = prompt_1[:, :ZOO_S]
    feats = None
    batch = {"tokens": prompt}
    if cfg.n_patches:
        feats = torch.randn((ZOO_B, cfg.n_patches, cfg.d_model),
                            device="cuda", generator=torch.Generator(
                                device="cuda").manual_seed(2)) * 0.1
        batch["image_embeds"] = feats
    generate(cfg, params, prompt[:, :256], 2, image_embeds=feats)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = generate(cfg, params, prompt, ZOO_NEW, image_embeds=feats)
    launches = {k.__name__: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": cfg.n_layers}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise RuntimeError(f"{arch} serve: launches {launches}, want {want}")
    logits = run.prefill_logits
    _check_generation(arch, run, (ZOO_B, ZOO_S, cfg.vocab))
    out = {"run": f"{arch} serve", "arch": arch, "layers": cfg.n_layers,
           "param_dtype": param_dtype, "batch": ZOO_B, "prompt_len": ZOO_S,
           "new": ZOO_NEW, "params": n_params, "init_s": init_s,
           "prefill_s": run.prefill_s,
           "prefill_tok_per_s": ZOO_B * ZOO_S / run.prefill_s,
           "decode_ms_per_step": 1e3 * run.decode_s / ZOO_NEW,
           "decode_tok_per_s": ZOO_B * ZOO_NEW / run.decode_s,
           "peak_gb": peak_gb, "max_abs_logit": float(logits.abs().max()),
           "launches": launches}
    del run
    if cfg.n_patches:
        # the cross path is live: the embeddings move the logits.  In bf16
        # printed beside the regrouping spread; held in fp32 below, where
        # the model's own rounding is far below FP32_LOGIT_TOL
        zeros = dict(batch, image_embeds=torch.zeros_like(feats))
        blind, _ = prefill(cfg, params, zeros)
        out["logit_diff_vs_zero_embeddings"] = _max_abs_diff(logits, blind)
        del blind
    held = {"kernel": logits}
    del logits
    _serve_checks(cfg, params, batch, held, out, cfg.n_layers)
    if cfg.n_patches:
        cfg32 = cfg.replace(dtype="float32")
        full, _ = prefill(cfg32, params, dict(batch, tokens=prompt_1))
        blind, _ = prefill(cfg32, params, dict(zeros, tokens=prompt_1))
        out["fp32_logit_diff_vs_zero_embeddings"] = _max_abs_diff(full,
                                                                  blind)
        del blind
        if not out["fp32_logit_diff_vs_zero_embeddings"] > FP32_LOGIT_TOL:
            raise RuntimeError(
                f"{arch}: the fp32 logits move by "
                f"{out['fp32_logit_diff_vs_zero_embeddings']:.4g} with the "
                f"embeddings, within {FP32_LOGIT_TOL}: the cross path is "
                f"dead")
        # fp32 prefill of S tokens and a decode step (its cross attention
        # from the cache's ck/cv) against prefill of S + 1 tokens
        _, cache = prefill(cfg32, params, batch, cache_len=ZOO_S + 1,
                           cache_dtype=torch.float32)
        pos = torch.full((ZOO_B,), ZOO_S, dtype=torch.int64, device="cuda")
        step, _ = decode_step(cfg32, params, cache, prompt_1[:, ZOO_S:], pos)
        out["fp32_continuation_max_abs_diff"] = float(
            (step[:, 0].float() - full[:, -1].float()).abs().max())
        del step, full, cache
        if not out["fp32_continuation_max_abs_diff"] <= FP32_LOGIT_TOL:
            raise RuntimeError(
                f"{arch}: fp32 decode after prefill differs from the longer "
                f"prefill by {out['fp32_continuation_max_abs_diff']:.4g}")
        _, cache = prefill(cfg, params, batch, cache_len=ZOO_S + 2,
                           cache_dtype=torch.float32)
        decode_step(cfg, params, cache, prompt[:, -1:], pos)
        warm = warm_cross_caches(cfg, params,
                                 init_cache(cfg, ZOO_B, ZOO_S + 2,
                                            torch.float32, device="cuda"),
                                 feats)
        for i, kind in enumerate(cfg.pattern):
            if kind != "cross":
                continue
            for s in range(cfg.n_super):
                xattn = {n: t[s] for n, t in
                         params["blocks"][f"pos{i}"]["xattn"].items()}
                cc = init_cross_cache(xattn, feats.to(torch.bfloat16),
                                      torch.float32)
                for key in ("ck", "cv"):
                    got = cache["blocks"][f"pos{i}"][key][s]
                    if not (torch.equal(got, cc[key]) and torch.equal(
                            got, warm["blocks"][f"pos{i}"][key][s])):
                        raise RuntimeError(f"{arch}: the decode cache's "
                                           f"{key} of cross block {s} is not "
                                           f"init_cross_cache's")
        out["cross_cache_checked_blocks"] = n_cross
        del cache, warm
    if cfg.n_experts:
        calls = []
        with _moe_captured(calls):
            prefill(cfg, params, batch)
        out["moe_blocks"] = [_moe_oracle(p, x, y, cfg) for p, x, y in calls]
        if len(calls) != sum(cfg.use_moe(i % len(cfg.pattern))
                             for i in range(cfg.n_layers)):
            raise RuntimeError(f"{arch}: {len(calls)} MoE blocks captured")
        del calls
    out["decode_profile"] = profile_decode(cfg, params, prompt,
                                           image_embeds=feats)
    del params
    torch.cuda.empty_cache()
    # an MoE model's bf16 logits jump where a routing flips, so the
    # regrouping spread bounds nothing there (see PERF.md §4): its kernel
    # is held by the per-call check and the fp32 gate alone
    out["logit_diff_gated"] = not cfg.n_experts
    log(json.dumps({"serve": out}))
    _serve_gates(arch, out, regroup=out["logit_diff_gated"])
    return out


def check_sharded_decode(part: str) -> dict:
    """sharded_decode_attention over a two-slot mesh (cuda:0, cuda:0) at
    the VLM's decode shape, fp32, against reference_decode_attention
    within FLASH_DECODE_TOL, both timed (host-paced calls)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.flash_decode import (reference_decode_attention,
                                                   sharded_decode_attention)

    B, H, K, S, hd = FLASH_DECODE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = _randn((B, H, hd), gen)
    kc, vc = _randn((B, K, S, hd), gen), _randn((B, K, S, hd), gen)
    pos = torch.tensor([ZOO_S - 1, S - 1], device="cuda")
    mesh = Mesh(("cuda:0",) * 2, (("model", 2),))
    got = sharded_decode_attention(q, kc, vc, pos, mesh)
    want = reference_decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=FLASH_DECODE_TOL,
                               atol=FLASH_DECODE_TOL)
    out = {"shape": list(FLASH_DECODE_SHAPE), "mesh": repr(mesh),
           "max_abs_err": max_abs_err(got, want),
           "sharded_call_ms": time_ms(lambda: sharded_decode_attention(
               q, kc, vc, pos, mesh), runs=10, hold=False),
           "reference_call_ms": time_ms(lambda: reference_decode_attention(
               q, kc, vc, pos), runs=10, hold=False),
           "bound_ms": bound_ms(4.0 * (2 * q.numel() + kc.numel()
                                       + vc.numel()),
                                4.0 * B * H * S * hd, part)[0]}
    log(json.dumps({"sharded_decode": out}))
    return out


def run_zoo(part: str) -> dict:
    """The phase "serve, the rest of the zoo": ZOO_SERVES one after
    another (each model freed before the next), then the sharded flash
    decode."""
    out = {}
    for arch, n_layers, param_dtype in ZOO_SERVES:
        torch.cuda.empty_cache()
        out[arch] = run_zoo_serve(arch, n_layers, param_dtype)
        log(f"{arch} serve done at {time.perf_counter() - T0:.1f} s")
    out["sharded_decode"] = check_sharded_decode(part)
    return out


# ------------------------------------------------------------ training
def _lm_batches(cfg, batch: int, S: int, steps: int) -> list:
    """launch/pretrain.py's data: make_token_lm's stream, ``batch`` rows a
    step (one stream a codebook), on the card; a VLM's batches also carry
    stub image embeddings (normal × 0.1 in bf16, as launch/specs.py makes
    them)."""
    import numpy as np

    from repro_torch.data.synthetic import make_token_lm

    rows = batch * max(1, cfg.n_codebooks)
    data = make_token_lm(steps * rows * (S + 1) * 2, vocab=cfg.vocab,
                         seq_len=S, seed=0)
    shape = (batch, cfg.n_codebooks, S) if cfg.n_codebooks else (batch, S)
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for step in range(steps):
        idx = (np.arange(rows) + step * rows) % data.x.shape[0]
        out.append({k: torch.from_numpy(a[idx].reshape(shape)).cuda()
                    for k, a in (("tokens", data.x), ("labels", data.y))})
        if cfg.n_patches:
            out[-1]["image_embeds"] = (0.1 * torch.randn(
                (batch, cfg.n_patches, cfg.d_model), generator=gen,
                device="cuda")).bfloat16()
    return out


def _attention_uses(cfg) -> int:
    """Attention blocks a forward runs (a shared block once a use)."""
    kinds = [k for k in cfg.pattern if k != "shared_attn"]
    own = sum(kinds[i % len(kinds)] in ("attn", "local")
              for i in range(cfg.n_layers))
    return own + cfg.n_super * cfg.pattern.count("shared_attn")


def _mamba_layers(cfg) -> tuple:
    """(Mamba layers in the remat'd superblocks, in the remainder)."""
    kinds = [k for k in cfg.pattern if k != "shared_attn"]
    in_super = cfg.n_super * kinds.count("mamba")
    rem = sum(kinds[i] == "mamba" for i in range(cfg.n_rem))
    return in_super, rem


def train_flops(cfg, n_params: int, batch: int, S: int) -> float:
    """Model FLOPs of one step: 6·N·tokens, plus the attention scores'
    two products forward and backward (12·H·hd·S a token a layer, halved
    by the causal mask).  The scan's own products (about 1 % of 6N for
    mamba2-130m) and remat's recomputation are not counted."""
    tokens = batch * S
    attn = 6.0 * _attention_uses(cfg) * cfg.n_heads * cfg.hd * S * tokens
    return 6.0 * n_params * tokens + attn


def _profile_train_step(train_step, state, batch) -> tuple:
    """One step under torch.profiler: the card's busy share of the step,
    and the shares of the step spent in the scan's forward kernels and in
    its plain backward (the ``ssd_scan_plain_backward`` spans on the
    card's timeline; None where the profiler shows none).  The profiler
    slows the host, so the shares are also given of the unprofiled step
    (``run_train`` adds them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card, spans = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # a record_function span shows on the card as an annotation over
        # its kernels: counted apart, not as busy time
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.name == "ssd_scan_plain_backward")
        (spans if annotation else on_card).append(e)
    busy = sum(e.time_range.elapsed_us() for e in on_card)
    scan_fwd = sum(e.time_range.elapsed_us() for e in on_card
                   if any(k in e.name for k in SSD_KERNEL_NAMES))
    scan_bwd = sum(e.time_range.elapsed_us() for e in spans
                   if e.name == "ssd_scan_plain_backward")
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # where the host's time went: operations and CUDA runtime calls (an
    # allocator's cudaFree waits for the card) by self time
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    wall_us = wall * 1e6
    return state, {
        "host_top_ms": [[a.key[:60], a.self_cpu_time_total / 1e3, a.count]
                        for a in host[:8]],
        "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / wall_us,
        "device_ops": len(on_card),
        "ssd_forward_kernels_ms": scan_fwd / 1e3,
        "ssd_forward_share": scan_fwd / wall_us,
        "ssd_plain_backward_ms": scan_bwd / 1e3 if scan_bwd else None,
        "ssd_plain_backward_share": scan_bwd / wall_us if scan_bwd else None,
        "top_ms": [[name[:80], us / 1e3] for name, us in top]}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp(min=1e-300))


def check_train_grads(cfg, params, batch, label: str) -> dict:
    """One step's grads (models.grads_of) with the scan's forward in the
    kernel, against the same step with the scan in its plain version at
    the kernel's chunk (TILE): every leaf within TRAIN_GRAD_FACTOR times
    what regrouping the plain scan's sums in chunks of SSD_REGROUP_CHUNK
    moves it by.  In the kernel path's step every scan call (the remat'd
    forward's re-runs too) is held against the plain scan on the same
    activations (_ssd_checked_per_call).  The Mamba params that reach the
    loss only through the scan (A_log, dt_bias, conv_w's and in_proj's
    x/B/C/dt parts) must get non-zero grads, layer by layer, on the kernel
    path."""
    from repro_torch.core.flatten import tree_paths
    from repro_torch.kernels import reset_launches, ssd_scan
    from repro_torch.models import grads_of

    reset_launches()
    per_call = {"calls": 0, "max_err_y": 0.0, "max_err_state": 0.0}
    with _ssd_checked_per_call(per_call):
        loss, kernel = grads_of(cfg, params, batch)
    launches = ssd_scan.launches
    if per_call["calls"] != launches or not launches:
        raise RuntimeError(f"{label}: {per_call['calls']} scan calls "
                           f"checked of {launches} launches")
    with _ssd_in_plain_version():
        plain_loss, plain = grads_of(cfg, params, batch)
    with _ssd_in_plain_version(tile=SSD_REGROUP_CHUNK):
        _, regrouped = grads_of(cfg, params, batch)
    leaves, worst = {}, 0.0
    for (path, g), (_, w), (_, r) in zip(tree_paths(kernel),
                                         tree_paths(plain),
                                         tree_paths(regrouped)):
        key = "/".join(path)
        got, spread = _rel_l2(g, w), _rel_l2(r, w)
        leaves[key] = {"rel_l2": got, "regroup_rel_l2": spread}
        ratio = got / (TRAIN_GRAD_FACTOR * spread) if spread else math.inf
        worst = max(worst, ratio)
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{label}: non-finite grads at {key}")
    d_inner, N = cfg.d_inner, cfg.ssm_state
    # each scan-only part of a Mamba block's params: (its dims unstacked,
    # its parts along the last dims); in_proj's columns are z, x, B, C, dt
    cuts = {"A_log": (1, lambda g: [g]), "dt_bias": (1, lambda g: [g]),
            "conv_w": (2, lambda g: [g[..., :d_inner, :],
                                     g[..., d_inner:, :]]),
            "in_proj": (2, lambda g: [
                g[..., d_inner:2 * d_inner],
                g[..., 2 * d_inner:2 * d_inner + N],
                g[..., 2 * d_inner + N:2 * d_inner + 2 * N],
                g[..., 2 * d_inner + 2 * N:]])}
    zero = []
    for path, g in tree_paths(kernel):
        if "mamba" not in path or path[-1] not in cuts:
            continue
        dims, cut = cuts[path[-1]]
        for part in cut(g):
            per_layer = part.reshape(part.shape[0] if g.dim() > dims else 1,
                                     -1)
            if not bool((per_layer.abs().amax(dim=1) > 0).all()):
                zero.append("/".join(path))
    out = {"label": label, "loss": float(loss),
           "plain_loss": float(plain_loss), "ssd_launches": launches,
           "per_call_check": per_call,
           "worst_rel_l2_over_bound": worst,
           "grad_norm": math.sqrt(sum(float(g.double().square().sum())
                                      for _, g in tree_paths(kernel))),
           "leaves": leaves}
    log(json.dumps({"train_grads": out}))
    if zero:
        raise RuntimeError(f"{label}: a layer's scan params got no grad on "
                           f"the kernel path: {zero}")
    if not worst <= 1.0:
        raise RuntimeError(f"{label}: kernel-path grads differ from the "
                           f"plain path's by {worst:.4g} of the bound "
                           f"({TRAIN_GRAD_FACTOR} x the regrouping spread)")
    return out


def train_config(arch: str, overrides=None):
    """The train runs' config: ``arch`` at full width with ``overrides``
    (a depth or expert count cut for one card), lr TRAIN_LR,
    efficient_ce."""
    from repro_torch.configs import get_config

    return get_config(arch).replace(learning_rate=TRAIN_LR,
                                    efficient_ce=True, **(overrides or {}))


def run_train(arch: str, batch: int, S: int, steps: int, part: str,
              grad_checks=("bfloat16",), overrides=None) -> dict:
    """``steps`` Adam steps of ``arch`` at full width (and full depth
    unless ``overrides`` cut it) through make_train_step on
    launch/pretrain.py's data (the main path of training), with the launch
    counts set to 0 just before and read just after: every step's loss
    finite and, over 10 steps or more, the mean of the last 5 below that
    of the first 5.  Before it, check_train_grads on the first batch for
    each dtype of ``grad_checks``; after it, one more step under
    FlopCounterMode (untimed: the card's count for the dry run) and one
    under torch.profiler.  Records the bytes of the state and of one batch
    the run holds, for the dry run's argument bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.cost_analysis import tree_bytes
    from repro_torch.models import make_train_step

    cfg = train_config(arch, overrides)
    if not cfg.remat:
        raise RuntimeError(f"{arch}: the full config trains with remat")
    train_step, init_state = make_train_step(cfg)
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    batches = _lm_batches(cfg, batch, S, steps)
    held_bytes = tree_bytes(state) + tree_bytes(batches[0])
    grads = {}
    for dtype in grad_checks:
        grads[dtype] = check_train_grads(
            cfg.replace(dtype=dtype), state["params"], batches[0],
            f"{arch} {dtype} grads")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = train_step(state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = {k.__name__: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    in_super, rem = _mamba_layers(cfg)
    want = {"ssd_scan": steps * (2 * in_super + rem),   # remat reruns it
            "adam": steps * adam_launches_a_step(state["params"])}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise RuntimeError(f"{arch} train: launches {launches}, want "
                           f"{want} and no other")
    with FlopCounterMode(display=False) as counter:
        state, _ = train_step(state, batches[0])
    card_flops = float(counter.get_total_flops())
    state, profile = _profile_train_step(train_step, state, batches[0])
    del state
    torch.cuda.empty_cache()
    step_ms = 1e3 * sum(step_s[1:]) / max(1, len(step_s) - 1)
    for key in ("device_busy", "ssd_forward_kernels", "ssd_plain_backward"):
        ms = profile[f"{key}_ms"]
        profile[f"{key}_share_of_step"] = ms / step_ms if ms else None
    flops = train_flops(cfg, n_params, batch, S)
    out = {
        "run": f"{arch} train", "arch": arch, "batch": batch, "seq": S,
        "steps": steps, "lr": TRAIN_LR, "params": n_params,
        "overrides": overrides or {}, "held_bytes": held_bytes,
        "allocated_before_gb": allocated_before / 1e9,
        "card_flops": card_flops,
        "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "remat": cfg.remat, "efficient_ce": cfg.efficient_ce,
        "init_s": init_s, "first_step_ms": 1e3 * step_s[0],
        "ms_per_step": step_ms, "tok_per_s": batch * S / step_ms * 1e3,
        "train_tflop_per_step": flops / 1e12,
        "train_mfu": flops / (step_ms / 1e3) / BF16_FLOPS[part],
        "peak_gb": peak_gb, "losses": losses, "launches": launches,
        "profile": profile, "grad_checks": {
            k: {"worst_rel_l2_over_bound": v["worst_rel_l2_over_bound"],
                "loss": v["loss"], "plain_loss": v["plain_loss"]}
            for k, v in grads.items()},
    }
    log(json.dumps({"train": out}))
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{arch} train: non-finite loss in {losses}")
    if steps >= 10 and not (sum(losses[-5:]) < sum(losses[:5])):
        raise RuntimeError(f"{arch} train: the loss did not fall: "
                           f"{losses}")
    return out


def check_ssd_autograd(gen, part: str) -> dict:
    """The ssd_scan Function on the card at the two training shapes (bf16,
    B and C head-broadcast views, fp32 a_dt): the y and final state it
    computes under autograd against ssd_scan_plain on the same inputs
    (within _ssd_y_tol and SSD_FP32_TOL, as check_ssd_scan holds them);
    its grads of x, a_dt and the views' bases (summed over heads by
    autograd) against autograd through ssd_scan_plain on the same inputs
    and cotangent, within SSD_GRAD_TOL of each max |grad|; and the plain
    backward's device time at each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    out = {}
    for arch, batch, S, _ in TRAIN_RUNS[:2]:
        c = get_config(arch)
        b, l, h, p, n = batch, S, c.ssm_heads, c.ssm_head_dim, c.ssm_state
        leaves = [(_randn((b, l, h, p), gen) * 0.5).bfloat16(),
                  -_randn((b, l, h), gen).abs() * 0.3,
                  (_randn((b, l, 1, n), gen) * 0.5).bfloat16(),
                  (_randn((b, l, 1, n), gen) * 0.5).bfloat16()]
        for t in leaves:
            t.requires_grad_(True)
        gy = (_randn((b, l, h, p), gen) * 0.5).bfloat16()

        def scan(fn, **kw):
            x, a, Bb, Cb = leaves
            return fn(x, a, Bb.expand(b, l, h, n), Cb.expand(b, l, h, n),
                      **kw)

        before = ssd_scan.launches
        y, state = scan(ssd_scan, return_state=True)
        if ssd_scan.launches != before + 1 or y.grad_fn is None:
            raise RuntimeError(f"ssd_scan under autograd at {arch}'s shape: "
                               f"no kernel launch or no graph")
        with torch.no_grad():
            want_y, want_state = scan(ssd_scan_plain, return_state=True)
        label = f"ssd_scan under autograd at {arch}'s shape"
        torch.testing.assert_close(y, want_y, **_ssd_y_tol(want_y),
                                   msg=lambda m: f"{label}, y: {m}")
        torch.testing.assert_close(
            state, want_state, rtol=SSD_FP32_TOL, atol=SSD_FP32_TOL,
            msg=lambda m: f"{label}, state: {m}")
        y_err, state_err = (max_abs_err(y, want_y),
                            max_abs_err(state, want_state))
        y_over_atol = y_err / _ssd_y_tol(want_y)["atol"]
        del want_y, want_state
        got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
        want = torch.autograd.grad(scan(ssd_scan_plain), leaves, gy)
        errs = []
        for name, g, w in zip(("x", "a_dt", "B", "C"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise RuntimeError(f"{arch} {name}: grad {g.dtype} "
                                   f"{tuple(g.shape)}")
            scale = float(w.float().abs().max())
            err = max_abs_err(g, w)
            errs.append(err / scale)
            if not (scale > 0 and err <= SSD_GRAD_TOL * scale):
                raise RuntimeError(f"ssd_scan grads at {arch}'s shape: "
                                   f"{name} off by {err:.3g} of max "
                                   f"{scale:.3g}")
        backward_ms = time_ms(lambda: torch.autograd.grad(
            y, leaves, gy, retain_graph=True), runs=3, warmup=1)
        out[arch] = {"shape": (b, l, h, p, n), "max_err_y": y_err,
                     "y_err_over_atol": y_over_atol,
                     "max_err_state": state_err,
                     "max_err_over_max_grad": max(errs),
                     "plain_backward_ms": backward_ms,
                     "kernel_forward_ms": time_ms(
                         lambda: scan(ssd_scan).detach(), runs=5)}
        del y, state, got, want, leaves, gy
        torch.cuda.empty_cache()
    log(json.dumps({"ssd_autograd": out}))
    return out


def check_flash_refuses_autograd() -> None:
    """flash_attention has no backward: with an input that requires grad
    it raises on the card, as jax.grad raises on the Pallas kernel."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (torch.randn(1, 2, 64, 64, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    try:
        flash_attention(q.requires_grad_(True), k, v)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise RuntimeError("flash_attention ran under autograd")
    if flash_attention.launches != before:
        raise RuntimeError("flash_attention launched under autograd")
    with torch.no_grad():
        flash_attention(q, k, v)
    log("flash_attention under autograd: raises (no backward), as in JAX")


def run_musicgen_serve() -> dict:
    """musicgen-medium at full width and depth (48 layers, d 1536, 4
    codebooks), random weights: MUSICGEN_SERVE's prompts of codebook
    frames prefilled through flash_attention (one launch a layer) and
    greedy new tokens.  Its bf16 prefill logits against the same model
    with attention in the kernel's plain version (within
    SERVE_REGROUP_FACTOR times what rounding p to bf16 in the plain
    version moves them by), every call against its plain version, the
    kernel path no further from the fp32 model than the plain attention
    path, and in fp32 kernel against plain path within FP32_LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, param_count

    arch = "musicgen-medium"
    B, S, new = MUSICGEN_SERVE
    cfg = get_config(arch).replace(use_pallas_attention=True)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"{arch}: {n_params} params, not "
                           f"{param_count(cfg)}")
    prompt = torch.randint(0, cfg.vocab, (B, cfg.n_codebooks, S),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(1))
    batch = {"tokens": prompt}
    generate(cfg, params, prompt[..., :128], 2)        # warm-up
    torch.cuda.synchronize()
    reset_launches()
    run = generate(cfg, params, prompt, new)
    launches = {k.__name__: k.launches for k in KERNELS}
    want = {"flash_attention": cfg.n_layers}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise RuntimeError(f"{arch} serve: launches {launches}, want {want}")
    logits = run.prefill_logits
    if tuple(logits.shape) != (B, S, cfg.n_codebooks * cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{arch} serve: logits {tuple(logits.shape)}, "
                           f"finite {bool(torch.isfinite(logits).all())}")
    if not (tuple(run.tokens.shape) == (B, new) and 0 <= int(
            run.tokens.min()) and int(run.tokens.max()) < cfg.vocab):
        raise RuntimeError(f"{arch} serve: generated ids {run.tokens}")
    out = {"run": f"{arch} serve", "arch": arch, "batch": B,
           "codebooks": cfg.n_codebooks, "prompt_len": S, "new": new,
           "params": n_params, "prefill_s": run.prefill_s,
           "decode_ms_per_step": 1e3 * run.decode_s / new,
           "max_abs_logit": float(logits.abs().max()), "launches": launches}
    held = {"kernel": logits}
    del run, logits
    _serve_checks(cfg, params, batch, held, out, cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    log(json.dumps({"serve": out}))
    _serve_gates(arch, out, vs_fp32=True)
    return out


def run_training(gen, part: str) -> dict:
    """The train phase: the scan under autograd at both training shapes,
    flash_attention's refusal, musicgen-medium's serve, then the three
    train runs (mamba2-130m with its grads checked in bf16 and in fp32,
    zamba2-1.2b in bf16)."""
    out = {"ssd_autograd": check_ssd_autograd(gen, part)}
    check_flash_refuses_autograd()
    out["musicgen_serve"] = run_musicgen_serve()
    checks = {"mamba2-130m": ("bfloat16", "float32"),
              "zamba2-1.2b": ("bfloat16",)}
    out["train"] = []
    for arch, batch, S, steps in TRAIN_RUNS:
        out["train"].append(run_train(arch, batch, S, steps, part,
                                      checks.get(arch, ())))
        log(f"{arch} train done at {time.perf_counter() - T0:.1f} s")
    return out


# ------------------------------------------------------------ sharded train
def _last_step_gap(got: dict, want: dict, lr: float) -> dict:
    """tests/test_torch_pretrain.py's bound on one step from one state:
    each param within 1e-3·lr plus one ulp of itself where ``want``'s m
    stands above SHARDED_GRAD_FLOOR of its leaf's largest; the worst
    ratio to that bound, and the largest gap anywhere."""
    from repro_torch.core.flatten import tree_paths
    worst, anywhere = 0.0, 0.0
    m_want = dict(tree_paths(want["opt"]["m"]))
    for (path, g), (_, w) in zip(tree_paths(got["params"]),
                                 tree_paths(want["params"])):
        gap = (g.float() - w.float()).abs()
        anywhere = max(anywhere, float(gap.max()))
        m = m_want[path].abs()
        sure = m > SHARDED_GRAD_FLOOR * m.max()
        w32 = w.float()[sure]
        ulp = (torch.nextafter(w32.abs(), torch.full_like(w32, math.inf))
               - w32.abs())
        ratio = gap[sure] / (1e-3 * lr + ulp)
        worst = max(worst, float(ratio.max()) if ratio.numel() else 0.0)
    return {"worst_over_bound": worst, "max_abs_gap": anywhere}


def run_sharded_train(smi: str) -> dict:
    """Phase 6: the sharded train step (launch/sharded.py) on one NCCL
    rank.  A (1, 1) ("data", "model") DeviceMesh over a process group of
    one, made in this process; mamba2-130m at full width and depth (the
    phase 4 run's config and batches, SHARDED_RUN) for three steps through
    make_train_step and three through the sharded step, from the same
    init: losses within SHARDED_LOSS_RTOL step by step, the params after
    the three steps, and after the last sharded step against the plain
    step from the sharded state before it, at tests/test_torch_pretrain.py's
    bound (one rank computes what the plain step computes: the loss's
    logsumexp is torch's arithmetic), every ssd_scan launch made from
    the scan's local_map region (ssd_scan_sharded; 2 a layer a step with
    remat), and a profiled sharded step whose scan kernels the profiler
    counts.  Then launch/pretrain.py under torch.distributed.run on one
    rank (SHARDED_CLI): exit 0 and finite losses.  ms a step, peak GB and
    the torch version are printed beside the card's name and power
    limit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.models.ssm as ssm
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import KERNELS, reset_launches, ssd_scan
    from repro_torch.launch.mesh import make_host_mesh, to_device_mesh
    from repro_torch.launch.sharded import make_sharded_train_step
    from repro_torch.models import make_train_step
    from repro_torch.sharding.rules import gather

    arch, batch, S, steps = SHARDED_RUN
    cfg = train_config(arch)
    if not cfg.remat:
        raise RuntimeError(f"{arch}: the full config trains with remat")
    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    region = ssm.ssd_scan_sharded
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return region(*args, **kw)
    try:
        device_mesh = to_device_mesh(make_host_mesh(device="cuda"), "cuda")
        batches = _lm_batches(cfg, batch, S, steps)
        runs = {}
        for name in ("plain", "sharded"):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step, init = (make_train_step(cfg) if name == "plain" else
                          make_sharded_train_step(cfg, device_mesh))
            state = init(torch.Generator(device="cuda").manual_seed(0))
            if name == "sharded" and not isinstance(
                    state["params"]["embed"], DTensor):
                raise RuntimeError("the sharded state holds no DTensor")
            reset_launches()
            calls[0] = 0
            ssm.ssd_scan_sharded = counted
            losses, step_s = [], []
            for i, b in enumerate(batches):
                if name == "sharded" and i == steps - 1:
                    before = gather(state)
                t0 = time.perf_counter()
                state, loss = step(state, b)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(loss))
            ssm.ssd_scan_sharded = region
            runs[name] = {
                "losses": losses, "step_s": step_s,
                "ms_per_step": 1e3 * sum(step_s[1:]) / (steps - 1),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k.__name__: k.launches for k in KERNELS},
                "region_calls": calls[0]}
            if name == "plain":
                plain_final = state
            else:
                final = gather(state)
                # two more sharded steps in one profiler session (no
                # schedule), a device sleep between them, the session's
                # longest kernel, marking the boundary.  CUPTI drops
                # records in a session's first milliseconds, so the
                # second step is the one counted
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for i in range(2):
                        if i:
                            torch.cuda._sleep(HOLD_CYCLES)
                        reset_launches()
                        state, _ = step(state, batches[i])
                        torch.cuda.synchronize()
                runs[name]["profiled_step_launches"] = ssd_scan.launches
                runs[name]["profiled_steps"] = _profiled_steps(prof)
            del state
        plain_step, _ = make_train_step(cfg)
        want, want_loss = plain_step(before, batches[-1])
        gap = _last_step_gap(final, want, cfg.learning_rate)
        gap_all = _last_step_gap(final, plain_final, cfg.learning_rate)
        in_super, rem = _mamba_layers(cfg)
        want_launches = steps * (2 * in_super + rem)
        out = {"run": f"{arch} sharded train", "card": smi,
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "mesh": dict(zip(device_mesh.mesh_dim_names,
                                device_mesh.shape)),
               "batch": batch, "seq": S, "steps": steps,
               "params": sum(t.numel() for t in tree_leaves(final["params"])),
               "want_ssd_launches": want_launches,
               "adam_launches_a_step": adam_launches_a_step(
                   final["params"]),
               "last_step_from_carried_state": {
                   "plain_loss": float(want_loss), **gap},
               "params_after_all_steps": gap_all, **runs}
        del before, final, want, plain_final
        torch.cuda.empty_cache()
    finally:
        ssm.ssd_scan_sharded = region
        dist.destroy_process_group()
    out["cli"] = _run_sharded_cli()
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"sharded_train": out}))
    plain, sharded = runs["plain"], runs["sharded"]
    failures = []
    for a, b in zip(sharded["losses"], plain["losses"]):
        if not (math.isfinite(a) and abs(a - b) <= SHARDED_LOSS_RTOL * abs(b)):
            failures.append(f"losses {sharded['losses']} against "
                            f"{plain['losses']}")
            break
    if not abs(sharded["losses"][-1] - out["last_step_from_carried_state"][
            "plain_loss"]) <= SHARDED_LOSS_RTOL * abs(sharded["losses"][-1]):
        failures.append("the last step's loss against the plain step's "
                        "from the same state")
    for label, g in (("the last step from one state", gap),
                     (f"{steps} steps from one init", gap_all)):
        if not g["worst_over_bound"] <= 1.0:
            failures.append(f"params {g['worst_over_bound']:.4g} of the "
                            f"bound after {label}")
    want_adam = steps * out["adam_launches_a_step"]
    for name, run in runs.items():
        launches = run["launches"]
        want = {"ssd_scan": want_launches, "adam": want_adam}
        if any(launches[k] != want.get(k, 0) for k in launches):
            failures.append(f"{name}: launches {launches}, want {want}")
    if sharded["region_calls"] != want_launches:
        failures.append(f"{sharded['region_calls']} ssd_scan_sharded calls "
                        f"for {want_launches} launches")
    # the profiled step: the wrapper's count is exact, and the profiler
    # must see each bf16 pass once a launch; one launch fewer passes only
    # where the profiler's own events show records lost: launches whose
    # kernel record is missing, at least its three and under 1 % of them
    per_step = want_launches // steps
    if sharded["profiled_step_launches"] != per_step:
        failures.append(f"profiled step: {sharded['profiled_step_launches']}"
                        f" ssd_scan launches, want {per_step}")
    counted = sharded["profiled_steps"][-1]
    seen = {counted["scan_kernels"].get(k, 0)
            for k in SSD_KERNEL_NAMES if k != "ssd_kernel"}
    lost = counted["launches_without_kernel"]
    if seen != {per_step} and not (
            seen == {per_step - 1} and (lost or 0) >= 3):
        failures.append(f"profiled step: scan kernels "
                        f"{counted['scan_kernels']} for {per_step} "
                        f"launches ({lost} of {counted['launches']} launch "
                        f"records without a kernel record)")
    if failures:
        raise RuntimeError("sharded train: " + "; ".join(failures))
    return out


def _profiled_steps(prof) -> list:
    """The two steps of a CUDA profile split at its longest kernel (the
    device sleep between them): for each, the scan's kernels that ran on
    the card, the launch records the host made (split at the sleep's own
    launch record, matched by CUPTI correlation id; None where that
    record is lost) and those whose correlation id has no record on the
    card (lost by CUPTI)."""
    on_card, launched = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            on_card.append(e)
        elif "LaunchKernel" in e.name:
            launched[e.id] = e.time_range.start
    marker = max(on_card, key=lambda e: e.time_range.elapsed_us())
    ids = {e.id for e in on_card}
    split = launched.get(marker.id)
    out = []
    for second in (False, True):
        scan = {}
        for e in on_card:
            if e is not marker and (
                    e.time_range.start > marker.time_range.start) == second:
                for k in SSD_KERNEL_NAMES:
                    if k in e.name:
                        scan[k] = scan.get(k, 0) + 1
        step = None if split is None else [
            c for c, t in launched.items()
            if c != marker.id and (t > split) == second]
        out.append({"scan_kernels": scan,
                    "launches": None if step is None else len(step),
                    "launches_without_kernel": None if step is None else sum(
                        1 for c in step if c not in ids)})
    out[1]["marker"] = {"kernel": marker.name[:60],
                        "ms": marker.time_range.elapsed_us() / 1e3}
    return out


def _run_sharded_cli() -> dict:
    """launch/pretrain.py under torch.distributed.run, one rank on the
    card (SHARDED_CLI): exit 0, every logged loss finite."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "repro_torch.launch.pretrain",
         *SHARDED_CLI], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    losses = [float(v) for v in re.findall(r"^step +\d+ loss ([\d.naif]+)",
                                           proc.stdout, re.M)]
    log(f"torch.distributed.run ... repro_torch.launch.pretrain "
        f"{' '.join(SHARDED_CLI)}: exit {proc.returncode} in {wall:.1f} s")
    for line in proc.stdout.splitlines():
        log(f"  | {line}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise RuntimeError(f"launch/pretrain.py (torch.distributed.run) "
                           f"exited {proc.returncode}")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"launch/pretrain.py (torch.distributed.run) "
                           f"logged losses {losses}")
    return {"flags": list(SHARDED_CLI), "wall_s": wall, "losses": losses}


# ------------------------------------------------------------ dry run
def _prediction(cfg, batch: int, S: int, kind: str) -> dict:
    """launch/dryrun.predict of ``cfg`` at (batch, S) on one card's mesh
    (data 1, model 1), on fake tensors on the host's CPU: the numbers this
    phase holds against the card."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import predict
    from repro_torch.launch.mesh import make_host_mesh

    rec = predict(cfg, InputShape(f"{kind} {batch}x{S}", S, batch, kind),
                  make_host_mesh(device="cpu"))
    g, roof = rec["global"], rec["roofline"]
    return {"argument_bytes": g["argument_bytes"], "flops": g["flops"],
            "bytes_accessed": g["bytes_accessed"],
            "peak_bytes": g["argument_bytes"] + g["peak_live_bytes"],
            "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
            "dominant": roof["dominant"], "trace_s": rec["trace_s"]}


def predict_runs() -> dict:
    """The dry run's prediction of each run phase 5 holds, on the host's
    CPU before the runs start: the train runs of TRAIN_RUNS and
    DRY_TRAIN_RUNS and gemma2-2b's prefill, each at its exact config and
    shape.  For a MoE run it first picks the expert
    count: the largest of DRY_MOE_EXPERTS whose predicted peak stays under
    DRY_PEAK_BUDGET (a count whose state and batch alone exceed it is not
    traced)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.cost_analysis import tree_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step

    runs, trials, overrides = {}, [], {}
    for arch, batch, S, _ in TRAIN_RUNS:
        runs[f"{arch} train"] = _prediction(train_config(arch), batch, S,
                                            "train")
    runs[f"{SERVE_ARCH} prefill"] = _prediction(
        get_config(SERVE_ARCH).replace(use_pallas_attention=True), SERVE_B,
        SERVE_S, "prefill")
    # on fake CPU tensors the wrapper runs the plain version: one prediction
    # for both of the card's prefills
    runs[f"{SERVE_ARCH} prefill, plain version"] = runs[
        f"{SERVE_ARCH} prefill"]
    for arch, batch, S, _, cut in DRY_TRAIN_RUNS:
        if not train_config(arch).n_experts:
            runs[f"{arch} train"] = _prediction(train_config(arch, cut),
                                                batch, S, "train")
            overrides[arch] = cut
            continue
        for n in DRY_MOE_EXPERTS:
            cfg = train_config(arch, dict(cut, n_experts=n))
            if cfg.top_k != 1:
                raise RuntimeError(f"{arch}: top-{cfg.top_k}, want top-1")
            step = build_step(cfg, InputShape("probe", S, batch, "train"),
                              make_host_mesh(device="cpu"))
            held = tree_bytes(step.args)
            del step
            if held >= DRY_PEAK_BUDGET:
                trials.append({"experts": n, "argument_bytes": held})
                continue
            pred = _prediction(cfg, batch, S, "train")
            trials.append({"experts": n, **pred})
            if pred["peak_bytes"] < DRY_PEAK_BUDGET:
                runs[f"{arch} train"] = pred
                overrides[arch] = dict(cut, n_experts=n)
                break
        else:
            raise RuntimeError(f"{arch}: no expert count of "
                               f"{DRY_MOE_EXPERTS} fits {DRY_PEAK_BUDGET}")
    return {"runs": runs, "overrides": overrides, "expert_trials": trials}


def run_dry_run(predicted: dict, serve: dict, training: dict,
                part: str) -> dict:
    """Phase 5: the two DRY_TRAIN_RUNS at the cuts the dry run chose, then
    every predicted run against what the card measured (module docstring,
    phase 5)."""
    runs = {f"{r['arch']} train": r for r in training["train"]}
    runs[f"{SERVE_ARCH} prefill"] = serve["lone_prefill"]
    runs[f"{SERVE_ARCH} prefill, plain version"] = serve[
        "lone_prefill_plain_version"]
    for arch, batch, S, steps, _ in DRY_TRAIN_RUNS:
        torch.cuda.empty_cache()
        runs[f"{arch} train"] = run_train(
            arch, batch, S, steps, part, grad_checks=(),
            overrides=predicted["overrides"][arch])
        log(f"{arch} train done at {time.perf_counter() - T0:.1f} s")
    rows, failures = [], []
    for label, pred in predicted["runs"].items():
        got = runs[label]
        step_s = got["ms_per_step"] / 1e3
        peak = got["peak_gb"] * 1e9
        kernel_free = not any(n for k, n in got["launches"].items()
                              if k != "adam")
        row = {"run": label, "launches": got["launches"],
               "argument_bytes": pred["argument_bytes"],
               "held_bytes": got["held_bytes"],
               "flops": pred["flops"], "card_flops": got["card_flops"],
               "flop_gap": (pred["flops"] - got["card_flops"])
               / pred["flops"],
               "compute_s": pred["compute_s"], "memory_s": pred["memory_s"],
               "dominant": pred["dominant"], "step_s": step_s,
               "peak_bytes": pred["peak_bytes"], "card_peak_bytes": peak,
               "peak_ratio": pred["peak_bytes"] / peak,
               "trace_s": pred["trace_s"]}
        rows.append(row)
        if row["argument_bytes"] != row["held_bytes"]:
            failures.append(f"{label}: argument bytes {row['argument_bytes']}"
                            f" != the {row['held_bytes']} the run holds")
        if not step_s >= row["compute_s"]:
            failures.append(f"{label}: {step_s:.4g} s a step, below "
                            f"compute_s {row['compute_s']:.4g}")
        lo, hi = DRY_PEAK_RATIO
        if not lo <= row["peak_ratio"] <= hi:
            failures.append(f"{label}: predicted / measured peak "
                            f"{row['peak_ratio']:.4g} outside {lo}-{hi}")
        if kernel_free and not abs(row["flop_gap"]) <= DRY_FLOP_RTOL:
            failures.append(f"{label}: FLOPs {row['flops']:.6g} fake, "
                            f"{row['card_flops']:.6g} on the card")
    out = {"rows": rows, "overrides": predicted["overrides"],
           "expert_trials": predicted["expert_trials"]}
    log(json.dumps({"dry_run": out}))
    if failures:
        raise RuntimeError("dry run against the card: " + "; ".join(failures))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    run_lint()
    smi = phase_environment()
    part = card_part(smi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_fed_agg(gen, part), check_fed_agg_apply(gen, part),
            check_fed_agg_sharded(gen, part),
            check_fed_agg_apply_sharded(gen, part),
            *check_int8(gen, part), check_topk_mask(gen, part),
            check_flash_attention(gen, part), check_ssd_scan(gen, part),
            check_adam(gen, part)]
    row_of = {row["name"]: row for row in rows}
    check_moe_layer(gen)
    log(f"phase 2 done at {time.perf_counter() - T0:.1f} s")

    # the default path on the card is the vectorized executor; one run
    # keeps the eager loop driven
    check_executor_full_width()
    eager = run_main_path("fedlesscan (eager)", vectorized=False)
    native = run_main_path("fedlesscan (eager, cudnn off)", vectorized=False,
                           cudnn=False)
    floor = check_runs_agree(eager, native)
    fedlesscan = run_main_path("fedlesscan")
    check_runs_agree(fedlesscan, eager, floor)
    fedadam = run_main_path("fedavg+fedadam", strategy="fedavg",
                            server_opt="fedadam", server_opt_lr=0.01)
    n_chunks = -(-MAIN_P // MAIN_CHUNK)
    int8 = run_main_path(
        "fedlesscan+int8", compress_scheme="int8",
        ratio=round(4 * MAIN_P / (MAIN_P + 4 * n_chunks), 4))
    topk = run_main_path(
        "fedlesscan+topk", compress_scheme="topk",
        compress_topk_ratio=TOPK_RATIO,
        ratio=round(4 * MAIN_P / (8 * CODEC_KS[-1]), 4))
    # executor and merge on two-slot meshes of the one card
    from repro_torch.launch.mesh import Mesh
    meshes = (Mesh(("cuda:0",) * 2, (("data", 2), ("model", 1))),
              Mesh(("cuda:0",) * 2, (("clients", 2),)))
    sharded = run_main_path("fedlesscan+sharded", meshes=meshes)
    check_runs_agree(sharded, fedlesscan, floor)
    fedadam_sharded = run_main_path(
        "fedavg+fedadam+sharded", meshes=meshes, strategy="fedavg",
        server_opt="fedadam", server_opt_lr=0.01)
    check_runs_agree(fedadam_sharded, fedadam, floor, same_trace=False)
    for run, name in ((sharded, "fed_agg_sharded"),
                      (fedadam_sharded, "fed_agg_apply_sharded")):
        merges = sum(1 for m in run["merged_updates"] if m)
        if run["launches"][name] < 3 or run["launches"][name] != merges:
            raise RuntimeError(f"{run['run']}: {run['launches'][name]} "
                               f"{name} launches for {merges} merges in 3 "
                               f"rounds")
    for run in (fedlesscan, fedadam, int8, topk):
        if run["launches"]["fed_agg_sharded"] or run["launches"][
                "fed_agg_apply_sharded"]:
            raise RuntimeError(f"{run['run']}: a sharded wrapper launched "
                               f"without a mesh")
    profile_local_training()
    profile_vectorized_round()
    log(f"FEMNIST runs done at {time.perf_counter() - T0:.1f} s")
    # the rest of the paper's experiment: its other two models, a
    # multi-platform fleet, checkpoint/resume
    check_lstm_executor_full_width()
    small_models = run_small_models()
    check_speech_dropout()
    fleet = run_platforms()
    check_checkpoint_resume()
    new_runs = [r for m in small_models.values()
                for r in (m["executor"], m["eager"])]
    row_of["fed_agg"]["merge_sizes"] = check_merge_sizes(gen, part,
                                                         new_runs)
    profiles = {"shakespeare": profile_vectorized_round("shakespeare"),
                "speech": profile_vectorized_round("speech", epochs=1)}
    log(json.dumps({"small_models": {
        name: {"params": m["executor"]["params"],
               "executor_wall_s_per_round":
                   m["executor"]["wall_s_per_round"],
               "eager_wall_s_per_round": m["eager"]["wall_s_per_round"],
               "executor_ms_per_step": m["executor"]["ms_per_local_step"],
               "profiled_ms_per_step": profiles[name]["wall_ms_per_step"],
               "executor_device_ops_per_step":
                   profiles[name]["device_ops_per_step"],
               "executor_device_busy_share":
                   profiles[name]["device_busy_share"],
               "eager_ms_per_client_step": m["eager"]["ms_per_local_step"],
               "params_rel_l2": m["gap"]["rel_l2"]}
        for name, m in small_models.items()}}))
    log(json.dumps({"platforms": {
        "executor_wall_s_per_round": fleet["executor"]["wall_s_per_round"],
        "eager_wall_s_per_round": fleet["eager"]["wall_s_per_round"],
        "eager_ms_per_client_step": fleet["eager"]["ms_per_local_step"],
        "params_rel_l2": fleet["gap"]["rel_l2"]}}))
    log(f"FL runs done at {time.perf_counter() - T0:.1f} s")
    federated_ssm = run_federated_ssm(gen, part)
    run_example_clis()
    log(f"federated ssm phase done at {time.perf_counter() - T0:.1f} s")
    predicted = predict_runs()
    log(json.dumps({"dry_run_predictions": predicted}))
    log(f"dry run predictions done at {time.perf_counter() - T0:.1f} s")
    serve = run_serve(row_of["flash_attention"])
    log(f"{SERVE_ARCH} serve done at {time.perf_counter() - T0:.1f} s")
    ssm_serves = []
    for spec in SSM_SERVES:
        ssm_serves.append(run_ssm_serve(*spec))
        log(f"{spec[0]} serve done at {time.perf_counter() - T0:.1f} s")
    zoo = run_zoo(part)
    training = run_training(gen, part)
    log(f"train phase done at {time.perf_counter() - T0:.1f} s")
    sharded_train = run_sharded_train(smi)
    log(f"sharded train phase done at {time.perf_counter() - T0:.1f} s")
    run_dry_run(predicted, serve, training, part)
    log(f"dry run phase done at {time.perf_counter() - T0:.1f} s")
    # which run's launches each kernel's row reports
    runs = {"fed_agg": fedlesscan, "fed_agg_apply": fedadam,
            "fed_agg_sharded": sharded,
            "fed_agg_apply_sharded": fedadam_sharded,
            "int8_encode": int8, "int8_decode": int8, "topk_mask": topk,
            "flash_attention": serve, "ssd_scan": ssm_serves[0],
            "adam": fedlesscan}
    for row in rows:
        run = runs[row["name"]]
        row["launches"] = run["launches"][row["name"]]
        if row["launches"] < 1:
            raise RuntimeError(f"the {run['run']} run never launched "
                               f"{row['name']}")
    # ssd_scan in training: mamba2-130m's launches (the forward, rerun by
    # remat), its kernel forward and plain backward at the train shape
    mamba_train = training["train"][0]
    row_of["ssd_scan"].update({
        "train_launches": mamba_train["launches"]["ssd_scan"],
        "train_shape": mamba_train["arch"] + " (8, 4096, 24, 64, 128) bf16",
        "train_ms": training["ssd_autograd"]["mamba2-130m"][
            "kernel_forward_ms"],
        "train_plain_backward_ms": training["ssd_autograd"]["mamba2-130m"][
            "plain_backward_ms"]})
    # the federated SSM run: the scan under the executor's vmap rule, the
    # merge at mamba2-130m's P
    row_of["ssd_scan"].update({
        "executor_launches": federated_ssm["executor_launches"]["ssd_scan"],
        "executor_steps": federated_ssm["executor_steps"],
        "executor_shape": federated_ssm["scan_shapes"],
        **{f"executor_{k}": federated_ssm["scan_at_folded_shape"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")}})
    fed_ssm_merge = federated_ssm["fed_agg"]
    row_of["fed_agg"].update({
        "ssm_launches": federated_ssm["executor_launches"]["fed_agg"],
        **{f"ssm_{k}": fed_ssm_merge[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape")}})
    # the sharded train step (phase 6): its launches, all from the scan's
    # local_map region on one NCCL rank
    row_of["ssd_scan"]["sharded_train_launches"] = sharded_train[
        "sharded"]["launches"]["ssd_scan"]
    row_of["flash_attention"]["musicgen_launches"] = training[
        "musicgen_serve"]["launches"]["flash_attention"]
    for arch, _, _ in ZOO_SERVES:
        row_of["flash_attention"][f"{arch}_launches"] = zoo[arch][
            "launches"]["flash_attention"]
    # adam in training and in the sharded train step: make_train_step's
    # launches, held to the steps' count by run_train / run_sharded_train
    row_of["adam"].update({
        "train_launches": mamba_train["launches"]["adam"],
        "sharded_train_launches": sharded_train["sharded"]["launches"][
            "adam"]})
    if int8["launches"]["int8_encode"] != int8["launches"]["int8_decode"]:
        raise RuntimeError(f"int8 launches differ: {int8['launches']}")
    if int8["launches"]["fed_agg"] < 1 or topk["launches"]["fed_agg"] < 1:
        raise RuntimeError("a compressed run never launched fed_agg")
    extra_keys = {
        "flash_attention": ("vlm_ms", "vlm_plain_ms", "vlm_bound_ms",
                            "vlm_library_ms"),
        "adam": ("library_ms", "lm_ms", "lm_plain_ms", "lm_bound_ms",
                 "lm_library_ms")}
    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms") + extra_keys.get(
                row["name"], ()):
            if not (isinstance(row[key], float) and math.isfinite(row[key])):
                raise RuntimeError(f"{row['name']}: bad {key} {row[key]}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
