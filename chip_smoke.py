#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds the port's CUDA kernels from the sources in this checkout,
reports what the attention kernels, the SSD scan, the router and the
GRU's cluster kernel compiled to (tensor-core, 16-byte load,
warp-reduction and cluster-barrier instructions, registers, spills; a
process of its own works this out beside the card's phases, and its
line comes after them), holds each kernel against its plain PyTorch version on the card (the
router and FedAvg beside an empty kernel's launch floor, the GRU beside
a kernel that only exchanges its state), differentiates the reduced GRU's loss
on the card through ``gru_seq`` against the CPU, then drives these paths
through the entry points a user calls:

- the paper's GRU replica-serving path at full width (2 layers, hidden
  128): flat, cluster and global FedAvg over 20 client replicas, a
  three-tier ``ReplicaPool`` serving request batches (with one failover)
  from the global model, and the latency model calibrated from the
  pool's timings, every result held against the same functions on the
  CPU, where the wrappers take the kernels' plain versions;
- the paper's training pipeline at full width (the quickstart's steps
  on Fig. 6's 20 clients): HFLOP clustering, one local and one global
  round of continual hierarchical FedAvg, every
  minibatch and validation forward in ``gru_seq`` and every aggregation
  in ``fedavg_reduce``, held against the same run on the CPU from the
  same numpy model and minibatch orders; a profile of one training step;
  the routing simulator with its default latencies and calibrated from
  the deployment's replica pool;
- LM replica serving of stablelm-1.6b at its published width (24
  layers, d 2048, bf16, random weights from a seed): the dense tiers
  (``lm_tiers``) and the paged tiers (``paged_lm_tiers``) on one shared
  weight tree, request batches at every tier, one failover, the
  measured occupancy sweep into the latency model; then the same
  entry points at full width but 2 layers in fp32 on the card and on the
  CPU, held against each other;
- MoE + MLA replica serving of deepseek-v2-lite-16b at its published
  width (27 layers, d 2048, MLA with kv_lora 512, 64 routed experts top-6
  and 2 shared, bf16, 15.7 B random weights drawn on the card from a
  seed), through the same entry points and checks, and its own 2-layer
  fp32 cut (the lead dense layer and one MoE layer) on the card and on
  the CPU;
- the zamba2-1.2b hybrid at its published width (38 Mamba2 layers, d
  2048, 64 SSD heads, one shared attention block after every 6 layers,
  bf16, 1.1 B random weights drawn on the card from a seed): its
  full-sequence forward and loss on a (2, 1024) token batch, whose
  Mamba2 scans run in ``mamba_chunk_scan``, and dense-tier serving, whose
  prompts are fed token by token through the decode step; then a 6-layer
  fp32 cut (one shared block) on the card and on the CPU;
- gemma3-1b at its published width (26 layers, d 1152, 5 local layers
  windowed at 512 to 1 global, QK-norm, 4 query heads on one kv head of
  dim 256, vocab 262,144, bf16, random weights drawn on the card from a
  seed): the three attention kernels at head dim 256, stablelm's dense
  and paged tiers and requests, a long-context run (a 600-token prompt
  and 16 new tokens at max_len 1024, so the local layers' 512-slot rings
  wrap and their window cuts flash, decode and paged decode), Poisson
  arrivals through ``ContinuousBatchingScheduler`` on a dense and a
  paged tier with a ``Telemetry`` attached, and a 6-layer fp32 cut with
  the long prompt on the card and on the CPU;
- the last model families: whisper-small's attention shapes (flash
  without the causal mask over 1500 frames and from 16 / 64 tokens to
  them, decode over 1500 rows), xlstm-125m at its published width (12
  blocks, d 768; forward and loss, the three default ``lm_tiers()``
  tiers, which launch no kernel: the JAX package has none for xLSTM),
  whisper-small at its published width (12 + 12 layers; encode, forward
  and loss, decode over primed cross rows, a dense tier, exact launch
  counts), each with a 2-layer fp32 cut on the card and on the CPU, and
  internvl2-76b's reduced config with its patch prefix (forward, loss,
  both engines) on the card and on the CPU.
- the LM training layer: hierarchical-FL training of gemma3-1b at its
  published width (bf16, AdamW, 2 clusters of batch 4 x 64 tokens from
  their TokenStream shards, 4 local rounds, a global round every 2: one
  plain and one int8 with error feedback), every forward's attention in
  ``flash_attention`` and both syncs' means in ``fedavg_reduce``, with
  exact launch counts, bit-identical replicas after each sync, peak
  memory and a profiled local round, each layer checkpointed (the
  config's ``remat="layer"``: the backward launches its flash again);
  then the same model's gradients on one (1, 4096) sequence without and
  with the checkpoints (remat: losses and gradients equal, activation
  memory, device time, 26 against 52 flash launches); then a 2-layer
  fp32 cut trained and synced on the card and on the CPU, and the
  reduced deepseek-v2-lite at two microbatches (``topk_router``);
- the distributed HFL layer: the same gemma3-1b run with one FL cluster
  a process, 2 ranks on the one card over gloo (``run_ranks``, a
  (cluster 2, data 1) ``DeviceMesh``): each rank's local rounds through
  ``make_hfl_local_step_shardmap``, a ``global_sync_shardmap``, a
  ``compressed_global_sync_shardmap`` (int8 on the wire) and a
  ``compressed_global_sync_manual`` on the same inputs; round-1 losses
  against the single-process run, replicas bit-identical across ranks
  after each sync, exact launches and the bytes each collective carried.
- the reference's production decode layout (split_decode): stablelm-1.6b
  and gemma3-1b at full width in bf16, and fp32 cuts of each, decoding
  4 steps from 32,768-slot caches drawn from the seed whose slots are
  split over 2 ranks on the one card (gloo; ``kv_seq`` over ``model``
  under DEFAULT_RULES), each rank's share through
  ``decode_attention_partial`` and the shares merged across the ranks,
  held against the unsharded ``decode_step`` on the same weights and
  cache (every layer's attention on the same inputs, the fp32 cuts'
  logits); the partial instance beside its plain version at a rank's
  share of 16,384 slots.
- the reference's expert-parallel MoE (ep_moe): deepseek-v2-lite-16b at
  full width in bf16 under EXPERT_PARALLEL_RULES on 2 ranks on the one
  card (gloo, a (data 1, model 2) mesh: each rank holds 32 of the 64
  routed experts and runs its experts' slots of the dispatch; its
  shards drawn from the seed), a forward and loss on (2, 256) tokens
  and 2 paged decode steps after the unsharded paged prefill, against
  the unsharded port (every MoE layer's routed block replayed on the
  same input, the logits against the control: the kernels' plain
  versions), and 2-layer fp32 cuts with gradients under those rules and
  under the override expert=("data",) on (data 2, model 1), whose
  dispatch is an all-to-all; the kernels beside their plain versions
  at a rank's shapes.
- the dry-run launch layer (dryrun): ``launch/dryrun.py``'s
  ``run_combo`` at full width on the host, over a fake world:
  gemma3-1b's train_4k on the 256-rank mesh and decode_32k on the
  512-rank one, and deepseek-v2-lite-16b's decode_32k on the 256-rank
  mesh under EXPERT_PARALLEL_RULES and under expert=("data",) (one
  subprocess each, a record a line); meanwhile, in a
  one-rank NCCL process, gemma3-1b's loss at train_slice's shape as
  DTensors under the production rules (``flash_attention`` reached
  through ``local_map``), against the unsharded loss, beside the
  analytic roofline of train_slice's step on one rank, and its
  gradients through the DTensors and a checkpoint a layer against the
  unsharded port's.

Each phase prints one JSON line.  The line before the last lists every
kernel with its launches on the main path, its error against its plain
version and its times beside the card's bound; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero, with no result,
without CUDA, outside a checkout of the repo, or when a phase fails.

    python3 chip_smoke.py
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
#: NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor
#: cores, dense bf16 tensor-core rate (the bound of the bf16 attention
#: rows; the kernels' arithmetic is fp32 either way)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
#: tolerances of tests/test_kernels.py (GRU 2e-5; fp32 3e-5, bf16 3e-2)
GRU_TOL = 2e-5
FEDAVG_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: end to end, the card and the CPU sum matrix products in other orders;
#: two stacked layers and the head compound that
PRED_TOL = 1e-4
#: the loss gradients of the reduced GRU, card against CPU: the forward's
#: recurrence is the kernel's on the card, the backward the plain
#: version's on both, so they differ as the predictions do
GRAD_TOL = 1e-4
#: the slice: 20 clients in cluster ids 0, 1 and 3 (id 2 has no members)
CLUSTER_IDS = np.array([0] * 8 + [1] * 7 + [3] * 5)
TIER_BATCH = {"device": 1, "edge": 4, "cloud": 16}
HISTORY = 12
BATCHES_PER_TIER = 3
#: the HFL slice: the paper's Fig. 6 setup (20 clients, 5 a geographic
#: cluster, 5 local epochs, batch 16, lr 1e-4, l = 2) for one local and
#: one global round of hierarchical FedAvg; each epoch cut to 4
#: minibatches, the epochs to 2 (a depth cut to keep the whole run in
#: its time limit: hfl_slice took 70.0 s at 5 on an H100 80GB HBM3 at
#: 700 W, the CPU's run most of it), the validation week to 128 windows
#: a client.  Card against CPU: val MSE within 1e-4 relative,
#: parameters within 1e-4 absolute
HFL_PER_CLUSTER = 5
HFL_RUN = dict(rounds=2, local_epochs=2, batch_size=16, lr=1e-4,
               max_batches=4, max_val_windows=128)
HFL_TOL = 1e-4
HFL_SIM_S = 60
HFL_PROFILE_STEPS = 20
#: attention kernels against their plain versions: tests/test_kernels.py
ATTN_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: a bf16 GQA decode row whose walk the kernel splits over blocks (S > 1)
#: is also held within this many bf16 ulps of its plain version at each
#: output vector's largest magnitude: both accumulate in fp32 from the
#: same inputs and round once.  3e-2 alone may not see a chunk dropped
#: from a long row (the mean of V over 1,500 slots moves by less), and
#: every split row's check must reject the plain output with the last
#: chunk that counts a slot masked out (the power check)
DECODE_SPLIT_ULPS = 1.0
#: seconds the sass report (run beside the card's phases) may still take
#: once they have ended
SASS_TIMEOUT = 300
#: a bf16 flash row is also held within this many bf16 ulps of its plain
#: version at each output vector's largest magnitude, split or not: the
#: kernel rounds P to bf16 for P.V, the plain version keeps it in fp32,
#: and both round once at the end (every bf16 row measured 1.0 on an
#: H100).  Over whisper's 1,500 keys a row's outputs are about as small
#: as 3e-2, so 3e-2 alone would pass a chunk merged with a wrong weight;
#: every split row's check must reject the plain output with each
#: block's last chunk masked out (the power check)
FLASH_ULPS = 1.0
#: the LM slice: stablelm-1.6b at full width, 8 tokens per request, two
#: request batches per tier (B = the tier's rows).  Prompts of 56 tokens
#: (prefill bucket 64): a paged tier's page budget is what its dense
#: counterpart reserves, 64 tokens a row at its full row count, so a
#: 64-token prompt plus 8 decoded tokens (5 pages) would not fit 32 rows
#: in the cloud's 128 pages.  ``measure()`` times 8 decode steps a
#: level (a depth cut from 16: three quarters of the slices' decode
#: steps were its, and deepseek's are host-bound at ~0.17 s each)
LM_ARCH = "stablelm-1.6b"
LM_PROMPT = 56
LM_STEPS = 8
LM_BATCHES_PER_TIER = 2
LM_MEASURE = dict(prompt_len=64, decode_steps=8, occupancy_levels=(1, 4, 8))
#: the CPU-parity run: full width, 2 layers (a depth cut only), fp32;
#: prefill logits on the card against the CPU (fp32 sums in other
#: orders through 2 layers and a 2048-wide head)
PARITY_LAYERS = 2
PARITY_LOGIT_TOL = 1e-3
#: the MoE slice: deepseek-v2-lite-16b at full width, with the LM slice's
#: requests, measurement and parity cut (its 2 layers: the lead dense
#: layer and one MoE layer)
MOE_ARCH = "deepseek-v2-lite-16b"
#: topk_router against its plain version: tests/test_kernels.py's weight
#: tolerance, and indices identical
ROUTER_TOL = 1e-6
#: the hybrid slice: zamba2-1.2b at full width.  Its weight count is
#: the JAX tree's (``param_count()`` is coarse for the hybrid); the
#: forward scores 2 sequences of 1024 tokens (8 chunks of 128 a layer)
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PARAMS = 1_104_937_856
HYBRID_BATCH = (2, 1024)
#: mamba_chunk_scan against its plain version: tests/test_kernels.py's
#: 5e-4 for fp32 and bf16's 3e-2 for y.  The fp32 state takes 5e-4 from
#: bf16 inputs too: kernel and plain version read the same bf16 values
#: and do fp32 arithmetic, so only the order of fp32 sums differs.
SCAN_TOL = {"float32": 5e-4, "bfloat16": 3e-2}
SCAN_STATE_TOL = 5e-4
#: the hybrid's parity cut: full width, 6 layers (one complete segment,
#: so the shared block runs once), fp32, a (2, 256) batch (2 chunks);
#: stepwise decode against the forward within
#: tests/test_decode_consistency.py's 2e-3, and the card's forward
#: against the CPU's within the same 2e-3, not the LM cuts' 1e-3: the
#: phase also reports each side's distance from an fp64 forward of the
#: same code, and on an H100 the card's fp32 logits lie about 1.1e-3 from
#: it (the plain scan in place of the kernel does no better), the CPU's
#: about 4e-4, so fp32 on the card does not reach 1e-3 on this cut
HYBRID_PARITY_LAYERS = 6
HYBRID_PARITY_SEQ = 256
HYBRID_PARITY_LOGIT_TOL = 2e-3
DECODE_TOL = 2e-3
#: the hybrid admits a prompt token by token, one ~40-layer decode step
#: each, so its measure() probes with 8-token prompts and its profile
#: admits 8-token prompts (a step's cost does not depend on the prompt)
HYBRID_MEASURE = dict(prompt_len=8, decode_steps=8,
                      occupancy_levels=(1, 4, 8))
HYBRID_PROFILE_PROMPT = 8
#: the hybrid's served request batches: prompts of 8 tokens, as its
#: measure() probes with (a depth cut: it admits a prompt with a decode
#: step a token, and hybrid_slice's serving_seconds were 120.0 at 56
#: tokens, 36.7-77.8 at 16, on an H100 80GB HBM3 at 700 W); xlstm's and
#: whisper's served prompts and recurrent parity cuts take the same
HYBRID_PROMPT = 8
#: the gemma3 slice: gemma3-1b at full width, with the LM slice's tiers,
#: requests and measurement
GEMMA_ARCH = "gemma3-1b"
#: the long-context run: one dense and one paged engine of LONG_ROWS rows
#: at max_len 1024, a 600-token prompt (bucket 1024) and 16 new tokens,
#: so the local layers' 512-slot rings wrap and their 512 window cuts
#: flash (T 1024), decode and paged decode
LONG_PROMPT = 600
LONG_STEPS = 16
LONG_MAX_LEN = 1024
LONG_ROWS = 2
#: gemma3's parity cut: 6 layers at full width (5 local, 1 global), fp32,
#: the long prompt, LONG_ROWS rows
GEMMA_PARITY_LAYERS = 6
#: the scheduler phase: Poisson arrivals onto the cloud tiers (8 dense
#: slots; 32 paged rows over 128 pages).  Requests as the reference's
#: serve launcher sends them (src/repro/launch/serve.py's defaults: 32
#: requests over 8 arrival streams, 16-token prompts, 8 new tokens); the
#: rate is SCHED_LOAD of the tier's capacity, which ``measure()`` gives on
#: the same engine just before: a request costs one prefill and its 7
#: decode steps' share of a step at full occupancy
SCHED_REQUESTS = 32
SCHED_PROMPT = 16
SCHED_NEW_TOKENS = 8
SCHED_LOAD = 0.5
#: the xLSTM slice: xlstm-125m at full width (12 layers, d 768, 4 heads,
#: sLSTM at layers 3 and 9), bf16, the LM tiers' default arch; its weight
#: count is the JAX tree's (``param_count()`` leaves out the blocks' own
#: projections), its forward batch (2, 256)
XLSTM_ARCH = "xlstm-125m"
XLSTM_PARAMS = 155_764_304
XLSTM_BATCH = (2, 256)
#: the whisper slice: whisper-small at full width (12 encoder and 12
#: decoder layers, d 768, 12 heads of dim 64, 1500 frames), bf16; the
#: JAX tree's weight count; a forward on 64 tokens, 8 decode steps over
#: the primed cross rows, and one dense tier (4 slots) serving 16-token
#: prompts
WHISPER_ARCH = "whisper-small"
WHISPER_PARAMS = 238_187_520
WHISPER_TOKENS = 64
WHISPER_STEPS = 8
WHISPER_TIER = "edge"
#: the vlm slice: internvl2-76b's reduced config (80 layers of d 8192 do
#: not fit one card)
VLM_ARCH = "internvl2-76b"
#: the LM training slice: gemma3-1b at full width, bf16, 2 clusters of
#: batch 4 x 64 tokens, AdamW lr 1e-3; 4 local rounds, a global round
#: every 2 (l = 2): first plain, then int8 with error feedback
TRAIN_ARCH = GEMMA_ARCH
TRAIN_CLUSTERS = 2
TRAIN_BATCH = 4
TRAIN_SEQ = 64
TRAIN_ROUNDS = 4
TRAIN_GLOBAL_EVERY = 2
TRAIN_LR = 1e-3
#: tests/test_torch_training.py's tolerances: losses relative; updates
#: in units of the larger of lr and the leaf's largest update
TRAIN_LOSS_RTOL = 3e-5
TRAIN_UPDATE_TOL = 1e-3
#: the card-vs-CPU training cut: 2 layers, fp32, batch 2, 2 local SGD
#: steps; and the reduced MoE at 2 microbatches
TRAIN_PARITY_LAYERS = 2
TRAIN_PARITY_BATCH = 2
TRAIN_PARITY_STEPS = 2
TRAIN_PARITY_LR = 1e-3
TRAIN_MOE_K = 2
#: the remat phase: gemma3-1b at full width, bf16, one cluster, one
#: sequence of the dry run's train_4k length, differentiated without and
#: with per-layer activation checkpointing
REMAT_BATCH = (1, 4096)
#: the distributed slice: train_slice's configuration, schedule and seed
#: with one FL cluster a process: 2 ranks sharing the one card over gloo
#: (NCCL refuses two ranks on one device), a (cluster 2, data 1) mesh.
#: Both ranks step at once: 28.6 GB peak each on an H100 80GB HBM3
DIST_RANKS = TRAIN_CLUSTERS
DIST_BACKEND = "gloo"
DIST_TIMEOUT = 420
#: the dry-run phase: full-width combos traced on a fake world of 256 /
#: 512 ranks on the host (each combo in a process of its own), under the
#: config's rules (None) or a rule set of DRYRUN_RULES: deepseek's
#: decode_32k under EXPERT_PARALLEL_RULES (its 64 experts 8 a rank over
#: model 8) and under the override expert=("data",) (an all-to-all over
#: data); and sharded_step: train_slice's gemma3-1b loss through the
#: production rules on a one-rank CUDA mesh (nccl: one rank on its card)
DRYRUN_COMBOS = (("single", GEMMA_ARCH, "train_4k", None),
                 ("multi", GEMMA_ARCH, "decode_32k", None),
                 ("single", MOE_ARCH, "decode_32k", "expert_parallel"),
                 ("single", MOE_ARCH, "decode_32k", "expert_over_data"))
DRYRUN_TIMEOUT = 240
#: sharded_step's loss against the unsharded port's, the same card
DRYRUN_LOSS_TOL = 1e-3
#: the split decode: decode_32k's 32,768-slot cache (the reference's
#: production decode layout) laid out by ``cache_shardings`` under
#: DEFAULT_RULES on a (data 1, model 2) mesh of 2 ranks on the one card
#: over gloo, so ``kv_seq`` takes ``model`` and each rank holds half the
#: slots; drawn from the seed, not prefilled.  Tokens cached a row before
#: the first step: all in rank 0's half, both halves, a wrapped ring.
#: The cases: (arch, dtype, layers or None for the published depth);
#: gemma3's fp32 cut keeps 6 layers, the first with a global layer (a
#: 2-layer cut would hold only its 512-slot local rings)
SPLIT_SLOTS = 32_768
SPLIT_TOKENS = (3_000, 20_000, 40_000)
SPLIT_STEPS = 4
SPLIT_CASES = ((LM_ARCH, "bfloat16", None), (LM_ARCH, "float32", 2),
               (GEMMA_ARCH, "bfloat16", None), (GEMMA_ARCH, "float32", 6))
SPLIT_TOL = ATTN_TOL
#: the partial instance's (o / l, m, l) against its plain version's,
#: whatever q's dtype: both compute in fp32 from the same inputs and
#: return fp32, so bf16's 3e-2 would pass an o of zeros (o / l is a mean
#: of V, ~0.01 at 16,384 slots)
PARTIAL_TOL = ATTN_TOL["float32"]
#: each layer's bf16 attention output on the ranks against the unsharded
#: kernel's and the plain version's on the same inputs: both sides
#: accumulate in fp32 and round once, so at most one bf16 ulp apart
SPLIT_ATTN_ULPS = 1.0
#: the bf16 models' logits gap to the unsharded run, at most this many
#: times the control's, the unsharded run with the plain decode against
#: the kernel: with random weights either gap grows through the layers
#: to the logits' scale (on an H100 the ratios were 1.37 for
#: stablelm-1.6b and 1.43 for gemma3-1b; PERF.md)
SPLIT_CONTROL_FACTOR = 2.0
SPLIT_TIMEOUT = 400
#: a rank's share of gemma3-1b's 512-slot local rings (its window)
LOCAL_SHARE = 256
#: the expert-parallel MoE (ep_moe): deepseek-v2-lite-16b at full width
#: in bf16 under the reference's EXPERT_PARALLEL_RULES on a (data 1,
#: model 2) mesh of 2 ranks on the one card over gloo, so each rank holds
#: 32 of the 64 routed experts (and draws only its shard of each weight
#: from the seed): a forward and loss on EP_BATCH tokens, then EP_STEPS
#: paged decode steps on DTensors after the parent's unsharded paged
#: prefill of EP_PROMPT tokens a row (pages of EP_PAGE tokens)
EP_BATCH = (2, 256)
EP_PROMPT = 64
EP_STEPS = 2
EP_PAGE = 16
EP_TIMEOUT = 600
#: each MoE layer's routed block on the ranks, replayed on its recorded
#: input into the unsharded block and into its plain version (the
#: router's): a token's k weighted expert rows are summed in fp32 and
#: rounded once unsharded; each rank rounds its partial sum and the two
#: partials' sum is rounded again, so at most two bf16 ulps apart (at
#: each token's largest output)
EP_BLOCK_ULPS = 2.0
#: the bf16 logits' gap to the unsharded run, at most this many times the
#: control's, the unsharded run with every kernel's plain version against
#: the kernels: with random weights either gap grows through the 27
#: layers (PERF.md)
EP_CONTROL_FACTOR = 2.0
#: the fp32 cut: the lead dense layer and one MoE layer, the loss and
#: every gradient (gathered to full) against the unsharded port's on the
#: card, under (a) EXPERT_PARALLEL_RULES on (data 1, model 2) and (b)
#: the override expert=("data",) on (data 2, model 1), where each rank
#: routes its own row and the dispatch is an all-to-all (the unsharded
#: reference then the mean over the rows, capacity being per rank's
#: tokens); the attention's query and key projections rescaled to a
#: fan-in over their input, as the CPU tests do
EP_CUT_LAYERS = 2
EP_CUT_TOL = 3e-5
EP_OVERRIDE = (("expert", ("data",)),)
#: served trees at full width: leaf -> shape
FULL_WIDTH = {
    LM_ARCH: {("layers", "attn", "wq"): (24, 2048, 32, 64)},
    MOE_ARCH: {("lead", "0", "attn", "wq"): (2048, 16, 192),
               ("lead", "0", "mlp", "wi_gate"): (2048, 10944),
               ("layers", "attn", "wq"): (26, 2048, 16, 192),
               ("layers", "attn", "w_uk"): (26, 512, 16, 128),
               ("layers", "moe", "router"): (26, 2048, 64),
               ("layers", "moe", "wi_gate"): (26, 64, 2048, 1408),
               ("layers", "moe", "shared", "wi_gate"): (26, 2048, 2816)},
    GEMMA_ARCH: {("embed", "table"): (262_144, 1152),
                 ("layers", "attn", "wq"): (26, 1152, 4, 256),
                 ("layers", "attn", "wk"): (26, 1152, 1, 256),
                 ("layers", "attn", "q_norm"): (26, 256),
                 ("layers", "mlp", "wi"): (26, 1152, 6912)},
    HYBRID_ARCH: {("mamba_layers", "mamba", "in_proj"): (38, 2048, 8384),
                  ("mamba_layers", "mamba", "conv_w"): (38, 4, 4224),
                  ("mamba_layers", "mamba", "A_log"): (38, 64),
                  ("mamba_layers", "mamba", "out_proj"): (38, 4096, 2048),
                  ("shared", "attn", "wq"): (2048, 32, 64),
                  ("shared", "mlp", "wi_gate"): (2048, 8192)},
    XLSTM_ARCH: {("blocks", "0", "wq"): (1536, 4, 384),
                 ("blocks", "0", "w_up"): (768, 3072),
                 ("blocks", "3", "r_i"): (4, 192, 192),
                 ("blocks", "3", "w_up"): (768, 2 * 1023),
                 ("blocks", "9", "w_down"): (1023, 768)},
    WHISPER_ARCH: {("encoder", "attn", "wq"): (12, 768, 12, 64),
                   ("decoder", "cross_attn", "wk"): (12, 768, 12, 64),
                   ("decoder", "mlp", "wi"): (12, 768, 3072),
                   ("embed", "table"): (51_968, 768)},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def call_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of ``fn`` as a caller sees it, host work
    included: CUDA events around ``iters`` eager calls, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the card alone: ``iters`` calls
    captured in one CUDA graph and replayed between CUDA events, so the
    host's per-call work is not in it.  Inputs stay in L2 between calls,
    as for a replica that serves one request batch after another."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split_ms(torch, fn, iters: int = 20) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches: ``iters``
    calls under ``torch.profiler``, device activity only."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.device_time_total > 0}


def timings(torch, kernel, plain, library, iters: int, plain_iters: int):
    """Kernel, plain version and (where one exists, else None) the one
    PyTorch call that computes the same function."""
    return {"ms": device_ms(torch, kernel, iters),
            "plain_ms": device_ms(torch, plain, plain_iters),
            "library_ms": (device_ms(torch, library, iters)
                           if library else None),
            "call_ms": call_ms(torch, kernel, iters),
            "plain_call_ms": call_ms(torch, plain, plain_iters),
            "library_call_ms": (call_ms(torch, library, iters)
                                if library else None)}


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds, "library": str(build.build())})
    print(build.build_log(), file=sys.stderr, flush=True)


#: kernel functions whose compiled code the sass phase reports: the two
#: GQA decode kernels (dense and paged), flash's bf16 (tensor-core: the
#: TMA and the one-warpgroup instances), split merge and fp32 (CUDA-core)
#: kernels, the MLA decode's bf16 tensor-core kernel,
#: the SSD scan's three kernels (every instance), the router's register
#: kernel, the GRU's cluster kernel and both FedAvg instances (every
#: count and dtype)
SASS_KERNELS = ("decode_attention_kernel", "paged_decode_attention_kernel",
                "flash_attention_tma_kernel", "flash_attention_wgmma_kernel",
                "flash_attention_merge_kernel", "flash_attention_kernel",
                "paged_mla_decode_mma_kernel", "mamba_chunk_local_kernel",
                "mamba_chunk_pass_kernel", "mamba_chunk_outputs_kernel",
                "topk_router_kernel", "gru_seq_cluster_kernel",
                "fedavg_reduce_vec_kernel", "fedavg_reduce_scalar_kernel")
#: opcodes the sass phase counts (``LDG.E.128``: 16-byte global loads;
#: ``LDG.E.EF.128``: the same with the streaming (evict-first) hint,
#: what ``__ldcs`` of a 16-byte vector compiles to; ``REDUX``: warp
#: reductions in one instruction; ``UCGABAR_ARV``: the arrival at a
#: cluster barrier, what ``barrier.cluster.arrive`` compiles to on sm_90a)
SASS_OPCODES = ("HGMMA", "HMMA", "LDG.E.128", "LDG.E.EF.128", "REDUX",
                "UCGABAR_ARV")


def ptxas_report(log: str) -> dict:
    """Per kernel function, what ``ptxas -v`` said in a build ``log``:
    registers a thread and bytes of spill stores and loads."""
    report, fn = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            fn = found.group(1)
            report[fn] = {}
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        regs = re.search(r"Used (\d+) registers", line)
        if fn and spill:
            report[fn].update(spill_stores=int(spill.group(1)),
                              spill_loads=int(spill.group(2)))
        if fn and regs:
            report[fn]["registers"] = int(regs.group(1))
    return report


def sass_counts(text: str, opcodes=SASS_OPCODES) -> dict:
    """Per kernel function of a ``cuobjdump -sass`` listing, how many
    instructions have an opcode that is or starts with each of
    ``opcodes``."""
    counts, fn = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
            continue
        if fn is None or not line.startswith("/*") or "*/" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words:
            continue
        for op in opcodes:
            if words[0] == op or words[0].startswith(op + "."):
                counts[fn][op] += 1
    return counts


def is_kernel(fn: str, name: str) -> bool:
    """Whether the mangled function ``fn`` is kernel ``name`` itself (and
    not another whose name ends in it: ``paged_decode_attention_kernel``
    is not ``decode_attention_kernel``)."""
    return re.search(rf"\d{name}[IE]", fn) is not None


def sass_report() -> dict:
    """What the compiled attention kernels contain: per function (one per
    template instance) the tensor-core and 16-byte-load instructions that
    ``cuobjdump -sass`` lists, and registers and spills from ``ptxas
    -v``.  Fails unless every bf16 flash instance (and every TMA instance
    moves registers with ``setmaxnreg``: USETMAXREG), the bf16 MLA decode
    kernel and the two product kernels of every bf16 tensor-core instance
    of the SSD scan have tensor-core instructions, the vector instances of both GQA
    decode kernels load K/V in 16 bytes, every vector instance of
    ``fedavg_reduce`` (each compile-time count and the run-time one, in
    both dtypes) loads in 16 bytes and spills nothing, every instance of the
    router's register kernel selects with REDUX, every instance of
    the GRU's cluster kernel has its cluster barrier and spills
    nothing, and every instance gemma3's head dim 256 takes (the decode
    kernels' 16-lane rows, flash's Dv-256 instances) spills nothing."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    listing = subprocess.run([str(cuobjdump), "-sass", str(build.build())],
                             capture_output=True, text=True,
                             check=True).stdout
    sass, regs = sass_counts(listing), ptxas_report(build.build_log())
    rows = {fn: {**sass[fn], **regs.get(fn, {})} for fn in sass
            if any(k in fn for k in SASS_KERNELS)}
    tc = [r for fn, r in rows.items()
          if is_kernel(fn, "flash_attention_wgmma_kernel")
          or is_kernel(fn, "flash_attention_tma_kernel")]
    # the TMA instances (Dv 64, 128, 256): the producer's registers moved
    # to the consumers
    maxreg = sass_counts(listing, ("USETMAXREG",))
    tma = {fn: maxreg[fn]["USETMAXREG"] for fn in rows
           if is_kernel(fn, "flash_attention_tma_kernel")}
    mla = [r for fn, r in rows.items()
           if is_kernel(fn, "paged_mla_decode_mma_kernel")]
    # template <typename T, bool kVec, ...>: the vector instances are Lb1E
    # right after the type
    vec = {name: [r for fn, r in rows.items()
                  if is_kernel(fn, name)
                  and re.search(r"I(?:f|13__nv_bfloat16)Lb1E", fn)]
           for name in ("decode_attention_kernel",
                        "paged_decode_attention_kernel")}
    # template <typename T, bool kTC, int NTP>: bf16 tensor-core instances
    scan = [r for fn, r in rows.items()
            if (is_kernel(fn, "mamba_chunk_local_kernel")
                or is_kernel(fn, "mamba_chunk_outputs_kernel"))
            and "13__nv_bfloat16Lb1E" in fn]
    router = [r for fn, r in rows.items()
              if is_kernel(fn, "topk_router_kernel")]
    gru = [r for fn, r in rows.items()
           if is_kernel(fn, "gru_seq_cluster_kernel")]
    # template <typename T, int kC>: counts 1..8 and 0 (run time), fp32
    # (If) and bf16 (I13__nv_bfloat16)
    fed = {dt: [r for fn, r in rows.items()
                if is_kernel(fn, "fedavg_reduce_vec_kernel") and tag in fn]
           for dt, tag in (("float32", "IfLi"),
                           ("bfloat16", "I13__nv_bfloat16Li"))}
    # the instances gemma3's head dim 256 takes: both decode kernels' rows
    # over 16 lanes, one query head a block (template <T, kVec, kLanes,
    # kDims, kGB, kSplit>; the dense kernel's full and partial outputs are
    # one instance, a split walk (kSplit) another), flash's
    # bf16 Dv-256 instances (template <kNo>: TMA and one-warpgroup) and
    # fp32 8-chunk instance (template <T, kChunks>)
    wide = {fn: r for fn, r in rows.items()
            if ((is_kernel(fn, "decode_attention_kernel")
                 or is_kernel(fn, "paged_decode_attention_kernel"))
                and re.search(r"Lb[01]ELi16ELi16E", fn))
            or ((is_kernel(fn, "flash_attention_wgmma_kernel")
                 or is_kernel(fn, "flash_attention_tma_kernel"))
                and "ILi256E" in fn)
            or (is_kernel(fn, "flash_attention_kernel") and "Li8EE" in fn)}
    checks = {"flash_bf16_on_tensor_cores": len(tc) == 6 and all(
                  r["HGMMA"] > 0 for r in tc),
              "flash_tma_setmaxnreg": len(tma) == 3 and all(
                  n > 0 for n in tma.values()),
              "decode_16_byte_loads": bool(vec["decode_attention_kernel"])
              and all(r["LDG.E.128"] > 0
                      for r in vec["decode_attention_kernel"]),
              "paged_decode_16_byte_loads": bool(
                  vec["paged_decode_attention_kernel"]) and all(
                  r["LDG.E.128"] > 0
                  for r in vec["paged_decode_attention_kernel"]),
              "paged_mla_bf16_on_tensor_cores": bool(mla) and all(
                  r["HMMA"] > 0 for r in mla),
              # two kernels x two widths of P
              "mamba_scan_bf16_on_tensor_cores": len(scan) == 4 and all(
                  r["HMMA"] > 0 for r in scan),
              "topk_router_selects_with_redux": bool(router) and all(
                  r["REDUX"] > 0 for r in router),
              "gru_seq_cluster_barrier": bool(gru) and all(
                  r["UCGABAR_ARV"] > 0 for r in gru),
              "gru_seq_cluster_no_spills": bool(gru) and all(
                  r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                  for r in gru),
              # 9 counts in each dtype, streamed 16-byte loads, no spills
              "fedavg_16_byte_loads": all(
                  len(v) == 9 and all(
                      r["LDG.E.EF.128"] + r["LDG.E.128"] > 0
                      and r.get("spill_stores") == 0
                      and r.get("spill_loads") == 0 for r in v)
                  for v in fed.values()),
              # 2 decode kernels (dense, paged) x 2 dtypes x 2 load
              # widths x split or not, flash's two bf16 instances (TMA,
              # one-warpgroup) and its fp32 one
              "head_dim_256_no_spills": len(wide) == 19 and all(
                  r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                  for r in wide.values())}
    return {"phase": "sass", "functions": rows,
            "flash_tma_usetmaxreg": tma, "head_dim_256": sorted(wide),
            "checks": checks}


def sass_worker(conn) -> None:
    """:func:`sass_report` in a process of its own (module level: the
    spawned child imports it), sent back through ``conn``; a failure as
    its traceback."""
    try:
        conn.send(("ok", sass_report()))
    except Exception:  # the parent reports it as the sass phase's
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def start_sass():
    """Start :func:`sass_worker` (host work only: ``cuobjdump`` and the
    parsers) beside the card's phases; :func:`finish_sass` collects it."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=sass_worker, args=(send,), daemon=True)
    proc.start()
    send.close()
    return recv, proc


def finish_sass(recv, proc) -> None:
    """Emit the sass line of :func:`start_sass`'s process and fail unless
    its checks hold."""
    try:
        if not recv.poll(SASS_TIMEOUT):
            raise TimeoutError(f"sass: no report in {SASS_TIMEOUT} s")
        status, line = recv.recv()
    finally:
        proc.join(10)
        if proc.is_alive():
            proc.terminate()
    if status != "ok":
        raise RuntimeError(f"sass report failed:\n{line}")
    emit(line)
    checks = line["checks"]
    if not all(checks.values()):
        raise AssertionError(f"sass checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def check_gru_seq(torch, rng, B, T, h):
    """gru_seq at (B, T, h); at a width the cluster instance runs,
    ``floor_ms`` times its exchange-only kernel on the same grid and
    cluster shape (the state's stores through distributed shared memory
    and the waits for them, T steps, no gate math), timed as the kernel
    is: the least time any body of the recurrence can take there."""
    from repro_torch.kernels import build, gru_cell, ref
    dev = torch.device(DEVICE)
    xw = torch.as_tensor(rng.normal(size=(B, T, 3 * h)), dtype=torch.float32,
                         device=dev)
    h0 = torch.as_tensor(rng.normal(size=(B, h)), dtype=torch.float32,
                         device=dev)
    w_h = torch.as_tensor(rng.normal(size=(h, 3 * h)) * 0.1,
                          dtype=torch.float32, device=dev)
    out = gru_cell.gru_seq(xw, h0, w_h)
    plain = ref.gru_seq_ref(xw, h0, w_h)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    ok = bool(torch.allclose(out, plain, atol=GRU_TOL, rtol=GRU_TOL))
    # library yardstick: cuDNN's GRU computes the same recurrence when its
    # input weights are the identity (so its input is xw itself), its
    # recurrent weights are w_h^T, and both biases are zero
    lib = torch.nn.GRU(3 * h, h, batch_first=True).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(3 * h, device=dev))
        lib.weight_hh_l0.copy_(w_h.T)
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()

        def library():
            return lib(xw, h0[None])[0]

        lib_err = (library() - plain).abs().max().item()
        nbytes = 4 * (B * T * 3 * h + B * h + h * 3 * h + B * T * h)
        bound_ms, bound_by = bound(nbytes, 2 * B * T * h * 3 * h)
        row = {"kernel": "gru_seq", "shape": [B, T, h], "dtype": "float32",
               "instance": gru_cell.instance(h),
               "max_abs_err": err, "tol": GRU_TOL, "ok": ok,
               **timings(torch, lambda: gru_cell.gru_seq(xw, h0, w_h),
                         lambda: ref.gru_seq_ref(xw, h0, w_h), library,
                         200, 20),
               "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by}
    if row["instance"] == "cluster":
        S, bb = gru_cell.cluster_shape(B, h)
        scratch = torch.empty_like(out)

        def floor():
            build.launch("gru_seq_floor", scratch.data_ptr(), B, T, h, S, bb,
                         torch.cuda.current_stream().cuda_stream)

        row.update(cluster=[S, bb], floor_ms=device_ms(torch, floor, 200))
    emit({"phase": "kernel_check", **row})
    return row


def check_fedavg_reduce(torch, rng, C, N, dtype_name, iters=(200, 50),
                        offset=0, more_readings=False):
    """``rng`` a numpy generator, or a torch one on the card for the LM
    syncs' replica matrices (C N of ~1.6e9 is too many numpy draws);
    ``iters`` the kernel's and the plain version's timed calls;
    ``offset`` elements of storage before the replicas (1: rows off any
    16-byte boundary, so the scalar instance).  ``floor_ms`` times an
    empty kernel on the instance's grid, timed as the kernel is.  With
    ``more_readings`` the kernel is also timed as a graph of 5 calls
    (``ms_graph_of_5``) and by CUDA events around each of 20 eager
    launches (``eager_ms``)."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fedavg_reduce as fr
    dev = torch.device(DEVICE)
    dtype = getattr(torch, dtype_name)
    if isinstance(rng, np.random.Generator):
        x = torch.as_tensor(rng.normal(size=(C, N)), dtype=torch.float32,
                            device=dev).to(dtype)
        w = torch.as_tensor(rng.uniform(0.5, 2.0, C), dtype=torch.float32,
                            device=dev)
    else:
        x = torch.randn((C, N), generator=rng, device=dev, dtype=dtype)
        w = torch.rand((C,), generator=rng, device=dev) * 1.5 + 0.5
    if offset:
        flat = torch.empty(C * N + offset, dtype=dtype, device=dev)
        x = flat[offset:].view(C, N).copy_(x)
    out = fr.fedavg_reduce(x, w)
    inst = fr.instance(C, N, dtype, x.data_ptr(), out.data_ptr())
    launch_shape = (inst == "vector", x.element_size(), C, N,
                    fr.sms(x.device.index))
    blocks = build.load().fedavg_reduce_blocks(*launch_shape)
    plain = ref.fedavg_reduce_ref(x, w)
    torch.cuda.synchronize()
    tol = FEDAVG_TOL[dtype_name]
    err = (out.float() - plain.float()).abs().max().item()
    ok = bool(out.dtype == dtype and torch.allclose(
        out.float(), plain.float(), atol=tol, rtol=tol))
    wn = (w / w.sum()).to(dtype)
    it = x.element_size()
    bound_ms, bound_by = bound(C * N * it + C * 4 + N * it, 2 * C * N)

    def floor():
        build.launch("fedavg_reduce_floor", *launch_shape,
                     torch.cuda.current_stream().cuda_stream)

    row = {"kernel": "fedavg_reduce", "shape": [C, N], "dtype": dtype_name,
           "offset": offset, "instance": inst, "blocks": blocks,
           "max_abs_err": err, "tol": tol, "ok": ok,
           **timings(torch, lambda: fr.fedavg_reduce(x, w),
                     lambda: ref.fedavg_reduce_ref(x, w),
                     lambda: torch.matmul(wn, x), *iters),
           "floor_ms": device_ms(torch, floor, 200),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if more_readings:
        row["ms_graph_of_5"] = device_ms(torch, lambda: fr.fedavg_reduce(x, w),
                                         5)
        row["eager_ms"] = launch_event_ms(
            torch, lambda: [fr.fedavg_reduce(x, w) for _ in range(20)],
            "fedavg_reduce_") / 20
    emit({"phase": "kernel_check", **row})
    return row


def launch_event_ms(torch, fn, prefix: str) -> float:
    """Device ms of the kernels that one call of ``fn`` launches through
    entry points named ``prefix...``: CUDA events recorded on the
    launching stream just before and after each such launch, summed.
    Unlike ``torch.profiler`` this needs no CUPTI."""
    from repro_torch.kernels import build
    launch, pairs = build.launch, []

    def timed(name, *args):
        if not name.startswith(prefix):
            return launch(name, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(name, *args)
        end.record()
        pairs.append((start, end))

    build.launch = timed
    try:
        fn()
    finally:
        build.launch = launch
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs)


def phase_kernels(torch, n_params):
    from repro_torch.kernels import fedavg_reduce as fr_mod
    rng = np.random.default_rng(SEED)
    gru_rows = [check_gru_seq(torch, rng, B, HISTORY, 128)
                for B in TIER_BATCH.values()]
    # the tests/test_kernels.py sweep shape T=24, h=64, at B=6, which that
    # test's batch block bb=4 does not divide; the reduced tiers' width;
    # a width past the cluster instance's, in the general instance
    gru_rows.append(check_gru_seq(torch, rng, 6, 24, 64))
    gru_rows.append(check_gru_seq(torch, rng, 8, HISTORY, 32))
    gru_rows.append(check_gru_seq(torch, rng, 3, 5, 1024))
    # the HFL slice's validation forwards: one a client, max_val_windows
    # rows (128 in the slice, 512 by default)
    gru_rows += [check_gru_seq(torch, rng, B, HISTORY, 128)
                 for B in (128, 512)]
    shapes = [(len(CLUSTER_IDS), n_params, "float32"),
              (len(CLUSTER_IDS), n_params, "bfloat16")]
    shapes += [(int(c), n_params, "float32")
               for c in np.bincount(CLUSTER_IDS) if c]
    shapes += [(int((np.bincount(CLUSTER_IDS) > 0).sum()), n_params,
                "float32"), (4, 513, "float32"), (4, 513, "bfloat16")]
    # each instance in both dtypes with a ragged tail (N no multiple of a
    # block's tile): the vector one at compile-time counts (C 2, 3) and
    # past them (C 37), the scalar one on rows one element off a 16-byte
    # boundary (the GRU's rows above take it at odd N)
    shapes += [(2, 1_048_584, "bfloat16"), (3, 1_048_580, "float32"),
               (37, 1_048_584, "bfloat16"), (37, 1_048_580, "float32")]
    # the most replicas the wrapper admits (a launch an earlier design
    # refused: ROADMAP Queue 3), at tests/test_torch_kernels.py's N 40
    shapes += [(fr_mod.MAX_REPLICAS, 40, "float32"),
               (fr_mod.MAX_REPLICAS, 40, "bfloat16")]
    fed_rows = [check_fedavg_reduce(torch, rng, *s) for s in shapes]
    fed_rows += [check_fedavg_reduce(torch, rng, 5, n, d, offset=1)
                 for n, d in ((1_048_584, "bfloat16"),
                              (1_048_580, "float32"))]
    bad = [r for r in gru_rows + fed_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return gru_rows, fed_rows


def phase_autograd(torch):
    """A loss on the card differentiates through the kernels: the reduced
    GRU's loss (its recurrence in ``gru_seq``) on the card and on the CPU,
    on the same numpy weights and windows, ``torch.autograd.grad`` of
    every leaf: each nonzero and within GRAD_TOL of the CPU's, with the
    forward launched through the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import (flatten_with_path, from_numpy_tree,
                                    tree_map)
    cfg = get_config("gru-traffic").reduced()
    api = make_model(cfg)
    rng = np.random.default_rng(SEED + 3)
    tree = numpy_clients(rng, cfg.model, 1)
    rows = {}
    for B in (1, 4):
        batch = {"windows": rng.normal(size=(B, HISTORY, 1)),
                 "targets": rng.normal(size=(B, 1))}
        grads, launches = {}, 0
        for dev in (DEVICE, "cpu"):
            params = tree_map(lambda x: x[0].clone().requires_grad_(),
                              from_numpy_tree(tree, dev))
            leaves = flatten_with_path(params)
            b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in batch.items()}
            ops.reset_launches()
            loss = api.loss(params, b)
            if dev == DEVICE:
                launches = ops.launch_counts()["gru_seq"]
            got = torch.autograd.grad(loss, [x for _, x in leaves])
            grads[dev] = {"/".join(k): g.cpu() for (k, _), g in
                          zip(leaves, got)}
        errs = {k: (g - grads["cpu"][k]).abs().max().item()
                for k, g in grads[DEVICE].items()}
        rows[B] = {"gru_seq_launches": launches,
                   "max_abs_err": max(errs.values()),
                   "zero_leaves": [k for k, g in grads[DEVICE].items()
                                   if not bool(g.abs().max() > 0)],
                   "err_by_leaf": errs}
    checks = {
        "forward_through_kernel": all(
            r["gru_seq_launches"] == cfg.model.rnn_layers
            for r in rows.values()),
        "every_leaf_nonzero": all(not r["zero_leaves"] for r in rows.values()),
        "gradients_match_cpu": all(r["max_abs_err"] <= GRAD_TOL
                                   for r in rows.values())}
    emit({"phase": "autograd", "arch": "gru-traffic (reduced)",
          "tol": GRAD_TOL, "by_batch": rows, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"autograd checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def check_attention(torch, kernel, shape, dtype_name, call, plain,
                    library, nbytes, flops, compared=None, tol=None,
                    extra=None):
    """One attention kernel at one shape: error against its plain
    version (over every output, where it returns several, each as
    ``compared`` maps the outputs) within ``tol`` (default the dtype's
    ATTN_TOL), times, and the bound of the work its inputs need.
    ``extra(outs, wants)`` -> (fields, ok) adds checks of its own (the
    decode kernels' split, :func:`split_checks`)."""
    outs, wants = call(), plain()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, wants = (outs,), (wants,)
    if compared:
        outs, wants = compared(*outs), compared(*wants)
    tol = ATTN_TOL[dtype_name] if tol is None else tol
    err = max((o.float() - w.float()).abs().max().item()
              for o, w in zip(outs, wants))
    ok = all(o.dtype == w.dtype and torch.allclose(
        o.float(), w.float(), atol=tol, rtol=tol)
        for o, w in zip(outs, wants))
    fields, extra_ok = extra(outs, wants) if extra else ({}, True)
    ok = ok and extra_ok
    rate = BF16_FLOP_PER_S if dtype_name == "bfloat16" else FP32_FLOP_PER_S
    bound_ms, bound_by = bound(nbytes, flops, rate)
    row = {"kernel": kernel, "shape": list(shape), "dtype": dtype_name,
           "max_abs_err": err, "tol": tol, "ok": ok, **fields,
           **timings(torch, call, plain, library, 200, 20),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "flops": flops}
    emit({"phase": "kernel_check", **row})
    return row


def _randn(torch, rng, shape, dtype):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=DEVICE).to(dtype)


def check_flash(torch, rng, BH, BHkv, T, D, window, dtype_name, Dv=None,
                causal=True, Tk=None, split=None):
    """``Dv`` (default D) is the value dim: MLA prefill scores over 192
    dims and returns 128.  ``causal=False`` drops the causal mask
    (whisper's encoder), and then ``Tk`` (default T) may give the keys a
    length of their own (its cross attention); such a row's shape ends
    in ("non-causal", Tk).  Each row records the instance and its S
    (``flash_attention.splits``); ``split`` True (a long walk on a small
    grid) or False (a serving shape, or a grid that fills the card)
    holds S > 1 or S = 1, and a split row must see its last chunk
    (:func:`flash_split_checks`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    Dv = D if Dv is None else Dv
    Tk = T if Tk is None else Tk
    q = _randn(torch, rng, (BH, T, D), dtype)
    k = _randn(torch, rng, (BHkv, Tk, D), dtype)
    v = _randn(torch, rng, (BHkv, Tk, Dv), dtype)
    # the yardstick takes every head's kv; repeat them outside its timing
    kx, vx = (x.repeat_interleave(BH // BHkv, 0) for x in (k, v))
    dist = np.arange(T)[:, None] - np.arange(Tk)[None, :]
    allowed = np.ones(dist.shape, bool)
    if causal:
        allowed &= dist >= 0
    if window > 0:
        allowed &= dist < window
    mask = torch.as_tensor(allowed, device=DEVICE)
    pairs = BH * int(allowed.sum())
    it = q.element_size()

    # (1, BH, T, D) views: SDPA's fused backends take 4-d inputs only, and
    # 3-d ones fall to its unfused math path
    q4, k4, v4 = q[None], kx[None], vx[None]

    def library():
        if window > 0:
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=mask)[0]
        return F.scaled_dot_product_attention(q4, k4, v4,
                                              is_causal=causal)[0]

    win = window if 0 < window < T else 0
    S = fa.splits(q, k, v, causal, win)
    shape = ((BH, BHkv, T, D, window) + ((Dv,) if Dv != D else ())
             + (() if causal else ("non-causal", Tk)))
    return check_attention(
        torch, "flash_attention", shape, dtype_name,
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
        lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window),
        library, it * (BH * T * (D + Dv) + BHkv * Tk * (D + Dv)),
        pairs * 2 * (D + Dv),
        extra=flash_split_checks(torch, S, split, dtype_name, q, k, v,
                                 allowed, causal, win,
                                 fa.instance(q, k, v)
                                 if dtype_name == "bfloat16" else "fp32"))


@contextlib.contextmanager
def flash_launch_shapes():
    """The (BH, BHkv, T, Tk, D, Dv, causal, window, S) of every flash
    kernel launch inside the block, as the wrapper passes them to its
    entry point (``build.launch`` wrapped; fp32 calls with S 1)."""
    from repro_torch.kernels import build
    seen, launch = [], build.launch

    def recording(name, *args):
        if name == "flash_attention_bf16":
            seen.append(tuple(args[5:14]))
        elif name == "flash_attention_f32":
            seen.append(tuple(args[4:12]) + (1,))
        return launch(name, *args)

    build.launch = recording
    try:
        yield seen
    finally:
        build.launch = launch


def flash_masked_plain(torch, q, k, v, allowed):
    """The plain flash attention with ``allowed`` (T, Tk) as the visible
    keys (a row with none averages V, as the kernels' -1e30 mask does)."""
    from repro_torch.kernels import ref
    G = q.shape[0] // k.shape[0]
    kx, vx = (x.repeat_interleave(G, 0).float() for x in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.float(), kx) / np.sqrt(q.shape[-1])
    s = torch.where(torch.as_tensor(allowed, device=q.device)[None], s,
                    ref.NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1),
                        vx).to(q.dtype)


def flash_split_checks(torch, S, expect, dtype_name, q, k, v, allowed,
                       causal, window, instance):
    """The ``extra`` of a flash row: records S and the instance, holds S >
    1 or S = 1 where ``expect`` says, and a bf16 row's output within
    FLASH_ULPS of the plain version's.  Split, the check's power: the
    plain output with the keys of each block's last chunk (``ref``'s
    ``flash_walk`` / ``flash_chunks``, the kernel's blocks of 64 or 128
    rows) masked out must fail the checks the row applies (its
    tolerance, and FLASH_ULPS in bf16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def extra(outs, wants):
        fields = {"splits": S, "splits_expected": expect,
                  "instance": instance}
        ok = expect is None or (S > 1) == expect
        bf16 = dtype_name == "bfloat16"
        if bf16:
            fields["kernel_ulps"] = ulps(torch, outs[0], wants[0],
                                         torch.bfloat16)
            ok = ok and fields["kernel_ulps"] <= FLASH_ULPS
        if S == 1:
            return fields, ok
        BH, T = q.shape[:2]
        Tk = k.shape[1]
        rows = 64 if fa.paired(BH, k.shape[0]) else 128
        cut = np.array(allowed, bool)
        for r0 in range(0, T, rows):
            r1 = min(T, r0 + rows)
            chunks = ref.flash_chunks(*ref.flash_walk(r0, r1, Tk, causal,
                                                      window), S)
            b, e = [c for c in chunks if c[1] > c[0]][-1]
            cut[r0:r1, b * 64:min(Tk, e * 64)] = False
        full, dropped = (flash_masked_plain(torch, q, k, v, m)
                         for m in (allowed, cut))
        tol = ATTN_TOL[dtype_name]
        seen = not torch.allclose(full.float(), dropped.float(), atol=tol,
                                  rtol=tol)
        power = {"max_abs": (full.float() - dropped.float()).abs()
                 .max().item(), "seen_at_tol": seen}
        if bf16:
            power["ulps"] = ulps(torch, full, dropped, torch.bfloat16)
            seen = seen or power["ulps"] > FLASH_ULPS
        power["seen"] = seen
        fields["power"] = power
        return fields, ok and seen
    return extra


def check_flash_merge(torch, rng, BH, BHkv, T, D, window):
    """The split's merge kernel alone, at a bf16 split shape: the entry
    point launched on a scratch of this function's, then the merged
    output held against ``ref.combine_partials`` of the chunks'
    statistics the kernel left there (o / l rounded to bf16, within one
    bf16 ulp of the largest output); its device time from the profiler
    beside the plain merge's, and the bound of its bytes (the scratch
    read, the output written)."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (_randn(torch, rng, s, torch.bfloat16)
               for s in ((BH, T, D), (BHkv, T, D), (BHkv, T, D)))
    win = window if 0 < window < T else 0
    S = fa.splits(q, k, v, True, win)
    work = fa.scratch(S, BH, T, D, q.device)
    out = torch.empty_like(q)
    n = S * BH * T
    o, m, l = (work[:n * D].view(S, BH, T, D),
               work[n * D:n * (D + 1)].view(S, BH, T),
               work[n * (D + 1):].view(S, BH, T))

    def launch():
        build.launch("flash_attention_bf16", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), work.data_ptr(), BH, BHkv,
                     T, T, D, D, 1, win, S,
                     torch.cuda.current_stream().cuda_stream)

    def plain():
        top, bot = ref.combine_partials(o, m, l)[::2]
        return (top / bot[..., None]).to(torch.bfloat16)

    launch()
    torch.cuda.synchronize()
    want = plain()
    err = (out.float() - want.float()).abs().max().item()
    ulp = ulps(torch, out, want, torch.bfloat16)
    split = kernel_split_ms(torch, launch)
    merge_ms = [t for key, t in split.items() if "merge" in key]
    bound_ms, bound_by = bound(4 * n * (D + 2) + 2 * BH * T * D, 2 * n * D)
    row = {"kernel": "flash_attention_merge", "shape": [S, BH, T, D],
           "dtype": "bfloat16", "splits": S, "max_abs_err": err,
           "ulps": ulp, "ok": S > 1 and ulp <= 1.0 and len(merge_ms) == 1,
           "ms": merge_ms[0] if merge_ms else None,
           "kernels_ms": split, "plain_ms": device_ms(torch, plain, 20),
           "library_ms": None, "call_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit({"phase": "kernel_check", **row})
    return row


def drop_last_chunk(valid, walks, S):
    """``valid`` (B, slots) with, in each row, the slots of the last of
    the S chunks of its walk ``walks[b]`` = (first, last) that counts a
    slot masked out (``ref.walk_chunks``, the kernels' chunks)."""
    from repro_torch.kernels import ref
    out = np.array(valid, bool)
    for b, (first, last) in enumerate(walks):
        for lo, hi in reversed(ref.walk_chunks(first, last, S)):
            if out[b, lo:hi].any():
                out[b, lo:hi] = False
                break
    return out


def split_checks(torch, S, expect, dtype_name, plain_on, valid, walks,
                 partial=False):
    """The ``extra`` of a GQA decode row whose wrapper splits each row's
    walk into S chunks: records S and, where ``expect`` is True (a long
    row) or False (a serving row), holds S > 1 or S = 1.  Split, a bf16
    row's output within DECODE_SPLIT_ULPS of the plain version's, and the
    check's power: ``plain_on(mask)`` (the plain version with ``mask``
    (B, slots) as the counted slots) over ``valid`` and over
    :func:`drop_last_chunk` of it must fail the checks the row applies
    (ATTN_TOL, and the ulps in bf16; the partial statistics' o / l at
    PARTIAL_TOL)."""
    def extra(outs, wants):
        fields = {"splits": S, "splits_expected": expect}
        ok = expect is None or (S > 1) == expect
        if S == 1:
            return fields, ok
        full, cut = (plain_on(torch.as_tensor(m, device=DEVICE))
                     for m in (valid, drop_last_chunk(valid, walks, S)))
        tol = PARTIAL_TOL if partial else ATTN_TOL[dtype_name]
        if partial:
            full, cut = normalised(*full)[0], normalised(*cut)[0]
        seen = not torch.allclose(full.float(), cut.float(), atol=tol,
                                  rtol=tol)
        power = {"max_abs": (full.float() - cut.float()).abs().max().item(),
                 "seen_at_tol": seen}
        if dtype_name == "bfloat16" and not partial:
            fields["kernel_ulps"] = ulps(torch, outs[0], wants[0],
                                         torch.bfloat16)
            ok = ok and fields["kernel_ulps"] <= DECODE_SPLIT_ULPS
            power["ulps"] = ulps(torch, full, cut, torch.bfloat16)
            seen = seen or power["ulps"] > DECODE_SPLIT_ULPS
        power["seen"] = seen
        fields["power"] = power
        return fields, ok and seen
    return extra


def check_decode(torch, rng, B, H, Hkv, C, D, n_valid, dtype_name,
                 valid=None, soft_cap=0.0, split=None):
    """``n_valid`` (B,) leading valid slots per row, as a ring cache
    holds them before it wraps; None: 80% of the slots at random; or
    ``valid``, a (B, C) bool mask as it is.  The bound counts each row's
    valid slots (K and V, scores and P.V), and for a row with none only
    the V of all C slots and its mean (every score is -1e30, so the
    output does not depend on K).  With ``soft_cap`` the shape gains it
    and there is no yardstick (SDPA has no cap).  ``split``: True at a
    long row (the wrapper must split its walk), False at a serving one
    (it must not), None either (:func:`split_checks`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    q = _randn(torch, rng, (B, H, D), dtype)
    k, v = (_randn(torch, rng, (B, C, Hkv, D), dtype) for _ in range(2))
    if valid is not None:
        valid = np.asarray(valid, bool)
    elif n_valid is None:
        valid = rng.uniform(size=(B, C)) < 0.8
        valid[:, 0] = True
    else:
        valid = np.arange(C)[None, :] < np.asarray(n_valid)[:, None]
    keys = int(valid.sum())   # rows with a valid slot: K and V read
    mean_rows = int((~valid.any(1)).sum())   # rows with none: V read
    valid_t = torch.as_tensor(valid, device=DEVICE)
    it = q.element_size()

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid_t[:, None, None, :], enable_gqa=H != Hkv)

    return check_attention(
        torch, "decode_attention",
        (B, H, Hkv, C, D) + ((soft_cap,) if soft_cap else ()), dtype_name,
        lambda: da.decode_attention(q, k, v, valid_t, soft_cap=soft_cap),
        lambda: ref.decode_attention_ref(q, k, v, valid_t,
                                         soft_cap=soft_cap),
        None if soft_cap else library,
        it * (2 * B * H * D + (2 * keys + mean_rows * C) * Hkv * D) + B * C,
        (keys * 4 + mean_rows * C * 2) * H * D,
        extra=split_checks(
            torch, da.splits(B, H, Hkv, C, D, D, q.device), split,
            dtype_name, lambda m: ref.decode_attention_ref(
                q, k, v, m, soft_cap=soft_cap), valid, [(0, C)] * B))


def check_decode_partial(torch, rng, B, H, Hkv, C, D, valid, dtype_name,
                         split=None):
    """The partial instance over one rank's share of C slots, ``valid``
    (B, C) as it is: its (o, m, l) against the plain version's within
    PARTIAL_TOL whatever the dtype, o as o / l: o is a sum over the
    share's slots whose elements cancel, so its error scales with l, not
    with o (an element near 0 carries the rounding of 16,384 terms), and
    o / l is what the merge uses.  Where a row has no valid slot, a
    planted fault, the kernel's o zeroed on those rows, is compared the
    same way at PARTIAL_TOL and at the dtype's ATTN_TOL
    (``planted_fault_passes``: the check must reject it).  The
    bound counts what :func:`check_decode` counts, the fp32 outputs
    written; the yardstick is the one PyTorch call that returns a
    decode's softmax statistics, the memory-efficient attention with
    ``compute_log_sumexp`` (its output normalised, with the log of the
    sum), over the kv heads repeated per query head (outside its timing)
    with an additive mask; None with the reason where it refuses.
    ``split`` as :func:`check_decode`'s."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    q = _randn(torch, rng, (B, H, D), dtype)
    k, v = (_randn(torch, rng, (B, C, Hkv, D), dtype) for _ in range(2))
    valid = np.asarray(valid, bool)
    keys = int(valid.sum())
    mean_rows = int((~valid.any(1)).sum())
    valid_t = torch.as_tensor(valid, device=DEVICE)
    it = q.element_size()
    q4 = q[:, :, None]
    k4, v4 = (x.transpose(1, 2).repeat_interleave(H // Hkv, 1).contiguous()
              for x in (k, v))
    bias = torch.where(valid_t, 0.0, -1e30).to(dtype)[:, None, None, :] \
        .expand(B, H, 1, C).contiguous()

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, bias, True)[:2]

    refused = None
    try:
        library()
        torch.cuda.synchronize()
    except Exception as exc:  # the yardstick only; the kernel is checked
        refused = f"{type(exc).__name__}: {exc}"[:300]
    row = check_attention(
        torch, "decode_attention_partial", (B, H, Hkv, C, D), dtype_name,
        lambda: da.decode_attention_partial(q, k, v, valid_t),
        lambda: ref.decode_attention_partial_ref(q, k, v, valid_t),
        None if refused else library,
        it * (B * H * D + (2 * keys + mean_rows * C) * Hkv * D) + B * C
        + 4 * B * H * (D + 2),
        (keys * 4 + mean_rows * C * 2) * H * D,
        compared=normalised, tol=PARTIAL_TOL,
        extra=split_checks(
            torch, da.splits(B, H, Hkv, C, D, D, q.device), split,
            dtype_name, lambda m: ref.decode_attention_partial_ref(
                q, k, v, m), valid, [(0, C)] * B, partial=True))
    if mean_rows:
        empty = torch.as_tensor(~valid.any(1), device=DEVICE)
        o, m, l = da.decode_attention_partial(q, k, v, valid_t)
        got = normalised(torch.where(empty[:, None, None], 0.0, o), m, l)
        want = normalised(*ref.decode_attention_partial_ref(q, k, v,
                                                            valid_t))
        row["planted_fault_passes"] = {
            str(t): all(torch.allclose(g, w, atol=t, rtol=t)
                        for g, w in zip(got, want))
            for t in (PARTIAL_TOL, ATTN_TOL[dtype_name])}
        emit({"phase": "kernel_check_planted", "kernel": row["kernel"],
              "shape": row["shape"], "dtype": dtype_name,
              "fault": "o zeroed on the rows with no valid slot",
              "passes": row["planted_fault_passes"]})
    if refused:
        row["library_refused"] = refused
        emit({"phase": "kernel_check_library", "kernel": row["kernel"],
              "shape": row["shape"], "refused": refused})
    return row


def normalised(o, m, l):
    """The partial statistics as they are compared: (o / l, m, l)."""
    return o / l[..., None], m, l


def paged_tables(rng, lengths, ps, Pseq, num_pages):
    """Block tables of rows holding ``lengths`` tokens: each row's pages
    are distinct ids of a shuffled pool; entries past a row's last page
    (every entry of a row with no token) point at the scratch page
    ``num_pages``."""
    used = -(-np.asarray(lengths) // ps)
    ids = rng.permutation(num_pages)
    bt = np.full((len(used), Pseq), num_pages, np.int32)
    start = 0
    for b, u in enumerate(used):
        bt[b, :u] = ids[start:start + u]
        start += u
    return bt


def paged_work(lengths, ps, Pseq, window=None):
    """What a paged decode call must read, from this call's lengths:
    per row the counted tokens (K and V, scores and P.V) and the table
    entries of their pages; a row with none (length 0) reads instead the
    V (latents) of all Pseq * ps slots and every table entry, and sums
    them into a uniform mean.  Returns (counted tokens, mean slots,
    table entries)."""
    lengths = np.asarray(lengths, np.int64)
    hi = np.minimum(lengths, Pseq * ps)
    lo = np.maximum(0, lengths - window) if window else np.zeros_like(hi)
    counted = hi > lo
    tokens = int(np.where(counted, hi - lo, 0).sum())
    pages = np.where(counted, -(-hi // ps) - lo // ps, Pseq)
    return tokens, int((~counted).sum()) * Pseq * ps, int(pages.sum())


def paged_walks(lengths, slots, window=None):
    """Each row's walk (first, last) in the paged GQA kernel: from the
    32-slot window of its first counted token to its last, or every slot
    of a row with none."""
    walks = []
    for n in np.asarray(lengths):
        hi = min(int(n), slots)
        lo = max(0, int(n) - window) if window else 0
        walks.append((lo & ~31, hi) if lo < hi else (0, slots))
    return walks


def check_paged(torch, rng, B, H, Hkv, ps, Pseq, D, lengths, num_pages,
                soft_cap, window, dtype_name, split=None):
    """paged_decode_attention on rows of ``lengths`` tokens (see
    ``paged_tables``).  The yardstick (no soft cap) is two calls: a
    gather of each row's pages, then SDPA with the row's mask.
    ``split`` as :func:`check_decode`'s; the power check's plain version
    is the dense one over the gathered rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    lengths = np.asarray(lengths, np.int32)
    bt = paged_tables(rng, lengths, ps, Pseq, num_pages)
    q = _randn(torch, rng, (B, H, D), dtype)
    kp, vp = (_randn(torch, rng, (num_pages + 1, ps, Hkv, D), dtype)
              for _ in range(2))
    bt_t, ln_t = (torch.as_tensor(a, device=DEVICE) for a in (bt, lengths))
    tokens, mean_slots, pages = paged_work(lengths, ps, Pseq, window)
    it = q.element_size()
    kw = dict(soft_cap=soft_cap, window=window)
    t = np.arange(Pseq * ps)[None, :]
    allowed = t < lengths[:, None]
    if window:
        allowed &= lengths[:, None] - 1 - t < window
    mask = torch.as_tensor(allowed, device=DEVICE)[:, None, None, :]
    bt_l = bt_t.long()

    def library():
        k = kp[bt_l].flatten(1, 2).transpose(1, 2)
        v = vp[bt_l].flatten(1, 2).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=H != Hkv)[:, :, 0]

    kg, vg = (x[bt_l].flatten(1, 2) for x in (kp, vp))
    S = pda.splits(B, H, Hkv, ps, Pseq, D, D,
                   window if window and window < Pseq * ps else 0, q.device)
    return check_attention(
        torch, "paged_decode_attention", (B, H, Hkv, ps, Pseq, D),
        dtype_name, lambda: pda.paged_decode_attention(q, kp, vp, bt_t, ln_t,
                                                       **kw),
        lambda: ref.paged_decode_attention_ref(q, kp, vp, bt_t, ln_t, **kw),
        None if soft_cap else library,
        it * (2 * B * H * D + (2 * tokens + mean_slots) * Hkv * D)
        + 4 * (pages + B), (tokens * 4 + mean_slots * 2) * H * D,
        extra=split_checks(
            torch, S, split, dtype_name, lambda m: ref.decode_attention_ref(
                q, kg, vg, m, soft_cap=soft_cap), allowed, paged_walks(
                lengths, Pseq * ps, window)))


def long_decode_rows(torch, rng, H, Hkv, D):
    """Rows whose walks the GQA decode kernels split over blocks (each
    must be split), in fp32 and bf16: dense and partial over 1,000 slots
    (no multiple of 32 S) of 3 rows whose valid slots end inside a chunk
    (517), lie only in the last chunk (the last slot) and are none; paged
    over 63 pages of 16 with 517 tokens, a full table and length 0, with
    no window and a window of 300 (its walk starts inside a chunk)."""
    valid = np.zeros((3, 1000), bool)
    valid[0, :517] = True
    valid[1, -1] = True
    rows = []
    for dt in ("float32", "bfloat16"):
        rows.append(check_decode(torch, rng, 3, H, Hkv, 1000, D, None, dt,
                                 valid=valid, split=True))
        rows.append(check_decode_partial(torch, rng, 3, H, Hkv, 1000, D,
                                         valid, dt, split=True))
        for window in (None, 300):
            rows.append(check_paged(torch, rng, 3, H, Hkv, 16, 63, D,
                                    [517, 1008, 0], 96, 0.0, window, dt,
                                    split=True))
    return rows


def phase_attention_kernels(torch):
    """The LM path's shapes in bf16 (full-width stablelm: 32 heads,
    head_dim 64, prompts in the 64-token bucket; decode at 57 to 64
    cached tokens, the paged tiers' pages filled to their budget: none
    split), long rows at head dim 64 (8 heads on 2: split), then the
    sweep shapes of tests/test_kernels.py in fp32 and bf16."""
    rng = np.random.default_rng(SEED + 4)
    lens = lambda B: LM_PROMPT + 1 + np.arange(B) % LM_STEPS  # noqa: E731
    main = {"flash_attention": check_flash(torch, rng, 32, 32, 64, 64, 0,
                                           "bfloat16", split=False)}
    rows = [main["flash_attention"]]
    for B in (1, 4, 8):
        rows.append(check_decode(torch, rng, B, 32, 32, 256, 64, lens(B),
                                 "bfloat16", split=False))
    main["decode_attention"] = rows[-1]
    # every slot valid: masked slots are not read, so this row's time is
    # the one to set beside the 57-64-valid row's
    rows.append(check_decode(torch, rng, 8, 32, 32, 256, 64, [256] * 8,
                             "bfloat16", split=False))
    for B, pages in ((4, 16), (16, 64), (32, 128)):
        rows.append(check_paged(torch, rng, B, 32, 32, 16, 16, 64, lens(B),
                                pages, 0.0, None, "bfloat16", split=False))
    main["paged_decode_attention"] = rows[-1]
    rows += long_decode_rows(torch, rng, 8, 2, 64)
    for dt in ("float32", "bfloat16"):
        for BH, BHkv, T, D in ((2, 2, 128, 64), (2, 2, 256, 32),
                               (2, 2, 256, 128), (2, 2, 100, 64),
                               (8, 4, 77, 32)):
            for window in (0, 64):
                rows.append(check_flash(torch, rng, BH, BHkv, T, D, window,
                                        dt))
        for H, Hkv, C in ((8, 2, 256), (4, 4, 128), (16, 2, 512)):
            rows.append(check_decode(torch, rng, 2, H, Hkv, C, 64, None, dt))
        # a row with no valid slot (the mean of every slot's V) and a row
        # whose only valid slot is the last
        edge = np.zeros((2, 256), bool)
        edge[1, -1] = True
        for H, Hkv in ((8, 2), (32, 32)):
            rows.append(check_decode(torch, rng, 2, H, Hkv, 256, 64, None, dt,
                                     valid=edge))
        # head dims that are no multiple of 16 (zero-padded on the tensor
        # cores in bf16), and in bf16 rows that are no whole 16-byte
        # pieces (D 36, the one-warpgroup instance)
        for window in (0, 64):
            rows.append(check_flash(torch, rng, 2, 2, 100, 40, window, dt))
            rows.append(check_flash(torch, rng, 4, 2, 100, 36, window, dt))
        for H, Hkv, ps, Pseq in ((8, 2, 16, 4), (4, 4, 8, 6)):
            for cap, window in ((0.0, None), (30.0, None), (0.0, 20)):
                rows.append(check_paged(
                    torch, rng, 2, H, Hkv, ps, Pseq, 64,
                    rng.integers(1, Pseq * ps + 1, 2), 2 * Pseq + 3, cap,
                    window, dt))
                # a row with no token (the mean of every slot's V) beside
                # one whose last page is partly filled
                rows.append(check_paged(
                    torch, rng, 2, H, Hkv, ps, Pseq, 64,
                    [0, Pseq * ps - ps // 2 - 1], 2 * Pseq + 3, cap,
                    window, dt))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"attention kernels disagree with their plain "
                             f"versions: {bad}")
    return main


def phase_gemma_kernels(torch):
    """gemma3's shapes (4 query heads on one kv head, D = Dv = 256) in
    bf16: flash at the 64-token bucket of a 56-token prompt and at the
    long prompt's 1024 bucket (window 512, local layers; none, global);
    dense decode at B 1/4/8 over 256-slot rings of 57-64 valid slots and
    the long run's full 512-slot local ring and 1024-slot global ring of
    616 tokens; paged decode at B 4/16/32 over 16-token pages and the long
    run's 616-token rows under the 512 window (the long rows split, the
    serving ones not), and :func:`long_decode_rows` at gemma3's heads.
    Then fp32 rows (the parity cut's instances: flash on the CUDA cores
    at Dv 256), decode with a soft cap among them (no registered config
    sets one)."""
    rng = np.random.default_rng(SEED + 8)
    lens = lambda B: LM_PROMPT + 1 + np.arange(B) % LM_STEPS  # noqa: E731
    long_len = [LONG_PROMPT + LONG_STEPS] * LONG_ROWS
    main = {"flash_attention": check_flash(torch, rng, 4, 1, 64, 256, 0,
                                           "bfloat16", split=False)}
    rows = [main["flash_attention"]]
    rows += [check_flash(torch, rng, 4, 1, 1024, 256, w, "bfloat16",
                         split=True) for w in (512, 0)]
    main["flash_attention_merge"] = check_flash_merge(torch, rng, 4, 1, 1024,
                                                      256, 0)
    rows.append(main["flash_attention_merge"])
    rows += [check_decode(torch, rng, B, 4, 1, 256, 256, lens(B),
                          "bfloat16", split=False) for B in (1, 4, 8)]
    main["decode_attention"] = rows[-1]
    rows.append(check_decode(torch, rng, LONG_ROWS, 4, 1, 512, 256,
                             [512] * LONG_ROWS, "bfloat16", split=True))
    rows.append(check_decode(torch, rng, LONG_ROWS, 4, 1, 1024, 256,
                             long_len, "bfloat16", split=True))
    for B, pages in ((4, 16), (16, 64), (32, 128)):
        rows.append(check_paged(torch, rng, B, 4, 1, 16, 16, 256, lens(B),
                                pages, 0.0, None, "bfloat16", split=False))
    main["paged_decode_attention"] = rows[-1]
    rows.append(check_paged(torch, rng, LONG_ROWS, 4, 1, 16, 64, 256,
                            long_len, 64 * LONG_ROWS, 0.0, 512, "bfloat16",
                            split=True))
    rows += long_decode_rows(torch, rng, 4, 1, 256)
    rows += [check_flash(torch, rng, 4, 1, 1024, 256, 512, "float32"),
             check_flash(torch, rng, 2, 1, 100, 256, 0, "float32"),
             check_flash(torch, rng, 2, 2, 77, 136, 20, "float32", Dv=256),
             check_decode(torch, rng, 2, 4, 1, 512, 256, [512, 300],
                          "float32", soft_cap=1.0, split=True),
             check_decode(torch, rng, 2, 4, 1, 1024, 256, [616, 0],
                          "float32", split=True),
             check_paged(torch, rng, 2, 4, 1, 16, 64, 256, [616, 37], 130,
                         1.0, 512, "float32", split=True)]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"head-dim-256 attention kernels disagree with "
                             f"their plain versions: {bad}")
    return main


def check_router(torch, rng, T, E, k, tie=False, rounding_tie=False):
    """topk_router at (T, E, k); with ``tie`` the first row's logits are
    all equal, so every probability ties and the picks are 0..k-1; with
    ``rounding_tie`` the first row's top two logits (experts 1 and 0)
    have different exponentials but one probability (the rows of
    tests/test_torch_moe_kernels.py's ``rounding_tie_logits``), so the
    picks start 0, 1.  ``floor_ms``: an empty kernel on the router's
    grid, timed as the router is, the time no kernel body can remove."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import topk_router as tr
    x = rng.normal(size=(T, E)).astype(np.float32)
    if tie:
        x[0] = 0.5
    if rounding_tie:
        x[0] = -200.0
        x[0, :2] = -2.0 ** -24, 0.0
        x[0, 2:11] = np.float32(-3 * np.log(2))
    logits = torch.as_tensor(x, device=DEVICE)
    w, i = tr.topk_router(logits, k)
    wr, ir = ref.topk_router_ref(logits, k)
    torch.cuda.synchronize()
    err = (w - wr).abs().max().item()
    same_idx = bool(torch.equal(i, ir))
    if tie:
        same_idx &= i[0].tolist() == list(range(k))
    if rounding_tie:
        same_idx &= i[0, :2].tolist() == [0, 1]

    def library():
        return torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)

    # logits in, weights and indices out; softmax (max, exp, sum, divide)
    # and k scans over every logit
    nbytes, ops_ = 4 * T * E + 8 * T * k, T * E * (4 + k)
    bound_ms, bound_by = bound(nbytes, ops_)
    def floor():
        build.launch("topk_router_floor", T,
                     torch.cuda.current_stream().cuda_stream)

    row = {"kernel": "topk_router", "shape": [T, E, k], "dtype": "float32",
           "tie_row": tie, "rounding_tie_row": rounding_tie,
           "max_abs_err": err, "tol": ROUTER_TOL, "indices_equal": same_idx,
           "ok": bool(err <= ROUTER_TOL and same_idx),
           **timings(torch, lambda: tr.topk_router(logits, k),
                     lambda: ref.topk_router_ref(logits, k), library, 200,
                     20),
           "floor_ms": device_ms(torch, floor, 200),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": ops_}
    emit({"phase": "kernel_check", **row})
    return row


def check_paged_mla(torch, rng, B, H, R, Dr, ps, Pseq, lengths, num_pages,
                    dtype_name):
    """paged_mla_decode_attention on rows of ``lengths`` tokens (see
    ``paged_tables``).  The yardstick is two calls: a gather of each
    row's pages of [c_kv | k_rope] latents (one pool, made outside the
    timing), then SDPA with the row's mask, every head sharing the one
    latent "kv head"."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    lengths = np.asarray(lengths, np.int32)
    bt = paged_tables(rng, lengths, ps, Pseq, num_pages)
    qc, qr = (_randn(torch, rng, (B, H, w), dtype) for w in (R, Dr))
    ckv, kr = (_randn(torch, rng, (num_pages + 1, ps, w), dtype)
               for w in (R, Dr))
    bt_t, ln_t = (torch.as_tensor(a, device=DEVICE) for a in (bt, lengths))
    scale = 1.0 / np.sqrt(128 + Dr)      # deepseek's nope 128 + rope
    tokens, mean_slots, pages = paged_work(lengths, ps, Pseq)
    it = qc.element_size()
    q_cat = torch.cat([qc, qr], -1)[:, :, None]
    latents = torch.cat([ckv, kr], -1)
    allowed = np.arange(Pseq * ps)[None, :] < lengths[:, None]
    mask = torch.as_tensor(allowed, device=DEVICE)[:, None, None, :]
    bt_l = bt_t.long()

    def library():
        lat = latents[bt_l].flatten(1, 2)[:, None]
        return F.scaled_dot_product_attention(
            q_cat, lat, lat[..., :R], attn_mask=mask, scale=scale,
            enable_gqa=True)[:, :, 0]

    return check_attention(
        torch, "paged_mla_decode_attention", (B, H, R, Dr, ps, Pseq),
        dtype_name,
        lambda: pda.paged_mla_decode_attention(qc, qr, ckv, kr, bt_t, ln_t,
                                               scale=scale),
        lambda: ref.paged_mla_decode_attention_ref(qc, qr, ckv, kr, bt_t,
                                                   ln_t, scale=scale),
        library, it * (B * H * (2 * R + Dr) + tokens * (R + Dr)
                       + mean_slots * R) + 4 * (pages + B),
        (tokens * (2 * R + Dr) + mean_slots * R) * H * 2)


def phase_moe_kernels(torch):
    """The MoE slice's kernels at its shapes (full-width deepseek-v2-lite:
    router over 64 experts top-6 at the 64-token prefill bucket and at 32
    and 1 decode rows; absorbed-MLA paged decode at 16 heads, R 512, Dr
    64, 16-token pages, 57 to 64 cached tokens a row; flash at score dim
    192 and value dim 128), then the sweep shapes of tests/test_kernels.py
    in fp32 and bf16, and tie rows for the router (equal logits; a
    rounding tie)."""
    rng = np.random.default_rng(SEED + 7)
    lens = lambda B: LM_PROMPT + 1 + np.arange(B) % LM_STEPS  # noqa: E731
    main = {}
    rows = [check_router(torch, rng, T, 64, 6) for T in (64, 32, 1)]
    main["topk_router"] = rows[0]
    rows += [check_router(torch, rng, T, E, k, tie)
             for T, E, k in ((64, 16, 4), (128, 60, 4), (32, 64, 6),
                             (1, 60, 4), (33, 60, 4), (7, 200, 8))
             for tie in (False, True)]
    rows += [check_router(torch, rng, T, E, k, rounding_tie=True)
             for T, E, k in ((64, 64, 6), (1, 60, 4), (33, 60, 4))]
    for B, pages in ((1, 16), (4, 16), (32, 128)):
        rows.append(check_paged_mla(torch, rng, B, 16, 512, 64, 16, 16,
                                    lens(B), pages, "bfloat16"))
    main["paged_mla_decode_attention"] = rows[-1]
    rows.append(check_flash(torch, rng, 16, 16, 64, 192, 0, "bfloat16",
                            Dv=128, split=False))
    main["flash_attention"] = rows[-1]
    for dt in ("float32", "bfloat16"):
        for H, R, Dr, ps, Pseq in ((8, 64, 16, 16, 4), (4, 128, 32, 8, 3)):
            rows.append(check_paged_mla(
                torch, rng, 2, H, R, Dr, ps, Pseq,
                rng.integers(1, Pseq * ps + 1, 2), 2 * Pseq + 2, dt))
            # a row with no token (the mean of every slot's latent) beside
            # one whose last page is partly filled
            rows.append(check_paged_mla(
                torch, rng, 2, H, R, Dr, ps, Pseq,
                [0, Pseq * ps - ps // 2 - 1], 2 * Pseq + 2, dt))
        # deepseek's widths: a row with no token among full-width rows
        rows.append(check_paged_mla(torch, rng, 3, 16, 512, 64, 16, 16,
                                    [0, 61, 9], 20, dt))
        rows.append(check_flash(torch, rng, 2, 2, 100, 192, 0, dt, Dv=128))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"MoE slice kernels disagree with their plain "
                             f"versions: {bad}")
    return main


def numpy_clients(rng, m, clients: int):
    """Stacked client replicas of the GRU in the JAX package's layout:
    fan-in-normal weights, small random biases (replicas that trained
    apart)."""
    h = m.rnn_hidden

    def draw(shape, std):
        return (rng.normal(size=(clients,) + shape) * std).astype(np.float32)

    gru = {}
    for i in range(m.rnn_layers):
        din = 1 if i == 0 else h
        gru[str(i)] = {"w_x": draw((din, 3 * h), din ** -0.5),
                       "w_h": draw((h, 3 * h), h ** -0.5),
                       "b": draw((3 * h,), 0.01)}
    return {"gru": gru, "head": {"w": draw((h, 1), h ** -0.5),
                                 "b": draw((1,), 0.01)}}


def param_count(tree) -> int:
    from repro_torch.params import flatten_with_path
    return sum(int(np.prod(x.shape)) for _, x in flatten_with_path(tree))


def max_tree_err(a, b) -> float:
    from repro_torch.params import flatten_with_path
    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for (_, x), (_, y) in zip(flatten_with_path(a),
                                         flatten_with_path(b)))


def all_finite(tree) -> bool:
    from repro_torch.params import flatten_with_path
    return all(bool(x.isfinite().all()) for _, x in flatten_with_path(tree))


def phase_slice(torch):
    """The main path, through the entry points a user calls."""
    from repro_torch.configs import get_config
    from repro_torch.fl import cluster_fedavg, fedavg, global_fedavg
    from repro_torch.kernels import ops
    from repro_torch.params import from_numpy_tree, tree_map
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import ReplicaPool, TierSpec

    m = get_config("gru-traffic").model
    rng = np.random.default_rng(SEED + 1)
    clients = numpy_clients(rng, m, len(CLUSTER_IDS))
    sizes = rng.integers(50, 500, len(CLUSTER_IDS))    # client data sizes
    stacked = from_numpy_tree(clients, DEVICE)
    stacked_cpu = from_numpy_tree(clients, "cpu")
    specs = [TierSpec(t, batch_size=b, reduced=False)
             for t, b in TIER_BATCH.items()]
    windows = {t: [rng.normal(size=(b, HISTORY, 1))
                   for _ in range(BATCHES_PER_TIER)]
               for t, b in TIER_BATCH.items()}

    ops.reset_launches()
    t0 = time.perf_counter()
    flat = fedavg(stacked, sizes)
    local = cluster_fedavg(stacked, CLUSTER_IDS, sizes)
    glob = global_fedavg(stacked, CLUSTER_IDS, sizes)
    model = tree_map(lambda x: x[0], glob)
    pool = ReplicaPool(specs, shared_params=model, device=DEVICE)
    preds = {t: [pool.dispatch(t, w) for w in ws]
             for t, ws in windows.items()}
    pool.mark_down("edge")
    before = pool.failovers
    failover_pred = pool.dispatch("edge", windows["edge"][0])
    failovers = pool.failovers - before
    pool.mark_up("edge")
    measured = pool.measure()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()

    # the plain path: the same entry points on CPU tensors
    cpu_model = tree_map(lambda x: x[0],
                         global_fedavg(stacked_cpu, CLUSTER_IDS, sizes))
    cpu_pool = ReplicaPool(specs, shared_params=cpu_model, device="cpu")
    agg_err = max(max_tree_err(flat, fedavg(stacked_cpu, sizes)),
                  max_tree_err(local, cluster_fedavg(stacked_cpu, CLUSTER_IDS,
                                                     sizes)),
                  max_tree_err(model, cpu_model))
    pred_err = max((p - cpu_pool.dispatch(t, w).to(p.device)).abs().max()
                   .item() for t in windows
                   for p, w in zip(preds[t], windows[t]))
    failover_err = (failover_pred.cpu()
                    - cpu_pool.dispatch("cloud", windows["edge"][0])
                    ).abs().max().item()
    lat = LatencyModel.from_measurements(measured)

    rep = pool.replica("cloud")
    n_dispatch = BATCHES_PER_TIER * len(TIER_BATCH) + 1
    # per forward: one gru_seq launch per layer; measure() makes one
    # warm-up and 8 timed forwards per tier
    want = {"gru_seq": m.rnn_layers * (n_dispatch + 9 * len(TIER_BATCH)),
            "fedavg_reduce": 1 + 2 * len(np.unique(CLUSTER_IDS)) + 1,
            "flash_attention": 0, "decode_attention": 0,
            "decode_attention_partial": 0,
            "paged_decode_attention": 0, "paged_mla_decode_attention": 0,
            "topk_router": 0, "mamba_chunk_scan": 0,
            "flash_attention_merge": 0}
    checks = {
        "full_width": (rep.cfg.model.rnn_hidden == 128
                       and tuple(rep.params["gru"]["1"]["w_h"].shape)
                       == (128, 384)),
        "finite": all_finite(glob) and all(
            bool(p.isfinite().all()) for ps in preds.values() for p in ps),
        "shapes": all(tuple(p.shape) == (TIER_BATCH[t], 1)
                      for t, ps in preds.items() for p in ps),
        "aggregation_matches_plain": agg_err <= FEDAVG_TOL["float32"],
        "predictions_match_plain": pred_err <= PRED_TOL,
        "failover_to_cloud": failovers == 1 and failover_err <= PRED_TOL,
        "launches": launches == want,
    }
    emit({"phase": "slice", "params": param_count(model),
          "seconds": seconds, "launches": launches,
          "expected_launches": want, "aggregation_max_abs_err": agg_err,
          "prediction_max_abs_err": pred_err,
          "failover_max_abs_err": failover_err,
          "tier_ms": {t: mm.prefill_ms for t, mm in measured.items()},
          "calibrated_infer_ms": {t: lat.infer_ms(t) for t in TIER_BATCH},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, pool, measured


def phase_profile(torch, pool, measured, batches: int = 20):
    """Where a request batch's time goes on the card: device time by
    kernel from ``torch.profiler`` over ``batches`` dispatches per tier,
    beside the tier's measured time per batch; the rest is the device
    waiting for the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for tier, b in TIER_BATCH.items():
        w = torch.as_tensor(rng.normal(size=(b, HISTORY, 1)),
                            dtype=torch.float32, device=DEVICE)
        pool.dispatch(tier, w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                pool.dispatch(tier, w)
            torch.cuda.synchronize()
        # device-side events only: a CPU op's device time repeats its
        # kernels' time
        kernels = {e.key[:80]: e.self_device_time_total / 1e3 / batches
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        device_ms = sum(kernels.values())
        tier_ms = measured[tier].prefill_ms
        out[tier] = {
            "tier_ms": tier_ms, "device_ms": device_ms or None,
            "device_idle_share": (1.0 - device_ms / tier_ms
                                  if device_ms else None),
            # the forward's two recurrences (one a layer)
            "gru_seq_ms": sum(v for k, v in kernels.items()
                              if "gru_seq" in k),
            "kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:6])}
    emit({"phase": "profile", "per_request_batch": out})


def hfl_deployment(data, orch, serving, device):
    """The quickstart's inventory over the slice's 20 sensors, clustered by
    HFLOP (l = 2), with one full-width GRU replica per tier on
    ``device``."""
    ds = data.generate(num_days=30, seed=SEED)
    sensors = data.select_fl_sensors(ds, per_cluster=HFL_PER_CLUSTER,
                                     seed=SEED)
    lam = np.random.default_rng(SEED).uniform(2.0, 6.0, len(sensors))
    devices = [orch.DeviceNode(i, lam=float(lam[i]),
                               lan_edge=int(ds.cluster_of[sensors[i]]))
               for i in range(len(sensors))]
    edges = [orch.EdgeNode(j, capacity_rps=float(lam.sum() / 4 * 1.4))
             for j in range(4)]
    tiers = [serving.TierSpec(t, batch_size=b, reduced=False)
             for t, b in TIER_BATCH.items()]
    controller = orch.LearningController(
        orch.Inventory(devices, edges), l=2, serving_tiers=tiers,
        device=device)
    return ds, sensors, controller, controller.deploy()


def numpy_permutations(torch, seed):
    """A ``permutations`` callable drawing with numpy from ``seed``, one
    draw per round however often the round is asked for, so that two
    runs in turn train on the same minibatch orders.  ``draw.drawn``
    holds the draws by round."""
    rng = np.random.default_rng(seed)

    def draw(t, C, epochs, N):
        if t not in draw.drawn:
            draw.drawn[t] = np.stack([[rng.permutation(N)
                                       for _ in range(epochs)]
                                      for _ in range(C)])
        return torch.from_numpy(draw.drawn[t])

    draw.drawn = {}
    return draw


def phase_hfl(torch):
    """The paper's training pipeline through the entry points a user
    calls: HFLOP clustering, continual hierarchical FedAvg of the
    full-width GRU (every forward in ``gru_seq``, every aggregation in
    ``fedavg_reduce``) on the card and on the CPU from the same numpy
    model and minibatch orders; ``fedavg_reduce`` held against its plain
    version at every shape the run gave it; a profile of one training
    step; the routing simulator with its default latencies and
    calibrated from the deployment's replicas."""
    from repro_torch import data, orchestration, serving
    from repro_torch.configs import get_config
    from repro_torch.fl import client
    from repro_torch.fl.hierarchy import ContinualHFL, HFLRunConfig
    from repro_torch.kernels import ops
    from repro_torch.params import tree_map
    from repro_torch.routing import LatencyModel, SimConfig, compare_methods

    t_phase = time.perf_counter()
    cfg = get_config("gru-traffic")
    m = cfg.model
    ds, sensors, controller, deployment = hfl_deployment(
        data, orchestration, serving, DEVICE)
    topo = deployment.topology
    params0 = tree_map(lambda x: x[0], numpy_clients(
        np.random.default_rng(SEED + 4), m, 1))
    run = HFLRunConfig(**HFL_RUN)
    perms = numpy_permutations(torch, SEED + 5)

    def train(device):
        hfl = ContinualHFL(cfg, ds, sensors, topo, run, mode="hier",
                           params0=params0, permutations=perms,
                           device=device)
        t0 = time.perf_counter()
        res = hfl.run_rounds()
        if device == DEVICE:
            torch.cuda.synchronize()
        return hfl, res, (time.perf_counter() - t0) / run.rounds

    ops.reset_launches()
    hfl, card, card_s = train(DEVICE)
    launches = ops.launch_counts()
    hfl_cpu, cpu, cpu_s = train("cpu")

    C = len(sensors)
    N = perms.drawn[0].shape[-1]                    # windows per client
    n_batches = min(N // run.batch_size, run.max_batches)
    K = len(np.unique(hfl.cluster_ids))
    want = {k: 0 for k in launches}
    want["gru_seq"] = (m.rnn_layers * run.rounds * C
                       * (run.local_epochs * n_batches + 1))
    want["fedavg_reduce"] = K + (K + 1)         # a local and a global round
    # the run's reductions: each cluster's clients, then the K cluster
    # models in the global round, over every parameter of the model
    n_params = param_count(tree_map(lambda x: x[0], hfl.params))
    fed_shapes = sorted({int(c) for c in np.bincount(hfl.cluster_ids)
                         if c} | {K}, reverse=True)
    fed_rows = [check_fedavg_reduce(torch, np.random.default_rng(SEED + 6),
                                    c, n_params, "float32")
                for c in fed_shapes]
    errs = {"mse_max_rel_err": float(np.max(np.abs(card.mse - cpu.mse)
                                            / np.abs(cpu.mse))),
            "train_loss_max_rel_err": float(np.max(
                np.abs(card.train_loss - cpu.train_loss)
                / np.abs(cpu.train_loss))),
            "params_max_abs_err": max_tree_err(hfl.params, hfl_cpu.params)}

    # one training step of one client at the slice's batch, profiled
    rng = np.random.default_rng(SEED + 7)
    p = tree_map(lambda x: x[0].detach().clone().requires_grad_(),
                 hfl.params)
    X, y = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=DEVICE)
            for s in ((run.batch_size, HISTORY, 1), (run.batch_size, 1)))

    def step():
        return client.sgd_step(p, m, X, y, run.lr)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HFL_PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / HFL_PROFILE_STEPS
    step_profile = profile_once(torch, step, HFL_PROFILE_STEPS, top=None)
    step_profile["gru_seq_ms"] = sum(
        v for k, v in step_profile["kernels_ms"].items() if "gru_seq" in k)
    step_profile["kernels_ms"] = dict(
        list(step_profile["kernels_ms"].items())[:8])

    # the routing simulator, default and calibrated from the replicas
    ops.reset_launches()
    calibrated = deployment.calibrated_latency()
    torch.cuda.synchronize()
    calib_launches = ops.launch_counts()
    inst = controller.inventory.to_instance(l=2)
    assigns = {"flat": None, "hflop": topo.assign}
    sims = {}
    for name, lat in (("default", LatencyModel()),
                      ("calibrated", calibrated)):
        logs = compare_methods(inst, assigns, SimConfig(
            duration_s=HFL_SIM_S, seed=SEED, latency=lat))
        sims[name] = {k: {"mean_ms": log.mean_latency(),
                          "std_ms": log.std_latency(),
                          "tier_fractions": log.tier_fractions()}
                      for k, log in logs.items()}
    calib_want = {k: 0 for k in calib_launches}
    # measure(): one warm-up and 8 timed forwards per tier
    calib_want["gru_seq"] = m.rnn_layers * 9 * len(TIER_BATCH)

    checks = {
        "full_width": tuple(hfl.params["gru"]["1"]["w_h"].shape)
        == (C, 128, 384),
        "val_mse_matches_cpu": errs["mse_max_rel_err"] <= HFL_TOL,
        "params_match_cpu": errs["params_max_abs_err"] <= HFL_TOL,
        "finite": all(np.isfinite(r.mse).all()
                      and np.isfinite(r.train_loss).all()
                      for r in (card, cpu)) and all_finite(hfl.params),
        "shapes": card.mse.shape == card.train_loss.shape == (run.rounds, C),
        "launches": launches == want,
        "fedavg_reduce_matches_plain": all(r["ok"] for r in fed_rows),
        "calibration_launches": calib_launches == calib_want,
        "calibrated_latencies_finite": all(
            np.isfinite(v["mean_ms"]) and np.isfinite(v["std_ms"])
            for sim in sims.values() for v in sim.values()),
    }
    emit({"phase": "hfl_slice", "seconds": time.perf_counter() - t_phase,
          "clients": C, "clusters": K,
          "assign": topo.assign.tolist(), "windows_per_client": N,
          "minibatches_per_epoch": n_batches, **HFL_RUN,
          "seconds_per_round": {"card": card_s, "cpu": cpu_s},
          "val_mse": card.mse.mean(axis=1).tolist(),
          "errors": errs, "launches": launches,
          "expected_launches": want,
          "fedavg_reduce_shapes": [r["shape"] for r in fed_rows],
          "calibration_launches": calib_launches,
          "train_step": {"batch": run.batch_size, "step_ms": step_ms,
                         **step_profile},
          "infer_ms": {t: {"default": LatencyModel().infer_ms(t),
                           "calibrated": calibrated.infer_ms(t)}
                       for t in TIER_BATCH},
          "latency": sims, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"hfl_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


def count_calls(engine, counts) -> None:
    """Count the engine's admissions and decode steps as the main path
    makes them (``generate`` and ``measure`` call both through the
    instance), independently of the kernels' launch counters; with a
    ``prompt_tokens`` key, also the admitted prompts' tokens."""
    for name in ("admit", "decode"):
        def counted(*args, _fn=getattr(engine, name), _name=name, **kw):
            counts[_name] += 1
            if _name == "admit" and "prompt_tokens" in counts:
                counts["prompt_tokens"] += len(args[0])
            return _fn(*args, **kw)
        setattr(engine, name, counted)


def full_width_tiers(specs):
    return [dataclasses.replace(s, reduced=False) for s in specs]


def norm_params(m) -> int:
    """Weights ``ModelConfig.param_count()`` leaves out: the norms' scales
    (and LayerNorm biases), each MLA layer's ``kv_norm``, and QK-norm's
    ``q_norm`` and ``k_norm`` a layer."""
    n = (2 * m.num_layers + 1) * m.d_model * (2 if m.norm == "layernorm"
                                              else 1)
    if m.attention.kind == "mla":
        n += m.num_layers * m.attention.mla.kv_lora_rank
    if m.attention.qk_norm:
        n += 2 * m.num_layers * m.attention.head_dim
    return n


def flash_split_layers(m, rows, T, share=1):
    """Per decoder layer of ``m``, whether ``flash_splits`` splits its
    causal flash call over ``rows`` sequences of T tokens: the call's
    shape as ``models/attention.py`` folds it, (rows * H, rows * Hkv, T,
    T) under the layer's own window (MLA: every head, D 192, Dv 128),
    with H and Hkv over ``share`` (a rank's heads where the model axis
    splits them).  Only bf16 calls split."""
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels.flash_attention import flash_splits
    from repro_torch.models.transformer import layer_window
    a = m.attention
    if a.kind == "mla":
        H = Hkv = a.num_heads
        D = a.mla.qk_nope_head_dim + a.mla.qk_rope_head_dim
        Dv = a.mla.v_head_dim
    else:
        H, Hkv, D, Dv = a.num_heads, a.num_kv_heads, a.head_dim, a.head_dim
    if m.dtype != "bfloat16":
        return [False] * m.num_layers
    H, Hkv = H // share, Hkv // share
    return [flash_splits(rows * H, rows * Hkv, T, T, True,
                         w if 0 < w < T else 0, D, Dv, fr.sms(0)) > 1
            for w in (layer_window(m, i) for i in range(m.num_layers))]


def expected_lm_launches(m, calls, prefill):
    """Kernel launches of the LM engines' calls: one attention launch per
    layer per admission (flash; an admission prefills one row padded to
    ``prefill`` tokens, and its layers' calls that ``flash_splits``
    splits launch the merge too) and per decode step (the dense or paged
    decode kernel of the attention kind; MLA's dense decode has none),
    one router launch per MoE layer per admission and per step."""
    L = m.num_layers
    moe_layers = L - m.moe.first_dense_layers if m.moe else 0
    mla = m.attention.kind == "mla"
    admits = calls["dense"]["admit"] + calls["paged"]["admit"]
    dense, paged = calls["dense"]["decode"], calls["paged"]["decode"]
    return {"gru_seq": 0, "fedavg_reduce": 0,
            "flash_attention": L * admits,
            "decode_attention": 0 if mla else L * dense,
            "decode_attention_partial": 0,
            "paged_decode_attention": 0 if mla else L * paged,
            "paged_mla_decode_attention": L * paged if mla else 0,
            "topk_router": moe_layers * (admits + dense + paged),
            "mamba_chunk_scan": 0,
            "flash_attention_merge": admits * sum(flash_split_layers(
                m, 1, prefill))}


def phase_lm(torch, arch, phase):
    """An LM main path: ``arch`` at full width in bf16, weights drawn on
    the card from a seed, one weight tree shared by a dense and a paged
    pool, through the entry points a user calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import (ReplicaPool, bucket_len, lm_tiers,
                                     paged_lm_tiers)

    cfg = get_config(arch)
    m = cfg.model
    api = make_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(flatten_with_path(params))
    n_params = sum(x.numel() for x in leaves.values())
    dense = ReplicaPool(full_width_tiers(lm_tiers(arch)),
                        shared_params=params, device=DEVICE)
    paged = ReplicaPool(full_width_tiers(paged_lm_tiers(arch)),
                        shared_params=params, device=DEVICE)
    counts = {kind: {t: {"admit": 0, "decode": 0} for t in dense.tiers}
              for kind in ("dense", "paged")}
    for kind, pool in (("dense", dense), ("paged", paged)):
        for tier in pool.tiers:
            count_calls(pool.engine(tier), counts[kind][tier])
    rng = np.random.default_rng(SEED + 5)
    batches = {t: [rng.integers(0, m.vocab_size,
                                (paged.specs[t].batch_size, LM_PROMPT))
                   for _ in range(LM_BATCHES_PER_TIER)] for t in dense.tiers}

    ops.reset_launches()
    t0 = time.perf_counter()
    outs = {"dense": {t: [] for t in dense.tiers},
            "paged": {t: [] for t in paged.tiers}}
    for tier, bs in batches.items():
        rows = dense.specs[tier].batch_size
        for b in bs:
            outs["dense"][tier].append(dense.dispatch(tier, b[:rows],
                                                      steps=LM_STEPS))
            outs["paged"][tier].append(paged.dispatch(tier, b,
                                                      steps=LM_STEPS))
    dense.mark_down("edge")
    before = (dense.failovers, counts["dense"]["edge"]["admit"],
              counts["dense"]["cloud"]["admit"])
    fo_batch = batches["edge"][0][:dense.specs["edge"].batch_size]
    failover_out = dense.dispatch("edge", fo_batch, steps=LM_STEPS)
    failovers = dense.failovers - before[0]
    served_by_cloud = (counts["dense"]["edge"]["admit"] == before[1]
                       and counts["dense"]["cloud"]["admit"] - before[2]
                       == len(fo_batch))
    dense.mark_up("edge")
    measured = {"dense": dense.measure(**LM_MEASURE),
                "paged": paged.measure(**LM_MEASURE)}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()

    lat = {k: LatencyModel.from_measurements(v, decode_tokens=LM_STEPS)
           for k, v in measured.items()}
    # logits of the served model through the model API (after the counted
    # run): one prompt's prefill and one decode step
    prompt = torch.as_tensor(batches["cloud"][0][:1], device=DEVICE)
    cache = api.init_cache(1, 256, device=DEVICE)
    logits, cache = api.prefill(params, prompt, cache, length=LM_PROMPT)
    step, _ = api.decode_step(params, prompt[:, -1:],
                              torch.tensor([LM_PROMPT], device=DEVICE), cache)
    calls = {k: {c: sum(v[t][c] for t in v) for c in ("admit", "decode")}
             for k, v in counts.items()}
    # every prompt (LM_PROMPT tokens, and measure()'s prompt_len)
    # prefills at one bucket
    want = expected_lm_launches(m, calls, bucket_len(LM_PROMPT))
    all_out = [o for k in outs for t in outs[k] for o in outs[k][t]]
    first_same = all(
        torch.equal(d[:, 0], p[:d.shape[0], 0])
        for t in dense.tiers
        for d, p in zip(outs["dense"][t], outs["paged"][t]))
    later = [(d[:, 1:] == p[:d.shape[0], 1:]).float().mean().item()
             for t in dense.tiers
             for d, p in zip(outs["dense"][t], outs["paged"][t])]
    routers_fp32 = all(x.dtype == torch.float32 for path, x in leaves.items()
                       if path[-1] == "router")
    checks = {
        "full_width": (all(tuple(leaves[k].shape) == v
                               for k, v in FULL_WIDTH[arch].items())
                       and params["embed"]["table"].dtype == torch.bfloat16
                       and routers_fp32
                       and n_params == m.param_count() + norm_params(m)),
        "finite_logits": bool(logits.isfinite().all()
                              and step.isfinite().all()),
        "shapes": all(
            tuple(o.shape) == (pool.specs[t].batch_size, LM_STEPS)
            for k, pool in (("dense", dense), ("paged", paged))
            for t in pool.tiers for o in outs[k][t]),
        "token_ids": all(bool(((o >= 0) & (o < m.vocab_size)).all())
                         for o in all_out),
        "dense_paged_first_tokens_equal": first_same,
        "failover_to_cloud": (failovers == 1 and served_by_cloud
                              and torch.equal(failover_out[:, 0],
                                              outs["dense"]["edge"][0][:, 0])),
        "latency_model": all(np.isfinite(lat[k].infer_ms(t)) and
                             lat[k].infer_ms(t) > 0
                             for k in lat for t in dense.tiers),
        "launches": launches == want and all(
            launches[k] > 0 for k, v in want.items() if v),
    }
    emit({"phase": phase, "arch": arch, "params": n_params,
          "config_param_count": m.param_count(), "norm_params": norm_params(m),
          "layers": m.num_layers, "d_model": m.d_model,
          "init_seconds": init_s, "seconds": seconds,
          "engine_calls": counts, "launches": launches,
          "expected_launches": want,
          "later_tokens_dense_paged_agree": float(np.mean(later)),
          "measured": {k: {t: dataclasses.asdict(mm) for t, mm in v.items()}
                       for k, v in measured.items()},
          "calibrated_infer_ms": {k: {t: lat[k].infer_ms(t)
                                      for t in dense.tiers} for k in lat},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, dense, paged, batches


def profile_once(torch, fn, n: int = 1, top=8):
    """``n`` calls of ``fn`` under ``torch.profiler``, per call: the wall
    time, the device time by kernel (the ``top`` largest; all when
    ``top`` is None), the kernel launches and the share of the wall time
    the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    kernels = {}
    for e in events:
        key = e.key[:80]
        kernels[key] = (kernels.get(key, 0.0)
                        + e.self_device_time_total / 1e3 / n)
    dev_ms = sum(kernels.values())
    return {"wall_ms": wall_ms, "device_ms": dev_ms or None,
            "device_idle_share": (1.0 - dev_ms / wall_ms
                                  if dev_ms else None),
            "device_launches": sum(e.count for e in events) / n,
            "kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:top])}


def profile_decode_steps(torch, pools, batches):
    """One decode step per LM tier with every row admitted: device time
    by kernel (``torch.profiler``) against the step's wall time."""
    out = {}
    for kind, pool in pools.items():
        for tier in pool.tiers:
            eng = pool.engine(tier)
            for prompt in batches[tier][0][:eng.batch_size]:
                eng.admit(prompt, slot=eng.acquire_slot(),
                          reserve_tokens=LM_STEPS)
            eng.decode()
            out[f"{kind}/{tier}"] = {"rows": eng.batch_size,
                                     **profile_once(torch, eng.decode)}
            eng.drain()
    return out


def phase_lm_profile(torch, dense, paged, batches, phase):
    emit({"phase": phase, "per_decode_step": profile_decode_steps(
        torch, {"dense": dense, "paged": paged}, batches)})


def numpy_lm_params(rng, m):
    """stablelm weights in the JAX package's tree and statistics
    (``ParamBuilder``: embedding normal 0.02, fan-in normal elsewhere,
    norm scales 1 and biases 0), drawn with numpy."""
    a, L, d, f = m.attention, m.num_layers, m.d_model, m.d_ff
    H, Hkv, hd, V = a.num_heads, a.num_kv_heads, a.head_dim, m.padded_vocab

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def norm(*lead):
        return {"scale": np.ones(lead + (d,), np.float32),
                "bias": np.zeros(lead + (d,), np.float32)}

    return {"embed": {"table": draw((V, d), 0.02)},
            "lm_head": {"w": draw((d, V), d ** -0.5)},
            "final_norm": norm(),
            "layers": {
                "ln1": norm(L), "ln2": norm(L),
                "attn": {"wq": draw((L, d, H, hd), H ** -0.5),
                         "wk": draw((L, d, Hkv, hd), Hkv ** -0.5),
                         "wv": draw((L, d, Hkv, hd), Hkv ** -0.5),
                         "wo": draw((L, H, hd, d), hd ** -0.5)},
                "mlp": {"wi_gate": draw((L, d, f), d ** -0.5),
                        "wi_up": draw((L, d, f), d ** -0.5),
                        "wo": draw((L, f, d), f ** -0.5)}}}


def numpy_moe_params(rng, m):
    """deepseek-v2-lite weights cut to one lead dense layer and
    ``m.num_layers - 1`` stacked MoE layers, in the JAX package's tree and
    statistics (``ParamBuilder``: embedding normal 0.02, fan-in normal
    elsewhere, RMS norm scales 1, fp32 routers), drawn with numpy."""
    a, mo, d, V = m.attention, m.moe, m.d_model, m.padded_vocab
    ml, H, E = a.mla, a.num_heads, mo.num_experts
    L = m.num_layers - mo.first_dense_layers

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ones(*shape):
        return np.ones(shape, np.float32)

    def mlp(f, *lead):
        return {"wi_gate": draw(lead + (d, f), d ** -0.5),
                "wi_up": draw(lead + (d, f), d ** -0.5),
                "wo": draw(lead + (f, d), f ** -0.5)}

    def layer(*lead):
        qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
        R = ml.kv_lora_rank
        return {"ln1": {"scale": ones(*lead, d)},
                "ln2": {"scale": ones(*lead, d)},
                "attn": {"wq": draw(lead + (d, H, qk), H ** -0.5),
                         "w_dkv": draw(lead + (d, R), d ** -0.5),
                         "w_krope": draw(lead + (d, ml.qk_rope_head_dim),
                                         d ** -0.5),
                         "kv_norm": ones(*lead, R),
                         "w_uk": draw(lead + (R, H, ml.qk_nope_head_dim),
                                      H ** -0.5),
                         "w_uv": draw(lead + (R, H, ml.v_head_dim),
                                      H ** -0.5),
                         "wo": draw(lead + (H, ml.v_head_dim, d),
                                    ml.v_head_dim ** -0.5)}}

    moe = {"router": draw((L, d, E), d ** -0.5),
           "wi_gate": draw((L, E, d, mo.d_expert), d ** -0.5),
           "wi_up": draw((L, E, d, mo.d_expert), d ** -0.5),
           "wo": draw((L, E, mo.d_expert, d), mo.d_expert ** -0.5),
           "shared": mlp(mo.d_shared, L)}
    return {"embed": {"table": draw((V, d), 0.02)},
            "lm_head": {"w": draw((d, V), d ** -0.5)},
            "final_norm": {"scale": ones(d)},
            "lead": {str(i): {**layer(), "mlp": mlp(mo.dense_d_ff)}
                     for i in range(mo.first_dense_layers)},
            "layers": {**layer(L), "moe": moe}}


def numpy_gemma_params(rng, m):
    """gemma3 weights in the JAX package's tree and statistics
    (``ParamBuilder``: embedding normal 0.02, tied to the head; fan-in
    normal elsewhere; RMS norm scales and QK-norm scales 1), drawn with
    numpy."""
    a, L, d, f = m.attention, m.num_layers, m.d_model, m.d_ff
    H, Hkv, hd, V = a.num_heads, a.num_kv_heads, a.head_dim, m.padded_vocab

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ones(*shape):
        return np.ones(shape, np.float32)

    return {"embed": {"table": draw((V, d), 0.02)},
            "final_norm": {"scale": ones(d)},
            "layers": {
                "ln1": {"scale": ones(L, d)}, "ln2": {"scale": ones(L, d)},
                "attn": {"wq": draw((L, d, H, hd), H ** -0.5),
                         "wk": draw((L, d, Hkv, hd), Hkv ** -0.5),
                         "wv": draw((L, d, Hkv, hd), Hkv ** -0.5),
                         "wo": draw((L, H, hd, d), hd ** -0.5),
                         "q_norm": ones(L, hd), "k_norm": ones(L, hd)},
                "mlp": {"wi": draw((L, d, f), d ** -0.5),
                        "wo": draw((L, f, d), f ** -0.5)}}}


def phase_gemma_long(torch, params):
    """gemma3 at full width on long prompts: a dense and a paged engine
    of LONG_ROWS rows at max_len 1024 generate LONG_STEPS tokens after a
    600-token prompt.  A local layer's dense ring (512 slots) ends
    holding exactly the last 512 positions written (it wrapped), the
    global layer's (1024) every one; flash runs at T 1024 under the
    window and both decode kernels under it past position 512.  Launches
    exact: 26 flash an admission, each split and merged (its shapes
    recorded), 26 decode a step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import (PagedServeEngine, ServeEngine,
                                     bucket_len)

    cfg = get_config(GEMMA_ARCH)
    m = cfg.model
    rng = np.random.default_rng(SEED + 9)
    prompts = rng.integers(0, m.vocab_size, (LONG_ROWS, LONG_PROMPT))
    engines = {"dense": ServeEngine(cfg, params, batch_size=LONG_ROWS,
                                    max_len=LONG_MAX_LEN, device=DEVICE),
               "paged": PagedServeEngine(cfg, params, max_seqs=LONG_ROWS,
                                         max_len=LONG_MAX_LEN, device=DEVICE)}
    counts = {k: {"admit": 0, "decode": 0} for k in engines}
    for k, eng in engines.items():
        count_calls(eng, counts[k])
    ops.reset_launches()
    t0 = time.perf_counter()
    with flash_launch_shapes() as shapes:
        out = {k: eng.generate(prompts, LONG_STEPS).cpu()
               for k, eng in engines.items()}
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    T = bucket_len(LONG_PROMPT)
    want = expected_lm_launches(m, counts, T)
    a = m.attention
    window = a.window
    # positions written: the prompt's, then one a decode step
    written = LONG_PROMPT + LONG_STEPS - 1
    rings = engines["dense"].cache["layers"]
    local = rings["0"].pos.cpu().numpy()
    glob = rings[str(m.attention.local_global_ratio)].pos.cpu().numpy()
    checks = {
        "local_ring_wrapped": rings["0"].capacity == window and all(
            sorted(row) == list(range(written - window, written))
            for row in local),
        "global_ring_holds_all": all(
            sorted(p for p in row if p >= 0) == list(range(written))
            for row in glob),
        "token_ids": all(bool(((o >= 0) & (o < m.vocab_size)).all())
                         for o in out.values()),
        "dense_paged_first_tokens_equal": torch.equal(out["dense"][:, 0],
                                                      out["paged"][:, 0]),
        "launches": launches == want and all(
            launches[k] > 0 for k, v in want.items() if v),
        # the engines admit one row at a time: every flash call is one
        # row's heads over the prompt's bucket (BH 4 on 1 kv head, T
        # 1024), and every one, global or windowed, splits its walks
        "flash_shapes": {s[:4] for s in shapes} == {(a.num_heads,
                                                     a.num_kv_heads, T, T)},
        "flash_all_split": all(s[-1] > 1 for s in shapes)
        and launches["flash_attention_merge"]
        == launches["flash_attention"] == len(shapes),
    }
    emit({"phase": "gemma_long", "arch": GEMMA_ARCH, "rows": LONG_ROWS,
          "flash_calls": [list(k) + [n] for k, n in
                          collections.Counter(shapes).items()],
          "prompt_len": LONG_PROMPT, "new_tokens": LONG_STEPS,
          "max_len": LONG_MAX_LEN, "seconds": seconds,
          "local_ring_capacity": rings["0"].capacity,
          "engine_calls": counts, "launches": launches,
          "expected_launches": want,
          "later_tokens_dense_paged_agree": (
              out["dense"][:, 1:] == out["paged"][:, 1:]).float().mean()
          .item(), "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"gemma_long checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


def phase_gemma_scheduler(torch, params):
    """Poisson arrivals through ``ContinuousBatchingScheduler`` onto
    gemma3's cloud tiers (the dense tier's 8 slots; the paged tier's 32
    rows over 128 pages), each engine with a ``Telemetry``, at SCHED_LOAD
    of the capacity its ``measure()`` gives just before: TTFT, TPOT and
    tokens a second, every request completed with its token budget, the
    page pool whole at the end, the run's ``serve.*`` counters equal to
    the engine calls it made, and 26 flash an admission and 26 decode a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     PagedServeEngine, ServeEngine,
                                     bucket_len, lm_tiers, paged_lm_tiers,
                                     poisson_requests, requests_from_events)
    from repro_torch.telemetry import Telemetry

    cfg = get_config(GEMMA_ARCH)
    m = cfg.model
    dense_spec, paged_spec = lm_tiers(GEMMA_ARCH)[2], \
        paged_lm_tiers(GEMMA_ARCH)[2]
    tel = {"dense": Telemetry(), "paged": Telemetry()}
    engines = {
        "dense": ServeEngine(cfg, params, batch_size=dense_spec.batch_size,
                             max_len=dense_spec.max_len, device=DEVICE,
                             telemetry=tel["dense"]),
        "paged": PagedServeEngine(cfg, params,
                                  max_seqs=paged_spec.batch_size,
                                  page_size=paged_spec.page_size,
                                  num_pages=paged_spec.num_pages,
                                  max_len=paged_spec.max_len, device=DEVICE,
                                  telemetry=tel["paged"])}
    rng = np.random.default_rng(SEED + 10)
    launches, rows = {}, {}
    checks = {}
    for kind, eng in engines.items():
        rows_n = eng.batch_size
        meas = eng.measure(prompt_len=SCHED_PROMPT,
                           decode_steps=LM_MEASURE["decode_steps"],
                           occupancy_levels=(rows_n,))
        (level, step_ms), = meas.occupancy_ms
        request_ms = (meas.prefill_ms
                      + (SCHED_NEW_TOKENS - 1) * step_ms / rows_n)
        rate = SCHED_LOAD * 1e3 / request_ms
        events = poisson_requests(np.full(8, rate / 8),
                                  duration_s=SCHED_REQUESTS / rate,
                                  seed=SEED)
        prompts = rng.integers(0, m.vocab_size, (len(events), SCHED_PROMPT))
        reqs = requests_from_events(events, prompts,
                                    max_new_tokens=SCHED_NEW_TOKENS)
        counts = {"admit": 0, "decode": 0}
        count_calls(eng, counts)
        before = dict(tel[kind].metrics.snapshot()["counters"])
        n_spans = len(tel[kind].tracer.spans)
        sched = ContinuousBatchingScheduler(eng)
        ops.reset_launches()
        stats = sched.run(reqs)
        torch.cuda.synchronize()
        launches[kind] = ops.launch_counts()
        none = {"admit": 0, "decode": 0}
        want = expected_lm_launches(m, {"dense": none, "paged": none,
                                        kind: counts},
                                    bucket_len(SCHED_PROMPT))
        snap = tel[kind].metrics.snapshot()
        run = {k: v - before.get(k, 0) for k, v in snap["counters"].items()}
        spans = [sp.name for sp in tel[kind].tracer.spans[n_spans:]]
        done = sched.completed
        checks[f"{kind}_measured_at_full_occupancy"] = level == rows_n
        checks[f"{kind}_every_request_completes"] = (
            len(done) == len(reqs) > 0 and not sched.queue
            and not sched.active
            and all(len(r.tokens) == r.max_new_tokens
                    and all(0 <= t < m.vocab_size for t in r.tokens)
                    for r in done))
        checks[f"{kind}_counters"] = (
            run.get("serve.admissions") == counts["admit"] == len(reqs)
            and run.get("serve.evictions") == len(reqs)
            and run.get("serve.decode_steps") == counts["decode"]
            and spans.count("serve.admit") == len(reqs))
        checks[f"{kind}_launches"] = launches[kind] == want
        if kind == "paged":
            eng.pool.check_invariants()
            checks["paged_pool_whole"] = (
                eng.pool.free_pages == eng.num_pages
                and not eng.pool.sequences
                and snap["gauges"]["page_pool.free_pages"] == eng.num_pages
                and snap["gauges"]["page_pool.sequences"] == 0)
        rows[kind] = {
            "rows": rows_n, "requests": len(reqs),
            "measured": dataclasses.asdict(meas),
            "request_ms": request_ms, "load": SCHED_LOAD,
            "rate_per_s": rate,
            "ttft_ms_p50": float(np.percentile(stats.ttft_ms, 50)),
            "ttft_ms_p95": float(np.percentile(stats.ttft_ms, 95)),
            "tpot_ms_mean": float(stats.tpot_ms.mean()),
            "tokens_per_s": stats.tokens_per_s,
            "tokens": stats.tokens_generated, "seconds": stats.duration_s,
            "slot_reuses": stats.slot_reuses,
            "peak_occupancy": stats.peak_occupancy,
            "engine_calls": counts, "launches": launches[kind],
            "expected_launches": want, "counters": run,
            "gauges": snap["gauges"], "summary": stats.summary()}
        print(f"scheduler/{kind}: {rate:.2f} requests/s, "
              f"{stats.summary()}", flush=True)
    emit({"phase": "gemma_scheduler", "arch": GEMMA_ARCH,
          "by_engine": rows, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"gemma_scheduler checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {k: sum(launches[e][k] for e in launches)
            for k in launches["dense"]}


def record_decode_logits(eng, sink: list) -> None:
    """Append each decode step's last-position logits (on the CPU, fp32)
    of engine ``eng`` to ``sink``, by wrapping its model's decode step."""
    from repro_torch.serving import PagedServeEngine
    name = ("paged_decode_step" if isinstance(eng, PagedServeEngine)
            else "decode_step")
    inner = getattr(eng.api, name)

    def step(*args, **kw):
        out, cache = inner(*args, **kw)
        sink.append(out[:, -1].float().cpu())
        return out, cache

    eng.api = eng.api._replace(**{name: step})


def phase_lm_parity(torch, arch, phase, numpy_params,
                    layers=PARITY_LAYERS, prompt_len=LM_PROMPT, max_len=256,
                    steps=LM_STEPS):
    """Full-width ``arch`` cut to ``layers`` layers, fp32, weights from a
    numpy seed (``numpy_params``): the same entry points on the card
    (kernels) and on the CPU (plain versions), for both engines, on two
    prompts of ``prompt_len`` tokens: prefill logits, each engine's decode
    step logits at every step, and the greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.params import from_numpy_tree
    from repro_torch.serving import (PagedServeEngine, ServeEngine,
                                     bucket_len)

    cfg = get_config(arch)
    m = dataclasses.replace(cfg.model, num_layers=layers,
                            dtype="float32", param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    rng = np.random.default_rng(SEED + 6)
    tree = numpy_params(rng, m)
    prompts = rng.integers(0, m.vocab_size, (2, prompt_len))
    api = make_model(pcfg)
    logits, tokens, steps_logits = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        params = from_numpy_tree(tree, dev)
        padded = torch.zeros((2, bucket_len(prompt_len)), dtype=torch.long,
                             device=dev)
        padded[:, :prompt_len] = torch.as_tensor(prompts)
        lg, _ = api.prefill(params, padded,
                            api.init_cache(2, max_len, device=dev),
                            length=prompt_len)
        logits[dev] = lg[:, :prompt_len].float().cpu()
        del lg
        for name, eng in (
                ("dense", ServeEngine(pcfg, params, batch_size=2,
                                      max_len=max_len, device=dev)),
                ("paged", PagedServeEngine(pcfg, params, max_seqs=2,
                                           max_len=max_len, device=dev))):
            sink = steps_logits[(name, dev)] = []
            record_decode_logits(eng, sink)
            tokens[(name, dev)] = eng.generate(prompts, steps).cpu()
    err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
    step_err = {name: max(
        (a - b).abs().max().item() for a, b in zip(
            steps_logits[(name, DEVICE)], steps_logits[(name, "cpu")]))
        for name in ("dense", "paged")}
    n_steps = {f"{k}/{d}": len(v) for (k, d), v in steps_logits.items()}
    checks = {"prefill_logits_match_cpu": err <= PARITY_LOGIT_TOL,
              "decode_logits_match_cpu": (
                  set(n_steps.values()) == {steps - 1}
                  and all(e <= PARITY_LOGIT_TOL for e in step_err.values())),
              "dense_tokens_match_cpu": torch.equal(tokens[("dense", DEVICE)],
                                                    tokens[("dense", "cpu")]),
              "paged_tokens_match_cpu": torch.equal(tokens[("paged", DEVICE)],
                                                    tokens[("paged", "cpu")])}
    emit({"phase": phase, "arch": arch, "layers": m.num_layers,
          "d_model": m.d_model, "prompt_len": prompt_len, "max_len": max_len,
          "dtype": m.dtype, "prefill_logits_max_abs_err": err,
          "decode_logits_max_abs_err": step_err, "decode_steps": n_steps,
          "tol": PARITY_LOGIT_TOL,
          "tokens": {f"{k}/{d}": v.tolist() for (k, d), v in tokens.items()},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def scan_work(B, L, H, P, N, Q, G, it, dtype_name):
    """The work of a scan of G groups of N-wide B, C (``it``-byte
    elements): (bytes, flops, on the tensor cores, bound ms, bound by).
    C.B^T once per batch, chunk and group (causal, Q(Q+1)/2 pairs), and
    per head the causal scores . u, C . S and the B (x) u update; the
    bf16 instance on the tensor cores (chunk and N multiples of 16, P of
    8; csrc/mamba_chunk_scan.cu) is bound at their bf16 rate."""
    from repro_torch.kernels import mamba_scan as ms
    nbytes = it * (2 * B * L * H * P + 2 * B * L * G * N) \
        + 4 * (B * L * H + H + B * H * N * P)
    pairs = Q * (Q + 1)          # 2 x the causal pairs of a chunk
    flops = B * (L // Q) * (G * pairs * N
                            + H * (pairs * P + 4 * Q * N * P))
    tc = (dtype_name == "bfloat16" and ms.kernel_chunk(Q) % 16 == 0
          and N % 16 == 0 and P % 8 == 0)
    return (nbytes, flops, tc,
            *bound(nbytes, flops, BF16_FLOP_PER_S if tc else FP32_FLOP_PER_S))


def check_mamba_scan(torch, rng, B, L, H, P, N, Q, dtype_name):
    """mamba_chunk_scan at one shape: sweep-style inputs (normal x, B,
    C; dt uniform in [0.01, 0.2); A in -[0.5, 2)), error of y and of the
    final state against the plain version, times, and the bound of the
    work: C.B^T once per batch and chunk (causal, Q(Q+1)/2 pairs), and
    per head the causal scores . u, C . S and the B (x) u update."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    x = _randn(torch, rng, (B, L, H, P), dtype)
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                         dtype=torch.float32, device=DEVICE)
    A = torch.as_tensor(-rng.uniform(0.5, 2.0, H), dtype=torch.float32,
                        device=DEVICE)
    Bm, Cm = (_randn(torch, rng, (B, L, N), dtype) for _ in range(2))
    y, st = ms.mamba_chunk_scan(x, dt, A, Bm, Cm, chunk=Q)
    yr, sr = ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype_name]
    err = (y.float() - yr.float()).abs().max().item()
    state_err = (st - sr).abs().max().item()
    ok = bool(y.dtype == dtype and st.dtype == torch.float32
              and torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol)
              and torch.allclose(st, sr, atol=SCAN_STATE_TOL,
                                 rtol=SCAN_STATE_TOL))
    nbytes, flops, tc, bound_ms, bound_by = scan_work(
        B, L, H, P, N, Q, 1, x.element_size(), dtype_name)
    row = {"kernel": "mamba_chunk_scan", "shape": [B, L, H, P, N, Q],
           "dtype": dtype_name, "tensor_cores": tc,
           "max_abs_err": err, "tol": tol,
           "state_max_abs_err": state_err, "state_tol": SCAN_STATE_TOL,
           "ok": ok,
           **timings(torch, lambda: ms.mamba_chunk_scan(x, dt, A, Bm, Cm,
                                                        chunk=Q),
                     lambda: ref.mamba_chunk_scan_ref(x, dt, A, Bm, Cm, Q),
                     None, 50, 10),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops,
           # device ms a call of each of the kernel's three launches (local
           # states, state pass, outputs)
           "kernels_ms": kernel_split_ms(
               torch, lambda: ms.mamba_chunk_scan(x, dt, A, Bm, Cm,
                                                  chunk=Q))}
    emit({"phase": "kernel_check", **row})
    return row


def check_mamba_scan_groups(torch, rng, B, L, H, P, N, Q, G, dtype_name):
    """The scan of G groups on the card: ``models/ssm.py``'s
    ``scan_per_group``, one ``mamba_chunk_scan`` a group on its H/G
    heads, against the plain scan with the group axis (``ssd_chunked``,
    the reference's head-to-group mapping), at one shape."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import ssm
    dtype = getattr(torch, dtype_name)
    x = _randn(torch, rng, (B, L, H, P), dtype)
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, (B, L, H)),
                         dtype=torch.float32, device=DEVICE)
    A = torch.as_tensor(-rng.uniform(0.5, 2.0, H), dtype=torch.float32,
                        device=DEVICE)
    Bm, Cm = (_randn(torch, rng, (B, L, G, N), dtype) for _ in range(2))

    def kernel(*t):
        return ms.mamba_chunk_scan(*(a.contiguous() for a in t),
                                   chunk=Q)[0]

    def grouped():
        return ssm.scan_per_group(kernel, x, dt, A, Bm, Cm)

    def plain():
        return ssm.ssd_chunked(x, dt, A, Bm, Cm, Q)[0]

    before = ms.mamba_chunk_scan.launches
    y = grouped()
    launches = ms.mamba_chunk_scan.launches - before
    yr = plain()
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype_name]
    err = (y.float() - yr.float()).abs().max().item()
    ok = bool(y.dtype == dtype and launches == G
              and torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol))
    nbytes, flops, tc, bound_ms, bound_by = scan_work(
        B, L, H, P, N, Q, G, x.element_size(), dtype_name)
    row = {"kernel": "mamba_chunk_scan", "shape": [B, L, H, P, N, Q],
           "groups": G, "dtype": dtype_name, "launches_a_call": launches,
           "max_abs_err": err, "tol": tol, "ok": ok,
           **timings(torch, grouped, plain, None, 50, 10),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops}
    emit({"phase": "kernel_check", **row})
    return row


def phase_ssm_kernels(torch):
    """mamba_chunk_scan at the zamba2-1.2b forward's shape in bf16 (B 2,
    L 1024, 64 heads of P 64, N 64, chunk 128), then the sweep shapes
    of tests/test_kernels.py in fp32 and a few edge shapes, and the same
    forward's shape at ngroups 2 (two launches of 32 heads); then
    flash_attention at the forward's shape (BH 64, T 1024, D 64,
    bf16)."""
    rng = np.random.default_rng(SEED + 9)
    B, L = HYBRID_BATCH
    rows = [check_mamba_scan(torch, rng, B, L, 64, 64, 64, 128, "bfloat16")]
    rows += [check_mamba_scan(torch, rng, 2, *shape, "float32")
             for shape in ((128, 4, 16, 8, 32), (64, 2, 32, 16, 64),
                           (96, 8, 8, 8, 32))]
    # the forward's shape at B 1, one chunk, H off the kernel's 4-head
    # tile, P 40 on the tensor cores and N 8 off them; fp32 at the
    # forward's widths (the parity cut's instance)
    rows += [check_mamba_scan(torch, rng, *shape, dt)
             for shape, dt in (((1, L, 64, 64, 64, 128), "bfloat16"),
                               ((2, 128, 6, 64, 64, 128), "bfloat16"),
                               ((2, 256, 3, 40, 32, 128), "bfloat16"),
                               ((2, 128, 4, 16, 8, 32), "bfloat16"),
                               ((2, 256, 64, 64, 64, 128), "float32"))]
    # ngroups 2 at the forward's shape: 2 x 32 heads, a launch a group
    groups = check_mamba_scan_groups(torch, rng, B, L, 64, 64, 64, 128, 2,
                                     "bfloat16")
    # the forward's shared attention: 2 x 32 heads of 64 over 1024 tokens
    # (window 4096 > T, so none)
    flash = check_flash(torch, rng, B * 32, B * 32, L, 64, 0, "bfloat16",
                        split=False)
    bad = [r for r in rows + [groups, flash] if not r["ok"]]
    if bad:
        raise AssertionError(f"hybrid forward kernels disagree with their "
                             f"plain versions: {bad}")
    return rows[0], flash


def expected_hybrid_launches(m, batch, forwards, prompt_tokens, steps):
    """Per forward of ``batch`` (B, T) one mamba_chunk_scan per Mamba2
    layer and one flash_attention per complete segment (merged too where
    ``flash_splits`` splits it); serving one decode_attention per
    complete segment per prompt token (the recurrent prefill runs the
    decode step) and per decode step, and no other kernel."""
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_splits
    from repro_torch.models.hybrid import _segments
    shared = sum(complete for _, _, complete in _segments(m))
    (B, T), a = batch, m.attention
    split = flash_splits(B * a.num_heads, B * a.num_kv_heads, T, T, True,
                         a.window if 0 < a.window < T else 0, a.head_dim,
                         a.head_dim, fr.sms(0)) > 1
    zero = {k: 0 for k in ops.launch_counts()}
    return ({**zero, "mamba_chunk_scan": m.num_layers * forwards,
             "flash_attention": shared * forwards,
             "flash_attention_merge": shared * forwards * split},
            {**zero, "decode_attention": shared * (prompt_tokens + steps)})


def phase_hybrid(torch):
    """The hybrid's main paths: zamba2-1.2b at full width in bf16,
    weights drawn on the card from a seed, (a) forward and loss on a
    (2, 1024) batch, (b) the dense tiers of ``lm_tiers`` serving request
    batches, one failover and ``measure()``.  Launches are counted from
    0 before (a) and read after (a) and after (b)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import ReplicaPool, lm_tiers

    cfg = get_config(HYBRID_ARCH)
    m = cfg.model
    api = make_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(flatten_with_path(params))
    n_params = sum(x.numel() for x in leaves.values())
    pool = ReplicaPool(full_width_tiers(lm_tiers(HYBRID_ARCH)),
                       shared_params=params, device=DEVICE)
    counts = {t: {"admit": 0, "decode": 0, "prompt_tokens": 0}
              for t in pool.tiers}
    for tier in pool.tiers:
        count_calls(pool.engine(tier), counts[tier])
    rng = np.random.default_rng(SEED + 10)
    toks = torch.as_tensor(rng.integers(0, m.vocab_size, HYBRID_BATCH),
                           device=DEVICE)
    labels = torch.as_tensor(rng.integers(0, m.vocab_size, HYBRID_BATCH),
                             device=DEVICE)
    batches = {t: [rng.integers(0, m.vocab_size,
                                (pool.specs[t].batch_size, HYBRID_PROMPT))
                   for _ in range(LM_BATCHES_PER_TIER)] for t in pool.tiers}

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = api.forward(params, {"tokens": toks})
        loss = api.loss(params, {"tokens": toks, "labels": labels})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    after_forward = ops.launch_counts()
    t0 = time.perf_counter()
    outs = {t: [pool.dispatch(t, b, steps=LM_STEPS) for b in bs]
            for t, bs in batches.items()}
    pool.mark_down("edge")
    before = (pool.failovers, counts["edge"]["admit"],
              counts["cloud"]["admit"])
    failover_out = pool.dispatch("edge", batches["edge"][0], steps=LM_STEPS)
    failovers = pool.failovers - before[0]
    served_by_cloud = (counts["edge"]["admit"] == before[1]
                       and counts["cloud"]["admit"] - before[2]
                       == len(batches["edge"][0]))
    pool.mark_up("edge")
    measured = pool.measure(**HYBRID_MEASURE)
    torch.cuda.synchronize()
    serving_s = time.perf_counter() - t0
    total = ops.launch_counts()
    serving = {k: total[k] - after_forward[k] for k in total}

    lat = LatencyModel.from_measurements(measured, decode_tokens=LM_STEPS)
    calls = {c: sum(v[c] for v in counts.values())
             for c in ("admit", "decode", "prompt_tokens")}
    want_forward, want_serving = expected_hybrid_launches(
        m, HYBRID_BATCH, 2, calls["prompt_tokens"], calls["decode"])
    all_out = [o for os_ in outs.values() for o in os_]
    fp32_leaves = {k[-1] for k, x in leaves.items()
                   if x.dtype == torch.float32}
    checks = {
        "full_width": (m.d_model == 2048 and m.num_layers == 38
                       and all(tuple(leaves[k].shape) == v
                               for k, v in FULL_WIDTH[HYBRID_ARCH].items())
                       and params["embed"]["table"].dtype == torch.bfloat16
                       and fp32_leaves == {"A_log", "D", "dt_bias"}
                       and n_params == HYBRID_PARAMS),
        "forward_finite": bool(logits.isfinite().all()
                               and loss.isfinite().all()),
        "forward_shape": (tuple(logits.shape) == HYBRID_BATCH
                          + (m.padded_vocab,)
                          and logits.dtype == torch.bfloat16
                          and float(aux) == 0.0),
        "shapes": all(tuple(o.shape) == (pool.specs[t].batch_size, LM_STEPS)
                      for t, os_ in outs.items() for o in os_),
        "token_ids": all(bool(((o >= 0) & (o < m.vocab_size)).all())
                         for o in all_out + [failover_out]),
        "failover_to_cloud": (failovers == 1 and served_by_cloud
                              and torch.equal(failover_out[:, 0],
                                              outs["edge"][0][:, 0])),
        "latency_model": all(np.isfinite(lat.infer_ms(t))
                             and lat.infer_ms(t) > 0 for t in pool.tiers),
        "forward_launches": after_forward == want_forward,
        "serving_launches": serving == want_serving
        and serving["decode_attention"] > 0,
    }
    emit({"phase": "hybrid_slice", "arch": HYBRID_ARCH, "params": n_params,
          "config_param_count": m.param_count(), "layers": m.num_layers,
          "d_model": m.d_model, "init_seconds": init_s,
          "forward_seconds": forward_s, "serving_seconds": serving_s,
          "loss": float(loss), "engine_calls": counts,
          "launches": total, "forward_launches": after_forward,
          "expected_forward_launches": want_forward,
          "serving_launches": serving,
          "expected_serving_launches": want_serving,
          "measured": {t: dataclasses.asdict(mm)
                       for t, mm in measured.items()},
          "calibrated_infer_ms": {t: lat.infer_ms(t) for t in pool.tiers},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"hybrid_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return total, pool, batches, params, toks


def phase_hybrid_profile(torch, pool, batches, params, toks):
    """One decode step per dense tier with every row admitted (8-token
    prompts), and one forward of the (2, 1024) batch: device ms by kernel
    and idle share."""
    from repro_torch.models import make_model
    api = make_model(pool.engine("device").cfg)

    def forward():
        with torch.no_grad():
            api.forward(params, {"tokens": toks})

    forward()
    short = {t: [b[:, :HYBRID_PROFILE_PROMPT] for b in bs]
             for t, bs in batches.items()}
    emit({"phase": "hybrid_profile",
          "per_decode_step": profile_decode_steps(torch, {"dense": pool},
                                                  short),
          "forward": {"batch": list(HYBRID_BATCH),
                      **profile_once(torch, forward)}})


def numpy_hybrid_params(rng, m):
    """zamba2 weights in the JAX package's tree and statistics
    (``ParamBuilder``: embedding normal 0.02, fan-in normal elsewhere,
    RMS norm scales 1, conv bias 0), drawn with numpy; A_log, dt_bias
    and D are drawn away from their 0 / 0 / 1 init so every head's decay
    and skip differ."""
    a, s, L, d, f, V = (m.attention, m.ssm, m.num_layers, m.d_model,
                        m.d_ff, m.padded_vocab)
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    d_in = d * s.expand
    Hs = d_in // s.head_dim
    ch = d_in + 2 * s.ngroups * s.state_dim
    e = 2 * d_in + 2 * s.ngroups * s.state_dim + Hs

    def draw(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ones(*shape):
        return np.ones(shape, np.float32)

    return {"embed": {"table": draw((V, d), 0.02)},
            "final_norm": {"scale": ones(d)},
            "mamba_layers": {
                "ln": {"scale": ones(L, d)},
                "mamba": {"in_proj": draw((L, d, e), d ** -0.5),
                          "conv_w": draw((L, s.conv_width, ch),
                                         s.conv_width ** -0.5),
                          "conv_b": np.zeros((L, ch), np.float32),
                          "A_log": draw((L, Hs), 0.5),
                          "D": 1.0 + draw((L, Hs), 0.2),
                          "dt_bias": draw((L, Hs), 0.5),
                          "norm_scale": ones(L, d_in),
                          "out_proj": draw((L, d_in, d), d_in ** -0.5)}},
            "shared": {"ln1": {"scale": ones(d)}, "ln2": {"scale": ones(d)},
                       "attn": {"wq": draw((d, H, hd), H ** -0.5),
                                "wk": draw((d, Hkv, hd), Hkv ** -0.5),
                                "wv": draw((d, Hkv, hd), Hkv ** -0.5),
                                "wo": draw((H, hd, d), hd ** -0.5)},
                       "mlp": {"wi_gate": draw((d, f), d ** -0.5),
                               "wi_up": draw((d, f), d ** -0.5),
                               "wo": draw((f, d), f ** -0.5)}}}


@contextlib.contextmanager
def fp64_upcasts(torch):
    """The port takes norms, activations and the SSD scan in fp32 through
    ``Tensor.float()``; inside this block that returns fp64, so fp64
    weights on the CPU run the same code in fp64: the reference the
    parity phase measures both fp32 forwards against."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def phase_hybrid_parity(torch):
    """Full-width zamba2 cut to 6 layers (one complete segment), fp32,
    numpy weights: the forward on the card (kernels) against the CPU
    (plain versions), stepwise decode on the card against the card's
    forward, and the dense engine's greedy tokens on both; each forward's
    distance from an fp64 forward of the same code is reported."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.params import from_numpy_tree, tree_map
    from repro_torch.serving import ServeEngine

    cfg = get_config(HYBRID_ARCH)
    m = dataclasses.replace(cfg.model, num_layers=HYBRID_PARITY_LAYERS,
                            dtype="float32", param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    rng = np.random.default_rng(SEED + 11)
    tree = numpy_hybrid_params(rng, m)
    toks = rng.integers(0, m.vocab_size, (2, HYBRID_PARITY_SEQ))
    prompts = rng.integers(0, m.vocab_size, (2, LM_PROMPT))
    api = make_model(pcfg)
    logits, tokens = {}, {}
    with torch.no_grad():
        for dev in (DEVICE, "cpu"):
            params = from_numpy_tree(tree, dev)
            logits[dev] = api.forward(params, {"tokens": torch.as_tensor(
                toks, device=dev)})[0].cpu()
            tokens[dev] = ServeEngine(pcfg, params, batch_size=2,
                                      max_len=256,
                                      device=dev).generate(prompts,
                                                           LM_STEPS).cpu()
            if dev == DEVICE:
                cache = api.init_cache(2, HYBRID_PARITY_SEQ, device=dev)
                t_dev = torch.as_tensor(toks, device=dev)
                steps = []
                for t in range(HYBRID_PARITY_SEQ):
                    lg, cache = api.decode_step(params, t_dev[:, t:t + 1],
                                                torch.tensor(t, device=dev),
                                                cache)
                    steps.append(lg[:, 0].cpu())
                stepwise = torch.stack(steps, 1)
            del params
        p64 = tree_map(lambda a: torch.as_tensor(a, dtype=torch.float64),
                       tree)
        with fp64_upcasts(torch):
            exact = api.forward(p64, {"tokens": torch.as_tensor(toks)})[0]
        del p64
    err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
    decode_err = (stepwise - logits[DEVICE]).abs().max().item()
    checks = {"forward_logits_match_cpu": err <= HYBRID_PARITY_LOGIT_TOL,
              "decode_matches_forward": bool(torch.allclose(
                  stepwise, logits[DEVICE], atol=DECODE_TOL,
                  rtol=DECODE_TOL)),
              "tokens_match_cpu": torch.equal(tokens[DEVICE],
                                              tokens["cpu"])}
    emit({"phase": "hybrid_parity", "arch": HYBRID_ARCH,
          "layers": m.num_layers, "d_model": m.d_model, "dtype": m.dtype,
          "seq": HYBRID_PARITY_SEQ, "forward_logits_max_abs_err": err,
          "fp64_max_abs_err": {d: (v.double() - exact).abs().max().item()
                               for d, v in logits.items()},
          "tol": HYBRID_PARITY_LOGIT_TOL, "decode_max_abs_err": decode_err,
          "decode_tol": DECODE_TOL,
          "tokens": {d: v.tolist() for d, v in tokens.items()},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"hybrid_parity checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


# ---------------------------------------------------------------------------
# the last model families: whisper's attention shapes, xlstm-125m,
# whisper-small, the vlm prefix
# ---------------------------------------------------------------------------

def phase_whisper_kernels(torch):
    """whisper-small's attention shapes (12 heads of dim 64 on 12 kv
    heads, 1500 encoder frames, two sequences): flash without the causal
    mask over the 1500 frames (the encoder), flash from 16 and 64
    decoder tokens to the 1500 frames (the cross attention of a forward),
    and dense decode over 1500 rows, every one valid (the decode step's
    cross attention), at the dense tiers' B 1, 4 and 8; in bf16 and in
    fp32 (the parity cut's instances)."""
    rng = np.random.default_rng(SEED + 15)
    F = 1500
    BH = 2 * 12
    main = {"encoder": check_flash(torch, rng, BH, BH, F, 64, 0,
                                   "bfloat16", causal=False, split=False)}
    rows = [main["encoder"],
            check_flash(torch, rng, BH, BH, F, 64, 0, "float32",
                        causal=False)]
    for T in (16, 64):
        rows.append(check_flash(torch, rng, BH, BH, T, 64, 0, "bfloat16",
                                causal=False, Tk=F, split=True))
    main["cross"] = rows[-1]
    rows.append(check_flash(torch, rng, BH, BH, 64, 64, 0, "float32",
                            causal=False, Tk=F))
    for dt in ("bfloat16", "float32"):
        for B in (1, 4, 8):
            rows.append(check_decode(torch, rng, B, 12, 12, F, 64, [F] * B,
                                     dt, split=True))
            if dt == "bfloat16" and B == 4:
                main["decode"] = rows[-1]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"whisper's attention shapes disagree with the "
                             f"plain versions: {bad}")
    return main


def o1_attention(tree):
    """Every ``wq`` / ``wk`` leaf (..., d, H, hd) rescaled from the
    init's fan-in over the heads (std 1/sqrt(H)) to a fan-in over d
    (1/sqrt(d)): attention scores O(1), as a trained model's.  At the
    init's scale whisper's scores reach the hundreds, and an fp32
    softmax over 1500 frames turns ill-conditioned."""
    import math
    from repro_torch.params import tree_map_with_path

    def scale(path, x):
        if path[-1] in ("wq", "wk"):
            return x * math.sqrt(x.shape[-2] / x.shape[-3])
        return x
    return tree_map_with_path(scale, tree)


def serve_recurrent_tiers(torch, pool, counts, batches):
    """Request batches at every tier of a pool of dense engines that
    admit prompts through the decode step, then ``measure()``."""
    outs = {t: [pool.dispatch(t, b, steps=LM_STEPS) for b in bs]
            for t, bs in batches.items()}
    measured = pool.measure(**HYBRID_MEASURE)
    torch.cuda.synchronize()
    calls = {c: sum(v[c] for v in counts.values())
             for c in ("admit", "decode", "prompt_tokens")}
    return outs, measured, calls


def phase_xlstm(torch):
    """xlstm-125m at full width in bf16, weights drawn on the card from a
    seed: (a) forward and loss on a (2, 256) batch, (b) the three dense
    tiers of ``lm_tiers()`` (its default arch) serving request batches of
    16-token prompts, each admitted token by token through the decode
    step, and ``measure()``.  The JAX package has no kernel for xLSTM,
    so neither path launches one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.routing import LatencyModel
    from repro_torch.serving import ReplicaPool, lm_tiers

    cfg = get_config(XLSTM_ARCH)
    m = cfg.model
    api = make_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(flatten_with_path(params))
    n_params = sum(x.numel() for x in leaves.values())
    specs = lm_tiers()
    pool = ReplicaPool(full_width_tiers(specs), shared_params=params,
                       device=DEVICE)
    counts = {t: {"admit": 0, "decode": 0, "prompt_tokens": 0}
              for t in pool.tiers}
    for tier in pool.tiers:
        count_calls(pool.engine(tier), counts[tier])
    rng = np.random.default_rng(SEED + 12)
    toks, labels = (torch.as_tensor(rng.integers(0, m.vocab_size,
                                                 XLSTM_BATCH), device=DEVICE)
                    for _ in range(2))
    batches = {t: [rng.integers(0, m.vocab_size,
                                (pool.specs[t].batch_size, HYBRID_PROMPT))
                   for _ in range(LM_BATCHES_PER_TIER)] for t in pool.tiers}

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = api.forward(params, {"tokens": toks})
        loss = api.loss(params, {"tokens": toks, "labels": labels})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs, measured, calls = serve_recurrent_tiers(torch, pool, counts,
                                                  batches)
    serving_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    lat = LatencyModel.from_measurements(measured, decode_tokens=LM_STEPS)
    all_out = [o for os_ in outs.values() for o in os_]
    fp32_leaves = {k[-1] for k, x in leaves.items()
                   if x.dtype == torch.float32}
    checks = {
        "default_lm_tiers": {s.arch for s in specs} == {XLSTM_ARCH},
        "full_width": (m.d_model == 768 and m.num_layers == 12
                       and m.xlstm.slstm_layers == (3, 9)
                       and all(tuple(leaves[k].shape) == v
                               for k, v in FULL_WIDTH[XLSTM_ARCH].items())
                       and params["embed"]["table"].dtype == torch.bfloat16
                       and fp32_leaves == {"w_i", "w_f", "b_i", "b_f",
                                           "b_z", "b_o"}
                       and n_params == XLSTM_PARAMS),
        "forward_finite": bool(logits.isfinite().all()
                               and loss.isfinite().all()),
        "forward_shape": (tuple(logits.shape) == XLSTM_BATCH
                          + (m.padded_vocab,)
                          and logits.dtype == torch.bfloat16
                          and float(aux) == 0.0),
        "shapes": all(tuple(o.shape) == (pool.specs[t].batch_size, LM_STEPS)
                      for t, os_ in outs.items() for o in os_),
        # greedy ids range over the padded vocabulary (50,432 rows, of
        # which 50,304 are the tokenizer's), as in the JAX engine
        "token_ids": all(bool(((o >= 0) & (o < m.padded_vocab)).all())
                         for o in all_out),
        "admitted_token_by_token": calls["prompt_tokens"] == HYBRID_PROMPT
        * calls["admit"] and calls["admit"] > 0,
        "latency_model": all(np.isfinite(lat.infer_ms(t))
                             and lat.infer_ms(t) > 0 for t in pool.tiers),
        # the JAX package has no Pallas kernel for xLSTM: no launch
        "no_kernel": set(launches.values()) == {0},
    }
    emit({"phase": "xlstm_slice", "arch": XLSTM_ARCH, "params": n_params,
          "config_param_count": m.param_count(), "layers": m.num_layers,
          "d_model": m.d_model, "init_seconds": init_s,
          "forward_seconds": forward_s, "serving_seconds": serving_s,
          "loss": float(loss), "engine_calls": counts, "launches": launches,
          "measured": {t: dataclasses.asdict(mm)
                       for t, mm in measured.items()},
          "calibrated_infer_ms": {t: lat.infer_ms(t) for t in pool.tiers},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"xlstm_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, pool, batches


def phase_recurrent_profile(torch, phase, pool, batches, forward=None):
    """One decode step per dense tier with every row admitted (8-token
    prompts), and, given, one call of ``forward``: device ms by kernel
    and idle share."""
    short = {t: [b[:, :HYBRID_PROFILE_PROMPT] for b in bs]
             for t, bs in batches.items()}
    out = {"phase": phase, "per_decode_step": profile_decode_steps(
        torch, {"dense": pool}, short)}
    if forward is not None:
        forward()
        out["forward"] = profile_once(torch, forward)
    emit(out)


def expected_whisper_launches(m, frames, forwards, decode_rows, serving):
    """Per encoding one non-causal flash a layer over the frames; per
    forward the encoding's and, a decoder layer, one causal flash over
    its WHISPER_TOKENS and one cross flash from them to the frames, at
    batch 2; each flash call that ``flash_splits`` splits merges too.
    Per decode step (the recurrent prefill's too) one
    ``decode_attention`` a decoder layer for the self ring and one for
    the cross rows."""
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_splits
    F = m.frontend.num_positions
    BH, D = 2 * m.attention.num_heads, m.attention.head_dim

    def split(T, Tk, causal):
        return flash_splits(BH, BH, T, Tk, causal, 0, D, D, fr.sms(0)) > 1

    zero = {k: 0 for k in ops.launch_counts()}
    encodings = m.encoder_layers * (frames + forwards)
    return {**zero,
            "flash_attention": encodings + 2 * m.num_layers * forwards,
            "flash_attention_merge": (
                encodings * split(F, F, False)
                + m.num_layers * forwards
                * (split(WHISPER_TOKENS, WHISPER_TOKENS, True)
                   + split(WHISPER_TOKENS, F, False))),
            "decode_attention": 2 * m.num_layers * (decode_rows + serving)}


def phase_whisper(torch):
    """whisper-small at full width in bf16, weights drawn on the card from
    a seed: ``encode`` of (2, 1500, 768) frames, the forward and loss on
    64 tokens, ``prime_cross_cache`` and 8 greedy decode steps over the
    primed cross rows, then one dense tier answering request batches as
    the JAX engine serves whisper (prompts through the decode step,
    against the zero cross rows of a fresh cache).  Launches are counted
    from 0 before and read after each part."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.serving import ReplicaPool, lm_tiers

    cfg = get_config(WHISPER_ARCH)
    m = cfg.model
    api = make_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict(flatten_with_path(params))
    n_params = sum(x.numel() for x in leaves.values())
    spec = [s for s in lm_tiers(WHISPER_ARCH) if s.tier == WHISPER_TIER]
    pool = ReplicaPool(full_width_tiers(spec), shared_params=params,
                       device=DEVICE)
    counts = {WHISPER_TIER: {"admit": 0, "decode": 0, "prompt_tokens": 0}}
    count_calls(pool.engine(WHISPER_TIER), counts[WHISPER_TIER])
    rng = np.random.default_rng(SEED + 14)
    F = m.frontend.num_positions
    frames = _randn(torch, rng, (2, F, m.d_model), torch.bfloat16)
    toks, labels = (torch.as_tensor(rng.integers(
        0, m.vocab_size, (2, WHISPER_TOKENS)), device=DEVICE)
        for _ in range(2))
    batches = {WHISPER_TIER: [rng.integers(
        0, m.vocab_size, (pool.specs[WHISPER_TIER].batch_size,
                          HYBRID_PROMPT)) for _ in range(LM_BATCHES_PER_TIER)]}
    batch = {"tokens": toks, "labels": labels, "frames": frames}

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = encdec.encode(params, m, frames)
        logits, aux = api.forward(params, batch)
        loss = api.loss(params, batch)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        after_forward = ops.launch_counts()
        cache = encdec.prime_cross_cache(params, m, api.init_cache(
            2, WHISPER_STEPS + 1, device=DEVICE), enc)
        tok, steps = toks[:, :1], []
        for t in range(WHISPER_STEPS):
            lg, cache = api.decode_step(params, tok,
                                        torch.full((2,), t, device=DEVICE),
                                        cache)
            steps.append(lg[:, -1])
            tok = torch.argmax(lg[:, -1], -1)[:, None]
    torch.cuda.synchronize()
    after_decode = ops.launch_counts()
    t0 = time.perf_counter()
    outs, measured, calls = serve_recurrent_tiers(torch, pool, counts,
                                                  batches)
    serving_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    serving = {k: launches[k] - after_decode[k] for k in launches}
    decoding = {k: after_decode[k] - after_forward[k] for k in launches}
    want_forward = expected_whisper_launches(m, 1, 2, 0, 0)
    want_decode = expected_whisper_launches(m, 0, 0, WHISPER_STEPS, 0)
    want_serving = expected_whisper_launches(
        m, 0, 0, 0, calls["prompt_tokens"] + calls["decode"])
    step_logits = torch.stack(steps, 1)
    checks = {
        "full_width": (m.d_model == 768 and m.num_layers == 12
                       and m.encoder_layers == 12 and F == 1500
                       and all(tuple(leaves[k].shape) == v
                               for k, v in FULL_WIDTH[WHISPER_ARCH].items())
                       and params["embed"]["table"].dtype == torch.bfloat16
                       and n_params == WHISPER_PARAMS),
        "encoder_shape": (tuple(enc.shape) == (2, F, m.d_model)
                          and bool(enc.isfinite().all())),
        "forward_finite": bool(logits.isfinite().all()
                               and loss.isfinite().all()),
        "forward_shape": (tuple(logits.shape) == (2, WHISPER_TOKENS,
                                                  m.padded_vocab)
                          and float(aux) == 0.0),
        "primed_decode_finite": bool(step_logits.isfinite().all()),
        "shapes": all(tuple(o.shape) == (pool.specs[t].batch_size, LM_STEPS)
                      for t, os_ in outs.items() for o in os_),
        "token_ids": all(bool(((o >= 0) & (o < m.padded_vocab)).all())
                         for os_ in outs.values() for o in os_),
        # the cross attention (64 tokens to 1500 frames) splits its
        # walks, the encodings (one, and the forward's and the loss's)
        # fill the card unsplit: one merge a decoder layer a pass
        "forward_launches": after_forward == want_forward
        and after_forward["flash_attention_merge"]
        == 2 * m.num_layers > 0,
        "decode_launches": decoding == want_decode,
        "serving_launches": serving == want_serving
        and serving["decode_attention"] > 0,
    }
    emit({"phase": "whisper_slice", "arch": WHISPER_ARCH, "params": n_params,
          "config_param_count": m.param_count(), "layers": m.num_layers,
          "encoder_layers": m.encoder_layers, "d_model": m.d_model,
          "frames": F, "init_seconds": init_s, "forward_seconds": forward_s,
          "serving_seconds": serving_s, "loss": float(loss),
          "engine_calls": counts, "launches": launches,
          "forward_launches": after_forward,
          "expected_forward_launches": want_forward,
          "decode_launches": decoding, "expected_decode_launches": want_decode,
          "serving_launches": serving,
          "expected_serving_launches": want_serving,
          "measured": {t: dataclasses.asdict(mm)
                       for t, mm in measured.items()},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"whisper_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")

    def forward():
        with torch.no_grad():
            api.forward(params, batch)
    return launches, pool, batches, forward


def phase_recurrent_parity(torch, arch, phase, **cut):
    """``arch`` at full width cut by ``cut`` (its depth), fp32, weights
    from a CPU seed with O(1) attention scores (:func:`o1_attention`):
    the forward, and the dense engine's greedy run of two 16-token
    prompts, on the card (kernels) and on the CPU (plain versions): the
    forward's logits and those of every decode step (the prompts' too,
    which the engine feeds through the decode step), and the tokens.
    whisper also holds 8 decode steps over cross rows primed from the
    encoder on both."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, make_model
    from repro_torch.params import from_numpy_tree, to_numpy_tree
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch)
    m = dataclasses.replace(cfg.model, **cut, dtype="float32",
                            param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    api = make_model(pcfg)
    tree = to_numpy_tree(o1_attention(api.init_params(
        torch.Generator().manual_seed(SEED), "cpu")))
    rng = np.random.default_rng(SEED + 13)
    batch = {"tokens": rng.integers(0, m.vocab_size, (2, HYBRID_PROMPT))}
    audio = m.family == "audio"
    if audio:
        batch["frames"] = rng.normal(size=(2, m.frontend.num_positions,
                                           m.d_model)).astype(np.float32)
    prompts = rng.integers(0, m.vocab_size, (2, HYBRID_PROMPT))
    logits, tokens, steps, primed, launches = {}, {}, {}, {}, {}
    with torch.no_grad():
        for dev in (DEVICE, "cpu"):
            ops.reset_launches()
            params = from_numpy_tree(tree, dev)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            logits[dev] = api.forward(params, b)[0].float().cpu()
            eng = ServeEngine(pcfg, params, batch_size=2, max_len=64,
                              device=dev)
            sink = steps[dev] = []
            record_decode_logits(eng, sink)
            tokens[dev] = eng.generate(prompts, LM_STEPS).cpu()
            if audio:
                cache = encdec.prime_cross_cache(
                    params, m, api.init_cache(2, 16, device=dev),
                    encdec.encode(params, m, b["frames"]))
                primed[dev] = []
                for t in range(WHISPER_STEPS):
                    lg, cache = api.decode_step(
                        params, b["tokens"][:, t:t + 1],
                        torch.full((2,), t, device=dev), cache)
                    primed[dev].append(lg[:, -1].float().cpu())
            launches[dev] = ops.launch_counts()
            del params, eng
    err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
    step_err = max((a - c).abs().max().item()
                   for a, c in zip(steps[DEVICE], steps["cpu"]))
    checks = {"forward_logits_match_cpu": err <= PARITY_LOGIT_TOL,
              "decode_logits_match_cpu": (
                  len(steps[DEVICE]) == len(steps["cpu"])
                  == 2 * HYBRID_PROMPT + LM_STEPS - 1
                  and step_err <= PARITY_LOGIT_TOL),
              "tokens_match_cpu": torch.equal(tokens[DEVICE],
                                              tokens["cpu"]),
              "cpu_launches_none": set(launches["cpu"].values()) == {0}}
    row = {}
    if audio:
        row["primed_decode_max_abs_err"] = max(
            (a - c).abs().max().item()
            for a, c in zip(primed[DEVICE], primed["cpu"]))
        checks["primed_decode_match_cpu"] = \
            row["primed_decode_max_abs_err"] <= PARITY_LOGIT_TOL
        checks["card_ran_the_kernels"] = (
            launches[DEVICE]["flash_attention"] > 0
            and launches[DEVICE]["decode_attention"] > 0)
    emit({"phase": phase, "arch": arch, "layers": m.num_layers,
          "encoder_layers": m.encoder_layers, "d_model": m.d_model,
          "dtype": m.dtype, "forward_logits_max_abs_err": err,
          "decode_logits_max_abs_err": step_err,
          "decode_steps": len(steps[DEVICE]), "tol": PARITY_LOGIT_TOL,
          "card_launches": launches[DEVICE], **row,
          "tokens": {d: v.tolist() for d, v in tokens.items()},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def phase_vlm(torch):
    """internvl2-76b's language model behind the stub's patch prefix, at
    ``.reduced()`` size (80 layers of d 8192 do not fit one card), fp32,
    weights from a CPU seed with O(1) attention scores: the forward and
    loss with 16 patch embeddings, and a dense and a paged engine's
    greedy run of two 12-token prompts, on the card and on the CPU:
    logits of the forward and of every decode step, the loss and the
    tokens.  Launches of the card's run are counted from 0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import from_numpy_tree, to_numpy_tree
    from repro_torch.serving import PagedServeEngine, ServeEngine

    cfg = get_config(VLM_ARCH).reduced()
    m = dataclasses.replace(cfg.model, dtype="float32", param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    api = make_model(pcfg)
    tree = to_numpy_tree(o1_attention(api.init_params(
        torch.Generator().manual_seed(SEED), "cpu")))
    rng = np.random.default_rng(SEED + 16)
    P = m.frontend.num_positions
    labels = rng.integers(0, m.vocab_size, (2, 16))
    batch = {"tokens": rng.integers(0, m.vocab_size, (2, 16)),
             "labels": labels,
             "patches": rng.normal(size=(2, P, m.d_model)).astype(
                 np.float32)}
    prompts = rng.integers(0, m.vocab_size, (2, 12))
    out = {}
    with torch.no_grad():
        for dev in (DEVICE, "cpu"):
            ops.reset_launches()
            params = from_numpy_tree(tree, dev)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            row = {"logits": api.forward(params, b)[0].float().cpu(),
                   "loss": float(api.loss(params, b))}
            for name, eng in (
                    ("dense", ServeEngine(pcfg, params, batch_size=2,
                                          max_len=64, device=dev)),
                    ("paged", PagedServeEngine(pcfg, params, max_seqs=2,
                                               max_len=64, device=dev))):
                sink = row[f"{name}_steps"] = []
                record_decode_logits(eng, sink)
                row[f"{name}_tokens"] = eng.generate(prompts, LM_STEPS).cpu()
            row["launches"] = ops.launch_counts()
            out[dev] = row
    card, cpu = out[DEVICE], out["cpu"]
    err = (card["logits"] - cpu["logits"]).abs().max().item()
    step_err = {name: max((a - c).abs().max().item() for a, c in zip(
        card[f"{name}_steps"], cpu[f"{name}_steps"]))
        for name in ("dense", "paged")}
    launches = card["launches"]
    checks = {
        "prefix_logits_shape": tuple(card["logits"].shape) == (
            2, P + 16, m.padded_vocab),
        "forward_logits_match_cpu": err <= PARITY_LOGIT_TOL,
        "loss_matches_cpu": abs(card["loss"] - cpu["loss"])
        <= PARITY_LOGIT_TOL,
        "decode_logits_match_cpu": all(
            len(card[f"{n}_steps"]) == LM_STEPS - 1
            and step_err[n] <= PARITY_LOGIT_TOL for n in step_err),
        "tokens_match_cpu": all(torch.equal(card[f"{n}_tokens"],
                                            cpu[f"{n}_tokens"])
                                for n in step_err),
        "launches": all(launches[k] > 0 for k in (
            "flash_attention", "decode_attention",
            "paged_decode_attention")),
    }
    emit({"phase": "vlm_slice", "arch": f"{VLM_ARCH} (reduced)",
          "layers": m.num_layers, "d_model": m.d_model, "patches": P,
          "dtype": m.dtype, "forward_logits_max_abs_err": err,
          "loss": {"card": card["loss"], "cpu": cpu["loss"]},
          "decode_logits_max_abs_err": step_err, "tol": PARITY_LOGIT_TOL,
          "launches": launches, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"vlm_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


def stacked_lm_batch(torch, streams, device):
    """One TokenStream batch a cluster, stacked on a leading axis."""
    batches = [s.next_batch() for s in streams]
    return {k: torch.as_tensor(np.stack([b[k] for b in batches]),
                               device=device) for k in batches[0]}


def replicas_identical(torch, stacked) -> bool:
    from repro_torch.params import flatten_with_path
    return all(torch.equal(x[0], x[c]) for _, x in flatten_with_path(stacked)
               for c in range(1, x.shape[0]))


def expected_train_launches(m, batch, steps, microbatches, sync_groups,
                            remat):
    """Kernel launches of ``steps`` cluster steps on ``batch`` (B, T)
    tokens (each a forward at ``microbatches`` slices of B / microbatches
    rows: one flash a layer, merged too where ``flash_splits`` splits
    it, one router a MoE layer; the backward is the plain versions') and
    of the syncs: one ``fedavg_reduce`` a dtype group of a plain sync,
    one an int8 sync.  With ``remat`` other than "none" every layer of
    the stack (all but the ``lead`` dense layers) is checkpointed, and
    the backward runs its forward again: its flash and its router launch
    twice."""
    forwards = steps * microbatches
    lead = m.moe.first_dense_layers if m.moe else 0
    moe_layers = m.num_layers - lead if m.moe else 0
    again = 0 if remat == "none" else 1
    split = flash_split_layers(m, batch[0] // microbatches, batch[1])
    want = {k: 0 for k in ("gru_seq", "fedavg_reduce", "flash_attention",
                           "decode_attention", "decode_attention_partial",
                           "paged_decode_attention",
                           "paged_mla_decode_attention", "topk_router",
                           "mamba_chunk_scan")}
    want["flash_attention"] = (m.num_layers
                               + again * (m.num_layers - lead)) * forwards
    want["flash_attention_merge"] = (sum(split)
                                     + again * sum(split[lead:])) * forwards
    want["topk_router"] = (1 + again) * moe_layers * forwards
    want["fedavg_reduce"] = sync_groups
    return want


def phase_train(torch):
    """The LM training layer's main path: hierarchical-FL training of
    gemma3-1b at its published width in bf16 (random weights drawn on
    the card from a seed) through the entry points a user calls.  Two
    clusters, each a replica and a TokenStream shard (batch 4 of 64
    tokens), AdamW (lr 1e-3, fp32 moments); 4 local rounds with a global
    round every 2: first ``hfl_global_round`` (bf16, through
    ``fedavg_reduce``), then ``compressed_global_sync`` (int8 deltas
    with error feedback since the first sync; their fp32 mean through
    ``fedavg_reduce``).  Every forward's attention is ``flash_attention``
    (D 256), its backward the plain version's; the config's
    ``remat="layer"`` checkpoints each layer, so the backward launches
    each layer's flash again.  Then one profiled local
    round, and ``fedavg_reduce`` and ``flash_attention`` held against
    their plain versions at the path's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.fl.collectives import (cluster_divergence,
                                            dtype_groups, stack_for_clusters)
    from repro_torch.fl.compression import (compressed_global_sync,
                                            init_ef_state, sync_bytes)
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.training import (AdamW, hfl_global_round,
                                      init_hfl_opt_state,
                                      make_hfl_train_step)

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    m = cfg.model
    api = make_model(cfg)
    C = TRAIN_CLUSTERS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                             DEVICE)
    leaves = dict(flatten_with_path(params))
    n_params = param_count(params)
    full_width = (all(tuple(leaves[k].shape) == v
                      for k, v in FULL_WIDTH[TRAIN_ARCH].items())
                  and {x.dtype for x in leaves.values()} == {torch.bfloat16}
                  and n_params == m.param_count() + norm_params(m))
    stacked = stack_for_clusters(params, C)
    del params, leaves
    opt = AdamW(lr=TRAIN_LR, state_dtype=cfg.run.opt_state_dtype)
    opt_state = init_hfl_opt_state(opt, stacked)
    local = make_hfl_train_step(api, cfg, opt)
    streams = [TokenStream(TokenStreamConfig(
        vocab_size=m.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH),
        shard=c) for c in range(C)]
    groups = len(dtype_groups([x for _, x in flatten_with_path(stacked)]))
    torch.cuda.synchronize()

    ops.reset_launches()
    losses, round_ms, syncs, ef = [], [], [], None
    for t in range(TRAIN_ROUNDS):
        batch = stacked_lm_batch(torch, streams, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked, opt_state, loss = local(stacked, opt_state, batch)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.tolist())
        if (t + 1) % TRAIN_GLOBAL_EVERY == 0:
            compressed = ef is not None
            div = float(cluster_divergence(stacked))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if compressed:
                stacked, ef = compressed_global_sync(stacked, ef)
            else:
                stacked = hfl_global_round(stacked)
            torch.cuda.synchronize()
            syncs.append({"kind": "int8" if compressed else "plain",
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "divergence_before": div,
                          "sync_bytes": sync_bytes(stacked, compressed),
                          "replicas_identical": replicas_identical(
                              torch, stacked)})
            if not compressed:      # the anchor: params at the last sync
                ef = init_ef_state(stacked)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    want = expected_train_launches(m, (TRAIN_BATCH, TRAIN_SEQ),
                                   C * TRAIN_ROUNDS,
                                   cfg.run.microbatches, groups + 1,
                                   cfg.run.remat)

    # more syncs of each kind and one more local round (their launches
    # are not the path's): the kernel's device time inside the real syncs,
    # beside the rows below, and a profile of each sync
    syncs_again = {"plain": lambda: hfl_global_round(stacked),
                   "int8": lambda: compressed_global_sync(stacked, ef)}
    fed_in_sync = {k: launch_event_ms(torch, fn, "fedavg_reduce_")
                   for k, fn in syncs_again.items()}
    sync_profiles = {k: profile_once(torch, fn, top=None)
                     for k, fn in syncs_again.items()}
    batch = stacked_lm_batch(torch, streams, DEVICE)
    step_profile = profile_once(
        torch, lambda: local(stacked, opt_state, batch), top=8)
    del stacked, opt_state, ef, batch
    torch.cuda.empty_cache()

    # the kernel over 20 timed calls, as a graph of 5 and eager: on an
    # H100 a graph of 5 once read 1.88 ms in bf16 here, against 1.63-1.65
    # eager or over 20 calls
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    fed_rows = [check_fedavg_reduce(torch, gen, C, n_params, name, (20, 2),
                                    more_readings=True)
                for name in ("bfloat16", "float32")]
    rng = np.random.default_rng(SEED + 21)
    B, H, Hkv = TRAIN_BATCH, m.attention.num_heads, m.attention.num_kv_heads
    flash_rows = [check_flash(torch, rng, B * H, B * Hkv, TRAIN_SEQ,
                              m.attention.head_dim, w, "bfloat16",
                              split=False)
                  for w in (m.attention.window, 0)]
    flat_losses = [x for row in losses for x in row]
    checks = {
        "full_width": full_width,
        "losses_finite": bool(np.isfinite(flat_losses).all())
        and len(flat_losses) == C * TRAIN_ROUNDS,
        "launches": launches == want,
        "syncs": [s["kind"] for s in syncs] == ["plain", "int8"],
        "replicas_identical_after_each_sync": all(
            s["replicas_identical"] for s in syncs),
        "fedavg_reduce_matches_plain": all(r["ok"] for r in fed_rows),
        "flash_attention_matches_plain": all(r["ok"] for r in flash_rows),
    }
    emit({"phase": "train_slice", "seconds": time.perf_counter() - t_phase,
          "arch": TRAIN_ARCH, "layers": m.num_layers, "d_model": m.d_model,
          "params": n_params, "dtype": m.param_dtype, "clusters": C,
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "rounds": TRAIN_ROUNDS,
          "global_every": TRAIN_GLOBAL_EVERY, "lr": TRAIN_LR,
          "opt_state_dtype": cfg.run.opt_state_dtype,
          "losses": losses, "round_ms": round_ms, "syncs": syncs,
          "peak_memory_bytes": peak_bytes,
          "local_round_profile": step_profile,
          "sync_profiles": sync_profiles,
          "fedavg_reduce_in_sync_ms": fed_in_sync,
          "launches": launches, "expected_launches": want,
          "fedavg_reduce_shapes": [r["shape"] for r in fed_rows],
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"train_slice checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, fed_rows, flash_rows[0], losses, step_profile


def phase_remat(torch, smi):
    """``RunConfig.remat`` on the card: ``value_and_grad(api.loss)`` of
    gemma3-1b at full width (bf16, random weights drawn on the card from
    the seed) on one (1, 4096) token batch, once with ``remat="none"``
    and once with the config's ``"layer"``, twice each in turns.  The
    losses and every gradient must be equal (bit for bit: every kernel
    and GEMM is deterministic at fixed shapes; a leaf that is not is
    held to train_parity's update rule at lr 1), the checkpointed run's
    activation memory (the peak allocated during the pass less what was
    allocated before it) must be below the other's, and ``flash_attention``
    must launch once a layer without a checkpoint and twice with one
    (the backward runs each layer's forward again)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.training.train_step import value_and_grad

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    m = cfg.model
    params = make_model(cfg).init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    rng = np.random.default_rng(SEED + 30)
    B, T = REMAT_BATCH
    batch = {k: torch.as_tensor(rng.integers(0, m.vocab_size, (B, T)),
                                device=DEVICE) for k in ("tokens", "labels")}
    apis = {r: make_model(dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, remat=r)))
        for r in ("none", "layer")}
    runs = {r: {"ms": [], "wall_ms": [], "activation_bytes": []}
            for r in apis}
    grads = {}
    for remat in ("none", "layer", "none", "layer"):
        grads.pop(remat, None)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        ops.reset_launches()
        t0 = time.perf_counter()
        start.record()
        loss, g = value_and_grad(apis[remat].loss, params, batch)
        end.record()
        torch.cuda.synchronize()
        run = runs[remat]
        run["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        run["ms"].append(start.elapsed_time(end))
        run["activation_bytes"].append(
            torch.cuda.max_memory_allocated() - before)
        run["launches"] = ops.launch_counts()
        run["loss"] = float(loss)
        run["loss_bits"] = loss
        grads[remat] = dict(flatten_with_path(g))
        del g
    gaps, equal, within = {}, True, True
    for path, a in grads["none"].items():
        b = grads["layer"][path]
        same = torch.equal(a, b)
        gap = 0.0 if same else float((a.float() - b.float()).abs().max())
        gaps["/".join(path)] = gap
        equal &= same
        within &= same or gap <= update_tol(1.0, a.float())
    flash = {r: runs[r]["launches"]["flash_attention"] for r in runs}
    merges = {r: runs[r]["launches"]["flash_attention_merge"] for r in runs}
    split = sum(flash_split_layers(m, B, T))
    act = {r: max(runs[r]["activation_bytes"]) for r in runs}
    others = {r: {k: v for k, v in runs[r]["launches"].items()
                  if k not in ("flash_attention", "flash_attention_merge")
                  and v} for r in runs}
    checks = {
        "losses_equal": torch.equal(runs["none"]["loss_bits"],
                                    runs["layer"]["loss_bits"])
        and bool(np.isfinite(runs["none"]["loss"])),
        "gradients_agree": within,
        "activation_memory_lower_with_remat": act["layer"] < act["none"],
        "flash_launches": flash == {"none": m.num_layers,
                                    "layer": 2 * m.num_layers},
        # merged where flash_splits splits a layer's call at (1, 4096)
        "flash_merges": merges == {"none": split, "layer": 2 * split},
        "no_other_kernel": others == {"none": {}, "layer": {}},
    }
    worst = max(gaps.items(), key=lambda kv: kv[1])
    launches = {k: runs["none"]["launches"][k] + runs["layer"]["launches"][k]
                for k in runs["none"]["launches"]}
    emit({"phase": "remat", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi, "arch": TRAIN_ARCH, "layers": m.num_layers,
          "dtype": m.param_dtype, "batch": [B, T],
          "loss": {r: runs[r]["loss"] for r in runs},
          "gradients_bit_equal": equal,
          "max_grad_gap": worst[1], "max_grad_gap_leaf": worst[0],
          "activation_bytes": {r: runs[r]["activation_bytes"]
                               for r in runs},
          "device_ms": {r: runs[r]["ms"] for r in runs},
          "wall_ms": {r: runs[r]["wall_ms"] for r in runs},
          "flash_attention_launches": flash, "flash_merges": merges,
          "layer_over_none_ms": (min(runs["layer"]["ms"])
                                 / min(runs["none"]["ms"])),
          "checks": checks})
    del grads, params
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"remat checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


def update_tol(lr, dw) -> float:
    """tests/test_torch_training.py's: 1e-3 of the larger of the step's
    learning rate and the leaf's largest update."""
    return TRAIN_UPDATE_TOL * max(lr, float(dw.abs().max()))


def phase_train_parity(torch):
    """gemma3-1b at its published width cut to 2 layers, fp32, numpy
    weights (``numpy_gemma_params``): 2 clusters of batch 2 x 64 tokens,
    2 local steps, then a plain and an int8 sync of the same replicas,
    on the card and on the CPU.  The CPU side holds about 15 GB of host
    memory: the stacked fp32 replicas, the error-feedback state, the int8
    sync's fp32 deltas and the 262,144-row tied embedding's gradients.
    SGD, whose update ``-lr * g`` shows every gradient (AdamW's first
    steps turn a gradient at the rounding floor into a whole step of
    either sign; tests/test_torch_training.py).  Losses within 3e-5
    relative; updates, the divergence and the plain sync within 1e-3 of
    the larger of lr and the leaf's largest update; the int8 sync and
    its residual within that plus one quantization step (the card's and
    the CPU's deltas may round to neighbouring int8 levels).  Then the
    reduced deepseek-v2-lite at ``microbatches = 2`` (its ``.reduced()``
    sets 1), fp32: one SGD step on both, the router in ``topk_router``
    on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.fl.collectives import (cluster_divergence, global_sync,
                                            stack_for_clusters)
    from repro_torch.fl.compression import (compressed_global_sync,
                                            init_ef_state)
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path, from_numpy_tree
    from repro_torch.training import (SGD, init_hfl_opt_state,
                                      make_hfl_train_step, make_train_step)

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    m = dataclasses.replace(cfg.model, num_layers=TRAIN_PARITY_LAYERS,
                            dtype="float32", param_dtype="float32")
    pcfg = dataclasses.replace(cfg, model=m)
    api = make_model(pcfg)
    tree = numpy_gemma_params(np.random.default_rng(SEED + 22), m)
    C, lr = TRAIN_CLUSTERS, TRAIN_PARITY_LR
    streams = [TokenStream(TokenStreamConfig(
        vocab_size=m.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_PARITY_BATCH, seed=1), shard=c) for c in range(C)]
    batches = [stacked_lm_batch(torch, streams, "cpu")
               for _ in range(TRAIN_PARITY_STEPS)]
    runs = {}
    for dev in (DEVICE, "cpu"):
        ops.reset_launches()
        stacked = stack_for_clusters(from_numpy_tree(tree, dev), C)
        ef = init_ef_state(stacked)
        opt = SGD(lr=lr)
        state = init_hfl_opt_state(opt, stacked)
        local = make_hfl_train_step(api, pcfg, opt)
        losses = []
        for b in batches:
            stacked, state, loss = local(
                stacked, state, {k: v.to(dev) for k, v in b.items()})
            losses.append(loss.cpu())
        run = {"losses": torch.stack(losses), "trained": stacked,
               "divergence": float(cluster_divergence(stacked)),
               "plain": global_sync(stacked)}
        run["int8"], ef = compressed_global_sync(stacked, ef)
        run["residual"] = ef.residual
        if dev == DEVICE:
            torch.cuda.synchronize()
            run["launches"] = ops.launch_counts()
        runs[dev] = run
        del stacked, state, ef
    card, cpu = runs[DEVICE], runs["cpu"]
    x0 = {p: torch.as_tensor(x) for p, x in flatten_with_path(tree)}
    keys = ("trained", "plain", "int8", "residual")
    card_leaves = {k: dict(flatten_with_path(card[k])) for k in keys}
    errs = {k: 0.0 for k in keys}
    largest_update = 0.0
    for p, w in flatten_with_path(cpu["trained"]):
        dw = w - x0[p]
        tol = update_tol(lr, dw)
        largest_update = max(largest_update, float(dw.abs().max()))
        # one int8 level of the leaf's largest cluster delta
        q_step = float(dw.abs().amax(dim=tuple(range(1, dw.dim()))).max()
                       ) / 127.0
        for key in keys:
            extra = q_step if key in ("int8", "residual") else 0.0
            want = dict(flatten_with_path(cpu[key]))[p]
            got = card_leaves[key][p].cpu()
            errs[key] = max(errs[key], float((got - want).abs().max())
                            / (tol + extra))
    loss_err = float(((card["losses"] - cpu["losses"]).abs()
                      / cpu["losses"].abs()).max())
    div_err = abs(card["divergence"] - cpu["divergence"]) / (
        TRAIN_UPDATE_TOL * max(lr, largest_update))
    launches = card["launches"]
    want = expected_train_launches(m, (TRAIN_PARITY_BATCH, TRAIN_SEQ),
                                   C * TRAIN_PARITY_STEPS, 1, 2,
                                   pcfg.run.remat)
    result = {"losses": {"card": card["losses"].tolist(),
                         "cpu": cpu["losses"].tolist()},
              "divergence": {"card": card["divergence"],
                             "cpu": cpu["divergence"]}}
    del runs, card, cpu, card_leaves

    # the reduced MoE at two microbatches: topk_router on the card
    mcfg = get_config(MOE_ARCH).reduced()
    mcfg = dataclasses.replace(
        mcfg, model=dataclasses.replace(mcfg.model, dtype="float32",
                                        param_dtype="float32"),
        run=dataclasses.replace(mcfg.run, microbatches=TRAIN_MOE_K))
    mapi = make_model(mcfg)
    mtree = mapi.init_params(torch.Generator().manual_seed(SEED), "cpu")
    mshape = (4, 32)
    mbatch = TokenStream(TokenStreamConfig(
        vocab_size=mcfg.model.vocab_size, seq_len=mshape[1],
        batch_size=mshape[0], seed=2)).next_batch()
    moe = {}
    for dev in (DEVICE, "cpu"):
        ops.reset_launches()
        params = from_numpy_tree(mtree, dev)
        opt = SGD(lr=lr)
        new, _, loss = make_train_step(mapi, mcfg, opt)(
            params, opt.init(params),
            {k: torch.as_tensor(v, device=dev) for k, v in mbatch.items()})
        moe[dev] = {"loss": float(loss), "new": dict(flatten_with_path(new)),
                    "launches": ops.launch_counts()}
    moe_err = max(
        float((moe[DEVICE]["new"][p].cpu() - moe["cpu"]["new"][p]
               ).abs().max()) / update_tol(lr, moe["cpu"]["new"][p] - x)
        for p, x in flatten_with_path(mtree))
    moe_loss_err = abs(moe[DEVICE]["loss"] - moe["cpu"]["loss"]) / abs(
        moe["cpu"]["loss"])
    moe_want = expected_train_launches(mcfg.model, mshape, 1, TRAIN_MOE_K,
                                       0, mcfg.run.remat)

    checks = {
        "losses_match_cpu": loss_err <= TRAIN_LOSS_RTOL,
        "updates_match_cpu": errs["trained"] <= 1.0,
        "divergence_matches_cpu": div_err <= 1.0,
        "plain_sync_matches_cpu": errs["plain"] <= 1.0,
        "int8_sync_matches_cpu": (errs["int8"] <= 1.0
                                  and errs["residual"] <= 1.0),
        "launches": launches == want,
        "moe_loss_matches_cpu": moe_loss_err <= TRAIN_LOSS_RTOL,
        "moe_updates_match_cpu": moe_err <= 1.0,
        "moe_launches": moe[DEVICE]["launches"] == moe_want,
    }
    emit({"phase": "train_parity", "seconds": time.perf_counter() - t_phase,
          "arch": TRAIN_ARCH, "layers": m.num_layers, "d_model": m.d_model,
          "dtype": m.dtype, "clusters": C,
          "batch": [TRAIN_PARITY_BATCH, TRAIN_SEQ],
          "steps": TRAIN_PARITY_STEPS, "lr": lr, **result,
          "loss_max_rel_err": loss_err,
          # errors in units of their tolerance (<= 1 holds)
          "update_err_over_tol": errs, "divergence_err_over_tol": div_err,
          "launches": launches, "expected_launches": want,
          "moe": {"arch": f"{MOE_ARCH} (reduced)", "microbatches":
                  TRAIN_MOE_K, "loss": {d: v["loss"] for d, v in moe.items()},
                  "loss_max_rel_err": moe_loss_err,
                  "update_err_over_tol": moe_err,
                  "launches": moe[DEVICE]["launches"],
                  "expected_launches": moe_want},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"train_parity checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")


def bit_sums(torch, tree):
    """Per leaf: the sum of its bits read as integers, and the same over
    every other element (a checksum of the exact bits), on the host."""
    from repro_torch.params import flatten_with_path
    out = []
    for _, x in flatten_with_path(tree):
        bits = x.reshape(-1).view(torch.int16 if x.element_size() == 2
                                  else torch.int32)
        out += [bits.sum(dtype=torch.int64), bits[1::2].sum(dtype=torch.int64)]
    return torch.stack(out).cpu()


def dist_rank(rank, results, conf):
    """One FL cluster of dist_slice, in a process of its own (module level:
    the spawned ranks import it).  Draws gemma3-1b on the card from the
    seed, keeps its cluster's replica with a leading dim of 1, and
    follows train_slice's schedule through the distributed entry points:
    ``make_hfl_local_step_shardmap(make_train_step(...))`` a round,
    ``global_sync_shardmap`` after round 2, ``compressed_global_sync_
    shardmap`` after round 4 (the anchor taken at the first sync), then
    ``compressed_global_sync_manual`` on the same inputs.  Launches and
    collective bytes are counted from 0 over that path; the checks run
    after it."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.fl.collectives import (collective_bytes, dtype_groups,
                                            global_sync_shardmap,
                                            make_hfl_local_step_shardmap,
                                            reset_collective_bytes,
                                            stack_for_clusters)
    from repro_torch.fl.compression import (compressed_global_sync_manual,
                                            compressed_global_sync_shardmap,
                                            init_ef_state, sync_bytes)
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_hfl_mesh
    from repro_torch.models import make_model
    from repro_torch.params import flatten_with_path
    from repro_torch.training import AdamW, init_hfl_opt_state, make_train_step

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the parent built the kernels: a rank loads that library
    prebuilt = (build.BUILD_ROOT / build.source_hash() / build.LIB_NAME
                ).exists()
    library = str(build.load()._name)
    mesh = make_hfl_mesh(DEVICE)
    group = mesh.get_group("cluster")
    world = dist.get_world_size(group)
    cfg = get_config(TRAIN_ARCH)
    m = cfg.model
    api = make_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                             DEVICE)
    leaves = dict(flatten_with_path(params))
    n_params = param_count(params)
    full_width = (all(tuple(leaves[k].shape) == v
                      for k, v in FULL_WIDTH[TRAIN_ARCH].items())
                  and {x.dtype for x in leaves.values()} == {torch.bfloat16}
                  and n_params == m.param_count() + norm_params(m))
    local = stack_for_clusters(params, 1)
    del params, leaves
    n_leaves = len(flatten_with_path(local))
    groups = len(dtype_groups([x for _, x in flatten_with_path(local)]))
    opt = AdamW(lr=TRAIN_LR, state_dtype=cfg.run.opt_state_dtype)
    opt_state = init_hfl_opt_state(opt, local)
    step = make_hfl_local_step_shardmap(make_train_step(api, cfg, opt), mesh)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=m.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH),
        shard=rank)
    want_bytes = {
        "plain": {"all_gather": {"cluster": sync_bytes(local, False)}},
        "int8": {"all_gather": {"cluster": sync_bytes(local, True)
                                + 4 * n_leaves}}}
    want_bytes["manual"] = {**want_bytes["int8"],
                            "all_reduce": {"data": 4 * n_leaves}}

    def identical_across_ranks(tree) -> bool:
        mine = bit_sums(torch, tree).to(DEVICE)   # NCCL takes CUDA tensors
        every = torch.empty((world,) + mine.shape, dtype=mine.dtype,
                            device=DEVICE)
        dist.all_gather(list(every.unbind(0)), mine, group=group)
        return bool((every == every[0]).all())

    # the wall time of the syncs' collectives (the card synchronised
    # around each), read beside the syncs' own
    in_collectives = []

    def clocked(call):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(*args, **kwargs)
            torch.cuda.synchronize()
            in_collectives.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def timed(fn):
        dist.barrier(group=group)
        torch.cuda.synchronize()
        reset_collective_bytes()
        in_collectives.clear()
        gather, reduce = dist.all_gather, dist.all_reduce
        dist.all_gather, dist.all_reduce = clocked(gather), clocked(reduce)
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            dist.all_gather, dist.all_reduce = gather, reduce
        return out, ms, collective_bytes()

    torch.cuda.synchronize()
    startup_s = time.time() - conf["spawned_at"]
    ops.reset_launches()
    losses, round_ms, round_bytes, syncs, ef = [], [], [], [], None
    for t in range(TRAIN_ROUNDS):
        batch = {k: torch.as_tensor(v[None], device=DEVICE)
                 for k, v in stream.next_batch().items()}
        (local, opt_state, loss), ms, nbytes = timed(
            lambda: step(local, opt_state, batch))
        round_ms.append(ms)
        round_bytes.append(nbytes)
        losses.append(float(loss[0]))
        del batch, loss
        if (t + 1) % TRAIN_GLOBAL_EVERY:
            continue
        if ef is None:
            local, ms, nbytes = timed(lambda: global_sync_shardmap(local, mesh))
            syncs.append({"kind": "plain", "ms": ms, "bytes": nbytes,
                          "collective_ms": list(in_collectives),
                          "replicas_identical": identical_across_ranks(local)})
            ef = init_ef_state(local)          # the anchor: this sync's
            continue
        if t + 1 == TRAIN_ROUNDS:               # no local round follows
            del opt_state
            torch.cuda.empty_cache()
        before, ef_before = local, ef
        (local, ef), ms, nbytes = timed(
            lambda: compressed_global_sync_shardmap(before, ef_before, mesh))
        syncs.append({"kind": "int8", "ms": ms, "bytes": nbytes,
                      "collective_ms": list(in_collectives),
                      "replicas_identical": identical_across_ranks(local)})
        (man, man_ef), ms, nbytes = timed(
            lambda: compressed_global_sync_manual(before, ef_before, mesh))
        syncs.append({"kind": "manual", "ms": ms, "bytes": nbytes,
                      "collective_ms": list(in_collectives),
                      "replicas_identical": identical_across_ranks(man),
                      "equals_shardmap": all(
                          torch.equal(a, b) for tree_a, tree_b in
                          ((man, local), (man_ef.anchor, ef.anchor),
                           (man_ef.residual, ef.residual))
                          for (_, a), (_, b) in zip(
                              flatten_with_path(tree_a),
                              flatten_with_path(tree_b)))})
        del man, man_ef
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()

    # the int8 sync against the plain fp32 mean of the same replicas: within
    # one quantization step (a leaf's largest cluster scale) of it
    int8_err = 0.0
    with torch.no_grad():
        for (_, x), (_, a), (_, r), (_, new_a) in zip(
                flatten_with_path(before), flatten_with_path(ef_before.anchor),
                flatten_with_path(ef_before.residual),
                flatten_with_path(ef.anchor)):
            both = torch.empty((world,) + tuple(x.shape), dtype=x.dtype,
                               device=x.device)
            dist.all_gather(list(both.unbind(0)), x, group=group)
            mean = both.float().mean(dim=0)
            scale = ((x.float() - a + r).abs().max() / 127.0).reshape(1)
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            int8_err = max(int8_err, float((new_a - mean).abs().max()
                                           / scale))
            del both, mean
    return {"rank": rank, "device": torch.cuda.current_device(),
            "device_name": torch.cuda.get_device_name(), "mesh": str(mesh),
            "backend": dist.get_backend(group), "prebuilt": prebuilt,
            "library": library, "full_width": full_width,
            "params": n_params, "leaves": n_leaves, "groups": groups,
            "losses": losses, "round_ms": round_ms,
            "round_bytes": round_bytes, "syncs": syncs,
            "expected_sync_bytes": want_bytes,
            "int8_err_over_step": int8_err, "launches": launches,
            "peak_memory_bytes": peak_bytes, "startup_s": startup_s,
            "rank_seconds": time.perf_counter() - t_start}


def phase_dist(torch, train_losses, backend=DIST_BACKEND,
               devices=f"{DEVICE}:0", phase="dist_slice"):
    """The distributed HFL layer's main path: train_slice's run with one
    FL cluster a process (``dist_rank``), 2 ranks on the one card over
    gloo (or as ``devices`` and ``backend`` say: None is one card a
    rank), started by ``run_ranks`` (spawn, a ``FileStore``).  Every
    forward's attention is ``flash_attention`` (D 256) and every sync's
    mean ``fedavg_reduce``.  Holds each rank against train_slice's
    cluster (round-1 losses within 3e-5 relative: same parameters, same
    data), the replicas bit-identical across ranks after each sync, the
    manual int8 sync equal to the shard_map one bit for bit, the int8
    sync within one quantization step of the plain mean, exact launches
    and the bytes each collective was handed.  Any failed rank fails the
    phase."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    held_bytes = torch.cuda.memory_allocated()
    # what of that the parent can still reach from Python (the rest is
    # the libraries' own: cuBLAS workspaces, graph pools)
    reachable = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            storage = obj.untyped_storage()
            reachable[storage.data_ptr()] = storage.nbytes()
    ranks = run_ranks(dist_rank, DIST_RANKS, backend=backend,
                      device=devices, timeout=DIST_TIMEOUT,
                      args=({"spawned_at": time.time()},))
    cfg = get_config(TRAIN_ARCH)
    # a plain sync's launches a dtype group, one an int8 sync, one manual
    want = expected_train_launches(cfg.model, (TRAIN_BATCH, TRAIN_SEQ),
                                   TRAIN_ROUNDS,
                                   cfg.run.microbatches,
                                   ranks[0]["groups"] + 2, cfg.run.remat)
    gaps = [[abs(r["losses"][t] - train_losses[t][c]) / abs(
        train_losses[t][c]) for t in range(TRAIN_ROUNDS)]
        for c, r in enumerate(ranks)]
    kinds = ["plain", "int8", "manual"]
    checks = {
        "full_width": all(r["full_width"] for r in ranks),
        "devices": [r["device"] for r in ranks] == (
            [0] * DIST_RANKS if devices else list(range(DIST_RANKS))),
        "kernels_loaded_not_rebuilt": all(r["prebuilt"] for r in ranks),
        "round1_losses_match_train_slice": all(
            g[0] <= TRAIN_LOSS_RTOL for g in gaps),
        "losses_finite": all(np.isfinite(r["losses"]).all()
                             and len(r["losses"]) == TRAIN_ROUNDS
                             for r in ranks),
        "syncs": all([s["kind"] for s in r["syncs"]] == kinds
                     for r in ranks),
        "replicas_identical_after_each_sync": all(
            s["replicas_identical"] for r in ranks for s in r["syncs"]),
        "manual_equals_shardmap": all(
            r["syncs"][2]["equals_shardmap"] for r in ranks),
        "int8_within_one_step_of_plain_mean": all(
            r["int8_err_over_step"] <= 1.0 for r in ranks),
        "launches": all(r["launches"] == want for r in ranks),
        "no_bytes_in_local_rounds": all(
            b == {} for r in ranks for b in r["round_bytes"]),
        "sync_bytes": all(s["bytes"] == r["expected_sync_bytes"][s["kind"]]
                          for r in ranks for s in r["syncs"]),
    }
    emit({"phase": phase, "seconds": time.perf_counter() - t_phase,
          "arch": TRAIN_ARCH, "ranks": DIST_RANKS, "backend": backend,
          "mesh": ranks[0]["mesh"],
          "params": ranks[0]["params"], "leaves": ranks[0]["leaves"],
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "rounds": TRAIN_ROUNDS,
          "global_every": TRAIN_GLOBAL_EVERY,
          "free_bytes_before_spawn": free_bytes,
          "total_bytes": total_bytes, "parent_held_bytes": held_bytes,
          "parent_reachable_cuda_tensors": {
              "storages": len(reachable), "bytes": sum(reachable.values())},
          # on the card under gloo: all_gather of bf16 rows (plain), of
          # int8 deltas and fp32 scales (int8), and all_reduce(MAX) of fp32
          # maxima (manual) on CUDA tensors; barriers and checksums on CPU
          "collectives": {k: sorted(v) for k, v in
                          ranks[0]["expected_sync_bytes"].items()},
          "loss_rel_gap_to_train_slice": gaps,
          "max_loss_rel_gap": max(max(g) for g in gaps),
          "tol": TRAIN_LOSS_RTOL,
          **{k: [r[k] for r in ranks] for k in (
              "losses", "round_ms", "syncs", "int8_err_over_step",
              "peak_memory_bytes", "startup_s", "rank_seconds",
              "launches")},
          "expected_launches": want, "library": ranks[0]["library"],
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {k: sum(r["launches"][k] for r in ranks) for k in want}


def dryrun_rank(rank, results):
    """sharded_step in a process of its own (a default group of one rank,
    module level: the spawned rank imports it): gemma3-1b drawn on the
    card from the seed, its parameters DTensors laid out by their logical
    axes under the production rules on a (data 1, model 1) CUDA mesh,
    train_slice's first batch of cluster 0; the loss through that
    layout (launches counted from 0 over it) and the unsharded port's
    loss on the same tensors, each timed with CUDA events."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import make_model
    from repro_torch.models.common import logical_sharding
    from repro_torch.params import flatten_with_path
    from repro_torch.training.train_step import value_and_grad

    prebuilt = (build.BUILD_ROOT / build.source_hash() / build.LIB_NAME
                ).exists()
    cfg = get_config(TRAIN_ARCH)
    m = cfg.model
    api = make_model(cfg)
    params, axes = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
        with_axes=True)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=m.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH),
        shard=0)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in stream.next_batch().items()}
    mesh = make_test_mesh(DEVICE, (1, 1), ("data", "model"))
    rules = sh.rules_for(cfg, mesh)
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    dbatch = sh.distribute_tree(batch, mesh,
                                sh.batch_shardings(batch, mesh, rules))

    def sharded():
        with logical_sharding(mesh, rules), implicit_replication():
            return api.loss(dparams, dbatch)

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    with torch.no_grad():
        ops.reset_launches()
        loss, sharded_ms = timed(sharded)
        launches = ops.launch_counts()
        plain, plain_ms = timed(lambda: api.loss(params, batch))
        _, sharded_again_ms = timed(sharded)

    # the same loss differentiated through the DTensors, each layer under
    # the config's checkpoint (remat="layer"), against the unsharded
    # port's gradients on the same tensors
    def sharded_grad():
        with logical_sharding(mesh, rules), implicit_replication():
            return value_and_grad(api.loss, dparams, dbatch)

    ops.reset_launches()
    (gloss, dgrads), grad_ms = timed(sharded_grad)
    grad_launches = ops.launch_counts()
    (ploss, pgrads), plain_grad_ms = timed(
        lambda: value_and_grad(api.loss, params, batch))
    pgrads = dict(flatten_with_path(pgrads))
    grad_gap, grads_equal, grads_dtensor = 0.0, True, True
    for path, g in flatten_with_path(dgrads):
        grads_dtensor &= isinstance(g, DTensor)
        g = g.full_tensor() if isinstance(g, DTensor) else g
        same = torch.equal(g, pgrads[path])
        grads_equal &= same
        if not same:
            grad_gap = max(grad_gap, float(
                (g.float() - pgrads[path].float()).abs().max()))
    gloss = gloss.full_tensor() if isinstance(gloss, DTensor) else gloss
    leaves = [x for _, x in flatten_with_path(dparams)]
    return {"loss": float(loss.full_tensor()), "plain_loss": float(plain),
            "is_dtensor": isinstance(loss, DTensor)
            and all(isinstance(x, DTensor) for x in leaves),
            "launches": launches, "prebuilt": prebuilt,
            "sharded_ms": [sharded_ms, sharded_again_ms],
            "plain_ms": plain_ms, "leaves": len(leaves),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "grad": {"remat": cfg.run.remat, "loss": float(gloss),
                     "loss_equals_no_grad": bool(torch.equal(
                         gloss, loss.full_tensor())),
                     "plain_loss": float(ploss),
                     "grads_on_dtensors": grads_dtensor,
                     "grads_equal_unsharded": grads_equal,
                     "max_grad_gap": grad_gap, "launches": grad_launches,
                     "sharded_ms": grad_ms, "plain_ms": plain_grad_ms}}


def phase_dryrun(torch, step_profile):
    """The dry-run launch layer: ``run_combo`` of gemma3-1b at full width
    (train_4k on the 256-rank mesh, decode_32k on the 512-rank one) and
    of deepseek-v2-lite-16b's decode_32k on the 256-rank mesh under
    EXPERT_PARALLEL_RULES (no all-to-all) and under the override
    expert=("data",) (an all-to-all), traced on the host's torch over a
    fake world, each combo in a subprocess, all at once; meanwhile
    sharded_step
    (``dryrun_rank``) on the card: its loss against the unsharded one,
    ``flash_attention`` launched through ``local_map`` on each rank's
    (here: the one rank's) local tensors, and the analytic roofline of
    train_slice's step on one rank beside train_slice's measured device
    time for one cluster step; then the same loss differentiated through
    the DTensors with each layer checkpointed (the config's
    ``remat="layer"``): 52 ``flash_attention`` launches, its loss equal
    to the no-grad one and its gradients to the unsharded port's."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import analytic_roofline
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.shardings import EXPERT_PARALLEL_RULES

    rule_sets = {None: (),
                 "expert_parallel": tuple(EXPERT_PARALLEL_RULES.items()),
                 "expert_over_data": EP_OVERRIDE}
    t_phase = time.perf_counter()
    with ThreadPoolExecutor(len(DRYRUN_COMBOS)) as pool:
        futures = [pool.submit(dryrun.run_in_subprocess, mesh,
                               [(arch, shape)], DRYRUN_TIMEOUT,
                               rule_sets[rules])
                   for mesh, arch, shape, rules in DRYRUN_COMBOS]
        t_step = time.perf_counter()
        step = run_ranks(dryrun_rank, 1, backend="nccl",
                         device=f"{DEVICE}:0", timeout=DRYRUN_TIMEOUT)[0]
        step_s = time.perf_counter() - t_step
        records = [r for f in futures for r in f.result()]
    all_to_alls = {}
    for rec, (_, _, _, rules) in zip(records, DRYRUN_COMBOS):
        emit({"phase": "dryrun_record", "rules": rules, **rec})
        if rules:
            all_to_alls[rules] = rec.get("roofline", {}).get(
                "collective_counts", {}).get("all-to-all", 0)
    cfg = get_config(TRAIN_ARCH)
    shape = InputShape("train_slice", TRAIN_SEQ, TRAIN_BATCH, "train")
    ana = analytic_roofline(cfg, shape, {"data": 1, "model": 1})
    measured = step_profile.get("device_ms")
    bound_s = max(ana.compute_s, ana.memory_s)
    checks = {
        "records_ok": len(records) == len(DRYRUN_COMBOS)
        and all(r.get("ok") for r in records),
        "records_traced": all(
            r.get("roofline", {}).get("flops_per_device", 0) > 0
            and sum(r.get("roofline", {}).get("collective_counts",
                                              {}).values()) > 0
            for r in records),
        # the experts over model need no exchange; over data, an
        # all-to-all there and back a MoE layer
        "expert_parallel_no_all_to_all":
            all_to_alls.get("expert_parallel") == 0,
        "expert_over_data_all_to_all": all_to_alls.get(
            "expert_over_data", 0) > 0,
        "sharded_on_dtensors": step["is_dtensor"],
        "sharded_loss_equals_unsharded": bool(np.isfinite(step["loss"]))
        and abs(step["loss"] - step["plain_loss"]) <= DRYRUN_LOSS_TOL,
        "flash_attention_launched": step["launches"].get(
            "flash_attention", 0) > 0,
        "kernels_loaded_not_rebuilt": step["prebuilt"],
        # the gradient pass: one flash a layer and one more a recomputed
        # layer, the loss equal to the no-grad one, the gradients the
        # unsharded port's (bit for bit on one rank)
        "grad_remat_layer": step["grad"]["remat"] == "layer",
        "grad_flash_launches": step["grad"]["launches"].get(
            "flash_attention") == 2 * step["launches"].get(
                "flash_attention", 0) == 2 * cfg.model.num_layers,
        "grad_loss_equals_no_grad": step["grad"]["loss_equals_no_grad"],
        "grads_on_dtensors": step["grad"]["grads_on_dtensors"],
        "grads_equal_unsharded": step["grad"]["grads_equal_unsharded"],
    }
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t_phase,
          "combos": [list(c) for c in DRYRUN_COMBOS],
          "all_to_alls": all_to_alls,
          "trace_s": {f"{r['arch']}__{r['shape']}__{r['mesh']}"
                      + (f"__{c[3]}" if c[3] else ""): r.get("trace_s")
                      for r, c in zip(records, DRYRUN_COMBOS)},
          "sharded_step": {**step, "seconds": step_s,
                           "loss_gap": abs(step["loss"] - step["plain_loss"]),
                           "tol": DRYRUN_LOSS_TOL,
                           "batch": [TRAIN_BATCH, TRAIN_SEQ]},
          # the reference's math on one rank at train_slice's shape; its
          # FSDP bytes on one rank are the reference's quirk (nothing
          # moves), so the bound is the larger of compute and memory
          "analytic_one_rank": ana.as_dict(),
          "analytic_bound_ms": bound_s * 1e3,
          "train_slice_device_ms_per_cluster_step": (
              measured / TRAIN_CLUSTERS if measured else None),
          "measured_over_bound": (measured / TRAIN_CLUSTERS / (bound_s * 1e3)
                                  if measured else None),
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dryrun checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return step["launches"], step["grad"]["launches"]


def split_config(arch, dtype_name, layers):
    """A SPLIT_CASES config: the published one (bf16), or an fp32 cut of
    ``layers`` layers at full width."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        if cfg.model.dtype != dtype_name:
            raise ValueError(f"{arch} is {cfg.model.dtype}, not {dtype_name}")
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype_name, param_dtype=dtype_name,
        num_layers=layers))


def rings(cache) -> list:
    from repro_torch.models.attention import map_kv_caches
    out = []
    map_kv_caches(out.append, cache)
    return out


def split_cache(torch, api, mesh=None, rules=None):
    """The split decode's cache: ``api.init_cache``'s tree at
    len(SPLIT_TOKENS) rows of SPLIT_SLOTS (gemma3's local rings 512), no
    prefill: K and V drawn on the card from the seed a layer at a time,
    each ring's positions those of its row's SPLIT_TOKENS tokens
    (``ring_positions``) and its index that count.  With ``mesh`` and
    ``rules`` each leaf is a DTensor laid out by ``cache_shardings``
    holding this rank's share, and only that share of each layer's draw
    is kept; the whole cache drawn by one process and the shares drawn by
    the ranks hold the same values."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import shardings as sh
    from repro_torch.models.attention import map_kv_caches, ring_positions

    with FakeTensorMode():   # the tree's shapes, nothing allocated
        shapes = api.init_cache(len(SPLIT_TOKENS), SPLIT_SLOTS, device="cpu")

    def local(x, pl):
        return shard_slices(mesh, pl, x.shape)

    count = itertools.count()

    def one(ring, pl=None):
        n, lead = next(count), tuple(ring.k.shape[:-4])
        pl = pl or (None,) * len(ring)

        def drawn(x, p, salt):
            keep = local(x, p)[len(lead):]
            slabs = []
            for j in range(int(np.prod(lead, dtype=np.int64))):
                g = torch.Generator(device=DEVICE).manual_seed(
                    SEED + 4096 * n + 2 * j + salt)
                slabs.append(torch.randn(x.shape[len(lead):], generator=g,
                                         dtype=x.dtype, device=DEVICE)[keep]
                             .clone())
            return torch.stack(slabs) if lead else slabs[0]

        rows = torch.stack([ring_positions(ring.k.shape[-3], t)
                            for t in SPLIT_TOKENS]).to(DEVICE)
        pos = rows.expand(lead + rows.shape)
        index = torch.as_tensor(SPLIT_TOKENS, dtype=ring.index.dtype,
                                device=DEVICE).expand(lead + rows.shape[:1])
        leaves = (drawn(ring.k, pl[0], 0), drawn(ring.v, pl[1], 1),
                  pos[local(ring.pos, pl[2])].contiguous(),
                  index[local(ring.index, pl[3])].contiguous())
        if mesh is not None:
            leaves = [DTensor.from_local(t, mesh, p, run_check=False,
                                         shape=x.shape, stride=x.stride())
                      for t, p, x in zip(leaves, pl, ring)]
        return type(ring)(*leaves)

    if mesh is None:
        return map_kv_caches(one, shapes)
    return map_kv_caches(one, shapes, sh.cache_shardings(shapes, mesh, rules))


def shard_slices(mesh, pl, shape) -> tuple:
    """This rank's slice of each dim of a tensor of ``shape`` laid out by
    the placements ``pl`` on ``mesh`` (None: whole), a dim split over
    several mesh dims in mesh-dim order, the first the outermost."""
    start, size = [0] * len(shape), list(shape)
    for j, p in enumerate(pl or ()):
        if p.is_shard():
            size[p.dim] //= mesh.size(j)
            start[p.dim] += mesh.get_coordinate()[j] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def split_tokens(cfg):
    """The tokens each row decodes, (rows, SPLIT_STEPS), from the seed."""
    return np.random.default_rng(SEED + 27).integers(
        0, cfg.model.vocab_size, (len(SPLIT_TOKENS), SPLIT_STEPS))


@contextlib.contextmanager
def attention_calls(record=None, replay=None):
    """Every dense-cache layer's ring write and decode attention in
    ``models/attention.py``, in call order.  With ``record`` (a list),
    the calls on DTensors append ("write", (k rows, v rows, positions))
    and ("decode", q, out), whole tensors on the host.  With ``replay``
    (such a list), the calls take the recorded rows and queries in place
    of their own and append ("decode", their out, the recorded out, the
    plain version's out on the same inputs): the same attention inputs,
    so two runs' decode outputs compare layer by layer although their
    hidden states part (bf16 rounding compounds through the layers),
    and the plain version is the third witness (computed in fp64 for
    the fp32 cuts)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models import sharded

    write, decode = attn._write_slot, attn._decode
    todo = iter(replay or ())
    done = []

    def whole(x):
        return (x.full_tensor() if sharded.is_dtensor(x) else x).cpu()

    def write_slot(cache, rows, slot):
        if replay is not None:
            rows = tuple(r.to(cache[0].device) for r in next(todo)[1])
        elif record is not None and sharded.is_dtensor(cache[0]):
            record.append(("write", tuple(whole(r) for r in rows)))
        return write(cache, rows, slot)

    def decode_at(q, kc, vc, valid, soft_cap=0.0):
        if replay is not None:
            _, q_r, out_r = next(todo)
            q_r = q_r.to(q.device)
            out = decode(q_r, kc, vc, valid, soft_cap)
            # fp32: the witness sums in fp64; on an H100 its fp32 sums
            # over 32,768 slots were 1.08e-4 (1.9x the 3e-5 check) from
            # the fp64 ones where the kernel's were 4.6e-5 (0.46x;
            # PERF.md §6)
            wide = (lambda t: t.double()) if kc.dtype == torch.float32 \
                else (lambda t: t)
            plain = ref.decode_attention_ref(
                wide(q_r[:, 0]), wide(kc), wide(vc), valid,
                soft_cap=soft_cap).to(kc.dtype)
            done.append(("decode", out.cpu(), out_r, plain[:, None].cpu()))
            return out
        out = decode(q, kc, vc, valid, soft_cap)
        if record is not None and sharded.is_dtensor(q):
            record.append(("decode", whole(q), whole(out)))
        return out

    attn._write_slot, attn._decode = write_slot, decode_at
    try:
        yield done
    finally:
        attn._write_slot, attn._decode = write, decode


def split_rank(rank, results, conf):
    """One rank of split_decode (module level: the spawned ranks import
    it): each SPLIT_CASES model drawn on the card from the seed, its
    parameters DTensors laid out by their logical axes and its cache by
    ``cache_shardings`` under DEFAULT_RULES on a (data 1, model 2) mesh
    (``kv_seq`` takes ``model``: this rank holds half of every ring's
    slots), then SPLIT_STEPS ``decode_step`` calls through that layout,
    launches counted from 0 over them.  Returns each case's logits, each
    ring's slot positions after the steps (its first layer's), the
    launches and the steps' wall times."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import build, ops
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import make_model
    from repro_torch.models.common import logical_sharding

    startup_s = time.time() - conf["spawned_at"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prebuilt = (build.BUILD_ROOT / build.source_hash() / build.LIB_NAME
                ).exists()
    mesh = make_test_mesh(DEVICE, (1, 2), ("data", "model"))
    rules = sh.DEFAULT_RULES
    out = []
    for arch, dtype_name, layers in SPLIT_CASES:
        cfg = split_config(arch, dtype_name, layers)
        api = make_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params, axes = api.init_params(
            torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
            with_axes=True)
        dparams = sh.distribute_tree(
            params, mesh, sh.params_shardings(axes, params, mesh, rules))
        del params
        cache = split_cache(torch, api, mesh, rules)
        slots_split = all(r.k.placements[-1] == Shard(r.k.ndim - 3)
                          and r.pos.placements[-1] == Shard(r.pos.ndim - 1)
                          for r in rings(cache))
        tokens = split_tokens(cfg)
        torch.cuda.synchronize()
        ops.reset_launches()
        logits, step_ms, calls = [], [], []
        for step in range(SPLIT_STEPS):
            t0 = time.perf_counter()
            tok = torch.as_tensor(tokens[:, step:step + 1], device=DEVICE)
            dtok = sh.distribute_tree(tok, mesh, sh.batch_shardings(
                {"tokens": tok}, mesh, rules)["tokens"])
            pos = torch.as_tensor(SPLIT_TOKENS, device=DEVICE) + step
            with torch.no_grad(), logical_sharding(mesh, rules), \
                    implicit_replication(), attention_calls(record=calls):
                got, cache = api.decode_step(dparams, dtok, pos, cache)
                got = got.full_tensor()[:, 0].float()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(got.cpu())
        launches = ops.launch_counts()
        ring_pos_after = [(r.pos.to_local()[0] if r.pos.ndim == 3
                           else r.pos.to_local()).cpu()
                          for r in rings(cache)]
        out.append({"arch": arch, "dtype": dtype_name,
                    "layers": cfg.model.num_layers,
                    "logits": torch.stack(logits), "launches": launches,
                    "calls": calls if rank == 0 else None,
                    "step_ms": step_ms, "slots_split": slots_split,
                    "ring_pos": ring_pos_after,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        del dparams, cache
        torch.cuda.empty_cache()
    return {"rank": rank, "device": torch.cuda.current_device(),
            "mesh": str(mesh), "prebuilt": prebuilt, "startup_s": startup_s,
            "cases": out}


def split_masks(C, window=None):
    """The valid slots (len(SPLIT_TOKENS), C) of a ring of C slots at the
    split decode's first step, each row's token written at its position
    SPLIT_TOKENS[b]: a slot counts if it holds a position, within
    ``window`` of the row's where there is one."""
    from repro_torch.models.attention import ring_positions
    pos = np.stack([ring_positions(C, t + 1).numpy() for t in SPLIT_TOKENS])
    valid = pos >= 0
    if window:
        valid &= np.asarray(SPLIT_TOKENS)[:, None] - pos < window
    return valid


def phase_split_kernels(torch):
    """The partial instance at split_decode's shapes, as its first step
    launches it: each rank's share of a 32,768-slot ring at the rows of
    SPLIT_TOKENS (rank 0: 3,001 of 16,384 valid, then two rows all valid;
    rank 1: none (V only), 3,617, all) at stablelm's heads (32 heads, 32
    kv heads, D 64) and gemma3's (4 heads, 1 kv head, D 256), and a share
    of gemma3's 512-slot local ring (window 512: all valid), bf16 and
    fp32.  The 16,384-slot shares' walks are split inside the card, the
    256-slot local share's not."""
    rng = np.random.default_rng(SEED + 9)
    half = SPLIT_SLOTS // 2
    glob = split_masks(SPLIT_SLOTS)
    shares = {f"rank{r}": glob[:, r * half:(r + 1) * half] for r in (0, 1)}
    local = split_masks(2 * LOCAL_SHARE, window=2 * LOCAL_SHARE)
    rows = {}
    for name, H, Hkv, D, masks, split in (
            ("stablelm", 32, 32, 64, shares, True),
            ("gemma", 4, 1, 256, shares, True),
            ("gemma", 4, 1, 256, {"local": local[:, :LOCAL_SHARE]}, False)):
        for share, valid in masks.items():
            for dtype_name in ("bfloat16", "float32"):
                rows[f"{name}_{share}_{dtype_name}"] = check_decode_partial(
                    torch, rng, len(SPLIT_TOKENS), H, Hkv, valid.shape[1], D,
                    valid, dtype_name, split=split)
    bad = [r for r in rows.values() if not r["ok"]]
    if bad:
        raise AssertionError(f"decode_attention_partial disagrees with its "
                             f"plain version: {bad}")
    missed = [r for r in rows.values()
              if r.get("planted_fault_passes", {}).get(str(PARTIAL_TOL))]
    if missed or not any("planted_fault_passes" in r for r in rows.values()):
        raise AssertionError(f"a planted fault passes the check: {missed}")
    return rows


@contextlib.contextmanager
def plain_kernels(names):
    """``ops.<name>`` for each of ``names`` replaced by its plain version
    (``kernels/ref.py``): the control runs."""
    from repro_torch.kernels import ops, ref
    kept = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ref, f"{n}_ref"))
    try:
        yield
    finally:
        for n, fn in kept.items():
            setattr(ops, n, fn)


def unsharded_split_run(torch, api, params, tokens, replay=None,
                        plain=False):
    """SPLIT_STEPS unsharded ``decode_step`` calls from a fresh
    :func:`split_cache`: (logits (steps, rows, V) fp32 on the host, each
    step's wall ms, the launches, each ring's positions after the steps
    (its first layer's), the replayed decode outputs).  ``replay``: the
    ranks' recorded attention calls take the place of this run's own
    (:func:`attention_calls`); ``plain``: the plain version in place of
    the decode kernel."""
    from repro_torch.kernels import ops

    cache = split_cache(torch, api)
    ops.reset_launches()
    logits, step_ms = [], []
    with plain_kernels(("decode_attention",) if plain else ()), \
            attention_calls(replay=replay) as replayed:
        for step in range(SPLIT_STEPS):
            t0 = time.perf_counter()
            tok = torch.as_tensor(tokens[:, step:step + 1], device=DEVICE)
            pos = torch.as_tensor(SPLIT_TOKENS, device=DEVICE) + step
            with torch.no_grad():
                got, cache = api.decode_step(params, tok, pos, cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(got[:, 0].float().cpu())
    pos_after = [(r.pos[0] if r.pos.ndim == 3 else r.pos).cpu()
                 for r in rings(cache)]
    return (torch.stack(logits), step_ms, ops.launch_counts(), pos_after,
            replayed)


def ulps(torch, a, b, dtype) -> float:
    """The largest gap between outputs a and b (..., Dv) in ulps of
    ``dtype`` at each output vector's largest magnitude: an element near
    0 of a sum that cancels carries the rounding of its terms, not of
    its own size."""
    a, b = a.float(), b.float()
    fi = torch.finfo(dtype)
    big = torch.maximum(a.abs(), b.abs()).amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(fi.tiny)))) * fi.eps
    return float(((a - b).abs() / ulp).max())


def phase_split_decode(torch, backend=DIST_BACKEND, devices=f"{DEVICE}:0",
                       phase="split_decode"):
    """The reference's production decode layout on the card: run
    ``split_rank`` on 2 ranks (by default both on the one card over
    gloo; NCCL refuses two ranks on one card), then, here, the unsharded
    port's ``decode_step`` on the same weights and cache (the full
    ``decode_attention`` kernel).  Holds every layer's decode attention
    on the ranks against the unsharded kernel's and the plain version's
    on the same inputs (the ranks' queries and written rows replayed into
    the unsharded run; bf16 3e-2, fp32 3e-5), the fp32 cuts' logits
    against the unsharded ones (3e-5), the ranks' logits equal to each
    other and finite, every ring split along its slots, the rings'
    positions after the steps equal to the unsharded cache's (the writes
    landed, on both sides of the split), and the launches exact: one
    ``decode_attention_partial`` a layer, step and rank, nothing else.
    In bf16 every layer's attention on the ranks is also within
    SPLIT_ATTN_ULPS ulps of both the unsharded kernel's and the plain
    version's, and the models' logits gap to the unsharded run within
    SPLIT_CONTROL_FACTOR times the control's, the gap between the
    unsharded run with the plain decode and with the kernel: with random
    weights a bf16 rounding change in any layer's attention grows
    through the depth to the scale of the logits (stablelm-1.6b's 24
    layers), in the port's own kernel against its plain version too, so
    the bf16 logits are not held at 3e-2."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import make_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks = run_ranks(split_rank, 2, backend=backend, device=devices,
                      timeout=SPLIT_TIMEOUT,
                      args=({"spawned_at": time.time()},))
    ranks_s = time.perf_counter() - t_phase
    cases, checks = [], {}
    total = {k: 0 for k in ops.launch_counts()}
    for i, (arch, dtype_name, layers) in enumerate(SPLIT_CASES):
        cfg = split_config(arch, dtype_name, layers)
        api = make_model(cfg)
        L = cfg.model.num_layers
        params, _ = api.init_params(
            torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
            with_axes=True)
        tokens = split_tokens(cfg)
        got = [r["cases"][i] for r in ranks]
        want, step_ms, unsharded_launches, pos_after, _ = \
            unsharded_split_run(torch, api, params, tokens)
        replayed = unsharded_split_run(torch, api, params, tokens,
                                       replay=got[0]["calls"])[4]
        control = None
        if dtype_name == "bfloat16":
            control = [float(x) for x in (unsharded_split_run(
                torch, api, params, tokens, plain=True)[0] - want)
                .abs().amax((1, 2))]
        del params
        torch.cuda.empty_cache()
        tol = SPLIT_TOL[dtype_name]
        dtype = getattr(torch, dtype_name)
        # per call: ranks vs kernel, ranks vs plain, kernel vs plain
        pairs = [((w, o), (w, p), (o, p)) for _, o, w, p in replayed]
        attn_err = [[float((a.float() - b.float()).abs().max())
                     for a, b in call] for call in pairs]
        attn_ulps = [[ulps(torch, a, b, dtype) for a, b in call]
                     for call in pairs]
        attn_out = [float(w.float().abs().max()) for _, _, w, _ in replayed]
        # each rank's slots: its half of every ring; new positions (at or
        # past the row's cached count) mark the steps' writes
        written = [[int((p >= torch.as_tensor(SPLIT_TOKENS)[:, None]).sum())
                    for p in g["ring_pos"]] for g in got]
        expect = {k: 0 for k in total}
        expect["decode_attention_partial"] = L * SPLIT_STEPS
        for k in total:
            total[k] += sum(g["launches"][k] for g in got)
        case = {
            "arch": arch, "dtype": dtype_name, "layers": L,
            "rows_tokens": list(SPLIT_TOKENS), "slots": SPLIT_SLOTS,
            "max_abs_err": max(float((g["logits"] - want).abs().max())
                               for g in got),
            "max_abs_err_by_step": [float((got[0]["logits"][t] - want[t])
                                          .abs().max())
                                    for t in range(SPLIT_STEPS)],
            "max_abs_logit": float(want.abs().max()), "tol": tol,
            "plain_vs_kernel_max_abs_err": control and max(control),
            "plain_vs_kernel_max_abs_err_by_step": control,
            "attention_calls": len(replayed),
            # [ranks vs kernel, ranks vs plain, kernel vs plain]
            "attention_max_abs_err": [max(e[i] for e in attn_err)
                                      for i in range(3)],
            "attention_max_ulps": [max(u[i] for u in attn_ulps)
                                   for i in range(3)],
            "attention_max_abs_err_by_layer": [
                max(attn_err[t * L + j][0] for t in range(SPLIT_STEPS))
                for j in range(L)],
            "attention_max_ulps_by_layer": [
                max(attn_ulps[t * L + j][0] for t in range(SPLIT_STEPS))
                for j in range(L)],
            "attention_max_abs_out_by_layer": [
                max(attn_out[t * L + j] for t in range(SPLIT_STEPS))
                for j in range(L)],
            "step_ms": [g["step_ms"] for g in got],
            "unsharded_step_ms": step_ms,
            "peak_memory_bytes": [g["peak_memory_bytes"] for g in got],
            "written_slots": written,
            "launches": [g["launches"] for g in got],
            "unsharded_launches": unsharded_launches}
        cases.append(case)
        key = f"{arch}_{dtype_name}"
        checks[f"{key}_attention"] = len(replayed) == L * SPLIT_STEPS and all(
            torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
            for call in pairs for a, b in call[:2])
        if dtype_name == "float32":
            checks[f"{key}_logits"] = all(
                torch.allclose(g["logits"], want, atol=tol, rtol=tol)
                for g in got)
        else:
            checks[f"{key}_attention_ulps"] = all(
                max(u[:2]) <= SPLIT_ATTN_ULPS for u in attn_ulps)
            checks[f"{key}_logits_vs_control"] = (
                case["max_abs_err"] <= SPLIT_CONTROL_FACTOR * max(control))
        checks[f"{key}_logits_finite"] = all(
            bool(g["logits"].isfinite().all()) for g in got)
        checks[f"{key}_ranks_equal"] = torch.equal(got[0]["logits"],
                                                   got[1]["logits"])
        checks[f"{key}_slots_split"] = all(g["slots_split"] for g in got)
        checks[f"{key}_writes"] = all(
            torch.equal(torch.cat([got[0]["ring_pos"][j],
                                   got[1]["ring_pos"][j]], -1), p)
            for j, p in enumerate(pos_after))
        # in every SPLIT_SLOTS ring both ranks hold some of the writes
        checks[f"{key}_writes_both_sides"] = all(
            w0 > 0 and w1 > 0 for w0, w1, p in zip(*written, pos_after)
            if p.shape[-1] == SPLIT_SLOTS)
        checks[f"{key}_launches"] = all(g["launches"] == expect for g in got)
        checks[f"{key}_unsharded_launches"] = (
            unsharded_launches["decode_attention"] == L * SPLIT_STEPS)
    checks["kernels_loaded_not_rebuilt"] = all(r["prebuilt"] for r in ranks)
    emit({"phase": phase, "seconds": time.perf_counter() - t_phase,
          "ranks_seconds": ranks_s, "backend": backend,
          "devices": devices, "mesh": ranks[0]["mesh"],
          "startup_s": [r["startup_s"] for r in ranks],
          "rank_devices": [r["device"] for r in ranks],
          "cases": cases, "launches": total, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return total


@contextlib.contextmanager
def sharded_draws(torch, mesh, rules):
    """``ParamInit.param`` drawing every leaf as the unsharded init does
    (the same generator calls in the same order, a stacked leaf a layer
    at a time) but keeping only this rank's shard of it, a DTensor laid
    out by the leaf's logical axes under ``rules``: a rank of a model too
    large to hold once a rank draws its shards from the seed, with the
    values of the unsharded init's."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import common

    param = common.ParamInit.param

    def draw(self, path, shape, axes, init="fan_in", scale=1.0, dtype=None,
             stack=0):
        dtype = dtype or self.dtype
        full = ((stack,) if stack else ()) + tuple(shape)
        logical = (("layers",) if stack else ()) + tuple(axes)
        pl = common.placements_for(mesh, rules, logical, full)
        keep = shard_slices(mesh, pl, full)
        if stack:
            if keep[0] != slice(0, stack):
                raise ValueError(f"{path}: its layers are split")
            val = torch.empty(tuple(k.stop - k.start for k in keep),
                              dtype=dtype, device=self.device)
            for i in range(stack):
                val[i] = self._draw(shape, init, scale, dtype)[keep[1:]]
        else:
            val = self._draw(shape, init, scale, dtype)[keep].to(
                self.device).contiguous()
        val = DTensor.from_local(
            val, mesh, pl, run_check=False, shape=torch.Size(full),
            stride=torch.empty(full, device="meta").stride())
        common._insert(self.params, path, val)
        common._insert(self.axes, path, logical)
        return val

    common.ParamInit.param = draw
    try:
        yield
    finally:
        common.ParamInit.param = param


@contextlib.contextmanager
def moe_blocks(torch, record):
    """Every MoE layer's routed experts on DTensors (``sharded.moe``), in
    call order: appends {x: its input, out: its output, whole on the
    host; topi: this rank's expert ids (t, k); ms: the call's wall time,
    synchronised}."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharded

    routed, route = sharded.moe, moe_mod._route
    picks = []

    def route_at(p, moe, xf, with_aux):
        out = route(p, moe, xf, with_aux)
        picks.append(out[1].cpu())
        return out

    def routed_at(fn, x, weights):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = routed(fn, x, weights)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        record.append({"x": x.full_tensor().cpu(),
                       "out": out.full_tensor().cpu(),
                       "topi": picks.pop(), "ms": ms})
        return out, aux

    sharded.moe, moe_mod._route = routed_at, route_at
    try:
        yield
    finally:
        sharded.moe, moe_mod._route = routed, route


@contextlib.contextmanager
def exchanges(torch, record):
    """The MoE dispatch's all-to-alls (``sharded._exchange``) of the
    forward: appends (bytes this rank sends, wall ms, synchronised and
    waited for)."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.models import sharded

    exchange = sharded._exchange

    def timed(t, group):
        if group is None:
            return exchange(t, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = funcol.wait_tensor(exchange(t, group))
        torch.cuda.synchronize()
        record.append((t.numel() * t.element_size(),
                       (time.perf_counter() - t0) * 1e3))
        return out

    sharded._exchange = timed
    try:
        yield
    finally:
        sharded._exchange = exchange


#: the kernels deepseek-v2-lite's paths launch
EP_KERNELS = ("flash_attention", "topk_router", "paged_mla_decode_attention")


def ep_tokens(cfg):
    """EP_BATCH tokens from the seed."""
    return np.random.default_rng(SEED + 28).integers(
        0, cfg.model.vocab_size, EP_BATCH)


def ep_block_tables():
    """Each row's pages: EP_PROMPT + EP_STEPS tokens of EP_PAGE-token
    pages, rows one after another."""
    per_row = -(-(EP_PROMPT + EP_STEPS) // EP_PAGE)
    return np.arange(EP_BATCH[0] * per_row, dtype=np.int32).reshape(
        EP_BATCH[0], per_row)


def ep_decode(torch, api, params, tokens, cache, bt, mesh=None, rules=None):
    """EP_STEPS paged decode steps after the prompt: each step's logits
    (rows, V) on the host and its wall ms; on ``mesh`` the tokens are
    laid out by ``rules`` (params and cache are DTensors already)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as sh
    from repro_torch.models.common import logical_sharding
    logits, ms = [], []
    for step in range(EP_STEPS):
        t0 = time.perf_counter()
        at = EP_PROMPT + step
        tok = torch.as_tensor(tokens[:, at:at + 1], device=DEVICE)
        pos = torch.full((EP_BATCH[0],), at, device=DEVICE)
        with torch.no_grad():
            if mesh is None:
                got, cache = api.paged_decode_step(params, tok, pos, cache,
                                                   bt)
            else:
                tok = sh.distribute_tree(tok, mesh, sh.batch_shardings(
                    {"tokens": tok}, mesh, rules)["tokens"])
                with logical_sharding(mesh, rules), implicit_replication():
                    got, cache = api.paged_decode_step(params, tok, pos,
                                                       cache, bt)
                got = got.full_tensor()
        got = got[:, 0].float().cpu()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(got)
    return torch.stack(logits), ms


def o1_scores(tree) -> None:
    """The attention's query and key projections (``wq``, MLA's
    ``w_uk``: (..., fan-in, H, hd)) rescaled in place from the init's
    fan-in over the heads to one over their input, as the CPU tests do:
    the fp32 softmax is ill-conditioned otherwise, and two summation
    orders' gradients part by more than rounding."""
    for k, v in tree.items():
        if isinstance(v, dict):
            o1_scores(v)
        elif k in ("wq", "w_uk") and v.ndim >= 3:
            v.mul_(float(np.sqrt(v.shape[-2] / v.shape[-3])))


def ep_cut(torch, mesh_shape, overrides):
    """One fp32 cut on a (data, model) mesh of ``mesh_shape`` under
    DEFAULT_RULES with ``overrides``: the unsharded port's loss and
    gradients on the card (the mean over the data shards' rows), then
    the same through DTensors (launches counted from 0 over it), every
    gradient gathered to full and compared leaf by leaf."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import make_model
    from repro_torch.models.common import logical_sharding
    from repro_torch.params import flatten_with_path
    from repro_torch.training.train_step import value_and_grad

    cfg = split_config(MOE_ARCH, "float32", EP_CUT_LAYERS)
    api = make_model(cfg)
    mesh = make_test_mesh(DEVICE, mesh_shape, ("data", "model"))
    rules = sh.rules_for(cfg, mesh, overrides)
    params, axes = api.init_params(
        torch.Generator(device=DEVICE).manual_seed(SEED + 1), DEVICE,
        with_axes=True)
    o1_scores(params)
    tok = torch.as_tensor(ep_tokens(cfg), device=DEVICE)
    batch = {"tokens": tok, "labels": tok}
    rows = tok.shape[0] // mesh_shape[0]
    want_loss, want = 0.0, {}
    for r in range(mesh_shape[0]):
        loss, grads = value_and_grad(api.loss, params, {
            k: v[r * rows:(r + 1) * rows] for k, v in batch.items()})
        want_loss += float(loss) / mesh_shape[0]
        for path, g in flatten_with_path(grads):
            want[path] = want.get(path, 0) + g / mesh_shape[0]
        del grads
    dparams = sh.distribute_tree(
        params, mesh, sh.params_shardings(axes, params, mesh, rules))
    dbatch = sh.distribute_tree(batch, mesh,
                                sh.batch_shardings(batch, mesh, rules))
    sent = []
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with logical_sharding(mesh, rules), implicit_replication(), \
            exchanges(torch, sent):
        loss, grads = value_and_grad(api.loss, dparams, dbatch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    moe = dparams["layers"]["moe"]
    err, close = {}, True
    for path, g in flatten_with_path(grads):
        g = g.full_tensor()
        err["/".join(path)] = float((g - want[path]).abs().max())
        close &= bool(torch.allclose(g, want[path], atol=EP_CUT_TOL,
                                     rtol=EP_CUT_TOL))
    loss = float(loss.full_tensor())
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "overrides": [list(o) for o in overrides],
            "loss": loss, "unsharded_loss": want_loss,
            "loss_gap": abs(loss - want_loss),
            "grads_close": close, "max_grad_err": max(err.values()),
            "max_grad_err_by_leaf": err,
            "expert_split": [p.is_shard(1) for p in moe["wo"].placements],
            "local_experts": moe["wo"].to_local().shape[1],
            "all_to_alls": len(sent), "all_to_all_bytes": sum(
                b for b, _ in sent),
            "all_to_all_ms": [ms for _, ms in sent],
            "step_ms": step_ms, "launches": launches}


def ep_rank(rank, results, conf):
    """One rank of ep_moe (module level: the spawned ranks import it):
    deepseek-v2-lite-16b's shards under EXPERT_PARALLEL_RULES on a
    (data 1, model 2) mesh drawn from the seed (``sharded_draws``); its
    forward with every MoE layer's routed block recorded, its loss, and
    EP_STEPS paged decode steps from the parent's prefilled cache (the
    pages whole on each rank), launches counted from 0 over the three;
    then the fp32 cuts (``ep_cut``)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import make_model
    from repro_torch.models.common import logical_sharding

    startup_s = time.time() - conf["spawned_at"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prebuilt = (build.BUILD_ROOT / build.source_hash() / build.LIB_NAME
                ).exists()
    mesh = make_test_mesh(DEVICE, (1, 2), ("data", "model"))
    rules = sh.rules_for(None, mesh, tuple(sh.EXPERT_PARALLEL_RULES.items()))
    cfg = get_config(MOE_ARCH)
    api = make_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with sharded_draws(torch, mesh, rules):
        params = api.init_params(
            torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    moe = params["layers"]["moe"]
    tokens = conf["tokens"]
    tok = torch.as_tensor(tokens, device=DEVICE)
    batch = {"tokens": tok, "labels": tok}
    dbatch = sh.distribute_tree(batch, mesh,
                                sh.batch_shardings(batch, mesh, rules))
    cache = sh.distribute_tree(
        {k: {i: type(c)(*(t.to(DEVICE) for t in c)) for i, c in v.items()}
         if k == "lead" else type(v)(*(t.to(DEVICE) for t in v))
         for k, v in conf["cache"].items()},
        mesh, (Replicate(), Replicate()))
    bt = torch.as_tensor(conf["block_tables"], device=DEVICE)
    blocks = []
    torch.cuda.synchronize()
    ops.reset_launches()
    with torch.no_grad(), logical_sharding(mesh, rules), \
            implicit_replication():
        t0 = time.perf_counter()
        with moe_blocks(torch, blocks):
            logits, _ = api.forward(params, dbatch)
            logits = logits.full_tensor().float().cpu()
        forward_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loss = float(api.loss(params, dbatch).full_tensor())
        torch.cuda.synchronize()
        loss_ms = (time.perf_counter() - t0) * 1e3
    steps, step_ms = ep_decode(torch, api, params, tokens, cache, bt, mesh,
                               rules)
    launches = ops.launch_counts()
    out = {"rank": rank, "mesh": str(mesh), "startup_s": startup_s,
           "prebuilt": prebuilt, "draw_s": draw_s,
           "param_bytes": sh.local_bytes(params),
           "local_experts": moe["wo"].to_local().shape[1],
           "expert_placements": [str(p) for p in moe["wo"].placements],
           "logits": logits, "loss": loss, "steps": steps,
           "forward_ms": forward_ms, "loss_ms": loss_ms, "step_ms": step_ms,
           "block_ms": [b["ms"] for b in blocks],
           "topi": [b["topi"] for b in blocks],
           "blocks": [(b["x"], b["out"]) for b in blocks] if rank == 0
           else [b["out"] for b in blocks],
           "launches": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del params, cache, blocks
    torch.cuda.empty_cache()
    out["cuts"] = {name: ep_cut(torch, shape, overrides) for name, shape,
                   overrides in (
                       ("expert_parallel", (1, 2),
                        tuple(sh.EXPERT_PARALLEL_RULES.items())),
                       ("expert_over_data", (2, 1), EP_OVERRIDE))}
    return out


def phase_ep_kernels(torch):
    """The kernels of ep_moe at its shapes on a rank: the router over
    EP_BATCH's 512 tokens and the 2 decode rows (64 experts, top-6),
    flash at the rank's 8 of 16 heads (T 256, score dim 192, value dim
    128) and absorbed-MLA paged decode at 8 heads (rows of 65 and 66
    tokens in 16-token pages), bf16."""
    rng = np.random.default_rng(SEED + 10)
    B, T = EP_BATCH
    per_row = ep_block_tables().shape[1]
    rows = {"topk_router": check_router(torch, rng, B * T, 64, 6),
            "topk_router_decode": check_router(torch, rng, B, 64, 6),
            "flash_attention": check_flash(torch, rng, B * 8, B * 8, T, 192,
                                           0, "bfloat16", Dv=128,
                                           split=False),
            "paged_mla_decode_attention": check_paged_mla(
                torch, rng, B, 8, 512, 64, EP_PAGE, per_row,
                [EP_PROMPT + 1, EP_PROMPT + 2], B * per_row, "bfloat16")}
    bad = [r for r in rows.values() if not r["ok"]]
    if bad:
        raise AssertionError(f"ep_moe kernels disagree with their plain "
                             f"versions: {bad}")
    return rows


def ep_unsharded(torch, api, params, tokens, bt):
    """The unsharded port's forward logits, loss and paged prefill (its
    cache, copied to the host before the steps) and EP_STEPS decode
    steps' logits, launches counted from 0 over them."""
    from repro_torch.kernels import ops
    tok = torch.as_tensor(tokens, device=DEVICE)
    ops.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, _ = api.forward(params, {"tokens": tok, "labels": tok})
        logits = logits.float().cpu()
        forward_ms = (time.perf_counter() - t0) * 1e3
        loss = float(api.loss(params, {"tokens": tok, "labels": tok}))
        cache = api.init_paged_cache(bt.numel(), EP_PAGE, DEVICE)
        _, cache = api.paged_prefill(params, tok[:, :EP_PROMPT], cache, bt)
    host = {k: {i: type(c)(*(t.cpu() for t in c)) for i, c in v.items()}
            if k == "lead" else type(v)(*(t.cpu() for t in v))
            for k, v in cache.items()}
    steps, step_ms = ep_decode(torch, api, params, tokens, cache, bt)
    return {"logits": logits, "loss": loss, "steps": steps,
            "forward_ms": forward_ms, "step_ms": step_ms, "cache": host,
            "launches": ops.launch_counts()}


def phase_ep_moe(torch, backend=DIST_BACKEND, devices=f"{DEVICE}:0",
                 phase="ep_moe"):
    """Expert-parallel MoE on the card.  First, here, the unsharded port
    at full width (its kernels, then every kernel's plain version: the
    control), its outputs kept and its weights freed; then ``ep_rank``
    on 2 ranks (by default both on the one card over gloo); then, here
    again, every MoE layer's routed block replayed on the ranks' recorded
    input into the unsharded block and into its plain version.  Checks:
    each rank holds 32 experts and launched the router on its tokens
    once a MoE layer and pass (26 a forward or decode step), flash once
    a layer a forward and the paged MLA kernel once a layer a step; the
    ranks' expert ids equal the unsharded router's on the same input,
    and their blocks within EP_BLOCK_ULPS bf16 ulps of both; the ranks'
    logits equal, finite and within EP_CONTROL_FACTOR times the
    control's gap of the unsharded ones; the loss's gap likewise; each
    fp32 cut's loss and gradients within EP_CUT_TOL, an all-to-all in
    (b) and none in (a)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import make_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import layer_slice

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    m = cfg.model
    api = make_model(cfg)
    tokens = ep_tokens(cfg)
    bt = torch.as_tensor(ep_block_tables(), device=DEVICE)

    def draw():
        return api.init_params(
            torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)

    params = draw()
    want = ep_unsharded(torch, api, params, tokens, bt)
    with plain_kernels(EP_KERNELS):
        control = ep_unsharded(torch, api, params, tokens, bt)
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    unsharded_s = time.perf_counter() - t_phase
    t_ranks = time.perf_counter()
    ranks = run_ranks(ep_rank, 2, backend=backend, device=devices,
                      timeout=EP_TIMEOUT,
                      args=({"spawned_at": time.time(), "tokens": tokens,
                             "cache": want.pop("cache"),
                             "block_tables": ep_block_tables()},))
    ranks_s = time.perf_counter() - t_ranks

    # every MoE layer's routed block on the ranks' recorded input
    params = draw()
    moe_layers = m.num_layers - m.moe.first_dense_layers
    dtype = getattr(torch, m.dtype)
    gaps, ulp, picks_equal = [], [], []
    for i, (x, out) in enumerate(ranks[0]["blocks"]):
        p = {k: v for k, v in layer_slice(params["layers"], i)["moe"].items()
             if k != "shared"}
        x = x.to(DEVICE)
        with torch.no_grad():
            kernel = moe_mod._routed(p, m.moe, x, m.act, 1, False)[0].cpu()
            topi = moe_mod._route(p, m.moe, x.reshape(-1, m.d_model),
                                  False)[1].cpu()
            with plain_kernels(("topk_router",)):
                plain = moe_mod._routed(p, m.moe, x, m.act, 1, False)[0]
                plain_topi = moe_mod._route(
                    p, m.moe, x.reshape(-1, m.d_model), False)[1].cpu()
        plain = plain.cpu()
        outs = [out] + ranks[1]["blocks"][i:i + 1]
        # [ranks vs kernel, ranks vs plain, kernel vs plain]
        pairs = [(o, kernel) for o in outs] + [(o, plain) for o in outs] + [
            (kernel, plain)]
        gaps.append([float((a.float() - b.float()).abs().max())
                     for a, b in pairs])
        ulp.append([ulps(torch, a, b, dtype) for a, b in pairs])
        picks_equal.append(all(torch.equal(r["topi"][i].int(), topi.int())
                               for r in ranks)
                           and torch.equal(plain_topi.int(), topi.int()))
    del params
    torch.cuda.empty_cache()

    def gap(a, b):
        return float((a - b).abs().max())

    control_gap = {"logits": gap(control["logits"], want["logits"]),
                   "loss": abs(control["loss"] - want["loss"]),
                   "steps": [gap(c, w) for c, w in
                             zip(control["steps"], want["steps"])]}
    got_gap = {"logits": max(gap(r["logits"], want["logits"])
                             for r in ranks),
               "loss": max(abs(r["loss"] - want["loss"]) for r in ranks),
               "steps": [max(gap(r["steps"][s], want["steps"][s])
                             for r in ranks) for s in range(EP_STEPS)]}
    L = m.num_layers
    expect = {k: 0 for k in ops.launch_counts()}
    expect.update(flash_attention=2 * L,
                  flash_attention_merge=2 * sum(flash_split_layers(
                      m, EP_BATCH[0], EP_BATCH[1], share=2)),
                  topk_router=(2 + EP_STEPS) * moe_layers,
                  paged_mla_decode_attention=EP_STEPS * L)
    total = {k: sum(r["launches"][k] for r in ranks) for k in expect}
    cuts = {name: [r["cuts"][name] for r in ranks]
            for name in ranks[0]["cuts"]}
    checks = {
        "experts_split": all(r["local_experts"] == m.moe.num_experts // 2
                             for r in ranks),
        "launches": all(r["launches"] == expect for r in ranks),
        # the unsharded run's paged prefill routes too
        "unsharded_launches": want["launches"]["topk_router"]
        == (3 + EP_STEPS) * moe_layers,
        "blocks_recorded": len(ranks[0]["blocks"]) == moe_layers,
        "routing_equal": all(picks_equal),
        "blocks_ulps": all(max(u[:4]) <= EP_BLOCK_ULPS for u in ulp),
        "ranks_equal": torch.equal(ranks[0]["logits"], ranks[1]["logits"])
        and all(torch.equal(ranks[0]["steps"], r["steps"]) for r in ranks),
        "finite": all(bool(r["logits"].isfinite().all())
                      and bool(r["steps"].isfinite().all()) for r in ranks)
        and tuple(ranks[0]["logits"].shape) == (*EP_BATCH, m.vocab_size),
        "logits_vs_control": got_gap["logits"]
        <= EP_CONTROL_FACTOR * control_gap["logits"],
        "steps_vs_control": all(
            g <= EP_CONTROL_FACTOR * c for g, c in
            zip(got_gap["steps"], control_gap["steps"])),
        "kernels_loaded_not_rebuilt": all(r["prebuilt"] for r in ranks),
    }
    for name, rs in cuts.items():
        checks[f"cut_{name}_loss"] = all(r["loss_gap"] <= EP_CUT_TOL
                                         for r in rs)
        checks[f"cut_{name}_grads"] = all(r["grads_close"] for r in rs)
        checks[f"cut_{name}_all_to_all"] = all(
            (r["all_to_alls"] > 0) == (name == "expert_over_data")
            for r in rs)
        checks[f"cut_{name}_experts_split"] = all(
            r["local_experts"] == m.moe.num_experts // 2 for r in rs)
    emit({"phase": phase, "seconds": time.perf_counter() - t_phase,
          "unsharded_seconds": unsharded_s, "ranks_seconds": ranks_s,
          "backend": backend, "devices": devices, "mesh": ranks[0]["mesh"],
          "rules": "EXPERT_PARALLEL_RULES", "batch": list(EP_BATCH),
          "prompt": EP_PROMPT, "steps": EP_STEPS,
          "startup_s": [r["startup_s"] for r in ranks],
          "draw_s": [r["draw_s"] for r in ranks],
          "param_bytes": [r["param_bytes"] for r in ranks],
          "local_experts": [r["local_experts"] for r in ranks],
          "expert_placements": [r["expert_placements"] for r in ranks],
          "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
          "forward_ms": [r["forward_ms"] for r in ranks],
          "loss_ms": [r["loss_ms"] for r in ranks],
          "step_ms": [r["step_ms"] for r in ranks],
          "unsharded_forward_ms": want["forward_ms"],
          "unsharded_step_ms": want["step_ms"],
          "block_ms": [r["block_ms"] for r in ranks],
          "loss": [r["loss"] for r in ranks],
          "unsharded_loss": want["loss"], "plain_loss": control["loss"],
          "gap": got_gap, "control_gap": control_gap,
          "control_factor": EP_CONTROL_FACTOR,
          "max_abs_logit": float(want["logits"].abs().max()),
          # per MoE layer: [rank 0, rank 1 vs kernel; rank 0, rank 1 vs
          # plain; kernel vs plain]
          "block_max_abs_err_by_layer": gaps,
          "block_max_ulps_by_layer": ulp,
          "block_max_ulps": [max(u[i] for u in ulp) for i in range(5)],
          "block_ulps_tol": EP_BLOCK_ULPS,
          "launches": [r["launches"] for r in ranks],
          "unsharded_launches": want["launches"]})
    for name, rs in cuts.items():
        emit({"phase": f"{phase}_cut", "cut": name, "layers": EP_CUT_LAYERS,
              "tol": EP_CUT_TOL, "ranks": rs})
    emit({"phase": f"{phase}_checks", "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return total


def kernel_entry(name, source, replaces, launches, row):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "call_ms": row["call_ms"], "shape": row["shape"],
            "dtype": row["dtype"],
            **({"floor_ms": row["floor_ms"]} if "floor_ms" in row else {})}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch
    except ImportError:
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 1
    if not os.path.abspath(repro_torch.__file__).startswith(ROOT + os.sep):
        print("chip_smoke: repro_torch was imported from outside this "
              "checkout", file=sys.stderr)
        return 1

    from repro_torch.kernels import fedavg_reduce as fr

    t_start = time.perf_counter()
    marks = []

    def at(name):
        """Start phase ``name``: its wall seconds go to the launches line."""
        marks.append((name, time.perf_counter()))
        return name

    phase = at("device")
    try:
        smi = phase_device(torch)
        phase = at("build")
        phase_build()
        # the compiled code's report, on the host beside the card's phases
        sass = start_sass()
        from repro_torch.configs import get_config
        one = numpy_clients(np.random.default_rng(SEED),
                            get_config("gru-traffic").model, 1)
        n_params = param_count(one)
        phase = at("kernels")
        gru_rows, fed_rows = phase_kernels(torch, n_params)
        phase = at("autograd")
        phase_autograd(torch)
        phase = at("attention_kernels")
        attn_rows = phase_attention_kernels(torch)
        phase = at("slice")
        launches, pool, measured = phase_slice(torch)
        phase = at("profile")
        phase_profile(torch, pool, measured)
        del pool
        phase = at("hfl_slice")
        hfl_launches = phase_hfl(torch)
        phase = at("lm_slice")
        lm_launches, dense, paged, batches = phase_lm(torch, LM_ARCH, phase)
        phase = at("lm_profile")
        phase_lm_profile(torch, dense, paged, batches, phase)
        del dense, paged
        torch.cuda.empty_cache()
        phase = at("lm_parity")
        phase_lm_parity(torch, LM_ARCH, phase, numpy_lm_params)
        phase = at("moe_kernels")
        moe_rows = phase_moe_kernels(torch)
        phase = at("moe_slice")
        moe_launches, dense, paged, batches = phase_lm(torch, MOE_ARCH,
                                                       phase)
        phase = at("moe_profile")
        phase_lm_profile(torch, dense, paged, batches, phase)
        del dense, paged
        torch.cuda.empty_cache()
        phase = at("moe_parity")
        phase_lm_parity(torch, MOE_ARCH, phase, numpy_moe_params)
        phase = at("ssm_kernels")
        ssm_row, hybrid_flash_row = phase_ssm_kernels(torch)
        phase = at("hybrid_slice")
        hybrid_launches, pool, batches, params, toks = phase_hybrid(torch)
        phase = at("hybrid_profile")
        phase_hybrid_profile(torch, pool, batches, params, toks)
        del pool, params, toks
        torch.cuda.empty_cache()
        phase = at("hybrid_parity")
        phase_hybrid_parity(torch)
        phase = at("gemma_kernels")
        gemma_rows = phase_gemma_kernels(torch)
        phase = at("gemma_slice")
        gemma_launches, dense, paged, batches = phase_lm(torch, GEMMA_ARCH,
                                                         phase)
        phase = at("gemma_profile")
        phase_lm_profile(torch, dense, paged, batches, phase)
        params = dense.engine("cloud").params
        del dense, paged
        phase = at("gemma_long")
        long_launches = phase_gemma_long(torch, params)
        phase = at("gemma_scheduler")
        sched_launches = phase_gemma_scheduler(torch, params)
        del params
        torch.cuda.empty_cache()
        phase = at("gemma_parity")
        phase_lm_parity(torch, GEMMA_ARCH, phase, numpy_gemma_params,
                        layers=GEMMA_PARITY_LAYERS, prompt_len=LONG_PROMPT,
                        max_len=LONG_MAX_LEN, steps=LONG_STEPS)
        phase = at("whisper_kernels")
        whisper_rows = phase_whisper_kernels(torch)
        phase = at("xlstm_slice")
        xlstm_launches, pool, batches = phase_xlstm(torch)
        phase = at("xlstm_profile")
        phase_recurrent_profile(torch, phase, pool, batches)
        del pool
        torch.cuda.empty_cache()
        phase = at("xlstm_parity")
        xl = get_config(XLSTM_ARCH).model.xlstm
        phase_recurrent_parity(torch, XLSTM_ARCH, phase, num_layers=2,
                               xlstm=dataclasses.replace(xl,
                                                         slstm_layers=(1,)))
        phase = at("whisper_slice")
        whisper_launches, pool, batches, forward = phase_whisper(torch)
        phase = at("whisper_profile")
        phase_recurrent_profile(torch, phase, pool, batches, forward)
        del pool, forward
        torch.cuda.empty_cache()
        phase = at("whisper_parity")
        phase_recurrent_parity(torch, WHISPER_ARCH, phase, num_layers=2,
                               encoder_layers=2)
        phase = at("vlm_slice")
        vlm_launches = phase_vlm(torch)
        torch.cuda.empty_cache()
        phase = at("train_slice")
        (train_launches, train_fed_rows, train_flash_row,
         train_losses, train_profile) = phase_train(torch)
        torch.cuda.empty_cache()
        phase = at("remat")
        remat_launches = phase_remat(torch, smi)
        phase = at("train_parity")
        phase_train_parity(torch)
        phase = at("dist_slice")
        dist_launches = phase_dist(torch, train_losses)
        phase = at("split_kernels")
        split_rows = phase_split_kernels(torch)
        phase = at("split_decode")
        split_launches = phase_split_decode(torch)
        phase = at("ep_kernels")
        ep_rows = phase_ep_kernels(torch)
        phase = at("ep_moe")
        ep_launches = phase_ep_moe(torch)
        phase = at("dryrun")
        dryrun_launches, dryrun_grad_launches = phase_dryrun(
            torch, train_profile)
        phase = at("sass")
        finish_sass(*sass)
    except Exception:  # report which phase failed, then fail the run
        traceback.print_exc()
        emit({"phase": phase, "ok": False})
        if "sass" in locals() and sass[1].is_alive():
            sass[1].terminate()
        return 1

    # each main path's launches, counted from 0 just before it ran
    paths = {"slice": launches, "hfl_slice": hfl_launches,
             "lm_slice": lm_launches,
             "moe_slice": moe_launches, "hybrid_slice": hybrid_launches,
             "gemma_slice": gemma_launches, "gemma_long": long_launches,
             "gemma_scheduler": sched_launches,
             "xlstm_slice": xlstm_launches,
             "whisper_slice": whisper_launches, "vlm_slice": vlm_launches,
             "train_slice": train_launches, "remat": remat_launches,
             "dist_slice": dist_launches, "split_decode": split_launches,
             "ep_moe": ep_launches,
             "dryrun_sharded_step": {k: dryrun_launches.get(k, 0)
                                     for k in launches},
             "dryrun_sharded_grad": {k: dryrun_grad_launches.get(k, 0)
                                     for k in launches}}
    total = {k: sum(p[k] for p in paths.values()) for k in launches}
    csrc = "src/repro_torch/kernels/csrc"
    attn = (("flash_attention", 70), ("decode_attention", 57),
            ("paged_decode_attention", 89))
    ends = [t for _, t in marks[1:]] + [time.perf_counter()]
    emit({"phase": "launches", "by_path": paths, "total": total,
          "seconds": time.perf_counter() - t_start,
          "phase_seconds": {name: end - t for (name, t), end in
                            zip(marks, ends)},
          # the three GQA kernels at stablelm's head dim 64 (the kernels
          # line carries gemma3's 256)
          **{f"{name}_stablelm": kernel_entry(
              name, f"{csrc}/{name}.cu",
              f"src/repro/kernels/{name}.py:{line}",
              lm_launches[name], attn_rows[name]) for name, line in attn},
          "flash_attention_mla": kernel_entry(
              "flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              moe_launches["flash_attention"], moe_rows["flash_attention"]),
          "flash_attention_hybrid": kernel_entry(
              "flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              hybrid_launches["flash_attention"], hybrid_flash_row),
          # whisper: the encoder's non-causal flash over 1500 frames, the
          # forward's cross attention (64 tokens to 1500 frames) and the
          # decode step's cross rows (B 4, C 1500)
          **{f"{name}_whisper_{part}": kernel_entry(
              name, f"{csrc}/{name}.cu",
              f"src/repro/kernels/{name}.py:{line}",
              whisper_launches[name], whisper_rows[part])
             for name, line, part in (("flash_attention", 70, "encoder"),
                                      ("flash_attention", 70, "cross"),
                                      ("decode_attention", 57, "decode"))},
          # the LM training path: gemma3's forward at B 4 (BH 16 on 4 kv
          # rows, T 64, D 256) and the two syncs' (C 2, N 792,797,824)
          # replica matrices, bf16 (plain) and fp32 (int8 deltas)
          "flash_attention_train": kernel_entry(
              "flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              train_launches["flash_attention"], train_flash_row),
          **{f"fedavg_reduce_train_{row['dtype']}": kernel_entry(
              "fedavg_reduce", f"{csrc}/fedavg_reduce.cu",
              "src/repro/kernels/fedavg_reduce.py:26",
              train_launches["fedavg_reduce"], row)
             for row in train_fed_rows},
          # the distributed path (both ranks' launches): the same shapes
          # as the LM training path's, whose rows they carry
          "flash_attention_dist": kernel_entry(
              "flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              dist_launches["flash_attention"], train_flash_row),
          **{f"fedavg_reduce_dist_{row['dtype']}": kernel_entry(
              "fedavg_reduce", f"{csrc}/fedavg_reduce.cu",
              "src/repro/kernels/fedavg_reduce.py:26",
              dist_launches["fedavg_reduce"], row)
             for row in train_fed_rows},
          # the split decode's partial instance at each share (the
          # kernels line carries stablelm's rank 1 in bf16)
          **{f"decode_attention_partial_{key}": kernel_entry(
              "decode_attention_partial", f"{csrc}/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:57",
              split_launches["decode_attention_partial"], row)
             for key, row in split_rows.items()
             if key != "stablelm_rank1_bfloat16"},
          # the expert-parallel MoE's shapes on a rank (both ranks'
          # launches): the router over 512 tokens and 2 decode rows, flash
          # and paged MLA at 8 of the 16 heads
          **{f"{name}_ep": kernel_entry(
              kernel, f"{csrc}/{kernel}.cu", replaces,
              ep_launches[kernel], ep_rows[name])
             for name, kernel, replaces in (
                 ("topk_router", "topk_router",
                  "src/repro/kernels/topk_router.py:32"),
                 ("topk_router_decode", "topk_router",
                  "src/repro/kernels/topk_router.py:32"),
                 ("flash_attention", "flash_attention",
                  "src/repro/kernels/flash_attention.py:70"),
                 ("paged_mla_decode_attention", "paged_mla_decode_attention",
                  "src/repro/kernels/paged_decode_attention.py:183"))},
          # the most replicas the wrapper admits (ROADMAP Queue 3)
          **{f"fedavg_reduce_max_replicas_{row['dtype']}": kernel_entry(
              "fedavg_reduce", f"{csrc}/fedavg_reduce.cu",
              "src/repro/kernels/fedavg_reduce.py:26", 0, row)
             for row in fed_rows if row["shape"][0] == fr.MAX_REPLICAS}})
    print(smi, flush=True)
    emit({"kernels": [
        kernel_entry("gru_seq", f"{csrc}/gru_seq.cu",
                     "src/repro/kernels/gru_cell.py:41",
                     total["gru_seq"], gru_rows[2]),
        kernel_entry("fedavg_reduce", f"{csrc}/fedavg_reduce.cu",
                     "src/repro/kernels/fedavg_reduce.py:26",
                     total["fedavg_reduce"], fed_rows[0]),
        *(kernel_entry(name, f"{csrc}/{name}.cu",
                       f"src/repro/kernels/{name}.py:{line}",
                       total[name], gemma_rows[name])
          for name, line in attn),
        kernel_entry("paged_mla_decode_attention",
                     f"{csrc}/paged_mla_decode_attention.cu",
                     "src/repro/kernels/paged_decode_attention.py:183",
                     total["paged_mla_decode_attention"],
                     moe_rows["paged_mla_decode_attention"]),
        kernel_entry("topk_router", f"{csrc}/topk_router.cu",
                     "src/repro/kernels/topk_router.py:32",
                     total["topk_router"], moe_rows["topk_router"]),
        kernel_entry("mamba_chunk_scan", f"{csrc}/mamba_chunk_scan.cu",
                     "src/repro/kernels/mamba_scan.py:66",
                     total["mamba_chunk_scan"], ssm_row),
        kernel_entry("decode_attention_partial",
                     f"{csrc}/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:57",
                     total["decode_attention_partial"],
                     split_rows["stablelm_rank1_bfloat16"]),
        # flash's split merge, launched behind every split flash call
        # (its row: gemma3's global layer at T 1024)
        kernel_entry("flash_attention_merge", f"{csrc}/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:70",
                     total["flash_attention_merge"],
                     gemma_rows["flash_attention_merge"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
