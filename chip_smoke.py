#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the eleven CUDA kernels from src/repro_torch/kernels/csrc (one
   nvcc per source, in parallel) and print each `-Xptxas -v` report;
2. print the card's name and power limit (nvidia-smi);
3. hold every kernel against its plain PyTorch version on the card:
   the dense kernels at the internlm2-1.8b leaf shapes with M = 256
   tokens (one cohort's batch 2 x seq 128), the grouped (MoE expert)
   kernels at the deepseek-v2-lite expert shapes (64 experts, the
   capacity M = 30 rows each) and at 8 experts of 64, 65, 240 and 300
   rows, kernels 5-7 also on f32 rows spanning 2**-60 .. 2**60 and on a
   repeated launch (the same bits), the masked depthwise conv kernels at the
   mamba2-370m and recurrentgemma-9b conv shapes (B 2, S 128, C 2304 and
   4096) with the last layer's offset, each with a non-zero stream
   offset, every mode (the conv also mask-free and flipped, its ds with
   both epilogues and the same bits on a repeated launch), a ragged
   shape and one of C % 4 != 0, and the dense kernels on the f32
   activations recurrentgemma's gate projections feed them: masks and
   words exactly, sums within float32 rounding.  sample_and_pack on
   every full internlm2 leaf of a round (C = 2), on ragged rows (n =
   100,003: the scalar path), on n = 100,004 (the vector path's tail)
   and on a base off the 16-byte grid, both modes, 0 differing bits and
   the same words on a repeated launch.  The bit-packing kernels
   bit for bit (torch.equal) at internlm2's largest leaf (402,653,184
   bits in one row), at a round's 2 rows of it, at a ragged row length
   with misaligned row starts, on a misaligned view, and pack -> unpack.
   The masked matmul at the decode's M = 1, 2, 4, 8 rows: bf16 x at
   internlm2's and gemma3-4b's leaf shapes, f32 x at recurrentgemma's
   4096 x 4096;
4. kernels 1-3 on a rank's column block of each internlm2 leaf (the
   partitioned train step's, `launch.partition`): a 16-way column
   block from the middle of the leaf, n_logical = N at offset c0: the
   block leaf's masks equal the full leaf's columns bit for bit,
   kernels 1-2's one-hot probes on the block equal their probes on the
   full leaf, y, dx and ds within their bounds of the plain versions,
   each block launch timed by graph replay beside the full launch;
   kernels 5-6 on a column block of deepseek-v2-lite's experts; kernels
   8-9 on a 16-way channel block of the mamba2 and recurrentgemma convs
   and kernels 1-2 on f32 on a column block of recurrentgemma's w_rg,
   each equal to the full launch's channels or columns bit for bit and
   timed by graph replay beside it (`conv_block_checks`); and
   time each kernel, its plain version and a PyTorch call computing the
   same function on the pre-masked weight (the library yardstick; none
   packs bits) with CUDA events (kernels 1-3, the tensor-core bodies,
   and 8-9 by CUDA-graph replay, their per-call times and an empty
   kernel's replay time beside), with each internlm2 shape's share of
   its bound and launch plan for kernels 1-3 and each deepseek-v2-lite
   shape's for kernels 5-7 (also at M = 240, a 2048-token cohort's
   capacity), and kernels 1-3 on f32 activations at recurrentgemma's gate
   shape (M 256, K = N = 4096); then kernels 1-3 and 5-7 at the shapes
   the zoo's new paths give them (ZOO_DENSE, ZOO_GROUPED: whisper's
   encoder and cross projections at 2 x 1500 rows, qwen2-7b's widest
   projection, deepseek-v2-236b's q up-projection and its 160 experts
   at 12 rows each) against their plain versions, and timed; then
   kernels 1-9 on bf16 score blocks (`bf16_score_kernel_phase`): 1-4
   at internlm2's shapes, qwen2-7b's 3584 x 18944, a ragged shape and
   (1-3) on f32 activations; 5-7 at the deepseek-v2-lite expert shapes,
   deepseek-v2-236b's 160 experts of 12 rows and a ragged cell; 8-9 at
   mamba2's and recurrentgemma's conv widths, a ragged shape and C % 4
   != 0; against their plain versions (masks and words exactly, ds in
   bf16 within one ulp), no launch allocating an f32 copy of its scores,
   timed (1-3 per internlm2 layer, 4 per round, 5-7 per
   deepseek-v2-lite MoE layer, 8-9 per mamba2 layer) beside the f32
   scores' times and their bounds at 2 bytes a score;
5. check the port's train and round steps on the card against the same
   steps on the CPU (plain versions) at the internlm2, deepseek-v2-lite,
   mamba2, recurrentgemma, qwen2-7b, qwen2-vl (4 patch embeddings a
   sequence) and whisper (stub frames) SMOKE configs: the round exactly,
   the train step's loss, and its backward leaf by leaf (each score
   leaf's update and first moment, each float leaf's update), on the
   configs' bf16 activations (whisper's read, not gated) and, but for
   the hybrid, on f32 ones; and the decode of every family's SMOKE
   config likewise (internlm2, deepseek-v2-lite, mamba2, recurrentgemma,
   gemma3, qwen2-7b, qwen2-vl, whisper with its cross K/V from
   `encode`), gemma3's ring caches against its
   full cache, the serving engine's tenant isolation on the card
   (bit-identical to a solo run), and the lockstep engine against the
   exact one (tokens equal, logits within atol = rtol = 1e-5); and
   (`feature_backward_phase`) one SMOKE train step card against CPU of
   internlm2 in 2 microbatches with remat, of internlm2,
   deepseek-v2-lite, mamba2 and recurrentgemma on bf16 scores, and of
   deepseek-v2-lite with block-local MoE dispatch;
6. drive the main paths, fedpm_reg through `repro_torch.launch.train`
   with 2 cohorts x batch 2 x seq 128, 4 steps, a round every 2, 8-bit
   downlink: full-size internlm2-1.8b (all 24 layers), then
   deepseek-v2-lite-16b at full width with its depth cut to 4 layers
   (the dense layer and 3 MoE layers; 27 do not fit one card's memory),
   full-size mamba2-370m (all 48 layers), and recurrentgemma-9b at full
   width with its depth cut to 5 layers (one rec, rec, attn group and
   the 2-layer rec tail; 38 do not fit); then the rest of the zoo:
   full-size whisper-medium (24 + 24 layers, zero frames of 1500 rows),
   full-size qwen2-vl-2b (28 layers; then one train step through
   `make_train_step` with 64 patch embeddings a sequence, M-RoPE at the
   published sections), qwen2-7b and deepseek-7b at full width cut to 4
   layers, deepseek-v2-236b at full width cut to 2 layers (the dense
   layer and one MoE layer of 160 experts) with 1 cohort, and
   internlm2-1.8b with `--algo fedavg` (no kernel, no round).  Every
   round unpacks each masked leaf's cohort words once (the unpack
   kernel).  Then the performance features (PR 25), through
   `make_train_step` / `make_round_step`: the depth paths on bf16
   scores and moments with 1 cohort (4 steps, 2 rounds): qwen2-7b at all
   28 layers, deepseek-v2-lite-16b at 16 of 27 (kernels 5-7 on bf16
   scores), recurrentgemma-9b at all 38 and mamba2-370m at all 48
   (kernels 8-9 on bf16 scores); internlm2-1.8b at
   batch 4 in one batch and in 2 microbatches with remat (kernel 1
   twice per projection and microbatch); deepseek-v2-lite at 4 layers
   with block dispatch through the launcher (kernels 5-7 once per
   projection, as without it) and one MoE layer's block dispatch
   against the global one on the card; gemma3-4b's masked forward with
   attention in chunks of 512 keys against the unchunked one at 4096
   tokens, then alone at 32768 (its first 4096 rows against the chunked
   forward over those tokens).  Then decoding
   through masked trees at the mamba2, recurrentgemma and gemma3 SMOKE
   configs: frozen decode against the fused training forward (kernels 1
   and 8), and the unfrozen `MaskedLeaf` tree against the frozen one
   (kernel 1 at M = 1).  Then serving with `repro_torch.launch.serve`
   (batch 4, 16-token prompts, 16 tokens; multi-tenant: 4 tenants on 2
   slots, freeze-cache capacity 2) at the published widths: internlm2-1.8b
   and mamba2-370m single and multi, whisper-medium (decoding against
   the zero cross K/V of `init_cache`) and qwen2-vl-2b (text) single,
   gemma3-4b single, multi and lockstep, recurrentgemma-9b single at
   full depth and multi cut to 5 layers; and the artifact path of examples/serve_masked.py for
   internlm2-1.8b and mamba2-370m (`init_server` -> `final_artifact`,
   one pack per masked leaf -> `save_artifact` -> `load_artifact` ->
   unpack, one per leaf -> m * w over weights regenerated from the seed
   -> 16 decode steps at batch 8 after a 32-token prompt).  Before each
   path the kernels' launch counters are zeroed, after it they are read,
   and every kernel must have run the expected number of times;
7. the paper's CNNs (`repro_torch.models.cnn`): (a) with the kernel
   phase, kernels 1-3 at CONV6's im2col shapes (img 32, batch 32: M
   32768 / 8192 / 2048 for the conv pairs, 32 for the denses; K from 27
   to 4096; N from 10 to 256) on f32 activations, against their plain
   versions (masks exactly) and timed beside their bounds and
   torch.matmul on the materialized m * w, and kernels 10-11 bit for bit
   at CONV10's leaf sizes; (b) one fused forward and backward of CONV6
   through `masked_forward_tree` on the card against the CPU, within
   four times the f32 spread of the plain versions on the card; (c)
   CONV4, CONV6 and CONV10 at the published widths through the host-sim
   API (fedpm_reg, 10 clients, 3 local steps, batch 32, adam), 2 rounds
   each with their seconds, client-update seconds, peak memory and the
   launches of kernels 10 and 11 a round, and one CONV6 round profiled;
   (d) the torch Fig. 1 benchmark (`python -m
   repro_torch.benchmarks.fig1_iid`) at its defaults for 4 rounds,
   gated on invariants and launch counts; then the rest of the host-sim
   API: (e) topk (k_frac 0.3), mv_signsgd and fedavg through `run_round`
   at CONV6's published width, non-IID (2 classes a client), 2 rounds
   each, launches exact (kernel 10 packs each client's mask or sign
   leaves, 11 unpacks each leaf once a round; fedavg none), topk's share
   of ones 0.3, mv_signsgd at 1 Bpp, fedavg at 32; (f) every codec that
   accepts it on one client's payload of each kind, from the card:
   lossless round trips, the meter on the card equal to the encoder's
   wire size, a flipped bit raising `ChecksumError`; (g) one round of
   full-size internlm2-1.8b with `--codec golomb`: the card's
   packed-words meter per cohort against the CPU's and the host
   encoder's, its seconds and the memory it adds; (h) the torch Fig. 2
   benchmark (`python -m repro_torch.benchmarks.fig2_noniid`) for 6
   rounds, gated on invariants and launch counts;
8. the runtime (checkpoint and restart, the federated engines): (a)
   internlm2-1.8b's full fed state (24 layers, 2 cohorts, ~28 GB)
   through `AsyncCheckpointer.save` and `restore_checkpoint` onto the
   card, every leaf torch.equal, with its bytes reckoned from the shapes
   against the free space under build/ first (too little fails the
   run), the bytes on disk, the save's blocking and write seconds and
   the restore's; (b) `python -m repro_torch.tools.chaos_smoke` on the
   card: internlm2-1.8b at full width cut to 4 layers, 6 steps, a round
   every 2, --fail-prob 0.3 --tree-fanout 1 --agg-fault-prob 0.3
   --ckpt-dir, SIGKILLed after its first durable round and resumed (its
   later losses, round metrics and final checkpoint equal to an
   uninterrupted run's bit for bit), then relaunched with 3 cohorts (the
   theta-only restore), each launcher process's kernel launches as its
   steps and rounds reckon; (c) the buffered-async engine at CONV6's
   published width (fedpm_reg, 10 clients, 3 local steps of batch 32,
   the bitpack codec): at zero faults and quorum 1 bit-identical to
   `run_round`, then 8 ticks under crashes, partitions, stragglers and
   corrupt uplinks, saved at tick 4 and restored into a fresh engine
   that continues to the same theta, events and seq, kernels 10-11
   exactly as reckoned, the ticks' seconds and the host's share of them;
   (d) the aggregator tree on 8 equal clients at fanout 2: bit-identical
   to the flat engine at zero faults, the measured root bits equal to
   `tree_root_round_bits`, a run under edge crashes and partitions, and
   `chaos_smoke --tree` on the card (exactly-once commits, the same
   theta digest); (e) one faulted engine tick and one commit profiled;
   (f) (after (b)) the mesh round in processes spawned one a card under
   NCCL (`repro_torch.launch.mesh_round.run`, internlm2-1.8b at full
   size, 2 cohorts, the launcher's round configuration): on one card's
   (1, 1, 1) mesh every leaf's digest and every metric equal to the
   `mesh=None` round's from the same seed, the unpacked bf16 baseline's
   theta equal to the packed one, kernel 10 in `mask_mean_packed` equal
   to its plain version, launches exact; the mesh shape, backend, round
   seconds, the collectives' bytes and device ms, peak memory; both
   rounds' collectives recorded (`analysis.comm_model`): the packed wire
   pure at 1 bit a parameter and cohort, the baseline impure, a bitpack
   round's uplink bits equal to its meter, the shard lint clean; then 4
   partitioned train steps (`steps.make_train_step(api, cfg, mesh,
   state_sh)`, the launcher's configuration and batches) on the rank's
   block beside 4 `mesh=None` steps, one state on the card at a time:
   on one card every score, moment and float digest and every loss
   equal, kernels 1-3 once a projection, layer, cohort and step, the
   first step's collectives recorded (gathers over "data" and "model",
   the dx all-reduce over "model", the ds reduce-scatter over "data"),
   the seconds of both and their peaks; the same for deepseek-v2-lite-16b
   at 4 layers (its expert collectives against a closed form) and for
   mamba2-370m at all 48 layers (bit for bit, its losses by their bits;
   every collective of its first step as `block_sites` gives it), then 2
   steps at microbatch 2 of internlm2-1.8b and of deepseek-v2-lite-16b
   with moe_block_dispatch 4 (a rank's rows as pieces inside the global
   chunks, each at its chunk's tick; bit for bit, the kernels once a
   piece, every collective as `block_sites` and `moe_step_sites` give
   it); (g)
   the analysis engines: the op
   walker over one full-width internlm2-1.8b train step and the three
   aligned check configs (no weight-shaped f32 value or mask outside
   the kernels, no f64, every leaf in place), the
   walked and bare step seconds and the peak memory, and the stream
   cover over every arch at full size on the (2, 16, 16) grid's 512
   shards (findings only on the leaves past the uint32 index); (h) the
   multi-pod dry run (`python -m repro_torch.launch.dryrun --device
   cuda`, in processes side by side, each rank 0 of torch's stand-in
   process group): every arch's train_4k cell on the (2, 16, 16) mesh
   (the mask-stream gate over 512 shards, the train step's flops on meta
   tensors and rank 0's partitioned step on meta blocks with its
   collectives recorded: every kind over its axis present, internlm2's,
   mamba2's and recurrentgemma's kernel 1-2 flops a 512th of the global
   step's, the moe cells' expert collectives and the ssm and hybrid
   cells' every collective against their closed forms, kernel 8's flops
   a 512th; the round run on rank 0's block on the
   card with its collectives recorded: wire purity, the comm model,
   the uplink bits against the bitpack meter, kernels 4 and 11 once a
   masked leaf),
   internlm2-1.8b's, the moe archs', mamba2-370m's and
   recurrentgemma-9b's train_4k on (16, 16), internlm2's prefill_32k and
   decode_32k, and its unpacked round (a purity finding a leaf, 16 bits
   a parameter), and deepseek-v2-lite-16b's partitioned train_4k step
   on (2, 16, 16) at microbatch 2 (routing over 8-rank data subgroups)
   and at moe_block_dispatch 64 (4 blocks a rank, routed there), in a
   process of their own (`--step train --patch ...`): their expert
   collectives and kernel 5-6 flops against the closed form, and the
   counted flops no kernel states beside the global dispatch's; (i) the
   four examples (`repro_torch.examples`:
   quickstart, serve_masked, train_lm_masked at ~40M parameters,
   fault_tolerance_demo) on the card, launches reckoned;
9. profile one more step and round of the first four training paths
   and of whisper-medium, eight decode
   steps of the served internlm2-1.8b, and 6 ticks of gemma3-4b's engine
   on 2 slots, exact and lockstep (torch.profiler): device time by
   kernel, the device's busy share and operations a step or tick.

The last two lines are a JSON object per kernel and
{"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

M = 256                       # tokens per cohort on the main path
LAYER_SHAPES = {              # internlm2-1.8b masked leaves, (K, N)
    "w_q": (2048, 2048), "w_k": (2048, 1024), "w_v": (2048, 1024),
    "w_o": (2048, 2048), "w_gate": (2048, 8192), "w_up": (2048, 8192),
    "w_down": (8192, 2048)}
N_LAYERS, COHORTS = 24, 2
RAGGED = (200, 1000, 1500)    # (M, K, N), no dimension a multiple of 64
# deepseek-v2-lite-16b expert projections: (E, M, K, N) with M the
# capacity int(256 tokens * top-6 * 1.25 / 64 experts) = 30
N_EXPERTS, CAP = 64, 30
EXPERT_SHAPES = {"w_gate": (2048, 1408), "w_up": (2048, 1408),
                 "w_down": (1408, 2048)}
GROUPED_RAGGED = (5, 29, 1000, 1500)
# a few groups at the row counts where kernels 5-6's blocks change: one
# 64-row wgmma tile full, two, four, and two M blocks of 256
GROUPED_ROWS = [(8, m, 2048, 1408) for m in (64, 65, 240, 300)]
CAP_2048 = 240                # the capacity of a 2048-token cohort
MOE_LAYERS = 4                # 1 dense + 3 MoE layers of the 27
# masked depthwise convs: W = 4 taps over (B 2, S 128) at mamba2-370m's
# C = d_in + 2*G*N = 2304 (48 layers) and recurrentgemma-9b's lru width
# 4096; a ragged (B, S, C)
CONV_W, CONV_B, CONV_S = 4, 2, 128
CONV_SHAPES = {"mamba2-370m": 2304, "recurrentgemma-9b": 4096}
CONV_RAGGED = (3, 37, 1000)
CONV_ODD = (2, 21, 1001)      # C % 4 != 0: the kernels' element path
MAMBA_LAYERS, RG_LAYERS = 48, 5   # recurrentgemma: 5 of its 38 layers
BITPACK_RAGGED = (3, 37_005)  # (R, n): row starts off the 16-byte grid
# masked leaves a round unpacks: internlm2 7, deepseek-v2-lite at 4
# layers 19, mamba2 3, recurrentgemma at 5 layers 34
ROUND_LEAVES = {"internlm2-1.8b": 7, "deepseek-v2-lite-16b": 19,
                "mamba2-370m": 3, "recurrentgemma-9b": 34}
# the rest of the zoo's training paths (fedpm_reg through the launcher):
# whisper-medium and qwen2-vl-2b at full size, qwen2-7b and deepseek-7b
# at full width cut to 4 layers (full depth needs ~117 and ~109 GB of
# mask state with 2 cohorts), deepseek-v2-236b at full width cut to its
# dense layer and one MoE layer with 1 cohort (~43 GB of state, ~16 GB
# of expert score gradients).  Masked leaves a round: whisper 16 (the
# encoder stack's 6: w_q, w_k, w_v, w_o, w_up, w_down; the decoder's
# 10: self 4, cross 4, w_up, w_down), the GQA models 7, deepseek-v2-236b
# 21 (the dense layer's MLA 6 and MLP 3; the MoE layer's MLA 6, its 3
# stacked expert leaves and the shared MLP's 3)
ROUND_LEAVES.update({"whisper-medium": 16, "qwen2-vl-2b": 7, "qwen2-7b": 7,
                     "deepseek-7b": 7, "deepseek-v2-236b": 21})
ZOO_LAYERS = 4                # qwen2-7b and deepseek-7b: 4 of 28 and 30
DSV2_BIG_LAYERS, DSV2_BIG_COHORTS = 2, 1
VLM_PATCHES = 64              # patch embeddings a sequence, a grid of 8
# the new paths' shapes the kernels meet, held against their plain
# versions and timed: (label, M, K, N) of kernels 1-3 (whisper's encoder
# at 2 x 1500 frame rows, its cross K/V projections likewise; qwen2-7b's
# widest MLP leaf; deepseek-v2-236b's q up-projection) and (label, E, M,
# K, N) of kernels 5-7 (deepseek-v2-236b's 160 experts at the capacity
# int(256 tokens * top-6 * 1.25 / 160) = 12 rows)
ZOO_DENSE = (("whisper enc w_up", 3000, 1024, 4096),
             ("whisper enc w_down", 3000, 4096, 1024),
             ("whisper cross w_k", 3000, 1024, 1024),
             ("qwen2-7b w_up", M, 3584, 18944),
             ("dsv2-236b w_uq", M, 1536, 24576))
ZOO_GROUPED = (("dsv2-236b w_up", 160, 12, 5120, 1536),
               ("dsv2-236b w_down", 160, 12, 1536, 5120))
# gemma3-4b masked leaves, (K, N), and the decode's row counts (batch 1-8)
GEMMA3_SHAPES = {
    "w_q": (2560, 2048), "w_k": (2560, 1024), "w_v": (2560, 1024),
    "w_o": (2048, 2560), "w_gate": (2560, 10240), "w_up": (2560, 10240),
    "w_down": (10240, 2560)}
SMALL_M = (1, 2, 4, 8)
# decode through an unfrozen masked tree, SMOKE configs: (arch, kernel-1
# launches a token at batch 1, bound against the frozen tree; None: bit
# for bit).  mamba2: 2 layers of w_in, w_out; recurrentgemma: 4 rec
# blocks of 8 projections and 1 attention block of 7; gemma3: 6 layers
# of 7
# the serve paths at the published widths: (arch, layers or None for all,
# mode).  recurrentgemma-9b serves one tenant at full depth (its w, f32
# scores and one frozen tree, ~65 GiB), and several at the training
# cell's 5-layer cut (two resident trees do not fit beside w and scores)
SERVE_RUNS = (("internlm2-1.8b", None, "single"),
              ("internlm2-1.8b", None, "multi"),
              ("whisper-medium", None, "single"),
              ("qwen2-vl-2b", None, "single"),
              ("gemma3-4b", None, "single"), ("gemma3-4b", None, "multi"),
              ("gemma3-4b", None, "lockstep"),
              ("mamba2-370m", None, "single"), ("mamba2-370m", None, "multi"),
              ("recurrentgemma-9b", None, "single"),
              ("recurrentgemma-9b", RG_LAYERS, "multi"))
MASKED_DECODE = (("mamba2-370m", 2 * 2, None),
                 ("recurrentgemma-9b", 4 * 8 + 7, 0.15),
                 ("gemma3-4b", 6 * 7, 0.02))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16, published
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_RTOL = 2.0 ** -7         # one bfloat16 ulp, relative
M32 = 0xFFFFFFFF
REPLACES = {
    "masked_matmul_fwd": "src/repro/kernels/masked_matmul.py:153",
    "masked_matmul_dx": "src/repro/kernels/masked_matmul.py:227",
    "masked_matmul_ds": "src/repro/kernels/masked_matmul.py:297",
    "sample_and_pack": "src/repro/kernels/masked_matmul.py:356",
    "masked_matmul_grouped": "src/repro/kernels/masked_matmul.py:443",
    "masked_matmul_grouped_dx": "src/repro/kernels/masked_matmul.py:513",
    "masked_matmul_grouped_ds": "src/repro/kernels/masked_matmul.py:574",
    "masked_conv1d": "src/repro/kernels/masked_matmul.py:649",
    "masked_conv1d_ds": "src/repro/kernels/masked_matmul.py:710",
    "pack_bits": "src/repro/kernels/bitpack.py:36",
    "unpack_bits": "src/repro/kernels/bitpack.py:57",
}


class Failed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failed(what)


def time_ms(torch, fns, reps):
    """Mean device ms of each zero-argument call, run in turn `reps`
    times after one warm-up round (CUDA events around each call)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    ev = [[(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
          for _ in fns]
    for r in range(reps):
        for j, f in enumerate(fns):
            ev[j][r][0].record()
            f()
            ev[j][r][1].record()
    torch.cuda.synchronize()
    return [sum(a.elapsed_time(b) for a, b in e) / reps for e in ev]


def graph_ms(torch, fns, reps):
    """Mean device ms of each zero-argument call, from CUDA events around
    replays of a CUDA graph holding `reps` back-to-back calls: for a
    kernel of a few microseconds the host's launch cost (the Python
    wrapper, ctypes, the output's allocation) would otherwise be timed
    instead of the kernel."""
    out = []
    for f in fns:
        f()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                f()
        graph.replay()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        for _ in range(5):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / (5 * reps))
        del graph
    return out


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def mask_exact(torch, got, want, u, theta, what):
    """Masks read back by identity probes: the same sigmoid runs in
    kernel and plain version, so any flip must sit on the boundary."""
    flips = got != want
    n = int(flips.sum())
    if n:
        gap = (u - theta).abs()[flips]
        check(bool((gap <= 2.4e-7).all()), f"{what}: {n} mask flips "
              f"off the sigmoid boundary")
    check(n <= 16, f"{what}: {n} boundary flips")
    return n


def close_bf16(a, b, what):
    """A bf16 kernel output against its plain version: f32 sums in another
    order, then a bf16 cast, so within one bf16 ulp (plus 1e-4 of the
    largest value); returns the largest difference."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    check(bool((d <= BF16_RTOL * b.abs() + 1e-4 * b.abs().max()).all()),
          f"{what}: max |diff| {float(d.max())}")
    return float(d.max())


def kernel_phase(torch, mm, ref, dev):
    """Kernels vs plain versions at the main path's shapes; returns
    {kernel: max_abs_err} (sample_and_pack: differing bits)."""
    from repro_torch.kernels.dispatch import KERNELS
    err = {k: 0.0 for k in KERNELS[:4]}
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(m, k, n):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(k, n, generator=gen, device=dev)
        g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        return x, w, s, g

    shapes = sorted(set(LAYER_SHAPES.values()))
    for (K, N) in shapes + [RAGGED[1:]]:
        m = RAGGED[0] if (K, N) == RAGGED[1:] else M
        x, w, s, g = operands(m, K, N)
        off = (5 * K * N) & 0xFFFFFFFF
        for mode in ("sample", "threshold"):
            kw = dict(mode=mode, tau=0.45)
            tag = f"K={K} N={N} M={m} {mode}"
            err["masked_matmul_fwd"] = max(err["masked_matmul_fwd"], close_bf16(
                mm.masked_matmul(x, w, s, 1234, off, **kw),
                ref.masked_matmul(x, w, s, 1234, off, **kw), "fwd " + tag))
            err["masked_matmul_dx"] = max(err["masked_matmul_dx"], close_bf16(
                mm.masked_matmul_dx(g, w, s, 1234, off, **kw),
                ref.masked_matmul_dx(g, w, s, 1234, off, **kw), "dx " + tag))
            # identity probes read the masks back exactly: x = [I 0]
            # gives rows 0..r-1 of m*w, g = [I 0] columns 0..r-1
            r = min(m, K, N)
            mask = (ref.threshold_mask(s, 0.45) if mode == "threshold"
                    else ref.sample_mask(s, 1234, off))
            wm = (mask.float() * w.float()).to(torch.bfloat16)
            idx = ref.flat_index(K, N, off, N, dev)
            u = ref.hash_uniform(idx, 1234) if mode == "sample" else \
                torch.full_like(s, 0.45)
            theta = torch.sigmoid(s)
            px = torch.zeros(r, K, device=dev, dtype=torch.bfloat16)
            px[:, :r] = torch.eye(r, device=dev, dtype=torch.bfloat16)
            y = mm.masked_matmul(px, w, s, 1234, off, **kw)
            n_f = mask_exact(torch, y != 0, wm[:r] != 0, u[:r], theta[:r],
                             "fwd probe " + tag)
            check(n_f or torch.equal(y, wm[:r]), "fwd probe values " + tag)
            pg = torch.zeros(r, N, device=dev, dtype=torch.bfloat16)
            pg[:, :r] = torch.eye(r, device=dev, dtype=torch.bfloat16)
            dx = mm.masked_matmul_dx(pg, w, s, 1234, off, **kw)
            n_d = mask_exact(torch, dx.T != 0, wm[:, :r] != 0, u[:, :r],
                             theta[:, :r], "dx probe " + tag)
            check(n_d or torch.equal(dx.T, wm[:, :r]),
                  "dx probe values " + tag)
        ds = mm.masked_matmul_ds(x, g, w, s)
        want = ref.masked_matmul_ds(x, g, w, s)
        d = float((ds - want).abs().max())
        # f32 sums over M bf16-exact products in another order
        check(bool(torch.allclose(ds, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max()))),
              f"ds K={K} N={N}: max |diff| {d}")
        err["masked_matmul_ds"] = max(err["masked_matmul_ds"], d)
        # layout probe: x = [I 0] makes x^T g the first rows of g exactly,
        # so ds equals the plain version to a few f32 ulps (the sigmoid's)
        r = min(m, K)
        px = torch.zeros(m, K, device=dev, dtype=torch.bfloat16)
        px[:r, :r] = torch.eye(r, device=dev, dtype=torch.bfloat16)
        got, want = mm.masked_matmul_ds(px, g, w, s), \
            ref.masked_matmul_ds(px, g, w, s)
        check(bool(torch.allclose(got, want, rtol=2.0 ** -21, atol=0.0)),
              f"ds probe K={K} N={N}: max |diff| "
              f"{float((got - want).abs().max())}")
        del x, w, s, g, wm, idx, u, theta, mask, px, got, want
        torch.cuda.empty_cache()

    # sample_and_pack: every full layer-stacked leaf of one round (C = 2),
    # a ragged row length (the scalar path), one of n % 4 == 0 off the
    # 128-element chunk (the vector path's tail) and a base off the
    # 16-byte grid (the scalar path), both modes: words exactly, and the
    # same words on a repeated launch
    lens = sorted({N_LAYERS * K * N for K, N in LAYER_SHAPES.values()})
    seeds = [0x9E3779B9 * (c + 1) & 0xFFFFFFFF for c in range(COHORTS)]
    for n in lens + [100_003, 100_004, "misaligned"]:
        if n == "misaligned":
            n = 100_004
            s = torch.empty(COHORTS * n + 1, device=dev)[1:].view(COHORTS, n)
            s.copy_(2 * torch.randn(COHORTS, n, generator=gen, device=dev))
            tag = f"n={n} misaligned"
        else:
            s = 2 * torch.randn(COHORTS, n, generator=gen, device=dev)
            tag = f"n={n}"
        plan = mm.sap_plan(COHORTS, n, mm.card_sms(dev.index or 0),
                           aligned=s.data_ptr() % 16 == 0)
        check(plan["vec"] == (n % 4 == 0 and s.data_ptr() % 16 == 0),
              f"sample_and_pack {tag}: plan {plan}")
        for mode in ("sample", "threshold"):
            words = mm.sample_and_pack(s, seeds, mode=mode, tau=0.45)
            want = ref.sample_and_pack(s, torch.tensor(seeds, device=dev),
                                       mode, 0.45)
            diff = int(ref.popcount32(words ^ want).sum())
            check(diff == 0, f"sample_and_pack {tag} {mode}: {diff} bits "
                  f"(vector path {plan['vec']})")
            del want
            check(torch.equal(words, mm.sample_and_pack(s, seeds, mode=mode,
                                                        tau=0.45)),
                  f"sample_and_pack {tag} {mode}: a repeated launch gives "
                  f"other words")
            torch.cuda.empty_cache()
        del s
    torch.cuda.synchronize()
    return err


def grouped_kernel_phase(torch, mm, ref, dev):
    """Grouped kernels vs plain versions at the deepseek-v2-lite expert
    shapes (E = 64, M = 30) with layer 2's stream offsets
    ((2*E + e)*K*N mod 2**32), a ragged shape and E = 8 groups at
    M = 64, 65, 240 and 300, both mask modes; kernels 5-7 also on f32
    inputs whose rows span 2**-60 .. 2**60 and on a repeated launch;
    returns {kernel: max_abs_err}."""
    from repro_torch.kernels.dispatch import KERNELS
    err = {k: 0.0 for k in KERNELS[4:7]}
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = [(N_EXPERTS, CAP, K, N)
              for K, N in sorted(set(EXPERT_SHAPES.values()))]
    for (E, m, K, N) in shapes + [GROUPED_RAGGED] + GROUPED_ROWS:
        x = torch.randn(E, m, K, generator=gen, device=dev)
        w = torch.randn(E, K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(E, K, N, generator=gen, device=dev)
        g = torch.randn(E, m, N, generator=gen, device=dev)
        seeds = [0x5EED0000 + e for e in range(E)]
        offs = [((2 * E + e) * K * N) & M32 for e in range(E)]
        for mode in ("sample", "threshold"):
            kw = dict(mode=mode, tau=0.45)
            tag = f"E={E} M={m} K={K} N={N} {mode}"
            for name, got, want in (
                    ("masked_matmul_grouped",
                     mm.masked_matmul_grouped(x, w, s, seeds, offs, **kw),
                     ref.masked_matmul_grouped(x, w, s, seeds, offs, **kw)),
                    ("masked_matmul_grouped_dx",
                     mm.masked_matmul_grouped_dx(g, w, s, seeds, offs, **kw),
                     ref.masked_matmul_grouped_dx(g, w, s, seeds, offs,
                                                  **kw))):
                d = float((got - want).abs().max())
                # f32 sums of bf16-exact weights in another order
                check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5
                                          * float(want.abs().max()))),
                      f"{name} {tag}: max |diff| {d}")
                err[name] = max(err[name], d)
                del got, want
            # identity probes read every group's mask back exactly in f32:
            # x[e] = [I 0] gives rows 0..r-1 of m[e]*w[e], g[e] = [I 0]
            # columns 0..r-1
            r = min(m, K, N)
            mask = ref.grouped_mask(s, seeds, offs, mode=mode, tau=0.45)
            wm = mask.float() * w.float()
            theta = torch.sigmoid(s)
            if mode == "sample":
                u = torch.stack([ref.hash_uniform(ref.flat_index(
                    K, N, offs[e], N, dev), seeds[e]) for e in range(E)])
            else:
                u = torch.full_like(s, 0.45)
            px = torch.zeros(E, r, K, device=dev)
            px[:, :, :r] = torch.eye(r, device=dev)
            y = mm.masked_matmul_grouped(px, w, s, seeds, offs, **kw)
            n_f = mask_exact(torch, y != 0, wm[:, :r] != 0, u[:, :r],
                             theta[:, :r], "grouped fwd probe " + tag)
            check(n_f or torch.equal(y, wm[:, :r]),
                  "grouped fwd probe values " + tag)
            pg = torch.zeros(E, r, N, device=dev)
            pg[:, :, :r] = torch.eye(r, device=dev)
            dx = mm.masked_matmul_grouped_dx(pg, w, s, seeds, offs, **kw)
            wt = wm[:, :, :r].transpose(1, 2)
            n_d = mask_exact(torch, dx != 0, wt != 0,
                             u[:, :, :r].transpose(1, 2),
                             theta[:, :, :r].transpose(1, 2),
                             "grouped dx probe " + tag)
            check(n_d or torch.equal(dx, wt), "grouped dx probe values "
                  + tag)
            del mask, wm, theta, u, px, y, pg, dx, wt
        ds = mm.masked_matmul_grouped_ds(x, g, w, s)
        want = ref.masked_matmul_grouped_ds(x, g, w, s)
        d = float((ds - want).abs().max())
        # f32 sums over M terms in another order
        check(bool(torch.allclose(ds, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max()))),
              f"grouped ds E={E} M={m} K={K} N={N}: max |diff| {d}")
        err["masked_matmul_grouped_ds"] = max(err["masked_matmul_grouped_ds"],
                                              d)
        del x, w, s, g, ds, want
        torch.cuda.empty_cache()

    # kernels 5-6 multiply three bf16 parts of each f32 value: rows of x
    # and g scaled by 2**-60 .. 2**60 hold each row to its own scale (f32
    # sums of exact products in another order), and a repeated launch
    # gives the same bits (the cluster's partials are summed in rank order)
    E, m, K, N = 8, CAP, 2048, 1408
    scale = torch.exp2(torch.linspace(-60, 60, E * m, device=dev).round())
    x = torch.randn(E, m, K, generator=gen, device=dev) * scale.view(E, m, 1)
    g = torch.randn(E, m, N, generator=gen, device=dev) * scale.view(E, m, 1)
    w = torch.randn(E, K, N, generator=gen, device=dev).to(torch.bfloat16)
    s = 2 * torch.randn(E, K, N, generator=gen, device=dev)
    seeds = [0x5EED0000 + e for e in range(E)]
    offs = [((2 * E + e) * K * N) & M32 for e in range(E)]
    for name, kern, plain, a in (
            ("masked_matmul_grouped", mm.masked_matmul_grouped,
             ref.masked_matmul_grouped, x),
            ("masked_matmul_grouped_dx", mm.masked_matmul_grouped_dx,
             ref.masked_matmul_grouped_dx, g)):
        got = kern(a, w, s, seeds, offs)
        again = kern(a, w, s, seeds, offs)
        want = plain(a, w, s, seeds, offs)
        rowmax = want.abs().amax(dim=-1, keepdim=True)
        d = (got - want).abs()
        check(bool((d <= 1e-5 * want.abs() + 1e-5 * rowmax).all()),
              f"{name} rows at 2**-60..2**60: max |diff| / row max "
              f"{float((d / rowmax).max())}")
        check(torch.equal(got, again), f"{name}: a repeated launch gives "
              f"other bits")
        del got, again, want, rowmax, d
    # kernel 7 multiplies three bf16 parts of x and of g: rows of x at
    # 2**-60 .. 2**60 against rows of g at 2**60 .. 2**-60 (each product
    # row near 1), held to the bound of an f32 sum of the terms,
    # (|x[e]|^T |g[e]|) * |w[e]| * sigmoid'(s[e]), and a repeated launch
    # gives the same bits
    g = g / scale.view(E, m, 1) * scale.flip(0).view(E, m, 1)
    got = mm.masked_matmul_grouped_ds(x, g, w, s)
    again = mm.masked_matmul_grouped_ds(x, g, w, s)
    want = ref.masked_matmul_grouped_ds(x, g, w, s)
    terms = ref.masked_matmul_grouped_ds(x.abs(), g.abs(), w.abs(), s)
    d = (got - want).abs()
    check(bool((d <= 1e-5 * terms).all()), "masked_matmul_grouped_ds rows "
          f"at 2**-60..2**60: max |diff| / bound "
          f"{float((d / terms.clamp_min(1e-30)).max())}")
    check(torch.equal(got, again), "masked_matmul_grouped_ds: a repeated "
          "launch gives other bits")
    del x, g, w, s, got, again, want, terms, d
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return err


def timing_phase(torch, mm, ref, dev):
    """Per-layer (7 projections, one cohort) times of kernels 1-3 and
    per-round (7 leaves, C = 2) times of sample_and_pack: kernel, plain
    version and library yardstick, in ms, with their bounds.  Kernels 1-3
    (the tensor-core bodies at bf16 activations) and their yardsticks run
    tens of microseconds a shape, so they are timed by CUDA-graph replay
    (`graph_ms`); their per-call times with the host's launch cost (CUDA
    events around each call) are printed beside, with each shape's plan
    and share of its bound.  Then kernels 1-3 on f32 activations (1-2 on
    the SIMT body, 3 on the tensor-core body, by graph replay) at
    recurrentgemma's gate shape, rows of their own."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ops = []
    for name, (K, N) in LAYER_SHAPES.items():
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = torch.randn(K, N, generator=gen, device=dev)
        g = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
        wm = (ref.sample_mask(s, 7, 0).to(torch.bfloat16) * w)
        ops.append((name, K, N, x, w, s, g, wm))
    res, per_shape = {}, {}
    specs = {
        "masked_matmul_fwd": (
            lambda o: (lambda: mm.masked_matmul(o[3], o[4], o[5], 7, 0)),
            lambda o: (lambda: ref.masked_matmul(o[3], o[4], o[5], 7, 0)),
            lambda o: (lambda: o[3] @ o[7]),
            lambda K, N: (2 * M * K + 6 * K * N + 2 * M * N, 2 * M * K * N)),
        "masked_matmul_dx": (
            lambda o: (lambda: mm.masked_matmul_dx(o[6], o[4], o[5], 7, 0)),
            lambda o: (lambda: ref.masked_matmul_dx(o[6], o[4], o[5], 7, 0)),
            lambda o: (lambda: o[6] @ o[7].T),
            lambda K, N: (2 * M * N + 6 * K * N + 2 * M * K, 2 * M * K * N)),
        "masked_matmul_ds": (
            lambda o: (lambda: mm.masked_matmul_ds(o[3], o[6], o[4], o[5])),
            lambda o: (lambda: ref.masked_matmul_ds(o[3], o[6], o[4], o[5])),
            lambda o: (lambda: o[3].T @ o[6]),
            lambda K, N: (2 * M * K + 2 * M * N + 10 * K * N, 2 * M * K * N)),
    }
    for kname, (kern, plain, lib, cost) in specs.items():
        t_k = graph_ms(torch, [kern(o) for o in ops], 20)
        t_l = graph_ms(torch, [lib(o) for o in ops], 20)
        t_call = time_ms(torch, [kern(o) for o in ops] +
                         [lib(o) for o in ops], 10)
        t_p = time_ms(torch, [plain(o) for o in ops], 2)
        nbytes = sum(cost(o[1], o[2])[0] for o in ops)
        flops = sum(cost(o[1], o[2])[1] for o in ops)
        b_ms, b_by = bound(nbytes, flops)
        res[kname] = dict(ms=sum(t_k), plain_ms=sum(t_p),
                          library_ms=sum(t_l), bound_ms=b_ms, bound_by=b_by)
        per_shape[kname] = {o[0]: (tk, tp, tl, bound(*cost(o[1], o[2]))[0])
                            for o, tk, tp, tl in zip(ops, t_k, t_p, t_l)}
        dx = kname == "masked_matmul_dx"
        print(f"  {kname} per shape at M={M} (graph replay; per call with "
              f"launch cost in brackets), share of the bound, plan:")
        for i, o in enumerate(ops):
            R, C = (o[2], o[1]) if dx else (o[1], o[2])
            if kname == "masked_matmul_ds":
                plan = mm.card_ds_plan(dev.index or 0, M, o[1], o[2], False)
                desc = (f"tile {plan['bk']}x{plan['bn']}, {plan['stages']} "
                        f"stages, {plan['grid']} blocks")
            else:
                plan = mm.card_plan(kname, dev.index or 0, M, R, C)
                desc = (f"width {plan['bc']}, cluster {plan['split']}, "
                        f"{plan['split'] * plan['grid'][1] * plan['grid'][2]}"
                        f" blocks")
            tb = per_shape[kname][o[0]][3]
            print(f"    {o[0]:7s} {t_k[i]:.4f} [{t_call[i]:.4f}] ms, library "
                  f"{t_l[i]:.4f} [{t_call[len(ops) + i]:.4f}], bound "
                  f"{tb:.4f}: {100 * tb / t_k[i]:.1f}% of the bound; {desc}")
        print(f"    layer   {sum(t_k):.4f} [{sum(t_call[:len(ops)]):.4f}] ms, "
              f"library {sum(t_l):.4f}, bound {b_ms:.4f}: "
              f"{100 * b_ms / sum(t_k):.1f}% of the bound")
    cap = mm.card_capacity("masked_matmul_fwd")
    print(f"  blocks the card holds at once in clusters of 1.."
          f"{mm.MAX_CLUSTER} (occupancy query, width 128): "
          f"{[cap(128, k, mm.wgmma_smem(128, 2)) for k in range(1, 9)]}")
    del ops
    torch.cuda.empty_cache()

    # one round's uplink: the 7 full leaves, C = 2 cohorts
    t_k, t_p, nbytes = 0.0, 0.0, 0
    per_shape["sample_and_pack"] = {}
    seeds = [11, 12]
    for name, (K, N) in LAYER_SHAPES.items():
        n = N_LAYERS * K * N
        s = torch.randn(COHORTS, n, generator=gen, device=dev)
        tk = time_ms(torch, [lambda: mm.sample_and_pack(s, seeds)], 5)[0]
        sd = torch.tensor(seeds, device=dev)
        tp = time_ms(torch, [lambda: ref.sample_and_pack(s, sd)], 1)[0]
        nb = COHORTS * n * 4 + COHORTS * ((n + 31) // 32) * 4
        per_shape["sample_and_pack"][name] = (tk, tp, None, bound(nb, 0)[0])
        t_k, t_p, nbytes = t_k + tk, t_p + tp, nbytes + nb
        plan = mm.sap_plan(COHORTS, n, mm.card_sms(dev.index or 0),
                           aligned=s.data_ptr() % 16 == 0)
        print(f"  sample_and_pack {name} C={COHORTS} n={n}: {tk:.4f} ms, "
              f"bound {bound(nb, 0)[0]:.4f}; plan: vector path "
              f"{plan['vec']}, {plan['per_thread']} elements a thread in "
              f"flight, {plan['grid']} blocks of {plan['threads']}")
        del s
        torch.cuda.empty_cache()
    b_ms, b_by = bound(nbytes, 0)
    res["sample_and_pack"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                                  bound_ms=b_ms, bound_by=b_by)

    # kernels 1-3 on f32 activations at recurrentgemma's gate projections
    # w_rg / w_ri; the yardstick an f32 torch.matmul (TF32 off) on the
    # pre-masked w (for kernel 3 the x^T g product alone).  Kernels 1-2
    # run the SIMT body, bound by f32 flops on the CUDA cores (67 TFLOP/s).
    # Kernel 3 runs the tensor-core body on three bf16 parts of x and g,
    # 6 products, so the f32 CUDA-core rate does not bound it: its bound
    # is the larger of its bytes and those products at the bf16 rate.
    K = N = CONV_SHAPES["recurrentgemma-9b"]
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
    s = torch.randn(K, N, generator=gen, device=dev)
    g = torch.randn(M, N, generator=gen, device=dev)
    wm = ref.sample_mask(s, 7, 0).float() * w.float()
    nb = 4 * M * K + 6 * K * N + 4 * M * N
    for kname, kern, plain, lib, cost in (
            ("masked_matmul_fwd", lambda: mm.masked_matmul(x, w, s, 7, 0),
             lambda: ref.masked_matmul(x, w, s, 7, 0), lambda: x @ wm,
             (nb, 2 * M * K * N, F32_FLOPS_PER_S)),
            ("masked_matmul_dx", lambda: mm.masked_matmul_dx(g, w, s, 7, 0),
             lambda: ref.masked_matmul_dx(g, w, s, 7, 0),
             lambda: g @ wm.T, (nb, 2 * M * K * N, F32_FLOPS_PER_S)),
            ("masked_matmul_ds", lambda: mm.masked_matmul_ds(x, g, w, s),
             lambda: ref.masked_matmul_ds(x, g, w, s), lambda: x.T @ g,
             (4 * M * K + 4 * M * N + 10 * K * N, 6 * 2 * M * K * N,
              BF16_FLOPS_PER_S))):
        if kname == "masked_matmul_ds":
            tk, tl = graph_ms(torch, [kern, lib], 20)
            t_call = time_ms(torch, [kern, lib], 10)
            print(f"  masked_matmul_ds f32 {K}x{N} at M={M}: {tk:.4f} "
                  f"[{t_call[0]:.4f}] ms, library {tl:.4f} [{t_call[1]:.4f}]"
                  f" (graph replay; per call in brackets)")
        else:
            tk, tl = time_ms(torch, [kern, lib], 5)
        tp = time_ms(torch, [plain], 2)[0]
        per_shape[kname][f"f32 {K}x{N}"] = (tk, tp, tl, bound(*cost)[0])
    del x, w, s, g, wm
    torch.cuda.empty_cache()
    return res, per_shape


# the partitioned train step's column blocks (`launch.partition`): each
# internlm2 leaf cut to a 16-way column block over "model", the 9th, in
# the middle of the leaf
BLOCK_SPLIT, BLOCK_AT = 16, 8


def block_kernel_phase(torch, mm, ref, dev):
    """Kernels 1-3 on a rank's column block of each internlm2 leaf (M =
    256): columns c0 .. c0 + N/16 of the leaf, launched with n_logical = N
    at stream offset c0.  The block leaf's masks (`effective_weight`)
    equal the full leaf's columns bit for bit; kernels 1 and 2 read the
    full leaf's masks, their one-hot probes on the block equal to their
    probes on the full leaf's columns bit for bit (and to the plain masks
    but for boundary flips, `mask_exact`); y, dx and ds within the
    kernels' bounds of their plain versions on random operands.  Each
    block launch is timed by CUDA-graph replay beside the full leaf's
    launch.  Returns ({kernel: max abs err}, {kernel: {leaf: (block ms,
    full ms, block bound ms)}})."""
    import numpy as np
    from repro_torch.core import masking
    from repro_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(41)
    names = ("masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds")
    err = dict.fromkeys(names, 0.0)
    rows = {k: {} for k in names}
    seed = 1234

    for name, (K, N) in LAYER_SHAPES.items():
        nl = N // BLOCK_SPLIT
        c0, c1 = BLOCK_AT * nl, (BLOCK_AT + 1) * nl
        w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(K, N, generator=gen, device=dev)
        wb, sb = w[:, c0:c1].contiguous(), s[:, c0:c1].contiguous()
        tag = f"block {name} K={K} N={N} cols {c0}..{c1}"
        full = layers.effective_weight(masking.MaskedLeaf(
            w, s, np.uint32(seed), np.uint32(0))).detach()
        blk = layers.effective_weight(masking.MaskedLeaf(
            wb, sb, np.uint32(seed), np.uint32(c0), n_logical=N)).detach()
        check(torch.equal(blk, full[:, c0:c1]), f"{tag}: the block leaf's "
              f"masks differ from the full leaf's columns")
        # one-hot probes: rows ks of m*w through kernel 1, columns ns
        # through kernel 2, on the block and on the full leaf
        ks = torch.arange(M, device=dev) * (K // M)
        ns = torch.arange(M, device=dev) % nl
        px = torch.zeros(M, K, device=dev, dtype=torch.bfloat16)
        px[torch.arange(M, device=dev), ks] = 1
        y = mm.masked_matmul(px, wb, sb, seed, c0, n_logical=N)
        check(torch.equal(y, mm.masked_matmul(px, w, s, seed, 0)[:, c0:c1]),
              f"{tag}: kernel 1's block probe differs from its full probe")
        u = ref.hash_uniform(ref.flat_index(K, N, 0, N, dev), seed)
        theta = torch.sigmoid(s)
        nf = mask_exact(torch, y != 0, blk[ks] != 0, u[ks, c0:c1],
                        theta[ks, c0:c1], "fwd " + tag)
        check(nf or torch.equal(y, blk[ks]), f"{tag}: kernel 1's probe")
        pg = torch.zeros(M, nl, device=dev, dtype=torch.bfloat16)
        pg[torch.arange(M, device=dev), ns] = 1
        pf = torch.zeros(M, N, device=dev, dtype=torch.bfloat16)
        pf[:, c0:c1] = pg
        dx = mm.masked_matmul_dx(pg, wb, sb, seed, c0, n_logical=N)
        check(torch.equal(dx, mm.masked_matmul_dx(pf, w, s, seed, 0)),
              f"{tag}: kernel 2's block probe differs from its full probe")
        nd = mask_exact(torch, dx.T != 0, blk[:, ns] != 0, u[:, c0 + ns],
                        theta[:, c0 + ns], "dx " + tag)
        check(nd or torch.equal(dx.T, blk[:, ns]), f"{tag}: kernel 2's probe")
        # random operands against the plain versions
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(M, nl, generator=gen, device=dev).to(torch.bfloat16)
        err["masked_matmul_fwd"] = max(err["masked_matmul_fwd"], close_bf16(
            mm.masked_matmul(x, wb, sb, seed, c0, n_logical=N),
            ref.masked_matmul(x, wb, sb, seed, c0, N), "fwd " + tag))
        err["masked_matmul_dx"] = max(err["masked_matmul_dx"], close_bf16(
            mm.masked_matmul_dx(g, wb, sb, seed, c0, n_logical=N),
            ref.masked_matmul_dx(g, wb, sb, seed, c0, N), "dx " + tag))
        ds = mm.masked_matmul_ds(x, g, wb, sb)
        want = ref.masked_matmul_ds(x, g, wb, sb)
        check(bool(torch.allclose(ds, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max()))),
              f"ds {tag}: max |diff| {float((ds - want).abs().max())}")
        err["masked_matmul_ds"] = max(err["masked_matmul_ds"],
                                      float((ds - want).abs().max()))
        gf = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
        t = graph_ms(torch, [
            lambda: mm.masked_matmul(x, wb, sb, seed, c0, n_logical=N),
            lambda: mm.masked_matmul(x, w, s, seed, 0),
            lambda: mm.masked_matmul_dx(g, wb, sb, seed, c0, n_logical=N),
            lambda: mm.masked_matmul_dx(gf, w, s, seed, 0),
            lambda: mm.masked_matmul_ds(x, g, wb, sb),
            lambda: mm.masked_matmul_ds(x, gf, w, s)], 20)
        cost = {"masked_matmul_fwd": 2 * M * K + 6 * K * nl + 2 * M * nl,
                "masked_matmul_dx": 2 * M * nl + 6 * K * nl + 2 * M * K,
                "masked_matmul_ds": 2 * M * K + 2 * M * nl + 10 * K * nl}
        for j, k in enumerate(names):
            rows[k][name] = (t[2 * j], t[2 * j + 1],
                             bound(cost[k], 2 * M * K * nl)[0])
        del w, s, wb, sb, full, blk, x, g, gf, px, pg, pf, u, theta
        torch.cuda.empty_cache()
    print(f"block phase (kernels 1-3 on column block {BLOCK_AT} of "
          f"{BLOCK_SPLIT} of each internlm2 leaf, n_logical = N, off = c0, "
          f"M = {M}; graph replay, ms): block / full / full over "
          f"{BLOCK_SPLIT} / block bound; the block's masks equal the full "
          f"leaf's columns, kernels 1-2's block probes their full probes")
    for k in names:
        for leaf, (tb, tf, bb) in rows[k].items():
            print(f"  {k:18s} {leaf:7s} {tb:9.4f} {tf:9.4f} "
                  f"{tf / BLOCK_SPLIT:9.4f} {bb:9.4f}")
        tb, tf = (sum(r[i] for r in rows[k].values()) for i in (0, 1))
        print(f"  {k:18s} layer   {tb:9.4f} {tf:9.4f} "
              f"{tf / BLOCK_SPLIT:9.4f} "
              f"{sum(r[2] for r in rows[k].values()):9.4f}")
    return err, rows


def grouped_block_checks(torch, mm, ref, dev):
    """Kernels 5-6 on a column block of deepseek-v2-lite's experts (E =
    8, M = CAP; the partitioned step's fallback where E does not split
    over "model"): columns c0 .. c0 + N/16 of each expert, launched with
    n_logical = N at each group's offset moved by c0.  One-hot probes on
    the block equal the full launch's columns (kernel 5) and its rows
    (kernel 6) bit for bit; y and dx on random operands within the f32
    bound of their plain versions.  Returns {kernel: max abs err}."""
    gen = torch.Generator(device=dev).manual_seed(43)
    names = ("masked_matmul_grouped", "masked_matmul_grouped_dx")
    err = dict.fromkeys(names, 0.0)
    E = 8
    for K, N in sorted(set(EXPERT_SHAPES.values())):
        nl = N // BLOCK_SPLIT
        c0, c1 = BLOCK_AT * nl, (BLOCK_AT + 1) * nl
        w = torch.randn(E, K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(E, K, N, generator=gen, device=dev)
        wb, sb = w[..., c0:c1].contiguous(), s[..., c0:c1].contiguous()
        seeds = [0x5EED0000 + e for e in range(E)]
        offs = [((2 * N_EXPERTS + e) * K * N) & M32 for e in range(E)]
        boffs = [(o + c0) & M32 for o in offs]
        tag = f"grouped block E={E} K={K} N={N} cols {c0}..{c1}"
        r = min(CAP, K, nl)
        px = torch.zeros(E, r, K, device=dev)
        px[:, :, :r] = torch.eye(r, device=dev)
        y = mm.masked_matmul_grouped(px, wb, sb, seeds, boffs, n_logical=N)
        check(torch.equal(y, mm.masked_matmul_grouped(
            px, w, s, seeds, offs)[..., c0:c1]), f"{tag}: kernel 5's block "
              f"probe differs from its full probe")
        pg = torch.zeros(E, r, nl, device=dev)
        pg[:, :, :r] = torch.eye(r, device=dev)
        pf = torch.zeros(E, r, N, device=dev)
        pf[..., c0:c1] = pg
        check(torch.equal(
            mm.masked_matmul_grouped_dx(pg, wb, sb, seeds, boffs,
                                        n_logical=N),
            mm.masked_matmul_grouped_dx(pf, w, s, seeds, offs)),
              f"{tag}: kernel 6's block probe differs from its full probe")
        x = torch.randn(E, CAP, K, generator=gen, device=dev)
        g = torch.randn(E, CAP, nl, generator=gen, device=dev)
        for name, got, want in (
                (names[0],
                 mm.masked_matmul_grouped(x, wb, sb, seeds, boffs,
                                          n_logical=N),
                 ref.masked_matmul_grouped(x, wb, sb, seeds, boffs, N)),
                (names[1],
                 mm.masked_matmul_grouped_dx(g, wb, sb, seeds, boffs,
                                             n_logical=N),
                 ref.masked_matmul_grouped_dx(g, wb, sb, seeds, boffs, N))):
            d = float((got - want).abs().max())
            check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5
                                      * float(want.abs().max()))),
                  f"{name} {tag}: max |diff| {d}")
            err[name] = max(err[name], d)
        del w, s, wb, sb, px, pg, pf, x, g, y
        torch.cuda.empty_cache()
    print(f"grouped block checks (kernels 5-6 on column block {BLOCK_AT} "
          f"of {BLOCK_SPLIT} of each deepseek-v2-lite expert, E = {E}, M = "
          f"{CAP}, n_logical = N): probes equal the full launch's, max abs "
          f"err {json.dumps(err)}")
    return err


def conv_block_checks(torch, mm, ref, dev):
    """The partitioned step's channel blocks at the launcher's rows (B =
    CONV_B, S = CONV_S): kernel 8 (forward on bf16 x, flipped on the f32
    cotangent) and kernel 9 on a rank's 16-way channel block of
    mamba2-370m's and recurrentgemma-9b's conv (channels c0 .. c0 + C/16,
    launched at the layer's offset moved by c0 with n_logical = C), and
    kernels 1-2 on f32 activations (the SIMT tile that carries
    recurrentgemma's gates) on a 16-way column block of its w_rg (4096 x
    4096, M = B * S).  The conv blocks on random operands equal the full
    launch's channels bit for bit (a depthwise conv sums each channel on
    its own, in an order set by (B, S) alone), and kernel 8 equals its
    plain version; kernels 1-2's one-hot probes on the block equal their
    probes on the full leaf's columns bit for bit, and on random f32
    operands they are within f32 rounding of their plain versions.  Each
    block launch is timed by CUDA-graph replay beside the full launch.
    Returns ({kernel: max abs err against the plain version}, {kernel:
    {shape: (block ms, full ms, block bound ms)}})."""
    gen = torch.Generator(device=dev).manual_seed(47)
    names = ("masked_conv1d", "masked_conv1d_ds", "masked_matmul_fwd",
             "masked_matmul_dx")
    err, rows = dict.fromkeys(names, 0.0), {k: {} for k in names}
    W, B, S, seed = CONV_W, CONV_B, CONV_S, 1234
    for arch, C in CONV_SHAPES.items():
        cb = C // BLOCK_SPLIT
        c0, c1 = BLOCK_AT * cb, (BLOCK_AT + 1) * cb
        off = ((MAMBA_LAYERS - 1) * W * C) & M32
        boff = (off + c0) & M32
        x = torch.randn(B, S, C, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(B, S, C, generator=gen, device=dev)
        w = torch.randn(W, C, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(W, C, generator=gen, device=dev)
        xb, gb = x[..., c0:c1].contiguous(), g[..., c0:c1].contiguous()
        wb, sb = w[:, c0:c1].contiguous(), s[:, c0:c1].contiguous()
        tag = f"conv block {arch} C={C} channels {c0}..{c1}"
        for flip, full, blk in ((False, x, xb), (True, g, gb)):
            got = mm.masked_conv1d(blk, wb, sb, seed, boff, n_logical=C,
                                   flip=flip)
            check(torch.equal(got, mm.masked_conv1d(
                full, w, s, seed, off, flip=flip)[..., c0:c1]),
                  f"{tag} flip={flip}: the block differs from the full "
                  f"launch's channels")
            want = ref.masked_conv1d(blk, wb, sb, seed, boff, n_logical=C,
                                     flip=flip)
            d = float((got - want).abs().max())
            check(torch.equal(got, want), f"{tag} flip={flip}: max |diff| "
                  f"{d} against the plain version")
            err["masked_conv1d"] = max(err["masked_conv1d"], d)
        ds = mm.masked_conv1d_ds(xb, gb, wb, sb)
        check(torch.equal(ds, mm.masked_conv1d_ds(x, g, w, s)[:, c0:c1]),
              f"{tag}: kernel 9's block differs from the full launch's "
              f"channels")
        want = ref.masked_conv1d_ds(xb, gb, wb, sb)
        d = float((ds - want).abs().max())
        check(bool(torch.allclose(ds, want, rtol=1e-5, atol=1e-5
                                  * float(want.abs().max()))),
              f"{tag} ds: max |diff| {d}")
        err["masked_conv1d_ds"] = max(err["masked_conv1d_ds"], d)
        t = graph_ms(torch, [
            lambda: mm.masked_conv1d(xb, wb, sb, seed, boff, n_logical=C),
            lambda: mm.masked_conv1d(x, w, s, seed, off),
            lambda: mm.masked_conv1d(gb, wb, sb, seed, boff, n_logical=C,
                                     flip=True),
            lambda: mm.masked_conv1d(g, w, s, seed, off, flip=True),
            lambda: mm.masked_conv1d_ds(xb, gb, wb, sb),
            lambda: mm.masked_conv1d_ds(x, g, w, s)], 50)
        n, ws = B * S * cb, 6 * W * cb          # w bf16 and s f32
        rows["masked_conv1d"][f"{arch} fwd"] = (t[0], t[1], bound(
            2 * n + ws + 4 * n, 2 * W * n, F32_FLOPS_PER_S)[0])
        rows["masked_conv1d"][f"{arch} flip"] = (t[2], t[3], bound(
            4 * n + ws + 4 * n, 2 * W * n, F32_FLOPS_PER_S)[0])
        rows["masked_conv1d_ds"][arch] = (t[4], t[5], bound(
            2 * n + 4 * n + ws + 4 * W * cb, 2 * W * n, F32_FLOPS_PER_S)[0])
        del x, g, w, s, xb, gb, wb, sb, ds, want
    # kernels 1-2 on f32 activations: a column block of recurrentgemma's
    # w_rg (its gates run on f32 u)
    K = N = CONV_SHAPES["recurrentgemma-9b"]
    Mr, nl = B * S, N // BLOCK_SPLIT
    c0, c1 = BLOCK_AT * nl, (BLOCK_AT + 1) * nl
    off = (7 * K * N) & M32
    w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
    s = 2 * torch.randn(K, N, generator=gen, device=dev)
    wb, sb = w[:, c0:c1].contiguous(), s[:, c0:c1].contiguous()
    tag = f"f32 block w_rg K={K} N={N} cols {c0}..{c1}"
    r = min(Mr, nl)
    px = torch.zeros(r, K, device=dev)
    px[torch.arange(r, device=dev), torch.arange(r, device=dev) * (K // r)] = 1
    check(torch.equal(
        mm.masked_matmul(px, wb, sb, seed, off + c0, n_logical=N),
        mm.masked_matmul(px, w, s, seed, off)[:, c0:c1]),
          f"{tag}: kernel 1's block probe differs from its full probe")
    pg = torch.zeros(r, nl, device=dev)
    pg[:, :r] = torch.eye(r, device=dev)
    pf = torch.zeros(r, N, device=dev)
    pf[:, c0:c1] = pg
    check(torch.equal(
        mm.masked_matmul_dx(pg, wb, sb, seed, off + c0, n_logical=N),
        mm.masked_matmul_dx(pf, w, s, seed, off)),
          f"{tag}: kernel 2's block probe differs from its full probe")
    x = torch.randn(Mr, K, generator=gen, device=dev)
    g = torch.randn(Mr, nl, generator=gen, device=dev)
    gf = torch.randn(Mr, N, generator=gen, device=dev)
    for name, got, want in (
            ("masked_matmul_fwd",
             mm.masked_matmul(x, wb, sb, seed, off + c0, n_logical=N),
             ref.masked_matmul(x, wb, sb, seed, off + c0, N)),
            ("masked_matmul_dx",
             mm.masked_matmul_dx(g, wb, sb, seed, off + c0, n_logical=N),
             ref.masked_matmul_dx(g, wb, sb, seed, off + c0, N))):
        d = float((got - want).abs().max())
        check(got.dtype == torch.float32 and bool(torch.allclose(
            got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))),
              f"{name} {tag}: max |diff| {d}")
        err[name] = max(err[name], d)
    t = graph_ms(torch, [
        lambda: mm.masked_matmul(x, wb, sb, seed, off + c0, n_logical=N),
        lambda: mm.masked_matmul(x, w, s, seed, off),
        lambda: mm.masked_matmul_dx(g, wb, sb, seed, off + c0, n_logical=N),
        lambda: mm.masked_matmul_dx(gf, w, s, seed, off)], 20)
    # f32 x or g, bf16 w, f32 s; 2 M K N/16 flops on the f32 units
    cost = (4 * Mr * K + 6 * K * nl + 4 * Mr * nl, 2 * Mr * K * nl)
    rows["masked_matmul_fwd"]["w_rg f32"] = (t[0], t[1],
                                             bound(*cost, F32_FLOPS_PER_S)[0])
    rows["masked_matmul_dx"]["w_rg f32"] = (t[2], t[3],
                                            bound(*cost, F32_FLOPS_PER_S)[0])
    del w, s, wb, sb, x, g, gf, px, pg, pf
    torch.cuda.empty_cache()
    print(f"conv block checks (channel block {BLOCK_AT} of {BLOCK_SPLIT} of "
          f"each conv at B={B} S={S}, off + c0, n_logical = C; kernels 1-2 "
          f"on f32 at M={Mr} on column block {BLOCK_AT} of w_rg): blocks "
          f"equal the full launches' channels and the probes bit for bit, "
          f"max abs err {json.dumps(err)}; graph replay, ms: block / full / "
          f"full over {BLOCK_SPLIT} / block bound")
    for k in names:
        for leaf, (tb, tf, bb) in rows[k].items():
            print(f"  {k:18s} {leaf:26s} {tb:9.4f} {tf:9.4f} "
                  f"{tf / BLOCK_SPLIT:9.4f} {bb:9.4f}")
    return err, rows


def grouped_timing_phase(torch, mm, ref, dev, score_dtype=None):
    """Per-MoE-layer (3 expert projections, one cohort) times of the
    grouped kernels at E = 64, M = 30: kernel, plain version and the
    library yardstick (torch.bmm on the pre-masked f32 weights, TF32
    off; for ds the x^T g product only), in ms, with their bounds and
    each shape's plan and share of its bound; then, on f32 scores, the
    same at M = 240 (a 2048-token cohort's capacity, where all four
    warpgroups of kernels 5-6 multiply and kernel 7 sums 8 stages a
    tile), a row of their own.  The bound counts the split products at
    the bf16 tensor-core rate: three of kernels 5-6, six of kernel 7;
    and the scores (and kernel 7's ds) at their bytes: `score_dtype`
    (f32 by default, or bf16)."""
    sd = score_dtype or torch.float32
    sb = torch.empty((), dtype=sd).element_size()
    gen = torch.Generator(device=dev).manual_seed(3)
    E = N_EXPERTS
    seeds = [7] * E
    res, per_shape = {}, {}
    for M_ in (CAP, CAP_2048) if sb == 4 else (CAP,):
        ops = []
        for name, (K, N) in EXPERT_SHAPES.items():
            offs = [((2 * E + e) * K * N) & M32 for e in range(E)]
            x = torch.randn(E, M_, K, generator=gen, device=dev)
            w = torch.randn(E, K, N, generator=gen,
                            device=dev).to(torch.bfloat16)
            s = torch.randn(E, K, N, generator=gen, device=dev).to(sd)
            g = torch.randn(E, M_, N, generator=gen, device=dev)
            wm = ref.grouped_mask(s, seeds, offs).float() * w.float()
            ops.append((name, K, N, x, w, s, g, wm, offs))
        specs = {
            "masked_matmul_grouped": (
                lambda o: (lambda: mm.masked_matmul_grouped(
                    o[3], o[4], o[5], seeds, o[8])),
                lambda o: (lambda: ref.masked_matmul_grouped(
                    o[3], o[4], o[5], seeds, o[8])),
                lambda o: (lambda: torch.bmm(o[3], o[7])),
                lambda K, N: (4 * E * M_ * K + (2 + sb) * E * K * N
                              + 4 * E * M_ * N, 3 * 2 * E * M_ * K * N,
                              BF16_FLOPS_PER_S)),
            "masked_matmul_grouped_dx": (
                lambda o: (lambda: mm.masked_matmul_grouped_dx(
                    o[6], o[4], o[5], seeds, o[8])),
                lambda o: (lambda: ref.masked_matmul_grouped_dx(
                    o[6], o[4], o[5], seeds, o[8])),
                lambda o: (lambda: torch.bmm(o[6], o[7].transpose(1, 2))),
                lambda K, N: (4 * E * M_ * N + (2 + sb) * E * K * N
                              + 4 * E * M_ * K, 3 * 2 * E * M_ * K * N,
                              BF16_FLOPS_PER_S)),
            "masked_matmul_grouped_ds": (
                lambda o: (lambda: mm.masked_matmul_grouped_ds(
                    o[3], o[6], o[4], o[5])),
                lambda o: (lambda: ref.masked_matmul_grouped_ds(
                    o[3], o[6], o[4], o[5])),
                lambda o: (lambda: torch.bmm(o[3].transpose(1, 2), o[6])),
                lambda K, N: (4 * E * M_ * K + 4 * E * M_ * N
                              + (2 + 2 * sb) * E * K * N,
                              6 * 2 * E * M_ * K * N, BF16_FLOPS_PER_S)),
        }
        for kname, (kern, plain, lib, cost) in specs.items():
            t_k = time_ms(torch, [kern(o) for o in ops], 10)
            t_p = time_ms(torch, [plain(o) for o in ops], 2)
            t_l = time_ms(torch, [lib(o) for o in ops], 10)
            costs = [cost(o[1], o[2]) for o in ops]
            b_ms, b_by = bound(sum(c[0] for c in costs),
                               sum(c[1] for c in costs), costs[0][2])
            if M_ == CAP:
                res[kname] = dict(ms=sum(t_k), plain_ms=sum(t_p),
                                  library_ms=sum(t_l), bound_ms=b_ms,
                                  bound_by=b_by)
                per_shape[kname] = {
                    o[0]: (tk, tp, tl, bound(*c)[0])
                    for o, tk, tp, tl, c in zip(ops, t_k, t_p, t_l, costs)}
            else:
                per_shape[kname][f"layer M={M_}"] = (sum(t_k), sum(t_p),
                                                     sum(t_l), b_ms)
            dx = kname == "masked_matmul_grouped_dx"
            print(f"  {kname} per shape at E={E} M={M_} ({str(sd)[6:]} "
                  f"scores, events per call), share of the bound, plan:")
            for o, tk, tl, c in zip(ops, t_k, t_l, costs):
                R, C = (o[2], o[1]) if dx else (o[1], o[2])
                if kname == "masked_matmul_grouped_ds":
                    plan = mm.card_ds_plan(dev.index or 0, M_, R, C, True, E,
                                           sb)
                    tiles = E * -(-R // plan["bk"]) * -(-C // plan["bn"])
                    desc = (f"tile {plan['bk']}x{plan['bn']}, {tiles} tiles "
                            f"on {plan['grid']} persistent blocks "
                            f"({plan['per_sm']} an SM), {plan['stages']} "
                            f"stages, {plan['chunks']} (w, s) chunks")
                else:
                    plan = mm.card_grouped_plan(kname, dev.index or 0, E, M_,
                                                R, C, sb)
                    blocks = plan["split"] * plan["grid"][1] * plan["grid"][2]
                    desc = (f"width {plan['bc']}, cluster {plan['split']}, "
                            f"{blocks} blocks, {plan['w_stages']} raw stages, "
                            f"{plan['a_bufs']} A buffers")
                tb = bound(*c)[0]
                print(f"    {o[0]:7s} {tk:.4f} ms, library {tl:.4f}, bound "
                      f"{tb:.4f}: {100 * tb / tk:.1f}% of the bound; {desc}")
            print(f"    layer   {sum(t_k):.4f} ms, library {sum(t_l):.4f}, "
                  f"plain {sum(t_p):.4f}, bound {b_ms:.4f} ({b_by}): "
                  f"{100 * b_ms / sum(t_k):.1f}% of the bound")
        del ops
        torch.cuda.empty_cache()
    cap = mm.card_capacity("masked_matmul_grouped", int(sb == 2))
    smem = mm.grouped_smem(128, 64, 2, 3, sb)
    print(f"  grouped blocks the card holds at once in clusters of 1.."
          f"{mm.MAX_CLUSTER} (occupancy query, width 128, 64 rows, "
          f"{str(sd)[6:]} scores): {[cap(128, k, smem) for k in range(1, 9)]}")
    return res, per_shape


def zoo_kernel_phase(torch, mm, ref, dev):
    """Kernels 1-3 and 5-7 at the shapes the zoo's new paths give them
    (ZOO_DENSE, ZOO_GROUPED) against their plain versions, sample mode at
    a non-zero stream offset: kernels 1-3 within the bounds of
    `kernel_phase`, kernels 5-7 per element within 1e-5 of the sum of
    the terms' magnitudes (the bound `grouped_kernel_phase` holds kernel
    7's wide-range rows to; here the sums run over up to 5120 terms);
    each timed with CUDA events (10 calls) beside
    its plain version (1 call), the library call on the pre-masked
    weight (`torch.matmul` / `torch.bmm`, for ds the x^T g product) and
    its bound.  Returns ({kernel: max abs err}, {kernel: {label: (ms,
    plain ms, library ms, bound ms)}})."""
    err, rows = {}, {}
    gen = torch.Generator(device=dev).manual_seed(24)

    def keep(kname, label, d, kern, plain, lib, cost):
        err[kname] = max(err.get(kname, 0.0), d)
        tk, tl = time_ms(torch, [kern, lib], 10)
        tp = time_ms(torch, [plain], 1)[0]
        rows.setdefault(kname, {})[label] = (tk, tp, tl, bound(*cost)[0])

    for label, m, K, N in ZOO_DENSE:
        x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(K, N, generator=gen, device=dev)
        g = torch.randn(m, N, generator=gen, device=dev).to(torch.bfloat16)
        off = (3 * K * N) & M32
        wm = ref.sample_mask(s, 99, off).to(torch.bfloat16) * w
        for kname, kern, plain, lib, nb in (
                ("masked_matmul_fwd",
                 lambda: mm.masked_matmul(x, w, s, 99, off),
                 lambda: ref.masked_matmul(x, w, s, 99, off),
                 lambda: x @ wm, 2 * m * K + 6 * K * N + 2 * m * N),
                ("masked_matmul_dx",
                 lambda: mm.masked_matmul_dx(g, w, s, 99, off),
                 lambda: ref.masked_matmul_dx(g, w, s, 99, off),
                 lambda: g @ wm.T, 2 * m * N + 6 * K * N + 2 * m * K)):
            got, want = kern().float(), plain().float()
            d = (got - want).abs()
            # f32 sums in another order, then a bf16 cast: one bf16 ulp
            check(bool((d <= BF16_RTOL * want.abs()
                        + 1e-4 * want.abs().max()).all()),
                  f"{kname} {label} M={m}: max |diff| {float(d.max())}")
            keep(kname, label, float(d.max()), kern, plain, lib,
                 (nb, 2 * m * K * N))
            del got, want, d
        got, want = mm.masked_matmul_ds(x, g, w, s), \
            ref.masked_matmul_ds(x, g, w, s)
        check(bool(torch.allclose(got, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max()))),
              f"masked_matmul_ds {label} M={m}: max |diff| "
              f"{float((got - want).abs().max())}")
        keep("masked_matmul_ds", label, float((got - want).abs().max()),
             lambda: mm.masked_matmul_ds(x, g, w, s),
             lambda: ref.masked_matmul_ds(x, g, w, s), lambda: x.T @ g,
             (2 * m * K + 2 * m * N + 10 * K * N, 2 * m * K * N))
        del x, w, s, g, wm, got, want
        torch.cuda.empty_cache()

    for label, E, m, K, N in ZOO_GROUPED:
        x = torch.randn(E, m, K, generator=gen, device=dev)
        w = torch.randn(E, K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(E, K, N, generator=gen, device=dev)
        g = torch.randn(E, m, N, generator=gen, device=dev)
        seeds = [0x5EED0000 + e for e in range(E)]
        offs = [((E + e) * K * N) & M32 for e in range(E)]
        wm = ref.grouped_mask(s, seeds, offs).to(torch.bfloat16) * w
        for kname, kern, plain, lib, terms, nb, parts in (
                ("masked_matmul_grouped",
                 lambda: mm.masked_matmul_grouped(x, w, s, seeds, offs),
                 lambda: ref.masked_matmul_grouped(x, w, s, seeds, offs),
                 lambda: torch.bmm(x, wm.float()),
                 lambda: ref.masked_matmul_grouped(x.abs(), w.abs(), s,
                                                   seeds, offs),
                 4 * E * m * K + 6 * E * K * N + 4 * E * m * N, 3),
                ("masked_matmul_grouped_dx",
                 lambda: mm.masked_matmul_grouped_dx(g, w, s, seeds, offs),
                 lambda: ref.masked_matmul_grouped_dx(g, w, s, seeds, offs),
                 lambda: torch.bmm(g, wm.float().transpose(1, 2)),
                 lambda: ref.masked_matmul_grouped_dx(g.abs(), w.abs(), s,
                                                      seeds, offs),
                 4 * E * m * N + 6 * E * K * N + 4 * E * m * K, 3),
                ("masked_matmul_grouped_ds",
                 lambda: mm.masked_matmul_grouped_ds(x, g, w, s),
                 lambda: ref.masked_matmul_grouped_ds(x, g, w, s),
                 lambda: torch.bmm(x.transpose(1, 2), g),
                 lambda: ref.masked_matmul_grouped_ds(x.abs(), g.abs(),
                                                      w.abs(), s),
                 4 * E * m * K + 4 * E * m * N + 10 * E * K * N, 6)):
            got, want, bnd = kern(), plain(), terms()
            d = (got - want).abs()
            rel = float((d / bnd.clamp_min(1e-30)).max())
            # f32 sums of up to 5120 terms in another order, held per
            # element to 1e-5 of the sum of the terms' magnitudes (an f32
            # sum of n terms in any order is within n * 2**-24 of it)
            check(bool((d <= 1e-5 * bnd).all()),
                  f"{kname} {label} E={E} M={m}: max |diff| "
                  f"{float(d.max())}, {rel:.3g} of the terms' magnitude")
            print(f"  {kname} {label}: max |diff| {float(d.max()):.4g} at "
                  f"scale {float(want.abs().max()):.4g}, {rel:.3g} of the "
                  f"terms' magnitude")
            keep(kname, label, float(d.max()), kern, plain, lib,
                 (nb, parts * 2 * E * m * K * N))
            del got, want, bnd, d
        del x, w, s, g, wm
        torch.cuda.empty_cache()
    print("zoo kernel shapes: kernels 1-3 and 5-7 agree with their plain "
          "versions at " + "; ".join(
              f"{l} M={m} K={K} N={N}" for l, m, K, N in ZOO_DENSE) + "; "
          + "; ".join(f"{l} E={E} M={m} K={K} N={N}"
                      for l, E, m, K, N in ZOO_GROUPED)
          + f"; max abs err {json.dumps(err)}")
    torch.cuda.synchronize()
    return err, rows


def close_within(a, b, rtol, share, what):
    """|a - b| within `rtol` of the plain version's value b plus `share`
    of its largest magnitude, elementwise; returns the max |diff|."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    check(bool((d <= rtol * b.abs() + share * b.abs().max()).all()),
          f"{what}: max |diff| {float(d.max())}")
    return float(d.max())


def bf16_ds_close(torch, got, want, what, share=1e-5):
    """A bf16 ds within one bf16 ulp of the plain version's value (2**-7
    of it bounds the ulp of any bf16 value; near zero, `share` of the
    largest: the f32 phases' share of the scale)."""
    check(got.dtype == torch.bfloat16, f"{what}: ds in {got.dtype}, not "
          f"bf16")
    return close_within(got, want, BF16_RTOL, share, what)


def no_f32_copy(torch, fn, s, what, allocs=None):
    """fn() under a watch of the allocator: a launch may allocate its
    output, never an f32 copy of the scores s.  The peak of allocated
    bytes must grow by less than that copy's size; or, where `allocs` is
    given (the conv kernels, whose (W, C) scores are far smaller than
    their output and than the caching allocator's slack on a block),
    the launch must make exactly `allocs` allocations (its outputs).
    Returns (fn(), bytes the peak grew by)."""
    count = lambda: torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.synchronize()
    base, made = torch.cuda.memory_allocated(), count()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    grew, made = torch.cuda.max_memory_allocated() - base, count() - made
    if allocs is None:
        check(grew < 4 * s.numel(), f"{what}: the launch allocated {grew} "
              f"bytes, an f32 copy of the scores is {4 * s.numel()}")
    else:
        check(made == allocs, f"{what}: the launch made {made} allocations "
              f"({grew} bytes), its outputs are {allocs}")
    return out, grew


# bf16 scores through kernels 1-4 (`score_dtype=torch.bfloat16`): the
# shapes they are held and timed at, (label, M, K, N), and f32
# activations at recurrentgemma's gate shape (the SIMT bodies of kernels
# 1-2 and kernel 3's f32 body on bf16 scores)
BF16_DENSE = (("qwen2-7b w_up", M, 3584, 18944),
              ("ragged", RAGGED[0], RAGGED[1], RAGGED[2]))
BF16_F32X = ("rg gate f32 x", M, 4096, 4096)
# kernel 4 on bf16 rows: n % 8 == 0 (the vector path), n % 8 == 4 and a
# ragged n (the scalar path), and qwen2-7b's widest layer block
BF16_SAP_LENS = (100_008, 100_004, 100_003, 3584 * 18944)


# bf16 scores through kernels 5-9: the grouped kernels at deepseek-v2-lite's
# expert shapes (E = 64 experts at the capacity M = 30), at
# deepseek-v2-236b's w_up (160 experts at M = 12) and the ragged cell
# (w's and s's rows off the 16-byte grid: the element loads); the conv
# kernels at mamba2's and recurrentgemma's widths (B 2, S 128), a ragged
# shape and one of C % 4 != 0 (the element path)
BF16_GROUPED = ([(N_EXPERTS, CAP, K, N)
                 for K, N in sorted(set(EXPERT_SHAPES.values()))]
                + [ZOO_GROUPED[0][1:], GROUPED_RAGGED])
# kernels 5-6 held there as `zoo_kernel_phase` holds them
WIDE = {ZOO_GROUPED[0][1:]}
BF16_CONV = ([(CONV_B, CONV_S, C) for C in CONV_SHAPES.values()]
             + [CONV_RAGGED, CONV_ODD])


def bf16_grouped_conv_checks(torch, mm, ref, dev, gen, err):
    """Kernels 5-9 on bf16 score blocks against their plain versions
    (which widen each score to f32 exactly), both mask modes at a
    non-zero stream offset (layer 2's for the experts, mamba2's last
    layer's for the convs): the masks by identity probes (exactly, up to
    flips on the sigmoid's boundary as `mask_exact` allows; the conv's
    exactly); kernels 5-6 within their f32 phases' bounds (1e-5 of each
    value and of the scale; at deepseek-v2-236b's 5120-term sums 1e-5 of
    the terms' magnitude); kernel 8 forward and flipped bit for bit;
    kernels 7 and 9's bf16 ds within one bf16 ulp of the plain
    version's plus 1e-5 of the scale, the same bits on a repeated launch;
    kernel 9's "dw" correlation in f32 within 1e-5; no launch raises the
    allocated peak by an f32 copy of its scores.  Updates `err`."""
    bf = torch.bfloat16
    for E, m, K, N in BF16_GROUPED:
        x = torch.randn(E, m, K, generator=gen, device=dev)
        g = torch.randn(E, m, N, generator=gen, device=dev)
        w = torch.randn(E, K, N, generator=gen, device=dev).to(bf)
        s = (2 * torch.randn(E, K, N, generator=gen, device=dev)).to(bf)
        seeds = [0x5EED0000 + e for e in range(E)]
        offs = [((2 * E + e) * K * N) & M32 for e in range(E)]
        tag = f"bf16 s E={E} M={m} K={K} N={N}"
        for mode in ("sample", "threshold"):
            kw = dict(mode=mode, tau=0.45)
            for name, kern, plain, a in (
                    ("masked_matmul_grouped", mm.masked_matmul_grouped,
                     ref.masked_matmul_grouped, x),
                    ("masked_matmul_grouped_dx", mm.masked_matmul_grouped_dx,
                     ref.masked_matmul_grouped_dx, g)):
                what = f"{name} {tag} {mode}"
                got, _ = no_f32_copy(
                    torch, lambda: kern(a, w, s, seeds, offs, **kw), s, what)
                want = plain(a, w, s, seeds, offs, **kw)
                if (E, m, K, N) in WIDE:
                    # the bound of their f32 phase at this shape
                    # (`zoo_kernel_phase`): 1e-5 of the sum of the terms'
                    # magnitudes, for sums over up to 5120 terms
                    d = (got - want).abs()
                    terms = plain(a.abs(), w.abs(), s, seeds, offs, **kw)
                    check(bool((d <= 1e-5 * terms).all()), f"{what}: max "
                          f"|diff| {float(d.max())}, "
                          f"{float((d / terms.clamp_min(1e-30)).max()):.3g} "
                          f"of the terms' magnitude")
                    err[name] = max(err.get(name, 0.0), float(d.max()))
                    del d, terms
                else:
                    err[name] = max(err.get(name, 0.0), close_within(
                        got, want, 1e-5, 1e-5, what))
                del got, want
            # identity probes read every group's mask back exactly in f32
            r = min(m, K, N)
            mask = ref.grouped_mask(s, seeds, offs, mode=mode, tau=0.45)
            wm = mask.float() * w.float()
            del mask
            theta = torch.sigmoid(s.float())
            u = (torch.stack([ref.hash_uniform(ref.flat_index(
                K, N, offs[e], N, dev), seeds[e]) for e in range(E)])
                 if mode == "sample" else torch.full(s.shape, 0.45,
                                                     device=dev))
            px = torch.zeros(E, r, K, device=dev)
            px[:, :, :r] = torch.eye(r, device=dev)
            y = mm.masked_matmul_grouped(px, w, s, seeds, offs, **kw)
            n_f = mask_exact(torch, y != 0, wm[:, :r] != 0, u[:, :r],
                             theta[:, :r], f"grouped fwd probe {tag} {mode}")
            check(n_f or torch.equal(y, wm[:, :r]),
                  f"grouped fwd probe values {tag} {mode}")
            pg = torch.zeros(E, r, N, device=dev)
            pg[:, :, :r] = torch.eye(r, device=dev)
            dx = mm.masked_matmul_grouped_dx(pg, w, s, seeds, offs, **kw)
            wt = wm[:, :, :r].transpose(1, 2)
            n_d = mask_exact(torch, dx != 0, wt != 0,
                             u[:, :, :r].transpose(1, 2),
                             theta[:, :, :r].transpose(1, 2),
                             f"grouped dx probe {tag} {mode}")
            check(n_d or torch.equal(dx, wt),
                  f"grouped dx probe values {tag} {mode}")
            del wm, theta, u, px, y, pg, dx, wt
            torch.cuda.empty_cache()
        ds, grew = no_f32_copy(
            torch, lambda: mm.masked_matmul_grouped_ds(x, g, w, s), s,
            f"grouped ds {tag}")
        err["masked_matmul_grouped_ds"] = max(
            err.get("masked_matmul_grouped_ds", 0.0),
            bf16_ds_close(torch, ds, ref.masked_matmul_grouped_ds(x, g, w, s),
                          f"grouped ds {tag}"))
        check(torch.equal(ds, mm.masked_matmul_grouped_ds(x, g, w, s)),
              f"grouped ds {tag}: a repeated launch gives other bits")
        print(f"  {tag}: kernels 5-7 agree; ds's launch added "
              f"{grew / 2**20:.1f} MiB (an f32 copy of s: "
              f"{4 * s.numel() / 2**20:.1f})")
        del x, g, w, s, ds
        torch.cuda.empty_cache()

    W = CONV_W
    for B, S, C in BF16_CONV:
        x = torch.randn(B, S, C, generator=gen, device=dev).to(bf)
        g = torch.randn(B, S, C, generator=gen, device=dev)
        w = torch.randn(W, C, generator=gen, device=dev).to(bf)
        s = (2 * torch.randn(W, C, generator=gen, device=dev)).to(bf)
        off = ((MAMBA_LAYERS - 1) * W * C) & M32
        tag = f"bf16 s conv B={B} S={S} C={C}"
        for mode in ("sample", "threshold"):
            for flip, inp in ((False, x), (True, g)):
                what = f"{tag} {mode} flip={flip}"
                got, _ = no_f32_copy(torch, lambda: mm.masked_conv1d(
                    inp, w, s, 1234, off, mode=mode, tau=0.45, flip=flip), s,
                    what, allocs=1)
                want = ref.masked_conv1d(inp, w, s, 1234, off, mode, 0.45,
                                         flip=flip)
                check(torch.equal(got, want), f"{what}: max |diff| "
                      f"{float((got - want).abs().max())}")
            ones = torch.ones(W, C, dtype=bf, device=dev)
            probe = torch.zeros(1, 2 * W, C, dtype=bf, device=dev)
            probe[0, W - 1] = 1
            y = mm.masked_conv1d(probe, ones, s, 1234, off, mode=mode,
                                 tau=0.45)
            read = torch.stack([y[0, 2 * (W - 1) - t] for t in range(W)])
            mask = ref.conv_weight(ones, s, 1234, off, None, mode, 0.45)
            check(torch.equal(read, mask), f"{tag} probe {mode}: "
                  f"{int((read != mask).sum())} mask bits differ")
        err.setdefault("masked_conv1d", 0.0)   # bit for bit above
        for xin in (x, x.float()):
            what = f"{tag} ds {xin.dtype}"
            ds, _ = no_f32_copy(torch, lambda: mm.masked_conv1d_ds(
                xin, g, w, s), s, what, allocs=1)
            err["masked_conv1d_ds"] = max(
                err.get("masked_conv1d_ds", 0.0),
                bf16_ds_close(torch, ds, ref.masked_conv1d_ds(xin, g, w, s),
                              what))
            check(torch.equal(ds, mm.masked_conv1d_ds(xin, g, w, s)),
                  f"{what}: a repeated launch gives other bits")
            dw = mm.masked_conv1d_ds(xin, g, w, s, epilogue="dw")
            check(dw.dtype == torch.float32, f"{what}: dw in {dw.dtype}")
            close_within(dw, ref.masked_conv1d_ds(xin, g, w, s, "dw"), 1e-5,
                         1e-5, f"{what} dw")
        del x, g, w, s
    torch.cuda.synchronize()
    print(f"bf16 scores: kernels 5-9 agree with their plain versions "
          f"(grouped at {BF16_GROUPED}, conv at {BF16_CONV}), no launch "
          f"allocated an f32 copy of its scores")


def bf16_grouped_conv_timing(torch, mm, ref, dev, rows, layer):
    """Kernels 5-7 per deepseek-v2-lite MoE layer (E = 64, M = 30) and
    kernels 8-9 per mamba2 layer on bf16 scores, timed as
    `grouped_timing_phase` and `conv_timing_phase` time them on f32
    scores, beside the same yardsticks and their bounds at 2 bytes a
    score (and ds).  Fills rows[kernel]["bf16 s layer"] = (ms, plain ms,
    library ms, bound ms) and layer[kernel] = ms."""
    for phase in (grouped_timing_phase, conv_timing_phase):
        res, _ = phase(torch, mm, ref, dev, torch.bfloat16)
        for k, r in res.items():
            layer[k] = r["ms"]
            rows.setdefault(k, {})["bf16 s layer"] = (
                r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"])


def bf16_score_kernel_phase(torch, mm, ref, dev):
    """Kernels 1-9 on bf16 score blocks (no f32 copy of them is made)
    against their plain versions, which widen each score to f32 exactly:
    kernels 1-4 at internlm2's leaf shapes (M = 256), at qwen2-7b's
    3584 x 18944 and a ragged shape, both mask modes at a non-zero stream
    offset, and kernels 1-3 on f32 activations at recurrentgemma's
    4096 x 4096; kernels 5-9 at the MoE and conv shapes of
    `bf16_grouped_conv_checks`.  Masks (identity probes) and packed words
    exactly; kernels 1-2 within the bf16 bound of `kernel_phase`; kernel
    3's bf16 ds within one bf16 ulp of the plain version's (both round an
    f32 value once, and the f32 values differ by the sums' order).  Each
    launch at qwen2-7b's shape (and kernel 4 on a round's rows of its
    block) must raise the peak of allocated memory by less than the
    block's f32 size.  Then the times: kernels 1-3 per internlm2 layer by
    graph replay, kernel 4 per internlm2 round (7 leaves, C = 2) by
    events, kernels 5-9 as `bf16_grouped_conv_timing` times them, each
    beside its bound with 2 bytes a score and its f32-score time.
    Returns ({kernel: max abs err}, {kernel: {label: (ms, plain ms,
    library ms, bound ms)}}, {kernel: bf16-score layer or round ms})."""
    bf = torch.bfloat16
    err, rows, layer = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(25)

    def dense(label, m, K, N, act):
        x = torch.randn(m, K, generator=gen, device=dev).to(act)
        w = torch.randn(K, N, generator=gen, device=dev).to(bf)
        s = (2 * torch.randn(K, N, generator=gen, device=dev)).to(bf)
        g = torch.randn(m, N, generator=gen, device=dev).to(act)
        off = (5 * K * N) & M32
        for mode in ("sample", "threshold"):
            kw = dict(mode=mode, tau=0.45)
            tag = f"bf16 s {label} M={m} {act} {mode}"
            y, grew = no_f32_copy(torch, lambda: mm.masked_matmul(
                x, w, s, 4321, off, **kw), s, "fwd " + tag)
            err["masked_matmul_fwd"] = max(
                err.get("masked_matmul_fwd", 0.0),
                close_within(y, ref.masked_matmul(x, w, s, 4321, off, **kw),
                             BF16_RTOL, 1e-4, "fwd " + tag))
            dx, _ = no_f32_copy(torch, lambda: mm.masked_matmul_dx(
                g, w, s, 4321, off, **kw), s, "dx " + tag)
            err["masked_matmul_dx"] = max(
                err.get("masked_matmul_dx", 0.0),
                close_within(dx, ref.masked_matmul_dx(g, w, s, 4321, off,
                                                      **kw),
                             BF16_RTOL, 1e-4, "dx " + tag))
            del y, dx
            # the masks by identity probes, against the upcast's sigmoid
            r = min(m, K, N)
            mask = (ref.threshold_mask(s, 0.45) if mode == "threshold"
                    else ref.sample_mask(s, 4321, off))
            wm = (mask.float() * w.float()).to(act)
            u = (ref.hash_uniform(ref.flat_index(K, N, off, N, dev), 4321)
                 if mode == "sample" else torch.full((K, N), 0.45,
                                                     device=dev))
            theta = torch.sigmoid(s.float())
            px = torch.zeros(r, K, device=dev, dtype=act)
            px[:, :r] = torch.eye(r, device=dev, dtype=act)
            yp = mm.masked_matmul(px, w, s, 4321, off, **kw)
            n_f = mask_exact(torch, yp != 0, wm[:r] != 0, u[:r], theta[:r],
                             "fwd probe " + tag)
            check(n_f or torch.equal(yp, wm[:r]), "fwd probe values " + tag)
            pg = torch.zeros(r, N, device=dev, dtype=act)
            pg[:, :r] = torch.eye(r, device=dev, dtype=act)
            dp = mm.masked_matmul_dx(pg, w, s, 4321, off, **kw)
            n_d = mask_exact(torch, dp.T != 0, wm[:, :r] != 0, u[:, :r],
                             theta[:, :r], "dx probe " + tag)
            check(n_d or torch.equal(dp.T, wm[:, :r]),
                  "dx probe values " + tag)
            del mask, wm, u, theta, px, yp, pg, dp
        ds, grew = no_f32_copy(torch, lambda: mm.masked_matmul_ds(
            x, g, w, s), s, f"ds bf16 s {label}")
        err["masked_matmul_ds"] = max(
            err.get("masked_matmul_ds", 0.0),
            bf16_ds_close(torch, ds, ref.masked_matmul_ds(x, g, w, s),
                          f"ds bf16 s {label} {act}"))
        print(f"  bf16 scores {label} M={m} {str(act)[6:]} x: kernels 1-3 "
              f"agree; ds's launch added {grew / 2**20:.1f} MiB (an f32 copy "
              f"of s: {4 * K * N / 2**20:.1f})")
        del x, w, s, g, ds
        torch.cuda.empty_cache()

    for (K, N) in sorted(set(LAYER_SHAPES.values())):
        dense(f"{K}x{N}", M, K, N, bf)
    for label, m, K, N in BF16_DENSE:
        dense(label, m, K, N, bf)
    dense(BF16_F32X[0], *BF16_F32X[1:], torch.float32)

    seeds = [0x9E3779B9 * (c + 3) & M32 for c in range(COHORTS)]
    for n in BF16_SAP_LENS + ("misaligned",):
        if n == "misaligned":
            n = 100_008
            s = torch.empty(COHORTS * n + 1, device=dev, dtype=bf)[1:]
            s = s.view(COHORTS, n)
            s.copy_(2 * torch.randn(COHORTS, n, generator=gen, device=dev))
            tag = f"n={n} misaligned"
        else:
            s = (2 * torch.randn(COHORTS, n, generator=gen,
                                 device=dev)).to(bf)
            tag = f"n={n}"
        plan = mm.sap_plan(COHORTS, n, mm.card_sms(dev.index or 0),
                           aligned=s.data_ptr() % 16 == 0, s_bytes=2)
        check(plan["vec"] == (n % 8 == 0 and s.data_ptr() % 16 == 0),
              f"sample_and_pack bf16 {tag}: plan {plan}")
        for mode in ("sample", "threshold"):
            words, grew = no_f32_copy(
                torch, lambda: mm.sample_and_pack(s, seeds, mode=mode,
                                                  tau=0.45), s,
                f"sample_and_pack bf16 {tag}")
            want = ref.sample_and_pack(s, torch.tensor(seeds, device=dev),
                                       mode, 0.45)
            diff = int(ref.popcount32(words ^ want).sum())
            check(diff == 0, f"sample_and_pack bf16 {tag} {mode}: {diff} "
                  f"bits (vector path {plan['vec']})")
            check(torch.equal(words, mm.sample_and_pack(s, seeds, mode=mode,
                                                        tau=0.45)),
                  f"sample_and_pack bf16 {tag} {mode}: a repeated launch "
                  f"gives other words")
            del words, want
        err["sample_and_pack"] = 0.0
        del s
        torch.cuda.empty_cache()
    print("bf16 scores: kernels 1-4 agree with their plain versions "
          f"(internlm2's shapes, {', '.join(l for l, *_ in BF16_DENSE)}, "
          f"{BF16_F32X[0]}; sample_and_pack at n = {BF16_SAP_LENS} and a "
          f"misaligned base), no launch allocated an f32 copy of its "
          f"scores")
    bf16_grouped_conv_checks(torch, mm, ref, dev, gen, err)
    print(f"bf16 scores: max abs err {json.dumps(err)}")

    # times per internlm2 layer (graph replay) beside the f32-score ones
    # of the same call's timing phase, and their bounds at 2 bytes a score
    ops = []
    for name, (K, N) in LAYER_SHAPES.items():
        x = torch.randn(M, K, generator=gen, device=dev).to(bf)
        w = torch.randn(K, N, generator=gen, device=dev).to(bf)
        s = torch.randn(K, N, generator=gen, device=dev).to(bf)
        g = torch.randn(M, N, generator=gen, device=dev).to(bf)
        wm = ref.sample_mask(s, 7, 0).to(bf) * w
        ops.append((name, K, N, x, w, s, g, wm))
    specs = {
        "masked_matmul_fwd": (
            lambda o: (lambda: mm.masked_matmul(o[3], o[4], o[5], 7, 0)),
            lambda o: (lambda: ref.masked_matmul(o[3], o[4], o[5], 7, 0)),
            lambda o: (lambda: o[3] @ o[7]),
            lambda K, N: (2 * M * K + 4 * K * N + 2 * M * N, 2 * M * K * N)),
        "masked_matmul_dx": (
            lambda o: (lambda: mm.masked_matmul_dx(o[6], o[4], o[5], 7, 0)),
            lambda o: (lambda: ref.masked_matmul_dx(o[6], o[4], o[5], 7, 0)),
            lambda o: (lambda: o[6] @ o[7].T),
            lambda K, N: (2 * M * N + 4 * K * N + 2 * M * K, 2 * M * K * N)),
        "masked_matmul_ds": (
            lambda o: (lambda: mm.masked_matmul_ds(o[3], o[6], o[4], o[5])),
            lambda o: (lambda: ref.masked_matmul_ds(o[3], o[6], o[4], o[5])),
            lambda o: (lambda: o[3].T @ o[6]),
            lambda K, N: (2 * M * K + 2 * M * N + 6 * K * N, 2 * M * K * N)),
    }
    for kname, (kern, plain, lib, cost) in specs.items():
        t_k = graph_ms(torch, [kern(o) for o in ops], 20)
        t_l = graph_ms(torch, [lib(o) for o in ops], 20)
        t_p = time_ms(torch, [plain(o) for o in ops], 2)
        b_ms = bound(sum(cost(o[1], o[2])[0] for o in ops),
                     sum(cost(o[1], o[2])[1] for o in ops))[0]
        layer[kname] = sum(t_k)
        rows.setdefault(kname, {})["bf16 s layer"] = (
            sum(t_k), sum(t_p), sum(t_l), b_ms)
        print(f"  {kname} bf16 scores per internlm2 layer: {sum(t_k):.4f} "
              f"ms (graph replay), library {sum(t_l):.4f}, bound "
              f"{b_ms:.4f}: {100 * b_ms / sum(t_k):.1f}% of the bound")
    del ops
    torch.cuda.empty_cache()
    t_k, t_p, nbytes = 0.0, 0.0, 0
    for name, (K, N) in LAYER_SHAPES.items():
        n = N_LAYERS * K * N
        s = torch.randn(COHORTS, n, generator=gen, device=dev).to(bf)
        t_k += time_ms(torch, [lambda: mm.sample_and_pack(s, [11, 12])], 5)[0]
        sd = torch.tensor([11, 12], device=dev)
        t_p += time_ms(torch, [lambda: ref.sample_and_pack(s, sd)], 1)[0]
        nbytes += COHORTS * n * 2 + COHORTS * ((n + 31) // 32) * 4
        del s
        torch.cuda.empty_cache()
    b_ms = bound(nbytes, 0)[0]
    layer["sample_and_pack"] = t_k
    rows["sample_and_pack"] = {"bf16 s round": (t_k, t_p, None, b_ms)}
    print(f"  sample_and_pack bf16 scores per internlm2 round (C = "
          f"{COHORTS}): {t_k:.4f} ms, bound {b_ms:.4f}: "
          f"{100 * b_ms / t_k:.1f}% of the bound")
    bf16_grouped_conv_timing(torch, mm, ref, dev, rows, layer)
    torch.cuda.synchronize()
    return err, rows, layer


def conv_kernel_phase(torch, mm, ref, dev):
    """Conv kernels vs plain versions at the mamba2 and recurrentgemma
    conv shapes with the last layer's stream offset, at a ragged shape
    and at one of C % 4 != 0 (kernels 8-9's element path): masked_conv1d in all three modes, forward (bf16 x) and
    flipped (f32 g), bit for bit (the same separately rounded products
    in the same order); masks exactly by an identity probe; ds with both
    epilogues and bf16 or f32 x within float32 rounding, and the same
    bits on a repeated launch (the cluster's partials are summed in rank
    order).  Then kernels
    1-3 on the f32 activations of recurrentgemma's gate projections
    (M = 256, K = N = 4096).  Returns {kernel: max_abs_err}."""
    err = {"masked_conv1d": 0.0, "masked_conv1d_ds": 0.0,
           "masked_matmul_fwd": 0.0, "masked_matmul_dx": 0.0,
           "masked_matmul_ds": 0.0}
    gen = torch.Generator(device=dev).manual_seed(5)
    W = CONV_W
    shapes = [(CONV_B, CONV_S, C) for C in CONV_SHAPES.values()]
    for (B, S, C) in shapes + [CONV_RAGGED, CONV_ODD]:
        x = torch.randn(B, S, C, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(B, S, C, generator=gen, device=dev)
        w = torch.randn(W, C, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(W, C, generator=gen, device=dev)
        off = ((MAMBA_LAYERS - 1) * W * C) & M32
        for mode in ("sample", "threshold", "plain"):
            for flip, inp in ((False, x), (True, g)):
                tag = f"conv B={B} S={S} C={C} {mode} flip={flip}"
                got = mm.masked_conv1d(inp, w, s, 1234, off, mode=mode,
                                       tau=0.45, flip=flip)
                want = ref.masked_conv1d(inp, w, s, 1234, off, mode, 0.45,
                                         flip=flip)
                d = float((got - want).abs().max())
                check(torch.equal(got, want), f"{tag}: max |diff| {d}")
                err["masked_conv1d"] = max(err["masked_conv1d"], d)
            if mode == "plain":
                continue
            # identity probe: w = 1 and a one-hot in time read tap t's
            # mask bit at time 2(W-1) - t of every channel
            ones = torch.ones(W, C, dtype=torch.bfloat16, device=dev)
            probe = torch.zeros(1, 2 * W, C, dtype=torch.bfloat16,
                                device=dev)
            probe[0, W - 1] = 1
            y = mm.masked_conv1d(probe, ones, s, 1234, off, mode=mode,
                                 tau=0.45)
            read = torch.stack([y[0, 2 * (W - 1) - t] for t in range(W)])
            mask = ref.conv_weight(ones, s, 1234, off, None, mode, 0.45)
            check(torch.equal(read, mask), f"conv probe C={C} {mode}: "
                  f"{int((read != mask).sum())} mask bits differ")
        for xin in (x, x.float()):
            for epi in ("ste", "dw"):
                ds = mm.masked_conv1d_ds(xin, g, w, s, epilogue=epi)
                want = ref.masked_conv1d_ds(xin, g, w, s, epi)
                d = float((ds - want).abs().max())
                # f32 sums over B*S terms in another order
                check(bool(torch.allclose(ds, want, rtol=1e-5, atol=1e-5
                                          * float(want.abs().max()))),
                      f"conv ds C={C} {epi} {xin.dtype}: max |diff| {d}")
                check(torch.equal(ds, mm.masked_conv1d_ds(xin, g, w, s,
                                                          epilogue=epi)),
                      f"conv ds C={C} {epi} {xin.dtype}: a repeated launch "
                      f"gives other bits")
                err["masked_conv1d_ds"] = max(err["masked_conv1d_ds"], d)
        del x, g, w, s
    # kernels 1-3 on f32 activations (recurrentgemma's w_rg, w_ri)
    K = N = CONV_SHAPES["recurrentgemma-9b"]
    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
    s = 2 * torch.randn(K, N, generator=gen, device=dev)
    g = torch.randn(M, N, generator=gen, device=dev)
    off = (7 * K * N) & M32
    for mode in ("sample", "threshold"):
        kw = dict(mode=mode, tau=0.45)
        for name, got, want in (
                ("masked_matmul_fwd", mm.masked_matmul(x, w, s, 99, off, **kw),
                 ref.masked_matmul(x, w, s, 99, off, **kw)),
                ("masked_matmul_dx",
                 mm.masked_matmul_dx(g, w, s, 99, off, **kw),
                 ref.masked_matmul_dx(g, w, s, 99, off, **kw)),
                ("masked_matmul_ds", mm.masked_matmul_ds(x, g, w, s),
                 ref.masked_matmul_ds(x, g, w, s))):
            d = float((got - want).abs().max())
            check(got.dtype == torch.float32 and bool(torch.allclose(
                got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))),
                f"{name} f32 {mode}: max |diff| {d}")
            err[name] = max(err[name], d)
    del x, w, s, g
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return err


def conv_timing_phase(torch, mm, ref, dev, score_dtype=None):
    """Per-recurrent-layer (one cohort) times of the conv kernels at
    mamba2-370m's C = 2304 (kernel 8: the forward on bf16 x and the
    flipped pass on the f32 cotangent; kernel 9: the STE ds), and at
    recurrentgemma-9b's C = 4096: kernel, plain version and the library
    yardstick (torch.nn.functional.conv1d, groups = C, on the pre-masked
    f32 kernel and an f32 input laid out (B, C, S) and padded
    beforehand; torch.nn.grad.conv1d_weight for kernel 9's correlation),
    in ms, with their bounds (f32 arithmetic: flops over the f32 peak).
    Kernel and library run a few microseconds each, so they are timed by
    CUDA-graph replay (`graph_ms`), beside the replay time of an empty
    kernel (`torch.cuda._sleep(0)`: one thread, no work), the floor of
    any kernel timed so; the per-call times with the host's launch cost
    included (CUDA events around each call) are printed beside them.
    The scores (and kernel 9's ds) are `score_dtype`: f32 by default, or
    bf16, counted at their bytes in the bound."""
    F = torch.nn.functional
    sd = score_dtype or torch.float32
    sb = torch.empty((), dtype=sd).element_size()
    gen = torch.Generator(device=dev).manual_seed(6)
    W, B, S = CONV_W, CONV_B, CONV_S
    res, per_shape = {}, {"masked_conv1d": {}, "masked_conv1d_ds": {}}
    for arch, C in CONV_SHAPES.items():
        x = torch.randn(B, S, C, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(B, S, C, generator=gen, device=dev)
        w = torch.randn(W, C, generator=gen, device=dev).to(torch.bfloat16)
        s = torch.randn(W, C, generator=gen, device=dev).to(sd)
        wm = ref.conv_weight(w, s, 7, 0)                       # (W, C) f32
        wk = wm.T.contiguous()[:, None, :]                     # (C, 1, W)
        wk_flip = wm.flip(0).T.contiguous()[:, None, :]
        xt = F.pad(x.float().transpose(1, 2), (W - 1, 0)).contiguous()
        gt = F.pad(g.transpose(1, 2), (0, W - 1)).contiguous()
        g_cs = g.transpose(1, 2).contiguous()
        kern = [lambda: mm.masked_conv1d(x, w, s, 7, 0),
                lambda: mm.masked_conv1d(g, w, s, 7, 0, flip=True),
                lambda: mm.masked_conv1d_ds(x, g, w, s)]
        lib = [lambda: F.conv1d(xt, wk, groups=C),
               lambda: F.conv1d(gt, wk_flip, groups=C),
               lambda: torch.nn.grad.conv1d_weight(xt, (C, 1, W), g_cs,
                                                   groups=C)]
        t_k = graph_ms(torch, kern, 50)
        t_l = graph_ms(torch, lib, 50)
        t_p = time_ms(torch, [
            lambda: ref.masked_conv1d(x, w, s, 7, 0),
            lambda: ref.masked_conv1d(g, w, s, 7, 0, flip=True),
            lambda: ref.masked_conv1d_ds(x, g, w, s)], 5)
        t_call = time_ms(torch, kern + lib, 20)
        t_empty = graph_ms(torch, [lambda: torch.cuda._sleep(0)], 50)[0]
        plan = mm.conv_ds_plan(B, S, C)
        fplan = mm.conv_plan(B, S, C)
        print(f"  conv {arch} C={C} plan: fwd/flip {fplan['grid'][0]} row "
              f"blocks x {fplan['grid'][1]} channel tiles of "
              f"{fplan['threads']} threads, {fplan['chunks']} chunks")
        print(f"  conv {arch} C={C} {str(sd)[6:]} scores by graph replay, "
              f"ms: kernel fwd/flip/ds "
              f"{' '.join(f'{t:.4f}' for t in t_k)}; library "
              f"{' '.join(f'{t:.4f}' for t in t_l)}; an empty kernel "
              f"{t_empty:.4f}.  Per call with launch cost (events): kernel "
              f"{' '.join(f'{t:.4f}' for t in t_call[:3])}; library "
              f"{' '.join(f'{t:.4f}' for t in t_call[3:])}.  ds plan: "
              f"cluster {plan['cluster']} x {plan['grid'][1]} channel "
              f"tiles, {plan['threads']} threads, {plan['chunks']} chunks")
        n = B * S * C
        # bytes: each input read once, each output written once
        ws = (2 + sb) * W * C                              # w and s
        costs = ((2 * n + ws + 4 * n, 2 * W * n),          # bf16 x -> f32 y
                 (4 * n + ws + 4 * n, 2 * W * n),          # f32 g -> f32 dx
                 (2 * n + 4 * n + ws + sb * W * C, 2 * W * n))  # -> ds
        for name, lo, hi in (("masked_conv1d", 0, 2),
                             ("masked_conv1d_ds", 2, 3)):
            nbytes = sum(c[0] for c in costs[lo:hi])
            flops = sum(c[1] for c in costs[lo:hi])
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            row = dict(ms=sum(t_k[lo:hi]), plain_ms=sum(t_p[lo:hi]),
                       library_ms=sum(t_l[lo:hi]), bound_ms=b_ms,
                       bound_by=b_by)
            per_shape[name][f"{arch} C={C}"] = (
                row["ms"], row["plain_ms"], row["library_ms"], b_ms)
            if arch == "mamba2-370m":
                res[name] = row
        del x, g, w, s, wm, wk, wk_flip, xt, gt, g_cs
    torch.cuda.empty_cache()
    return res, per_shape


def bitpack_kernel_phase(torch, bp, dev):
    """The bit-packing kernels against their plain versions, bit for bit
    (torch.equal): internlm2's largest leaf as one row (the artifact's
    pack and unpack), a round's 2 cohort rows of it (the round mean's
    unpack), a ragged row length whose row starts are off the 16-byte
    grid, a misaligned view, padding bits set in the words, and pack ->
    unpack.  Returns {kernel: max_abs_err} (0 when equal)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    n_big = N_LAYERS * max(K * N for K, N in LAYER_SHAPES.values())
    for R, n in ((1, n_big), (COHORTS, n_big), BITPACK_RAGGED):
        bits = (torch.rand(R, n, generator=gen, device=dev) < 0.3).to(
            torch.uint8)
        rows = bits[0] if R == 1 else bits
        words = bp.pack_bits(rows)
        check(torch.equal(words, bp.pack_bits_plain(rows)),
              f"pack_bits R={R} n={n}: words differ from the plain version")
        back = bp.unpack_bits(words, n)
        check(torch.equal(back, rows), f"unpack_bits R={R} n={n}: the "
              f"round trip does not give the bits back")
        noisy = torch.randint(-2**31, 2**31, words.shape, generator=gen,
                              device=dev, dtype=torch.int64).to(torch.int32)
        check(torch.equal(bp.unpack_bits(noisy, n),
                          bp.unpack_bits_plain(noisy, n)),
              f"unpack_bits R={R} n={n}: bits differ from the plain version")
        del bits, rows, words, back, noisy
        torch.cuda.empty_cache()
    buf = (torch.rand(2 * 4096 + 3, generator=gen, device=dev) < 0.5).to(
        torch.uint8)
    view = buf[3:].view(2, 4096)
    check(torch.equal(bp.pack_bits(view), bp.pack_bits_plain(view)),
          "pack_bits on a misaligned view")
    torch.cuda.synchronize()
    return {"pack_bits": 0.0, "unpack_bits": 0.0}


def bitpack_timing_phase(torch, bp, dev):
    """Times of the bit-packing kernels at the internlm2 leaves: pack per
    artifact (7 leaves, one row each) and unpack per round (7 leaves, 2
    cohort rows), kernel and plain version, with their bounds (bytes: n
    bits as bytes one way, n/8 the other; no library call packs bits)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    res, per_shape = {}, {"pack_bits": {}, "unpack_bits": {}}
    tot = {k: [0.0, 0.0, 0] for k in per_shape}
    for name, (K, N) in LAYER_SHAPES.items():
        n = N_LAYERS * K * N
        bits = (torch.rand(n, generator=gen, device=dev) < 0.5).to(
            torch.uint8)
        words = torch.randint(-2**31, 2**31, (COHORTS, n // 32),
                              generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        for kname, kern, plain, R in (
                ("pack_bits", lambda: bp.pack_bits(bits),
                 lambda: bp.pack_bits_plain(bits), 1),
                ("unpack_bits", lambda: bp.unpack_bits(words, n),
                 lambda: bp.unpack_bits_plain(words, n), COHORTS)):
            tk = time_ms(torch, [kern], 10)[0]
            tp = time_ms(torch, [plain], 2)[0]
            nb = R * (n + n // 8)
            per_shape[kname][name] = (tk, tp, None, bound(nb, 0)[0])
            t = tot[kname]
            t[0], t[1], t[2] = t[0] + tk, t[1] + tp, t[2] + nb
        del bits, words
        torch.cuda.empty_cache()
    for kname, (tk, tp, nb) in tot.items():
        b_ms, b_by = bound(nb, 0)
        res[kname] = dict(ms=tk, plain_ms=tp, library_ms=None, bound_ms=b_ms,
                          bound_by=b_by)
    return res, per_shape


def smoke_states(torch, arch, devices, f32=False, over=None,
                 score_dtype=None, microbatch=1):
    """The SMOKE model of `arch` (its config fields replaced by `over`),
    the step config of the smoke reference (`microbatch` chunks), one
    fed state per device (all from one CPU init, scores and moments of
    `score_dtype`, f32 by default), and the tokens of its train step.
    `f32`: the float leaves (embedding, norm scales, biases) cast to f32,
    so that every activation is f32 (the masked weights stay bf16, as
    the kernels take them)."""
    from repro_torch.configs import get_config
    from repro_torch.core import masking, tree
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    api = build_model(dataclasses.replace(get_config(arch, smoke=True),
                                          **(over or {})))
    cfg = steps.StepConfig(lam=1.0, lr=0.3, seed=17, microbatch=microbatch,
                           score_dtype=score_dtype or torch.float32)
    states = []
    for d in devices:
        st = steps.init_fed_state(torch.Generator().manual_seed(3), api,
                                  masking.MaskSpec(), C=COHORTS,
                                  score_dtype=cfg.score_dtype)
        if f32:
            st["floats"] = tree.tree_map(
                lambda t: None if t is None else t.float(), st["floats"])
        states.append({k: (v if k == "step" else tree.tree_map(
            lambda t: None if t is None else t.to(d), v))
            for k, v in st.items()})
    toks = torch.randint(0, 256, (COHORTS, 2, 32),
                         generator=torch.Generator().manual_seed(4))
    return api, cfg, states, toks


def smoke_extra(torch, api, f32=False):
    """The non-token inputs of a SMOKE train step, (C, 2, ...) on the
    CPU: 4 stub patch embeddings a sequence for the VLM, stub frames for
    the encoder-decoder (0.1 * normal, bf16, or f32 with `f32`), nothing
    for the other families."""
    gen = torch.Generator().manual_seed(6)
    shape = {"vlm": ("vis_embeds", 4),
             "encdec": ("frames", api.cfg.enc_seq)}.get(api.cfg.family)
    if shape is None:
        return {}
    key, n = shape
    x = 0.1 * torch.randn(COHORTS, 2, n, api.cfg.d_model, generator=gen)
    return {key: x if f32 else x.to(torch.bfloat16)}


# Bounds of the backward check below, (largest relative norm of the
# difference, smallest cosine) per leaf, for one train step under
# momentum on the card against the same step on the CPU.  They are the
# reference's own rounding spread for such a step.  bf16 activations
# (tests/test_torch_steps.py, `test_two_train_steps_match`): the JAX
# package's jit and eager runs, which round bf16 activations at other
# points, differ per leaf by a relative norm <= 0.13 (cosine >= 0.99),
# and the port is held to <= 0.3 and >= 0.97 against the reference
# there.  The hybrid family (recurrentgemma: gelu MLPs, RG-LRU gates, the
# softmax of its attention block) moves further under bf16 rounding:
# the reference's jit and eager bf16 steps differ per leaf by up to 0.57
# (cosine down to 0.85; tests/test_torch_hybrid.py,
# `test_train_step_matches`), so its bf16 step is held to that spread.
# f32 activations: only the sums' order differs, and the port is held to
# <= 1e-2 and >= 0.9999 against the reference (the same test).  The
# hybrid's f32 step is not run: on an H100 it moves up to 0.036 from the
# CPU's (cosine 0.9994) with or without the kernels (every kernel
# replaced by its plain version reads the same), and its bf16 step
# already runs kernels 1-3 on f32 activations (the RG-LRU gates).
# qwen2-7b (qkv bias): the reference's jit and eager bf16 steps differ
# per leaf by up to 0.187 (cosine down to 0.982), held to twice that;
# qwen2-vl's 0.118 (0.993) lies inside the default.  whisper's bf16 step
# is not held leaf by leaf: the reference's own jit and eager steps
# differ per leaf by a relative norm of up to 3.0 (cosines -0.07 to
# 0.05), so its backward is held on f32 activations only.  (Measured on the
# CPU at the SMOKE configs, the batch of `smoke_states` and
# `smoke_extra`.)
# bf16 scores (internlm2 SMOKE, bf16 activations): the port stores each
# score where the reference's jitted step rounds it (the step's
# `_update_low`), on the card as on the CPU, so the reference's jit and
# eager spread does not bound the score updates; they are held instead
# to about five times the card's own reading against the CPU (relative
# norm 0.001833, cosine 0.999998 on an H100 80GB HBM3 at 700 W), and the
# first moments and float updates, on bf16 activations, to the bf16
# default (read 0.004554 and 0.008449).
# deepseek-v2-lite (MoE) and mamba2 (SSM) on bf16 scores are held to the
# same bounds (read on an H100 80GB HBM3 at 700 W, score update / first
# moment / float update: deepseek-v2-lite 0.006709 / 0.002610 / 0.005280,
# mamba2 0.000906 / 0.004101 / 0.013430).  recurrentgemma (hybrid) on
# bf16 scores: its first moments and float updates are held to its bf16
# spread (0.57, 0.85) (read 0.2789 and 0.2638); its score updates, each
# score's bf16 rounding of a moment that spreads as the hybrid's bf16
# step does, to the reference's own spread for them: the reference's jit
# and eager bf16-score steps differ per leaf by up to 5.19 (cosine down
# to 0.2312) in the score update (read 1.721, cosine 0.3747), and by up
# to 0.604 (0.806) in the first moment (measured on the CPU at the SMOKE
# config and the batch of `smoke_states`: `python
# tests/test_torch_bf16_scores_conv.py`).
BACKWARD_BOUNDS = {"bf16": (0.3, 0.97), "bf16 hybrid": (0.57, 0.85),
                   "bf16 qwen2": (0.375, 0.964), "f32": (1e-2, 0.9999),
                   "bf16 scores": {"score update": (1e-2, 0.999),
                                   "first moment": (0.3, 0.97),
                                   "float update": (0.3, 0.97)},
                   "bf16 scores hybrid": {"score update": (5.2, 0.23),
                                          "first moment": (0.57, 0.85),
                                          "float update": (0.57, 0.85)}}
F32_BACKWARD = ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
                "qwen2-7b", "qwen2-vl-2b", "whisper-medium")


def backward_bounds(arch, f32):
    """(largest relative norm, smallest cosine) of `arch`'s backward check,
    None where it is not held (whisper at bf16)."""
    if f32:
        return BACKWARD_BOUNDS["f32"]
    if arch == "whisper-medium":
        return None
    key = {"recurrentgemma-9b": "bf16 hybrid", "qwen2-7b": "bf16 qwen2"}
    return BACKWARD_BOUNDS[key.get(arch, "bf16")]


def first_step_updates(api, cfg, state, tokens, extra=None):
    """One train step of `state` (updated in place) on `tokens` and the
    batch's other inputs `extra` ({key: (C, B, ...)}); returns its loss
    and {kind: [(path, tensor)]} on the CPU in f32: each score leaf's
    update s1 - s0, its first moment opt_m (under momentum from zero: the
    step's gradient, regularizer included) and each float leaf's
    update."""
    from repro_torch.core import tree
    from repro_torch.launch import steps

    def flat(key):
        # a copy: the step updates the state's tensors in place
        return [(p, t.detach().float().cpu().clone())
                for p, t in tree.flatten_with_paths(state[key])
                if t is not None]

    s0, f0 = flat("scores"), flat("floats")
    dev = next(t for t in tree.leaves(state["scores"]) if t is not None
               ).device
    batch = dict(extra or {}, tokens=tokens)
    batch = {k: v.to(dev) for k, v in batch.items()}
    _, metrics = steps.make_train_step(api, cfg)(state, batch)
    return float(metrics["loss"]), {
        "score update": [(p, t - a) for (p, t), (_, a)
                         in zip(flat("scores"), s0)],
        "first moment": flat("opt_m"),
        "float update": [(p, t - a) for (p, t), (_, a)
                         in zip(flat("floats"), f0)]}


def backward_check(want, got, what, bounds=BACKWARD_BOUNDS["bf16"]):
    """Per leaf of each kind of `first_step_updates`: the relative norm of
    the difference got - want and the cosine between them, held to
    `bounds` (largest relative norm, smallest cosine; a leaf that neither
    run moved agrees; a dict of bounds gives each kind its own).  Raises
    Failed on a miss; returns {kind: (max rel, min cos, leaves
    compared)}."""
    out = {}
    for kind, pairs in want.items():
        max_rel, min_cos = (bounds[kind] if isinstance(bounds, dict)
                            else bounds)
        worst_rel, worst_cos, n = 0.0, 1.0, 0
        for (path, a), (path_b, b) in zip(pairs, got[kind]):
            check(path == path_b and a.shape == b.shape,
                  f"{what} {kind}: leaf {path} against {path_b}")
            a, b = a.double().ravel(), b.double().ravel()
            na, nb = float(a.norm()), float(b.norm())
            if na == 0.0 and nb == 0.0:
                continue
            rel = float((b - a).norm()) / na if na else math.inf
            cos = float(a @ b) / (na * nb) if na and nb else 0.0
            check(rel <= max_rel and cos >= min_cos,
                  f"{what} {kind} {path}: relative norm {rel:.4g}, cosine "
                  f"{cos:.6f} (bounds {max_rel}, {min_cos})")
            worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
            n += 1
        check(len(pairs) == len(got[kind]), f"{what} {kind}: "
              f"{len(pairs)} leaves against {len(got[kind])}")
        out[kind] = (worst_rel, worst_cos, n)
    return out


def smoke_reference_phase(torch, dev, arch):
    """The port's round and train step on the card against the same
    steps on the CPU (plain versions) from one SMOKE state of `arch`:
    the round exactly, the train step's loss, and the train step's
    backward leaf by leaf (`backward_check`, within `backward_bounds`),
    on the config's bf16 activations and, for F32_BACKWARD, again on f32
    ones.  The VLM's step carries 4 patch embeddings a sequence, the
    encoder-decoder's stub frames (`smoke_extra`)."""
    from repro_torch.core import tree
    from repro_torch.launch import steps
    api, cfg, states, toks = smoke_states(torch, arch, ("cpu", dev))
    extra = smoke_extra(torch, api)
    metrics = [steps.make_round_step(api, cfg)(st)[1] for st in states]
    for key in ("bpp", "bits_measured"):
        check(float(metrics[0][key]) == float(metrics[1][key]),
              f"smoke round {key}: cpu {float(metrics[0][key])} "
              f"card {float(metrics[1][key])}")
    for a, b in zip(tree.leaves(states[0]["scores"]),
                    tree.leaves(states[1]["scores"])):
        if a is not None:
            check(torch.equal(torch.sign(a), torch.sign(b.cpu())),
                  "smoke round theta differs between cpu and card")
    losses, updates = zip(*(first_step_updates(api, cfg, st, toks, extra)
                            for st in states))
    # bf16 activations, f32 sums in another order: 0.5% of the loss
    check(abs(losses[0] - losses[1]) <= 5e-3 * abs(losses[0]),
          f"smoke train loss cpu {losses[0]} card {losses[1]}")
    print(f"smoke reference {arch}: round bpp "
          f"{float(metrics[1]['bpp']):.6f} "
          f"bits {float(metrics[1]['bits_measured']):.0f} equal on cpu "
          f"and card; train loss cpu {losses[0]:.6f} card {losses[1]:.6f}")
    for f32 in (False, True) if arch in F32_BACKWARD else (False,):
        if f32:   # the same step again on f32 activations
            api, cfg, states, toks = smoke_states(torch, arch, ("cpu", dev),
                                                  f32=True)
            for st in states:
                steps.make_round_step(api, cfg)(st)
            extra = smoke_extra(torch, api, f32=True)
            updates = [first_step_updates(api, cfg, st, toks, extra)[1]
                       for st in states]
        tag = "f32" if f32 else "bf16"
        bounds = backward_bounds(arch, f32)
        held = bounds is not None
        if not held:   # read, not gated (BACKWARD_BOUNDS)
            bounds = (math.inf, -1.0)
        agree = backward_check(updates[0], updates[1],
                               f"smoke backward {arch} {tag}", bounds)
        print(f"smoke backward {arch} {tag} activations: card vs cpu after "
              f"one train step, worst leaf (relative norm, cosine; "
              + (f"bounds {bounds[0]}, {bounds[1]}" if held else
                 "not gated: the reference's own spread") + "): "
              + "; ".join(
                  f"{kind} ({n} leaves) {rel:.4g}, {cos:.6f}"
                  for kind, (rel, cos, n) in agree.items()))


# The feature phase's SMOKE steps, card against CPU: (arch, smoke_states
# keywords, BACKWARD_BOUNDS key); "score_dtype": "bfloat16" runs the step
# on bf16 scores and moments; block-local MoE dispatch in BLOCK_DISPATCH
# blocks (also the depth-4 path's)
BLOCK_DISPATCH = 4
FEATURE_STEPS = (
    ("internlm2-1.8b", dict(over={"remat": True}, microbatch=2), "bf16"),
    ("internlm2-1.8b", dict(score_dtype="bfloat16"), "bf16 scores"),
    ("deepseek-v2-lite-16b",
     dict(over={"moe_block_dispatch": BLOCK_DISPATCH}), "bf16"),
    ("deepseek-v2-lite-16b", dict(score_dtype="bfloat16"), "bf16 scores"),
    ("mamba2-370m", dict(score_dtype="bfloat16"), "bf16 scores"),
    ("recurrentgemma-9b", dict(score_dtype="bfloat16"),
     "bf16 scores hybrid"))


def feature_backward_phase(torch, dev):
    """`backward_check` of the step features, one SMOKE train step each
    on the card against the same step on the CPU (bf16 activations):
    internlm2 in 2 microbatches with each layer recomputed (`remat`),
    internlm2, deepseek-v2-lite, mamba2 and recurrentgemma on bf16 scores
    and moments (kernels 1-3, 5-7 and 8-9 on bf16 score blocks), and
    deepseek-v2-lite with block-local MoE dispatch (4 blocks of 16
    tokens); the loss within 0.5% and each leaf within its bounds
    (FEATURE_STEPS, BACKWARD_BOUNDS)."""
    for arch, kw, key in FEATURE_STEPS:
        kw = {k: getattr(torch, v) if k == "score_dtype" else v
              for k, v in kw.items()}
        api, cfg, states, toks = smoke_states(torch, arch, ("cpu", dev),
                                              **kw)
        losses, updates = zip(*(first_step_updates(api, cfg, st, toks)
                                for st in states))
        check(abs(losses[0] - losses[1]) <= 5e-3 * abs(losses[0]),
              f"feature step {arch} {kw}: loss cpu {losses[0]} card "
              f"{losses[1]}")
        agree = backward_check(updates[0], updates[1],
                               f"feature backward {arch} {kw}",
                               BACKWARD_BOUNDS[key])
        what = ", ".join(f"{k}={v}" for k, v in kw.items())
        print(f"feature backward {arch} ({what}): loss cpu {losses[0]:.6f} "
              f"card {losses[1]:.6f}; worst leaf (relative norm, cosine; "
              f"bounds {BACKWARD_BOUNDS[key]}): " + "; ".join(
                  f"{kind} ({n} leaves) {rel:.4g}, {cos:.6f}"
                  for kind, (rel, cos, n) in agree.items()))


def _smoke_serving(torch, arch, gen_seed, windowed=False):
    """A SMOKE model of `arch` (gemma3 over ring caches if `windowed`) and
    its MaskedParams on the CPU, from one seeded generator."""
    from repro_torch.configs import get_config
    from repro_torch.core import masking
    from repro_torch.models import build_model
    cfg = get_config(arch, smoke=True)
    if windowed:
        cfg = dataclasses.replace(cfg, window_kv_cache=True)
    api = build_model(cfg)
    gen = torch.Generator().manual_seed(gen_seed)
    return api, masking.init_masked(gen, api.init_params(gen),
                                    masking.MaskSpec())


# the families whose decode the smoke reference phase checks
DECODE_ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
                "recurrentgemma-9b", "gemma3-4b", "qwen2-7b", "qwen2-vl-2b",
                "whisper-medium")


def fill_cross(torch, api, params, cache, frames):
    """Write the cross K/V of an encoder-decoder's decode cache from
    `encode(frames)` (each decoder layer's masked w_k / w_v), in place."""
    from repro_torch.models import encdec
    with torch.no_grad():
        enc = encdec.encode(params, api.cfg, frames)
        for l in range(api.cfg.n_layers):
            k, v = encdec.cross_kv(
                api.cfg, encdec.layer_slice(params["dec_layers"], l), enc)
            cache["ck"][l].copy_(k)
            cache["cv"][l].copy_(v)


def decode_reference_phase(torch, dev):
    """KV-cache and recurrent decode on the card against the CPU at every
    ported family's SMOKE config (one frozen tree, 8 tokens; whisper's
    cross K/V filled from `encode` of stub frames): bf16 products in
    another order, within 3% of the logit scale, the bound the CPU tests
    hold the port to against the JAX package.  gemma3's
    ring caches (`window_kv_cache`) over 24 tokens, a window of 8,
    against its full-cache decode on the card (the reference's 0.05).
    The serving engine's tenant isolation on the card: 3 tenants
    interleaved on 2 slots give logits bit-identical to each tenant
    decoded alone.  Then the lockstep engine against the exact one on
    the card, on the reference's traffic (3 tenants, 6-token prompts, 5
    generated, 2 slots) and every family: tokens equal, logits within
    the reference's atol = rtol = 1e-5."""
    from repro_torch.core import masking, tree
    from repro_torch.runtime.serve_engine import ServeEngine
    for arch in DECODE_ARCHS:
        api, mp = _smoke_serving(torch, arch, 3)
        frozen = masking.freeze_identity(mp, masking.MaskIdentity(seed=11))
        toks = torch.randint(0, api.cfg.vocab, (2, 8),
                             generator=torch.Generator().manual_seed(4))
        err, scale = 0.0, 0.0
        trees = {d: tree.tree_map(lambda t: None if t is None else t.to(d),
                                  frozen) for d in ("cpu", dev)}
        caches = {d: api.init_cache(2, 8, d) for d in ("cpu", dev)}
        if api.cfg.family == "encdec":
            frames = (0.1 * torch.randn(
                2, api.cfg.enc_seq, api.cfg.d_model,
                generator=torch.Generator().manual_seed(7))).bfloat16()
            for d in ("cpu", dev):
                fill_cross(torch, api, trees[d], caches[d], frames.to(d))
        for t in range(8):
            out = {}
            for d in ("cpu", dev):
                out[d], caches[d] = api.decode_step(
                    trees[d], caches[d], toks[:, t].to(d), t)
            err = max(err, float((out[dev].cpu() - out["cpu"]).abs().max()))
            scale = max(scale, float(out["cpu"].abs().max()))
        check(err <= 0.03 * scale, f"decode {arch}: card vs cpu max |diff| "
              f"{err} at logit scale {scale}")
        print(f"decode reference {arch}: 8 tokens, card vs cpu max |diff| "
              f"{err:.3g} at logit scale {scale:.3g}")

    full, mp = _smoke_serving(torch, "gemma3-4b", 5)
    ring, _ = _smoke_serving(torch, "gemma3-4b", 5, windowed=True)
    params = tree.tree_map(lambda t: None if t is None else t.to(dev),
                           masking.freeze_identity(
                               mp, masking.MaskIdentity(seed=2)))
    S = 24
    toks = torch.randint(0, full.cfg.vocab, (2, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    c1, c2 = full.init_cache(2, S, dev), ring.init_cache(2, S, dev)
    err = 0.0
    for t in range(S):
        l1, c1 = full.decode_step(params, c1, toks[:, t], t)
        l2, c2 = ring.decode_step(params, c2, toks[:, t], t)
        err = max(err, float((l2 - l1).abs().max()))
    check(err < 0.05, f"gemma3 ring caches: max |diff| {err} from the full "
          f"cache")
    print(f"decode gemma3 window_kv_cache on the card: {S} tokens over a "
          f"window of {ring.cfg.sliding_window}, max |diff| {err:.3g} from "
          f"the full-cache decode (bound 0.05)")

    api, mp = _smoke_serving(torch, "internlm2-1.8b", 0)
    mp = masking.MaskedParams(*(tree.tree_map(
        lambda t: None if t is None else t.to(dev), x)
        for x in (mp.weights, mp.scores, mp.floats)))
    prompts = torch.randint(0, api.cfg.vocab, (3, 10),
                            generator=torch.Generator().manual_seed(2))
    lens = [(10, 6), (7, 8), (4, 5)]

    def engine(api, mp, slots, cap, max_seq, lockstep=False):
        return ServeEngine(api, mp, slots=slots, cache_capacity=cap,
                           max_seq=max_seq, lockstep=lockstep)

    eng = engine(api, mp, 2, 3, 18)
    rids = []
    for i, (P, G) in enumerate(lens):
        eng.register_tenant(f"t{i}", seed=100 + i, mode="sample")
        rids.append(eng.submit(f"t{i}", prompts[i, :P].numpy(), G))
    done = eng.run()
    for i, (P, G) in enumerate(lens):
        solo = engine(api, mp, 1, 1, 18)
        solo.register_tenant("solo", seed=100 + i, mode="sample")
        rid = solo.submit("solo", prompts[i, :P].numpy(), G)
        want = solo.run()[rid]
        got = done[rids[i]]
        check(got.tokens == want.tokens and all(
            torch.equal(a, b) for a, b in zip(got.decode_logits,
                                              want.decode_logits)),
              f"engine tenant t{i}: logits differ from its solo session")
    print(f"engine isolation on the card: 3 tenants on 2 slots "
          f"({eng.mixed_ticks} mixed ticks), logits bit-identical to solo "
          f"sessions")

    for arch in DECODE_ARCHS + ("gemma3-4b ring",):
        api, mp = _smoke_serving(torch, arch.split()[0], 3,
                                 windowed=arch.endswith("ring"))
        mp = masking.MaskedParams(*(tree.tree_map(
            lambda t: None if t is None else t.to(dev), x)
            for x in (mp.weights, mp.scores, mp.floats)))
        prompts = torch.randint(0, api.cfg.vocab, (3, 6),
                                generator=torch.Generator().manual_seed(3))
        runs = []
        for lockstep in (False, True):
            eng = engine(api, mp, 2, 3, 12, lockstep)
            rids = []
            for i in range(3):
                eng.register_tenant(f"t{i}", seed=50 + i)
                rids.append(eng.submit(f"t{i}", prompts[i].numpy(), 5))
            done = eng.run()
            runs.append([done[r] for r in rids])
        tol = 1e-5
        err, worst = 0.0, 0.0
        for e, l in zip(*runs):
            check(e.tokens == l.tokens, f"lockstep {arch}: tokens "
                  f"{l.tokens} against the exact mode's {e.tokens}")
            for a, b in zip(e.decode_logits, l.decode_logits):
                err = max(err, float((a - b).abs().max()))
                worst = max(worst, float(((a - b).abs()
                                          / (tol + tol * a.abs())).max()))
        print(f"lockstep vs exact on the card, {arch}: tokens equal, "
              f"logits max |diff| {err:.3g} (atol = rtol = {tol:g}: "
              f"{worst:.3g} of the bound)")
        check(worst <= 1.0, f"lockstep {arch}: logits max |diff| {err} "
              f"beyond atol = rtol = {tol}")


def small_m_kernel_phase(torch, mm, ref, dev):
    """Kernel 1 at the decode's row counts M = 1, 2, 4, 8 against its
    plain version: bf16 x at internlm2-1.8b's and gemma3-4b's leaf
    shapes (one bf16 ulp, as `kernel_phase`), f32 x at recurrentgemma's
    4096 x 4096 gate projections (f32 rounding), both modes.  Returns
    the largest |diff|."""
    gen = torch.Generator(device=dev).manual_seed(9)
    shapes = sorted(set(LAYER_SHAPES.values()) | set(GEMMA3_SHAPES.values()))
    cases = [(K, N, torch.bfloat16) for K, N in shapes]
    cases.append((CONV_SHAPES["recurrentgemma-9b"],) * 2 + (torch.float32,))
    err = 0.0
    for K, N, dt in cases:
        w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(K, N, generator=gen, device=dev)
        off = (3 * K * N) & M32
        for m in SMALL_M:
            x = torch.randn(m, K, generator=gen, device=dev).to(dt)
            for mode in ("sample", "threshold"):
                kw = dict(mode=mode, tau=0.45)
                got = mm.masked_matmul(x, w, s, 77, off, **kw).float()
                want = ref.masked_matmul(x, w, s, 77, off, **kw).float()
                d = (got - want).abs()
                if dt == torch.bfloat16:
                    ok = (d <= BF16_RTOL * want.abs()
                          + 1e-4 * want.abs().max()).all()
                else:
                    ok = torch.allclose(got, want, rtol=1e-5,
                                        atol=1e-5 * float(want.abs().max()))
                check(bool(ok), f"kernel 1 at M={m} K={K} N={N} {dt} {mode}: "
                      f"max |diff| {float(d.max())}")
                err = max(err, float(d.max()))
        del w, s
    torch.cuda.empty_cache()
    print(f"kernel 1 at M in {SMALL_M}: {len(cases)} shapes (bf16 x at "
          f"internlm2 and gemma3 widths, f32 x at 4096 x 4096), both modes, "
          f"agree with the plain version; max |diff| {err:.3g}")
    return err


def zoo_paths(steps_, every):
    """The zoo's training paths after the first four: [(cfg, {kernel:
    launches}, extra argv)] for 2 cohorts (deepseek-v2-236b 1) x `steps_`
    steps and a round every `every`.  Dense projections a train pass:
    whisper 24 encoder layers of 6 (w_q, w_k, w_v, w_o, w_up, w_down) and
    24 decoder layers of 10 (self 4, cross 4, w_up, w_down), 384;
    qwen2-vl 28 layers of 7; qwen2-7b and deepseek-7b 4 of 7;
    deepseek-v2-236b at 2 layers 18 (MLA with q-lora 6 and an MLP 3 in
    each: the dense layer's own, the MoE layer's shared experts) and 3
    expert projections in its MoE layer.  Each round packs and unpacks
    every masked leaf once (ROUND_LEAVES).  Then fedavg on
    internlm2-1.8b: plain float weights, no round, no kernel."""
    from repro_torch.configs import get_config
    rounds, per_pass = steps_ // every, COHORTS * steps_
    big = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DSV2_BIG_LAYERS)
    big_pass = DSV2_BIG_COHORTS * steps_
    out = []
    for cfg, n_proj in (
            (get_config("whisper-medium"), 24 * 6 + 24 * 10),
            (get_config("qwen2-vl-2b"), 28 * 7),
            (dataclasses.replace(get_config("qwen2-7b"),
                                 n_layers=ZOO_LAYERS), ZOO_LAYERS * 7),
            (dataclasses.replace(get_config("deepseek-7b"),
                                 n_layers=ZOO_LAYERS), ZOO_LAYERS * 7)):
        out.append((cfg, {k: n_proj * per_pass for k in (
            "masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds")},
            []))
    expect = {k: 18 * big_pass for k in (
        "masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds")}
    expect.update({k: 3 * big_pass for k in (
        "masked_matmul_grouped", "masked_matmul_grouped_dx",
        "masked_matmul_grouped_ds")})
    out.append((big, expect, ["--cohorts", str(DSV2_BIG_COHORTS)]))
    for cfg, expect, _ in out:
        n = ROUND_LEAVES[cfg.name] * rounds
        expect.update(sample_and_pack=n, unpack_bits=n)
    return out + [(get_config("internlm2-1.8b"), {}, ["--algo", "fedavg"])]


def train_path(torch, dispatch, cfg, expect, argv, steps_, every):
    """`repro_torch.launch.train.run(cfg, argv)` on the card: its step and
    round seconds, losses and peak memory printed; every kernel launched
    exactly `expect` times, `steps_` finite losses, a round every `every`
    steps (none for fedavg) with uplink Bpp in (0, 1].  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    args = train.parse_args(["--arch", cfg.name] + argv)
    print(f"main path: python -m repro_torch.launch.train --arch "
          f"{cfg.name} {' '.join(argv)} at {cfg.n_layers} layers of "
          f"{get_config(cfg.name).n_layers}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.time()
    out = train.run(cfg, args)
    torch.cuda.synchronize()
    got = dict(dispatch.LAUNCHES)
    wall = time.time() - t0
    print(f"main path {cfg.name} {args.algo}: {wall:.1f}s; launches "
          f"{json.dumps(got)}; step seconds "
          f"{[round(t, 4) for t in out['step_seconds']]}; round "
          f"seconds {[round(t, 4) for t in out['round_seconds']]}; "
          f"losses {[round(v, 4) for v in out['losses']]}; max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(got == expect, f"{cfg.name} launch counts {got}, expected "
          f"{expect}")
    check(len(out["losses"]) == steps_ and all(
        math.isfinite(v) for v in out["losses"]),
          f"{cfg.name}: non-finite loss")
    check(len(out["rounds"]) == (0 if args.algo == "fedavg"
                                 else steps_ // every),
          f"{cfg.name}: missing round")
    for r in out["rounds"]:
        check(0.0 < r["bpp"] <= 1.0 and 0.0 < r["bpp_measured"] <= 1.1,
              f"{cfg.name}: uplink Bpp out of range: {r}")
    del out
    torch.cuda.empty_cache()
    return got


def vlm_patch_step(torch, dispatch, dev):
    """One fedpm_reg train step of full-size qwen2-vl-2b through
    `make_train_step` with VLM_PATCHES stub patch embeddings a sequence
    prepended (the M-RoPE branch on a grid of side 8 at the published
    sections (16, 24, 24)), 2 cohorts x batch 2 x 128 tokens: 28 layers
    x 7 projections x 2 cohorts launches of each of kernels 1-3 at M =
    2 x (64 + 128) rows and a finite loss.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import masking
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_config("qwen2-vl-2b")
    api = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(29)
    state = steps.init_fed_state(gen, api, masking.MaskSpec(), C=COHORTS)
    batch = {"tokens": torch.randint(0, cfg.vocab, (COHORTS, 2, 128),
                                     generator=gen, device=dev),
             "vis_embeds": (0.1 * torch.randn(
                 COHORTS, 2, VLM_PATCHES, cfg.d_model, generator=gen,
                 device=dev)).to(torch.bfloat16)}
    step = steps.make_train_step(api, steps.StepConfig(lam=1.0, lr=0.3,
                                                       seed=17))
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = dict(dispatch.LAUNCHES)
    loss = float(metrics["loss"])
    n = cfg.n_layers * 7 * COHORTS
    expect = {k: 0 for k in dispatch.KERNELS}
    expect.update(masked_matmul_fwd=n, masked_matmul_dx=n,
                  masked_matmul_ds=n)
    check(got == expect, f"qwen2-vl patch step launches {got}, expected "
          f"{expect}")
    check(math.isfinite(loss), f"qwen2-vl patch step: loss {loss}")
    print(f"qwen2-vl-2b train step with {VLM_PATCHES} patch embeddings a "
          f"sequence (M-RoPE sections {cfg.mrope_sections}, M = "
          f"{2 * (VLM_PATCHES + 128)} rows a cohort): loss {loss:.4f}, "
          f"{dt:.3f}s (first step, warm kernels), launches {n} of each of "
          f"kernels 1-3; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, batch, metrics
    torch.cuda.empty_cache()
    return got


# The performance features' paths: internlm2-1.8b at batch 4 in 2
# microbatches with each layer recomputed; deepseek-v2-lite at 4 layers
# with block-local MoE dispatch; gemma3-4b's chunked prefill forward.
# The depth paths on bf16 scores and moments, one cohort: (arch, layers,
# None for all).  qwen2-7b whole; deepseek-v2-lite-16b and
# recurrentgemma-9b at the deepest cut one card holds (8 bytes a masked
# weight in the step: bf16 w, scores, moments and score gradients; 6 in
# the round beside ~9 bytes a weight of its largest leaf (the unpacked
# mean, theta, the downlink's uniforms); recurrentgemma's f32 unembed of
# its tied 1.05 G embedding ~13 GB); mamba2-370m whole (kernels 8-9 on
# bf16 scores at the published width)
FULL_DEPTH_COHORTS = 1
FULL_DEPTH_PATHS = (("qwen2-7b", None), ("deepseek-v2-lite-16b", 16),
                    ("recurrentgemma-9b", None), ("mamba2-370m", None))
MICRO_BATCH, MICRO = 4, 2
CHUNK_KV, CHUNK_CHECK_LEN, CHUNK_LONG_LEN = 512, 4096, 32768
# On bf16 activations the chunked forward rounds the attention output's
# f32 sums at other points than the unchunked one, and 34 layers carry
# that apart.  It is gated at this share of the bf16 rounding spread
# itself, the unchunked forward on bf16 against f32 activations, both
# read in the same call: on gemma3 SMOKE cut to 12 layers (a 64-token
# window, 256 tokens in chunks of 32) the reference's own chunked spread
# is 0.101 of its rounding spread and the port's 0.089, on the CPU
# (tests/test_torch_perf_features.py,
# `test_bf16_chunked_spread_within_rounding_spread`, which holds both to
# this share).  The chunked forward at CHUNK_LONG_LEN tokens is held to
# the same bound against the chunked one at CHUNK_CHECK_LEN on their
# common rows: causal attention reads no later key, so they differ only
# where a product over more rows sums in another order.
CHUNK_BF16_SPREAD = 0.5


def steps_path(torch, dispatch, dev, cfg, scfg, cohorts, batch, seq,
               steps_, every, codec="arithmetic"):
    """`steps.make_train_step` / `make_round_step` on the card, batches
    drawn from the launcher's token stream as `launch.train` draws them
    (the launcher has no score-type, microbatch or remat flag, as the
    reference's has none), on a fed state of `scfg.score_dtype`:
    `steps_` steps, a round every `every`.  Returns ({kernel: launches},
    step seconds, round seconds, round metrics, losses, peak GiB) and
    prints the state's masked weights and its largest masked leaf."""
    from repro_torch.core import masking, tree
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.runtime import fault
    api = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(scfg.seed)
    state = steps.init_fed_state(gen, api, masking.MaskSpec(), C=cohorts,
                                 score_dtype=scfg.score_dtype)
    sizes = [s[0].numel() for s in tree.leaves(state["scores"])
             if s is not None]
    floats = sum(f[0].numel() for f in tree.leaves(state["floats"])
                 if f is not None)
    print(f"  {cfg.name} at {cfg.n_layers} layers: {sum(sizes) / 1e9:.4f} G "
          f"masked weights a cohort, the largest leaf {max(sizes) / 1e9:.4f}"
          f" G, {floats / 1e9:.4f} G floats")
    step_fn = steps.make_train_step(api, scfg)
    round_fn = steps.make_round_step(api, scfg, codec=codec)
    toks = synthetic.make_lm_stream(scfg.seed, 500_000, cfg.vocab, dev)
    dispatch.reset_launch_counts()
    t_step, t_round, rounds, losses = [], [], [], []
    for step in range(steps_):
        bgen = torch.Generator(device=dev)
        bgen.manual_seed(fault.counter_seed(scfg.seed, step, fault.S_BATCH))
        idx = torch.randint(0, toks.shape[0] - seq - 1, (cohorts, batch),
                            generator=bgen, device=dev)
        tokens = toks[idx[..., None] + torch.arange(seq, device=dev)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, {"tokens": tokens})
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if (step + 1) % every == 0:
            t0 = time.perf_counter()
            state, rm = round_fn(state)
            torch.cuda.synchronize()
            t_round.append(time.perf_counter() - t0)
            rounds.append({k: float(v) for k, v in rm.items()})
    got = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(v) for v in losses), f"{cfg.name}: losses "
          f"{losses}")
    check(len(rounds) == steps_ // every and all(
        0.0 < r["bpp"] <= 1.0 for r in rounds),
          f"{cfg.name}: rounds {rounds}")
    del state, step_fn, round_fn, toks
    torch.cuda.empty_cache()
    return got, t_step, t_round, rounds, losses, peak


def _fmt(ts):
    return [round(t, 4) for t in ts]


def depth_launches(cfg, passes, rounds):
    """{kernel: launches} of `passes` train passes (cohorts x steps) and
    `rounds` rounds of `cfg` at its depth: dense (qwen2) 7 projections a
    layer; MoE 8 a layer (MLA 5 and the dense or shared MLP 3) and 3
    expert projections a MoE layer; SSM 2 projections and one conv a
    layer; the hybrid 8 projections and one conv a rec block, 7
    projections an attn block, its layers the block pattern repeated.
    Kernel 8 runs twice a conv and pass (the forward and the flipped
    dL/dx), kernel 9 once.  A round packs and unpacks every stacked
    masked leaf once: 7 (dense), 19 (MoE: the dense layer's 8, the MoE
    layers' MLA 5, shared MLP 3 and experts 3), 3 (SSM), and for the
    hybrid 9, 9 and 7 under its groups' blocks and 9 under a rec tail."""
    L, fam = cfg.n_layers, cfg.family
    out = {}
    if fam == "dense":
        dense, leaves = 7 * L, 7
    elif fam == "moe":
        dense, leaves = 8 * L, 8 * (cfg.first_dense_layers > 0) + 11
        out["masked_matmul_grouped"] = 3 * (L - cfg.first_dense_layers)
    elif fam == "ssm":
        dense, leaves = 2 * L, 3
        out.update(masked_conv1d=2 * L, masked_conv1d_ds=L)
    else:
        pat = cfg.block_pattern
        kinds = [pat[i % len(pat)] for i in range(L)]
        rec = kinds.count("rec")
        dense = 8 * rec + 7 * (L - rec)
        out.update(masked_conv1d=2 * rec, masked_conv1d_ds=rec)
        leaves = 25 * (L >= len(pat)) + 9 * (L % len(pat) > 0)
    out.update(masked_matmul_fwd=dense, masked_matmul_dx=dense,
               masked_matmul_ds=dense)
    if "masked_matmul_grouped" in out:
        out.update(masked_matmul_grouped_dx=out["masked_matmul_grouped"],
                   masked_matmul_grouped_ds=out["masked_matmul_grouped"])
    out = {k: v * passes for k, v in out.items()}
    out.update(sample_and_pack=leaves * rounds, unpack_bits=leaves * rounds)
    return out


def full_depth_phase(torch, dispatch, dev):
    """The depth paths (FULL_DEPTH_PATHS) on one card: bf16 scores and
    moments (`init_fed_state(score_dtype=torch.bfloat16)`, 2 bytes a
    weight each beside the bf16 w and the bf16 score gradients), 1
    cohort, fedpm_reg, batch 2 x seq 128, 4 steps, a round every 2,
    8-bit downlink, arithmetic codec, seed 17, through `steps_path`:
    qwen2-7b at all 28 layers, deepseek-v2-lite-16b and recurrentgemma-9b
    cut to the depth one card holds, mamba2-370m at all 48.  Each kernel
    launches as `depth_launches` reckons; the step and round seconds, the
    peak, the losses and the rounds' Bpp (in (0, 1]) are printed.
    Returns the launch counts of all paths."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    steps_, every = 4, 2
    scfg = steps.StepConfig(lam=1.0, lr=0.3, downlink_bits=8, seed=17,
                            score_dtype=torch.bfloat16)
    total = {k: 0 for k in dispatch.KERNELS}
    for arch, layers in FULL_DEPTH_PATHS:
        cfg = get_config(arch)
        full = cfg.n_layers
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.time()
        held = torch.cuda.memory_allocated() / 2**30
        got, ts, tr, rounds, losses, peak = steps_path(
            torch, dispatch, dev, cfg, scfg, FULL_DEPTH_COHORTS, 2, 128,
            steps_, every)
        expect = {k: 0 for k in dispatch.KERNELS}
        expect.update(depth_launches(cfg, FULL_DEPTH_COHORTS * steps_,
                                     steps_ // every))
        check(got == expect, f"{cfg.name} depth path launches {got}, "
              f"expected {expect}")
        print(f"depth path: {cfg.name} at {cfg.n_layers} of {full} layers, "
              f"bf16 scores, {FULL_DEPTH_COHORTS} cohort, batch 2 x seq 128, "
              f"{steps_} steps, a round every {every} "
              f"({time.time() - t0:.1f}s): step seconds {_fmt(ts)}; round "
              f"seconds {_fmt(tr)}; losses {_fmt(losses)}; bpp "
              f"{[round(r['bpp'], 6) for r in rounds]}, measured "
              f"{[round(r['bpp_measured'], 6) for r in rounds]}; max memory "
              f"allocated {peak:.2f} GiB ({held:.2f} held before the path); "
              f"launches {json.dumps({k: v for k, v in got.items() if v})}")
        total = {k: total[k] + got[k] for k in total}
    return total


def microbatch_remat_phase(torch, dispatch, dev):
    """internlm2-1.8b (nothing cut) at batch MICRO_BATCH, 2 cohorts, 4
    steps and a round every 2: first in one batch, then in MICRO
    microbatches with `cfg.remat` (each layer recomputed in the
    backward), in the same call.  Microbatched with remat, kernel 1
    launches twice per projection, microbatch, cohort and step (the
    forward and its recompute) and kernels 2-3 once; kernel 4 and 11 once
    per leaf and round.  Each run's step and round seconds and peak are
    printed.  Returns the launch counts of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    steps_, every = 4, 2
    total = {k: 0 for k in dispatch.KERNELS}
    base = get_config("internlm2-1.8b")
    leaves = ROUND_LEAVES[base.name] * (steps_ // every)
    for micro, remat in ((1, False), (MICRO, True)):
        cfg = dataclasses.replace(base, remat=remat)
        scfg = steps.StepConfig(lam=1.0, lr=0.3, downlink_bits=8, seed=17,
                                microbatch=micro)
        got, ts, tr, rounds, losses, peak = steps_path(
            torch, dispatch, dev, cfg, scfg, COHORTS, MICRO_BATCH, 128,
            steps_, every)
        n = cfg.n_layers * len(LAYER_SHAPES) * COHORTS * steps_ * micro
        expect = {k: 0 for k in dispatch.KERNELS}
        expect.update(masked_matmul_fwd=n * (2 if remat else 1),
                      masked_matmul_dx=n, masked_matmul_ds=n,
                      sample_and_pack=leaves, unpack_bits=leaves)
        check(got == expect, f"internlm2 microbatch {micro} remat {remat} "
              f"launches {got}, expected {expect}")
        print(f"internlm2-1.8b batch {MICRO_BATCH} in {micro} "
              f"microbatch(es), remat {remat}: step seconds {_fmt(ts)}; "
              f"round seconds {_fmt(tr)}; losses {_fmt(losses)}; bpp "
              f"{[round(r['bpp'], 6) for r in rounds]}; max memory "
              f"allocated {peak:.2f} GiB; kernel 1-3 launches "
              f"{got['masked_matmul_fwd']}, {got['masked_matmul_dx']}, "
              f"{got['masked_matmul_ds']}")
        total = {k: total[k] + got[k] for k in total}
    return total


def block_dispatch_phase(torch, dispatch, dev, argv, steps_, every):
    """deepseek-v2-lite-16b at full width cut to MOE_LAYERS layers with
    `moe_block_dispatch` = BLOCK_DISPATCH through the launcher: kernels
    5-7 launch exactly once per projection, MoE layer, cohort and step,
    as without block dispatch (the blocks fold into one (E, G*C) launch).
    Then one MoE layer of its published width on the card, with ample
    capacity (capacity factor E / k: no block drops a token), block
    dispatch against the global dispatch within the reference test's
    1e-4.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import masking
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=MOE_LAYERS,
                              moe_block_dispatch=BLOCK_DISPATCH)
    n_moe = MOE_LAYERS - cfg.first_dense_layers
    per_pass = COHORTS * steps_
    expect = {k: 0 for k in dispatch.KERNELS}
    expect.update({k: 8 * MOE_LAYERS * per_pass for k in (
        "masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds")})
    expect.update({k: 3 * n_moe * per_pass for k in (
        "masked_matmul_grouped", "masked_matmul_grouped_dx",
        "masked_matmul_grouped_ds")})
    n = ROUND_LEAVES[cfg.name] * (steps_ // every)
    expect.update(sample_and_pack=n, unpack_bits=n)
    got = train_path(torch, dispatch, cfg, expect, argv, steps_, every)

    gen = torch.Generator(device=dev).manual_seed(41)
    p = L.moe_init(gen, cfg.d_model, cfg.moe_d_ff, cfg.n_experts, 0)
    p = {k: (v.float() if k == "router_w" else masking.MaskedLeaf.build(
        v, torch.randn(v.shape, generator=gen, device=dev), 77))
        for k, v in p.items()}
    x = torch.randn(2, 128, cfg.d_model, generator=gen, device=dev)
    cf = cfg.n_experts / cfg.top_k
    dispatch.reset_launch_counts()
    with torch.no_grad():
        y0, _ = L.moe_apply(p, x, cfg.n_experts, cfg.top_k, cf)
        yb, _ = L.moe_apply(p, x, cfg.n_experts, cfg.top_k, cf,
                            block_dispatch=BLOCK_DISPATCH)
    torch.cuda.synchronize()
    layer = dict(dispatch.LAUNCHES)
    d = float((y0.float() - yb.float()).abs().max())
    scale = float(y0.float().abs().max())
    check(bool(torch.allclose(y0.float(), yb.float(), rtol=1e-4,
                              atol=1e-4)),
          f"block dispatch vs global at capacity factor {cf}: max |diff| "
          f"{d} at scale {scale}")
    check(layer["masked_matmul_grouped"] == 2 * 3,
          f"block dispatch layer launches {layer}")
    print(f"block dispatch: one deepseek-v2-lite MoE layer (E = "
          f"{cfg.n_experts}, k = {cfg.top_k}, 256 tokens) at capacity "
          f"factor {cf}, {BLOCK_DISPATCH} blocks against the global "
          f"dispatch on the card: max |diff| {d:.3g} at scale {scale:.3g} "
          f"(bound 1e-4); 3 grouped launches each")
    del p, x, y0, yb
    torch.cuda.empty_cache()
    return {k: got[k] + layer[k] for k in got}


def chunked_attention_phase(torch, dispatch, dev):
    """gemma3-4b (in the reference's long-context set) at its published
    width, batch 1, bf16 scores: a masked forward without grad over its
    unfrozen scores, attention in chunks of CHUNK_KV keys, against the
    unchunked forward at CHUNK_CHECK_LEN tokens.  With the float leaves
    cast to f32, every activation is f32 and only the order of the f32
    sums differs: logits within 1e-3 of their scale.  On the config's
    bf16 activations the two round at other points through 34 layers:
    held to CHUNK_BF16_SPREAD of the bf16 rounding spread read in the
    same call (the unchunked forward on bf16 against f32 activations).
    Then the chunked forward alone at CHUNK_LONG_LEN tokens (the
    reference's prefill_32k) on the bf16 activations, whose f32 logits
    alone are 34.4 GB: its seconds and peak, kernel 1 at M = 32768 rows,
    and its first CHUNK_CHECK_LEN rows against the chunked forward over
    those tokens alone, at the same bound.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import masking, tree
    from repro_torch.models import build_model
    cfg = get_config("gemma3-4b")
    api = build_model(cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(43)
    mp = masking.init_masked(gen, api.init_params(gen), masking.MaskSpec(),
                             score_dtype=torch.bfloat16)
    fused = masking.masked_forward_tree(
        mp, lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=17))
    toks = torch.randint(0, cfg.vocab, (1, CHUNK_LONG_LEN), generator=gen,
                         device=dev)
    f32 = tree.tree_map(
        lambda p: p if isinstance(p, masking.MaskedLeaf) or p is None
        else p.float(), fused)
    amax = lambda a, b: float((a - b).abs().max())
    dispatch.reset_launch_counts()
    with torch.no_grad():
        short = {"tokens": toks[:, :CHUNK_CHECK_LEN]}
        f32_u = api.forward(f32, short)[0]
        got = api.forward(f32, short, chunk_kv=CHUNK_KV)[0]
        d, scale = amax(got, f32_u), float(f32_u.abs().max())
        mean = float((got - f32_u).abs().mean())
        del got
        bf_u = api.forward(fused, short)[0]
        bf_c = api.forward(fused, short, chunk_kv=CHUNK_KV)[0]
        rounding, bd = amax(bf_u, f32_u), amax(bf_c, bf_u)
        bmean = float((bf_c - bf_u).abs().mean())
        del f32_u, bf_u
    torch.cuda.synchronize()
    total = dict(dispatch.LAUNCHES)
    check(d <= 1e-3 * scale, f"gemma3-4b chunked vs unchunked at "
          f"{CHUNK_CHECK_LEN} tokens, f32 activations: max |diff| {d} at "
          f"scale {scale}")
    bound = CHUNK_BF16_SPREAD * rounding
    check(bd <= bound, f"gemma3-4b chunked vs unchunked at "
          f"{CHUNK_CHECK_LEN} tokens, bf16 activations: max |diff| {bd}, "
          f"bound {bound} ({CHUNK_BF16_SPREAD} of the bf16 rounding spread "
          f"{rounding})")
    # the short chunked logits wait on the host, out of the long
    # forward's peak
    bf_c = bf_c.cpu()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = api.forward(fused, {"tokens": toks}, chunk_kv=CHUNK_KV)[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    long_launches = dict(dispatch.LAUNCHES)
    # in slices of rows: a test of the whole 34.4 GB at once would
    # allocate as much again
    rows = range(0, logits.shape[1], 1024)
    finite = all(bool(torch.isfinite(logits[:, i:i + 1024]).all())
                 for i in rows)
    ld = max(amax(logits[:, i:i + 1024], bf_c[:, i:i + 1024].to(dev))
             for i in range(0, CHUNK_CHECK_LEN, 1024))
    shape = tuple(logits.shape)
    del logits, bf_c
    check(finite and shape == (1, CHUNK_LONG_LEN, cfg.vocab),
          f"gemma3-4b chunked forward at {CHUNK_LONG_LEN}: shape {shape}, "
          f"finite {finite}")
    check(ld <= bound, f"gemma3-4b chunked forward at {CHUNK_LONG_LEN}: its "
          f"first {CHUNK_CHECK_LEN} rows against the chunked forward over "
          f"those tokens: max |diff| {ld}, bound {bound}")
    n = cfg.n_layers * 7
    check(long_launches["masked_matmul_fwd"] == n,
          f"gemma3-4b chunked forward launches {long_launches}")
    print(f"chunked attention: gemma3-4b, bf16 scores, chunks of "
          f"{CHUNK_KV} keys: at {CHUNK_CHECK_LEN} tokens chunked vs "
          f"unchunked logits on f32 activations max |diff| {d:.4g}, mean "
          f"{mean:.3g}, at scale {scale:.4g} (bound 1e-3 of it); on bf16 "
          f"activations max |diff| {bd:.4g}, mean {bmean:.3g}, bf16 "
          f"rounding spread {rounding:.4g} (bound {CHUNK_BF16_SPREAD} of "
          f"it, {bound:.4g}); at {CHUNK_LONG_LEN} tokens the chunked "
          f"forward {dt:.3f}s, max memory allocated {peak:.2f} GiB, its "
          f"first {CHUNK_CHECK_LEN} rows against the short chunked forward "
          f"max |diff| {ld:.4g}, kernel 1 launched {n} times at M = "
          f"{CHUNK_LONG_LEN}")
    del mp, fused, f32, toks
    torch.cuda.empty_cache()
    return {k: total[k] + long_launches[k] for k in total}


def masked_decode_phase(torch, dispatch, dev):
    """Serving through masked trees on the card, SMOKE configs: for
    mamba2, recurrentgemma and gemma3, 10 tokens of frozen decode against
    the fused masked training forward on the same tokens (kernels 1 and
    8; the reference's 0.02, 0.15 for the hybrid), then 6 tokens decoded
    through the unfrozen `MaskedLeaf` tree (kernel 1 at M = 1 for every
    projection; the conv step materializes its kernel, as the
    reference's) against the frozen tree: mamba2 bit for bit,
    recurrentgemma within 0.15, as tests/test_serving.py holds them.
    Launch counts are read around each pass.  Returns them summed."""
    from repro_torch.core import masking, tree
    total = {k: 0 for k in dispatch.KERNELS}
    seed_fn = lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=9)
    for arch, per_step, tol in MASKED_DECODE:
        api, mp = _smoke_serving(torch, arch, 5)
        mp = masking.MaskedParams(*(tree.tree_map(
            lambda t: None if t is None else t.to(dev), x)
            for x in (mp.weights, mp.scores, mp.floats)))
        fused = masking.masked_forward_tree(mp, seed_fn, mode="sample")
        toks = torch.randint(0, api.cfg.vocab, (2, 10), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        dispatch.reset_launch_counts()
        with torch.no_grad():
            want = api.forward(fused, {"tokens": toks})[0]
        torch.cuda.synchronize()
        fwd = dict(dispatch.LAUNCHES)
        frozen = masking.freeze_for_decode(fused)
        cache = api.init_cache(2, 10, dev)
        err = 0.0
        for t in range(10):
            logits, cache = api.decode_step(frozen, cache, toks[:, t], t)
            err = max(err, float((logits - want[:, t]).abs().max()))
        bound_fwd = 0.15 if api.cfg.family == "hybrid" else 0.02
        check(err < bound_fwd, f"{arch}: frozen decode vs fused forward on "
              f"the card, max |diff| {err}")
        check(fwd["masked_matmul_fwd"] > 0, f"{arch}: fused forward "
              f"launched no kernel 1: {fwd}")

        c1, c2 = api.init_cache(1, 6, dev), api.init_cache(1, 6, dev)
        dispatch.reset_launch_counts()
        diff = 0.0
        for t in range(6):
            l1, c1 = api.decode_step(frozen, c1, toks[:1, t], t)
            l2, c2 = api.decode_step(fused, c2, toks[:1, t], t)
            diff = max(diff, float((l1 - l2).abs().max()))
            if tol is None:
                check(torch.equal(l1, l2), f"{arch}: unfrozen decode "
                      f"differs from the frozen one at t={t} by "
                      f"{float((l1 - l2).abs().max())}")
        torch.cuda.synchronize()
        got = dict(dispatch.LAUNCHES)
        check(tol is None or diff <= tol, f"{arch}: unfrozen decode max "
              f"|diff| {diff} from the frozen one")
        expect = {k: 0 for k in dispatch.KERNELS}
        expect["masked_matmul_fwd"] = 6 * per_step
        check(got == expect, f"{arch}: unfrozen decode launches {got}, "
              f"expected {expect}")
        print(f"masked decode {arch}: frozen decode vs fused forward "
              f"(launches {json.dumps({k: v for k, v in fwd.items() if v})})"
              f" max |diff| {err:.3g} (bound {bound_fwd}); unfrozen vs "
              f"frozen decode over 6 tokens max |diff| {diff:.3g} "
              f"({'bit for bit' if tol is None else f'bound {tol}'}), "
              f"kernel 1 launched {got['masked_matmul_fwd']} times at M = 1")
        total = {k: total[k] + fwd[k] + got[k] for k in total}
        del mp, fused, frozen, cache, c1, c2
    return total


def serve_phase(torch, dispatch, dev):
    """`repro_torch.launch.serve` at the published widths (SERVE_RUNS):
    single tenant (batch 4), 4 tenants on 2 slots with freeze-cache
    capacity 2, and for gemma3-4b the same in lockstep.  The frozen
    decode runs plain products and the threshold freeze no kernel of the
    port, so no kernel launches here.  Returns {(arch, tag): summary}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    multi = ["--tenants", "4", "--slots", "2", "--cache-capacity", "2"]
    extra = {"single": [], "multi": multi, "lockstep": multi + ["--lockstep"]}
    out_all = {}
    for arch, layers, tag in SERVE_RUNS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        argv = ["--arch", arch, "--batch", "4", "--prompt-len", "16",
                "--tokens", "16"] + extra[tag]
        print(f"serve path: python -m repro_torch.launch.serve "
              f"{' '.join(argv)} at {cfg.n_layers} layers of "
              f"{get_config(arch).n_layers}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        t0 = time.time()
        out = serve.run(cfg, serve.parse_args(argv))
        torch.cuda.synchronize()
        got = dict(dispatch.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(not any(got.values()), f"serve {arch} {tag}: unexpected "
              f"kernel launches {got}")
        if tag == "single":
            check(bool(torch.isfinite(out["last_logits"]).all()),
                  f"serve {arch} single: non-finite logits")
            per_tenant = out["freeze_s"]
        else:
            check(out["served"] == 4, f"serve {arch} {tag}: "
                  f"{out['served']}/4 served")
            check(out["lockstep"] == (tag == "lockstep"),
                  f"serve {arch} {tag}: lockstep {out['lockstep']}")
            check(out["evictions"] >= 1, f"serve {arch} {tag}: no eviction")
            check(out["max_occupancy"] <= 2, f"serve {arch} {tag}: "
                  f"freeze-cache occupancy reached {out['max_occupancy']}")
            check(all(bool(torch.isfinite(l).all())
                      for c in out["completions"].values()
                      for l in c.decode_logits),
                  f"serve {arch} {tag}: non-finite logits")
            per_tenant = out["freeze_s"] / out["freezes"]
        print(f"serve {arch} {tag}: {time.time() - t0:.1f}s; prefill "
              f"{out['prefill_tok_s']:.1f} tok/s, decode "
              f"{out['decode_tok_s']:.1f} tok/s; freeze "
              f"{per_tenant * 1e3:.1f} ms per tenant "
              f"({out['freezes']} freezes); max memory allocated "
              f"{peak / 2**30:.2f} GiB")
        out_all[(arch, tag)] = {k: out[k] for k in (
            "prefill_tok_s", "decode_tok_s", "freeze_s", "freezes")}
        del out
    torch.cuda.empty_cache()
    return out_all


def artifact_phase(torch, dispatch, dev, arch):
    """The artifact path of examples/serve_masked.py at the full width of
    `arch`: `init_server` -> `final_artifact` (one pack launch per masked
    leaf) -> `save_artifact` -> `load_artifact` -> `artifact_masks`
    (`BitpackedMasks.to_masks`, one unpack launch per leaf), checked bit
    for bit against `final_mask`, its `bpp` against the unpacked masks'
    share -> `served_params`, m * w over weights regenerated from the
    artifact's seed (checked equal to the server's) -> 16 greedy
    `decode_step`s at batch 8 after a 32-token prompt.  Returns the
    launch counts."""
    import tempfile
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import federated, masking, regularizer, tree
    from repro_torch.models import build_model
    cfg = get_config(arch)
    api = build_model(cfg)
    spec = masking.MaskSpec()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(21)
    server = federated.init_server(gen, api.init_params(gen), spec)
    art = federated.final_artifact(
        server, torch.Generator(device=dev).manual_seed(22))
    scores = masking.scores_from_theta(server.theta)
    want = dict(masking.leaves_with_paths(masking.final_mask(
        masking.MaskedParams(server.weights, scores, server.floats),
        torch.Generator(device=dev).manual_seed(22))))
    del scores
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / f"{arch}.npz")
        nbytes = checkpoint.save_artifact(path, art)
        loaded = checkpoint.load_artifact(path, dev)
    n = sum(math.prod(sh) for _, sh in loaded["masks"].values())
    fbytes = sum(t.numel() * t.element_size()
                 for t in loaded["floats"].values())
    check(abs(nbytes - (n / 8 + fbytes)) <= 0.01 * (n / 8 + fbytes),
          f"artifact {nbytes} B, expected about n/8 + floats = "
          f"{n / 8 + fbytes:.0f} B")
    masks, packed = checkpoint.artifact_masks(loaded)
    check(set(masks) == set(want), "artifact leaves differ from the mask's")
    for p, m in want.items():
        check(torch.equal(masks[p], m),
              f"artifact mask {p} differs from final_mask")
    # eq. 13 from the words' popcount against the unpacked masks' share
    ones = sum(int(m.sum()) for m in masks.values())
    bpp, bpp_plain = float(packed.bpp()), float(regularizer.binary_entropy(
        torch.tensor(ones / n, dtype=torch.float64)))
    check(packed.num_params() == n and abs(bpp - bpp_plain) <= 2.0 ** -23,
          f"artifact bpp {bpp} against {bpp_plain} from the masks")
    server_weights = server.weights
    del server, art, want

    # serve side: regenerate w from the seed, apply the masks
    gen = torch.Generator(device=dev).manual_seed(loaded["seed"])
    weights = masking.init_masked(gen, api.init_params(gen), spec).weights
    for a, b in zip(tree.leaves(weights), tree.leaves(server_weights)):
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              "weights regenerated from the seed differ from the server's")
    del server_weights
    eff = checkpoint.served_params(weights, masks, loaded["floats"])
    del weights, masks
    got = dict(dispatch.LAUNCHES)
    build_s = time.time() - t0

    B, P, G = 8, 32, 16
    cache = api.init_cache(B, P + G, dev)
    prompt = torch.randint(0, cfg.vocab, (B, P), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               23))
    tok = prompt[:, 0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for t in range(P + G - 1):
        logits, cache = api.decode_step(eff, cache, tok, t)
        tok = prompt[:, t + 1] if t + 1 < P else torch.argmax(logits, -1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    check(bool(torch.isfinite(logits).all()), "artifact decode: non-finite")
    print(f"artifact path {arch}: {n} masked params -> {nbytes} B "
          f"file ({8 * (nbytes - fbytes) / n:.4f} bits/param beside "
          f"{fbytes} B of floats, bpp {bpp:.6f}); build, save, load, "
          f"unpack, regenerate "
          f"{build_s:.1f}s; launches {json.dumps(got)}; {P + G - 1} steps "
          f"at batch {B} in {dt:.3f}s ({B * (P + G - 1) / dt:.1f} tok/s); "
          f"max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eff, cache, logits
    torch.cuda.empty_cache()
    return got


def profile_phase(torch, dev, cfg):
    """One more train step and round of `cfg` under torch.profiler:
    device time by kernel and the device's busy share of the wall time
    (after the main paths, whose launch counts are already read)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import registry
    from repro_torch.launch import steps as steplib
    from repro_torch.models import build_model
    api = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(17)
    plan = registry.get_launch_plan("fedpm_reg")(
        api, steplib.StepConfig(lam=1.0, lr=0.3, downlink_bits=8, seed=17),
        gen=gen, cohorts=COHORTS)
    toks = torch.randint(0, api.cfg.vocab, (100_000,), generator=gen,
                         device=dev)
    batch = plan.make_batch(gen, toks, 2, 128)
    state, _ = plan.step_fn(plan.state, batch)     # warm-up
    torch.cuda.synchronize()
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in (("step", lambda s: plan.step_fn(s, batch)),
                         ("round", plan.round_fn)):
            t0 = time.perf_counter()
            state, _ = fn(state)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    wall = sum(walls.values()) * 1e3
    print(f"profile {cfg.name} ({cfg.n_layers} layers): 1 step + 1 round, "
          f"wall {wall:.1f} ms "
          f"(step {walls['step'] * 1e3:.1f}, round "
          f"{walls['round'] * 1e3:.1f}), device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%); device ms by kernel:")
    # the 15 largest, then every other hand-written kernel of the port
    own = ("masked_", "sample_and_pack", "gated_gemm", "ds_gemm")
    for key, count, ms in rows[:15] + [r for r in rows[15:]
                                       if any(k in r[0] for k in own)]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:90]}")
    check(busy > 0, "the profiler saw no device time")


def serve_profile_phase(torch, dev):
    """Eight decode steps of full-size internlm2-1.8b at batch 4 (the
    serve launcher's frozen threshold tree) under torch.profiler, after
    two warm-up steps: device time by kernel, the device's busy share of
    the wall time, and the launches a step makes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import masking
    from repro_torch.models import build_model
    api = build_model(get_config("internlm2-1.8b"))
    gen = torch.Generator(device=dev).manual_seed(0)
    eff = masking.freeze_identity(
        masking.init_masked(gen, api.init_params(gen), masking.MaskSpec()),
        masking.MaskIdentity(seed=0))
    B, S, n = 4, 32, 8
    cache = api.init_cache(B, S, dev)
    toks = torch.randint(0, api.cfg.vocab, (B, S), generator=gen,
                         device=dev)
    for t in range(2):
        api.decode_step(eff, cache, toks[:, t], t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2, 2 + n):
            api.decode_step(eff, cache, toks[:, t], t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile serve internlm2-1.8b: {n} decode steps at batch {B}, "
          f"wall {wall:.1f} ms ({wall / n:.2f} ms a step), device busy "
          f"{busy:.1f} ms ({100 * busy / wall:.1f}%), {launches / n:.0f} "
          f"device ops a step; device ms by kernel:")
    for key, count, ms in rows[:12]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:90]}")
    check(busy > 0, "the profiler saw no device time in decoding")
    del eff, cache
    torch.cuda.empty_cache()


def lockstep_profile_phase(torch, dev):
    """The serving engine on full-size gemma3-4b, 2 tenants on 2 slots
    (8-token prompts, 8 generated), exact per-slot steps against the
    lockstep step: after 2 warm-up ticks, 6 ticks under torch.profiler,
    their wall time, the device's busy share and the device operations
    a tick."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import masking
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_engine import ServeEngine
    api = build_model(get_config("gemma3-4b"))
    gen = torch.Generator(device=dev).manual_seed(0)
    mp = masking.init_masked(gen, api.init_params(gen), masking.MaskSpec())
    prompts = torch.randint(0, api.cfg.vocab, (2, 8), generator=gen,
                            device=dev).cpu().numpy()
    cuda = torch.autograd.DeviceType.CUDA
    for lockstep in (False, True):
        eng = ServeEngine(api, mp, slots=2, cache_capacity=2, max_seq=16,
                          lockstep=lockstep)
        for i in range(2):
            eng.register_tenant(f"t{i}", seed=i)
            eng.submit(f"t{i}", prompts[i], 8)
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(6):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == cuda and e.self_device_time_total > 0]
        busy = sum(r[2] for r in rows)
        ops = sum(r[1] for r in rows)
        mode = "lockstep" if lockstep else "exact"
        print(f"profile serve gemma3-4b {mode}, 2 slots: 6 ticks, wall "
              f"{wall:.1f} ms ({wall / 6:.2f} ms a tick, "
              f"{2 * 6 / wall * 1e3:.1f} tok/s), device busy {busy:.1f} ms "
              f"({100 * busy / wall:.1f}%), {ops / 6:.0f} device ops a tick")
        check(busy > 0, f"the profiler saw no device time ({mode})")
        del eng
        torch.cuda.empty_cache()
    del mp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The paper's CNNs: kernels 1-3 at their im2col shapes, the fused step,
# the host-sim API at the published widths and the Fig. 1 benchmark
# ---------------------------------------------------------------------------

CNN_BATCH = 32                # the host-sim local batch (run_fedpm_variant)
HOSTSIM = dict(k=10, local_steps=3, rounds=2, n=1024, seed=31)
# the reference benchmark's default is 12 rounds; 4 keep the script in
# its time limit beside the dry-run, examples and mesh phases (6 until
# the mesh phase's microbatched steps)
FIG1_ROUNDS = 4


def cnn_shapes(cfg, batch=CNN_BATCH):
    """(name, M, K, N) of every masked leaf's one launch in the fused CNN
    forward: a conv's im2col (B*H*W, 9*ci) against its (9*ci, co)
    reshape, a dense's (B, din) against (din, dout)."""
    out, side, cin = [], cfg.img_size, cfg.in_channels
    for i, cout in enumerate(cfg.conv_planes):
        out.append((f"conv{i + 1}", batch * side * side, 9 * cin, cout))
        cin = cout
        if i % 2 == 1:
            side //= 2
    din = side * side * cin
    for j, dout in enumerate(cfg.dense_sizes + (cfg.n_classes,)):
        out.append((f"dense{j + 1}", batch, din, dout))
        din = dout
    return out


def cnn_kernel_phase(torch, mm, ref, bp, dev):
    """Kernels 1-3 against their plain versions at CONV6's shapes (img 32,
    batch 32) on the CNN's f32 activations, both mask modes: masks read
    back exactly by identity probes, sums within f32 rounding (1e-5 of the
    scale); each shape timed beside its bound and beside torch.matmul on
    the materialized f32 m * w (TF32 off; for kernel 3 the x^T g product
    alone).  Kernels 10-11 bit for bit at CONV10's leaf sizes (one row to
    pack, the 10 clients' rows to unpack).  Returns ({kernel: max abs
    err}, {kernel: {shape: (ms, plain ms, library ms, bound ms)}})."""
    from repro_torch.models import cnn
    gen = torch.Generator(device=dev).manual_seed(23)
    err = {k: 0.0 for k in ("masked_matmul_fwd", "masked_matmul_dx",
                            "masked_matmul_ds", "pack_bits", "unpack_bits")}
    per_shape = {k: {} for k in err if k.startswith("masked")}
    seed, off = 0x2545F491, 0
    print(f"cnn kernel phase: kernels 1-3 at conv6's shapes, f32 x, "
          f"ms per launch (graph replay): kernel / plain / torch.matmul on "
          f"m*w / bound (share of the bound)")
    for name, M, K, N in cnn_shapes(cnn.CONV6):
        x = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16)
        s = 2 * torch.randn(K, N, generator=gen, device=dev)
        g = torch.randn(M, N, generator=gen, device=dev)
        for mode in ("sample", "threshold"):
            kw = dict(mode=mode, tau=0.45)
            tag = f"cnn {name} M={M} K={K} N={N} {mode}"
            for kname, got, want in (
                    ("masked_matmul_fwd",
                     mm.masked_matmul(x, w, s, seed, off, **kw),
                     ref.masked_matmul(x, w, s, seed, off, **kw)),
                    ("masked_matmul_dx",
                     mm.masked_matmul_dx(g, w, s, seed, off, **kw),
                     ref.masked_matmul_dx(g, w, s, seed, off, **kw))):
                d = float((got - want).abs().max())
                check(got.dtype == torch.float32 and bool(torch.allclose(
                    got, want, rtol=1e-5,
                    atol=1e-5 * float(want.abs().max()))),
                    f"{kname} {tag}: max |diff| {d}")
                err[kname] = max(err[kname], d)
            # identity probes: rows (fwd) and columns (dx) of m * w exactly
            r = min(M, K, N)
            mask = (ref.threshold_mask(s, 0.45) if mode == "threshold"
                    else ref.sample_mask(s, seed, off))
            wm = mask.float() * w.float()
            u = (ref.hash_uniform(ref.flat_index(K, N, off, N, dev), seed)
                 if mode == "sample" else torch.full_like(s, 0.45))
            theta = torch.sigmoid(s)
            eye = torch.eye(r, device=dev)
            px = torch.zeros(r, K, device=dev)
            px[:, :r] = eye
            y = mm.masked_matmul(px, w, s, seed, off, **kw)
            n_f = mask_exact(torch, y != 0, wm[:r] != 0, u[:r], theta[:r],
                             "fwd probe " + tag)
            check(n_f or torch.equal(y, wm[:r]), "fwd probe values " + tag)
            pg = torch.zeros(r, N, device=dev)
            pg[:, :r] = eye
            dx = mm.masked_matmul_dx(pg, w, s, seed, off, **kw)
            n_d = mask_exact(torch, dx.T != 0, wm[:, :r] != 0, u[:, :r],
                             theta[:, :r], "dx probe " + tag)
            check(n_d or torch.equal(dx.T, wm[:, :r]),
                  "dx probe values " + tag)
        ds = mm.masked_matmul_ds(x, g, w, s)
        want = ref.masked_matmul_ds(x, g, w, s)
        d = float((ds - want).abs().max())
        check(bool(torch.allclose(ds, want, rtol=1e-5,
                                  atol=1e-5 * float(want.abs().max()))),
              f"masked_matmul_ds cnn {name}: max |diff| {d}")
        err["masked_matmul_ds"] = max(err["masked_matmul_ds"], d)

        wm = ref.sample_mask(s, seed, off).float() * w.float()
        nb = 4 * M * K + 6 * K * N + 4 * M * N
        for kname, kern, plain, lib, cost in (
                ("masked_matmul_fwd",
                 lambda: mm.masked_matmul(x, w, s, seed, off),
                 lambda: ref.masked_matmul(x, w, s, seed, off),
                 lambda: x @ wm, (nb, 2 * M * K * N, F32_FLOPS_PER_S)),
                ("masked_matmul_dx",
                 lambda: mm.masked_matmul_dx(g, w, s, seed, off),
                 lambda: ref.masked_matmul_dx(g, w, s, seed, off),
                 lambda: g @ wm.T, (nb, 2 * M * K * N, F32_FLOPS_PER_S)),
                ("masked_matmul_ds", lambda: mm.masked_matmul_ds(x, g, w, s),
                 lambda: ref.masked_matmul_ds(x, g, w, s), lambda: x.T @ g,
                 (4 * M * K + 4 * M * N + 10 * K * N, 6 * 2 * M * K * N,
                  BF16_FLOPS_PER_S))):
            tk, tl = graph_ms(torch, [kern, lib], 10)
            tp = time_ms(torch, [plain], 2)[0]
            tb, by = bound(*cost)
            per_shape[kname][name] = (tk, tp, tl, tb)
            print(f"  {kname:18s} {name:7s} M={M:5d} K={K:4d} N={N:3d} "
                  f"{tk:8.4f} {tp:8.4f} {tl:8.4f} {tb:8.4f} "
                  f"({100 * tb / tk:.1f}%, by {by})")
        del x, w, s, g, wm, mask, u, theta, px, pg, y, dx, ds, want
        torch.cuda.empty_cache()

    # kernels 10-11 at CONV10's leaf sizes: a client packs each leaf, a
    # round unpacks the 10 clients' rows of it
    k = HOSTSIM["k"]
    for name, M, K, N in cnn_shapes(cnn.CONV10):
        n = K * N
        bits = (torch.rand(k, n, generator=gen, device=dev) < 0.4).to(
            torch.uint8)
        words = torch.stack([bp.pack_bits(bits[i]) for i in range(k)])
        check(torch.equal(words, bp.pack_bits_plain(bits)),
              f"pack_bits cnn {name} n={n}: words differ from the plain "
              f"version")
        back = bp.unpack_bits(words, n)
        check(torch.equal(back, bp.unpack_bits_plain(words, n))
              and torch.equal(back, bits),
              f"unpack_bits cnn {name} n={n}: bits differ")
    torch.cuda.synchronize()
    return err, per_shape


def _cnn_step(torch, cnn, masking, tree, mp, cfg, images, labels, seed_fn,
              device):
    """One fused forward and backward of the CE loss through
    `masked_forward_tree` on `device`: (loss, [per-leaf score gradient as
    f64 on the CPU])."""
    mv = lambda t: tree.tree_map(
        lambda a: None if a is None else a.to(device), t)
    scores = tree.tree_map(lambda a: None if a is None else
                           a.to(device).requires_grad_(), mp.scores)
    fwd = masking.masked_forward_tree(
        masking.MaskedParams(mv(mp.weights), scores, mv(mp.floats)), seed_fn)
    loss = cnn.ce_loss(cnn.forward(fwd, cfg, images.to(device)),
                       {"labels": labels.to(device)})
    leaves = [s for s in tree.leaves(scores) if s is not None]
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach().double().cpu() for g in grads]


def _rel_cos(a, b):
    na = float(a.norm())
    rel = float((b - a).norm()) / na if na else math.inf
    cos = float(a.ravel() @ b.ravel()) / (na * float(b.norm()))
    return rel, cos


def fused_cnn_phase(torch, dispatch, mm, dev):
    """One forward and backward of CONV6 (img 32, batch 32) through
    `masked_forward_tree` (kernels 1-3 on every conv's im2col and every
    dense) on the card against the same on the CPU (plain versions): the
    loss, and each score leaf's gradient by relative norm and cosine.
    The bounds are four times the f32 spread the same step shows with the
    kernels swapped for their plain versions on the card (cuBLAS against
    the CPU's sums), never below 1e-6.  The launches of the kernel run
    are counted: every conv and dense once forward and once for ds, and
    once for dx but the first conv (the images need no gradient).
    Returns the launch counts."""
    from repro_torch.core import masking, tree
    from repro_torch.models import cnn
    cfg = cnn.CONV6
    gen = torch.Generator().manual_seed(41)
    mp = masking.init_masked(gen, cnn.init_params(gen, cfg),
                             masking.MaskSpec())
    images = torch.randn(CNN_BATCH, cfg.img_size, cfg.img_size,
                         cfg.in_channels, generator=gen)
    labels = torch.randint(0, cfg.n_classes, (CNN_BATCH,), generator=gen)
    seed_fn = lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=41)
    step = lambda device: _cnn_step(torch, cnn, masking, tree, mp, cfg,
                                    images, labels, seed_fn, device)
    cpu_loss, cpu_g = step("cpu")
    plain = {"masked_matmul": mm.masked_matmul_plain,
             "masked_matmul_dx": mm.masked_matmul_dx_plain,
             "masked_matmul_ds": mm.masked_matmul_ds_plain}
    kernels = {k: getattr(mm, k) for k in plain}
    try:
        for k, f in plain.items():
            setattr(mm, k, f)
        plain_loss, plain_g = step(dev)
    finally:
        for k, f in kernels.items():
            setattr(mm, k, f)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    card_loss, card_g = step(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(dispatch.LAUNCHES)
    n = len(cfg.conv_planes) + len(cfg.dense_sizes) + 1   # masked leaves
    expect = {k: 0 for k in dispatch.KERNELS}
    expect.update(masked_matmul_fwd=n, masked_matmul_dx=n - 1,
                  masked_matmul_ds=n)
    check(got == expect, f"fused conv6 step launch counts {got}, expected "
          f"{expect}")
    spread = [_rel_cos(a, b) for a, b in zip(cpu_g, plain_g)]
    s_rel = max(r for r, _ in spread)
    s_cos = min(c for _, c in spread)
    rel_b, cos_b = max(4 * s_rel, 1e-6), 1 - max(4 * (1 - s_cos), 1e-9)
    l_b = max(4 * abs(plain_loss - cpu_loss), 1e-6 * abs(cpu_loss))
    check(abs(card_loss - cpu_loss) <= l_b, f"fused conv6 loss card "
          f"{card_loss} cpu {cpu_loss} (bound {l_b})")
    worst = (0.0, 1.0)
    for i, (a, b) in enumerate(zip(cpu_g, card_g)):
        rel, cos = _rel_cos(a, b)
        check(rel <= rel_b and cos >= cos_b, f"fused conv6 leaf {i}: "
              f"relative norm {rel:.4g}, cosine {cos:.9f} (bounds "
              f"{rel_b:.4g}, {cos_b:.9f})")
        worst = (max(worst[0], rel), min(worst[1], cos))
    print(f"fused conv6 step (batch {CNN_BATCH}): loss card {card_loss:.7f} "
          f"cpu {cpu_loss:.7f} (plain on card {plain_loss:.7f}); score "
          f"gradients, worst leaf of {n}: relative norm {worst[0]:.4g}, "
          f"cosine {worst[1]:.9f}; f32 spread (plain versions on the card "
          f"against the cpu) {s_rel:.4g}, {s_cos:.9f}; bounds {rel_b:.4g}, "
          f"{cos_b:.9f}; launches {json.dumps({k: v for k, v in got.items() if v})}; "
          f"wall {wall * 1e3:.1f} ms")
    return got


def hostsim_phase(torch, dispatch, dev):
    """The paper's widths through the host-sim API: CONV4, CONV6 and
    CONV10 as `models/cnn.py` defines them, each on a cifar10-like task
    at img 32 (1024 images), fedpm_reg at lam 1 with run_fedpm_variant's
    settings (10 clients, 3 local steps of batch 32, adam at lr 0.1 on
    the scores, 1e-3 on the floats), 2 rounds and an evaluation each.
    Per round: its seconds, the client updates' seconds, the launches of
    kernels 10 (each client packs each masked leaf) and 11 (the round
    unpacks each leaf's 10 rows once); Bpp in (0, 1], theta in [0, 1].
    Then one more CONV6 round under torch.profiler.  Returns the launch
    counts of the whole path."""
    from repro_torch import api
    from repro_torch.benchmarks import common
    from repro_torch.core import tree
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    k, H, R = HOSTSIM["k"], HOSTSIM["local_steps"], HOSTSIM["rounds"]
    dispatch.reset_launch_counts()
    total = {kk: 0 for kk in dispatch.KERNELS}
    prof_args = None
    for cfg in (cnn.CONV4, cnn.CONV6, cnn.CONV10):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(dev).manual_seed(HOSTSIM["seed"])
        task = synthetic.make_image_task(gen, n=HOSTSIM["n"],
                                         img=cfg.img_size,
                                         channels=cfg.in_channels,
                                         n_classes=cfg.n_classes,
                                         proto_scale=1.0, noise=0.7)
        setup = common.setup_from(cfg, task, k, None, HOSTSIM["seed"], gen)
        algo = api.get_algorithm(
            "fedpm_reg", setup["apply_fn"], setup["loss_fn"],
            spec=common.SPEC, local_steps=H, lam=1.0, lr=0.1,
            optimizer="adam", float_lr=1e-3)
        client = algo.client_update
        t_client = [0.0]

        def timed(*a, _client=client, _t=t_client):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _client(*a)
            torch.cuda.synchronize()
            _t[0] += time.perf_counter() - t
            return out

        algo.client_update = timed
        st = algo.init(gen, setup["params"])
        n_leaves = sum(1 for a in tree.leaves(st.theta) if a is not None)
        n_params = sum(a.numel() for a in tree.leaves(st.theta)
                       if a is not None)
        sizes = torch.tensor([len(c) for c in setup["cidx"]],
                             dtype=torch.float32, device=dev)
        part = torch.ones(k, dtype=torch.bool, device=dev)
        for r in range(R):
            data = synthetic.federated_batches(gen, task, setup["cidx"], k,
                                               H, CNN_BATCH)
            before = dict(dispatch.LAUNCHES)
            t_client[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = algo.round(st, data, part, sizes, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {kk: dispatch.LAUNCHES[kk] - before[kk] for kk in before}
            expect = {kk: 0 for kk in dispatch.KERNELS}
            expect.update(pack_bits=k * n_leaves, unpack_bits=n_leaves)
            check(got == expect, f"host-sim {cfg.name} round {r} launch "
                  f"counts {got}, expected {expect}")
            bpp, bpp_m = float(m["uplink_bpp"]), float(m["uplink_bpp_measured"])
            check(0.0 < bpp <= 1.0 and 0.0 < bpp_m <= 1.1,
                  f"host-sim {cfg.name}: Bpp {bpp}, measured {bpp_m}")
            # theta is a weighted mean of bits: [0, 1] up to the f32
            # rounding of the weights' sum
            for t in tree.leaves(st.theta):
                if t is not None:
                    check(bool(torch.isfinite(t).all()) and
                          float(t.min()) >= 0.0
                          and float(t.max()) <= 1.0 + 1e-6,
                          f"host-sim {cfg.name}: theta in [{float(t.min())}"
                          f", {float(t.max())}]")
            check(math.isfinite(float(m["loss"])),
                  f"host-sim {cfg.name}: non-finite loss")
            print(f"host-sim {cfg.name} ({n_params} masked weights in "
                  f"{n_leaves} leaves) round {r}: {wall:.3f} s, client "
                  f"updates {t_client[0]:.3f} s, launches pack_bits "
                  f"{got['pack_bits']} unpack_bits {got['unpack_bits']}; "
                  f"loss {float(m['loss']):.4f} bpp {bpp:.6f} measured "
                  f"{bpp_m:.6f} sparsity {float(m['sparsity']):.4f}")
        acc = float(api.evaluate(algo, st, setup["test"], setup["apply_fn"],
                                 setup["metric_fn"], gen, n_samples=2))
        check(0.0 <= acc <= 1.0, f"host-sim {cfg.name}: accuracy {acc}")
        print(f"host-sim {cfg.name}: accuracy after {R} rounds {acc:.4f}; "
              f"max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if cfg is cnn.CONV6:
            prof_args = (algo, st, setup, gen, sizes, part)
        total = {kk: total[kk] + v for kk, v in dispatch.LAUNCHES.items()}
        dispatch.reset_launch_counts()
    cnn_profile(torch, dev, *prof_args)
    return total


def cnn_profile(torch, dev, algo, st, setup, gen, sizes, part):
    """One more CONV6 host-sim round under torch.profiler: device time by
    kernel, device operations and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import synthetic
    data = synthetic.federated_batches(gen, setup["task"], setup["cidx"],
                                       setup["k"], HOSTSIM["local_steps"],
                                       CNN_BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        algo.round(st, data, part, sizes, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    n_ops = sum(r[1] for r in rows)
    print(f"profile host-sim conv6 round (10 clients x 3 steps): wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}"
          f"%), {n_ops} device operations; device ms by kernel:")
    for key, count, ms in rows[:12] + [r for r in rows[12:]
                                       if "pack_bits" in r[0]]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:90]}")
    check(busy > 0, "the profiler saw no device time")


def fig1_phase(torch, dispatch, dev):
    """The torch Fig. 1 benchmark (`repro_torch.benchmarks.fig1_iid.main`)
    at its defaults on the card (the reduced widths of
    `benchmarks/common.py`, 10 clients) for FIG1_ROUNDS rounds: its CSV
    and summary, gated on invariants only (the header, one row per
    dataset, variant and round, accuracy in [0, 1], Bpp in (0, 1] and the
    measured rate at or above it, the cumulative MB growing) and on the
    launches of kernels 10 and 11.  Returns the launch counts."""
    import io
    from repro_torch.benchmarks import common, fig1_iid
    out, err = io.StringIO(), io.StringIO()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    fig1_iid.main(rounds=FIG1_ROUNDS, k=HOSTSIM["k"], device=str(dev),
                  out=out, err=err)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(dispatch.LAUNCHES)
    lines = out.getvalue().splitlines()
    print(f"fig1 (python -m repro_torch.benchmarks.fig1_iid --rounds "
          f"{FIG1_ROUNDS}): {wall:.1f}s")
    print("\n".join(lines))
    print(err.getvalue().rstrip())
    check(lines[0] == "dataset,algo,round,acc,bpp,bpp_measured,sparsity,"
          "cum_mb", f"fig1 header {lines[0]!r}")
    rows = [l.split(",") for l in lines[1:]]
    variants = [v for _, v, _ in fig1_iid.VARIANTS]
    check([tuple(r[:3]) for r in rows] == [
        (ds, v, str(r)) for ds in fig1_iid.DATASETS for v in variants
        for r in range(FIG1_ROUNDS)], "fig1: rows missing or out of order")
    last = {}
    for r in rows:
        acc, bpp, bpp_m, sp, cum = map(float, r[3:])
        check(0.0 <= acc <= 1.0 and 0.0 < bpp <= 1.0 and 0.0 <= sp <= 1.0
              and bpp - 1e-6 <= bpp_m <= 1.1, f"fig1 row out of range: {r}")
        check(cum > last.get(tuple(r[:2]), 0.0), f"fig1: cum_mb not "
              f"growing: {r}")
        last[tuple(r[:2])] = cum
    # masked leaves a client packs and a round unpacks: the empty ones
    # launch nothing (cifar100-like's Conv10 pools its 16 x 16 images to
    # 0 x 0, as the reference's does, so its first dense is (0, 64))
    from repro_torch.core import masking, tree
    spec = masking.MaskSpec()
    leaves = {ds: sum(1 for p, a in tree.flatten_with_paths(
        common.make_setup(ds, 1, None, n=16, device=dev)["params"])
        if spec.is_masked(p, a) and a.numel())
        for ds in fig1_iid.DATASETS}
    per = len(variants) * FIG1_ROUNDS
    expect = {k: 0 for k in dispatch.KERNELS}
    expect.update(
        pack_bits=sum(HOSTSIM["k"] * n * per for n in leaves.values()),
        unpack_bits=sum(n * per for n in leaves.values()))
    check(got == expect, f"fig1 launch counts {got}, expected {expect}")
    return got


# ---------------------------------------------------------------------------
# The rest of the host-sim API: the baselines at Conv6's published width,
# every wire codec on their payloads, the golomb meter at internlm2's full
# width and the Fig. 2 benchmark
# ---------------------------------------------------------------------------

BASELINES = (("topk", dict(k_frac=0.3, lr=0.1)), ("mv_signsgd", {}),
             ("fedavg", {}))
NONIID_C = 2                  # classes a client (the paper's non-IID split)
FIG2_ROUNDS = 4               # 6 until the mesh phase's microbatched steps


def baselines_phase(torch, dispatch, dev):
    """topk (k_frac 0.3), mv_signsgd and fedavg through `run_round` at
    CONV6's published width (2.26 M masked weights) on a cifar10-like
    task of 1024 images split non-IID (2 classes a client), HOSTSIM's
    settings (10 clients, 3 local steps of batch 32), 2 rounds each.  Per
    round: its seconds, the client updates' seconds, the peak memory and
    the launches, exactly: topk packs each masked leaf a client (kernel
    10) and unpacks each leaf once (11), mv_signsgd the same over every
    float leaf (its sign votes), fedavg launches none.  Gates: topk's
    share of ones is 0.3 up to ties, mv_signsgd's uplink is exactly 1 Bpp
    and its measured rate the word-aligned bits over n, fedavg's both 32;
    a finite loss and an accuracy in [0, 1].  Returns (the launches, one
    client's payload of each kind, on the card)."""
    from repro_torch import api
    from repro_torch.benchmarks import common
    from repro_torch.core import tree
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    k, H, R = HOSTSIM["k"], HOSTSIM["local_steps"], HOSTSIM["rounds"]
    cfg = cnn.CONV6
    total = {kk: 0 for kk in dispatch.KERNELS}
    sent = {}
    for name, kw in BASELINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(dev).manual_seed(HOSTSIM["seed"])
        task = synthetic.make_image_task(gen, n=HOSTSIM["n"],
                                         img=cfg.img_size,
                                         channels=cfg.in_channels,
                                         n_classes=cfg.n_classes,
                                         proto_scale=1.0, noise=0.7)
        setup = common.setup_from(cfg, task, k, NONIID_C, HOSTSIM["seed"],
                                  gen)
        algo = api.get_algorithm(name, setup["apply_fn"], setup["loss_fn"],
                                 spec=common.SPEC, local_steps=H, **kw)
        client = algo.client_update
        t_client = [0.0]

        def timed(*a, _client=client, _t=t_client, _name=name):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _client(*a)
            torch.cuda.synchronize()
            _t[0] += time.perf_counter() - t
            sent.setdefault(_name, out[0])   # the first client's uplink
            return out

        algo.client_update = timed
        st = algo.init(gen, setup["params"])
        leaves = [a for a in tree.leaves(
            st.scores if name == "topk" else st.params) if a is not None]
        n = sum(a.numel() for a in leaves)
        sizes = torch.tensor([len(c) for c in setup["cidx"]],
                             dtype=torch.float32, device=dev)
        part = torch.ones(k, dtype=torch.bool, device=dev)
        expect = {kk: 0 for kk in dispatch.KERNELS}
        if name != "fedavg":
            expect.update(pack_bits=k * len(leaves),
                          unpack_bits=len(leaves))
        dispatch.reset_launch_counts()
        for r in range(R):
            data = synthetic.federated_batches(gen, task, setup["cidx"], k,
                                               H, CNN_BATCH)
            before = dict(dispatch.LAUNCHES)
            t_client[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = algo.round(st, data, part, sizes, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {kk: dispatch.LAUNCHES[kk] - before[kk] for kk in before}
            check(got == expect, f"baselines {name} round {r} launch counts "
                  f"{got}, expected {expect}")
            bpp = float(m["uplink_bpp"])
            bpp_m = float(m["uplink_bpp_measured"])
            if name == "topk":
                ones = 1.0 - float(m["sparsity"])
                check(abs(ones - 0.3) <= 1e-3, f"topk: share of ones {ones}")
                check(0.0 < bpp <= 1.0 and bpp <= bpp_m + 1e-6 <= 1.1,
                      f"topk: Bpp {bpp}, measured {bpp_m}")
            else:
                # a client's payload reports its rate exactly; the round's
                # is the f32 weighted mean over the clients (weights that
                # sum to 1 within an ulp)
                rate, want_m = (1.0, 32 * ((n + 31) // 32) / n) \
                    if name == "mv_signsgd" else (32.0, 32.0)
                check(float(sent[name].bpp()) == rate and abs(bpp - rate)
                      <= rate * 2 ** -22 and abs(bpp_m - want_m) <= want_m
                      * 2 ** -22, f"{name}: Bpp {bpp} (a client's "
                      f"{float(sent[name].bpp())}), measured {bpp_m} (want "
                      f"{rate}, {want_m})")
            check(math.isfinite(float(m["loss"])), f"baselines {name}: "
                  f"non-finite loss")
            print(f"baselines {name} conv6 ({n} weights in {len(leaves)} "
                  f"uplink leaves, non-IID c={NONIID_C}) round {r}: "
                  f"{wall:.3f} s, client updates {t_client[0]:.3f} s, "
                  f"launches pack_bits {got['pack_bits']} unpack_bits "
                  f"{got['unpack_bits']}; loss {float(m['loss']):.4f} bpp "
                  f"{bpp:.6f} measured {bpp_m:.6f} sparsity "
                  f"{float(m['sparsity']):.4f} uplink "
                  f"{float(m['uplink_bits_measured']) / 8e6:.3f} MB "
                  f"downlink {float(m['downlink_bits']) / 8e6:.3f} MB")
        acc = float(api.evaluate(algo, st, setup["test"], setup["apply_fn"],
                                 setup["metric_fn"], gen, n_samples=1))
        check(0.0 <= acc <= 1.0, f"baselines {name}: accuracy {acc}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"baselines {name}: accuracy after {R} rounds {acc:.4f}; max "
              f"memory allocated {peak:.3f} GiB")
        total = {kk: total[kk] + v for kk, v in dispatch.LAUNCHES.items()}
        dispatch.reset_launch_counts()
    return total, sent


def _same_payload(torch, a, b):
    """Every tensor field of two payloads equal bit for bit (on the CPU),
    the static fields equal."""
    from repro_torch.core import tree
    import dataclasses as dc
    for f in dc.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("shapes", "bits"):
            if x != y:
                return False
            continue
        lx, ly = tree.leaves(x), tree.leaves(y)
        if len(lx) != len(ly):
            return False
        for p, q in zip(lx, ly):
            if (p is None) != (q is None):
                return False
            if p is not None and not (p.dtype == q.dtype and torch.equal(
                    p.detach().cpu(), q.detach().cpu())):
                return False
    return True


def codec_phase(torch, dispatch, sent):
    """Each codec that accepts it on one client's payload of each kind
    from the baselines phase, read from the card: decode(encode(p)) is p
    bit for bit; `measure_bits` on the card equals the encoder's
    `wire_bits` (exactly, the arithmetic coder within one word); one
    flipped bit raises `ChecksumError`.  Prints the encode and decode
    seconds.  Launches nothing (the meters are popcounts and shifts)."""
    from repro_torch.api import codecs
    dispatch.reset_launch_counts()
    for kind, pay in sent.items():
        for name in codecs.available():
            codec = codecs.get_codec(name)
            if not codec.accepts(type(pay)):
                continue
            t0 = time.perf_counter()
            msg = codec.encode(pay)
            t1 = time.perf_counter()
            back = codec.decode(msg)
            t2 = time.perf_counter()
            check(_same_payload(torch, back, pay), f"codec {name} on "
                  f"{kind}: decode(encode(p)) != p")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            meas = float(codec.measure_bits(pay))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            tol = 32 if name == "arithmetic" else 0
            check(abs(meas - msg.wire_bits) <= tol, f"codec {name} on "
                  f"{kind}: measured {meas} bits, wire {msg.wire_bits}")
            stream = msg.words[0]
            stream[stream.size // 2] ^= 1 << 9
            try:
                codec.decode(msg)
            except codecs.ChecksumError:
                pass
            else:
                check(False, f"codec {name} on {kind}: a flipped bit "
                      f"decoded")
            n = pay.num_params()
            print(f"codec {name:10s} on {kind:10s} ({n} parameters): wire "
                  f"{msg.wire_bits} bits ({msg.wire_bits / n:.6f} Bpp), "
                  f"sidecar {msg.sidecar_bits}, header {msg.header_bits}; "
                  f"encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s, meter "
                  f"on the card {(t4 - t3) * 1e3:.2f} ms")
    check(not any(dispatch.LAUNCHES.values()), f"codec phase launched "
          f"{dispatch.LAUNCHES}")


def golomb_meter_phase(torch, dispatch, dev):
    """One round of the internlm2-1.8b training path (the launcher's
    default model, nothing cut) with `--codec golomb`: the round step
    meters each cohort's pooled words (~47 M words, 1.5 G bits) through
    `GolombRice.measure_pooled_words` on the card.  Each call's seconds
    and the peak memory it adds above what was allocated before it;
    cohort 0's count against the same function over the same words on
    the CPU, and against the host encoder's `wire_bits` for the first
    masked leaf's words.  Returns the path's launches."""
    from repro_torch.api import codecs, payloads
    from repro_torch.configs import get_config
    from repro_torch.core import aggregation
    from repro_torch.launch import train
    golomb = codecs.CODECS["golomb"]
    calls, first_leaf = [], {}
    meter, sap = golomb.measure_pooled_words, aggregation.sample_and_pack_rows

    def spy_meter(words, n):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bits = meter(words, n)
        torch.cuda.synchronize()
        calls.append(dict(bits=bits, n=n, s=time.perf_counter() - t0,
                          added=torch.cuda.max_memory_allocated() - base,
                          words=None if calls else words.clone()))
        return bits

    def spy_sap(flat, seeds, **kw):
        words = sap(flat, seeds, **kw)
        first_leaf.setdefault("words", words[0].clone())
        first_leaf.setdefault("n", flat.shape[1])
        return words

    argv = ["--algo", "fedpm_reg", "--codec", "golomb", "--cohorts",
            str(COHORTS), "--batch", "2", "--seq", "128", "--steps", "2",
            "--round-every", "2", "--downlink-bits", "8", "--device", "cuda"]
    cfg = get_config("internlm2-1.8b")
    golomb.measure_pooled_words = spy_meter
    aggregation.sample_and_pack_rows = spy_sap
    torch.cuda.empty_cache()
    dispatch.reset_launch_counts()
    try:
        t0 = time.time()
        out = train.run(cfg, train.parse_args(["--arch", cfg.name] + argv))
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        del golomb.measure_pooled_words
        aggregation.sample_and_pack_rows = sap
    got = dict(dispatch.LAUNCHES)
    expect = {k: 0 for k in dispatch.KERNELS}
    dense = N_LAYERS * len(LAYER_SHAPES) * COHORTS * 2
    expect.update(masked_matmul_fwd=dense, masked_matmul_dx=dense,
                  masked_matmul_ds=dense, sample_and_pack=len(LAYER_SHAPES),
                  unpack_bits=len(LAYER_SHAPES))
    check(got == expect, f"golomb path launch counts {got}, expected "
          f"{expect}")
    check(len(calls) == COHORTS and len(out["rounds"]) == 1,
          f"golomb path: {len(calls)} meter calls, {len(out['rounds'])} "
          f"rounds")
    r = out["rounds"][0]
    check(0.0 < r["bpp"] <= 1.0 and r["bpp"] <= r["bpp_measured"] <= 1.1,
          f"golomb path: Bpp {r['bpp']}, measured {r['bpp_measured']}")
    c0 = calls[0]
    t0 = time.perf_counter()
    on_cpu = golomb.measure_pooled_words(c0["words"].cpu(), c0["n"])
    cpu_s = time.perf_counter() - t0
    check(on_cpu == c0["bits"], f"golomb meter: card {c0['bits']} bits, "
          f"cpu {on_cpu}")
    n0, w0 = first_leaf["n"], first_leaf["words"]
    leaf = payloads.BitpackedMasks({"w": w0}, None, ((n0,),))
    t0 = time.perf_counter()
    wire = golomb.encode(leaf).wire_bits
    enc_s = time.perf_counter() - t0
    leaf_bits = golomb.measure_pooled_words(w0, n0)
    check(leaf_bits == wire == golomb.measure_bits(leaf), f"golomb meter "
          f"on the first masked leaf: {leaf_bits} bits, encoder {wire}")
    print(f"golomb meter (python -m repro_torch.launch.train --arch "
          f"internlm2-1.8b {' '.join(argv)}): {wall:.1f}s; per cohort "
          + ", ".join(f"{c['n']} bits -> {c['bits']} ({c['bits'] / c['n']:.6f}"
                      f" Bpp) in {c['s']:.3f} s, +{c['added'] / 2**20:.1f} MiB"
                      for c in calls)
          + f"; cohort 0 on the cpu {cpu_s:.1f} s, equal; first masked leaf "
          f"({n0} bits) {leaf_bits} bits, host encoder {wire} in {enc_s:.1f} "
          f"s; round Bpp {r['bpp']:.6f} measured {r['bpp_measured']:.6f}; "
          f"round seconds {out['round_seconds']}")
    del out, calls, first_leaf
    torch.cuda.empty_cache()
    return got


def fig2_phase(torch, dispatch, dev):
    """The torch Fig. 2 benchmark (`repro_torch.benchmarks.fig2_noniid`)
    at its defaults but FIG2_ROUNDS rounds: the header exact, one row per
    dataset, algorithm and round in the reference benchmark's order,
    accuracy in [0, 1], the lambda variants' and topk's measured Bpp in
    (0, 1.1] and at least the entropy bound, mv_signsgd's bound exactly
    1, the cumulative MB growing both ways, and the launches of kernels
    10 and 11 exact.  Returns the launch counts."""
    import io
    from repro_torch.benchmarks import common, fig2_noniid
    from repro_torch.core import masking, tree
    out, err = io.StringIO(), io.StringIO()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    fig2_noniid.main(rounds=FIG2_ROUNDS, k=HOSTSIM["k"], c=NONIID_C,
                     device=str(dev), out=out, err=err)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(dispatch.LAUNCHES)
    lines = out.getvalue().splitlines()
    print(f"fig2 (python -m repro_torch.benchmarks.fig2_noniid --rounds "
          f"{FIG2_ROUNDS}): {wall:.1f}s")
    print("\n".join(lines))
    print(err.getvalue().rstrip())
    check(lines[0] == "dataset,algo,round,acc,bpp,bpp_measured,cum_up_mb,"
          "cum_down_mb", f"fig2 header {lines[0]!r}")
    algos = [f"lam={lam}" for lam in fig2_noniid.LAMS] + [
        n for n, _ in fig2_noniid.BASELINES]
    rows = [l.split(",") for l in lines[1:]]
    check([tuple(r[:3]) for r in rows] == [
        (ds, a, str(r)) for ds in fig2_noniid.DATASETS for a in algos
        for r in range(FIG2_ROUNDS)], "fig2: rows missing or out of order")
    last = {}
    for r in rows:
        acc, bpp, bpp_m, up, down = map(float, r[3:])
        check(0.0 <= acc <= 1.0, f"fig2 accuracy out of range: {r}")
        if r[1] == "mv_signsgd":
            check(r[4] == "1.0000", f"fig2 mv_signsgd Bpp: {r}")
        else:
            check(0.0 < bpp_m <= 1.1 and bpp_m >= bpp - 1e-4,
                  f"fig2 measured Bpp out of range: {r}")
        prev = last.get(tuple(r[:2]), (0.0, 0.0))
        check(up > prev[0] and down > prev[1], f"fig2: cumulative MB not "
              f"growing: {r}")
        last[tuple(r[:2])] = (up, down)
    spec = masking.MaskSpec()
    per = {}
    for ds in fig2_noniid.DATASETS:
        params = common.make_setup(ds, 1, None, n=16, device=dev)["params"]
        masked = sum(1 for p, a in tree.flatten_with_paths(params)
                     if spec.is_masked(p, a) and a.numel())
        floats = sum(1 for a in tree.leaves(params) if a.numel())
        # 4 lambda variants and topk on the masked leaves, mv_signsgd on
        # every float leaf
        per[ds] = (len(fig2_noniid.LAMS) + 1) * masked + floats
    expect = {k: 0 for k in dispatch.KERNELS}
    expect.update(
        pack_bits=sum(HOSTSIM["k"] * v * FIG2_ROUNDS for v in per.values()),
        unpack_bits=sum(v * FIG2_ROUNDS for v in per.values()))
    check(got == expect, f"fig2 launch counts {got}, expected {expect}")
    return got



# ---------------------------------------------------------------------------
# The runtime: checkpoint and restart, the buffered-async engine and the
# aggregator tree
# ---------------------------------------------------------------------------

RUNTIME = dict(k=10, local_steps=3, n=1024, seed=31, ticks=8, save_at=4)
RUNTIME_FAULTS = dict(crash_prob=0.2, pod_size=5, partition_prob=0.15,
                      straggler_prob=0.3, straggler_rounds_max=2,
                      corrupt_prob=0.2, max_retries=2)
RUNTIME_CFG = dict(quorum_frac=0.8, deadline_rounds=2, max_staleness=3)
TREE_K, TREE_FANOUT = 8, 2
TREE_FAULTS = dict(crash_prob=0.1, corrupt_prob=0.1, agg_crash_prob=0.3,
                   agg_partition_prob=0.15)
# the kill-and-resume cell: internlm2-1.8b at full width cut to 2 layers
# (its four launcher processes and their checkpoints are the script's
# longest phase)
CHAOS_LAYERS, CHAOS_STEPS, CHAOS_EVERY = 2, 6, 2
CHAOS_ARGV = ["--device", "cuda", "--arch", "internlm2-1.8b", "--full-size",
              "--layers", str(CHAOS_LAYERS), "--steps", str(CHAOS_STEPS),
              "--round-every", str(CHAOS_EVERY), "--cohorts", str(COHORTS),
              "--batch", "2", "--seq", "128", "--fail-prob", "0.3",
              "--quorum-frac", "1.0", "--tree-fanout", "1",
              "--agg-fault-prob", "0.3", "--relaunch-cohorts", "3",
              "--timeout", "400"]


def _scratch(name):
    import shutil
    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def checkpoint_phase(torch, dev):
    """(a) internlm2-1.8b's full fed state (24 layers, 2 cohorts, from the
    launch plan) through `AsyncCheckpointer.save` (its blocking seconds:
    the device -> host copy; then the write, `save_checkpoint` on its
    thread) and `restore_checkpoint` onto the card: every leaf
    torch.equal, the int step an int.  The bytes are reckoned from the
    shapes and held against the free space under build/ first: too little
    fails the run."""
    import shutil
    from repro_torch.api import registry
    from repro_torch.ckpt import checkpoint as ckptlib
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import plans  # noqa: F401  (the launch plans)
    from repro_torch.launch import steps as steplib
    from repro_torch.models import build_model
    cfg = get_config("internlm2-1.8b")
    gen = torch.Generator(device=dev).manual_seed(17)
    state = registry.get_launch_plan("fedpm_reg")(
        build_model(cfg), steplib.StepConfig(seed=17), gen=gen,
        cohorts=COHORTS).state
    state["step"] = 7
    tensors = [l for l in tree.leaves(state) if isinstance(l, torch.Tensor)]
    nbytes = sum(l.numel() * l.element_size() for l in tensors)
    masked = sum(l[0].numel() for l in tree.leaves(state["scores"])
                 if l is not None)
    d = _scratch("chip_smoke_ckpt")
    free = shutil.disk_usage(d).free
    print(f"checkpoint: internlm2-1.8b fed state, {COHORTS} cohorts, "
          f"{masked} masked parameters a cohort, {len(tensors)} tensors, "
          f"{nbytes} bytes reckoned from the shapes; {free} bytes free "
          f"under build/")
    check(free > 1.05 * nbytes, f"checkpoint phase refuses: the state needs "
          f"{nbytes} bytes, build/ has {free} free")
    torch.cuda.synchronize()
    ac = ckptlib.AsyncCheckpointer(str(d), keep=1)
    t0 = time.perf_counter()
    ac.save(1, state)
    t_block = time.perf_counter() - t0
    ac.close()
    t_save = time.perf_counter() - t0 - t_block
    on_disk = (d / "step_1.npz").stat().st_size
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored, step = ckptlib.restore_checkpoint(str(d), state)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(step == 1 and restored["step"] == 7,
          f"checkpoint: step {step}, state step {restored['step']}")
    n = 0
    for a, b in zip(tree.leaves(restored), tree.leaves(state)):
        if isinstance(b, torch.Tensor):
            check(a.device == b.device and a.dtype == b.dtype
                  and torch.equal(a, b), "checkpoint: a leaf differs")
            n += 1
    print(f"checkpoint: {on_disk} bytes on disk ({on_disk / nbytes:.6f} of "
          f"the reckoning); AsyncCheckpointer.save blocked "
          f"{t_block:.3f} s (device -> host), its write {t_save:.3f} s "
          f"({nbytes / t_save / 1e9:.2f} GB/s); restore_checkpoint "
          f"{t_restore:.3f} s ({nbytes / t_restore / 1e9:.2f} GB/s); "
          f"{n} leaves torch.equal")
    del restored, state, tensors
    shutil.rmtree(d)
    torch.cuda.empty_cache()


def kill_resume_phase(torch, dispatch):
    """(b) `python -m repro_torch.tools.chaos_smoke` on the card:
    internlm2-1.8b at full width cut to 2 layers, fedpm_reg, 6 steps, a
    round every 2, --fail-prob 0.3 --tree-fanout 1 --agg-fault-prob 0.3,
    --ckpt-dir: an uninterrupted run, one SIGKILLed after its first
    durable round, its resumption (every later loss, round metric and
    final checkpoint leaf equal to the uninterrupted run's), and a
    relaunch with 3 cohorts (the theta-only restore).  Each launcher
    process writes its launch counts; they must be what its steps and
    rounds reckon.  Returns the uninterrupted run's counts."""
    import shutil
    from repro_torch.tools import chaos_smoke
    torch.cuda.empty_cache()
    work = _scratch("chip_smoke_chaos")
    t0 = time.time()
    out = chaos_smoke.main(CHAOS_ARGV + ["--work-dir", str(work), "--keep"])
    wall = time.time() - t0
    leaves, L = len(LAYER_SHAPES), CHAOS_LAYERS

    def expect(cohorts, start, steps):
        n, rounds = steps - start, steps // CHAOS_EVERY - start // CHAOS_EVERY
        e = {k: 0 for k in dispatch.KERNELS}
        for k in ("masked_matmul_fwd", "masked_matmul_dx",
                  "masked_matmul_ds"):
            e[k] = L * leaves * cohorts * n
        e.update(sample_and_pack=leaves * rounds, unpack_bits=leaves * rounds)
        return e

    ref = None
    for sub in ("ref", "run"):
        with open(Path(out["root"]) / sub / "launches.jsonl") as f:
            for line in f:
                r = json.loads(line)
                want = expect(r["cohorts"], r["start"], r["steps"])
                got = {k: r["launches"].get(k, 0) for k in dispatch.KERNELS}
                check(got == want, f"kill-and-resume {sub} from step "
                      f"{r['start']}: launches {got}, expected {want}")
                if sub == "ref":
                    ref = got
    secs = {k: round(v, 1) for k, v in out["seconds"].items()}
    print(f"kill-and-resume: {wall:.1f}s ({json.dumps(secs)}); "
          f"killed at step {out['killed_at']}, resumed at {out['resumed']}, "
          f"steps {out['compared_steps']} and {out['leaves']} checkpoint "
          f"leaves equal the uninterrupted run's; ledger {out['ledger']}; "
          f"--cohorts 3 ran steps {out['relaunch_steps']} after the "
          f"theta-only restore; launches of the uninterrupted run "
          f"{json.dumps(ref)}")
    shutil.rmtree(work)
    return ref


# ---------------------------------------------------------------------------
# The mesh round (multi-device): one process a card under NCCL
# ---------------------------------------------------------------------------

# `python -m repro_torch.launch.mesh_round` (the launcher's round
# configuration): internlm2-1.8b at full size, 2 cohorts
MESH_ARGV = ["--arch", "internlm2-1.8b", "--cohorts", str(COHORTS)]
MESH_TIMEOUT = 300            # seconds a rank may take
MESH_STEPS = 4                # partitioned train steps before the round
MICROBATCH, MICRO_STEPS = 2, 2  # the microbatched partitioned steps
DIGEST_PIECE = 1 << 26


def digest(torch, t):
    """Two exact, order-free int64 sums of a tensor's bits on its device:
    the plain sum and one weighted by position mod 8191 + 1 (a piece at
    a time, so the int64 temporaries stay 512 MiB)."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({1: torch.uint8, 2: torch.int16,
                      4: torch.int32}[flat.element_size()])
    d = torch.zeros(2, dtype=torch.int64, device=t.device)
    for j in range(0, bits.numel(), DIGEST_PIECE):
        p = bits[j:j + DIGEST_PIECE].to(torch.int64)
        w = torch.arange(j, j + p.numel(), device=t.device) % 8191 + 1
        d[0] += p.sum()
        d[1] += (p * w).sum()
    return d.tolist()


def state_digests(torch, state, shardings=None):
    """{key: [digest of each tensor leaf]} of scores, floats and opt_m;
    with `shardings`, of this rank's block of each global leaf."""
    from repro_torch.core import tree
    out = {}
    for key in ("scores", "floats", "opt_m"):
        leaves = tree.leaves(state[key])
        shs = (tree.leaves(shardings[key]) if shardings is not None
               else [None] * len(leaves))
        out[key] = [digest(torch, x if sh is None else sh.local(x))
                    for x, sh in zip(leaves, shs) if x is not None]
    return out


def _wire_log(torch, log):
    """A runner for `analysis.comm_model.record_collectives`: each call
    between two CUDA events, logged as (its sites, start event, end
    event)."""
    def run(sites, call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        w = call()
        b.record()
        log.append((sites, a, b))
        return w
    return run


def _wire_totals(log, mesh):
    """{"prim dtype": [calls, bytes sent, bytes received, device ms]}, a
    call keyed by its first operand: an all-gather receives its operand
    from every rank of its group, an all-reduce as much as it sends."""
    out = {}
    for sites, a, b in log:
        t = out.setdefault(f"{sites[0].prim} {sites[0].dtype}",
                           [0, 0, 0, 0.0])
        t[0] += 1
        for site in sites:
            sent = site.bits // 8
            k = math.prod(mesh.axis_size(x) for x in site.axes)
            t[1] += sent
            t[2] += sent * k if site.prim == "all_gather" else sent
        t[3] += a.elapsed_time(b)
    return out


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def moe_config():
    """deepseek-v2-lite-16b at full width cut to MOE_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                               n_layers=MOE_LAYERS)


def moe_routing(cfg, tokens, shape, microbatch=1, block_dispatch=0):
    """A MoE layer's routing on one rank of a partitioned train step, from
    the shapes: `tokens` a cohort's tokens on the rank, `shape` the
    mesh's axis sizes.  The cohort's tokens run as `microbatch` chunks
    (T tokens each, global), a chunk in blocks of T/G where G =
    `block_dispatch` gives blocks of at least 8 tokens, else whole: a
    routing group of L tokens.  The rank runs its tokens as pieces of
    gcd(T, tokens), each holding `groups` whole groups (span 1) or one
    rank's share of a group over `span` data ranks.  The capacity of a
    group and a piece's slots an expert: its groups' capacities, or the
    capacity padded to a multiple of the span."""
    T = tokens * shape["data"] // microbatch
    piece = math.gcd(T, tokens)
    G = block_dispatch
    G = G if G and T % G == 0 and T // G >= 8 else 1
    L = T // G
    check(piece % L == 0 or L % piece == 0, f"routing groups of {L} tokens "
          f"on pieces of {piece}: unaligned")
    groups, span = (piece // L, 1) if piece % L == 0 else (1, L // piece)
    cap = max(int(L * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 4)
    return {"chunk": T, "blocks": G, "group": L, "pieces": tokens // piece,
            "piece": piece, "groups": groups, "span": span, "cap": cap,
            "slots": groups * cap if span == 1 else -(-cap // span) * span}


def moe_expert_sites(cfg, tokens, shape, cohorts, microbatch=1,
                     block_dispatch=0):
    """The collectives a MoE layer's expert layout issues on one rank in
    one partitioned train step (`partition.ExpertLayout.moe`), as
    `dryrun.collective_operands` keys them ({"kind axes dtype":
    {elements: calls}}), and the layer's routing (`moe_routing`).
    `tokens`: a cohort's tokens on the rank; `shape`: the mesh's axis
    sizes; `cohorts`: the rank's cohorts.  Per MoE layer, cohort and
    piece, where a routing group spans k > 1 data ranks (their subgroup
    "data/k", or "data" at k = d_data): the router logits gathered there
    and their gradient reduce-scattered; the slots reduce-scattered
    there forward and gathered backward; the experts' outputs gathered
    there forward (reduce-scattered backward).  Always: the experts'
    outputs gathered over "model"; each expert leaf's w (bf16) and s
    rows gathered over "data" and its ds reduce-scattered there, once a
    piece."""
    dd, dm = shape["data"], shape["model"]
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    El = E // dm
    rt = moe_routing(cfg, tokens, shape, microbatch, block_dispatch)
    k, slots = rt["span"], rt["slots"]
    n = (cfg.n_layers - cfg.first_dense_layers) * cohorts * rt["pieces"]
    out = {}

    def add(key, elems, calls):
        out.setdefault(key, {})
        out[key][str(elems)] = out[key].get(str(elems), 0) + calls
    if k > 1:
        ax = "data" if k == dd else f"data/{k}"
        add(f"all-gather {ax} float32", rt["piece"] * E, n)
        add(f"reduce-scatter {ax} float32", rt["group"] * E, n)
        add(f"reduce-scatter {ax} float32", El * slots * D, 2 * n)
        add(f"all-gather {ax} float32", El * slots // k * D, 2 * n)
    add("all-gather model float32", El * slots * D, n)
    # w_gate and w_up (E, D, F), w_down (E, F, D): alike a rank's rows
    add("all-gather data bfloat16", El * D // dd * F, 3 * n)
    add("all-gather data float32", El * D // dd * F, 3 * n)
    add("reduce-scatter data float32", El * D * F, 3 * n)
    return out, rt


def missing_sites(want, got) -> list:
    """The (key, elements, calls expected, calls recorded) of `want`
    (`moe_expert_sites`) that `got` (`dryrun.collective_operands`) does
    not hold exactly."""
    return [(k, e, c, got.get(k, {}).get(e, 0)) for k, v in want.items()
            for e, c in v.items() if got.get(k, {}).get(e, 0) != c]


def block_sites(state, state_sh, shape, tokens, cohorts, act="bfloat16",
                f32_inputs=(), pieces=1):
    """The collectives one partitioned train step issues on one rank
    (`partition.BlockLayout`, `TrainPlan.gather_floats`) for a state whose
    masked leaves are dense (K, N) or depthwise conv (W, C) layer blocks,
    as `dryrun.collective_operands` keys them ({"kind axes dtype":
    {elements: calls}}), from the global shapes and dtypes of `state`
    (meta tensors do) and its shardings: `shape` the mesh's axis sizes,
    `tokens` a cohort's tokens on the rank, `cohorts` the rank's cohorts,
    `act` the activations' type but for the leaves named in `f32_inputs`
    (the hybrid's gates, on f32), `pieces` the microbatch pieces a cohort
    runs in (`partition.batch_pieces`: tokens / pieces each).  Returns
    (every site, the conv leaves' own).  Per layer block, cohort and
    piece (the w and s gathers are not hoisted out of the piece loop):
    its w (bf16) and s rows gathered over "data" and its ds
    reduce-scattered there (rows held whole: ds all-reduced there);
    where its columns split over "model", a dense block's output columns
    gathered and its dx all-reduced over "model", a conv block's f32
    output channels gathered and its input channels' dx gathered there.
    Per float leaf and cohort: each sharded dim gathered in turn, once
    (the gather precedes the piece loop); the gradient (model dims
    sliced) reduce-scattered over "data" on a data dim, else
    all-reduced, once a piece.  The loss once over the client axes."""
    from repro_torch.core import tree
    dd, dm = shape["data"], shape["model"]
    out, conv = {}, {}

    def add(sites, kind, axes, dtype, elems, calls):
        key = f"{kind} {axes} {str(dtype).removeprefix('torch.')}"
        sites.setdefault(key, {})
        sites[key][str(elems)] = sites[key].get(str(elems), 0) + calls
    for (path, s), sh in zip(tree.flatten_with_paths(state["scores"]),
                             tree.leaves(state_sh["scores"])):
        if s is None:
            continue
        spec = list(sh.spec) + [None] * (s.ndim - len(sh.spec))
        rows, cols = spec[-2] == "data", spec[-1] == "model"
        K, N = s.shape[-2:]
        kl, nl = K // dd if rows else K, N // dm if cols else N
        n = math.prod(s.shape[1:-2]) * cohorts * pieces
        t = tokens // pieces
        is_conv = path.endswith("conv/w_conv")
        x = "float32" if path.rsplit("/", 1)[-1] in f32_inputs else act
        for sites in (out, conv) if is_conv else (out,):
            if rows:
                add(sites, "all-gather", "data", "bfloat16", kl * nl, n)
                add(sites, "all-gather", "data", s.dtype, kl * nl, n)
                add(sites, "reduce-scatter", "data", s.dtype, K * nl, n)
            else:
                add(sites, "all-reduce", "data", s.dtype, K * nl, n)
            if cols and is_conv:
                add(sites, "all-gather", "model", "float32", t * nl, n)
                add(sites, "all-gather", "model", x, t * nl, n)
            elif cols:
                add(sites, "all-gather", "model", x, t * nl, n)
                add(sites, "all-reduce", "model", x, t * K, n)
    for f, sh in zip(tree.leaves(state["floats"]),
                     tree.leaves(state_sh["floats"])):
        if f is None:
            continue
        parts = list(sh.spec)[1:] + [None] * (f.ndim - len(sh.spec))
        dims = [d // {"data": dd, "model": dm}.get(p, 1)
                for d, p in zip(f.shape[1:], parts)]
        for i, p in enumerate(parts):
            if p is not None:
                add(out, "all-gather", p, f.dtype, math.prod(dims), cohorts)
                dims[i] = f.shape[1 + i]
        grad = math.prod(d // dm if p == "model" else d
                         for d, p in zip(f.shape[1:], parts))
        add(out, "reduce-scatter" if "data" in parts else "all-reduce",
            "data", f.dtype, grad, cohorts * pieces)
    add(out, "all-reduce", "x".join(a for a in ("pod", "data") if a in shape),
        "float32", 1, 1)
    return out, conv


def moe_step_sites(cfg, state, state_sh, shape, tokens, cohorts,
                   act="bfloat16", microbatch=1, block_dispatch=0):
    """Every collective one partitioned train step of a moe arch issues on
    one rank, keyed as `block_sites` keys them: `block_sites` of its
    dense leaves and floats, `moe_expert_sites` of its expert layouts,
    and per MoE layer, cohort and piece the dispatch's dx all-reduced
    over "model" (the rank's experts' partial gradient of the piece's
    tokens).  Returns (the sites, the routing)."""
    from repro_torch.core import tree
    dense = dict(state, scores=tree.tree_map(
        lambda s: None if s is None or s.ndim == 5 else s, state["scores"]))
    rt = moe_routing(cfg, tokens, shape, microbatch, block_dispatch)
    out, _ = block_sites(dense, state_sh, shape, tokens, cohorts, act,
                         pieces=rt["pieces"])
    experts, _ = moe_expert_sites(cfg, tokens, shape, cohorts, microbatch,
                                  block_dispatch)
    n = (cfg.n_layers - cfg.first_dense_layers) * cohorts * rt["pieces"]
    experts.setdefault(f"all-reduce model {act}", {})
    experts[f"all-reduce model {act}"][str(rt["piece"] * cfg.d_model)] = n
    for key, calls in experts.items():
        for e, c in calls.items():
            out.setdefault(key, {})
            out[key][e] = out[key].get(e, 0) + c
    return {k: dict(sorted(v.items(), key=lambda kv: int(kv[0])))
            for k, v in sorted(out.items())}, rt


def stub_mesh(shape):
    """A stand-in for `launch.mesh.Mesh` that `steps.fed_state_shardings`
    reads: its axis names and sizes (`shape`, in mesh order)."""
    return type("Stub", (), {"shape": dict(shape),
                             "axis_names": tuple(shape),
                             "coords": dict.fromkeys(shape, 0)})()


def _train_compare(torch, mesh, api, host, sh, tcfg, batches, res, tag,
                   profiled):
    """`len(batches)` train steps of `tcfg` on this rank's block of `host`
    (`make_train_step(api, tcfg, mesh, sh)`, batches cut to the rank's
    rows) and as many `mesh=None` steps on the whole state, one state on
    the card at a time.  Writes into `res` under `tag` and `tag`_plain /
    `tag`_mesh: each side's losses (and their f32 bits), seconds, peak
    GiB, launches and digests, the first partitioned step's collectives
    (count, bytes by kind and axes, calls by operand, calls and device ms
    by kind); with
    `profiled`, one more step of each under torch.profiler (wall ms,
    device busy ms, collective calls)."""
    from repro_torch.analysis import comm_model
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as steplib
    from repro_torch.runtime import elastic
    from torch.profiler import ProfilerActivity, profile
    rows = shd.NamedSharding(mesh, shd.P("pod", "data"))
    for side in ("plain", "mesh"):
        key = f"{tag}_{side}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        part = side == "mesh"
        st = elastic.reshard_server(host, sh if part else mesh.device)
        fn = (steplib.make_train_step(api, tcfg, mesh, sh) if part
              else steplib.make_train_step(api, tcfg))
        dispatch.reset_launch_counts()
        losses, bits, secs, log = [], [], [], []
        for i, b in enumerate(batches):
            if part:
                b = {k: rows.local(v) for k, v in b.items()}
            rec = (comm_model.record_collectives(
                mesh, run=_wire_log(torch, log)) if part and i == 0
                else contextlib.nullcontext([]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rec as sites:
                st, m = fn(st, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            bits.append(int(m["loss"].detach().float().reshape(1).view(
                torch.int32).item()))
            if sites:
                res[f"{tag}_sites"] = len(sites)
                res[f"{tag}_axes"] = dryrun.collective_axes(sites)
                res[f"{tag}_operands"] = dryrun.collective_operands(sites)
                res[f"{tag}_wire"] = _wire_totals(log, mesh)
        res[f"{key}_launches"] = dict(dispatch.LAUNCHES)
        res[f"{key}_losses"], res[f"{key}_s"] = losses, secs
        res[f"{key}_loss_bits"] = bits
        res[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res[key] = state_digests(torch, st, None if part else sh)
        if profiled:
            # one more step under torch.profiler, after the digests: its
            # wall ms, the device's busy ms and the collective calls
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                st, m = fn(st, b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ka = prof.key_averages()
            res[f"{key}_profile"] = [
                wall * 1e3,
                sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3,
                sum(e.count for e in ka if e.key.startswith("c10d::"))]
            del prof, ka
        del st, fn, m
    torch.cuda.empty_cache()


def mesh_rank(rank, world, store, out_path):
    """One rank of `mesh_phase`: NCCL on card `rank`.  The host-global
    state is drawn once from the launcher's seed (on the card, then moved
    to the host), cohort c's float rows
    shifted by c in their own type (at init every cohort's rows are the
    same, and a mean over cohorts could not be told from a row kept; the
    bf16 tables stay bf16, so the train steps see the launcher's bf16
    activations).  From it: (1) the
    plain (`mesh=None`) round on the whole state placed on the card,
    digests of this rank's blocks; (2) the mesh round through
    `repro_torch.launch.mesh_round.run` on this rank's block, its
    launches, peak memory, digests and wire, recorded by
    `analysis.comm_model.record_collectives` with CUDA events around each
    call: its cost model and wire purity; (3) the unpacked bf16 baseline
    likewise; (4) a bitpack-codec round's comm model against its meter,
    and the shard lint's declared vs held; (5) `mask_mean_packed` with
    kernel 10 against its plain version on one internlm2 layer's masks;
    (6) MESH_STEPS partitioned train steps (`make_train_step(api, cfg,
    mesh, state_sh)`, the launcher's configuration and batches) on this
    rank's block beside MESH_STEPS `mesh=None` steps on the whole state,
    one after the other: losses, seconds, peak memory, launches, digests,
    the first partitioned step's collectives, and one more step of each
    under torch.profiler (wall, device busy, collective calls), then
    MICRO_STEPS steps both ways at microbatch MICROBATCH (`micro`); (7)
    the same MESH_STEPS steps both ways for deepseek-v2-lite-16b at full
    width cut to MOE_LAYERS layers (its expert leaves through
    `partition.ExpertLayout`), without the profiled step, then
    MICRO_STEPS steps both ways at microbatch MICROBATCH with
    `moe_block_dispatch` = BLOCK_DISPATCH (`moe_micro`); (8) the same for
    mamba2-370m at all MAMBA_LAYERS layers (its conv leaves through
    `partition.BlockLayout.conv`), the phase's seconds beside.
    Writes a JSON of what it found; raises on any failed check."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import collective_lint, comm_model, shard_lint
    from repro_torch.core import aggregation, tree
    from repro_torch.kernels import bitpack, dispatch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import mesh_round
    from repro_torch.launch import steps as steplib
    from repro_torch.models import build_model
    from repro_torch.runtime import elastic
    dev = meshlib.init("cuda", store=dist.FileStore(store, world), rank=rank,
                       world_size=world)
    try:
        mesh = meshlib.make_debug_pod_mesh()
        args = mesh_round.parse_args(MESH_ARGV)
        res = {"shape": mesh.shape, "backend": mesh.backend,
               "coords": mesh.coords}
        # NCCL sets a communicator up at a group's first collective: do
        # that off the clock, for the two groups the round uses
        aggregation.all_gather_rows(torch.zeros(1, device=dev),
                                    mesh.group("pod"))
        dist.all_reduce(torch.zeros(1, device=dev),
                        group=mesh.group(mesh.axis_names))
        for axes in (("data",), ("model",), ("pod", "data")):
            dist.all_reduce(torch.zeros(1, device=dev),
                            group=mesh.group(axes))
        # and one SMOKE round loads the round's kernels, so no round
        # below pays a first call's costs
        mesh_round.run(mesh_round.parse_args(MESH_ARGV + ["--smoke"]), mesh)

        t0 = time.perf_counter()
        api, host = mesh_round.global_state(args.arch, args.cohorts,
                                            smoke=args.smoke,
                                            draw_device=dev)
        torch.cuda.empty_cache()
        host["floats"] = tree.tree_map(
            lambda t: None if t is None else (t + torch.arange(
                float(COHORTS)).view((-1,) + (1,) * (t.ndim - 1))).to(
                    t.dtype), host["floats"])
        res["draw_s"] = time.perf_counter() - t0
        sh = steplib.fed_state_shardings(host, mesh)
        start = elastic.reshard_server(host["floats"], sh["floats"])
        res["start_floats"] = [digest(torch, x) for x in tree.leaves(start)
                               if x is not None]
        del start
        st = elastic.reshard_server(host, dev)
        plain = steplib.make_round_step(api, mesh_round.step_config(args),
                                        codec=mesh_round.CODEC)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = plain(st)
        torch.cuda.synchronize()
        res["plain_s"] = time.perf_counter() - t0
        res["plain_metrics"] = {k: float(v) for k, v in m.items()}
        res["plain"] = state_digests(torch, st, sh)
        del st, m, plain
        torch.cuda.empty_cache()

        for tag, argv in (("mesh", MESH_ARGV),
                          ("unpacked", MESH_ARGV + ["--unpacked"])):
            log = []
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_launch_counts()
            margs = mesh_round.parse_args(argv)
            with comm_model.record_collectives(
                    mesh, run=_wire_log(torch, log)) as sites:
                out = mesh_round.run(margs, mesh, (api, host))
            res[f"{tag}_launches"] = dict(dispatch.LAUNCHES)
            torch.cuda.synchronize()
            res[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            res[f"{tag}_s"] = out["seconds"]
            res[f"{tag}_metrics"] = out["metrics"]
            res[f"{tag}_wire"] = _wire_totals(log, mesh)
            res[tag] = state_digests(torch, out["state"])
            # the recorded round's cost model and wire purity
            model = comm_model.round_comm_model(
                sites, host, sh, mesh, mesh_round.step_config(margs))
            res[f"{tag}_comm"] = {k: model[k] for k in (
                "n_sites", "uplink_bits", "bpp_wire", "mask_params",
                "ring_bytes_per_axis", "ring_bytes_per_prim")}
            res[f"{tag}_roles"] = sorted(
                f"{r['prim']} {r['dtype']} {r['role']}"
                for r in model["sites"])
            res[f"{tag}_purity"] = [str(f) for f in
                                    collective_lint.round_purity_findings(
                                        sites, host, sh, mesh)]
            del out, log, sites
            torch.cuda.empty_cache()
        # (6) the partitioned train step (`launch.partition`): MESH_STEPS
        # steps of the launcher's configuration and batches on this
        # rank's block against mesh=None from the same start, one state on
        # the card at a time (two do not fit beside the activations), held
        # by digests; the first partitioned step's collectives recorded
        targs = mesh_round.parse_args(MESH_ARGV + ["--steps",
                                                   str(MESH_STEPS)])
        tcfg = mesh_round.step_config(targs)
        batches = [mesh_round.step_batch(targs, api, i, dev)
                   for i in range(MESH_STEPS)]
        _train_compare(torch, mesh, api, host, sh, tcfg, batches, res,
                       "train", profiled=True)
        # microbatches on the mesh: each rank's rows as pieces inside the
        # global chunks, each at its chunk's tick
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(tcfg, microbatch=MICROBATCH)
        _train_compare(torch, mesh, api, host, sh, mcfg,
                       batches[:MICRO_STEPS], res, "micro", profiled=False)
        res["micro_phase_s"] = time.perf_counter() - t0
        del batches

        # the comm model's uplink bits against the bits the round meters
        # under the bitpack codec, and declared vs held on the placed
        # state (its contents at 4096 positions a leaf)
        t0 = time.perf_counter()
        model = comm_model.arch_round_comm_model(
            "internlm2-1.8b", mesh=mesh, C=COHORTS, start=(api, host))
        res["bitpack_uplink_bits"] = model["uplink_bits"]
        res["bitpack_metered_bits"] = model.pop("_run")[-1]["bits_measured"]
        torch.cuda.empty_cache()
        rep = shard_lint.round_shard_report(mesh, COHORTS, start=(api, host),
                                            positions=4096)
        res["shard_findings"] = [str(f) for f in rep["findings"]]
        res["shard_leaves"] = rep["n_leaves"]
        res["comm_shard_s"] = time.perf_counter() - t0
        del host, model, rep
        torch.cuda.empty_cache()

        # (7) the MoE family's partitioned train step: deepseek-v2-lite-16b
        # at full width cut to MOE_LAYERS layers, the launcher's cohorts
        # and batches, MESH_STEPS steps on this rank's block against
        # mesh=None from one host state drawn on the card
        t0 = time.perf_counter()
        api, host = mesh_round.global_state(
            "deepseek-v2-lite-16b", COHORTS, draw_device=dev,
            n_layers=MOE_LAYERS)
        torch.cuda.empty_cache()
        res["moe_draw_s"] = time.perf_counter() - t0
        batches = [mesh_round.step_batch(targs, api, i, dev)
                   for i in range(MESH_STEPS)]
        _train_compare(torch, mesh, api, host,
                       steplib.fed_state_shardings(host, mesh), tcfg,
                       batches, res, "moe", profiled=False)
        # microbatches and block-local dispatch: each piece's routing
        # groups the global chunk's blocks
        t0 = time.perf_counter()
        _train_compare(torch, mesh, build_model(dataclasses.replace(
            api.cfg, moe_block_dispatch=BLOCK_DISPATCH)), host,
            steplib.fed_state_shardings(host, mesh), mcfg,
            batches[:MICRO_STEPS], res, "moe_micro", profiled=False)
        res["moe_micro_phase_s"] = time.perf_counter() - t0
        del api, host, batches

        # (8) the ssm family's partitioned train step: mamba2-370m at all
        # its layers, the launcher's cohorts and batches, MESH_STEPS steps
        # on this rank's block (its conv leaves on the rank's channels)
        # against mesh=None from one host state drawn on the card
        t0 = time.perf_counter()
        api, host = mesh_round.global_state("mamba2-370m", COHORTS,
                                            draw_device=dev)
        torch.cuda.empty_cache()
        res["ssm_draw_s"] = time.perf_counter() - t0
        batches = [mesh_round.step_batch(targs, api, i, dev)
                   for i in range(MESH_STEPS)]
        _train_compare(torch, mesh, api, host,
                       steplib.fed_state_shardings(host, mesh), tcfg,
                       batches, res, "ssm", profiled=False)
        res["ssm_phase_s"] = time.perf_counter() - t0
        del api, host, batches

        # kernel 10 in mask_mean_packed: one layer's masks of each leaf
        gen = torch.Generator(device=dev).manual_seed(29)
        masks = {k: (torch.rand(s, generator=gen, device=dev) < 0.5).to(
            torch.uint8) for k, s in LAYER_SHAPES.items()}
        clients = mesh.group(("pod", "data"))
        dispatch.reset_launch_counts()
        got = aggregation.mask_mean_packed(masks, clients, True)
        torch.cuda.synchronize()
        res["mean_launches"] = dict(dispatch.LAUNCHES)
        want = aggregation.mask_mean_packed(masks, clients, False)
        res["mean_equal"] = all(torch.equal(got[k], want[k]) for k in masks)
        res["words_equal"] = all(torch.equal(
            bitpack.pack_bits(m.reshape(-1)),
            bitpack.pack_bits_plain(m.reshape(-1))) for m in masks.values())
        Path(out_path).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, dispatch):
    """(f) the mesh round under NCCL, one process a card
    (`torch.cuda.device_count()`, so one rank on a one-card machine, a
    (1, 1, 1) mesh): internlm2-1.8b at full size, 2 cohorts, the
    launcher's round configuration, on a host-drawn state whose cohorts'
    float rows differ.  On a mesh of one rank the mesh round equals the
    `mesh=None` round from the same state, every score and moment digest
    and every metric, while its floats keep each cohort's row (the
    reference's pod-only float mean) where `mesh=None` averages them; on
    any mesh the unpacked baseline's scores equal the
    packed round's (theta is a mean of two bits, exact in bf16, and both
    cross the same downlink draws), and kernel 10 in `mask_mean_packed`
    gives its plain version's words and mean.  The recorded wire
    (`analysis`): the packed round pure and at 1 bit a parameter and
    cohort plus word padding, the bf16 baseline impure once a mask leaf,
    no ring bytes on an axis of size 1, a bitpack round's uplink bits
    equal to its meter, no shard-lint finding.  The main path's launches
    (the mesh round: kernel 4 and 11 once a masked leaf; the mask mean:
    10 and 11 once a leaf) must be exact.  The partitioned train steps
    of internlm2-1.8b and of deepseek-v2-lite-16b at MOE_LAYERS layers:
    on one rank the `mesh=None` steps bit for bit (digests and losses),
    kernels 1-3 (and 5-7 for the experts) launched once a projection,
    layer, local cohort and step, the expert layout's collectives each
    of the closed form's operand size and count (`moe_expert_sites`).
    The partitioned train steps of mamba2-370m at all its layers: on one
    rank the `mesh=None` steps bit for bit (digests, and the losses by
    their bits: the launcher's lr diverges mamba2 in both packages, and a
    NaN must neither fail the check nor hide a difference), kernels 1-3
    once a dense projection, layer, local cohort and step, kernel 8
    twice a conv and 9 once, every collective of the first step as the
    closed form gives it (`block_sites`, the conv leaves' among them).
    The microbatched steps (MICRO_STEPS at MICROBATCH, a rank's rows as
    pieces inside the global chunks) of internlm2-1.8b and of
    deepseek-v2-lite-16b with `moe_block_dispatch` = BLOCK_DISPATCH: on
    one rank the `mesh=None` steps bit for bit (digests and loss bits),
    the kernels once a projection, layer, local cohort, piece and step,
    every collective of the first step as `block_sites` (pieces) and
    `moe_step_sites` give them.  Returns the launches, summed over the
    ranks."""
    import multiprocessing

    from repro_torch.analysis import stream_cover
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh_round
    from repro_torch.launch import steps as steplib
    world = torch.cuda.device_count()
    work = _scratch("chip_smoke_mesh")
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.time()
    procs = [ctx.Process(target=mesh_rank, args=(
        r, world, str(work / "store"), str(work / f"rank{r}.json")))
        for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(MESH_TIMEOUT)
            check(not p.is_alive(), "mesh phase: a rank did not finish")
            check(p.exitcode == 0, f"mesh phase: a rank exited with "
                  f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    wall = time.time() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(world)]
    leaves = len(LAYER_SHAPES)
    launches = {k: 0 for k in dispatch.KERNELS}
    for r, x in enumerate(res):
        want = {k: 0 for k in dispatch.KERNELS}
        want.update(sample_and_pack=leaves, unpack_bits=leaves)
        check(x["mesh_launches"] == want, f"mesh round rank {r} launches "
              f"{x['mesh_launches']}, expected {want}")
        check(not any(x["unpacked_launches"].values()),
              f"the unpacked baseline launched {x['unpacked_launches']}")
        want = {k: 0 for k in dispatch.KERNELS}
        want.update(pack_bits=leaves, unpack_bits=leaves)
        check(x["mean_launches"] == want, f"mask_mean_packed rank {r} "
              f"launches {x['mean_launches']}, expected {want}")
        check(x["mean_equal"] and x["words_equal"], f"mask_mean_packed on "
              f"kernel 10 differs from its plain version on rank {r}")
        # the partitioned train steps: kernels 1-3 once a projection, layer,
        # local cohort and step, nothing else
        want = {k: 0 for k in dispatch.KERNELS}
        n = N_LAYERS * leaves * (COHORTS // x["shape"]["pod"]) * MESH_STEPS
        want.update(masked_matmul_fwd=n, masked_matmul_dx=n,
                    masked_matmul_ds=n)
        check(x["train_mesh_launches"] == want, f"partitioned train steps "
              f"rank {r} launched {x['train_mesh_launches']}, expected "
              f"{want}")
        # the MoE steps: kernels 1-3 once a dense projection (MLA 5, the
        # dense or shared MLP 3), layer, local cohort and step; kernels
        # 5-7 once an expert projection, MoE layer, local cohort and step
        local = COHORTS // x["shape"]["pod"]
        want = {k: 0 for k in dispatch.KERNELS}
        n = 8 * MOE_LAYERS * local * MESH_STEPS
        want.update(masked_matmul_fwd=n, masked_matmul_dx=n,
                    masked_matmul_ds=n)
        n = 3 * (MOE_LAYERS - 1) * local * MESH_STEPS
        want.update(masked_matmul_grouped=n, masked_matmul_grouped_dx=n,
                    masked_matmul_grouped_ds=n)
        check(x["moe_mesh_launches"] == want, f"partitioned MoE steps rank "
              f"{r} launched {x['moe_mesh_launches']}, expected {want}")
        for tag in ("train", "moe"):
            check(len(set(x[f"{tag}_mesh_losses"])) == MESH_STEPS and all(
                math.isfinite(v) for v in x[f"{tag}_mesh_losses"]),
                  f"rank {r}: partitioned losses {x[f'{tag}_mesh_losses']}")
            for kind, axes in (("all-gather", "data"),
                               ("all-gather", "model"),
                               ("all-reduce", "model"),
                               ("reduce-scatter", "data")):
                check(x[f"{tag}_axes"].get(f"{kind} {axes}", 0) > 0,
                      f"rank {r}: no {kind} over {axes} in the partitioned "
                      f"{tag} step: {x[f'{tag}_axes']}")
        # the expert layout's collectives, each operand size and count
        tokens = mesh_round.BATCH // x["shape"]["data"] * mesh_round.SEQ
        moe_sites, rt = moe_expert_sites(moe_config(), tokens, x["shape"],
                                         local)
        cap, slots = rt["cap"], rt["slots"]
        miss = missing_sites(moe_sites, x["moe_operands"])
        check(not miss, f"rank {r}: the partitioned MoE step's expert "
              f"collectives (kind, elements, expected, recorded): {miss}")
        # the microbatched steps: kernels once a projection, layer, local
        # cohort, piece and step (a rank's rows as pieces inside the
        # global chunks, `partition.batch_pieces`); every collective of
        # the first step as the closed forms give them
        rows = mesh_round.BATCH // x["shape"]["data"]
        pieces = rows // math.gcd(mesh_round.BATCH // MICROBATCH, rows)
        want = {k: 0 for k in dispatch.KERNELS}
        n = N_LAYERS * leaves * local * pieces * MICRO_STEPS
        want.update(masked_matmul_fwd=n, masked_matmul_dx=n,
                    masked_matmul_ds=n)
        check(x["micro_mesh_launches"] == want, f"microbatched partitioned "
              f"steps rank {r} launched {x['micro_mesh_launches']}, "
              f"expected {want}")
        want = {k: 0 for k in dispatch.KERNELS}
        n = 8 * MOE_LAYERS * local * pieces * MICRO_STEPS
        want.update(masked_matmul_fwd=n, masked_matmul_dx=n,
                    masked_matmul_ds=n)
        n = 3 * (MOE_LAYERS - 1) * local * pieces * MICRO_STEPS
        want.update(masked_matmul_grouped=n, masked_matmul_grouped_dx=n,
                    masked_matmul_grouped_ds=n)
        check(x["moe_micro_mesh_launches"] == want, f"microbatched "
              f"partitioned MoE steps rank {r} launched "
              f"{x['moe_micro_mesh_launches']}, expected {want}")
        _, meta = stream_cover.meta_fed_state(get_config("internlm2-1.8b"),
                                              COHORTS)
        micro_sites, _ = block_sites(
            meta, steplib.fed_state_shardings(meta, stub_mesh(x["shape"])),
            x["shape"], tokens, local, pieces=pieces)
        check(x["micro_operands"] == micro_sites, f"rank {r}: the "
              f"microbatched partitioned step's collectives "
              f"{x['micro_operands']}, the closed form {micro_sites}")
        mcfg = dataclasses.replace(moe_config(),
                                   moe_block_dispatch=BLOCK_DISPATCH)
        _, meta = stream_cover.meta_fed_state(mcfg, COHORTS)
        moe_micro_sites, mrt = moe_step_sites(
            mcfg, meta, steplib.fed_state_shardings(
                meta, stub_mesh(x["shape"])), x["shape"], tokens, local,
            microbatch=MICROBATCH, block_dispatch=BLOCK_DISPATCH)
        check(mrt["pieces"] == pieces, f"rank {r}: {mrt} against {pieces} "
              f"pieces")
        check(x["moe_micro_operands"] == moe_micro_sites, f"rank {r}: the "
              f"microbatched block-dispatched MoE step's collectives "
              f"{x['moe_micro_operands']}, the closed form "
              f"{moe_micro_sites}")
        for tag in ("micro", "moe_micro"):
            check(len(x[f"{tag}_mesh_losses"]) == MICRO_STEPS and all(
                math.isfinite(v) for v in x[f"{tag}_mesh_losses"]),
                  f"rank {r}: {tag} losses {x[f'{tag}_mesh_losses']}")
        # the ssm steps: kernels 1-3 once a dense projection (w_in, w_out),
        # layer, local cohort and step; kernel 8 twice a conv (forward,
        # flipped dx), 9 once
        want = {k: 0 for k in dispatch.KERNELS}
        n = 2 * MAMBA_LAYERS * local * MESH_STEPS
        want.update(masked_matmul_fwd=n, masked_matmul_dx=n,
                    masked_matmul_ds=n, masked_conv1d=n,
                    masked_conv1d_ds=n // 2)
        check(x["ssm_mesh_launches"] == want, f"partitioned ssm steps rank "
              f"{r} launched {x['ssm_mesh_launches']}, expected {want}")
        _, meta = stream_cover.meta_fed_state(get_config("mamba2-370m"),
                                              COHORTS)
        ssm_sites, ssm_conv = block_sites(
            meta, steplib.fed_state_shardings(meta, stub_mesh(x["shape"])),
            x["shape"], mesh_round.BATCH // x["shape"]["data"]
            * mesh_round.SEQ, local)
        check(x["ssm_operands"] == ssm_sites, f"rank {r}: the partitioned "
              f"ssm step's collectives {x['ssm_operands']}, the closed form "
              f"{ssm_sites}")
        check(len(x["ssm_mesh_loss_bits"]) == MESH_STEPS, f"rank {r}: ssm "
              f"losses {x['ssm_mesh_losses']}")
        check(x["unpacked"]["scores"] == x["mesh"]["scores"],
              f"rank {r}: the unpacked theta differs from the packed one")
        if world == 1:
            # two cohorts on a pod of one: the mesh round's pod mean keeps
            # each cohort's float rows, `mesh=None` averages them
            for key in ("scores", "opt_m"):
                check(x["mesh"][key] == x["plain"][key], f"the mesh round's "
                      f"{key} differ from the mesh=None round's")
            check(x["mesh"]["floats"] == x["start_floats"], "the mesh "
                  "round's floats are not the start's rows")
            check(x["plain"]["floats"] != x["start_floats"], "the "
                  "mesh=None round's floats kept the start's rows")
            check(x["mesh_metrics"] == x["plain_metrics"],
                  f"mesh metrics {x['mesh_metrics']} differ from "
                  f"mesh=None's {x['plain_metrics']}")
            # one rank holds every block: the partitioned steps are the
            # mesh=None steps bit for bit
            check(x["train_mesh"] == x["train_plain"], "the partitioned "
                  "train steps' scores, moments or floats differ from "
                  "mesh=None's")
            check(x["train_mesh_losses"] == x["train_plain_losses"],
                  f"partitioned losses {x['train_mesh_losses']} against "
                  f"mesh=None's {x['train_plain_losses']}")
            check(x["moe_mesh"] == x["moe_plain"], "the partitioned MoE "
                  "train steps' scores, moments or floats differ from "
                  "mesh=None's")
            check(x["moe_mesh_losses"] == x["moe_plain_losses"],
                  f"partitioned MoE losses {x['moe_mesh_losses']} against "
                  f"mesh=None's {x['moe_plain_losses']}")
            for tag in ("micro", "moe_micro"):
                check(x[f"{tag}_mesh"] == x[f"{tag}_plain"], f"the "
                      f"partitioned {tag} train steps' scores, moments or "
                      f"floats differ from mesh=None's")
                check(x[f"{tag}_mesh_loss_bits"]
                      == x[f"{tag}_plain_loss_bits"], f"partitioned {tag} "
                      f"losses {x[f'{tag}_mesh_losses']} against "
                      f"mesh=None's {x[f'{tag}_plain_losses']} (by their "
                      f"bits)")
            check(x["ssm_mesh"] == x["ssm_plain"], "the partitioned ssm "
                  "train steps' scores, moments or floats differ from "
                  "mesh=None's")
            check(x["ssm_mesh_loss_bits"] == x["ssm_plain_loss_bits"],
                  f"partitioned ssm losses {x['ssm_mesh_losses']} against "
                  f"mesh=None's {x['ssm_plain_losses']} (by their bits)")
        # the recorded rounds: the packed wire clean and at 1 bit a
        # parameter and cohort (plus word padding: <= 32 bits a leaf,
        # cohort and shard), the bf16 baseline firing once a mask leaf at
        # 16 bits a parameter and shard (its local cohorts are averaged
        # before they cross, so 16 / cohorts-a-shard a cohort); no ring
        # traffic on an axis of size 1; the uplink bits equal
        # to what the round meters under the bitpack codec; every placed
        # leaf the block its sharding names
        check(x["mesh_purity"] == [], f"rank {r}: the packed round's wire "
              f"is impure: {x['mesh_purity']}")
        check(len(x["unpacked_purity"]) == leaves and all(
            "[collective-f32-weight]" in f for f in x["unpacked_purity"]),
              f"rank {r}: the unpacked baseline's purity findings "
              f"{x['unpacked_purity']}")
        slack = 32 * leaves * world / x["mesh_comm"]["mask_params"]
        check(x["mesh_comm"]["bpp_wire"] <= 1 + slack, f"rank {r}: packed "
              f"bpp_wire {x['mesh_comm']['bpp_wire']} > 1 + {slack}")
        local = COHORTS // x["shape"]["pod"]
        check(x["unpacked_comm"]["bpp_wire"] == 16.0 / local, f"rank {r}: "
              f"unpacked bpp_wire {x['unpacked_comm']['bpp_wire']}, "
              f"expected 16 / {local}")
        for tag in ("mesh", "unpacked"):
            for ax, v in x[f"{tag}_comm"]["ring_bytes_per_axis"].items():
                if all(x["shape"][a] == 1 for a in ax.split("x")):
                    check(v == 0.0, f"rank {r}: {v} ring bytes on {ax}, "
                          f"an axis of size 1")
        check(x["bitpack_uplink_bits"] == x["bitpack_metered_bits"],
              f"rank {r}: comm model uplink bits "
              f"{x['bitpack_uplink_bits']} against the metered "
              f"{x['bitpack_metered_bits']}")
        check(x["shard_findings"] == [], f"rank {r}: shard lint "
              f"{x['shard_findings']}")
        for k in launches:
            launches[k] += (x["mesh_launches"][k] + x["mean_launches"][k]
                            + x["train_mesh_launches"][k]
                            + x["moe_mesh_launches"][k]
                            + x["ssm_mesh_launches"][k]
                            + x["micro_mesh_launches"][k]
                            + x["moe_micro_mesh_launches"][k])
    check(len({json.dumps(x["mesh_metrics"]["bits_measured"])
               for x in res}) == 1, "ranks disagree on bits_measured")
    x = res[0]
    g = x["mesh_wire"].get("all_gather int32", [0, 0, 0, 0.0])
    ru = x["unpacked_wire"].get("psum bfloat16", [0, 0, 0, 0.0])
    print(f"mesh phase: {wall:.1f}s, {world} rank(s), mesh {x['shape']}, "
          f"backend {x['backend']}; internlm2-1.8b round, {COHORTS} "
          f"cohorts, the host state drawn in {x['draw_s']:.3f} s: mesh {x['mesh_s']:.3f} s, mesh=None {x['plain_s']:.3f}"
          f" s, unpacked baseline {x['unpacked_s']:.3f} s; the packed "
          f"round's all-gathers: {g[0]} calls, {g[1]} bytes sent, {g[2]} "
          f"received, {g[3]:.3f} device ms; the unpacked round's bf16 "
          f"all-reduces: {ru[0]} calls, {ru[1]} bytes, {ru[3]:.3f} device "
          f"ms; every collective {json.dumps(x['mesh_wire'])} and "
          f"{json.dumps(x['unpacked_wire'])}; peak "
          f"{x['mesh_peak_gib']:.2f} GiB (unpacked "
          f"{x['unpacked_peak_gib']:.2f}); metrics "
          f"{json.dumps(x['mesh_metrics'])}; scores and moments equal to "
          f"mesh=None's and floats the start's rows (mesh=None's their "
          f"mean): {world == 1}; unpacked theta equal to packed; "
          f"kernel 10 in mask_mean_packed equal to its plain version")
    steady = lambda ts: sum(ts[1:]) / (len(ts) - 1)
    print(f"mesh phase, partitioned train steps (internlm2-1.8b, "
          f"{COHORTS} cohorts, batch 2 x 128, {MESH_STEPS} steps): "
          f"partitioned {_fmt(x['train_mesh_s'])} s (steps 2-{MESH_STEPS} "
          f"{steady(x['train_mesh_s']):.4f} s a step), mesh=None "
          f"{_fmt(x['train_plain_s'])} s ({steady(x['train_plain_s']):.4f}"
          f" s); overhead {steady(x['train_mesh_s']) / steady(x['train_plain_s']) - 1:+.2%}; peak "
          f"{x['train_mesh_peak_gib']:.2f} GiB against "
          f"{x['train_plain_peak_gib']:.2f}; losses {x['train_mesh_losses']}"
          f" (mesh=None {x['train_plain_losses']}); digests equal: "
          f"{x['train_mesh'] == x['train_plain']}; the first step's "
          f"{x['train_sites']} collectives, bytes by kind and axes "
          f"{json.dumps(x['train_axes'])}, calls {json.dumps(x['train_wire'])}")
    mw = x["moe_wire"]
    print(f"mesh phase, partitioned MoE train steps (deepseek-v2-lite-16b "
          f"at full width, {MOE_LAYERS} layers, {COHORTS} cohorts, batch 2 "
          f"x 128: capacity {cap}, {slots} slots a data rank's share of "
          f"{x['shape']['data']}; state drawn in {x['moe_draw_s']:.3f} s; "
          f"{smi_line()}): partitioned {_fmt(x['moe_mesh_s'])} s (steps "
          f"2-{MESH_STEPS} {steady(x['moe_mesh_s']):.4f} s a step), "
          f"mesh=None {_fmt(x['moe_plain_s'])} s "
          f"({steady(x['moe_plain_s']):.4f} s); overhead "
          f"{steady(x['moe_mesh_s']) / steady(x['moe_plain_s']) - 1:+.2%}; "
          f"peak {x['moe_mesh_peak_gib']:.2f} GiB against "
          f"{x['moe_plain_peak_gib']:.2f}; losses {x['moe_mesh_losses']} "
          f"(mesh=None {x['moe_plain_losses']}); digests equal: "
          f"{x['moe_mesh'] == x['moe_plain']}; the first step's "
          f"{x['moe_sites']} collectives ({sum(v[0] for v in mw.values())} "
          f"calls, {sum(v[1] for v in mw.values())} bytes sent), bytes by "
          f"kind and axes {json.dumps(x['moe_axes'])}, calls, bytes sent, "
          f"received and device ms by kind {json.dumps(mw)}; the expert "
          f"layout's {sum(sum(v.values()) for v in moe_sites.values())} "
          f"collectives as the closed form gives them")
    sw = x["ssm_wire"]
    conv_calls = sum(sum(v.values()) for v in ssm_conv.values())
    conv_bytes = sum(int(e) * c * (2 if "bfloat16" in k else 4)
                     for k, v in ssm_conv.items() for e, c in v.items())
    print(f"mesh phase, partitioned ssm train steps (mamba2-370m, all "
          f"{MAMBA_LAYERS} layers, {COHORTS} cohorts, batch 2 x 128; state "
          f"drawn in {x['ssm_draw_s']:.3f} s, the whole step (8) "
          f"{x['ssm_phase_s']:.1f} s; {smi_line()}): partitioned "
          f"{_fmt(x['ssm_mesh_s'])} s (steps 2-{MESH_STEPS} "
          f"{steady(x['ssm_mesh_s']):.4f} s a step), mesh=None "
          f"{_fmt(x['ssm_plain_s'])} s ({steady(x['ssm_plain_s']):.4f} s); "
          f"overhead "
          f"{steady(x['ssm_mesh_s']) / steady(x['ssm_plain_s']) - 1:+.2%}; "
          f"peak {x['ssm_mesh_peak_gib']:.2f} GiB against "
          f"{x['ssm_plain_peak_gib']:.2f}; losses {x['ssm_mesh_losses']} "
          f"(mesh=None {x['ssm_plain_losses']}), bits equal: "
          f"{x['ssm_mesh_loss_bits'] == x['ssm_plain_loss_bits']}; digests "
          f"equal: {x['ssm_mesh'] == x['ssm_plain']}; the first step's "
          f"{x['ssm_sites']} collectives ({sum(v[0] for v in sw.values())} "
          f"calls, {sum(v[1] for v in sw.values())} bytes sent) as the "
          f"closed form gives them, the conv leaves' {conv_calls} "
          f"({conv_bytes} bytes); bytes by kind and axes "
          f"{json.dumps(x['ssm_axes'])}, calls, bytes sent, received and "
          f"device ms by kind {json.dumps(sw)}")
    for tag, what, sites in (
            ("micro", f"internlm2-1.8b at full size, {COHORTS} cohorts, "
             f"batch 2 x 128 at microbatch {MICROBATCH}", micro_sites),
            ("moe_micro", f"deepseek-v2-lite-16b at full width, "
             f"{MOE_LAYERS} layers, {COHORTS} cohorts, batch 2 x 128 at "
             f"microbatch {MICROBATCH}, moe_block_dispatch {BLOCK_DISPATCH}"
             f" ({mrt['groups']} routing groups of {mrt['group']} tokens a "
             f"piece, capacity {mrt['cap']}, {mrt['slots']} slots an "
             f"expert)", moe_micro_sites)):
        w = x[f"{tag}_wire"]
        ms, ps = x[f"{tag}_mesh_s"], x[f"{tag}_plain_s"]
        print(f"mesh phase, microbatched partitioned train steps ({what}; "
              f"{pieces} piece(s) a rank; {smi_line()}): the whole run "
              f"{x[f'{tag}_phase_s']:.1f} s; partitioned {_fmt(ms)} s "
              f"(step 2 {ms[-1]:.4f} s), mesh=None {_fmt(ps)} s (step 2 "
              f"{ps[-1]:.4f} s); peak {x[f'{tag}_mesh_peak_gib']:.2f} GiB "
              f"against {x[f'{tag}_plain_peak_gib']:.2f}; losses "
              f"{x[f'{tag}_mesh_losses']} (mesh=None "
              f"{x[f'{tag}_plain_losses']}); digests and loss bits equal: "
              f"{x[f'{tag}_mesh'] == x[f'{tag}_plain'] and x[f'{tag}_mesh_loss_bits'] == x[f'{tag}_plain_loss_bits']}"
              f"; the first step's {x[f'{tag}_sites']} collectives "
              f"({sum(v[0] for v in w.values())} calls, "
              f"{sum(v[1] for v in w.values())} bytes sent) as the closed "
              f"form gives them ({sum(sum(v.values()) for v in sites.values())}"
              f"); calls, bytes sent, received and device ms by kind "
              f"{json.dumps(w)}")
    pm, pp = x["train_mesh_profile"], x["train_plain_profile"]
    print(f"mesh phase, one more step under torch.profiler: partitioned "
          f"wall {pm[0]:.1f} ms, device busy {pm[1]:.1f} ms "
          f"({100 * pm[1] / pm[0]:.1f}%), {pm[2]} collective calls; "
          f"mesh=None wall {pp[0]:.1f} ms, device busy {pp[1]:.1f} ms "
          f"({100 * pp[1] / pp[0]:.1f}%), {pp[2]} collective calls")
    print(f"mesh phase, recorded rounds (analysis.comm_model): packed "
          f"{json.dumps(x['mesh_comm'])}, sites {x['mesh_roles']}; "
          f"unpacked {json.dumps(x['unpacked_comm'])}, purity findings "
          f"{len(x['unpacked_purity'])} (packed {len(x['mesh_purity'])}); "
          f"bitpack round: uplink bits {x['bitpack_uplink_bits']} = metered "
          f"{x['bitpack_metered_bits']}; shard lint: {x['shard_leaves']} "
          f"weights explained, declared vs held on every state leaf, "
          f"{len(x['shard_findings'])} finding(s); "
          f"{x['comm_shard_s']:.1f} s for both")
    import shutil
    shutil.rmtree(work)
    return launches


ANALYSIS_SEQ = 128             # the launcher's batch 2 x seq 128


def _walk_step(torch, op_lint, step, state, batch, rules):
    """One train step under an op walker: (the walker, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with op_lint.OpWalker(rules) as w:
        step(state, batch)
    torch.cuda.synchronize()
    return w, time.perf_counter() - t0


def analysis_phase(torch, dispatch, dev):
    """(h) the analysis engines on the card.  The op walker over one
    full-width internlm2-1.8b train step at the launcher's configuration
    (2 cohorts x batch 2 x seq 128; kernels 1-3) and over the three
    aligned check configs' steps (the dense one on kernels 1-3, the moe
    one on 5-7, the hybrid one on 8-9, each of them launched by the fused
    step alone): no weight-shaped f32 value and no mask at a block shape
    outside the kernels, no f64, every state leaf in place through the
    step and a round; the materializing path above the fused one at
    every leaf shape.  Then the stream cover over every arch at full size
    on the (2, 16, 16) grid's 512 shards: findings only on the leaves past
    the uint32 stream index (2**32 elements).  Returns the fused steps'
    launches."""
    from repro_torch.analysis import model_check, op_lint, stream_cover
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.core import masking, tree
    from repro_torch.launch import steps as steplib
    from repro_torch.launch import train
    from repro_torch.models import build_model
    t0 = time.time()
    launches = {k: 0 for k in dispatch.KERNELS}
    args = train.parse_args(["--arch", "internlm2-1.8b", "--cohorts",
                             str(COHORTS), "--batch", "2", "--seq",
                             str(ANALYSIS_SEQ), "--device", "cuda"])
    cfg = get_config(args.arch)
    api = build_model(cfg)
    scfg = steplib.StepConfig(lam=args.lam, lr=args.lr,
                              optimizer=args.score_opt,
                              downlink_bits=args.downlink_bits,
                              seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = steplib.init_fed_state(gen, api, masking.MaskSpec(),
                                   C=args.cohorts, optimizer=args.score_opt)
    batch = {"tokens": torch.randint(0, cfg.vocab, (args.cohorts, 2,
                                                    ANALYSIS_SEQ),
                                     generator=gen, device=dev)}
    state_bytes = sum(t.numel() * t.element_size() for k in (
        "scores", "floats", "weights", "opt_m")
        for t in tree.leaves(state[k]) if t is not None)
    blocks = model_check.masked_block_shapes(state)
    leaves = model_check.masked_leaf_shapes(state)
    rules = [op_lint.weight_f32_temporaries(sh) for sh in blocks]
    rules += [op_lint.mask_materialization(sh) for sh in blocks]
    rules.append(op_lint.DtypePromotionRule())
    counters = {sh: model_check.CountRule(model_check.LeafShapeRule(sh))
                for sh in leaves}
    step = steplib.make_train_step(api, scfg)
    step(state, batch)                       # loads the kernels
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    bare_s = time.perf_counter() - t1
    keep = op_lint.InPlaceRule(state)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    w, walked_s = _walk_step(torch, op_lint, step, state, batch,
                             rules + list(counters.values()))
    got = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    found = w.findings + keep.check(state)
    keep = op_lint.InPlaceRule(state)
    steplib.make_round_step(api, scfg, codec=args.codec)(state)
    found += keep.check(state)
    check(found == [], f"op walker on internlm2-1.8b: "
          f"{[str(f) for f in found[:8]]}")
    per_pass = N_LAYERS * len(LAYER_SHAPES) * args.cohorts
    for k in ("masked_matmul_fwd", "masked_matmul_dx", "masked_matmul_ds"):
        check(got[k] == per_pass, f"walked step launched {k} {got[k]} "
              f"times, expected {per_pass}")
    launches = {k: launches[k] + got[k] for k in launches}
    leaf_counts = {"x".join(map(str, sh)): c.n for sh, c in counters.items()}
    print(f"analysis phase, op walker: internlm2-1.8b full width, "
          f"{args.cohorts} cohorts x batch 2 x seq {ANALYSIS_SEQ}: {w.n_ops} "
          f"aten ops and {w.n_kernels} kernel calls walked, 0 findings at "
          f"{len(blocks)} block shapes {blocks}; f32 values at the leaf "
          f"shapes (fused): {leaf_counts}; "
          f"step {bare_s:.3f} s bare, {walked_s:.3f} s walked; peak "
          f"{peak / 2**30:.2f} GiB against the state's "
          f"{state_bytes / 2**30:.2f} GiB; every leaf in place through the "
          f"step and a round")
    del state, batch, step, w, keep
    torch.cuda.empty_cache()

    for fam, (ccfg, S) in model_check.MODEL_CHECK_CFGS.items():
        out = model_check.model_step_weight_defs(ccfg, S=S, device=dev)
        got = {k: out["fused_launches"].get(k, 0) for k in launches}
        for sh, c in out["block_shapes"].items():
            check(c["fused"] == 0 and c["fused_masks"] == 0,
                  f"check config {fam}: block {sh} {c}")
        for sh, c in out["leaf_shapes"].items():
            check(c["eff"] > c["fused"], f"check config {fam}: leaf {sh} "
                  f"{c}")
        want = {"dense": ("masked_matmul_fwd", "masked_matmul_dx",
                          "masked_matmul_ds"),
                "moe": ("masked_matmul_grouped", "masked_matmul_grouped_dx",
                        "masked_matmul_grouped_ds"),
                "hybrid": ("masked_conv1d", "masked_conv1d_ds")}[fam]
        check(all(got[k] > 0 for k in want), f"check config {fam}'s fused "
              f"step launched {out['fused_launches']}")
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"analysis phase, check config {fam}: {json.dumps(out)}")

    t1 = time.time()
    wrapped = {}
    for arch in ARCH_NAMES:
        rep = stream_cover.arch_stream_report(arch, smoke=False, C=COHORTS,
                                              devs=range(512))
        big = {iv.owner for iv in rep["intervals"]
               if iv.flat_size > 2 ** 32}
        where = {f.where for f in rep["findings"]}
        check(where == big, f"stream cover {arch}: findings on {where}, "
              f"leaves past 2**32 elements {big}")
        if big:
            wrapped[arch] = len(rep["findings"])
        print(f"analysis phase, stream cover {arch} (full size, 512 "
              f"shards x {COHORTS} cohorts): {rep['n_leaves']} leaves, "
              f"{rep['n_intervals']} intervals, {rep['n_streams']} streams, "
              f"{len(rep['findings'])} finding(s)"
              + (f" on {sorted(big)} (past 2**32 elements)" if big else ""))
    print(f"analysis phase: {time.time() - t0:.1f}s (stream cover "
          f"{time.time() - t1:.1f}s; uint32 index wraps: {wrapped})")
    return launches


# the dry run's cells on the card, one process a group: the stand-in
# process group is process-wide, and the train steps' meta flop counts are
# host work the groups run side by side (deepseek-v2-236b's alone)
DRYRUN_GROUPS = (
    ("deepseek-v2-236b", "train_4k", "multi", ()),
    ("mamba2-370m,internlm2-1.8b,qwen2-7b", "train_4k", "multi", ()),
    ("recurrentgemma-9b,whisper-medium,deepseek-7b", "train_4k", "multi",
     ()),
    ("gemma3-4b,deepseek-v2-lite-16b,qwen2-vl-2b", "train_4k", "multi", ()),
    ("internlm2-1.8b,mamba2-370m,recurrentgemma-9b", "train_4k", "single",
     ()),
    ("deepseek-v2-lite-16b,deepseek-v2-236b", "train_4k", "single", ()),
    ("internlm2-1.8b", "prefill_32k,decode_32k", "multi", ()),
    ("internlm2-1.8b", "train_4k", "multi", ("--unpacked",)),
    ("deepseek-v2-lite-16b", "train_4k", "multi", (
        "--step", "train", "--patch", json.dumps({"microbatch": 2}),
        "--patch", json.dumps({"moe_block_dispatch": 64}))),
)
# the MoE cells whose flops `dryrun_phase` sets side by side: global
# dispatch, microbatches (routing over 8-rank data subgroups) and
# block-local dispatch (4 blocks a data rank)
DRYRUN_MOE = ("deepseek-v2-lite-16b|train_4k|pod2x16x16",
              "deepseek-v2-lite-16b|train_4k|pod2x16x16|microbatch=2",
              "deepseek-v2-lite-16b|train_4k|pod2x16x16|"
              "moe_block_dispatch=64")
GROUPED = ("masked_matmul_grouped", "masked_matmul_grouped_dx",
           "masked_matmul_grouped_ds")
DRYRUN_TIMEOUT = 600           # seconds a group may take
DRYRUN_DEVICES = {"pod16x16": 256, "pod2x16x16": 512}


def _gib(b):
    return "-" if b is None else f"{b / 2**30:.3f}"


def dryrun_cell_check(key, res, unpacked):
    """The checks of `dryrun_phase` on one cell's result (a value of the
    dry run's --out JSON); prints its lines and returns the round's
    launches ({} for a prefill or decode cell)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import partition
    check(res["ok"], f"dry run {key}: {res.get('error')}")
    arch, shape, mesh, *patch = key.split("|")
    patch = {k: int(v) for k, v in (kv.split("=") for kv in
                                     patch[0].split(","))} if patch else {}
    n_dev = DRYRUN_DEVICES[mesh]
    for step, r in res.items():
        if not isinstance(r, dict) or step == "stream_cover":
            continue
        check(r["peers"] == "fake", f"{key} {step}: peers {r['peers']}")
        mem = r["memory"]
        sites = r["comm_model"]["n_sites"] if "comm_model" in r else None
        print(f"dry run {key} {step}: {r['seconds']:.1f} s, arguments "
              f"{_gib(mem['argument_size'])} GiB, peak above them "
              f"{_gib(mem['temp_size'])} GiB, flops {r['flops']}, sites "
              f"{sites}, collective bytes "
              f"{json.dumps(r['collective_bytes'])}")
    check(all(r["flops"] > 0 and r["memory"]["argument_size"] > 0
              for k, r in res.items()
              if k.endswith("_step") and k != "round_step"),
          f"dry run {key}: {res}")
    train = res.get("train_step")
    if train is not None and get_config(arch).family in partition.FAMILIES:
        # rank 0's block of the partitioned step: FSDP gathers over
        # "data", the output gathers and dx all-reduces over "model", the
        # ds reduce-scatters over "data"
        axes = train["collective_axes"]
        check(train["collective_bytes"] is not None and all(
            axes.get(k, 0) > 0 for k in (
                "all-gather data", "all-gather model", "all-reduce model",
                "reduce-scatter data")), f"{key}: partitioned train step "
              f"collectives {axes}")
        ratio = {k: train["global_step"]["kernel_work"][k]["flops"]
                 / train["kernel_work"][k]["flops"]
                 for k in ("masked_matmul_fwd", "masked_matmul_dx")}
        if arch in ("internlm2-1.8b", "mamba2-370m", "recurrentgemma-9b"):
            # every leaf divides
            check(all(v == n_dev for v in ratio.values()), f"{key}: the "
                  f"global step's kernel 1-2 flops over rank 0's {ratio}, "
                  f"expected {n_dev}")
        moe = ""
        if get_config(arch).family in ("ssm", "hybrid"):
            moe = conv_cell_check(key, train, n_dev, ratio)
        if get_config(arch).family == "moe":
            # the expert layout's collectives, each operand size and
            # count; kernels 5-6 on rank 0's experts and slots: the
            # global step runs cohorts x M chunks x G' groups x cap rows
            # an expert, rank 0 its E/16 experts' pieces x slots / span
            cfg = get_config(arch)
            cohorts = 2 if mesh == "pod2x16x16" else 1
            shape = {"data": 16, "model": 16}
            tokens = (SHAPES["train_4k"].global_batch // cohorts
                      // shape["data"] * SHAPES["train_4k"].seq_len)
            micro = patch.get("microbatch", 1)
            want, rt = moe_expert_sites(
                cfg, tokens, shape, 1, micro,
                patch.get("moe_block_dispatch", cfg.moe_block_dispatch))
            miss = missing_sites(want, train["collective_operands"])
            check(not miss, f"{key}: expert collectives (kind, elements, "
                  f"expected, recorded) {miss}")
            cap, slots, span = rt["cap"], rt["slots"], rt["span"]
            mine_rows = rt["pieces"] * cfg.n_experts // 16 * slots // span
            glob_rows = cohorts * micro * rt["blocks"] * cap * cfg.n_experts
            for k in ("masked_matmul_grouped", "masked_matmul_grouped_dx"):
                glob = int(train["global_step"]["kernel_work"][k]["flops"])
                mine = int(train["kernel_work"][k]["flops"])
                check(glob * mine_rows == mine * glob_rows, f"{key}: {k} "
                      f"global flops {glob} over rank 0's {mine}, expected "
                      f"{glob_rows} / {mine_rows} (expert rows)")
                ratio[k] = glob / mine
            routed = ("on the rank" if span == 1 else
                      "over \"data\"" if span == 16 else
                      f"over the subgroup \"data/{span}\"")
            moe = (f"; routing groups of {rt['group']} tokens, "
                   f"{rt['groups']} a piece, routed {routed}; capacity "
                   f"{cap}, {slots} slots an expert ({slots - rt['groups'] * cap} "
                   f"padded), the expert layout's "
                   f"{sum(sum(v.values()) for v in want.values())} "
                   f"collectives as the closed form gives them")
            subs = {k.split()[1] for k in train["collective_operands"]
                    if k.split()[1].startswith("data/")}
            check(subs == ({f"data/{span}"} if 1 < span < 16 else set()),
                  f"{key}: collectives over data subgroups {subs}, routing "
                  f"groups over {span} data ranks")
        print(f"dry run {key} partitioned train step: {train['n_sites']} "
              f"collectives, bytes by kind and axes {json.dumps(axes)}; "
              f"global over rank 0 kernel flops {ratio}{moe}")
    if "round_step" not in res:
        return {}
    rnd = res["round_step"]
    cm = rnd["comm_model"]
    leaves = res["stream_cover"]["n_leaves"]
    got = rnd["launches"]
    if unpacked:
        check(len(rnd["purity_findings"]) == leaves and all(
            "collective-f32-weight" in f for f in rnd["purity_findings"]),
              f"{key} unpacked: purity {rnd['purity_findings']}")
        check(cm["bpp_wire"] == 16.0, f"{key} unpacked: bpp_wire "
              f"{cm['bpp_wire']}")
        check(got == {}, f"{key} unpacked launched {got}")
        print(f"dry run {key} unpacked: {leaves} purity findings, bpp_wire "
              f"{cm['bpp_wire']}")
        return got
    check(rnd["purity_findings"] == [], f"{key}: purity "
          f"{rnd['purity_findings']}")
    check(got == {"sample_and_pack": leaves, "unpack_bits": leaves},
          f"{key}: round launches {got}, expected {leaves} of kernels 4 "
          f"and 11")
    if mesh == "pod16x16":                    # one cohort: nothing crosses
        check(cm["uplink_bits"] == 0, f"{key}: {cm}")
        return got
    # 2 cohorts, one a pod: < 32 padding bits a leaf and shard
    pad = 32 * leaves * n_dev / (2 * rnd["mask_params"])
    lo = 1.0 + rnd["replica_share"]
    check(lo - 1e-4 <= cm["bpp_wire"] <= lo + pad + 1e-4,
          f"{key}: bpp_wire {cm['bpp_wire']} outside [{lo}, {lo + pad}]")
    check(cm["uplink_bits"] == n_dev * rnd["block_metered_bits"],
          f"{key}: uplink bits {cm['uplink_bits']} against {n_dev} x the "
          f"block's metered {rnd['block_metered_bits']}")
    print(f"dry run {key} round: peak {_gib(rnd['memory']['peak'])} GiB, "
          f"bpp_wire {cm['bpp_wire']} (replicas "
          f"{rnd['replica_share']:.5f}), uplink bits {cm['uplink_bits']} = "
          f"{n_dev} x metered {rnd['block_metered_bits']:.0f}, ring bytes "
          f"{json.dumps(cm['ring_bytes_per_axis'])}, round "
          f"{rnd['round_s']:.3f} s, stream findings "
          f"{res['stream_cover']['wrapped_findings']} (past 2**32 "
          f"elements: {res['stream_cover']['wrapped_leaves']})")
    return got


def conv_cell_check(key, train, n_dev, ratio):
    """The partitioned train step of an ssm or hybrid dry-run cell (rank 0
    of the production mesh, one cohort a pod): every collective as the
    closed form gives it (`block_sites`, its conv leaves' among them);
    kernel 8 exactly the global step's flops over the device count, and
    kernel 9 too but for its epilogue, which runs on the rank's C/16
    channels of every tap (W = 4 does not split over 16 data ranks).
    Adds kernels 8-9's ratios to `ratio`; returns a line's tail."""
    from repro_torch.analysis import stream_cover
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import tree
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.launch import steps as steplib
    arch, _, mesh = key.split("|")
    cfg = get_config(arch)
    shape = ({"pod": 2, "data": 16, "model": 16} if mesh == "pod2x16x16"
             else {"data": 16, "model": 16})
    cohorts = shape.get("pod", 1)
    _, meta = stream_cover.meta_fed_state(cfg, cohorts)
    sh = steplib.fed_state_shardings(meta, stub_mesh(shape))
    rows = SHAPES["train_4k"].global_batch // cohorts
    S = SHAPES["train_4k"].seq_len
    want, conv = block_sites(
        meta, sh, shape, rows // shape["data"] * S, 1,
        f32_inputs=("w_rg", "w_ri") if cfg.family == "hybrid" else ())
    got = train["collective_operands"]
    bad = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
           if got.get(k) != want.get(k)}
    check(not bad, f"{key}: collectives (recorded, closed form) {bad}")
    convs = [s for p, s in tree.flatten_with_paths(meta["scores"])
             if s is not None and p.endswith("conv/w_conv")]
    W, C = convs[0].shape[-2:]
    L = sum(math.prod(s.shape[1:-2]) for s in convs)   # conv layers
    cl, rl = C // shape["model"], rows // shape["data"]
    epi = mm.EPILOGUE_FLOPS * W
    work = train["kernel_work"]
    glob = train["global_step"]["kernel_work"]
    k8 = (int(glob["masked_conv1d"]["flops"]),
          int(work["masked_conv1d"]["flops"]))
    k9 = (int(glob["masked_conv1d_ds"]["flops"]),
          int(work["masked_conv1d_ds"]["flops"]))
    check(k8 == (cohorts * L * 2 * 2 * W * rows * S * C,
                 L * 2 * 2 * W * rl * S * cl) and k8[0] == n_dev * k8[1],
          f"{key}: kernel 8 flops (global, rank 0) {k8}")
    check(k9 == (cohorts * L * (2 * W * rows * S * C + epi * C),
                 L * (2 * W * rl * S * cl + epi * cl)), f"{key}: kernel 9 "
          f"flops (global, rank 0) {k9}")
    ratio.update(masked_conv1d=k8[0] / k8[1], masked_conv1d_ds=k9[0] / k9[1])
    n = sum(sum(v.values()) for v in conv.values())
    return (f"; every collective as the closed form gives it, the {L} conv "
            f"layers' {n} (C = {C} on \"model\": {cl} channels a rank)")


def dryrun_phase(torch, dispatch):
    """(h) the multi-pod dry run (`python -m repro_torch.launch.dryrun
    --device cuda`, DRYRUN_GROUPS in processes side by side): every
    arch's train_4k cell on the (2, 16, 16) mesh, internlm2-1.8b's on
    (16, 16) and its prefill_32k and decode_32k cells, each as rank 0 of
    the stand-in process group, the round on rank 0's block on the card;
    then internlm2-1.8b's train_4k with `--unpacked`.  Any [FAIL] fails
    the run.  Each packed multi-pod round: no purity finding, `bpp_wire`
    at least 1 plus the replicated blocks' share and at most that plus
    the word padding, its uplink bits every shard's block as the bitpack
    meter counts it on rank 0's, kernels 4 and 11 once a masked leaf; the
    single pod's round no word stream (one cohort) and the same
    launches; the unpacked round a purity finding a leaf at 16 bits a
    parameter and no kernel (`dryrun_cell_check`).  Returns the rounds'
    launches."""
    work = _scratch("chip_smoke_dryrun")
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.time()
    procs = []
    for i, (archs, shapes, mesh, more) in enumerate(DRYRUN_GROUPS):
        log = open(work / f"group{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             "cuda", "--arch", archs, "--shape", shapes, "--mesh", mesh,
             "--out", str(work / f"group{i}.json"), *more], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(DRYRUN_TIMEOUT)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
            log.close()
    wall = time.time() - t0
    launches = {k: 0 for k in dispatch.KERNELS}
    cells = {}
    for i, (p, _) in enumerate(procs):
        text = (work / f"group{i}.log").read_text()
        check(p.returncode == 0 and "[FAIL]" not in text,
              f"dry run group {DRYRUN_GROUPS[i][:3]} exited "
              f"{p.returncode}: {text[-3000:]}")
        unpacked = "--unpacked" in DRYRUN_GROUPS[i][3]
        for key, res in json.loads(
                (work / f"group{i}.json").read_text()).items():
            cells[key] = res
            for k, v in dryrun_cell_check(key, res, unpacked).items():
                launches[k] += v
    # the MoE train cells' counted flops against the kernels' stated
    # work: what is not a kernel's is mostly the one-hot dispatch and
    # combine einsums
    for key in DRYRUN_MOE:
        t = cells[key]["train_step"]
        line = []
        for side, r in (("rank 0", t), ("global", t["global_step"])):
            kern = sum(v["flops"] for v in r["kernel_work"].values())
            experts = sum(r["kernel_work"][k]["flops"] for k in GROUPED)
            line.append(f"{side} {r['flops']:.6g} flops, kernels "
                        f"{kern:.6g} (experts, kernels 5-7: {experts:.6g}), "
                        f"the rest {r['flops'] - kern:.6g} = "
                        f"{(r['flops'] - kern) / experts:.3f} x the experts'")
        print(f"dry run {key} flops: {'; '.join(line)}")
    print(f"dryrun_phase: {wall:.1f}s, {len(procs)} processes side by side")
    import shutil
    shutil.rmtree(work)
    return launches


EXAMPLES_ARGV = (
    ("quickstart", ["--rounds", "2"]),
    ("serve_masked", []),
    ("train_lm_masked", ["--small", "--steps", "4", "--round-every", "2"]),
    ("fault_tolerance_demo", []),
)


def examples_phase(torch, dispatch, dev):
    """(i) the four examples (`repro_torch.examples`) on the card through
    their `main(argv)`: the quickstart for 2 rounds (it fails on a codec
    round trip that is not exact), the serving example at its defaults
    (kernel 11 once a masked leaf), the LM trainer at ~40M parameters for
    4 steps with a round every 2 (kernels 1-3 once a projection, cohort
    and step; 4 and 11 once a masked leaf and round), the fault-tolerance
    demo (its restore exact).  Returns their launches."""
    import importlib
    work = _scratch("chip_smoke_examples")
    launches = {k: 0 for k in dispatch.KERNELS}
    for name, argv in EXAMPLES_ARGV:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        argv = ["--device", "cuda"] + argv
        if name == "quickstart":
            argv += ["--out", str(work / "artifact.npz")]
        elif name in ("train_lm_masked", "fault_tolerance_demo"):
            argv += ["--ckpt-dir", str(work / name)]
        torch.cuda.synchronize()
        t0 = time.time()
        dispatch.reset_launch_counts()
        out = mod.main(argv)
        torch.cuda.synchronize()
        got = dict(dispatch.LAUNCHES)
        secs = time.time() - t0
        if name == "quickstart":
            check(out["exact"], "quickstart: the codec round trip")
            want = ("pack_bits", "unpack_bits")
        elif name == "serve_masked":
            check(got["unpack_bits"] == 7 and out["tok_s"] > 0,
                  f"serve_masked: launches {got}")
            want = ("unpack_bits",)
        elif name == "train_lm_masked":
            cfg = mod.make_100m_cfg(small=True)
            per = cfg.n_layers * len(LAYER_SHAPES) * COHORTS * 4
            rounds = len(LAYER_SHAPES) * 2
            for k, v in (("masked_matmul_fwd", per),
                         ("masked_matmul_dx", per),
                         ("masked_matmul_ds", per),
                         ("sample_and_pack", rounds),
                         ("unpack_bits", rounds)):
                check(got[k] == v, f"train_lm_masked: {k} {got[k]}, "
                      f"expected {v}")
            check(all(0.0 < r["bpp"] <= 1.0 for r in out["rounds"]),
                  f"train_lm_masked rounds {out['rounds']}")
            want = ()
        else:
            check(out["restored_equal"] and len(out["accs"]) == 10,
                  f"fault_tolerance_demo: {out}")
            want = ("pack_bits", "unpack_bits")
        check(all(got[k] > 0 for k in want), f"{name}: launches {got}")
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"examples phase {name}: {secs:.1f}s, launches "
              f"{ {k: v for k, v in got.items() if v} }")
    import shutil
    shutil.rmtree(work)
    return launches


def _conv6_setup(torch, dev, k):
    """CONV6 at its published width on HOSTSIM's cifar10-like task, split
    IID over k clients: (setup, fedpm_reg with the bitpack codec, one
    tick's data, the sizes)."""
    from repro_torch import api
    from repro_torch.benchmarks import common
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    cfg = cnn.CONV6
    gen = torch.Generator(dev).manual_seed(RUNTIME["seed"])
    task = synthetic.make_image_task(gen, n=RUNTIME["n"], img=cfg.img_size,
                                     channels=cfg.in_channels,
                                     n_classes=cfg.n_classes,
                                     proto_scale=1.0, noise=0.7)
    setup = common.setup_from(cfg, task, k, None, RUNTIME["seed"], gen)
    algo = api.get_algorithm(
        "fedpm_reg", setup["apply_fn"], setup["loss_fn"], spec=common.SPEC,
        local_steps=RUNTIME["local_steps"], lam=1.0, lr=0.1,
        optimizer="adam", float_lr=1e-3, codec="bitpack")
    data = synthetic.federated_batches(gen, task, setup["cidx"], k,
                                       RUNTIME["local_steps"], CNN_BATCH)
    sizes = torch.tensor([len(c) for c in setup["cidx"]],
                         dtype=torch.float32, device=dev)
    return setup, algo, data, sizes


def _init_state(torch, dev, algo, setup):
    return algo.init(torch.Generator(dev).manual_seed(RUNTIME["seed"] + 1),
                     setup["params"])


def _same_state(torch, a, b, what):
    from repro_torch.core import tree
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        check(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y,
              f"{what}: the states differ")


def _kinds(events):
    out = {}
    for e in events:
        out[e["kind"]] = out.get(e["kind"], 0) + 1
    return out


def _launched(dispatch, before):
    return {k: dispatch.LAUNCHES[k] - before[k] for k in before}


def async_phase(torch, dispatch, dev):
    """(c) The buffered-async engine at CONV6's published width (2.26 M
    masked weights in 9 leaves): fedpm_reg, 10 clients, 3 local steps of
    batch 32, adam, the bitpack codec (the host arithmetic coder takes ~2
    s a payload each way).  At zero faults and quorum 1, two commits
    bit-identical to `run_round` on the tick's generator (theta, metrics,
    wire bits), with cuDNN's deterministic algorithms (its default conv
    backward sums in a nondeterministic order).  Then 8 ticks with
    crashes, pod partitions, stragglers and corrupt uplinks (quorum 0.8,
    deadline 2), saved at tick 4; a
    fresh engine restored from that save continues to the same theta,
    events and seq.  Kernels 10 and 11 exactly: each client packs each
    leaf a tick (and an engine's template once), each commit unpacks each
    leaf once.  Prints the ticks' seconds and the host's share (read
    back, encode, decode, fold).  Returns (launches, the faulted engine
    and its data, for the profile)."""
    from repro_torch.core import tree
    from repro_torch.runtime import async_engine, fault
    k = RUNTIME["k"]
    # equal draws must give equal client updates: cuDNN's default conv
    # backward sums in a nondeterministic order
    torch.backends.cudnn.deterministic = True
    setup, algo, data, sizes = _conv6_setup(torch, dev, k)
    st = _init_state(torch, dev, algo, setup)
    leaves = sum(1 for t in tree.leaves(st.theta) if t is not None)
    print(f"async engine: CONV6, {k} clients, codec {algo.codec.name} "
          f"(the arithmetic coder runs ~2 s a payload on the host)")
    dispatch.reset_launch_counts()
    total = {kk: 0 for kk in dispatch.KERNELS}
    eng = async_engine.AsyncRoundEngine(algo, _init_state(torch, dev, algo,
                                                          setup),
                                        data, sizes, RUNTIME["seed"])
    part = torch.ones(k, dtype=torch.bool, device=dev)
    for t in range(2):
        st, m = algo.round(st, data, part, sizes, eng.tick_generator(t))
        (c,) = eng.tick(data)
        for key in ("loss", "uplink_bpp", "uplink_bits_measured",
                    "downlink_bits"):
            check(c[key] == float(m[key]), f"async zero faults tick {t}: "
                  f"{key} {c[key]} vs run_round {float(m[key])}")
        _same_state(torch, eng.state, st, f"async zero faults tick {t}")
    got = dict(dispatch.LAUNCHES)
    want = {kk: 0 for kk in dispatch.KERNELS}
    # run_round and the engine each pack k x leaves a round, unpack leaves
    # a commit; the engine's template packs leaves once
    want.update(pack_bits=(4 * k + 1) * leaves, unpack_bits=4 * leaves)
    check(got == want, f"async zero faults: launches {got}, expected {want}")
    print(f"async engine zero faults, quorum 1: 2 commits bit-identical to "
          f"run_round (theta, loss, Bpp, {c['uplink_bits_measured']:.0f} "
          f"wire bits a commit); launches {json.dumps(got)}")
    total = {kk: total[kk] + got[kk] for kk in total}
    del eng, st

    def faulted():
        return async_engine.AsyncRoundEngine(
            algo, _init_state(torch, dev, algo, setup), data, sizes,
            RUNTIME["seed"], config=async_engine.AsyncConfig(**RUNTIME_CFG),
            injector=fault.FaultInjector(k, seed=RUNTIME["seed"],
                                         **RUNTIME_FAULTS))

    d = _scratch("chip_smoke_engine")
    dispatch.reset_launch_counts()
    eng = faulted()
    walls, host0 = [], dict(eng.host_seconds)
    commits = []
    for t in range(RUNTIME["ticks"]):
        if t == RUNTIME["save_at"]:
            eng.save(str(d / "engine"))
            commits_at_save = len(commits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        commits += eng.tick(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    host = {kk: eng.host_seconds[kk] - host0[kk] for kk in host0}
    commits += eng.flush()
    got = dict(dispatch.LAUNCHES)
    want = {kk: 0 for kk in dispatch.KERNELS}
    want.update(pack_bits=(1 + RUNTIME["ticks"] * k) * leaves,
                unpack_bits=len(commits) * leaves)
    check(got == want, f"async faulted: launches {got}, expected {want}")
    total = {kk: total[kk] + got[kk] for kk in total}
    check(len(commits) >= 2, f"async faulted: {len(commits)} commits")
    print(f"async engine faulted ({RUNTIME['ticks']} ticks + flush): events "
          f"{json.dumps(_kinds(eng.events))}; {len(commits)} commits "
          f"folding {[c['n_folded'] for c in commits]}; uplink "
          f"{eng.totals['uplink_bits_measured']:.0f} bits, headers "
          f"{eng.totals['uplink_header_bits']:.0f}, downlink "
          f"{eng.totals['downlink_bits']:.0f}; launches {json.dumps(got)}")
    tick_s = sum(walls)
    print(f"async engine ticks: {[round(w, 4) for w in walls]} s (mean "
          f"{tick_s / len(walls):.4f}); host share of the ticks: "
          + ", ".join(f"{kk} {v:.4f} s ({100 * v / tick_s:.1f}%)"
                      for kk, v in host.items()))
    dispatch.reset_launch_counts()
    eng2 = faulted()
    eng2.restore(str(d / "engine"))
    check(not eng2._degraded_restore and eng2.tick_idx == RUNTIME["save_at"],
          "async restore: degraded or at the wrong tick")
    commits2 = []
    for t in range(RUNTIME["save_at"], RUNTIME["ticks"]):
        commits2 += eng2.tick(data)
    commits2 += eng2.flush()
    check(eng2.events == eng.events and eng2._event_seq == eng._event_seq,
          "async restore: the events differ")
    check(commits2 == commits[commits_at_save:],
          "async restore: the commits differ")
    _same_state(torch, eng2.state, eng.state, "async restore")
    check(eng2.totals == eng.totals, "async restore: the totals differ")
    got = dict(dispatch.LAUNCHES)
    want = {kk: 0 for kk in dispatch.KERNELS}
    want.update(pack_bits=(1 + (RUNTIME["ticks"] - RUNTIME["save_at"]) * k)
                * leaves, unpack_bits=len(commits2) * leaves)
    check(got == want, f"async restored: launches {got}, expected {want}")
    total = {kk: total[kk] + got[kk] for kk in total}
    print(f"async engine restored at tick {RUNTIME['save_at']}: "
          f"{len(commits2)} commits, {len(eng2.events)} events and seq "
          f"{eng2._event_seq} equal the uninterrupted engine's, theta "
          f"torch.equal; launches {json.dumps(got)}")
    import shutil
    shutil.rmtree(d)
    del eng2
    return total, (eng, data)


def tree_phase(torch, dispatch, dev):
    """(d) The aggregator tree at CONV6's width: 8 clients of 128 images
    (dyadic weights) at fanout 2.  At zero faults two commits, each from
    the same state, bit-identical to the flat engine's (theta, wire bits;
    the float leaves, pooled in another order, within roundings), with the
    measured root bits equal to `analysis.comm_model.tree_root_round_bits`
    exactly; then 6 ticks with edge crashes and partitions, client
    crashes and corrupt uplinks; then `repro_torch.tools.chaos_smoke
    --tree` on the card (the agg_tree CLI SIGKILLed after its first
    durable commit: exactly-once commits, the same theta digest).
    Returns the launches (kernel 10 only: the root reduces pooled counts
    through `mean_from_counts`, no unpack)."""
    from repro_torch.analysis import comm_model
    from repro_torch.core import tree
    from repro_torch.runtime import agg_tree, async_engine, fault
    from repro_torch.tools import chaos_smoke
    k = TREE_K
    torch.backends.cudnn.deterministic = True
    setup, algo, data, sizes = _conv6_setup(torch, dev, k)
    check(len(set(sizes.tolist())) == 1, f"tree: unequal sizes {sizes}")
    st0 = _init_state(torch, dev, algo, setup)
    leaves = sum(1 for t in tree.leaves(st0.theta) if t is not None)
    leaf_params = [t.numel() for t in tree.leaves(st0.theta)
                   if t is not None]
    float_elems = sum(f.numel() for f in tree.leaves(st0.floats)
                      if f is not None)
    del st0
    dispatch.reset_launch_counts()
    flat = async_engine.AsyncRoundEngine(
        algo, _init_state(torch, dev, algo, setup), data, sizes,
        RUNTIME["seed"])
    eng = agg_tree.TreeRoundEngine(
        algo, _init_state(torch, dev, algo, setup), data, sizes,
        RUNTIME["seed"], tree=agg_tree.TreeConfig(fanout=TREE_FANOUT))
    flat_unpack = 0
    for t in range(2):
        (cf,) = flat.tick(data)
        flat_unpack = dispatch.LAUNCHES["unpack_bits"]
        (ct,) = eng.tick(data)
        check(dispatch.LAUNCHES["unpack_bits"] == flat_unpack,
              "tree: the root unpacked words")
        for key in ("uplink_bits_measured", "n_folded", "clients"):
            check(cf[key] == ct[key], f"tree tick {t}: {key} {ct[key]} vs "
                  f"flat {cf[key]}")
        for a, b in zip(tree.leaves(flat.state.theta),
                        tree.leaves(eng.state.theta)):
            check(a is None or torch.equal(a, b),
                  f"tree tick {t}: theta differs from the flat engine's")
        fdiff = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree.leaves(flat.state.floats),
                                    tree.leaves(eng.state.floats))
                    if a is not None)
        # the float leaves pool in another order (edge sums, then the
        # root's), so they may differ by roundings; the next tick starts
        # both engines from the flat engine's state
        eng.state = flat.state
        st = comm_model.tree_root_round_bits(
            leaf_params, eng.n_edges, acc_bits=eng.tree.acc_bits,
            float_elems=float_elems, n_metrics=len(eng.metric_names))
        check(ct["root_bits_measured"] == st["root_bits"],
              f"tree: root bits {ct['root_bits_measured']} vs the static "
              f"model's {st['root_bits']}")
    got = dict(dispatch.LAUNCHES)
    want = {kk: 0 for kk in dispatch.KERNELS}
    want.update(pack_bits=2 * (1 + 2 * k) * leaves, unpack_bits=2 * leaves)
    check(got == want, f"tree zero faults: launches {got}, expected {want}")
    print(f"tree zero faults ({k} clients, fanout {TREE_FANOUT}, "
          f"{eng.n_edges} edges): 2 commits with theta torch.equal to the "
          f"flat engine's from the same state (float leaves within "
          f"{fdiff:.3g}), {ct['uplink_bits_measured']:.0f} uplink bits "
          f"each; root {ct['root_bits_measured']:.0f} bits a commit = "
          f"tree_root_round_bits (flat root traffic "
          f"{cf['uplink_bits_measured']:.0f}); launches {json.dumps(got)}")
    total = dict(got)
    del flat, eng
    dispatch.reset_launch_counts()
    eng = agg_tree.TreeRoundEngine(
        algo, _init_state(torch, dev, algo, setup), data, sizes,
        RUNTIME["seed"], config=async_engine.AsyncConfig(
            quorum_frac=0.75, deadline_rounds=2),
        injector=fault.FaultInjector(k, seed=RUNTIME["seed"], **TREE_FAULTS),
        tree=agg_tree.TreeConfig(fanout=TREE_FANOUT))
    commits = []
    t0 = time.perf_counter()
    for _ in range(6):
        commits += eng.tick(data)
    commits += eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(dispatch.LAUNCHES)
    want = {kk: 0 for kk in dispatch.KERNELS}
    want.update(pack_bits=(1 + 6 * k) * leaves)
    check(got == want, f"tree faulted: launches {got}, expected {want}")
    check(commits and eng.totals["root_bits_measured"] > 0,
          "tree faulted: no commit")
    total = {kk: total[kk] + got[kk] for kk in total}
    print(f"tree faulted (6 ticks + flush, {wall:.2f} s): events "
          f"{json.dumps(_kinds(eng.events))}; {len(commits)} commits "
          f"folding {[c['n_folded'] for c in commits]} over edges "
          f"{[c['edges'] for c in commits]}; root "
          f"{eng.totals['root_bits_measured']:.0f} bits, uplink "
          f"{eng.totals['uplink_bits_measured']:.0f}; host "
          + ", ".join(f"{kk} {v:.3f} s" for kk, v in eng.host_seconds.items()))
    del eng
    work = _scratch("chip_smoke_tree")
    t0 = time.time()
    out = chaos_smoke.main(["--tree", "--device", "cuda", "--timeout", "300",
                            "--work-dir", str(work)])
    print(f"tree kill-and-resume on the card ({time.time() - t0:.1f}s): "
          f"killed at v{out['killed_at']}, resumed at v{out['resumed']}, "
          f"versions {out['versions']}, digest {out['digest']}")
    return total


def runtime_profile(torch, eng, data):
    """(e) One faulted engine tick and one commit (the flush) of the CONV6
    engine under torch.profiler: device time by kernel, the device's busy
    share and operations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in (("tick", lambda: eng.tick(data)),
                         ("commit", eng.flush)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    wall = sum(walls.values()) * 1e3
    print(f"profile async engine CONV6: 1 faulted tick + 1 commit, wall "
          f"{wall:.1f} ms (tick {walls['tick'] * 1e3:.1f}, commit "
          f"{walls['commit'] * 1e3:.1f}), device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), {sum(r[1] for r in rows)} device "
          f"operations; device ms by kernel:")
    for key, count, ms in rows[:12]:
        print(f"  {ms:9.2f} ms {count:6d}x  {key[:90]}")
    check(busy > 0, "the profiler saw no device time")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ref

    t0 = time.time()
    for name, log in build.build().items():
        print(f"== nvcc -Xptxas -v {name}.cu")
        print(log.strip())
    print(f"build: {time.time() - t0:.1f}s")
    print(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    err = kernel_phase(torch, mm, ref, dev)
    err.update(grouped_kernel_phase(torch, mm, ref, dev))
    for k, v in conv_kernel_phase(torch, mm, ref, dev).items():
        err[k] = max(err.get(k, 0.0), v)
    err.update(bitpack_kernel_phase(torch, bp, dev))
    err["masked_matmul_fwd"] = max(err["masked_matmul_fwd"],
                                   small_m_kernel_phase(torch, mm, ref, dev))
    cnn_err, _ = cnn_kernel_phase(torch, mm, ref, bp, dev)
    for k, v in cnn_err.items():
        err[k] = max(err[k], v)
    print(f"kernel phase: all kernels agree with their plain versions "
          f"({time.time() - t0:.1f}s); max abs err {json.dumps(err)}")
    t0 = time.time()
    timing, per_shape = timing_phase(torch, mm, ref, dev)
    for phase in (grouped_timing_phase, conv_timing_phase):
        p_timing, p_per_shape = phase(torch, mm, ref, dev)
        timing.update(p_timing)
        per_shape.update(p_per_shape)
    p_timing, p_per_shape = bitpack_timing_phase(torch, bp, dev)
    timing.update(p_timing)
    per_shape.update(p_per_shape)
    block_err, _ = block_kernel_phase(torch, mm, ref, dev)
    block_err.update(grouped_block_checks(torch, mm, ref, dev))
    t1 = time.time()
    for k, v in conv_block_checks(torch, mm, ref, dev)[0].items():
        block_err[k] = max(block_err.get(k, 0.0), v)
    print(f"conv_block_checks: {time.time() - t1:.1f}s")
    for k, v in block_err.items():
        err[k] = max(err[k], v)
    zoo_err, zoo_rows = zoo_kernel_phase(torch, mm, ref, dev)
    for k, v in zoo_err.items():
        err[k] = max(err[k], v)
    for k, rows in zoo_rows.items():
        per_shape[k].update(rows)
    bf_err, bf_rows, bf_layer = bf16_score_kernel_phase(torch, mm, ref, dev)
    for k, v in bf_err.items():
        err[k] = max(err[k], v)
    for k, rows in bf_rows.items():
        per_shape[k].update(rows)
    print("bf16 scores against f32 scores (same call): " + "; ".join(
        f"{k} {bf_layer[k]:.4f} ms against {timing[k]['ms']:.4f}"
        for k in bf_layer) + " (kernels 1-3 per internlm2 layer, 4 per "
        "round, 5-7 per deepseek-v2-lite MoE layer, 8-9 per mamba2 layer)")
    print(f"timing phase ({time.time() - t0:.1f}s), ms per launch (dense "
          f"at M={M}, grouped at E={N_EXPERTS} M={CAP}; conv per layer at "
          f"B={CONV_B} S={CONV_S}: fwd + flipped dx, ds; pack per leaf, "
          f"one row; unpack per leaf, {COHORTS} rows): kernel / plain / "
          f"library / bound")
    for kname, rows in per_shape.items():
        for leaf, (tk, tp, tl, tb) in rows.items():
            lib = "-" if tl is None else f"{tl:.4f}"
            print(f"  {kname:24s} {leaf:9s} {tk:9.4f} {tp:9.4f} {lib:>9s} "
                  f"{tb:9.4f}")
    t0 = time.time()
    for arch in ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
                 "recurrentgemma-9b", "qwen2-7b", "qwen2-vl-2b",
                 "whisper-medium"):
        smoke_reference_phase(torch, dev, arch)
    feature_backward_phase(torch, dev)
    decode_reference_phase(torch, dev)
    print(f"smoke reference phase: {time.time() - t0:.1f}s")

    steps_, every = 4, 2
    argv = ["--algo", "fedpm_reg", "--cohorts", str(COHORTS), "--batch",
            "2", "--seq", "128", "--steps", str(steps_), "--round-every",
            str(every), "--downlink-bits", "8", "--device", "cuda"]
    dense = N_LAYERS * len(LAYER_SHAPES) * COHORTS * steps_
    moe_cfg = moe_config()
    # per MoE-path train step: 8 dense projections in every layer (MLA 5
    # + the dense or shared MLP 3), 3 expert projections in each MoE
    # layer; 19 masked leaves per round
    n_moe = MOE_LAYERS - moe_cfg.first_dense_layers
    grouped = 3 * n_moe * COHORTS * steps_
    dense_moe = 8 * MOE_LAYERS * COHORTS * steps_
    rg_cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                                 n_layers=RG_LAYERS)
    rounds = steps_ // every
    per_pass = COHORTS * steps_       # launches of one projection or conv
    # mamba2: 2 dense projections (w_in, w_out) and one conv per layer,
    # 3 masked leaves per round.  recurrentgemma at 5 layers: one group
    # (rec, rec, attn) and a 2-layer rec tail, so 4 rec blocks of 8 dense
    # projections (w_x, w_y, w_rg, w_ri, w_out, the MLP's 3) and one conv
    # each, and 1 attn block of 7 (w_q, w_k, w_v, w_o, the MLP's 3).  A
    # round packs each stacked leaf once: 9 under each of groups/b0_rec,
    # groups/b1_rec and the tail, 7 under groups/b2_attn, 34 in all.
    # Kernel 8 runs twice per conv and pass (forward, flipped dx).
    paths = [
        (get_config("internlm2-1.8b"), {
            "masked_matmul_fwd": dense, "masked_matmul_dx": dense,
            "masked_matmul_ds": dense,
            "sample_and_pack": len(LAYER_SHAPES) * rounds}),
        (moe_cfg, {
            "masked_matmul_fwd": dense_moe, "masked_matmul_dx": dense_moe,
            "masked_matmul_ds": dense_moe,
            "sample_and_pack": 19 * rounds,
            "masked_matmul_grouped": grouped,
            "masked_matmul_grouped_dx": grouped,
            "masked_matmul_grouped_ds": grouped}),
        (get_config("mamba2-370m"), {
            "masked_matmul_fwd": 2 * MAMBA_LAYERS * per_pass,
            "masked_matmul_dx": 2 * MAMBA_LAYERS * per_pass,
            "masked_matmul_ds": 2 * MAMBA_LAYERS * per_pass,
            "sample_and_pack": 3 * rounds,
            "masked_conv1d": 2 * MAMBA_LAYERS * per_pass,
            "masked_conv1d_ds": MAMBA_LAYERS * per_pass}),
        (rg_cfg, {
            "masked_matmul_fwd": (4 * 8 + 7) * per_pass,
            "masked_matmul_dx": (4 * 8 + 7) * per_pass,
            "masked_matmul_ds": (4 * 8 + 7) * per_pass,
            "sample_and_pack": (3 * 9 + 7) * rounds,
            "masked_conv1d": 2 * 4 * per_pass,
            "masked_conv1d_ds": 4 * per_pass}),
    ]
    # each round unpacks every masked leaf's cohort rows once (the mean)
    paths = [(cfg, dict(expect, unpack_bits=ROUND_LEAVES[cfg.name] * rounds),
              []) for cfg, expect in paths] + zoo_paths(steps_, every)
    paths = [(cfg, {k: expect.get(k, 0) for k in dispatch.KERNELS}, more)
             for cfg, expect, more in paths]
    launches = {k: 0 for k in dispatch.KERNELS}
    for cfg, expect, more in paths:
        got = train_path(torch, dispatch, cfg, expect, argv + more,
                         steps_, every)
        launches = {k: launches[k] + got[k] for k in launches}
        if cfg.name == "qwen2-vl-2b":
            got = vlm_patch_step(torch, dispatch, dev)
            launches = {k: launches[k] + got[k] for k in launches}

    # the slice's new paths: full depth on bf16 scores, microbatches with
    # remat, block-local MoE dispatch, chunked attention at 32k tokens
    for phase in (full_depth_phase, microbatch_remat_phase,
                  block_dispatch_phase, chunked_attention_phase):
        t0 = time.time()
        got = (phase(torch, dispatch, dev, argv, steps_, every)
               if phase is block_dispatch_phase
               else phase(torch, dispatch, dev))
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"{phase.__name__}: {time.time() - t0:.1f}s")

    t0 = time.time()
    got = masked_decode_phase(torch, dispatch, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"masked decode paths: {time.time() - t0:.1f}s")
    t0 = time.time()
    serve_phase(torch, dispatch, dev)
    # masked leaves of an artifact: internlm2 7, mamba2 3 (w_in, the
    # conv, w_out)
    for arch, n_leaves in (("internlm2-1.8b", len(LAYER_SHAPES)),
                           ("mamba2-370m", 3)):
        got = artifact_phase(torch, dispatch, dev, arch)
        expect = {k: 0 for k in dispatch.KERNELS}
        expect.update(pack_bits=n_leaves, unpack_bits=n_leaves)
        check(got == expect, f"artifact path {arch} launch counts {got}, "
              f"expected {expect}")
        launches = {k: launches[k] + got[k] for k in launches}
    print(f"serve and artifact paths: {time.time() - t0:.1f}s")

    # the paper's CNNs: the fused step (kernels 1-3), the host-sim API at
    # the published widths and the Fig. 1 benchmark (kernels 10-11)
    for phase in (fused_cnn_phase, hostsim_phase, fig1_phase):
        t0 = time.time()
        got = (phase(torch, dispatch, mm, dev) if phase is fused_cnn_phase
               else phase(torch, dispatch, dev))
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"{phase.__name__}: {time.time() - t0:.1f}s")
    # the rest of the host-sim API: the baselines, the codecs on their
    # payloads, the golomb meter at full width and the Fig. 2 benchmark
    t0 = time.time()
    got, sent = baselines_phase(torch, dispatch, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"baselines_phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    codec_phase(torch, dispatch, sent)
    del sent
    print(f"codec_phase: {time.time() - t0:.1f}s")
    for phase in (golomb_meter_phase, fig2_phase):
        t0 = time.time()
        got = phase(torch, dispatch, dev)
        launches = {k: launches[k] + got[k] for k in launches}
        print(f"{phase.__name__}: {time.time() - t0:.1f}s")

    # the runtime: checkpoint and restart, the async engine and the tree
    t0 = time.time()
    checkpoint_phase(torch, dev)
    print(f"checkpoint_phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    got = kill_resume_phase(torch, dispatch)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"kill_resume_phase: {time.time() - t0:.1f}s")
    got = mesh_phase(torch, dispatch)
    launches = {k: launches[k] + got[k] for k in launches}
    got = analysis_phase(torch, dispatch, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    t0 = time.time()
    got, profiled = async_phase(torch, dispatch, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"async_phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    got = tree_phase(torch, dispatch, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"tree_phase: {time.time() - t0:.1f}s")
    runtime_profile(torch, *profiled)
    del profiled
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # the multi-pod dry run (its rounds on the card) and the examples
    got = dryrun_phase(torch, dispatch)
    launches = {k: launches[k] + got[k] for k in launches}
    t0 = time.time()
    got = examples_phase(torch, dispatch, dev)
    launches = {k: launches[k] + got[k] for k in launches}
    print(f"examples_phase: {time.time() - t0:.1f}s")
    torch.cuda.empty_cache()

    # the first four training paths and, of the zoo's, whisper-medium
    for cfg, _, _ in paths[:5]:
        t0 = time.time()
        profile_phase(torch, dev, cfg)
        print(f"profile phase {cfg.name}: {time.time() - t0:.1f}s")
        torch.cuda.empty_cache()
    serve_profile_phase(torch, dev)
    lockstep_profile_phase(torch, dev)

    kernels = []
    for name in dispatch.KERNELS:
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err[name], **timing[name]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
