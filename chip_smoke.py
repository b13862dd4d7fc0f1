#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--full]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch version on the card (at the
paper's DEFAULT shapes and at tile-tail shapes; the conv kernels at
every shape of the main path, the backward with and without dx, timed
beside a grouped ``conv2d`` and the im2col GEMM; ``hieavg_agg`` as one
launch over the CNN's six leaves, with float32, bfloat16 and
float8_e4m3fn history; ``coef_agg`` and ``coef_agg_pair`` as one launch
over the six leaves at the edge and the global layer's lead, bitwise on
repeat; ``sgd_update`` as one launch over the CNN's six leaves, with one
scale and, before each sweep plan runs, with one scale a row at every row
count its buckets give that path (``sgd_update[rows]``,
``torch._foreach_addcmul`` its library yardstick);
``eval_head`` at 10 and 100 classes, bitwise on repeat;
``flash_attention`` over a grid of lengths, head dims, masks and GQA
groups in float32 and bfloat16, at unit-scale and at sharp logits, and
at the serving shape of h2o-danube-1.8b in bfloat16 and float32, after a
line that names the kernel each input type launched and its HGMMA
count) and times both.  Then it runs the
paper's experiment at the full width of its CNN (DEFAULT cut to T = 4:
5 SGD steps per edge round, 2 cold-boot and 2 warm global rounds) under
every single-run aggregator: ``hieavg`` (float32, bfloat16 and float8
history) and ``t_fedavg``, ``d_fedavg``, ``delayed_grad`` with temporary
stragglers, ``fedavg`` without.  Each runs once with the kernels
(``kernel_mode="auto"``) and once with the plain versions (``"torch"``),
and the two must agree.  Last, ``run_checkpointed(every=2)`` is cut
after its first chunk and resumed from a fresh simulator: the result
must be bitwise the uninterrupted checkpointed run's.  Then the
``geometry`` phase: the same experiment (HieAvg, T = 2) at three CNN
geometries past the conv kernels' old limits (``GEOMETRY``: a 96-pixel
image, 128 -> 256 channels, 256 pixels a row), kernels against plain
within the engine-parity bounds, clock and energy equal; the conv kernels
are also checked at those geometries' shapes and tails (``CONV_SHAPES``,
dW and db bitwise on repeat) and timed at two of them (``CONV_WIDE``).
Then the sweeps
(``repro_torch.fl.sweep``) at the CNN's full width, DEFAULT cut to T = 4
with one epoch over each device's own shard: Fig. 3's eleven rows
(``bucket_cost="measured"``) and a "switched" plan (HieAvg,
delayed-gradient and FedAvg x two straggler fractions over seeds 0 and 1,
and one ragged ``j_per_edge`` point), each run with the kernels and with
the plain versions on the same buckets, and every point once more alone:
each point within the engine-parity bounds of its standalone run and of
the plain sweep, clock and energy equal.  Then K* over a batched grid
(``optimize_k_masked`` on the card, 16 ``LatencyParams`` x 3 omega_bar,
against the host's ``optimize_k``: every K* equal).  Then the sweep over
a mesh's ranks (``mesh_sweep``): Fig. 3's eleven rows through
``run_sweep(mesh=make_sweep_mesh())`` in a world of one, bitwise the
meshless kernel sweep; then two ``gloo`` ranks on the one card, each a
process of this script (``--mesh-rank``), run ten of the rows as one
bucket split five points a rank (``placement="shard"``) and all eleven
under ``"auto"``, rank 0's rows within the engine-parity bounds of this
process's sweep of the same plan, and ``"shard"`` on eleven rows as one
bucket must raise.  Then the census (``mesh_census``): the bytes the
stand-ins of ``launch.inputs.input_specs`` reckon for danube's serve cell
and its 4-layer train line on a one-card mesh against what the drivers'
own code asks the card's allocator for, the prefill on that mesh bitwise
the meshless one, the largest pair whose arguments alone (the census)
are within the card, and the dry-run's memory tracker held to the card
(``peak_case``): its peak of the plain step (argument + output + temp,
``launch.dryrun.track`` on meta tensors of the same shapes) for danube's
serve prefill, the train line and deepseek-v2-lite's prefill cut to two
layers, within MEMORY_BOUND of the allocator's requested peak of the same
step on the card, the tracker with its frees ignored outside it, the
kernel path's peak beside.  Then ``mesh_memory``: two ranks of (data=1,
model=2) sharing the card run danube's float32 HFL step cut to two
layers, each rank's requested peak held so to the tracker's on a fake
group of two ranks (a process of its own, ``--mesh-memory-predict``).
Then ``mesh_train``: the training entry point on a mesh,
``train.run(..., mesh=...)`` on danube at full width cut to two layers
(float32, one edge of two clients of 2 x 2048 tokens, T = 1, K = 2), by
four ranks of (data=2, model=2) sharing the card on the staged group and
by a group of one rank on NCCL (``--mesh-train-rank``), each rank's
setup peak (its shard built leaf by leaf, ``train.mesh_state``) held to
its placed state plus one whole leaf, its losses, clock and chain to the
one-card run's (see MESH_TRAIN_KW).  Then population
mode at full width (DEFAULT cut to T = 4, a cohort of 5 devices an edge
resampled every round out of stores of 10^3 and 10^6 devices, each built
once): HieAvg and delayed-gradient with the kernels and plain, the pair
within the engine-parity bounds, launch counts those of the standalone
smoke run, churn resets applied at every occupant change of the
delayed-gradient run, peak memory the same at both sizes; the 10^6
delayed-gradient run checkpointed, cut and resumed, bitwise; a static cohort
of the 10^6 store against ``store.subset`` of its rows, bitwise; the
mixed grid of ``benchmarks/bench_population.py`` (HieAvg, delayed-gradient
at beta 0.5 and 0.9) over the 10^6 store as one "switched" stack, each
point within the engine-parity bounds of its standalone run.  Then
``run_legacy()`` (the per-edge loop in plain PyTorch, no kernel) against
the smoke HieAvg ``run()``, within the engine-parity bounds.  Last, the LLM
serving path: ``repro_torch.launch.serve.run`` on h2o-danube-1.8b at full
width (24 layers, bfloat16, batch 2, a prompt of 8192 tokens, twice the
sliding window, 32 greedy tokens), with the flash kernel and with its
plain version on the same seeded weights, and the parity of the two,
layer by layer (see ``serve_parity``); then the same for the two models
with cross-attention at full width and depth: llama-3.2-vision-11b (40
layers, 8 of them cross-attention over 1601 image tokens, a prompt of
8192) and seamless-m4t-large-v2 (a 24-layer encoder over 1500 frames, 24
decoder layers, a prompt of 2048), each kernel run's flash launches
counted at each layer kind's shape, their parity with random memory and
gates 1.0 at every encoder, self- and cross-attention layer, and against
``serve.run`` itself fed that memory and those gates (its timed run reads
zero memory under zero gates, which leaves cross-attention inert).  (The
flash kernels at those models' non-causal shapes are checked in the flash
phases' grids and timed, forward and backward, in
``flash_model_timing``.)  Then the training path: the flash
backward kernels against their plain version (``flash_bwd_phase``: tail
cases in float32 and bfloat16 and the serving shape, the forward's
``lse`` against the plain forward's, each backward against the plain one
fed the plain forward's output and ``lse``; ``flash_bwd_design`` before
it: the backward kernels each input type launched and their HGMMA
counts), ``repro_torch.launch.train.run`` on h2o-danube-1.8b at full
width cut to 4 layers (one edge of two clients, 2 x 8192 tokens a client
a step) with the kernels and plain, its parity and danube-smoke's on the
card (``train_parity``), one client's float32 gradients at full width,
kernels against plain, beside the same reading for a plain version
whose attention backward is broken (``train_grads``), and its bfloat16
gradients layer by layer: every backward call of the model recorded and
the kernel held against the plain backward on it (``train_grads_bf16``);
then ``train.run`` on seamless-m4t-large-v2 cut to 4 decoder and 4
encoder layers (2 x 2048 tokens a client) with the kernels and plain and
its parity, one HFL step of it in float32 with random memory and gates
1.0, kernels against plain (``xattn_step_parity``: the train line's zero
memory and zero gates leave its encoder and cross-attention inert), and
``train_grads_bf16`` on seamless at that cut and on llama-vision cut to
one unit, with random memory and gates 1.0.  Last, multi-head latent
attention and mixture-of-experts (``MOE_SERVE``, ``MOE_TRAIN``):
``serve.run`` on minicpm3-4b and deepseek-v2-lite-16b at full width and
depth and on grok-1-314b cut to 2 of its 64 layers (batch 2, a prompt of
8192, 32 greedy tokens), kernels and plain, each with its
``serve_parity`` (every MLA layer's attention at Dh 96 or 192 within the
flash bound and its padded columns exactly 0, every MoE block bitwise in
both modes, logits and decode against ``serve.run`` itself); then
``train.run`` on the two MLA models cut to 4 layers (2 x 8192 tokens a
client), kernels and plain, ``train_parity`` and ``train_grads_bf16`` at
Dh 96 and 192.  The flash phases hold the kernels at those head dims and
at grok's group of 6 (``FLASH_MLA``, ``FLASH_BWD_CASES``), and
``flash_model_timing`` times them at the three models' causal shapes.
Last, the recurrent layer kinds (``RECURRENT_SERVE``,
``RECURRENT_TRAIN``): ``serve.run`` on recurrentgemma-9b (38 layers:
RG-LRU and local attention at head dim 256, 16 query heads over one kv
head, window 2048, and a (rec, rec) tail) and on mamba2-130m (24 SSD
layers, no attention: no kernel launches, and its line says so) at full
width and depth, batch 2, a prompt of 8192, 32 greedy tokens, kernels and
plain, and recurrentgemma's ``serve_parity`` (every attention layer at
the flash bounds, every recurrent layer and its caches bitwise in both
modes, the tail after the units); ``train.run`` on mamba2 at full depth
and on recurrentgemma cut to one unit and its tail (5 layers), kernels
and plain, ``train_parity``, and ``train_grads_bf16`` on recurrentgemma's
attention layer; then recurrentgemma trained in float32 (``RG_F32_KW``:
one client of 1 x 8192 tokens at 5 layers), kernels and plain, its
``train_parity``, the dry-run's predicted peak beside the card's
(``train_rg_f32``), and the float32 backward at Dh 256 timed at the
``[rg]`` shape (``flash_attention_bwd[rg_f32]``).  The flash phases hold the kernels at head dim 256
(``FLASH_RG``, two sharp cases in ``FLASH_SHARP``; the float32 backward
on its 32-row tiles), and ``flash_model_timing`` times them at
recurrentgemma's shape (``[rg]``, with the instances' registers, spills
and HGMMA counts).  The flash phases also hold the kernels at head dims
no kernel is built for (``FLASH_PADDED``: 24, smoke MLA's, 40 and 100),
which the wrappers run zero-padded to the next built one.  Every kernel
is also held at the shapes the example drivers give it: the CNN kernels
at REDUCED's widths, leaves, row counts (``EXAMPLE_ROWS``) and n_test
(``CONV_SHAPES``, ``EXAMPLE_NTEST``), the flash kernels at smoke width
(``FLASH_SMOKE``).  Last, the
example drivers (``examples_torch/``, the ``examples`` phase): each
driver's ``main`` under "auto" at the reference driver's own sizes
(``quickstart``, ``leader_failover``, ``latency_optimization``,
``sweep_grid``, ``sweep_topology``, ``latency_pareto``, ``serve_batched``
for all ten architecture ids, ``train_bhfl_llm``), each checked to
launch the kernels of its path (``EXAMPLES``) and to give what the
reference driver states, and ``quickstart`` under "torch" too, its
host-plane rows equal to the kernel run's and its accuracies within the
engine-parity bound.

Output, one line each: the card as ``nvidia-smi`` names it, then JSON
objects: the build, one per kernel check (with ``flash_design`` before
the flash line and ``flash_bwd_design`` before the backward's), one per
run (each run launches ``sgd_update`` once per
local step and one aggregate kernel per aggregate: ``coef_agg`` in
HieAvg's cold rounds and in FedAvg, ``hieavg_agg`` in HieAvg's warm ones,
``coef_agg_pair`` in delayed-gradient), one parity line
per configuration, the resume checks, one ``sweep`` line per plan (its
buckets, wall seconds of the plan, of its plain run and of its points one
by one, peak memory, launches, the largest differences and whether they
are bitwise), the ``kstar`` line, four ``mesh_sweep`` lines (the world of
one; each ranked plan with each rank's wall seconds, device, launches and
per-row SGD rows; the refused ``"shard"``), the ``mesh_census`` line
(its ``peaks``), the ``mesh_memory`` line, a ``mesh_train_rank`` line a
rank and the ``mesh_train`` line, one ``population`` line per
store size and aggregator (the store's host build seconds, rounds/s, peak memory,
launches and churn resets of each mode, and their parity), the
``population_resume``, ``population_parity``, ``population_sweep`` and
``legacy`` lines, one per serve run, the serve parity, one ``train``
line per mode, ``train_parity``, ``train_grads``, ``train_grads_bf16``,
``xattn_step_parity``, the MLA and MoE models' ``serve``,
``serve_parity``, ``train``, ``train_parity`` and ``train_grads_bf16``
lines, the same for the recurrent models, one ``example`` line per
driver run (wall seconds, launches, peak memory, the driver's last
printed lines) and the ``example_parity`` line, the ``kernels`` summary,
and last ``{"ok": true,
"device": {...}}``.  ``--profile`` adds one more HieAvg run, the switched sweep,
one train round and the serve path's prefill and decode (danube, the
two cross-attention models, minicpm3, deepseek-v2-lite, recurrentgemma,
mamba2) under
``torch.profiler``, a line of device time per kernel each;
``--full`` adds the paper's whole DEFAULT run (T = 50) per mode of
HieAvg, FedAvg and delayed-gradient aggregation, its Fig. 2 set
(``run_comparison`` under temporary and permanent stragglers, with
HieAvg's eq. (4) as written and normalized), Fig. 3's grid at T = 50 as
one plan (wall seconds, final and best accuracy per point), population
HieAvg at T = 50 over stores of 10^3 to 10^6 devices (``population_full``:
rounds/s per size, best of 3 in turns, and their max/min ratio), a
serve run with a prompt of 32768 tokens, the 24-layer train run with the
kernels (time and memory: its random weights diverge at that depth), and
one client's gradients at 12 and 24 layers (``train_grads_depth``).
Any failed phase raises and exits non-zero; without a CUDA device it
exits 2 and prints nothing on stdout.  Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib.util
import io
import itertools
import json
import math
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks: HBM3 bandwidth, dense FP32 and bf16
# tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

# the paper's DEFAULT widths: D = 5 x 5 devices, B = 32, 28x28, c1 = 32,
# c2 = 64, 10 classes, n_test = 1000
D, B, HW, C1, C2, NCLS, NTEST = 25, 32, 28, 32, 64, 10, 1000
FEAT = (HW // 2) ** 2 * C2
# the example drivers' REDUCED widths (``configs/bhfl_cnn.py``; checked
# against it at run time): B = 16, 14x14, c1 = 8, c2 = 16; their n_test:
# 400 (quickstart, leader_failover) and 300 (the four sweep drivers); the
# most points a sweep driver runs (latency_pareto's 18), each of 5 x 5
# devices
RB, RHW, RC1, RC2 = 16, 14, 8, 16
RFEAT = (RHW // 2) ** 2 * RC2
EXAMPLE_NTEST, EXAMPLE_POINTS = (400, 300), 18
#: the conv kernels' check shapes (D, B, H, W, Cin, Cout) past the old
#: limits: every shape the GEOMETRY runs give the kernels (``geometry_phase``
#: checks that none is missing): S1's, S2's and S3's two layers at the
#: train shape (layer 2 of S1 and S2 timed, CONV_WIDE) and at the eval
#: shape (n_test NTEST, one model), then a 230-pixel row's tail segment,
#: 4096 input channels (weights streamed) and 300 (streamed, odd)
CONV_GEOMETRY_SHAPES = (
    (D, B, 96, 96, C1, C2), (D, B, 96, 96, 1, C1),
    (1, NTEST, 96, 96, 1, C1), (1, NTEST, 96, 96, C1, C2),
    (D, B, HW, HW, 128, 256), (D, B, HW, HW, 1, 128),
    (1, NTEST, HW, HW, 1, 128), (1, NTEST, HW, HW, 128, 256),
    (4, 8, 256, 256, 8, 16), (4, 8, 256, 256, 1, 8),
    (1, NTEST, 256, 256, 1, 8), (1, NTEST, 256, 256, 8, 16),
    (1, 2, 9, 230, 3, 5), (1, 1, 3, 3, 4096, 64), (1, 2, 10, 10, 300, 7))
#: the conv kernels' check shapes (D, B, H, W, Cin, Cout): the main path's
#: (train and eval, layers 2 and 1; the first is timed), the example
#: drivers' at REDUCED (train at 25 devices and at the largest sweep's
#: points x 25, eval of one model at n_test 400 and of the largest sweep's
#: points at 300) and tails of the tiling: one tile, tails, odd channels,
#: a non-square image, channels across the 4-channel chunk and 8-channel
#: group edges; then CONV_GEOMETRY_SHAPES
CONV_SHAPES = ((D, B, HW, HW, C1, C2), (D, B, HW, HW, 1, C1),
               (1, NTEST, HW, HW, 1, C1), (1, NTEST, HW, HW, C1, C2),
               (D, RB, RHW, RHW, 1, RC1), (D, RB, RHW, RHW, RC1, RC2),
               (EXAMPLE_POINTS * D, RB, RHW, RHW, 1, RC1),
               (EXAMPLE_POINTS * D, RB, RHW, RHW, RC1, RC2),
               (1, EXAMPLE_NTEST[0], RHW, RHW, 1, RC1),
               (1, EXAMPLE_NTEST[0], RHW, RHW, RC1, RC2),
               (EXAMPLE_POINTS, EXAMPLE_NTEST[1], RHW, RHW, 1, RC1),
               (EXAMPLE_POINTS, EXAMPLE_NTEST[1], RHW, RHW, RC1, RC2),
               (1, 1, 5, 5, 1, 3), (2, 2, 12, 12, 4, 8), (1, 2, 16, 16, 3, 7),
               (1, 3, 7, 9, 5, 6), (1, 2, 10, 10, 33, 65),
               *CONV_GEOMETRY_SHAPES)
#: the paper's experiment at CNN geometries past the conv kernels' old
#: limits (the ``geometry`` phase: HieAvg, temporary stragglers at both
#: layers, T = GEOMETRY_T, kernels and plain): label -> the BHFLSetting
#: fields it overrides.  S1: a 96-pixel image at the paper's widths (the
#: dW pass's row segments); S2: 128 -> 256 channels (dx's streamed
#: weights, dW's channel windows); S3: 256 pixels a row (two column
#: segments), 2 edges of 2 devices at batch 8
GEOMETRY = {"s1": dict(image_hw=96),
            "s2": dict(cnn_c1=128, cnn_c2=256),
            "s3": dict(image_hw=256, cnn_c1=8, cnn_c2=16, n_edges=2,
                       j_per_edge=2, batch_size=8)}
GEOMETRY_T = 2
#: the geometry runs' local steps an edge round: DEFAULT's own count
#: (4000 // (25 x 32)), which S1 and S2 take by themselves; one epoch of
#: S3's 4 devices x batch 8 would be 125 (25 s a plain run on the card)
GEOMETRY_KW = dict(steps_per_epoch=5)
#: the conv entries of the ``kernels`` line at a geometry's second layer
#: (D, B, H, W, c1, c2 of its train step; PERF.md rows 1b, 2b): label ->
#: geometry
CONV_WIDE = {"s2": (D, B, HW, HW, 128, 256), "s1": (D, B, 96, 96, C1, C2)}

REPLACES = {
    "conv3x3_fwd": "src/repro/kernels/conv3x3.py:83",
    "conv3x3_bwd": "src/repro/kernels/conv3x3.py:105",
    # the same two kernels at the geometries' second layers (CONV_WIDE)
    "conv3x3_fwd[s2]": "src/repro/kernels/conv3x3.py:83",
    "conv3x3_bwd[s2]": "src/repro/kernels/conv3x3.py:105",
    "conv3x3_fwd[s1]": "src/repro/kernels/conv3x3.py:83",
    "conv3x3_bwd[s1]": "src/repro/kernels/conv3x3.py:105",
    "sgd_update": "src/repro/kernels/sgd_update.py:40",
    "sgd_update[rows]": "src/repro/kernels/sgd_update.py:40",
    "hieavg_agg": "src/repro/kernels/hieavg_agg.py:60",
    "coef_agg": "src/repro/kernels/coef_agg.py:62",
    "coef_agg_pair": "src/repro/kernels/coef_agg.py:88",
    "eval_head": "src/repro/kernels/eval_head.py:48",
    "flash_attention": "src/repro/kernels/flash_attention.py:77",
    # the Pallas kernel has no backward: this is the gradient of its function
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:77",
    # the same two kernels at the cross-attention and encoder cells'
    # shapes (FLASH_TIMED)
    "flash_attention[xattn]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention[enc]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention[xattn_m4t]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention_bwd[enc]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention_bwd[xattn_m4t]":
        "src/repro/kernels/flash_attention.py:77",
    # the same two kernels at the multi-head latent attention and
    # mixture-of-experts cells' shapes (FLASH_TIMED)
    "flash_attention[mla96]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention[mla192]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention[grok]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention_bwd[mla96]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention_bwd[mla192]":
        "src/repro/kernels/flash_attention.py:77",
    # the same two kernels at recurrentgemma's local attention (Dh 256, G
    # 16, window 2048; FLASH_TIMED)
    "flash_attention[rg]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention_bwd[rg]": "src/repro/kernels/flash_attention.py:77",
    # the float32 backward at that shape (recurrentgemma trained in float32,
    # RG_F32_KW)
    "flash_attention_bwd[rg_f32]": "src/repro/kernels/flash_attention.py:77",
    # the same two kernels at a rank's shard of the mesh steps (danube's
    # heads over model=2; FLASH_SHARD)
    "flash_attention[shard]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention[shard_f32]": "src/repro/kernels/flash_attention.py:77",
    "flash_attention_bwd[shard_f32]":
        "src/repro/kernels/flash_attention.py:77",
}
SOURCE = {
    "conv3x3_fwd": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "conv3x3_bwd": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "conv3x3_fwd[s2]": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "conv3x3_bwd[s2]": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "conv3x3_fwd[s1]": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "conv3x3_bwd[s1]": "src/repro_torch/kernels/csrc/conv3x3.cu",
    "sgd_update": "src/repro_torch/kernels/csrc/sgd_update.cu",
    "sgd_update[rows]": "src/repro_torch/kernels/csrc/sgd_update.cu",
    "hieavg_agg": "src/repro_torch/kernels/csrc/hieavg_agg.cu",
    "coef_agg": "src/repro_torch/kernels/csrc/coef_agg.cu",
    "coef_agg_pair": "src/repro_torch/kernels/csrc/coef_agg.cu",
    "eval_head": "src/repro_torch/kernels/csrc/eval_head.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention[xattn]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention[enc]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention[xattn_m4t]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd[enc]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd[xattn_m4t]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention[mla96]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention[mla192]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention[grok]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd[mla96]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd[mla192]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention[rg]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd[rg]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd[rg_f32]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention[shard]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention[shard_f32]":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd[shard_f32]":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}

#: the sweep phase: DEFAULT geometry cut to T = 4, one epoch over each
#: device's own shard (``steps_per_epoch=None``, as Fig. 3 runs); Fig. 3's
#: eleven rows (``benchmarks/fig3_sweeps.py``), and a "switched" plan of
#: aggregator x straggler fraction over two seeds with one ragged point
SWEEP_T = 4
SWEEP_KW = dict(n_train=4000, n_test=1000, steps_per_epoch=None)
FIG3 = (("j_per_edge", (3, 5, 8)), ("n_edges", (3, 5, 8)),
        ("k_edge_rounds", (1, 2, 4)), ("straggler_frac", (0.2, 0.4)))
SWITCHED = tuple({"aggregation": a, "straggler_frac": f}
                 for a in ("hieavg", "delayed_grad", "fedavg")
                 for f in (0.2, 0.4)) + (
    {"j_per_edge": [3, 5, 8, 5, 4], "seed": 1},)
SWITCHED_SEEDS = (0, 1)
#: the kernels of the sweep path each plan must launch
SWEEP_KERNELS = {"fig3": ("conv3x3_fwd", "conv3x3_bwd", "sgd_update[rows]",
                          "hieavg_agg", "coef_agg", "eval_head"),
                 "switched": ("conv3x3_fwd", "conv3x3_bwd", "sgd_update",
                              "hieavg_agg", "coef_agg", "coef_agg_pair",
                              "eval_head")}
#: the sweep over a mesh's ranks (``mesh_sweep``): MESH_WORLD ``gloo``
#: ranks on the one card, each a process of this script
#: (``--mesh-rank``), run Fig. 3's first ten rows as one bucket split
#: five points a rank (``placement="shard"``, ``max_buckets=1``), then all
#: eleven under ``"auto"`` over the reference's proxy plan (its buckets
#: split where their point count is even, whole on both ranks otherwise);
#: ``"shard"`` on the eleven as one bucket must raise.  A rank that has
#: not ended after MESH_RANK_TIMEOUT seconds fails the phase
MESH_WORLD = 2
MESH_PLANS = {"fig3_10_shard": (10, dict(max_buckets=1, placement="shard",
                                         bucket_cost="measured")),
              "fig3_11_auto": (11, dict(placement="auto",
                                        bucket_cost="proxy"))}
MESH_RANK_TIMEOUT = 600
#: the mesh steps phase (``mesh_steps``): MESH_STEPS_WORLD ranks of the
#: mesh MESH_STEPS_MESH on the one card, their collectives carried by
#: ``gloo`` through host memory (``launch.mesh.StagedGroup``).  Each runs
#: ``make_hfl_train_step`` on h2o-danube-1.8b at full width cut to
#: MESH_STEPS_LAYERS layers, float32 weights (so the float32 flash
#: kernels run), one edge of MESH_STEPS_CLIENTS clients of MESH_STEPS_ROWS
#: x MESH_STEPS_SEQ tokens; then a bf16 prefill of the same rows and
#: MESH_STEPS_GEN teacher-forced decode steps, again in float32 with
#: MESH_STEPS_GEN_F32 decode steps; and a bf16 and a float32 prefill of
#: deepseek-v2-lite-16b cut alike (experts split, the all-to-all; MLA
#: heads split).  Bounds against the one-card steps on the same card, each
#: measured from the same computation one precision up (float64 for
#: float32, float32 for bf16; the same weights upcast): the loss within
#: MESH_STEPS_LOSS_REL of the one-card loss; each client's gradient leaf,
#: and every step's logits, no farther from the one-precision-up values
#: (of the largest) than MESH_STEPS_SPREAD times the one-card values are,
#: nor than MESH_STEPS_GRAD_REL (gradients; the reference's jit-vs-eager
#: spread at smoke width, ROADMAP.md), MESH_STEPS_F32_REL (float32 logits)
#: or SERVE_REL_TOL (bf16 logits), whichever is larger; the float32 logits
#: also that near the one-card float32 logits.  The bf16 bounds come to
#: half the largest logit and more (bf16 rounding through random
#: full-width layers), so they catch only a gross fault: the float32 steps
#: are what hold the mesh's splits, the all-to-all and the cache writes to
#: the one card.  These random full-width weights amplify rounding: the
#: one-card float32 gradient lies ~1e-3 of a leaf's largest from float64
#: at 2 x 256 tokens on the CPU (PERF.md, section 6), and the mesh sums its
#: split products in another order
MESH_STEPS_WORLD = 4
MESH_STEPS_MESH = {"data": 2, "model": 2}
MESH_STEPS_LAYERS, MESH_STEPS_CLIENTS, MESH_STEPS_ROWS, MESH_STEPS_SEQ = \
    2, 2, 2, 2048
MESH_STEPS_GEN, MESH_STEPS_GEN_F32 = 8, 2
MESH_STEPS_MOE = "deepseek-v2-lite-16b"
MESH_STEPS_GRAD_REL, MESH_STEPS_LOSS_REL, MESH_STEPS_SPREAD = 2e-4, 1e-5, 2.0
MESH_STEPS_F32_REL = 1e-4
MESH_STEPS_SEED = 7
#: the script each rank runs (this one, with ``--mesh-rank``)
RANK_SCRIPT = Path(__file__).resolve()
#: the census's tolerance against the bytes the drivers ask the caching
#: allocator for (its ``requested_bytes``): 512 bytes a tensor.  The
#: allocator's own blocks (``memory_allocated``) are larger: a block is a
#: multiple of 512 bytes, and a block of the large pool keeps the tail of
#: its segment when that tail is 1 MiB or less (it is not split off)
CENSUS_ROUNDING = 512
BLOCK_TAIL = 1 << 20
#: the dry-run's peak held to the card (``peak_case``: ``mesh_census``'s
#: cases and the ``mesh_memory`` phase): the tracker's predicted peak
#: (argument + output + temp; ``launch.dryrun.track`` on the meta device)
#: within MEMORY_BOUND of the measured peak, the allocator's requested
#: bytes at the most while the card runs the same plain step at the same
#: shapes, above what was held before its arguments were placed.  The
#: workspace term, what warm-up GEMMs and one warm-up run of the step
#: leave behind (cuBLAS's workspaces, a library's scratch), is measured
#: first and held before the measured run, so it is out of the peak.  The
#: tracker with its frees ignored must read outside the bound.  Beside it
#: the kernel path's measured peak (no bound).  ``mesh_memory``: each of
#: MEMORY_WORLD ranks of MEMORY_MESH on the card (``start_group``) runs
#: danube's float32 HFL step cut to MEMORY_LAYERS layers, MESH_STEPS_*'s
#: clients, rows and sequence, placed as ``mesh_steps`` places it; its
#: prediction comes from a fake group of MEMORY_WORLD ranks on the meta
#: device in a process of its own
MEMORY_BOUND = 0.05
MEMORY_WORLD, MEMORY_MESH, MEMORY_LAYERS = 2, {"data": 1, "model": 2}, 2
#: the training entry point on a mesh (``mesh_train``): ``train.run(...,
#: mesh=...)`` as a user calls it, MESH_TRAIN_KW (h2o-danube-1.8b at full
#: width cut to MESH_STEPS_LAYERS layers, float32 weights, one edge of
#: MESH_STEPS_CLIENTS clients of MESH_STEPS_ROWS x MESH_STEPS_SEQ tokens,
#: T = 1, K = 2), by MESH_STEPS_WORLD ranks of MESH_STEPS_MESH sharing the
#: card (``start_group(backend="staged")``) and by a group of one rank on
#: ``"nccl"``, each a process.  Held to the one-card ``train.run`` on the
#: card: ``sim_clock``, blocks and chain bitwise; each edge round's loss
#: no farther from the one-card loss than MESH_STEPS_SPREAD times the
#: one-card loss is from the float64 run's (the same run one precision
#: up, plain attention), nor than MESH_STEPS_LOSS_REL, whichever is
#: larger; the NCCL rank's losses as near the one-card ones as a second
#: one-card run's are (bitwise where that one is).  Each rank's setup peak
#: (the allocator's requested bytes while ``train.mesh_state`` builds its
#: shard) at most its placed state plus the largest whole leaf (float32,
#: as drawn) plus CENSUS_ROUNDING bytes a tensor; the control, its placed
#: state plus the whole model (what building the whole model first took),
#: must read outside that bound
MESH_TRAIN_KW = dict(smoke=False, n_layers=MESH_STEPS_LAYERS, n_edges=1,
                     n_clients=MESH_STEPS_CLIENTS, batch=MESH_STEPS_ROWS,
                     seq=MESH_STEPS_SEQ, steps=1, k_edge=2,
                     param_dtype="float32", progress=False)

#: the K* grid: 16 LatencyParams (lm_device x lp_device) x 3 omega_bar,
#: consensus latency 3.3 s, K up to 64
KSTAR_LM, KSTAR_LP = (0.1, 0.51, 1.0, 2.0), (0.5, 1.67, 3.0, 6.0)
KSTAR_OMEGA, KSTAR_CONS, KSTAR_KMAX = (9.1, 10.3, 12.0), 3.3, 64

# engine-parity tolerances of tests/test_engine_parity.py
ACC_TOL, LOSS_TOL, DELTA_RTOL, DELTA_ATOL = 0.02, 1e-3, 0.01, 1e-4

#: the runs at DEFAULT width, T = 4: label -> (aggregator, stragglers at
#: both layers, history dtype name or None)
RUNS = {
    "hieavg": ("hieavg", "temporary", None),
    "t_fedavg": ("t_fedavg", "temporary", None),
    "d_fedavg": ("d_fedavg", "temporary", None),
    "delayed_grad": ("delayed_grad", "temporary", None),
    "fedavg": ("fedavg", "none", None),
    "hieavg_bf16": ("hieavg", "temporary", "bfloat16"),
    "hieavg_f8": ("hieavg", "temporary", "float8_e4m3fn"),
}
#: kernels every run launches, and those only some runs do
EVERY_RUN = ("conv3x3_fwd", "conv3x3_bwd", "sgd_update", "eval_head")
RUN_KERNELS = {"hieavg": ("hieavg_agg", "coef_agg"),
               "delayed_grad": ("coef_agg_pair",),
               "fedavg": ("coef_agg",),
               "hieavg_bf16": ("hieavg_agg", "coef_agg"),
               "hieavg_f8": ("hieavg_agg", "coef_agg")}
#: the run whose launches the ``kernels`` line reports, where not "hieavg"
LAUNCHES_FROM = {"coef_agg_pair": "delayed_grad"}
#: the kernels whose launches the ``kernels`` line takes from a smoke run
#: (flash_attention's come from the serve run, the per-row SGD update's
#: from the sweeps)
RUN_LAUNCHES = ("conv3x3_fwd", "conv3x3_bwd", "sgd_update", "hieavg_agg",
                "coef_agg", "coef_agg_pair", "eval_head")
#: the configurations whose checkpointed run is cut and resumed
RESUMED = ("delayed_grad", "hieavg_bf16")
#: the population cell: DEFAULT (5 edges, a cohort of 5 devices an edge:
#: 25 a round) cut to T = 4, n_train 4000, n_test 1000, cohorts resampled
#: every round, temporary stragglers; stores of POP_SIZES devices, each
#: built once; HieAvg and delayed-gradient, and the sweep's grid
#: (``benchmarks/bench_population.py``'s mixed grid: HieAvg beside
#: delayed-gradient at each beta of POP_BETAS) over the largest store.
#: ``--full`` runs HieAvg at T = 50 over POP_FULL_SIZES in turns, the best
#: of POP_REPEAT after one warm-up pass
POP_SIZES = (10 ** 3, 10 ** 6)
POP_FULL_SIZES = (10 ** 3, 10 ** 4, 10 ** 5, 10 ** 6)
POP_J_COHORT = 5
POP_KW = dict(n_train=4000, n_test=1000)
POP_RUNS = ("hieavg", "delayed_grad")
POP_BETAS = (0.5, 0.9)
POP_REPEAT = 3
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")

#: the serve cell: h2o-danube-1.8b at full width, batch 2, a prompt of
#: twice its sliding window, 32 greedy tokens; ``--full`` adds a prompt of
#: PREFILL_32K's length at batch 1
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = \
    "h2o-danube-1.8b", 2, 8192, 32
SERVE_LONG_PROMPT = 32768
#: the cross-attention and encoder serve cells, full width and depth, at
#: SERVE_BATCH and SERVE_GEN: llama-3.2-vision-11b (40 layers, every fifth
#: a gated cross-attention layer over 1601 patch embeddings, bf16 weights
#: 19.6 GB) with a prompt of 8192 tokens, and seamless-m4t-large-v2 (a
#: 24-layer encoder over 1500 frames, 24 decoder layers alternating self-
#: and cross-attention, 3.9 GB) with a prompt of 2048; the arch -> its
#: prompt length
XATTN_SERVE = {"llama-3.2-vision-11b": 8192, "seamless-m4t-large-v2": 2048}
#: their parity runs' memory and gates: N(0, 1) memory in bf16 from this
#: seed, every ``xattn_gate`` 1.0 (the reference's zero gate and its
#: drivers' zero memory leave cross-attention inert)
XATTN_MEMORY_SEED, XATTN_GATE = 3, 1.0
#: the multi-head latent attention and mixture-of-experts serve cells, full
#: width, at SERVE_BATCH, SERVE_PROMPT and SERVE_GEN: arch -> its depth
#: (None: its own).  minicpm3-4b (62 MLA layers, 4.07 B parameters, bf16
#: 8.1 GB), deepseek-v2-lite-16b (27 MLA + MoE layers, 64 experts top 6 and
#: 2 shared, 16.21 B, 32.4 GB) and grok-1-314b cut to 2 of its 64 layers
#: (GQA 48 over 8 heads, 8 experts top 2 of width 32768: 11.45 B, 22.9 GB;
#: its 316.5 B parameters hold on no single card)
MOE_SERVE = {"minicpm3-4b": None, "deepseek-v2-lite-16b": None,
             "grok-1-314b": 2}
#: their train cells: full width cut to TRAIN_LAYERS layers, TRAIN_KW
#: (minicpm3 0.44 B parameters, deepseek 2.76 B); and ``train_grads_bf16``
#: on each at that cut, 2 x 8192 tokens
MOE_TRAIN = ("minicpm3-4b", "deepseek-v2-lite-16b")
#: the recurrent cells, full width: recurrentgemma-9b (38 layers: 12 units
#: of two RG-LRU layers and a local-attention one at Dh 256, 16 query heads
#: over one kv head, window 2048, and a (rec, rec) tail; 9.40 B
#: parameters, bf16 18.8 GB) and mamba2-130m (24 SSD layers, no attention,
#: 0.129 B) served at full depth, SERVE_BATCH x SERVE_PROMPT, SERVE_GEN
#: tokens; trained (TRAIN_KW) at the depths given: mamba2 at its own,
#: recurrentgemma cut to one unit and the tail (5 layers, 2.17 B)
RG_ARCH, MAMBA_ARCH = "recurrentgemma-9b", "mamba2-130m"
RECURRENT_SERVE = (RG_ARCH, MAMBA_ARCH)
RECURRENT_TRAIN = {MAMBA_ARCH: 24, RG_ARCH: 5}
#: recurrentgemma-9b trained in float32 (the reference's own training
#: dtype; ``train.run(param_dtype="float32")``), its local attention's
#: backward on the float32 kernels at Dh 256: full width cut to one unit
#: and its tail (RECURRENT_TRAIN's 5 layers, the least ``cut_depth``
#: takes; 2.17 B parameters, 8.7 GB a copy), one edge of one client of
#: 1 x 8192 tokens, T = 1, K = 2, kernels and plain.  Sized by the
#: dry-run's peak of the plain step (``rg_f32_predict``, printed beside the
#: card's): two clients' state alone is 69.6 GB; one client's 43.5 GB and
#: the step's temp 21.6 GB give 65.1 GB of the card's 80
RG_F32_KW = dict(n_edges=1, n_clients=1, batch=1, seq=8192, steps=1,
                 k_edge=2, param_dtype="float32")
#: the layer kinds that attend to nothing (no flash call)
RECURRENT_KINDS = ("rec", "ssd")
#: auto-vs-torch bound on each layer's output and on the logits, relative
#: to their largest magnitude: 4 bfloat16 ulps at the top binade.  The two
#: flash versions differ by one ulp in a few elements; the layer's bf16
#: products after attention (wo, the MLP) carry that to a few ulps of the
#: layer's largest value.  The layers are compared fed the same input: the
#: random-weight model is chaotic, so free-running outputs diverge
#: (PERF.md, section 6).
SERVE_REL_TOL = 2.0 ** -5
#: the flash kernel's check grid: query and kv lengths (the serving
#: prompt's kv length among them), head dims, windows, (H, Hkv)
FLASH_SQ, FLASH_SKV = (1, 300, 512), (256, 300, 8192)
FLASH_DH, FLASH_WINDOWS = (32, 64, 80, 128), (None, 100, 4096)
FLASH_HEADS = ((2, 2), (8, 2))
#: sharp attention: (Sq, Skv, Dh, causal, window, q scale); q scaled up so
#: that logits reach the hundreds, as in the serving model's random
#: weights, where the order of the float32 sums decides the output
FLASH_SHARP = ((300, 8192, 80, True, 4096, 24.0), (129, 129, 128, False, None,
                                                   24.0),
               (512, 1000, 32, True, 256, 24.0), (300, 300, 64, True, 100,
                                                  60.0),
               (300, 1000, 96, True, None, 24.0), (257, 300, 192, True,
                                                   None, 24.0),
               (300, 1000, 256, True, 100, 24.0), (129, 257, 256, False,
                                                   None, 24.0))
#: the flash kernels at multi-head latent attention's head dims (96 = 64 +
#: 32, 192 = 128 + 64; 64-row kv tiles in the bf16 forward above Dh 128, a
#: dV and a dK pass in its backward) and at grok's group of 6: (Sq, Skv,
#: Dh, causal, window, (H, Hkv)), lengths no multiple of a tile, in the
#: forward's grid (float32 and bfloat16) and, with a q offset,
#: FLASH_BWD_CASES (like tests/test_torch_gpu.py's FLASH_MLA_CASES)
FLASH_MLA = ((300, 300, 96, True, None, (8, 8)),
             (129, 257, 96, False, None, (4, 4)),
             (257, 129, 96, True, 70, (8, 2)),
             (257, 127, 128, True, None, (12, 2)),
             (65, 130, 192, False, None, (4, 1)),
             (300, 300, 192, True, None, (4, 4)),
             (129, 257, 192, True, 100, (8, 2)),
             (1, 300, 192, True, None, (4, 1)))
#: the flash kernels at recurrentgemma's head dim 256 (32-row kv tiles in the
#: bf16 forward, 32-row streamed tiles in its backward): (Sq, Skv, Dh,
#: causal, window, (H, Hkv)), its group of 16 over one kv head among them,
#: windows, lengths across the 32-row tiles' edges, in the forward's grid
#: and, with a q offset, FLASH_BWD_CASES (tests/test_torch_gpu.py's
#: FLASH_RG_CASES), the float32 backward on its 32-row tiles
FLASH_RG = ((300, 300, 256, True, 100, (16, 1)),
            (33, 65, 256, False, None, (4, 1)),
            (129, 257, 256, True, 40, (16, 1)),
            (31, 31, 256, True, None, (2, 2)),
            (257, 127, 256, True, 70, (8, 2)),
            (130, 97, 256, False, None, (16, 1)))
#: the flash kernels at head dims no kernel is built for, run zero-padded
#: to the next built one at the true head dim's scale: smoke MLA's 16 + 8 =
#: 24 (-> 32; the serve_batched driver's MLA pair) and 40 (-> 64), 100
#: (-> 128); (Sq, Skv, Dh, causal, window, (H, Hkv)) in the forward's grid
#: and, with a q offset, FLASH_BWD_CASES (tests/test_torch_gpu.py's
#: FLASH_PADDED_CASES)
FLASH_PADDED = ((129, 129, 24, True, None, (4, 4)),
                (65, 130, 24, False, None, (8, 2)),
                (64, 64, 24, True, 20, (4, 1)),
                (200, 257, 40, True, 100, (8, 2)),
                (257, 127, 100, True, 70, (8, 2)),
                (129, 129, 100, False, 64, (2, 2)))
#: the flash kernels at the shapes the LLM example drivers give them
#: (smoke width: Dh 32, 4 query heads; batch EXAMPLE_LLM_BATCH): the
#: prompt's self-attention in ``serve_batched`` at 48 tokens (deepseek-7b
#: and seamless's decoder G 1; qwen3, grok and llama-vision G 2;
#: h2o-danube G 2 and recurrentgemma G 4 in a window of 16; the MLA pair
#: at Dh 24, padded), its cross-attention over 16 memory rows
#: (llama-vision G 2, seamless G 1) and seamless's encoder over 16 frames;
#: and ``train_bhfl_llm``'s 64 tokens (h2o-danube), in the forward's grid
#: and, with no q offset, FLASH_BWD_CASES' loop (FLASH_SMOKE_BWD):
#: (Sq, Skv, Dh, causal, window, (H, Hkv))
EXAMPLE_LLM_BATCH = 4
FLASH_SMOKE_BWD = ((64, 64, 32, True, 16, (4, 2)),)
FLASH_SMOKE = ((48, 48, 32, True, None, (4, 4)),
               (48, 48, 32, True, None, (4, 2)),
               (48, 48, 32, True, 16, (4, 2)),
               (48, 48, 32, True, 16, (4, 1)),
               (48, 48, 24, True, None, (4, 4)),
               (48, 16, 32, False, None, (4, 2)),
               (48, 16, 32, False, None, (4, 4)),
               (16, 16, 32, False, None, (4, 4))) + FLASH_SMOKE_BWD
#: the reference's float32 flash bound (tests/test_kernels.py)
FLASH_F32_ATOL = 2e-5
#: the flash kernels at the cross-attention and encoder cells' shapes,
#: non-causal, at batch SERVE_BATCH: ((Sq, Skv), Dh, (H, Hkv)) of
#: llama-vision's cross layers, seamless's encoder and its cross layers;
#: checked in the forward's grid and in FLASH_BWD_CASES
FLASH_MODEL = (((8192, 1601), 128, (32, 8)), ((1500, 1500), 64, (16, 16)),
               ((2048, 1500), 64, (16, 16)))
#: the shapes ``flash_model_timing`` checks and times, label -> ((Sq, Skv),
#: Dh, (H, Hkv), causal, backward timed too, window): FLASH_MODEL's, and
#: the causal self-attention of the MLA and MoE cells at SERVE_PROMPT:
#: minicpm3 (Dh 96, G 1), deepseek-v2-lite (Dh 192, G 1), grok (Dh 128,
#: G 6; no grok train line, so its backward is not timed); and
#: recurrentgemma's local attention (Dh 256, G 16, window 2048)
FLASH_TIMED = {
    "xattn": (*FLASH_MODEL[0], False, True, None),
    "enc": (*FLASH_MODEL[1], False, True, None),
    "xattn_m4t": (*FLASH_MODEL[2], False, True, None),
    "mla96": ((SERVE_PROMPT, SERVE_PROMPT), 96, (40, 40), True, True, None),
    "mla192": ((SERVE_PROMPT, SERVE_PROMPT), 192, (16, 16), True, True,
               None),
    "grok": ((SERVE_PROMPT, SERVE_PROMPT), 128, (48, 8), True, False, None),
    "rg": ((SERVE_PROMPT, SERVE_PROMPT), 256, (16, 1), True, True, 2048)}
#: the ``kernels`` line's entries at FLASH_TIMED's shapes: (kernel, label)
#: -> the main-path run whose launches at that shape the entry reports (the
#: serve runs' prefill at batch SERVE_BATCH, the enc-dec train run's
#: clients at TRAIN_KW's batch).  The cross-attention backward at
#: llama-vision's shape is timed but launched by no main-path run (no
#: llama-vision train line): it is left out of the ``kernels`` line
FLASH_TIMED_RUNS = {
    ("flash_attention", "xattn"): ("serve", "llama-3.2-vision-11b"),
    ("flash_attention", "enc"): ("serve", "seamless-m4t-large-v2"),
    ("flash_attention", "xattn_m4t"): ("serve", "seamless-m4t-large-v2"),
    ("flash_attention_bwd", "enc"): ("train", "seamless-m4t-large-v2"),
    ("flash_attention_bwd", "xattn_m4t"): ("train", "seamless-m4t-large-v2"),
    ("flash_attention", "mla96"): ("serve", "minicpm3-4b"),
    ("flash_attention", "mla192"): ("serve", "deepseek-v2-lite-16b"),
    ("flash_attention", "grok"): ("serve", "grok-1-314b"),
    ("flash_attention_bwd", "mla96"): ("train", "minicpm3-4b"),
    ("flash_attention_bwd", "mla192"): ("train", "deepseek-v2-lite-16b"),
    ("flash_attention", "rg"): ("serve", RG_ARCH),
    ("flash_attention_bwd", "rg"): ("train", RG_ARCH)}

#: the flash backward's check cases besides the serving shape: ((Sq, Skv),
#: Dh, (H, Hkv), causal, window, q_offset): every head dim, tails of the
#: 64-row tiles and, at Dh 80 with G = 4, of the bf16 design's 64- and
#: 128-row tiles (127, 129, 257) under windows that are no multiple of a
#: tile, GQA groups 1 and 4, a chunked prefill's offset and rows that see
#: no key, before and after the ones that do, and last FLASH_MODEL's
#: shapes (tests/test_torch_gpu.py's FLASH_BWD_CASES, those three at
#: reduced lengths)
FLASH_BWD_CASES = (((100, 100), 32, (4, 4), True, None, 0),
                   ((129, 129), 64, (8, 2), True, 50, 0),
                   ((65, 130), 80, (4, 1), False, None, 0),
                   ((130, 130), 128, (2, 2), False, 64, 0),
                   ((70, 200), 80, (8, 2), True, 40, 130),
                   ((64, 64), 80, (4, 1), True, None, -10),
                   ((1, 300), 64, (4, 1), True, 100, 299),
                   ((127, 127), 80, (8, 2), True, None, 0),
                   ((129, 129), 80, (8, 2), True, 100, 0),
                   ((257, 257), 80, (8, 2), True, 150, 0),
                   ((129, 257), 80, (8, 2), True, 100, 128),
                   ((257, 129), 80, (4, 1), False, 90, 0),
                   ((257, 127), 80, (8, 2), True, 70, 5)) + tuple(
    (sqkv, dh, hh, False, None, 0) for sqkv, dh, hh in FLASH_MODEL) + tuple(
    ((sq, skv), dh, hh, causal, window, 5 if causal else 0)
    for sq, skv, dh, causal, window, hh in FLASH_MLA + FLASH_RG
    + FLASH_PADDED) + (
    # recurrentgemma's window over a cut length, float32 on its 32-row tiles
    ((2304, 2304), 256, (16, 1), True, 2048, 0),)
#: the backward's bounds against its plain version (each side fed its own
#: forward's output and lse), relative to each gradient's largest
#: magnitude: float32 1e-4 (the same float32 sums in another order),
#: bfloat16 2^-7 (one bfloat16 ulp at the top binade: both sum in float32
#: and round once, which may land one ulp apart)
FLASH_BWD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
#: the forward kernel's lse against the plain forward's, relative to
#: max(1, |lse|): the same float32 exponentials summed in another order
#: (tests/test_torch_gpu.py holds it to 1e-5 too); rows that see no key
#: are +inf on both sides
FLASH_LSE_REL = 1e-5

#: the train cell: h2o-danube-1.8b at full width (d_model 2560, 32 heads,
#: 8 kv heads, head dim 80, d_ff 6912, vocab 32000, window 4096, bf16) cut
#: to TRAIN_LAYERS layers, one edge of two clients, 2 x 8192 tokens a
#: client a step, T = 2 global rounds of K = 2 edge rounds; ``--full`` the
#: 24-layer model with the kernels
TRAIN_ARCH, TRAIN_LAYERS = "h2o-danube-1.8b", 4
TRAIN_KW = dict(smoke=False, n_edges=1, n_clients=2, batch=2, seq=8192,
                steps=2, k_edge=2, progress=False)
#: the enc-dec train cell: seamless-m4t-large-v2 at full width (d_model
#: 1024, 16 heads, head dim 64, d_ff 8192, vocab 256206, bf16) cut to
#: XATTN_TRAIN_LAYERS decoder and as many encoder layers (0.76 B
#: parameters), 2 x XATTN_TRAIN_SEQ tokens a client, zero memory of 1500
#: frames (as the reference's driver feeds it), the rest as TRAIN_KW
XATTN_TRAIN_ARCH, XATTN_TRAIN_LAYERS, XATTN_TRAIN_SEQ = \
    "seamless-m4t-large-v2", 4, 2048
#: ``train_grads_bf16`` on the cross-attention archs, random memory
#: (XATTN_MEMORY_SEED) and gates XATTN_GATE: (arch, layers, rows, tokens a
#: row): seamless at the train cell's cut; llama-vision cut to one unit
#: (4 self-attention layers and a cross-attention one), 1 x 4096 tokens
XATTN_GRADS = (("seamless-m4t-large-v2", XATTN_TRAIN_LAYERS, 2,
                XATTN_TRAIN_SEQ), ("llama-3.2-vision-11b", 5, 1, 4096))
#: train parity, stated before the first call: the kernel run's first
#: reported loss within 1e-2 (relative) of the plain run's, clock and
#: blocks equal; danube-smoke (float32, head dim 32), T = 3, K = 2: the
#: first round's loss within the engine-parity bound (1e-3), every round's
#: within 2e-2: training the random weights is chaotic, and the
#: reference's own jit and eager steps end its third round 9.6e-3 apart
#: (tests/test_torch_train.py)
TRAIN_LOSS_REL, SMOKE_LOSS_TOL, SMOKE_CHAOS_REL = 1e-2, 1e-3, 2e-2
#: the train path's gradient parity (``train_grads``): one client's
#: gradients at full width, TRAIN_LAYERS layers, float32 weights, with the
#: kernels against the plain versions, the worst leaf's max |diff| within
#: 0.15 of that leaf's largest gradient, at two data seeds.  Set from a
#: first reading on the card: sound 0.046; the plain version with its
#: attention backward scaled by 0.9 0.34, with dq or dk/dv dropped
#: 1.06-1.09.  Every run measures every control of FAULTS and fails if
#: one of TRAIN_GRAD_FAULTS reads within the bound (a scale of 0.99 reads
#: within it: the check's resolution).  In bfloat16 this whole-model
#: reading cannot tell a sound backward from a broken one (sound 1.07, dq
#: dropped 1.09: the random weights amplify bfloat16 rounding), so the
#: bfloat16 path is held layer by layer (``train_grads_bf16``)
TRAIN_GRAD_REL = 0.15
TRAIN_GRAD_FAULTS = ("dq_dropped", "scaled_0.9")
#: the bfloat16 train path (``train_grads_bf16``): every layer's recorded
#: backward within FLASH_BWD_REL["bfloat16"] of the plain one, these
#: controls (FAULTS applied to the kernel's gradients) above it; and,
#: against a float32 gradient on the same bf16-rounded weights, the
#: kernel's error within this factor of the plain version's, checked only
#: where TRAIN_GRAD_FAULTS' controls read this factor above both
FLASH_BWD_FAULTS = ("dq_dropped", "scaled_0.9")
TRAIN_GRAD_ANCHOR_FACTOR = 2.0
#: the enc-dec step's loss with random memory and gates XATTN_GATE
#: (``xattn_step_parity``, float32), kernels against plain, relative.
#: Set from a first reading on the card (NVIDIA H100 80GB HBM3, 700 W):
#: the kernels 1.458e-4; the plain step with a few-ulp forward perturbation
#: (``o_noise``) 1.49e-5; with every non-causal forward output (encoder
#: and cross-attention) scaled by 0.9 1.63e-3, which every run measures
#: and must read above it.  The leaves' changes over that step are read,
#: not held: the few-ulp perturbation alone moves them by 0.49-2.59 of
#: their largest (the random weights amplify rounding), as much as the
#: kernels (0.43-2.17) or a dropped dq (1.0)
XATTN_LOSS_REL = 5e-4

#: the Dh-256 flash instances' build facts, read once the library is
#: built: registers and spill bytes per kernel (``tools/flash_ptxas.py``,
#: ``ptxas -v``) and HGMMA counts (``hgmma_counts``); the ``[rg]`` lines
#: carry them
FLASH_BUILD_FACTS: dict = {}

#: the example drivers (``examples_torch/``), each run once through its
#: ``main`` under "auto" at the reference driver's own sizes (the
#: ``examples`` phase): driver -> the kernels its path must launch.  The
#: CNN drivers' sweeps may also take the per-row SGD path
#: (``sgd_update[rows]``), as their buckets decide; it is counted, not
#: required.
EXAMPLE_CNN = ("conv3x3_fwd", "conv3x3_bwd", "sgd_update", "hieavg_agg",
               "coef_agg", "eval_head")
EXAMPLES = {"quickstart": EXAMPLE_CNN, "leader_failover": EXAMPLE_CNN,
            "latency_optimization": EXAMPLE_CNN, "sweep_grid": EXAMPLE_CNN,
            "sweep_topology": EXAMPLE_CNN, "latency_pareto": EXAMPLE_CNN,
            "serve_batched": ("flash_attention",),
            # the LLM step aggregates in plain PyTorch, as the reference's
            # in jnp (``launch/steps.py``): no aggregate kernel on its path
            "train_bhfl_llm": ("flash_attention", "flash_attention_bwd")}
#: the architectures ``serve_batched`` runs at smoke width in the examples
#: phase (all ten; the driver's default, mamba2-130m, has no attention
#: layer and launches no kernel)
EXAMPLE_SERVE_NO_KERNEL = (MAMBA_ARCH,)
#: the row counts (points x N x J) a bucket of the sweep drivers can give
#: the per-row SGD path: any number of points up to a driver's grid times
#: its N x J (5 x 5; sweep_topology's 8 points at N, J in {2, 4}), each
#: checked at REDUCED's leaves before the drivers run
EXAMPLE_ROWS = tuple(sorted(
    {p * nj for top, njs in ((EXAMPLE_POINTS, (25,)), (8, (4, 8, 16)))
     for p in range(1, top + 1) for nj in njs}))
#: the quickstart driver's rows that come from the host plane and must
#: equal between its kernel and plain runs
EXAMPLE_HOST_ROWS = ("sim_clock", "sim_energy", "blocks", "chain_valid",
                     "chain_latency", "k_star", "k_latency")

#: mantissa bits and least normal exponent of the narrow history dtypes
NARROW = {"bfloat16": (7, -126), "float8_e4m3fn": (3, -6)}
#: float32 values at the edges of float8_e4m3fn: the largest finite value
#: 448, the round-to-448 midpoint 464, what lies past it (NaN, as JAX casts),
#: infinities, NaN, and the subnormals and their rounding midpoints
F8_EDGES = (448.0, -448.0, 450.0, 464.0, -464.0, 464.01, -464.01, 465.0,
            480.0, 1e30, float("inf"), float("-inf"), float("nan"), 1.0,
            0.0, 2.0 ** -6, 2.0 ** -9, -2.0 ** -9, 2.0 ** -10,
            3 * 2.0 ** -11, 2.0 ** -11, 1.5 * 2.0 ** -9, 7 * 2.0 ** -10)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the FLOPs' time at
    ``flop_rate``, the card's peak for the inputs' type."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def host_ms(torch, fn, iters: int = 200) -> float:
    """The host's time per call of ``fn`` (perf_counter, the device not
    waited for inside the loop): what a host-bound wrapper costs."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def device_ms(torch, fn, symbols, iters: int = 20):
    """Device time per call of ``fn`` spent in the kernels whose names hold
    one of ``symbols``, read from ``torch.profiler``: the kernels' own time,
    without the host's launch cost that ``timed_ms`` includes.  None when
    the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if str(ev.device_type) == "DeviceType.CUDA"
             and any(sym in ev.key for sym in symbols))
    return us / 1e3 / iters if us > 0 else None


def launch_ms(torch, build, fn, iters: int = 10) -> dict:
    """Device time per call of each launch ``fn`` makes, by the name its
    wrapper hands ``build.check`` right after the launch: CUDA events
    recorded before the call and at each such check, so each launch's time
    runs from the end of the one before (with whatever the host did in
    between); the profiler is not needed."""
    sound, marks = build.check, []

    def mark(rc, name):
        sound(rc, name)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    fn()
    torch.cuda.synchronize()
    totals: dict = collections.defaultdict(float)
    build.check = mark
    try:
        for _ in range(iters):
            marks.clear()
            prev = torch.cuda.Event(enable_timing=True)
            prev.record()
            fn()
            torch.cuda.synchronize()
            for name, ev in marks:
                totals[name] += prev.elapsed_time(ev) / iters
                prev = ev
    finally:
        build.check = sound
    return dict(totals)


def check(name: str, ok: bool, detail: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {detail}")


#: device-side kernel names -> the port's kernels (the rest is PyTorch's)
KERNEL_SYMBOLS = (("conv3x3_fwd_kernel", "conv3x3_fwd"),
                  ("conv3x3_fwd_ws_kernel", "conv3x3_fwd"),
                  ("conv3x3_dx_kernel", "conv3x3_bwd dx"),
                  ("conv3x3_dx_ws_kernel", "conv3x3_bwd dx"),
                  ("conv3x3_dw_kernel", "conv3x3_bwd dW/db"),
                  ("conv3x3_dw_wide_kernel", "conv3x3_bwd dW/db"),
                  ("sgd_update_kernel", "sgd_update"),
                  ("hieavg_agg_kernel", "hieavg_agg"),
                  ("coef_agg_kernel<false>", "coef_agg"),
                  ("coef_agg_kernel<true>", "coef_agg_pair"),
                  ("eval_head_kernel", "eval_head"),
                  ("eval_head_argmax_kernel", "eval_head argmax"),
                  ("flash_attention_kernel", "flash_attention"),
                  ("flash_attention_wgmma_kernel", "flash_attention"),
                  ("flash_bwd_delta_kernel", "flash_attention_bwd delta"),
                  ("flash_bwd_dkdv_kernel", "flash_attention_bwd dk/dv"),
                  ("flash_bwd_dkdv_wgmma_kernel", "flash_attention_bwd dk/dv"),
                  ("flash_bwd_dq_kernel", "flash_attention_bwd dq"),
                  ("flash_bwd_dq_wgmma_kernel", "flash_attention_bwd dq"))


def symbols_of(kernel: str) -> tuple:
    return tuple(k for k, v in KERNEL_SYMBOLS
                 if v == kernel or v.startswith(kernel + " "))


def profile_run(torch, fn) -> dict:
    """``fn()`` (one more ``kernel_mode="auto"`` run) under
    ``torch.profiler``: device time per kernel (the port's by name,
    PyTorch's own summed per name) and the device's busy share of the run's
    wall time.  Only with ``--profile``; the profiler's host overhead
    lengthens the wall time, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name: dict = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us <= 0 or str(ev.device_type) != "DeviceType.CUDA":
            continue
        name = next((v for k, v in KERNEL_SYMBOLS if k in ev.key),
                    "torch: " + ev.key[:60])
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + ev.count, t + us / 1e3)
    busy = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3),
            "kernels": [{"name": k, "count": n, "device_ms": t}
                        for k, (n, t) in top]}


def full_runs(torch, simulator, setting, label: str = "hieavg") -> dict:
    """The paper's whole DEFAULT run (T = 50 global rounds) of the smoke
    configuration ``label`` (``RUNS``) once per kernel mode, in turns
    (auto, torch, auto, torch): wall seconds, rounds per second and the
    final accuracy.  Only with ``--full``."""
    agg, strag, _ = RUNS[label]
    out: dict = {"config": label, "t_global_rounds": setting.t_global_rounds}
    for mode in ("auto", "torch", "auto", "torch"):
        sim = simulator(setting, agg, strag, strag, device="cuda",
                        kernel_mode=mode)
        torch.cuda.synchronize()
        res = sim.run()
        torch.cuda.synchronize()
        out.setdefault(mode, []).append({
            "wall_s": res.wall_time,
            "rounds_per_s": setting.t_global_rounds / res.wall_time,
            "final_accuracy": float(res.accuracy[-1]),
            "final_loss": float(res.loss[-1]),
            "final_clock_s": float(res.sim_clock[-1])})
    return out


def fig2_runs(run_comparison, setting) -> dict:
    """The paper's Fig. 2 set at DEFAULT (T = 50), ``kernel_mode="auto"``:
    ``run_comparison`` (FedAvg without stragglers, HieAvg, T-FedAvg,
    D-FedAvg) under temporary and permanent stragglers, with HieAvg's
    eq. (4) as the paper writes it (``normalize=False``, the simulator's
    default) and normalized (``normalize=True``, as the reference's own
    Fig. 2 driver ``benchmarks/fig2_convergence.py`` runs it).  Wall
    seconds, final and best accuracy per run.  Only with ``--full``."""
    out: dict = {"t_global_rounds": setting.t_global_rounds}
    for normalize in (False, True):
        for kind in ("temporary", "permanent"):
            res = run_comparison(setting, straggler_kind=kind, device="cuda",
                                 kernel_mode="auto", normalize=normalize)
            key = f"{kind}_normalized" if normalize else kind
            out[key] = {name: {"wall_s": r.wall_time,
                               "final_accuracy": float(r.accuracy[-1]),
                               "best_accuracy": float(r.accuracy.max()),
                               "final_loss": float(r.loss[-1])}
                        for name, r in res.items()}
    return out


def bf16_ulps(got, want, atol: float = 0.0) -> float:
    """max (|got - want| - atol) in bfloat16 ulps at the larger magnitude of
    the two (ulp 2^(e - 7) for a value in [2^e, 2^(e+1)))."""
    import torch
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() - atol).clamp(min=0.0).div(ulp).max().item())


def flash_pairs(sq: int, skv: int, causal: bool, window, q_offset=0) -> int:
    """(query, key) pairs the masks keep, per head: the work this call's
    data needs (the kernel skips whole tiles outside them)."""
    pairs = 0
    for i in range(sq):
        qpos = q_offset + i
        hi = min(skv, qpos + 1) if causal else skv
        lo = max(0, qpos - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    return pairs


def kernel_key(name: str) -> str:
    """``flash_attention_wgmma_kernel<80>`` from a mangled
    (``..._kernelILi80E...``) or a demangled (``..._kernel<80, ...>``)
    kernel name: its name and first template argument."""
    m = re.search(r"([a-z_]+_kernel)(?:ILi|<)(\d+)", name)
    return f"{m.group(1)}<{m.group(2)}>" if m else name


def hgmma_counts(library: Path) -> dict:
    """HGMMA (wgmma) instructions per kernel in the built library's SASS,
    by ``cuobjdump -sass``: which kernels run on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = kernel_key(line.split("Function : ")[1].strip())
            counts.setdefault(fn, 0)
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def launched_kernels(torch, run, keep, windows=(3, 20, 50, 100)) -> list:
    """The kernels that ``run()`` launches and whose profiler names pass
    ``keep``, as sorted ``kernel_key``s: the union over one profiling
    session for each of ``windows`` (that many calls each), after a warm-up
    call.  CUPTI now and then hands a session none of its device events, in
    a short window or a long one; ``run`` launches the same kernels on
    every call, so the union is the set it launches."""
    from torch.profiler import ProfilerActivity, profile
    run()
    names: set = set()
    for calls in windows:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        names |= {kernel_key(ev.key) for ev in prof.key_averages()
                  if keep(ev.key)}
    return sorted(names)


def flash_designs(torch, flash_attention, designs, randn, library) -> dict:
    """Which kernel each input type launched, read from the profiler's
    kernel names, beside its design and its HGMMA count: bfloat16 must run
    the wgmma kernel at Dh 80 (the serving head dim) and at MLA's 96 and
    192 (``bfloat16_dh96``, ``bfloat16_dh192``), float32 the FMA one with
    no HGMMA; and at recurrentgemma's 256 (``bfloat16_dh256``)."""
    hgmma = hgmma_counts(library)
    out = {}
    for dtype, dh in ((torch.float32, 80), (torch.bfloat16, 80),
                      (torch.bfloat16, 96), (torch.bfloat16, 192),
                      (torch.bfloat16, 256)):
        q, k, v = (randn(1, 256, 2, dh).to(dtype) for _ in range(3))
        names = launched_kernels(
            torch, lambda: flash_attention(q, k, v, causal=True, mode="cuda"),
            lambda key: "flash_attention" in key)
        count = sum(hgmma.get(name, 0) for name in names)
        key = str(dtype).split(".")[-1] + ("" if dh == 80 else f"_dh{dh}")
        out[key] = {"design": designs[dtype], "kernels": names,
                    "hgmma": count}
    check("flash_attention", all(
        out[f"bfloat16{sfx}"]["kernels"]
        == [f"flash_attention_wgmma_kernel<{dh}>"]
        and out[f"bfloat16{sfx}"]["hgmma"] > 0
        for dh, sfx in ((80, ""), (96, "_dh96"), (192, "_dh192"),
                        (256, "_dh256")))
          and out["float32"]["kernels"] == ["flash_attention_kernel<80>"]
          and out["float32"]["hgmma"] == 0, f"designs launched: {out}")
    out["hgmma_per_kernel"] = {f: n for f, n in hgmma.items() if n}
    emit({"flash_design": out})
    return out


def flash_bwd_design(torch, kern, randn, library) -> dict:
    """Which backward kernels each input type launched, read from the
    profiler's kernel names, beside its design and each kernel's HGMMA
    count: bfloat16 must run the two wgmma kernels at Dh 80 (the served
    head dim) and at MLA's 96 and 192 (``bfloat16_dh96``,
    ``bfloat16_dh192``; the dk/dv kernel's two passes there share a
    name), each with HGMMA > 0, float32 the two FMA kernels with none; and
    bfloat16 at recurrentgemma's 256 (``bfloat16_dh256``)."""
    hgmma = hgmma_counts(library)
    out = {}
    for dtype, dh in ((torch.float32, 80), (torch.bfloat16, 80),
                      (torch.bfloat16, 96), (torch.bfloat16, 192),
                      (torch.bfloat16, 256)):
        q, do = (randn(1, 256, 8, dh).to(dtype) for _ in range(2))
        k, v = (randn(1, 256, 2, dh).to(dtype) for _ in range(2))
        o, lse = kern.flash_attention_fwd(q, k, v, causal=True, lse=True,
                                          mode="cuda")

        def run():
            kern.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                     mode="cuda")
        names = launched_kernels(
            torch, run, lambda key: "flash_bwd_" in key and "delta" not in key)
        key = str(dtype).split(".")[-1] + ("" if dh == 80 else f"_dh{dh}")
        out[key] = {"design": kern.BWD_DESIGNS[dtype], "kernels": names,
                    "hgmma": {n: hgmma.get(n, 0) for n in names}}
    f32 = out["float32"]
    check("flash_attention_bwd", all(
        out[f"bfloat16{sfx}"]["kernels"]
        == [f"flash_bwd_dkdv_wgmma_kernel<{dh}>",
            f"flash_bwd_dq_wgmma_kernel<{dh}>"]
        and all(n > 0 for n in out[f"bfloat16{sfx}"]["hgmma"].values())
        for dh, sfx in ((80, ""), (96, "_dh96"), (192, "_dh192"),
                        (256, "_dh256")))
          and f32["kernels"] == ["flash_bwd_dkdv_kernel<80>",
                                 "flash_bwd_dq_kernel<80>"]
          and not any(f32["hgmma"].values()), f"designs launched: {out}")
    emit({"flash_bwd_design": out})
    return out


def flash_phase(torch, cfg, flash_attention, randn, record) -> dict:
    """The flash kernel against its plain version: a grid of Sq x Skv x Dh
    x masks x GQA groups in float32 (atol 2e-5, the reference's bound) and
    bfloat16 (one ulp beyond that bound: both versions sum in float32,
    which may differ by 2e-5 where a sum cancels to near 0, and round once),
    q read through strides and a chunked prefill's ``q_offset``, and the
    same bounds at sharp attention (``FLASH_SHARP``), at the
    cross-attention and encoder cells' shapes (``FLASH_MODEL``, batch 2,
    non-causal, kv lengths no multiple of a tile), at MLA's head dims
    and grok's group (``FLASH_MLA``), at recurrentgemma's head dim 256
    (``FLASH_RG``) and at head dims no kernel is built for, run padded
    (``FLASH_PADDED``, smoke MLA's 24 among them), and at the LLM example
    drivers' shapes (``FLASH_SMOKE``, batch ``EXAMPLE_LLM_BATCH``); rows
    that see no key exactly 0; then the serving shape of h2o-danube-1.8b,
    checked and timed."""
    worst = {"float32_abs": 0.0, "bfloat16_ulp": 0.0, "cases": 0,
             "padded_head_dims": sorted({c[2] for c in FLASH_PADDED})}
    grid = [(sq, skv, dh, causal, window, hh, 1.0, dtype)
            for sq, skv, dh, causal, window, hh, dtype in itertools.product(
                FLASH_SQ, FLASH_SKV, FLASH_DH, (True, False), FLASH_WINDOWS,
                FLASH_HEADS, (torch.float32, torch.bfloat16))]
    grid += [(sq, skv, dh, causal, window, (8, 2), qs, dtype)
             for sq, skv, dh, causal, window, qs in FLASH_SHARP
             for dtype in (torch.float32, torch.bfloat16)]
    grid += [(sq, skv, dh, False, None, hh, 1.0, dtype)
             for (sq, skv), dh, hh in FLASH_MODEL
             for dtype in (torch.float32, torch.bfloat16)]
    grid += [(sq, skv, dh, causal, window, hh, 1.0, dtype)
             for sq, skv, dh, causal, window, hh
             in FLASH_MLA + FLASH_RG + FLASH_PADDED
             for dtype in (torch.float32, torch.bfloat16)]
    grid = [(2, *g) for g in grid] + [
        (EXAMPLE_LLM_BATCH, sq, skv, dh, causal, window, hh, 1.0, dtype)
        for sq, skv, dh, causal, window, hh in FLASH_SMOKE
        for dtype in (torch.float32, torch.bfloat16)]
    for b, sq, skv, dh, causal, window, (h, hkv), qs, dtype in grid:
        q = randn(b, sq, 2 * h, dh, scale=qs).to(dtype)[:, :, :h]  # strided
        k, v = (randn(b, skv, hkv, dh).to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window,
                  q_offset=skv - sq if causal and skv > sq else 0)
        got = flash_attention(q, k, v, mode="cuda", **kw)
        want = flash_attention(q, k, v, mode="torch", **kw)
        case = f"{(b, sq, skv, dh, causal, window, h, hkv, qs, dtype)}"
        if dtype == torch.float32:
            err = (got - want).abs().max().item()
            check("flash_attention", err <= FLASH_F32_ATOL, f"{case}: {err}")
            worst["float32_abs"] = max(worst["float32_abs"], err)
        else:
            u = bf16_ulps(got, want, FLASH_F32_ATOL)
            check("flash_attention", u <= 1.0, f"{case}: {u} ulp")
            worst["bfloat16_ulp"] = max(worst["bfloat16_ulp"], u)
        worst["cases"] += 1
    for dtype, off in itertools.product((torch.float32, torch.bfloat16),
                                        (-10, -100)):
        q, k, v = (randn(1, 300, 4, 80).to(dtype) for _ in range(3))
        got = flash_attention(q, k, v, causal=True, q_offset=off, mode="cuda")
        want = flash_attention(q, k, v, causal=True, q_offset=off,
                               mode="torch")
        n = -off
        check("flash_attention", bool((got[:, :n] == 0).all())
              and bool((want[:, :n] == 0).all()),
              f"rows that see no key are not 0 (q_offset {off})")
        worst["cases"] += 1

    # the serving shape: the prefill of ``cfg`` (h2o-danube-1.8b), bf16
    b, s, h, hkv, dh, win = SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, \
        cfg.n_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    q = randn(b, s, h, dh).to(torch.bfloat16)
    k, v = (randn(b, s, hkv, dh).to(torch.bfloat16) for _ in range(2))
    got = flash_attention(q, k, v, causal=True, window=win, mode="cuda")
    want = flash_attention(q, k, v, causal=True, window=win, mode="torch")
    u = bf16_ulps(got, want, FLASH_F32_ATOL)
    check("flash_attention", u <= 1.0, f"serving shape: {u} ulp")
    qpos = torch.arange(s, device=q.device)
    mask = (qpos[None, :] <= qpos[:, None]) & \
        (qpos[None, :] > qpos[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = (library().transpose(1, 2).float() - want.float()).abs().max()
    flops = 4.0 * dh * b * h * flash_pairs(s, s, True, win)
    record("flash_attention", (got.float() - want.float()).abs().max().item(),
           2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7),
           lambda: flash_attention(q, k, v, causal=True, window=win,
                                   mode="cuda"),
           timed_ms(torch, lambda: flash_attention(
               q, k, v, causal=True, window=win, mode="torch"), iters=5),
           timed_ms(torch, library, iters=5),
           2.0 * (2 * b * s * h * dh + 2 * b * s * hkv * dh), flops,
           {"shape": {"q": [b, s, h, dh], "kv": [b, s, hkv, dh],
                      "dtype": "bfloat16", "causal": True, "window": win},
            "max_ulp_beyond_atol": u, "max_ulp": bf16_ulps(got, want),
            "tolerance": f"1 bf16 ulp beyond atol {FLASH_F32_ATOL}",
            "flops": flops, "bound_flop_rate": BF16_TC_FLOP_PER_S,
            "bound_fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
            "bound_qk_bf16_pv_fp32_ms": flops / 2 / BF16_TC_FLOP_PER_S * 1e3
            + flops / 2 / FP32_FLOP_PER_S * 1e3,
            "library_call": "scaled_dot_product_attention(attn_mask=causal "
                            "& window, enable_gqa=True)",
            "library_max_abs_diff": float(lib_err), "grid": worst},
           flop_rate=BF16_TC_FLOP_PER_S)

    # the float32 instantiation (off the serving path) at the same shape,
    # against its FP32 bound and the library call on float32 inputs
    q, k, v = (t_.float() for t_ in (q, k, v))
    got = flash_attention(q, k, v, causal=True, window=win, mode="cuda")
    want = flash_attention(q, k, v, causal=True, window=win, mode="torch")
    err = (got - want).abs().max().item()
    check("flash_attention", err <= FLASH_F32_ATOL,
          f"float32 serving shape: {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    del got, want
    record("flash_attention_f32", err, FLASH_F32_ATOL,
           lambda: flash_attention(q, k, v, causal=True, window=win,
                                   mode="cuda"),
           timed_ms(torch, lambda: flash_attention(
               q, k, v, causal=True, window=win, mode="torch"), iters=5),
           timed_ms(torch, library, iters=5),
           4.0 * (2 * b * s * h * dh + 2 * b * s * hkv * dh), flops,
           {"shape": {"q": [b, s, h, dh], "kv": [b, s, hkv, dh],
                      "dtype": "float32", "causal": True, "window": win},
            "library_call": "scaled_dot_product_attention(attn_mask=causal "
                            "& window, enable_gqa=True), float32"},
           kernel="flash_attention")
    return worst


def flash_key(name: str, b: int, sq: int, skv: int, h: int, hkv: int,
              dh: int, causal: bool) -> tuple:
    """The key ``shape_launches`` counts a flash call's launches under."""
    return name, b, sq, skv, h, hkv, dh, causal


def timed_key(name: str, label: str) -> tuple:
    """``flash_key`` of FLASH_TIMED[label] at batch SERVE_BATCH."""
    (sq, skv), dh, (h, hkv), causal, _, _ = FLASH_TIMED[label]
    return flash_key(name, SERVE_BATCH, sq, skv, h, hkv, dh, causal)


def attn_heads(cfg, kind: str) -> tuple:
    """(H, Hkv, Dh) of a layer kind's flash calls: multi-head latent
    attention expands its latent to every head at Dh nope + rope."""
    if kind.startswith("mla"):
        m = cfg.mla
        return cfg.n_heads, cfg.n_heads, m.qk_nope_head_dim \
            + m.qk_rope_head_dim
    return cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim


def flash_shapes(cfg, batch: int, seq: int,
                 name: str = "flash_attention") -> collections.Counter:
    """The flash calls of one full-sequence pass of ``cfg`` over ``batch``
    rows of ``seq`` tokens, by ``flash_key``: one a self-attention or MLA
    layer (causal), a cross-attention layer (over the memory's frames) and
    an encoder layer (frames over frames), of the units and of the tail;
    none a recurrent layer (RECURRENT_KINDS)."""
    from repro_torch.launch.inputs import memory_shape
    frames = (memory_shape(cfg) or (0,))[0]
    out = collections.Counter()
    for kinds, times in ((cfg.block_pattern, cfg.n_units),
                         (cfg.tail_pattern, 1)):
        for kind in kinds:
            if kind in RECURRENT_KINDS:
                continue
            skv, causal = (frames, False) if kind == "xattn" else (seq, True)
            out[flash_key(name, batch, seq, skv, *attn_heads(cfg, kind),
                          causal)] += times
    if cfg.encoder:
        out[flash_key(name, batch, frames, frames,
                      *attn_heads(cfg, "enc_attn"), False)] += \
            cfg.encoder.n_layers
    return out


def flash_layers(cfg) -> int:
    """The flash calls of one full-sequence pass of ``cfg``: one a self- or
    cross-attention layer of the decoder, one an encoder layer."""
    return sum(flash_shapes(cfg, 1, 1).values())


@contextlib.contextmanager
def shape_launches(kern, build):
    """While open, each flash forward and backward call's launches (its own
    increment of ``build.LAUNCHES``) are added to the yielded Counter under
    the call's ``flash_key``: a run's launches at each shape.  The kernels'
    wrappers are swapped for counting ones (the attribute swap FAULTS
    uses) and restored on exit."""
    into = collections.Counter()
    names = {"flash_attention_fwd": "flash_attention",
             "flash_attention_bwd": "flash_attention_bwd"}
    sound = {attr: getattr(kern, attr) for attr in names}

    def counted(attr, q, k, *a, **kw):
        before = build.LAUNCHES[names[attr]]
        try:
            return sound[attr](q, k, *a, **kw)
        finally:
            n = build.LAUNCHES[names[attr]] - before
            if n:
                b, sq, h, dh = q.shape
                into[flash_key(names[attr], b, sq, k.shape[1], h, k.shape[2],
                               dh, bool(kw.get("causal", True)))] += n

    for attr in names:
        setattr(kern, attr, functools.partial(counted, attr))
    try:
        yield into
    finally:
        for attr, fn in sound.items():
            setattr(kern, attr, fn)


def set_gates(params: dict) -> None:
    """Every ``xattn_gate`` of a nested parameter dict to XATTN_GATE."""
    for unit in params["unit"].values():
        if "xattn_gate" in unit["mixer"]:
            unit["mixer"]["xattn_gate"].fill_(XATTN_GATE)


def xattn_memory(torch, cfg, lead: tuple, dtype=None):
    """N(0, 1) raw memory ``[*lead, *memory shape]`` from XATTN_MEMORY_SEED
    on the card, in ``dtype`` (default the parameters')."""
    from repro_torch.launch.inputs import memory_shape
    g = torch.Generator(device="cuda")
    g.manual_seed(XATTN_MEMORY_SEED)
    return torch.randn(lead + memory_shape(cfg), generator=g,
                       device="cuda").to(dtype or cfg.torch_param_dtype)


def serve_cfg(arch: str, n_layers=None):
    """``arch``'s full config, cut to ``n_layers`` where given."""
    from repro_torch.configs import cut_depth, get_config
    cfg = get_config(arch)
    return cfg if n_layers is None else cut_depth(cfg, n_layers)


def serve_runs(torch, serve, build, kern, arch: str = SERVE_ARCH,
               prompt: int = SERVE_PROMPT, n_layers=None) -> dict:
    """``serve.run`` of ``arch`` at full width and depth (or cut to
    ``n_layers``), batch
    SERVE_BATCH, a prompt of ``prompt`` tokens, with the kernels and with
    the plain versions, on the same seeded weights, each decoding its own
    greedy tokens, after a short run that takes the first-call costs: the
    launch counts are set to 0 just before each run and read just after,
    in all and at each shape (``shape_launches``); the kernel run launches
    the flash kernel once a self-attention, cross-attention and encoder
    layer at that layer's shape (``flash_shapes``: the encoder runs once,
    inside the timed prefill), decode none."""
    from repro_torch.models import count_params, param_specs
    cfg = serve_cfg(arch, n_layers)
    kw = dict(smoke=False, batch=SERVE_BATCH, prompt_len=prompt,
              gen=SERVE_GEN, device="cuda", progress=False,
              n_layers=n_layers)
    serve.run(arch, **{**kw, "prompt_len": 512, "gen": 2})
    runs = {}
    for mode in ("auto", "torch"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        with shape_launches(kern, build) as shapes:
            res = serve.run(arch, kernel_mode=mode, **kw)
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check("serve", res["tokens"].shape == (SERVE_BATCH, SERVE_GEN)
              and bool(np.isfinite(res["logits"]).all()),
              f"{arch} {mode}: tokens {res['tokens'].shape}, logits not "
              "finite")
        runs[mode] = (res, launches, shapes)
        emit({"serve": {
            "arch": arch, "kernel_mode": mode, "layers": cfg.n_layers,
            "depth_cut_from": None if n_layers is None
            else serve_cfg(arch).n_layers,
            "params": count_params(param_specs(cfg)),
            "encoder_layers": cfg.encoder.n_layers if cfg.encoder else 0,
            "flash_layers": flash_layers(cfg),
            "batch": SERVE_BATCH, "prompt": prompt, "gen": SERVE_GEN,
            "prefill_s": res["t_prefill"], "decode_s": res["t_decode"],
            "decode_tokens_per_s": SERVE_GEN * SERVE_BATCH / res["t_decode"],
            "prefill_tokens_per_s": SERVE_BATCH * prompt / res["t_prefill"],
            "peak_memory_gb": peak / 1e9, "launches": launches,
            "launches_by_shape": [[*k, n] for k, n in shapes.items()]}})
    want = flash_shapes(cfg, SERVE_BATCH, prompt)
    check("launches", runs["auto"][1].get("flash_attention", 0)
          == sum(want.values()) and runs["auto"][2] == want,
          f"{arch} auto: {runs['auto'][1]}, by shape {runs['auto'][2]}, "
          f"expected {want}")
    check("launches", not runs["torch"][1],
          f"{arch} torch mode launched {runs['torch'][1]}")
    return runs


def serve_live(torch, serve, arch: str, prompt: int, raw) -> dict:
    """``serve.run`` with the kernels, as ``serve_runs`` drives it, but with
    every ``xattn_gate`` at XATTN_GATE as its weights are made and its zero
    memory swapped for ``raw`` at its ``encode`` call: the serving path
    itself (the encoder inside the prefill, each decode step fed its
    output) on inputs that make cross-attention count."""
    make_params, encode = serve.make_params, serve.encode
    fed = []

    def gated(cfg, seed, device):
        params = make_params(cfg, seed, device)
        set_gates(params)
        return params

    def encode_raw(params, zeros, cfg, **kw):
        fed.append(tuple(zeros.shape) == tuple(raw.shape)
                   and not bool(zeros.any()))
        return encode(params, raw, cfg, **kw)

    serve.make_params, serve.encode = gated, encode_raw
    try:
        res = serve.run(arch, smoke=False, batch=SERVE_BATCH,
                        prompt_len=prompt, gen=SERVE_GEN, device="cuda",
                        progress=False)
    finally:
        serve.make_params, serve.encode = make_params, encode
    check("serve_parity", fed == [True],
          f"{arch}: serve.run's memory at its encode call: {fed}")
    return res


def serve_parity(torch, serve, runs, arch: str = SERVE_ARCH,
                 prompt: int = SERVE_PROMPT, n_layers=None) -> dict:
    """Auto against torch on the same inputs, through the model functions.
    Every layer of the prefill is fed the auto pass's input in both modes
    (the kernel's one-ulp differences would otherwise flip the sharp
    attention of random weights and the runs diverge): the encoder's
    layers (over the memory), then the decoder's self- and
    cross-attention layers (the cross layers reading the auto pass's
    encoder output).  A model with cross-attention gets N(0, 1) bf16
    memory (XATTN_MEMORY_SEED) and every ``xattn_gate`` at XATTN_GATE, so
    that the path is not inert.  Per layer, the attention output itself
    (before ``wo`` and the residual) within one bf16 ulp beyond
    ``FLASH_F32_ATOL`` times the layer's largest ``|v|``: the flash
    phase's bound, scaled as the float32 error of a convex combination of
    v's rows scales; the kernel on the model's own activations.  The
    layer's output, and the last position's logits of the two last
    layers, within ``SERVE_REL_TOL`` of their largest magnitude.  An MLA
    layer's attention (Dh nope + rope, v zero-padded) is read the same
    way, and the padded columns of the kernel's output must be exactly 0
    (``mla_pad_zero``).  A MoE layer's feed-forward block, which runs no
    kernel, is fed the auto pass's attention output in both modes and
    must give bitwise the same output (``moe_bitwise``).  A recurrent
    layer (RG-LRU, SSD), which runs the same plain code in both modes,
    must give bitwise the same output and caches (``recurrent_bitwise``);
    the tail's layers follow the units'.

    Then the serving path's own output against the auto pass: the timed
    kernel ``serve.run`` of ``serve_runs`` (``runs["auto"]``) for a model
    without memory, and for one with memory ``serve_live``'s run on the
    same memory and gates (the timed run reads zero memory under zero
    gates, which leaves cross-attention inert): its prefill logits against
    the auto pass's, and its decode logits against torch mode's decode
    from its caches of that pass, fed the run's tokens and the auto pass's
    encoder output.  Decode launches no kernel and the caches hold k and v
    from before attention, so for the decode this checks that ``serve.run``
    decodes from the encoded memory and deterministically.  The
    free-running ``serve.run`` pair's own differences and greedy-token
    agreement are reported, not checked."""
    from repro_torch.data import lm_tokens
    from repro_torch.launch import make_serve_step
    from repro_torch.launch.inputs import memory_shape
    from repro_torch.models import attention as A
    from repro_torch.models import mla as M
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed_apply, rms_norm, \
        unembed_apply

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    cfg = serve_cfg(arch, n_layers)
    dev = torch.device("cuda")
    modes = ("auto", "torch")
    ms = memory_shape(cfg)
    raw = None if ms is None else xattn_memory(torch, cfg, (SERVE_BATCH,))
    served = runs["auto"][0] if ms is None else serve_live(
        torch, serve, arch, prompt, raw)
    auto = {k: torch.as_tensor(served[k], device=dev)
            for k in ("tokens", "logits")}
    params = serve.make_params(cfg, 0, dev)
    if ms is not None:
        set_gates(params)
    prompts = torch.as_tensor(lm_tokens(SERVE_BATCH, prompt, cfg.vocab,
                                        seed=0), device=dev).long()
    caches = {m: serve.make_caches(cfg, SERVE_BATCH, prompt + SERVE_GEN,
                                   dev, smoke=False) for m in modes}
    kinds, layers, attn_ulp, attn_rel = [], [], [], []
    mla_pad_zero, moe_bitwise, recurrent_bitwise = [], [], []

    def layer(kind, p, x, memory, pos, cache):
        """One layer fed ``x`` in both modes: its attention output and its
        output read; the outputs returned."""
        if kind in RECURRENT_KINDS:
            y = {m: T._apply_layer(kind, p, x, cfg, mode="prefill",
                                   cache=cache(m), pos=None, memory=memory,
                                   kernel_mode=m)[0] for m in modes}
            recurrent_bitwise.append(
                torch.equal(y["auto"], y["torch"])
                and all(torch.equal(cache("auto")[k], cache("torch")[k])
                        for k in cache("auto")))
            kinds.append(kind)
            layers.append(rel(y["torch"], y["auto"]))
            return y
        mp = p["mixer"]
        h = rms_norm(x, mp["norm"], cfg.norm_eps)
        causal = kind != "xattn" and kind != "enc_attn"
        width = None
        if kind.startswith("mla"):
            q, k, v = M._qkv(mp, h, cfg, pos)[:3]
            width = cfg.mla.v_head_dim
        elif kind == "xattn":
            q, k, v = A._qkv(mp, h, cfg, kv_x=memory)
        else:
            q, k, v = A._qkv(mp, h, cfg)
            q, k = (A.apply_rope(t, pos, cfg.rope_theta) for t in (q, k))
        a = {m: A._sdpa(q, k, v, causal=causal,
                        window=cfg.sliding_window if causal else None,
                        kernel_mode=m) for m in modes}
        attn_ulp.append(bf16_ulps(a["auto"], a["torch"], FLASH_F32_ATOL
                                  * v.float().abs().max().item()))
        attn_rel.append(rel(a["auto"], a["torch"]))
        if width is not None:
            mla_pad_zero.append(not bool(a["auto"][..., width:].any()))
        del q, k, v, a
        y = {m: T._apply_layer(kind, p, x, cfg, mode="prefill",
                               cache=cache(m), pos=None, memory=memory,
                               kernel_mode=m)[0] for m in modes}
        if T.FFN[kind] == "moe":
            # the feed-forward block alone, fed the auto pass's attention
            # output (its residual: the layer's output less the block's)
            mixed = mixer_out(kind, p, x, memory, cache("auto"))
            outs = [moe.moe_apply(p["ffn"], mixed, cfg) for _ in modes]
            moe_bitwise.append(torch.equal(outs[0][0], outs[1][0])
                               and torch.equal(outs[0][1], outs[1][1]))
            del mixed, outs
        kinds.append(kind)
        layers.append(rel(y["torch"], y["auto"]))
        return y

    def mixer_out(kind, p, x, memory, cache):
        """The layer's attention with its residual, in auto mode."""
        mp = p["mixer"]
        if kind.startswith("mla"):
            return M.mla_prefill(mp, x, cfg, cache, kernel_mode="auto")[0]
        return A.attn_prefill(mp, x, cfg, cache, kernel_mode="auto")[0]

    memory = raw
    if cfg.encoder:
        frames = torch.arange(ms[0], device=dev)
        for u in range(cfg.encoder.n_layers):
            memory = layer("enc_attn", T._index(params["encoder"]["unit"],
                                                u)["0"],
                           memory, None, frames, lambda m: None)["auto"]
    x = embed_apply(params["embed"], prompts, cfg.torch_param_dtype)
    pos = torch.arange(prompt, device=dev)
    for u in range(cfg.n_units):
        up = T._index(params["unit"], u)
        for i, kind in enumerate(cfg.block_pattern):
            y = layer(kind, up[str(i)], x, memory, pos, lambda m: T._index(
                caches[m]["unit"], u).get(str(i)))
            x = y["auto"]
    for i, kind in enumerate(cfg.tail_pattern):
        y = layer(kind, params["tail"][str(i)], x, memory, pos,
                  lambda m: caches[m]["tail"].get(str(i)))
        x = y["auto"]
    logits = {m: unembed_apply(params["embed"], y[m][:, -1:], cfg)[:, 0]
              for m in y}
    del x, y
    decode = make_serve_step(cfg)
    c, steps = caches["torch"], []
    for i in range(SERVE_GEN - 1):
        lg, c = decode(params, auto["tokens"][:, i:i + 1].long(), prompt + i,
                       c, memory)
        steps.append(lg.float())
    torch_run = runs["torch"][0]
    out = {
        "arch": arch, "prompt": prompt, "tolerance_rel": SERVE_REL_TOL,
        "attn_tolerance": f"1 bf16 ulp beyond atol {FLASH_F32_ATOL} "
                          "x max|v|",
        "memory": None if ms is None else {
            "shape": [SERVE_BATCH, *ms], "seed": XATTN_MEMORY_SEED,
            "xattn_gate": XATTN_GATE},
        "served_by": "serve_runs' kernel run" if ms is None
        else "serve.run with the kernels, this memory and these gates",
        "layer_kinds": kinds, "attn_ulp": attn_ulp, "attn_rel": attn_rel,
        "layer_rel": layers, "mla_pad_zero": mla_pad_zero,
        "moe_bitwise": moe_bitwise, "recurrent_bitwise": recurrent_bitwise,
        "prefill_logits_rel": rel(logits["torch"], logits["auto"]),
        "forced_auto_vs_run_rel": rel(logits["auto"], auto["logits"][:, 0]),
        "decode_logits_rel": rel(torch.stack(steps, 1),
                                 auto["logits"][:, 1:]),
        "free_running": {
            "prefill_logits_max_abs_diff": float(np.abs(
                torch_run["logits"][:, 0] - runs["auto"][0]["logits"][:, 0]
            ).max()),
            "decode_logits_max_abs_diff": float(np.abs(
                torch_run["logits"][:, 1:] - runs["auto"][0]["logits"][:, 1:]
            ).max()),
            "max_abs_logit": float(np.abs(runs["auto"][0]["logits"]).max()),
            "greedy_token_agreement": float(np.mean(
                torch_run["tokens"] == runs["auto"][0]["tokens"]))}}
    emit({"serve_parity": out})
    bad = {k: out[k] for k in ("prefill_logits_rel", "forced_auto_vs_run_rel",
                               "decode_logits_rel")
           if out[k] > SERVE_REL_TOL}
    worst_layer = max(layers)
    check("serve_parity", not bad and worst_layer <= SERVE_REL_TOL,
          f"{arch}: over {SERVE_REL_TOL}: {bad}, worst layer {worst_layer}")
    check("serve_parity", max(attn_ulp, default=0.0) <= 1.0,
          f"{arch}: attention output over 1 bf16 ulp: {attn_ulp}")
    check("serve_parity", all(recurrent_bitwise),
          f"{arch}: a recurrent layer differs between the modes "
          f"({recurrent_bitwise})")
    check("serve_parity", all(mla_pad_zero) and all(moe_bitwise),
          f"{arch}: MLA's padded columns not 0 ({mla_pad_zero}) or a MoE "
          f"block not bitwise ({moe_bitwise})")
    return out


def flash_bwd_phase(torch, cfg, kern, randn, record, design) -> dict:
    """The flash backward kernels against their plain version: the tail
    cases (``FLASH_BWD_CASES``) and the LLM example driver's training
    shape (``FLASH_SMOKE_BWD``) in float32 and bfloat16, rows that see no
    key giving dq exactly 0, and the serving shape of h2o-danube-1.8b in
    bfloat16, checked (``FLASH_BWD_REL``), bitwise on repeat and timed
    beside the plain version and the library's backward
    (``scaled_dot_product_attention`` through autograd, bool mask,
    ``enable_gqa``).  The bound counts 10 Dh FLOPs a visible pair at the
    bf16 tensor-core peak (the FP32 one beside it); the bf16 kernels
    execute (8 + 6 ``BWD_TERMS``) Dh a pair (``design``: their HGMMA
    counts, ``flash_bwd_design``)."""
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    fwd, bwd = kern.flash_attention_fwd, kern.flash_attention_bwd
    worst = {"float32_rel": 0.0, "bfloat16_rel": 0.0, "lse_rel": 0.0,
             "cases": 0}

    def grads_err(got, want):
        return max((g.float() - w.float()).abs().max().item()
                   / max(w.float().abs().max().item(), 1e-30)
                   for g, w in zip(got, want))

    def lse_err(case, got, want):
        """The kernel's lse against the plain forward's: +inf on the same
        rows, the finite values within FLASH_LSE_REL of max(1, |lse|)."""
        check("flash_attention_bwd", torch.equal(torch.isinf(got),
                                                 torch.isinf(want))
              and not bool(torch.isnan(got).any()),
              f"{case}: lse's +inf rows differ from the plain version's")
        fin = torch.isfinite(want)
        err = ((got[fin] - want[fin]).abs()
               / want[fin].abs().clamp(min=1.0)).max().item() \
            if bool(fin.any()) else 0.0
        check("flash_attention_bwd", err <= FLASH_LSE_REL,
              f"{case}: lse {err} over {FLASH_LSE_REL}")
        worst["lse_rel"] = max(worst["lse_rel"], err)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, ((sq, skv), dh, (h, hkv), causal, window, off) in [
                (2, c) for c in FLASH_BWD_CASES] + [
                (EXAMPLE_LLM_BATCH, ((sq, skv), dh, hh, causal, window, 0))
                for sq, skv, dh, causal, window, hh in FLASH_SMOKE_BWD]:
            q = randn(b, sq, 2 * h, dh).to(dtype)[:, :, :h]     # strided
            k, v = (randn(b, skv, hkv, dh).to(dtype) for _ in range(2))
            do = randn(b, sq, h, dh).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            o, lse = fwd(q, k, v, lse=True, mode="cuda", **kw)
            got = bwd(q, k, v, o, lse, do, mode="cuda", **kw)
            o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
            case = f"{(b, (sq, skv), dh, (h, hkv), causal, window, off, name)}"
            lse_err(case, lse, lse_ref)
            rel = grads_err(got, flash_attention_bwd_ref(
                q, k, v, o_ref, lse_ref, do, **kw))
            check("flash_attention_bwd", rel <= FLASH_BWD_REL[name],
                  f"{case}: {rel}")
            unseen = torch.isinf(lse_ref).permute(0, 2, 1)   # [B, Sq, H]
            check("flash_attention_bwd", bool((got[0][unseen] == 0).all()),
                  f"{case}: dq of rows that see no key is not 0")
            worst[f"{name}_rel"] = max(worst[f"{name}_rel"], rel)
            worst["cases"] += 1

    # the serving shape, bf16
    b, s, h, hkv, dh, win = SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, \
        cfg.n_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    q = randn(b, s, h, dh).to(torch.bfloat16)
    k, v = (randn(b, s, hkv, dh).to(torch.bfloat16) for _ in range(2))
    do = randn(b, s, h, dh).to(torch.bfloat16)
    kw = dict(causal=True, window=win)
    o, lse = fwd(q, k, v, lse=True, mode="cuda", **kw)
    got = bwd(q, k, v, o, lse, do, mode="cuda", **kw)
    check("flash_attention_bwd", all(torch.equal(a, c) for a, c in zip(
        got, bwd(q, k, v, o, lse, do, mode="cuda", **kw))),
        "not bitwise on repeat")
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    lse_err("serving shape", lse, lse_ref)
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    del o_ref, lse_ref
    rel = grads_err(got, want)
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    check("flash_attention_bwd", rel <= FLASH_BWD_REL["bfloat16"],
          f"serving shape: {rel}")
    del got, want
    qpos = torch.arange(s, device=q.device)
    mask = (qpos[None, :] <= qpos[:, None]) & \
        (qpos[None, :] > qpos[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)

    flops = 10.0 * dh * b * h * flash_pairs(s, s, True, win)
    record("flash_attention_bwd", err, FLASH_BWD_REL["bfloat16"],
           lambda: bwd(q, k, v, o, lse, do, mode="cuda", **kw),
           timed_ms(torch, lambda: flash_attention_bwd_ref(
               q, k, v, o, lse, do, **kw), iters=2, warmup=1),
           timed_ms(torch, library, iters=5),
           2.0 * (3 * b * s * h * dh + 4 * b * s * hkv * dh)
           + 4.0 * b * h * s, flops,
           {"shape": {"q": [b, s, h, dh], "kv": [b, s, hkv, dh],
                      "dtype": "bfloat16", "causal": True, "window": win},
            "max_rel_err": rel,
            "tolerance": f"{FLASH_BWD_REL['bfloat16']} x max|grad|",
            "flops": flops, "bound_flop_rate": BF16_TC_FLOP_PER_S,
            "bound_fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
            "executed_flops": (8.0 + 6.0 * kern.BWD_TERMS) * dh * b * h
            * flash_pairs(s, s, True, win),
            "hgmma": design["bfloat16"]["hgmma"],
            "bitwise_on_repeat": True,
            "library_call": "autograd of scaled_dot_product_attention("
                            "attn_mask=causal & window, enable_gqa=True)",
            "device_ms_kernels": {part: device_ms(
                torch, lambda: bwd(q, k, v, o, lse, do, mode="cuda", **kw),
                (sym,)) for sym, part in (
                ("flash_bwd_delta_kernel", "delta"),
                ("flash_bwd_dkdv_wgmma_kernel", "dk_dv"),
                ("flash_bwd_dq_wgmma_kernel", "dq"))},
            "grid": worst},
           flop_rate=BF16_TC_FLOP_PER_S)
    return worst


def flash_model_timing(torch, kern, randn, record) -> None:
    """The flash forward and backward at the shapes FLASH_TIMED names
    (llama-vision's cross-attention, seamless's encoder and cross
    attention, non-causal; the MLA cells' and grok's causal
    self-attention; bf16, batch SERVE_BATCH, random data), each checked
    against its plain version (the flash phases' bounds) and timed beside
    the plain version, the bound and the library's
    ``scaled_dot_product_attention`` (``enable_gqa``, ``is_causal`` where
    causal; its backward through autograd), the backward only where
    FLASH_TIMED asks; a window's library call takes it as a bool mask.
    The bounds count 4 Dh FLOPs a visible (query, key) pair forward and
    10 Dh backward at the bf16 tensor-core peak.  At Dh 192 and 256 the
    forward is timed once more with q scaled by 24 (``ms_sharp_q24``):
    logits in the hundreds take the float32 FMA chain over d of the
    sharp-logit refinement (``softmax_tile``).  The Dh-256 lines carry the
    instances' registers and spills (``ptxas -v``) and HGMMA counts
    (``FLASH_BUILD_FACTS``)."""
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    fwd, bwd = kern.flash_attention_fwd, kern.flash_attention_bwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, ((sq, skv), dh, (h, hkv), causal, with_bwd, window) in \
            FLASH_TIMED.items():
        b = SERVE_BATCH
        q = randn(b, sq, h, dh).to(torch.bfloat16)
        k, v = (randn(b, skv, hkv, dh).to(torch.bfloat16) for _ in range(2))
        do = randn(b, sq, h, dh).to(torch.bfloat16)
        kw = dict(causal=causal, window=window)
        o, lse = fwd(q, k, v, lse=True, mode="cuda", **kw)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
        u = bf16_ulps(o, o_ref, FLASH_F32_ATOL)
        check("flash_attention", u <= 1.0, f"{label} shape: {u} ulp")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        shape = {"q": [b, sq, h, dh], "kv": [b, skv, hkv, dh],
                 "dtype": "bfloat16", "causal": causal, "window": window}
        pairs = flash_pairs(sq, skv, True, window) if causal else sq * skv
        flops = 4.0 * dh * b * h * pairs
        lib_kw, lib_call = dict(is_causal=causal), f"is_causal={causal}"
        if window is not None:
            qpos = torch.arange(sq, device=q.device)
            lib_kw = dict(attn_mask=(qpos[None, :] <= qpos[:, None])
                          & (qpos[None, :] > qpos[:, None] - window))
            lib_call = "attn_mask=causal & window"
        extra = {"visible_pairs": b * h * pairs}
        if dh == 256:
            extra.update(FLASH_BUILD_FACTS)
        if dh in (192, 256):
            qs = (q.float() * 24.0).to(torch.bfloat16)
            extra["ms_sharp_q24"] = float(np.median([timed_ms(
                torch, lambda: fwd(qs, k, v, mode="cuda", **kw)[0])
                for _ in range(3)]))
            del qs
        record(f"flash_attention[{label}]",
               (o.float() - o_ref.float()).abs().max().item(),
               2.0 ** (math.floor(math.log2(o_ref.float().abs().max()
                                            .item())) - 7),
               lambda: fwd(q, k, v, mode="cuda", **kw)[0],
               timed_ms(torch, lambda: fwd(q, k, v, mode="torch", **kw),
                        iters=5),
               timed_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True,
                                            **lib_kw), iters=5),
               2.0 * (2 * b * sq * h * dh + 2 * b * skv * hkv * dh), flops,
               {"shape": shape, "max_ulp_beyond_atol": u,
                "tolerance": f"1 bf16 ulp beyond atol {FLASH_F32_ATOL}",
                "flops": flops, "bound_flop_rate": BF16_TC_FLOP_PER_S,
                "library_call": "scaled_dot_product_attention(enable_gqa="
                                f"True, {lib_call})", **extra},
               kernel="flash_attention", flop_rate=BF16_TC_FLOP_PER_S)
        if not with_bwd:
            del q, k, v, do, o, lse, o_ref, lse_ref, qt, kt, vt
            continue
        got = bwd(q, k, v, o, lse, do, mode="cuda", **kw)
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        rel = max((g.float() - w.float()).abs().max().item()
                  / max(w.float().abs().max().item(), 1e-30)
                  for g, w in zip(got, want))
        check("flash_attention_bwd", rel <= FLASH_BWD_REL["bfloat16"],
              f"{label} shape: {rel}")
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        del got, want, o_ref, lse_ref
        lib_out = sdpa(qt, kt, vt, enable_gqa=True, **lib_kw)
        dot = do.transpose(1, 2)
        flops = 10.0 * dh * b * h * pairs
        record(f"flash_attention_bwd[{label}]", err,
               FLASH_BWD_REL["bfloat16"],
               lambda: bwd(q, k, v, o, lse, do, mode="cuda", **kw),
               timed_ms(torch, lambda: flash_attention_bwd_ref(
                   q, k, v, o, lse, do, **kw), iters=2, warmup=1),
               timed_ms(torch, lambda: torch.autograd.grad(
                   lib_out, (qt, kt, vt), dot, retain_graph=True),
                   iters=5),
               2.0 * (3 * b * sq * h * dh + 4 * b * skv * hkv * dh)
               + 4.0 * b * h * sq, flops,
               {"shape": shape, "max_rel_err": rel,
                "tolerance": f"{FLASH_BWD_REL['bfloat16']} x max|grad|",
                "flops": flops, "bound_flop_rate": BF16_TC_FLOP_PER_S,
                "library_call": "autograd of scaled_dot_product_attention("
                                f"enable_gqa=True, {lib_call})",
                **({"hgmma": FLASH_BUILD_FACTS.get("hgmma")}
                   if dh == 256 else {}),
                "device_ms_kernels": {part: device_ms(
                    torch, lambda: bwd(q, k, v, o, lse, do, mode="cuda",
                                       **kw), (sym,)) for sym, part in (
                    ("flash_bwd_delta_kernel", "delta"),
                    ("flash_bwd_dkdv_wgmma_kernel", "dk_dv"),
                    ("flash_bwd_dq_wgmma_kernel", "dq"))}},
               kernel="flash_attention_bwd", flop_rate=BF16_TC_FLOP_PER_S)
        del q, k, v, do, o, lse, qt, kt, vt, lib_out, lib_kw


#: the ``kernels`` line's entries at FLASH_SHARD's shapes: (kernel, label)
#: -> the ``mesh_steps`` part whose rank-0 launches at that shape the entry
#: reports
SHARD_RUNS = {("flash_attention", "shard"): "serve",
              ("flash_attention", "shard_f32"): "train",
              ("flash_attention_bwd", "shard_f32"): "train"}
#: the flash kernels at a rank's shard in ``mesh_steps``: label -> (batch,
#: (Sq, Skv), Dh, (H, Hkv), dtype, backward timed too): danube's heads
#: over model=2 (32/8 -> 16/4), the bf16 prefill's rows over data=2, the
#: float32 train step's two rows a client
FLASH_SHARD = {"shard": (1, (MESH_STEPS_SEQ, MESH_STEPS_SEQ), 80, (16, 4),
                         "bfloat16", False),
               "shard_f32": (MESH_STEPS_ROWS, (MESH_STEPS_SEQ,
                                               MESH_STEPS_SEQ), 80,
                             (16, 4), "float32", True)}


def flash_shard_timing(torch, kern, randn, record) -> None:
    """The flash forward (and the float32 backward) at FLASH_SHARD's
    shapes, causal with danube's window, checked against the plain version
    (bf16: 1 ulp beyond FLASH_F32_ATOL; float32: FLASH_F32_ATOL, the
    backward FLASH_BWD_REL) and timed beside it, the bound (4 Dh FLOPs a
    visible pair forward, 10 Dh backward, at the input type's peak) and
    ``scaled_dot_product_attention`` (``enable_gqa``, ``is_causal``; the
    window is inert below its 4096)."""
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    fwd, bwd = kern.flash_attention_fwd, kern.flash_attention_bwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    window = 4096
    for label, (b, (sq, skv), dh, (h, hkv), dtype, with_bwd) in \
            FLASH_SHARD.items():
        dt = getattr(torch, dtype)
        rate = BF16_TC_FLOP_PER_S if dtype == "bfloat16" \
            else FP32_FLOP_PER_S
        q = randn(b, sq, h, dh).to(dt)
        k, v = (randn(b, skv, hkv, dh).to(dt) for _ in range(2))
        do = randn(b, sq, h, dh).to(dt)
        kw = dict(causal=True, window=window)
        o, lse = fwd(q, k, v, lse=True, mode="cuda", **kw)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
        err = (o.float() - o_ref.float()).abs().max().item()
        if dtype == "bfloat16":
            u = bf16_ulps(o, o_ref, FLASH_F32_ATOL)
            check("flash_attention", u <= 1.0, f"{label}: {u} ulp")
            tol = f"1 bf16 ulp beyond atol {FLASH_F32_ATOL}"
        else:
            check("flash_attention", err <= FLASH_F32_ATOL,
                  f"{label}: {err} > {FLASH_F32_ATOL}")
            tol = FLASH_F32_ATOL
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        pairs = flash_pairs(sq, skv, True, window)
        shape = {"q": [b, sq, h, dh], "kv": [b, skv, hkv, dh],
                 "dtype": dtype, "causal": True, "window": window}
        esz = q.element_size()
        flops = 4.0 * dh * b * h * pairs
        record(f"flash_attention[{label}]", err, tol,
               lambda: fwd(q, k, v, mode="cuda", **kw)[0],
               timed_ms(torch, lambda: fwd(q, k, v, mode="torch", **kw),
                        iters=3),
               timed_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True,
                                            is_causal=True), iters=5),
               esz * (2 * b * sq * h * dh + 2 * b * skv * hkv * dh), flops,
               {"shape": shape, "flops": flops, "bound_flop_rate": rate,
                "library_call": "scaled_dot_product_attention(enable_gqa="
                                "True, is_causal=True)"},
               kernel="flash_attention", flop_rate=rate)
        if with_bwd:
            got = bwd(q, k, v, o, lse, do, mode="cuda", **kw)
            want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
            rel = max((g.float() - w.float()).abs().max().item()
                      / max(w.float().abs().max().item(), 1e-30)
                      for g, w in zip(got, want))
            check("flash_attention_bwd", rel <= FLASH_BWD_REL[dtype],
                  f"{label}: {rel}")
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            del got, want
            lib_out = sdpa(qt, kt, vt, enable_gqa=True, is_causal=True)
            dot = do.transpose(1, 2)
            flops = 10.0 * dh * b * h * pairs
            record(f"flash_attention_bwd[{label}]", err, FLASH_BWD_REL[dtype],
                   lambda: bwd(q, k, v, o, lse, do, mode="cuda", **kw),
                   timed_ms(torch, lambda: flash_attention_bwd_ref(
                       q, k, v, o, lse, do, **kw), iters=2, warmup=1),
                   timed_ms(torch, lambda: torch.autograd.grad(
                       lib_out, (qt, kt, vt), dot, retain_graph=True),
                       iters=5),
                   esz * (3 * b * sq * h * dh + 4 * b * skv * hkv * dh)
                   + 4.0 * b * h * sq, flops,
                   {"shape": shape, "max_rel_err": rel,
                    "tolerance": f"{FLASH_BWD_REL[dtype]} x max|grad|",
                    "flops": flops, "bound_flop_rate": rate,
                    "library_call": "autograd of scaled_dot_product_"
                                    "attention(enable_gqa=True, "
                                    "is_causal=True)"},
                   kernel="flash_attention_bwd", flop_rate=rate)
            del lib_out
        del q, k, v, do, o, lse, o_ref, lse_ref, qt, kt, vt


def train_runs(torch, train, build, kern, n_layers: int,
               modes=("auto", "torch"), finite: bool = True,
               arch: str = TRAIN_ARCH, seq: int = TRAIN_KW["seq"],
               over=None) -> dict:
    """``train.run`` on ``arch`` at full width cut to ``n_layers`` layers
    (``TRAIN_KW``, ``seq`` tokens a row, ``over``'s fields in its place),
    once per kernel mode, the launch
    counts set to 0 just before each run and read just after, in all and
    at each shape (``shape_launches``): seconds per edge round, tokens a
    second, peak memory, the losses, the clock and the blocks.  With the
    kernels, every layer that attends (``flash_shapes`` of the cut config:
    the encoder's too) launches the flash forward twice a client step
    (remat runs it again before its backward) and the backward's three
    kernels once, at its own shape; the plain run launches nothing.
    ``finite=False`` (the 24-layer run) does not require finite losses:
    the random weights' gradients grow with depth (``train_grads_depth``;
    the reference's do too, ``tests/test_torch_train.py``) and the paper's
    lr then throws the model to inf and NaN after one step, with or
    without the kernels; that line measures time and memory only."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import count_params, param_specs
    kw = {**TRAIN_KW, "n_layers": n_layers, "device": "cuda", "seq": seq,
          **(over or {})}
    seq = kw["seq"]
    cfg = cut_depth(get_config(arch), n_layers)
    rounds = kw["steps"] * kw["k_edge"]
    tokens = rounds * kw["n_edges"] * kw["n_clients"] * kw["batch"] \
        * kw["seq"]
    steps = rounds * kw["n_edges"] * kw["n_clients"]
    out = {}
    for mode in modes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        with shape_launches(kern, build) as shapes:
            res = train.run(arch, kernel_mode=mode, **kw)
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses_finite = bool(np.isfinite(res["losses"]).all())
        check("train", len(res["losses"]) == kw["steps"]
              and (losses_finite or not finite)
              and res["blocks"] == kw["steps"] and res["chain_valid"],
              f"{arch} {mode}: {res}")
        line = {"arch": arch, "kernel_mode": mode, "layers": n_layers,
                "params": count_params(param_specs(cfg)),
                **{k: kw[k] for k in ("n_edges", "n_clients", "batch", "seq",
                                      "steps", "k_edge")},
                "param_dtype": kw.get("param_dtype") or cfg.param_dtype,
                "wall_s": res["wall"], "s_per_edge_round": res["wall"]
                / rounds, "tokens_per_s": tokens / res["wall"],
                "peak_memory_gb": peak / 1e9,
                "losses": [x if math.isfinite(x) else None
                           for x in res["losses"]],
                "losses_finite": losses_finite,
                "sim_clock": [float(x) for x in res["sim_clock"]],
                "blocks": res["blocks"], "launches": launches,
                "launches_by_shape": [[*k, n] for k, n in shapes.items()]}
        emit({"train": line})
        out[mode] = (res, launches, line, shapes)
        if mode == "auto":
            by_shape = collections.Counter()
            for name, per in (("flash_attention", 2),
                              ("flash_attention_bwd", 3)):
                for key, n in flash_shapes(cfg, kw["batch"], seq,
                                           name).items():
                    by_shape[key] = per * n * steps
            want = {name: sum(n for k, n in by_shape.items()
                              if k[0] == name)
                    for name in ("flash_attention", "flash_attention_bwd")}
            check("launches", {k: launches.get(k, 0) for k in want} == want
                  and shapes == by_shape,
                  f"train {arch} auto: {launches}, by shape {shapes}, "
                  f"expected {by_shape}")
        else:
            check("launches", not launches,
                  f"train {arch} {mode} launched {launches}")
    return out


def train_parity(torch, train, runs, arch: str = TRAIN_ARCH) -> dict:
    """The full-width kernel run against the plain run (first reported loss
    within TRAIN_LOSS_REL, clock and blocks equal), and for TRAIN_ARCH
    danube-smoke on the card (float32, head dim 32; T = 3, K = 2) with the
    kernels against plain: clock and blocks equal, the first round's loss
    within the engine-parity bound, every round's within
    SMOKE_CHAOS_REL."""
    a, p = runs["auto"][0], runs["torch"][0]
    full = {
        "first_loss_rel": abs(a["losses"][0] - p["losses"][0])
        / abs(p["losses"][0]),
        "losses_rel": [abs(x - y) / abs(y) for x, y in
                       zip(a["losses"], p["losses"])],
        "clock_equal": bool(np.array_equal(a["sim_clock"], p["sim_clock"])),
        "blocks_equal": a["blocks"] == p["blocks"]}
    tol = {"full_first_loss_rel": TRAIN_LOSS_REL}
    check("train_parity", full["first_loss_rel"] <= TRAIN_LOSS_REL
          and full["clock_equal"] and full["blocks_equal"], f"{arch}: {full}")
    if arch != TRAIN_ARCH:
        out = {"arch": arch, "full_width": full, "tolerances": tol}
        emit({"train_parity": out})
        return out
    smoke = {m: train.run(TRAIN_ARCH, smoke=True, steps=3, k_edge=2,
                          device="cuda", kernel_mode=m, progress=False)
             for m in ("auto", "torch")}
    sa, sp = (np.asarray(smoke[m]["losses"]) for m in ("auto", "torch"))
    small = {
        "losses_auto": sa.tolist(), "losses_torch": sp.tolist(),
        "first_round_within": bool(np.allclose(sa[0], sp[0],
                                               rtol=SMOKE_LOSS_TOL,
                                               atol=SMOKE_LOSS_TOL)),
        "rounds_within": bool(np.allclose(sa, sp, rtol=SMOKE_CHAOS_REL)),
        "clock_equal": bool(np.array_equal(smoke["auto"]["sim_clock"],
                                           smoke["torch"]["sim_clock"])),
        "blocks_equal": smoke["auto"]["blocks"] == smoke["torch"]["blocks"]}
    out = {"arch": arch, "full_width": full, "smoke": small,
           "tolerances": {**tol, "smoke_first_round": SMOKE_LOSS_TOL,
                          "smoke_rounds_rel": SMOKE_CHAOS_REL}}
    emit({"train_parity": out})
    check("train_parity", small["first_round_within"]
          and small["rounds_within"] and small["clock_equal"]
          and small["blocks_equal"], f"{small}")
    return out


def xattn_step_parity(torch, kern, arch: str = XATTN_TRAIN_ARCH,
                      n_layers: int = XATTN_TRAIN_LAYERS,
                      seq: int = XATTN_TRAIN_SEQ) -> dict:
    """The enc-dec train step where the ``train`` line cannot see it: that
    line feeds zero memory under zero gates, as the reference's driver
    does, so ``encode(0) = 0``, every cross-attention output is multiplied
    by ``tanh(0) = 0``, the gates' gradients are 0 and the encoder and
    cross layers get ``do = 0``.

    One ``make_hfl_train_step`` step of ``arch`` at full width cut to
    ``n_layers`` decoder and as many encoder layers, in float32, one edge
    of one client of TRAIN_KW's rows x ``seq`` tokens, with N(0, 1) memory
    (XATTN_MEMORY_SEED) in its batch and every ``xattn_gate`` at
    XATTN_GATE, the lr of ``train.run``'s first step, with the kernels and
    with the plain versions.  Checked: the step's loss within
    XATTN_LOSS_REL, the plain step with its non-causal forward broken
    (XATTN_FWD_FAULTS) above it, and every gate moved in both runs.  Read:
    per leaf of the encoder and of the cross-attention layers, the leaf's
    change over the step (the aggregated model minus the initial weights),
    max |auto - torch| over that leaf's largest plain change, beside the
    same reading for the plain step with a few-ulp perturbation of its
    forward (``o_noise``: the reading's resolution).  The backward of those
    layers is held call by call in ``train_grads_bf16``."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.data import lm_tokens
    from repro_torch.launch.serve import make_params
    from repro_torch.launch.steps import (flatten, init_fl_histories,
                                          make_hfl_train_step, unflatten)
    from repro_torch.optim import paper_lr
    cfg = dataclasses.replace(cut_depth(get_config(arch), n_layers),
                              param_dtype="float32")
    dev, rows = torch.device("cuda"), TRAIN_KW["batch"]
    tree = make_params(cfg, 0, dev)
    set_gates(tree)
    base = flatten(tree)
    del tree
    toks = torch.as_tensor(lm_tokens(rows, seq + 1, cfg.vocab, seed=1),
                           device=dev).long()[None, None]
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "memory": xattn_memory(torch, cfg, (1, 1, rows))}
    cross = tuple(f"unit/{i}/" for i, kind in enumerate(cfg.block_pattern)
                  if kind == "xattn")
    watched = [k for k in base if k.startswith(("encoder/",) + cross)]
    gates = [k for k in watched if k.endswith("xattn_gate")]
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)
    lr = float(paper_lr(0, 1e-2, 0.3))

    def step(mode):
        params = unflatten({k: v[None, None].clone()
                            for k, v in base.items()})
        dev_hist, glob_hist = init_fl_histories(params)
        params, _, _, loss = make_hfl_train_step(cfg, kernel_mode=mode)(
            params, dev_hist, glob_hist, batch, ones, ones[:, 0], lr)
        flat = flatten(params)
        return loss.item(), {k: flat[k][0, 0] - base[k] for k in watched}

    def per_leaf(got, want):
        return {k: ((got[k] - want[k]).abs().max()
                    / want[k].abs().max().clamp(min=1e-30)).item()
                for k in want}

    plain = step("torch")
    auto = step("auto")
    noise = faulty(kern, "o_noise", lambda: step("torch"))
    broken = faulty(kern, "noncausal_fwd_0.9", lambda: step("torch"),
                    XATTN_FWD_FAULTS)[0]
    out = {"arch": arch, "layers": n_layers, "encoder_layers": n_layers,
           "dtype": "float32", "tokens": [rows, seq],
           "memory": {"shape": list(batch["memory"].shape),
                      "seed": XATTN_MEMORY_SEED, "xattn_gate": XATTN_GATE},
           "lr": lr, "loss": {"auto": auto[0], "torch": plain[0]},
           "loss_rel": abs(auto[0] - plain[0]) / abs(plain[0]),
           "loss_rel_noncausal_fwd_0.9": abs(broken - plain[0])
           / abs(plain[0]),
           "loss_rel_o_noise": abs(noise[0] - plain[0]) / abs(plain[0]),
           "gate_change": {k: {"auto": auto[1][k].flatten().tolist(),
                               "torch": plain[1][k].flatten().tolist()}
                           for k in gates},
           "leaf_change_rel": {"auto": per_leaf(auto[1], plain[1]),
                               "o_noise": per_leaf(noise[1], plain[1])},
           "tolerance": XATTN_LOSS_REL}
    emit({"xattn_step_parity": out})
    check("xattn_step_parity", out["loss_rel"] <= XATTN_LOSS_REL,
          f"loss {out['loss']}: {out['loss_rel']}")
    check("xattn_step_parity", out["loss_rel_noncausal_fwd_0.9"]
          > XATTN_LOSS_REL, "a broken encoder and cross-attention forward "
          f"reads within the bound: {out['loss_rel_noncausal_fwd_0.9']}")
    check("xattn_step_parity", all(v != 0 for leaf in
                                   out["gate_change"].values()
                                   for mode in leaf.values() for v in mode),
          f"a gate did not move: {out['gate_change']}")
    return out


def grad_inputs(torch, n_layers: int, dtype: str, seed: int = 1,
                arch: str = TRAIN_ARCH, rows: int = 2,
                seq: int = TRAIN_KW["seq"]):
    """``arch`` at full width cut to ``n_layers`` layers (``cut_depth``):
    its config in ``dtype``, the weights ``train.run`` draws (seed 0),
    flattened, one client's batch of ``rows`` x ``seq`` tokens and labels
    (``lm_tokens`` from ``seed``), and for a model with cross-attention
    N(0, 1) memory (XATTN_MEMORY_SEED) in ``dtype`` with every
    ``xattn_gate`` at XATTN_GATE (else None), on the card."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.data import lm_tokens
    from repro_torch.launch.inputs import memory_shape
    from repro_torch.launch.serve import make_params
    from repro_torch.launch.steps import flatten
    cfg = dataclasses.replace(cut_depth(get_config(arch), n_layers),
                              param_dtype=dtype)
    dev = torch.device("cuda")
    tree, mem = make_params(cfg, 0, dev), None
    if memory_shape(cfg) is not None:
        set_gates(tree)
        mem = xattn_memory(torch, cfg, (rows,))
    toks = torch.as_tensor(lm_tokens(rows, seq + 1, cfg.vocab, seed=seed),
                           device=dev).long()
    return cfg, flatten(tree), toks[:, :-1], toks[:, 1:], mem


def client_grads(torch, cfg, params, tok, lab, mem, mode):
    """One client's ``loss_fn`` gradients (remat on, ``mem`` the raw
    memory or None) in ``mode``: the gradient per leaf, and the loss, the
    largest |gradient| and its leaf, whether every gradient is finite."""
    from repro_torch.launch.steps import unflatten
    from repro_torch.models import loss_fn
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(unflatten(leaves), tok, lab, cfg, memory_embeds=mem,
                   remat=True, kernel_mode=mode)
    g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    top = max(g, key=lambda k: g[k].float().abs().max().item())
    return g, {"loss": loss.item(), "leaf": top,
               "max_abs_grad": g[top].float().abs().max().item(),
               "finite": all(bool(torch.isfinite(x).all())
                             for x in g.values())}


def worst_leaf(got, want):
    """The worst leaf's max |got - want| over that leaf's largest |want|,
    and the leaf."""
    errs = {k: ((got[k].float() - want[k].float()).abs().max()
                / want[k].float().abs().max().clamp(min=1e-30)).item()
            for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def faulty(kern, name, fn, faults=None):
    """``fn()`` with the attention wrapper that ``faults[name]`` (default
    FAULTS) names replaced by its broken or perturbed version."""
    attr, broken = (faults or FAULTS)[name]
    sound = getattr(kern, attr)
    setattr(kern, attr, functools.partial(broken, sound))
    try:
        return fn()
    finally:
        setattr(kern, attr, sound)


def train_grads(torch, kern, n_layers: int, dtype: str, seed: int = 1,
                faults: tuple = ()) -> dict:
    """One client's ``loss_fn`` gradients on TRAIN_ARCH at full width cut to
    ``n_layers`` layers (``grad_inputs``) with the kernels and with the
    plain versions: each run's loss, largest |gradient| and its leaf,
    whether every gradient is finite, and ``rel``, the worst leaf's max
    |auto - torch| over that leaf's largest |gradient| under ``torch``.
    Each of ``faults`` (FAULTS' names) reruns the plain version with its
    attention broken or perturbed so, and gives the same reading against
    the sound plain gradients."""
    inputs = grad_inputs(torch, n_layers, dtype, seed)
    plain, out = client_grads(torch, *inputs, "torch"), {
        "layers": n_layers, "dtype": dtype, "seed": seed}
    auto = client_grads(torch, *inputs, "auto")
    out.update(auto=auto[1], torch=plain[1])
    out["rel"], out["rel_leaf"] = worst_leaf(auto[0], plain[0])
    del auto
    for name in faults:
        out[f"fault_{name}"] = worst_leaf(faulty(
            kern, name, lambda: client_grads(torch, *inputs, "torch"))[0],
            plain[0])[0]
    return out


def train_grads_bf16(torch, build, kern, n_layers: int, seed: int = 1,
                     arch: str = TRAIN_ARCH, rows: int = 2,
                     seq: int = TRAIN_KW["seq"]) -> dict:
    """The bfloat16 train path's gradients, checked where the whole-model
    reading cannot be (its sound reading equals a dropped dq's).

    Per layer: one client's bfloat16 ``loss_fn`` gradient with the kernels
    (``grad_inputs`` of ``arch`` at ``n_layers`` layers, ``rows`` x
    ``seq`` tokens; a cross-attention model's random memory and gates),
    every call of ``flash_attention_bwd`` recorded on the model's own
    activations (q, k, v, o, lse, do; the attribute swap FAULTS uses): one
    a layer that attends (``flash_layers``: causal self-attention,
    non-causal encoder and cross-attention), their launches counted;
    then each call's kernel backward held against the plain backward fed
    the plain forward's (o, lse) on the same q, k, v, do
    (``flash_bwd_phase``'s rule), to FLASH_BWD_REL["bfloat16"] of each
    gradient's largest magnitude; FLASH_BWD_FAULTS applied to the kernel's
    gradients must read above it on every layer.

    For TRAIN_ARCH, against float32: the kernel's and the plain version's
    bfloat16 gradients, each against the plain float32 gradient on the same
    bf16-rounded weights and tokens (the worst leaf, as ``train_grads``
    reads it), their ratio, and every control of FAULTS rerun on the plain
    bfloat16 path.  Checked (the ratio within TRAIN_GRAD_ANCHOR_FACTOR) only
    where every control of TRAIN_GRAD_FAULTS reads at least that factor
    above both sound readings; read otherwise."""
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    cfg, params, tok, lab, mem = grad_inputs(torch, n_layers, "bfloat16",
                                             seed, arch, rows, seq)
    calls, sound = [], kern.flash_attention_bwd

    def recorded(*a, **k):
        calls.append(([x.detach().clone() for x in a], dict(k)))
        return sound(*a, **k)

    kern.flash_attention_bwd = recorded
    build.reset_launch_counts()
    try:
        auto = client_grads(torch, cfg, params, tok, lab, mem, "auto")
    finally:
        kern.flash_attention_bwd = sound
    launches = dict(build.LAUNCHES)
    check("train_grads_bf16", len(calls) == flash_layers(cfg),
          f"{arch}: {len(calls)} backward calls for {flash_layers(cfg)} "
          "layers that attend")

    def rel(got, want):
        return max((g.float() - w.float()).abs().max().item()
                   / max(w.float().abs().max().item(), 1e-30)
                   for g, w in zip(got, want))

    bound, layers = FLASH_BWD_REL["bfloat16"], []
    for (q, k, v, o, lse, do), kw in calls:
        kw = {n: kw[n] for n in ("causal", "window", "q_offset") if n in kw}
        got = sound(q, k, v, o, lse, do, mode="cuda", **kw)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        layer = {"rel": rel(got, want), "causal": kw["causal"],
                 "shape": {"q": list(q.shape), "kv": list(k.shape)},
                 "max_abs_grad": [w.float().abs().max().item()
                                  for w in want]}
        for name in FLASH_BWD_FAULTS:
            layer[name] = rel(FAULTS[name][1](lambda *a, **k_: got), want)
        layers.append(layer)
        del got, want, o_ref, lse_ref
    del calls
    out = {"arch": arch, "layers": n_layers, "tokens": [rows, seq],
           "seed": seed, "tolerance": bound, "launches": launches,
           "per_layer": layers}
    check("train_grads_bf16", all(x["rel"] <= bound for x in layers),
          f"{arch}: kernel backward against plain per layer: {layers}")
    check("train_grads_bf16", all(x[f] > bound for x in layers
                                  for f in FLASH_BWD_FAULTS),
          f"{arch}: a broken backward reads within the bound: {layers}")
    if arch != TRAIN_ARCH:
        emit({"train_grads_bf16": out})
        return out

    plain = client_grads(torch, cfg, params, tok, lab, mem, "torch")
    out["auto"], out["torch"] = auto[1], plain[1]
    out["rel_auto_torch"] = worst_leaf(auto[0], plain[0])[0]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    ref32 = client_grads(torch, cfg32, {k: v.float() for k, v in
                                        params.items()}, tok, lab, mem,
                         "torch")[0]
    anchor = {"auto": worst_leaf(auto[0], ref32),
              "torch": worst_leaf(plain[0], ref32)}
    del auto, plain
    for name in FAULTS:
        anchor[f"fault_{name}"] = worst_leaf(faulty(
            kern, name, lambda: client_grads(torch, cfg, params, tok, lab,
                                             mem, "torch"))[0], ref32)
    sound_max = max(anchor["auto"][0], anchor["torch"][0])
    separated = all(anchor[f"fault_{f}"][0]
                    >= TRAIN_GRAD_ANCHOR_FACTOR * sound_max
                    for f in TRAIN_GRAD_FAULTS)
    out["against_float32"] = {
        **{k: {"rel": r, "leaf": leaf} for k, (r, leaf) in anchor.items()},
        "ratio": anchor["auto"][0] / max(anchor["torch"][0], 1e-30),
        "factor": TRAIN_GRAD_ANCHOR_FACTOR, "separated": separated,
        "checked": separated}
    emit({"train_grads_bf16": out})
    if separated:
        check("train_grads_bf16", out["against_float32"]["ratio"]
              <= TRAIN_GRAD_ANCHOR_FACTOR, f"{out['against_float32']}")
    return out


def _o_noise(fwd, *a, **k):
    """The forward's output times 1 + 2^-20 n, n standard normal from a
    fixed seed: a perturbation of a few float32 ulps."""
    import torch
    o, lse = fwd(*a, **k)
    g = torch.Generator(device=o.device)
    g.manual_seed(0)
    return o * (1 + 2.0 ** -20 * torch.randn(
        o.shape, generator=g, device=o.device, dtype=o.dtype)), lse


#: what ``train_grads`` reruns the plain version with: the attention
#: wrapper it replaces, and the replacement (given the sound wrapper).
#: Faults of the backward: dq dropped, dk and dv dropped, all three scaled
#: by 0.9 or 0.99; ``o_noise`` perturbs the forward's output by a few
#: float32 ulps, what rounding alone can do
def _noncausal_scaled(fwd, *a, **k):
    """The forward's output times 0.9 on a non-causal call (an encoder or
    cross-attention layer), as it is on a causal one."""
    o, lse = fwd(*a, **k)
    return (o if k.get("causal", True) else o * 0.9), lse


#: the forward broken on the enc-dec path alone (``xattn_step_parity``)
XATTN_FWD_FAULTS = {"noncausal_fwd_0.9": ("flash_attention_fwd",
                                          _noncausal_scaled)}
FAULTS = {
    "dq_dropped": ("flash_attention_bwd", lambda bwd, *a, **k: (
        lambda g: (g[0] * 0, g[1], g[2]))(bwd(*a, **k))),
    "dkdv_dropped": ("flash_attention_bwd", lambda bwd, *a, **k: (
        lambda g: (g[0], g[1] * 0, g[2] * 0))(bwd(*a, **k))),
    "scaled_0.9": ("flash_attention_bwd", lambda bwd, *a, **k: tuple(
        x * 0.9 for x in bwd(*a, **k))),
    "scaled_0.99": ("flash_attention_bwd", lambda bwd, *a, **k: tuple(
        x * 0.99 for x in bwd(*a, **k))),
    "o_noise": ("flash_attention_fwd", _o_noise),
}


def resume_check(np_run, make_sim) -> dict:
    """``run_checkpointed(every=2)`` run through, then run again, its last
    step file deleted and resumed from a fresh simulator: the resumed
    result must be bitwise the uninterrupted one, and close to ``run()``
    (``np_run``; the same operations in the same order, rtol 1e-5).  The
    checkpoints go to ``build/`` in the checkout and are removed."""
    base = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    try:
        full = make_sim().run_checkpointed(str(base / "a"), every=2)
        make_sim().run_checkpointed(str(base / "b"), every=2)
        last = max((base / "b").glob("step_*.npz"))
        last.unlink()
        last.with_suffix(".json").unlink()
        resumed = make_sim().run_checkpointed(str(base / "b"), every=2)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    bitwise = all(np.array_equal(getattr(resumed, r), getattr(full, r))
                  for r in ROWS) and resumed.blocks == full.blocks
    close = all(np.allclose(getattr(full, r), getattr(np_run, r), rtol=1e-5,
                            atol=1e-6) for r in ROWS)
    return {"deleted": last.name, "resumed_bitwise": bitwise,
            "close_to_run": close,
            "max_abs_diff_to_run": {r: float(np.abs(getattr(full, r)
                                                    - getattr(np_run, r))
                                             .max()) for r in ROWS}}


def make_store(fl, core, setting, size: int, resample: str = "round"):
    """The device store ``BHFLSimulator(setting, population=size,
    j_cohort=POP_J_COHORT)`` builds (seeded on the deployment's
    ``"population"`` stream), with cohorts resampled by ``resample``."""
    return fl.DevicePopulation(
        fl.PopulationSpec(size=size, j_cohort=POP_J_COHORT,
                          resample=resample),
        n_classes=setting.n_classes, max_classes=setting.classes_per_device,
        seed=core.stream_seed(setting.seed, "population"))


def within_bounds(a, b, clock: bool = True) -> dict:
    """Run ``a`` against run ``b``: the largest differences of the
    accuracy, loss and delta rows and whether they hold the engine-parity
    bounds, with the clock and energy rows equal (``clock``) and the blocks
    equal."""
    ok = bool(np.allclose(a.accuracy, b.accuracy, rtol=0, atol=ACC_TOL)
              and np.allclose(a.loss, b.loss, rtol=LOSS_TOL, atol=LOSS_TOL)
              and np.allclose(a.grad_norm, b.grad_norm, rtol=DELTA_RTOL,
                              atol=DELTA_ATOL)
              and a.blocks == b.blocks)
    if clock:
        ok = ok and bool(np.array_equal(a.sim_clock, b.sim_clock)
                         and np.array_equal(a.sim_energy, b.sim_energy))
    return {"within_bounds": ok, "max_abs_diff": {
        k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
        for k in ("accuracy", "loss", "grad_norm")}}


def population_phase(torch, build, fl, core, setting, smoke_launches) -> dict:
    """Population mode at full width (the ``population`` cell): a store of
    each size of POP_SIZES built once (host seconds printed), then HieAvg
    and delayed-gradient over it with the kernels and plain, each pair
    within the engine-parity bounds, clock and energy equal.  A run's
    launch counts must be the smoke run's of its aggregator
    (``smoke_launches``): the kernels see a cohort of 25 devices whatever
    the store's size.  The delayed-gradient run must apply a churn reset
    at every occupant change of its plan (``engine.CHURN_RESETS``), and
    more than 0; peak device memory must not grow with the store.  The
    last of them (delayed-gradient over the largest store) is checkpointed,
    cut and resumed from fresh simulators built with ``population=size,
    j_cohort=...`` (``population_resume``: bitwise).  Then
    ``population_parity`` (a static cohort of the largest store against
    ``store.subset`` of its rows run as a "full" population: bitwise) and
    ``population_sweep`` (the mixed grid over the largest store as one
    "switched" stack, each point within the engine-parity bounds of its
    standalone run).  Returns the stores."""
    from repro_torch.fl import engine
    T = setting.t_global_rounds
    stores, build_s = {}, {}
    for size in POP_SIZES:
        t0 = time.time()
        stores[size] = make_store(fl, core, setting, size)
        build_s[size] = time.time() - t0
    peaks: dict = {}
    for size in POP_SIZES:
        for label in POP_RUNS:
            out, res = {}, {}
            for mode in ("auto", "torch"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                build.reset_launch_counts()
                engine.CHURN_RESETS.clear()
                t0 = time.time()
                sim = fl.BHFLSimulator(setting, label, "temporary",
                                       "temporary", population=stores[size],
                                       device="cuda", kernel_mode=mode,
                                       **POP_KW)
                r = res[mode] = sim.run()
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = dict(build.LAUNCHES)
                resets = engine.CHURN_RESETS["slots"]
                changes = int(sim.cohort_change().sum())
                peak = torch.cuda.max_memory_allocated()
                peaks[size, label, mode] = peak
                for key in ROWS:
                    row = getattr(r, key)
                    check("population", row.shape == (T,)
                          and bool(np.isfinite(row).all()),
                          f"{size} {label} {mode} {key}: {row}")
                check("population", r.blocks == T and r.chain_valid,
                      f"{size} {label} {mode}: chain {r.blocks}")
                want = smoke_launches[label] if mode == "auto" else {}
                check("launches", launches == want,
                      f"population {size} {label} {mode}: {launches}, the "
                      f"standalone run's {want}")
                check("population", changes > 0 and resets == (
                    changes if label == "delayed_grad" else 0),
                      f"{size} {label} {mode}: {resets} churn resets for "
                      f"{changes} occupant changes")
                out[mode] = {"wall_s": wall, "run_s": r.wall_time,
                             "rounds_per_s": T / wall,
                             "peak_memory_gb": peak / 1e9,
                             "launches": launches, "churn_resets": resets,
                             "final_accuracy": float(r.accuracy[-1]),
                             **{k: [float(v) for v in getattr(r, k)]
                                for k in ("loss", "sim_clock")}}
            if (size, label) == (POP_SIZES[-1], "delayed_grad"):
                resumed_from = res["auto"]
            parity = within_bounds(res["auto"], res["torch"])
            emit({"population": {
                "size": size, "config": label, "j_cohort": POP_J_COHORT,
                "devices_a_round": sim.D, "resample": "round",
                "t_global_rounds": T, **POP_KW,
                "store_build_s": build_s[size], "occupant_changes": changes,
                **out, "auto_vs_torch": parity}})
            check("population", parity["within_bounds"],
                  f"{size} {label}: {parity}")
    # ---- the largest delayed-gradient run checkpointed, cut and resumed
    # from fresh simulators given the store's size (each builds its store)
    line = resume_check(resumed_from, lambda: fl.BHFLSimulator(
        setting, "delayed_grad", "temporary", "temporary",
        population=POP_SIZES[-1], j_cohort=POP_J_COHORT, device="cuda",
        **POP_KW))
    emit({"population_resume": {"size": POP_SIZES[-1],
                                "config": "delayed_grad", "every": 2,
                                **line}})
    check("population_resume", line["resumed_bitwise"]
          and line["close_to_run"], f"{line}")
    for label in POP_RUNS:
        for mode in ("auto", "torch"):
            a, b = (peaks[size, label, mode] for size in POP_SIZES)
            check("population", abs(b - a) <= 0.01 * a,
                  f"{label} {mode}: peak memory {a} B at {POP_SIZES[0]} "
                  f"devices, {b} B at {POP_SIZES[-1]}")

    # ---- a gathered cohort against its materialized subset, bitwise
    big_size = POP_SIZES[-1]
    static = make_store(fl, core, setting, big_size, "static")
    line = {"size": big_size}
    for label in POP_RUNS:
        big = fl.BHFLSimulator(setting, label, "temporary", "temporary",
                               population=static, device="cuda", **POP_KW)
        small = fl.BHFLSimulator(
            setting, label, "temporary", "temporary",
            population=static.subset(big.cohort_ids[0]), device="cuda",
            **POP_KW)
        a, b = big.run(), small.run()
        diff = {k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
                for k in ROWS}
        bitwise = all(np.array_equal(getattr(a, k), getattr(b, k))
                      for k in ROWS) and a.blocks == b.blocks
        line[label] = {"bitwise": bitwise, "max_abs_diff": diff}
        check("population_parity", bitwise, f"{label}: {diff}")
    emit({"population_parity": line})

    # ---- the mixed grid over the largest store, one "switched" stack
    store = stores[big_size]
    overrides = [{"aggregation": "hieavg"}] + [
        {"aggregation": "delayed_grad", "staleness_discount": b}
        for b in POP_BETAS]
    t0 = time.time()
    plan = fl.plan_sweep(setting, (0,), overrides=overrides, device="cuda",
                         kernel_mode="auto", population=store, **POP_KW)
    plan_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    engine.CHURN_RESETS.clear()
    t0 = time.time()
    got = fl.run_plan(plan)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(build.LAUNCHES)
    resets = engine.CHURN_RESETS["slots"]
    peak = torch.cuda.max_memory_allocated()
    alone, alone_s = [], []
    for ov, seed in got.points:
        ov = dict(ov)
        agg = ov.pop("aggregation")
        torch.cuda.synchronize()
        t0 = time.time()
        sim = fl.BHFLSimulator(dataclasses.replace(setting, **ov), agg,
                               "temporary", "temporary", population=store,
                               seed=seed, device="cuda", **POP_KW)
        alone.append(sim.run())
        torch.cuda.synchronize()
        alone_s.append(time.time() - t0)
    changes = int(sim.cohort_change().sum())
    missing = [k for k in SWEEP_KERNELS["switched"] if not launches.get(k)]
    vs_alone = _rows_diff(got, alone, got.t_valid)
    emit({"population_sweep": {
        "size": big_size, "points": len(got.points),
        "aggregator": plan.aggregator, "betas": list(POP_BETAS),
        "buckets": plan.describe().splitlines(), "plan_s": plan_s,
        "wall_s": wall, "points_s": alone_s, "one_by_one_s": sum(alone_s),
        "peak_memory_gb": peak / 1e9, "launches": launches,
        "churn_resets": resets, "vs_standalone": vs_alone,
        "final_accuracy": [float(got.accuracy[p, -1])
                           for p in range(len(got.points))]}})
    check("launches", not missing,
          f"population sweep: never launched {missing} ({launches})")
    check("population_sweep", resets == len(POP_BETAS) * changes > 0,
          f"{resets} churn resets for {len(POP_BETAS)} delayed-gradient "
          f"points of {changes} occupant changes")
    check("population_sweep", vs_alone["within_bounds"],
          f"sweep against standalone runs {vs_alone}")
    return stores


def legacy_phase(torch, build, simulator, setting, engine_run) -> dict:
    """``run_legacy()`` (the reference's per-edge loop in plain PyTorch, no
    kernel) of the smoke HieAvg configuration on the card, against
    ``run()`` with the kernels (``engine_run``): within the engine-parity
    bounds, blocks equal, both chains valid, and no kernel launched."""
    sim = simulator(setting, "hieavg", "temporary", "temporary",
                    device="cuda")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    res = sim.run_legacy()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    T = setting.t_global_rounds
    for key in ("accuracy", "loss", "grad_norm"):
        row = getattr(res, key)
        check("legacy", row.shape == (T,) and bool(np.isfinite(row).all()),
              f"{key}: {row}")
    line = within_bounds(res, engine_run, clock=False)
    out = {"config": "hieavg", "wall_s": res.wall_time,
           "engine_wall_s": engine_run.wall_time, "launches": launches,
           "blocks": res.blocks, "chain_valid": res.chain_valid,
           "engine_chain_valid": engine_run.chain_valid,
           "vs_run": line,
           "accuracy": [float(v) for v in res.accuracy],
           "loss": [float(v) for v in res.loss]}
    emit({"legacy": out})
    check("legacy", not launches, f"run_legacy launched {launches}")
    check("legacy", line["within_bounds"] and res.chain_valid
          and engine_run.chain_valid, f"{out}")
    return out


def population_full(torch, fl, core, setting) -> dict:
    """``--full``: HieAvg at T = 50 over stores of POP_FULL_SIZES devices,
    each built once; a warm-up pass, then POP_REPEAT passes with the sizes
    in turns, the best wall seconds of each (the simulator built and run,
    as ``benchmarks/bench_population.py`` times it): rounds per second per
    size and their max/min ratio."""
    stores = {size: make_store(fl, core, setting, size)
              for size in POP_FULL_SIZES}

    def one(size) -> float:
        torch.cuda.synchronize()
        t0 = time.time()
        fl.BHFLSimulator(setting, "hieavg", "temporary", "temporary",
                         population=stores[size], device="cuda",
                         **POP_KW).run()
        torch.cuda.synchronize()
        return time.time() - t0

    for size in POP_FULL_SIZES:
        one(size)
    best = {size: float("inf") for size in POP_FULL_SIZES}
    for _ in range(POP_REPEAT):
        for size in POP_FULL_SIZES:
            best[size] = min(best[size], one(size))
    rps = {str(size): setting.t_global_rounds / best[size]
           for size in POP_FULL_SIZES}
    return {"t_global_rounds": setting.t_global_rounds,
            "j_cohort": POP_J_COHORT, "repeat": POP_REPEAT,
            "best_wall_s": {str(k): v for k, v in best.items()},
            "rounds_per_s": rps,
            "max_min_ratio": max(rps.values()) / min(rps.values())}


def fig3_overrides() -> list:
    return [{field: v} for field, values in FIG3 for v in values]


def _point_sim(simulator, setting, ov: dict, seed: int, mode: str):
    """The standalone simulator of a sweep point (its overrides, seed and
    aggregation)."""
    ov = dict(ov)
    ov.pop("seed", None)
    agg = ov.pop("aggregation", "hieavg")
    kw = dict(SWEEP_KW)
    jpe = ov.pop("j_per_edge", None)
    if isinstance(jpe, list):
        kw["j_per_edge"] = jpe
    elif jpe is not None:
        ov["j_per_edge"] = jpe
    return simulator(dataclasses.replace(setting, **ov), agg, "temporary",
                     "temporary", seed=seed, device="cuda", kernel_mode=mode,
                     **kw)


def _rows_diff(a, b, t_valid) -> dict:
    """Largest differences of the sweep rows ``a`` against ``b`` (a
    SweepResult, or a list of standalone RunResults), over each point's
    valid rounds, whether they are bitwise, and whether they hold the
    engine-parity bounds with the clock and the energy equal."""
    def row(res, p, k, tv):
        return getattr(res[p], k) if isinstance(res, list) \
            else getattr(res, k)[p, :tv]

    out = {k: 0.0 for k in ROWS}
    bitwise = within = True
    for p, tv in enumerate(t_valid):
        x = {k: row(a, p, k, tv) for k in ROWS}
        y = {k: row(b, p, k, tv) for k in ROWS}
        for k in ROWS:
            out[k] = max(out[k], float(np.abs(x[k] - y[k]).max()))
            bitwise = bitwise and bool(np.array_equal(x[k], y[k]))
        within = within and bool(
            np.allclose(x["accuracy"], y["accuracy"], rtol=0, atol=ACC_TOL)
            and np.allclose(x["loss"], y["loss"], rtol=LOSS_TOL,
                            atol=LOSS_TOL)
            and np.allclose(x["grad_norm"], y["grad_norm"], rtol=DELTA_RTOL,
                            atol=DELTA_ATOL)
            and np.array_equal(x["sim_clock"], y["sim_clock"])
            and np.array_equal(x["sim_energy"], y["sim_energy"]))
    return {"max_abs_diff": out, "bitwise": bitwise, "within_bounds": within}


def per_row_launches(plan) -> dict:
    """{rows: launches} of the per-row SGD path over a plan's buckets, by
    the engine's rule (``fl/engine.py``, ``run_engine_chunk``): at global
    round t and edge round k the points still running take one scale a row
    (``Pa·N·J`` rows, one launch a step) where their lr differs or a step
    is padded for some of them; a host float otherwise."""
    out: dict = {}
    for b in plan.buckets:
        inp = b.inputs
        _, T, K, N, J = inp.dev_masks.shape
        steps = inp.batch_idx.shape[-2]
        for t in range(1, T + 1):
            for k in range(K):
                ids = np.flatnonzero((t <= inp.t_valid) & (k < inp.k_valid))
                if not ids.size:
                    continue
                lr = inp.lr[ids, t - 1, k]
                if (inp.s_valid[ids] < steps).any() or (lr != lr[0]).any():
                    rows = ids.size * N * J
                    out[rows] = out.get(rows, 0) + steps
    return out


def sweep_phase(torch, build, fl, setting, rows_check) -> dict:
    """The sweep path at full width: Fig. 3's eleven rows
    (``bucket_cost="measured"``) and the "switched" plan, each planned
    once, then run with the kernels (the launch counts set to 0 just
    before and read just after) and with the plain versions on the same
    buckets; every point run again alone with the kernels.  Each point of
    the kernel sweep is held to its standalone run and to the plain sweep
    within the engine-parity bounds, clock and energy equal.  Before a
    plan runs, ``rows_check`` holds the per-row SGD kernel against its
    plain version at each row count the plan gives it
    (``per_row_launches``); after, its counted launches must be those.
    Returns the launches of the kernel sweeps and their results by
    plan."""
    plans = {"fig3": (fig3_overrides(), (0,)),
             "switched": (list(SWITCHED), SWITCHED_SEEDS)}
    total: dict = {}
    results: dict = {}
    for name, (overrides, seeds) in plans.items():
        t0 = time.time()
        plan = fl.plan_sweep(setting, seeds, overrides=overrides,
                             bucket_cost="measured", device="cuda",
                             kernel_mode="auto", **SWEEP_KW)
        plan_s = time.time() - t0
        rows_launches = per_row_launches(plan)
        rows_check(rows_launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.time()
        got = fl.run_plan(plan, donate=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.time()
        plain = fl.run_plan(dataclasses.replace(plan, kernel_mode="torch"))
        torch.cuda.synchronize()
        plain_wall = time.time() - t0
        alone, alone_s = [], 0.0
        for ov, seed in got.points:
            sim = _point_sim(fl.BHFLSimulator, setting, ov, seed, "auto")
            torch.cuda.synchronize()
            t0 = time.time()
            alone.append(sim.run())
            torch.cuda.synchronize()
            alone_s += time.time() - t0
        for k in ROWS:
            row = getattr(got, k)
            check("sweep", bool(np.isfinite(row).all())
                  and row.shape == (len(got.points), plan.grid_max["t"]),
                  f"{name} {k}: {row}")
        missing = [k for k in SWEEP_KERNELS[name] if not launches.get(k)]
        check("launches", not missing,
              f"sweep {name}: never launched {missing} ({launches})")
        check("launches", launches.get("sgd_update[rows]", 0)
              == sum(rows_launches.values()),
              f"sweep {name}: per-row SGD launches {launches} against "
              f"{rows_launches} by the engine's rule")
        vs_alone = _rows_diff(got, alone, got.t_valid)
        vs_plain = _rows_diff(got, plain, got.t_valid)
        emit({"sweep": {
            "plan": name, "points": len(got.points),
            "buckets": plan.describe().splitlines(),
            "aggregator": plan.aggregator,
            "t_global_rounds": setting.t_global_rounds,
            **{k: v for k, v in SWEEP_KW.items()},
            "plan_s": plan_s, "per_row_sgd_rows": {
                str(r): n for r, n in sorted(rows_launches.items())},
            "wall_s": wall,
            "points_per_s": len(got.points) / wall,
            "plain_wall_s": plain_wall, "one_by_one_s": alone_s,
            "peak_memory_gb": peak / 1e9, "launches": launches,
            "vs_standalone": vs_alone, "vs_plain": vs_plain,
            "final_accuracy": [float(got.accuracy[p, got.t_valid[p] - 1])
                               for p in range(len(got.points))],
            "tolerances": {"accuracy_atol": ACC_TOL,
                           "loss_rtol_atol": LOSS_TOL,
                           "delta_rtol": DELTA_RTOL,
                           "delta_atol": DELTA_ATOL}}})
        check("sweep", vs_alone["within_bounds"],
              f"{name}: sweep against standalone runs {vs_alone}")
        check("sweep", vs_plain["within_bounds"],
              f"{name}: kernel sweep against plain sweep {vs_plain}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        results[name] = got
    return total, results


def share_plan(fl_sweep, plan, world: int):
    """Per rank, the buckets it runs of ``plan`` on a ``data`` mesh of
    ``world`` ranks, as ``execute_plan`` cuts them: a bucket whose point
    count divides ``world`` a contiguous share of its branch-ordered
    points, any other whole.  Each entry has the ``buckets[i].inputs`` of
    a plan, for ``per_row_launches``."""
    import types

    from repro_torch.launch.sharding import sweep_spec
    ns = types.SimpleNamespace(shape={"data": world})
    out = [[] for _ in range(world)]
    for b in plan.buckets:
        order = fl_sweep._branch_order(b.inputs)
        split = bool(sweep_spec(len(b.point_ids), ns))
        size = order.size // world if split else order.size
        for r in range(world):
            share = order[r * size:(r + 1) * size] if split else order
            out[r].append(types.SimpleNamespace(
                inputs=fl_sweep._reorder(b.inputs, share)))
    return [types.SimpleNamespace(buckets=bs) for bs in out]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_procs(phase: str, out: Path, argvs: dict, during=None) -> float:
    """``argvs`` ({label: arguments of this script}) as processes started
    together, each's output to ``out/<label>.log``, ``during()`` run in
    this process meanwhile; every one must exit 0 within
    MESH_RANK_TIMEOUT seconds (``check`` under ``phase``, a log's tail in
    the message), and none is left running.  Returns the wall seconds."""
    t0 = time.time()
    logs = {k: out / f"{k}.log" for k in argvs}
    procs = {}
    try:
        for k, argv in argvs.items():
            with open(logs[k], "w") as log:
                procs[k] = subprocess.Popen(
                    [sys.executable, str(RANK_SCRIPT), *map(str, argv)],
                    stdout=log, stderr=subprocess.STDOUT)
        if during is not None:
            during()
        for p in procs.values():
            p.wait(timeout=max(1.0, MESH_RANK_TIMEOUT
                               - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        check(phase, False, f"a process had not ended after "
              f"{MESH_RANK_TIMEOUT} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    for k, p in procs.items():
        check(phase, p.returncode == 0, f"{k} exited {p.returncode}:\n"
              f"{logs[k].read_text()[-4000:]}")
    return wall


def mesh_sweep(torch, build, fl, setting, fig3, rows_check) -> dict:
    """The sweep split over a mesh's ranks.  (a) A world of one:
    ``run_sweep(..., mesh=make_sweep_mesh(), placement="auto")`` on Fig.
    3's eleven rows, planned as ``sweep_phase`` planned them (the measured
    step times are cached in this process), must be bitwise
    ``sweep_phase``'s kernel sweep ``fig3``.  (b) MESH_WORLD ``gloo``
    ranks on the one card (``MESH_PLANS``), each a process of this script:
    rank 0's rows held to this process's kernel sweep of the same plan
    within the engine-parity bounds, clock and energy equal, every rank's
    rows the same, every rank launching every kernel of the sweep path,
    its per-row SGD launches those of its share by the engine's rule
    (checked against the plain version first, ``rows_check``), and
    ``"shard"`` on the eleven rows as one bucket raising the reference's
    message.  Returns the ranks' launches by plan."""
    import torch.distributed as dist

    from repro_torch.fl import sweep as fl_sweep
    from repro_torch.launch.mesh import make_sweep_mesh

    started = not dist.is_initialized()
    try:
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.time()
        one = fl.run_sweep(setting, overrides=fig3_overrides(),
                           bucket_cost="measured", device="cuda",
                           kernel_mode="auto", mesh=make_sweep_mesh(),
                           placement="auto", **SWEEP_KW)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(build.LAUNCHES)
    finally:
        if started:
            dist.destroy_process_group()
    same = _rows_diff(one, fig3, one.t_valid)
    missing = [k for k in SWEEP_KERNELS["fig3"] if not launches.get(k)]
    emit({"mesh_sweep": {"world": 1, "points": len(one.points),
                         "wall_s": wall, "launches": launches,
                         "vs_meshless": same}})
    check("mesh_sweep", same["bitwise"],
          f"a world of one is not bitwise the meshless sweep: {same}")
    check("launches", not missing,
          f"mesh_sweep world 1: never launched {missing} ({launches})")

    # (b) the plans the ranks run, here in one process, and each rank's
    # share of them
    refs, expect = {}, {}
    for name, (n, kw) in MESH_PLANS.items():
        plan = fl.plan_sweep(setting, overrides=fig3_overrides()[:n],
                             device="cuda", kernel_mode="auto",
                             **{k: v for k, v in kw.items()
                                if k != "placement"}, **SWEEP_KW)
        shares = share_plan(fl_sweep, plan, MESH_WORLD)
        expect[name] = [per_row_launches(sh) for sh in shares]
        for rows in expect[name]:
            rows_check(rows)
        t0 = time.time()
        refs[name] = (fl.run_plan(plan), time.time() - t0,
                      plan.describe().splitlines())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    out = ROOT / "build" / "mesh_sweep"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    port = free_port()
    ranks_wall = run_procs("mesh_sweep", out, {
        f"rank{r}": ["--mesh-rank", r, "--mesh-world", MESH_WORLD,
                     "--mesh-port", port, "--mesh-out", out]
        for r in range(MESH_WORLD)})
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(MESH_WORLD)]
    total: dict = {}
    for name in MESH_PLANS:
        ref, ref_wall, buckets = refs[name]
        rows = [np.load(out / f"{name}_rank{r}.npz")
                for r in range(MESH_WORLD)]
        got = [types_ns(**{k: x[k] for k in ROWS}) for x in rows]
        vs_one = _rows_diff(got[0], ref, ref.t_valid)
        agree = all(np.array_equal(x[k], rows[0][k]) for x in rows[1:]
                    for k in ROWS)
        per_rank = [{"wall_s": rec[name]["wall_s"],
                     "plan_s": rec[name]["plan_s"],
                     "device": rec[name]["device"],
                     "launches": rec[name]["launches"],
                     "per_row_sgd_rows": {str(k): v for k, v in
                                          sorted(expect[name][r].items())}}
                    for r, rec in enumerate(recs)]
        emit({"mesh_sweep": {
            "world": MESH_WORLD, "plan": name,
            "points": len(ref.points), "buckets": buckets,
            "placement": MESH_PLANS[name][1]["placement"],
            "ranks": per_rank, "one_process_wall_s": ref_wall,
            "ranks_same_rows": agree, "rank0_vs_one_process": vs_one,
            "tolerances": {"accuracy_atol": ACC_TOL,
                           "loss_rtol_atol": LOSS_TOL,
                           "delta_rtol": DELTA_RTOL,
                           "delta_atol": DELTA_ATOL}}})
        check("mesh_sweep", vs_one["within_bounds"],
              f"{name}: rank 0 against one process {vs_one}")
        check("mesh_sweep", agree, f"{name}: the ranks' rows differ")
        for r, rank in enumerate(per_rank):
            missing = [k for k in SWEEP_KERNELS["fig3"]
                       if not rank["launches"].get(k)
                       and (k != "sgd_update[rows]" or expect[name][r])]
            check("launches", not missing,
                  f"mesh_sweep {name} rank {r}: never launched {missing}")
            check("launches", rank["launches"].get("sgd_update[rows]", 0)
                  == sum(expect[name][r].values()),
                  f"mesh_sweep {name} rank {r}: per-row SGD launches "
                  f"{rank['launches']} against {expect[name][r]}")
            for k, v in rank["launches"].items():
                total[k] = total.get(k, 0) + v
    msgs = [rec["shard11"] for rec in recs]
    emit({"mesh_sweep": {"world": MESH_WORLD, "plan": "fig3_11_shard",
                         "raised": msgs[0], "ranks_wall_s": ranks_wall}})
    check("mesh_sweep", all(
        m is not None and m.startswith(
            "placement='shard' but a bucket of 11 grid points (of 11 "
            "total) does not divide a >1 mesh axis (mesh={'data': 2}); "
            "force max_buckets=1 or use placement='auto'") for m in msgs),
        f"placement='shard' on eleven rows: {msgs}")
    return total


def types_ns(**kw):
    import types
    return types.SimpleNamespace(**kw)


def mesh_rank(argv: list) -> int:
    """One rank of ``mesh_sweep`` (``--mesh-rank R --mesh-world W
    --mesh-port P --mesh-out DIR``): joins the ``gloo`` group, runs
    ``MESH_PLANS`` through ``run_sweep``'s halves, ``plan_sweep`` and
    ``run_plan`` with ``mesh=make_sweep_mesh()``, with the kernels (the
    plan and the run timed apart; the launch counts set to 0 just before
    the run and read just after), and ``"shard"`` on the eleven rows as
    one bucket through ``run_sweep``; writes its
    rows and a JSON record to DIR.  The kernels are built by the parent
    before the ranks start."""
    import datetime

    import torch
    import torch.distributed as dist
    arg = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(arg["--mesh-rank"]), int(arg["--mesh-world"])
    out = Path(arg["--mesh-out"])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import fl
    from repro_torch.configs import DEFAULT
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_sweep_mesh

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{arg['--mesh-port']}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT))
    try:
        mesh = make_sweep_mesh()
        build.library()
        setting = dataclasses.replace(DEFAULT, t_global_rounds=SWEEP_T)
        rec = {}
        for name, (n, kw) in MESH_PLANS.items():
            # run_sweep's two halves, timed apart: every rank plans
            kw = dict(kw)
            placement = kw.pop("placement")
            t0 = time.time()
            plan = fl.plan_sweep(setting, overrides=fig3_overrides()[:n],
                                 device="cuda", kernel_mode="auto",
                                 mesh=mesh, **kw, **SWEEP_KW)
            plan_s = time.time() - t0
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.time()
            res = fl.run_plan(plan, mesh=mesh, placement=placement)
            torch.cuda.synchronize()
            rec[name] = {"wall_s": time.time() - t0, "plan_s": plan_s,
                         "launches": dict(build.LAUNCHES),
                         "device": f"cuda:{torch.cuda.current_device()}"}
            np.savez(out / f"{name}_rank{rank}.npz",
                     **{k: getattr(res, k) for k in ROWS})
        try:
            fl.run_sweep(setting, overrides=fig3_overrides(), max_buckets=1,
                         placement="shard", device="cuda",
                         kernel_mode="auto", mesh=mesh, **SWEEP_KW)
            rec["shard11"] = None
        except ValueError as e:
            rec["shard11"] = str(e)
        (out / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_census(torch, build) -> dict:
    """What the census says an arch x shape takes on a card, against what
    the card allocates.  On a one-card mesh (``make_debug_mesh()``), the
    census of ``input_specs`` for danube at the serve cell's shape (batch
    SERVE_BATCH x SERVE_PROMPT, prefill) and for the TRAIN_LAYERS-layer
    train line (one edge, TRAIN_KW's clients, batch and sequence) against
    what the card's allocator gains while the drivers' own code places the
    parameters, caches and histories (``serve.make_params`` /
    ``make_caches``; ``train.run``'s slots and ``init_fl_histories``):
    the bytes asked for (the allocator's ``requested_bytes``) within
    CENSUS_ROUNDING bytes a tensor, the allocated blocks within BLOCK_TAIL
    bytes a tensor above them (its rounding).  The leader's history is held
    at its float32 size: ``init_fl_histories`` keeps it in float32, where
    the stand-ins (as the reference's) keep the parameters' dtype.  Then
    the prefill with the mesh must give logits and caches bitwise those
    of the prefill without, its flash launches counted (set to 0 just
    before, read just after).  Then the dry-run's census of every pair
    on the two production meshes and the largest whose arguments are
    within this card (arguments only: whether a pair fits is the dry-run
    record's ``bytes_per_device``).  Last, ``census_peaks``."""
    import torch.distributed as dist

    from repro_torch.configs import ARCH_IDS, cut_depth, get_config
    from repro_torch.data import lm_tokens
    from repro_torch.launch import dryrun, inputs, make_debug_mesh
    from repro_torch.launch.serve import make_caches, make_params
    from repro_torch.launch.steps import init_fl_histories, make_prefill_step
    from repro_torch.models.config import INPUT_SHAPES, InputShape
    from repro_torch.optim.sgd import tree_map

    dev = torch.device("cuda")

    def allocated():
        """(allocated, requested) bytes on the card now."""
        torch.cuda.synchronize()
        return np.array([torch.cuda.memory_allocated(),
                         torch.cuda.memory_stats()[
                             "requested_bytes.all.current"]])

    def held(label, grown, specs_tree, extra=0):
        n = len(inputs.leaves(specs_tree))
        want = inputs.census(specs_tree, mesh) + extra
        line = {"reckoned": want, "requested": int(grown[1]),
                "allocated": int(grown[0]), "tensors": n,
                "bound": CENSUS_ROUNDING * n}
        check("mesh_census", abs(int(grown[1]) - want)
              <= CENSUS_ROUNDING * n, f"{label}: {line}")
        check("mesh_census", 0 <= grown[0] - grown[1] <= BLOCK_TAIL * n,
              f"{label}: the allocator's blocks {line}")
        return line

    started = not dist.is_initialized()
    mesh = make_debug_mesh()
    try:
        out = {"mesh": "1x1"}
        cfg = get_config(SERVE_ARCH)
        shape = InputShape("serve_8k", SERVE_PROMPT, SERVE_BATCH, "prefill")
        specs = inputs.input_specs(cfg, shape, mesh)
        torch.cuda.empty_cache()
        a0 = allocated()
        params = make_params(cfg, 0, dev)
        a1 = allocated()
        caches = make_caches(cfg, SERVE_BATCH, SERVE_PROMPT, dev,
                             smoke=False)
        a2 = allocated()
        serve_line = {"arch": SERVE_ARCH, "batch": SERVE_BATCH,
                      "seq": SERVE_PROMPT,
                      "params": held("serve params", a1 - a0,
                                     specs["params"]),
                      "caches": held("serve caches", a2 - a1,
                                     specs["caches"])}
        tokens = torch.as_tensor(lm_tokens(SERVE_BATCH, SERVE_PROMPT,
                                           cfg.vocab, seed=0),
                                 device=dev).long()
        bare = make_caches(cfg, SERVE_BATCH, SERVE_PROMPT, dev, smoke=False)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.time()
        lm, cm = make_prefill_step(cfg, mesh=mesh)(params, tokens, caches)
        torch.cuda.synchronize()
        mesh_s = time.time() - t0
        launches = dict(build.LAUNCHES)
        t0 = time.time()
        ln, cn = make_prefill_step(cfg)(params, tokens, bare)
        torch.cuda.synchronize()
        bare_s = time.time() - t0
        same = bool(torch.equal(lm, ln)) and all(
            torch.equal(a, b) for a, b in zip(inputs.leaves(cm),
                                              inputs.leaves(cn)))
        serve_line.update(prefill_bitwise=same, flash_launches=launches.get(
            "flash_attention", 0), expected_launches=flash_layers(cfg),
            prefill_mesh_s=mesh_s, prefill_s=bare_s)
        check("mesh_census", same, "the mesh prefill is not bitwise the "
              "prefill without a mesh")
        check("launches", serve_line["flash_launches"] == flash_layers(cfg),
              f"mesh prefill: flash launches {launches}")
        out["serve"] = serve_line
        del params, caches, bare, lm, cm, ln, cn, tokens

        tcfg = dataclasses.replace(
            cut_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS),
            clients_per_pod=TRAIN_KW["n_clients"])
        e, c = TRAIN_KW["n_edges"], TRAIN_KW["n_clients"]
        tshape = InputShape("train_line", TRAIN_KW["seq"],
                            e * c * TRAIN_KW["batch"], "train")
        tspecs = inputs.input_specs(tcfg, tshape, mesh)
        check("mesh_census", inputs.fl_dims(tcfg, tshape, mesh)
              == (e, c, TRAIN_KW["batch"]), "the train line's FL dims")
        torch.cuda.empty_cache()
        a0 = allocated()
        base = make_params(tcfg, 0, dev)
        params = tree_map(lambda x: x[None, None].expand(
            (e, c) + tuple(x.shape)).contiguous(), base)
        del base
        a1 = allocated()
        dev_hist, glob_hist = init_fl_histories(params)
        a2 = allocated()
        counts = [tspecs["glob_hist"].n_obs, tspecs["glob_hist"].miss_count]
        glob = [tspecs["glob_hist"].prev_w, tspecs["glob_hist"].delta_mean]
        f32 = 4 / tcfg.torch_param_dtype.itemsize
        out["train"] = {
            "arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "edges": e,
            "clients": c, "batch": TRAIN_KW["batch"],
            "seq": TRAIN_KW["seq"],
            "params": held("train params", a1 - a0, tspecs["params"]),
            "histories": held(
                "train histories", a2 - a1,
                [tspecs["dev_hist"], glob, counts],
                extra=int(inputs.census(glob, mesh) * (f32 - 1))),
            "glob_hist_float32": True}
        del params, dev_hist, glob_hist
        torch.cuda.empty_cache()
    finally:
        if started:
            dist.destroy_process_group()

    import types
    card = torch.cuda.get_device_properties(0).total_memory
    prod = {"16x16": {"data": 16, "model": 16},
            "2x16x16": {"pod": 2, "data": 16, "model": 16}}
    pairs = []
    for arch in ARCH_IDS:
        for sname, s in INPUT_SHAPES.items():
            if not dryrun.applicable(arch, sname)[0]:
                continue
            for mname, ext in prod.items():
                ns = types.SimpleNamespace(shape=ext)
                split = dryrun.split_census(
                    inputs.input_specs(get_config(arch), s, ns), ns)
                pairs.append({"arch": arch, "shape": sname, "mesh": mname,
                              "argument_bytes": sum(split.values())})
    within = [p for p in pairs if p["argument_bytes"] <= card]
    out["dry_run"] = {
        "pairs": len(pairs), "arguments_within_card": len(within),
        "card_bytes": card,
        "largest_arguments_within_card": max(
            within, key=lambda p: p["argument_bytes"]),
        "largest_arguments": max(pairs, key=lambda p: p["argument_bytes"])}
    out["peaks"] = census_peaks(torch, dryrun)
    emit({"mesh_census": out})
    return out


def requested_now(torch) -> int:
    """The bytes the card's caching allocator holds for the program now."""
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def warm_gemms(torch) -> None:
    """A float32 and a bfloat16 GEMM on the card: cuBLAS's workspaces."""
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones((512, 512), dtype=dtype, device="cuda")
        (a @ a).sum().item()


def card_peaks(torch, step, x, argument: int) -> dict:
    """The card's side of a peak case: the workspace term (what warm-up
    GEMMs and one warm-up run of the plain step on ``x`` leave behind),
    then ``step(x, mode)`` under "torch" and "auto", each's requested peak
    above what was held before it, plus the ``argument`` bytes that
    placing ``x`` asked for."""
    h = requested_now(torch)
    warm_gemms(torch)
    out = step(x, "torch")
    del out
    out = {"workspace": requested_now(torch) - h}
    for mode in ("torch", "auto"):
        torch.cuda.reset_peak_memory_stats()
        h0 = requested_now(torch)
        res = step(x, mode)
        torch.cuda.synchronize()
        out[mode] = torch.cuda.memory_stats()[
            "requested_bytes.all.peak"] - h0 + argument
        del res
    return out


def held_peak(phase: str, label: str, pred: dict, ctrl: dict, card: dict,
              argument: int, n_args: int) -> dict:
    """The line of a peak case and its checks: the tracker's peak within
    MEMORY_BOUND of the card's plain peak, its arguments within
    CENSUS_ROUNDING bytes a tensor of the bytes placing them asked for,
    the frees-ignored control outside the bound."""
    got = card["torch"]
    line = {"predicted": pred["peak"], "measured": got,
            "rel": (pred["peak"] - got) / got,
            "argument": pred["argument"], "argument_requested": argument,
            "output": pred["output"], "temp": pred["temp"],
            "control": ctrl["peak"], "control_rel": (ctrl["peak"] - got)
            / got, "workspace": card["workspace"],
            "kernel_path_measured": card["auto"], "bound": MEMORY_BOUND}
    check(phase, abs(pred["peak"] - got) <= MEMORY_BOUND * got,
          f"{label}: the predicted peak is off the card's: {line}")
    check(phase, abs(pred["argument"] - argument)
          <= CENSUS_ROUNDING * n_args, f"{label}: the tracker's arguments "
          f"are not what placing them asked for: {line}")
    check(phase, abs(ctrl["peak"] - got) > MEMORY_BOUND * got,
          f"{label}: the tracker with its frees ignored reads within the "
          f"bound: {line}")
    return line


def peak_case(torch, dryrun, label: str, cfg, shape, make) -> dict:
    """One card's peak case: ``make()`` places the inputs of the plain
    step of ``shape``'s kind (``dryrun.run_step``, no mesh) on the card;
    the tracker runs it on meta tensors of the same shapes and dtypes
    (``dryrun.materialize``), with and without its frees; the card runs
    it (``card_peaks``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    h = requested_now(torch)
    x = make()
    argument = requested_now(torch) - h

    def step(x, mode):
        return dryrun.run_step(cfg, shape, None, x, kernel_mode=mode)

    meta = dryrun.materialize(x, "meta")
    t0 = time.time()
    pred = dryrun.track(lambda m: step(m, "torch"), meta)
    tracker_s = time.time() - t0
    ctrl = dryrun.track(lambda m: step(m, "torch"), meta, frees=False)
    card = card_peaks(torch, step, x, argument)
    n = sum(1 for _ in dryrun.tensors_of(x))
    del x
    torch.cuda.empty_cache()
    return {**held_peak("mesh_census", label, pred, ctrl, card, argument,
                        n),
            "tracker_s": tracker_s}


def census_peaks(torch, dryrun) -> dict:
    """``mesh_census``'s peak cases: danube's serve prefill at the serve
    cell's shape, the TRAIN_LAYERS-layer train line (TRAIN_KW), and
    MESH_STEPS_MOE's prefill cut as ``mesh_steps`` cuts it (MLA and
    MoE)."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.data import lm_tokens
    from repro_torch.launch.serve import make_caches, make_params
    from repro_torch.launch.steps import init_fl_histories
    from repro_torch.models.config import InputShape
    from repro_torch.optim.sgd import tree_map

    def prefill(cfg, b, s):
        def make():
            return {"params": make_params(cfg, 0, "cuda"),
                    "tokens": torch.as_tensor(
                        lm_tokens(b, s, cfg.vocab, seed=0),
                        device="cuda").long(),
                    "caches": make_caches(cfg, b, s, "cuda", smoke=False)}
        return make

    out = {}
    cfg = get_config(SERVE_ARCH)
    out["serve"] = peak_case(torch, dryrun, "serve prefill", cfg,
                             InputShape("serve", SERVE_PROMPT, SERVE_BATCH,
                                        "prefill"),
                             prefill(cfg, SERVE_BATCH, SERVE_PROMPT))
    tcfg = dataclasses.replace(
        cut_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS),
        clients_per_pod=TRAIN_KW["n_clients"])
    e, c, b, s = (TRAIN_KW["n_edges"], TRAIN_KW["n_clients"],
                  TRAIN_KW["batch"], TRAIN_KW["seq"])

    def train_inputs():
        params = tree_map(lambda x: x[None, None].expand(
            (e, c) + tuple(x.shape)).contiguous(),
            make_params(tcfg, 0, "cuda"))
        dev_hist, glob_hist = init_fl_histories(params)
        toks = torch.as_tensor(lm_tokens(e * c * b, s + 1, tcfg.vocab,
                                         seed=0), device="cuda").long()
        toks = toks.reshape(e, c, b, s + 1)
        return {"params": params, "dev_hist": dev_hist,
                "glob_hist": glob_hist,
                "batch": {"tokens": toks[..., :-1].contiguous(),
                          "labels": toks[..., 1:].contiguous()},
                "dev_mask": torch.ones((e, c), dtype=torch.bool,
                                       device="cuda"),
                "edge_mask": torch.ones((e,), dtype=torch.bool,
                                        device="cuda"),
                "lr": 0.01}

    out["train"] = peak_case(torch, dryrun, "train line", tcfg,
                             InputShape("train", s, e * c * b, "train"),
                             train_inputs)
    mcfg = cut_depth(get_config(MESH_STEPS_MOE), MESH_STEPS_LAYERS)
    out["moe"] = peak_case(torch, dryrun, "moe prefill", mcfg,
                           InputShape("moe", MESH_STEPS_SEQ, MESH_STEPS_ROWS,
                                      "prefill"),
                           prefill(mcfg, MESH_STEPS_ROWS, MESH_STEPS_SEQ))
    for k, arch, layers in (("serve", SERVE_ARCH, None),
                            ("train", TRAIN_ARCH, TRAIN_LAYERS),
                            ("moe", MESH_STEPS_MOE, MESH_STEPS_LAYERS)):
        out[k].update(arch=arch, layers=layers)
    return out


def _mesh_state(mesh, base: dict, specs: dict):
    """Layout-A parameters and both histories as DTensors on ``mesh``,
    placed by ``specs`` (``train_input_specs``), every client slot holding
    ``base`` (flat whole tensors), in ``init_fl_histories``' cold boot:
    only this rank's chunks are made, as ``train.run`` makes them
    (``sharding.shard_leaves``, ``steps.place_fl_state``)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import flatten, place_fl_state
    pspec = {k: v.spec for k, v in flatten(specs["params"]).items()}
    return place_fl_state(shd.shard_leaves(iter(base.items()), pspec, mesh,
                                           lead=2), specs, mesh)


def _flash_heads(shapes) -> dict:
    """{kernel: sorted [(H, Hkv), ...]} of a ``shape_launches`` Counter."""
    out: dict = {}
    for key, n in shapes.items():
        if n:
            out.setdefault(key[0], set()).add((key[4], key[5]))
    return {k: sorted(v) for k, v in out.items()}


def mesh_train_rank(torch, build, kern, mesh) -> dict:
    """One rank's ``make_hfl_train_step`` on the mesh (see MESH_STEPS_*).
    Step 1 keeps each gradient leaf whole as the step takes it (its
    ``_Shards.grad`` wrapped to gather it first), and a rank at model
    coordinate 0 holds its client's against the one-card gradient of the
    same weights and tokens (``steps._client_grads``, the kernels, whole
    tensors), computed first; step 2, from the updated state, is timed,
    its launches counted (set to 0 just before, read just after) in all
    and by shape, its peak memory read."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch import inputs, steps
    from repro_torch.launch.serve import make_params
    from repro_torch.models.config import InputShape
    cfg = dataclasses.replace(
        cut_depth(get_config(TRAIN_ARCH), MESH_STEPS_LAYERS),
        param_dtype="float32", clients_per_pod=MESH_STEPS_CLIENTS)
    e, c, b, s = 1, MESH_STEPS_CLIENTS, MESH_STEPS_ROWS, MESH_STEPS_SEQ
    base = steps.flatten(make_params(cfg, 0, "cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MESH_STEPS_SEED)
    toks = torch.randint(0, cfg.vocab, (e, c, b, s + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[..., :-1].contiguous(),
             "labels": toks[..., 1:].contiguous()}
    client = mesh.get_local_rank("data")
    lead = mesh.get_local_rank("model") == 0
    out = {"client": client, "arch": TRAIN_ARCH, "layers": MESH_STEPS_LAYERS,
           "clients": c, "rows": b, "seq": s, "dtype": "float32"}
    if lead:
        torch.cuda.synchronize()
        t0 = time.time()
        loss, want = steps._client_grads(
            steps.unflatten(base), batch["tokens"][0, client],
            batch["labels"][0, client], cfg, remat=True, n_micro=1,
            kernel_mode="auto")
        torch.cuda.synchronize()
        out["one_card_loss"], out["one_card_s"] = loss.item(), \
            time.time() - t0
        # one precision up: the same weights in float64 (plain attention)
        _, exact = steps._client_grads(
            steps.unflatten({k: v.double() for k, v in base.items()}),
            batch["tokens"][0, client], batch["labels"][0, client],
            dataclasses.replace(cfg, param_dtype="float64"), remat=True,
            n_micro=1, kernel_mode="torch")
        out["one_card_err"], out["one_card_err_leaf"] = worst_leaf(want,
                                                                   exact)
    specs = inputs.train_input_specs(
        cfg, InputShape("mesh_steps", s, e * c * b, "train"), mesh)
    state = _mesh_state(mesh, base, specs)
    del base
    args = _mesh_batch(torch, mesh, specs, batch)
    step = steps.make_hfl_train_step(cfg, mesh=mesh, kernel_mode="auto")
    got, sound = {}, steps._Shards.grad

    def grad(self, key, g):
        whole = g.full_tensor()
        if lead:
            got[key] = whole
        return sound(self, key, g)

    steps._Shards.grad = grad
    try:
        *_, loss = step(*state, *args, 0.01)
    finally:
        steps._Shards.grad = sound
    out["loss"] = loss.item()
    if lead:
        out["grad_rel_one_card"], _ = worst_leaf(got, want)
        out["grad_worst_rel"], out["grad_worst_leaf"] = worst_leaf(got,
                                                                   exact)
        del exact
    del got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with shape_launches(kern, build) as shapes:
        t0 = time.time()
        step(*state, *args, 0.01)
        torch.cuda.synchronize()
        out["wall_s"] = time.time() - t0
    out["launches"] = dict(build.LAUNCHES)
    out["flash_heads"] = _flash_heads(shapes)
    out["launches_by_shape"] = [[*k, n] for k, n in shapes.items()]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _mesh_batch(torch, mesh, specs, batch, device: str = "cuda"):
    """The train step's batch, masks (every client present) and edge mask
    placed on ``mesh`` by ``specs``."""
    from repro_torch.launch import sharding as shd
    e, c = specs["dev_mask"].shape
    return shd.place(
        (batch, torch.ones((e, c), dtype=torch.bool, device=device),
         torch.ones((e,), dtype=torch.bool, device=device)),
        ({k: specs["batch"][k] for k in batch}, specs["dev_mask"],
         specs["edge_mask"]), mesh)


def mesh_serve_rank(torch, build, kern, mesh, arch: str, gen: int,
                    dtype: str = "bfloat16") -> dict:
    """One rank's prefill in ``dtype`` of ``arch`` (full width,
    MESH_STEPS_LAYERS layers, MESH_STEPS_ROWS x MESH_STEPS_SEQ tokens) and
    ``gen`` teacher-forced decode steps on the mesh, timed, launches
    counted; rank 0 reads every step's logits (gathered whole) against the
    one-card steps on the same weights (bf16 ones), caches and tokens, run
    first in ``dtype`` and with the weights upcast one precision up."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch import inputs
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import make_caches, make_params
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import cache_specs, init_from_specs
    from repro_torch.models.config import InputShape
    from repro_torch.optim.sgd import tree_map
    cfg = dataclasses.replace(cut_depth(get_config(arch), MESH_STEPS_LAYERS),
                              param_dtype=dtype)
    b, s = MESH_STEPS_ROWS, MESH_STEPS_SEQ
    params = make_params(dataclasses.replace(cfg, param_dtype="bfloat16"), 0,
                         "cuda")
    params = tree_map(lambda t: t.to(cfg.torch_param_dtype), params)
    gen_ = torch.Generator(device="cuda")
    gen_.manual_seed(MESH_STEPS_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (b, s + gen), generator=gen_,
                         device="cuda")
    out = {"arch": arch, "layers": MESH_STEPS_LAYERS, "rows": b,
           "prompt": s, "gen": gen, "dtype": dtype}
    ref = {}
    if mesh.get_rank() == 0:
        # the one-card steps, and again one precision up (bf16 -> float32,
        # float32 -> float64), the same weights upcast
        up = "float64" if dtype == "float32" else "float32"
        for name, c in (("one_card", cfg), (
                "up", dataclasses.replace(cfg, param_dtype=up))):
            p = tree_map(lambda t: t.to(c.torch_param_dtype), params)
            caches = init_from_specs(cache_specs(
                c, b, s + gen, dtype=c.torch_param_dtype), None, "cuda")
            mode = "torch" if up == "float64" and name == "up" else "auto"
            lg, caches = make_prefill_step(c, mode)(p, toks[:, :s], caches)
            ref[name] = [lg.double()]
            for i in range(gen):
                lg, caches = make_serve_step(c)(
                    p, toks[:, s + i:s + i + 1], s + i, caches)
                ref[name].append(lg.double())
            del caches
    specs = inputs.serve_input_specs(
        cfg, InputShape("mesh_steps", s + gen, b, "prefill"), mesh)
    dparams, dcaches = shd.place(
        (params, make_caches(cfg, b, s + gen, "cuda",
                             smoke=dtype == "float32")),
        (specs["params"], specs["caches"]), mesh)
    del params
    prefill = make_prefill_step(cfg, "auto", mesh=mesh)
    decode = make_serve_step(cfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    logits, walls = [], []
    with shape_launches(kern, build) as shapes:
        for i in range(gen + 1):
            tok = shd.place(toks[:, :s] if i == 0
                            else toks[:, s + i - 1:s + i], specs["tokens"],
                            mesh)
            t0 = time.time()
            if i == 0:
                lg, dcaches = prefill(dparams, tok, dcaches)
            else:
                lg, dcaches = decode(dparams, tok, s + i - 1, dcaches)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            logits.append(lg.full_tensor())
    out["launches"] = dict(build.LAUNCHES)
    out["flash_heads"] = _flash_heads(shapes)
    out["launches_by_shape"] = [[*k, n] for k, n in shapes.items()]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["prefill_s"] = walls[0]
    out["decode_s"] = walls[1:]
    if ref:
        def rel(got, want):
            return [((g.double() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got, want)]
        out["logits_rel_up"] = rel(logits, ref["up"])
        out["one_card_rel_up"] = rel(ref["one_card"], ref["up"])
        out["logits_rel_one_card"] = rel(logits, ref["one_card"])
        out["finite"] = all(bool(torch.isfinite(g).all()) for g in logits)
    return out


def mesh_steps_rank(argv: list) -> int:
    """One rank of ``mesh_steps`` (``--mesh-steps-rank R --mesh-world W
    --mesh-port P --mesh-out DIR``): joins the group
    (``launch.mesh.start_group``: collectives through host memory), runs
    ``mesh_train_rank`` and ``mesh_serve_rank`` (danube with decode, then
    MESH_STEPS_MOE's prefills) on ``make_debug_mesh(**MESH_STEPS_MESH)``
    over the card, and writes its record (the collectives carried, by
    kind) to DIR.  The kernels are built by the parent first."""
    import torch
    import torch.distributed as dist
    arg = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(arg["--mesh-steps-rank"]), int(arg["--mesh-world"])
    out = Path(arg["--mesh-out"])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import (StagedGroup, make_debug_mesh,
                                         start_group)
    kern = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.cuda.set_device(0)
    start_group(rank, world, int(arg["--mesh-port"]),
                timeout_s=MESH_RANK_TIMEOUT)
    try:
        mesh = make_debug_mesh(**MESH_STEPS_MESH)
        build.library()
        rec = {"rank": rank, "coords": {a: mesh.get_local_rank(a)
                                        for a in mesh.mesh_dim_names},
               "device": f"cuda:{torch.cuda.current_device()}"}
        t0 = time.time()
        rec["train"] = mesh_train_rank(torch, build, kern, mesh)
        rec["serve"] = mesh_serve_rank(torch, build, kern, mesh, SERVE_ARCH,
                                       MESH_STEPS_GEN)
        rec["serve_f32"] = mesh_serve_rank(torch, build, kern, mesh,
                                           SERVE_ARCH, MESH_STEPS_GEN_F32,
                                           "float32")
        rec["moe"] = mesh_serve_rank(torch, build, kern, mesh,
                                     MESH_STEPS_MOE, 0)
        rec["moe_f32"] = mesh_serve_rank(torch, build, kern, mesh,
                                         MESH_STEPS_MOE, 0, "float32")
        rec["rank_s"] = time.time() - t0
        carried: dict = {}
        for (kind, what), n in StagedGroup.CARRIED.items():
            carried.setdefault(kind, {})[what] = n
        rec["carried"] = carried
        (out / f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_steps(torch, build) -> dict:
    """The LLM steps on a mesh of MESH_STEPS_WORLD ranks sharing the card
    (``mesh_steps_rank``), each a process of this script started after the
    kernels are built.  Every rank must exit 0 (a rank's failure fails the
    phase, nothing caught); every rank launches the flash forward (and in
    training the backward) at its local head count (the heads over
    ``model``: danube 32/8 -> 16/4, deepseek's MLA 16 -> 8); the ranks at
    model coordinate 0 hold their client's gradients to the one-card ones,
    the mean of their one-card losses is the mesh step's, rank 0's
    logits stand as near the one-precision-up logits as the one-card ones
    do, and its float32 logits as near the one-card float32 logits, each
    by the bounds of MESH_STEPS_*.  Prints one line a rank (wall s,
    launches, peak memory, the collectives each kind carried and by what)
    and a summary; returns rank 0's train and serve records."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "mesh_steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    port = free_port()
    wall = run_procs("mesh_steps", out, {
        f"rank{r}": ["--mesh-steps-rank", r, "--mesh-world",
                     MESH_STEPS_WORLD, "--mesh-port", port, "--mesh-out", out]
        for r in range(MESH_STEPS_WORLD)})
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(MESH_STEPS_WORLD)]
    from repro_torch.configs import get_config
    heads = {}
    for arch, kind in ((TRAIN_ARCH, "attn"), (MESH_STEPS_MOE, "mla")):
        h, hkv, _ = attn_heads(get_config(arch), kind)
        m = MESH_STEPS_MESH["model"]
        heads[arch] = [[h // m, hkv // m]]
    for rec in recs:
        emit({"mesh_steps_rank": rec})
        tr, sv, moe = rec["train"], rec["serve"], rec["moe"]
        check("launches", tr["flash_heads"].get("flash_attention")
              == heads[TRAIN_ARCH]
              and tr["flash_heads"].get("flash_attention_bwd")
              == heads[TRAIN_ARCH],
              f"mesh_steps rank {rec['rank']} train: flash launches by "
              f"heads {tr['flash_heads']}, expected {heads[TRAIN_ARCH]}")
        for part, arch in ((sv, TRAIN_ARCH), (rec["serve_f32"], TRAIN_ARCH),
                           (moe, MESH_STEPS_MOE),
                           (rec["moe_f32"], MESH_STEPS_MOE)):
            check("launches", part["flash_heads"].get("flash_attention")
                  == heads[arch] and not part["launches"].get(
                      "flash_attention_bwd"),
                  f"mesh_steps rank {rec['rank']} {arch}: flash launches "
                  f"by heads {part['flash_heads']}, expected {heads[arch]}")
        if "grad_worst_rel" in tr:
            bound = max(MESH_STEPS_GRAD_REL,
                        MESH_STEPS_SPREAD * tr["one_card_err"])
            check("mesh_steps", tr["grad_worst_rel"] <= bound,
                  f"rank {rec['rank']} client {tr['client']}: gradient "
                  f"{tr['grad_worst_leaf']} {tr['grad_worst_rel']} of its "
                  f"largest from float64 > {bound} (the one-card float32 "
                  f"gradient's: {tr['one_card_err']})")
    one_card = float(np.mean([r["train"]["one_card_loss"] for r in recs
                              if "one_card_loss" in r["train"]]))
    loss_rel = abs(recs[0]["train"]["loss"] - one_card) / abs(one_card)
    check("mesh_steps", loss_rel <= MESH_STEPS_LOSS_REL,
          f"loss {recs[0]['train']['loss']} against the one-card "
          f"{one_card}: {loss_rel}")
    for part, floor in (("serve_f32", MESH_STEPS_F32_REL),
                        ("moe_f32", MESH_STEPS_F32_REL),
                        ("serve", SERVE_REL_TOL), ("moe", SERVE_REL_TOL)):
        r0 = recs[0][part]
        bound = max(floor, MESH_STEPS_SPREAD * max(r0["one_card_rel_up"]))
        check("mesh_steps", r0["finite"]
              and max(r0["logits_rel_up"]) <= bound,
              f"{r0['arch']} {r0['dtype']} logits from one precision up: "
              f"{r0['logits_rel_up']} > {bound} (the one-card "
              f"{r0['dtype']} logits': {r0['one_card_rel_up']})")
        check("mesh_steps", r0["dtype"] != "float32"
              or max(r0["logits_rel_one_card"]) <= bound,
              f"{r0['arch']} float32 logits from the one-card float32 "
              f"logits: {r0['logits_rel_one_card']} > {bound}")
    summary = {
        "world": MESH_STEPS_WORLD, "mesh": MESH_STEPS_MESH, "wall_s": wall,
        "loss": recs[0]["train"]["loss"], "one_card_loss": one_card,
        "loss_rel": loss_rel,
        **{k: max(r["train"][k] for r in recs if k in r["train"])
           for k in ("grad_worst_rel", "one_card_err",
                     "grad_rel_one_card")},
        **{f"{p}_{k}": max(recs[0][p][k])
           for p in ("serve", "serve_f32", "moe", "moe_f32")
           for k in ("logits_rel_up", "one_card_rel_up",
                     "logits_rel_one_card")},
        "tolerances": {"grad": [MESH_STEPS_GRAD_REL, MESH_STEPS_SPREAD],
                       "loss": MESH_STEPS_LOSS_REL,
                       "logits": [MESH_STEPS_F32_REL, SERVE_REL_TOL,
                                  MESH_STEPS_SPREAD]},
        "backend": {kind: "gloo on host copies (launch.mesh.StagedGroup)"
                    for kind in recs[0]["carried"]},
        "rank_wall_s": [r["rank_s"] for r in recs],
        "train_step_s": [r["train"]["wall_s"] for r in recs],
        "peak_memory_gb": [max(r[p]["peak_memory_gb"] for p in
                               ("train", "serve", "serve_f32", "moe",
                                "moe_f32"))
                           for r in recs]}
    emit({"mesh_steps": summary})
    return {"train": recs[0]["train"], "serve": recs[0]["serve"]}


def _memory_state(torch, mesh, device: str):
    """``mesh_memory``'s step and its inputs on ``mesh``, as
    ``mesh_train_rank`` places them: the float32 HFL step of TRAIN_ARCH
    cut to MEMORY_LAYERS layers, one edge of MESH_STEPS_CLIENTS clients
    of MESH_STEPS_ROWS x MESH_STEPS_SEQ tokens; on ``device`` ("cuda", or
    "meta" for the prediction: the weights' shapes and dtypes only)."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch import inputs, steps
    from repro_torch.launch.serve import make_params
    from repro_torch.models import param_specs
    from repro_torch.models.config import InputShape
    from repro_torch.models.spec import ParamSpec
    cfg = dataclasses.replace(
        cut_depth(get_config(TRAIN_ARCH), MEMORY_LAYERS),
        param_dtype="float32", clients_per_pod=MESH_STEPS_CLIENTS)
    e, c, b, s = 1, MESH_STEPS_CLIENTS, MESH_STEPS_ROWS, MESH_STEPS_SEQ

    def empty(tree):
        if isinstance(tree, ParamSpec):
            return torch.empty(tree.shape, dtype=cfg.torch_param_dtype,
                               device="meta")
        return {k: empty(v) for k, v in sorted(tree.items())}

    base = steps.flatten(empty(param_specs(cfg)) if device == "meta"
                         else make_params(cfg, 0, device))
    specs = inputs.train_input_specs(
        cfg, InputShape("mesh_memory", s, e * c * b, "train"), mesh)
    state = _mesh_state(mesh, base, specs)
    del base
    toks = torch.zeros((e, c, b, s), dtype=torch.long, device=device)
    args = _mesh_batch(torch, mesh, specs,
                       {"tokens": toks, "labels": toks.clone()}, device)

    def step(x, mode):
        return steps.make_hfl_train_step(cfg, mesh=mesh, kernel_mode=mode)(
            *x[0], *x[1], 0.01)

    return step, (state, args)


def mesh_memory_rank(argv: list) -> int:
    """One rank of ``mesh_memory`` (``--mesh-memory-rank R --mesh-world W
    --mesh-port P --mesh-out DIR``): joins the group (``start_group``),
    places the step's inputs on ``make_debug_mesh(**MEMORY_MESH)``, runs
    ``card_peaks`` and writes its record to DIR.  The kernels are built by
    the parent first."""
    import torch
    import torch.distributed as dist
    arg = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(arg["--mesh-memory-rank"]), int(arg["--mesh-world"])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_debug_mesh, start_group
    torch.cuda.set_device(0)
    start_group(rank, world, int(arg["--mesh-port"]),
                timeout_s=MESH_RANK_TIMEOUT)
    try:
        mesh = make_debug_mesh(**MEMORY_MESH)
        build.library()
        torch.cuda.empty_cache()
        h = requested_now(torch)
        step, x = _memory_state(torch, mesh, "cuda")
        argument = requested_now(torch) - h
        rec = {"rank": rank, "argument": argument,
               **card_peaks(torch, step, x, argument)}
        Path(arg["--mesh-out"], f"rank{rank}.json").write_text(
            json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_memory_predict(argv: list) -> int:
    """``mesh_memory``'s prediction (``--mesh-memory-predict DIR``): the
    dry-run's tracker (``launch.dryrun.track``, with and without its
    frees) over rank 0's step on a fake group of MEMORY_WORLD ranks, its
    inputs on the meta device; written to DIR.  Touches no card."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    dryrun.start_fake_group(MEMORY_WORLD)
    try:
        mesh = make_debug_mesh(**MEMORY_MESH)
        step, x = _memory_state(torch, mesh, "meta")
        t0 = time.time()
        rec = {"predicted": dryrun.track(lambda m: step(m, "torch"), x)}
        rec["tracker_s"] = time.time() - t0
        rec["control"] = dryrun.track(lambda m: step(m, "torch"), x,
                                      frees=False)
        rec["n_args"] = len(dryrun.tensors_of(x))
        for k in ("predicted", "control"):
            rec[k].pop("collectives")
        Path(argv[argv.index("--mesh-memory-predict") + 1],
             "predict.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_memory(torch, build) -> dict:
    """Case (d) of the dry-run's peak held to the card: MEMORY_WORLD ranks
    of MEMORY_MESH sharing the card (``mesh_memory_rank``, host-staged
    collectives) against the tracker's prediction for a rank on a fake
    group (``mesh_memory_predict``), each a process of this script started
    after the kernels are built.  Every process must exit 0; each rank's
    plain peak within MEMORY_BOUND of the prediction, the frees-ignored
    control outside it (``held_peak``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "mesh_memory"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    port = free_port()
    wall = run_procs("mesh_memory", out, {
        "predict": ["--mesh-memory-predict", out],
        **{f"rank{r}": ["--mesh-memory-rank", r, "--mesh-world",
                        MEMORY_WORLD, "--mesh-port", port, "--mesh-out", out]
           for r in range(MEMORY_WORLD)}})
    pred = json.loads((out / "predict.json").read_text())
    line = {"world": MEMORY_WORLD, "mesh": MEMORY_MESH, "arch": TRAIN_ARCH,
            "layers": MEMORY_LAYERS, "clients": MESH_STEPS_CLIENTS,
            "rows": MESH_STEPS_ROWS, "seq": MESH_STEPS_SEQ,
            "dtype": "float32", "wall_s": wall,
            "tracker_s": pred["tracker_s"], "ranks": []}
    for r in range(MEMORY_WORLD):
        card = json.loads((out / f"rank{r}.json").read_text())
        line["ranks"].append(held_peak(
            "mesh_memory", f"rank {r}", pred["predicted"], pred["control"],
            card, card["argument"], pred["n_args"]))
    emit({"mesh_memory": line})
    return line


@contextlib.contextmanager
def edge_losses(train):
    """While open, the loss of every edge round ``train.run`` steps
    (floats, in order), read from the step ``make_hfl_train_step``
    builds."""
    seen, make = [], train.make_hfl_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def wrapped(*args):
            out = step(*args)
            seen.append(float(out[-1]))
            return out
        return wrapped

    train.make_hfl_train_step = recording
    try:
        yield seen
    finally:
        train.make_hfl_train_step = make


def _run_record(res: dict, losses: list) -> dict:
    """A ``train.run`` result as JSON, its edge rounds' losses beside."""
    return {**{k: v if k == "mesh" else np.asarray(v).tolist()
               for k, v in res.items()}, "edge_losses": losses}


def mesh_setup(torch, train, mesh, device) -> dict:
    """One rank's setup peak: the allocator's requested bytes while
    ``train.mesh_state`` builds the rank's shard of MESH_TRAIN_KW's state
    (``train.run``'s own setup), above what was held before, against its
    placed state, the largest whole leaf (float32, as drawn) and the whole
    model."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch.inputs import leaves
    from repro_torch.models import param_specs
    from repro_torch.models.spec import iter_specs
    kw = MESH_TRAIN_KW
    cfg = dataclasses.replace(
        cut_depth(get_config(TRAIN_ARCH), kw["n_layers"]),
        param_dtype=kw["param_dtype"], clients_per_pod=kw["n_clients"])
    specs = train.mesh_specs(cfg, mesh, edges=kw["n_edges"],
                             clients=kw["n_clients"], batch=kw["batch"],
                             seq=kw["seq"])
    torch.cuda.empty_cache()
    h0 = requested_now(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = train.mesh_state(cfg, mesh, specs, seed=0, device=device)
    torch.cuda.synchronize()
    out = {"seconds": time.time() - t0,
           "peak": torch.cuda.memory_stats()["requested_bytes.all.peak"]
           - h0, "held": requested_now(torch) - h0}
    ts = leaves(state)
    out["placed"] = sum(t.to_local().numel() * t.to_local().element_size()
                        for t in ts)
    out["tensors"] = len(ts)
    sizes = [math.prod(sp.shape) * 4 for _, sp in
             iter_specs(param_specs(cfg))]
    out["largest_leaf"], out["whole_model"] = max(sizes), sum(sizes)
    out["bound"] = out["placed"] + out["largest_leaf"] \
        + CENSUS_ROUNDING * out["tensors"]
    out["control"] = out["placed"] + out["whole_model"]
    del state, ts
    torch.cuda.empty_cache()
    return out


def mesh_run_rank(argv: list) -> int:
    """One rank of ``mesh_train`` (``--mesh-train-rank R --mesh-world W
    --mesh-port P --mesh-backend B --mesh-out DIR``): joins the group
    (``start_group(backend=B)``; W = MESH_STEPS_WORLD ranks of
    MESH_STEPS_MESH, or one rank), reads its setup peak (``mesh_setup``),
    then runs ``train.run(**MESH_TRAIN_KW, mesh=...)`` with its launches
    counted (set to 0 just before, read just after, by shape too) and
    writes its record to DIR.  The kernels are built by the parent
    first."""
    import torch
    import torch.distributed as dist
    arg = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(arg["--mesh-train-rank"]), int(arg["--mesh-world"])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh, start_group
    kern = importlib.import_module("repro_torch.kernels.flash_attention")
    if arg["--mesh-backend"] == "staged":
        torch.cuda.set_device(0)
    group = start_group(rank, world, int(arg["--mesh-port"]),
                        backend=arg["--mesh-backend"],
                        timeout_s=MESH_RANK_TIMEOUT)
    try:
        mesh = make_debug_mesh(**(MESH_STEPS_MESH if world > 1 else {}))
        build.library()
        dev = torch.device("cuda", torch.cuda.current_device())
        rec = {"rank": rank, "world": world, "backend": group.backend,
               "reason": group.reason, "device": str(dev),
               "coords": {a: mesh.get_local_rank(a)
                          for a in mesh.mesh_dim_names}}
        rec["setup"] = mesh_setup(torch, train, mesh, dev)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        with shape_launches(kern, build) as shapes, \
                edge_losses(train) as losses:
            t0 = time.time()
            res = train.run(TRAIN_ARCH, **MESH_TRAIN_KW, mesh=mesh,
                            device="cuda")
            rec["wall_s"] = time.time() - t0
        rec["launches"] = dict(build.LAUNCHES)
        rec["flash_heads"] = _flash_heads(shapes)
        rec["run"] = _run_record(res, losses)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        Path(arg["--mesh-out"], f"rank{rank}_of{world}.json").write_text(
            json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_train(torch, build, train) -> dict:
    """``train.run`` on a mesh through its entry point (see MESH_TRAIN_KW):
    MESH_STEPS_WORLD staged ranks sharing the card and one NCCL rank, each
    a process of this script (``mesh_run_rank``) started after the kernels
    are built, while this process runs the one-card references: the run
    twice (its repeat spread) and once in float64 (plain attention).  Every
    process must exit 0 (a rank's failure fails the phase, nothing
    caught), every rank launch the flash forward and backward at its local
    head count, hold its setup peak to its bound, and return what the
    one-card run returns within the bounds of MESH_TRAIN_KW's comment.
    Prints one line a rank and a summary."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "mesh_train"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.time()
    port, port1 = free_port(), free_port()
    argvs = {f"staged{r}": ["--mesh-train-rank", r, "--mesh-world",
                            MESH_STEPS_WORLD, "--mesh-port", port,
                            "--mesh-backend", "staged", "--mesh-out", out]
             for r in range(MESH_STEPS_WORLD)}
    argvs["nccl0"] = ["--mesh-train-rank", 0, "--mesh-world", 1,
                      "--mesh-port", port1, "--mesh-backend", "nccl",
                      "--mesh-out", out]
    ref = {}

    def references():
        for name, kw in (("one_card", {}), ("repeat", {}), ("float64", dict(
                param_dtype="float64", kernel_mode="torch"))):
            with edge_losses(train) as losses:
                res = train.run(TRAIN_ARCH, **{**MESH_TRAIN_KW, **kw},
                                device="cuda")
            ref[name] = _run_record(res, losses)

    wall = run_procs("mesh_train", out, argvs, during=references)
    recs = [json.loads((out / f"rank{r}_of{MESH_STEPS_WORLD}.json")
                       .read_text()) for r in range(MESH_STEPS_WORLD)]
    recs.append(json.loads((out / "rank0_of1.json").read_text()))
    one, rep, up = ref["one_card"], ref["repeat"], ref["float64"]

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    one_up = rel(one["edge_losses"], up["edge_losses"])
    bound = [max(MESH_STEPS_LOSS_REL, MESH_STEPS_SPREAD * x) for x in one_up]
    spread = rel(rep["edge_losses"], one["edge_losses"])
    from repro_torch.configs import get_config
    h, hkv, _ = attn_heads(get_config(TRAIN_ARCH), "attn")
    layers, k_edge = MESH_TRAIN_KW["n_layers"], MESH_TRAIN_KW["k_edge"]
    for rec in recs:
        who = f"mesh_train {rec['backend']} rank {rec['rank']}"
        m = MESH_STEPS_MESH["model"] if rec["world"] > 1 else 1
        clients = MESH_TRAIN_KW["n_clients"] // (
            MESH_STEPS_MESH["data"] if rec["world"] > 1 else 1)
        steps = layers * k_edge * clients
        emit({"mesh_train_rank": rec})
        check("launches", rec["launches"].get("flash_attention") == 2 * steps
              and rec["launches"].get("flash_attention_bwd") == 3 * steps
              and rec["flash_heads"].get("flash_attention")
              == rec["flash_heads"].get("flash_attention_bwd")
              == [[h // m, hkv // m]],
              f"{who}: flash launches {rec['launches']} by heads "
              f"{rec['flash_heads']}, expected {2 * steps} forward and "
              f"{3 * steps} backward at {[h // m, hkv // m]}")
        st = rec["setup"]
        check("mesh_train", st["peak"] <= st["bound"] < st["control"]
              and st["held"] <= st["placed"] + CENSUS_ROUNDING
              * st["tensors"],
              f"{who}: setup peak {st['peak']} B against its bound "
              f"{st['bound']} (placed {st['placed']}, held {st['held']}, "
              f"largest leaf {st['largest_leaf']}), control "
              f"{st['control']}")
        run = rec["run"]
        check("mesh_train", run["sim_clock"] == one["sim_clock"]
              and (run["blocks"], run["chain_valid"]) == (one["blocks"],
                                                          one["chain_valid"])
              and run["backend"] == rec["backend"],
              f"{who}: clock {run['sim_clock']}, blocks {run['blocks']}, "
              f"chain {run['chain_valid']}, backend {run['backend']} "
              f"against the one-card {one['sim_clock']}, {one['blocks']}, "
              f"{one['chain_valid']}")
        got = rel(run["edge_losses"], one["edge_losses"])
        lim = bound if rec["world"] > 1 else spread
        check("mesh_train", len(got) == len(lim) == k_edge
              and all(g <= b for g, b in zip(got, lim)),
              f"{who}: edge losses {run['edge_losses']} against the "
              f"one-card {one['edge_losses']}: {got} > {lim}")
    staged = recs[:-1]
    check("mesh_train", [r["backend"] for r in recs]
          == ["staged"] * MESH_STEPS_WORLD + ["nccl"],
          f"backends {[r['backend'] for r in recs]}")
    check("mesh_train", all(r["run"]["edge_losses"]
                            == staged[0]["run"]["edge_losses"]
                            for r in staged),
          "the staged ranks returned different losses")
    summary = {
        "world": MESH_STEPS_WORLD, "mesh": MESH_STEPS_MESH,
        "arch": TRAIN_ARCH, **{k: MESH_TRAIN_KW[k] for k in (
            "n_layers", "n_clients", "batch", "seq", "steps", "k_edge",
            "param_dtype")},
        "wall_s": time.time() - t0, "ranks_wall_s": wall,
        "one_card": one, "repeat_rel": spread, "float64": up,
        "one_card_rel_float64": one_up, "loss_bound": bound,
        "staged_rel_one_card": rel(staged[0]["run"]["edge_losses"],
                                   one["edge_losses"]),
        "nccl_rel_one_card": rel(recs[-1]["run"]["edge_losses"],
                                 one["edge_losses"]),
        "setup": {f"{r['backend']}{r['rank']}": {
            k: r["setup"][k] for k in ("peak", "bound", "control",
                                       "placed", "largest_leaf",
                                       "whole_model", "seconds")}
            for r in recs},
        "rank_run_s": [r["wall_s"] for r in recs],
        "peak_memory_gb": [r["peak_memory_gb"] for r in recs]}
    emit({"mesh_train": summary})
    return summary


def load_driver(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_driver(torch, build, name: str, mode: str = "auto", *args) -> tuple:
    """One driver's ``main`` on the card under ``mode``, its printed lines
    kept (the last four go on its line): (its result, a line of wall
    seconds, launches, peak memory).  The launch counts are set to 0 just
    before and read just after."""
    main = load_driver(name).main
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = main(*args, device="cuda", kernel_mode=mode)
    torch.cuda.synchronize()
    line = {"driver": name, "args": list(args), "kernel_mode": mode,
            "wall_s": time.perf_counter() - t0,
            "launches": dict(build.LAUNCHES),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "printed_tail": out.getvalue().rstrip().splitlines()[-4:]}
    return res, line


def examples_phase(torch, build) -> None:
    """The eight example drivers (``EXAMPLES``) on the card under "auto" at
    the reference drivers' sizes, ``serve_batched`` for every architecture
    id; each must launch the kernels of its path, and its results are
    checked as the reference driver states them (finite rows, every block
    committed and the chain valid, the failover's survivors, a full plan,
    tokens in the vocabulary, the LLM's loss falling).  ``quickstart`` runs
    under "torch" too: its host-plane rows must equal the kernel run's and
    its accuracies lie within ``ACC_TOL`` of them.  One ``example`` line a
    run: its wall seconds, launches and peak memory."""
    from repro_torch.configs import ARCH_IDS, get_smoke

    def finish(line, need, extra):
        missing = [k for k in need if line["launches"].get(k, 0) == 0]
        check("examples", not missing,
              f"{line['driver']} {line['args']}: never launched {missing} "
              f"({line['launches']})")
        emit({"example": {**line, **extra}})

    # quickstart, with the kernels and plain
    runs = {}
    for mode in ("auto", "torch"):
        res, line = run_driver(torch, build, "quickstart", mode)
        runs[mode] = res
        check("examples", len(res["accuracy"]) == 15
              and res["blocks"] == 15 and res["chain_valid"]
              and bool(np.isfinite(res["accuracy"]).all()),
              f"quickstart {mode}: {res}")
        check("examples", mode == "auto" or not line["launches"],
              f"quickstart torch launched {line['launches']}")
        finish(line, EXAMPLES["quickstart"] if mode == "auto" else (),
               {"final_accuracy": float(res["accuracy"][-1]),
                "sim_seconds": float(res["sim_clock"][-1]),
                "blocks": res["blocks"], "k_star": res["k_star"]})
    a, p = runs["auto"], runs["torch"]
    host_equal = {k: bool(np.array_equal(a[k], p[k]))
                  for k in EXAMPLE_HOST_ROWS}
    acc_diff = float(np.abs(a["accuracy"] - p["accuracy"]).max())
    emit({"example_parity": {"driver": "quickstart",
                             "host_rows_equal": host_equal,
                             "accuracy_max_abs_diff": acc_diff,
                             "accuracy_atol": ACC_TOL}})
    check("examples", all(host_equal.values()) and acc_diff <= ACC_TOL,
          f"quickstart auto vs torch: {host_equal}, accuracy {acc_diff}")

    res, line = run_driver(torch, build, "leader_failover")
    check("examples", res["blocks"] == 16 and res["chain_valid"]
          and len(res["accuracy"]) == 16
          and res["alive"] == res["edges"] - 1
          and bool(np.isfinite(res["accuracy"]).all()),
          f"leader_failover: {res}")
    finish(line, EXAMPLES["leader_failover"],
           {"final_accuracy": float(res["accuracy"][-1]),
            "alive": res["alive"], "leader": res["leader"]})

    for name in ("latency_optimization", "sweep_grid", "sweep_topology",
                 "latency_pareto"):
        res, line = run_driver(torch, build, name)
        sw = res["sweep"]
        t = sw.accuracy.shape[1]
        ok = (bool(np.isfinite(sw.accuracy).all())
              and bool(np.isfinite(sw.sim_clock).all())
              and bool((sw.blocks == sw.t_valid).all()))
        check("examples", ok, f"{name}: accuracy {sw.accuracy}, blocks "
              f"{sw.blocks} of {sw.t_valid}")
        extra = {"points": len(sw.points), "rounds": t,
                 "best_accuracy": float(sw.accuracy.max())}
        if name == "latency_optimization":
            extra.update(k_star_empirical=res["k_star_empirical"],
                         k_star_theory=res["k_star_theory"],
                         k_star_table=res["k_star_table"])
        if name == "sweep_topology":
            extra.update(buckets=res["buckets"],
                         padding_stats={k: v for k, v in
                                        res["padding_stats"].items()
                                        if k != "buckets"})
        if name == "latency_pareto":
            extra.update(front=len(res["front"]))
        finish(line, EXAMPLES[name], extra)

    for arch in ARCH_IDS:
        res, line = run_driver(torch, build, "serve_batched", "auto", arch)
        vocab = get_smoke(arch).vocab
        toks = res["tokens"]
        check("examples", toks.shape == (4, 24)
              and bool(((toks >= 0) & (toks < vocab)).all())
              and bool(np.isfinite(res["logits"]).all()),
              f"serve_batched {arch}: tokens {toks.shape}")
        finish(line, () if arch in EXAMPLE_SERVE_NO_KERNEL
               else EXAMPLES["serve_batched"],
               {"prefill_s": res["t_prefill"], "decode_s": res["t_decode"]})

    res, line = run_driver(torch, build, "train_bhfl_llm")
    losses = np.asarray(res["losses"])
    check("examples", len(losses) == 40 and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0] and res["blocks"] == 40
          and res["chain_valid"],
          f"train_bhfl_llm: losses {losses}, blocks {res['blocks']}")
    finish(line, EXAMPLES["train_bhfl_llm"],
           {"loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "sim_seconds": float(res["sim_clock"][-1])})


@contextlib.contextmanager
def conv_launches(conv, build):
    """While open, each conv forward and backward call's launches are
    added to the yielded Counter under (kernel, D, B, H, W, Cin, Cout) of
    its input: a run's launches at each layer's shape.  The wrappers of
    module ``conv`` (which the autograd function looks up at each call) are
    swapped for counting ones and restored on exit."""
    into = collections.Counter()
    sound = {name: getattr(conv, name) for name in ("conv3x3_fwd",
                                                    "conv3x3_bwd")}

    def counted(name, x, w, *a, **kw):
        before = build.LAUNCHES[name]
        try:
            return sound[name](x, w, *a, **kw)
        finally:
            n = build.LAUNCHES[name] - before
            if n:
                into[(name, *x.shape, w.shape[-1])] += n

    for name in sound:
        setattr(conv, name, functools.partial(counted, name))
    try:
        yield into
    finally:
        for name, fn in sound.items():
            setattr(conv, name, fn)


def geometry_phase(torch, build, simulator, conv) -> dict:
    """The paper's experiment at each GEOMETRY (DEFAULT with its fields,
    T = GEOMETRY_T, GEOMETRY_KW), HieAvg with temporary stragglers at both
    layers, once with the kernels and once plain, the launch counts set to
    0 just before each run and read just after (``conv_launches`` by
    shape): every
    run's rows finite and its chain valid, the kernel run launching the
    conv kernels, the SGD update, the coefficient aggregate and the
    evaluation head and the plain run nothing, the pair within the
    engine-parity bounds with clock and energy equal.  Returns each
    geometry's kernel-run launches by conv shape."""
    from repro_torch.configs import DEFAULT
    out, t0 = {}, time.time()
    for label, fields in GEOMETRY.items():
        setting = dataclasses.replace(DEFAULT, t_global_rounds=GEOMETRY_T,
                                      **fields)
        runs = {}
        for mode in ("auto", "torch"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            sim = simulator(setting, "hieavg", "temporary", "temporary",
                            device="cuda", kernel_mode=mode, **GEOMETRY_KW)
            with conv_launches(conv, build) as shapes:
                res = sim.run()
            torch.cuda.synchronize()
            runs[mode] = (res, dict(build.LAUNCHES), shapes)
            for key in ROWS:
                row = getattr(res, key)
                check("geometry", row.shape == (GEOMETRY_T,)
                      and bool(np.isfinite(row).all()),
                      f"{label} {mode} {key}: {row}")
            check("geometry", res.blocks == GEOMETRY_T and res.chain_valid,
                  f"{label} {mode}: chain {res.blocks}")
            emit({"geometry_run": {
                "geometry": label, "fields": fields, "kernel_mode": mode,
                "wall_s": res.wall_time, "steps_per_epoch": sim.steps,
                "devices": sim.D, **{k: [float(v) for v in getattr(res, k)]
                                     for k in ROWS},
                "launches": runs[mode][1],
                "conv_launches_by_shape": [[*k, n] for k, n in
                                           sorted(shapes.items())],
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}})
        (a, launches, shapes), (p, plain, _) = runs["auto"], runs["torch"]
        check("geometry", not plain, f"{label}: torch mode launched {plain}")
        unchecked = sorted({k[1:] for k in shapes} - set(CONV_SHAPES))
        check("geometry", not unchecked,
              f"{label}: conv shapes not in CONV_SHAPES {unchecked}")
        missing = [k for k in EVERY_RUN + ("coef_agg",)
                   if launches.get(k, 0) == 0]
        check("geometry", not missing, f"{label}: never launched {missing}")
        parity = {
            "accuracy": bool(np.allclose(a.accuracy, p.accuracy, rtol=0,
                                         atol=ACC_TOL)),
            "loss": bool(np.allclose(a.loss, p.loss, rtol=LOSS_TOL,
                                     atol=LOSS_TOL)),
            "delta": bool(np.allclose(a.grad_norm, p.grad_norm,
                                      rtol=DELTA_RTOL, atol=DELTA_ATOL)),
            "clock_equal": bool(np.array_equal(a.sim_clock, p.sim_clock)),
            "energy_equal": bool(np.array_equal(a.sim_energy,
                                                p.sim_energy)),
            "blocks_equal": a.blocks == p.blocks}
        emit({"geometry_parity": {
            "geometry": label, "auto_vs_torch": parity,
            "max_abs_diff": {k: float(np.abs(getattr(a, r)
                                             - getattr(p, r)).max())
                             for k, r in (("accuracy", "accuracy"),
                                          ("loss", "loss"),
                                          ("delta", "grad_norm"))},
            "tolerances": {"accuracy_atol": ACC_TOL,
                           "loss_rtol_atol": LOSS_TOL,
                           "delta_rtol": DELTA_RTOL,
                           "delta_atol": DELTA_ATOL}}})
        check("geometry", all(parity.values()), f"{label}: {parity}")
        out[label] = shapes
    emit({"geometry": {"seconds": time.time() - t0}})
    return out


def rg_f32_predict(torch, cfg, kw: dict) -> dict:
    """The dry-run's reading of the plain HFL step of ``cfg`` at ``kw``'s
    edges, clients, rows and tokens, on meta tensors of the train line's
    state (``dryrun.track``, no mesh): argument, output, temp and peak
    bytes, and the seconds it took."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import init_fl_histories
    from repro_torch.models import param_specs
    from repro_torch.models.config import InputShape
    e, c, b, s = kw["n_edges"], kw["n_clients"], kw["batch"], kw["seq"]

    def tree(specs):
        return {k: tree(v) if isinstance(v, dict) else torch.zeros(
            (e, c) + tuple(v.shape), dtype=cfg.torch_param_dtype,
            device="meta") for k, v in specs.items()}

    params = tree(param_specs(cfg))
    dev_hist, glob_hist = init_fl_histories(params)
    tok = torch.zeros((e, c, b, s), dtype=torch.long, device="meta")
    x = {"params": params, "dev_hist": dev_hist, "glob_hist": glob_hist,
         "batch": {"tokens": tok, "labels": tok.clone()},
         "dev_mask": torch.ones((e, c), dtype=torch.bool, device="meta"),
         "edge_mask": torch.ones((e,), dtype=torch.bool, device="meta"),
         "lr": 0.01}
    shape = InputShape("train", s, e * c * b, "train")
    t0 = time.time()
    rec = dryrun.track(lambda m: dryrun.run_step(cfg, shape, None, m,
                                                 kernel_mode="torch"), x)
    return {**{k: rec[k] for k in ("argument", "output", "temp", "peak")},
            "seconds": time.time() - t0}


def rg_f32_phase(torch, train, build, kern, randn, record) -> dict:
    """recurrentgemma-9b trained in float32 (RG_F32_KW), kernels against
    plain (``train_runs``: launches at each shape, the float32 backward's
    three a call; ``train_parity``), the dry-run's predicted peak
    (``rg_f32_predict``) beside each run's measured one; then the float32
    backward timed at row 8p's shape (FLASH_TIMED["rg"], bf16 there) beside
    its plain version and the library's (autograd of
    ``scaled_dot_product_attention`` in float32, bool mask,
    ``enable_gqa``), its bound at the FP32 peak.  Returns the kernel run's
    launches by shape."""
    import dataclasses as dc
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    t0 = time.time()
    n = RECURRENT_TRAIN[RG_ARCH]
    cfg = dc.replace(cut_depth(get_config(RG_ARCH), n),
                     param_dtype=RG_F32_KW["param_dtype"],
                     clients_per_pod=RG_F32_KW["n_clients"])
    pred = rg_f32_predict(torch, cfg, RG_F32_KW)
    runs = train_runs(torch, train, build, kern, n, arch=RG_ARCH,
                      over=RG_F32_KW)
    parity = train_parity(torch, train, runs, RG_ARCH)
    emit({"train_rg_f32": {
        "predicted_peak_gb": pred["peak"] / 1e9,
        "predicted": {k: v / 1e9 if k != "seconds" else v
                      for k, v in pred.items()},
        "measured_peak_gb": {m: runs[m][2]["peak_memory_gb"]
                             for m in runs},
        "first_loss_rel": parity["full_width"]["first_loss_rel"]}})
    # the float32 backward at row 8p's shape
    (sq, skv), dh, (h, hkv), causal, _, win = FLASH_TIMED["rg"]
    b = SERVE_BATCH
    q, do = (randn(b, sq, h, dh) for _ in range(2))
    k, v = (randn(b, skv, hkv, dh) for _ in range(2))
    kw = dict(causal=causal, window=win)
    fwd, bwd = kern.flash_attention_fwd, kern.flash_attention_bwd
    o, lse = fwd(q, k, v, lse=True, mode="cuda", **kw)
    got = bwd(q, k, v, o, lse, do, mode="cuda", **kw)
    check("flash_attention_bwd", all(torch.equal(a, c) for a, c in zip(
        got, bwd(q, k, v, o, lse, do, mode="cuda", **kw))),
        "float32 at Dh 256: not bitwise on repeat")
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    del o_ref, lse_ref
    rel = max((g - w).abs().max().item() / w.abs().max().item()
              for g, w in zip(got, want))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check("flash_attention_bwd", rel <= FLASH_BWD_REL["float32"],
          f"float32 at row 8p's shape: {rel}")
    del got, want
    qpos = torch.arange(sq, device=q.device)
    mask = (qpos[None, :] <= qpos[:, None]) & \
        (qpos[None, :] > qpos[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)

    flops = 10.0 * dh * b * h * flash_pairs(sq, skv, causal, win)
    record("flash_attention_bwd[rg_f32]", err, FLASH_BWD_REL["float32"],
           lambda: bwd(q, k, v, o, lse, do, mode="cuda", **kw),
           timed_ms(torch, lambda: flash_attention_bwd_ref(
               q, k, v, o, lse, do, **kw), iters=2, warmup=1),
           timed_ms(torch, library, iters=3, warmup=1),
           4.0 * (3 * b * sq * h * dh + 4 * b * skv * hkv * dh + b * h * sq),
           flops,
           {"shape": {"q": [b, sq, h, dh], "kv": [b, skv, hkv, dh],
                      "dtype": "float32", "causal": causal, "window": win},
            "max_rel_err": rel,
            "tolerance": f"{FLASH_BWD_REL['float32']} x max|grad|",
            "flops": flops, "bitwise_on_repeat": True,
            "design": kern.BWD_DESIGNS[torch.float32],
            "library_call": "autograd of scaled_dot_product_attention("
                            "attn_mask=causal & window, enable_gqa=True), "
                            "float32",
            "device_ms_kernels": {part: device_ms(
                torch, lambda: bwd(q, k, v, o, lse, do, mode="cuda", **kw),
                (sym,), iters=10) for sym, part in (
                ("flash_bwd_delta_kernel", "delta"),
                ("flash_bwd_dkdv_kernel", "dk_dv"),
                ("flash_bwd_dq_kernel", "dq"))},
            "launch_ms": launch_ms(torch, build, lambda: bwd(
                q, k, v, o, lse, do, mode="cuda", **kw), iters=5),
            "host_ms": host_ms(torch, lambda: bwd(
                q, k, v, o, lse, do, mode="cuda", **kw), iters=5)},
           kernel="flash_attention_bwd", iters=10)
    del q, k, v, o, lse, do, qt, kt, vt, lib_out, dot
    emit({"rg_f32_phase": {"seconds": time.time() - t0}})
    return runs["auto"][-1]


def kstar_phase(torch, core) -> dict:
    """K* over a batched grid: ``optimize_k_masked`` on the card over 16
    LatencyParams x 3 omega_bar in one call, against ``optimize_k`` on the
    host per grid point; every ``k_star`` must be equal."""
    dev = torch.device("cuda")
    lms, lps = np.meshgrid(KSTAR_LM, KSTAR_LP, indexing="ij")
    n_om = len(KSTAR_OMEGA)
    lm = np.repeat(lms.ravel(), n_om).astype(np.float32)
    lp = np.repeat(lps.ravel(), n_om).astype(np.float32)
    om = np.tile(np.asarray(KSTAR_OMEGA, np.float32), lms.size)
    G = lm.size
    p = core.LatencyParams(lm_device=torch.from_numpy(lm).to(dev),
                           lp_device=torch.from_numpy(lp).to(dev))
    bp = dataclasses.replace(core.BoundParams(),
                             eta=torch.full((G,), 0.12, device=dev))
    om_t = torch.from_numpy(om).to(dev)

    def solve():
        return core.optimize_k_masked(
            core.total_latency_k(p, KSTAR_KMAX),
            core.omega_bound_k(bp, KSTAR_KMAX),
            core.edge_window_k(p, KSTAR_KMAX), om_t, KSTAR_CONS)

    k, lat_, _ = solve()
    card = k.cpu().numpy()
    t0 = time.perf_counter()
    host = []
    for i in range(G):
        r = core.optimize_k(
            core.LatencyParams(lm_device=float(lm[i]),
                               lp_device=float(lp[i])),
            lambda kk: core.omega_bound(kk, core.BoundParams()),
            float(om[i]), KSTAR_CONS, KSTAR_KMAX)
        host.append(-1 if r is None else r.k_star)
    host_ms_ = (time.perf_counter() - t0) * 1e3
    out = {"grid": G, "k_max": KSTAR_KMAX, "consensus_latency": KSTAR_CONS,
           "omega_bar": list(KSTAR_OMEGA), "k_star": card.tolist(),
           "equal": bool((card == np.asarray(host)).all()),
           "card_ms": timed_ms(torch, solve), "host_ms": host_ms_}
    emit({"kstar": out})
    check("kstar", out["equal"], f"card {card.tolist()} host {host}")
    return out


def fig3_full(torch, fl, setting) -> dict:
    """Fig. 3's grid at T = 50 (``--full``): wall seconds of the plan and
    of its run, final and best accuracy per point."""
    t0 = time.time()
    plan = fl.plan_sweep(setting, overrides=fig3_overrides(),
                         device="cuda", kernel_mode="auto", **SWEEP_KW)
    plan_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    res = fl.run_plan(plan)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return {"t_global_rounds": setting.t_global_rounds, "plan_s": plan_s,
            "wall_s": wall, "points_per_s": len(res.points) / wall,
            "points": [{"override": ov,
                        "final_accuracy": float(res.accuracy[p, -1]),
                        "best_accuracy": float(res.accuracy[p].max())}
                       for p, (ov, _) in enumerate(res.points)]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if "--mesh-rank" in sys.argv[1:]:
        return mesh_rank(sys.argv[1:])
    if "--mesh-steps-rank" in sys.argv[1:]:
        return mesh_steps_rank(sys.argv[1:])
    if "--mesh-memory-rank" in sys.argv[1:]:
        return mesh_memory_rank(sys.argv[1:])
    if "--mesh-memory-predict" in sys.argv[1:]:
        return mesh_memory_predict(sys.argv[1:])
    if "--mesh-train-rank" in sys.argv[1:]:
        return mesh_run_rank(sys.argv[1:])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, fl
    from repro_torch.configs import DEFAULT, REDUCED, get_config
    from repro_torch.core.hieavg import to_history_dtype
    from repro_torch.fl import BHFLSimulator, run_comparison
    from repro_torch.kernels import build
    from repro_torch.kernels.coef_agg import (coef_agg_many,
                                              coef_agg_pair_many)
    from repro_torch.kernels.conv3x3 import conv3x3_bwd, conv3x3_fwd
    conv_mod = importlib.import_module("repro_torch.kernels.conv3x3")
    from repro_torch.kernels.eval_head import eval_head
    from repro_torch.kernels.flash_attention import DESIGNS as FLASH_DESIGNS
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hieavg_agg import hieavg_agg, hieavg_agg_many
    from repro_torch.kernels.ref import im2col3x3
    from repro_torch.kernels.sgd_update import sgd_update, sgd_update_many
    # the module: ``repro_torch.kernels.flash_attention`` is the function
    flash_kernels = importlib.import_module(
        "repro_torch.kernels.flash_attention")
    from repro_torch.launch import serve, train
    from repro_torch.models import cnn_specs
    from repro_torch.models.spec import count_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.time()
    # the Dh-256 instances' registers and spills, compiled beside the build
    ptxas = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "flash_ptxas.py"), "--dh",
         "256", "--out", str(ROOT / "build" / "ptxas")],
        stdout=subprocess.PIPE, text=True)
    try:
        build.library()
    finally:
        ptxas_out, _ = ptxas.communicate()
    check("build", ptxas.returncode == 0, "tools/flash_ptxas.py failed")
    FLASH_BUILD_FACTS["ptxas"] = [json.loads(x) for x in
                                  ptxas_out.splitlines()]
    FLASH_BUILD_FACTS["hgmma"] = {
        k: n for k, n in hgmma_counts(build.compile_library()).items()
        if k.endswith("<256>")}
    emit({"build": {"seconds": time.time() - t0,
                    "library": build.compile_library().name,
                    "flags": " ".join(build.NVCC_FLAGS),
                    "flash_dh256": FLASH_BUILD_FACTS}})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    results = {}

    def record(name, err, tol, fn, plain_ms, library_ms, nbytes, flops,
               extra=None, kernel=None, flop_rate=FP32_FLOP_PER_S,
               iters=20):
        """``fn`` launches the kernel (``kernel``, default ``name``) at the
        timed shape: ``ms`` is its wall time per call through the wrapper
        (CUDA events, the median of 5 timings of ``iters`` calls: a
        host-bound wrapper's swings with the shared host), ``device_ms``
        its kernels' own device time (profiler).  The bound counts
        ``flops`` at ``flop_rate``."""
        bms, by = bound_ms(nbytes, flops, flop_rate)
        line = {"kernel": name, "max_abs_err": err, "tolerance": tol,
                "ms": float(np.median([timed_ms(torch, fn, iters=iters)
                                       for _ in range(5)])),
                "device_ms": device_ms(torch, fn, symbols_of(kernel or name),
                                       iters=iters),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bms, "bound_by": by, **(extra or {})}
        emit(line)
        results[name] = line

    def gemm_err(got, want, rel=1e-4):
        """max |got - want| and its tolerance rel * max|want| (FP32 sums in
        another order than cuBLAS's)."""
        err = (got - want).abs().max().item()
        return err, rel * max(want.abs().max().item(), 1e-30)

    # ------------------------------------------------- conv3x3_fwd and _bwd
    # every shape the main path gives the kernels (train and eval, both
    # layers), the tiling's tails and the geometries past the old limits,
    # the backward with and without dx, and dx, dW and db bitwise on repeat;
    # layer 2 at the train shape is timed, and at CONV_WIDE's
    worst_f = worst_b = 0.0
    wide_s = 0.0  # CONV_GEOMETRY_SHAPES' share of the phase
    for shape in CONV_SHAPES:
        t_shape = time.time()
        d, b_, h, wd, ci, co = shape
        x, w = rand(d, b_, h, wd, ci), randn(d, 3, 3, ci, co,
                                             scale=(9 * ci) ** -0.5)
        b = randn(d, co, scale=0.1)
        want = conv3x3_fwd(x, w, b, "torch")
        err, tol = gemm_err(conv3x3_fwd(x, w, b, "cuda"), want)
        check("conv3x3_fwd", err <= tol, f"{shape}: {err} > {tol}")
        worst_f = max(worst_f, err / max(tol, 1e-30))
        dy = randn(d, b_, h, wd, co)
        for need in (True, False):
            got = conv3x3_bwd(x, w, want, dy, need, "cuda")
            for g_, w_ in zip(got, conv3x3_bwd(x, w, want, dy, need,
                                               "torch")):
                if w_ is None:
                    check("conv3x3_bwd", g_ is None, "dx where none asked")
                    continue
                err, tol = gemm_err(g_, w_)
                check("conv3x3_bwd", err <= tol,
                      f"{shape} need_dx={need}: {err} > {tol}")
                worst_b = max(worst_b, err / max(tol, 1e-30))
        again = conv3x3_bwd(x, w, want, dy, True, "cuda")
        check("conv3x3_bwd", all(torch.equal(g_, a_) for g_, a_ in zip(
            conv3x3_bwd(x, w, want, dy, True, "cuda"), again)),
            f"{shape}: not bitwise on repeat")
        del x, w, b, want, dy, got, again
        if shape in CONV_GEOMETRY_SHAPES:
            wide_s += time.time() - t_shape

    def conv_records(suffix, shape, iters=20):
        """conv3x3_fwd and _bwd at ``shape`` (D, B, H, W, Cin, Cout) timed
        beside the plain versions and the yardsticks: one grouped conv2d
        over the D devices (NCHW, TF32 off), its convolution_backward given
        dz and, at the DEFAULT shape, the im2col GEMM on patches built
        beforehand."""
        d, b_, h, wd, ci, co = shape
        m = b_ * h * wd
        x, w = rand(d, b_, h, wd, ci), randn(d, 3, 3, ci, co,
                                             scale=(9 * ci) ** -0.5)
        b = randn(d, co, scale=0.1)
        y = conv3x3_fwd(x, w, b, "torch")
        dy = randn(d, b_, h, wd, co)
        xn = x.permute(1, 0, 4, 2, 3).reshape(b_, d * ci, h, wd).contiguous()
        wn = w.permute(0, 4, 3, 1, 2).reshape(d * co, ci, 3, 3).contiguous()
        bn = b.reshape(-1)
        dzn = (dy * (y > 0)).permute(1, 0, 4, 2, 3).reshape(
            b_, d * co, h, wd).contiguous()

        def lib_fwd():
            return torch.nn.functional.conv2d(xn, wn, bn, padding=1,
                                              groups=d)

        def lib_bwd():
            return torch.ops.aten.convolution_backward(
                dzn, xn, wn, [d * co], [1, 1], [1, 1], [1, 1], False,
                [0, 0], d, [True, True, True])

        lib_diff = (torch.relu(lib_fwd()).reshape(b_, d, co, h, wd)
                    .permute(1, 0, 3, 4, 2) - y).abs().max().item()
        cols_ms = None
        if not suffix:
            cols = im2col3x3(x).reshape(d, m, 9 * ci)
            wmat = w.reshape(d, 9 * ci, co)
            cols_ms = timed_ms(torch, lambda: torch.baddbmm(
                b[:, None, :], cols, wmat))
            del cols, wmat
        err, tol = gemm_err(conv3x3_fwd(x, w, b, "cuda"), y)
        flops = 2.0 * d * m * 9 * ci * co
        record("conv3x3_fwd" + suffix, err, tol,
               lambda: conv3x3_fwd(x, w, b, "cuda"),
               timed_ms(torch, lambda: conv3x3_fwd(x, w, b, "torch"),
                        iters=iters),
               timed_ms(torch, lib_fwd, iters=iters),
               4.0 * (d * m * ci + d * 9 * ci * co + d * co + d * m * co),
               flops,
               {"shape": [d, b_, h, wd, ci, co],
                "worst_err_over_tol": worst_f,
                "library_call": "conv2d(groups=D), no ReLU",
                "library_max_abs_diff": lib_diff,
                "library_cols_ms": cols_ms,
                "library_cols_call": "baddbmm on im2col patches built "
                                     "before"},
               kernel="conv3x3_fwd", iters=iters)
        got = conv3x3_bwd(x, w, y, dy, True, "cuda")
        errs = [gemm_err(g_, w_) for g_, w_ in
                zip(got, conv3x3_bwd(x, w, y, dy, True, "torch"))]
        check("conv3x3_bwd", all(e <= t_ for e, t_ in errs), f"{errs}")
        record("conv3x3_bwd" + suffix, max(e for e, _ in errs),
               max(t_ for _, t_ in errs),
               lambda: conv3x3_bwd(x, w, y, dy, True, "cuda"),
               timed_ms(torch, lambda: conv3x3_bwd(x, w, y, dy, True,
                                                   "torch"), iters=iters),
               timed_ms(torch, lib_bwd, iters=iters),
               4.0 * (2 * d * m * ci + 2 * d * 9 * ci * co + 2 * d * m * co
                      + d * co), 2 * flops + d * m * co,
               {"shape": [d, b_, h, wd, ci, co],
                "worst_err_over_tol": worst_b,
                "library_call": "convolution_backward of conv2d(groups=D), "
                                "given dz",
                "library_cols_ms": None,
                "bitwise_on_repeat": all(torch.equal(a_, b2) for a_, b2 in
                                         zip(got, conv3x3_bwd(
                                             x, w, y, dy, True, "cuda")))},
               kernel="conv3x3_bwd", iters=iters)

    conv_records("", CONV_SHAPES[0])
    t_wide = time.time()
    for label, shape in CONV_WIDE.items():
        conv_records(f"[{label}]", shape, iters=5)
    emit({"conv_wide": {"seconds": wide_s + time.time() - t_wide}})

    # ------------------------------------------------ the model's leaves
    specs = cnn_specs(HW, 1, NCLS, c1=C1, c2=C2)
    P = count_params(specs)
    leaf_sizes = [math.prod(s.shape) for s in specs.values()]
    # the example drivers' CNN at REDUCED, whose leaves each kernel is
    # also held at
    check("examples", (REDUCED.batch_size, REDUCED.image_hw, REDUCED.cnn_c1,
                       REDUCED.cnn_c2) == (RB, RHW, RC1, RC2),
          f"REDUCED is not the widths the checks assume: {REDUCED}")
    rspecs = cnn_specs(RHW, 1, NCLS, c1=RC1, c2=RC2)
    rleaf_sizes = [math.prod(s.shape) for s in rspecs.values()]

    # ----------------------------------------------------------- sgd_update
    # one launch per local step over every leaf: bitwise the plain version
    # per leaf, scale 0 an exact identity, one launch counted per call
    ws = [randn(D, L) for L in leaf_sizes]
    gs = [randn(D, L) for L in leaf_sizes]
    s = 0.00095238
    err = 0.0
    for L in (1, 7, 2047, 2049):
        w1, g1 = randn(3, L), randn(3, L)
        e = (sgd_update(w1, g1, s, "cuda")
             - sgd_update(w1, g1, s, "torch")).abs().max().item()
        err = max(err, e)
        check("sgd_update", torch.equal(sgd_update(w1, g1 * 1e3, 0.0, "cuda"),
                                        w1), "scale 0 is not an identity")
    before = build.LAUNCHES["sgd_update"]
    got = sgd_update_many(ws, gs, s, "cuda")
    check("sgd_update", build.LAUNCHES["sgd_update"] == before + 1,
          f"{len(ws)} leaves took {build.LAUNCHES['sgd_update'] - before} "
          "launches")
    for g_, w_ in zip(got, sgd_update_many(ws, gs, s, "torch")):
        err = max(err, (g_ - w_).abs().max().item())
    rws = [randn(D, L) for L in rleaf_sizes]
    rgs = [randn(D, L) for L in rleaf_sizes]
    for g_, w_ in zip(sgd_update_many(rws, rgs, s, "cuda"),
                      sgd_update_many(rws, rgs, s, "torch")):
        err = max(err, (g_ - w_).abs().max().item())
    del rws, rgs
    check("sgd_update", err == 0.0, f"not bitwise the plain version: {err}")
    check("sgd_update", all(torch.equal(a, w_) for a, w_ in zip(
        sgd_update_many(ws, [g * 1e3 for g in gs], 0.0, "cuda"), ws)),
        "scale 0 is not an identity")
    record("sgd_update", err, 0.0,
           lambda: sgd_update_many(ws, gs, s, "cuda"),
           timed_ms(torch, lambda: sgd_update_many(ws, gs, s, "torch")),
           timed_ms(torch, lambda: torch._foreach_add(ws, gs, alpha=-s)),
           12.0 * D * P, 2.0 * D * P,
           {"shape": [D, P], "leaves": len(ws), "launches_per_call": 1})
    del ws, gs, got

    def sgd_rows_check(rows_launches: dict, leaf_specs=specs) -> None:
        """One scale a row at each row count (points x devices) a sweep
        bucket gives the per-row path (``per_row_launches``), over the
        CNN's leaves (``leaf_specs``): bitwise the plain version, a padded
        step's zero rows exactly their w, one launch counted per call.
        Timed at the count the plan launches most, at DEFAULT's leaves;
        called before the sweep's counts are reset, so these launches are
        not the main path's."""
        key = count_params(leaf_specs)
        for rows in sorted(set(rows_launches) - checked_rows[key]):
            checked_rows[key].add(rows)
            ws = [randn(rows, *s_.shape) for s_ in leaf_specs.values()]
            gs = [randn(rows, *s_.shape, scale=1e3)
                  for s_ in leaf_specs.values()]
            scale = rand(rows) * 0.01
            scale[::3] = 0.0
            before = build.LAUNCHES["sgd_update[rows]"]
            got = sgd_update_many(ws, gs, scale, "cuda")
            check("sgd_update[rows]", build.LAUNCHES["sgd_update[rows]"]
                  == before + 1, f"{rows} rows: not one launch a call")
            err = max((g_ - w_).abs().max().item() for g_, w_ in zip(
                got, sgd_update_many(ws, gs, scale, "torch")))
            check("sgd_update[rows]", err == 0.0,
                  f"{rows} rows: not bitwise the plain version: {err}")
            check("sgd_update[rows]", all(torch.equal(a[::3], w_[::3])
                                          for a, w_ in zip(got, ws)),
                  f"{rows} rows: a zero row is not an identity")
            if "sgd_update[rows]" in results or leaf_specs is not specs \
                    or rows != max(rows_launches,
                                   key=lambda r: (rows_launches[r], r)):
                del ws, gs, got
                continue
            col = [scale.view((rows,) + (1,) * (w_.dim() - 1)).expand_as(w_)
                   for w_ in ws]
            lib_err = max((a - b2).abs().max().item() for a, b2 in zip(
                torch._foreach_addcmul(ws, col, gs, value=-1.0), got))
            record("sgd_update[rows]", err, 0.0,
                   lambda: sgd_update_many(ws, gs, scale, "cuda"),
                   timed_ms(torch, lambda: sgd_update_many(ws, gs, scale,
                                                           "torch")),
                   timed_ms(torch, lambda: torch._foreach_addcmul(
                       ws, col, gs, value=-1.0)),
                   12.0 * rows * P + 4.0 * rows, 2.0 * rows * P,
                   {"shape": [rows, P], "leaves": len(ws),
                    "launches_per_call": 1,
                    "zero_rows": len(range(0, rows, 3)),
                    "sweep_row_counts": {str(r): n for r, n in
                                         sorted(rows_launches.items())},
                    "library_call": "_foreach_addcmul(w, scale rows "
                                    "expanded, g, value=-1)",
                    "library_max_abs_diff": lib_err}, kernel="sgd_update")
            del ws, gs, got, col

    checked_rows: dict = collections.defaultdict(set)

    # ----------------------------------------------------------- hieavg_agg
    def hieavg_inputs(nb, n, L):
        mask = rand(nb, n) > 0.3
        coef = rand(nb, n)
        return (randn(nb, n, L), randn(nb, n, L), randn(nb, n, L, scale=0.1),
                mask, coef * mask, coef * ~mask,
                torch.floor(rand(nb, n) * 6))

    def agg_err(got, want):
        err = max((g_ - w_).abs().max().item() for g_, w_ in zip(got, want))
        tol = 1e-5 * max(w_.abs().max().item() for w_ in want)
        return err, tol

    def many_inputs(nb, n, hdt, sizes=leaf_sizes):
        """the six leaves [nb, n, L] (L in ``sizes``) of one aggregate and
        its float32 coefficients (as the main path passes them), history
        stored in ``hdt``"""
        a = [hieavg_inputs(nb, n, L) for L in sizes]
        return ([x[0] for x in a], [to_history_dtype(x[1], hdt) for x in a],
                [to_history_dtype(x[2], hdt) for x in a],
                *(v.float() for v in a[0][3:]))

    def one_launch(name, args):
        """hieavg_agg_many on the card, checked to be one launch"""
        before = build.LAUNCHES["hieavg_agg"]
        got = hieavg_agg_many(*args, mode="cuda")
        check(name, build.LAUNCHES["hieavg_agg"] == before + 1,
              f"{len(args[0])} leaves took "
              f"{build.LAUNCHES['hieavg_agg'] - before} launches")
        return got

    nb, n = 5, 5                                  # N = 5 edges of J = 5
    err, tol = 0.0, 0.0
    for (nb2, n2, L) in ((1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)):
        args = hieavg_inputs(nb2, n2, L)
        e, t = agg_err(hieavg_agg(*args, mode="cuda"),
                       hieavg_agg(*args, mode="torch"))
        check("hieavg_agg", e <= t, f"{(nb2, n2, L)}: {e} > {t}")
    margs = many_inputs(nb, n, torch.float32)
    for got, want in zip(zip(*one_launch("hieavg_agg", margs)),
                         zip(*hieavg_agg_many(*margs, mode="torch"))):
        e, t = agg_err(got, want)
        check("hieavg_agg", e <= t, f"DEFAULT leaf: {e} > {t}")
        err, tol = max(err, e), max(tol, t)
    rargs = many_inputs(nb, n, torch.float32, rleaf_sizes)
    for got, want in zip(zip(*one_launch("hieavg_agg", rargs)),
                         zip(*hieavg_agg_many(*rargs, mode="torch"))):
        e, t = agg_err(got, want)
        check("hieavg_agg", e <= t, f"REDUCED leaf: {e} > {t}")
    del rargs
    # a zero-coefficient slot adds exactly nothing, whatever it holds
    a = hieavg_inputs(1, 4, 999)
    junk = [x.clone() for x in a[:3]]
    for x in junk:
        x[:, 3] = 1e6
    cp, ce = a[4].clone(), a[5].clone()
    cp[:, 3] = ce[:, 3] = 0.0
    check("hieavg_agg", torch.equal(
        hieavg_agg(*a[:3], a[3], cp, ce, a[6], mode="cuda")[0],
        hieavg_agg(*junk, a[3], cp, ce, a[6], mode="cuda")[0]),
        "a zero-coefficient slot changed the aggregate")
    outs = [o for kind in hieavg_agg_many(*margs, mode="cuda") for o in kind]
    record("hieavg_agg", err, tol,
           lambda: hieavg_agg_many(*margs, mode="cuda"),
           timed_ms(torch, lambda: hieavg_agg_many(*margs, mode="torch")),
           None, 4.0 * (5 * nb * n * P + nb * P + 4 * nb * n),
           17.0 * nb * n * P, {
               "shape": [nb, n, P], "leaves": len(margs[0]),
               "history": "float32", "launches_per_call": 1,
               # the host's share: the whole wrapper, and the per-leaf
               # output views alone (as_strided of each of the 18)
               "host_ms": host_ms(torch, lambda: hieavg_agg_many(
                   *margs, mode="cuda")),
               "views_host_ms": host_ms(torch, lambda: [
                   o.as_strided(o.shape, o.stride(), o.storage_offset())
                   for o in outs])})
    del outs
    del margs

    # ------------------------------- hieavg_agg with narrow history storage
    def ulps(got, want, dtype_name):
        """max |got - want| in units in the last place of the storage dtype
        at the larger magnitude, compared in float32; NaN against NaN is 0,
        NaN against a number is NaN (fails every bound)."""
        g, w_ = got.float(), want.float()
        mant, emin = NARROW[dtype_name]
        mag = torch.maximum(g.abs(), w_.abs()).clamp(min=2.0 ** emin)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
        r = torch.where(g.isnan() & w_.isnan(), 0.0, (g - w_).abs() / ulp)
        return float(torch.nan_to_num(r, nan=float("inf")).max().item())

    for hname in NARROW:
        hdt = getattr(torch, hname)
        label = f"hieavg_agg[{hname}]"

        def narrow_inputs(nb2, n2, L):
            a = list(hieavg_inputs(nb2, n2, L))
            a[1], a[2] = to_history_dtype(a[1], hdt), to_history_dtype(a[2], hdt)
            return a

        def narrow_check(shape, got, want):
            check(label, got[1].dtype == got[2].dtype == hdt,
                  f"history came back as {got[1].dtype}")
            e, t = agg_err(got[:1], want[:1])
            check(label, e <= t, f"{shape} agg: {e} > {t}")
            u = max(ulps(g_, w_, hname) for g_, w_ in zip(got[1:], want[1:]))
            check(label, u <= 1.0, f"{shape} history: {u} ulp")
            return e, t, u

        err, tol, worst_ulp = 0.0, 0.0, 0.0
        for shape in [(1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)]:
            args = narrow_inputs(*shape)
            narrow_check(shape, hieavg_agg(*args, mode="cuda"),
                         hieavg_agg(*args, mode="torch"))
        for b_ in (nb, 1):
            margs = many_inputs(b_, n, hdt)
            for got, want in zip(zip(*one_launch(label, margs)),
                                 zip(*hieavg_agg_many(*margs, mode="torch"))):
                e, t, u = narrow_check((b_, n), got, want)
                err, tol = max(err, e), max(tol, t)
                worst_ulp = max(worst_ulp, u)
        # a present slot stores w itself: the kernel's rounding of the edge
        # values against the cast helper's (which casts as jnp.astype)
        edges = torch.tensor(F8_EDGES, device=dev)
        one = torch.ones((1, 1), device=dev)
        zero_h = to_history_dtype(torch.zeros((1, 1, len(F8_EDGES)),
                                              device=dev), hdt)
        ebits, stored = {}, {}
        for mode in ("cuda", "torch"):
            _, p_, d_ = hieavg_agg(edges[None, None], zero_h, zero_h,
                                   one > 0, one, one * 0, one * 0, mode=mode)
            ebits[mode] = (p_.float()[0, 0], d_.float()[0, 0])
            stored[mode] = (p_[0, 0], d_[0, 0])
        want_h = to_history_dtype(edges, hdt)
        want = want_h.float()

        def same(a_, b_):
            return bool(((a_ == b_) | (a_.isnan() & b_.isnan())).all())

        check(label, all(same(x, want) for x in ebits["cuda"] + ebits["torch"]),
              f"edge values: {ebits['cuda'][0].tolist()} != {want.tolist()}")
        if hdt == torch.float8_e4m3fn:
            # float8 bitwise, the NaNs' signs included (bfloat16 NaN
            # payloads differ between conversions, so it stops at the value)
            bits = [x.view(torch.uint8) for x in stored["cuda"]]
            check(label, all(torch.equal(b_, want_h.view(torch.uint8))
                             for b_ in bits),
                  f"edge bits: {bits[0].tolist()} != "
                  f"{want_h.view(torch.uint8).tolist()}")
        margs = many_inputs(nb, n, hdt)
        s = 2 if hname == "bfloat16" else 1
        record(label, err, tol,
               lambda: hieavg_agg_many(*margs, mode="cuda"),
               timed_ms(torch, lambda: hieavg_agg_many(*margs, mode="torch")),
               None, (4.0 + 4.0 * s) * nb * n * P + 4.0 * nb * P
               + 16.0 * nb * n,
               17.0 * nb * n * P,
               {"shape": [nb, n, P], "leaves": len(margs[0]), "history": hname,
                "launches_per_call": 1,
                "history_max_ulp": worst_ulp, "history_tolerance_ulp": 1.0,
                "edge_values": dict(zip(map(str, F8_EDGES),
                                        ebits["cuda"][0].tolist()))},
               kernel="hieavg_agg")
        del margs

    # ------------------------------------------- coef_agg and coef_agg_pair
    # every leaf of an aggregate in one launch, at the edge layer's lead
    # (B = n = 5) and the global layer's (n = 5), each checked to be one
    # launch, within the plain version's bound and bitwise on repeat; the
    # tails one leaf a call; a zero-coefficient slot adds exactly nothing;
    # the six-leaf call at the edge layer's lead is timed
    leaf_shapes = [tuple(s.shape) for s in specs.values()]
    rleaf_shapes = [tuple(s.shape) for s in rspecs.values()]

    def coef_inputs(kind, lead, shapes):
        """leaves [*lead, *leaf] (the pair: w and aux) and coefficients
        [*lead]: one vector, or a delayed-gradient mix (present slots weigh
        w, missing ones aux)"""
        c = rand(*lead)
        if kind == "coef_agg":
            return [[randn(*lead, *s) for s in shapes]], (c,)
        m = rand(*lead) > 0.4
        return ([[randn(*lead, *s) for s in shapes] for _ in range(2)],
                (c * m, c * ~m))

    for kind, many in (("coef_agg", coef_agg_many),
                       ("coef_agg_pair", coef_agg_pair_many)):
        err, tol = 0.0, 0.0
        for (nb2, n2, L) in ((1, 3, 1), (2, 5, 7), (5, 5, 2047), (1, 5, 2049)):
            ops_, cs = coef_inputs(kind, (nb2, n2), [(L,)])
            e, t = agg_err(many(*ops_, *cs, mode="cuda"),
                           many(*ops_, *cs, mode="torch"))
            check(kind, e <= t, f"{(nb2, n2, L)}: {e} > {t}")
        for lead, shapes in itertools.product(((nb, n), (n,)),
                                              (leaf_shapes, rleaf_shapes)):
            ops_, cs = coef_inputs(kind, lead, shapes)
            before = build.LAUNCHES[kind]
            got = many(*ops_, *cs, mode="cuda")
            check(kind, build.LAUNCHES[kind] == before + 1,
                  f"lead {lead}: {len(shapes)} leaves took "
                  f"{build.LAUNCHES[kind] - before} launches")
            e, t = agg_err(got, many(*ops_, *cs, mode="torch"))
            check(kind, e <= t, f"lead {lead}: {e} > {t}")
            err, tol = max(err, e), max(tol, t)
            check(kind, all(torch.equal(a_, b_) for a_, b_ in zip(
                got, many(*ops_, *cs, mode="cuda"))),
                f"lead {lead}: not bitwise on repeat")
        # a zero-coefficient slot adds exactly nothing, whatever it holds
        w2, a2 = randn(1, 5, 500), randn(1, 5, 500)
        w3, a3 = w2.clone(), a2.clone()
        if kind == "coef_agg":
            zc = (torch.tensor([[0.5, 0.3, 0.2, 0.0, 0.0]], device=dev),)
            w3[:, 3:] = 1e6
        else:
            zc = (torch.tensor([[0.5, 0.0, 0.2, 0.0, 0.0]], device=dev),
                  torch.tensor([[0.0, 0.3, 0.0, 0.0, 0.0]], device=dev))
            w3[:, [1, 3, 4]] = 1e6
            a3[:, [0, 2, 3, 4]] = 1e6
        clean = [[w2], [a2]][:len(zc)]
        junk = [[w3], [a3]][:len(zc)]
        check(kind, torch.equal(many(*clean, *zc, mode="cuda")[0],
                                many(*junk, *zc, mode="cuda")[0]),
              "a zero-coefficient slot changed the aggregate")
        ops_, cs = coef_inputs(kind, (nb, n), leaf_shapes)
        flat = [[x.view(nb, n, -1) for x in o] for o in ops_]
        if kind == "coef_agg":
            def library():
                return [torch.einsum("bn,bnl->bl", cs[0], w_)
                        for w_ in flat[0]]
        else:
            def library():
                return [torch.einsum("bn,bnl->bl", cs[0], w_).add_(
                    torch.einsum("bn,bnl->bl", cs[1], a_))
                    for w_, a_ in zip(*flat)]
        outs = many(*ops_, *cs, mode="cuda")
        record(kind, err, tol, lambda: many(*ops_, *cs, mode="cuda"),
               timed_ms(torch, lambda: many(*ops_, *cs, mode="torch")),
               timed_ms(torch, library),
               4.0 * (len(ops_) * nb * n * P + nb * P + len(cs) * nb * n),
               2.0 * len(ops_) * nb * n * P, {
                   "shape": [nb, n, P], "leaves": len(leaf_shapes),
                   "launches_per_call": 1,
                   "library_calls": f"{len(ops_)} einsum call(s) a leaf",
                   # the host's share: the whole wrapper, and the per-leaf
                   # output views alone (as_strided of each of the six)
                   "host_ms": host_ms(torch, lambda: many(
                       *ops_, *cs, mode="cuda")),
                   "views_host_ms": host_ms(torch, lambda: [
                       o.as_strided(o.shape, o.stride(), o.storage_offset())
                       for o in outs])})
        del ops_, flat, outs, got

    # ------------------------------------------------------------ eval_head
    def margin_rows(feats, wmat, bias):
        """rows whose two largest logits are within float32 reach of each
        other: their argmax may differ between two summation orders"""
        z = feats.double() @ wmat.double() + bias.double()
        top = torch.topk(z, 2, dim=-1).values
        return int(((top[:, 0] - top[:, 1])
                    <= 1e-4 * z.abs().amax(-1)).sum().item())

    def eval_case(m_, c_, feat=FEAT):
        """inputs at M = m_, F = feat, C = c_ (a third of the labels
        right), the kernel's count against the plain one, bitwise on
        repeat"""
        f_ = rand(m_, feat)
        wm, bb = randn(feat, c_, scale=feat ** -0.5), randn(c_, scale=0.1)
        lab = torch.randint(-1, c_, (m_,), generator=gen, device=dev,
                            dtype=torch.int32)
        lab[::3] = torch.argmax(f_ @ wm + bb, -1)[::3]
        got = eval_head(f_, wm, bb, lab, "cuda")
        want = int(eval_head(f_, wm, bb, lab, "torch").item())
        amb = margin_rows(f_, wm, bb)
        check("eval_head", abs(int(got.item()) - want) <= amb,
              f"M={m_} F={feat} C={c_}: count {int(got.item())} vs {want}, {amb} "
              "ambiguous rows")
        check("eval_head", all(torch.equal(eval_head(f_, wm, bb, lab, "cuda"),
                                           got) for _ in range(2)),
              f"M={m_} F={feat} C={c_}: count not bitwise on repeat")
        return (f_, wm, bb, lab), abs(int(got.item()) - want), amb

    for c_ in (NCLS, 100):
        ambiguous, err = 0, 0
        for m_ in (1, 7, 257, NTEST):
            args, e, amb = eval_case(m_, c_)
            ambiguous, err = ambiguous + amb, max(err, e)
        record("eval_head" if c_ == NCLS else f"eval_head[C={c_}]",
               float(err), float(ambiguous),
               lambda: eval_head(*args, "cuda"),
               timed_ms(torch, lambda: eval_head(*args, "torch")),
               None, 4.0 * (NTEST * FEAT + FEAT * c_ + c_ + NTEST) + 8.0,
               2.0 * NTEST * FEAT * c_,
               {"shape": [NTEST, FEAT, c_], "bitwise_on_repeat": True,
                "host_ms": host_ms(torch, lambda: eval_head(*args, "cuda")),
                # the two passes' device times: partial logits, argmax
                "device_ms_passes": [device_ms(
                    torch, lambda: eval_head(*args, "cuda"), (sym,))
                    for sym in ("eval_head_kernel",
                                "eval_head_argmax_kernel")]},
               kernel="eval_head")
        del args
    # the example drivers' evaluations: REDUCED's features at their n_test
    for m_ in EXAMPLE_NTEST:
        eval_case(m_, NCLS, RFEAT)

    # ------------------------------------------------------ flash_attention
    serve_cfg = get_config(SERVE_ARCH)
    flash_designs(torch, flash_attention, FLASH_DESIGNS, randn,
                  build.compile_library())
    flash_phase(torch, serve_cfg, flash_attention, randn, record)
    flash_bwd_phase(torch, serve_cfg, flash_kernels, randn, record,
                    flash_bwd_design(torch, flash_kernels, randn,
                                     build.compile_library()))
    flash_model_timing(torch, flash_kernels, randn, record)
    flash_shard_timing(torch, flash_kernels, randn, record)

    # ----------------------------------------------------------- the runs
    # every configuration with the kernels and with the plain versions; the
    # launch counts are set to 0 just before each run and read just after
    setting = dataclasses.replace(DEFAULT, t_global_rounds=4)
    T = setting.t_global_rounds

    def make_sim(label, mode):
        agg, strag, hname = RUNS[label]
        return BHFLSimulator(setting, agg, strag, strag, device="cuda",
                             kernel_mode=mode,
                             history_dtype=hname and getattr(torch, hname))

    runs, steps_of = {}, {}
    for label in RUNS:
        for mode in ("auto", "torch"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            sim = make_sim(label, mode)
            res = sim.run()
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            runs[label, mode] = (res, dict(build.LAUNCHES))
            steps_of[label] = sim.steps
            for key in ROWS:
                row = getattr(res, key)
                check("run", row.shape == (T,) and bool(np.isfinite(row).all()),
                      f"{label} {mode} {key}: {row}")
            check("run", res.blocks == T and res.chain_valid,
                  f"{label} {mode}: chain {res.blocks}")
            emit({"run": {"config": label, "kernel_mode": mode,
                          "wall_s": res.wall_time,
                          "steps_per_epoch": sim.steps, "devices": sim.D,
                          "blocks": res.blocks,
                          "chain_valid": res.chain_valid,
                          **{k: [float(v) for v in getattr(res, k)]
                             for k in ROWS},
                          "launches": runs[label, mode][1],
                          "peak_memory_gb": peak_gb}})
        a, launches = runs[label, "auto"]
        p, plain_launches = runs[label, "torch"]
        check("run", not plain_launches,
              f"{label}: torch mode launched {plain_launches}")
        missing = [k for k in EVERY_RUN + RUN_KERNELS.get(label, ())
                   if launches.get(k, 0) == 0]
        check("launches", not missing,
              f"{label}: never launched {missing} ({launches})")
        steps = T * setting.k_edge_rounds * steps_of[label]
        check("launches", launches.get("sgd_update", 0) == steps,
              f"{label}: {launches.get('sgd_update', 0)} sgd_update "
              f"launches for {steps} local steps")
        # one launch an aggregate: K edge rounds and the global one in
        # every round; HieAvg's cold rounds on coef_agg, its warm ones on
        # hieavg_agg
        per_round = setting.k_edge_rounds + 1
        cold = min(T, setting.t_cold_boot)
        aggs = {"fedavg": {"coef_agg": T * per_round},
                "delayed_grad": {"coef_agg_pair": T * per_round}}
        if "hieavg_agg" in RUN_KERNELS.get(label, ()):
            aggs[label] = {"hieavg_agg": (T - cold) * per_round,
                           "coef_agg": cold * per_round}
        for k, want in aggs.get(label, {}).items():
            check("launches", launches.get(k, 0) == want,
                  f"{label}: {launches.get(k, 0)} {k} launches for {want} "
                  "aggregates")
        parity = {
            "accuracy": bool(np.allclose(a.accuracy, p.accuracy, rtol=0,
                                         atol=ACC_TOL)),
            "loss": bool(np.allclose(a.loss, p.loss, rtol=LOSS_TOL,
                                     atol=LOSS_TOL)),
            "delta": bool(np.allclose(a.grad_norm, p.grad_norm,
                                      rtol=DELTA_RTOL, atol=DELTA_ATOL)),
            "clock_equal": bool(np.array_equal(a.sim_clock, p.sim_clock)),
            "energy_equal": bool(np.array_equal(a.sim_energy, p.sim_energy)),
            "blocks_equal": a.blocks == p.blocks,
        }
        emit({"parity": {"config": label, "auto_vs_torch": parity,
                         "max_abs_diff": {
                             "accuracy": float(np.abs(a.accuracy
                                                      - p.accuracy).max()),
                             "loss": float(np.abs(a.loss - p.loss).max()),
                             "delta": float(np.abs(a.grad_norm
                                                   - p.grad_norm).max())},
                         "tolerances": {"accuracy_atol": ACC_TOL,
                                        "loss_rtol_atol": LOSS_TOL,
                                        "delta_rtol": DELTA_RTOL,
                                        "delta_atol": DELTA_ATOL}}})
        check("parity", all(parity.values()), f"{label}: {parity}")

    # ------------------------------------------------- the resumed runs
    for label in RESUMED:
        line = resume_check(runs[label, "auto"][0],
                            lambda: make_sim(label, "auto"))
        emit({"resume": {"config": label, "every": 2, **line}})
        check("resume", line["resumed_bitwise"] and line["close_to_run"],
              f"{label}: {line}")

    # ---------------------------- the geometries past the conv's old limits
    geometry = geometry_phase(torch, build, BHFLSimulator, conv_mod)

    # ------------------------------------------------------ the sweeps
    sweep_setting = dataclasses.replace(DEFAULT, t_global_rounds=SWEEP_T)
    sweep_launches, swept = sweep_phase(torch, build, fl, sweep_setting,
                                        sgd_rows_check)
    check("sgd_update[rows]", "sgd_update[rows]" in results,
          "no sweep bucket took the per-row SGD path")
    kstar_phase(torch, core)

    # ------------------------- the sweep over a mesh's ranks, the census
    mesh_sweep(torch, build, fl, sweep_setting, swept["fig3"],
               sgd_rows_check)
    mesh_census(torch, build)
    meshed = mesh_steps(torch, build)
    mesh_memory(torch, build)
    mesh_train(torch, build, train)

    # ------------------------------------ population mode, the legacy loop
    population_phase(torch, build, fl, core, setting, {
        label: runs[label, "auto"][1] for label in POP_RUNS})
    legacy_phase(torch, build, BHFLSimulator, setting,
                 runs["hieavg", "auto"][0])

    # --------------------------------------------------- the serving path
    served = serve_runs(torch, serve, build, flash_kernels)
    serve_parity(torch, serve, served)
    xserved = {}
    for arch, prompt in XATTN_SERVE.items():
        xserved[arch] = serve_runs(torch, serve, build, flash_kernels, arch,
                                   prompt)
        serve_parity(torch, serve, xserved[arch], arch, prompt)

    # ----------------------------------------------- the training path
    # a short run first takes the first-call costs
    train.run(TRAIN_ARCH, **dict(TRAIN_KW, n_layers=1, steps=1, k_edge=1,
                                 seq=1024), device="cuda")
    trained = train_runs(torch, train, build, flash_kernels, TRAIN_LAYERS)
    train_parity(torch, train, trained)
    sound = [train_grads(torch, flash_kernels, TRAIN_LAYERS, "float32", seed,
                         tuple(FAULTS) if seed == 1 else ())
             for seed in (1, 2)]
    emit({"train_grads": {"tolerance": TRAIN_GRAD_REL, "float32": sound}})
    check("train_grads", all(r["rel"] <= TRAIN_GRAD_REL for r in sound),
          f"kernels against plain: {[r['rel'] for r in sound]}")
    check("train_grads", all(sound[0][f"fault_{f}"] > TRAIN_GRAD_REL
                             for f in TRAIN_GRAD_FAULTS),
          f"a broken attention backward reads within the bound: {sound[0]}")
    train_grads_bf16(torch, build, flash_kernels, TRAIN_LAYERS)
    xtrained = train_runs(torch, train, build, flash_kernels,
                          XATTN_TRAIN_LAYERS, arch=XATTN_TRAIN_ARCH,
                          seq=XATTN_TRAIN_SEQ)
    train_parity(torch, train, xtrained, XATTN_TRAIN_ARCH)
    xattn_step_parity(torch, flash_kernels)
    for arch, n, rows, seq in XATTN_GRADS:
        train_grads_bf16(torch, build, flash_kernels, n, arch=arch,
                         rows=rows, seq=seq)

    # ---------------- multi-head latent attention and mixture-of-experts
    mserved, mtrained = {}, {}
    for arch, n in MOE_SERVE.items():
        mserved[arch] = serve_runs(torch, serve, build, flash_kernels, arch,
                                   SERVE_PROMPT, n)
        serve_parity(torch, serve, mserved[arch], arch, SERVE_PROMPT, n)
    for arch in MOE_TRAIN:
        mtrained[arch] = train_runs(torch, train, build, flash_kernels,
                                    TRAIN_LAYERS, arch=arch)
        train_parity(torch, train, mtrained[arch], arch)
        train_grads_bf16(torch, build, flash_kernels, TRAIN_LAYERS,
                         arch=arch)

    # ------------------------------------------ the recurrent layer kinds
    rserved, rtrained = {}, {}
    for arch in RECURRENT_SERVE:
        rserved[arch] = serve_runs(torch, serve, build, flash_kernels, arch,
                                   SERVE_PROMPT)
    serve_parity(torch, serve, rserved[RG_ARCH], RG_ARCH, SERVE_PROMPT)
    for arch, n in RECURRENT_TRAIN.items():
        # a short run first takes the first-call costs at its shapes
        train.run(arch, **dict(TRAIN_KW, n_layers=n, steps=1, k_edge=1,
                               seq=1024), device="cuda")
        rtrained[arch] = train_runs(torch, train, build, flash_kernels, n,
                                    arch=arch)
        train_parity(torch, train, rtrained[arch], arch)
    train_grads_bf16(torch, build, flash_kernels, RECURRENT_TRAIN[RG_ARCH],
                     arch=RG_ARCH)
    rg_f32 = rg_f32_phase(torch, train, build, flash_kernels, randn, record)

    # ------------------------------------------------ the example drivers
    # the per-row SGD kernel at every row count the sweep drivers' buckets
    # can give it, at REDUCED's leaves, before the drivers' counts are reset
    sgd_rows_check({r: 1 for r in EXAMPLE_ROWS}, rspecs)
    examples_phase(torch, build)

    if "--profile" in sys.argv[1:]:
        emit({"profile": profile_run(torch, lambda: BHFLSimulator(
            setting, "hieavg", "temporary", "temporary", device="cuda",
            kernel_mode="auto").run())})
        emit({"profile_sweep": {"plan": "switched", **profile_run(
            torch, lambda: fl.run_sweep(
                dataclasses.replace(DEFAULT, t_global_rounds=SWEEP_T),
                SWITCHED_SEEDS, overrides=list(SWITCHED), device="cuda",
                kernel_mode="auto", **SWEEP_KW))}})
        emit({"profile_train": {"layers": TRAIN_LAYERS, **profile_run(
            torch, lambda: train.run(
                TRAIN_ARCH, **dict(TRAIN_KW, n_layers=TRAIN_LAYERS, steps=1,
                                   k_edge=1), device="cuda"))}})
        for arch, prompt in ((SERVE_ARCH, SERVE_PROMPT),
                             *XATTN_SERVE.items(),
                             ("minicpm3-4b", SERVE_PROMPT),
                             ("deepseek-v2-lite-16b", SERVE_PROMPT),
                             *((a, SERVE_PROMPT) for a in RECURRENT_SERVE)):
            for label, gen in (("prefill", 1), ("decode", SERVE_GEN)):
                # gen 1 is the prefill alone; the decode's share is the
                # rest
                emit({"profile_serve": {"arch": arch, "part": label,
                                        **profile_run(torch, lambda: serve.run(
                                            arch, smoke=False,
                                            batch=SERVE_BATCH,
                                            prompt_len=prompt, gen=gen,
                                            device="cuda",
                                            progress=False))}})
    if "--full" in sys.argv[1:]:
        for label in ("hieavg", "fedavg", "delayed_grad"):
            emit({"full_run": full_runs(torch, BHFLSimulator, DEFAULT,
                                        label)})
        emit({"fig2": fig2_runs(run_comparison, DEFAULT)})
        emit({"fig3": fig3_full(torch, fl, DEFAULT)})
        emit({"population_full": population_full(torch, fl, core, DEFAULT)})
        torch.cuda.reset_peak_memory_stats()
        res = serve.run(SERVE_ARCH, smoke=False, batch=1,
                        prompt_len=SERVE_LONG_PROMPT, gen=SERVE_GEN,
                        device="cuda", progress=False)
        check("serve", bool(np.isfinite(res["logits"]).all()),
              "long prompt: logits not finite")
        emit({"serve_long": {
            "arch": SERVE_ARCH, "batch": 1, "prompt": SERVE_LONG_PROMPT,
            "gen": SERVE_GEN, "prefill_s": res["t_prefill"],
            "decode_tokens_per_s": SERVE_GEN / res["t_decode"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}})
        emit({"train_full": train_runs(
            torch, train, build, flash_kernels,
            get_config(TRAIN_ARCH).n_layers,
            modes=("auto",), finite=False)["auto"][2]})
        for n in (12, get_config(TRAIN_ARCH).n_layers):
            emit({"train_grads_depth": train_grads(torch, flash_kernels, n,
                                                   "bfloat16")})

    launches = {k: runs[LAUNCHES_FROM.get(k, "hieavg"), "auto"][1].get(k, 0)
                for k in REPLACES if k in RUN_LAUNCHES}
    launches["flash_attention"] = served["auto"][1].get("flash_attention", 0)
    launches["flash_attention_bwd"] = trained["auto"][1].get(
        "flash_attention_bwd", 0)
    main_runs = {"serve": {**xserved, **mserved, **rserved},
                 "train": {XATTN_TRAIN_ARCH: xtrained, **mtrained,
                           **rtrained}}
    for (name, label), (path, arch) in FLASH_TIMED_RUNS.items():
        shapes = main_runs[path][arch]["auto"][-1]
        launches[f"{name}[{label}]"] = shapes[timed_key(name, label)]
    launches["sgd_update[rows]"] = sweep_launches.get("sgd_update[rows]", 0)
    for label, (d, b_, h, wd, ci, co) in CONV_WIDE.items():
        for name in ("conv3x3_fwd", "conv3x3_bwd"):
            launches[f"{name}[{label}]"] = geometry[label][
                (name, d, b_, h, wd, ci, co)]
    launches["flash_attention_bwd[rg_f32]"] = sum(
        n for key, n in rg_f32.items() if key[0] == "flash_attention_bwd")
    for (name, label), part in SHARD_RUNS.items():
        b, (sq, skv), dh, (h, hkv), _, _ = FLASH_SHARD[label]
        key = list(flash_key(name, b, sq, skv, h, hkv, dh, True))
        launches[f"{name}[{label}]"] = sum(
            row[-1] for row in meshed[part]["launches_by_shape"]
            if row[:-1] == key)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"]} for k in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
