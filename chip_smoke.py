#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dtqn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the attention kernels from dtqn_tpu_torch/csrc with nvcc and
     print each instance's registers and spills (-Xptxas -v);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the edges of every kernel instance
     (PARITY_CASES; float32, TF32 off; atol 2e-5 forward, 5e-5
     gradients), and check that two backward launches are bit-equal at
     every shape;
  4. drive the main path through the port's entry points at the flagless
     bench.py configuration (DiscreteCarFlag-v0, DTQN in_embed 64, 8 heads,
     2 layers, context 50, batch 32, 64 envs, buffer 500k, target update
     10k): init, random prepopulation, two train iterations of 64 updates;
     check the launch counts, the updates and the Q-values against the
     plain path on the CPU;
  5. runner: ``run_experiment`` at the same configuration in a temporary
     directory (prepopulation 40 000, two chunks of 128 env steps, each
     followed by a 10-episode evaluation, policy saved): CSV headers and
     rows, finite losses, policy file and completion sentinel, exact
     launch counts, the saved policy's Q on the card against the CPU's;
  6. resume: the same run cut by a time limit after its first chunk (the
     full checkpoint's size and save / load seconds are printed), resumed
     by a second call, and its final parameters compared bit for bit with
     phase 5's uninterrupted run;
  7. discrete observations: Memory-5-v0, DTQN in_embed 128 (head width
     16), 64 envs: prepopulation, one train iteration of 64 updates, one
     evaluation; launch counts, updates, card Q against CPU Q;
  8. evaluation alone: the main path's network evaluated eager
     (``make_evaluate_fn``) and graphed (``make_evaluate``: a reset and
     blocks of env steps replayed as CUDA graphs) in turns (eager,
     graphed, graphed, eager), results, launches by shape and generators'
     end states bit-equal (``evaluation_turns``; the bag of 25, DRQN on
     Memory-5 and 5 stacked seeds likewise in phases 9, 11 and 16), the
     captures' seconds and the graph pool's bytes; the graphed evaluation
     with the early-exit read every 10 steps (the default), every step and
     never, all giving the same numbers, each timed and profiled (device
     operations, busy share); the runner's chunk loop at
     ``--eval-frequency 5000`` over 5 chunks whose evaluations are graphed,
     then eager and graphed in turns: env-steps/s with the evaluations and
     their share of the wall time;
  9. the bag: DTQN-bag on gv_memory.7x7.yaml at in_embed 128 (head width
     16), bag 25, 64 envs, batch 32, buffer 500k: prepopulation, two train
     iterations with every attention launch's shape reckoned from the
     configuration and counted exactly, card Q against CPU Q, one
     evaluation; the same with ``bag_mask`` (the bag attention launches
     nothing); a ``bag_store`` run through ``run_experiment``, whole, then
     cut and resumed bit-equal; Car Flag at in_embed 64 with bag 10; device
     operations of one act step, one update and one evict forward;
 10. the classic POMDPs: DTQN at in_embed 64 (head width 8) on
     POMDP-hallway-episodic-v0 (data/hallway.pomdp's tables; the parser
     that served is printed) and on POMDP-heavenhell_3-episodic-v0 (at a
     50-step cap, so that a context of 50 fits an episode), 64 envs:
     prepopulation, two train iterations and one evaluation each, every
     attention launch counted by shape against the reckoning, card Q
     against CPU Q, gradients repeating bit for bit; the host time of an
     update of each, timed in turns with the main path's;
 11. the baselines: DRQN and DQN on Memory-5-v0 at in_embed 128, ADRQN on
     Hallway and DARQN on DiscreteCarFlag-v0 at in_embed 64, 64 envs,
     batch 32, context 50 (1 for DQN): prepopulation, two train
     iterations, one evaluation, no attention launch, card Q against CPU
     Q, gradients repeating, device operations of an update and an act
     step; a DRQN run through ``run_experiment`` whole, then cut and
     resumed bit-equal;
 12. images: DTQN on ImageMaze-9-v0 at in_embed 128 (uint8 CHW
     observations through the five-convolution embedder), 64 envs:
     prepopulation, two train iterations and one evaluation with every
     attention launch counted by shape against the reckoning, card Q
     against CPU Q, gradients repeating bit for bit, device operations and
     a profiled iteration; the embedder's convolutions (unfold + GEMM)
     timed against cuDNN's on the update's 1600 images; a run through
     ``run_experiment`` whole, then cut and resumed bit-equal;
 13. several domains: DTQN at in_embed 128 on gv_memory_four_rooms 7x7 and
     9x9, a domain drawn per episode: two train iterations reckoned, card Q
     against CPU Q, operations, one evaluation per domain on its own padded
     env;
 14. the ablations on the flagless configuration: the GRU gate with the
     identity layer and sin positions, none positions, and dropout 0.1
     (whose updates are train-mode forwards in stock ops: they launch
     nothing), each with two train iterations reckoned, card Q against
     CPU Q, gradients repeating (under dropout from one generator state),
     operations and a profiled iteration; ``attention_weights`` on the card
     against the CPU with and without a bag; the updates of each, of the
     image and four-rooms paths and of the main path timed in turns;
 15. continuous Car Flag: 200 steps of random forces on 64 envs, the card
     against the CPU, bit for bit;
 16. the multi-seed sweep: the flagless configuration at 5 stacked seeds
     (each 64 envs and a 500k buffer): prepopulation, two train iterations
     with every attention launch reckoned at the seeds' folded batches,
     one evaluation per seed, card Q against CPU Q per seed, gradients
     repeating; its update against the main path's in turns (1, 5, 5, 1
     seeds): device kernels (at most 2x, and as many attention launches),
     device time, host time, and the aggregate env-steps/s of an
     iteration; a profiled iteration of each; the bag at 2 seeds (evict
     forward at 2 * 1664) and at 1 and 5 seeds timed in turns;
     ``run_sweep`` at 2 seeds whole, then cut and resumed bit-equal;
 17. time each kernel, its plain version and the matching PyTorch call
     (scaled_dot_product_attention, timed here only) at the causal and the
     bag's non-causal shapes of the driven paths, the sweep's folded ones
     included, inside CUDA graphs so that host launch cost is left out;
     then the streamed <16, 0> at head width 16, Lk = 50 (B = 32 and
     1664), held against its plain version and timed in turns with the
     staged <16, 2> that the shape picks;
 18. profile one more train iteration (torch.profiler): the device's busy
     share, device operations per update and the costliest kernels; the
     same for one iteration of each run of phases 10-12 and 14 but
     ADRQN's;
 19. bf16 (the JAX package's --bf16): each bf16 instance against its plain
     version in bf16 (BF16_PARITY_CASES: within 1 bf16 ulp plus the
     float32 tolerance; two backward launches bit-equal): the tensor-core
     form that every bf16 call at head width 8 or 16 with Lk (and,
     backward, Lq) up to 64 takes, the keys-on-lanes instance that such a
     shape took before it (launched by configuration), and the others;
     the tensor-core form on a cancellation input, where P rounded once to
     bf16 fails (BF16_CANCELLATION_CASES); the flagless
     configuration in bf16 (two iterations, every launch a bf16 one at a
     shape held in bf16, card Q against CPU Q within BF16_Q_ULPS bf16 ulps
     with cuBLAS's reduced-precision bf16 reduction off, the error with it
     on reported) against phase 4's float32 run in turns (f32, bf16, bf16,
     f32): operations, attention launches and device ms per update
     (profiled), host ms per update, env-steps/s, busy share; the bag of
     25, DRQN on Memory-5 and ImageMaze in bf16 (device ms of an update, an
     act step and the evict forward beside phases 9, 11 and 12's; the
     LSTM's outputs float32, the CNN's bf16); the runner in bf16 with
     --profile-dir (the trace holds one chunk's bf16 attention kernels,
     the phases file its last replay by phase), cut and resumed
     bit-equal; ``run_sweep`` in bf16 at 2 seeds; Car Flag
     with bag 10 and the flagless configuration at 2 stacked seeds in bf16
     (launches reckoned by shape and form: every bf16 launch of a driven
     path takes the tensor-core form); the bf16 kernels timed at every
     driven bf16 shape, each in turns with the keys-on-lanes instance that
     it replaced (SDPA in bf16 the library call);
 20. several devices: the state of phase 4's configuration saved as a
     one-device checkpoint and trained in turns on 1, 2, 2 and 1 ranks
     (two processes on the one card, gloo: NCCL refuses two ranks on one
     device), each turn 4 iterations of 64 updates with the target update
     every 100 applied steps (not 10 000, so that the turn crosses target
     swaps), through ``make_distributed_train_chunk``; the 2-rank state
     against the 1-rank one (parameters and targets within rtol 2e-4 /
     atol 2e-5, diagnostics within rtol 1e-3 / atol 1e-4, counters,
     flushed_total, generator, replay, contexts and env state equal; the
     largest differences printed), repeated turns bit-equal; every
     attention launch of each rank counted by shape (update at B=16, act
     at B=32) and held; per turn the env-steps/s of an iteration, host and
     device ms per update and, over 2 ranks, the collectives per update
     and their host ms; then ``run_experiment`` with --dp-devices 2 whole,
     cut and resumed (final parameters bit-equal), and the cut run's
     checkpoint resumed by a one-device run;
 21. the host loop (MiniHack's runner, ``train/host_loop.py``) on host envs
     defined here: ``run_host_experiment`` trained from scratch on the cue
     task at the JAX validation configuration (in_embed 32, context 8, 8
     heads: head width 4, padded to <8, 1>; 32 envs, batch 32,
     prepopulation 1000) for 4992 env steps, its final success rate above
     0.8, every attention launch reckoned by shape and held, the saved
     policy's Q on the card against the CPU's; at full width (the JAX
     CLI's defaults for MH-Room-5-v0: in_embed 128, context 50, 32 envs) on
     a glyph room shaped like MH-Room-5-v0's crop (81 int32 tokens, mask
     5977, 8 actions, 100-step cap): 110 prepopulation iterations, an
     iteration clocked part by part (device-to-host copy of the actions,
     the host envs' step, host-to-device copies: counts, bytes, ms), one
     timed (env-steps/s) and one profiled (device ms and operations, busy
     share), launches reckoned, card Q against CPU Q, gradients repeating,
     an update's peak memory, one evaluation; one bf16 iteration (every
     launch the tensor-core form, card Q within BF16_Q_ULPS); the runner
     whole, then cut by the time limit and resumed (the loaded state bit
     for bit the saved one).  The functions are CUDA graphs
     (``make_host_fns``, ``make_host_eval``): from one saved state and
     deep-copied host envs the plain bodies and the graphs train two
     iterations bit-equal in every leaf and launch, then run in turns
     (eager, graphed, graphed, eager: wall and host ms, env-steps/s) and
     profiled (device ms, busy share) and clocked part by part each,
     still bit-equal; the evaluation eager, then graphed twice, equal in
     results and generator state.  Phase 17 also times <8, 1> at the cue
     task's B=32, Lq = Lk = 8, D=4;
 22. CUDA graphs: the flagless configuration in float32 and in bf16, the
     bag of 25, DRQN on Memory-5, ImageMaze, dropout 0.1 and 5 stacked
     seeds, each prepopulated through ``make_prepopulate`` and saved, and
     from the saved state a chunk of 3 iterations of 64 updates eager
     (``make_train_chunk_fn``, from the checkpoint) and graphed
     (``make_train_chunk``: a warm-up, the capture and two replays): every
     leaf of the two states, each generator's state, launch_counts and
     the launches by shape bit-equal; the capture's seconds and the graph
     pool's bytes; for the flagless configuration in both dtypes a second
     chunk (replays only, the graph reused), held the same way, then eager
     and graphed chunks in turns (host ms, wall ms and env-steps/s per
     iteration) and a graphed chunk profiled (device ms, busy share).
     After each compared chunk, one evaluation of each state's network,
     eager and graphed, bit-equal (results, launches, generators); for
     the flagless paths the second one replays between two graphed
     chunks, and the chunks after it stay bit-equal to eager ones;
 23. tracing (``utils/profiling.py``): the flagless configuration and the
     bag of 25, at one seed and five, each prepopulated, saved and loaded
     twice: 20 iterations of one through a chunk captured with tracing
     off, of the other through one captured with it on (the phases'
     boundary events recorded into the graph): every leaf bit-equal; then
     two iterations of each graph profiled, the second read (a session
     drops records at its start): the same kernels by name and count
     (copies and fills apart, as the benchmark counts), and the traced
     graph's phases (``GraphedStep.phase_ms``, each above 0,
     ``evict`` only with the bag) summing to within 3% of the replay's
     device span (its first operation's start to its last one's end);
     then the two chunks timed in turns (off, on, on, off: device ms an
     iteration), and the leaves bit-equal still;
 24. the optimizer kernels (``ops/cuda_optimizer.py``, the step after the
     gradient) against the plain PyTorch chain on the card at the
     benchmark networks' parameter vectors, [107779], [5, 107779],
     [509142] and [5, 509142]: the norm below and above the clip, a seed
     gated off, a non-finite gradient and a target swap (train_steps
     9 999 -> 10 000), at 5 seeds one a seed, at one each in a call: the
     norm within 1e-6 of ``torch.linalg.vector_norm``'s, parameters,
     moments, target, counters and gate bit-equal to the chain fed the
     kernels' norm, the gated and non-finite seeds' state unchanged, each
     call 2 launches; a graph replay bit-equal to an eager call, counting
     2 launches; the device ms of the pair and of the chain beside the
     bytes' bound.  (Every training path of the phases before counts the
     two kernels' launches from zero, one of each an update, and every
     evaluation none.)  Alone: ``python3 -c 'import chip_smoke as c;
     c.optimizer_phase(0)'``.

Every phase on the card trains and evaluates through the compiled entry
points (``train/loop.py``: ``make_prepopulate`` and ``make_train_chunk``,
one iteration captured as a CUDA graph and replayed; ``make_evaluate``, a
reset and blocks of env steps; ``train/host_loop.py``: the host loop's
device halves), directly or through ``run_experiment``,
``run_host_experiment`` and ``run_sweep``, but phase 20's ranks, which
train eager (rank 0's evaluation is graphed).  A replay runs no Python,
so the greedy calls and the launches by shape that the phases reckon are
counted through ``utils.graphs.TRACKED_COUNTERS`` (``install_counters``):
a replay adds what its capture counted.

Before the last line it prints the script's total seconds, the card line
and one ``{"kernels": [...]}`` JSON line (each kernel with its dtype: the
float32 instances, then the bf16 ones under ``*_bf16`` with their form);
the last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import csv
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
Q_ATOL = 1e-4
# bf16: a kernel's output within 1 bf16 ulp of its plain version's, plus
# the float32 tolerance (the same products summed in another order can
# flip one rounding); the card's Q within BF16_Q_ULPS bf16 ulps (at the
# largest |Q|) of the CPU's: each bf16 GEMM on the way sums in another
# order on the card and may round the other way.
BF16_Q_ULPS = 8
# The CNN's float32 pre-activations against float64 at the update's 1600
# images, relative to each layer's largest entry: float32 sums over at most
# 1152 products stay near 1e-6, where TF32's 10-bit mantissa gives ~1e-3.
CONV_FWD_RTOL = 1e-5
DEVICE = "cuda"  # where every phase runs; a dry run of the script's own
# control flow on a machine without a GPU may set it to "cpu"
KERNEL_SOURCE = "dtqn_tpu_torch/csrc/attention.cu"
GV_ENV, GV_BAG = "gv_memory.7x7.yaml", 25  # the bag configuration
HALLWAY, HEAVENHELL = ("POMDP-hallway-episodic-v0",
                       "POMDP-heavenhell_3-episodic-v0")
# The baselines' runs: (model, env, in_embed).
BASELINES = [("DRQN", "Memory-5-v0", 128), ("DQN", "Memory-5-v0", 128),
             ("ADRQN", HALLWAY, 64), ("DARQN", "DiscreteCarFlag-v0", 64)]
# The instances that driven paths launch: head width 8 (Car Flag, the
# POMDPs, the Car Flag bag) and 16 (in_embed 128), keys on lanes in
# float32 and the tensor-core form (keys per lane -1, MMA_FORM) in bf16.
DRIVEN_INSTANCES = ((8, 1), (8, 2), (16, 2), (8, -1), (16, -1))
REPLACES = {
    "attention_fwd": "dtqn_tpu/ops/pallas_attention.py:62",
    "attention_bwd": "dtqn_tpu/ops/pallas_attention.py:77",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rand(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at each value of ``x`` (0 at 0)."""
    m, e = torch.frexp(x.float())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


# ------------------------------------------------------------------ parity
# (B, Lq, Lk, heads, causal, E): the main path's act and update shapes;
# unaligned and cross-attention shapes; Lk at the keys-per-lane edges
# (1, 32, 33, 64, 65); B = 1; causal L = 1; head widths 16, 32 and 64; and
# head widths 4 and 12, which the kernels pad and load a float at a time.
# Then the evaluation's batch of 10 and the discrete path's head width 16,
# and last the bag path: context queries over bag keys at the update's, the
# act step's and the evict forward's batch (gv_memory: bag 25, head width
# 16, 64 * 26 candidates; Car Flag: bag 10, head width 8, 64 * 11), and the
# bag evaluation's 10 episodes (greedy forward at 10, evict forward at
# 10 * 26).  Then the staged <16, 2>'s edges at head width 16 (Lk 33, 50
# and 64, causal and not, B = 1; Lq != Lk; Lq past one 64-row forward tile;
# a backward past 48 KB of shared memory) and the shapes past Lk = 64 that
# still take the streamed <16, 0>.  Between them they reach every kernel
# instance, and check_ledger refuses a launch of a driven path at a shape
# not listed.
PARITY_CASES = [
    (64, 50, 50, 8, True, 64), (32, 50, 50, 8, True, 64),
    (4, 7, 3, 8, False, 64), (4, 1, 50, 8, False, 64),
    (4, 50, 10, 8, False, 64),
    (4, 50, 1, 8, False, 64), (4, 50, 32, 8, False, 64),
    (4, 50, 33, 8, False, 64), (4, 50, 64, 8, False, 64),
    (4, 50, 65, 8, False, 64), (2, 64, 64, 8, True, 64),
    (2, 65, 65, 8, True, 64),
    (1, 50, 50, 8, True, 64), (4, 1, 1, 8, True, 64),
    (2, 20, 20, 4, False, 64), (3, 50, 50, 4, True, 64),
    (2, 100, 100, 2, True, 64), (2, 50, 50, 1, True, 64),
    (2, 7, 65, 1, False, 64),
    (2, 30, 30, 16, True, 64), (2, 40, 40, 4, True, 48),
    (10, 50, 50, 8, True, 64), (64, 50, 50, 8, True, 128),
    (32, 50, 50, 8, True, 128), (10, 50, 50, 8, True, 128),
    (32, 50, 25, 8, False, 128), (64, 50, 25, 8, False, 128),
    (1664, 50, 25, 8, False, 128), (1664, 50, 50, 8, True, 128),
    (32, 50, 10, 8, False, 64), (64, 50, 10, 8, False, 64),
    (1664, 50, 10, 8, False, 64), (704, 50, 50, 8, True, 64),
    (10, 50, 25, 8, False, 128), (260, 50, 25, 8, False, 128),
    (260, 50, 50, 8, True, 128), (704, 50, 10, 8, False, 64),
    (1, 33, 33, 8, True, 128), (1, 33, 33, 8, False, 128),
    (1, 50, 50, 8, True, 128), (1, 50, 50, 8, False, 128),
    (1, 64, 64, 8, True, 128), (1, 64, 64, 8, False, 128),
    (2, 7, 50, 8, False, 128), (4, 1, 64, 8, False, 128),
    (3, 100, 33, 8, False, 128), (2, 130, 64, 8, False, 128),
    (2, 100, 100, 8, True, 128), (2, 7, 65, 8, False, 128),
    # The sweep's folded batches (the seeds' batches in one launch): Car
    # Flag at 5 seeds (update 5 * 32, act 5 * 64, evaluation 5 * 10) and the
    # runner at 2 (act 2 * 64, evaluation 2 * 10); the bag at 2 seeds (act
    # 2 * 64, evict 2 * 64 * 26; its update is the single act's 64) and at 5
    # (update 5 * 32, act 5 * 64, evict 5 * 64 * 26).
    (160, 50, 50, 8, True, 64), (320, 50, 50, 8, True, 64),
    (50, 50, 50, 8, True, 64), (128, 50, 50, 8, True, 64),
    (20, 50, 50, 8, True, 64),
    (128, 50, 50, 8, True, 128), (128, 50, 25, 8, False, 128),
    (3328, 50, 50, 8, True, 128), (3328, 50, 25, 8, False, 128),
    (160, 50, 50, 8, True, 128), (160, 50, 25, 8, False, 128),
    (320, 50, 50, 8, True, 128), (320, 50, 25, 8, False, 128),
    (8320, 50, 50, 8, True, 128), (8320, 50, 25, 8, False, 128),
    # Phase 20's ranks: the flagless update's batch of 32 over 2 ranks
    # (each rank's act forward, at 32 of the 64 envs, is listed above).
    (16, 50, 50, 8, True, 64),
    # Phase 21's cue task (head width 4, context 8, 32 envs): the act step
    # and the update at 32, the evaluation at 10.  (Its full-width glyph
    # room launches at shapes listed above: 32 and 10 at head width 16.)
    (32, 8, 8, 8, True, 32), (10, 8, 8, 8, True, 32),
]


# The bf16 instances' shapes (B, Lq, Lk, heads, causal, E): every shape a
# bf16 drive launches (phase 19: the flagless path's update, act and
# evaluation, and at 2 seeds folded; the bag of 25's update, act and evict
# forward; the Car Flag bag of 10's, its evict forward's causal layers at
# 64 * 11 included; ImageMaze's update and act), and one streamed shape
# per head width.
BF16_PARITY_CASES = [
    (32, 50, 50, 8, True, 64), (64, 50, 50, 8, True, 64),
    (10, 50, 50, 8, True, 64), (128, 50, 50, 8, True, 64),
    (20, 50, 50, 8, True, 64),
    (32, 50, 50, 8, True, 128), (64, 50, 50, 8, True, 128),
    (10, 50, 50, 8, True, 128), (1664, 50, 50, 8, True, 128),
    (32, 50, 25, 8, False, 128),
    (64, 50, 25, 8, False, 128), (1664, 50, 25, 8, False, 128),
    (32, 50, 10, 8, False, 64), (64, 50, 10, 8, False, 64),
    (704, 50, 10, 8, False, 64), (704, 50, 50, 8, True, 64),
    (4, 50, 65, 8, False, 64), (2, 100, 100, 8, True, 128),
    (2, 100, 100, 2, True, 64), (2, 50, 50, 1, True, 64),
]


def bf16_held(ca, args, cfgs):
    """The bf16 forward and backward of ``args`` (q, k, v, dout, heads,
    causal) launched by ``cfgs`` (kind -> launch configuration, or None for
    the counted wrappers, which pick their own) against the plain versions:
    each kind's largest error and its excess over 1 bf16 ulp plus the
    float32 tolerance; two backward launches must be bit-equal."""
    q, k, v, dout, h, causal = args
    if cfgs is None:
        out = ca.attention_fwd(q, k, v, h, causal)
        grads = ca.attention_bwd(q, k, v, dout, h, causal)
        again = ca.attention_bwd(q, k, v, dout, h, causal)
    else:
        out = ca.launch_fwd(q, k, v, h, causal, cfgs["attention_fwd"])
        grads = ca.launch_bwd(q, k, v, dout, h, causal, cfgs["attention_bwd"])
        again = ca.launch_bwd(q, k, v, dout, h, causal, cfgs["attention_bwd"])
    ref = ca.plain_attention_fwd(q, k, v, h, causal)
    ref_grads = ca.plain_attention_bwd(q, k, v, dout, h, causal)
    torch.cuda.synchronize()
    check(out.dtype == ref.dtype == torch.bfloat16
          and all(g.dtype == torch.bfloat16 for g in grads),
          "a bf16 call returned another dtype")
    check(all(torch.equal(a, r) for a, r in zip(grads, again)),
          "two bf16 attention_bwd launches on the same inputs differ")
    result = {}
    for kind, got, want, atol in (
            ("attention_fwd", (out,), (ref,), FWD_ATOL),
            ("attention_bwd", grads, ref_grads, GRAD_ATOL)):
        err, excess = 0.0, -1.0
        for a, r in zip(got, want):
            diff = (a.float() - r.float()).abs()
            err = max(err, diff.max().item())
            excess = max(excess, (diff - bf16_ulp(r) - atol).max().item())
        result[kind] = (err, excess)
    return result


def cancelling(ca, q, k, v, heads, causal, row):
    """``v`` shifted, per batch row and head, by the float32 output of
    query ``row``, and rounded to bf16: that query's output is ~0 while
    sum_j p_j |v_j| is not, where rounding P once to bf16 shows."""
    o = ca.plain_attention_fwd(q.float(), k.float(), v.float(), heads,
                               causal)
    return (v.float() - o[:, row:row + 1]).bfloat16()


def one_rounding_fwd(q, k, v, heads, causal):
    """The forward with P rounded once to bf16 before P V (float32
    otherwise): what the split P of the tensor-core form avoids."""
    b, lq, e = q.shape
    lk, d = k.shape[1], e // heads

    def split(x):
        return x.float().view(b, x.shape[1], heads, d).transpose(1, 2)

    s = split(q) @ split(k).transpose(-1, -2) * d ** -0.5
    keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
    o = p.bfloat16().float() @ split(v)
    return o.transpose(1, 2).reshape(b, lq, e).bfloat16()


# The cancellation input's shapes (B, Lq, Lk, heads, causal, E): the
# flagless and the in_embed-128 update, query 49 cancelled in every head.
BF16_CANCELLATION_CASES = [(32, 50, 50, 8, True, 64),
                           (32, 50, 50, 8, True, 128)]


def bf16_parity(ca):
    """The bf16 instances against their plain versions in bf16 on the same
    card inputs: within 1 bf16 ulp of the plain value plus the float32
    tolerance, compared in float32; two backward launches bit-equal.  At
    every BF16_PARITY_CASES shape the instance that the wrappers pick, and
    where that is the tensor-core form, also the keys-on-lanes instance
    that the shape took before it (launched by configuration, counting
    nothing); between them they reach every bf16 instance.  Then the
    cancellation input, where the forward with P rounded once fails."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    errs = {"attention_fwd": 0.0, "attention_bwd": 0.0}
    lanes_errs = dict(errs)
    covered = set()
    for b, lq, lk, h, causal, e in BF16_PARITY_CASES:
        q, dout = (rand(gen, b, lq, e).bfloat16() for _ in range(2))
        k, v = (rand(gen, b, lk, e).bfloat16() for _ in range(2))
        args = (q, k, v, dout, h, causal)
        picked = {kind: ca.launch_config(kind, lq, lk, e // h, bf16)
                  for kind in errs}
        runs = [(None, picked, errs)]
        if any(c.keys_per_lane == ca.MMA_FORM for c in picked.values()):
            lanes = {kind: ca.launch_config(kind, lq, lk, e // h, bf16,
                                            lanes=True) for kind in errs}
            runs.append((lanes, lanes, lanes_errs))
        for cfgs, used, into in runs:
            covered.update((c.head_dim_pad, c.keys_per_lane)
                           for c in used.values())
            for kind, (err, excess) in bf16_held(ca, args, cfgs).items():
                form = ca.form_name(used[kind])
                log(f"bf16 parity B={b} Lq={lq} Lk={lk} H={h} D={e // h} "
                    f"causal={causal} {kind} {form}: max err {err:.3e}")
                check(excess <= 0, f"bf16 {kind} {form} at B={b} Lq={lq} "
                                   f"Lk={lk} D={e // h}: past 1 ulp + "
                                   f"tolerance by {excess}")
                into[kind] = max(into[kind], err)
    check(covered == set(ca.instances(bf16)),
          f"bf16 parity reaches instances {sorted(covered)}, not all of "
          f"{sorted(ca.instances(bf16))}")
    cancellation = {}
    for b, lq, lk, h, causal, e in BF16_CANCELLATION_CASES:
        q, dout = (rand(gen, b, lq, e).bfloat16() for _ in range(2))
        k, v = (rand(gen, b, lk, e).bfloat16() for _ in range(2))
        v = cancelling(ca, q, k, v, h, causal, lq - 1)
        ref = ca.plain_attention_fwd(q, k, v, h, causal)
        once = one_rounding_fwd(q, k, v, h, causal)
        row = ref[:, lq - 1]
        once_excess = ((once[:, lq - 1].float() - row.float()).abs()
                       - bf16_ulp(row) - FWD_ATOL).max().item()
        check(once_excess > 0, f"the cancellation input at D={e // h} "
                               f"does not show P rounded once")
        held = bf16_held(ca, (q, k, v, dout, h, causal), None)
        shape = f"B={b} Lq={lq} Lk={lk} H={h} D={e // h} causal={causal}"
        cancellation[shape] = {
            "one_rounding_excess": once_excess,
            "row_abs_max": row.float().abs().max().item(),
            **{kind: {"max_abs_err": err, "excess": excess}
               for kind, (err, excess) in held.items()}}
        log(f"bf16 cancellation {shape}: {json.dumps(cancellation[shape])}")
        for kind, (err, excess) in held.items():
            check(excess <= 0, f"bf16 {kind} on the cancellation input at "
                               f"{shape}: past 1 ulp + tolerance by {excess}")
    return {"picked": errs, "lanes": lanes_errs,
            "cancellation": cancellation}


def parity(ca):
    """Each kernel against its plain version on the same card inputs, and
    two backward launches against each other (bit-equal)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"attention_fwd": 0.0, "attention_bwd": 0.0}
    covered = set()
    for b, lq, lk, h, causal, e in PARITY_CASES:
        pairs = []
        for kind in errs:
            cfg = ca.launch_config(kind, lq, lk, e // h)
            pairs.append((cfg.head_dim_pad, cfg.keys_per_lane))
        covered.update(pairs)
        q, dout = rand(gen, b, lq, e), rand(gen, b, lq, e)
        k, v = rand(gen, b, lk, e), rand(gen, b, lk, e)
        out = ca.attention_fwd(q, k, v, h, causal)
        ref = ca.plain_attention_fwd(q, k, v, h, causal)
        grads = ca.attention_bwd(q, k, v, dout, h, causal)
        again = ca.attention_bwd(q, k, v, dout, h, causal)
        ref_grads = ca.plain_attention_bwd(q, k, v, dout, h, causal)
        torch.cuda.synchronize()
        e_fwd = (out - ref).abs().max().item()
        e_bwd = max((a - r).abs().max().item()
                    for a, r in zip(grads, ref_grads))
        log(f"parity B={b} Lq={lq} Lk={lk} H={h} D={e // h} "
            f"causal={causal} {pairs}: fwd {e_fwd:.3e} bwd {e_bwd:.3e}")
        check(e_fwd <= FWD_ATOL, f"attention_fwd disagrees: {e_fwd}")
        check(e_bwd <= GRAD_ATOL, f"attention_bwd disagrees: {e_bwd}")
        check(all(torch.equal(a, r) for a, r in zip(grads, again)),
              "two attention_bwd launches on the same inputs differ")
        errs["attention_fwd"] = max(errs["attention_fwd"], e_fwd)
        errs["attention_bwd"] = max(errs["attention_bwd"], e_bwd)
    check(covered == set(ca.INSTANCES),
          f"parity reaches instances {sorted(covered)}, not all of "
          f"{sorted(ca.INSTANCES)}")
    # The act path and the DDQN selector take the first maximum, as
    # jnp.argmax does.
    ties = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]], device="cuda")
    check(torch.argmax(ties, dim=-1).tolist() == [1, 0],
          "torch.argmax on the card does not take the first maximum")
    return errs


# --------------------------------------------------------------- main path
def main_path(seed, ca):
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import make_prepopulate, make_train_chunk
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    num_envs, updates = 64, 64
    cfg = AgentConfig(
        model="DTQN", num_envs=num_envs, context_len=50, history=50,
        inner_embed=64, num_heads=8, num_layers=2, batch_size=32,
        buffer_size=500_000, target_update_frequency=10_000,
    )
    agent = Agent(cfg, make_env("DiscreteCarFlag-v0"))  # the card
    check(agent.device.type == "cuda", "Agent did not default to cuda")
    prepopulate = make_prepopulate(agent, max(40_000 // num_envs, 1))
    train_iter = make_train_chunk(
        agent, EpsilonSchedule(1.0, 0.1, 200_000),
        updates_per_iter=updates, iters_per_chunk=1,
    )

    reset_launch_counts()
    t0 = time.perf_counter()
    state = agent.init_state(seed)
    prepopulate(state)
    torch.cuda.synchronize()
    t_prepop = time.perf_counter() - t0
    flushed = int(state.buffer.flushed_total)
    check(flushed > cfg.batch_size, f"prepopulation flushed only {flushed}")
    train_iter(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_iter(state)
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = launch_counts()
    optimizer_launches(2 * updates, "main path")

    train_steps = int(state.train_steps)
    nonfinite = int(state.nonfinite_grads)
    check(train_steps == 2 * updates, f"train_steps {train_steps}")
    check(nonfinite == 0, f"{nonfinite} non-finite gradient steps")
    # Per iteration: one act forward, and per update three forwards
    # (policy and target on next_obs, the loss) and one backward; two
    # layers each.
    layers = cfg.num_layers
    expect_fwd = 2 * layers * (1 + 3 * updates)
    expect_bwd = 2 * layers * updates
    check(launches["attention_fwd"] == expect_fwd,
          f"attention_fwd launched {launches['attention_fwd']} times, "
          f"expected {expect_fwd}")
    check(launches["attention_bwd"] == expect_bwd,
          f"attention_bwd launched {launches['attention_bwd']} times, "
          f"expected {expect_bwd}")
    diags = {k: float(v) for k, v in state.diagnostics.means().items()}
    check(all(map(math.isfinite, diags.values())),
          f"diagnostics not finite: {diags}")

    # What comes out is right: the trained policy's Q on the run's own
    # contexts, kernel path on the card vs plain path on the CPU.
    cpu_net = agent.build_network()
    cpu_net.load_state_dict(state.network.state_dict())
    with torch.no_grad():
        q_gpu = state.network(state.context.obs, state.context.action)
        q_cpu = cpu_net(state.context.obs.cpu(), state.context.action.cpu())
    check(tuple(q_gpu.shape) == (num_envs, 50, 3), f"Q shape {q_gpu.shape}")
    check(bool(torch.isfinite(q_gpu).all()), "non-finite Q on the card")
    q_err = (q_gpu.cpu() - q_cpu).abs().max().item()
    check(q_err <= Q_ATOL, f"card Q differs from CPU Q by {q_err}")

    result = {
        "env_steps_per_s": num_envs / t_iter,
        "updates_per_s": updates / t_iter,
        "timed_iteration_s": t_iter,
        "init_and_prepopulate_s": t_prepop,
        "prepopulation_graph": graph_stats(prepopulate),
        "iteration_graph": graph_stats(train_iter),
        "flushed_episodes": flushed,
        "train_steps": train_steps,
        "nonfinite_grads": nonfinite,
        "launches": launches,
        "q_max_abs_err_vs_cpu": q_err,
        "diagnostics": diags,
    }
    log(f"main path: {json.dumps(result)}")
    return result, agent, state, train_iter


def device_events(fn):
    """Runs ``fn()`` under torch.profiler: (its wall time in us, {device
    operation name: (count, device us)}).  Reads the profiler's raw records:
    building its event tree takes ~0.2 ms per event, minutes for the
    recurrent models' iterations (~200 000 kernels each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        n, us = by_name.get(ev.name(), (0, 0.0))
        by_name[ev.name()] = (n + 1, us + (ev.end_ns() - ev.start_ns()) / 1e3)
    return wall_us, by_name


def profile_iteration(state, train_iter, updates=64, top=12,
                      what="one train iteration"):
    """Where one train iteration's time goes (torch.profiler): the device's
    busy share of the wall time, kernel launches, and the kernels with the
    most device time.  One unprofiled call first: a compiled chunk whose
    state moved since its capture (an eager step in between) captures
    again there, and the profile holds replays only."""
    train_iter(state)
    wall_us, by_name = device_events(lambda: train_iter(state))
    check(by_name, f"{what}: the profiler recorded no device operation")
    device_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    attention = {}
    for kind in ("attention_fwd", "attention_bwd"):
        hits = [nu for name, nu in by_name.items()
                if f"{kind}_kernel" in name or f"{kind}_mma" in name]
        attention[kind] = {"count": sum(n for n, _ in hits),
                           "device_us": sum(us for _, us in hits)}
    result = {
        "profiled_wall_us": wall_us,
        "device_busy_us": device_us,
        "device_busy_share": device_us / wall_us,
        "device_ops_per_update": launches / updates,
        "attention_kernels": attention,
        "top_kernels": [
            {"name": name[:80], "count": n, "device_us": us}
            for name, (n, us) in ranked
        ],
    }
    log(f"profile of {what}: {json.dumps(result)}")
    return result


# ------------------------------------------------- runner, resume, discrete
@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def in_directory(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


COUNTERS_INSTALLED = []


def install_counters():
    """Once per process: ``Agent.greedy_actions`` counts its calls, and the
    kernels' wrappers note their calls by shape, into the dicts registered
    under "greedy_calls" and "ledger" in ``utils.graphs.TRACKED_COUNTERS``.
    A graph replay adds to the dicts registered then what its capture
    counted, so the counts are those of the work that ran, graphed or
    eager; ``counted_greedy_calls`` and ``launch_ledger`` register a fresh
    dict for the stretch they count."""
    if COUNTERS_INSTALLED:
        return
    from dtqn_tpu_torch.agents.base import Agent
    from dtqn_tpu_torch.ops import cuda_attention as ca
    from dtqn_tpu_torch.utils import graphs

    tracked = graphs.TRACKED_COUNTERS
    tracked.update(greedy_calls={}, ledger={})
    greedy = Agent.greedy_actions

    def counting(agent, network, context, *args, **kwargs):
        calls = tracked["greedy_calls"]
        calls["calls"] = calls.get("calls", 0) + 1
        return greedy(agent, network, context, *args, **kwargs)

    def noting(name, fn):
        def wrapper(q, k, *rest):
            b, lq, lk, _, d = ca.check_shapes(q, k, rest[0], rest[-2],
                                              rest[-1])
            form = ("mma" if ca.launch_config(name, lq, lk, d, q.dtype)
                    .keys_per_lane == ca.MMA_FORM else "lanes")
            key = (name, b, lq, lk, d, bool(rest[-1]), dtype_name(q.dtype),
                   form)
            ledger = tracked["ledger"]
            ledger[key] = ledger.get(key, 0) + 1
            return fn(q, k, *rest)
        return wrapper

    Agent.greedy_actions = counting
    ca.attention_fwd = noting("attention_fwd", ca.attention_fwd)
    ca.attention_bwd = noting("attention_bwd", ca.attention_bwd)
    COUNTERS_INSTALLED.append(True)


@contextlib.contextmanager
def registered(name):
    """Yields a fresh dict that counts under ``name`` inside the context."""
    from dtqn_tpu_torch.utils import graphs

    install_counters()
    tracked = graphs.TRACKED_COUNTERS
    old, tracked[name] = tracked[name], {}
    try:
        yield tracked[name]
    finally:
        tracked[name] = old


@contextlib.contextmanager
def counted_greedy_calls():
    """Yields a dict whose "calls" counts the ``Agent.greedy_actions`` calls
    inside the context, graph replays included: each is one forward of the
    policy network, for an act step or an evaluation step (with a bag, each
    is followed by one evict forward)."""
    with registered("greedy_calls") as calls:
        calls["calls"] = 0
        yield calls


class Probe:
    """Counts and clocks what ``run_experiment`` calls, from outside: every
    greedy forward, each chunk, each evaluation, each checkpoint save and
    load.  The clocked calls end in a ``synchronize``; the runner reads a
    device value after each of them anyway."""

    def __init__(self):
        self.greedy_calls = {"calls": 0}
        self.seconds = {"chunk": [], "evaluate": [], "save_checkpoint": [],
                        "load_checkpoint": []}
        self.first_chunk_start = None
        self.resumed_at = None

    def clocked(self, kind, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "chunk" and self.first_chunk_start is None:
                self.first_chunk_start = t0
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[kind].append(time.perf_counter() - t0)
            return out
        # A graphed chunk's phases stay readable through the wrapper
        # (``--profile-dir`` writes them).
        if hasattr(fn, "phase_ms"):
            wrapper.phase_ms = fn.phase_ms
        return wrapper

    @contextlib.contextmanager
    def attached(self):
        from dtqn_tpu_torch.train import runner

        make_chunk, make_eval = (runner.make_train_chunk,
                                 runner.make_evaluate)
        save, real_load = (runner.ckpt.save_checkpoint,
                           runner.ckpt.load_checkpoint)

        def load(path, template):
            state, extra = real_load(path, template)
            self.resumed_at = int(state.env_steps)
            return state, extra

        with counted_greedy_calls() as self.greedy_calls, \
                patched(runner, "make_train_chunk",
                        lambda *a: self.clocked("chunk", make_chunk(*a))), \
                patched(runner, "make_evaluate",
                        lambda *a: self.clocked("evaluate", make_eval(*a))), \
                patched(runner.ckpt, "save_checkpoint",
                        self.clocked("save_checkpoint", save)), \
                patched(runner.ckpt, "load_checkpoint",
                        self.clocked("load_checkpoint", load)):
            yield self


RESULT_HEAD = ["Hours", "Step", "{e}/SuccessRate", "{e}/EpisodeLength",
               "{e}/Return"]
LOSS_HEAD = ["Hours", "Step", "TD Error", "Grad Norm", "Max Q Value",
             "Mean Q Value", "Min Q Value", "Max Target Value",
             "Mean Target Value", "Min Target Value"]


def runner_config(seed, **kw):
    """The bench configuration on a short schedule: two chunks of two
    iterations (128 env steps, 128 updates), each followed by an
    evaluation.  ``kw`` replaces fields."""
    from dtqn_tpu_torch.config import ExperimentConfig

    fields = dict(
        envs=["DiscreteCarFlag-v0"], model="DTQN", in_embed=64, heads=8,
        layers=2, context=50, history=50, batch=32, num_envs=64,
        buf_size=500_000, tuf=10_000, prepop_steps=40_000,
        eval_frequency=128, eval_episodes=10, num_steps=256,
        save_policy=True, seed=seed, project_name="chip-smoke",
        device=DEVICE,
    )
    return ExperimentConfig(**dict(fields, **kw))


def bag_runner_config(seed, **kw):
    """The same schedule at the bag configuration, training on the stored
    act-time bags; 300 prepopulation steps per env (every env ends an
    episode within 250)."""
    return runner_config(seed, **dict(
        dict(envs=[GV_ENV], model="DTQN-bag", in_embed=128, bag_size=GV_BAG,
             bag_store=True, prepop_steps=64 * 300), **kw))


def drqn_runner_config(seed, **kw):
    """DRQN on Memory-5-v0 at in_embed 128, cut in depth: two chunks of one
    iteration (128 env steps, 128 updates), each followed by an evaluation;
    60 prepopulation steps per env (every env ends an episode within 50)."""
    return runner_config(seed, **dict(
        dict(envs=["Memory-5-v0"], model="DRQN", in_embed=128,
             prepop_steps=64 * 60, eval_frequency=64, num_steps=128), **kw))


def check_csvs(cfg, steps, cap=None):
    """Both CSVs: the reference headers and one row per entry of ``steps``,
    every value finite, success rate and episode length (at most ``cap``,
    by default the env's) in range."""
    from dtqn_tpu_torch.envs import make_env

    env = cfg.envs[0]
    if cap is None:
        cap = make_env(env).max_episode_steps
    tables = []
    for suffix, head in (("_results.csv",
                          [h.format(e=env) for h in RESULT_HEAD]),
                         ("_losses.csv", LOSS_HEAD)):
        with open(cfg.policy_path() + suffix, newline="") as f:
            rows = list(csv.reader(f))
        check(rows[0] == head, f"{suffix} header {rows[0]}")
        check([r[1] for r in rows[1:]] == [str(s) for s in steps],
              f"{suffix} steps {[r[1] for r in rows[1:]]}, expected {steps}")
        check(all(math.isfinite(float(x)) for r in rows[1:] for x in r),
              f"{suffix} holds a non-finite value")
        tables.append(rows[1:])
    for row in tables[0]:
        check(0.0 <= float(row[2]) <= 1.0, f"success rate {row[2]}")
        check(1.0 <= float(row[3]) <= cap, f"episode length {row[3]}")
    return tables


def reset_launch_counts():
    """Zeroes the launch counts of both kernel libraries: the attention
    pair's (``ops/cuda_attention.py``) and the optimizer pair's
    (``ops/cuda_optimizer.py``)."""
    from dtqn_tpu_torch.ops import cuda_attention as ca
    from dtqn_tpu_torch.ops import cuda_optimizer as co

    ca.reset_launch_counts()
    co.reset_launch_counts()


def launch_counts():
    """Both libraries' launches since ``reset_launch_counts``, by kernel."""
    from dtqn_tpu_torch.ops import cuda_attention as ca
    from dtqn_tpu_torch.ops import cuda_optimizer as co

    return dict(ca.launch_counts, **co.launch_counts)


def optimizer_launches(updates, what):
    """The optimizer kernels' launches since ``reset_launch_counts``,
    checked to be one of each an update: every model, stacked or not, in
    float32 or bf16, graphed or eager, runs the step after the gradient
    once an update, and acting, the prepopulation and evaluation never."""
    from dtqn_tpu_torch.ops import cuda_optimizer as co

    counts = dict(co.launch_counts)
    check(counts == {"adam_sumsq": updates, "adam_apply": updates},
          f"{what}: the optimizer kernels launched {counts}, expected "
          f"{updates} of each (one an update)")
    return counts


def check_launches(ca, probe, cfg, iters, what, prepopulated=True):
    """Every forward launches one attention_fwd per layer, and one more for
    the bag: one forward per greedy call (an act step or an evaluation
    step), with a bag one evict forward after each and after each step of
    the prepopulation, and three per update; every update launches one
    attention_bwd per layer and for the bag.  With dropout the update's
    forwards are train-mode ones, in stock ops: an update launches none.
    Every update, with dropout too, launches each optimizer kernel once."""
    updates = iters * cfg.resolved_updates_per_iter * (cfg.dropout <= 0.0)
    greedy_calls = probe.greedy_calls["calls"]
    eval_steps = greedy_calls - iters
    launches = dict(ca.launch_counts)
    bag = cfg.bag_size > 0
    transformer = cfg.agent_config().kind == "transformer"
    per_forward = (cfg.layers + bag) * transformer
    evicts = bag * (greedy_calls + prepopulated
                    * max(cfg.prepop_steps // cfg.num_envs, 1))
    expect_fwd = per_forward * (greedy_calls + evicts + 3 * updates)
    expect_bwd = per_forward * updates
    # A bf16 run launches the bf16 instances, and no float32 one.
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    fwd, bwd = (ca.count_name(k, dtype) for k in ca.KINDS)
    check(launches[fwd] == expect_fwd,
          f"{what}: {fwd} launched {launches[fwd]} times, expected "
          f"{expect_fwd}")
    check(launches[bwd] == expect_bwd,
          f"{what}: {bwd} launched {launches[bwd]} times, expected "
          f"{expect_bwd}")
    check(sum(launches.values()) == expect_fwd + expect_bwd,
          f"{what}: launches of the other dtype's instances: {launches}")
    launches.update(optimizer_launches(
        iters * cfg.resolved_updates_per_iter, what))
    return launches, eval_steps


def saved_policy(cfg, device):
    """A fresh network on ``device`` holding the run's saved policy."""
    from dtqn_tpu_torch.agents import Agent
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    agent = Agent(cfg.agent_config(), make_env(cfg.envs[0]), device=device)
    return ckpt.load_policy(cfg.policy_path(),
                            agent.build_network().to(device))


def policy_q_card_vs_cpu(cfg, seed):
    """The saved policy's Q on random CarFlag contexts: a network on the
    card (kernel path) against one on the CPU (plain path)."""
    nets = {device: saved_policy(cfg, device) for device in (DEVICE, "cpu")}
    gen = torch.Generator().manual_seed(seed)
    obs = torch.rand((cfg.num_envs, cfg.context, 3), generator=gen) * 2.2 - 1.1
    with torch.no_grad():
        q_gpu = nets[DEVICE](obs.to(DEVICE))
        q_cpu = nets["cpu"](obs)
    check(bool(torch.isfinite(q_gpu).all()), "non-finite Q from the policy")
    q_err = (q_gpu.cpu() - q_cpu).abs().max().item()
    check(q_err <= Q_ATOL, f"saved policy: card Q differs from CPU Q by "
                           f"{q_err}")
    return q_err, nets[DEVICE].state_dict()


def runner_phase(seed, ca):
    """``run_experiment`` on the card, uninterrupted."""
    from dtqn_tpu_torch.train.runner import run_experiment
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    cfg = runner_config(seed)
    iters = cfg.num_steps // cfg.num_envs
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            Probe().attached() as probe:
        reset_launch_counts()
        t0 = time.perf_counter()
        final = run_experiment(cfg)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches, eval_steps = check_launches(ca, probe, cfg, iters, "runner")
        check(len(probe.seconds["chunk"]) == 2
              and len(probe.seconds["evaluate"]) == 2,
              f"chunks and evaluations: {probe.seconds}")
        check(2 <= eval_steps <= 2 * 200, f"{eval_steps} evaluation steps")
        check_csvs(cfg, [128, 256])
        check(all(math.isfinite(v) for v in final.values()),
              f"final log not finite: {final}")
        check(final["losses/Grad_Norm"] > 0.0,
              "the runner's updates were not applied")
        check(ckpt.load_mini_checkpoint(cfg.policy_path())
              == {"step": 256, "wandb_id": None}, "completion sentinel")
        check(not ckpt.has_checkpoint(cfg.policy_path()),
              "an uninterrupted run wrote a full checkpoint")
        check(os.path.exists(cfg.policy_path() + "_policy.pt"),
              "policy file missing")
        q_err, weights = policy_q_card_vs_cpu(cfg, seed)
        again = run_experiment(cfg)
        check(again == {"completed": True, "step": 256},
              f"a second call did not short-circuit: {again}")
    loop_s = t_end - probe.first_chunk_start
    result = {
        "env_steps_per_s_chunk_loop_with_eval": cfg.num_steps / loop_s,
        "chunk_loop_s": loop_s,
        "init_and_prepopulate_s": probe.first_chunk_start - t0,
        "chunk_s": probe.seconds["chunk"],
        "evaluation_s": probe.seconds["evaluate"],
        "evaluation_steps": eval_steps,
        "launches": launches,
        "policy_q_max_abs_err_vs_cpu": q_err,
        "final_log": final,
    }
    log(f"runner phase: {json.dumps(result)}")
    return result, weights


def resume_phase(seed, ca, whole_weights, make_cfg=runner_config,
                 what="resume phase"):
    """The run of ``make_cfg`` cut by a time limit after its first chunk,
    resumed, and held bit for bit against the uninterrupted run's final
    parameters."""
    from dtqn_tpu_torch.train.runner import run_experiment
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        cfg = make_cfg(seed, time_limit=1e-9)
        # Per call: one chunk before the cut, one after the resume.
        iters = cfg.resolved_iters_per_chunk
        cut_at, final = iters * cfg.num_envs, cfg.num_steps
        with Probe().attached() as cut:
            reset_launch_counts()
            run_experiment(cfg)
            launches_cut, _ = check_launches(ca, cut, cfg, iters,
                                             "run to the time limit")
        check(ckpt.has_checkpoint(cfg.policy_path()),
              "the time limit wrote no full checkpoint")
        check(ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == cut_at,
              f"the cut run's mini checkpoint is not at step {cut_at}")
        nbytes = os.path.getsize(cfg.policy_path() + "_checkpoint.pt")
        log(f"full checkpoint: {nbytes} bytes")
        check_csvs(cfg, [cut_at])

        cfg = make_cfg(seed)
        with Probe().attached() as resumed:
            reset_launch_counts()
            run_experiment(cfg)
            launches_resumed, _ = check_launches(
                ca, resumed, cfg, iters, "resumed run", prepopulated=False)
        check(resumed.resumed_at == cut_at,
              f"resumed at step {resumed.resumed_at}, not {cut_at}")
        check(len(resumed.seconds["chunk"]) == 1,
              "the resumed run did not train exactly one more chunk")
        check(ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == final,
              "the resumed run did not finish")
        check_csvs(cfg, [cut_at, final])
        weights = saved_policy(cfg, "cpu").state_dict()
    check(list(weights) == list(whole_weights), "policy keys differ")
    differing = [k for k in weights
                 if not torch.equal(weights[k], whole_weights[k].cpu())]
    check(not differing, f"resumed run's final parameters differ from the "
                         f"uninterrupted run's in {differing}")
    result = {
        "checkpoint_bytes": nbytes,
        "save_checkpoint_s": cut.seconds["save_checkpoint"][0],
        "load_checkpoint_s": resumed.seconds["load_checkpoint"][0],
        "resumed_at_step": resumed.resumed_at,
        "final_parameters_bit_equal": True,
        "launches_cut": launches_cut,
        "launches_resumed": launches_resumed,
    }
    log(f"{what}: {json.dumps(result)}")
    return result


def discrete_phase(seed, ca):
    """Memory Cards: int32 token observations through the discrete
    embedder, head width 16."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import (
        make_evaluate,
        make_prepopulate,
        make_train_chunk,
    )
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    num_envs, updates, layers = 64, 64, 2
    cfg = AgentConfig(
        model="DTQN", num_envs=num_envs, context_len=50, history=50,
        inner_embed=128, num_heads=8, num_layers=layers, batch_size=32,
        buffer_size=50_000, target_update_frequency=10_000,
    )
    env = make_env("Memory-5-v0")
    agent = Agent(cfg, env, device=DEVICE)
    instances = {
        kind: ca.launch_config(kind, 50, 50, cfg.inner_embed // cfg.num_heads)
        for kind in ("attention_fwd", "attention_bwd")
    }
    for kind, lc in instances.items():
        check(lc.head_dim_pad == 16
              and (lc.head_dim_pad, lc.keys_per_lane) in ca.INSTANCES,
              f"{kind} instance for head width 16: {lc}")
    reset_launch_counts()
    state = agent.init_state(seed)
    make_prepopulate(agent, 150)(state)
    flushed = int(state.buffer.flushed_total)
    check(flushed > cfg.batch_size, f"prepopulation flushed only {flushed}")
    with counted_greedy_calls() as greedy_calls:
        make_train_chunk(
            agent, EpsilonSchedule(1.0, 0.1, 200_000),
            updates_per_iter=updates, iters_per_chunk=1)(state)
        sr, ret, length = (
            float(x) for x in make_evaluate(agent, env, 10)(
                state.network,
                torch.Generator(device=DEVICE).manual_seed(seed)))
    launches = launch_counts()
    optimizer_launches(updates, "discrete")
    check(int(state.train_steps) == updates,
          f"train_steps {int(state.train_steps)}")
    check(int(state.nonfinite_grads) == 0, "non-finite gradient steps")
    check(state.context.obs.dtype == torch.int32
          and state.buffer.obs.dtype == torch.int32,
          "token observations were widened")
    check(0.0 <= sr <= 1.0 and 1.0 <= length <= 50.0 and -50.0 <= ret <= 0.0,
          f"evaluation out of range: {sr}, {ret}, {length}")
    # One act forward, three forwards per update, and one forward per
    # evaluation step (all 50 unless every game was won before).
    eval_steps = greedy_calls["calls"] - 1
    check(10 <= eval_steps <= 50, f"{eval_steps} evaluation steps")
    check(launches["attention_fwd"] == layers * (1 + 3 * updates + eval_steps),
          f"attention_fwd launched {launches['attention_fwd']} times")
    check(launches["attention_bwd"] == layers * updates,
          f"attention_bwd launched {launches['attention_bwd']} times")

    cpu_net = agent.build_network()
    cpu_net.load_state_dict(state.network.state_dict())
    with torch.no_grad():
        q_gpu = state.network(state.context.obs, state.context.action)
        q_cpu = cpu_net(state.context.obs.cpu(), state.context.action.cpu())
    check(tuple(q_gpu.shape) == (num_envs, 50, 10), f"Q shape {q_gpu.shape}")
    check(bool(torch.isfinite(q_gpu).all()), "non-finite Q on the card")
    q_err = (q_gpu.cpu() - q_cpu).abs().max().item()
    check(q_err <= Q_ATOL, f"discrete: card Q differs from CPU Q by {q_err}")
    result = {
        "instances": {k: [lc.head_dim_pad, lc.keys_per_lane]
                      for k, lc in instances.items()},
        "launches_head_width_16": launches,
        "evaluation_steps": eval_steps,
        "evaluation": [sr, ret, length],
        "flushed_episodes": flushed,
        "train_steps": updates,
        "q_max_abs_err_vs_cpu": q_err,
    }
    log(f"discrete phase: {json.dumps(result)}")
    return result


# ------------------------------------------------------------------ the bag
def dtype_name(dtype):
    return "bf16" if dtype == torch.bfloat16 else "f32"


@contextlib.contextmanager
def launch_ledger(ca):
    """Yields a dict that counts every call of the kernels' wrappers inside
    the context, graph replays included, by (kernel, B, Lq, Lk, head width,
    causal, dtype, form): the form "mma" where the wrapper launches the
    tensor-core form, else "lanes" (``install_counters`` wraps them once).
    The wrappers themselves go on counting their launches."""
    del ca
    with registered("ledger") as ledger:
        yield ledger


def reckoned_launches(cfg, act_steps, updates, evict_steps=None):
    """The attention launches of ``act_steps`` greedy act steps (or
    evaluation steps at ``cfg.num_envs`` episodes), ``evict_steps`` evict
    forwards (as many, unless given) and ``updates`` updates, by shape, from
    the configuration alone.  A forward launches one causal attention per
    layer and, unless the bag is masked, one over the bag; an update is
    three forwards and one backward at the batch size, unless dropout makes
    them train-mode forwards, which take the stock-op path and launch
    nothing.  The recurrent and feedforward models launch none.  Every
    bf16 launch takes the tensor-core form (head width 8 or 16, Lk and Lq
    at most 50), every float32 one a keys-on-lanes instance."""
    if evict_steps is None:
        evict_steps = act_steps
    length, d = cfg.context_len, cfg.inner_embed // cfg.num_heads
    envs, bag = cfg.num_envs, cfg.bag_size
    dtype, form = ("bf16", "mma") if cfg.bf16 else ("f32", "lanes")
    out = {}
    if cfg.kind != "transformer":
        return out

    def add(kind, b, n):
        shapes = [((kind, b, length, length, d, True, dtype, form),
                   cfg.num_layers * n)]
        if bag and not cfg.bag_mask:
            shapes.append(((kind, b, length, bag, d, False, dtype, form),
                           n))
        for key, count in shapes:
            if count:
                out[key] = out.get(key, 0) + count

    add("attention_fwd", envs, act_steps)
    if bag:
        add("attention_fwd", envs * (bag + 1), evict_steps)
    if cfg.dropout > 0.0:
        updates = 0
    add("attention_fwd", cfg.batch_size, 3 * updates)
    add("attention_bwd", cfg.batch_size, updates)
    return out


def show_ledger(d):
    return {"{} B={} Lq={} Lk={} D={} causal={} {} {}".format(*k): n
            for k, n in sorted(d.items())}


def check_held(ledger, what):
    """Every launch of ``ledger`` at a (shape, dtype) that the parity
    phases hold against the plain versions: PARITY_CASES in float32,
    BF16_PARITY_CASES in bf16."""
    held = {(b, lq, lk, e // h, causal, dtype)
            for dtype, cases in (("f32", PARITY_CASES),
                                 ("bf16", BF16_PARITY_CASES))
            for b, lq, lk, h, causal, e in cases}
    unheld = {k: n for k, n in ledger.items() if k[1:7] not in held}
    check(not unheld, f"{what}: launched at shapes that the parity phase "
                      f"does not hold against the plain versions: "
                      f"{show_ledger(unheld)}")


def check_mma(ledger, what):
    """Every bf16 launch of ``ledger`` took the tensor-core form."""
    lanes = {k: n for k, n in ledger.items()
             if k[6] == "bf16" and k[7] != "mma"}
    check(ledger and not lanes, f"{what}: bf16 launches outside the "
                                f"tensor-core form: {show_ledger(lanes)}")


def check_ledger(ca, ledger, expected, what, updates):
    """The attention launches by shape (``ledger``) against ``expected``,
    and the launch counts against both: the attention pair's against the
    shapes', the optimizer pair's against the stretch's ``updates``.
    Returns the launches by shape and the optimizer's by kernel."""
    check(ledger == expected,
          f"{what}: launches by shape {show_ledger(ledger)}, reckoned "
          f"{show_ledger(expected)}")
    check_held(ledger, what)
    for name in ca.launch_counts:
        total = sum(n for k, n in expected.items()
                    if ca.count_name(k[0], torch.bfloat16 if k[6] == "bf16"
                                     else torch.float32) == name)
        check(ca.launch_counts[name] == total,
              f"{what}: {name} counted {ca.launch_counts[name]} launches, "
              f"reckoned {total}")
    return dict(show_ledger(ledger), **optimizer_launches(updates, what))


def seed_blocks(state):
    """(seed count, each seed's single-network weights) of a state: one
    block, or a stacked state's S seed-major blocks."""
    if not state.seed_shape:
        return 1, [state.network.state_dict()]
    n = state.seed_shape[0]
    return n, [state.network.seed_state_dict(i) for i in range(n)]


def q_card_vs_cpu(agent, state, what):
    """The network's Q on the run's own contexts and bags (for the recurrent
    models over each context's filled rows): the card's path against the
    plain path on the CPU, for a stacked state each seed's block against a
    single network with that seed's weights."""
    ctx = state.context
    inputs = (ctx.obs, ctx.action, agent._bag_in(state.bag),
              ctx.last_index + 1)
    seeds, weights = seed_blocks(state)

    def block(x, i):
        if isinstance(x, tuple):
            return tuple(block(y, i) for y in x)
        return x.chunk(seeds)[i].cpu()

    cfg = agent.config
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    q_cpu = []
    with torch.no_grad():
        # bf16 GEMMs on the card sum in float32 for this check (cuBLAS may
        # otherwise reduce split sums in bf16); the error with them is
        # reported beside it.
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            q_gpu = agent._q_context(state.network, *inputs)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        for i, w in enumerate(weights):
            cpu_net = agent.build_network()
            cpu_net.load_state_dict(w)
            q_cpu.append(agent._q_context(cpu_net, *block(inputs, i)))
        q_reduced = (agent._q_context(state.network, *inputs)
                     if cfg.bf16 else None)
    q_cpu = torch.cat(q_cpu)
    check(tuple(q_gpu.shape) == (seeds * cfg.num_envs, cfg.context_len,
                                 agent.env.num_actions),
          f"{what}: Q shape {tuple(q_gpu.shape)}")
    check(bool(torch.isfinite(q_gpu).all()), f"{what}: non-finite Q")
    check(q_gpu.dtype == q_cpu.dtype == (torch.bfloat16 if cfg.bf16
                                         else torch.float32),
          f"{what}: Q is {q_gpu.dtype} on the card, {q_cpu.dtype} on the "
          f"CPU")
    q_err = (q_gpu.cpu().float() - q_cpu.float()).abs().max().item()
    if not cfg.bf16:
        check(q_err <= Q_ATOL, f"{what}: card Q differs from CPU Q by "
                               f"{q_err}")
        return q_err
    ulp = bf16_ulp(q_cpu.float().abs().max()).item()
    check(q_err <= BF16_Q_ULPS * ulp,
          f"{what}: bf16 card Q differs from CPU Q by {q_err} "
          f"({q_err / ulp} ulps at max |Q|)")
    out = {"max_abs_err": q_err, "ulps_at_max_abs_q": q_err / ulp,
           "max_abs_err_reduced_precision_reduction":
               (q_reduced.cpu().float() - q_cpu.float()).abs().max().item()}
    log(f"{what}: bf16 Q card vs CPU: {json.dumps(out)}")
    return out


def gradients_repeat(agent, state, what):
    """Three gradient computations on one sampled batch agree bit for bit in
    every parameter: what a bit-equal resume rests on.  With dropout each is
    a train-mode forward whose masks come from one generator state (each
    seed's, stacked), as a resumed run's do."""
    batch = agent.sample_batch(state.buffer, state.generator)
    bag_in = (batch.bag_obs, batch.bag_action) if agent.use_bag else ()
    names, params = zip(*state.network.named_parameters())
    grads = []
    gens = (state.generator if isinstance(state.generator, list)
            else [state.generator])
    start = [g.get_state() for g in gens]
    for _ in range(3):
        for g, s in zip(gens, start):
            g.set_state(s)
        q = agent._q_context(state.network, batch.obs, batch.action, bag_in,
                             batch.ep_len,
                             agent.dropout_draws(state,
                                                 window=batch.obs.shape[:2]))
        grads.append(torch.autograd.grad(q.square().mean(), params))
    differing = [n for n, *g in zip(names, *grads)
                 if not all(torch.equal(g[0], x) for x in g[1:])]
    check(not differing, f"{what}: gradients of one batch differ between "
                         f"computations in {differing}")
    return len(names)


def drive(seed, ca, env_name, prepop_iters, iters, evaluate=False,
          max_episode_steps=None, seeds=None, turns=False, **kw):
    """Init, prepopulation and ``iters`` train iterations of 64 updates of
    an agent on the card (by default DTQN-bag at the bag configuration;
    ``kw`` replaces AgentConfig fields) on ``env_name``, or on a list of
    names as the runner combines them, every attention launch held against
    the reckoning; optionally one 10-episode evaluation (per seed) through
    ``make_evaluate``, and with ``turns`` its graphed form against the
    eager one in turns (``evaluation_turns``).
    ``max_episode_steps`` replaces the env's cap, as the CLI's
    ``--max-episode-steps`` does.  With ``seeds``, a stacked state of those
    seeds (the sweep): one launch per forward at the seeds' folded batch."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.config import ExperimentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import (
        make_evaluate,
        make_prepopulate,
        make_train_chunk,
    )
    from dtqn_tpu_torch.train.runner import build_envs
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    updates = 64
    cfg = AgentConfig(**dict(dict(
        model="DTQN-bag", num_envs=64, context_len=50, history=50,
        inner_embed=128, num_heads=8, num_layers=2, batch_size=32,
        buffer_size=500_000, target_update_frequency=10_000,
        bag_size=GV_BAG), **kw))
    what = f"drive {env_name} {kw}" + (f" seeds {seeds}" if seeds else "")
    env = (make_env(env_name) if isinstance(env_name, str)
           else build_envs(ExperimentConfig(envs=list(env_name)))[0])
    if max_episode_steps:
        env.max_episode_steps = max_episode_steps
    agent = Agent(cfg, env, device=DEVICE)
    cfg = agent.config  # DQN's context is 1
    n = len(seeds) if seeds else 1
    # The launches' shapes: the seeds' envs and batches folded.
    folded = dataclasses.replace(cfg, num_envs=n * cfg.num_envs,
                                 batch_size=n * cfg.batch_size)
    train_iter = make_train_chunk(
        agent, EpsilonSchedule(1.0, 0.1, 200_000),
        updates_per_iter=updates, iters_per_chunk=1)
    result = {"config": kw, "env": env_name, "seeds": seeds}

    with launch_ledger(ca) as ledger:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = (agent.init_sweep_state(seeds) if seeds
                 else agent.init_state(seed))
        make_prepopulate(agent, prepop_iters)(state)
        torch.cuda.synchronize()
        result["init_and_prepopulate_s"] = time.perf_counter() - t0
        # Random actions: no greedy forward, one evict forward per step.
        result["launches_prepopulation"] = check_ledger(
            ca, ledger,
            reckoned_launches(folded, 0, 0, evict_steps=prepop_iters),
            f"{what}, prepopulation", 0)
    flushed = state.buffer.flushed_total.reshape(-1).tolist()
    check(min(flushed) > cfg.batch_size,
          f"{what}: prepopulation flushed only {flushed}")

    with launch_ledger(ca) as ledger:
        reset_launch_counts()
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_iter(state)
            torch.cuda.synchronize()
            t_iter = time.perf_counter() - t0
        result["launches"] = launch_counts()
        result["launches_by_shape"] = check_ledger(
            ca, ledger, reckoned_launches(folded, iters, iters * updates),
            f"{what}, {iters} train iterations", iters * updates)
    applied = state.train_steps.reshape(-1).tolist()
    check(applied == [iters * updates] * n, f"{what}: train_steps {applied}")
    check(int(state.nonfinite_grads.sum()) == 0,
          f"{what}: non-finite gradient steps")
    diags = {k: v.tolist() for k, v in state.diagnostics.means().items()}
    check(all(math.isfinite(x) for v in diags.values()
              for x in (v if seeds else [v])),
          f"{what}: diagnostics not finite: {diags}")
    if agent.use_bag:
        check(int(state.bag.pos.max()) > 0, f"{what}: every bag is empty")
        result["bag_slots_filled"] = float(state.bag.pos.float().mean())
    if state.carry is not None:
        check(bool(state.carry.h.abs().sum() > 0),
              f"{what}: the act-time carry never moved")
    result.update(
        env_steps_per_s=n * cfg.num_envs / t_iter, timed_iteration_s=t_iter,
        flushed_episodes=flushed, train_steps=applied,
        q_max_abs_err_vs_cpu=q_card_vs_cpu(agent, state, what),
        parameters_with_repeating_gradients=gradients_repeat(agent, state,
                                                             what),
        diagnostics=diags)

    if evaluate:
        gens = [torch.Generator(device=DEVICE).manual_seed(s + 1)
                for s in (seeds or [seed])]
        with launch_ledger(ca) as ledger, counted_greedy_calls() as calls:
            reset_launch_counts()
            t0 = time.perf_counter()
            out = make_evaluate(agent, env, 10)(
                state.network, gens if seeds else gens[0])
            sr, ret, length = (x.reshape(-1).tolist() for x in out)
            result["evaluation_s"] = time.perf_counter() - t0
            steps = calls["calls"]
            eval_cfg = dataclasses.replace(cfg, num_envs=10 * n)
            result["launches_evaluation"] = check_ledger(
                ca, ledger, reckoned_launches(eval_cfg, steps, 0),
                f"{what}, evaluation", 0)
        cap = env.max_episode_steps
        check(1 <= steps <= cap and all(
            0.0 <= a <= 1.0 and 1.0 <= b <= cap and abs(c) <= cap
            for a, b, c in zip(sr, length, ret)),
            f"{what}: evaluation out of range: {sr}, {ret}, {length}")
        if not seeds:
            sr, ret, length = sr[0], ret[0], length[0]
        result.update(evaluation=[sr, ret, length], evaluation_steps=steps)
        if turns:
            result["evaluation_turns"] = evaluation_turns(
                ca, agent, env, state.network, seed, seeds, what)
    log(f"{what}: {json.dumps(result)}")
    return result, agent, state, train_iter


def operations(agent, state, what):
    """Device operations and device time of one act step, one update and,
    with a bag, one evict forward (torch.profiler), eagerly.  The state's
    leaves stay where a graph of its iteration reads them
    (``leaves_kept``; its copies run outside the profile)."""
    from dtqn_tpu_torch.train import loop
    from dtqn_tpu_torch.utils.graphs import leaves_kept

    runs = {
        "act_step": lambda: loop.env_step(agent, state),
        "update": lambda: agent.learn(state),
    }
    if agent.use_bag:
        ctx, bag = state.context, state.bag
        ev_act = torch.zeros_like(ctx.action[:, 0])
        need = torch.ones_like(ev_act, dtype=torch.bool)
        runs["evict_forward"] = lambda: agent._bag_evict(
            state.network, ctx, bag, ctx.obs[:, 0], ev_act, ev_act, need)
    result = {}
    for name, fn in runs.items():
        with leaves_kept(state):
            fn()  # warm
            wall_us, by_name = device_events(fn)
        result[name] = {
            "device_ops": sum(n for n, _ in by_name.values()),
            "device_us": sum(us for _, us in by_name.values()),
            "profiled_wall_us": wall_us,
        }
    log(f"{what} operations: {json.dumps(result)}")
    return result


def bag_phase(seed, ca):
    """DTQN-bag at full width, its ablations, its runner and Car Flag."""
    from dtqn_tpu_torch.train.runner import run_experiment

    d = 128 // 8
    instances = {
        "causal": [ca.launch_config(k, 50, 50, d)[:2]
                   for k in ("attention_fwd", "attention_bwd")],
        "bag": [ca.launch_config(k, 50, GV_BAG, d)[:2]
                for k in ("attention_fwd", "attention_bwd")],
        "carflag_bag": [ca.launch_config(k, 50, 10, 8)[:2]
                        for k in ("attention_fwd", "attention_bwd")],
    }
    check(instances == {"causal": [(16, 2)] * 2, "bag": [(16, 2)] * 2,
                        "carflag_bag": [(8, 1)] * 2},
          f"bag instances {instances}")

    main, agent, state, _ = drive(seed, ca, GV_ENV, 625, 2, evaluate=True,
                                  turns=True)
    ops = operations(agent, state, "bag")
    del agent, state
    masked, *_ = drive(seed, ca, GV_ENV, 300, 1, bag_mask=True)
    check(all("Lk=25" not in k for k in masked["launches_by_shape"]),
          "the masked bag attention launched a kernel")
    carflag, *_ = drive(seed, ca, "DiscreteCarFlag-v0", 200, 1,
                        inner_embed=64, bag_size=10)

    # --bag-store through the runner: whole, then cut and resumed.
    cfg = bag_runner_config(seed)
    iters = cfg.num_steps // cfg.num_envs
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            Probe().attached() as probe:
        reset_launch_counts()
        final = run_experiment(cfg)
        launches, eval_steps = check_launches(ca, probe, cfg, iters,
                                              "bag-store runner")
        check_csvs(cfg, [128, 256])
        check(all(math.isfinite(v) for v in final.values()),
              f"bag-store runner: final log not finite: {final}")
        whole_weights = saved_policy(cfg, "cpu").state_dict()
    stored = {
        "launches": launches, "evaluation_steps": eval_steps,
        "chunk_s": probe.seconds["chunk"],
        "evaluation_s": probe.seconds["evaluate"], "final_log": final,
    }
    log(f"bag-store runner: {json.dumps(stored)}")
    stored["resume"] = resume_phase(seed, ca, whole_weights,
                                    bag_runner_config, "bag-store resume")
    return {"instances": {k: [list(i) for i in v]
                          for k, v in instances.items()},
            "full_width": main, "operations": ops,
            "bag_mask": masked, "carflag_bag10": carflag,
            "bag_store": stored}


def update_ms_in_turns(runs, rounds=3, updates=16):
    """Host time of one update of each of ``runs`` ({name: (agent, state)}),
    timed in turns within one call, best of ``rounds``: phases timed at
    different moments of a call differ by more than their work does."""
    from dtqn_tpu_torch.utils.graphs import leaves_kept

    best = dict.fromkeys(runs, math.inf)
    for _ in range(rounds):
        for name, (agent, state) in runs.items():
            with leaves_kept(state):  # the copies after the clock stops
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(updates):
                    agent.learn(state)
                torch.cuda.synchronize()
                best[name] = min(best[name],
                                 1e3 * (time.perf_counter() - t0) / updates)
    log(f"update ms in turns: {json.dumps(best)}")
    return best


def pomdp_phase(seed, ca, flagless):
    """DTQN at in_embed 64 on Hallway and HeavenHell: the main path's
    attention shapes on discrete observations; their updates timed in turns
    with the main path's ``flagless`` (agent, state)."""
    from dtqn_tpu_torch.envs.pomdp_parser import native_parser_loads

    parser = "native" if native_parser_loads() else "python"
    log(f"pomdp: data/hallway.pomdp parsed by the {parser} parser")
    result = {"parser": parser}
    runs = {"DiscreteCarFlag-v0": flagless}
    for env_name, cap in ((HALLWAY, None), (HEAVENHELL, 50)):
        run, agent, state, train_iter = drive(
            seed, ca, env_name, 150, 2, evaluate=True, max_episode_steps=cap,
            model="DTQN", inner_embed=64, bag_size=0)
        run["profile"] = profile_iteration(state, train_iter,
                                           what=f"{env_name} DTQN")
        result[env_name] = run
        runs[env_name] = (agent, state)
    result["update_ms_in_turns"] = update_ms_in_turns(runs)
    return result


def baselines_phase(seed, ca):
    """DQN, DRQN, ADRQN and DARQN at full width, and a DRQN run through the
    runner whole, cut and resumed."""
    from dtqn_tpu_torch.train.runner import run_experiment

    result = {}
    # Enough random steps that every env ends an episode (caps 50-200).
    prepop = {"Memory-5-v0": 60, HALLWAY: 110, "DiscreteCarFlag-v0": 210}
    for model, env_name, width in BASELINES:
        run, agent, state, train_iter = drive(
            seed, ca, env_name, prepop[env_name], 2, evaluate=True,
            turns=model == "DRQN", model=model, inner_embed=width,
            bag_size=0)
        run["operations"] = operations(agent, state, model)
        # ADRQN's iteration is DRQN's plus an action lookup; profiling one
        # of ~200 000 kernels takes ~40 s, so its share comes from the
        # profiled update and act step above.
        if model != "ADRQN":
            run["profile"] = profile_iteration(state, train_iter,
                                               what=f"{model} {env_name}")
        result[f"{model} {env_name}"] = run
        del agent, state, train_iter

    cfg = drqn_runner_config(seed)
    iters = cfg.num_steps // cfg.num_envs
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            Probe().attached() as probe:
        reset_launch_counts()
        final = run_experiment(cfg)
        launches, eval_steps = check_launches(ca, probe, cfg, iters,
                                              "DRQN runner")
        check_csvs(cfg, [64, 128])
        check(all(math.isfinite(v) for v in final.values()),
              f"DRQN runner: final log not finite: {final}")
        whole_weights = saved_policy(cfg, "cpu").state_dict()
    runner = {
        "launches": launches, "evaluation_steps": eval_steps,
        "chunk_s": probe.seconds["chunk"],
        "evaluation_s": probe.seconds["evaluate"], "final_log": final,
    }
    log(f"DRQN runner: {json.dumps(runner)}")
    runner["resume"] = resume_phase(seed, ca, whole_weights,
                                    drqn_runner_config, "DRQN resume")
    result["drqn_runner"] = runner
    return result


EAGER_GRAPHED_TURNS = ("eager", "graphed", "graphed", "eager")


def evaluation_turns(ca, agent, env, network, seed, seeds, what):
    """Ten episodes (per seed) of ``network`` evaluated eager
    (``make_evaluate_fn``) and graphed (``make_evaluate``) from generators
    seeded alike: a first graphed call (its captures), then the two in
    turns (EAGER_GRAPHED_TURNS).  Every call's results, steps, launches by
    shape (reckoned) and generators' end states bit-equal; the seconds of each
    call, the captures' seconds and the graph pool's bytes."""
    from dtqn_tpu_torch.train.loop import make_evaluate, make_evaluate_fn

    evaluators = {"eager": make_evaluate_fn(agent, env, 10),
                  "graphed": make_evaluate(agent, env, 10)}
    n = len(seeds) if seeds else 1

    def one(kind):
        gens = [torch.Generator(device=DEVICE).manual_seed(s + 1)
                for s in (seeds or [seed])]
        with launch_ledger(ca) as ledger, counted_greedy_calls() as calls:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = evaluators[kind](network, gens if seeds else gens[0])
            out = [x.reshape(-1).tolist() for x in out]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            seen = (out, calls["calls"], launch_counts(), dict(ledger))
        return seconds, seen, [g.get_state() for g in gens]

    first_s, reference, reference_gens = one("graphed")
    out, steps, launches, ledger = reference
    check_ledger(ca, ledger, reckoned_launches(
        dataclasses.replace(agent.config, num_envs=10 * n), steps, 0),
        f"{what}, graphed evaluation", 0)
    times = {"eager": [], "graphed": []}
    for kind in EAGER_GRAPHED_TURNS:
        seconds, seen, gens = one(kind)
        check(seen == reference and all(
            torch.equal(a, b) for a, b in zip(gens, reference_gens)),
            f"{what}: the {kind} evaluation (results, steps, launches) "
            f"{seen[:3]} differs from the first graphed one's "
            f"{reference[:3]}, or its generators' end states do")
        times[kind].append(seconds)
    graphed = evaluators["graphed"]
    result = {
        "first_graphed_s": first_s, "eager_s": times["eager"],
        "graphed_s": times["graphed"],
        "speedup": sum(times["eager"]) / sum(times["graphed"]),
        "steps": steps, "result": out, "launches": launches,
        "captures": {str(k): graph_stats(v) for k, v in
                     getattr(graphed, "compiled", {}).items()},
        "pool_bytes": pool_bytes(agent), "bit_equal": True,
    }
    log(f"{what}: evaluations eager and graphed in turns: "
        f"{json.dumps(result)}")
    return result


def evaluation_phase(seed, ca, agent, state):
    """Phase 8: one 10-episode evaluation of the main path's network, eager
    and graphed in turns (``evaluation_turns``); the graphed one reading
    the early-exit flag every 10 steps (the default), every step and never,
    all giving the same numbers, each timed and profiled; then the runner's
    chunk loop with its evaluations eager and graphed in turns
    (``runner_loop_turns``)."""
    from dtqn_tpu_torch.train import loop

    result = {"turns": evaluation_turns(ca, agent, agent.env, state.network,
                                        seed, None, "evaluation, flagless")}
    evaluate = loop.make_evaluate(agent, agent.env, 10)
    for every in (loop.EVAL_EXIT_CHECK_EVERY, 1, 0):

        def run_once():
            return evaluate(
                state.network,
                torch.Generator(device=DEVICE).manual_seed(seed + 1))

        with patched(loop, "EVAL_EXIT_CHECK_EVERY", every), \
                counted_greedy_calls() as calls:
            run_once()  # warm: this block length's captures
            torch.cuda.synchronize()
            calls["calls"] = 0
            t0 = time.perf_counter()
            out = [float(x) for x in run_once()]
            seconds = time.perf_counter() - t0
            steps = calls["calls"]
            wall_us, by_name = device_events(run_once)
        ops = sum(n for n, _ in by_name.values())
        device_us = sum(us for _, us in by_name.values())
        result[f"graphed_check_every_{every}"] = {
            "seconds": seconds, "steps": steps, "result": out,
            "device_ops": ops, "device_ops_per_step": ops / steps,
            "device_us": device_us,
            "device_busy_share_profiled": device_us / wall_us,
        }
    outs = [result[f"graphed_check_every_{every}"]["result"]
            for every in (loop.EVAL_EXIT_CHECK_EVERY, 1, 0)]
    turns = [x for xs in result["turns"]["result"] for x in xs]
    check(outs[0] == outs[1] == outs[2] == turns,
          f"early exit changed the evaluation: {outs}, {turns}")
    result["runner_loop"] = runner_loop_turns(seed)
    log(f"evaluation alone: {json.dumps(result)}")
    return result


# The runner's chunk loop at the CLI's default --eval-frequency 5000 (78
# iterations of 64 env steps a chunk), one evaluation after each chunk:
# graphed (its captures), then in turns.
LOOP_EVALS = ("graphed",) + EAGER_GRAPHED_TURNS


def runner_loop_turns(seed):
    """``run_experiment`` at the flagless configuration and the default
    --eval-frequency 5000 over len(LOOP_EVALS) chunks, each followed by an
    evaluation that is eager (``make_evaluate_fn``) or graphed
    (``make_evaluate``) in the order of LOOP_EVALS: per kind, the chunks'
    and the evaluations' seconds, the env-steps/s of a chunk with its
    evaluation, and the evaluations' share of that wall time."""
    from dtqn_tpu_torch.train import runner
    from dtqn_tpu_torch.train.loop import make_evaluate, make_evaluate_fn

    cfg = runner_config(seed, eval_frequency=5000,
                        num_steps=len(LOOP_EVALS) * (5000 // 64) * 64,
                        save_policy=False)
    chunk_env_steps = cfg.resolved_iters_per_chunk * cfg.num_envs
    seconds = {"chunk": [], "evaluate": []}
    make_chunk = runner.make_train_chunk

    def clocked(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            if kind == "evaluate":
                out = [float(x) for x in out]
            torch.cuda.synchronize()
            seconds[kind].append(time.perf_counter() - t0)
            return out
        return call

    def alternating(agent, env, n):
        evaluators = {"eager": make_evaluate_fn(agent, env, n),
                      "graphed": make_evaluate(agent, env, n)}
        order = iter(LOOP_EVALS)
        return clocked("evaluate", lambda network, generator: evaluators[
            next(order)](network, generator))

    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            patched(runner, "make_train_chunk",
                    lambda *a: clocked("chunk", make_chunk(*a))), \
            patched(runner, "make_evaluate", alternating):
        final = runner.run_experiment(cfg)
    check(len(seconds["chunk"]) == len(seconds["evaluate"]) == len(LOOP_EVALS),
          f"runner loop: chunks and evaluations {seconds}")
    check(all(math.isfinite(v) for v in final.values()),
          f"runner loop: final log not finite: {final}")
    per = {"eager": [], "graphed": []}
    for i, kind in enumerate(LOOP_EVALS):
        if i:  # the first, graphed, evaluation captures
            per[kind].append((seconds["chunk"][i], seconds["evaluate"][i]))
    result = {"chunk_env_steps": chunk_env_steps, "order": LOOP_EVALS,
              "chunk_s": seconds["chunk"], "evaluation_s": seconds["evaluate"]}
    for kind, pairs in per.items():
        wall = sum(c + e for c, e in pairs)
        result[kind] = {
            "env_steps_per_s_with_evaluation":
                chunk_env_steps * len(pairs) / wall,
            "evaluation_share_of_wall": sum(e for _, e in pairs) / wall,
        }
    log(f"runner chunk loop, evaluations in turns: {json.dumps(result)}")
    return result


# ------------------------------------- images, variants, several domains
IMAGE_ENV = "ImageMaze-9-v0"
FOUR_ROOMS = ("gv_memory_four_rooms.7x7.yaml",
              "gv_memory_four_rooms.9x9.yaml")
# The paper's ablations on the flagless configuration: (name, AgentConfig
# fields).
VARIANTS = [("gru-identity-sin", dict(gate="gru", identity=True, pos="sin")),
            ("pos-none", dict(pos="none")),
            ("dropout-0.1", dict(dropout=0.1))]


def image_runner_config(seed, **kw):
    """ImageMaze at the validation policy's configuration (in_embed 128) on
    the runner's short schedule; 110 prepopulation steps per env (every env
    ends an episode within its 100-step cap)."""
    return runner_config(seed, **dict(
        dict(envs=[IMAGE_ENV], in_embed=128, prepop_steps=64 * 110), **kw))


def conv_cost(network, images):
    """The image embedder's five convolutions at ``images`` 9x9 images:
    device ms of forward and backward in the port's unfold + GEMM form and
    through F.conv2d (cuDNN with deterministic algorithms, TF32 off) on the
    same weights; each one's float32 pre-activations against float64
    convolutions on the card (largest error relative to each layer's
    largest entry; the port's held within CONV_FWD_RTOL, which TF32 would
    exceed) and its gradients' (reported: a pre-activation within float32
    rounding of zero may take the other side of the ReLU, and then its
    gradient differs by its whole contribution; the flips are counted);
    and two backward passes of the port's form held bit-equal."""
    import torch.nn.functional as F

    from dtqn_tpu_torch.models.embeddings import CNN_STRIDES

    emb = network.obs_embedding
    convs = [getattr(emb, f"conv_{i}") for i in range(len(CNN_STRIDES))]
    params = [p for c in convs for p in (c.weight, c.bias)]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    x = (torch.rand((images, 3, 9, 9), generator=gen, device=DEVICE)
         < 0.3).float() * 255

    def port(weights):
        """Pre-activations (NHWC) and the gradients of the sum of the
        output, in the port's form."""
        h, pre = x.permute(0, 2, 3, 1), []
        for c in convs:
            pre.append(c(h))
            h = torch.relu(pre[-1])
        return pre, torch.autograd.grad(h.sum(), weights)

    def conv2d(dtype):
        wide = [p.detach().to(dtype).requires_grad_() for p in params]
        h, pre = x.to(dtype), []
        for c, w, b in zip(convs, wide[::2], wide[1::2]):
            pre.append(F.conv2d(h, w, b, stride=c.stride, padding=1))
            h = torch.relu(pre[-1])
        return ([z.permute(0, 2, 3, 1) for z in pre],
                torch.autograd.grad(h.sum(), wide))

    def rel_err(got, ref):
        return max(((g.double() - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(got, ref))

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = {"images": images,
               "unfold_gemm_ms": graph_ms(lambda: port(params), calls=20),
               "cudnn_deterministic_ms": graph_ms(
                   lambda: conv2d(torch.float32), calls=20)}
        pre_lib, grads_lib = conv2d(torch.float32)
        pre_ref, grads_ref = conv2d(torch.float64)
    pre, grads = port(params)
    _, again = port(params)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "the image embedder's gradients differ between two backward "
          "passes")
    out.update(
        unfold_gemm_fwd_rel_err_vs_float64=rel_err(pre, pre_ref),
        cudnn_fwd_rel_err_vs_float64=rel_err(pre_lib, pre_ref),
        unfold_gemm_grad_rel_err_vs_float64=rel_err(grads, grads_ref),
        cudnn_grad_rel_err_vs_float64=rel_err(grads_lib, grads_ref),
        unfold_gemm_relu_flips_vs_float64=sum(
            int(((z.double() > 0) != (r > 0)).sum())
            for z, r in zip(pre, pre_ref)))
    check(out["unfold_gemm_fwd_rel_err_vs_float64"] <= CONV_FWD_RTOL,
          f"image embedder pre-activations: {out}")
    log(f"image embedder convolutions: {json.dumps(out)}")
    return out


def image_phase(seed, ca):
    """DTQN on ImageMaze-9-v0 at in_embed 128 (the validation policy's
    configuration): uint8 CHW observations through the CNN embedder."""
    from dtqn_tpu_torch.train.runner import run_experiment

    instances = [ca.launch_config(k, 50, 50, 128 // 8)[:2]
                 for k in ("attention_fwd", "attention_bwd")]
    check(instances == [(16, 2)] * 2, f"image instances {instances}")
    run, agent, state, train_iter = drive(
        seed, ca, IMAGE_ENV, 110, 2, evaluate=True, model="DTQN",
        inner_embed=128, bag_size=0)
    check(state.context.obs.dtype == torch.uint8
          and state.buffer.obs.dtype == torch.uint8,
          "image observations were widened")
    run["operations"] = operations(agent, state, IMAGE_ENV)
    run["profile"] = profile_iteration(state, train_iter,
                                       what=f"{IMAGE_ENV} DTQN")
    run["convolutions"] = conv_cost(
        state.network, agent.config.batch_size * agent.config.context_len)

    cfg = image_runner_config(seed)
    iters = cfg.num_steps // cfg.num_envs
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            Probe().attached() as probe:
        reset_launch_counts()
        final = run_experiment(cfg)
        launches, eval_steps = check_launches(ca, probe, cfg, iters,
                                              "image runner")
        check_csvs(cfg, [128, 256])
        check(all(math.isfinite(v) for v in final.values()),
              f"image runner: final log not finite: {final}")
        whole_weights = saved_policy(cfg, "cpu").state_dict()
    runner = {
        "launches": launches, "evaluation_steps": eval_steps,
        "chunk_s": probe.seconds["chunk"],
        "evaluation_s": probe.seconds["evaluate"], "final_log": final,
    }
    log(f"image runner: {json.dumps(runner)}")
    runner["resume"] = resume_phase(seed, ca, whole_weights,
                                    image_runner_config, "image resume")
    run["runner"] = runner
    return run, (agent, state)


def attention_maps_card_vs_cpu(seed):
    """``attention_weights`` on the card against the CPU, at the flagless
    width with and without a bag of 10: maps within the forward's
    tolerance, Q within Q_ATOL, and the card's Q the kernel forward's."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.models import attention_weights

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for bag in (0, 10):
        cfg = AgentConfig(model="DTQN", num_envs=64, context_len=50,
                          history=50, inner_embed=64, num_heads=8,
                          num_layers=2, bag_size=bag)
        agent = Agent(cfg, make_env("DiscreteCarFlag-v0"), device=DEVICE)
        cpu_net = agent.build_network(torch.Generator().manual_seed(seed))
        card_net = agent.build_network(
            torch.Generator().manual_seed(seed)).to(DEVICE)
        args = [torch.rand((64, 50, 3), generator=gen) * 2.2 - 1.1,
                torch.randint(0, 3, (64, 50), generator=gen)]
        if bag:
            args += [torch.rand((64, bag, 3), generator=gen) * 2.2 - 1.1,
                     torch.randint(0, 3, (64, bag), generator=gen)]
        card_args = [a.to(DEVICE) for a in args]
        with torch.no_grad():
            q_card, maps_card = attention_weights(card_net, *card_args)
            q_kernel = card_net(*card_args)
            q_cpu, maps_cpu = attention_weights(cpu_net, *args)
        what = f"attention_weights, bag {bag}"
        check(torch.equal(q_card, q_kernel),
              f"{what}: Q is not the kernel forward's")
        check(len(maps_card) == len(maps_cpu) == 2 + bool(bag)
              and all(m.shape == (64, 50, 50) for m in maps_card[-2:]),
              f"{what}: maps {[tuple(m.shape) for m in maps_card]}")
        map_err = max((a.cpu() - b).abs().max().item()
                      for a, b in zip(maps_card, maps_cpu))
        q_err = (q_card.cpu() - q_cpu).abs().max().item()
        check(map_err <= FWD_ATOL, f"{what}: maps differ by {map_err}")
        check(q_err <= Q_ATOL, f"{what}: Q differs by {q_err}")
        out[f"bag_{bag}"] = {"maps": len(maps_card),
                             "map_max_abs_err_vs_cpu": map_err,
                             "q_max_abs_err_vs_cpu": q_err}
    log(f"attention maps: {json.dumps(out)}")
    return out


def variants_phase(seed, ca, runs):
    """The ablations on the flagless configuration (DiscreteCarFlag-v0,
    in_embed 64); their updates timed in turns with ``runs``' ({name:
    (agent, state)}), to which they are added."""
    result = {}
    for name, kw in VARIANTS:
        run, agent, state, train_iter = drive(
            seed, ca, "DiscreteCarFlag-v0", 210, 2, model="DTQN",
            inner_embed=64, bag_size=0, **kw)
        if agent.config.dropout > 0.0:
            check(run["launches"]["attention_bwd"] == 0,
                  f"{name}: a train-mode update launched a kernel")
        run["operations"] = operations(agent, state, name)
        run["profile"] = profile_iteration(state, train_iter,
                                           what=f"{name} DTQN")
        result[name] = run
        runs[name] = (agent, state)
    result["attention_weights"] = attention_maps_card_vs_cpu(seed)
    result["update_ms_in_turns"] = update_ms_in_turns(runs)
    return result


def multi_phase(seed, ca):
    """DTQN at in_embed 128 on the four-rooms 7x7 and 9x9 domains, a domain
    drawn per episode (the validation policy's configuration), then one
    evaluation on each domain's own padded env.  Returns the result and the
    (agent, state) for the updates timed in turns."""
    from dtqn_tpu_torch.config import ExperimentConfig
    from dtqn_tpu_torch.train.loop import make_evaluate
    from dtqn_tpu_torch.train.runner import build_envs

    run, agent, state, _ = drive(seed, ca, FOUR_ROOMS, 260, 2, model="DTQN",
                                 inner_embed=128, bag_size=0)
    domains = torch.bincount(state.env_state.domain.long(), minlength=2)
    check(bool((domains > 0).all()), f"domains drawn: {domains.tolist()}")
    run["envs_per_domain"] = domains.tolist()
    run["operations"] = operations(agent, state, "four rooms")
    eval_cfg = dataclasses.replace(agent.config, num_envs=10)
    evals = build_envs(ExperimentConfig(envs=list(FOUR_ROOMS)))[1]
    for i, env in enumerate(evals):
        with launch_ledger(ca) as ledger, counted_greedy_calls() as calls:
            reset_launch_counts()
            sr, ret, length = (
                float(x) for x in make_evaluate(agent, env, 10)(
                    state.network,
                    torch.Generator(device=DEVICE).manual_seed(seed + i)))
            steps = calls["calls"]
            launches = check_ledger(
                ca, ledger, reckoned_launches(eval_cfg, steps, 0),
                f"four rooms, evaluation on {env.name}", 0)
        cap = env.max_episode_steps
        check(0.0 <= sr <= 1.0 and 1.0 <= length <= cap
              and 1 <= steps <= cap and abs(ret) <= 5.0 + 0.05 * cap,
              f"{env.name}: evaluation out of range: {sr}, {ret}, {length}")
        run[f"evaluation {env.name}"] = {
            "result": [sr, ret, length], "steps": steps,
            "launches": launches}
    log(f"four rooms: {json.dumps(run)}")
    return run, (agent, state)


def continuous_phase(seed):
    """Continuous Car Flag: 200 steps of random forces in [-1.5, 1.5] (the
    env clips them to [-1, 1]) on 64 envs, the card against the CPU, with
    states, observations, rewards and flags equal bit for bit."""
    from dtqn_tpu_torch.envs import make_env

    env = make_env("CarFlag-continuous-v0")
    gen = torch.Generator().manual_seed(seed)
    _, cpu = env.reset_env(gen, 64, "cpu")
    card = dataclasses.replace(cpu, **{
        f.name: getattr(cpu, f.name).to(DEVICE)
        for f in dataclasses.fields(cpu)})
    forces = torch.rand((200, 64, 1), generator=gen) * 3.0 - 1.5
    ended = torch.zeros(64, dtype=torch.bool)
    for f in forces:
        obs_cpu, cpu, ts_cpu = env.step(None, cpu, f)
        obs_card, card, ts_card = env.step(None, card, f.to(DEVICE))
        same = [torch.equal(obs_card.cpu(), obs_cpu)] + [
            torch.equal(getattr(card, k.name).cpu(), getattr(cpu, k.name))
            for k in dataclasses.fields(cpu)] + [
            torch.equal(getattr(ts_card, k).cpu(), getattr(ts_cpu, k))
            for k in ("reward", "terminated", "truncated")]
        check(all(same), "continuous Car Flag: the card's step differs from "
                         "the CPU's")
        ended |= ts_cpu.terminated
    result = {"steps": 200, "envs": 64, "envs_at_a_flag": int(ended.sum()),
              "bit_equal": True}
    log(f"continuous Car Flag: {json.dumps(result)}")
    return result


# ------------------------------------------------------------------ sweep
SWEEP_SEEDS = 5  # the reference protocol's seeds 1-5 (README.md:35-36)
# At S seeds, one update may launch at most this many times the kernels of a
# single-seed update (a loop over the seeds would launch S times as many).
SWEEP_KERNEL_RATIO = 2.0
TURNS = (1, SWEEP_SEEDS, SWEEP_SEEDS, 1)


def update_kernels_in_turns(ca, runs, turns=TURNS):
    """Device kernels, device time and attention launches of one update of
    each of ``runs`` ({key: (agent, state)}), profiled in ``turns`` (keys
    of ``runs``); the means of each key's turns."""
    from dtqn_tpu_torch.utils.graphs import leaves_kept

    for agent, state in runs.values():
        with leaves_kept(state):
            agent.learn(state)  # warm
    seen = {n: [] for n in runs}
    for n in turns:
        agent, state = runs[n]
        reset_launch_counts()
        with leaves_kept(state):
            _, by_name = device_events(lambda: agent.learn(state))
        seen[n].append((sum(k for k, _ in by_name.values()),
                        sum(us for _, us in by_name.values()),
                        {k: v for k, v in ca.launch_counts.items() if v}))
    out = {}
    for n, seen_n in seen.items():
        out[n] = {
            "device_kernels": [t[0] for t in seen_n],
            "device_us": [t[1] for t in seen_n],
            "attention_launches": seen_n[0][2],
            "mean_device_kernels": sum(t[0] for t in seen_n) / len(seen_n),
            "mean_device_us": sum(t[1] for t in seen_n) / len(seen_n),
        }
        check(all(t[2] == seen_n[0][2] for t in seen_n),
              f"{n}: attention launches differ between turns")
    log(f"update kernels in turns: {json.dumps(out)}")
    return out


def sweep_kernels_in_turns(ca, runs):
    """``update_kernels_in_turns`` at 1 and SWEEP_SEEDS seeds ({seed count:
    (agent, state)}): at most SWEEP_KERNEL_RATIO times the kernels of one
    seed's update, and its attention launches."""
    out = update_kernels_in_turns(ca, runs)
    one, many = out[1], out[SWEEP_SEEDS]
    ratio = many["mean_device_kernels"] / one["mean_device_kernels"]
    check(ratio <= SWEEP_KERNEL_RATIO,
          f"an update at {SWEEP_SEEDS} seeds launches {ratio:.2f}x the "
          f"kernels of one seed's (at most {SWEEP_KERNEL_RATIO})")
    check(many["attention_launches"] == one["attention_launches"],
          f"attention launches per update: {many['attention_launches']} at "
          f"{SWEEP_SEEDS} seeds, {one['attention_launches']} at one")
    out["kernel_ratio"] = ratio
    return out


def rates_in_turns(runs, what, turns=TURNS):
    """Aggregate env-steps/s of one train iteration (64 env steps per seed,
    64 updates) of each of ``runs`` ({key: (state, train_iter)}), timed in
    ``turns`` (keys of ``runs``), over every seed's env steps, after one
    untimed call each (a compiled chunk whose state moved since its
    capture captures again there)."""
    for state, train_iter in runs.values():
        train_iter(state)
    seen = {n: [] for n in runs}
    for n in turns:
        state, train_iter = runs[n]
        seeds = state.seed_shape[0] if state.seed_shape else 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_iter(state)
        torch.cuda.synchronize()
        seen[n].append(seeds * 64 / (time.perf_counter() - t0))
    out = {n: {"env_steps_per_s_turns": t,
               "env_steps_per_s": sum(t) / len(t)} for n, t in seen.items()}
    log(f"{what} rates in turns: {json.dumps(out)}")
    return out


def aggregate_rates(runs, what):
    """``rates_in_turns`` at 1 and SWEEP_SEEDS seeds, with the ratio of the
    aggregate rates."""
    out = rates_in_turns(runs, what)
    out["aggregate_ratio"] = (out[SWEEP_SEEDS]["env_steps_per_s"]
                              / out[1]["env_steps_per_s"])
    return out


def sweep_runner_phase(seed, ca):
    """``run_sweep`` at 2 seeds on the runner's schedule (bench width): the
    per-seed CSVs and policies, the completion sentinel, the launches; the
    same sweep cut by a time limit after its first chunk, resumed, and each
    seed's final policy held bit for bit against the uninterrupted one's."""
    from types import SimpleNamespace

    from dtqn_tpu_torch.train.sweep import run_sweep, sweep_path
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    seeds = [seed, seed + 1]

    def config(**kw):
        return runner_config(seed, prepop_steps=64 * 210, **kw)

    def per_seed(cfg):
        return [dataclasses.replace(cfg, seed=s) for s in seeds]

    def policies(cfg):
        return [torch.load(c.policy_path() + "_policy.pt", weights_only=True)
                for c in per_seed(cfg)]

    cfg = config()
    iters = cfg.num_steps // cfg.num_envs
    cut_at = cfg.resolved_iters_per_chunk * cfg.num_envs
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            counted_greedy_calls() as calls:
        reset_launch_counts()
        t0 = time.perf_counter()
        final = run_sweep(cfg, seeds)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        launches, eval_steps = check_launches(
            ca, SimpleNamespace(greedy_calls=calls), cfg, iters,
            "sweep runner")
        for c in per_seed(cfg):
            check_csvs(c, [cut_at, cfg.num_steps])
        check(all(math.isfinite(v) for s in seeds for v in final[s].values())
              and all(final[s]["losses/Grad_Norm"] > 0.0 for s in seeds),
              f"sweep runner: final logs {final}")
        ck = sweep_path(cfg, seeds)
        check(ckpt.load_mini_checkpoint(ck)
              == {"step": cfg.num_steps, "wandb_id": None},
              "sweep completion sentinel")
        check(ckpt.has_checkpoint(ck), "a finished sweep kept no checkpoint")
        whole = policies(cfg)
        check(run_sweep(cfg, seeds)
              == {"completed": True, "step": cfg.num_steps},
              "a second sweep call did not short-circuit")

    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        cut = config(time_limit=1e-9)
        run_sweep(cut, seeds)
        ck = sweep_path(cfg, seeds)  # paths are under the working directory
        check(ckpt.load_mini_checkpoint(ck)["step"] == cut_at,
              f"the cut sweep's mini checkpoint is not at step {cut_at}")
        nbytes = os.path.getsize(ck + "_checkpoint.pt")
        for c in per_seed(cut):
            check_csvs(c, [cut_at])
        run_sweep(cfg, seeds)
        check(ckpt.load_mini_checkpoint(ck)["step"] == cfg.num_steps,
              "the resumed sweep did not finish")
        for c in per_seed(cfg):
            check_csvs(c, [cut_at, cfg.num_steps])
        resumed = policies(cfg)
    for s, got, ref in zip(seeds, resumed, whole):
        differing = [k for k in ref if not torch.equal(got[k], ref[k])]
        check(not differing, f"seed {s}: the resumed sweep's parameters "
                             f"differ from the uninterrupted one's in "
                             f"{differing}")
    result = {"seeds": seeds, "whole_run_s": whole_s, "launches": launches,
              "evaluation_steps": eval_steps, "checkpoint_bytes": nbytes,
              "final_parameters_bit_equal": True,
              "final_log": {str(s): final[s] for s in seeds}}
    log(f"sweep runner: {json.dumps(result)}")
    return result


def sweep_phase(seed, ca, flagless):
    """The multi-seed sweep: the flagless configuration at SWEEP_SEEDS
    stacked seeds (prepopulation, two iterations, an evaluation; launches by
    folded shape, card Q against CPU Q per seed, gradients repeating); its
    update against the main path's ``flagless`` (agent, state, train_iter)
    in turns: kernels, device time, attention launches, host time, and the
    aggregate env-steps/s of an iteration; a profiled iteration of each;
    the bag at 2 seeds (the evict forward at 2 * 1664) and at 1 and
    SWEEP_SEEDS seeds timed in turns; ``run_sweep`` whole, cut and
    resumed."""
    seeds = [seed + i for i in range(SWEEP_SEEDS)]
    one_agent, one_state, one_iter = flagless
    run, agent, state, train_iter = drive(
        seed, ca, "DiscreteCarFlag-v0", 210, 2, evaluate=True, seeds=seeds,
        turns=True, model="DTQN", inner_embed=64, bag_size=0)
    result = {"flagless": run}
    runs = {1: (one_agent, one_state), SWEEP_SEEDS: (agent, state)}
    result["update_kernels_in_turns"] = sweep_kernels_in_turns(ca, runs)
    result["update_ms_in_turns"] = update_ms_in_turns(
        {str(n): r for n, r in runs.items()})
    result["flagless_rates_in_turns"] = aggregate_rates(
        {1: (one_state, one_iter), SWEEP_SEEDS: (state, train_iter)},
        "flagless")
    result["profile"] = {
        str(n): profile_iteration(st, it, what=f"one iteration at {n} seeds")
        for n, (st, it) in ((1, (one_state, one_iter)),
                            (SWEEP_SEEDS, (state, train_iter)))}
    del agent, state, train_iter, runs

    result["bag_x2"], *_ = drive(seed, ca, GV_ENV, 300, 1, seeds=seeds[:2])
    bag_one, _, one_bag, one_bag_iter = drive(seed, ca, GV_ENV, 300, 1)
    bag_many, _, many_bag, many_bag_iter = drive(seed, ca, GV_ENV, 300, 1,
                                                 seeds=seeds)
    result["bag_x1"], result[f"bag_x{SWEEP_SEEDS}"] = bag_one, bag_many
    result["bag_rates_in_turns"] = aggregate_rates(
        {1: (one_bag, one_bag_iter), SWEEP_SEEDS: (many_bag, many_bag_iter)},
        "bag")
    del one_bag, many_bag, one_bag_iter, many_bag_iter
    result["runner"] = sweep_runner_phase(seed, ca)
    return result


# ------------------------------------------------------------------ timing
def graph_ms(fn, calls=100, replays=20):
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(kind, b, lq, lk, heads, d, causal, dtype=torch.float32):
    """Least time on an H100 SXM: each input read once and each output
    written once over HBM (4 or 2 bytes an element), or the multiply-adds
    of the unmasked (query, key) pairs over the rate for the inputs' type
    (float32 67 TFLOP/s; bf16 989 TFLOP/s, the tensor cores'), whichever
    is larger."""
    e = heads * d
    size = torch.finfo(dtype).bits // 8
    pairs = lq * (lq + 1) // 2 if causal else lq * lk
    if kind == "attention_fwd":  # reads q, k, v; writes out
        nbytes, products = size * b * e * (2 * lq + 2 * lk), 2
    else:  # reads q, k, v, dout; writes dq, dk, dv
        nbytes, products = size * b * e * (3 * lq + 4 * lk), 5
    flops = products * 2 * b * heads * d * pairs
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timings(ca, b, lq=50, lk=50, heads=8, d=8, causal=True, calls=100,
            dtype=torch.float32):
    """Device ms of each kernel, its plain version and SDPA at one shape,
    in ``dtype``, ``calls`` calls per CUDA graph.  Where the shape takes the
    tensor-core form, it is timed in turns (picked, lanes, lanes, picked)
    with the keys-on-lanes instance that the shape took before it
    (``lanes_ms``, launched by configuration: counts nothing)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    e = heads * d
    q, dout = (rand(gen, b, lq, e).to(dtype) for _ in range(2))
    k, v = (rand(gen, b, lk, e).to(dtype) for _ in range(2))

    def heads_view(x):
        return x.view(b, x.shape[1], heads, d).transpose(1, 2)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            heads_view(q), heads_view(k), heads_view(v), is_causal=causal
        )

    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    do_h = heads_view(dout)

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), do_h)

    def picked_and_lanes(kind, launch, args):
        """{"ms"} of the picked instance, and where that is the
        tensor-core form, {"lanes_ms", "turns_ms"} too."""
        picked = ca.launch_config(kind, lq, lk, d, dtype)
        lanes = ca.launch_config(kind, lq, lk, d, dtype, lanes=True)
        counted = getattr(ca, kind)
        out = {"form": ca.form_name(picked)}
        if picked == lanes:
            out["ms"] = graph_ms(lambda: counted(*args), calls)
            return out
        turns = [graph_ms(lambda cfg=cfg: launch(*args, cfg), calls)
                 for cfg in (picked, lanes, lanes, picked)]
        out.update(ms=(turns[0] + turns[3]) / 2,
                   lanes_form=ca.form_name(lanes),
                   lanes_ms=(turns[1] + turns[2]) / 2, turns_ms=turns)
        return out

    fwd = {
        **picked_and_lanes("attention_fwd", ca.launch_fwd,
                           (q, k, v, heads, causal)),
        "plain_ms": graph_ms(
            lambda: ca.plain_attention_fwd(q, k, v, heads, causal), calls),
        "library_ms": graph_ms(lambda: sdpa(q, k, v), calls),
    }
    # SDPA's backward alone is no single call: time forward + backward and
    # take the forward's time off.
    lib_both = graph_ms(sdpa_fwd_bwd, calls)
    bwd = {
        **picked_and_lanes("attention_bwd", ca.launch_bwd,
                           (q, k, v, dout, heads, causal)),
        "plain_ms": graph_ms(
            lambda: ca.plain_attention_bwd(q, k, v, dout, heads, causal),
            calls),
        "library_ms": max(lib_both - fwd["library_ms"], 0.0),
    }
    out = {}
    for name, t in (("attention_fwd", fwd), ("attention_bwd", bwd)):
        bound, by = bound_ms(name, b, lq, lk, heads, d, causal, dtype)
        out[name] = dict(t, bound_ms=bound, bound_by=by)
    shape = (f"B={b} Lq={lq} Lk={lk} H={heads} D={d} "
             f"{'causal' if causal else 'non-causal'} {dtype_name(dtype)}")
    log(f"timings {shape}: {json.dumps(out)}")
    return shape, out


# The bag path's shapes: (B, Lk, D) at Lq = 50, non-causal: the update, the
# act forward and the evict forward, on gv_memory (bag 25, head width 16)
# and on Car Flag (bag 10, head width 8); and the evict forward's causal
# layers.
BAG_TIMING_SHAPES = [
    dict(b=32, lk=25, d=16, causal=False),
    dict(b=64, lk=25, d=16, causal=False),
    dict(b=1664, lk=25, d=16, causal=False),
    dict(b=32, lk=10, d=8, causal=False),
    dict(b=64, lk=10, d=8, causal=False),
    dict(b=1664, lk=10, d=8, causal=False),
    dict(b=1664, d=16),
]


# The sweep's folded batches (Lq = 50): the flagless path at 5 seeds
# (update, act, evaluation; head width 8, causal) and the bag at 2 and 5
# seeds (act, evict and, at 5, the update; head width 16, causal and over
# the bag of 25).  The largest take fewer calls per graph.
SWEEP_TIMING_SHAPES = [
    dict(b=160), dict(b=320), dict(b=50),
    dict(b=128, d=16), dict(b=128, lk=25, d=16, causal=False),
    dict(b=3328, d=16, calls=10),
    dict(b=3328, lk=25, d=16, causal=False, calls=10),
    dict(b=160, d=16), dict(b=160, lk=25, d=16, causal=False),
    dict(b=320, d=16), dict(b=320, lk=25, d=16, causal=False),
    dict(b=8320, d=16, calls=4),
    dict(b=8320, lk=25, d=16, causal=False, calls=4),
]


# The streamed <16, 0>, which head width 16 took at Lk = 50 before the
# staged <16, 2>: (kernel, B) at Lq = Lk = 50, H = 8, D = 16, causal.
STREAMED_SHAPES = [("attention_fwd", 32), ("attention_bwd", 32),
                   ("attention_fwd", 1664), ("attention_bwd", 1664)]


def streamed_timings(ca):
    """The streamed form at each STREAMED_SHAPES shape, launched through the
    C entry point with its own configuration (these launches count
    nothing), held against the plain version and timed in turns with the
    form the shape picks: streamed, picked, picked, streamed."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    heads, d, length = 8, 16, 50
    out = {}
    for kind, b in STREAMED_SHAPES:
        q, k, v, dout = (rand(gen, b, length, heads * d) for _ in range(4))
        streamed = ca.launch_config(kind, length, length, d, streamed=True)
        picked = ca.launch_config(kind, length, length, d)
        if kind == "attention_fwd":
            args = (q, k, v, heads, True)
            got = (ca.launch_fwd(*args, streamed),)
            ref = (ca.plain_attention_fwd(*args),)
            launch, atol = ca.launch_fwd, FWD_ATOL
        else:
            args = (q, k, v, dout, heads, True)
            got = ca.launch_bwd(*args, streamed)
            ref = ca.plain_attention_bwd(*args)
            launch, atol = ca.launch_bwd, GRAD_ATOL
        err = max((a - r).abs().max().item() for a, r in zip(got, ref))
        check(err <= atol, f"streamed {kind} at B={b} disagrees with the "
                           f"plain version: {err}")
        turns = [graph_ms(lambda: launch(*args, cfg))
                 for cfg in (streamed, picked, picked, streamed)]
        bound, by = bound_ms(kind, b, length, length, heads, d, True)
        name = (f"{kind} <16, 0> B={b} Lq={length} Lk={length} H={heads} "
                f"D={d} causal f32")
        out[name] = {
            "ms": (turns[0] + turns[3]) / 2,
            "picked": f"<{picked.head_dim_pad}, {picked.keys_per_lane}>",
            "picked_ms": (turns[1] + turns[2]) / 2,
            "turns_ms": turns,
            "max_abs_err": err,
            "bound_ms": bound,
            "bound_by": by,
        }
        log(f"streamed {name}: {json.dumps(out[name])}")
    return out


# -------------------------------------------------------------------- bf16
# The bf16 timing shapes at Lq = 50, H = 8, every shape a bf16 drive
# launches (each the tensor-core form, timed in turns with the
# keys-on-lanes instance it replaced): head width 8 at the flagless update,
# act and evaluation batches and the 2-seed sweep's folded act and
# evaluation batches, over Car Flag's bag of 10 at the update, act and
# evict batches and its evict forward's causal layers; head width 16 at
# the in_embed-128 paths' update, act,
# evaluation and evict batches and over the bag of 25.
BF16_TIMING_SHAPES = [
    dict(b=32), dict(b=64), dict(b=10), dict(b=128), dict(b=20),
    dict(b=32, lk=10, causal=False), dict(b=64, lk=10, causal=False),
    dict(b=704, lk=10, causal=False), dict(b=704),
    dict(b=32, d=16), dict(b=64, d=16), dict(b=10, d=16),
    dict(b=1664, d=16, calls=20),
    dict(b=32, lk=25, d=16, causal=False),
    dict(b=64, lk=25, d=16, causal=False),
    dict(b=1664, lk=25, d=16, causal=False, calls=20),
]
DTYPE_TURNS = ("f32", "bf16", "bf16", "f32")


def dtypes_of_one_update(agent, state, types):
    """The output dtypes of the modules of ``types`` over one update."""
    seen = {}

    def note(module, inputs, output):
        out = output[0] if isinstance(output, tuple) else output
        seen.setdefault(type(module).__name__, set()).add(str(out.dtype))

    from dtqn_tpu_torch.utils.graphs import leaves_kept

    hooks = [m.register_forward_hook(note) for m in state.network.modules()
             if isinstance(m, types)]
    try:
        with leaves_kept(state):
            agent.learn(state)
    finally:
        for h in hooks:
            h.remove()
    return {k: sorted(v) for k, v in seen.items()}


def bf16_runner_config(seed, **kw):
    return runner_config(seed, **dict(dict(bf16=True), **kw))


def trace_kernels(path):
    """{kernel name: launches} of the CUDA kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def bf16_runner_phase(seed, ca):
    """``run_experiment --bf16 --profile-dir``: the trace names the bf16
    attention kernels and holds one chunk; the run cut by a time limit and
    resumed ends bit-equal to it; ``run_sweep --bf16`` at 2 seeds."""
    from dtqn_tpu_torch.train.runner import run_experiment
    from dtqn_tpu_torch.train.sweep import run_sweep

    iters = bf16_runner_config(seed).num_steps // 64
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            Probe().attached() as probe, launch_ledger(ca) as ledger:
        cfg = bf16_runner_config(seed, profile_dir=os.path.join(tmp, "prof"))
        reset_launch_counts()
        final = run_experiment(cfg)
        launches, eval_steps = check_launches(ca, probe, cfg, iters,
                                              "bf16 runner")
        check_held(ledger, "bf16 runner")
        check_mma(ledger, "bf16 runner")
        check_csvs(cfg, [128, 256])
        check(all(math.isfinite(v) for v in final.values()),
              f"bf16 runner: final log not finite: {final}")
        # One Chrome trace and, since tracing is on for the run, the traced
        # chunk's last replay by phase.
        listed = sorted(os.listdir(cfg.profile_dir))
        traces = [n for n in listed if n.startswith("trace_")]
        phases = [n for n in listed if n.startswith("phases_")]
        check(len(traces) == len(phases) == 1 == len(listed) - 1,
              f"--profile-dir wrote {listed}")
        with open(os.path.join(cfg.profile_dir, phases[0])) as f:
            read = json.load(f)
        check(set(read["phases"]) >= {"act", "env", "replay_write", "sample",
                                       "update"} and read["replay"] > 0,
              f"--profile-dir's phases: {read}")
        kernels = trace_kernels(os.path.join(cfg.profile_dir, traces[0]))
        # bf16 attention kernels of either form; the tensor-core form's
        # names end their kernel part in _mma.
        traced = {kind: sum(n for name, n in kernels.items()
                            if kind in name and "bfloat16" in name)
                  for kind in ca.KINDS}
        traced_mma = {kind: sum(n for name, n in kernels.items()
                                if f"{kind}_mma" in name)
                      for kind in ca.KINDS}
        check(traced_mma == traced, f"the trace holds bf16 attention "
                                    f"kernels {traced}, {traced_mma} of "
                                    f"them the tensor-core form")
        # One chunk: 2 iterations, each an act forward and 64 updates.  The
        # profiler may drop a record (384-386 of an iteration's 386 forward
        # launches in phase 18's profiles): all but 1% of one chunk's
        # launches, and none of another chunk's.
        updates = cfg.resolved_iters_per_chunk * 64
        chunk = {"attention_fwd": cfg.layers * (
                     cfg.resolved_iters_per_chunk + 3 * updates),
                 "attention_bwd": cfg.layers * updates}
        check(all(0.99 * chunk[k] <= traced[k] <= chunk[k] for k in chunk),
              f"the trace holds attention kernels {traced}, one chunk "
              f"launches {chunk}")
        whole_weights = saved_policy(cfg, "cpu").state_dict()
    result = {"launches": launches, "evaluation_steps": eval_steps,
              "chunk_s": probe.seconds["chunk"], "final_log": final,
              "trace_attention_kernels": traced,
              "trace_kernel_launches": sum(kernels.values())}
    log(f"bf16 runner: {json.dumps(result)}")
    result["resume"] = resume_phase(seed, ca, whole_weights,
                                    bf16_runner_config, "bf16 resume")

    seeds = [seed, seed + 1]
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            launch_ledger(ca) as ledger:
        reset_launch_counts()
        cfg = bf16_runner_config(seed, num_steps=128, eval_frequency=64,
                                 prepop_steps=64 * 210)
        final = run_sweep(cfg, seeds)
        check_held(ledger, "bf16 sweep")
        check_mma(ledger, "bf16 sweep")
        check(all(math.isfinite(v) for s in seeds for v in final[s].values()),
              f"bf16 sweep: final log not finite: {final}")
        launches = launch_counts()
        optimizer_launches(cfg.num_steps // cfg.num_envs
                           * cfg.resolved_updates_per_iter, "bf16 sweep")
        check(launches["attention_fwd"] == launches["attention_bwd"] == 0
              and launches["attention_bwd_bf16"] > 0,
              f"bf16 sweep launches {launches}")
    result["sweep"] = {"seeds": seeds, "launches": launches,
                       "final_log": {str(s): final[s] for s in seeds}}
    log(f"bf16 sweep: {json.dumps(result['sweep'])}")
    return result


def bf16_phase(seed, ca, flagless, f32_operations):
    """The bf16 compute dtype: the bf16 instances against their plain
    versions; the flagless configuration in bf16 (two iterations, card Q
    against CPU Q in bf16 ulps) against the main path's float32
    ``flagless`` (agent, state, train_iter) in turns (operations and
    attention launches per update, device and host ms per update,
    env-steps/s, busy share); the bag of 25, DRQN on Memory-5 and
    ImageMaze in bf16, their device ms beside the float32 runs'
    ``f32_operations``; Car Flag with bag 10 and the flagless
    configuration at 2 stacked seeds, reckoned; the runner with
    --profile-dir, cut and resumed; a 2-seed sweep; the bf16 kernels'
    times, each in turns with the instance it replaced."""
    from dtqn_tpu_torch.models.embeddings import Conv3x3
    from dtqn_tpu_torch.models.init import Dense
    from dtqn_tpu_torch.models.recurrent import LSTM

    t0 = time.perf_counter()
    result = {"parity": bf16_parity(ca)}
    one_agent, one_state, one_iter = flagless
    run, agent, state, train_iter = drive(
        seed, ca, "DiscreteCarFlag-v0", 210, 2, model="DTQN",
        inner_embed=64, bag_size=0, bf16=True)
    result["flagless"] = run
    runs = {"f32": (one_agent, one_state), "bf16": (agent, state)}
    result["update_kernels_in_turns"] = update_kernels_in_turns(
        ca, runs, DTYPE_TURNS)
    result["update_ms_in_turns"] = update_ms_in_turns(runs)
    result["rates_in_turns"] = rates_in_turns(
        {"f32": (one_state, one_iter), "bf16": (state, train_iter)},
        "f32 and bf16", DTYPE_TURNS)
    result["profile"] = {
        n: profile_iteration(st, it, what=f"one {n} flagless iteration")
        for n, (st, it) in (("f32", (one_state, one_iter)),
                            ("bf16", (state, train_iter)))}
    del agent, state, train_iter, runs

    bag, agent, state, _ = drive(seed, ca, GV_ENV, 300, 1, bf16=True)
    bag["operations"] = operations(agent, state, "bf16 bag")
    bag["f32_operations"] = f32_operations["bag"]
    result["bag"] = bag
    del agent, state
    result["carflag_bag10"], *_ = drive(seed, ca, "DiscreteCarFlag-v0", 200,
                                        1, inner_embed=64, bag_size=10,
                                        bf16=True)
    result["sweep_drive"], *_ = drive(
        seed, ca, "DiscreteCarFlag-v0", 210, 1, model="DTQN",
        inner_embed=64, bag_size=0, bf16=True, seeds=[seed, seed + 1])
    for key, model, env_name, prepop in (
            ("drqn", "DRQN", "Memory-5-v0", 60),
            ("image", "DTQN", IMAGE_ENV, 110)):
        run, agent, state, _ = drive(seed, ca, env_name, prepop, 1,
                                     model=model, inner_embed=128,
                                     bag_size=0, bf16=True)
        run["dtypes"] = dtypes_of_one_update(agent, state,
                                             (LSTM, Conv3x3, Dense))
        check(run["dtypes"]["Dense"] == ["torch.bfloat16"],
              f"bf16 {model}: Dense outputs {run['dtypes']}")
        if model == "DRQN":
            check(run["dtypes"]["LSTM"] == ["torch.float32"],
                  f"bf16 DRQN: the LSTM runs in {run['dtypes']['LSTM']}")
        else:
            check(run["dtypes"]["Conv3x3"] == ["torch.bfloat16"],
                  f"bf16 ImageMaze: the CNN runs in "
                  f"{run['dtypes']['Conv3x3']}")
        run["operations"] = operations(agent, state, f"bf16 {model}")
        run["f32_operations"] = f32_operations[key]
        result[key] = run
        del agent, state
    result["runner"] = bf16_runner_phase(seed, ca)
    result["timings"] = dict(timings(ca, dtype=torch.bfloat16, **shape)
                             for shape in BF16_TIMING_SHAPES)
    # The bag's evict forward at B=1664: the tensor-core form against SDPA
    # in bf16 and against the keys-on-lanes <16, 2> it replaced, in turns.
    result["evict_forward_b1664"] = {
        shape: {"ms": t["attention_fwd"]["ms"],
                "lanes_ms": t["attention_fwd"]["lanes_ms"],
                "library_ms": t["attention_fwd"]["library_ms"],
                "under_library": t["attention_fwd"]["ms"]
                < t["attention_fwd"]["library_ms"],
                "at_most_half_of_lanes": t["attention_fwd"]["ms"]
                <= 0.5 * t["attention_fwd"]["lanes_ms"]}
        for shape, t in result["timings"].items()
        if shape.startswith("B=1664")}
    log(f"bf16 evict forward: {json.dumps(result['evict_forward_b1664'])}")
    result["seconds"] = time.perf_counter() - t0
    log(f"bf16 phase: {result['seconds']:.1f} s")
    return result


# ------------------------------------------- several devices (phase 20)
DP_RANKS = 2
# Per turn: DP_ITERS iterations of one update per env step (64; the first
# a warm-up of the timing), then DP_UPDATES more updates timed alone and
# DP_UPDATES profiled.
DP_ITERS = 4
DP_UPDATES = 16
# The phase's target-update frequency, lowered from the configuration's
# 10 000 so that each turn crosses applied target swaps: at least one in
# the first DP_CHECKED iterations (128 updates).
DP_TUF = 100
# The JAX package's sharding test holds its runs to DP_PARAM_TOL /
# DP_DIAG_TOL after 30 updates; here that holds through DP_CHECKED
# iterations.  Past them rounding differences grow with the training
# dynamics (a one-device run whose parameters are nudged by one ulp
# drifts further, PERF.md), and every iteration is held to that yardstick.
DP_CHECKED = 2
DP_TURNS = (1, DP_RANKS, DP_RANKS, 1)
DP_PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
DP_DIAG_TOL = dict(rtol=1e-3, atol=1e-4)
DP_FLOAT_KEYS = ("params", "target_params", "opt_state.mu", "opt_state.nu",
                 "diagnostics.averages.buf")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dp_load(path, device):
    """The flagless agent (target update every DP_TUF) on ``device`` and
    the one-device state saved at ``path``."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    cfg = AgentConfig(
        model="DTQN", num_envs=64, context_len=50, history=50,
        inner_embed=64, num_heads=8, num_layers=2, batch_size=32,
        buffer_size=500_000, target_update_frequency=DP_TUF,
    )
    agent = Agent(cfg, make_env("DiscreteCarFlag-v0"), device=device)
    state, _ = ckpt.load_checkpoint(path, agent.init_state(0))
    return agent, state


def dp_tensors(state, keys=None):
    """The tensors of a (global) state named ``keys`` (default: all, the
    generator's state with them) on the host, by checkpoint name."""
    from dtqn_tpu_torch.utils.checkpoint import _leaves

    return {name: (leaf.get_state() if isinstance(leaf, torch.Generator)
                   else leaf.detach().cpu().clone())
            for name, leaf in _leaves(state) if keys is None or name in keys}


def dp_turn(agent, state, train_iter, mesh, gathered):
    """DP_ITERS train iterations, the learner state after each and the
    ``gathered()`` global state after the last; then DP_UPDATES updates
    timed on the host and DP_UPDATES profiled: the turn's numbers."""
    from dtqn_tpu_torch.agents import Agent

    device = agent.device
    seconds, learner = [], []
    for _ in range(DP_ITERS):
        sync(device)
        t0 = time.perf_counter()
        train_iter(state)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        learner.append(dp_tensors(state, DP_FLOAT_KEYS))
    out = {"learner": learner, "state": gathered()}
    updater = Agent(agent.config, agent.env, device=device, mesh=mesh)
    before = (dict(mesh.counts), dict(mesh.seconds)) if mesh else None
    sync(device)
    t0 = time.perf_counter()
    for _ in range(DP_UPDATES):
        updater.learn(state)
    sync(device)
    update_s = (time.perf_counter() - t0) / DP_UPDATES
    timed = sorted(seconds[1:])[len(seconds[1:]) // 2]
    out.update({
        "iteration_s": seconds,
        "env_steps_per_s": agent.config.num_envs / timed,
        "host_ms_per_update": 1e3 * update_s,
    })
    if mesh is not None:
        out["collectives_per_update"] = {
            k: (mesh.counts[k] - before[0][k]) / DP_UPDATES
            for k in mesh.counts}
        out["collective_host_ms_per_update"] = {
            k: 1e3 * (mesh.seconds[k] - before[1][k]) / DP_UPDATES
            for k in mesh.seconds}
    if torch.device(device).type == "cuda":
        _, by_name = device_events(
            lambda: [updater.learn(state) for _ in range(DP_UPDATES)])
        out["device_ms_per_update"] = sum(
            us for _, us in by_name.values()) / 1e3 / DP_UPDATES
    return out


def dp_rank(mesh, path, turns):
    """One rank of phase 20, started by ``spawn``: in each of ``turns``
    turns, the saved one-device state loaded, sharded and trained through
    ``make_distributed_train_chunk``, every attention launch counted by
    shape and held by ``check_ledger``; the replicated state checked equal
    across the ranks, and the global state gathered (rank 0 returns it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from dtqn_tpu_torch.ops import cuda_attention as ca
    from dtqn_tpu_torch.parallel import (
        make_distributed_train_chunk,
        process_info,
        shard_state,
    )
    from dtqn_tpu_torch.parallel.mesh import check_replicated, unshard_state
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    out = {"process_info": process_info(), "device": str(mesh.device),
           "turns": []}
    for _ in range(turns):
        agent, state = dp_load(path, mesh.device)
        state = shard_state(agent, state, mesh)
        cfg = agent.config
        train_iter = make_distributed_train_chunk(
            agent, EpsilonSchedule(1.0, 0.1, 200_000), cfg.num_envs, 1, mesh,
            state)

        def gathered():
            check_replicated(state, mesh)
            return dp_tensors(unshard_state(state, mesh))

        reset_launch_counts()
        with launch_ledger(ca) as ledger:
            turn = dp_turn(agent, state, train_iter, mesh, gathered)
            launched = dict(ledger)
        if mesh.rank:
            del turn["learner"], turn["state"]  # rank 0's are the same
        share = dataclasses.replace(cfg, num_envs=cfg.num_envs // mesh.size,
                                    batch_size=cfg.batch_size // mesh.size)
        on_card = mesh.device.type == "cuda"
        updates = DP_ITERS * cfg.num_envs + DP_UPDATES * (2 if on_card else 1)
        turn["launches"] = check_ledger(
            ca, launched, reckoned_launches(share, DP_ITERS, updates),
            f"phase 20, rank {mesh.rank}", updates if on_card else 0)
        out["turns"].append(turn)
    return out


def dp_one_device(path, nudge=False):
    """A turn of one rank: the saved state trained on the card unsharded;
    with ``nudge``, from parameters one ulp above the saved ones."""
    from dtqn_tpu_torch.train.loop import make_train_chunk_fn
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    agent, state = dp_load(path, DEVICE)
    if nudge:
        with torch.no_grad():
            state.params.copy_(torch.nextafter(
                state.params, torch.full_like(state.params, math.inf)))
    train_iter = make_train_chunk_fn(
        agent, EpsilonSchedule(1.0, 0.1, 200_000), agent.config.num_envs, 1)
    return dp_turn(agent, state, train_iter, None, lambda: dp_tensors(state))


def dp_gaps(one, other):
    """{float learner field: its largest difference after each
    iteration}."""
    return {key: [(a[key] - b[key]).abs().max().item()
                  for a, b in zip(one["learner"], other["learner"])]
            for key in DP_FLOAT_KEYS}


def dp_compare(one, other, what, checked=DP_ITERS):
    """``other``'s turn against ``one``'s: the float learner state within
    the JAX package's sharding-test tolerances after each of the first
    ``checked`` iterations, and every other tensor of the final state
    (counters, flushed_total, generator, replay, contexts, env state)
    equal.  Returns the largest differences after each iteration."""
    for i, (a, b) in enumerate(zip(one["learner"][:checked],
                                   other["learner"])):
        for key in DP_FLOAT_KEYS:
            tol = DP_DIAG_TOL if key.startswith("diag") else DP_PARAM_TOL
            check(torch.allclose(b[key], a[key], **tol),
                  f"{what}: {key} after iteration {i + 1} differs by "
                  f"{(a[key] - b[key]).abs().max().item()} ({tol})")
    check(one["state"].keys() == other["state"].keys(),
          f"{what}: the states' fields differ")
    unequal = [key for key, a in one["state"].items()
               if key not in DP_FLOAT_KEYS
               and not torch.equal(a, other["state"][key])]
    check(not unequal, f"{what}: {unequal} differ")
    return dp_gaps(one, other)


def dp_runner_phase(seed):
    """``run_experiment`` with --dp-devices 2: whole; cut by the time limit
    and resumed (final parameters bit-equal to the whole run's: a sum over
    2 ranks does not depend on its order); the cut run's checkpoint resumed
    by a one-device run."""
    import shutil

    from dtqn_tpu_torch.train.runner import run_experiment
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    def cfg(project, **kw):
        # 250 prepopulation steps per env: every env ends an episode
        # within 200.
        return runner_config(seed, **dict(
            dict(dp_devices=DP_RANKS, prepop_steps=64 * 250,
                 project_name=project), **kw))

    seconds = {}
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        t0 = time.perf_counter()
        whole = cfg("dp-whole")
        final = run_experiment(whole)
        seconds["whole"] = time.perf_counter() - t0
        check_csvs(whole, [128, 256])
        check(all(math.isfinite(v) for v in final.values()),
              f"dp runner: final log not finite: {final}")
        check(ckpt.load_mini_checkpoint(whole.policy_path())
              == {"step": 256, "wandb_id": None}, "dp runner: sentinel")
        check(not ckpt.has_checkpoint(whole.policy_path()),
              "dp runner: an uninterrupted run wrote a full checkpoint")
        whole_weights = saved_policy(whole, "cpu").state_dict()

        t0 = time.perf_counter()
        run_experiment(cfg("dp-cut", time_limit=1e-9))
        seconds["cut"] = time.perf_counter() - t0
        cut = cfg("dp-cut")
        check(ckpt.has_checkpoint(cut.policy_path())
              and ckpt.load_mini_checkpoint(cut.policy_path())["step"] == 128,
              "dp runner: the time limit wrote no checkpoint at step 128")
        shutil.copytree(os.path.join("policies", "dp-cut"),
                        os.path.join("policies", "dp-handoff"))
        t0 = time.perf_counter()
        run_experiment(cut)
        seconds["resumed"] = time.perf_counter() - t0
        check_csvs(cut, [128, 256])
        weights = saved_policy(cut, "cpu").state_dict()
        differing = [k for k in weights
                     if not torch.equal(weights[k], whole_weights[k])]
        check(not differing, f"dp runner: the resumed run's final "
                             f"parameters differ in {differing}")

        handoff = cfg("dp-handoff", dp_devices=1)
        t0 = time.perf_counter()
        final = run_experiment(handoff)
        seconds["one_device_resume"] = time.perf_counter() - t0
        check(ckpt.load_mini_checkpoint(handoff.policy_path())["step"] == 256
              and math.isfinite(final["losses/TD_Error"]),
              "dp runner: a one-device run did not finish from the 2-rank "
              "checkpoint")
    return {"seconds": seconds, "resumed_bit_equal": True}


def dp_phase(seed, card, flagless):
    """Phase 20: phase 4's state saved as a one-device checkpoint, trained
    in turns on 1, 2, 2 and 1 ranks (the 2-rank turns in two processes on
    the one card, gloo), then once more on 1 rank from parameters nudged
    by one ulp; the 2-rank turns against the first 1-rank turn; then the
    runner over 2 ranks."""
    from dtqn_tpu_torch.parallel.distributed import pick_backend, spawn
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    _, state = flagless
    t_start = time.perf_counter()
    backend = pick_backend(DP_RANKS, DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagless")
        ckpt.save_checkpoint(path, state)
        first = dp_one_device(path)
        ranks = spawn(dp_rank, DP_RANKS, (path, 2), device=DEVICE)
        last = dp_one_device(path)
        nudged = dp_one_device(path, nudge=True)
    check(all(r["process_info"]["backend"] == backend for r in ranks),
          f"the ranks' backend is not {backend}: "
          f"{[r['process_info'] for r in ranks]}")
    two, again = ranks[0]["turns"]
    gaps = {
        "1_rank_repeat": dp_compare(first, last, "1-rank turns"),
        "2_rank_repeat": dp_compare(two, again, "2-rank turns"),
        "2_ranks_vs_1": dp_compare(first, two, "2 ranks against 1",
                                   DP_CHECKED),
        "1_ulp_nudge_vs_1": dp_gaps(first, nudged),
    }
    check(all(g == 0.0 for key in ("1_rank_repeat", "2_rank_repeat")
              for gs in gaps[key].values() for g in gs),
          f"a repeated turn differs: {gaps}")
    check(all(a <= b for a, b in zip(gaps["2_ranks_vs_1"]["params"],
                                     gaps["1_ulp_nudge_vs_1"]["params"])),
          f"the 2-rank run drifts further from the 1-rank run than a one-ulp "
          f"nudge of its parameters: {gaps}")
    train_steps = int(first["state"]["train_steps"])
    updates = DP_ITERS * state.obs.shape[0]  # one per env step
    swaps = train_steps // DP_TUF - (train_steps - updates) // DP_TUF
    check(swaps >= 2, f"the turns crossed {swaps} target swaps")

    def numbers(turn):
        return {k: v for k, v in turn.items() if k not in ("learner", "state")}

    # Each turn's numbers, per rank: 1, 2, 2, 1 ranks.
    timing = [[numbers(first)],
              [numbers(r["turns"][0]) for r in ranks],
              [numbers(r["turns"][1]) for r in ranks],
              [numbers(last)]]
    runner = dp_runner_phase(seed)
    result = {
        "card": card,
        "backend": backend,
        "process_info": [r["process_info"] for r in ranks],
        "target_swaps": swaps,
        "largest_differences_per_iteration": gaps,
        "turns": timing,
        "runner": runner,
        "seconds": time.perf_counter() - t_start,
    }
    log(f"dp phase: {json.dumps(result)}")
    return result


# ------------------------------------------------ the host loop (phase 21)
# The CueHost run: the JAX package's validation configuration
# (tools/host_loop_tpu_smoke.py: in_embed 32, context and history 8, 8
# heads, 2 layers, 32 envs, batch 32, prepopulation 1000) for one chunk of
# 156 iterations, the JAX run's first evaluation step (its _results.csv),
# where it stood at SuccessRate 1.0; the tool's bar is above 0.8.
CUE_ENV, CUE_STEPS, CUE_SR = "MH-CueHost-v0", 4992, 0.8
# The full-width configuration: the JAX CLI's defaults for
# --envs MH-Room-5-v0 (in_embed 128, context 50, 8 heads, 2 layers, batch
# 32, 32 envs, buffer 500k) on a fake env shaped like that domain's glyph
# crop: 9 x 9 int32 glyph tokens, MiniHack navigation's 8 compass moves and
# the 100-step cap (envs/minihack.py MH_SPECS).  The crop's observation
# space is NLE's Box(0, MAX_GLYPH) with MAX_GLYPH = 5976 (NetHack 3.6's
# glyph count), so the wrapper's mask is 5976 + 1 (mini_hack.py:44-53).
GLYPH_ENV, NLE_MAX_GLYPH, GLYPH_CROP, GLYPH_CAP = ("MH-GlyphRoom-v0", 5976,
                                                    9, 100)
# Prepopulation of the full-width drives: past the 100-step cap every env
# has ended an episode, so the ring holds more than the batch's 32.
GLYPH_PREPOP_ITERS = 110


def host_env_classes():
    """The phase's host envs: the cue task of tools/host_loop_tpu_smoke.py
    and a glyph room shaped like MH-Room-5-v0's observations."""
    import numpy as np

    from dtqn_tpu_torch.envs.core import ObsKind
    from dtqn_tpu_torch.envs.host import HostEnvironment

    class CueHostEnv(HostEnvironment):
        """Observe a cue token at t=0, then blanks; acting the cue ends the
        episode with +1, any other action costs 0.1."""

        name = CUE_ENV
        num_actions = 2
        max_episode_steps = 8
        obs_kind = ObsKind.DISCRETE
        obs_shape = (1,)
        obs_dtype = torch.int32

        def __init__(self, seed=0):
            self.rng = np.random.default_rng(seed)
            self.cue = 0

        @property
        def obs_mask(self):
            return 3.0

        def seed(self, seed):
            self.rng = np.random.default_rng(seed)

        def reset(self):
            self.cue = int(self.rng.integers(0, 2))
            return np.array([self.cue], np.int32)

        def step(self, action):
            if action == self.cue:
                return np.array([2], np.int32), 1.0, True, {"is_success": True}
            return np.array([2], np.int32), -0.1, False, {}

    # Stand-in glyph ids inside NLE's range: rock beyond the room, its
    # walls, floor, the down stair (the goal) and the agent.
    stone, wall, floor, stair, agent = 2359, 2360, 2378, 2382, 333
    moves = [(-1, 0), (0, 1), (1, 0), (0, -1),
             (-1, 1), (1, 1), (1, -1), (-1, -1)]
    pad = GLYPH_CROP // 2

    class GlyphRoomHost(HostEnvironment):
        """A 5 x 5 room: reach the stair by compass moves (+1 and the end
        of the episode); the observation is the 9 x 9 glyph crop around
        the agent, flattened to 81 int32 tokens."""

        name = GLYPH_ENV
        num_actions = len(moves)
        max_episode_steps = GLYPH_CAP
        obs_kind = ObsKind.DISCRETE
        obs_shape = (GLYPH_CROP * GLYPH_CROP,)
        obs_dtype = torch.int32

        def __init__(self, seed=0):
            self.rng = np.random.default_rng(seed)
            room = np.full((7, 7), wall, np.int32)
            room[1:6, 1:6] = floor
            self.map = np.pad(room, pad, constant_values=stone)

        @property
        def obs_mask(self):
            return float(NLE_MAX_GLYPH + 1)

        def seed(self, seed):
            self.rng = np.random.default_rng(seed)

        def _obs(self):
            r, c = self.pos
            crop = self.map[r:r + GLYPH_CROP, c:c + GLYPH_CROP].copy()
            gr, gc = self.goal
            if abs(gr - r) <= pad and abs(gc - c) <= pad:
                crop[gr - r + pad, gc - c + pad] = stair
            crop[pad, pad] = agent
            return crop.reshape(-1)

        def reset(self):
            cells = self.rng.choice(25, 2, replace=False)
            self.pos, self.goal = ((1 + x // 5, 1 + x % 5) for x in cells)
            return self._obs()

        def step(self, action):
            dr, dc = moves[action]
            r, c = self.pos[0] + dr, self.pos[1] + dc
            if 1 <= r <= 5 and 1 <= c <= 5:
                self.pos = (r, c)
            if self.pos == self.goal:
                return self._obs(), 1.0, True, {"is_success": True}
            return self._obs(), 0.0, False, {}

    return CueHostEnv, GlyphRoomHost


def host_config(seed, **kw):
    """A run of the host loop: the JAX CLI's defaults (32 envs, batch 32,
    in_embed 128, context 50, buffer 500k) unless ``kw`` replaces them."""
    from dtqn_tpu_torch.config import ExperimentConfig

    fields = dict(seed=seed, project_name="chip-smoke", device=DEVICE,
                  save_policy=True, eval_episodes=10)
    return ExperimentConfig(**dict(fields, **kw))


def host_reckoned(cfg, act_steps, updates, eval_steps):
    """The attention launches of ``act_steps`` act steps and ``updates``
    updates at the run's width and ``eval_steps`` evaluation steps of 10
    episodes (AgentConfig ``cfg``; no bag on these paths)."""
    out = reckoned_launches(cfg, act_steps, updates)
    evaluation = reckoned_launches(dataclasses.replace(cfg, num_envs=10),
                                   eval_steps, 0)
    for key, n in evaluation.items():
        out[key] = out.get(key, 0) + n
    return out


class HostProbe:
    """Clocks the host-side parts of a host-loop iteration from outside,
    each between synchronizations: the device-to-host copy of the actions,
    the host envs' step, the host-to-device copies of the step's arrays;
    counts the copies and their bytes."""

    def __init__(self):
        self.ms = {"d2h": 0.0, "env_step": 0.0, "h2d": 0.0}
        self.copies = {"d2h": 0, "h2d": 0}
        self.bytes = {"d2h": 0, "h2d": 0}

    def clocked(self, kind, fn, tensors=None):
        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.ms[kind] += 1e3 * (time.perf_counter() - t0)
            if tensors is not None:
                moved = tensors(args, out)
                self.copies[kind] += len(moved)
                self.bytes[kind] += sum(t.numel() * t.element_size()
                                        for t in moved)
            return out
        return wrapper

    @contextlib.contextmanager
    def attached(self, hl, vec):
        with patched(hl, "actions_to_host", self.clocked(
                "d2h", hl.actions_to_host, lambda args, out: [args[0]])), \
                patched(hl, "step_to_device", self.clocked(
                    "h2d", hl.step_to_device, lambda args, out: out)), \
                patched(vec, "step", self.clocked("env_step", vec.step)):
            yield self


def host_cue_phase(seed, ca):
    """``run_host_experiment`` from scratch on the cue task at the JAX
    validation configuration: the final success rate above CUE_SR, every
    attention launch reckoned by shape (head width 4, which the kernels
    pad to 8: <8, 1>) and held, the saved policy's Q on the card against
    the CPU's."""
    from dtqn_tpu_torch.agents import Agent
    from dtqn_tpu_torch.train import host_loop as hl
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    CueHostEnv, _ = host_env_classes()
    cfg = host_config(seed, envs=[CUE_ENV], in_embed=32, context=8,
                      history=8, prepop_steps=1000, num_steps=CUE_STEPS)
    acfg = cfg.agent_config()
    iters = CUE_STEPS // cfg.num_envs
    check(cfg.resolved_iters_per_chunk == iters,
          f"the cue run's chunk is {cfg.resolved_iters_per_chunk} "
          f"iterations, not {iters}")
    evaluations = []
    evaluate = hl.evaluate_host

    def clocked_evaluate(*args):
        t0 = time.perf_counter()
        out = evaluate(*args)
        evaluations.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp), \
            launch_ledger(ca) as ledger, counted_greedy_calls() as calls, \
            patched(hl, "evaluate_host", clocked_evaluate):
        reset_launch_counts()
        t0 = time.perf_counter()
        final = hl.run_host_experiment(
            cfg, env_factory=lambda name: CueHostEnv())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        eval_steps = calls["calls"] - iters
        by_shape = check_ledger(
            ca, ledger,
            host_reckoned(acfg, iters, iters * cfg.resolved_updates_per_iter,
                          eval_steps), "host loop, cue task",
            iters * cfg.resolved_updates_per_iter)
        launches = launch_counts()
        nets = {d: ckpt.load_policy(cfg.policy_path(), Agent(
            acfg, CueHostEnv(), device=d).build_network().to(d))
            for d in (DEVICE, "cpu")}
    sr = final[f"{CUE_ENV}/SuccessRate"]
    check(sr > CUE_SR, f"host loop, cue task: SuccessRate {sr} at step "
                       f"{CUE_STEPS}, not above {CUE_SR}")
    check(all(math.isfinite(v) for v in final.values()),
          f"host loop, cue task: final log not finite: {final}")
    gen = torch.Generator().manual_seed(seed)
    obs = torch.randint(0, 4, (cfg.num_envs, cfg.context, 1), generator=gen,
                        dtype=torch.int32)
    act = torch.randint(0, 2, (cfg.num_envs, cfg.context), generator=gen,
                        dtype=torch.int32)
    with torch.no_grad():
        q_gpu = nets[DEVICE](obs.to(DEVICE), act.to(DEVICE))
        q_cpu = nets["cpu"](obs, act)
    q_err = (q_gpu.cpu() - q_cpu).abs().max().item()
    check(q_err <= Q_ATOL, f"host loop, cue task: card Q differs from CPU Q "
                           f"by {q_err}")
    train_s = seconds - sum(evaluations)
    result = {
        "final_log": final, "success_rate": sr, "seconds": seconds,
        "evaluation_s": evaluations, "evaluation_steps": eval_steps,
        "env_steps_per_s_with_prepopulation": CUE_STEPS / train_s,
        "launches": launches, "launches_by_shape": by_shape,
        "policy_q_max_abs_err_vs_cpu": q_err,
    }
    log(f"host loop, cue task: {json.dumps(result)}")
    return result


HOST_COMPARED = 2  # iterations compared leaf by leaf before the turns


def host_drive(seed, ca, bf16=False):
    """The host loop's functions at full width on the glyph room: init from
    the host envs' reset, GLYPH_PREPOP_ITERS random iterations (graphed);
    then, in float32, the state saved and loaded into a second one and the
    host envs deep-copied, and HOST_COMPARED iterations of the plain bodies
    (``make_host_bodies``) on the copy and of the graphed functions
    (``make_host_fns``) on the saved state, every leaf and launch bit-equal
    after each; the two in turns (eager, graphed, graphed, eager: wall and
    host ms per iteration, env-steps/s), one profiled iteration of each
    (device ms, operations, busy share) and one clocked part by part
    (HostProbe), the leaves still equal after them; the captures' seconds
    and the graph pool's bytes; card Q against CPU Q; gradients repeating;
    an update's peak memory; one evaluation eager, then two graphed
    (captures, replays): results and generators' end states equal.  In
    bf16, one iteration to warm up and one timed.  Every attention launch
    reckoned and held."""
    import copy

    from dtqn_tpu_torch.agents import Agent
    from dtqn_tpu_torch.envs.host import HostVecEnv
    from dtqn_tpu_torch.train import host_loop as hl
    from dtqn_tpu_torch.utils import checkpoint as ckpt
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    _, GlyphRoomHost = host_env_classes()
    cfg = host_config(seed, envs=[GLYPH_ENV], bf16=bf16)
    acfg = cfg.agent_config()
    what = f"host loop, glyph room{' bf16' if bf16 else ''}"
    envs = [GlyphRoomHost() for _ in range(cfg.num_envs)]
    for i, e in enumerate(envs):
        e.seed(seed + i)
    vec = HostVecEnv(envs)
    agent = Agent(acfg, vec.meta, device=DEVICE)
    updates = cfg.resolved_updates_per_iter
    eps = EpsilonSchedule(1.0, 0.1, 200_000)
    fns = hl.make_host_fns(agent, eps, updates)
    result = {}

    with launch_ledger(ca) as ledger:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = agent.init_state(seed, vec.reset_all())
        for _ in range(GLYPH_PREPOP_ITERS):
            hl.host_iteration(vec, state, fns.act_random, fns.observe_only,
                              fns.inputs)
        torch.cuda.synchronize()
        result["init_and_prepopulate_s"] = time.perf_counter() - t0
        check(not ledger, f"{what}: the prepopulation launched "
                          f"{show_ledger(ledger)}")
    flushed = int(state.buffer.flushed_total)
    check(flushed > cfg.batch, f"{what}: prepopulation flushed {flushed}")
    check(state.obs.dtype == torch.int32
          and tuple(state.obs.shape) == (cfg.num_envs, 81),
          f"{what}: observations {state.obs.dtype} {tuple(state.obs.shape)}")

    if bf16:
        with launch_ledger(ca) as ledger:
            reset_launch_counts()
            for _ in range(2):  # the first warms up (captures)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hl.host_iteration(vec, state, fns.act, fns.observe_and_learn,
                                  fns.inputs)
                torch.cuda.synchronize()
            t_iter = time.perf_counter() - t0
            result.update(iteration_s=t_iter,
                          env_steps_per_s=cfg.num_envs / t_iter,
                          launches=launch_counts(),
                          launches_by_shape=check_ledger(
                              ca, ledger, reckoned_launches(acfg, 2,
                                                            2 * updates),
                              f"{what}, 2 iterations", 2 * updates))
            check_mma(ledger, what)
        check(int(state.train_steps) == 2 * updates,
              f"{what}: train_steps {int(state.train_steps)}")
        check(int(state.nonfinite_grads) == 0, f"{what}: non-finite "
                                               "gradients")
        result["q_vs_cpu"] = q_card_vs_cpu(agent, state, what)
        log(f"{what}: {json.dumps(result)}")
        return result

    # The eager run goes on from the saved state, on host envs in the
    # graphed run's state.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "saved")
        ckpt.save_checkpoint(path, state)
        eager, _ = ckpt.load_checkpoint(
            path, agent.init_state(seed, state.obs.cpu()))
    runs = {"eager": (eager, copy.deepcopy(vec),
                      hl.make_host_bodies(agent, eps, updates)),
            "graphed": (state, vec, fns)}

    def iterate(kind):
        st, v, f = runs[kind]
        hl.host_iteration(v, st, f.act, f.observe_and_learn, f.inputs)

    def same(when):
        differ = differing_leaves(eager, state)
        check(not differ, f"{what}, {when}: the graphed state's leaves "
                          f"differ from the eager one's: {differ}")

    for i in range(HOST_COMPARED):
        seen = {}
        for kind in runs:
            with launch_ledger(ca) as ledger:
                reset_launch_counts()
                iterate(kind)
                seen[kind] = (launch_counts(), check_ledger(
                    ca, ledger, reckoned_launches(acfg, 1, updates),
                    f"{what}, {kind} iteration {i + 1}", updates))
        same(f"iteration {i + 1}")
        check(seen["eager"] == seen["graphed"],
              f"{what}, iteration {i + 1}: launches eager "
              f"{seen['eager']}, graphed {seen['graphed']}")
    result["launches"] = {k: HOST_COMPARED * n
                          for k, n in seen["graphed"][0].items()}
    result["launches_by_shape_per_iteration"] = seen["graphed"][1]

    def timed(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterate(kind)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host, time.perf_counter() - t0

    times = {"eager": [], "graphed": []}
    for kind in EAGER_GRAPHED_TURNS:
        times[kind].append(timed(kind))
    turns = {kind: {"wall_ms": [1e3 * w for _, w in v],
                    "host_ms": [1e3 * h for h, _ in v],
                    "env_steps_per_s": [cfg.num_envs / w for _, w in v]}
             for kind, v in times.items()}
    for kind, (_, v, _) in runs.items():
        wall_us, by_name = device_events(lambda: iterate(kind))
        device_us = sum(us for _, us in by_name.values())
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        turns[kind]["profiled_iteration"] = {
            "wall_us": wall_us, "device_us": device_us,
            "device_ops": sum(n for n, _ in by_name.values()),
            "device_ops_per_update": sum(
                n for n, _ in by_name.values()) / updates,
            "device_busy_share": device_us / wall_us,
            "top_kernels": [{"name": name[:80], "count": n,
                             "device_us": us}
                            for name, (n, us) in ranked],
        }
        with HostProbe().attached(hl, v) as probe:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iterate(kind)
            torch.cuda.synchronize()
            turns[kind]["probed_iteration"] = {
                "wall_ms": 1e3 * (time.perf_counter() - t0),
                "host_ms": probe.ms, "copies": probe.copies,
                "bytes": probe.bytes}
    same("the turns, a profiled and a probed iteration")
    for kind in turns:
        turns[kind]["mean_env_steps_per_s"] = (
            sum(turns[kind]["env_steps_per_s"]) / 2)
    turns["speedup"] = (turns["graphed"]["mean_env_steps_per_s"]
                        / turns["eager"]["mean_env_steps_per_s"])
    result["in_turns"] = turns
    result["graphs"] = {name: graph_stats(getattr(fns, name).graph)
                        for name in ("act", "act_random", "observe_only",
                                     "observe_and_learn")}
    result["pool_bytes"] = pool_bytes(agent)
    log(f"{what}: eager and graphed in turns: {json.dumps(turns)}")
    iters = HOST_COMPARED + len(EAGER_GRAPHED_TURNS) // 2 + 2
    applied = int(state.train_steps)
    check(applied == iters * updates, f"{what}: train_steps {applied}")
    check(int(state.nonfinite_grads) == 0, f"{what}: non-finite gradients")
    check(int(state.env_steps) == iters * cfg.num_envs,
          f"{what}: env_steps {int(state.env_steps)}")
    diags = {k: float(v) for k, v in state.diagnostics.means().items()}
    check(all(map(math.isfinite, diags.values())),
          f"{what}: diagnostics not finite: {diags}")
    result["q_vs_cpu"] = q_card_vs_cpu(agent, state, what)
    result["parameters_with_repeating_gradients"] = gradients_repeat(
        agent, state, what)
    torch.cuda.reset_peak_memory_stats()
    agent.learn(state)
    torch.cuda.synchronize()
    result["update_peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    eval_fns = {"eager": hl.make_host_eval_bodies(agent, vec.meta, 10),
                "graphed": hl.make_host_eval(agent, vec.meta, 10)}
    evaluations = {}
    for kind in ("eager", "graphed", "graphed"):
        with launch_ledger(ca) as ledger, counted_greedy_calls() as calls:
            reset_launch_counts()
            gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
            seeds = iter(range(seed, seed + 10))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [float(x) for x in hl.evaluate_host(
                agent, state.network, lambda: GlyphRoomHost(next(seeds)), 10,
                gen, eval_fns[kind])]
            seconds = time.perf_counter() - t0
            steps = calls["calls"]
            launches = check_ledger(ca, ledger,
                                    host_reckoned(acfg, 0, 0, steps),
                                    f"{what}, {kind} evaluation", 0)
        evaluations.setdefault(kind, []).append(
            {"seconds": seconds, "steps": steps, "result": out,
             "launches": launches, "generator": gen.get_state()})
    first = evaluations["eager"][0]
    for e in evaluations["graphed"]:
        check(e["result"] == first["result"] and e["steps"] == first["steps"]
              and e["launches"] == first["launches"]
              and torch.equal(e["generator"], first["generator"]),
              f"{what}: a graphed evaluation {e['result']} in {e['steps']} "
              f"steps differs from the eager one, {first['result']} in "
              f"{first['steps']} steps, or its generator's end state does")
    sr, ret, length = first["result"]
    steps = first["steps"]
    check(1 <= steps <= GLYPH_CAP and 0.0 <= sr <= 1.0
          and 1.0 <= length <= GLYPH_CAP and 0.0 <= ret <= 1.0,
          f"{what}: evaluation out of range: {sr}, {ret}, {length}, "
          f"{steps} steps")
    result.update(
        evaluation=first["result"], evaluation_steps=steps,
        launches_evaluation=first["launches"],
        evaluation_s={kind: [e["seconds"] for e in v]
                      for kind, v in evaluations.items()},
        evaluation_graphs={name: graph_stats(getattr(
            eval_fns["graphed"], name).graph)
            for name in ("eval_init", "greedy", "eval_observe")},
        pool_bytes_after_evaluation=pool_bytes(agent),
        flushed_episodes=flushed, diagnostics=diags)
    log(f"{what}: {json.dumps(result)}")
    return result


def state_leaves(state):
    """Every checkpointed leaf of ``state`` on the host: tensors copied,
    generators as their state."""
    from dtqn_tpu_torch.utils.checkpoint import _leaves

    return {name: (leaf.get_state() if isinstance(leaf, torch.Generator)
                   else leaf.detach().cpu().clone())
            for name, leaf in _leaves(state)}


def host_runner_phase(seed, ca):
    """``run_host_experiment`` at full width on the glyph room: whole (two
    chunks of two iterations, each followed by a 10-episode evaluation),
    with every launch reckoned; then cut by the time limit after its first
    chunk and resumed: the loaded state bit-equal to the saved one, the
    resumed run reaching its steps.  As in the JAX package, the resumed
    run is not the uninterrupted one: the host envs restart."""
    from dtqn_tpu_torch.train import host_loop as hl
    from dtqn_tpu_torch.utils import checkpoint as ckpt

    _, GlyphRoomHost = host_env_classes()
    factory = lambda name: GlyphRoomHost()  # noqa: E731
    steps = 128

    def config(**kw):
        return host_config(seed, envs=[GLYPH_ENV],
                           prepop_steps=32 * GLYPH_PREPOP_ITERS,
                           eval_frequency=64, num_steps=steps, **kw)

    cfg = config()
    iters = steps // cfg.num_envs
    result = {}
    with tempfile.TemporaryDirectory() as tmp, in_directory(tmp):
        with launch_ledger(ca) as ledger, counted_greedy_calls() as calls:
            reset_launch_counts()
            t0 = time.perf_counter()
            final = hl.run_host_experiment(cfg, env_factory=factory)
            torch.cuda.synchronize()
            result["whole_s"] = time.perf_counter() - t0
            eval_steps = calls["calls"] - iters
            result["launches_by_shape"] = check_ledger(
                ca, ledger,
                host_reckoned(cfg.agent_config(), iters,
                              iters * cfg.resolved_updates_per_iter,
                              eval_steps), "host loop runner",
                iters * cfg.resolved_updates_per_iter)
        check_csvs(cfg, [64, 128], cap=GLYPH_CAP)
        check(all(math.isfinite(v) for v in final.values()),
              f"host loop runner: final log not finite: {final}")
        check(ckpt.load_mini_checkpoint(cfg.policy_path())
              == {"step": steps, "wandb_id": None}, "completion sentinel")
        whole = ckpt.load_policy(cfg.policy_path(), saved_host_network(cfg))
        for name in os.listdir(cfg.policy_dir()):
            os.remove(os.path.join(cfg.policy_dir(), name))

        saved, loaded = {}, {}
        save, load = hl.ckpt.save_checkpoint, hl.ckpt.load_checkpoint

        def saving(path, state, **kw):
            saved.update(state_leaves(state))
            return save(path, state, **kw)

        def loading(path, template):
            out = load(path, template)
            loaded.update(state_leaves(out[0]))
            return out

        with patched(hl.ckpt, "save_checkpoint", saving):
            t0 = time.perf_counter()
            hl.run_host_experiment(config(time_limit=1e-9),
                                   env_factory=factory)
            result["cut_s"] = time.perf_counter() - t0
        check(ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == 64,
              "the cut host run's mini checkpoint is not at step 64")
        result["checkpoint_bytes"] = os.path.getsize(
            cfg.policy_path() + "_checkpoint.pt")
        with patched(hl.ckpt, "load_checkpoint", loading):
            t0 = time.perf_counter()
            hl.run_host_experiment(cfg, env_factory=factory)
            result["resumed_s"] = time.perf_counter() - t0
        check(ckpt.load_mini_checkpoint(cfg.policy_path())["step"] >= steps,
              "the resumed host run did not reach its steps")
        check_csvs(cfg, [64, 128], cap=GLYPH_CAP)
        resumed = ckpt.load_policy(cfg.policy_path(),
                                   saved_host_network(cfg))
    check(set(saved) == set(loaded) and saved,
          f"saved and loaded leaves differ: {set(saved) ^ set(loaded)}")
    differing = [k for k in saved if not torch.equal(saved[k], loaded[k])]
    check(not differing, f"the host run's resume did not load its "
                         f"checkpoint bit for bit: {differing}")
    result.update(
        final_log=final, resume_loads_bit_equal=True,
        leaves_checked=len(saved),
        resumed_equals_uninterrupted=all(
            torch.equal(a, b) for a, b in zip(
                resumed.state_dict().values(), whole.state_dict().values())))
    log(f"host loop runner: {json.dumps(result)}")
    return result


def saved_host_network(cfg):
    """A fresh CPU network of the glyph room's configuration."""
    from dtqn_tpu_torch.agents import Agent

    _, GlyphRoomHost = host_env_classes()
    return Agent(cfg.agent_config(), GlyphRoomHost(),
                 device="cpu").build_network()


def host_phase(seed, ca):
    """Phase 21: the host loop (MiniHack's runner) on in-script host envs:
    the cue task trained from scratch, the full-width glyph room's
    iterations in float32 and bf16, and its runner whole, cut and
    resumed."""
    t0 = time.perf_counter()
    result = {
        "cue": host_cue_phase(seed, ca),
        "glyph": host_drive(seed, ca),
        "glyph_bf16": host_drive(seed, ca, bf16=True),
        "runner": host_runner_phase(seed, ca),
    }
    result["seconds"] = time.perf_counter() - t0
    log(f"host phase: {result['seconds']:.1f} s")
    return result


# ------------------------------------------------------------------ graphs
# (name, env, AgentConfig fields over the bag configuration, prepopulation
# iterations, stacked seeds): the paths phase 22 holds graphed against eager.
GRAPH_PATHS = (
    ("flagless", "DiscreteCarFlag-v0",
     dict(model="DTQN", inner_embed=64, bag_size=0), 200, None),
    ("flagless bf16", "DiscreteCarFlag-v0",
     dict(model="DTQN", inner_embed=64, bag_size=0, bf16=True), 200, None),
    ("bag 25", GV_ENV, {}, 300, None),
    ("DRQN Memory-5", "Memory-5-v0", dict(model="DRQN", bag_size=0), 100,
     None),
    ("ImageMaze", IMAGE_ENV, dict(model="DTQN", bag_size=0), 150, None),
    ("dropout 0.1", "DiscreteCarFlag-v0",
     dict(model="DTQN", inner_embed=64, bag_size=0, dropout=0.1), 200, None),
    ("5 seeds", "DiscreteCarFlag-v0",
     dict(model="DTQN", inner_embed=64, bag_size=0), 200,
     list(range(SWEEP_SEEDS))),
)
GRAPH_ITERS = 3  # iterations of 64 updates per compared chunk
# The paths given a second chunk, which only replays (the first warms up,
# captures and replays twice), and timed eager and graphed in turns (eager,
# graphed, graphed, eager), one chunk each.  5 seeds and DRQN were timed so
# in PR 13 (PERF.md); phases 11 and 16 time their graphed iterations.
GRAPH_TIMED = ("flagless", "flagless bf16")


def differing_leaves(a, b):
    """The leaves (``utils.tree.leaves``, what a checkpoint saves) of two
    states that are not bit for bit equal, generators' states included."""
    from dtqn_tpu_torch.utils.tree import leaves

    out = []
    for (name, x), (_, y) in zip(leaves(a), leaves(b)):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if not torch.equal(x, y):
            out.append(name)
    return out


def graph_stats(chunk):
    """A compiled entry point's capture: warm-up and capture seconds (None
    for the plain body of a CPU dry run)."""
    return {"warm_up_s": getattr(chunk, "warm_up_s", None),
            "capture_s": getattr(chunk, "capture_s", None),
            "captures": getattr(chunk, "captures", None)}


def pool_bytes(agent):
    """Bytes the caching allocator holds in ``agent``'s graph memory pool
    (None before its first capture)."""
    if agent.graph_pool is None:
        return None
    want = tuple(agent.graph_pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want)


def graphed_path(seed, ca, name, env_name, kw, prepop_iters, seeds):
    """One saved state trained a chunk of GRAPH_ITERS iterations (two for
    GRAPH_TIMED) eager (``make_train_chunk_fn``) and graphed
    (``make_train_chunk``): after each chunk every leaf, each generator's
    state, ``launch_counts`` and the launches by shape bit-equal; then, for
    GRAPH_TIMED, the chunks timed in turns and a graphed chunk profiled."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import (
        make_evaluate,
        make_evaluate_fn,
        make_prepopulate,
        make_train_chunk,
        make_train_chunk_fn,
    )
    from dtqn_tpu_torch.utils import checkpoint as ckpt
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    updates = 64
    cfg = AgentConfig(**dict(dict(
        model="DTQN-bag", num_envs=64, context_len=50, history=50,
        inner_embed=128, num_heads=8, num_layers=2, batch_size=32,
        buffer_size=500_000, target_update_frequency=10_000,
        bag_size=GV_BAG), **kw))
    what = f"graphs, {name}"
    agent = Agent(cfg, make_env(env_name), device=DEVICE)
    n = len(seeds) if seeds else 1

    def fresh():
        return (agent.init_sweep_state(seeds) if seeds
                else agent.init_state(seed))

    graphed = fresh()
    prepopulate = make_prepopulate(agent, prepop_iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepopulate(graphed)
    torch.cuda.synchronize()
    result = {"config": kw, "env": env_name, "seeds": seeds,
              "prepopulation_s": time.perf_counter() - t0,
              "prepopulation_graph": graph_stats(prepopulate),
              "pool_bytes_after_prepopulation": pool_bytes(agent)}
    flushed = graphed.buffer.flushed_total.reshape(-1).tolist()
    check(min(flushed) > cfg.batch_size,
          f"{what}: prepopulation flushed only {flushed}")
    # The graphed run goes on from the saved state, the eager one from its
    # checkpoint.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "saved")
        ckpt.save_checkpoint(path, graphed)
        eager, _ = ckpt.load_checkpoint(path, fresh())
    del prepopulate

    eps = EpsilonSchedule(1.0, 0.1, 200_000)
    chunks = {"eager": (eager, make_train_chunk_fn(agent, eps, updates,
                                                   GRAPH_ITERS)),
              "graphed": (graphed, make_train_chunk(agent, eps, updates,
                                                    GRAPH_ITERS))}
    evaluators = {"eager": (eager, make_evaluate_fn(agent, agent.env, 10)),
                  "graphed": (graphed, make_evaluate(agent, agent.env, 10))}
    rounds = []
    for r in range(2 if name in GRAPH_TIMED else 1):
        seen = {}
        for kind, (st, chunk) in chunks.items():
            with launch_ledger(ca) as ledger:
                reset_launch_counts()
                seen[kind] = (timed_call(chunk, st), launch_counts(),
                              dict(ledger))
                optimizer_launches(GRAPH_ITERS * updates,
                                   f"{what}, {kind} chunk {r + 1}")
        differ = differing_leaves(eager, graphed)
        check(not differ, f"{what}, chunk {r + 1}: the graphed chunk's "
                          f"leaves differ from the eager one's: {differ}")
        check(seen["eager"][1] == seen["graphed"][1],
              f"{what}, chunk {r + 1}: launch_counts eager "
              f"{seen['eager'][1]}, graphed {seen['graphed'][1]}")
        check(seen["eager"][2] == seen["graphed"][2],
              f"{what}, chunk {r + 1}: launches by shape eager "
              f"{show_ledger(seen['eager'][2])}, graphed "
              f"{show_ledger(seen['graphed'][2])}")
        rounds.append({"eager_s": seen["eager"][0][1],
                       "graphed_s": seen["graphed"][0][1],
                       "launches": {k: v for k, v in seen["graphed"][1].items()
                                    if v},
                       "updates": GRAPH_ITERS * updates,
                       "evaluation": evaluations_equal(
                           ca, evaluators, seeds or seed,
                           f"{what}, after chunk {r + 1}")})
    captures = getattr(chunks["graphed"][1], "captures", 1)
    check(captures == 1, f"{what}: {captures} captures of one state's "
                         "iteration: its graph was not reused")
    applied = graphed.train_steps.reshape(-1).tolist()
    check(applied == [len(rounds) * GRAPH_ITERS * updates] * n,
          f"{what}: train_steps {applied}")
    check(int(graphed.nonfinite_grads.sum()) == 0,
          f"{what}: non-finite gradient steps")
    result.update(rounds=rounds, leaves_bit_equal=True,
                  chunk_graph=graph_stats(chunks["graphed"][1]),
                  pool_bytes=pool_bytes(agent))
    if name in GRAPH_TIMED:
        # The last round's chunks (eager, then graphed) are the first two
        # turns.
        result["in_turns"] = graph_turns(
            chunks, n * cfg.num_envs, what,
            {kind: seen[kind][0] for kind in chunks})
        # The second evaluation replayed between the second round's chunks
        # and these: they are bit-equal still.
        differ = differing_leaves(eager, graphed)
        check(not differ, f"{what}: after an evaluation's replay between "
                          f"graphed chunks, the leaves differ: {differ}")
        state, chunk = chunks["graphed"]
        result["profile"] = profile_iteration(
            state, chunk, updates=GRAPH_ITERS * updates,
            what=f"{what}, a graphed chunk of {GRAPH_ITERS} iterations")
    log(f"{what}: {json.dumps(result)}")
    return result


def evaluations_equal(ca, evaluators, seed, what):
    """One 10-episode evaluation (per seed) of each state's network,
    {kind: (state, evaluator)}, from generators seeded alike: results,
    steps, launches by shape and the generators' end states bit-equal."""
    seen = {}
    for kind, (state, evaluate) in evaluators.items():
        gens = [torch.Generator(device=DEVICE).manual_seed(s + 7)
                for s in (seed if isinstance(seed, list) else [seed])]
        with launch_ledger(ca) as ledger, counted_greedy_calls() as calls:
            reset_launch_counts()
            t0 = time.perf_counter()
            out = evaluate(state.network,
                           gens if isinstance(seed, list) else gens[0])
            out = [x.reshape(-1).tolist() for x in out]
            seconds = time.perf_counter() - t0
            seen[kind] = ((out, calls["calls"], launch_counts(),
                           dict(ledger)), [g.get_state() for g in gens],
                          seconds)
            optimizer_launches(0, f"{what}, {kind} evaluation")
    (a, gens_a, _), (b, gens_b, _) = seen["eager"], seen["graphed"]
    check(a == b and all(torch.equal(x, y) for x, y in zip(gens_a, gens_b)),
          f"{what}: the graphed evaluation {b[:3]} differs from the eager "
          f"one {a[:3]}, or its generators' end states do")
    return {"result": a[0], "steps": a[1], "launches": a[2],
            "bit_equal": True, "eager_s": seen["eager"][2],
            "graphed_s": seen["graphed"][2]}


def timed_call(chunk, state):
    """(host seconds until ``chunk(state)`` returns, wall seconds to the end
    of its device work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(state)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host, time.perf_counter() - t0


def graph_turns(chunks, envs, what, first):
    """The chunks of ``chunks`` ({kind: (state, chunk)}) in turns eager,
    graphed, graphed, eager, the first two ``first`` ({kind: (host s, wall
    s)}, timed already): per iteration the host ms until the call returns,
    the wall ms to the end of its device work, and env-steps/s over
    ``envs`` envs."""
    seen = {kind: [first[kind]] for kind in ("eager", "graphed")}
    for kind in ("graphed", "eager"):
        state, chunk = chunks[kind]
        seen[kind].append(timed_call(chunk, state))
    out = {k: {"host_ms_per_iteration": [1e3 * h / GRAPH_ITERS for h, _ in v],
               "wall_ms_per_iteration": [1e3 * w / GRAPH_ITERS for _, w in v],
               "env_steps_per_s": [envs * GRAPH_ITERS / w for _, w in v]}
           for k, v in seen.items()}
    for v in out.values():
        v["mean_env_steps_per_s"] = (sum(v["env_steps_per_s"])
                                     / len(v["env_steps_per_s"]))
    out["speedup"] = (out["graphed"]["mean_env_steps_per_s"]
                      / out["eager"]["mean_env_steps_per_s"])
    log(f"{what}: eager and graphed in turns: {json.dumps(out)}")
    return out


def graphs_phase(seed, ca):
    """Phase 22: every path of GRAPH_PATHS graphed against eager."""
    return {name: graphed_path(seed, ca, name, env, kw, prepop, seeds)
            for name, env, kw, prepop, seeds in GRAPH_PATHS}


# (name, env, AgentConfig fields over graphed_path's, prepopulation
# iterations, seeds): the paths whose graphs phase 23 captures with and
# without the phases' marks.
TRACED_PATHS = (
    ("flagless", "DiscreteCarFlag-v0",
     dict(model="DTQN", inner_embed=64, bag_size=0), 200, None),
    ("bag 25", GV_ENV, {}, 300, None),
    ("flagless, 5 seeds", "DiscreteCarFlag-v0",
     dict(model="DTQN", inner_embed=64, bag_size=0), 200,
     list(range(SWEEP_SEEDS))),
    ("bag 25, 5 seeds", GV_ENV, {}, 300, list(range(SWEEP_SEEDS))),
)
TRACED_ITERS = 20  # iterations each graph trains before the states compare
PHASE_SPAN_RTOL = 0.03  # the phases' sum against the replay's device span


def replay_kernels(step, state):
    """Two calls of ``step`` (a one-iteration ``GraphedStep`` already
    captured) under torch.profiler, and of the second replay (each device
    operation placed by the correlation id of the graph launch that issued
    it): ({kernel name: count}, {copy or fill: count}, the device span in
    ms from its first operation's start to its last one's end).  A session
    drops records, at its start most, so the first replay is not read.
    Kernels leave out copies and fills, as the benchmark's count does
    (``perfbench/trace.py``): a graph's memcpy node runs as a kernel
    (``memcpy32_post``) or on a copy engine, which is the driver's
    choice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state)
        step(state)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launches = sorted((ev.start_ns(), ev.correlation_id()) for ev in events
                      if ev.name() == "cudaGraphLaunch")
    check(len(launches) == 2, f"the profiler saw {len(launches)} graph "
                              "launches of two replays")
    second = launches[-1][1]
    counts, copies, first, last = {}, {}, None, None
    for ev in events:
        if (ev.device_type() != DeviceType.CUDA or ev.is_user_annotation()
                or second not in (ev.correlation_id(),
                                  ev.linked_correlation_id())):
            continue
        first = ev.start_ns() if first is None else min(first, ev.start_ns())
        last = ev.end_ns() if last is None else max(last, ev.end_ns())
        into = copies if ev.name().startswith(
            ("Memcpy", "Memset", "memcpy", "memset")) else counts
        into[ev.name()] = into.get(ev.name(), 0) + 1
    check(counts, "the profiler recorded no kernel of a replay")
    return counts, copies, (last - first) * 1e-6


def ms_per_iteration(chunk, state, iterations):
    """Device ms an iteration of one call of ``chunk`` (events on the
    stream before and after it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chunk(state)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iterations


def traced_path(seed, name, env_name, kw, prepop_iters, seeds):
    """One saved state trained TRACED_ITERS iterations through a chunk
    captured with tracing off and through one captured with it on, compared
    leaf by leaf; then one iteration of each through one-iteration graphs,
    profiled; then the chunks in turns (off, on, on, off), timed, and the
    leaves compared again."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import make_prepopulate, make_train_chunk
    from dtqn_tpu_torch.utils import checkpoint as ckpt
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
    from dtqn_tpu_torch.utils.profiling import tracing_on

    updates, per_call = 64, 10
    cfg = AgentConfig(**dict(dict(
        model="DTQN-bag", num_envs=64, context_len=50, history=50,
        inner_embed=128, num_heads=8, num_layers=2, batch_size=32,
        buffer_size=500_000, target_update_frequency=10_000,
        bag_size=GV_BAG), **kw))
    what = f"tracing, {name}"
    agent = Agent(cfg, make_env(env_name), device=DEVICE)

    def fresh():
        return (agent.init_sweep_state(seeds) if seeds
                else agent.init_state(seed))

    # Both states loaded from one checkpoint, so that they are alike in
    # layout as well as in value.
    saved = fresh()
    make_prepopulate(agent, prepop_iters)(saved)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "saved")
        ckpt.save_checkpoint(path, saved)
        del saved
        states = {kind: ckpt.load_checkpoint(path, fresh())[0]
                  for kind in ("off", "on")}
    eps = EpsilonSchedule(1.0, 0.1, 200_000)
    result, kernels, chunks = {"config": kw, "env": env_name,
                               "seeds": seeds}, {}, {}
    for kind, state in states.items():
        chunk = chunks[kind] = make_train_chunk(agent, eps, updates,
                                                per_call)
        step = make_train_chunk(agent, eps, updates, 1)
        with tracing_on(kind == "on"):
            for _ in range(TRACED_ITERS // per_call):
                chunk(state)
            step(state)  # captures the one-iteration graph
        torch.cuda.synchronize()
        check((chunk.phase_ms() is not None) == (kind == "on"),
              f"{what}: the chunk captured with tracing {kind} read "
              f"{chunk.phase_ms()}")
        kernels[kind], copies, span_ms = replay_kernels(step, state)
        result[kind] = {"kernels": sum(kernels[kind].values()),
                        "copies_and_fills": copies,
                        "replay_span_ms": span_ms,
                        "boundary_events": len(step.graph.marks),
                        "phases": step.phase_ms()}
    differ = differing_leaves(states["off"], states["on"])
    check(not differ, f"{what}: after {TRACED_ITERS + 3} iterations the "
                      f"leaves of the traced graphs differ: {differ}")
    turns = {"off": [], "on": []}
    for kind in ("off", "on", "on", "off"):
        turns[kind].append(ms_per_iteration(chunks[kind], states[kind],
                                            per_call))
    result["ms_per_iteration_in_turns"] = turns
    differ = differing_leaves(states["off"], states["on"])
    check(not differ, f"{what}: after the chunks in turns the leaves "
                      f"differ: {differ}")
    check(kernels["off"] == kernels["on"],
          f"{what}: the traced graph's kernels differ: " + json.dumps({
              k: [kernels["off"].get(k, 0), kernels["on"].get(k, 0)]
              for k in set(kernels["off"]) | set(kernels["on"])
              if kernels["off"].get(k) != kernels["on"].get(k)}))
    read = result["on"]["phases"]
    want = {"act", "env", "replay_write", "sample", "update", "other"} | (
        {"evict"} if cfg.bag_size else set())
    check(set(read["phases"]) == want and all(
        read["phases"][k] > 0 for k in want - {"other"}),
        f"{what}: phases {read}")
    span_ms = result["on"]["replay_span_ms"]
    gap = abs(sum(read["phases"].values()) - span_ms) / span_ms
    check(gap <= PHASE_SPAN_RTOL,
          f"{what}: the phases sum to {sum(read['phases'].values())} ms, "
          f"the replay's kernels span {span_ms} ms")
    result.update(leaves_bit_equal=True, kernels_equal=True,
                  phase_sum_gap=gap)
    log(f"{what}: {json.dumps(result)}")
    return result


def tracing_phase(seed):
    """Phase 23: every path of TRACED_PATHS with and without the marks."""
    return {name: traced_path(seed, name, env, kw, prepop, seeds)
            for name, env, kw, prepop, seeds in TRACED_PATHS}


# (name, gradient scale, ok, a non-finite gradient, train_steps) of phase
# 24's cases: at 5 seeds one a seed, at one seed each in a call of its
# own.  A gradient's norm is about its scale times sqrt(P): 0.33 / 0.71
# at 1e-3, 3.3 / 7.1 at 1e-2 (P = 107 779 / 509 142).
OPTIMIZER_CASES = (
    ("below", 1e-3, True, False, 12),
    ("above", 1e-2, True, False, 12),
    ("gated", 1e-2, False, False, 12),
    ("nonfinite", 1e-2, True, True, 12),
    ("swap", 1e-2, True, False, 9_999),
)
# The flat parameter vectors of the benchmark's two networks (Car Flag
# DTQN, the gridverse DTQN-bag), at one seed and five.
OPTIMIZER_SHAPES = ((107_779,), (5, 107_779), (509_142,), (5, 509_142))
OPTIMIZER_TARGET_EVERY = 10_000
OPTIMIZER_NORM_RTOL = 1e-6  # the kernels' norm against vector_norm's


@dataclasses.dataclass
class OptimizerState:
    """The fields of an ``AgentState`` that the step after the gradient
    reads and writes."""

    params: torch.Tensor
    target_params: torch.Tensor
    opt_state: object
    train_steps: torch.Tensor
    nonfinite_grads: torch.Tensor

    @property
    def seed_shape(self):
        return self.train_steps.shape

    def tensors(self):
        opt = self.opt_state
        return {"params": self.params, "target": self.target_params,
                "mu": opt.mu, "nu": opt.nu, "count": opt.count,
                "train_steps": self.train_steps,
                "nonfinite_grads": self.nonfinite_grads}

    def clone(self):
        opt = self.opt_state
        return OptimizerState(
            self.params.clone(), self.target_params.clone(),
            type(opt)(opt.mu.clone(), opt.nu.clone(), opt.count.clone()),
            self.train_steps.clone(), self.nonfinite_grads.clone())


def optimizer_inputs(seed, shape, cases):
    """A state, its gradients and ``ok`` on the card for ``cases`` (one
    a row), drawn from ``seed``."""
    from dtqn_tpu_torch.agents.base import AdamState

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    seeds = shape[:-1]

    def draw(scale):
        return scale * torch.randn(shape, generator=gen, device=DEVICE)

    def per_row(values, dtype):
        return torch.tensor(values, dtype=dtype, device=DEVICE).reshape(
            seeds)

    grads = draw(1.0) * per_row([c[1] for c in cases],
                                torch.float32)[..., None]
    for i, case in enumerate(cases):
        if case[3]:
            grads.view(-1, shape[-1])[i, 1234] = float("nan")
    params = draw(0.02)
    state = OptimizerState(
        params, params + draw(1e-3),
        AdamState(draw(1e-3), draw(1e-3) ** 2,
                  per_row([41] * len(cases), torch.int32)),
        per_row([c[4] for c in cases], torch.int32),
        per_row([3] * len(cases), torch.int32))
    return state, grads, per_row([c[2] for c in cases], torch.bool)


def fused_step(state, grads, ok):
    """The kernels on ``state`` as ``optimizer_step`` runs them: (gnorm,
    apply), the counters rebound."""
    from dtqn_tpu_torch.agents import base
    from dtqn_tpu_torch.ops import cuda_optimizer as co

    opt = state.opt_state
    gnorm, apply, opt.count, state.train_steps, state.nonfinite_grads = (
        co.clip_adam_apply(
            state.params, grads, opt.mu, opt.nu, opt.count, ok,
            state.train_steps, state.nonfinite_grads, state.target_params,
            3e-4, 1.0, OPTIMIZER_TARGET_EVERY, base.ADAM_B1, base.ADAM_B2,
            base.ADAM_EPS))
    return gnorm, apply


def chain_step(state, grads, ok, gnorm=None):
    """The plain chain on the card, fed ``gnorm`` or its own norm."""
    from dtqn_tpu_torch.agents import base

    if gnorm is None:
        gnorm = torch.linalg.vector_norm(
            grads, dim=-1 if state.seed_shape else None)
    return gnorm, base.gated_adam_step(state, grads, gnorm, ok, 3e-4, 1.0,
                                       OPTIMIZER_TARGET_EVERY)


def bits_differ(a, b):
    """The names of two dicts' tensors that are not bit for bit equal."""
    def raw(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return [k for k in a if not torch.equal(raw(a[k]), raw(b[k]))]


def optimizer_case(seed, shape, cases):
    """One call of the kernels against the chain fed their norm, and against
    the state it started from; returns the norm's relative gap."""
    from dtqn_tpu_torch.ops import cuda_optimizer as co

    what = f"optimizer {list(shape)} {[c[0] for c in cases]}"
    start, grads, ok = optimizer_inputs(seed, shape, cases)
    fused, chain = start.clone(), start.clone()
    before = dict(co.launch_counts)
    gnorm, apply = fused_step(fused, grads, ok)
    check({k: co.launch_counts[k] - before[k] for k in before}
          == {"adam_sumsq": 1, "adam_apply": 1},
          f"{what}: launch counts {co.launch_counts} from {before}")
    want = torch.linalg.vector_norm(grads, dim=-1 if len(shape) > 1
                                    else None).reshape(-1)
    got = gnorm.reshape(-1)
    gap = 0.0
    for i, case in enumerate(cases):
        if case[3]:
            check(not torch.isfinite(got[i]),
                  f"{what}: a non-finite gradient's norm read {got[i]}")
            continue
        gap = max(gap, abs(float(got[i]) - float(want[i])) / float(want[i]))
        check((float(got[i]) < 1.0) == (case[0] == "below"),
              f"{what}: {case[0]}'s norm is {float(got[i])}")
    check(gap <= OPTIMIZER_NORM_RTOL,
          f"{what}: the norm is {gap:.3g} off vector_norm's")
    _, want_apply = chain_step(chain, grads, ok, gnorm)
    differ = bits_differ(fused.tensors(), chain.tensors())
    check(not differ and torch.equal(apply, want_apply),
          f"{what}: the kernels and the chain fed their norm differ in "
          f"{differ}, apply {apply.tolist()} / {want_apply.tolist()}")
    rows = {k: t.reshape(len(cases), -1) for k, t in fused.tensors().items()}
    old = {k: t.reshape(len(cases), -1) for k, t in start.tensors().items()}
    for i, case in enumerate(cases):
        name = case[0]
        moved = [k for k in ("params", "mu", "nu", "count")
                 if not torch.equal(rows[k][i], old[k][i])]
        check(len(moved) == (0 if name in ("gated", "nonfinite") else 4),
              f"{what}: {name} changed {moved}")
        check(torch.equal(rows["target"][i], rows["params"][i]
                          if name == "swap" else old["target"][i]),
              f"{what}: {name}'s target")
        check(int(rows["train_steps"][i]) == int(old["train_steps"][i]) + (
            name not in ("gated", "nonfinite")), f"{what}: {name}'s steps")
        check(int(rows["nonfinite_grads"][i]) == 3 + (name == "nonfinite"),
              f"{what}: {name}'s non-finite count")
    return gap


def optimizer_graphed(seed, shape):
    """The kernels captured in a CUDA graph and replayed once, against one
    eager call from the same state: bit-equal, 2 launches counted."""
    from dtqn_tpu_torch.ops import cuda_optimizer as co
    from dtqn_tpu_torch.utils import graphs

    what = f"optimizer graphed {list(shape)}"
    cases = OPTIMIZER_CASES if len(shape) > 1 else OPTIMIZER_CASES[1:2]
    start, grads, ok = optimizer_inputs(seed, shape, cases)
    eager, graphed = start.clone(), start.clone()
    eager_out = fused_step(eager, grads, ok)
    graph = torch.cuda.CUDAGraph()
    with graphs.counting_capture() as gains:
        with torch.cuda.graph(graph):
            graphed_out = fused_step(graphed, grads, ok)
    counted = graphs.CountedGraph(graph, gains)
    before = dict(co.launch_counts)
    counted.replay()
    torch.cuda.synchronize()
    check({k: co.launch_counts[k] - before[k] for k in before}
          == {"adam_sumsq": 1, "adam_apply": 1},
          f"{what}: a replay counted {co.launch_counts} from {before}")
    differ = bits_differ(dict(eager.tensors(), gnorm=eager_out[0],
                              apply=eager_out[1]),
                         dict(graphed.tensors(), gnorm=graphed_out[0],
                              apply=graphed_out[1]))
    check(not differ, f"{what}: a replay and an eager call differ in "
                      f"{differ}")


def optimizer_times(seed, shape):
    """Device ms of one step at ``shape`` (every seed legal, clipped), the
    kernels and the chain (``graph_ms``: each call captured, the vectors
    warm in L2 after the first), beside the bytes' bound."""
    cases = (OPTIMIZER_CASES[1],) * (shape[0] if len(shape) > 1 else 1)
    times = {}
    for kind, step in (("kernels", fused_step), ("chain", chain_step)):
        state, grads, ok = optimizer_inputs(seed, shape, cases)
        times[kind + "_ms"] = graph_ms(lambda: step(state, grads, ok),
                                       calls=20, replays=10)
    # g, p, mu and nu read, p, mu and nu written once.
    elems = math.prod(shape)
    times["bound_ms"] = 1e3 * 7 * 4 * elems / HBM_BYTES_PER_S
    return times


def optimizer_phase(seed):
    """Phase 24: the step after the gradient, the kernels against the plain
    chain on the card."""
    from dtqn_tpu_torch.ops import cuda_optimizer as co

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    co.build(verbose=True)
    with open(os.path.splitext(co._lib._name)[0] + ".log") as f:
        result = {"ptxas": [line for line in f.read().splitlines()
                            if "registers" in line or "spill" in line]}
    for shape in OPTIMIZER_SHAPES:
        if len(shape) > 1:
            gaps = [optimizer_case(seed, shape, OPTIMIZER_CASES)]
        else:
            gaps = [optimizer_case(seed + i, shape, (case,))
                    for i, case in enumerate(OPTIMIZER_CASES)]
        optimizer_graphed(seed, shape)
        result[str(list(shape))] = dict(
            norm_gap=max(gaps), **optimizer_times(seed, shape))
        log(f"optimizer {list(shape)}: {json.dumps(result[str(list(shape))])}")
    log(f"optimizer: {json.dumps(result)}")
    return result


def run(seed):
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from dtqn_tpu_torch.ops import cuda_attention as ca
    except ImportError as e:
        raise SmokeFailure(f"the dtqn_tpu_torch package is missing: {e}")

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    ca.build(verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    phase_seconds, last = {"build": time.perf_counter() - t0}, [
        time.perf_counter()]

    def mark(name):
        """Logs the seconds since the previous mark as phase ``name``'s."""
        now = time.perf_counter()
        phase_seconds[name], last[0] = now - last[0], now
        log(f"phase {name}: {phase_seconds[name]:.1f} s")

    usage = ca.ptxas_usage()
    for u in usage:
        log(f"ptxas: {json.dumps(u)}")
    check(len(usage) == 2 * sum(len(ca.instances(t)) for t in ca.DTYPES),
          f"ptxas reported {len(usage)} kernels")

    def instance(kernel):
        """"attention_fwd_kernel<bfloat16,8,2>" -> (8, 2);
        "attention_fwd_mma<16>" -> (16, MMA_FORM)."""
        args = kernel[kernel.index("<") + 1:-1].split(",")
        if len(args) == 1:
            return int(args[0]), ca.MMA_FORM
        return int(args[1]), int(args[2])

    spilled = [u["kernel"] for u in usage
               if instance(u["kernel"]) in DRIVEN_INSTANCES
               and u.get("spill_stores", 0) + u.get("spill_loads", 0)]
    check(not spilled, f"instances on driven paths spill: {spilled}")
    errs = parity(ca)
    mark("parity")
    # Before any graph is captured: every capture then records what the
    # counters that the phases reckon gained (install_counters).
    install_counters()
    main, agent, state, train_iter = main_path(seed, ca)
    mark("main path")
    runner, whole_weights = runner_phase(seed, ca)
    mark("runner")
    resume = resume_phase(seed, ca, whole_weights)
    mark("resume")
    discrete = discrete_phase(seed, ca)
    mark("discrete")
    evaluation = evaluation_phase(seed, ca, agent, state)
    mark("evaluation")
    bag = bag_phase(seed, ca)
    mark("bag")
    pomdp = pomdp_phase(seed, ca, (agent, state))
    mark("pomdp")
    baselines = baselines_phase(seed, ca)
    mark("baselines")
    image, image_run = image_phase(seed, ca)
    mark("image")
    multi, multi_run = multi_phase(seed, ca)
    mark("four rooms")
    variants = variants_phase(seed, ca, {"DiscreteCarFlag-v0": (agent, state),
                                         IMAGE_ENV: image_run,
                                         "four rooms": multi_run})
    del image_run, multi_run
    mark("variants")
    continuous = continuous_phase(seed)
    mark("continuous")
    sweep = sweep_phase(seed, ca, (agent, state, train_iter))
    mark("sweep")
    main_shape, t_main = timings(ca, 32)  # each update's batch
    _, t_act = timings(ca, 64)  # the act forward's batch
    _, t_wide = timings(ca, 32, d=16)  # the in_embed-128 paths' update
    # The host loop's cue task: act step and update at B=32, context 8,
    # head width 4 (padded to 8: <8, 1>).
    _, t_cue = timings(ca, 32, lq=8, lk=8, d=4)
    # ... their act step and their evaluation's batch
    t_d16 = dict(timings(ca, b, d=16) for b in (64, 10))
    t_bag = dict(timings(ca, **shape) for shape in BAG_TIMING_SHAPES)
    t_streamed = streamed_timings(ca)
    t_sweep = dict(timings(ca, **shape) for shape in SWEEP_TIMING_SHAPES)
    mark("kernel timings")

    prof = profile_iteration(state, train_iter)
    mark("profile")
    bf16 = bf16_phase(seed, ca, (agent, state, train_iter), {
        "bag": bag["operations"],
        "drqn": baselines["DRQN Memory-5-v0"]["operations"],
        "image": image["operations"]})
    mark("bf16")
    dp = dp_phase(seed, card, (agent, state))
    mark("several devices")
    host = host_phase(seed, ca)
    mark("host loop")
    graphed = graphs_phase(seed, ca)
    mark("graphs")
    traced = tracing_phase(seed)
    mark("tracing")
    optimizer = optimizer_phase(seed)
    mark("optimizer")

    kernels = []
    for name in ("attention_fwd", "attention_bwd"):
        t = t_main[name]
        kernels.append({
            "name": name,
            "dtype": "float32",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": main["launches"][name],
            "launches_bag_path": bag["full_width"]["launches"][name],
            "launches_pomdp_path": {
                env: pomdp[env]["launches"][name]
                for env in (HALLWAY, HEAVENHELL)},
            "launches_image_path": image["launches"][name],
            "launches_variant_paths": {
                v: variants[v]["launches"][name] for v, _ in VARIANTS},
            "launches_four_rooms_path": multi["launches"][name],
            "launches_sweep_path": sweep["flagless"]["launches"][name],
            "launches_per_rank_2_rank_path": [
                sum(n for shape, n in rank["launches"].items()
                    if shape.startswith(name + " "))
                for rank in dp["turns"][1]],
            "launches_graphed_per_iteration": graphed["flagless"]["rounds"][
                -1]["launches"][name] // GRAPH_ITERS,
            "launches_graphed_evaluation": evaluation["turns"]["launches"][
                name],
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": main_shape,
            "bag_path_shapes": {shape: t[name]
                                for shape, t in t_bag.items()},
            "head_width_16_shapes": {shape: t[name]
                                     for shape, t in t_d16.items()},
            "streamed_16_0_in_turns": {
                shape: t for shape, t in t_streamed.items()
                if shape.startswith(name)},
            "sweep_shapes": {shape: t[name] for shape, t in t_sweep.items()},
            "launches_host_loop_cue_path": host["cue"]["launches"][name],
            "launches_host_loop_glyph_path": host["glyph"]["launches"][name],
            "host_loop_cue_shape": t_cue[name],
        })
    shape_bf16, t_bf16 = next(iter(bf16["timings"].items()))  # B=32 D=8
    for name in ("attention_fwd", "attention_bwd"):
        t = t_bf16[name]
        kernels.append({
            "name": f"{name}_bf16",
            "dtype": "bfloat16",
            "form": t["form"],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": bf16["flagless"]["launches"][f"{name}_bf16"],
            "launches_bag_path": bf16["bag"]["launches"][f"{name}_bf16"],
            "launches_carflag_bag10_path":
                bf16["carflag_bag10"]["launches"][f"{name}_bf16"],
            "launches_image_path": bf16["image"]["launches"][f"{name}_bf16"],
            "launches_sweep_path":
                bf16["sweep_drive"]["launches"][f"{name}_bf16"],
            "launches_host_loop_glyph_path":
                host["glyph_bf16"]["launches"][f"{name}_bf16"],
            "launches_graphed_per_iteration": graphed["flagless bf16"][
                "rounds"][-1]["launches"][f"{name}_bf16"] // GRAPH_ITERS,
            "launches_graphed_evaluation": graphed["flagless bf16"][
                "rounds"][-1]["evaluation"]["launches"].get(
                    f"{name}_bf16", 0),
            "max_abs_err": bf16["parity"]["picked"][name],
            "max_abs_err_lanes": bf16["parity"]["lanes"][name],
            "ms": t["ms"],
            "lanes_form": t["lanes_form"],
            "lanes_ms": t["lanes_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": shape_bf16,
            "shapes": {shape: t[name] for shape, t in bf16["timings"].items()},
        })

    def adam(launches):
        """The optimizer pair's launches of a path's counts."""
        return {k: launches[k] for k in ("adam_sumsq", "adam_apply")}

    graphed_round = graphed["flagless"]["rounds"][-1]
    kernels.append({
        "name": "adam_grad_sumsq + adam_clip_apply",
        "dtype": "float32",
        "route": "cuda",
        "source": "dtqn_tpu_torch/csrc/optimizer.cu",
        "replaces": None,
        "launches": adam(main["launches"]),
        "launches_bag_path": adam(bag["full_width"]["launches"]),
        "launches_pomdp_path": {
            env: adam(pomdp[env]["launches"]) for env in (HALLWAY, HEAVENHELL)},
        "launches_image_path": adam(image["launches"]),
        "launches_variant_paths": {
            v: adam(variants[v]["launches"]) for v, _ in VARIANTS},
        "launches_four_rooms_path": adam(multi["launches"]),
        "launches_sweep_path": adam(sweep["flagless"]["launches"]),
        "launches_per_rank_2_rank_path": [
            adam(rank["launches"]) for rank in dp["turns"][1]],
        "launches_graphed_per_update": {
            k: n / graphed_round["updates"]
            for k, n in adam(graphed_round["launches"]).items()},
        "launches_graphed_evaluation": adam(
            evaluation["turns"]["launches"]),
        "launches_host_loop_cue_path": adam(host["cue"]["launches"]),
        "launches_host_loop_glyph_path": adam(host["glyph"]["launches"]),
        "launches_bf16_path": adam(bf16["flagless"]["launches"]),
        "launches_bf16_bag_path": adam(bf16["bag"]["launches"]),
        "launches_bf16_sweep_path": adam(bf16["sweep_drive"]["launches"]),
        "launches_bf16_host_loop_glyph_path": adam(
            host["glyph_bf16"]["launches"]),
        "shapes": {shape: t for shape, t in optimizer.items()
                   if shape.startswith("[")},
    })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"main_path": main, "runner": runner, "resume": resume,
                      "discrete": discrete, "evaluation": evaluation,
                      "bag": bag, "pomdp": pomdp, "baselines": baselines,
                      "image": image, "variants": variants,
                      "four_rooms": multi, "continuous_car_flag": continuous,
                      "sweep": sweep, "timings_sweep": t_sweep,
                      "timings_b64": t_act, "timings_b32_d16": t_wide,
                      "timings_host_loop_cue": t_cue, "host_loop": host,
                      "timings_d16": t_d16, "timings_bag": t_bag,
                      "timings_streamed": t_streamed,
                      "profile": prof, "bf16": bf16, "several_devices": dp,
                      "graphs": graphed, "tracing": traced,
                      "optimizer": optimizer,
                      "phase_seconds": phase_seconds,
                      "ptxas": usage}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    try:
        run(args.seed)
    except SmokeFailure as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
