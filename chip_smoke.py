"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. print the card (nvidia-smi name and power limit), torch and CUDA
     versions; no CUDA device is an error;
  1. build the hand-written CUDA kernels from ``tokenflow_torch/csrc``;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (seeded inputs), with error, flipped-index share and median
     times (CUDA events) per shape, beside the bound (bytes over 3.35 TB/s
     or bf16 flops over 989 TFLOP/s, whichever is larger) and, where one
     PyTorch call computes the same function, that call's time (SDPA for
     K1, F.group_norm for K4 without SiLU; the port calls neither; for K5
     the path it replaced, F.layer_norm on an fp32 copy, cast back). K1 runs
     at head dim 64 (SD-2.1) and at 40, 80 and 160 (SD-1.5's ControlNet
     path), also on the strided head-split views the pivotal pass gives it,
     under a watchdog that ends the run if its checks hang. K6 (short-key
     attention) runs at one row per family the paths launch (K6_SHAPES:
     cross attention over 77 keys at each head dim, 1024, 256 and 64 keys)
     against sdp_attention in fp32 at K1's limits, with its plan, wrapper /
     device / host ms, share of the bound, the plain version's and SDPA's
     times, under the same watchdog. K2 and K3 run at
     every site of both paths with the F the path passes, timed as the
     wrapper call, the kernel launch and the launch without output (the
     match stage alone), and once more against each other across S. K4
     runs at both paths' GroupNorm shapes in bf16 (the transformers' 32^2,
     16^2 and 8^2 among them, and one in fp32), SiLU on and off, with its
     plan (variant, cluster size, CTAs per SM), the wrapper's time and one
     launch's device time, and a repeat launch that must match bit for bit.
     K5 runs at every UNet, ControlNet and CLIP text LayerNorm shape
     (LN_SHAPES): its plan and grid, the wrapper's time, one launch's device
     time and its share of the bound, a repeat launch bit for bit, and the
     error against its plain version. The fp32 kernels (``dtype: f32``) against
     their plain versions in fp32, TF32 off, bounded as their 3xTF32 splits
     run, at three times the flops on the 495 TFLOP/s TF32 tensor cores,
     and also at 67 TFLOP/s of fp32 on the CUDA cores: K1-f32 at every shape of the
     fp32 paths and one row per SD-1.5 head dim (K1_F32_SHAPES) and on
     the D = 64 row's strided views, with SDPA's fp32 time beside it; the fp32 match core
     through K2 (F=40, 4096x320 in four modes: separated, duplicated-row,
     random and all-negative inputs; every other K2_SHAPES site separated
     and random; the ragged all-negative row) and K3 (F=24, 9216x320 in
     the four modes, the per-chunk F=8, the ragged row; bitwise equal to
     K2). The match core also at two streams, the approximate propagation
     pass's [uncond|cond] tables, in bf16 and fp32: K2 at F=40 4096x320 and
     at F=24 9216x320 (the 768p top level, K2's under approx), K3 at F=24
     9216x320 (the kernel alone), and K2 on ``kf_attn[1:]`` of a
     three-stream table in the cache's stream-major order (passed as it is)
     and in frame-major order (copied by the wrapper). K7 (the GEGLU's
     projection and activation) runs at one row per shape family the paths
     launch and a ragged one (K7_SHAPES) against its plain version in fp32
     (K7_MAX_ULPS), two launches bit for bit, with its plan, device time by
     events and by the profiler's record, its share of the bound, the
     replaced bf16 path's time and F.linear's projection alone;
  3. zero the kernels' launch counters and drive the main path through the
     port's CLIs: 40 synthetic 512x512 frames, SD-2.1 with random weights
     in bf16, DDIM inversion + reconstruction, then a 10-step PnP edit with
     5 pivots; check the output tree, finite frames, that K1, K2, K4, K5,
     K6 and K7 were launched and that K3 was not (K6's launches a step are
     reported beside the yardstick's count, K6_PER_STEP; K7's must equal
     K7_PER_STEP, one a transformer block a model call). ``[clip]`` (``check_clip``):
     a full-width ViT-L/14 CLIP checkpoint in HF layout with random
     weights from a seed (build/, removed after); the port's
     ``compare_outputs`` CLI (PSNR, CLIP temporal consistency and score)
     of that exact edit against its ``prop_approx`` edit on the card, in a
     subprocess; in this process, the scorer its ``load_scorer`` builds
     (fp32): the 40 frames' image-feature seconds and peak memory, its
     metrics equal to the CLI's, its image and text features against
     ``load_scorer``'s CPU scorer within CLIP_REL_L2, and the card with
     TF32 on, a control that must read above it; then the port's
     ``prop_approx_ab`` CLI at its defaults (cuda, SD-2.1, 40 x 512^2,
     exact then pinned ``prop_approx`` PnP, the report with that
     checkpoint) in a subprocess. ``[sharded]`` (``run_sharded_path``): the
     port's frames sharding on the main path's latents and pivots, two ranks
     of a gloo group spawned on the one card (host-staged collectives): the
     sharded K1 and K2 entries bit for bit against the unsharded launches,
     the bf16 10-step edit with and without shard_pivotal against a
     single-rank edit of the same batch shapes (without: bit for bit), and
     in fp32 each of the first steps, with a no-gather control that must
     fail the limit the sound runs meet. ``[fused]`` (``run_fused_path``,
     right after the main path, under a watchdog): the single-pass fused
     step on the main path's latents and pinned pivots, one UNet call a
     step on 15 + 120 items: the 10-step bf16 edit through ``run_pnp`` with
     ``fused_step: true``, whose K1 and K2 launches must equal the
     two-pass edit's (K2 at three streams only); fused and two-pass edits
     of the first steps in turns on a held stack (s/step, peak memory; the
     fused latents within SHARDED_BF16_REL_L2 of the two-pass ones); a
     2-step fused edit under ``profiling.trace``, whose trace must name K1's
     and K2's CUDA functions; and in fp32 each of the first steps, fused,
     from the two-pass edit's latents, within FUSED_F32_REL_L2 of its step,
     with a control (the frames propagating from the other step's pivot
     segment) that must read above it. ``[resume]`` (``run_resume_path``): checkpoint/resume
     through the CLIs in subprocesses at 40 x 512^2 (SD-2.1, bf16):
     preprocess + run_pnp uninterrupted; preprocess --checkpoint_inversion
     --then_edit killed at its first inversion checkpoint; the same command
     again, which must resume the inversion, killed at its first edit
     checkpoint; run_pnp, which must resume the edit; the resumed
     trajectory and frames must equal the uninterrupted ones bit for bit.
     Then, counters zeroed again, the SDEdit path at 768p
     at the CLIs' defaults: preprocess 24 frames, an 8-step SDEdit
     edit with 3 pivots and a 2-step --vanilla run; all five kernels must
     launch (K3 at the 96x96 level). The edit runs once more with
     ``group_norm_kernel: false`` (``F.group_norm``), for its step time.
     Launches are read after each CLI, so each path reports them per step
     of its preprocess and edit.
     One pivotal and one propagation UNet call on the card against the
     CPU's plain path. Then, counters zeroed again, the ControlNet path at
     512^2 on SD-1.5 with random weights (the ControlNet's zero projections
     filled from a seed, its residuals checked non-zero): preprocess 40
     frames with --sd_version ControlNet, then a 10-step run_controlnet
     edit with 5 pivots; K1 must launch at head dims 40, 80 and 160 and K2,
     K4 and K5 must launch, K3 not. Then the same small-input check for the
     SD-1.5 UNet with the ControlNet's residuals. Then, counters zeroed
     again, the depth path at 512^2: a DPT-Large checkpoint with random
     weights from a seed in HF layout (build/, removed after), preprocess
     40 frames with --sd_version depth --depth_model_dir (the DPT makes
     each frame's depth map at 384^2, cached to depth/%05d.npy; SD-2-depth's
     5-channel UNet, 10 + 10 steps) and a 10-step PnP edit with 5 pivots,
     then the same edit with prop_approx, the CLIs run with TF32 on around
     them; K1 (D = 64 only), K2, K4 and K5 must launch, K3 not; the 40 maps
     must be finite and not constant, and the CLI's raw map of frame 0
     within DPT_REL_L2 of the CPU's fp32 run of the same checkpoint (the
     card's model run with TF32 on, a control that must read above it); the DPT's
     seconds for the 40 frames. Then the SD-2.1 small-input check's exact
     mode on the SD-2-depth UNet (5 input channels). Each small-input check
     also runs the card's weights in fp32 (fp32 kernels) against the same
     CPU run, and once more with TF32 on as a control, through one check:
     where a run's matched indices differ from the CPU's, each must be a
     near tie (REF_TIE_TOL) and the run is read against a CPU run that
     takes its resolution of them, within a limit of its own; the sound
     run must pass, the control must fail. Each run reports the share of
     matched indices per site that differ and the largest replayed flip's
     similarity gap. Last,
     the stack in fp32 (dtype f32, fp32 kernels only, no bf16 launch
     allowed), depth cut further:
     preprocess + PnP at 40x512^2 with 3 + 3 + 3 steps (K1-f32, K2-f32, K4
     in fp32), then preprocess + SDEdit at 8x768^2 with 4 + 4 steps and 2
     edit steps (K1-f32, K2-f32, K3-f32, K4 in fp32). Each bf16
     path also edits its latents again (``run_variant``, counts zeroed just
     before and read just after): PnP 512^2, SDEdit 768p and
     ControlNet 512^2 with ``prop_approx``; they must launch K2 at two
     streams only (``launches_by_streams``) and SDEdit 768p no K3; each
     prints its s/step by pass beside the exact edit's (PnP repeats the
     exact edit after it, like for like). The SD-2.1 small-input check
     runs three modes: exact, PnP approx and SDEdit approx;
  4. print one JSON line with the kernel table, then the result line
     ``{"ok": true, "device": {...}}`` last.

Not run by main(): ``profile_edit_step()`` (torch.profiler device ms by
kernel class for one 768p SDEdit edit step) and
``sweep_group_norm_clusters(gen)`` (K4 with each cluster size forced).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# tolerances (see PERF.md "H100 port"): K1 bf16 output, unit-normal inputs
K1_ATOL = 2e-2
# K1 against its plain version, per shape: max|err| at most K1_MAX_ULPS
# bf16 steps at that shape's largest |output| (never above K1_ATOL), and
# relative L2 at most K1_REL_L2. Another block order of the same numerics
# (bf16 P, bf16 output) sits at 1 step and ~2e-3; a ragged KV tail counted
# as zero logits instead of masked gives the 1000 x 3000 row 1.4e-2 at only
# 2 steps (tests/test_torch_attention.py holds both limits to such cases)
K1_MAX_ULPS = 4
K1_REL_L2 = 5e-3
# K2 on random inputs: share of matched indices allowed to differ from the
# plain version (fp32 sums in another order break near-ties)
K2_MAX_FLIP_SHARE = 1e-3
# the main path's UNet on the card against the CPU's plain fp32 path
REF_REL_L2 = 5e-2
# the same with the card's stack in fp32 (fp32 kernels, TF32 off), read
# against a CPU run that takes the card's resolution of near-tie matches
# (REF_TIE_TOL): fp32 sums in another order over ~70 layers, against bf16's
# rounding (relative step 2^-8) in REF_REL_L2. The limit lies near the
# geometric mean of the sound fp32 readings and those with TF32 on, a
# control that must fail the check, both read that way (on the H100: sound
# 5.55e-6 to 6.76e-6, TF32 8.32e-4 to 9.58e-4 over SD-2.1's three modes and
# SD-1.5 + ControlNet; PERF.md)
REF_REL_L2_F32 = 7.5e-5
# a matched index the card's fp32 run resolves otherwise than the CPU's is
# a near tie when the two candidates' similarities, in fp64 from the CPU
# run's operands, lie within REF_TIE_TOL * |x| of each other (p_hat is unit
# norm). Near the geometric mean of the largest such gap of the sound fp32
# runs (6.03e-7) and the smallest largest gap of the TF32 controls (1.59e-4)
# over the same references (on the H100; PERF.md)
REF_TIE_TOL = 1e-5

# the fp32 kernels (K1-f32, the fp32 match core) against their plain
# versions in fp32, TF32 off. K1: fp32 rounding over Skv <= 20480 terms
# sits near 1e-6 relative, a single-pass TF32 product (10-bit mantissa)
# near 1e-3, and a ragged tail counted as zero logits far above both
K1_F32_REL_L2 = 2e-5
K1_F32_ATOL = 1e-4
# the match core: identical indices on separated and duplicated-row
# inputs, at most this share flipped on random and all-negative ones (fp32
# sums in another order break near-ties only), and where the indices
# agree the blended rows within K2_F32_VALUE_TOL * max|kf| (the blend's
# roundings are the plain version's)
K2_F32_MAX_FLIP_SHARE = 1e-4
K2_F32_VALUE_TOL = 1e-6

# K4 against its plain version: at most this many bf16 steps, counted at
# the magnitude of the plain result but never below GN_ULP_FLOOR (fp32 sums
# in another order move the statistics by ~1e-6 relative; near zero the
# fp32 rounding of the affine's terms exceeds a bf16 step of the result)
GN_MAX_ULPS = 2
GN_ULP_FLOOR = 2.0**-6

K1_SHAPES = [  # (B, Sq, Skv, H) with D = 64
    (2, 20480, 20480, 5),  # PnP 512^2: pivotal extended attention, 64x64 level
    (2, 5120, 5120, 10),  # PnP 512^2: pivotal extended attention, 32x32 level
    (2, 1280, 1280, 20),  # PnP 512^2: pivotal extended attention, 16x16 level
    (40, 4096, 4096, 5),  # PnP 512^2: inversion self-attention, 40 frames
    (2, 27648, 27648, 5),  # SDEdit 768p: pivotal extended attention, 96x96
    (2, 6912, 6912, 10),  # SDEdit 768p: pivotal extended attention, 48x48
    (2, 1728, 1728, 20),  # SDEdit 768p: pivotal extended attention, 24x24
    (24, 9216, 9216, 5),  # SDEdit 768p: inversion / vanilla self-attention
    (2, 1000, 3000, 5),  # ragged Q and KV tails
]
# (B, Sq, Skv, H, D): SD-1.5's 8 heads at the ControlNet path's 512^2
K1_SD15_SHAPES = [
    (2, 20480, 20480, 8, 40),  # pivotal extended attention, 64x64 level
    (2, 5120, 5120, 8, 80),  # pivotal extended attention, 32x32 level
    (2, 1280, 1280, 8, 160),  # pivotal extended attention, 16x16 level
    (2, 1024, 1024, 8, 160),  # the same at 32 frames (4 keyframes): D = 160's 128-row plan
    (40, 4096, 4096, 8, 40),  # inversion and ControlNet self-attention, 40 frames
    (5, 4096, 4096, 8, 40),  # pivotal pass: the source stream's per-frame attention
    (15, 4096, 4096, 8, 40),  # pivotal pass: the ControlNet's, 3 streams x 5 pivots
    (120, 4096, 4096, 8, 40),  # propagation pass: the ControlNet's, 3 streams x 40 frames
    # ragged Q and KV tails against each head dim's tiles
    (2, 1000, 3000, 5, 40), (2, 1000, 3000, 5, 80), (2, 1000, 3000, 5, 160),
]
# K1's checks end the run if they take longer (a hung kernel)
K1_PHASE_SECONDS = 420
# the plain version's reference runs over batch slices whose fp32 logits of
# one 1024-token KV block stay under this many bytes (its temporaries take
# a few times that)
K1_PLAIN_BYTES = 6 << 30
# (B, Sq, Skv, H, D): K6's rows, one per family the paths launch (cross
# attention over 77 text tokens at each head dim, 1024 keys at D = 64 and
# 80, 256 at D = 160, 64 keys), held to K1's limits against sdp_attention
# on fp32 copies; the first two are the byte-bound rows that carry the most
# of K6's bytes (SD-XL's 32^2 and SDEdit 768^2's 96^2 cross attention over
# the propagation pass's 120 images)
K6_SHAPES = [
    (120, 1024, 77, 20, 64),  # SD-XL 1024^2: cross attention at 32x32
    (120, 9216, 77, 5, 64),  # SDEdit 768^2: cross attention at 96x96
    (120, 4096, 77, 8, 40),  # SD-1.5 512^2: cross attention at 64x64
    (120, 1024, 77, 8, 80),  # SD-1.5 512^2: cross attention at 32x32
    (120, 256, 77, 8, 160),  # SD-1.5 512^2: cross attention at 16x16
    (5, 1024, 1024, 20, 64),  # SD-XL 1024^2: the source stream's self attention at 32x32
    (120, 1024, 1024, 8, 80),  # SD-1.5 + ControlNet: self attention at 32x32
    (40, 256, 256, 8, 160),  # SD-1.5 inversion: self attention at 16x16
    (40, 64, 64, 20, 64),  # SD-2.1 inversion: self attention at the 8x8 mid block
]
# K6's launches a step on the main paths (the yardstick's count of the
# attention calls at or under kv_block: 44 an edit step of PnP 512^2 over
# 40 frames, 27 an inversion or reconstruction step; 68 a ControlNet edit
# step), beside the counts the paths read
K6_PER_STEP = {"pnp_512": {"inversion+reconstruction": 27, "edit": 44},
               "controlnet_512": {"edit": 68}}
# the depth path (SD-2-depth, DPT-Large): this many inversion,
# reconstruction and edit steps
DEPTH_STEPS = 10
# the DPT-Large on the card (fp32, TF32 off) against the CPU's fp32 run:
# relative L2 of the raw prediction on one 384^2 frame. fp32 sums in another
# order over 24 layers sit near 1e-6 relative; TF32 products (10-bit
# mantissa) near 1e-3
DPT_REL_L2 = 1e-4
DPT_SEED = 21
# the CLIP towers (ViT-L/14 and the 12 x 768 text tower, fp32, TF32 off) on
# the card against the CPU port's fp32 run: relative L2 of the image
# features of CLIP_REF_FRAMES frames and of the text features; the same
# limit as the DPT's, another 24-layer ViT-L in fp32
CLIP_REL_L2 = 1e-4
CLIP_SEED = 23
CLIP_REF_FRAMES = 8
# the resume path (SD-2.1, 40 x 512^2, bf16): inversion steps, save grid
# and segment length; edit steps and segment length
RESUME_INV_STEPS, RESUME_SAVE_STEPS, RESUME_INV_SEGMENT = 20, 10, 4
RESUME_EDIT_STEPS, RESUME_EDIT_SEGMENT = 10, 2
# a CLI subprocess (the resume path, the CLIP phase) ends the run if it
# takes longer
CLI_SECONDS = 300
# the fp32 paths' depth: PnP 512^2 (40 frames) with this many inversion,
# reconstruction and edit steps; SDEdit 768p with F32_SDEDIT_FRAMES frames,
# this many inversion and reconstruction steps and a schedule of as many
# (2 edit steps after the 0.9 truncation)
F32_PNP_STEPS = 3
F32_SDEDIT_FRAMES = 8
F32_SDEDIT_STEPS = 4
# (K pivots, S, heads, inner) of the pivotal pass's extended attention: PnP
# 512^2 at the 64x64 level (D = 64), ControlNet 512^2 at each level (D =
# 40, 80, 160)
K1_STRIDED = [(5, 4096, 5, 320), (5, 4096, 8, 320), (5, 1024, 8, 640), (5, 256, 8, 1280)]
# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 and TF32 tensor-core FLOP/s and fp32 FLOP/s on the CUDA cores (the
# plain fp32 rate), at the 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
# the peak each dtype's kernels are bounded by, as named in their rows:
# the fp32 kernels run every fp32 product as three TF32 products on the
# tensor cores (3xTF32 splits), so 3 x flops at the TF32 peak
PEAKS = {
    torch.bfloat16: (H100_BF16_FLOPS, "bf16 tensor cores, 989 TFLOP/s"),
    torch.float32: (H100_TF32_FLOPS / 3,
                    "3xTF32: 3 x flops on the TF32 tensor cores, 495 TFLOP/s"),
}
# the fp32 rows' second reading: flops at the plain fp32 rate
FFMA = (H100_FP32_FLOPS, "fp32 CUDA cores (FFMA), 67 TFLOP/s")


def ffma_bound_ms(nbytes: float, flops: float) -> float:
    """The fp32 rows' second bound: ``flops`` at the CUDA cores' fp32 (FFMA)
    peak, or the bytes, whichever takes longer."""
    return bound(nbytes, flops, FFMA[0])[0]
# K1-f32's rows (B, Sq, Skv, H, D): every shape the fp32 paths give it (D =
# 64), the 24-frame 768p pivotal row, one row per SD-1.5 head dim at its
# largest path shape, and the ragged row
K1_F32_SHAPES = [
    (2, 20480, 20480, 5, 64),  # PnP 512^2: pivotal extended attention, 64x64
    (2, 5120, 5120, 10, 64),  # PnP 512^2: pivotal extended attention, 32x32
    (40, 4096, 4096, 5, 64),  # PnP 512^2: inversion self-attention, 40 frames
    (2, 9216, 9216, 5, 64),  # fp32 SDEdit 768p (1 pivot): pivotal, 96x96
    (2, 2304, 2304, 10, 64),  # fp32 SDEdit 768p: pivotal, 48x48
    (8, 9216, 9216, 5, 64),  # fp32 SDEdit 768p: inversion, 8 frames, 96x96
    (8, 2304, 2304, 10, 64),  # fp32 SDEdit 768p: inversion, 48x48
    (2, 27648, 27648, 5, 64),  # SDEdit 768p at 24 frames (3 pivots): pivotal, 96x96
    (2, 20480, 20480, 8, 40),  # SD-1.5 512^2: pivotal extended attention, 64x64
    (2, 5120, 5120, 8, 80),  # SD-1.5 512^2: 32x32
    (2, 1280, 1280, 8, 160),  # SD-1.5 512^2: 16x16
    (2, 1000, 3000, 5, 64),  # ragged Q and KV tails
]
# the strided views of the D = 64 row (K1_STRIDED's first entry)
K1_F32_STRIDED = [(5, 4096, 5, 320)]
K2_SHAPES = [  # (S, D, F, K): F frames per launch as the path passes them
    (4096, 320, 40, 5), (1024, 640, 40, 5), (256, 1280, 40, 5),  # PnP 512^2 sites
    (64, 1280, 40, 5),  # PnP 512^2 mid block
    # SDEdit 768p sites below the top level, per propagate_chunk of 8 frames
    (2304, 640, 8, 3), (576, 1280, 8, 3),
    (144, 1280, 8, 3),  # 768p mid block, ragged against the core's 128-token tiles
    (9216, 320, 40, 5),  # the 768p top level (K3's site), K2 off its path
]
K2_NS = 3
# the ragged row where every real similarity is negative: a zero-filled tail
# column read as similarity 0 would win every row
K2_NEGATIVE = (144, 1280, 8, 3)
# the fp32 match core's rows (S, D, F, K) in all four modes: K2 at the PnP
# 512^2 top level, K3 at the 768p top level in one launch of three chunks
# (check_token_match_f32 adds every K2_SHAPES site, K3's per-chunk launch
# and the ragged all-negative row)
K2_F32 = (4096, 320, 40, 5)
K3_F32 = (9216, 320, 24, 3)
K3_S, K3_D, K3_K, K3_NS = 9216, 320, 3, 3  # SDEdit 768p top level
K3_F = 24  # three propagate_chunks of 8 frames in one launch
K3_CHUNK_F = 8  # the per-chunk launch of the path
# the approximate (source-free) propagation pass's two-stream ([uncond|cond])
# kf tables, (S, D, F, K): K2 at the PnP 512^2 top level and at the 768p top
# level, where a two-stream bf16 table (11.25 MiB) stays under K3's 12 MiB
# cap, so the approximate 768p path launches K2 there; K3 at the 768p top
# level, the kernel alone (no path launches it at two streams)
NS2_K2_SHAPES = [(4096, 320, 40, 5), (9216, 320, 24, 3)]
NS2_K3_SHAPE = (9216, 320, 24, 3)
NS2_MODES = ("separated", "random")
# K2 on the PnP approximate pass's kf_attn[1:] of a three-stream table
NS2_VIEW_SHAPE = (4096, 320, 40, 5)
# K2 against K3 on the same inputs across S at D = 320, one 8-frame chunk
K2_K3_SWEEP = [(2304, 320), (4096, 320), (9216, 320)]
GN_SHAPES = [  # (B, C, H, W), groups 32: the plan's variant and cluster size
    (9, 320, 96, 96),  # SDEdit 768p pivotal pass, 96^2 (4-CTA clusters)
    (24, 640, 48, 48),  # 768p propagation chunk, 48^2 (2-CTA clusters)
    (24, 2560, 12, 12),  # 768p propagation chunk, 12^2 (80 channels per group)
    (24, 960, 96, 96),  # 768p up-block at 96^2 (8-CTA clusters)
    (15, 320, 64, 64),  # PnP 512^2 pivotal pass (5 pivots x 3 streams), 64^2
    (120, 320, 64, 64),  # PnP 512^2 propagation (40 frames x 3 streams), 1 CTA
    (120, 960, 64, 64),  # PnP 512^2 up-block at 64^2 (4-CTA clusters)
    (120, 640, 32, 32),  # PnP 512^2 propagation, 32^2: a transformer's norm without SiLU
    (120, 1280, 16, 16),  # PnP 512^2 propagation, 16^2
    (120, 1280, 8, 8),  # PnP 512^2 propagation, the mid block's 8^2
    (10, 512, 192, 192),  # VAE decoder at 192^2 (16-CTA clusters of 74 KB)
    (10, 128, 768, 768),  # VAE decoder at pixel resolution (split spans)
    (3, 96, 7, 9),  # ragged: 3 channels x 63 per group, single-element ends
]
# K4 in fp32 (the stack's f32 dtype), against its plain version at rtol =
# atol = GN_F32_TOL: fp32 sums in another order (~1e-7 relative) and the
# fast SiLU (a few fp32 ulps)
GN_F32_SHAPES = [(9, 320, 96, 96)]
GN_F32_TOL = 1e-5
# K5's rows (rows, C): every LayerNorm of the UNet and the ControlNet on the
# benchmark's paths (SD-2.1 and SD-1.5 share the widths) and of the CLIP
# text towers
LN_SHAPES = [
    (61440, 320), (15360, 640), (3840, 1280), (960, 1280),  # pivotal pass: 5 pivots x 3 streams
    (491520, 320), (122880, 640), (30720, 1280), (7680, 1280),  # propagation: 40 frames x 3
    (163840, 320), (40960, 640), (10240, 1280), (2560, 1280),  # inversion: 40 frames
    (92160, 320), (737280, 320),  # SDEdit 768^2: 5 pivots x 2 streams, 40 frames x 2, 96^2
    (154, 1024), (77, 1024), (154, 768), (77, 768),  # CLIP text: OpenCLIP-H, CLIP-L
]
# HunyuanDiT v1.2 at 1024^2 (64^2 = 4096 tokens a frame, 16 heads of 88,
# 1408 wide, a 333-token context), 5 keyframes, 40 frames, 3 streams: K1's
# rows (B, Sq, Skv, H, D) at D = 88, the pivotal pass's extended attention
# over 5 keyframes, its source stream per frame, and the inversion's self
# attention over 40 frames; K6's, the cross attention of the pivotal pass
# and of the propagation pass (120 images); each against sdp_attention on
# fp32 copies (K1's limits)
DIT_K1_SHAPES = [(2, 20480, 20480, 16, 88), (5, 4096, 4096, 16, 88),
                 (40, 4096, 4096, 16, 88), (2, 1000, 3000, 16, 88)]
DIT_K6_SHAPES = [(15, 4096, 333, 16, 88), (120, 4096, 333, 16, 88), (3, 1000, 333, 16, 88)]
# the propagation's match (S, D, F, K): K3 at the DiT's 64^2 tokens, 1408
# wide (C = 1, 3 stages), every flip a near tie of the fp32 plain version
DIT_MATCH = (4096, 1408, 40, 5)
# K5's DiT rows (rows, C): the blocks' norms at 1408 over the pivotal and
# propagation passes, the per-head QK norm at 88 and the long skips' norm
# at 2816
DIT_LN_SHAPES = [(61440, 1408), (491520, 1408), (983040, 88), (7864320, 88),
                 (491520, 2816)]
# K5's rotary entry at the DiT's rotated q and k (tokens, heads, head dim):
# the propagation pass's cross-attention q (120 images of 64^2 tokens) and
# the pivotal pass's q and k (15 images), against the two launches it
# replaces (K5, then apply_rope in fp32) within LN_MAX_ULPS
DIT_ROPE_SHAPES = [(491520, 16, 88), (61440, 16, 88)]
DIT_ROPE_GRID = 64  # the token grid at 1024^2: 4096 tokens an image
# the DiT cell's launches a step of the rotary entry (40 blocks x 4 rotated
# tensors: the pivotal pass's self-attention q and k, both passes'
# cross-attention q) and of K5's plain entry (the other norms)
DIT_ROPE_PER_STEP = 160
DIT_K5_PER_STEP = 360
# the DiT cell's checks end the run if they take longer (a hung kernel)
DIT_PHASE_SECONDS = 600
# K5 against its plain version: at most this many bf16 steps at
# max(|ref|, GN_ULP_FLOOR) (fp32 sums in another order; the rounding to
# bf16 of a result near a tie)
LN_MAX_ULPS = 1
# K7's rows (M, K, 2N): x (M, K) against the ff.net.0.proj weight (2N, K),
# one per shape family the paths launch, and one ragged M that is a
# multiple of neither plan's tile rows
K7_SHAPES = [
    (491520, 320, 2560),  # SD 512^2: the propagation pass's 64x64 level (120 images)
    (122880, 640, 5120),  # SD 512^2: 32x32
    (30720, 1280, 10240),  # SD 512^2: 16x16
    (960, 1280, 10240),  # the pivotal pass's 8x8 mid block (15 images): the 64-row plan
    (491520, 640, 5120),  # SD-XL 1024^2: 64x64
    (122880, 1280, 10240),  # SD-XL 1024^2: 32x32
    (1000, 320, 2560),  # ragged M
]
# K7 against its plain version in fp32 (TF32 off) on fp32 copies of the
# same bf16 inputs: at most this many bf16 steps at max(|ref|,
# GN_ULP_FLOOR). K7 rounds once to bf16 (half a step) after fp32 sums in
# another order than cuBLAS's (about 1e-6 relative) and erff; the bf16
# plain path, which rounds the projection, the GELU and the product, read
# 5.7-6.8 steps at these rows on an H100
K7_MAX_ULPS = 1
# K7's launches a step on the main paths: one per transformer block a
# model call runs (16 a UNet call, 7 a ControlNet call)
K7_PER_STEP = {"pnp_512": {"inversion+reconstruction": 16, "edit": 32},
               "controlnet_512": {"edit": 46}}
# cluster sizes compared per row (sweep_group_norm_clusters)
GN_CLUSTER_SWEEP = [
    ((9, 320, 96, 96), (2, 4, 8)), ((24, 640, 48, 48), (1, 2, 4)),
    ((24, 960, 96, 96), (4, 8, 16)), ((15, 320, 64, 64), (1, 2, 4)),
    ((120, 320, 64, 64), (1, 2, 4)), ((120, 960, 64, 64), (4, 8)),
    ((10, 512, 192, 192), (8, 16)),
]
# GPU cycles the stream sleeps before a timed launch, so that the host has
# enqueued it before the start event runs (device_ms)
SLEEP_CYCLES = 400_000
# torch.profiler kernel classes of profile_edit_step, first match wins
KERNEL_CLASSES = [
    ("K1 flash attention", ("flash_fwd",)),
    ("K2/K3 token match", ("match_core",)),
    ("fp32 split pre-pass (K1-f32, K2/K3-f32)", ("tf32_split",)),
    ("K4 GroupNorm", ("gn_cluster", "gn_stats", "gn_apply", "gn_resident")),
    ("convolution", ("conv", "cudnn", "xmma_fprop", "implicit", "winograd", "dgrad")),
    ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("GroupNorm (PyTorch)", ("group_norm", "groupnorm")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("softmax", ("softmax",)),
    ("copies and casts", ("copy", "memcpy", "cat", "transpose", "permute", "memset",
                          "nhwc")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
]

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, runs: int = 7) -> float:
    fn()  # warm up
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, runs: int = 7) -> float:
    """Median device time (CUDA events) of the work ``fn`` enqueues: the
    stream sleeps first, so the host has queued ``fn``'s launches before
    the start event runs and host work is not counted."""
    fn()  # warm up
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, runs: int = 7) -> float:
    """Median host time (perf_counter) to enqueue ``fn``'s work while the
    stream sleeps, so that the host never waits on the device."""
    fn()  # warm up
    times = []
    for _ in range(runs):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def kernel_trace_ms(fn, key: str, runs: int = 10) -> float:
    """Device time a call of ``fn`` spends in the kernels whose name holds
    ``key`` (their durations summed over ``runs`` calls, over ``runs``),
    from torch.profiler's CUDA kernel records: the kernels' own time,
    without the launch and event overhead (a few us) that device_ms's
    events take in. NaN if the profiler saw none."""
    fn()  # warm up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and key in e.name()]
    return sum(ns) / runs / 1e6 if ns else float("nan")


def bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 representable steps between a and b."""

    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((ordered(a) - ordered(b)).abs().max().item())


def bf16_ulps_floored(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 steps at max(|want|, GN_ULP_FLOOR)."""
    worst = 0.0
    for g, w in zip(got.reshape(-1).split(1 << 26), want.reshape(-1).split(1 << 26)):
        g, w = g.float(), w.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(GN_ULP_FLOOR))) - 7)
        worst = max(worst, float(((g - w).abs() / ulp).max().item()))
    return worst


def bound(nbytes: float, flops: float, peak: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and to do
    ``flops`` operations at ``peak`` FLOP/s (bf16 tensor cores unless
    given; ``PEAKS``), at the H100's published peaks."""
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Ends the process (exit 3) if the block has not finished in time: a
    kernel that hangs fails the run instead of eating its limit."""

    def fire():
        print(f"[watchdog] {what} did not finish in {seconds} s", flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def k1_mismatch(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """K1's output against its plain version: max|err|, its limit at this
    output's scale, and the relative L2 error."""
    o, r = out.float(), ref.float()
    peak = max(float(r.abs().max()), 2.0**-126)
    return {
        "max_abs_err": float((o - r).abs().max()),
        "max_abs_limit": min(K1_ATOL, K1_MAX_ULPS * 2.0 ** (math.floor(math.log2(peak)) - 7)),
        "rel_l2": float((o - r).norm() / r.norm().clamp_min(1e-30)),
        "rel_l2_limit": K1_REL_L2,
    }


def k1_within_limits(m: dict) -> bool:
    return m["max_abs_err"] <= m["max_abs_limit"] and m["rel_l2"] <= m["rel_l2_limit"]


def k1_f32_mismatch(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """K1-f32's output against its plain version in fp32: max|err| and the
    relative L2 error beside their limits."""
    return {
        "max_abs_err": float((out - ref).abs().max()),
        "max_abs_limit": K1_F32_ATOL,
        "rel_l2": float((out - ref).norm() / ref.norm().clamp_min(1e-30)),
        "rel_l2_limit": K1_F32_REL_L2,
    }


def _k1_plain(fa, q, k, v) -> torch.Tensor:
    """K1's plain version on (q, k, v), over slices of the batch where the
    fp32 logits of one 1024-token KV block would pass K1_PLAIN_BYTES (the
    batch's items are independent, so the slices give the same output)."""
    b, sq, h, _ = q.shape
    step = max(1, min(b, K1_PLAIN_BYTES // (4 * sq * h * 1024)))
    return torch.cat([fa.flash_attention_plain(q[i:i + step], k[i:i + step],
                                               v[i:i + step], kv_block=1024)
                      for i in range(0, b, step)])


def _k1_row(fa, q, k, v, label: str, strided: bool = False) -> dict:
    """K1 on (q, k, v) against its plain version (bf16: ``k1_mismatch``;
    fp32: ``k1_f32_mismatch``), with its time, SDPA's on the same tensors
    (as (B, H, S, D) views: the port never calls it) and the bound at the
    dtype's peak (``PEAKS``). Each time three ways: the wrapper's call
    (``median_ms``, host work included), one call's device time
    (``device_ms``, host work hidden) and the host's time to enqueue it
    (``host_ms``); the share of the bound by device time; bf16 rows also
    K1's tile plan for the row (``k1_plan``) and its waves of one block per
    SM."""
    import torch.nn.functional as F

    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = fa.flash_attention_kernel(q, k, v)
    ref = _k1_plain(fa, q, k, v)
    torch.cuda.synchronize()
    m = (k1_f32_mismatch if q.dtype == torch.float32 else k1_mismatch)(out, ref)
    del out, ref
    err = m["max_abs_err"]
    if not k1_within_limits(m):
        raise AssertionError(
            f"K1 {q.dtype} at {label}: max|err| {err} (limit {m['max_abs_limit']}), "
            f"rel L2 {m['rel_l2']} (limit {m['rel_l2_limit']})"
        )

    def call():
        return fa.flash_attention_kernel(q, k, v)

    ms, kernel_device_ms, kernel_host_ms = median_ms(call), device_ms(call), host_ms(call)
    plain_ms = median_ms(lambda: _k1_plain(fa, q, k, v), runs=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)

    library_ms, library_device_ms, library_host_ms = median_ms(sdpa), device_ms(sdpa), host_ms(sdpa)
    flops = 4.0 * b * h * sq * skv * d
    peak, peak_name = PEAKS[q.dtype]
    nbytes = q.element_size() * d * b * h * (2 * sq + 2 * skv)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    tflops = flops / ms * 1e-9
    tag = "[K1]" if q.dtype == torch.bfloat16 else "[K1 fp32]"
    split = {}
    if q.dtype == torch.float32:
        split = {"bound_ffma_ms": ffma_bound_ms(nbytes, flops)}
    else:
        plan, waves = k1_plan(b, sq, h, d)
        split = {"plan": plan, "waves": waves}
    print(
        f"{tag} {label}: max|err|={err:.3e} (limit {m['max_abs_limit']:.3e}) "
        f"rel L2 {m['rel_l2']:.3e}, kernel {ms:.4f} ms wrapper / {kernel_device_ms:.4f} "
        f"ms device / {kernel_host_ms:.4f} ms host ({tflops:.1f} TFLOP/s by the wrapper, "
        f"{bound_ms / kernel_device_ms:.1%} of the bound by device time), SDPA "
        f"{library_ms:.4f} / {library_device_ms:.4f} / {library_host_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {peak_name})"
        + (f", bound {split['bound_ffma_ms']:.3f} ms ({FFMA[1]})"
           if "bound_ffma_ms" in split else
           f", {split['plan']['consumers']} consumers x {split['plan']['kv_tokens']}-token "
           f"tiles, {split['waves']:.2f} waves"),
        flush=True,
    )
    return {"shape": [b, sq, skv, h], "head_dim": d, "strided": strided, **m,
            "ms": ms, "device_ms": kernel_device_ms, "host_ms": kernel_host_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "library_host_ms": library_host_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": peak_name,
            "bound_share_device": bound_ms / kernel_device_ms,
            **split, "tflops": tflops}


def k1_plan(b: int, sq: int, h: int, d: int) -> tuple[dict, float]:
    """The bf16 tile plan K1 takes for q (b, sq, h, d) on this card, as the
    library reports it (``tf_flash_attention_plan``), and its grid's waves
    of one block per SM."""
    import ctypes

    from tokenflow_torch.kernels import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    got = (ctypes.c_int * 5)()
    lib = _build.load_library()
    _build.check(lib, lib.tf_flash_attention_plan(d, b, h, sq, sms, got),
                 "tf_flash_attention_plan")
    plan = dict(zip(("block_rows", "kv_tokens", "stages", "consumers", "smem_bytes"), got))
    return plan, -(-sq // plan["block_rows"]) * h * b / sms


def check_flash(gen: torch.Generator) -> dict:
    from tokenflow_torch.kernels import flash_attention as fa
    from tokenflow_torch.ops.attention import split_heads

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    rows = []
    shapes = [(*row, 64) for row in K1_SHAPES] + K1_SD15_SHAPES
    for b, sq, skv, h, d in shapes:
        rows.append(_k1_row(
            fa, randn(b, sq, h, d), randn(b, skv, h, d), randn(b, skv, h, d),
            f"B={b} Sq={sq} Skv={skv} H={h} D={d}",
        ))
        torch.cuda.empty_cache()
    # the pivotal pass's extended attention as ops/extended_attention.py
    # passes it: head-split views of the (3, K, S, inner) projections, uncond
    # and cond streams over K frames; q and k either injected from the
    # source stream (a broadcast view, which the wrapper copies for TMA) or
    # the streams' own (injection off, and every SDEdit and ControlNet
    # pivotal pass), so that all three operands reach the kernel as views
    for kf, s, heads, inner in K1_STRIDED:
        for injected in (True, False) if inner // heads == 64 else (False,):
            q3, k3 = (
                randn(1, kf, s, inner).expand(3, kf, s, inner) if injected
                else randn(3, kf, s, inner) for _ in range(2)
            )
            v3 = randn(3, kf, s, inner)
            q, k, v = (split_heads(t[1:].reshape(2, kf * s, inner), heads)
                       for t in (q3, k3, v3))
            rows.append(_k1_row(
                fa, q, k, v, f"extended attention views K={kf} S={s} H={heads} "
                f"D={inner // heads}, q/k {'injected' if injected else 'own'}, strides "
                f"q {q.stride()} v {v.stride()}", strided=True,
            ))
            del q3, k3, v3, q, k, v
            torch.cuda.empty_cache()
    main = rows[0]
    by_d = {}
    for r in rows:  # each head dim's first row: its largest path shape
        by_d.setdefault(r["head_dim"], r)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "tokenflow_torch/csrc/flash_attention.cu",
        "replaces": "tokenflow_tpu/kernels/flash_attention.py:133",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2": max(r["rel_l2"] for r in rows),
        **{key: main[key] for key in
           ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "tflops")},
        "by_head_dim": {
            str(d): {key: r[key] for key in
                     ("shape", "ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                      "library_device_ms", "library_host_ms", "bound_ms", "bound_by",
                      "bound_share_device", "tflops", "max_abs_err", "rel_l2")}
            for d, r in sorted(by_d.items())
        },
        "shapes": rows,
    }


def check_short_attention(gen: torch.Generator) -> dict:
    """K6 against sdp_attention on fp32 copies of its bf16 inputs at
    K6_SHAPES (K1's limits, ``k1_mismatch``), two launches bitwise equal;
    per row K6's plan, its wrapper / device / host-enqueue ms, the share of
    the bound by device time, the plain version's ms (sdp_attention on the
    bf16 inputs, the path K6 replaced) and SDPA's device ms (the library
    yardstick; the port never calls it)."""
    import torch.nn.functional as F

    from tokenflow_torch.kernels import short_attention as sa
    from tokenflow_torch.ops.attention import sdp_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    rows = []
    for b, sq, skv, h, d in K6_SHAPES:
        q, k, v = randn(b, sq, h, d), randn(b, skv, h, d), randn(b, skv, h, d)
        tag = f"[K6] B={b} Sq={sq} Skv={skv} H={h} D={d}"
        out = sa.short_attention_kernel(q, k, v)
        again = sa.short_attention_kernel(q, k, v)
        ref = sdp_attention(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        m = k1_mismatch(out, ref)
        bitwise = torch.equal(out, again)
        del out, again, ref
        if not (k1_within_limits(m) and bitwise):
            raise AssertionError(f"{tag}: {m}, two launches bitwise equal: {bitwise}")

        def call():
            return sa.short_attention_kernel(q, k, v)

        ms, dev_ms, enq_ms = median_ms(call), device_ms(call), host_ms(call)
        plain_ms = median_ms(lambda: sdp_attention(q, k, v), runs=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * b * h * sq * skv * d
        bound_ms, bound_by = bound(q.element_size() * d * b * h * (2 * sq + 2 * skv), flops)
        plan = sa.plan(skv)
        print(f"{tag}: plan {plan}, max|err|={m['max_abs_err']:.3e} (limit "
              f"{m['max_abs_limit']:.3e}) rel L2 {m['rel_l2']:.3e}, two launches bitwise "
              f"equal; kernel {ms:.4f} ms wrapper / {dev_ms:.4f} ms device / {enq_ms:.4f} ms "
              f"host ({bound_ms / dev_ms:.1%} of the bound by device time), plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms device, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        rows.append({"shape": [b, sq, skv, h], "head_dim": d, "plan": plan, **m,
                     "ms": ms, "device_ms": dev_ms, "host_ms": enq_ms, "plain_ms": plain_ms,
                     "library_device_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share_device": bound_ms / dev_ms})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    main = rows[0]
    return {
        "name": "short_attention",
        "route": "cuda",
        "source": "tokenflow_torch/csrc/short_attention.cu",
        "replaces": "ops/attention.py::sdp_attention on CUDA bf16 (no TPU kernel: XLA's einsums)",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2": max(r["rel_l2"] for r in rows),
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": main["library_device_ms"],
        "shapes": rows,
    }


def check_flash_f32(gen: torch.Generator) -> dict:
    """K1-f32 against its plain version in fp32 (TF32 off) at one row per
    head dim (K1_F32_SHAPES) and on the pivotal pass's strided views of the
    D = 64 row, q/k injected and not; SDPA's time at fp32 beside it."""
    from tokenflow_torch.kernels import flash_attention as fa
    from tokenflow_torch.ops.attention import split_heads

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = []
    for b, sq, skv, h, d in K1_F32_SHAPES:
        rows.append(_k1_row(
            fa, randn(b, sq, h, d), randn(b, skv, h, d), randn(b, skv, h, d),
            f"B={b} Sq={sq} Skv={skv} H={h} D={d}",
        ))
        torch.cuda.empty_cache()
    for kf, s, heads, inner in K1_F32_STRIDED:
        for injected in (True, False):
            q3, k3 = (
                randn(1, kf, s, inner).expand(3, kf, s, inner) if injected
                else randn(3, kf, s, inner) for _ in range(2)
            )
            v3 = randn(3, kf, s, inner)
            q, k, v = (split_heads(t[1:].reshape(2, kf * s, inner), heads)
                       for t in (q3, k3, v3))
            rows.append(_k1_row(
                fa, q, k, v, f"extended attention views K={kf} S={s} H={heads} "
                f"D={inner // heads}, q/k {'injected' if injected else 'own'}, strides "
                f"q {q.stride()} v {v.stride()}", strided=True,
            ))
            del q3, k3, v3, q, k, v
            torch.cuda.empty_cache()
    main = rows[0]
    by_d = {}
    for r in rows:  # each head dim's first row
        by_d.setdefault(r["head_dim"], r)
    return {
        "name": "flash_attention_f32",
        "route": "cuda",
        "source": "tokenflow_torch/csrc/flash_attention_f32.cu",
        "replaces": "tokenflow_tpu/kernels/flash_attention.py:133",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2": max(r["rel_l2"] for r in rows),
        **{key: main[key] for key in
           ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_peak",
            "bound_ffma_ms", "tflops")},
        "library": "scaled_dot_product_attention in fp32, TF32 off",
        "by_head_dim": {
            str(d): {key: r[key] for key in
                     ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                      "bound_ffma_ms", "tflops", "max_abs_err", "rel_l2")}
            for d, r in sorted(by_d.items())
        },
        "shapes": rows,
    }


NO_LIBRARY_CALL = "no single PyTorch call computes the match, gather and blend"


def _match_bound(f: int, s: int, d: int, k: int, ns: int,
                 dtype: torch.dtype = torch.bfloat16) -> tuple[float, str]:
    """Bound of the token match + gather: each frame's (S, D) rows against
    its two pivots' S rows (4 F S^2 D flops at the dtype's peak, ``PEAKS``);
    x, the pivot table and the kf tables read once, the (ns, F, S, D)
    output written once."""
    size = torch.finfo(dtype).bits // 8
    return bound(size * d * s * (f + k + ns * k + ns * f), 4.0 * f * s * s * d,
                 PEAKS[dtype][0])


def _stage_bounds(f: int, s: int, d: int, k: int, ns: int,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """The bound of each stage alone: the match reads x and the pivot table
    and writes (2, F, S) int32 indices; the gather reads the indices and the
    kf tables and writes the output."""
    size = torch.finfo(dtype).bits // 8
    match_ms, _ = bound(size * d * s * (f + k) + 8.0 * f * s, 4.0 * f * s * s * d,
                        PEAKS[dtype][0])
    gather_ms, _ = bound(size * d * s * ns * (k + f) + 8.0 * f * s, 0.0)
    return {"match_bound_ms": match_ms, "gather_bound_ms": gather_ms}


def _match_inputs(gen, s, d, mode, f, k, ns=K2_NS, device="cuda", dtype=torch.bfloat16):
    """Seeded (x, p_hat, kf, pa, pb, w1) on ``device``, the tables in
    ``dtype``. Modes: "random";
    "separated" (pivot rows are permuted base rows plus noise, so every
    query has one clear match); "ties" (every pivot row appears four times,
    at 2m and 2m + 1 in the first half and again in the second half, so
    the first maximum is the even row of the first half, with its equals
    in the same 128-token tile and in a later one); "negative" (positive
    pivot rows, negative query rows: every real similarity is below 0)."""
    from tokenflow_torch.ops.propagation import propagation_indices

    pa, pb, w1 = (
        torch.as_tensor(a, device=device)
        for a in propagation_indices(f, -(-f // k))
    )
    if mode == "random":
        x = torch.randn((f, s, d), generator=gen, device=device)
        p = torch.randn((k, s, d), generator=gen, device=device)
    elif mode == "separated":  # pivot rows: permuted base rows plus noise
        base = torch.randn((s, d), generator=gen, device=device)

        def perm():
            return torch.randperm(s, generator=gen, device=device)

        x = torch.stack([base[perm()] for _ in range(f)])
        p = torch.stack([base[perm()] for _ in range(k)])
        x = x + 0.01 * torch.randn(x.shape, generator=gen, device=device)
        p = p + 0.01 * torch.randn(p.shape, generator=gen, device=device)
    elif mode == "negative":
        x = -torch.randn((f, s, d), generator=gen, device=device).abs()
        p = torch.randn((k, s, d), generator=gen, device=device).abs()
    else:  # "ties"
        assert mode == "ties" and s % 4 == 0, (mode, s)
        base = torch.randn((s // 4, d), generator=gen, device=device)
        pick = torch.randint(0, s // 4, (f, s), generator=gen, device=device)
        x = base[pick] + 0.01 * torch.randn((f, s, d), generator=gen, device=device)
        p = torch.stack([
            base[torch.randperm(s // 4, generator=gen, device=device)]
            for _ in range(k)
        ])
        p = p + 0.01 * torch.randn(p.shape, generator=gen, device=device)
        p = p.repeat_interleave(2, dim=1).repeat(1, 2, 1)
    p_hat = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    kf = torch.randn((ns, k, s, d), generator=gen, device=device)
    return x.to(dtype), p_hat.to(dtype), kf.to(dtype), pa, pb, w1


def flip_gaps(x, p_hat, pa, pb, got, want) -> torch.Tensor:
    """The similarity gap over |x|, in fp64, between the pivot rows that
    ``got`` and ``want`` ((2, F, S) indices into the tables of ``pa`` and
    ``pb``) pick for each token where they differ, one entry per such token
    (p_hat is unit norm, so a gap near 0 is a near tie)."""
    xd, pd = x.double(), p_hat.double()
    norm = xd.norm(dim=-1)
    gaps = []
    for j, piv in enumerate((pa, pb)):
        table = pd[piv.long()]

        def sim(i):
            return (xd * torch.gather(table, 1, i.long()[..., None].expand_as(xd))).sum(-1)

        flipped = got[j] != want[j]
        gaps.append(((sim(want[j]) - sim(got[j])).abs() / norm)[flipped])
    return torch.cat(gaps)


def _match_verdict(tag, mode, idx, ref_idx, out, ref, kf_max=None, inputs=None):
    """(line, flipped share, max|err|) of a token-match kernel against its
    plain version; raises past the tolerances of ``mode``: identical
    indices on separated or duplicated-row inputs (ties to the earlier row:
    an even row of the first half), at most K2_MAX_FLIP_SHARE (bf16) or
    K2_F32_MAX_FLIP_SHARE (fp32) flipped on random and all-negative ones;
    where the indices agree, bf16 rows within 1 ulp and fp32 rows within
    K2_F32_VALUE_TOL * ``kf_max`` (max|kf|). Given the match's ``inputs``
    (x, p_hat, pa, pb), an fp32 flip on random and all-negative inputs
    whose similarity gap (``flip_gaps``) is within REF_TIE_TOL * |x| is a
    near tie and does not count against the share, as in the small-input
    references (``check_ties``)."""
    flips = idx.long() != ref_idx
    flipped = float(flips.float().mean().item())
    err = float((out.float() - ref.float()).abs().max().item())
    same = (idx.long() == ref_idx).all(dim=0)  # (F, S) tokens matched alike
    counted = flipped
    if out.dtype == torch.float32:
        max_flips = K2_F32_MAX_FLIP_SHARE
        same_err = float((out[:, same] - ref[:, same]).abs().max()) if same.any() else 0.0
        value_ok = same_err <= K2_F32_VALUE_TOL * kf_max
        line = (f"{tag} {mode}: flipped={flipped:.3e} max|err|={err:.3e} "
                f"max|err|(same idx)={same_err:.3e} (limit {K2_F32_VALUE_TOL * kf_max:.3e})")
        if inputs is not None and mode in ("random", "negative") and flips.any():
            gaps = flip_gaps(*inputs, idx, ref_idx)
            ties = int((gaps <= REF_TIE_TOL).sum())
            counted = (int(flips.sum()) - ties) / flips.numel()
            line += (f", near ties {ties} of {int(flips.sum())} flips (largest gap "
                     f"{float(gaps.max()):.3e} |x|, tie limit {REF_TIE_TOL} |x|)")
    else:
        max_flips = K2_MAX_FLIP_SHARE
        ulps = bf16_ulp_diff(out[:, same], ref[:, same]) if same.any() else 0
        value_ok = ulps <= 1
        line = f"{tag} {mode}: flipped={flipped:.3e} max|err|={err:.3e} ulps(same idx)={ulps}"
    if mode in ("separated", "ties"):
        if flipped != 0.0 or not value_ok:
            raise AssertionError(f"{line}: indices must agree, values within the limit")
        if mode == "ties" and bool(((idx % 2) | (idx >= idx.shape[-1] // 2)).any()):
            raise AssertionError(f"{line}: a tie resolved to a later row")
    elif counted > max_flips or not value_ok:
        raise AssertionError(f"{line}: above {max_flips} flipped (near ties aside) "
                             "or values off")
    return line, flipped, err


def _stage_times(launch, tm, args) -> dict:
    """Median times (CUDA events around each launch) of one launch of the
    kernel alone, of the same launch with no output (the match stage: the
    indices only), and their difference, the gather + blend epilogue.
    ``launch(ops, idx, out)`` is K2's or K3's launcher."""
    ops = tm.prepare_operands("stage timing", *args)
    f, s, d = ops[0].shape
    idx = torch.empty((2, f, s), dtype=torch.int32, device="cuda")
    out = torch.empty((ops[2].shape[0], f, s, d), dtype=ops[2].dtype, device="cuda")
    kernel_ms = median_ms(lambda: launch(ops, idx, out))
    match_ms = median_ms(lambda: launch(ops, idx, None))
    return {"kernel_ms": kernel_ms, "match_ms": match_ms,
            "gather_ms": kernel_ms - match_ms}


def _k3_launch(ops, idx, out):
    from tokenflow_torch.kernels import token_match as tm

    tm.launch(ops, idx, out, split=True)


def _match_row(tag, kernel, plain, launch, args, mode, f, s, d, k, extra=None):
    """One token-match row: the kernel against its plain version (raises past
    the tolerances of ``mode``), the pair's, the stages' and the plain
    version's times, and the bounds. ``kernel`` and ``plain`` return (out,
    (2, F, S) indices)."""
    from tokenflow_torch.kernels import token_match as tm

    out, idx = kernel(*args)
    ref, ref_idx = plain(*args)
    torch.cuda.synchronize()
    dtype, ns = args[2].dtype, args[2].shape[0]
    line, flipped, err = _match_verdict(
        f"{tag} F={f} K={k} ns={ns} S={s} D={d}", mode, idx, ref_idx.long(), out, ref,
        kf_max=float(args[2].abs().max()), inputs=(args[0], args[1], args[3], args[4]),
    )
    if extra is not None:
        line += extra(out, idx)
    ms = median_ms(lambda: kernel(*args))
    stages = _stage_times(launch, tm, args)
    plain_ms = median_ms(lambda: plain(*args), runs=5)
    bound_ms, bound_by = _match_bound(f, s, d, k, ns, dtype)
    stage_bounds = _stage_bounds(f, s, d, k, ns, dtype)
    split = {}
    if dtype == torch.float32:
        split = {"bound_ffma_ms": ffma_bound_ms(
            4.0 * d * s * (f + k + ns * (k + f)), 4.0 * f * s * s * d)}
    print(f"{line} wrapper {ms:.3f} ms, kernel {stages['kernel_ms']:.3f} (match "
          f"{stages['match_ms']:.3f}, gather {stages['gather_ms']:.3f}), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"(match {stage_bounds['match_bound_ms']:.3f}, gather "
          f"{stage_bounds['gather_bound_ms']:.3f}; {PEAKS[dtype][1]})"
          + (f", bound {split['bound_ffma_ms']:.3f} ms ({FFMA[1]})" if split else ""),
          flush=True)
    return {"shape": [f, s, d], "k": k, "ns": ns, "mode": mode,
            "dtype": str(dtype).split(".")[-1],
            "flipped": flipped, "max_abs_err": err, "ms": ms, **stages,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_peak": PEAKS[dtype][1], **split, **stage_bounds}


def _k2_kernel(*args):
    from tokenflow_torch.kernels import token_match as tm

    return tm.token_match_gather_kernel(*args, return_indices=True)


def _k2_plain(*args):
    from tokenflow_torch.kernels import token_match as tm

    return tm.token_match_gather_plain(*args, return_indices=True)


def _k3_kernel(*args):
    from tokenflow_torch.kernels import token_match_split as tms

    out, ia, ib = tms.token_match_gather_split_kernel(*args, return_indices=True)
    if ia.shape != (args[0].shape[0], 1, args[0].shape[1]) or ia.dtype != torch.int32:
        raise AssertionError(f"K3 indices {tuple(ia.shape)} {ia.dtype}")
    return out, torch.stack([ia[:, 0], ib[:, 0]])


def _k3_plain(*args):
    from tokenflow_torch.kernels import token_match_split as tms

    ref, ref_ia, ref_ib = tms.token_match_gather_split_plain(*args, return_indices=True)
    return ref, torch.stack([ref_ia[:, 0], ref_ib[:, 0]])


def _k2_equal(args):
    """K3's rows' extra check: K2 on the same inputs, bitwise equal."""
    def extra(out, idx):
        k2_out, k2_idx = _k2_kernel(*args)
        if not (torch.equal(k2_idx, idx) and torch.equal(k2_out, out)):
            raise AssertionError("K3 and K2 disagree")
        return ", K2 bitwise equal"
    return extra


def _match_entry(name: str, source: str, replaces: str, rows: list) -> dict:
    """A token-match kernel's entry of the kernels line: the first row's
    times, the worst error outside the random rows."""
    main = rows[0]
    ns2 = [r for r in rows if r["ns"] == 2]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["mode"] != "random"),
        "ns2": [{key: r.get(key) for key in
                 ("shape", "k", "mode", "view", "copied", "flipped", "ms", "kernel_ms",
                  "plain_ms", "bound_ms", "bound_by", "own_table_ms")} for r in ns2],
        **{key: main[key] for key in
           ("ms", "kernel_ms", "match_ms", "gather_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_peak")},
        "library_ms": None,
        "library": NO_LIBRARY_CALL,
        "shapes": rows,
    }


def _ns2_k2_rows(gen: torch.Generator, dtype: torch.dtype) -> list:
    """K2 at two streams (NS2_K2_SHAPES, separated and random inputs) and on
    the PnP approximate pass's ``kf_attn[1:]`` view of a three-stream table,
    in ``dtype``."""
    from tokenflow_torch.kernels import token_match as tm
    from tokenflow_torch.kernels import token_match_split as tms

    s, d = NS2_K2_SHAPES[1][:2]
    if tms.use_split(s, d, 2) or not tms.use_split(s, d, 3):
        raise AssertionError(f"(S, D) = ({s}, {d}) must be K2's at ns = 2 and K3's at 3")
    tag = "[K2 ns=2]" if dtype == torch.bfloat16 else "[K2 fp32 ns=2]"
    rows = []
    for s, d, f, k in NS2_K2_SHAPES:
        for mode in NS2_MODES:
            args = _match_inputs(gen, s, d, mode, f, k, ns=2, dtype=dtype)
            rows.append(_match_row(tag, _k2_kernel, _k2_plain, tm.launch, args, mode,
                                   f, s, d, k))
            del args
            torch.cuda.empty_cache()
    return rows + _kf_view_rows(gen, dtype)


def _kf_view_rows(gen: torch.Generator, dtype: torch.dtype) -> list:
    """K2 on ``kf_attn[1:]`` of a three-stream table, the slice the PnP
    approximate pass gathers from, in two storage orders: stream-major (the
    port's cache: a contiguous slice at an aligned offset, which the wrapper
    passes as it is) and frame-major (strided: ``tma_operand`` clones it).
    Beside each, the wrapper's time on the same values as a table of their
    own."""
    from tokenflow_torch.kernels import token_match as tm
    from tokenflow_torch.kernels._operands import tma_operand

    s, d, f, k = NS2_VIEW_SHAPE
    x, p_hat, kf3, pa, pb, w1 = _match_inputs(gen, s, d, "separated", f, k, ns=3,
                                              dtype=dtype)
    rows = []
    for layout in ("stream-major", "frame-major"):
        table = kf3 if layout == "stream-major" else (
            kf3.transpose(0, 1).contiguous().transpose(0, 1))
        view = table[1:]
        args = (x, p_hat, view, pa, pb, w1)
        tag = f"[K2{'' if dtype == torch.bfloat16 else ' fp32'} kf_attn[1:] {layout}]"
        row = _match_row(tag, _k2_kernel, _k2_plain, tm.launch, args, "separated",
                         f, s, d, k)
        own = view.clone()
        row.update(view=layout, copied=tma_operand(view, contiguous=True) is not view,
                   own_table_ms=median_ms(
                       lambda: tm.token_match_gather_kernel(x, p_hat, own, pa, pb, w1)))
        print(f"{tag} the wrapper {'copies' if row['copied'] else 'passes'} the view: "
              f"{row['ms']:.3f} ms, on a table of its own {row['own_table_ms']:.3f} ms",
              flush=True)
        rows.append(row)
        del table, view, own
        torch.cuda.empty_cache()
    return rows


def _ns2_k3_rows(gen: torch.Generator, dtype: torch.dtype) -> list:
    """K3 at two streams at the 768p top level (NS2_K3_SHAPE), separated and
    random inputs, in ``dtype``; bitwise equal to K2."""
    s, d, f, k = NS2_K3_SHAPE
    tag = "[K3 ns=2]" if dtype == torch.bfloat16 else "[K3 fp32 ns=2]"
    rows = []
    for mode in NS2_MODES:
        args = _match_inputs(gen, s, d, mode, f, k, ns=2, dtype=dtype)
        rows.append(_match_row(tag, _k3_kernel, _k3_plain, _k3_launch, args, mode, f, s, d,
                               k, extra=_k2_equal(args)))
        del args
        torch.cuda.empty_cache()
    return rows


def check_token_match(gen: torch.Generator) -> dict:
    from tokenflow_torch.kernels import token_match as tm

    cases = [(row, "separated") for row in K2_SHAPES]
    cases += [(row, "random") for row in K2_SHAPES]
    cases += [(K2_SHAPES[0], "ties"), (K2_NEGATIVE, "negative")]
    rows = []
    for (s, d, f, k), mode in cases:
        args = _match_inputs(gen, s, d, mode, f, k)
        rows.append(_match_row("[K2]", _k2_kernel, _k2_plain, tm.launch, args, mode, f, s,
                               d, k))
        del args
        torch.cuda.empty_cache()
    rows += _ns2_k2_rows(gen, torch.bfloat16)
    return _match_entry("token_match_gather", "tokenflow_torch/csrc/token_match.cu",
                        "tokenflow_tpu/kernels/token_match.py:105", rows)


def check_token_match_split(gen: torch.Generator) -> dict:
    """K3 at the 768p top level, in one launch of three chunks and in the
    path's per-chunk launch, and at the ragged all-negative row, against its
    plain version with K2's tolerances; its indices and output must also
    equal K2's bit for bit (the two entry points launch one match core).
    Then K2 against K3 on the same inputs across S."""
    from tokenflow_torch.kernels import token_match_split as tms

    if not tms.use_split(K3_S, K3_D, K3_NS):
        raise AssertionError(f"(S, D) = ({K3_S}, {K3_D}) is not a K3 site")
    cases = [(K3_S, K3_D, K3_F, mode) for mode in ("separated", "random", "ties")]
    cases += [(K3_S, K3_D, K3_CHUNK_F, mode) for mode in ("separated", "random")]
    cases += [(K2_NEGATIVE[0], K2_NEGATIVE[1], K2_NEGATIVE[2], "negative")]
    rows = []
    for s, d, f, mode in cases:
        args = _match_inputs(gen, s, d, mode, f, K3_K, K3_NS)
        rows.append(_match_row("[K3]", _k3_kernel, _k3_plain, _k3_launch, args, mode,
                               f, s, d, K3_K, extra=_k2_equal(args)))
        del args
        torch.cuda.empty_cache()
    rows += _ns2_k3_rows(gen, torch.bfloat16)
    entry = _match_entry("token_match_gather_split", "tokenflow_torch/csrc/token_match_split.cu",
                         "tokenflow_tpu/kernels/token_match_split.py:123", rows)
    entry["k2_vs_k3"] = sweep_k2_k3(gen)
    return entry


def check_token_match_f32(gen: torch.Generator) -> tuple[dict, dict]:
    """The fp32 match core through both wrappers against their plain
    versions in fp32 (TF32 off). K2 at F=40, 4096x320 (the PnP 512^2 top
    level) on the separated, duplicated-row, random and all-negative
    inputs, at every other K2_SHAPES site on the separated and random ones,
    and at the ragged all-negative row (K2_NEGATIVE). K3 at F=24,
    9216x320 (the 768p top level) in the four modes, at the path's
    per-chunk F on the separated and random ones and at the ragged row; its
    indices and output must also equal K2's bit for bit. Returns both
    entries."""
    from tokenflow_torch.kernels import token_match as tm

    modes = ("separated", "ties", "random", "negative")
    k2_cases = [(K2_F32, mode) for mode in modes]
    k2_cases += [(row, mode) for row in K2_SHAPES if row != K2_F32
                 for mode in ("separated", "random")]
    k2_cases += [(K2_NEGATIVE, "negative")]
    k3_chunk = (K3_S, K3_D, K3_CHUNK_F, K3_K)
    k3_cases = [(K3_F32, mode) for mode in modes]
    k3_cases += [(k3_chunk, mode) for mode in ("separated", "random")]
    k3_cases += [(K2_NEGATIVE, "negative")]
    entries = []
    for name, replaces, cases, kernel, plain, launch, tag in (
        ("token_match_f32", "tokenflow_tpu/kernels/token_match.py:105", k2_cases,
         _k2_kernel, _k2_plain, tm.launch, "[K2 fp32]"),
        ("token_match_split_f32", "tokenflow_tpu/kernels/token_match_split.py:123",
         k3_cases, _k3_kernel, _k3_plain, _k3_launch, "[K3 fp32]"),
    ):
        rows = []
        for (s, d, f, k), mode in cases:
            args = _match_inputs(gen, s, d, mode, f, k, dtype=torch.float32)
            extra = _k2_equal(args) if kernel is _k3_kernel else None
            rows.append(_match_row(tag, kernel, plain, launch, args, mode, f, s, d, k,
                                   extra=extra))
            del args
            torch.cuda.empty_cache()
        rows += (_ns2_k3_rows if kernel is _k3_kernel else _ns2_k2_rows)(gen, torch.float32)
        entry = _match_entry(name, "tokenflow_torch/csrc/token_match_f32.cu", replaces, rows)
        entry["bound_ffma_ms"] = rows[0]["bound_ffma_ms"]
        entries.append(entry)
    return tuple(entries)


def sweep_k2_k3(gen: torch.Generator) -> list:
    """K2 and K3 on the same separated inputs, one 8-frame chunk at D =
    320 across S: the pairs' and the match stages' times (data for the
    K2/K3 dispatch rule), outputs bitwise equal."""
    from tokenflow_torch.kernels import token_match as tm
    from tokenflow_torch.kernels import token_match_split as tms

    rows = []
    for s, d in K2_K3_SWEEP:
        args = _match_inputs(gen, s, d, "separated", K3_CHUNK_F, K3_K, K3_NS)
        k2_out = tm.token_match_gather_kernel(*args)
        k3_out = tms.token_match_gather_split_kernel(*args)
        if not torch.equal(k2_out, k3_out):
            raise AssertionError(f"K2 and K3 disagree at S={s} D={d}")
        row = {
            "shape": [K3_CHUNK_F, s, d],
            "k2_ms": median_ms(lambda: tm.token_match_gather_kernel(*args)),
            "k3_ms": median_ms(lambda: tms.token_match_gather_split_kernel(*args)),
            "k2_match_ms": _stage_times(tm.launch, tm, args)["match_ms"],
            "k3_match_ms": _stage_times(_k3_launch, tm, args)["match_ms"],
            "use_split": tms.use_split(s, d, K3_NS),
            "bound_ms": _match_bound(K3_CHUNK_F, s, d, K3_K, K3_NS)[0],
        }
        print(f"[K2 vs K3] F={K3_CHUNK_F} S={s} D={d}: K2 {row['k2_ms']:.3f} ms (match "
              f"{row['k2_match_ms']:.3f}), K3 {row['k3_ms']:.3f} ms (match "
              f"{row['k3_match_ms']:.3f}), bound {row['bound_ms']:.3f} ms, use_split "
              f"{row['use_split']}", flush=True)
        rows.append(row)
        del args, k2_out, k3_out
        torch.cuda.empty_cache()
    return rows


def gn_inputs(gen: torch.Generator, shape, dtype=torch.bfloat16):
    """Seeded K4 inputs: x with a mean offset, weights around 1."""
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3).to(dtype)
    w = (1 + 0.5 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)
    b = (0.5 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)
    return x, w, b


def gn_verdict(tag: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """K4's output against its plain version: finite, and in bf16 at most
    GN_MAX_ULPS steps at max(|ref|, GN_ULP_FLOOR), in fp32 within rtol =
    atol = GN_F32_TOL. Raises AssertionError past them; returns the errors
    and a report line."""
    o, r = out.float(), ref.float()
    err = float((o - r).abs().max())
    finite = bool(torch.isfinite(o).all())
    if out.dtype == torch.bfloat16:
        ulps = bf16_ulps_floored(out, ref)
        line = f"{tag}: max|err|={err:.3e} ulps={ulps:.3f}"
        if not (finite and ulps <= GN_MAX_ULPS):
            raise AssertionError(f"{line}: above {GN_MAX_ULPS} bf16 steps")
        return {"max_abs_err": err, "ulps": ulps, "line": line}
    excess = float(((o - r).abs() - GN_F32_TOL * r.abs()).max())
    line = f"{tag}: max|err|={err:.3e} (fp32)"
    if not (finite and excess <= GN_F32_TOL):
        raise AssertionError(f"{line}: above rtol = atol = {GN_F32_TOL}")
    return {"max_abs_err": err, "ulps": None, "line": line}


def _gn_row(gn, x, w, b, act, eps) -> dict:
    """One K4 row: the verdict, two launches bitwise equal, the plan and its
    occupancy, the wrapper's time, one launch's device time, the plain
    version's and F.group_norm's (without SiLU; the port never calls it),
    the kernels' own time by the profiler's records, and the one-read,
    one-write bound."""
    shape = tuple(x.shape)
    tag = f"[K4] {shape} {str(x.dtype).split('.')[-1]} act={act} eps={eps}"
    out = gn.group_norm_kernel(x, w, b, 32, eps, act)
    again = gn.group_norm_kernel(x, w, b, 32, eps, act)
    ref = gn.group_norm_plain(x, w, b, 32, eps, act)
    torch.cuda.synchronize()
    v = gn_verdict(tag, out, ref)
    if not torch.equal(out, again):
        raise AssertionError(f"{tag}: two launches on the same input differ")
    del out, again, ref
    c = shape[1]
    p = gn.plan(shape[0], c, x.numel() // (shape[0] * c), 32, x.dtype)
    ops = gn.prepare_operands(x, w, b, 32, act)
    out, part = torch.empty_like(x), gn.scratch(x, 32, p)
    kernel_ms = device_ms(lambda: gn.launch(ops, out, part, 32, eps, act, p))
    trace_ms = kernel_trace_ms(lambda: gn.launch(ops, out, part, 32, eps, act, p), "gn_")
    ms = median_ms(lambda: gn.group_norm_kernel(x, w, b, 32, eps, act))
    plain_ms = median_ms(lambda: gn.group_norm_plain(x, w, b, 32, eps, act), runs=5)
    library_ms = None if act else median_ms(
        lambda: torch.nn.functional.group_norm(x, 32, w, b, eps)
    )
    per_sm, clusters = (
        gn.occupancy(x, 32, act, p) if p.variant == "cluster" else (None, None)
    )
    bound_ms, bound_by = bound(2.0 * x.element_size() * x.numel(), 0.0)
    lib = "-" if library_ms is None else f"{library_ms:.3f} ms"
    print(f"{v['line']}, {p.variant} cluster {p.cluster} slice {p.slice} "
          f"({per_sm} CTAs/SM, {clusters} clusters), two launches bitwise equal: "
          f"wrapper {ms:.3f} ms, kernel {kernel_ms:.4f} ms "
          f"({bound_ms / kernel_ms:.0%} of the bound; by the profiler's kernel records "
          f"{trace_ms:.4f} ms, {bound_ms / trace_ms:.0%}), plain {plain_ms:.3f} ms, "
          f"F.group_norm {lib}, bound {bound_ms:.4f} ms", flush=True)
    return {"shape": list(shape), "dtype": str(x.dtype).split(".")[-1], "act": act,
            "ulps": v["ulps"], "max_abs_err": v["max_abs_err"], "bitwise_repeat": True,
            "variant": p.variant, "cluster": p.cluster, "slice": p.slice,
            "ctas_per_sm": per_sm, "clusters": clusters, "ms": ms, "kernel_ms": kernel_ms,
            "trace_ms": trace_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / kernel_ms}


def check_group_norm(gen: torch.Generator) -> dict:
    """K4 against its plain version at both paths' GroupNorm shapes, SiLU on
    (resnet norms, eps 1e-5) and off (transformer norms, eps 1e-6), bf16
    and one fp32 shape; per row the plan, the wrapper's and one launch's
    times and a repeat launch that must match bit for bit."""
    from tokenflow_torch.kernels import group_norm as gn

    cases = [(shape, torch.bfloat16) for shape in GN_SHAPES]
    cases += [(shape, torch.float32) for shape in GN_F32_SHAPES]
    rows = []
    for shape, dtype in cases:
        x, w, b = gn_inputs(gen, shape, dtype)
        for act, eps in (("silu", 1e-5), (None, 1e-6)):
            rows.append(_gn_row(gn, x, w, b, act, eps))
        del x, w, b
        torch.cuda.empty_cache()
    main = rows[1]  # the first shape without SiLU, which F.group_norm computes
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    return {
        "name": "group_norm",
        "route": "cuda",
        "source": "tokenflow_torch/csrc/group_norm.cu",
        "replaces": "tokenflow_tpu/kernels/group_norm.py:170",
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        "max_ulps": max(r["ulps"] for r in bf16),
        "f32_max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        "main": {"shape": main["shape"], "act": main["act"]},
        **{key: main[key] for key in
           ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shapes": rows,
    }


def check_layer_norm(gen: torch.Generator) -> dict:
    """K5 against its plain version at LN_SHAPES (bf16, eps 1e-5): per row
    the plan and grid, at most LN_MAX_ULPS bf16 steps, two launches bit for
    bit, the wrapper's time, one launch's device time by CUDA events and by
    the profiler's kernel record, each with its share of the one-read,
    one-write bound, and the time of the path K5 replaced (F.layer_norm on
    an fp32 copy, cast back)."""
    from tokenflow_torch.kernels import layer_norm as ln

    rows = []
    for n, c in LN_SHAPES:
        x, w, b = gn_inputs(gen, (n, c))
        tag = f"[K5] ({n}, {c})"
        out = ln.layer_norm_kernel(x, w, b, 1e-5)
        again = ln.layer_norm_kernel(x, w, b, 1e-5)
        ref = ln.layer_norm_plain(x, w, b, 1e-5)
        torch.cuda.synchronize()
        ulps = bf16_ulps_floored(out, ref)
        err = float((out.float() - ref.float()).abs().max())
        if not (bool(torch.isfinite(out.float()).all()) and ulps <= LN_MAX_ULPS):
            raise AssertionError(f"{tag}: {ulps} bf16 steps from the plain version")
        if not torch.equal(out, again):
            raise AssertionError(f"{tag}: two launches on the same input differ")
        del out, again, ref
        p = ln.plan(c)
        grid = ln.grid(n, p)
        ops = ln.prepare_operands(x, w, b)
        out = torch.empty_like(x)
        kernel_ms = device_ms(lambda: ln.launch(ops, out, 1e-5, p))
        trace_ms = kernel_trace_ms(lambda: ln.launch(ops, out, 1e-5, p), "layer_norm")
        ms = median_ms(lambda: ln.layer_norm_kernel(x, w, b, 1e-5))
        replaced_ms = device_ms(lambda: torch.nn.functional.layer_norm(
            x.float(), (c,), w.float(), b.float(), 1e-5).to(x.dtype))
        bound_ms, bound_by = bound(2.0 * x.element_size() * x.numel(), 0.0)
        print(f"{tag}: max|err|={err:.3e} ulps={ulps:.3f}, plan {p.lanes} lanes x {p.vecs} "
              f"vectors, grid {grid}, two launches bitwise equal: "
              f"wrapper {ms:.4f} ms, kernel {kernel_ms:.4f} ms ({bound_ms / kernel_ms:.0%} of "
              f"the bound; by the profiler's kernel record {trace_ms:.4f} ms, "
              f"{bound_ms / trace_ms:.0%}), replaced path {replaced_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms", flush=True)
        rows.append({"shape": [n, c], "ulps": ulps, "max_abs_err": err, "bitwise_repeat": True,
                     "lanes": p.lanes, "vecs": p.vecs, "grid": grid,
                     "ms": ms, "kernel_ms": kernel_ms, "trace_ms": trace_ms,
                     "replaced_ms": replaced_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / kernel_ms,
                     "trace_bound_share": bound_ms / trace_ms})
        del x, w, b, out, ops
        torch.cuda.empty_cache()
    main = rows[0]
    return {
        "name": "layer_norm",
        "route": "cuda",
        "source": "tokenflow_torch/csrc/layer_norm.cu",
        "replaces": "F.layer_norm on an fp32 copy (no TPU kernel)",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_ulps": max(r["ulps"] for r in rows),
        "main": {"shape": main["shape"]},
        **{key: main[key] for key in ("ms", "kernel_ms", "replaced_ms", "bound_ms", "bound_by")},
        "shapes": rows,
    }


def _geglu_rows_f32(x, w, b, rows: int = 1 << 16):
    """The plain version in fp32 on fp32 copies of bf16 x, w and b, row
    slice by row slice (the full fp32 projection would take 10 GB)."""
    from tokenflow_torch.kernels.geglu import geglu_plain

    wf, bf = w.float(), b.float()
    for i in range(0, x.shape[0], rows):
        yield i, geglu_plain(x[i:i + rows].float(), wf, bf)


def _sdp_f32_sliced(q, k, v, rows: int = 1 << 28) -> torch.Tensor:
    """sdp_attention on fp32 copies of bf16 q, k, v (B, S, H, D), one
    (batch, head) slice of its logits at a time under ``rows`` elements."""
    from tokenflow_torch.ops.attention import sdp_attention

    b, sq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    per = max(1, rows // (sq * k.shape[1]))
    for i in range(b):
        for h0 in range(0, h, per):
            hs = slice(h0, h0 + per)
            out[i : i + 1, :, hs] = sdp_attention(q[i : i + 1, :, hs].float(),
                                                  k[i : i + 1, :, hs].float(),
                                                  v[i : i + 1, :, hs].float())
    return out


def _dit_attention_row(kernel, plan, b, sq, skv, h, d, gen) -> dict:
    """One D = 88 attention row: the kernel against sdp_attention in fp32
    (K1's limits), two launches bit for bit, the device time and the share
    of the bound."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, k, v = randn(b, sq, h, d), randn(b, skv, h, d), randn(b, skv, h, d)
    out, again = kernel(q, k, v), kernel(q, k, v)
    ref = _sdp_f32_sliced(q, k, v)
    torch.cuda.synchronize()
    m = k1_mismatch(out, ref)
    bitwise = torch.equal(out, again)
    tag = f"B={b} Sq={sq} Skv={skv} H={h} D={d}"
    del out, again, ref
    if not (k1_within_limits(m) and bitwise):
        raise AssertionError(f"{tag}: {m}, two launches bitwise equal: {bitwise}")
    dev_ms = device_ms(lambda: kernel(q, k, v))
    flops = 4.0 * b * h * sq * skv * d
    bound_ms, bound_by = bound(2 * d * b * h * (2 * sq + 2 * skv), flops)
    print(f"{tag}: plan {plan}, max|err|={m['max_abs_err']:.3e} (limit "
          f"{m['max_abs_limit']:.3e}) rel L2 {m['rel_l2']:.3e} against sdp_attention in fp32, "
          f"two launches bitwise equal; {dev_ms:.4f} ms device, bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / dev_ms:.1%} of it", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": [b, sq, skv, h, d], "plan": plan, **m, "device_ms": dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share_device": bound_ms / dev_ms}


def check_dit_kernels(gen: torch.Generator) -> dict:
    """What HunyuanDiT v1.2 adds to the kernels: K1 and K6 at D = 88
    (DIT_K1_SHAPES, DIT_K6_SHAPES) against sdp_attention in fp32; K3 and K2
    at DIT_MATCH, 1408 wide, in the separated and random modes against the
    plain version (fp32 products of the bf16 tables), every flip a near tie
    (``flip_gaps`` within REF_TIE_TOL |x|), K3 bitwise equal to K2; K5 at
    DIT_LN_SHAPES (88, 1408, 2816) against its plain version (LN_MAX_ULPS),
    two launches bit for bit; K5's rotary entry at DIT_ROPE_SHAPES
    (``_dit_rope_row``). Each row prints its plan and its device time
    against the bound."""
    from tokenflow_torch.kernels import flash_attention as fa
    from tokenflow_torch.kernels import layer_norm as ln
    from tokenflow_torch.kernels import short_attention as sa
    from tokenflow_torch.kernels import token_match as tm

    out = {"k1": [], "k6": [], "match": [], "k5": []}
    for b, sq, skv, h, d in DIT_K1_SHAPES:
        plan, waves = k1_plan(b, sq, h, d)
        print(f"[K1 D=88] waves {waves:.2f}", end=" ", flush=True)
        out["k1"].append(_dit_attention_row(fa.flash_attention_kernel, plan, b, sq, skv, h, d,
                                            gen))
    for b, sq, skv, h, d in DIT_K6_SHAPES:
        print("[K6 D=88]", end=" ", flush=True)
        out["k6"].append(_dit_attention_row(sa.short_attention_kernel, sa.plan(skv), b, sq,
                                            skv, h, d, gen))
    s, d, f, k = DIT_MATCH
    for mode in ("separated", "random"):
        args = _match_inputs(gen, s, d, mode, f, k)

        def near_ties(o, idx, args=args):
            ref, ref_idx = _k3_plain(*args)
            gaps = flip_gaps(args[0], args[1], args[3], args[4], idx, ref_idx)
            if gaps.numel() and float(gaps.max()) > REF_TIE_TOL:
                raise AssertionError(f"a flip {float(gaps.max()):.3e} |x| from a tie")
            line = _k2_equal(args)(o, idx)
            return line + f", {gaps.numel()} flips, each a near tie"

        out["match"].append(_match_row("[K3 D=1408]", _k3_kernel, _k3_plain, _k3_launch, args,
                                       mode, f, s, d, k, extra=near_ties))
        del args
        torch.cuda.empty_cache()
    for n, c in DIT_LN_SHAPES:
        x, w, b = gn_inputs(gen, (n, c))
        got, again = ln.layer_norm_kernel(x, w, b, 1e-6), ln.layer_norm_kernel(x, w, b, 1e-6)
        ref = ln.layer_norm_plain(x, w, b, 1e-6)
        torch.cuda.synchronize()
        ulps = bf16_ulps_floored(got, ref)
        if not (bool(torch.isfinite(got.float()).all()) and ulps <= LN_MAX_ULPS
                and torch.equal(got, again)):
            raise AssertionError(f"[K5] ({n}, {c}): {ulps} bf16 steps, or launches differ")
        del got, again, ref
        p = ln.plan(c)
        kernel_ms = device_ms(lambda: ln.layer_norm_kernel(x, w, b, 1e-6))
        bound_ms, _ = bound(2.0 * x.element_size() * x.numel(), 0.0)
        print(f"[K5] ({n}, {c}): ulps={ulps:.3f}, plan {p.lanes} lanes x {p.vecs} vectors, "
              f"two launches bitwise equal; {kernel_ms:.4f} ms device, bound {bound_ms:.4f} "
              f"ms, {bound_ms / kernel_ms:.0%} of it", flush=True)
        out["k5"].append({"shape": [n, c], "ulps": ulps, "lanes": p.lanes, "vecs": p.vecs,
                          "device_ms": kernel_ms, "bound_ms": bound_ms,
                          "bound_share": bound_ms / kernel_ms})
        del x, w, b
        torch.cuda.empty_cache()
    out["k5_rope"] = [_dit_rope_row(tokens, h, d, gen) for tokens, h, d in DIT_ROPE_SHAPES]
    return {"name": "dit_kernels", **out}


def _dit_rope_row(tokens: int, h: int, d: int, gen: torch.Generator) -> dict:
    """K5's rotary entry on (tokens / 4096, 4096, h, d) bf16 with the DiT's
    64 x 64 RoPE tables: within LN_MAX_ULPS bf16 steps of the two launches
    it replaces (K5, then ``apply_rope`` in fp32) and the share of elements
    that differ; the steps from the all-plain version (``layer_norm_rope_plain``:
    K5's own one-step differences, carried through the rotation); two
    launches bit for bit; device time against the 4-byte-an-element bound,
    and the two launches' device time."""
    from tokenflow_torch.kernels import layer_norm as ln
    from tokenflow_torch.models.hunyuan_dit import apply_rope, rope_tables

    s = DIT_ROPE_GRID * DIT_ROPE_GRID
    x, w, b = gn_inputs(gen, (tokens * h, d))
    x = x.reshape(tokens // s, s, h, d)
    cos, sin = rope_tables(d, DIT_ROPE_GRID, DIT_ROPE_GRID, 32, "cuda")
    tag = f"[K5 rope] ({tokens}, {h}, {d})"
    got = ln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin)
    again = ln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin)
    two = apply_rope(ln.layer_norm_kernel(x, w, b, 1e-6), cos, sin)
    torch.cuda.synchronize()
    ulps = bf16_ulps_floored(got, two)
    differ = float((got != two).float().mean())
    bitwise = torch.equal(got, again)
    del again, two
    plain_ulps = max(bf16_ulps_floored(got[i:i + 8], ln.layer_norm_rope_plain(
        x[i:i + 8], w, b, 1e-6, cos, sin)) for i in range(0, x.shape[0], 8))
    if not (bool(torch.isfinite(got.float()).all()) and ulps <= LN_MAX_ULPS and bitwise):
        raise AssertionError(f"{tag}: {ulps} bf16 steps from K5 + apply_rope, two launches "
                             f"bitwise equal: {bitwise}")
    del got
    p = ln.rope_plan(d)
    kernel_ms = device_ms(lambda: ln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin))
    trace_ms = kernel_trace_ms(lambda: ln.layer_norm_rope_kernel(x, w, b, 1e-6, cos, sin),
                               "layer_norm_rope")
    two_ms = device_ms(lambda: apply_rope(ln.layer_norm_kernel(x, w, b, 1e-6), cos, sin))
    bound_ms, _ = bound(2.0 * x.element_size() * x.numel(), 0.0)
    print(f"{tag}: {ulps:.3f} bf16 steps from K5 + apply_rope ({differ:.3e} of elements "
          f"differ), {plain_ulps:.3f} from the all-plain version, plan {p.lanes} lanes x "
          f"{p.vecs} vectors, two launches bitwise equal; {kernel_ms:.4f} ms device "
          f"({bound_ms / kernel_ms:.1%} of the bound; by the profiler's kernel record "
          f"{trace_ms:.4f} ms, {bound_ms / trace_ms:.1%}), bound {bound_ms:.4f} ms; K5 + "
          f"apply_rope {two_ms:.4f} ms", flush=True)
    del x, w, b
    torch.cuda.empty_cache()
    return {"shape": [tokens, h, d], "ulps": ulps, "differ_share": differ,
            "plain_ulps": plain_ulps, "lanes": p.lanes, "vecs": p.vecs, "device_ms": kernel_ms,
            "trace_ms": trace_ms, "two_launch_ms": two_ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / kernel_ms}


def check_dit_cell(seed: int = 2147483901, steps: int = 2) -> dict:
    """The benchmark cell ``hunyuandit_sdedit1024_edit``'s program, set up
    and warmed as ``scripts/bench_sites.py`` makes it (a benchmark run's
    set-up), for ``steps`` steps with the
    launch counts zeroed: K1, K6, K3 (and no K2) and K5 launches a step
    against the yardstick's (``architectures/hunyuan_dit.py::step_ops``:
    K1 and K6 calls, matches), K5's rotary and plain launches a step
    (DIT_ROPE_PER_STEP, DIT_K5_PER_STEP), the edit sites visited (40 a
    model call), the pivotal cache bytes a step and no CUDA attention call
    or q/k rotation off the kernels (``plain_on_cuda``,
    ``plain_rope_on_cuda``)."""
    sys.path[:0] = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")]
    import bench_sites
    import manifest
    import yardstick as Y

    from tokenflow_torch.models import hunyuan_dit
    from tokenflow_torch.ops import attention, editctx

    cell = manifest.cell("hunyuandit_sdedit1024_edit")
    spec, _ = cell.arch.specs(cell.config)
    stage = bench_sites.stage_for(cell, seed, manifest.HERE, torch.device("cuda"))
    torch.cuda.synchronize()
    zero_counts()
    attention.plain_on_cuda = hunyuan_dit.plain_rope_on_cuda = 0
    sites0, cache0 = editctx.sites_visited, editctx.pivotal_cache_bytes
    for i in range(steps):
        stage.step(i, check=False)
    torch.cuda.synchronize()
    launches = read_counts()
    counts = {k: v / steps for k, v in launches.items() if v}
    ops = cell.arch.step_ops(cell.stage, spec, None, cell.traffic)
    due = {"flash_attention": sum(isinstance(o, Y.Attn) and o.k1 for o in ops),
           "short_attention": sum(isinstance(o, Y.Attn) and not o.k1 for o in ops),
           "token_match_gather_split": sum(isinstance(o, Y.Match) for o in ops),
           "layer_norm_rope": DIT_ROPE_PER_STEP, "layer_norm": DIT_K5_PER_STEP}
    sites = (editctx.sites_visited - sites0) / steps
    cache = (editctx.pivotal_cache_bytes - cache0) / steps
    print(f"[dit cell] launches a step {counts}, due {due}; sites visited a step {sites} "
          f"(2 model calls x 40), pivotal cache {cache / 1e9:.3f} GB a step, plain_on_cuda "
          f"{attention.plain_on_cuda}, plain rotations {hunyuan_dit.plain_rope_on_cuda}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    bad = [k for k, v in due.items() if counts.get(k, 0) != v]
    if (bad or counts.get("token_match_gather") or sites != 80 or attention.plain_on_cuda
            or hunyuan_dit.plain_rope_on_cuda):
        raise AssertionError(f"[dit cell] launches {counts} against {due}, sites {sites}")
    stage.release()
    return {"launches": launches, "launches_per_step": counts, "due": due,
            "sites_per_step": sites, "pivotal_cache_bytes_per_step": cache}


def check_geglu(gen: torch.Generator) -> dict:
    """K7 against its plain version in fp32 (TF32 off) at K7_SHAPES (at
    most K7_MAX_ULPS bf16 steps, ``bf16_ulps_floored``, and the relative
    L2), two launches bit for bit; per row the plan, one launch's device
    time by CUDA events and by the profiler's kernel record, the bound
    (flops at 989 TFLOP/s or x + W + out bytes at 3.35 TB/s), the replaced
    bf16 path (``geglu_plain``: F.linear, F.gelu and the product, the
    library yardstick) and ``F.linear``'s projection alone."""
    import torch.nn.functional as F

    from tokenflow_torch.kernels import geglu as gg

    rows = []
    for m, k, n2 in K7_SHAPES:
        n = n2 // 2
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((n2, k), generator=gen, device="cuda") * k**-0.5).bfloat16()
        b = (0.1 * torch.randn((n2,), generator=gen, device="cuda")).bfloat16()
        tag = f"[K7] {m} x {k} -> {n2}"
        out = gg.geglu_kernel(x, w, b)
        again = gg.geglu_kernel(x, w, b)
        torch.cuda.synchronize()
        ulps, sq_err, sq_ref = 0.0, 0.0, 0.0
        for i, ref in _geglu_rows_f32(x, w, b):
            got = out[i:i + ref.shape[0]]
            ulps = max(ulps, bf16_ulps_floored(got, ref))
            sq_err += float((got.float() - ref).square().sum())
            sq_ref += float(ref.square().sum())
            del ref
        rel = math.sqrt(sq_err / sq_ref)
        bitwise = torch.equal(out, again)
        if not (bool(torch.isfinite(out.float()).all()) and ulps <= K7_MAX_ULPS and bitwise):
            raise AssertionError(f"{tag}: {ulps} bf16 steps from the fp32 plain version, "
                                 f"rel L2 {rel:.3e}, two launches bitwise equal: {bitwise}")
        head = x[:1 << 16]  # the replaced bf16 path's error, on the first rows
        plain_ulps = bf16_ulps_floored(gg.geglu_plain(head, w, b),
                                       gg.geglu_plain(head.float(), w.float(), b.float()))
        del out, again
        p = gg.plan(m, k, n)

        def call():
            return gg.geglu_kernel(x, w, b)

        dev_ms = device_ms(call)
        trace_ms = kernel_trace_ms(call, "geglu_gemm")
        plain_ms = device_ms(lambda: gg.geglu_plain(x, w, b), runs=5)
        linear_ms = device_ms(lambda: F.linear(x, w, b), runs=5)
        flops = 2.0 * m * k * n2
        bound_ms, bound_by = bound(2.0 * (m * k + n2 * k + m * n), flops)
        print(f"{tag}: plan {p}, {ulps:.3f} bf16 steps (bf16 plain path {plain_ulps:.3f}), "
              f"rel L2 {rel:.3e}, two launches bitwise equal; kernel {dev_ms:.4f} ms device "
              f"({bound_ms / dev_ms:.1%} of the bound; profiler's kernel record "
              f"{trace_ms:.4f} ms, {bound_ms / trace_ms:.1%}), plain bf16 path "
              f"{plain_ms:.4f} ms, F.linear alone {linear_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        rows.append({"shape": [m, k, n2], "plan": p, "ulps": ulps, "rel_l2": rel,
                     "plain_bf16_ulps": plain_ulps, "bitwise_repeat": True,
                     "device_ms": dev_ms, "trace_ms": trace_ms, "plain_ms": plain_ms,
                     "linear_ms": linear_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share_device": bound_ms / dev_ms})
        del x, w, b, head
        torch.cuda.empty_cache()
    main = rows[0]
    return {
        "name": "geglu",
        "route": "cuda",
        "source": "tokenflow_torch/csrc/geglu_gemm.cu",
        "replaces": "F.linear, F.gelu and the product on CUDA bf16 (no TPU kernel: XLA's)",
        "max_ulps": max(r["ulps"] for r in rows),
        "rel_l2": max(r["rel_l2"] for r in rows),
        "ms": main["device_ms"],
        **{key: main[key] for key in ("plain_ms", "bound_ms", "bound_by")},
        "library_ms": main["plain_ms"],
        "shapes": rows,
    }


def sweep_group_norm_clusters(gen: torch.Generator) -> list:
    """K4 at the GN_CLUSTER_SWEEP rows with each listed cluster size forced
    (the plan's override), without SiLU: one launch's device time and the
    verdict (data for the plan's cluster rule)."""
    from tokenflow_torch.kernels import group_norm as gn

    rows = []
    for shape, sizes in GN_CLUSTER_SWEEP:
        x, w, b = gn_inputs(gen, shape)
        ref = gn.group_norm_plain(x, w, b, 32, 1e-6)
        ops = gn.prepare_operands(x, w, b, 32, None)
        out = torch.empty_like(x)
        c, hw = shape[1], shape[2] * shape[3]
        for n in sizes:
            p = gn.plan(shape[0], c, hw, 32, x.dtype, cluster=n)
            part = gn.scratch(x, 32, p)
            gn.launch(ops, out, part, 32, 1e-6, None, p)
            v = gn_verdict(f"[K4 sweep] {shape} cluster {n}", out, ref)
            ms = device_ms(lambda: gn.launch(ops, out, part, 32, 1e-6, None, p))
            per_sm, clusters = gn.occupancy(x, 32, None, p)
            bound_ms = bound(2.0 * x.element_size() * x.numel(), 0.0)[0]
            print(f"{v['line']}, slice {p.slice}, {per_sm} CTAs/SM, {clusters} clusters: "
                  f"kernel {ms:.4f} ms ({bound_ms / ms:.0%} of the bound), plan's "
                  f"choice {gn.plan(shape[0], c, hw, 32, x.dtype).cluster}", flush=True)
            rows.append({"shape": list(shape), "cluster": n, "kernel_ms": ms,
                         "ctas_per_sm": per_sm, "clusters": clusters,
                         "bound_ms": bound_ms, "ulps": v["ulps"]})
        del x, w, b, ref, out, ops
        torch.cuda.empty_cache()
    return rows


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_edit_step(group_norm_kernel: bool = True) -> dict:
    """torch.profiler device time by kernel class for one SDEdit edit step
    at 768p, as the smoke's SDEdit phase runs it: 24 frames of 96^2
    latents, window 8 (3 pivots), propagation chunks of 8, SD-2.1 with
    random weights in bf16, K4 on (or off). One step warms up, the next is
    traced. Not run by main(), so the smoke's time does not grow:

        python -c "import chip_smoke as c; c.profile_edit_step()"

    Prints one table row per class and returns the step's wall and device
    times, the device's idle share and the classes' device ms."""
    from torch.profiler import ProfilerActivity, profile

    from tokenflow_torch import runtime
    from tokenflow_torch.diffusion import ddim
    from tokenflow_torch.editing import pipeline

    n_frames, lat, window, chunk = 24, 96, 8, 8
    stack = runtime.load_stack("2.1", device="cuda", dtype=torch.bfloat16, init="random",
                               group_norm_kernel=group_norm_kernel)
    gen = torch.Generator(device="cuda").manual_seed(5)
    sched = ddim.truncate_schedule(ddim.make_schedule(10), 0.9)
    full = pipeline.make_edit_schedule(sched, sched.timesteps)

    def steps(sl):
        return pipeline.EditSchedule(**{
            f: getattr(full, f)[sl] for f in pipeline.EditSchedule.__dataclass_fields__
        })

    x0 = torch.randn((n_frames, lat, lat, 4), generator=gen, device="cuda").bfloat16()
    traj = torch.randn((len(sched.timesteps), n_frames, lat, lat, 4), generator=gen,
                       device="cuda").bfloat16()
    embeds3 = torch.randn((3, 77, 1024), generator=gen, device="cuda").bfloat16()
    pivots = np.tile(np.arange(window // 2, n_frames, window), (1, 1))

    def one_step(sl):
        return pipeline.tokenflow_sample_loop(
            stack.unet_apply, x0, traj, embeds3, steps(sl), window_size=window,
            guidance_scale=7.5, pnp=False, pivot_indices=pivots, propagate_chunk=chunk,
        )

    one_step(slice(0, 1))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = one_step(slice(1, 2))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(out).all():
        raise AssertionError("profile_edit_step: non-finite latents")
    by_class: dict = {}
    counts: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        cls = _kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        counts[cls] = counts.get(cls, 0) + evt.count
    device = sum(by_class.values())
    if device <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile 768p step, K4 {'on' if group_norm_kernel else 'off'}] {cls}: "
              f"{ms:.3f} ms ({ms / device:.1%}), {counts[cls]} launches", flush=True)
    report = {"group_norm_kernel": group_norm_kernel, "step_wall_ms": wall_ms,
              "device_ms": device, "idle_share": 1.0 - device / wall_ms,
              "by_class_ms": by_class, "launches_by_class": counts,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    print(f"[profile 768p step] wall {wall_ms:.1f} ms, device {device:.1f} ms, idle "
          f"share {report['idle_share']:.3f}", flush=True)
    return report


def write_frames(root: str, n: int, hw: int) -> str:
    """n synthetic frames with gentle horizontal motion, as PNGs."""
    from PIL import Image

    data = os.path.join(root, "data", "clip")
    os.makedirs(data)
    rng = np.random.default_rng(0)
    base = rng.integers(40, 210, (hw, hw, 3), dtype=np.uint8)
    for i in range(n):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(
            os.path.join(data, f"{i:05d}.png")
        )
    return data


def kernel_modules() -> dict:
    """The wrapper module of each kernel, by its bf16 name in the kernels
    line."""
    from tokenflow_torch.kernels import flash_attention as fa
    from tokenflow_torch.kernels import geglu as gg
    from tokenflow_torch.kernels import group_norm as gn
    from tokenflow_torch.kernels import layer_norm as ln
    from tokenflow_torch.kernels import short_attention as sa
    from tokenflow_torch.kernels import token_match as tm
    from tokenflow_torch.kernels import token_match_split as tms

    return {"flash_attention": fa, "token_match_gather": tm,
            "token_match_gather_split": tms, "group_norm": gn, "layer_norm": ln,
            "short_attention": sa, "geglu": gg}


# each entry of the kernels line: (its wrapper module in kernel_modules(),
# the dtype of the launches it counts, or None for all: K4 is one source in
# both dtypes, K5, K6 and K7 are bf16 only)
KERNEL_ENTRIES = {
    "flash_attention": ("flash_attention", "bfloat16"),
    "token_match_gather": ("token_match_gather", "bfloat16"),
    "token_match_gather_split": ("token_match_gather_split", "bfloat16"),
    "group_norm": ("group_norm", None),
    "layer_norm": ("layer_norm", None),
    "short_attention": ("short_attention", None),
    "geglu": ("geglu", None),
    "flash_attention_f32": ("flash_attention", "float32"),
    "token_match_f32": ("token_match_gather", "float32"),
    "token_match_split_f32": ("token_match_gather_split", "float32"),
}
BF16_KERNELS = ("flash_attention", "token_match_gather", "token_match_gather_split",
                "layer_norm", "short_attention", "geglu")
MATCH_KERNELS = ("token_match_gather", "token_match_gather_split")
F32_KERNELS = ("flash_attention_f32", "token_match_f32", "token_match_split_f32")
# the norms' kernels a CUDA stack launches by default: K4 and K5 in bf16,
# K4 alone in fp32 (an fp32 LayerNorm stays on F.layer_norm)
NORMS_BF16 = ("group_norm_bf16", "layer_norm")
# the kernels every bf16 edit path launches: K1, K6 (the short-key
# attention calls), K2, K7 (the GEGLUs) and the norms'
PATH_BF16 = ("flash_attention", "short_attention", "token_match_gather", "geglu") + NORMS_BF16
NORMS_F32 = ("group_norm_f32",)


def zero_counts() -> None:
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
        if m not in (mods["short_attention"], mods["geglu"]):  # K6 and K7 are bf16 alone
            m.launches_by_dtype.clear()
    for name in ("flash_attention", "short_attention"):
        mods[name].launches_by_head_dim.clear()
    for name in ("flash_attention", "group_norm", "layer_norm", "short_attention"):
        mods[name].launches_by_shape.clear()
    mods["layer_norm"].rope_launches = 0
    mods["short_attention"].launches_by_plan.clear()
    mods["geglu"].launches_by_plan.clear()
    for name in MATCH_KERNELS:
        mods[name].launches_by_streams.clear()


def read_counts() -> dict:
    """Launches of each entry of the kernels line since the counts were
    zeroed, K4's by dtype and K5's rotary entry's."""
    mods = kernel_modules()
    counts = {
        name: mods[m].launches if dt is None else mods[m].launches_by_dtype.get(dt, 0)
        for name, (m, dt) in KERNEL_ENTRIES.items()
    }
    gn = mods["group_norm"].launches_by_dtype
    counts["group_norm_bf16"] = gn.get("bfloat16", 0)
    counts["group_norm_f32"] = gn.get("float32", 0)
    counts["layer_norm_rope"] = mods["layer_norm"].rope_launches
    return counts


def check_launched(counts: dict, path: str, want: tuple, not_want: tuple) -> None:
    """Raises unless every kernel of ``want`` launched on ``path`` and none
    of ``not_want`` did."""
    for name in want:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    for name in not_want:
        if counts[name] != 0:
            raise AssertionError(f"kernel {name} ran on the {path} path")


def check_k7_per_step(tag: str, launches_per_step: dict, want: dict) -> dict:
    """Raises unless K7 launched ``want[phase]`` times a step in each phase
    (one launch per transformer block a model call runs); returns them."""
    got = {phase: launches_per_step[phase]["geglu"] for phase in want}
    if got != want:
        raise AssertionError(f"{tag}: K7 launches a step {got}, expected {want}")
    return got


def read_match_streams() -> dict:
    """K2's and K3's launches by their kf tables' stream count since the
    counts were zeroed."""
    mods = kernel_modules()
    return {name: dict(sorted(mods[name].launches_by_streams.items()))
            for name in MATCH_KERNELS}


def read_k1_head_dims() -> dict:
    """K1's launches by head dim since the counts were zeroed."""
    return dict(sorted(kernel_modules()["flash_attention"].launches_by_head_dim.items()))


def read_k1_shapes() -> dict:
    """K1's launches by (B, Sq, Skv, H, D) since the counts were zeroed."""
    return dict(sorted(kernel_modules()["flash_attention"].launches_by_shape.items()))


def per_step(pre: dict, after_edit: dict, steps: dict) -> dict:
    """Launches per denoising step of each kernel: the preprocess CLI's
    (inversion + reconstruction) and the edit CLI's (its pivotal and
    propagation passes and the final decode), from the counts read after
    each."""
    edit = {n: after_edit[n] - pre[n] for n in pre}
    return {phase: {n: c / steps[phase] for n, c in counts.items()}
            for phase, counts in (("inversion+reconstruction", pre), ("edit", edit))}


# the PnP 512^2 path's further edits of its latents (run_variant): (name,
# config keys, the stream count K2 must launch at)
PNP_VARIANTS = (("pnp_approx", {"prop_approx": True}, 2), ("pnp_exact_again", {}, 3))


def run_main_path(root: str, dtype: str = "bf16", inv_steps: int = 20,
                  edit_steps: int = 10, sd_version: str = "2.1", pre_args: tuple = (),
                  variants=None, tag=None) -> dict:
    """PnP at 512^2 at the CLIs' defaults, the stack in ``dtype``: K1 (at
    D = 64 only), K2 and the norms' kernels of that dtype (K4 and K5 in
    bf16, K4 in fp32) must launch and no kernel of the other dtype; K3 (no
    site past its table size at 512^2) must not. ``pre_args`` go to
    preprocess as well; ``variants`` (default: PNP_VARIANTS in bf16, none in
    fp32) are the further edits of the latents."""
    import yaml

    from tokenflow_torch.cli import preprocess, run_pnp

    if variants is None:
        variants = PNP_VARIANTS if dtype == "bf16" else ()
    tag = tag or ("[main path]" if dtype == "bf16" else "[pnp 512 f32]")
    n_frames = 40
    write_frames(root, n_frames, 512)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pre = preprocess.main([
            "--data_path", "data/clip", "--H", "512", "--W", "512",
            "--sd_version", sd_version, "--init", "random", "--dtype", dtype,
            "--n_frames", str(n_frames), "--batch_size", str(n_frames),
            "--steps", str(inv_steps), "--save_steps", str(edit_steps),
            "--device", "cuda", *pre_args,
        ])
        t_pre = time.perf_counter() - t0
        pre_counts = read_counts()
        peak_pre = torch.cuda.max_memory_allocated()
        config = {
            "seed": 1, "device": "cuda", "output_path": "results",
            "data_path": "data/clip", "latents_path": "latents",
            "n_inversion_steps": inv_steps, "n_frames": n_frames,
            "sd_version": sd_version, "init": "random", "dtype": dtype,
            "guidance_scale": 7.5, "n_timesteps": edit_steps,
            "prompt": "a marble sculpture of a woman running",
            "negative_prompt": "ugly, blurry, low res",
            "batch_size": 8, "pnp_attn_t": 0.5, "pnp_f_t": 0.8,
        }
        with open("config_pnp.yaml", "w") as f:
            yaml.safe_dump(config, f)
        t0 = time.perf_counter()
        decoded = run_pnp.main(["--config_path", "config_pnp.yaml"])
        t_edit = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts, dims = read_counts(), read_k1_head_dims()
        out_dir = run_pnp.resolve_output_path(dict(config))["output_path"]
        for name in (
            "img_ode/00000.png", "tokenflow_PnP_fps_10.mp4", "vae_recon_10.mp4",
            "input_fps10.mp4", "config.yaml", "metrics.json",
        ):
            if not os.path.exists(os.path.join(out_dir, name)):
                raise AssertionError(f"missing output {name}")
        traj = os.path.join(pre["save_path"], "latents", "trajectory.npz")
        for name in (traj, os.path.join(pre["save_path"], "inverted.mp4")):
            if not os.path.exists(name):
                raise AssertionError(f"missing output {name}")
        if decoded.shape != (n_frames, 512, 512, 3) or not np.isfinite(decoded).all():
            raise AssertionError(f"decoded frames bad: shape {decoded.shape}")
        with open(os.path.join(out_dir, "metrics.json")) as f:
            metrics = json.load(f)
        exact = _edit_report(out_dir, edit_steps)
        # the same edit with approximate propagation, and exact once more:
        # the first edit of the process also pays its shapes' first calls,
        # so the repeat is the like-for-like reading
        variants = {
            name: run_variant(
                run_pnp, config, name, extra, edit_steps,
                PATH_BF16,
                ("token_match_gather_split", "group_norm_f32") + F32_KERNELS, k2_streams,
            )
            for name, extra, k2_streams in variants
        }
    finally:
        os.chdir(cwd)
    if set(dims) != {64}:
        raise AssertionError(f"{tag}: K1 must launch at head dim 64 only, launched {dims}")
    if dtype == "bf16":
        check_launched(counts, "PnP 512^2",
                       PATH_BF16,
                       ("token_match_gather_split", "group_norm_f32") + F32_KERNELS)
    else:
        check_launched(counts, "fp32 PnP 512^2",
                       ("flash_attention_f32", "token_match_f32") + NORMS_F32,
                       ("token_match_split_f32", "group_norm_bf16") + BF16_KERNELS)
    ph = metrics["phases_seconds"]
    report = {
        "dtype": dtype,
        "sd_version": sd_version,
        "launches": counts,
        "k1_launches_by_head_dim": {str(d): n for d, n in dims.items()},
        "launches_per_step": per_step(
            pre_counts, counts, {"inversion+reconstruction": 2 * inv_steps,
                                 "edit": edit_steps},
        ),
        "preprocess_seconds": t_pre,
        "inversion_seconds_per_step": pre["inversion_seconds"] / inv_steps,
        "reconstruction_seconds_per_step": pre["reconstruction_seconds"] / inv_steps,
        "edit_seconds": t_edit,
        "edit_pivotal_seconds_per_step": ph["edit_pivotal"] / edit_steps,
        "edit_propagate_seconds_per_step": ph["edit_propagate"] / edit_steps,
        "edit_loop_seconds": ph["edit_loop"],
        "decode_seconds": ph["decode"],
        "peak_memory_bytes": peak,
        "peak_memory_preprocess_bytes": peak_pre,
        "reconstruction_psnr": pre["reconstruction_psnr"],
        "output_dir": os.path.join(root, out_dir),
    }
    if "depth_seconds" in pre:
        report["depth_maps_seconds"] = pre["depth_seconds"]
    if dtype == "bf16" and sd_version == "2.1":
        report["k6_expected_per_step"] = K6_PER_STEP["pnp_512"]
        check_k7_per_step(tag, report["launches_per_step"], K7_PER_STEP["pnp_512"])
    if variants:
        report["variants"] = variants
        report["steps_by_variant"] = compare_steps(tag, exact, variants)
    for k, v in report.items():
        print(f"{tag} {k}: {v}", flush=True)
    return report


def _edit_report(out_dir: str, n_steps: int) -> dict:
    """An edit's seconds per step by pass (pivotal and propagate, or the
    fused step) and their sum, from its metrics.json."""
    with open(os.path.join(out_dir, "metrics.json")) as f:
        ph = json.load(f)["phases_seconds"]
    passes = {f"{name}_seconds_per_step": ph[f"edit_{name}"] / n_steps
              for name in ("pivotal", "propagate", "fused") if f"edit_{name}" in ph}
    return {
        **passes,
        "step_seconds": sum(passes.values()),
        "edit_loop_seconds": ph["edit_loop"],
        "decode_seconds": ph["decode"],
    }


def run_variant(cli, config: dict, name: str, extra: dict, n_steps: int, want: tuple,
                not_want: tuple, k2_streams: int) -> dict:
    """One more edit of a path through its CLI module ``cli``, on the latents
    the path's preprocess wrote (run from that path's root): ``config`` with
    ``extra``, output under ``results_<name>``, the counts zeroed just before
    and read just after. Checks the output tree and frames, that every
    kernel of ``want`` launched and none of ``not_want``, and that K2
    launched only at ``k2_streams`` streams. Returns the edit's s/step by
    pass and its launches (per step: the edit's and its final decode's)."""
    import yaml

    cfg = dict(config, output_path=f"results_{name}", **extra)
    with open(f"config_{name}.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    zero_counts()
    t0 = time.perf_counter()
    decoded = cli.main(["--config_path", f"config_{name}.yaml"])
    t_edit = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts, streams, dims = read_counts(), read_match_streams(), read_k1_head_dims()
    out_dir = cli.resolve_output_path(dict(cfg))["output_path"]
    for f in ("img_ode/00000.png", "config.yaml", "metrics.json", "pivots.json"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"{name}: missing output {f}")
    n_frames, hw = cfg["n_frames"], cfg.get("image_size", 512)
    if decoded.shape != (n_frames, hw, hw, 3) or not np.isfinite(decoded).all():
        raise AssertionError(f"{name}: decoded frames bad, {decoded.shape}")
    check_launched(counts, name, want, not_want)
    k2 = streams["token_match_gather"]
    if k2 != {k2_streams: counts["token_match_gather"]}:
        raise AssertionError(f"{name}: K2 must launch at {k2_streams} streams only, "
                             f"launched {k2}")
    report = {
        "output_dir": os.path.abspath(out_dir),
        "launches": counts,
        "launches_per_step": {n: c / n_steps for n, c in counts.items()},
        "match_launches_by_streams": streams,
        "k1_launches_by_head_dim": {str(d): n for d, n in dims.items()},
        "edit_seconds": t_edit,
        **_edit_report(out_dir, n_steps),
    }
    for k, v in report.items():
        print(f"[{name}] {k}: {v}", flush=True)
    return report


def compare_steps(tag: str, exact: dict, variants: dict) -> dict:
    """Prints and returns the exact edit's s/step by pass beside each
    variant's, all from this run."""
    keys = ("pivotal_seconds_per_step", "propagate_seconds_per_step", "step_seconds")
    table = {name: {k: r[k] for k in keys}
             for name, r in {"exact": exact, **variants}.items()}
    for name, row in table.items():
        print(f"{tag} s/step, {name}: {row}", flush=True)
    return table


def run_sdedit_path(root: str, dtype: str = "bf16", n_frames: int = 24,
                    inv_steps: int = 10, n_timesteps: int = 10) -> dict:
    """The SDEdit editor at 768p through the port's CLIs at their defaults
    (the GroupNorm kernel on, as on every CUDA path): preprocess
    ``n_frames`` synthetic 768x768 frames (SD-2.1, random weights, the
    stack in ``dtype``), an SDEdit edit with window 8 and propagation chunks
    of 8 frames. All the kernels of that dtype must launch in this phase
    (K3 at the 96x96 level; K5 in bf16 only), and none of the other. In
    bf16, also a 2-step --vanilla run, then the same edit once more with
    ``group_norm_kernel: false`` (``F.group_norm``), for its step time."""
    import yaml

    from tokenflow_torch.cli import preprocess, run_sdedit
    from tokenflow_torch.diffusion import ddim

    hw, bf16 = 768, dtype == "bf16"
    write_frames(root, n_frames, hw)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pre = preprocess.main([
            "--data_path", "data/clip", "--H", str(hw), "--W", str(hw),
            "--sd_version", "2.1", "--init", "random", "--dtype", dtype,
            "--n_frames", str(n_frames), "--batch_size", str(n_frames),
            "--steps", str(inv_steps), "--save_steps", str(n_timesteps),
            "--device", "cuda",
        ])
        t_pre = time.perf_counter() - t0
        pre_counts = read_counts()
        peak_pre = torch.cuda.max_memory_allocated()
        config = {
            "seed": 1, "device": "cuda", "output_path": "results",
            "data_path": "data/clip", "latents_path": "latents",
            "n_frames": n_frames, "sd_version": "2.1", "init": "random",
            "dtype": dtype, "guidance_scale": 7.5, "n_timesteps": n_timesteps,
            "prompt": "a shiny silver robotic wolf",
            "negative_prompt": "ugly, blurry, low res",
            "batch_size": 8, "propagate_chunk": 8, "start": 0.9,
            "image_size": hw,
        }
        decoded, out_dirs = {}, {}

        def edit(name, cfg, *flags):
            with open(f"config_{name}.yaml", "w") as f:
                yaml.safe_dump(cfg, f)
            decoded[name] = run_sdedit.main(["--config_path", f"config_{name}.yaml", *flags])
            out_dirs[name] = run_sdedit.resolve_output_path(dict(cfg))["output_path"]

        edit("sdedit", config)
        edit_counts = read_counts()
        outputs = [("sdedit", ("img_ode/00000.png", "tokenflow_SDEdit_fps_10.mp4",
                               "input_fps10.mp4", "config.yaml", "metrics.json",
                               "pivots.json"))]
        if bf16:
            edit("vanilla", dict(config, start=0.3), "--vanilla")  # 2 steps
            outputs.append(("vanilla", ("img_ode_vanilla_sde/00000.png", "vanilla_sde.mp4",
                                        "metrics_vanilla.json")))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = {"sdedit_path": read_counts()}
        if bf16:
            zero_counts()
            edit("sdedit_gn_off", dict(config, output_path="results_gn_off",
                                       group_norm_kernel=False))
            counts["gn_off_run"] = read_counts()
            outputs.append(("sdedit_gn_off", ("img_ode/00000.png", "metrics.json")))
        for name, files in outputs:
            for f in files:
                if not os.path.exists(os.path.join(out_dirs[name], f)):
                    raise AssertionError(f"{name}: missing output {f}")
            if decoded[name].shape != (n_frames, hw, hw, 3) or not np.isfinite(
                decoded[name]
            ).all():
                raise AssertionError(f"{name}: decoded frames bad, {decoded[name].shape}")
        n_steps = len(ddim.truncate_schedule(
            ddim.make_schedule(n_timesteps), config["start"]
        ).timesteps)
        on = _edit_report(out_dirs["sdedit"], n_steps)
        off = _edit_report(out_dirs["sdedit_gn_off"], n_steps) if bf16 else None
        variants = {}
        if bf16:
            # approximate propagation, K4 on: two-stream tables everywhere, so
            # the 96x96 level's table fits K2 and K3 must not launch
            variants["sdedit_approx"] = run_variant(
                run_sdedit, config, "sdedit_approx", {"prop_approx": True}, n_steps,
                PATH_BF16,
                ("token_match_gather_split", "group_norm_f32") + F32_KERNELS, 2,
            )
    finally:
        os.chdir(cwd)
    if bf16:
        check_launched(counts["sdedit_path"], "SDEdit 768p",
                       BF16_KERNELS + NORMS_BF16, F32_KERNELS + ("group_norm_f32",))
        if counts["gn_off_run"]["group_norm"] != 0:
            raise AssertionError("the GroupNorm kernel ran with group_norm_kernel off")
    else:
        check_launched(counts["sdedit_path"], "fp32 SDEdit 768p",
                       F32_KERNELS + NORMS_F32, BF16_KERNELS + ("group_norm_bf16",))
    report = {
        "dtype": dtype,
        "n_frames": n_frames,
        "launches": counts["sdedit_path"],
        "launches_per_step": per_step(
            pre_counts, edit_counts, {"inversion+reconstruction": 2 * inv_steps,
                                      "edit": n_steps},
        ),
        "preprocess_seconds": t_pre,
        "inversion_seconds_per_step": pre["inversion_seconds"] / inv_steps,
        "reconstruction_seconds_per_step": pre["reconstruction_seconds"] / inv_steps,
        "reconstruction_psnr": pre["reconstruction_psnr"],
        "edit_steps": n_steps,
        "gn_kernel_on": on,
        "peak_memory_bytes": peak,
    }
    if bf16:
        report["gn_kernel_off"] = off
        report["variants"] = variants
        report["steps_by_variant"] = compare_steps("[sdedit 768p]", on, variants)
    tag = "[sdedit 768p]" if bf16 else "[sdedit 768p f32]"
    for k, v in report.items():
        print(f"{tag} {k}: {v}", flush=True)
    return report


@contextlib.contextmanager
def record_matches(log: list):
    """Inside the block, every propagation site's matched indices ((2, F, S),
    on the CPU) are appended to ``log`` in call order, whichever of K2, K3
    or the plain version ran the site (``ops/propagation.py``'s names)."""
    from tokenflow_torch.ops import propagation as prop

    names = ("token_match_gather_kernel", "token_match_gather_split_kernel", "match_gather")
    saved = {n: getattr(prop, n) for n in names}

    def wrap(fn, split):
        def call(*args):
            res = fn(*args, return_indices=True)
            idx = torch.stack([res[1][:, 0], res[2][:, 0]]) if split else res[1]
            log.append(idx.long().cpu())
            return res[0]
        return call

    for n in names:
        setattr(prop, n, wrap(saved[n], n == "token_match_gather_split_kernel"))
    try:
        yield
    finally:
        for n in names:
            setattr(prop, n, saved[n])


def flipped_matches(got_log: list, want_log: list) -> list:
    """The share of matched indices that differ between two runs' logs
    (``record_matches``) at each propagation site."""
    return [float((g != w).float().mean()) for g, w in zip(got_log, want_log)]


@contextlib.contextmanager
def replay_matches(card_log: list, ties: list):
    """Inside the block, each propagation site of a CPU run (the plain
    version) takes the card run's matched indices from ``card_log``, in
    call order, and gathers at them (``token_match.gather_blend``). Appends
    per site (the count of tokens whose index differs from the CPU's own
    first argmax, the largest similarity gap over |x| among them, 0.0 where
    none differ) to ``ties``: the two candidates' similarities in fp64 from
    the CPU run's operands (p_hat is unit norm)."""
    from tokenflow_torch.kernels.token_match import gather_blend
    from tokenflow_torch.ops import propagation as prop

    plain = prop.match_gather
    calls = iter(card_log)

    def call(x, p_hat, kf, pa, pb, w1):
        _, own = plain(x, p_hat, kf, pa, pb, w1, return_indices=True)
        card = next(calls).to(own.device)
        flipped = card != own
        gap = 0.0
        if flipped.any():
            gap = float(flip_gaps(x, p_hat, pa, pb, card, own).max())
        ties.append((int(flipped.sum()), gap))
        return gather_blend(kf, card, pa, pb, w1)

    prop.match_gather = call
    try:
        yield
    finally:
        prop.match_gather = plain


def tie_gap(ties: list) -> float:
    """The largest similarity gap over |x| of the flips ``replay_matches``
    replayed (0.0 for none)."""
    return max((g for _, g in ties), default=0.0)


def check_ties(ties: list) -> None:
    """Raises unless every flip ``replay_matches`` replayed is a near tie,
    within REF_TIE_TOL * |x|."""
    if tie_gap(ties) > REF_TIE_TOL:
        raise AssertionError(
            f"a match the card resolves otherwise is no near tie: similarity gap "
            f"{tie_gap(ties)} |x| > {REF_TIE_TOL} |x|"
        )


def _dtype_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def compare_reference(tag: str, run, card_models, cpu_models) -> dict:
    """``run(models, device, dtype)`` -> eps on the CPU, through the card's
    bf16 models (the kernels in bf16), the CPU's fp32 copies (the plain
    versions) and the fp32 copies moved to the card (the kernels in fp32,
    TF32 off), and once more with TF32 on as a control. Holds the bf16
    card run to REF_REL_L2 against the CPU. The two fp32 runs pass one
    check: where a run's matched indices differ from the CPU's, each such
    token must be a near tie (``replay_matches``, ``check_ties``) and the
    run is read against a CPU run that takes its resolution of those
    matches (a near tie's flip moves a whole gathered row, which says
    nothing of the arithmetic the limit bounds), within REF_REL_L2_F32. The
    sound run must pass it and the control must fail it (so the check
    catches TF32 products). Reports each run's K1 launches by head dim and
    dtype, its K2/K3 launches by dtype and stream count, the share of
    matched indices per site that differ from the CPU's, the largest
    replayed flip's similarity gap over |x|, and the reading against the
    CPU's own matches. A failed check is listed under "failures" after all
    three runs have printed; the caller raises."""
    import copy

    from tokenflow_torch import utils

    mods = kernel_modules()

    def launches():
        return {
            "k1_by_head_dim": dict(mods["flash_attention"].launches_by_head_dim),
            **{f"{name}_by_dtype": dict(mods[name].launches_by_dtype)
               for name in ("flash_attention",) + MATCH_KERNELS},
            **{f"{name}_by_streams": dict(mods[name].launches_by_streams)
               for name in MATCH_KERNELS},
        }

    def rel_l2(got, ref):
        return float((got - ref).norm() / ref.norm())

    want_log = []
    with record_matches(want_log):
        want = run(cpu_models, "cpu", torch.float32)
    result, failures = {}, []
    f32_models = [copy.deepcopy(m).cuda() for m in cpu_models]
    for name, models, dtype, limit, tf32 in (
        ("bf16", card_models, torch.bfloat16, REF_REL_L2, False),
        ("f32", f32_models, torch.float32, REF_REL_L2_F32, False),
        ("f32_tf32_control", f32_models, torch.float32, REF_REL_L2_F32, True),
    ):
        before = launches()
        got_log = []
        with utils.tf32(tf32), record_matches(got_log):
            got = run(models, "cuda", dtype)
        after = launches()
        counts = {k: _dtype_delta(before[k], after[k]) for k in after}
        flips = flipped_matches(got_log, want_log)
        ref, ties = want, []
        if dtype == torch.float32 and any(flips):
            with replay_matches(got_log, ties):
                ref = run(cpu_models, "cpu", torch.float32)
        rel, own_rel = rel_l2(got, ref), rel_l2(got, want)
        err = float((got - ref).abs().max())
        gap = tie_gap(ties)
        try:
            check_ties(ties)
            if rel > limit:
                raise AssertionError(f"rel L2 {rel} > {limit}")
            verdict = None
        except AssertionError as e:
            verdict = str(e)
        print(
            f"[reference] {tag} eps, card (kernels, {name}) vs CPU (plain, fp32): rel L2 "
            f"{rel:.3e} (limit {limit}), max|err| {err:.3e}, flipped matches per site "
            f"{flips}"
            + (f", {sum(n for n, _ in ties)} flips replayed as the card resolved them, largest "
               f"similarity gap {gap:.3e} |x| (tie limit {REF_TIE_TOL} |x|), rel L2 against "
               f"the CPU's own matches {own_rel:.3e}" if ties else "")
            + f", {'fails' if verdict else 'passes'} the check"
            + (f" ({verdict})" if verdict else "")
            + (" (the TF32 control must fail it)" if tf32 else "")
            + f", launches {counts}",
            flush=True,
        )
        other = "bfloat16" if dtype == torch.float32 else "float32"
        if any(other in counts[k] for k in counts if k.endswith("_by_dtype")):
            failures.append(f"{tag} {name}: a {other} kernel ran: {counts}")
        if not torch.isfinite(got).all():
            failures.append(f"small-input reference ({tag}, {name}): not finite")
        if tf32 and verdict is None:
            failures.append(
                f"small-input reference ({tag}): with TF32 on it passes the check (rel L2 "
                f"{rel} <= {limit}, tie gap {gap}), so the check would not catch TF32 products"
            )
        if not tf32 and verdict is not None:
            failures.append(f"small-input reference ({tag}, {name}): {verdict}; flipped "
                            f"matches per site {flips}")
        result[name] = {"rel_l2": rel, "limit": limit, "max_abs_err": err, "launches": counts,
                        "flipped_per_site": flips}
        if ties:
            result[name].update(replayed_flips=sum(n for n, _ in ties), tie_gap=gap,
                                tie_limit=REF_TIE_TOL, rel_l2_own_matches=own_rel)
    del f32_models
    torch.cuda.empty_cache()
    result["failures"] = failures
    return result


def check_small_reference(sd_version: str = "2.1",
                          modes=(("exact", 3), ("pnp_approx", 2), ("sdedit_approx", 2)),
                          ) -> dict:
    """One pivotal and one propagation UNet call of the main path's SD-2.1
    stack (or ``sd_version``'s: SD-2-depth's UNet takes 5 input channels) on
    a small input, through the kernels on the card (bf16, and the same
    weights in fp32) and through the plain versions on the CPU (an
    fp32 copy of the same weights, the same bf16-rounded inputs). 2 frames,
    1 window, 40x40 latents: S = 1600 > kv_block, so K1 runs (the source
    stream on strided views) and K2 runs at every site, in each dtype.
    Tolerance on the relative L2 error of eps: REF_REL_L2 in bf16 (bf16
    weights and activations, relative step 2^-8, over the ~70 layers of
    the UNet, plus NN matches that near-ties flip between the two
    precisions), REF_REL_L2_F32 in fp32, and the fp32 run with TF32
    on must fail that check. ``modes`` on the same weights and inputs
    (each with the stream count K2 must launch at), by default three:
    the exact passes; PnP approx (a three-stream pivotal pass that also
    caches the uncond tables and the conv features, then a two-stream
    propagation pass); SDEdit approx (two-stream pivotal and propagation
    passes, no injection). Every mode runs and prints before a failure
    raises."""
    from tokenflow_torch import runtime
    from tokenflow_torch.models.unet2d import UNet2DConditionModel
    from tokenflow_torch.ops import editctx
    from tokenflow_torch.ops.propagation import propagation_indices

    stack = runtime.load_stack(sd_version, device="cuda", dtype=torch.bfloat16, init="random")
    cpu_unet = UNet2DConditionModel(stack.unet.config)
    cpu_unet.load_state_dict(
        {k: v.float().cpu() for k, v in stack.unet.state_dict().items()}
    )
    cpu_unet.eval()
    gen = torch.Generator().manual_seed(3)
    hw, f, t, c = 40, 2, 801, stack.unet.config.in_channels
    x = torch.randn((3, hw, hw, c), generator=gen).bfloat16()  # pivot: 3 streams
    xp = torch.randn((3 * f, hw, hw, c), generator=gen).bfloat16()
    emb = torch.randn((3, 77, 1024), generator=gen).bfloat16()
    pa, pb, w1 = (torch.as_tensor(a) for a in propagation_indices(f, f))

    def two_streams(a):  # the [uncond|cond] items of a frame-major 3-stream batch
        return a.reshape(-1, 3, *a.shape[1:])[:, 1:].reshape(-1, *a.shape[1:])

    def runner(mode):
        def run(models, device, dtype):
            (unet,) = models

            def put(a):
                return a.to(device=device, dtype=dtype)

            gates = dict(qk_gate=True, conv_gate=True)
            prop_idx = dict(prop_pa=pa.to(device), prop_pb=pb.to(device),
                            prop_w1=w1.to(device))
            with torch.inference_mode():
                approx, pnp = mode != "exact", mode != "sdedit_approx"
                src_free = approx and not pnp
                piv = editctx.UNetEdit(
                    mode=editctx.EditMode.PIVOTAL, n_frames=1, pnp=pnp,
                    prop_approx=approx, **gates,
                )
                _, cache = unet(put(two_streams(x) if src_free else x), t,
                                put(emb[1:] if src_free else emb), piv)
                prop = editctx.UNetEdit(
                    mode=editctx.EditMode.PROPAGATE, n_frames=f, pnp=pnp,
                    prop_approx=approx, cache=cache, **gates, **prop_idx,
                )
                eps, _ = unet(put(two_streams(xp) if approx else xp), t,
                              put((emb[1:] if approx else emb).repeat(f, 1, 1)), prop)
            return eps.float().cpu()
        return run

    name = {"2.1": "SD-2.1", "depth": "SD-2-depth"}[sd_version]
    results, failures = {}, []
    for mode, k2_streams in modes:
        result = compare_reference(f"{name} {mode}", runner(mode), [stack.unet],
                                   [cpu_unet])
        for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
            counts = result[name]["launches"]
            if not (counts["k1_by_head_dim"].get(64, 0) > 0
                    and counts["flash_attention_by_dtype"].get(dtype, 0) > 0
                    and counts["token_match_gather_by_dtype"].get(dtype, 0) > 0
                    and set(counts["token_match_gather_by_streams"]) == {k2_streams}):
                failures.append(f"small-input reference ({mode}, {name}): launches {counts}")
        failures += result.pop("failures")
        results[mode] = result
    if failures:
        raise AssertionError("; ".join(failures))
    return results


def fill_controlnet_projections(model, seed: int = 11) -> None:
    """Random weights for a ControlNet's zero-initialised projections
    (cond_embedding.conv_out, controlnet_down_*, controlnet_mid), drawn from
    ``seed`` at the other convs' scale: with them at zero every residual is
    exactly zero and the branch would change nothing on the path."""
    from tokenflow_torch.models.weights import ZERO_INIT

    gen = torch.Generator(device=model.conv_in.weight.device).manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if ZERO_INIT.match(name):
                w = torch.randn(m.weight.shape, generator=gen, device=m.weight.device)
                m.weight.copy_(w / math.sqrt(m.weight[0].numel()))


def controlnet_stack():
    """The ControlNet path's stack and ControlNet, as the CLIs load them
    (SD-1.5, random weights, bf16), with the projections filled; both stay
    held, so the CLIs run on these weights."""
    from tokenflow_torch import runtime, utils
    from tokenflow_torch.cli import controlnet_utils

    stack = runtime.load_stack("ControlNet", device=utils.resolve_device("cuda"),
                               dtype=torch.bfloat16, init="random")
    model = controlnet_utils.load_controlnet(stack, None, "random")
    fill_controlnet_projections(model)
    return stack, model


def check_controlnet_residuals(stack, model, frames: np.ndarray) -> dict:
    """The filled ControlNet on one frame's canny image: every residual must
    be finite and not all zero."""
    from tokenflow_torch.cli import controlnet_utils

    canny = torch.as_tensor(controlnet_utils.canny_cond(frames[:1]), device="cuda").bfloat16()
    lat = frames.shape[1] // 8
    x = torch.randn((1, lat, lat, 4), generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda").bfloat16()
    ctx = torch.zeros((1, 77, 768), device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        down, mid = model(x, 501, ctx, canny)
    norms = [float(r.float().norm()) for r in (*down, mid)]
    if not all(math.isfinite(n) and n > 0 for n in norms):
        raise AssertionError(f"ControlNet residual norms {norms}: zero or not finite")
    return {"n_residuals": len(norms), "min_norm": min(norms), "max_norm": max(norms),
            "edge_share": float(canny[..., 0].float().mean())}


def run_controlnet_path(root: str) -> dict:
    """The ControlNet editor at 512^2 through the port's CLIs: preprocess 40
    synthetic frames with --sd_version ControlNet (SD-1.5, random weights,
    bf16, the ControlNet's projections filled from a seed), then a 10-step
    run_controlnet edit with window 8 (5 pivots). K1 must launch at head dims
    40, 80 and 160 and K2, K4 and K5 must launch; K3 (no site past its
    table size at 512^2) must not."""
    import yaml

    from tokenflow_torch.cli import preprocess, run_controlnet
    from tokenflow_torch.io import video as video_io

    n_frames, inv_steps, edit_steps = 40, 20, 10
    data = write_frames(root, n_frames, 512)
    stack, model = controlnet_stack()
    residuals = check_controlnet_residuals(
        stack, model, video_io.load_frames(data, 1, resize_square=512)
    )
    cwd = os.getcwd()
    os.chdir(root)
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pre = preprocess.main([
            "--data_path", "data/clip", "--H", "512", "--W", "512",
            "--sd_version", "ControlNet", "--init", "random", "--dtype", "bf16",
            "--n_frames", str(n_frames), "--batch_size", str(n_frames),
            "--steps", str(inv_steps), "--save_steps", str(edit_steps),
            "--device", "cuda",
        ])
        t_pre = time.perf_counter() - t0
        pre_counts, pre_dims = read_counts(), read_k1_head_dims()
        pre_shapes = read_k1_shapes()
        config = {
            "seed": 1, "device": "cuda", "output_path": "results",
            "data_path": "data/clip", "latents_path": "latents",
            "n_inversion_steps": inv_steps, "n_frames": n_frames,
            "sd_version": "ControlNet", "init": "random", "dtype": "bf16",
            "guidance_scale": 7.5, "n_timesteps": edit_steps,
            "prompt": "a marble sculpture of a woman running, Venus de Milo",
            "negative_prompt": "ugly, blurry, low res, unrealistic, unaesthetic",
            "batch_size": 8,
        }
        with open("config_controlnet.yaml", "w") as f:
            yaml.safe_dump(config, f)
        t0 = time.perf_counter()
        decoded = run_controlnet.main(["--config_path", "config_controlnet.yaml"])
        t_edit = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts, dims = read_counts(), read_k1_head_dims()
        shapes = read_k1_shapes()
        out_dir = run_controlnet.resolve_output_path(dict(config))["output_path"]
        for name in (
            "img_ode/00000.png", "tokenflow_ControlNet_fps_10.mp4", "vae_recon_10.mp4",
            "input_fps10.mp4", "config.yaml", "metrics.json", "pivots.json",
        ):
            if not os.path.exists(os.path.join(out_dir, name)):
                raise AssertionError(f"ControlNet: missing output {name}")
        if not os.path.exists(os.path.join(pre["save_path"], "latents", "trajectory.npz")):
            raise AssertionError("ControlNet: missing trajectory")
        if decoded.shape != (n_frames, 512, 512, 3) or not np.isfinite(decoded).all():
            raise AssertionError(f"ControlNet: decoded frames bad, {decoded.shape}")
        edit = _edit_report(out_dir, edit_steps)
        variants = {"controlnet_approx": run_variant(
            run_controlnet, config, "controlnet_approx", {"prop_approx": True}, edit_steps,
            PATH_BF16,
            ("token_match_gather_split", "group_norm_f32") + F32_KERNELS, 2,
        )}
    finally:
        os.chdir(cwd)
    edit_dims = {d: n - pre_dims.get(d, 0) for d, n in dims.items()}
    for d in (40, 80, 160):
        if edit_dims.get(d, 0) <= 0:
            raise AssertionError(f"K1 was not launched at head dim {d} on the ControlNet edit")
    # every K1 launch shape of the path is a row check_flash holds and times
    missing = sorted(set(shapes) - {tuple(r) for r in K1_SD15_SHAPES})
    if missing:
        raise AssertionError(f"ControlNet K1 shapes missing from K1_SD15_SHAPES: {missing}")
    if counts["token_match_gather"] <= 0:
        raise AssertionError("K2 was not launched on the ControlNet path")
    check_launched(counts, "512^2 ControlNet", NORMS_BF16 + ("short_attention", "geglu"),
                   ("token_match_gather_split", "group_norm_f32") + F32_KERNELS)
    launches_per_step = per_step(
        pre_counts, counts, {"inversion+reconstruction": 2 * inv_steps, "edit": edit_steps},
    )
    report = {
        "launches": counts,
        "launches_per_step": launches_per_step,
        "k1_launches_by_head_dim": {
            "inversion+reconstruction": {str(d): n for d, n in pre_dims.items()},
            "edit": {str(d): n for d, n in edit_dims.items()},
        },
        "k1_launches_by_shape": {
            "inversion+reconstruction": {str(s): n for s, n in pre_shapes.items()},
            "edit": {str(s): n - pre_shapes.get(s, 0) for s, n in shapes.items()
                     if n > pre_shapes.get(s, 0)},
        },
        "k6_expected_per_step": K6_PER_STEP["controlnet_512"],
        "k7_per_step": check_k7_per_step("[controlnet 512]", launches_per_step,
                                         K7_PER_STEP["controlnet_512"]),
        "residuals": residuals,
        "preprocess_seconds": t_pre,
        "inversion_seconds_per_step": pre["inversion_seconds"] / inv_steps,
        "reconstruction_seconds_per_step": pre["reconstruction_seconds"] / inv_steps,
        "reconstruction_psnr": pre["reconstruction_psnr"],
        "edit_seconds": t_edit,
        **{f"edit_{k}": v for k, v in edit.items()},
        "peak_memory_bytes": peak,
        "variants": variants,
        "steps_by_variant": compare_steps("[controlnet 512]", edit, variants),
    }
    for k, v in report.items():
        print(f"[controlnet 512] {k}: {v}", flush=True)
    return report


def check_small_reference_controlnet() -> dict:
    """One pivotal and one propagation call of the ControlNet path's SD-1.5
    UNet with the ControlNet's residuals on a small input, through the
    kernels on the card (bf16, and the same weights in fp32) and through the
    plain versions on the CPU (an fp32 copy of the same weights, the same
    bf16-rounded inputs). 6 frames in windows of 2 (3 pivots), 40x40
    latents: K1 runs at D = 40 (S = 1600 per frame, and the pivotal pass's
    4800) and at D = 80 (the pivotal pass's 1200 tokens at 20x20), K2 at
    every site, in each dtype. Tolerances: REF_REL_L2 in bf16,
    REF_REL_L2_F32 in fp32 (the TF32 control must fail that check)."""
    from tokenflow_torch.models.controlnet import ControlNetModel
    from tokenflow_torch.models.unet2d import UNet2DConditionModel
    from tokenflow_torch.ops import editctx
    from tokenflow_torch.ops.propagation import propagation_indices

    stack, model = controlnet_stack()
    cpu_unet = UNet2DConditionModel(stack.unet.config)
    cpu_unet.load_state_dict({k: v.float().cpu() for k, v in stack.unet.state_dict().items()})
    cpu_cn = ControlNetModel(stack.unet.config, model.controlnet_cond_embedding.num_downsamples)
    cpu_cn.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    cpu_unet.eval()
    cpu_cn.eval()
    gen = torch.Generator().manual_seed(3)
    hw, f, ws, t = 40, 6, 2, 801
    k = f // ws
    x = torch.randn((3 * k, hw, hw, 4), generator=gen).bfloat16()  # pivots, 3 streams
    xp = torch.randn((3 * f, hw, hw, 4), generator=gen).bfloat16()
    emb = torch.randn((3, 77, 768), generator=gen).bfloat16()
    cond = (torch.rand((f, 8 * hw, 8 * hw, 3), generator=gen) > 0.9).bfloat16()
    piv = torch.arange(ws // 2, f, ws)
    pa, pb, w1 = (torch.as_tensor(a) for a in propagation_indices(f, ws))

    def run(models, device, dtype):
        unet, cn = models

        def put(a):
            return a.to(device=device, dtype=dtype)

        def residuals(sample, ctx, c):
            down, mid = cn(sample, t, ctx, put(c).repeat_interleave(3, dim=0))
            return dict(down_block_residuals=down, mid_block_residual=mid)

        with torch.inference_mode():
            edit = editctx.UNetEdit(mode=editctx.EditMode.PIVOTAL, n_frames=k, pnp=False,
                                    qk_gate=False, conv_gate=False)
            ctx = put(emb.repeat(k, 1, 1))
            _, cache = unet(put(x), t, ctx, edit, **residuals(put(x), ctx, cond[piv]))
            prop = editctx.UNetEdit(
                mode=editctx.EditMode.PROPAGATE, n_frames=f, pnp=False, qk_gate=False,
                conv_gate=False, cache=cache, prop_pa=pa.to(device), prop_pb=pb.to(device),
                prop_w1=w1.to(device),
            )
            ctx = put(emb.repeat(f, 1, 1))
            eps, _ = unet(put(xp), t, ctx, prop, **residuals(put(xp), ctx, cond))
        return eps.float().cpu()

    result = compare_reference("SD-1.5 + ControlNet pivotal+propagate", run,
                               [stack.unet, model], [cpu_unet, cpu_cn])
    if result["failures"]:
        raise AssertionError("; ".join(result["failures"]))
    del result["failures"]
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        counts = result[name]["launches"]
        dims = counts["k1_by_head_dim"]
        if not (dims.get(40, 0) > 0 and dims.get(80, 0) > 0
                and counts["token_match_gather_by_dtype"].get(dtype, 0) > 0):
            raise AssertionError(f"small-input reference (ControlNet, {name}): {counts}")
    return result


def build_dpt_checkpoint(path: str, seed: int = DPT_SEED) -> str:
    """A DPT-Large state dict in HF layout with random weights from
    ``seed`` (the port's init scales; the CLS token and position table,
    zeros in Flax, normal(0.02) as HF initialises them), with the keys HF
    has and the model never reads, as one fp32 .safetensors file of about
    1.37 GB at ``path``. Returns ``path``."""
    from safetensors.torch import save_file

    from tokenflow_torch.models import weights
    from tokenflow_torch.models.dpt import DPTConfig, DPTDepthModel

    cfg = DPTConfig.dpt_large()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        model = DPTDepthModel(cfg)
    weights.init_random_(model, gen)
    with torch.no_grad():
        for p in (model.dpt.embeddings.cls_token, model.dpt.embeddings.position_embeddings):
            p.normal_(0.0, 0.02, generator=gen)
    sd = {k: v.cpu().contiguous() for k, v in model.state_dict().items()}
    ch = cfg.fusion_hidden_size
    sd.update({"dpt.layernorm.weight": torch.ones(cfg.hidden_size),
               "dpt.layernorm.bias": torch.zeros(cfg.hidden_size)})
    for i in (1, 2):
        unit = f"neck.fusion_stage.layers.0.residual_layer1.convolution{i}."
        sd.update({unit + "weight": torch.zeros(ch, ch, 3, 3), unit + "bias": torch.zeros(ch)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_file(sd, path)
    return path


def check_dpt(ckpt: str, data: str, n_frames: int) -> dict:
    """The depth path's DPT-Large, full width, on the preprocess's frames:
    the raw map the CLI cached for frame 0 (its DPT run with TF32 on around
    it, which ``predict_depth`` must turn off) against the CPU's fp32 run of
    the same checkpoint, within DPT_REL_L2; the card's model called with
    TF32 on, a control printed beside it; every cached map finite and not
    constant; and the DPT's seconds for the ``n_frames`` frames (batches of
    8, fp32, after a warm-up batch) and its peak memory above what was
    allocated before them."""
    from tokenflow_torch import utils
    from tokenflow_torch.io import depth as depth_io

    frames = depth_io.dpt_inputs(data, n_frames)
    raw = np.stack([np.load(p) for p in depth_io.depth_paths(data, n_frames)])
    if not np.isfinite(raw).all() or (raw.reshape(n_frames, -1).std(axis=1) == 0).any():
        raise AssertionError("[dpt] a cached depth map is not finite or is constant")
    with torch.inference_mode():
        want = depth_io.load_dpt_model(ckpt, device="cpu")(torch.as_tensor(frames[:1]))[0]
    want = want.numpy().astype(np.float64)
    card = depth_io.load_dpt_model(ckpt, device="cuda")
    with utils.tf32(True), torch.inference_mode():
        control = card(torch.as_tensor(frames[:1], device="cuda"))[0].cpu().numpy()
    depth_io.predict_depth(card, frames[:8])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    preds = depth_io.predict_depth(card, frames)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base

    def rel_l2(got):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    result = {
        "rel_l2_cli_tf32_off": rel_l2(raw[0]), "limit": DPT_REL_L2,
        "rel_l2_tf32_control": rel_l2(control),
        "rel_l2_predict_depth": rel_l2(preds[0]),
        "max_abs_err": float(np.abs(raw[0] - want).max()),
        "raw_range": [float(raw.min()), float(raw.max())],
        "dpt_seconds": seconds, "frames": n_frames,
        "dpt_peak_memory_bytes_above_weights": peak,
        "input": list(frames.shape[1:3]), "layers": card.config.num_layers,
    }
    for k, v in result.items():
        print(f"[dpt] {k}: {v}", flush=True)
    check_control("[dpt] card (TF32 off) vs CPU", result["rel_l2_cli_tf32_off"],
                  result["rel_l2_tf32_control"], DPT_REL_L2)
    if rel_l2(preds[0]) > DPT_REL_L2:
        raise AssertionError(f"[dpt] predict_depth vs CPU: rel L2 {rel_l2(preds[0])}")
    return result


def check_control(what: str, sound: float, control: float, limit: float,
                  control_name: str = "the TF32-on control") -> None:
    """A sound reading and its control's (an fp32 model against the CPU and
    the same with TF32 on; the sharded edit against one rank and the same
    with no K/V gather): the sound run must read within ``limit`` and the
    control above it, so that the check can tell the fault it guards from
    sound rounding."""
    if not sound <= limit:
        raise AssertionError(f"{what}: rel L2 {sound} > {limit}")
    if not control > limit:
        raise AssertionError(f"{what}: {control_name} reads {control}, within the "
                             f"limit {limit}: the check cannot tell it from the sound run")


def run_depth_path(root: str) -> dict:
    """Depth-conditioned PnP at 512^2: a random DPT-Large checkpoint
    (``build_dpt_checkpoint``, under build/, removed after), preprocess
    ``--sd_version depth --depth_model_dir`` (40 frames, DEPTH_STEPS
    inversion and reconstruction steps; the DPT makes the frames' depth maps
    at 384^2) and a DEPTH_STEPS-step PnP edit with 5 pivots on SD-2-depth's
    5-channel UNet, bf16, random weights, the CLIs run with TF32 on as a
    caller might leave it; then the same edit with ``prop_approx``. K1 (D =
    64 only), K2, K4 and K5 must launch, K3 not. Then ``check_dpt``."""
    from tokenflow_torch import utils

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "dpt_large_random", "model.safetensors")
    try:
        t0 = time.perf_counter()
        build_dpt_checkpoint(ckpt)
        t_ckpt = time.perf_counter() - t0
        with utils.tf32(True):
            report = run_main_path(
                root, inv_steps=DEPTH_STEPS, edit_steps=DEPTH_STEPS, sd_version="depth",
                pre_args=("--depth_model_dir", ckpt),
                variants=(("depth_approx", {"prop_approx": True}, 2),), tag="[pnp 512 depth]",
            )
        report["checkpoint_seconds"] = t_ckpt
        report["dpt"] = check_dpt(ckpt, os.path.join(root, "data", "clip"), 40)
    finally:
        if os.path.exists(ckpt):
            os.remove(ckpt)
    return report


def build_clip_checkpoint(path: str, seed: int = CLIP_SEED) -> str:
    """An HF ``CLIPModel`` checkpoint directory at ``path`` with
    openai/clip-vit-large-patch14's geometry (ViT-L/14: 24 x 1024, 16
    heads, 224^2, patch 14, 257 tokens; the 12 x 768 text tower; 768-wide
    projections) and random weights from ``seed`` (the port's init scales;
    the class embedding normal(0.02), as HF initialises it): one fp32
    model.safetensors of about 1.71 GB under HF's keys, ``position_ids`` and
    ``logit_scale`` among them; a config.json written out here; and a
    vocab.json / merges.txt holding CLIP's 512 byte tokens at their ids, no
    merges and its two special tokens at 49406 / 49407, so that the CLI
    tokenizes the prompt. Returns ``path``."""
    from safetensors.torch import save_file

    from tokenflow_torch.io.tokenizer import _bytes_to_unicode
    from tokenflow_torch.models import weights
    from tokenflow_torch.models.clip_text import CLIPTextConfig
    from tokenflow_torch.models.clip_vision import CLIPScorer, CLIPVisionConfig

    vision, text = CLIPVisionConfig.vit_l_14(), CLIPTextConfig.sd15()
    bos, eos = 49406, 49407
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        scorer = CLIPScorer(vision, text, eos_token_id=eos)
    weights.init_random_(scorer, gen)
    with torch.no_grad():
        scorer.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=gen)
    sd = {k: v.cpu().contiguous() for k, v in scorer.state_dict().items()}
    del scorer
    n_patches = (vision.image_size // vision.patch_size) ** 2 + 1
    sd.update({
        "text_model.embeddings.position_ids":
            torch.arange(text.max_position_embeddings)[None],
        "vision_model.embeddings.position_ids": torch.arange(n_patches)[None],
        "logit_scale": torch.tensor(2.6592),
    })
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    config = {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": vision.projection_dim, "logit_scale_init_value": 2.6592,
        "text_config": {
            "hidden_size": text.hidden_size, "intermediate_size": text.intermediate_size,
            "num_attention_heads": text.num_heads, "num_hidden_layers": text.num_layers,
            "hidden_act": text.hidden_act, "vocab_size": text.vocab_size,
            "max_position_embeddings": text.max_position_embeddings,
            "bos_token_id": bos, "eos_token_id": eos, "pad_token_id": 1,
            "projection_dim": vision.projection_dim,
        },
        "vision_config": {
            "hidden_size": vision.hidden_size,
            "intermediate_size": vision.intermediate_size,
            "num_attention_heads": vision.num_heads, "num_hidden_layers": vision.num_layers,
            "image_size": vision.image_size, "patch_size": vision.patch_size,
            "hidden_act": vision.hidden_act, "projection_dim": vision.projection_dim,
        },
    }
    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab.update({"<|startoftext|>": bos, "<|endoftext|>": eos})
    for name, obj in (("config.json", config), ("vocab.json", vocab)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return path


def check_clip(root: str, exact_dir: str, approx_dir: str, prompt: str) -> dict:
    """``[clip]``: a full-width CLIP checkpoint in HF layout
    (``build_clip_checkpoint``, under build/, removed after); the port's
    ``compare_outputs`` CLI on it (a subprocess, ``--device cuda``) scores
    the PnP 512^2 exact edit's frames against its ``prop_approx`` edit's.
    In this process, the scorer the CLI builds (``load_scorer``, fp32 on the
    card): the seconds of the 40 frames' image features (after a warm-up
    batch) and the peak memory above what was allocated before it; its
    CLIP metrics must agree with the CLI's report to its rounding; its
    image features of CLIP_REF_FRAMES frames and its text features against
    ``load_scorer``'s CPU scorer within CLIP_REL_L2, and once more with TF32
    on around the card's call, a control that must read above that limit.
    ``[prop_approx_ab]``: the port's ``prop_approx_ab`` CLI at its defaults
    (cuda, SD-2.1, 40 x 512^2, random weights) with this checkpoint, in a
    subprocess; its pinned pivots must hold and its report be finite."""
    import shutil

    from tokenflow_torch import utils
    from tokenflow_torch.cli import compare_outputs as co
    from tokenflow_torch.models.clip_vision import preprocess_images

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "clip_vit_l_14_random")
    t_phase = time.perf_counter()
    try:
        build_clip_checkpoint(ckpt)
        t_ckpt = time.perf_counter() - t_phase
        out = os.path.join(root, "clip_report.json")
        cli = run_cli(root, [
            "tokenflow_torch.cli.compare_outputs", os.path.join(exact_dir, "img_ode"),
            os.path.join(approx_dir, "img_ode"), "--clip_ckpt", ckpt, "--prompt", prompt,
            "--device", "cuda", "--out", out,
        ], os.path.join(root, "compare_outputs.log"), tag="[clip]")
        with open(out) as f:
            report = json.load(f)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the held SD stack, among others
        scorer, tok = co.load_scorer(ckpt, "cuda")
        frames = np.stack(co.load_dir(os.path.join(exact_dir, "img_ode")))
        co.image_features(scorer, frames[:16])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        co.image_features(scorer, frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        here = co.clip_metrics(frames, prompt, scorer, tok)

        ref = frames[:CLIP_REF_FRAMES]
        ids = np.asarray([tok(p) for p in (prompt, "a photo of a cat", "ugly, blurry, low res")])
        cpu, _ = co.load_scorer(ckpt, "cpu")
        want_img = co.image_features(cpu, ref).double()
        want_txt = co.text_features(cpu, ids).double()
        del cpu
        card_img = co.image_features(scorer, ref).double().cpu()
        card_txt = co.text_features(scorer, ids).double().cpu()
        with utils.tf32(True), torch.inference_mode():
            pixels = preprocess_images(torch.as_tensor(ref, device="cuda"))
            control_img = scorer.image_features(pixels).double().cpu()
            control_txt = scorer.text_features(
                torch.as_tensor(ids, dtype=torch.long, device="cuda")).double().cpu()
        vision_layers = scorer.vision_config.num_layers
        text_layers = scorer.text_config.num_layers
        del scorer
        torch.cuda.empty_cache()

        ab = run_cli(root, ["tokenflow_torch.cli.prop_approx_ab", os.path.join(root, "ab"),
                            "--clip_ckpt", ckpt], os.path.join(root, "prop_approx_ab.log"),
                     tag="[prop_approx_ab]")
        with open(os.path.join(root, "ab", "approx_ab_report.json")) as f:
            ab_report = json.load(f)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    def rel_l2(got, want):
        return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))

    result = {
        "report": report, "compare_outputs_cli_seconds": cli["seconds"],
        "checkpoint_seconds": t_ckpt,
        "image_features_seconds_40_frames": seconds, "frames": len(frames),
        "peak_memory_bytes_above_phase_start": peak,
        "clip_metrics_in_process": here,
        "rel_l2_image_tf32_off": rel_l2(card_img, want_img),
        "rel_l2_image_tf32_control": rel_l2(control_img, want_img),
        "rel_l2_text_tf32_off": rel_l2(card_txt, want_txt),
        "rel_l2_text_tf32_control": rel_l2(control_txt, want_txt),
        "limit": CLIP_REL_L2, "reference_frames": CLIP_REF_FRAMES,
        "vision_layers": vision_layers, "text_layers": text_layers,
    }
    result["phase_seconds"] = time.perf_counter() - t_phase - ab["seconds"]
    for k, v in result.items():
        print(f"[clip] {k}: {v}", flush=True)
    result["prop_approx_ab"] = {"report": ab_report, "seconds": ab["seconds"]}
    print(f"[prop_approx_ab] report: {ab_report}", flush=True)
    print(f"[prop_approx_ab] seconds: {ab['seconds']}", flush=True)
    check_control("[clip] image features, card (TF32 off) vs CPU",
                  result["rel_l2_image_tf32_off"], result["rel_l2_image_tf32_control"],
                  CLIP_REL_L2)
    check_control("[clip] text features, card (TF32 off) vs CPU",
                  result["rel_l2_text_tf32_off"], result["rel_l2_text_tf32_control"],
                  CLIP_REL_L2)
    # the CLI and this process read the same checkpoint: the same metrics
    # up to the report's rounding (4 and 3 decimals)
    for key, unit in (("clip_temporal_consistency", 1e-4), ("clip_score_mean", 1e-3),
                      ("clip_score_min", 1e-3)):
        for name, rep in (("compare_outputs", report), ("prop_approx_ab", ab_report)):
            if not np.isfinite(rep[key]):
                raise AssertionError(f"[clip] {name} {key} is not finite: {rep[key]}")
        if abs(report[key] - here[key]) > unit * 1.01:
            raise AssertionError(f"[clip] {key}: the CLI reads {report[key]}, this process "
                                 f"{here[key]}")
    for name, rep in (("compare_outputs", report), ("prop_approx_ab", ab_report)):
        if rep["frames_compared"] != len(frames) or not np.isfinite(rep["psnr_mean"]):
            raise AssertionError(f"[clip] {name}: PSNR report {rep}")
    return result


def run_cli(root: str, args: list, log: str, kill_when: str | None = None,
            tag: str = "[resume]") -> dict:
    """One of the port's CLIs (``python -m <args>``) in a subprocess from
    ``root``, its output to ``log``. With ``kill_when`` (a glob under
    ``root``), SIGKILL it as soon as a file matches; a run that ends before
    that is an error, and so is one that takes more than CLI_SECONDS.
    Returns its seconds, return code, whether it was killed, and its
    output; ``tag`` names the phase in its errors."""
    import glob
    import signal

    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               # random-init stacks tokenize with HashTokenizer, which hashes
               # words with Python's hash(), salted per process: pinned, every
               # process gives a prompt the same ids, so a checkpoint's token
               # ids match and a resumed run may take it up
               PYTHONHASHSEED="0")
    t0 = time.perf_counter()
    killed = False
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=root, env=env,
                                stdout=out, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                if kill_when and glob.glob(os.path.join(root, kill_when), recursive=True):
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    killed = True
                    break
                if time.perf_counter() - t0 > CLI_SECONDS:
                    raise AssertionError(f"{tag} {args[0]} ran past {CLI_SECONDS} s")
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as f:
        text = f.read()
    seconds = time.perf_counter() - t0
    if kill_when and not killed:
        raise AssertionError(f"{tag} {args[0]} ended (rc {proc.returncode}) before "
                             f"{kill_when} appeared: the kill landed too late\n{text[-3000:]}")
    if not kill_when and proc.returncode != 0:
        raise AssertionError(f"{tag} {args[0]} failed, rc {proc.returncode}\n{text[-3000:]}")
    return {"seconds": seconds, "rc": proc.returncode, "killed": killed, "output": text}


def _frames_of(root: str, results: str) -> np.ndarray:
    """The img_ode/ frames an edit wrote under ``root/results*``, as uint8."""
    import glob

    from PIL import Image

    (d,) = glob.glob(os.path.join(root, results + "*", "**", "img_ode"), recursive=True)
    return np.stack([np.asarray(Image.open(p)) for p in sorted(glob.glob(f"{d}/*.png"))])


def _trajectory_of(root: str, save_dir: str) -> dict:
    import glob

    (path,) = glob.glob(os.path.join(root, save_dir, "**", "trajectory.npz"), recursive=True)
    with np.load(path) as f:
        return {k: f[k] for k in ("traj", "final")}


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
               for k in a)


def run_resume_path(root: str) -> dict:
    """``[resume]``: checkpoint/resume through the port's CLIs, each in a
    subprocess, at 40 x 512^2, SD-2.1, bf16, random weights from a seed:
    RESUME_INV_STEPS inversion steps (save RESUME_SAVE_STEPS), segments of
    RESUME_INV_SEGMENT, and a RESUME_EDIT_STEPS-step PnP edit in segments of
    RESUME_EDIT_SEGMENT with pinned pivots.
      (a) the uninterrupted reference: preprocess, then run_pnp;
      (b) preprocess --checkpoint_inversion --then_edit <YAML with
          checkpoint_edit: true>, SIGKILLed as soon as
          inversion_checkpoint.npz appears;
      (c) the same command: it must print the inversion's resume line, and
          is SIGKILLed as soon as edit_checkpoint.npz appears;
      (d) run_pnp on the same YAML: it must print the edit's resume line.
    (c)'s trajectory and (d)'s frames must equal (a)'s bit for bit, and no
    checkpoint may remain. If they differ, a second uninterrupted
    reference measures how far two processes differ, and the resumed run
    is held to that."""
    import yaml

    write_frames(root, 40, 512)
    rng = np.random.default_rng(5)
    window = 8
    pivots = (rng.integers(0, window, (RESUME_EDIT_STEPS, 40 // window))
              + np.arange(0, 40, window)).tolist()

    def pre_args(save_dir):
        return ["tokenflow_torch.cli.preprocess", "--data_path", "data/clip",
                "--H", "512", "--W", "512", "--sd_version", "2.1", "--init", "random",
                "--dtype", "bf16", "--n_frames", "40", "--batch_size", "40",
                "--steps", str(RESUME_INV_STEPS), "--save_steps", str(RESUME_SAVE_STEPS),
                "--device", "cuda", "--skip_reconstruction", "--save_dir", save_dir]

    def edit_config(name, save_dir, **kw):
        cfg = {
            "seed": 1, "device": "cuda", "output_path": f"results_{name}",
            "data_path": "data/clip", "latents_path": save_dir,
            "n_inversion_steps": RESUME_INV_STEPS, "n_frames": 40, "sd_version": "2.1",
            "init": "random", "dtype": "bf16", "guidance_scale": 7.5,
            "n_timesteps": RESUME_EDIT_STEPS,
            "prompt": "a marble sculpture of a woman running",
            "negative_prompt": "ugly, blurry, low res", "batch_size": window,
            "pnp_attn_t": 0.5, "pnp_f_t": 0.8, "pivot_indices": pivots, **kw,
        }
        path = os.path.join(root, f"config_{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return os.path.basename(path)

    def log(name):
        return os.path.join(root, f"{name}.log")

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ref_yaml = edit_config("ref", "latents_ref")
    ck_yaml = edit_config("ck", "latents_ck", checkpoint_edit=True,
                          steps_per_dispatch=RESUME_EDIT_SEGMENT)
    ck_pre = pre_args("latents_ck") + [
        "--checkpoint_inversion", "--steps_per_dispatch", str(RESUME_INV_SEGMENT),
        "--then_edit", ck_yaml]
    runs = {
        "a_preprocess": run_cli(root, pre_args("latents_ref"), log("a_preprocess")),
        "a_run_pnp": run_cli(root, ["tokenflow_torch.cli.run_pnp", "--config_path", ref_yaml],
                             log("a_run_pnp")),
        "b_killed_in_inversion": run_cli(root, ck_pre, log("b"),
                                         kill_when="latents_ck/**/inversion_checkpoint.npz"),
        "c_resumed_inversion_killed_in_edit": run_cli(
            root, ck_pre, log("c"), kill_when="results_ck*/**/edit_checkpoint.npz"),
        "d_resumed_edit": run_cli(root, ["tokenflow_torch.cli.run_pnp", "--config_path",
                                         ck_yaml], log("d")),
    }
    lines = {name: [line for line in r["output"].splitlines() if "resuming at segment" in line]
             for name, r in runs.items()}
    for name, r in runs.items():
        print(f"[resume] {name}: {r['seconds']:.2f} s, rc {r['rc']}, killed {r['killed']}, "
              f"resume lines {lines[name]}", flush=True)
    inv_line = [x for x in lines["c_resumed_inversion_killed_in_edit"]
                if "inversion_checkpoint.npz" in x]
    edit_line = [x for x in lines["d_resumed_edit"] if "edit_checkpoint.npz" in x]
    if not inv_line:
        raise AssertionError("[resume] (c) did not resume the inversion")
    if not edit_line:
        raise AssertionError("[resume] (d) did not resume the edit")
    if lines["b_killed_in_inversion"] or lines["a_preprocess"] or lines["a_run_pnp"]:
        raise AssertionError(f"[resume] a run resumed that had nothing to resume: {lines}")

    traj_ref, traj_ck = _trajectory_of(root, "latents_ref"), _trajectory_of(root, "latents_ck")
    frames_ref, frames_ck = _frames_of(root, "results_ref"), _frames_of(root, "results_ck")
    result = {
        "inversion_resume_line": inv_line[0], "edit_resume_line": edit_line[0],
        "seconds": {name: r["seconds"] for name, r in runs.items()},
        "trajectory_bitwise_equal": all(np.array_equal(traj_ref[k], traj_ck[k])
                                        for k in traj_ref),
        "frames_bitwise_equal": np.array_equal(frames_ref, frames_ck),
        "trajectory_max_abs_diff": _max_diff(traj_ref, traj_ck),
        "frames_max_abs_diff": _max_diff({"f": frames_ref}, {"f": frames_ck}),
        "frames": list(frames_ck.shape),
    }
    import glob

    left = glob.glob(os.path.join(root, "**", "*checkpoint*.npz"), recursive=True)
    if left:
        raise AssertionError(f"[resume] checkpoints remain: {left}")
    if not (result["trajectory_bitwise_equal"] and result["frames_bitwise_equal"]):
        # how far two uninterrupted runs in separate processes differ
        run_cli(root, pre_args("latents_ref2"), log("a2_preprocess"))
        run_cli(root, ["tokenflow_torch.cli.run_pnp", "--config_path",
                       edit_config("ref2", "latents_ref2")], log("a2_run_pnp"))
        result["reference_repeat_trajectory_max_abs_diff"] = _max_diff(
            traj_ref, _trajectory_of(root, "latents_ref2"))
        result["reference_repeat_frames_max_abs_diff"] = _max_diff(
            {"f": frames_ref}, {"f": _frames_of(root, "results_ref2")})
    result["phase_seconds"] = time.perf_counter() - t_phase
    for k, v in result.items():
        print(f"[resume] {k}: {v}", flush=True)
    if not (result["trajectory_bitwise_equal"] and result["frames_bitwise_equal"]):
        if (result["trajectory_max_abs_diff"]
                > result["reference_repeat_trajectory_max_abs_diff"]
                or result["frames_max_abs_diff"] > result["reference_repeat_frames_max_abs_diff"]):
            raise AssertionError("[resume] the resumed run differs from the uninterrupted one "
                                 "by more than two uninterrupted runs differ")
    return result


# the [sharded] phase (run_sharded_path): two ranks of a gloo group on the
# one card, PnP 512^2 on the main path's latents (40 frames, window 8, so 5
# pivots: 3 + 2 keyframes with shard_pivotal), the main path's pivot table
SHARDED_RANKS = 2
# a rank's work ends the run if the phase takes longer (a hung collective)
SHARDED_SECONDS = 420
# bf16: the 10-step edit with shard_pivotal against the single-rank edit,
# rel L2 of the latents. Not a test of the K/V gather: bf16 rounding of
# other batch shapes, amplified by random weights, moves this edit as far as
# the single rank's own chunking does (up to 0.0498 between propagate
# chunks of 20 and 40 frames) and as far as a missing gather does (0.045
# after one step; PERF.md §6, frames sharding). Twice that catches gross faults
# (frame order, a lost block: rel L2 near 1). Without shard_pivotal every
# UNet call has the reference's shapes, and the edit must equal it bit for
# bit.
SHARDED_BF16_REL_L2 = 0.1
# fp32 (TF32 off, the fp32 kernels): each of the first SHARDED_F32_STEPS
# steps from the single-rank edit's latents against that edit's step, rel
# L2 of the latents; near the geometric mean of the largest sound reading
# with shard_pivotal (7.1e-5) and the largest of the control that attends
# over the rank's own keyframes only (4.8e-3), on the H100 (PERF.md §6)
SHARDED_F32_STEPS = 2
SHARDED_F32_REL_L2 = 5e-4
# the fp32 runs of each rank: (name, shard_pivotal, K/V gathered)
SHARDED_RUNS = (("shard_pivotal", True, True), ("replicated_pivotal", False, True),
                ("no_gather_control", True, False))

# the [fused] phase (run_fused_path): the single-pass fused step on the main
# path's latents and pivot table (PnP 512^2, SD-2.1, 40 frames, window 8, so
# 5 pivots: one UNet call a step on 3 x 5 + 3 x 40 items)
# fused and two-pass edits in turns, this many each, of the edit's first
# FUSED_READING_STEPS steps (q/k and conv injection on in all of them)
FUSED_READINGS = 3
FUSED_READING_STEPS = 5
# fp32 (TF32 off, the fp32 kernels): each of the first FUSED_F32_STEPS steps,
# fused, from the two-pass edit's latents against that edit's step, rel L2
# of the latents. Sound: the two passes' maths in other batch shapes, so
# fp32 rounding and near-tie flips only. The control feeds the frames the
# other step's pivot segment, so that they propagate from a cache of other
# latents. On the H100 the sound steps read 1.60e-4 and 3.90e-5, the control
# 0.835 and 0.392 in a dev call (PERF.md §6); the limit is ~3x the larger sound
# reading, as the sharded pivotal pass's (other batch shapes too), since
# the readings move between processes with the hash-salted prompt ids
FUSED_F32_STEPS = 2
FUSED_F32_REL_L2 = 5e-4
# fused steps traced under profiling.trace
FUSED_TRACE_STEPS = 2
# the phase ends the run if it takes longer (a hung kernel); it took 62.4 s
FUSED_SECONDS = 240


def sharded_kernel_rows(group) -> dict:
    """B3 on the card, on one rank, through the ops entries that take a
    rank's share: K1 through the two-stream ``extended_attention`` with the
    group on the rank's keyframes of the 512^2 pivotal pass's top level (5
    keyframes x 4096 tokens, 5 heads of 64; this rank's keyframes of
    ``split_counts``) against the gathered K/V, and K2 through
    ``token_propagation`` on the rank's frames (F = 40, 4096 x 320, 5
    pivots, separated inputs), each equal bit for bit to those rows of the
    same call's unsharded launch on the same seeded inputs."""
    from tokenflow_torch.ops.extended_attention import extended_attention
    from tokenflow_torch.ops.propagation import token_propagation
    from tokenflow_torch.sharding import mesh

    gen = torch.Generator(device="cuda").manual_seed(0)  # the same on every rank
    kf, s, h, d = 5, 4096, 5, 64
    q, k, v = (torch.randn((2, kf, s, h * d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    counts = mesh.split_counts(kf, group.world)
    mine = slice(sum(counts[: group.rank]), sum(counts[: group.rank + 1]))
    rows = slice(mine.start * s, mine.stop * s)
    got = extended_attention(q[:, mine], k[:, mine], v[:, mine], heads=h, kv_block=1024,
                             group=group, kf_counts=counts)
    want = extended_attention(q, k, v, heads=h, kv_block=1024)[:, mine]
    k1_equal = torch.equal(got, want)
    args = _match_inputs(gen, 4096, 320, "separated", 40, 5)
    local = [group.local(a) for a in (args[0], *args[3:])]
    got = token_propagation(local[0], args[1], args[2], *local[1:])
    want = token_propagation(*args)[:, group.frame_slice(40)]
    k2_equal = torch.equal(got, want)
    if not (k1_equal and k2_equal):
        raise AssertionError(f"[sharded] rank {group.rank}: sharded rows differ from the "
                             f"unsharded launch (K1 equal {k1_equal}, K2 equal {k2_equal})")
    return {"k1_rows": [rows.start, rows.stop], "k1_sq_skv": [rows.stop - rows.start, kf * s],
            "k2_frames": list(group.frame_slice(40).indices(40)[:2]),
            "k1_bitwise": k1_equal, "k2_bitwise": k2_equal}


def _sharded_rank(rank: int, spec: dict) -> None:
    """One rank of ``run_sharded_path`` (a spawned process): the kernel rows;
    the bf16 edit with shard_pivotal and without, each with the counts
    zeroed just before and read just after; then, on the fp32 stack, each
    of the first steps from the single-rank latents with shard_pivotal,
    without, and with no K/V gather (the control). Rank 0 gathers the
    latents. Writes rank<r>.json (and rank 0 the latents) under
    ``spec["out"]``."""
    from tokenflow_torch import runtime
    from tokenflow_torch.cli import common
    from tokenflow_torch.editing import pipeline
    from tokenflow_torch.profiling import PhaseMetrics
    from tokenflow_torch.sharding import mesh

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dev = torch.device(spec["device"])
    group = mesh.init_frames_group(rank, spec["world"], dev, backend="gloo",
                                   init_method=spec["init"])
    print(group.describe(), flush=True)
    inputs = torch.load(spec["inputs"], weights_only=False)
    schedule, pivots = inputs["schedule"], inputs["pivots"]
    n_steps = len(schedule.timesteps)
    result = {"rank": rank, "backend": group.backend, "transport": group.transport,
              "kernel_rows": sharded_kernel_rows(group)}
    gather = mesh.all_gather_along

    def local_kv(group, t, axis, sizes, kind):
        """The control: K/V of the rank's own keyframes, no gather."""
        return t if kind == "kv_all_gather" else gather(group, t, axis, sizes, kind)

    def zero():
        zero_counts()
        group.bytes_sent.clear()

    def counts(n):
        return {
            "launches": read_counts(),
            "collective_bytes_per_step": {k: v / n for k, v in group.bytes_sent.items()},
        }

    outs = {}
    for dtype in ("bf16", "f32"):
        part = inputs[dtype]
        stack = runtime.load_stack(spec["sd_version"], device=dev,
                                   dtype=part["xs"].dtype, init="random")
        traj = group.local(part["traj"].to(dev), 1)
        embeds3 = part["embeds3"].to(dev)

        def edit(x, sched, piv, shard, phase=lambda n: contextlib.nullcontext()):
            return pipeline.tokenflow_sample_loop(
                stack.unet_apply, group.local(x.to(dev)), traj, embeds3, sched,
                window_size=spec["window"], guidance_scale=7.5, pnp=True,
                pivot_indices=piv, phase=phase, group=group, shard_pivotal=shard)

        if dtype == "bf16":  # the edit as it runs: counted and timed
            for name, shard, _ in SHARDED_RUNS[:2]:
                metrics = PhaseMetrics()
                zero()
                with common.device_phase(metrics, "edit", group.device, group):
                    out = edit(part["xs"][0], schedule, pivots, shard,
                               lambda n: common.device_phase(metrics, n, group.device, group))
                ph = metrics.phases
                result[name] = {
                    **counts(n_steps),
                    "pivotal_seconds_per_step": ph["pivotal"] / n_steps,
                    "propagate_seconds_per_step": ph["propagate"] / n_steps,
                    "edit_seconds": ph["edit"],
                }
                outs[name] = mesh.gather_to_rank0(group, out)
            continue
        # fp32: each step from the single-rank edit's latents there
        segments = pipeline.split_schedule(schedule, 1)[:SHARDED_F32_STEPS]
        for name, shard, kv_gather in SHARDED_RUNS:
            mesh.all_gather_along = gather if kv_gather else local_kv
            zero()
            try:
                steps = [mesh.gather_to_rank0(group, edit(part["xs"][i], seg,
                                                          pivots[i : i + 1], shard))
                         for i, seg in enumerate(segments)]
            finally:
                mesh.all_gather_along = gather
            result[f"f32_{name}"] = counts(len(segments))
            if rank == 0:
                outs[f"f32_{name}_steps"] = torch.stack(steps)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in outs.items()}, os.path.join(spec["out"], "latents.pt"))
    mesh.barrier(group)


def check_sharded_launches(ranks: list) -> None:
    """On every rank, in bf16 and fp32: K1 and K2 launched, and the pivotal
    pass's K/V all-gathered (``kv_all_gather`` bytes) exactly with
    shard_pivotal (without it the pivotal pass is whole); no kernel off the
    PnP 512^2 path or of the other dtype."""
    for r in ranks:
        for name, shard in (("shard_pivotal", True), ("replicated_pivotal", False)):
            for prefix, want, not_want in (
                    ("", PATH_BF16,
                     F32_KERNELS + ("group_norm_f32",)),
                    ("f32_", ("flash_attention_f32", "token_match_f32") + NORMS_F32,
                     BF16_KERNELS + ("group_norm_bf16",))):
                run = r[prefix + name]
                kv_bytes = run["collective_bytes_per_step"].get("kv_all_gather", 0)
                if (kv_bytes > 0) != shard:
                    raise AssertionError(
                        f"[sharded] rank {r['rank']} {prefix}{name}: the pivotal pass "
                        f"all-gathered {kv_bytes} K/V bytes a step with shard_pivotal {shard}")
                check_launched(run["launches"], f"sharded rank {r['rank']} {prefix}{name}",
                               want, ("token_match_gather_split", "token_match_split_f32")
                               + not_want)


def latents_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main_edit_of(out_dir: str) -> tuple[dict, np.ndarray]:
    """The config and pivot table of the PnP edit written to ``out_dir``."""
    import yaml

    with open(os.path.join(out_dir, "config.yaml")) as f:
        config = yaml.safe_load(f)
    with open(os.path.join(out_dir, "pivots.json")) as f:
        return config, np.asarray(json.load(f)["pivot_indices"], np.int32)


def editor_inputs(root: str, config: dict, dtype: str, output_path: str) -> tuple:
    """The PnP editor's inputs of ``config`` with the stack in ``dtype``, read
    from the path's ``root``: (EditorData, edit schedule, start latents,
    trajectory), the latents and trajectory on the card in the stack's
    dtype."""
    from tokenflow_torch.cli import common
    from tokenflow_torch.diffusion import ddim
    from tokenflow_torch.editing import pipeline

    cwd = os.getcwd()
    os.chdir(root)
    try:
        data = common.setup_editor(dict(config, dtype=dtype, output_path=output_path))
    finally:
        os.chdir(cwd)
    sched = ddim.make_schedule(config["n_timesteps"])
    schedule = pipeline.make_edit_schedule(sched, data.trajectory.save_ts,
                                           pnp_attn_t=config["pnp_attn_t"],
                                           pnp_f_t=config["pnp_f_t"])
    x_init = ddim.add_noise(data.latents, data.eps,
                            sched.alphas_cumprod[sched.timesteps[0]]).to(data.stack.dtype)
    traj = torch.as_tensor(data.trajectory.traj, device=data.stack.device).to(data.stack.dtype)
    return data, schedule, x_init, traj


def run_sharded_path(root: str, main_out_dir: str) -> dict:
    """``[sharded]``: the port's frames sharding on the card, on the main
    path's latents (run from its ``root``) and pivot table. This process
    runs the PnP edit on one rank (the reference, propagating in chunks of
    a rank's frames so that each UNet call has a rank's batch), then spawns
    SHARDED_RANKS ranks of a gloo group (``file://`` init) that share
    cuda:0 (NCCL refuses two ranks on one GPU) and stage their collectives
    through host memory. Each rank checks K1 and K2 through the ops entries
    with its share bit for bit against the unsharded launches
    (``sharded_kernel_rows``) and runs the bf16 10-step edit with
    shard_pivotal (3 + 2 keyframes) and without: both must launch K1 and
    K2, and all-gather the pivotal pass's K/V exactly with shard_pivotal
    (``check_sharded_launches``), the edit without
    shard_pivotal must equal the reference bit for bit, and the one with it
    must read within SHARDED_BF16_REL_L2 (gross faults only: bf16 cannot
    hold the K/V gather, see the constant). The gather itself is held in
    fp32 (TF32 off, the fp32 kernels), where the batch shapes move the edit
    by fp32 rounding only: each of the first SHARDED_F32_STEPS steps from
    the single-rank latents, with shard_pivotal, without, and with no K/V
    gather (the control): the sound runs within SHARDED_F32_REL_L2 of the
    single-rank step, the control above it (``check_control``). Two ranks on
    one card prove correctness and the sharded launches, not NCCL scaling."""
    from tokenflow_torch.cli import common
    from tokenflow_torch.editing import pipeline
    from tokenflow_torch.profiling import PhaseMetrics

    t_phase = time.perf_counter()
    config, pivots = main_edit_of(main_out_dir)
    out = os.path.join(root, "sharded")
    os.makedirs(out)
    chunk = config["n_frames"] // SHARDED_RANKS
    inputs, single = {"pivots": pivots}, {}
    for dtype in ("bf16", "f32"):
        data, schedule, x_init, traj = editor_inputs(root, config, dtype,
                                                     os.path.join(out, dtype))
        segments = pipeline.split_schedule(schedule, 1)
        if dtype == "f32":
            segments = segments[:SHARDED_F32_STEPS]

        def run(x, seg, piv, propagate_chunk, metrics):
            return pipeline.tokenflow_sample_loop(
                data.stack.unet_apply, x, traj, data.embeds3, seg,
                window_size=config["batch_size"], guidance_scale=config["guidance_scale"],
                pnp=True, pivot_indices=piv, propagate_chunk=propagate_chunk,
                phase=lambda n: common.device_phase(metrics, n, data.stack.device))

        metrics = PhaseMetrics()
        if dtype == "bf16":  # the edit whole, and once more in one chunk
            xs = torch.stack([x_init, run(x_init, schedule, pivots, chunk, metrics)])
            whole = run(x_init, schedule, pivots, None, PhaseMetrics()).cpu()
        else:  # each step from the reference's own latents
            xs = [x_init]
            for i, seg in enumerate(segments):
                xs.append(run(xs[-1], seg, pivots[i : i + 1], chunk, metrics))
            xs = torch.stack(xs)
        single[dtype] = {f"{n}_seconds_per_step": metrics.phases[n] / len(segments)
                         for n in ("pivotal", "propagate")}
        inputs[dtype] = {"xs": xs.cpu(), "traj": traj.cpu(), "embeds3": data.embeds3.cpu()}
        inputs["schedule"] = schedule
        device = data.stack.device
        del data, traj, x_init
        torch.cuda.empty_cache()
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    spec = {"world": SHARDED_RANKS, "window": config["batch_size"], "device": str(device),
            "sd_version": config["sd_version"],
            "init": "file://" + os.path.join(out, "group_init"),
            "inputs": os.path.join(out, "inputs.pt"), "out": out}
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_sharded_rank, args=(spec,), nprocs=SHARDED_RANKS,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + SHARDED_SECONDS
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"[sharded] ranks ran past {SHARDED_SECONDS} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    ranks = []
    for r in range(SHARDED_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    lat = torch.load(os.path.join(out, "latents.pt"))
    ref, ref32 = inputs["bf16"]["xs"][-1], inputs["f32"]["xs"]
    edits = {name: latents_rel_l2(lat[name], ref) for name, _, _ in SHARDED_RUNS[:2]}
    f32_steps = {name: [latents_rel_l2(y, x) for y, x in zip(lat[f"f32_{name}_steps"],
                                                               ref32[1:])]
                 for name, _, _ in SHARDED_RUNS}
    report = {
        "card": card_line(), "ranks": SHARDED_RANKS, "backend": ranks[0]["backend"],
        "transport": ranks[0]["transport"],
        "bf16_edit_rel_l2_vs_single_rank": edits,
        "bf16_replicated_bitwise": torch.equal(lat["replicated_pivotal"], ref),
        "bf16_single_rank_chunk_vs_whole": latents_rel_l2(ref, whole),
        "bf16_edit_rel_l2_limit": SHARDED_BF16_REL_L2,
        "f32_step_rel_l2_vs_single_rank": f32_steps, "f32_step_rel_l2_limit": SHARDED_F32_REL_L2,
        "single_rank_seconds_per_step": single,
        "finite": all(bool(torch.isfinite(v).all()) for v in lat.values()),
    }
    for r in ranks:
        for name in [n for n, _, _ in SHARDED_RUNS[:2]] + [f"f32_{n}" for n, _, _ in SHARDED_RUNS]:
            run_ = r[name]
            steps = (f", s/step pivotal {run_['pivotal_seconds_per_step']:.4f} propagate "
                     f"{run_['propagate_seconds_per_step']:.4f}"
                     if "pivotal_seconds_per_step" in run_ else "")
            n = run_["launches"]
            print(f"[sharded] rank {r['rank']} {name}: K1 launches "
                  f"{n['flash_attention'] + n['flash_attention_f32']}, K2 launches "
                  f"{n['token_match_gather'] + n['token_match_f32']}{steps}, collective "
                  f"bytes/step {run_['collective_bytes_per_step']}, transport "
                  f"{r['transport']}", flush=True)
        print(f"[sharded] rank {r['rank']} kernel rows: {r['kernel_rows']}", flush=True)
    report["per_rank"] = ranks
    report["seconds"] = time.perf_counter() - t_phase
    print(f"[sharded] {report['card']}: single rank s/step {single}; bf16 10-step edit rel "
          f"L2 against it {edits} (limit {SHARDED_BF16_REL_L2}; without shard_pivotal bit "
          f"for bit: {report['bf16_replicated_bitwise']}; the single rank's own chunk of "
          f"{chunk} against {config['n_frames']} frames "
          f"{report['bf16_single_rank_chunk_vs_whole']}); fp32, each step "
          f"from its latents {f32_steps} (limit {SHARDED_F32_REL_L2} on the largest, which "
          f"the control's must exceed); two ranks share one card and stage through the "
          f"host: correctness and launches, not NCCL scaling; phase "
          f"{report['seconds']:.1f} s", flush=True)
    if not report["finite"]:
        raise AssertionError("[sharded] non-finite latents")
    if not report["bf16_replicated_bitwise"]:
        raise AssertionError("[sharded] bf16 edit without shard_pivotal differs from the "
                             "single-rank edit of the same batch shapes")
    if not edits["shard_pivotal"] <= SHARDED_BF16_REL_L2:
        raise AssertionError(f"[sharded] bf16 edit with shard_pivotal: rel L2 "
                             f"{edits['shard_pivotal']} > {SHARDED_BF16_REL_L2}")
    for name in ("shard_pivotal", "replicated_pivotal"):
        check_control(f"[sharded] fp32 {name}, each step vs single rank",
                      max(f32_steps[name]), max(f32_steps["no_gather_control"]),
                      SHARDED_F32_REL_L2, control_name="the no-gather control")
    check_sharded_launches(ranks)
    report["launches"] = {n: sum(r["shard_pivotal"]["launches"][n] for r in ranks)
                          for n in ranks[0]["shard_pivotal"]["launches"]}
    return report


def trace_kernels(trace_dir: str) -> dict:
    """The one ``*.pt.trace.json`` that ``profiling.trace`` wrote to
    ``trace_dir``: its size and the count of its device kernel events by
    kernel family (K1: ``flash_fwd``, the match core: ``match_core``,
    others)."""
    import glob

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"[fused] the trace dir holds {files}, not one trace")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    counts = {"flash_fwd": 0, "match_core": 0, "other": 0}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")
            family = next((k for k in ("flash_fwd", "match_core") if k in name), "other")
            counts[family] += 1
    return {"file": os.path.basename(files[0]), "bytes": os.path.getsize(files[0]),
            "kernel_events": counts}


def run_fused_path(root: str, main_out_dir: str, two_pass: dict) -> dict:
    """``[fused]``: the single-pass fused step (``fused_step: true``,
    ``EditMode.FUSED``) on the main path's latents (run from its ``root``)
    and pivot table. The 10-step bf16 edit through ``run_pnp`` (counts
    zeroed just before, read just after): its K1 and K2 launches must equal
    those of ``two_pass``, the main path's second two-pass edit through the
    same CLI (K2 at three streams only; no K3, K4 or fp32 kernel). Then, on
    a held bf16 stack, fused and two-pass edits of the first
    FUSED_READING_STEPS steps in turns, FUSED_READINGS each (host clock
    after a synchronize; peak ``max_memory_allocated`` of each kind), the
    fused latents within SHARDED_BF16_REL_L2 of the two-pass ones (bf16 on
    random weights tells only gross faults from a change of batch shape,
    see that constant); FUSED_TRACE_STEPS fused steps under
    ``profiling.trace``, whose trace must hold K1's (``flash_fwd``) and
    the match core's (``match_core``) kernels; and, on the fp32 stack
    (TF32 off), each of the first FUSED_F32_STEPS steps fused from the
    two-pass edit's latents against that edit's step, within
    FUSED_F32_REL_L2, with a control that feeds the frames the other step's
    pivot segment and must read above it (``check_control``)."""
    from tokenflow_torch import profiling
    from tokenflow_torch.cli import run_pnp
    from tokenflow_torch.editing import pipeline

    t_phase = time.perf_counter()
    config, pivots = main_edit_of(main_out_dir)
    n_steps, kf = config["n_timesteps"], config["n_frames"] // config["batch_size"]
    out = os.path.join(root, "fused")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        cli = run_variant(run_pnp, dict(config, pivot_indices=pivots.tolist()), "pnp_fused",
                          {"fused_step": True}, n_steps,
                          PATH_BF16,
                          ("token_match_gather_split", "group_norm_f32") + F32_KERNELS, 3)
    finally:
        os.chdir(cwd)
    for name in ("flash_attention", "token_match_gather"):
        if cli["launches"][name] != two_pass["launches"][name]:
            raise AssertionError(f"[fused] {name} launched {cli['launches'][name]} times, the "
                                 f"two-pass edit {two_pass['launches'][name]}")

    def loop(stack, traj, embeds3, x, schedule, piv, fused, unet=None):
        return pipeline.tokenflow_sample_loop(
            unet or stack.unet_apply, x, traj, embeds3, schedule,
            window_size=config["batch_size"], guidance_scale=config["guidance_scale"],
            pnp=True, pivot_indices=piv, fused=fused)

    data, schedule, x_init, traj = editor_inputs(root, config, "bf16", os.path.join(out, "bf16"))
    first = pipeline.split_schedule(schedule, FUSED_READING_STEPS)[0]
    seconds, peaks, lat = {"fused": [], "two_pass": []}, {}, {}
    for _ in range(FUSED_READINGS):
        for name in ("fused", "two_pass"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            y = loop(data.stack, traj, data.embeds3, x_init, first,
                     pivots[:FUSED_READING_STEPS], name == "fused")
            torch.cuda.synchronize()
            seconds[name].append((time.perf_counter() - t0) / FUSED_READING_STEPS)
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())
            lat.setdefault(name, y)
    trace_dir = os.path.join(out, "trace")
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        loop(data.stack, traj, data.embeds3, x_init,
             pipeline.split_schedule(schedule, FUSED_TRACE_STEPS)[0],
             pivots[:FUSED_TRACE_STEPS], True)
    traced = trace_kernels(trace_dir) | {"seconds": time.perf_counter() - t0}
    bf16_rel_l2 = latents_rel_l2(lat["fused"], lat["two_pass"])
    finite = all(bool(torch.isfinite(v).all()) for v in lat.values())
    del data, traj, x_init, lat, y
    torch.cuda.empty_cache()

    # fp32: each step fused from the two-pass edit's latents of that step
    data, schedule, x_init, traj = editor_inputs(root, config, "f32", os.path.join(out, "f32"))
    segments = pipeline.split_schedule(schedule, 1)[:FUSED_F32_STEPS]
    xs = [x_init]
    for i, seg in enumerate(segments):
        xs.append(loop(data.stack, traj, data.embeds3, xs[-1], seg, pivots[i : i + 1], False))
    pivot_segments = []

    def recording(sample, *args, **kw):
        pivot_segments.append(sample[: 3 * kf].clone())
        return data.stack.unet_apply(sample, *args, **kw)

    def other_step(i):
        def unet(sample, *args, **kw):
            sample = torch.cat([pivot_segments[1 - i], sample[3 * kf :]])
            return data.stack.unet_apply(sample, *args, **kw)
        return unet

    f32 = {"sound": [], "control": []}
    for i, seg in enumerate(segments):
        y = loop(data.stack, traj, data.embeds3, xs[i], seg, pivots[i : i + 1], True, recording)
        f32["sound"].append(latents_rel_l2(y, xs[i + 1]))
    for i, seg in enumerate(segments):
        y = loop(data.stack, traj, data.embeds3, xs[i], seg, pivots[i : i + 1], True,
                 other_step(i))
        f32["control"].append(latents_rel_l2(y, xs[i + 1]))
    finite = finite and bool(torch.isfinite(y).all())
    del data, traj, x_init, xs, y, pivot_segments
    torch.cuda.empty_cache()

    report = {
        "card": card_line(),
        "cli": cli,
        "cli_vs_two_pass_cli_seconds_per_step": {
            "fused": cli["fused_seconds_per_step"],
            "two_pass": two_pass["step_seconds"],
        },
        "reading_steps": FUSED_READING_STEPS,
        "seconds_per_step_readings": seconds,
        "seconds_per_step_median": {k: float(np.median(v)) for k, v in seconds.items()},
        "peak_memory_bytes": peaks,
        "bf16_rel_l2_vs_two_pass": bf16_rel_l2,
        "bf16_rel_l2_limit": SHARDED_BF16_REL_L2,
        "trace": traced,
        "f32_step_rel_l2_vs_two_pass": f32,
        "f32_step_rel_l2_limit": FUSED_F32_REL_L2,
        "finite": finite,
        "launches": cli["launches"],
    }
    report["seconds"] = time.perf_counter() - t_phase
    for k, v in report.items():
        if k != "cli":
            print(f"[fused] {k}: {v}", flush=True)
    if not finite:
        raise AssertionError("[fused] non-finite latents")
    if not bf16_rel_l2 <= SHARDED_BF16_REL_L2:
        raise AssertionError(f"[fused] bf16 fused edit: rel L2 {bf16_rel_l2} against the "
                             f"two-pass edit > {SHARDED_BF16_REL_L2}")
    kernels = traced["kernel_events"]
    if not (kernels["flash_fwd"] > 0 and kernels["match_core"] > 0):
        raise AssertionError(f"[fused] the trace names no K1 or no K2 kernel: {kernels}")
    check_control("[fused] fp32, each fused step vs the two-pass step", max(f32["sound"]),
                  min(f32["control"]), FUSED_F32_REL_L2,
                  control_name="the other-step pivot control")
    return report


def main() -> int:
    # phase 0: the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(
        f"[versions] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}",
        flush=True,
    )
    # phase 1: build
    from tokenflow_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[precision] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
        flush=True,
    )
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    with watchdog(K1_PHASE_SECONDS, "K1's checks"):
        kernels = [check_flash(gen)]
    with watchdog(K1_PHASE_SECONDS, "K6's checks"):
        kernels.append(check_short_attention(gen))
    with watchdog(K1_PHASE_SECONDS, "K1-f32's checks"):
        kernels.append(check_flash_f32(gen))
    kernels += [check_token_match(gen), check_token_match_split(gen),
                *check_token_match_f32(gen), check_group_norm(gen), check_layer_norm(gen),
                check_geglu(gen)]
    with watchdog(DIT_PHASE_SECONDS, "the DiT's kernel checks"):
        dit_kernels = check_dit_kernels(gen)

    # phase 3: the paths through the CLIs, each with the counts zeroed
    # just before it and read just after
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        report = run_main_path(root)
        with watchdog(FUSED_SECONDS, "the [fused] phase"):
            fused = run_fused_path(root, report["output_dir"],
                                   report["variants"]["pnp_exact_again"])
        clip = check_clip(root, report["output_dir"],
                          report["variants"]["pnp_approx"]["output_dir"],
                          "a marble sculpture of a woman running")
        with watchdog(SHARDED_SECONDS + 120, "the [sharded] phase"):
            sharded = run_sharded_path(root, report["output_dir"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as root:
        resume = run_resume_path(root)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sdedit_") as root:
        sdedit = run_sdedit_path(root)
    report["reference"] = check_small_reference()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_controlnet_") as root:
        controlnet = run_controlnet_path(root)
    controlnet["reference"] = check_small_reference_controlnet()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_depth_") as root:
        depth = run_depth_path(root)
    depth["reference"] = check_small_reference("depth", modes=(("exact", 3),))
    with watchdog(DIT_PHASE_SECONDS, "the DiT cell's steps"):
        dit_cell = check_dit_cell()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[pnp 512 depth] {card}: " + json.dumps({
        k: depth[k] for k in (
            "inversion_seconds_per_step", "reconstruction_seconds_per_step",
            "edit_pivotal_seconds_per_step", "edit_propagate_seconds_per_step",
            "decode_seconds", "peak_memory_bytes", "launches_per_step",
            "depth_maps_seconds")
    } | {"dpt_seconds_40_frames": depth["dpt"]["dpt_seconds"]}), flush=True)
    # the stack in fp32 (dtype f32): fp32 kernels only, depth cut further
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f32_") as root:
        pnp_f32 = run_main_path(root, "f32", inv_steps=F32_PNP_STEPS,
                                edit_steps=F32_PNP_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sdedit_f32_") as root:
        sdedit_f32 = run_sdedit_path(root, "f32", n_frames=F32_SDEDIT_FRAMES,
                                     inv_steps=F32_SDEDIT_STEPS,
                                     n_timesteps=F32_SDEDIT_STEPS)
    by_path = {"pnp_512": report["launches"], "sdedit_768": sdedit["launches"],
               "controlnet_512": controlnet["launches"], "pnp_512_depth": depth["launches"],
               "pnp_512_f32": pnp_f32["launches"], "sdedit_768_f32": sdedit_f32["launches"],
               "pnp_512_sharded_2_ranks": sharded["launches"],
               "pnp_512_fused": fused["launches"], "hunyuandit_1024": dit_cell["launches"]}
    for path in (report, sdedit, controlnet, depth):  # the approximate edits
        by_path.update({name: v["launches"] for name, v in path["variants"].items()})
    for entry in kernels:
        entry["launches_by_path"] = {
            path: counts[entry["name"]] for path, counts in by_path.items()
        }
        entry["launches"] = sum(entry["launches_by_path"].values())

    # phase 4: result lines
    print(json.dumps({"main_path": report, "sdedit_path": sdedit,
                      "controlnet_path": controlnet, "depth_path": depth,
                      "pnp_f32_path": pnp_f32,
                      "sdedit_f32_path": sdedit_f32, "clip": clip,
                      "resume": resume, "sharded": sharded, "fused": fused,
                      "hunyuandit_cell": dit_cell}), flush=True)
    print(json.dumps({"kernels": kernels, "dit_kernels": dit_kernels}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
