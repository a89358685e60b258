#!/usr/bin/env python3
"""Drive lidog_tpu_torch's serving path and training steps on one CUDA
card and check them.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

  1. the card: name and power limit (nvidia-smi);
  2. build every kernel of both paths from the sources in this checkout
     (one nvcc per CUDA source, in parallel; Triton compiles at first
     launch);
  3. per kernel: the kernel against its plain PyTorch version on the same
     inputs: the forward kernels (KA-KD) at shapes from a full-width
     serving plan of one synthetic scan (KB and KC at every strided
     form's forward), the backward kernels (KE-KH) at shapes from the
     training plan of 4 scans, KA at its L0 shapes too, KA and KE at
     every width pair of MinkUNet34's zconv3 calls at its level of the
     training plan (ZCONV3_WIDTHS), every strided form (STRIDED_FORMS:
     forward, dx through the partner kernel with W^T, and KF's dW, called
     twice and held bitwise equal) there with the bound of a step's 24
     strided launches, the L0 <-> L1 pair also in f32, and KG, KH and KD
     at every (level, width, residual, ReLU) form of its 62 norms
     (BN_FORMS) in bf16, at L0 96 in f32, at an odd width and with a mask
     of no row and of one row, each twice bitwise equal, with the BN bound
     a step; max error relative to max|plain| against a stated bound,
     kernel / plain times (CUDA events), and the kernel's
     least possible time on an H100 (bytes over 3.35 TB/s or operations
     over the peak rate of their type);
  4. full-width serving: Predictor(MinkUNet34, bf16) on a 100,000-point
     scan, 1 warm-up and 5 timed requests; zero overflow, >= 95% of points
     labelled, labels in [0, 7), and every kernel counter equal to its
     launches per forward x requests;
  5. cross-check: the same weights through the Predictor on the CPU (plain
     versions): on a 20,000-point scan and on phase 4's 100,000-point scan
     the voxelization and the plan's integer fields bitwise equal to the
     card's, as the sortless training batch's plan (pos and rep too), and
     on the 20,000-point scan label agreement >= 99%;
  6. full-width training (bench.py's shapes): MinkUNet34 bf16, 4 scans x
     100,000 points, SoftDICE + Adam (lr 1e-3), 1 warm-up and 5 timed
     steps on the same batch; zero overflow, finite losses with the last
     below the first, confusion totals equal to the supervised voxels, and
     every kernel counter equal to its launches per step x steps; then the
     stage split of one more step;
  7. train cross-check: one f32 step of full-width MinkUNet34 on a
     20,000-point scan on the card and on the CPU from the same weights:
     loss, every grad, the params after Adam and the batch_stats within
     stated bounds;
  8. the BEV kernels KI and KJ against their plain versions at the
     training plan's level 0 (491,520 rows x 96, ReLU-like features), bf16
     and f32: KI equal, KJ within 1 ulp of the dtype per element, each
     twice bitwise equal; KI also beside one scatter_reduce_ call
     (library_ms), its device ms split into the fill and the scatter;
     then, untimed on the same rows, in bf16 pool strides 1, 2 and 5, C =
     98 (the 4-byte form), 128 and 256, and a mask of no row and of one
     row, and in f32 C = 98 (the 4-byte form);
  9. full-width LiDOG training (bench_lidog.py's shapes): MinkUNet34BEV
     bf16, 4 scans x 100,000 points through the host BEV preprocessing
     (head 167, level block8), SoftDICE + DICE, Adam (lr 1e-3), warm-up
     0; 1 warm-up and 5 timed steps; zero overflow, finite total, sem and
     bev losses with the last total below the first, proj_iou in [0, 1],
     and every counter equal to its launches per step x steps (KI = KJ =
     1 per step); then the stage split of one more step;
 10. BEV head cross-check: bev_scatter_pooled -> Encoder2D -> DICE, forward
     and backward, f32 on one full-grid scan, on the card and on the CPU
     from the same features and weights: the loss within 1e-5, each grad
     in relative L2 within 10x the larger of a 1e-7 weight-perturbation
     floor and the spread of two CPU convolution libraries;
 11. the instance-norm kernels KK/KL and the whitening-loss kernels KM/KN
     against their plain versions at the training plan's levels and the
     RobustNet taps' widths (IN_FORMS: L0 x 32, L1 x 32, L2 x 64, L3 x
     128; IRW at L0 with rows scaled so that its hinge is live), bf16 and
     f32; KK and KL also on a mask of no row and of one row, on shuffled
     batch ids, on L0 three times over (12 scans) and at width 37, each
     twice bitwise equal;
 12. full-width RobustNet training (the training cell's batch and caps):
     MinkUNet34Robust bf16, SoftDICE + 0.5 IW over its 5 instance-normed
     taps with the gate on from the first step, Adam (lr 1e-3); 1 warm-up
     and 5 timed steps; the checks of phase 6, plus a finite aux_loss,
     then the stage split;
 13. full-width IBN training: MinkUNet34IBN bf16 through the plain train
     step, as phase 6;
 14. RobustNet cross-check: one f32 step of full-width MinkUNet34Robust on
     a 20,000-point scan on the card and on the CPU from the same weights,
     compared by phase 7's rule (loss and aux_loss as the loss), once with
     the gate on and once off; with the gate off the aux loss's grads
     (what the whitening loss sends back into each tap) are exactly 0;
 15. the general stem's kernels at the training plan's level 0 built with
     stem_feature_map=True (491,520 rows, K = 125): KQ (the stem125 and
     conv9 maps) equal to its plain version; KO (4 -> 32), KO as dx (32 ->
     4) and KP (dW) in bf16 and f32 within the bounds of phase 3, KP
     twice bitwise equal; KO and KP at the edge widths STEM_EDGE_WIDTHS
     (1 -> 32, 4 -> 33, 64 -> 64) in bf16 on the same map (untimed);
 16. full-width training of MinkUNet34 with 4 input channels (each
     voxel's representative point's x, y, z and a seeded remission) on
     the general stem, as phase 6 (counters per step: KO 1, KP 1, KQ 1,
     no KO as dx), plus one eval step; then phase 7's check of it, with
     the card's stem125 map equal to the CPU's, the stem output within
     1e-4 and the stem kernel's grad by the L2 rule;
 17. the sortless path: Predictor(sortless=True) against the sorted
     Predictor on phase 4's scan (plans and every point's label equal),
     5 timed sortless requests; the sortless training step (raw per-point
     cells -> assume_unique=False plan): its plan equal to the sorted
     one's, its first-step loss equal to the sorted step's (within the
     spread of two sorted runs, which is printed), 5 timed steps as
     phase 6; requests and steps timed in turns with the sorted path's;
 18. the plan's sweep kernels KR (stem occupancy + conv9 at level 0), KS
     (conv9 at levels 1-4), KT (pos3) and KU (the packed y-neighbourhood
     table) torch.equal to their plain versions on the builder's own
     inputs: the serving plan of phase 4's scan, the training plan of 4
     scans and its sortless plan at every level each runs at, KU also at
     every level of the general stem's plan, and the CPU tests' edge
     voxels with roomy and starved caps (run after phase 15, before phase
     4); KU's and KX's rows in the kernels line carry their level and
     that level's launches (`level_launches`);
 19. the plan's column-table kernels KV (the y-dilated column grid and
     slot stamps), KW (the real z-bit words), KX (the aug words and
     per-scan starts) and KY (the aug rows and the level's maps)
     torch.equal to their plain versions, overflow terms included, on the
     builder's own inputs (table_inputs) at every level: the serving plan,
     the training plan, its sortless and general-stem plans, and the edge
     voxels with roomy, starved and column-starved caps and as sortless
     input (run after phase 18).

 20. the generic plan's kernels against their plain versions: LA (the
     gather-GEMM, csrc/sparse_conv.cu; forward and dIn) and LB (dW) at the
     generic training plan's conv3 L0 32->32 and 128->96, conv3 L3
     512->256, down L0->L1 32->32 and up L1->L0 96->96, the stem (K 125,
     1 -> 32: KO / KP) in bf16 and f32 within phase 3's bounds (LB and KP
     called twice and held bitwise equal), and LA at
     P2's shape (27 taps, 393,216 rows, 96 -> 96, bf16); the voxelizer LC
     (csrc/voxelize.cu) torch.equal to its plain version on phase 4's
     scan, on the training batch and at a capacity below its voxel count
     (overflow > 0); the label gather LD (csrc/label_gather.cu) torch.equal
     to its plain version, sorted and sortless (run after phase 19);
 21. the generic plan: build_unet_plan on the card bitwise equal to the
     CPU's on the 20,000-point scan (levels, perm, every kmap, overflow),
     and the f32 forward of phase 4's weights on the UNetPlan equal to the
     ZPlan forward row by row, aligned by coordinate, within rtol = atol =
     2e-3 (run after phase 5);
 22. full-width training on the generic plan (bench.py's batch, pooled
     caps make_caps(4); MinkUNet34 bf16, SoftDICE + Adam 1e-3, no plan
     given: the step builds the batch's UNetPlan, plain torch): 2 warm-up
     and 5 timed steps in turns with the ZPlan step, finite losses falling,
     confusion totals equal to the supervised voxels, counters LA 108, LB
     54, KO 1, KP 1 per step; one eval step; the plan build's device ms and
     launches; then phase 7's card-vs-CPU check of the generic step.
 23. the gather and DMA probes (python -m lidog_tpu_torch.probes all) at
     lidog_tpu's probe shapes: every correct= / ok= check true, each of
     LE-LH (csrc/window_gather.cu, csrc/window_copy.cu) and LA launched;
     then LE, LF and LG torch.equal to their plain versions at every probe
     shape (and in bf16 at P1's and f32 at t1's), LE and LF also at the
     CPU test's edge shapes (WINDOW_EDGES), LH bitwise equal at P5's; LE
     and LF beside index_select / gather in CUDA events and in device ms,
     warm and with the L2 cache flushed; and a port kernel (LF) launched
     inside `with torch.cuda.stream(s)` runs on s.

Every request and voxelized training batch runs LC once and every request
LD once.  Every request and step builds one plan: KV, KW, KX, KY, KT and KU 5
calls each (KX and KU one kernel a call, counted per level too), KR 1 (KQ
in its place on the general stem) and KS 4, counted with the model's
launches.  On the card the plan runs no plain torch: only
these kernels and the fills of its own buffers.

The line before the last is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.  Exits non-zero without a card, and
in a directory that does not hold the lidog_tpu_torch package.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16, f32 non-tensor
SEED = 0
POINTS = 100_000
VOXEL = 0.05
PER_SCAN = 98_304
GRID_HALF = 1024
REQUESTS = 5
CHECK_POINTS = 20_000
NUM_CLASSES = 7
# launches of each kernel per MinkUNet34 forward (models/minkunet.py):
# 23 BasicBlocks x 2 k=3 convs, 4 down, 4 up, and the fused norm after the
# stem (1), each down (4) and up (4), both convs of each block (46) and
# each of the 7 shortcuts
PER_FORWARD = {"zconv3_fwd": 46, "zconv_down_fwd": 4, "zconv_up_fwd": 4,
               "bn_act": 62}
# the plan's kernels per plan build (one plan per request or step): the
# column tables KV, KW, KX, KY and the sweeps KT and KU at each of the 5
# levels, KR at level 0 (the occupancy stem) and KS at levels 1-4; KU and
# KX (one kernel a call each) also counted per level ("name@Li")
PER_PLAN = {"pos3_lookup": 5, "build_packed": 5, "stem_conv9_packed": 1,
            "conv9_packed": 4, "column_grid": 5, "real_words": 5,
            "assemble_aug": 5, "emit_rows": 5,
            **{f"{k}@L{i}": 1 for k in ("build_packed", "assemble_aug")
               for i in range(5)}}
# the voxelizer LC once per request or voxelized batch, and the label
# gather LD once per request (the sortless path has no voxelizer)
LEVEL_KERNELS = ("build_packed", "assemble_aug")
PER_SORTLESS_REQUEST = {**PER_FORWARD, **PER_PLAN, "label_gather": 1}
PER_REQUEST = {**PER_SORTLESS_REQUEST, "voxelize": 1}
VOXELIZED = {"voxelize": 1}
# training (bench.py:36-44): 4 scans x 100k points, per-scan plan caps
TRAIN_BATCH = 4
TRAIN_STEPS = 5
TRAIN_CAP_IN = 393_216
ZCAPS_R = (92_160, 61_440, 22_528, 9_216, 3_584)
ZCAPS_A = (122_880, 77_824, 25_600, 10_752, 4_352)
ZCAPS_D = (196_608, 93_184, 54_272, 23_552, 9_728)
# launches per train step: the forward's (norms in train mode: KG, which
# ends in KD), and the backward's: KE and KF per k=3 conv, KF and the
# partner forward kernel with transposed weights per down/up conv (so KB
# and KC run 4 + 4 times), KH per norm
PER_STEP = {"zconv3_fwd": 46, "zconv_down_fwd": 8, "zconv_up_fwd": 8,
            "bn_act": 62, "zconv3_bwd_dx": 46, "zconv3_wgrad": 46,
            "zconv_down_wgrad": 4, "zconv_up_wgrad": 4, "bn_train_fwd": 62,
            "bn_train_bwd": 62, **PER_PLAN}
# the (level, width, residual, ReLU, count) forms of MinkUNet34's 62
# train-mode norms (models/minkunet.py): the stem's, each down conv's,
# each block's norm1, shortcut norm (1x1, no ReLU) and norm2 (+ residual),
# and each up conv's
BN_FORMS = ((0, 32, False, True, 1), (1, 32, False, True, 3),
            (1, 32, True, True, 2), (2, 32, False, True, 1),
            (2, 64, False, True, 3), (2, 64, False, False, 1),
            (2, 64, True, True, 3), (3, 64, False, True, 1),
            (3, 128, False, True, 4), (3, 128, False, False, 1),
            (3, 128, True, True, 4), (4, 128, False, True, 1),
            (4, 256, False, True, 6), (4, 256, False, False, 1),
            (4, 256, True, True, 6), (3, 256, False, True, 3),
            (3, 256, False, False, 1), (3, 256, True, True, 2),
            (2, 128, False, True, 3), (2, 128, False, False, 1),
            (2, 128, True, True, 2), (1, 96, False, True, 3),
            (1, 96, False, False, 1), (1, 96, True, True, 2),
            (0, 96, False, True, 3), (0, 96, False, False, 1),
            (0, 96, True, True, 2))
BN_SRC = "lidog_tpu_torch/csrc/masked_bn.cu"
# LiDOG (bench_lidog.py:26-34, 66-121): bound 50 m, BEV labels 167^2, one
# decoder level (block8); per step the backbone's launches and KI, KJ once
# per level
BOUND_2D = 50.0
BEV_HEAD = 167
LEVELS = ("block8",)
PER_LIDOG_STEP = {**PER_STEP, "bev_scatter_max": len(LEVELS),
                  "bev_scatter_max_bwd": len(LEVELS)}
# RobustNet (models/minkunet_robustnet.py): MinkUNet34's convs; an instance
# norm instead of the stem's BN and none after the first down conv (60
# BNs); instance norms in0, in1 and one per RobustBlock of stages 1-3 (2 +
# 3 + 4); the whitening loss on the 5 taps
PER_ROBUST_STEP = {**PER_STEP, "bn_act": 60, "bn_train_fwd": 60,
                   "bn_train_bwd": 60, "instance_norm_fwd": 11,
                   "instance_norm_bwd": 11, "whitening_fwd": 5,
                   "whitening_bwd": 5}
# IBN (models/minkunet_ibn.py): MinkUNet34's convs and BNs, and one
# instance norm beside the first BN of each IBNBlock of stages 1-3
PER_IBN_STEP = {**PER_STEP, "instance_norm_fwd": 9, "instance_norm_bwd": 9}
# the (level, width, per RobustNet step, per IBN step) forms of those
# instance norms on the training plan: in0 (L0); in1 and stage 1's blocks
# (L1); stage 2's (L2); stage 3's (L3)
IN_FORMS = ((0, 32, 1, 0), (1, 32, 3, 2), (2, 64, 3, 3), (3, 128, 4, 4))
IN_SRC = "lidog_tpu_torch/csrc/instance_norm.cu"
# the general stem (in_channels 4): MinkUNet34's kernels, the stem as KO
# (its dW as KP; the input features take no grad, so no KO as dx), and KQ
# once per plan in KR's place
IN_CHANNELS = 4
STEM_R = 2
PER_CIN_STEP = {**{k: v for k, v in PER_STEP.items()
                   if k != "stem_conv9_packed"},
                "zconv_full_fwd": 1, "zconv_full_wgrad": 1, "stem_feat125": 1}
# the generic UNetPlan path (phases 20-22): MinkUNet34 with no plan given,
# so the step builds the batch's UNetPlan (plain torch) at the pooled caps
# of bench.py's 4 scans (caps.make_caps(4)); every conv is LA, its dIn LA
# over the transpose map and its dW LB (23 blocks x 2 k=3 convs, 4 down,
# 4 up: 54 of each), but the stem (K 125, 1 -> 32), which is KO and KP,
# its input taking no grad
GENERIC_CAPS = (524_288, 288_768, 157_696, 63_488, 26_624)
CHECK_PER_SCAN = 65_536  # the generic cross-check's make_caps(1, .)
GENERIC_WARMUP = 2
PER_GENERIC_STEP = {"sparse_conv_fwd": 108, "sparse_conv_wgrad": 54,
                    "zconv_full_fwd": 1, "zconv_full_wgrad": 1,
                    "bn_act": 62, "bn_train_fwd": 62, "bn_train_bwd": 62,
                    **VOXELIZED}
# the probes (phase 23): the kernels that one run of the three probe mains
# launches (their counts follow the probes' timing loops)
PROBE_KERNELS = ("window_row_gather", "window_lane_gather", "window_copy",
                 "lane_gather_sum", "sparse_conv_fwd")
# LE's (row: W, C) and LF's (lane: C, W) edge shapes, which the CPU test
# (tests/test_torch_port_ops.py test_window_gather_split) runs too: name:
# (kind, rows, columns, T, dtype, lowest and highest index drawn)
WINDOW_EDGES = {
    "LE_16B_rows_f32": ("row", 64, 4, 37, "f32", -3, 67),
    "LE_16B_rows_bf16": ("row", 8, 8, 1, "bf16", 8, 9),
    "LE_wide_rows": ("row", 50, 640, 45, "f32", -1, 51),
    "LE_bf16_T33": ("row", 300, 96, 33, "bf16", -1, 301),
    "LF_bf16_odd_T": ("lane", 5, 40, 37, "bf16", -2, 42),
    "LF_f32_C13": ("lane", 13, 7, 33, "f32", -1, 8),
    "LF_bf16_T2": ("lane", 1, 9, 2, "bf16", -1, 10),
    "LF_bf16_T1": ("lane", 3, 16, 1, "bf16", 16, 17)}
PER_VARIANT_STEP = {"source": {**PER_STEP, **VOXELIZED},
                    "robustnet": {**PER_ROBUST_STEP, **VOXELIZED},
                    "ibn": {**PER_IBN_STEP, **VOXELIZED},
                    "cin4": {**PER_CIN_STEP, **VOXELIZED}}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters=10):
    """Mean device ms of fn() over iters launches (after one warm-up)."""
    import torch

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


def _launch_tables():
    from lidog_tpu_torch.core import voxelize, zseg
    from lidog_tpu_torch.losses import losses
    from lidog_tpu_torch.ops import (bev, gather, labels, norm, sparse_conv,
                                     zconv)

    return (zconv.LAUNCHES, norm.LAUNCHES, bev.LAUNCHES, losses.LAUNCHES,
            zseg.LAUNCHES, sparse_conv.LAUNCHES, voxelize.LAUNCHES,
            labels.LAUNCHES, gather.LAUNCHES)


def counters():
    from lidog_tpu_torch.core import zseg

    out = {k: v for d in _launch_tables() for k, v in d.items()}
    for k, per_level in zseg.LEVEL_LAUNCHES.items():
        out.update({f"{k}@L{i}": v for i, v in enumerate(per_level)})
    return out


def zero_counters():
    from lidog_tpu_torch.core import zseg

    for d in _launch_tables():
        for k in d:
            d[k] = 0
    for per_level in zseg.LEVEL_LAUNCHES.values():
        per_level[:] = [0] * len(per_level)


def scan(points, seed):
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset

    ds = SyntheticLidarDataset(num_scans=1, points_per_scan=points,
                               radius=50.0, seed=seed)
    return ds[0]["points"][None]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def ulp_err(a, b):
    """max |a - b| in units in the last place of b's dtype at |b|."""
    import torch

    mant = {torch.float32: 23, torch.bfloat16: 7}[b.dtype]
    bf = b.float()
    ulp = torch.ldexp(torch.ones_like(bf),
                      torch.frexp(bf.abs()).exponent - 1 - mant)
    return float(((a.float() - bf).abs() / ulp).max())


class Checker:
    """Holds kernels against their plain versions; collects one row per
    (kernel, shape)."""

    # kernel vs plain, relative to max |plain|: bf16 kernels sum in f32 in
    # another order (KA and KE also skip JAX's intermediate bf16 roundings,
    # u9 and dxc); f32 differs by summation order only
    TOL = {"bfloat16": {"zconv3_fwd": 2e-2, "zconv3_bwd_dx": 2e-2},
           "float32": {}}
    TOL_DEFAULT = {"bfloat16": 1e-2, "float32": 1e-4}

    def __init__(self, gen, dev):
        self.gen, self.dev, self.rows = gen, dev, []

    def feats(self, n_rows, c, real, dt):
        import torch

        x = torch.randn(n_rows, c, generator=self.gen).to(self.dev, dt)
        return (x * real[:, None].to(dt)).contiguous()

    def weights(self, dt, *shape):
        import torch

        return (torch.randn(*shape, generator=self.gen) * 0.05).to(self.dev,
                                                                    dt)

    @staticmethod
    def bound(nbyte, ops, kind):
        tb = nbyte / HBM_BYTES_PER_S * 1e3
        to = ops / PEAK_OPS[kind] * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    def record(self, name, source, replaces, kfn, pfn, dt, nbyte, ops, shape,
               mma=True, ulps=None, lfn=None, exact=False):
        """kfn/pfn return the output to compare (a tensor, or a tuple whose
        first entry is compared with the stated bound and whose others
        with the same bound each).  mma: the work is a matrix product (its
        operations count against the tensor cores' rate in bf16).  ulps:
        hold every element within that many units in the last place of
        the dtype at |plain| instead (0: equal).  exact (and integer
        outputs): every output torch.equal to the plain one, dtype
        included.  lfn: one PyTorch call that computes the same function
        (timed as library_ms, and held equal to the plain version)."""
        import torch

        out_k, out_p = kfn(), pfn()
        torch.cuda.synchronize()
        if not isinstance(out_k, tuple):
            out_k, out_p = (out_k,), (out_p,)
        dname = str(dt).split(".")[-1]
        if exact or not out_p[0].is_floating_point():  # maps: torch.equal
            t = "equal"
            errs = [0 if a.dtype == b.dtype and torch.equal(a, b)
                    else int((a != b).sum()) if a.shape == b.shape else -1
                    for a, b in zip(out_k, out_p)]
            err = max(errs, key=abs)
            ok = err == 0
        elif ulps is None:
            t = self.TOL[dname].get(name, self.TOL_DEFAULT[dname])
            errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
            err = max(errs)
            ok = err <= t
        else:
            t = f"{ulps} ulp"
            errs = [ulp_err(a, b) for a, b in zip(out_k, out_p)]
            err = max(errs)
            ok = err <= ulps
        kind = "bf16" if dt == torch.bfloat16 and mma else "f32"
        b_ms, b_by = self.bound(nbyte, ops, kind)
        shape = f"{shape} {dname}"
        row = {"name": name, "route": "triton" if source.endswith(".py")
               else "cuda", "source": source, "replaces": replaces,
               "shape": shape, "max_abs_err": max(
                   float((a.float() - b.float()).abs().max())
                   for a, b in zip(out_k, out_p)),
               "max_rel_err": max(rel_err(a, b) for a, b in zip(out_k, out_p))
               if out_p[0].is_floating_point() and not exact else 0.0,
               "tol_rel": t, "ms": cuda_ms(kfn),
               "plain_ms": cuda_ms(pfn), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        if lfn is not None:
            if not torch.equal(lfn(), out_p[0]):
                raise AssertionError(f"{name} {shape}: the library call "
                                     "differs from the plain version")
            row["library_ms"] = cuda_ms(lfn)
        print(f"[kernel] {name} {shape}: err {err:.3e} (bound {t}) "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} {shape}: err {errs} > {t}")
        self.rows.append(row)


def conv3_pairs(plan, lvl):
    """(offset, z tap) sources that the k=3 sum needs on real rows: the
    forward's multiply-adds per output width, and the backward's."""
    L = plan.level(lvl)
    nbr9 = plan.kmaps[f"conv9_l{lvl}"]
    src = nbr9.clamp(min=0).long()
    taps = (nbr9 >= 0).long() * (1 + L.zdn.long()[src] + L.zup.long()[src])
    taps[4] = L.valid.long() * (1 + L.zdn.long() + L.zup.long())
    return int((taps * L.real.long()).sum())


# MinkUNet34's zconv3 width pairs (Cin, Cout) at their levels of the
# training plan, besides block8's at L0: block1 and block7 (L1), block2
# and block6 (L2), block3 and block5 (L3), block4 (L4)
ZCONV3_WIDTHS = ((1, 32, 32), (2, 32, 64), (2, 64, 64), (3, 64, 128),
                 (3, 128, 128), (4, 128, 256), (4, 256, 256), (3, 384, 256),
                 (2, 192, 128), (1, 128, 96), (1, 96, 96))


def record_ka(ck, plan, lvl, cin, cout, dt, tag=""):
    """KA against zconv3_plain at one level of plan, seeded features on its
    real rows."""
    from lidog_tpu_torch.ops import zconv

    L = plan.level(lvl)
    nbr9 = plan.kmaps[f"conv9_l{lvl}"]
    n = nbr9.shape[1]
    x = ck.feats(n, cin, L.real, dt)
    wf = ck.weights(dt, 9, 3 * cin, cout)
    ck.record("zconv3_fwd", "lidog_tpu_torch/csrc/zconv3_fwd.cu",
              "lidog_tpu/ops/zconv.py:180 (_zconv3_core); "
              "benchmarks/micro/micro_windowconv.py:113 (make_windowed)",
              lambda: zconv.zconv3_fwd(x, nbr9, L.zup, L.zdn, wf, L.real),
              lambda: zconv.zconv3_plain(x, nbr9, L.zup, L.zdn, wf, L.real),
              dt, nbytes(x, nbr9, L.zup, L.zdn, wf, L.real)
              + n * cout * x.element_size(),
              2 * cin * cout * conv3_pairs(plan, lvl),
              f"{tag}L{lvl} {n} rows {cin}->{cout}")


def record_ke(ck, plan, lvl, dout, wf):
    """KE against zconv3_bwd_dx_plain at one level of plan (dout read
    through the level's real mask)."""
    from lidog_tpu_torch.ops import zconv

    L = plan.level(lvl)
    nbr9 = plan.kmaps[f"conv9_l{lvl}"]
    n, cout = dout.shape
    cin = wf.shape[1] // 3
    ck.record("zconv3_bwd_dx", "lidog_tpu_torch/csrc/zconv3_bwd_dx.cu",
              "lidog_tpu/ops/zconv.py:231 (_zconv3_bwd dx, _zcat_t:116)",
              lambda: zconv.zconv3_bwd_dx(dout, nbr9, L.zup, L.zdn, wf,
                                          L.real),
              lambda: zconv.zconv3_bwd_dx_plain(dout, nbr9, L.zup, L.zdn,
                                                wf, L.real),
              dout.dtype, nbytes(dout, nbr9, L.zup, L.zdn, wf, L.real)
              + n * cin * dout.element_size(),
              2 * cin * cout * conv3_pairs(plan, lvl),
              f"L{lvl} {n} rows {cin}->{cout}")


# MinkUNet34's strided convs (models/minkunet.py): (kind, fine level, Cin,
# Cout) of conv1-conv4 (down, fine L -> coarse L + 1) and convtr4-convtr7
# (up, coarse L + 1 -> fine L).  A training step runs each form's forward
# (KB down, KC up), its dx (the partner kernel with W^T: KC for a down, KB
# for an up) and its dW (KF's down or up form): 24 launches.
STRIDED_FORMS = (("down", 0, 32, 32), ("down", 1, 32, 32),
                 ("down", 2, 64, 64), ("down", 3, 128, 128),
                 ("up", 3, 256, 256), ("up", 2, 256, 128),
                 ("up", 1, 128, 96), ("up", 0, 96, 96))
# the plan kernels that `profile_turns kernels` times in turns with another
# checkout, as (plan, level, wrapper in core/zseg.py): KV, KW, KX, KY, KT
# and KU at every level of the serving and training plans, KR at both
# plans' L0, KS at their L1-L4 and KQ at the general stem's L0
PLAN_FORMS = tuple((p, lvl, k) for p in ("serve", "train")
                   for k in ("column_grid", "real_words", "assemble_aug",
                             "emit_rows", "_build_packed", "pos3_lookup")
                   for lvl in range(5)) + tuple(
    (p, lvl, "conv9_packed") for p in ("serve", "train")
    for lvl in range(1, 5)) + (
    ("serve", 0, "stem_conv9_packed"), ("train", 0, "stem_conv9_packed"),
    ("cin4", 0, "stem_feat125_packed"))
STRIDED_SRC = {"zconv_down_fwd": "lidog_tpu_torch/csrc/zconv_down_fwd.cu",
               "zconv_up_fwd": "lidog_tpu_torch/csrc/zconv_up_fwd.cu",
               "zconv_down_wgrad": "lidog_tpu_torch/csrc/zconv_wgrad.cu",
               "zconv_up_wgrad": "lidog_tpu_torch/csrc/zconv_wgrad.cu"}


def record_strided(ck, plan, kind, lvl, cin, cout, dt,
                   parts=("fwd", "dx", "dW"), tag=""):
    """One strided form at its level pair of `plan` against its plain
    versions: the forward, dx (the partner forward kernel with W^T, the
    cotangent read through the output mask) and dW (called twice and held
    bitwise equal).  Returns the sum of their bounds (ms)."""
    import torch

    from lidog_tpu_torch.ops import zconv

    fine, coarse = plan.level(lvl), plan.level(lvl + 1)
    nbr8 = plan.kmaps[f"down8_l{lvl}"]
    parent, off = plan.kmaps[f"parent_l{lvl}"], plan.kmaps[f"off_l{lvl}"]
    nf, nc = fine.coords.shape[0], coarse.coords.shape[0]
    esz = torch.finfo(dt).bits // 8
    down = kind == "down"
    # x on the conv's input level, the cotangent on its output level
    (ni, mi), (no, mo) = ((nf, fine.real), (nc, coarse.real)) if down else (
        (nc, coarse.real), (nf, fine.real))
    x = ck.feats(ni, cin, mi, dt)
    dout = ck.feats(no, cout, torch.ones(no, dtype=torch.bool,
                                         device=x.device), dt)
    w8 = ck.weights(dt, 8, cin, cout)
    w8t = w8.transpose(1, 2).contiguous()
    src = parent.clamp(min=0).long()
    # live (fine row, parent) pairs through each mask: the one-hot work
    pairs_c = int(((parent >= 0) & coarse.real[src]).sum())
    pairs_f = int(((parent >= 0) & fine.real).sum())
    # live (coarse row, child) entries: KB's forward through the output
    # mask, its dx through the source mask
    live_c = int(((nbr8 >= 0) & coarse.real[None]).sum())
    taps_f = int(((nbr8 >= 0) & fine.real[nbr8.clamp(min=0).long()]).sum())
    a, b = (lvl, lvl + 1) if down else (lvl + 1, lvl)
    shape = f"{tag}{kind} L{a}->L{b} {cin}->{cout} {nf} fine rows"
    rep = ("lidog_tpu/ops/zconv.py:466 (_down_loop / _zdown_core)",
           "lidog_tpu/ops/zconv.py:505 (_zdown_bwd dx, _onehot_matmuls:437 "
           "transpose=True)",
           "lidog_tpu/ops/zconv.py:505 (_zdown_bwd dW, _onehot_dw:455)") \
        if down else (
           "lidog_tpu/ops/zconv.py:548 (_zup_core, _onehot_matmuls:437)",
           "lidog_tpu/ops/zconv.py:561 (_zup_bwd dx, _down_loop:466 with W^T)",
           "lidog_tpu/ops/zconv.py:561 (_zup_bwd dW, _onehot_dw:455)")
    bound = 0.0

    def rec(name, replaces, kfn, pfn, nbyte, ops, what):
        nonlocal bound
        b, _ = Checker.bound(nbyte, ops, "bf16" if dt == torch.bfloat16
                             else "f32")
        bound += b
        ck.record(name, STRIDED_SRC[name], replaces, kfn, pfn, dt, nbyte, ops,
                  f"{what} {shape}")

    if down:
        if "fwd" in parts:
            rec("zconv_down_fwd", rep[0],
                lambda: zconv.zconv_down_fwd(x, nbr8, w8, coarse.real),
                lambda: zconv.zconv_down_plain(x, nbr8, w8, coarse.real),
                nbytes(x, nbr8, w8, coarse.real) + nc * cout * esz,
                2 * cin * cout * live_c, "fwd")
        if "dx" in parts:
            rec("zconv_up_fwd", rep[1],
                lambda: zconv.zconv_up_fwd(dout, parent, off, w8t, None,
                                           src_mask=coarse.real),
                lambda: zconv.zconv_up_plain(dout, parent, off, w8t, None,
                                             src_mask=coarse.real),
                nbytes(dout, parent, off, w8t, coarse.real) + nf * cin * esz,
                2 * cin * cout * pairs_c, "dx")
        if "dW" in parts:
            def kfn():
                return zconv.zconv_down_wgrad(x, dout, parent, off,
                                              coarse.real)

            rec("zconv_down_wgrad", rep[2], kfn,
                lambda: zconv.zconv_down_wgrad_plain(x, dout, parent, off,
                                                     coarse.real),
                nbytes(x, dout, parent, off, coarse.real)
                + 8 * cin * cout * esz,
                2 * cin * cout * pairs_c, "dW")
            twice_equal("zconv_down_wgrad", kfn, shape)
    else:
        if "fwd" in parts:
            rec("zconv_up_fwd", rep[0],
                lambda: zconv.zconv_up_fwd(x, parent, off, w8, fine.real),
                lambda: zconv.zconv_up_plain(x, parent, off, w8, fine.real),
                nbytes(x, parent, off, w8, fine.real) + nf * cout * esz,
                2 * cin * cout * pairs_f, "fwd")
        if "dx" in parts:
            rec("zconv_down_fwd", rep[1],
                lambda: zconv.zconv_down_fwd(dout, nbr8, w8t, None,
                                             src_mask=fine.real),
                lambda: zconv.zconv_down_plain(dout, nbr8, w8t, None,
                                               src_mask=fine.real),
                nbytes(dout, nbr8, w8t, fine.real) + nc * cin * esz,
                2 * cin * cout * taps_f, "dx")
        if "dW" in parts:
            def kfn():
                return zconv.zconv_up_wgrad(x, dout, parent, off, fine.real)

            rec("zconv_up_wgrad", rep[2], kfn,
                lambda: zconv.zconv_up_wgrad_plain(x, dout, parent, off,
                                                   fine.real),
                nbytes(x, dout, parent, off, fine.real) + 8 * cin * cout * esz,
                2 * cin * cout * pairs_f, "dW")
            twice_equal("zconv_up_wgrad", kfn, shape)
    return bound


def twice_equal(name, kfn, shape):
    """A deterministic kernel: two calls on the same inputs bitwise equal."""
    import torch

    a, b = kfn(), kfn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name} {shape}: two calls differ in "
                             f"{int((a != b).sum())} elements")
    print(f"[kernel] {name} {shape}: two calls bitwise equal", flush=True)


def kernel_checks(plan, gen):
    """Phase 3, forward kernels at the serving plan's shapes."""
    import torch

    from lidog_tpu_torch.ops import norm, zconv

    bf, f32 = torch.bfloat16, torch.float32
    dev = plan.levels[0].coords.device
    l0 = plan.level(0)
    na = l0.coords.shape[0]
    ck = Checker(gen, dev)
    feats, weights, record = ck.feats, ck.weights, ck.record

    # KA: zconv3 at the main path's shapes: L0 128 -> 96 (block8_0.conv1:
    # up 96 + skip 32), L0 96 -> 96 (block8 conv2), L1 32 -> 32 (block1);
    # f32 (MinkUNet34's default compute dtype) at L1 32 -> 32
    for lvl, cin, cout, dt in ((0, 128, 96, bf), (0, 96, 96, bf),
                               (1, 32, 32, bf), (1, 32, 32, f32)):
        record_ka(ck, plan, lvl, cin, cout, dt)

    # KB and KC: every strided form's forward on the serving plan (bf16),
    # and the L0 <-> L1 pair's in f32
    for kind, lvl, cin, cout in STRIDED_FORMS:
        record_strided(ck, plan, kind, lvl, cin, cout, bf, ("fwd",),
                       "serving ")
    for kind, lvl, cin, cout in STRIDED_FORMS:
        if lvl == 0:
            record_strided(ck, plan, kind, lvl, cin, cout, f32, ("fwd",),
                           "serving ")

    # KD: BN(eval) + residual + ReLU at L0, width 96 (block8 norm2)
    mean = (torch.randn(96, generator=gen) * 0.1).to(dev)
    inv = (torch.rand(96, generator=gen) + 0.5).to(dev)
    bias = (torch.randn(96, generator=gen) * 0.1).to(dev)
    for dt in (bf, f32):
        x = feats(na, 96, l0.real, dt)
        res = feats(na, 96, l0.real, dt)
        record("bn_act", BN_SRC, BN_ACT_REPLACES,
               lambda: norm.bn_act(x, mean, inv, bias, l0.real, res, True),
               lambda: norm.bn_act_plain(x, mean, inv, bias, l0.real, res,
                                         True),
               dt, nbytes(x, res, l0.real, mean, inv, bias)
               + na * 96 * x.element_size(), 5 * na * 96,
               f"L0 {na} rows 96 +res +relu", mma=False)
    return ck.rows


def backward_kernel_checks(plan, gen):
    """Phase 3, backward kernels (KE-KH, KB/KC transposed) at the training
    plan's shapes."""
    import torch

    from lidog_tpu_torch.ops import norm, zconv

    bf, f32 = torch.bfloat16, torch.float32
    dev = plan.levels[0].coords.device
    l0, l1 = plan.level(0), plan.level(1)
    na0, na1 = l0.coords.shape[0], l1.coords.shape[0]
    ck = Checker(gen, dev)
    feats, weights, record = ck.feats, ck.weights, ck.record
    # cotangents are not masked: each kernel reads them through the
    # forward's output mask
    ones0 = torch.ones(na0, dtype=torch.bool, device=dev)
    ones1 = torch.ones(na1, dtype=torch.bool, device=dev)
    zw_src = "lidog_tpu_torch/csrc/zconv3_wgrad.cu"
    zw_rep = "lidog_tpu/ops/zconv.py:268 (_zconv3_bwd dW)"

    def record_zw(x, dout, nbr9, zup, zdn, real, nnz9, shape):
        cin, cout = x.shape[1], dout.shape[1]
        record("zconv3_wgrad", zw_src, zw_rep,
               lambda: zconv.zconv3_wgrad(x, dout, nbr9, zup, zdn, real),
               lambda: zconv.zconv3_wgrad_plain(x, dout, nbr9, zup, zdn,
                                                real),
               x.dtype, nbytes(x, dout, nbr9, zup, zdn, real)
               + 27 * cin * cout * x.element_size(), 2 * cin * cout * nnz9,
               shape)

    # KE / KF(zconv3): block8_0.conv1 (L0 128 -> 96), block8 conv2 (L0 96 ->
    # 96) and block1 (L1 32 -> 32)
    for lvl, cin, cout, dt in ((0, 128, 96, bf), (0, 96, 96, bf),
                               (0, 96, 96, f32), (1, 32, 32, bf),
                               (1, 32, 32, f32)):
        L = plan.level(lvl)
        nbr9 = plan.kmaps[f"conv9_l{lvl}"]
        n = nbr9.shape[1]
        nnz9 = conv3_pairs(plan, lvl)
        ones = ones0 if lvl == 0 else ones1
        x = feats(n, cin, L.real, dt)
        dout = feats(n, cout, ones, dt)
        wf = weights(dt, 9, 3 * cin, cout)
        record_ke(ck, plan, lvl, dout, wf)
        record_zw(x, dout, nbr9, L.zup, L.zdn, L.real, nnz9,
                  f"L{lvl} {n} rows {cin}->{cout}")

    # KA at the training plan's L0 shapes (block8), then KA and KE once at
    # every other width pair of MinkUNet34's 46 zconv3 calls, at its level
    for cin, cout in ((128, 96), (96, 96)):
        record_ka(ck, plan, 0, cin, cout, bf, "training ")
    for lvl, cin, cout in ZCONV3_WIDTHS:
        n = plan.level(lvl).coords.shape[0]
        record_ka(ck, plan, lvl, cin, cout, bf, "training ")
        if (lvl, cin, cout) != (1, 32, 32):  # (KE held there above)
            record_ke(ck, plan, lvl, feats(n, cout, torch.ones(
                n, dtype=torch.bool, device=dev), bf),
                weights(bf, 9, 3 * cin, cout))

    # KF (zconv3) where its tiling changes: L1 128 -> 96 (block7_0.conv1:
    # 12 warps a block), L4 256 -> 256 (block4, 12 launches a step: two
    # Cin slabs, eight Cout slabs), and L2 cut to a row count that is no
    # multiple of the 64-row step (halo rows and z flags at the level's
    # end; its maps' rows past the cut read as misses on both sides)
    for lvl, cin, cout, dt, cut in ((1, 128, 96, bf, 0), (4, 256, 256, bf, 0),
                                    (2, 64, 64, bf, 37), (2, 64, 64, f32, 37)):
        L = plan.level(lvl)
        n = L.coords.shape[0] - cut
        nbr9 = plan.kmaps[f"conv9_l{lvl}"][:, :n].contiguous()
        zup, zdn, real = (t[:n].contiguous() for t in (L.zup, L.zdn, L.real))
        src = nbr9.clamp(min=0).long()
        hit = (nbr9 >= 0) & (nbr9 < n)
        taps = hit.long() * (1 + zdn.long()[src.clamp(max=n - 1)]
                             + zup.long()[src.clamp(max=n - 1)])
        taps[4] = L.valid[:n].long() * (1 + zdn.long() + zup.long())
        nnz9 = int((taps * real.long()).sum())
        x = feats(n, cin, real, dt)
        dout = feats(n, cout, torch.ones(n, dtype=torch.bool, device=dev), dt)
        record_zw(x, dout, nbr9, zup, zdn, real, nnz9,
                  f"L{lvl} {n} rows {cin}->{cout}")

    # every strided form of MinkUNet34 on the training plan (forward, dx,
    # dW) in bf16, the L0 <-> L1 pair (conv1, convtr7) also in f32; the
    # bound of a step's 24 strided launches
    bound = sum(record_strided(ck, plan, *form, bf)
                for form in STRIDED_FORMS)
    print(f"[strided] bound a step (KB, KC, KF: {3 * len(STRIDED_FORMS)} "
          f"launches at the training plan's rows): {bound:.4f} ms", flush=True)
    for kind, lvl, cin, cout in STRIDED_FORMS:
        if lvl == 0:
            record_strided(ck, plan, kind, lvl, cin, cout, f32)

    # KG, KH and KD at every norm form of MinkUNet34 (bf16) and at L0 96
    # +res +relu in f32; an odd width (the scalar path) at L1; a mask with
    # no row and one with a single row at L0 96
    bound = 0.0
    for lvl, c, has_res, relu, count in BN_FORMS:
        b_ms = record_bn(ck, plan.level(lvl).real, c, has_res, relu, bf,
                         f"L{lvl}")
        bound += count * b_ms
    print(f"[bn] bound a step (KG + KH, {sum(f[4] for f in BN_FORMS)} "
          f"norms at the training plan's rows): {bound:.4f} ms", flush=True)
    record_bn(ck, l0.real, 96, True, True, f32, "L0")
    l1real = plan.level(1).real
    for dt in (bf, f32):
        record_bn(ck, l1real, 37, True, True, dt, "L1 odd width")
    one = torch.zeros(na0, dtype=torch.bool, device=dev)
    one[na0 // 2] = True
    for real, tag in ((torch.zeros_like(one), "L0 no row"),
                      (one, "L0 one row")):
        record_bn(ck, real, 96, True, True, bf, tag)
    return ck.rows


BN_ACT_REPLACES = ("lidog_tpu/ops/norm.py:73 (MaskedBatchNorm eval) + "
                   "lidog_tpu/models/minkunet.py:252 (residual, ReLU)")


def record_bn(ck, real, c, has_res, relu, dt, tag):
    """KG (bn_train_fwd, which ends in KD), KH (bn_train_bwd) and KD
    (bn_act) against their plain versions on seeded rows (all of them,
    masked or not), mask `real`, width c: y, mean, var_raw and inv, and
    the running stats after the same number of updates (1e-4); dx,
    dscale, dbias (and dres); y.  Each kernel twice on the same inputs
    gives bitwise-equal outputs.  Returns the bound of KG + KH."""
    import torch

    from lidog_tpu_torch.ops import norm

    gen, dev = ck.gen, real.device
    n = real.shape[0]
    scale = (torch.rand(c, generator=gen) + 0.5).to(dev)
    bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
    stats0 = [(torch.randn(c, generator=gen) * 0.1).to(dev),
              (torch.rand(c, generator=gen) + 0.5).to(dev)]
    # values on every row: the kernels read masked rows too
    every = torch.ones_like(real)
    x = ck.feats(n, c, every, dt)
    res = ck.feats(n, c, every, dt) if has_res else None
    dy = ck.feats(n, c, every, dt)
    esz = x.element_size()
    shape = (f"{tag} {n} rows {c}" + (" +res" if has_res else "")
             + (" +relu" if relu else ""))
    run_k = [t.clone() for t in stats0]
    run_p = [t.clone() for t in stats0]

    def kg(run, fn=norm.bn_train_fwd):
        return fn(x, real, scale, bias, *run, 0.1, 1e-5, res, relu)[:4]

    vecs = nbytes(real, scale, bias, *stats0) + 3 * c * 4
    ck.record("bn_train_fwd", BN_SRC,
              "lidog_tpu/ops/norm.py:24 (_masked_moments) + :61-76 (train "
              "update, normalise)",
              lambda: kg(run_k), lambda: kg(run_p, norm.bn_train_fwd_plain),
              dt, nbytes(x) * (3 if has_res else 2) + vecs, 10 * n * c, shape,
              mma=False)
    b_kg = ck.rows[-1]["bound_ms"]
    # the running stats took the same number of updates on each side
    for a, b in zip(run_k, run_p):
        if not rel_err(a, b) <= 1e-4:
            raise AssertionError(f"bn_train_fwd running stats {shape}: "
                                 f"rel err {rel_err(a, b)}")
    twice = [kg([t.clone() for t in stats0]) for _ in range(2)]
    y, mean, var_raw, inv, count = norm.bn_train_fwd_plain(
        x, real, scale, bias, *[t.clone() for t in stats0], 0.1, 1e-5, res,
        relu)
    args = (dy, y, x, real, scale, mean, var_raw, inv, count, 1e-5, has_res,
            relu)
    n_io = 3 + relu + has_res  # dy, x, dx; y (ReLU), dres (residual)
    ck.record("bn_train_bwd", BN_SRC,
              "autodiff of lidog_tpu/ops/norm.py:24-76 with the residual "
              "and ReLU of lidog_tpu/models/minkunet.py:252",
              lambda: tuple(t for t in norm.bn_train_bwd(*args)
                            if t is not None),
              lambda: tuple(t for t in norm.bn_train_bwd_plain(*args)
                            if t is not None),
              dt, n_io * n * c * esz + nbytes(real) + 6 * c * 4, 14 * n * c,
              shape, mma=False)
    b_kh = ck.rows[-1]["bound_ms"]
    twice += [tuple(t for t in norm.bn_train_bwd(*args) if t is not None)
              for _ in range(2)]
    ck.record("bn_act", BN_SRC, BN_ACT_REPLACES,
              lambda: norm.bn_act(x, mean, inv, bias, real, res, relu),
              lambda: norm.bn_act_plain(x, mean, inv, bias, real, res, relu),
              dt, nbytes(x) * (3 if has_res else 2) + nbytes(real)
              + 3 * c * 4, 5 * n * c, shape, mma=False)
    twice += [(norm.bn_act(x, mean, inv, bias, real, res, relu),)
              for _ in range(2)]
    for first, second in zip(twice[::2], twice[1::2]):
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"masked BN {shape}: two calls on the same "
                                 "input differ")
    return b_kg + b_kh


def record_in(ck, real, bidx, c, dt, x, tag):
    """KK (instance_norm_fwd: y, mean, var_raw, rstd, count) and KL
    (instance_norm_bwd: dx) against their plain versions on x [n, c] with
    mask `real` and batch ids `bidx`, and each kernel twice on the same
    inputs bitwise equal."""
    import torch

    from lidog_tpu_torch.ops import norm

    n = x.shape[0]
    nreal = int(real.sum())
    esz = x.element_size()
    io = nbytes(real) + 4 * n  # the mask and the batch ids
    shape = f"{tag} {n} rows ({nreal} real) x {c}"
    ck.record("instance_norm_fwd", IN_SRC,
              "lidog_tpu/ops/norm.py:79 (MaskedInstanceNorm)",
              lambda: norm.instance_norm_fwd(x, real, bidx),
              lambda: norm.instance_norm_fwd_plain(x, real, bidx),
              dt, 2 * n * c * esz + io, 8 * nreal * c, shape, mma=False)
    _, mean, var_raw, rstd, count = norm.instance_norm_fwd_plain(x, real,
                                                                 bidx)
    dy = ck.feats(n, c, real, dt)
    args = (dy, x, real, bidx, mean, var_raw, rstd, count)
    ck.record("instance_norm_bwd", IN_SRC,
              "autodiff of lidog_tpu/ops/norm.py:79-104",
              lambda: norm.instance_norm_bwd(*args),
              lambda: norm.instance_norm_bwd_plain(*args),
              dt, 3 * n * c * esz + io, 10 * nreal * c, shape, mma=False)
    for fn in (lambda: norm.instance_norm_fwd(x, real, bidx),
               lambda: (norm.instance_norm_bwd(*args),)):
        first, second = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"instance norm {shape} {dt}: two calls on "
                                 "the same input differ")


def variant_kernel_checks(plan, gen):
    """Phase 11: KK/KL (instance norm) and KM/KN (IW, and IRW at L0) at
    the training plan's levels, at the widths of the RobustNet taps that
    live there (IN_FORMS): in0 (L0 x 32), in1 and block1 (L1 x 32), block2
    (L2 x 64), block3 (L3 x 128); the IBN norms take the same widths.  KK
    and KL also on a mask of no row and of one row, on the batch ids
    shuffled over the rows (every block of the sums meets every scan), on
    L0 three times over and at width 37 (one channel a thread), each
    twice bitwise equal."""
    import torch

    from lidog_tpu_torch.losses import losses

    dev = plan.levels[0].coords.device
    ck = Checker(gen, dev)
    wh_src = "lidog_tpu_torch/losses/whiten_triton.py"
    for lvl, c, _, _ in IN_FORMS:
        L = plan.level(lvl)
        n, bidx = L.coords.shape[0], L.coords[:, 0]
        real = int(L.real.sum())
        shape = f"L{lvl} {n} rows ({real} real) x {c}"
        for dt in (torch.bfloat16, torch.float32):
            x = in_feats(ck, L.real, c, dt)
            esz = x.element_size()
            record_in(ck, L.real, bidx, c, dt, x, f"L{lvl}")
            irws = (False, True) if lvl == 0 else (False,)
            for irw in irws:
                xw = x
                if irw:  # rows scaled so that IRW's hinge is live on some
                    big = torch.rand(n, generator=gen).to(dev) < 0.3
                    xw = (x.float() * torch.where(big, 12.0, 1.0)[:, None]
                          ).to(dt).contiguous()
                tag = f"{shape} {'IRW' if irw else 'IW'}"
                ck.record("whitening_fwd", wh_src,
                          "lidog_tpu/losses/losses.py:211 "
                          "(_per_row_offdiag_abs) + :234 (IWLoss), :249 "
                          "(IRWLoss)",
                          lambda: losses.whitening_fwd(xw, L.real, irw),
                          lambda: losses.whitening_fwd_plain(xw, L.real, irw),
                          dt, n * c * esz + nbytes(L.real) + 4 * n,
                          4 * real * c, tag, mma=False)
                _, srow, nv = losses.whitening_fwd_plain(xw, L.real, irw)
                dl = torch.ones((), device=dev)
                wargs = (dl, xw, L.real, srow, nv, irw)
                ck.record("whitening_bwd", wh_src,
                          "autodiff of lidog_tpu/losses/losses.py:211-265",
                          lambda: losses.whitening_bwd(*wargs),
                          lambda: losses.whitening_bwd_plain(*wargs),
                          dt, 2 * n * c * esz + nbytes(L.real) + 4 * n,
                          6 * real * c, tag, mma=False)
    # KK and KL's edges: at L0 x 32 bf16 a mask of no row, of one row, and
    # the batch ids shuffled; L0 three times over (4 scans a copy, a
    # block's run past the segment bytes its shared memory keeps); width 37
    # at L1 in bf16 and f32
    bf = torch.bfloat16
    L = plan.level(0)
    n, bidx = L.coords.shape[0], L.coords[:, 0]
    one = torch.zeros(n, dtype=torch.bool, device=dev)
    one[int(L.real.nonzero()[n // 1000, 0])] = True
    shuffled = bidx[torch.randperm(n, generator=gen).to(dev)].contiguous()
    for real, ids, tag in ((torch.zeros_like(one), bidx, "L0 no row"),
                           (one, bidx, "L0 one row"),
                           (L.real, shuffled, "L0 shuffled ids")):
        record_in(ck, real, ids, 32, bf, in_feats(ck, L.real, 32, bf), tag)
    real3 = L.real.repeat(3)
    ids3 = torch.cat([bidx + 4 * i for i in range(3)])
    record_in(ck, real3, ids3, 32, bf, in_feats(ck, real3, 32, bf),
              "L0 x 3 (12 scans)")
    L = plan.level(1)
    for dt in (bf, torch.float32):
        record_in(ck, L.real, L.coords[:, 0], 37, dt,
                  in_feats(ck, L.real, 37, dt), "L1 odd width")
    return ck.rows


def in_feats(ck, real, c, dt):
    """Conv outputs for the instance norm: seeded rows shifted and scaled
    per channel, masked."""
    import torch

    x = (ck.feats(real.shape[0], c, real, torch.float32) * 3.0 + 1.5).to(dt)
    return (x * real[:, None].to(dt)).contiguous()


def sweep_lookups(args, kwargs, dxs):
    """(grid cells, table rows) that a packed-table sweep's rows (KQ, KR,
    KS; args and kwargs as the builder passes them) look up over the dx
    offsets `dxs`: the bytes its inputs must give, on this run's data."""
    import torch

    grid, packed, coords, valid, g, ccap, cap_a = args[:7]
    nb, gh, lvl = args[-1], kwargs["grid_half"], kwargs["level"]
    n = coords.shape[0]
    b = torch.arange(n, device=coords.device) // (n // nb)
    gx0 = (coords[:, 1] >> lvl) + (gh >> lvl)
    gy0 = (coords[:, 2] >> lvl) + (gh >> lvl)
    cells, slots = [], []
    for dx in dxs:
        ok = valid & (gx0 + dx >= 0) & (gx0 + dx < g)
        flat = ((b * g + gx0 + dx) * g + gy0)[ok]
        cells.append(flat)
        cid = grid[flat]
        slots.append(cid[cid >= 0])
    return (int(torch.unique(torch.cat(cells)).numel()),
            int(torch.unique(torch.cat(slots)).numel()))


def stem_kernel_checks(dev, gen):
    """Phase 15: KQ, KO (forward and as dx) and KP at the training plan's
    level 0 of the general stem (4 scans, stem_feature_map=True,
    in_channels 4): KQ bitwise equal to its plain version, KO and KP in
    bf16 and f32 within the stated bounds."""
    import torch

    from lidog_tpu_torch.core import zseg
    from lidog_tpu_torch.core.bitgrid import ZWORDS
    from lidog_tpu_torch.ops import sparse_conv as sc

    pts, labels = train_data()
    batch = train_batch(pts, labels, dev)
    builder = train_plan_builder(IN_CHANNELS)
    plan = builder(batch["coords"], batch["mask"])
    args, kwargs = builder.stem_inputs(batch["coords"], batch["mask"])
    if int(plan.overflow.sum()) != 0:
        raise AssertionError(f"stem plan overflow {plan.overflow.tolist()}")
    ck = Checker(gen, dev)
    l0 = plan.level(0)
    n = l0.coords.shape[0]
    nbr = plan.kmaps["stem125"]
    k = nbr.shape[0]
    cells, slots = sweep_lookups(args, kwargs, range(-STEM_R, STEM_R + 1))
    aug_bytes = (2 * STEM_R + 1) * (ZWORDS + 1) * 4  # a row's aug slabs
    ck.record("stem_feat125", "lidog_tpu_torch/csrc/stem_feat125.cu",
              "lidog_tpu/core/zseg.py:540 (stem_feat125_packed)",
              lambda: zseg.stem_feat125_packed(*args, **kwargs),
              lambda: zseg.stem_feat125_plain(*args, **kwargs),
              torch.int32, (k + 9) * n * 4 + nbytes(l0.coords, l0.valid)
              + cells * args[0].element_size() + slots * aug_bytes, 0,
              f"L0 {n} rows ({cells} cells, {slots} columns) -> "
              f"[{k}+9, {n}]", mma=False)
    del args, kwargs
    src = "lidog_tpu_torch/csrc/zconv_full.cu"
    hits = int(((nbr >= 0) & l0.real[None]).sum())  # forward: real outputs
    src_real = (nbr >= 0) & l0.real[nbr.clamp(min=0).long()]
    hits_dx = int(src_real.sum())  # dx: sources on real rows
    hits_dw = int(src_real.flip(0).sum())  # dW[o] reads nbr[K-1-o]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    cin, cout = IN_CHANNELS, 32
    for dt in (torch.bfloat16, torch.float32):
        esz = torch.finfo(dt).bits // 8
        x = ck.feats(n, cin, l0.real, dt)
        w = ck.weights(dt, k, cin, cout)
        shape = f"L0 {n} rows K {k} {cin}->{cout}"
        ck.record("zconv_full_fwd", src,
                  "lidog_tpu/ops/zconv.py:342 (_zfull_core)",
                  lambda: sc.zconv_full_fwd(x, nbr, w, l0.real),
                  lambda: sc.sparse_conv_plain(x, nbr, w, l0.real),
                  dt, nbytes(nbr, x, w, l0.real) + n * cout * esz,
                  2 * cin * cout * hits, shape)
        dout = ck.feats(n, cout, ones, dt)
        wt = w.flip(0).transpose(1, 2).contiguous()
        ck.record("zconv_full_fwd", src,
                  "lidog_tpu/ops/zconv.py:373 (_zfull_bwd dx)",
                  lambda: sc.zconv_full_fwd(dout, nbr, wt, None,
                                            src_mask=l0.real),
                  lambda: sc.sparse_conv_plain(dout, nbr, wt, None,
                                               src_mask=l0.real),
                  dt, nbytes(nbr, dout, wt, l0.real) + n * cin * esz,
                  2 * cin * cout * hits_dx,
                  f"bwd dx L0 {n} rows K {k} {cout}->{cin}")
        ck.record("zconv_full_wgrad", src,
                  "lidog_tpu/ops/zconv.py:373 (_zfull_bwd dW)",
                  lambda: sc.zconv_full_wgrad(x, dout, nbr, l0.real),
                  lambda: sc.sparse_conv_wgrad_plain(x, dout, nbr, l0.real,
                                                     reverse=True),
                  dt, nbytes(x, dout, nbr, l0.real) + k * cin * cout * esz,
                  2 * cin * cout * hits_dw, shape)
        twice_equal("zconv_full_wgrad",
                    lambda: sc.zconv_full_wgrad(x, dout, nbr, l0.real),
                    "dW " + shape)
    stem_edge_checks(ck, nbr, l0.real)
    return ck.rows


# KO and KP widths beside the stem's (Cin, Cout): Q slices of one channel
# with W's AB = 1 path, two column sets (c, c + 32), and W too wide to
# stage (read from L2) with passes of 16 channels
STEM_EDGE_WIDTHS = ((1, 32), (4, 33), (64, 64))


def stem_edge_checks(ck, nbr, real):
    """KO (forward) and KP at STEM_EDGE_WIDTHS on the level-0 stem map,
    bf16, each within phase 3's bf16 bound (1e-2) of its plain version,
    KP twice bitwise equal; no timing."""
    import torch

    from lidog_tpu_torch.ops import sparse_conv as sc

    n, dt = nbr.shape[1], torch.bfloat16
    ones = torch.ones(n, dtype=torch.bool, device=real.device)
    tol = Checker.TOL_DEFAULT["bfloat16"]
    for cin, cout in STEM_EDGE_WIDTHS:
        x = ck.feats(n, cin, real, dt)
        w = ck.weights(dt, nbr.shape[0], cin, cout)
        dout = ck.feats(n, cout, ones, dt)
        shape = f"L0 {n} rows K {nbr.shape[0]} {cin}->{cout} {dt}"

        def kp():
            return sc.zconv_full_wgrad(x, dout, nbr, real)

        for name, kfn, pfn in (
                ("zconv_full_fwd", lambda: sc.zconv_full_fwd(x, nbr, w, real),
                 lambda: sc.sparse_conv_plain(x, nbr, w, real)),
                ("zconv_full_wgrad", kp,
                 lambda: sc.sparse_conv_wgrad_plain(x, dout, nbr, real,
                                                    reverse=True))):
            err = rel_err(kfn(), pfn())
            print(f"[kernel] {name} edge {shape}: err {err:.3e} (bound "
                  f"{tol})", flush=True)
            if not err <= tol:
                raise AssertionError(f"{name} edge {shape}: err {err} > "
                                     f"{tol}")
        twice_equal("zconv_full_wgrad", kp, "edge dW " + shape)


# the plan's sweep kernels (csrc/zseg_sweeps.cu) by their wrapper in
# core/zseg.py: (launch count, plain version, the lidog_tpu function)
PLAN_KERNELS = {
    "pos3_lookup": ("pos3_lookup", "pos3_plain", "lidog_tpu/core/zseg.py:682 "
                    "(pos3_lookup)"),
    "_build_packed": ("build_packed", "_build_packed_plain",
                      "lidog_tpu/core/zseg.py:378 (_build_packed)"),
    "stem_conv9_packed": ("stem_conv9_packed", "stem_conv9_plain",
                          "lidog_tpu/core/zseg.py:446 (stem_conv9_packed)"),
    "conv9_packed": ("conv9_packed", "conv9_plain",
                     "lidog_tpu/core/zseg.py:631 (conv9_packed)"),
}


def sweep_nbytes(name, args, kwargs):
    """Bytes that a plan sweep kernel must move on this run's data: each
    input read once (of the grid and the tables, the cells and rows its
    rows look up), each output written once."""
    import torch

    from lidog_tpu_torch.core.bitgrid import ZWORDS

    slab = (ZWORDS + 1) * 4  # an aug slab: words + start, int32
    if name == "pos3_lookup":
        aug16, coords, valid = args[:3]
        cid = kwargs["cid"]
        rows = int(torch.unique(cid[valid & (cid >= 0)]).numel())
        return nbytes(coords, valid, cid) + rows * slab + 3 * cid.numel() * 4
    if name == "_build_packed":
        from lidog_tpu_torch.core.zseg import packed_width

        real_w, aug16, col_bxy, col_valid = args[:4]
        r, aug_r, slots = args[7], kwargs["aug_r"], real_w.shape[0]
        return ((slots * ZWORDS * 4 if r >= 0 else 0) + slots * slab
                + nbytes(col_bxy, col_valid)
                + slots * packed_width(r, aug_r) * 4)
    coords, valid = args[2], args[3]
    n, cell = coords.shape[0], args[0].element_size()  # a grid cell's bytes
    cells, slots9 = sweep_lookups(args, kwargs, (-1, 0, 1))
    if name == "conv9_packed":
        return (nbytes(coords, valid) + cells * cell + slots9 * 3 * slab
                + 9 * n * 4)
    cells, slots = sweep_lookups(args, kwargs, range(-STEM_R, STEM_R + 1))
    k = (2 * STEM_R + 1) ** 3
    return (nbytes(coords, valid) + cells * cell
            + slots * (2 * STEM_R + 1) * ZWORDS * 4 + slots9 * 3 * slab
            + n * (k * 2 + 9 * 4))


def plan_kernel_checks(dev):
    """Phase 18: KR, KS, KT and KU torch.equal to their plain versions on
    the inputs the plan builder gives them: the serving plan of phase 4's
    scan, the training plan of 4 scans, its sortless plan, the general
    stem's plan (KU only; KQ is phase 15's), and the edge voxels of the CPU
    tests (data/synthetic.py plan_edge_voxels, roomy and starved caps);
    each at every level it runs at."""
    import torch

    from lidog_tpu_torch.caps import make_zcaps
    from lidog_tpu_torch.core import zseg
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.data import synthetic

    ck = Checker(None, dev)
    src = "lidog_tpu_torch/csrc/zseg_sweeps.cu"
    flat = torch.from_numpy(scan(POINTS, SEED)[0]).to(dev)
    vox = voxelize_device(flat, torch.ones(POINTS, dtype=torch.bool,
                                           device=dev),
                          torch.zeros(POINTS, dtype=torch.int32, device=dev),
                          VOXEL, PER_SCAN, batch_size=1)
    tpts, tlabels = train_data()
    tbatch = train_batch(tpts, tlabels, dev)
    raw = train_batch(tpts, tlabels, dev, sortless=True)
    edge = [torch.from_numpy(a).to(dev) for a in synthetic.plan_edge_voxels()]
    cases = [("serve", zseg.ZSegPlanBuilder(
        *make_zcaps(PER_SCAN)[:2], num_batches=1, grid_half=GRID_HALF,
        caps_col_dil=make_zcaps(PER_SCAN)[2]), vox.coords, vox.mask, None),
             ("train", train_plan_builder(), tbatch["coords"],
              tbatch["mask"], None),
             ("train sortless", train_plan_builder(assume_unique=False),
              raw["coords"], raw["mask"], None),
             ("train cin4", train_plan_builder(IN_CHANNELS),
              tbatch["coords"], tbatch["mask"], "_build_packed")]
    for label, caps in (("edges", synthetic.EDGE_CAPS),
                        ("edges starved", synthetic.EDGE_CAPS_STARVED)):
        cases.append((label, zseg.ZSegPlanBuilder(
            *caps, num_batches=2, grid_half=synthetic.EDGE_GRID_HALF),
            *edge, None))
    for label, builder, coords, mask, only in cases:
        for lvl, name, args, kwargs in builder.sweep_inputs(coords, mask):
            if only is not None and name != only:
                continue
            key, plain, replaces = PLAN_KERNELS[name]
            wrapper, plain = getattr(zseg, name), getattr(zseg, plain)
            if name == "_build_packed":
                r, aug_r = args[7], kwargs["aug_r"]
                shape = (f"{label} L{lvl} {args[0].shape[0]} slots, r {r} "
                         f"aug_r {aug_r}")
            else:
                rows = args[1] if name == "pos3_lookup" else args[2]
                shape = f"{label} L{lvl} {rows.shape[0]} rows"
            ck.record(key, src, replaces,
                      lambda f=wrapper, a=args, k=kwargs: f(*a, **k),
                      lambda f=plain, a=args, k=kwargs: f(*a, **k),
                      torch.bfloat16 if key == "stem_conv9_packed"
                      else torch.int32,
                      sweep_nbytes(name, args, kwargs), 0,
                      shape, mma=False, exact=True)
            ck.rows[-1]["level"] = lvl
    return ck.rows


# the plan's column-table kernels (csrc/zseg_tables.cu) by their wrapper
# in core/zseg.py: the lidog_tpu functions each replaces
TABLE_KERNELS = {
    "column_grid": "lidog_tpu/core/zseg.py:271 (_column_grid), :288 "
                   "(_grid_from_has), :300 (_dilate_y), :106, :129 "
                   "(_grid_lookup, K3, inlined), __call__:863-914",
    "real_words": "lidog_tpu/core/zseg.py:916-979 (__call__), :234 "
                  "(_zpair_words)",
    "assemble_aug": "lidog_tpu/core/zseg.py:335 (_assemble_aug)",
    "emit_rows": "lidog_tpu/core/zseg.py:1004-1026, 1049-1100 (__call__), "
                 ":735-770",
}


def grid_hits(grid, b, gx, gy, ok, g):
    """(cells looked up, of them hits) of grid lookups (b, gx, gy) where
    ok: what a column-table kernel reads of a grid on this run's data."""
    flat = ((b * g + gx) * g + gy)[ok]
    return int(flat.numel()), int((grid[flat] >= 0).sum())


def table_nbytes(name, args, kwargs):
    """Bytes that a column-table kernel must move on this run's data: each
    input read once (of a grid, the cells its rows look up, and of a
    table, the rows they hit), each output written once."""
    from lidog_tpu_torch.core.bitgrid import ZWORDS

    words = ZWORDS * 4  # a row's real words, int32 (not its 2 pad words)
    if name == "column_grid":  # the int32 grid, int64 vox_cid, col tables
        coords, valid, nb, gh, lvl, ccap = args[:6]
        g = (2 * gh) >> lvl
        return (nbytes(coords, valid) + nb * g * g * 4 + coords.shape[0] * 8
                + nb * ccap * 9)
    if name == "real_words":
        lvl, nb, ccap, gh = args
        out = nb * ccap * words
        if lvl == 0:
            return nbytes(kwargs["coords"], kwargs["valid"],
                          kwargs["vox_cid"]) + out
        cb, cv = kwargs["col_bxy"], kwargs["col_valid"]
        f_g = (2 * gh) >> (lvl - 1)
        b, gx, gy = cb >> 24, (cb >> 12) & 4095, cb & 4095
        cells = rows = 0
        for cx in (0, 1):
            for cy in (0, 1):
                gxf, gyf = 2 * gx + cx, 2 * gy + cy
                c, h = grid_hits(kwargs["fine_grid"], b, gxf, gyf,
                                 cv & (gxf < f_g) & (gyf < f_g), f_g)
                cells, rows = cells + c, rows + h
        return (nbytes(cb, cv) + cells * kwargs["fine_grid"].element_size()
                + rows * words + out)
    if name == "assemble_aug":
        cb, cv, grid, nb, g, ccap = args[1:7]
        b, gx, gy = cb >> 24, (cb >> 12) & 4095, cb & 4095
        cells = 0
        for dx in (-1, 1):
            ok = cv & (gx + dx >= 0) & (gx + dx < g)
            cells += grid_hits(grid, b, (gx + dx).clamp(0, g - 1), gy, ok,
                               g)[0]
        return (nb * ccap * words + nbytes(cb, cv)
                + cells * grid.element_size()
                + nb * ccap * (ZWORDS + 2) * 4 + nb * 8)
    pos3, coords, valid, counts_b, nb, cap_a, gh, lvl = args
    n, n_a = coords.shape[0], nb * cap_a
    out = n_a * (16 + 4) + n * 4  # coords, 4 flags; pos or parent
    if lvl:
        out += n * 4 + 8 * n_a * 4  # off, down8
    elif kwargs.get("rep"):
        out += n_a * 4
    return nbytes(pos3, coords, valid, counts_b) + out


def table_shape(name, args):
    """A column-table call's size: source rows in, slots or rows out."""
    if name == "column_grid":
        return f"{args[0].shape[0]} rows -> {args[2] * args[5]} slots"
    if name == "real_words":
        return f"{args[1] * args[2]} slots"
    if name == "assemble_aug":
        return f"{args[0].shape[0]} slots"
    return f"{args[1].shape[0]} rows -> {args[4] * args[5]} aug rows"


def table_call(fn, args, kwargs):
    """fn(*args, **kwargs) on a zeroed copy of its overflow vector (where
    it takes one); returns its outputs and that vector."""
    import torch

    def run():
        kw = dict(kwargs)
        if "overflow" in kw:
            kw["overflow"] = torch.zeros_like(kw["overflow"])
        out = fn(*args, **kw)
        out = out if isinstance(out, tuple) else (out,)
        return out + ((kw["overflow"],) if "overflow" in kw else ())
    return run


def table_kernel_checks(dev):
    """Phase 19: KV, KW, KX and KY torch.equal to their plain versions on
    the inputs the plan builder gives them (table_inputs), overflow terms
    included: the serving plan of phase 4's scan, the training plan of 4
    scans, its sortless plan (device_batch_raw), the general stem's plan,
    and the edge voxels of the CPU tests with roomy, starved and
    column-starved caps, and as sortless input (also with caps_real below
    its voxels); each at every level, and the scratch of KV, KX and KY
    zero again after each check's launches."""
    import torch

    from lidog_tpu_torch.caps import make_zcaps
    from lidog_tpu_torch.core import zseg
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.data import synthetic as syn

    ck = Checker(None, dev)
    src = "lidog_tpu_torch/csrc/zseg_tables.cu"
    flat = torch.from_numpy(scan(POINTS, SEED)[0]).to(dev)
    vox = voxelize_device(flat, torch.ones(POINTS, dtype=torch.bool,
                                           device=dev),
                          torch.zeros(POINTS, dtype=torch.int32, device=dev),
                          VOXEL, PER_SCAN, batch_size=1)
    tpts, tlabels = train_data()
    tbatch = train_batch(tpts, tlabels, dev)
    raw = train_batch(tpts, tlabels, dev, sortless=True)
    edge = [torch.from_numpy(a).to(dev) for a in syn.plan_edge_voxels()]
    edge_raw = [torch.from_numpy(a).to(dev)
                for a in syn.plan_edge_voxels_sortless()]
    zc = make_zcaps(PER_SCAN)
    cases = [("serve", zseg.ZSegPlanBuilder(
        *zc[:2], num_batches=1, grid_half=GRID_HALF, caps_col_dil=zc[2]),
        vox.coords, vox.mask),
             ("train", train_plan_builder(), tbatch["coords"], tbatch["mask"]),
             ("train sortless", train_plan_builder(assume_unique=False),
              raw["coords"], raw["mask"]),
             ("train cin4", train_plan_builder(IN_CHANNELS),
              tbatch["coords"], tbatch["mask"])]
    edge_kw = dict(num_batches=2, grid_half=syn.EDGE_GRID_HALF)
    for label, caps, opts, rows in (
            ("edges", syn.EDGE_CAPS, {}, edge),
            ("edges starved", syn.EDGE_CAPS_STARVED, {}, edge),
            ("edges col starved", syn.EDGE_CAPS,
             dict(caps_col_dil=syn.EDGE_COL_DIL_STARVED), edge),
            ("edges sortless", syn.EDGE_CAPS, dict(assume_unique=False),
             edge_raw),
            ("edges sortless starved", ((256,) * 5, syn.EDGE_CAPS[1]),
             dict(assume_unique=False), edge_raw)):
        cases.append((label, zseg.ZSegPlanBuilder(*caps, **edge_kw, **opts),
                      *rows))
    for label, builder, coords, mask in cases:
        for lvl, name, args, kwargs in builder.table_inputs(coords, mask):
            wrapper = getattr(zseg, name)
            plain = getattr(zseg, name + "_plain")
            ck.record(name, src, TABLE_KERNELS[name],
                      table_call(wrapper, args, kwargs),
                      table_call(plain, args, kwargs),
                      torch.int32 if name in ("assemble_aug", "real_words")
                      else torch.int64,
                      table_nbytes(name, args, kwargs), 0,
                      f"{label} L{lvl} {table_shape(name, args)}",
                      mma=False, exact=True)
            ck.rows[-1]["level"] = lvl
            torch.cuda.synchronize()
            bad = zseg.scratch_left_zero(coords.device)
            if bad:
                raise AssertionError(f"{name} {label} L{lvl}: scratch "
                                     f"{bad} left nonzero")
    return ck.rows


def serve(model, pts, dev):
    """Phase 4: timed requests through the Predictor, each followed by one
    request split into stages (in turns, so that both see the same host);
    returns stats."""
    import torch

    from lidog_tpu_torch.serve import Predictor

    pred = Predictor(model, batch_size=1, voxel_size=VOXEL,
                     caps_per_scan=PER_SCAN, grid_half=GRID_HALF, device=dev)
    pts_dev = torch.from_numpy(pts).to(dev)
    labels = pred(pts_dev)  # warm-up (Triton specializations, caches)
    torch.cuda.synchronize()
    ms, splits = [], []
    launches = dict.fromkeys(counters(), 0)
    for _ in range(REQUESTS):
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = pred(pts_dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in counters().items():
            launches[k] += v
        split, plan_rows, bounds = stage_split(pred, pts_dev)
        splits.append(split)
    lab = labels.cpu().numpy()
    ov = pred.overflow
    print(f"[serve] overflow {ov.tolist()} labelled "
          f"{(lab >= 0).mean():.4f} request ms {ms}; split in turns "
          f"{splits}", flush=True)
    if ov.sum() != 0:
        raise AssertionError(f"plan overflow {ov.tolist()}")
    if not (lab >= 0).mean() >= 0.95:
        raise AssertionError(f"only {(lab >= 0).mean():.4f} of points labelled")
    if lab.max() >= NUM_CLASSES or lab.min() < -1:
        raise AssertionError(f"labels outside [0, {NUM_CLASSES})")
    for k, per in PER_REQUEST.items():
        if launches[k] != per * REQUESTS:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} x {REQUESTS}")
    stages = {n: statistics.median(sp[n] for sp in splits) for n in splits[0]}
    print(f"[serve] plain stages' byte bounds: {bounds}", flush=True)
    return {"p50_ms": statistics.median(ms), "request_ms": ms,
            "launches": launches, "stages_ms": stages, "stage_runs_ms": splits,
            "stage_bounds": bounds,
            "real_rows_per_level": plan_rows,
            "labelled": float((lab >= 0).mean()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def plan_nbytes(plan):
    """Bytes of every tensor a plan holds: what the plan build writes."""
    ts = [getattr(lv, f) for lv in plan.levels
          for f in ("coords", "real", "valid", "zup", "zdn")]
    ts += list(plan.kmaps.values()) + [plan.pos, plan.overflow]
    return nbytes(*ts) + (0 if plan.rep is None else nbytes(plan.rep))


def byte_bounds(**stage_bytes):
    """{stage: (bytes, least ms on an H100: the bytes over 3.35 TB/s)} for
    the stages that run as plain torch (K1 voxelize, K2-K10 the plan, K15
    the labels): each input read once, each output written once."""
    return {k: {"bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3}
            for k, b in stage_bytes.items()}


def stage_split(pred, pts_dev):
    """Device ms of voxelize / plan / forward / labels for one request
    (CUDA events between the Predictor's stages), the real rows per level,
    and the plain stages' byte bounds."""
    import torch

    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.core.voxelize import voxelize_device

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.no_grad():
        ev[0].record()
        flat = pts_dev.reshape(-1, 3)
        valid = torch.ones(flat.shape[0], dtype=torch.bool,
                           device=flat.device)
        bidx = torch.zeros(flat.shape[0], dtype=torch.int32,
                           device=flat.device)
        vox = voxelize_device(flat, valid, bidx, pred.voxel_size,
                              pred.cap_in, batch_size=1)
        ev[1].record()
        plan = pred.builder(vox.coords, vox.mask)
        ev[2].record()
        logits = pred.model(input_tensor(
            plan, vox.mask[:, None].float()), plan)
        ev[3].record()
        out = pred.labels_of(plan, logits, vox)
        ev[4].record()
    torch.cuda.synchronize()
    names = ("voxelize", "plan", "forward", "labels")
    bounds = byte_bounds(
        voxelize=nbytes(flat, valid, bidx, vox.coords, vox.mask, vox.rep_idx,
                        vox.inverse),
        plan=nbytes(vox.coords, vox.mask) + plan_nbytes(plan),
        labels=nbytes(logits, plan.level(0).real, plan.pos, vox.inverse,
                      out))
    return ({n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)},
            [int(l.real.sum()) for l in plan.levels], bounds)


def plans_equal(a, b, what):
    """Raise unless two plans (on any devices) have equal levels, kmaps and
    overflow, and the overflow is 0."""
    import torch

    def same(x, y):
        return torch.equal(x.cpu(), y.cpu())

    for i, (la, lb) in enumerate(zip(a.levels, b.levels)):
        for f in ("coords", "real", "valid", "zup", "zdn"):
            if not same(getattr(la, f), getattr(lb, f)):
                raise AssertionError(f"{what}: level {i} {f} differs")
    if sorted(a.kmaps) != sorted(b.kmaps):
        raise AssertionError(f"{what}: kmaps {sorted(a.kmaps)} vs "
                             f"{sorted(b.kmaps)}")
    for k in a.kmaps:
        if not same(a.kmaps[k], b.kmaps[k]):
            raise AssertionError(f"{what}: kmap {k} differs")
    if not same(a.overflow, b.overflow) or int(a.overflow.sum()):
        raise AssertionError(f"{what}: overflow {a.overflow.tolist()} vs "
                             f"{b.overflow.tolist()}")


def cross_check(model, dev):
    """Phase 5: card vs CPU, same weights and caps: on the 20,000-point
    check scan (seed 1) and on phase 4's 100,000-point scan (seed 0) the
    voxelization (every field) and the plan (through KR-KY on the card,
    their plain versions on the CPU) bitwise equal, and the sortless
    training batch's plan (pos and rep included) too; on the check scan
    the labels agree on >= 99% of points."""
    import torch

    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.serve import Predictor

    kw = dict(batch_size=1, voxel_size=VOXEL, caps_per_scan=PER_SCAN,
              grid_half=GRID_HALF)
    gpu = Predictor(model, device=dev, **kw)
    cpu = Predictor(copy.deepcopy(model).cpu(), device="cpu", **kw)
    for points, seed in ((CHECK_POINTS, SEED + 1), (POINTS, SEED)):
        flat = torch.from_numpy(scan(points, seed)[0])
        vp = []
        for pred in (gpu, cpu):
            d = pred.device
            vox = voxelize_device(
                flat.to(d), torch.ones(points, dtype=torch.bool, device=d),
                torch.zeros(points, dtype=torch.int32, device=d), VOXEL,
                pred.cap_in, batch_size=1)
            vp.append((vox, pred.builder(vox.coords, vox.mask)))
        (vox_g, plan_g), (vox_c, plan_c) = vp
        for f in vox_g._fields:
            if not torch.equal(getattr(vox_g, f).cpu(), getattr(vox_c, f)):
                raise AssertionError(f"card vs CPU voxelization of {points} "
                                     f"points: {f} differs")
        plans_equal(plan_g, plan_c, f"card vs CPU plan of {points} points")
        if not torch.equal(plan_g.pos.cpu(), plan_c.pos):
            raise AssertionError(f"card vs CPU plan of {points} points: pos "
                                 "differs")
        print(f"[check] {points} points (seed {seed}): voxels and plan "
              f"bitwise equal on {len(plan_c.kmaps)} maps", flush=True)
    # the sortless training batch (raw per-point cells, duplicates kept):
    # its assume_unique=False plan on the card (KV-KY) and on the CPU
    tpts, tlabels = train_data()
    raw = train_batch(tpts, tlabels, dev, sortless=True)
    builder = train_plan_builder(assume_unique=False)
    plan_g = builder(raw["coords"], raw["mask"])
    plan_c = builder(raw["coords"].cpu(), raw["mask"].cpu())
    plans_equal(plan_g, plan_c, "card vs CPU sortless training plan")
    for f in ("pos", "rep"):
        if not torch.equal(getattr(plan_g, f).cpu(), getattr(plan_c, f)):
            raise AssertionError(f"card vs CPU sortless training plan: {f} "
                                 "differs")
    print(f"[check] sortless training batch ({raw['coords'].shape[0]} raw "
          f"cells): plan, pos and rep bitwise equal on "
          f"{len(plan_c.kmaps)} maps", flush=True)
    del raw, plan_g, plan_c
    pts = scan(CHECK_POINTS, SEED + 1)
    lab_g = gpu(pts).cpu().numpy()
    lab_c = cpu(pts).numpy()
    both = (lab_g >= 0) | (lab_c >= 0)
    agree = float((lab_g == lab_c)[both].mean())
    print(f"[check] label agreement card vs CPU {agree:.5f}", flush=True)
    if not agree >= 0.99:
        raise AssertionError(f"label agreement {agree} < 0.99")
    return agree


def train_batch(points, labels, dev, feats=None, sortless=False,
                cap_in=TRAIN_CAP_IN):
    """The training batch of the points: voxelized (or, sortless, the raw
    per-point cells), with one constant input channel or the per-point
    features `feats` (numpy [B, P, C]; point_features)."""
    import torch

    from lidog_tpu_torch.train.device_pipeline import (
        device_batch_from_points, device_batch_raw)

    b, p = points.shape[:2]
    args = (torch.from_numpy(points).to(dev),
            torch.ones(b, p, dtype=torch.bool, device=dev),
            torch.from_numpy(labels).to(dev), VOXEL)
    if feats is not None:
        feats = torch.from_numpy(feats).to(dev)
    if sortless:
        return device_batch_raw(*args, point_feats=feats)
    return device_batch_from_points(*args, cap_in, point_feats=feats)


def train_plan_builder(in_channels=1, **options):
    """The plan builder at bench.py's training caps for a model with
    `in_channels` input channels."""
    from lidog_tpu_torch.caps import plan_builder

    return plan_builder(in_channels, TRAIN_BATCH, (ZCAPS_R, ZCAPS_A, ZCAPS_D),
                        grid_half=GRID_HALF, **options)


def train_data():
    import numpy as np

    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset

    ds = SyntheticLidarDataset(num_scans=TRAIN_BATCH, points_per_scan=POINTS,
                               radius=50.0, seed=SEED)
    scans = [ds[i] for i in range(TRAIN_BATCH)]
    return (np.stack([d["points"] for d in scans]),
            np.stack([d["sem_labels"] for d in scans]).astype(np.int32))


def variant_model(variant, dtype, generator):
    """The model of a training path at full width: "source" and "generic"
    MinkUNet34, "ibn" MinkUNet34IBN, "robustnet" MinkUNet34Robust, "cin4"
    MinkUNet34 with IN_CHANNELS input channels (the general stem)."""
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.models.minkunet_ibn import MinkUNet34IBN
    from lidog_tpu_torch.models.minkunet_robustnet import MinkUNet34Robust

    cls = {"source": MinkUNet34, "ibn": MinkUNet34IBN, "cin4": MinkUNet34,
           "robustnet": MinkUNet34Robust, "generic": MinkUNet34}[variant]
    return cls(out_channels=NUM_CLASSES, compute_dtype=dtype,
               generator=generator, in_channels=in_channels_of(variant))


def in_channels_of(variant):
    return IN_CHANNELS if variant == "cin4" else 1


def features_of(variant, points):
    """The per-point input features of a path's model (None: one constant
    channel): for the general stem, the points' x, y, z and a remission
    drawn from the seed."""
    from lidog_tpu_torch.data.synthetic import point_features

    cin = in_channels_of(variant)
    return None if cin == 1 else point_features(points, cin, SEED)


def variant_step(variant, cov_stat_epoch=0, whitening=None, caps=None):
    """The train step of a path: make_train_step (source, IBN; generic:
    with no plan given it builds the batch's UNetPlan at `caps`, by
    default GENERIC_CAPS), or the
    RobustNet step with IW (or the given whitening loss) and its gate on
    from epoch cov_stat_epoch."""
    from lidog_tpu_torch.losses.losses import IWLoss, SoftDICELoss
    from lidog_tpu_torch.train.robustnet_step import make_robustnet_train_step
    from lidog_tpu_torch.train.train_step import make_train_step

    crit = SoftDICELoss(ignore_label=-1)
    if variant == "robustnet":
        return make_robustnet_train_step(
            crit, whitening or IWLoss(), num_classes=NUM_CLASSES,
            cov_stat_epoch=cov_stat_epoch)
    if variant == "generic":
        return make_train_step(crit, num_classes=NUM_CLASSES,
                               caps=caps or GENERIC_CAPS)
    return make_train_step(crit, num_classes=NUM_CLASSES)


def train(dev, variant="source"):
    """Phases 6, 12, 13 and 16: full-width bf16 training steps of one path;
    returns stats.  The general stem (variant "cin4") also takes one eval
    step."""
    import torch

    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState, make_eval_step

    pts, labels = train_data()
    model = variant_model(variant, torch.bfloat16,
                          torch.Generator().manual_seed(SEED))
    step = variant_step(variant)
    state = TrainState.create(model, make_optimizer("Adam", lr=1e-3),
                              device=dev)
    builder = train_plan_builder(in_channels_of(variant))
    feats = features_of(variant, pts)

    def full_step():
        batch = train_batch(pts, labels, dev, feats)
        plan = builder(batch["coords"], batch["mask"])
        _, metrics = step(state, batch, plan)
        torch.cuda.synchronize()
        return batch, plan, metrics

    batch, plan, metrics = full_step()  # warm-up (Triton specializations)
    overflow = plan.overflow.cpu().tolist()
    if sum(overflow) != 0:
        raise AssertionError(f"training plan overflow {overflow}")
    supervised = int(((batch["labels"] >= 0) & batch["mask"]).sum())
    losses = [float(metrics["loss"])]
    aux = [float(metrics["aux_loss"])] if "aux_loss" in metrics else []
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    ms = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = full_step()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        if aux:
            aux.append(float(metrics["aux_loss"]))
        total = int(metrics["confusion"].sum())
        if total != supervised:
            raise AssertionError(f"confusion total {total} != {supervised} "
                                 "supervised voxels")
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{variant}] overflow {overflow} supervised voxels {supervised} "
          f"losses {losses} aux losses {aux} step ms {ms}", flush=True)
    if not all(math.isfinite(v) for v in losses + aux) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{variant} losses {losses}, aux {aux}: not "
                             "finite or not falling")
    if variant == "robustnet" and not aux:
        raise AssertionError("the RobustNet step reported no aux_loss")
    for k, per in PER_VARIANT_STEP[variant].items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in {variant} "
                                 f"training, expected {per} x {TRAIN_STEPS}")
    evals = {}
    if variant == "cin4":
        batch = train_batch(pts, labels, dev, feats)
        plan = builder(batch["coords"], batch["mask"])
        ev = make_eval_step(SoftDICELoss(ignore_label=-1),
                            NUM_CLASSES)(state, batch, plan)
        evals = {"eval_loss": float(ev["loss"]),
                 "eval_confusion_total": int(ev["confusion"].sum())}
        print(f"[{variant}] eval step: {evals}", flush=True)
        if not math.isfinite(evals["eval_loss"]) \
                or evals["eval_confusion_total"] != supervised:
            raise AssertionError(f"{variant} eval step {evals}")
    stages = train_stage_split(state, pts, labels, builder, dev, variant,
                               feats)
    p50 = statistics.median(ms)
    return {"p50_ms": p50, "scans_per_s": TRAIN_BATCH / p50 * 1e3,
            "step_ms": ms, "losses": losses, "aux_losses": aux, **evals,
            "launches": launches, "stages_ms": stages,
            "supervised_voxels": supervised,
            "real_rows_per_level": [int(l.real.sum()) for l in plan.levels],
            "peak_mem_gb": peak,
            "params": sum(p.numel() for p in model.parameters())}


def train_stage_split(state, pts, labels, builder, dev, variant="source",
                      feats=None):
    """Device ms of voxelize / plan / forward+loss / backward / optimizer
    for one step (CUDA events between the stages; median of 3)."""
    import torch

    from lidog_tpu_torch.losses.losses import IWLoss, SoftDICELoss
    from lidog_tpu_torch.train.robustnet_step import robust_forward
    from lidog_tpu_torch.train.train_step import _forward_loss

    crit = SoftDICELoss(ignore_label=-1)
    runs = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        batch = train_batch(pts, labels, dev, feats)
        ev[1].record()
        plan = builder(batch["coords"], batch["mask"])
        ev[2].record()
        state.optimizer.zero_grad()
        model = state.model.train()
        if variant == "robustnet":  # the step's loss, gate on
            sem, aux, _ = robust_forward(model, batch, crit, IWLoss(),
                                         NUM_CLASSES, plan)
            loss = sem + 0.5 * aux
        else:
            loss, _ = _forward_loss(model, batch, crit, NUM_CLASSES, plan)
        ev[3].record()
        loss.backward()
        ev[4].record()
        state.optimizer.step()
        ev[5].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    names = ("voxelize", "plan", "forward", "backward", "optimizer")
    stages = {n: statistics.median(r[i] for r in runs)
              for i, n in enumerate(names)}
    n = pts.shape[0] * pts.shape[1]
    in_bytes = n * (12 + 1 + 4) + (0 if feats is None else feats.nbytes)
    stages["bounds"] = byte_bounds(
        voxelize=in_bytes + nbytes(*batch.values()),
        plan=nbytes(batch["coords"], batch["mask"]) + plan_nbytes(plan))
    return stages


class AuxProbe:
    """A whitening loss that records the grad it sends back into each tap
    (through a view of the tap that only the loss reads)."""

    def __init__(self, loss):
        self.loss, self.grads = loss, []

    def __call__(self, feats, mask):
        tap = feats.view_as(feats)
        tap.register_hook(lambda g: self.grads.append(g.detach().cpu()))
        return self.loss(feats=tap, mask=mask)


def train_cross_check(dev, variant="source"):
    """Phases 7 and 14: one f32 step of a full-width model on a
    20,000-point scan on the card and on the CPU from the same weights,
    and a third step on the CPU from the weights scaled by (1 + 1e-7 N(0,
    1)): the floor.  RobustNet runs the card and the CPU step twice, with
    the gate on (and its floor) and with it off, where the grads of the
    aux loss into its 5 taps must be exactly 0.

    The forward is well-conditioned: loss, aux_loss and batch_stats within
    1e-4 of the CPU's (relative, per tensor).  The backward is not: a ReLU
    input within rounding of 0 flips its gate, so a 1e-7 change of the
    weights moves single grad entries by percents.  So the grads are held,
    in relative L2 norm (whole model, and the worst tensor), to 10x the
    floor's; the params after Adam's first step (lr * g / (|g| + eps),
    about lr * sign(g)) to 2 lr everywhere, and the share of entries whose
    update changed sign to 10x the floor's share + 1e-4.  The gate-off
    step takes the gate-on floor: its grads are the SoftDICE part of the
    same model's.

    The general stem (phase 16, variant "cin4"; 4 input channels, plans
    with the stem's source-row maps) and the generic plan (phase 22,
    variant "generic": no plan given, the step builds the UNetPlan at
    make_caps(1, CHECK_PER_SCAN)): also the card's stem map equal to the CPU's,
    the stem's output within 1e-4 of the CPU's (relative to its max), and
    the stem kernel's grad by the L2 rule above."""
    import numpy as np
    import torch

    from lidog_tpu_torch.caps import make_caps, make_zcaps, plan_builder
    from lidog_tpu_torch.core.plan import build_unet_plan
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset
    from lidog_tpu_torch.losses.losses import IWLoss
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState

    lr = 1e-3
    scan0 = SyntheticLidarDataset(num_scans=1, points_per_scan=CHECK_POINTS,
                                  radius=50.0, seed=SEED + 2)[0]
    pts = scan0["points"][None]
    labels = scan0["sem_labels"][None].astype(np.int32)
    caps_r, caps_a, caps_d = make_zcaps(PER_SCAN)
    # the generic plan at pooled caps that fit the check scan's 19,976
    # voxels (the CPU's plain gathers run over every row of a level)
    generic_caps = make_caps(1, CHECK_PER_SCAN)
    cap_in = generic_caps[0] if variant == "generic" else caps_r[0]
    cpu_model = variant_model(variant, torch.float32,
                              torch.Generator().manual_seed(SEED + 3))
    pert_model = copy.deepcopy(cpu_model)
    noise = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        for p in pert_model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=noise))
    cpu = torch.device("cpu")
    # (gate on from epoch: 0 on, 1 off at the step's epoch 0; device, model)
    runs = {"cuda": (0, dev, cpu_model), "cpu": (0, cpu, cpu_model),
            "floor": (0, cpu, pert_model)}
    if variant == "robustnet":
        runs.update({"cuda_gate_off": (1, dev, cpu_model),
                     "cpu_gate_off": (1, cpu, cpu_model)})
    out = {}
    for where, (cov, d, base) in runs.items():
        model = copy.deepcopy(base)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        state = TrainState.create(model, make_optimizer("Adam", lr=lr),
                                  device=d)
        batch = train_batch(pts, labels, d, features_of(variant, pts),
                            cap_in=cap_in)
        if variant == "generic":  # the plan the step builds itself
            plan = build_unet_plan(batch["coords"], batch["mask"],
                                   generic_caps)
        else:
            plan = plan_builder(in_channels_of(variant), 1,
                                (caps_r, caps_a, caps_d),
                                grid_half=GRID_HALF)(batch["coords"],
                                                     batch["mask"])
        if int(plan.overflow.sum()) != 0:
            raise AssertionError(f"check plan overflow {plan.overflow}")
        probe = AuxProbe(IWLoss())
        stem = model.backbone.conv0 if hasattr(model, "backbone") \
            else model.conv0
        stem_out = []
        hook = stem.register_forward_hook(
            lambda mod, args, res: stem_out.append(res.feats.detach().cpu()))
        t0 = time.perf_counter()
        _, metrics = variant_step(variant, cov, probe, generic_caps)(
            state, batch, None if variant == "generic" else plan)
        hook.remove()
        stem_map = next(plan.kmaps[k] for k in ("stem125", "stem", "conv9_l0")
                        if k in plan.kmaps)
        out[where] = {
            "stem_map": stem_map.cpu(), "stem_out": stem_out[0],
            "loss": float(metrics["loss"]),
            "aux_loss": float(metrics.get("aux_loss", 0.0)),
            "aux_grads": probe.grads,
            "confusion": metrics["confusion"].cpu(),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()},
            "update": {n: p.detach().cpu() - before[n]
                       for n, p in model.named_parameters()},
            "stats": {n: b.detach().cpu() for n, b in model.named_buffers()},
            "s": time.perf_counter() - t0}

    def compare(a, b):
        """a against the CPU run b."""
        num = sum(float(((a["grads"][n] - g) ** 2).sum())
                  for n, g in b["grads"].items())
        den = sum(float((g ** 2).sum()) for g in b["grads"].values())
        per = {n: float((a["grads"][n] - g).norm() / g.norm().clamp(
            min=1e-30)) for n, g in b["grads"].items()}
        flips = sum(int(((a["update"][n] > 0) != (u > 0)).sum())
                    for n, u in b["update"].items())
        total = sum(u.numel() for u in b["update"].values())
        return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "aux_loss": abs(a["aux_loss"] - b["aux_loss"])
                / max(abs(b["aux_loss"]), 1e-30),
                "stats": max(rel_err(a["stats"][n], v)
                             for n, v in b["stats"].items()),
                "grad_l2": (num / den) ** 0.5, "grad_l2_worst": max(
                    per.values()),
                "grad_l2_worst_tensor": max(per, key=per.get),
                "update_sign_flips": flips / total,
                "param_lr": max(float((a["params"][n] - p).abs().max())
                                for n, p in b["params"].items()) / lr,
                "confusion_abs_diff": int(
                    (a["confusion"] - b["confusion"]).abs().sum()),
                "stem_map_equal": bool(torch.equal(a["stem_map"],
                                                   b["stem_map"])),
                "stem_out": rel_err(a["stem_out"], b["stem_out"]),
                "stem_grad_l2": per[stem_key]}

    stem_key = next(n for n in out["cpu"]["grads"] if "conv0.kernel" in n)
    floor = compare(out["floor"], out["cpu"])
    result = {"floor": floor}
    bounds = {"loss": 1e-4, "aux_loss": 1e-4, "stats": 1e-4,
              "grad_l2": 10 * floor["grad_l2"] + 1e-6,
              "grad_l2_worst": 10 * floor["grad_l2_worst"] + 1e-6,
              "update_sign_flips": 10 * floor["update_sign_flips"] + 1e-4,
              "param_lr": 2.0}
    if variant in ("cin4", "generic"):
        bounds.update({"stem_out": 1e-4,
                       "stem_grad_l2": 10 * floor["stem_grad_l2"] + 1e-6})
        if not compare(out["cuda"], out["cpu"])["stem_map_equal"]:
            raise AssertionError(f"{variant} cross-check: the card's stem "
                                 "map differs from the CPU's")
    for gate in [""] + (["_gate_off"] if variant == "robustnet" else []):
        got = compare(out["cuda" + gate], out["cpu" + gate])
        print(f"[{variant}-check{gate}] card vs CPU, f32 full width, "
              f"{CHECK_POINTS} points: {got}; floor (CPU, weights x (1 + "
              f"1e-7 N)): {floor}; step s card "
              f"{out['cuda' + gate]['s']:.2f} CPU "
              f"{out['cpu' + gate]['s']:.2f}", flush=True)
        result["card_vs_cpu" + gate] = got
    for gate in [""] + (["_gate_off"] if variant == "robustnet" else []):
        got = result["card_vs_cpu" + gate]
        for k, b in bounds.items():
            if not got[k] <= b:
                raise AssertionError(f"{variant} cross-check{gate} {k}: "
                                     f"{got[k]} > {b}")
    if variant == "robustnet":
        on, off = out["cuda"]["aux_grads"], out["cuda_gate_off"]["aux_grads"]
        if len(on) != 5 or len(off) != 5:
            raise AssertionError(f"aux grads of {len(on)}, {len(off)} taps, "
                                 "expected 5")
        if not all(bool(g.abs().sum() > 0) for g in on):
            raise AssertionError("a tap got no aux grad with the gate on")
        nonzero = [int((g != 0).sum()) for g in off]
        print(f"[{variant}-check] aux grads into the 5 taps: gate on max "
              f"{[float(g.abs().max()) for g in on]}, gate off nonzero "
              f"entries {nonzero}", flush=True)
        if any(nonzero):
            raise AssertionError(f"gate off: aux grads not 0 ({nonzero})")
        result["aux_grad_nonzero_gate_off"] = nonzero
    return result


def sortless(dev):
    """Phase 17: the sortless path.  Serving: Predictor(sortless=True) and
    the sorted Predictor (MinkUNet34 bf16, phase 4's seeded weights) on
    phase 4's scan: the two plans' levels, kmaps and overflow equal, every
    point's label equal; then 5 timed requests of each, in turns (sorted,
    sortless, sortless, sorted, ...; the sortless counters = launches x
    requests).  Training (the training cell's batch and caps): the sorted
    step twice and the sortless one (device_batch_raw -> assume_unique=
    False plan -> step) from the same weights, the plans equal and the
    sortless loss equal to the sorted one (bitwise where the two sorted
    runs agree bitwise, else within their spread); then 5 more steps of
    each, in turns (finite losses, the last below the first, confusion
    totals equal to the supervised voxels, the sortless counters =
    launches x steps), and one sortless step alone for its peak memory."""
    import torch

    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState

    model = MinkUNet34(out_channels=NUM_CLASSES, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED))
    pts = torch.from_numpy(scan(POINTS, SEED)).to(dev)
    kw = dict(batch_size=1, voxel_size=VOXEL, caps_per_scan=PER_SCAN,
              grid_half=GRID_HALF, device=dev)
    preds = {"sorted": Predictor(model, **kw),
             "sortless": Predictor(model, sortless=True, **kw)}
    plans = {k: p.forward_voxels(pts)[1] for k, p in preds.items()}
    plans_equal(plans["sorted"], plans["sortless"], "sortless serving plan")
    labels = {k: p(pts) for k, p in preds.items()}
    same = float((labels["sorted"] == labels["sortless"]).float().mean())
    print(f"[sortless] serving plan equal to the sorted one; labels equal on "
          f"{same:.6f} of {POINTS} points", flush=True)
    if not torch.equal(labels["sorted"], labels["sortless"]):
        raise AssertionError(f"sortless labels differ ({same} equal)")
    del plans
    # the two paths in turns (sorted, sortless, sortless, sorted, ...), the
    # counters read for the sortless requests only
    serve_ms = {"sorted": [], "sortless": []}
    serve_launches = dict.fromkeys(counters(), 0)
    for i in range(REQUESTS):
        for kind in in_turns(("sorted", "sortless"), i):
            zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds[kind](pts)
            torch.cuda.synchronize()
            serve_ms[kind].append((time.perf_counter() - t0) * 1e3)
            if kind == "sortless":
                for k, v in counters().items():
                    serve_launches[k] += v
    for k, per in PER_SORTLESS_REQUEST.items():
        if serve_launches[k] != per * REQUESTS:
            raise AssertionError(f"{k}: {serve_launches[k]} launches in "
                                 f"sortless serving, expected {per} x "
                                 f"{REQUESTS}")
    del preds, model
    torch.cuda.empty_cache()

    tpts, tlabels = train_data()
    builders = {"sorted": train_plan_builder(),
                "sortless": train_plan_builder(assume_unique=False)}
    step = variant_step("source")

    def run_step(kind, state):
        batch = train_batch(tpts, tlabels, dev, sortless=kind == "sortless")
        plan = builders[kind](batch["coords"], batch["mask"])
        _, metrics = step(state, batch, plan)
        return metrics, plan, batch

    def first_step(kind):
        m = variant_model("source", torch.bfloat16,
                          torch.Generator().manual_seed(SEED))
        state = TrainState.create(m, make_optimizer("Adam", lr=1e-3),
                                  device=dev)
        metrics, plan, batch = run_step(kind, state)
        return float(metrics["loss"]), state, plan, batch

    loss_s1, state_s, plan_s, batch_s = first_step("sorted")
    loss_s2 = first_step("sorted")[0]
    loss_r, state_r, plan_r, _ = first_step("sortless")
    plans_equal(plan_s, plan_r, "sortless training plan")
    supervised = int(((batch_s["labels"] >= 0) & batch_s["mask"]).sum())
    del plan_s, batch_s, plan_r
    spread = abs(loss_s1 - loss_s2)
    print(f"[sortless] first-step loss sorted {loss_s1!r}, {loss_s2!r} "
          f"(spread {spread!r}), sortless {loss_r!r}", flush=True)
    if not abs(loss_r - loss_s1) <= spread:
        raise AssertionError(f"sortless loss {loss_r!r} vs sorted "
                             f"{loss_s1!r} (two sorted runs: spread "
                             f"{spread!r})")
    states = {"sorted": state_s, "sortless": state_r}
    losses = {"sorted": [loss_s1], "sortless": [loss_r]}
    ms = {"sorted": [], "sortless": []}
    launches = dict.fromkeys(counters(), 0)
    for i in range(TRAIN_STEPS):
        for kind in in_turns(("sorted", "sortless"), i):
            zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run_step(kind, states[kind])[0]
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            losses[kind].append(float(metrics["loss"]))
            total = int(metrics["confusion"].sum())
            if total != supervised:
                raise AssertionError(f"{kind} confusion total {total} != "
                                     f"{supervised} supervised voxels")
            if kind == "sortless":
                for k, v in counters().items():
                    launches[k] += v
    # the sortless step's peak memory, with its model alone on the card
    del states, state_s
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_step("sortless", state_r)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[sortless] losses {losses} step ms {ms}; request ms "
          f"{serve_ms}", flush=True)
    for kind, seq in losses.items():
        if not all(math.isfinite(v) for v in seq) or not seq[-1] < seq[0]:
            raise AssertionError(f"{kind} losses {seq}: not finite or not "
                                 "falling")
    for k, per in PER_STEP.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in sortless "
                                 f"training, expected {per} x {TRAIN_STEPS}")
    p50 = {k: statistics.median(v) for k, v in ms.items()}
    return {"serve_p50_ms": statistics.median(serve_ms["sortless"]),
            "serve_sorted_p50_ms": statistics.median(serve_ms["sorted"]),
            "request_ms": serve_ms, "serve_launches": serve_launches,
            "p50_ms": p50["sortless"], "sorted_p50_ms": p50["sorted"],
            "scans_per_s": TRAIN_BATCH / p50["sortless"] * 1e3,
            "step_ms": ms, "losses": losses, "launches": launches,
            "first_loss_sorted": [loss_s1, loss_s2],
            "first_loss_sortless": loss_r, "peak_mem_gb": peak,
            "supervised_voxels": supervised}


def in_turns(pair, i):
    """The two of `pair` in the order of round i: a, b, then b, a, ..."""
    return pair if i % 2 == 0 else pair[::-1]


# untimed edges of KI and KJ on phase 8's rows: (tag, pool stride,
# channels, rows: all real ones, none or one, dtype)
BEV_EDGES = (("stride 1", 1, 96, "all", "bfloat16"),
             ("stride 2", 2, 96, "all", "bfloat16"),
             ("stride 5", 5, 96, "all", "bfloat16"),
             ("C 98", 3, 98, "all", "bfloat16"),
             ("C 128", 3, 128, "all", "bfloat16"),
             ("C 256", 3, 256, "all", "bfloat16"),
             ("no row", 3, 96, "none", "bfloat16"),
             ("one row", 3, 96, "one", "bfloat16"),
             ("C 98 f32", 3, 98, "all", "float32"))


def bev_split_ms(fn, calls=5):
    """(fill, scatter, all) device ms a call of fn() under torch.profiler:
    KI's zero fill apart from the rest."""
    _, _, events = profile_device(lambda: [fn() for _ in range(calls)])
    fill = sum(us for k, us, _ in events if "Memset" in k) / 1e3 / calls
    total = sum(us for _, us, _ in events) / 1e3 / calls
    return fill, total - fill, total


def bev_kernel_checks(plan, gen):
    """Phase 8: KI and KJ at the training plan's level 0 (the block8 tap's
    rows), with ReLU-like features (half of them 0: ties at 0): KI equal to
    its plain version, KJ within 1 ulp, each twice bitwise equal, and
    their device ms (KI's fill and scatter apart); then BEV_EDGES,
    untimed."""
    import torch

    from lidog_tpu_torch.ops import bev

    dev = plan.levels[0].coords.device
    l0 = plan.level(0)
    n, c = l0.coords.shape[0], 96
    grid = int(round(2 * BOUND_2D / VOXEL))
    hw = bev.pooled_size(grid, 5, 3, 1)
    geom = (TRAIN_BATCH, grid, hw, 5, 3, 1)
    ck = Checker(gen, dev)
    cells, live = bev.candidates(l0.coords, l0.real, *geom)
    k = cells.shape[0]
    flat_idx = torch.where(live, cells, TRAIN_BATCH * hw * hw).reshape(-1)
    touched = int(torch.unique(cells[live]).numel())
    n_live = int(live.sum())
    src = "lidog_tpu_torch/csrc/bev_scatter_max.cu"
    shape = f"L0 {n} rows {c} -> {TRAIN_BATCH}x{hw}^2"
    for dt in (torch.bfloat16, torch.float32):
        esz = torch.finfo(dt).bits // 8
        feats = torch.relu(ck.feats(n, c, l0.real, dt)).contiguous()
        grid_bytes = TRAIN_BATCH * hw * hw * c * esz
        # one scatter_reduce_ over the K candidates of every row, dead
        # candidates into a spare row (indices and sources made outside
        # the timing)
        lib_src = feats.float().clamp(min=0).to(dt).repeat(k, 1)
        lib_idx = flat_idx[:, None].expand(-1, c)

        def library():
            out = torch.zeros(TRAIN_BATCH * hw * hw + 1, c, dtype=dt,
                              device=dev)
            out.scatter_reduce_(0, lib_idx, lib_src, "amax",
                                include_self=True)
            return out[:-1].view(TRAIN_BATCH, hw, hw, c)

        def ki():
            return bev.bev_scatter_max(feats, l0.coords, l0.real, *geom)

        ck.record("bev_scatter_max", src,
                  "lidog_tpu/ops/bev.py:93 (_pooled_scatter_max; "
                  "bev_scatter_pooled:31)", ki,
                  lambda: bev.bev_scatter_max_plain(feats, l0.coords,
                                                    l0.real, *geom),
                  dt, nbytes(feats, l0.coords, l0.real) + grid_bytes,
                  n_live * c, shape, mma=False, ulps=0, lfn=library)
        fill, scatter, total = bev_split_ms(ki)
        ck.rows[-1].update(device_ms=total, fill_device_ms=fill,
                           scatter_device_ms=scatter)
        print(f"[bev] KI {str(dt)[6:]} device {total:.4f} ms: fill "
              f"{fill:.4f}, scatter {scatter:.4f}", flush=True)
        twice_equal("bev_scatter_max", ki, f"{shape} {str(dt)[6:]}")
        out = bev.bev_scatter_max_plain(feats, l0.coords, l0.real, *geom)
        dout = torch.randn(out.shape, generator=gen).to(dev, dt)

        def kj():
            return bev.bev_scatter_max_bwd(feats, l0.coords, l0.real, out,
                                           dout, *geom)

        ck.record("bev_scatter_max_bwd", src,
                  "lidog_tpu/ops/bev.py:115 (_psm_bwd)", kj,
                  lambda: bev.bev_scatter_max_bwd_plain(
                      feats, l0.coords, l0.real, out, dout, *geom),
                  dt, 2 * nbytes(feats) + nbytes(l0.coords, l0.real)
                  + 2 * touched * c * esz, 2 * n_live * c,
                  f"L0 {n} rows {c} <- {TRAIN_BATCH}x{hw}^2 ({touched} "
                  "cells touched)", mma=False, ulps=1)
        ck.rows[-1]["device_ms"] = bev_split_ms(kj)[2]
        twice_equal("bev_scatter_max_bwd", kj, f"{shape} {str(dt)[6:]}")
        del out, dout, lib_src
    bev_edge_checks(l0, gen)
    return ck.rows


def bev_edge_checks(l0, gen):
    """BEV_EDGES on phase 8's rows: KI's bits equal to the plain version's,
    KJ within 1 ulp of it, each twice bitwise equal."""
    import torch

    from lidog_tpu_torch.ops import bev

    grid = int(round(2 * BOUND_2D / VOXEL))
    n = l0.coords.shape[0]
    for tag, stride, c, rows, dtype in BEV_EDGES:
        dt = getattr(torch, dtype)
        hw = bev.pooled_size(grid, 5, stride, 1)
        geom = (TRAIN_BATCH, grid, hw, 5, stride, 1)
        mask = {"all": l0.real, "none": torch.zeros_like(l0.real),
                "one": torch.zeros_like(l0.real).index_fill_(
                    0, torch.nonzero(l0.real)[:1].flatten(), True)}[rows]
        x = torch.randn(n, c, generator=gen).to(l0.real.device, dt)
        feats = torch.relu(x * mask[:, None].to(x.dtype)).contiguous()
        what = f"{tag}: L0 {n} rows ({int(mask.sum())} live) {c} -> " \
               f"{TRAIN_BATCH}x{hw}^2 {dtype}"

        def ki():
            return bev.bev_scatter_max(feats, l0.coords, mask, *geom)

        out = bev.bev_scatter_max_plain(feats, l0.coords, mask, *geom)
        got = ki()
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), out.view(bits)):
            raise AssertionError(f"bev_scatter_max {what}: "
                                 f"{int((got != out).sum())} elements differ")
        twice_equal("bev_scatter_max", ki, what)
        dout = torch.randn(out.shape, generator=gen).to(out.device, out.dtype)

        def kj():
            return bev.bev_scatter_max_bwd(feats, l0.coords, mask, out, dout,
                                           *geom)

        err = ulp_err(kj(), bev.bev_scatter_max_bwd_plain(
            feats, l0.coords, mask, out, dout, *geom))
        if not err <= 1:
            raise AssertionError(f"bev_scatter_max_bwd {what}: {err} ulp")
        twice_equal("bev_scatter_max_bwd", kj, what)
        print(f"[bev-edge] {what}: KI equal, KJ {err:.3f} ulp", flush=True)
        del out, dout, got, feats


def lidog_batch(dev):
    """bench_lidog.py's batch: 4 synthetic scans through the host BEV
    preprocessing and collation; returns (tensors on dev, voxels
    dropped to capacity)."""
    import torch

    from lidog_tpu_torch.data.bev import collate_bev, preprocess_scan_bev
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset

    ds = SyntheticLidarDataset(num_scans=TRAIN_BATCH, points_per_scan=POINTS,
                               radius=BOUND_2D, seed=SEED)
    samples = [preprocess_scan_bev(
        ds[i]["points"], ds[i]["sem_labels"], decoder_2d_levels=LEVELS,
        voxel_size=VOXEL, bound_2d=BOUND_2D, sub_p=1.0, augmentations=None,
        train=False, bev_img_sizes={lvl: BEV_HEAD for lvl in LEVELS})
        for i in range(TRAIN_BATCH)]
    arrays = collate_bev(samples, TRAIN_CAP_IN, decoder_2d_levels=LEVELS)
    dropped = int(arrays.pop("dropped"))
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}, dropped


def lidog(dev):
    """Phase 9: full-width bf16 LiDOG steps; returns stats."""
    import torch

    from lidog_tpu_torch.losses.losses import DICELoss, SoftDICELoss
    from lidog_tpu_torch.models.minkunet_bev import MinkUNet34BEV
    from lidog_tpu_torch.train.lidog_step import make_lidog_train_step
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState

    t0 = time.perf_counter()
    batch, dropped = lidog_batch(dev)
    prep_s = time.perf_counter() - t0
    model = MinkUNet34BEV(out_channels=NUM_CLASSES, decoder_2d_levels=LEVELS,
                          num_batches=TRAIN_BATCH, voxel_size=VOXEL,
                          bound_2d=BOUND_2D, compute_dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED))
    state = TrainState.create(model, make_optimizer("Adam", lr=1e-3),
                              device=dev)
    builder = train_plan_builder()
    step = make_lidog_train_step(
        SoftDICELoss(ignore_label=-1), DICELoss(ignore_label=-1),
        decoder_levels=LEVELS, num_classes=NUM_CLASSES, warmup_epochs=0,
        steps_per_epoch=1)

    def full_step():
        plan = builder(batch["coords"], batch["mask"])
        _, metrics = step(state, batch, plan)
        torch.cuda.synchronize()
        return plan, metrics

    def losses_of(m):
        return [float(m[k]) for k in ("loss", "sem_loss", "bev_loss")]

    plan, metrics = full_step()  # warm-up (Triton, cuDNN)
    overflow = plan.overflow.cpu().tolist()
    if sum(overflow) != 0:
        raise AssertionError(f"LiDOG plan overflow {overflow}")
    supervised = int(((batch["labels"] >= 0) & batch["mask"]).sum())
    losses = [losses_of(metrics)]
    proj = [float(metrics[f"proj_iou_{lvl}"]) for lvl in LEVELS]
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    ms = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = full_step()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(losses_of(metrics))
        proj += [float(metrics[f"proj_iou_{lvl}"]) for lvl in LEVELS]
        total = int(metrics["confusion"].sum())
        if total != supervised:
            raise AssertionError(f"confusion total {total} != {supervised} "
                                 "supervised voxels")
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[lidog] overflow {overflow} dropped {dropped} supervised "
          f"{supervised} losses (total, sem, bev) {losses} proj_iou {proj} "
          f"step ms {ms}", flush=True)
    if not all(math.isfinite(v) for row in losses for v in row) \
            or not losses[-1][0] < losses[0][0]:
        raise AssertionError(f"LiDOG losses {losses}: not finite or not "
                             "falling")
    if not all(0.0 <= v <= 1.0 for v in proj):
        raise AssertionError(f"proj_iou {proj} outside [0, 1]")
    for k, per in PER_LIDOG_STEP.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in LiDOG "
                                 f"training, expected {per} x {TRAIN_STEPS}")
    stages = lidog_stage_split(state, batch, builder)
    p50 = statistics.median(ms)
    return {"p50_ms": p50, "scans_per_s": TRAIN_BATCH / p50 * 1e3,
            "step_ms": ms, "losses_total_sem_bev": losses, "proj_iou": proj,
            "launches": launches, "stages_ms": stages,
            "supervised_voxels": supervised, "dropped_voxels": dropped,
            "host_preprocess_s": prep_s,
            "real_rows_per_level": [int(l.real.sum()) for l in plan.levels],
            "peak_mem_gb": peak,
            "params": sum(p.numel() for p in model.parameters())}


def lidog_stage_split(state, batch, builder):
    """Device ms of plan / forward+losses / backward / optimizer for one
    LiDOG step (CUDA events between the stages; median of 3)."""
    import torch

    from lidog_tpu_torch.losses.losses import DICELoss, SoftDICELoss
    from lidog_tpu_torch.train.lidog_step import _lidog_forward

    crits = (SoftDICELoss(ignore_label=-1), DICELoss(ignore_label=-1))
    runs = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        plan = builder(batch["coords"], batch["mask"])
        ev[1].record()
        state.optimizer.zero_grad()
        sem, bev, _, _ = _lidog_forward(state.model.train(), batch, *crits,
                                        LEVELS, NUM_CLASSES, plan)
        total = 0.5 * sem + 0.5 * bev
        ev[2].record()
        total.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    names = ("plan", "forward+losses", "backward", "optimizer")
    return {n: statistics.median(r[i] for r in runs)
            for i, n in enumerate(names)}


def bev_cross_check(dev):
    """Phase 10: the BEV head (bev_scatter_pooled -> Encoder2D -> DICE,
    forward and backward) in f32 on one full-grid scan, on the card and on
    the CPU from the same block8-shaped features (ReLU-like, at the scan's
    level-0 rows) and weights.  The CPU reference takes PyTorch's native
    convolution (im2col and a matrix product).  Two floors, on the CPU:
    the same head from the weights scaled by (1 + 1e-7 N(0, 1)), and the
    same head through oneDNN's convolution.  The second is there because a
    convolution library's own summation order moves one grad far more than
    a 1e-7 perturbation does: against a float64 evaluation, the native f32
    weight gradient of the second conv sits at 1.7e-6 (relative L2), and
    oneDNN's at 1.1e-4, as cuDNN's on an H100 does.  The loss within 1e-5
    (relative); each grad (Encoder2D's and the features') and all of them
    together in relative L2 within 10x the larger floor (+ 1e-6)."""
    import torch

    from lidog_tpu_torch.caps import make_zcaps
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.data.bev import collate_bev, preprocess_scan_bev
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset
    from lidog_tpu_torch.losses.losses import DICELoss
    from lidog_tpu_torch.models.conv2d import Encoder2D
    from lidog_tpu_torch.ops.bev import bev_scatter_pooled

    scan0 = SyntheticLidarDataset(num_scans=1, points_per_scan=POINTS,
                                  radius=BOUND_2D, seed=SEED + 5)[0]
    sample = preprocess_scan_bev(scan0["points"], scan0["sem_labels"],
                                 voxel_size=VOXEL, bound_2d=BOUND_2D,
                                 sub_p=1.0, train=False,
                                 bev_img_sizes={"block8": BEV_HEAD})
    caps_r, caps_a, caps_d = make_zcaps(PER_SCAN)
    arrays = collate_bev([sample], caps_r[0])
    coords = torch.from_numpy(arrays["coords"])
    mask = torch.from_numpy(arrays["mask"])
    plan = ZSegPlanBuilder(caps_r, caps_a, num_batches=1, grid_half=GRID_HALF,
                           caps_col_dil=caps_d)(coords, mask)
    if int(plan.overflow.sum()) != 0:
        raise AssertionError(f"BEV check plan overflow {plan.overflow}")
    l0 = plan.level(0)
    gen = torch.Generator().manual_seed(SEED + 6)
    feats = torch.relu(torch.randn(l0.coords.shape[0], 96, generator=gen)) \
        * l0.real[:, None].float()
    labels = torch.from_numpy(arrays["bev_labels_block8"])
    enc = Encoder2D(96, n_classes=NUM_CLASSES,
                    generator=torch.Generator().manual_seed(SEED + 7))
    pert = copy.deepcopy(enc)
    noise = torch.Generator().manual_seed(SEED + 8)
    with torch.no_grad():
        for p in pert.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=noise))
    cpu = torch.device("cpu")
    # (device, model, oneDNN convolutions on the CPU)
    runs = {"cuda": (dev, copy.deepcopy(enc), False),
            "cpu": (cpu, enc, False),
            "floor": (cpu, pert, False),
            "onednn": (cpu, copy.deepcopy(enc), True)}
    out = {}
    for where, (d, model, onednn) in runs.items():
        torch.backends.mkldnn.enabled = onednn
        model = model.to(d).train()
        # a leaf of its own per run: on the CPU, feats.to(d) is feats itself,
        # and a second backward would add into the first run's grad
        f = feats.to(d, copy=True).requires_grad_()
        t0 = time.perf_counter()
        bev = bev_scatter_pooled(l0.coords.to(d), f, l0.real.to(d),
                                 num_batches=1, voxel_size=VOXEL,
                                 bound=BOUND_2D)
        hw = bev.shape[1]
        loss = DICELoss(ignore_label=-1)(model(bev), labels.to(d))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        grads["feats"] = f.grad.detach().cpu().clone()
        out[where] = {"loss": float(loss.detach()), "grads": grads,
                      "s": time.perf_counter() - t0}
    torch.backends.mkldnn.enabled = True

    def compare(a, b):
        num = sum(float(((a["grads"][n] - g) ** 2).sum())
                  for n, g in b["grads"].items())
        den = sum(float((g ** 2).sum()) for g in b["grads"].values())
        per = {n: float((a["grads"][n] - g).norm() / g.norm().clamp(
            min=1e-30)) for n, g in b["grads"].items()}
        return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "grad_l2": (num / den) ** 0.5,
                "grad_l2_worst": max(per.values()),
                "grad_l2_worst_tensor": max(per, key=per.get),
                "grad_l2_per_tensor": per}

    got = compare(out["cuda"], out["cpu"])
    floor = compare(out["floor"], out["cpu"])
    lib = compare(out["onednn"], out["cpu"])
    print(f"[bev-check] card vs CPU, f32, one scan, {int(l0.real.sum())} "
          f"rows -> {hw}^2 -> {BEV_HEAD}^2: {got}; floor (CPU, weights x (1 "
          f"+ 1e-7 N)): {floor}; floor (CPU, oneDNN convs): {lib}; s card "
          f"{out['cuda']['s']:.2f} CPU {out['cpu']['s']:.2f}", flush=True)
    bounds = {"grad_l2": 10 * max(floor["grad_l2"], lib["grad_l2"]) + 1e-6}
    for n in got["grad_l2_per_tensor"]:
        bounds[n] = 10 * max(floor["grad_l2_per_tensor"][n],
                             lib["grad_l2_per_tensor"][n]) + 1e-6
    if not got["loss"] <= 1e-5:
        raise AssertionError(f"BEV cross-check loss: {got['loss']} > 1e-5")
    for k, b in bounds.items():
        v = got[k] if k == "grad_l2" else got["grad_l2_per_tensor"][k]
        if not v <= b:
            raise AssertionError(f"BEV cross-check {k}: {v} > {b}")
    return {"card_vs_cpu": got, "floor": floor, "floor_onednn": lib,
            "loss": out["cpu"]["loss"]}


def generic_batch_plan(dev):
    """The training batch of 4 scans at the generic caps (its input
    capacity GENERIC_CAPS[0]) and its UNetPlan, overflow 0."""
    from lidog_tpu_torch.core.plan import build_unet_plan

    pts, labels = train_data()
    batch = train_batch(pts, labels, dev, cap_in=GENERIC_CAPS[0])
    plan = build_unet_plan(batch["coords"], batch["mask"], GENERIC_CAPS)
    overflow = plan.overflow.cpu().tolist()
    if sum(overflow) != 0:
        raise AssertionError(f"generic training plan overflow {overflow}")
    return batch, plan


def map_hits(nbr, mask):
    """Entries of a [K, N] map that read a row: >= 0, and where a mask is
    given, onto a row it keeps (the work a data-dependent gather does)."""
    hit = nbr >= 0
    if mask is not None:
        hit = hit & mask[nbr.clamp(min=0).long()]
    return int(hit.sum())


def generic_kernel_checks(dev, gen):
    """Phase 20, LA and LB (and the stem's KO / KP): each against its plain
    version at shapes of the generic training plan (phase 22's), in bf16
    and f32: the forward (out_mask the level's mask), dIn over the
    transpose map (W[::-1]^T, or W^T over the partner map; the output mask
    as source mask) and dW; plus LA at P2's shape (27 taps, N 393,216,
    96 -> 96, bf16: benchmarks/micro/micro_gather.py:155-246).  Bounds:
    operations 2 x (map entries that read a row) x Cin x Cout, bytes each
    operand once."""
    import torch

    from lidog_tpu_torch.ops import sparse_conv as sc

    _, plan = generic_batch_plan(dev)
    ck = Checker(gen, dev)
    src = "lidog_tpu_torch/csrc/sparse_conv.cu"
    rep_f = "lidog_tpu/ops/sparse_conv.py:107 _conv_core (_gemm_scan:78)"
    rep_b = "lidog_tpu/ops/sparse_conv.py:121 _conv_core_bwd"
    cases = (("conv3_l0", 0, 0, 32, 32, None), ("conv3_l0", 0, 0, 128, 96, None),
             ("conv3_l3", 3, 3, 512, 256, None),
             ("down_l0", 0, 1, 32, 32, "up_l0"),
             ("up_l0", 1, 0, 96, 96, "down_l0"), ("stem", 0, 0, 1, 32, None))
    for dt in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dt).element_size()
        for name, li, lo, cin, cout, partner in cases:
            nbr = plan.kmaps[name]
            m_in, m_out = plan.level(li).mask, plan.level(lo).mask
            x = ck.feats(m_in.shape[0], cin, m_in, dt)
            w = ck.weights(dt, nbr.shape[0], cin, cout)
            dout = ck.feats(m_out.shape[0], cout, m_out, dt)
            rev = partner is None
            tmap = nbr if rev else plan.kmaps[partner]
            wt = (w.flip(0) if rev else w).transpose(1, 2).contiguous()
            stem = name == "stem"
            k_src = "lidog_tpu_torch/csrc/zconv_full.cu" if stem else src
            shape = (f"{name} {nbr.shape[1]} rows K {nbr.shape[0]} "
                     f"{cin}->{cout}")
            out_b = nbr.shape[1] * cout * es
            hits = map_hits(nbr, None)
            ck.record("zconv_full_fwd" if stem else "sparse_conv_fwd", k_src,
                      rep_f, lambda: sc.sparse_conv_fwd(x, nbr, w, m_out),
                      lambda: sc.sparse_conv_plain(x, nbr, w, m_out), dt,
                      nbytes(x, nbr, w, m_out) + out_b,
                      2 * hits * cin * cout, shape)
            t_hits = map_hits(tmap, m_out)
            if not stem:  # the stem's input takes no grad
                ck.record("sparse_conv_fwd", src, rep_b,
                          lambda: sc.sparse_conv_fwd(dout, tmap, wt, None,
                                                     m_out),
                          lambda: sc.sparse_conv_plain(dout, tmap, wt, None,
                                                       m_out), dt,
                          nbytes(dout, tmap, wt, m_out) + x.numel() * es,
                          2 * t_hits * cin * cout, "dIn " + shape)
            def kfn():
                return sc.sparse_conv_wgrad(x, dout, tmap, m_out,
                                            reverse=rev)

            ck.record("zconv_full_wgrad" if stem else "sparse_conv_wgrad",
                      k_src, rep_b, kfn,
                      lambda: sc.sparse_conv_wgrad_plain(x, dout, tmap, m_out,
                                                         reverse=rev), dt,
                      nbytes(x, dout, tmap, m_out) + w.numel() * 4,
                      2 * t_hits * cin * cout, "dW " + shape)
            twice_equal("zconv_full_wgrad" if stem else "sparse_conv_wgrad",
                        kfn, "dW " + shape)
    # P2's shape: 27 taps over 393,216 output rows, 96 -> 96, bf16
    dt = torch.bfloat16
    m0 = plan.level(0).mask
    nbr = plan.kmaps["conv3_l0"][:, :393_216].contiguous()
    mo = m0[:393_216].contiguous()
    x = ck.feats(m0.shape[0], 96, m0, dt)
    w = ck.weights(dt, 27, 96, 96)
    ck.record("sparse_conv_fwd", src,
              "benchmarks/micro/micro_gather.py:246 q3_windowed_vs_xla (P2; "
              "P3 micro_gather2.py:93,198)",
              lambda: sc.sparse_conv_fwd(x, nbr, w, mo),
              lambda: sc.sparse_conv_plain(x, nbr, w, mo), dt,
              nbytes(x, nbr, w, mo) + 393_216 * 96 * 2,
              2 * map_hits(nbr, None) * 96 * 96,
              "P2 conv3_l0 393216 rows K 27 96->96")
    return ck.rows


def pipeline_kernel_checks(dev, gen):
    """Phase 20, LC and LD against their plain versions, torch.equal on
    every output: the voxelizer on phase 4's scan (1 x 100,000 points at
    the serving capacity), on the training batch (4 x 100,000 points at
    the training capacity) and on the same batch at a capacity below its
    voxel count (overflow > 0), with every 7th point invalid, and with
    cells at the ends of the 13-bit range; a valid point at batch id B
    sets batch_breach (the batch-size contract); voxelize_device without a
    batch size on 2 scans equal to the CPU's; the label gather on phase
    4's scan, sorted (plan.pos, then the voxelizer's inverse map) and
    sortless (plan.pos per point), with seeded bf16 logits."""
    import numpy as np
    import torch

    from lidog_tpu_torch.core import keys
    from lidog_tpu_torch.core.voxelize import (quantize, voxelize_cells,
                                               voxelize_device, voxelize_plain)
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.ops.labels import label_gather, labels_plain
    from lidog_tpu_torch.serve import Predictor

    ck = Checker(gen, dev)
    src = "lidog_tpu_torch/csrc/voxelize.cu"
    rep = "lidog_tpu/core/voxelize.py:81 voxelize_device"
    tpts, _ = train_data()
    single = scan(POINTS, SEED)[0]

    def cells(pts, b):
        flat = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        return (quantize(flat, VOXEL),
                torch.ones(flat.shape[0], dtype=torch.bool, device=dev),
                torch.arange(b, dtype=torch.int32, device=dev)
                .repeat_interleave(flat.shape[0] // b))

    serve_cells = cells(single, 1)
    train_cells = cells(tpts.reshape(-1, 3), TRAIN_BATCH)
    # every 7th point invalid; then also cells at and beyond the ends of
    # the 13-bit range (-4096, 4095 kept; -4097, 4096 invalid) on every
    # 5th point
    invalid = [t.clone() for t in train_cells]
    invalid[1][::7] = False
    edge = [t.clone() for t in invalid]
    ends = torch.tensor([-4096, 4095, -4097, 4096], dtype=torch.int32,
                        device=dev)
    for a in range(3):
        n_a = edge[0][a::5, a].shape[0]
        edge[0][a::5, a] = ends[torch.arange(n_a, device=dev) % 4]
    cases = (("serve 1 x 100000 points", serve_cells, 1, PER_SCAN),
             ("train 4 x 100000 points", train_cells, TRAIN_BATCH,
              TRAIN_CAP_IN),
             ("train 4 x 100000 points, overflow", train_cells, TRAIN_BATCH,
              TRAIN_CAP_IN // 2),
             ("train 4 x 100000 points, every 7th invalid", invalid,
              TRAIN_BATCH, TRAIN_CAP_IN),
             ("train 4 x 100000 points, cells at +-4096, every 7th invalid",
              edge, TRAIN_BATCH, TRAIN_CAP_IN))
    for shape, (disc, valid, bidx), b, cap in cases:
        want = voxelize_plain(disc, valid, bidx, cap)
        if "overflow" in shape and not int(want.overflow) > 0:
            raise AssertionError(f"voxelizer check {shape}: no overflow")
        ck.record("voxelize", src, rep,
                  lambda: voxelize_cells(disc, valid, bidx, cap,
                                         batch_size=b),
                  lambda: voxelize_plain(disc, valid, bidx, cap),
                  torch.int32, nbytes(disc, valid, bidx, *want), 0,
                  f"{shape} cap {cap} ({int(want.num_voxels)} voxels)",
                  mma=False, exact=True)
        # the library call: torch.unique over the packed keys (the sorted
        # voxels and each point's voxel; it syncs to the host for its
        # output size)
        packed = keys.combined(*keys.pack(
            torch.cat([bidx[:, None], disc], dim=1), valid))
        uniq, _ = torch.unique(packed, sorted=True, return_inverse=True)
        if int(((uniq >> 31) != keys.INVALID_KEY).sum()) \
                != int(want.num_voxels):
            raise AssertionError(f"torch.unique: {uniq.numel()} voxels, "
                                 f"LC's plain version {int(want.num_voxels)}")
        ck.rows[-1]["library_ms"] = cuda_ms(lambda: torch.unique(
            packed, sorted=True, return_inverse=True))
        print(f"[kernel] voxelize {shape}: library (torch.unique) "
              f"{ck.rows[-1]['library_ms']:.4f} ms", flush=True)
    # the batch-size contract: a valid point at batch id B sets batch_breach
    # on the card (the CPU raises); overflow keeps lidog_tpu's meaning
    broken = [t.clone() for t in train_cells]
    broken[2][-1] = TRAIN_BATCH
    got = voxelize_cells(*broken, TRAIN_CAP_IN, batch_size=TRAIN_BATCH)
    if int(got.batch_breach) != 1 or int(got.overflow) != max(
            int(got.num_voxels) - TRAIN_CAP_IN, 0):
        raise AssertionError(f"voxelizer: a valid point at batch id "
                             f"{TRAIN_BATCH} gave batch_breach "
                             f"{int(got.batch_breach)}, overflow "
                             f"{int(got.overflow)}")
    print("[kernel] voxelize: a batch id at batch_size sets batch_breach",
          flush=True)
    # voxelize_device called as lidog_tpu's, without a batch size (the card
    # takes B = MAX_BATCH, 7 passes), on a batch of 2 at a roomy capacity
    # and at one that overflows: equal to the CPU's, which the CPU tests
    # hold to lidog_tpu's
    two = tpts[:2].reshape(-1, 3)
    for cap in (2 * PER_SCAN, PER_SCAN // 2):
        outs = []
        for d in (dev, torch.device("cpu")):
            flat = torch.from_numpy(np.ascontiguousarray(two)).to(d)
            outs.append(voxelize_device(
                flat, torch.ones(flat.shape[0], dtype=torch.bool, device=d),
                torch.arange(2, dtype=torch.int32, device=d)
                .repeat_interleave(flat.shape[0] // 2), VOXEL, cap))
        for f, a, b in zip(outs[1]._fields, *outs):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"voxelize_device without batch_size, "
                                     f"cap {cap}: {f} differs card vs CPU")
        if int(outs[0].batch_breach) != 0 or (cap < 2 * PER_SCAN) != (
                int(outs[0].overflow) > 0):
            raise AssertionError(f"voxelize_device without batch_size, cap "
                                 f"{cap}: overflow {int(outs[0].overflow)}, "
                                 f"batch_breach {int(outs[0].batch_breach)}")
    print("[kernel] voxelize_device without batch_size on a batch of 2: "
          "equal to the CPU's", flush=True)
    model = MinkUNet34(out_channels=NUM_CLASSES, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED))
    kw = dict(batch_size=1, voxel_size=VOXEL, caps_per_scan=PER_SCAN,
              grid_half=GRID_HALF, device=dev)
    pts_dev = torch.from_numpy(scan(POINTS, SEED)).to(dev)
    for sortless in (False, True):
        vox, plan, logits = Predictor(model, sortless=sortless,
                                      **kw).forward_voxels(pts_dev)
        logits = torch.randn(logits.shape, generator=gen).to(dev, logits.dtype)
        real, pos = plan.level(0).real, plan.pos
        inv = None if vox is None else vox.inverse
        n_out = pos.shape[0] if inv is None else inv.shape[0]
        labelled = map_hits(pos[None], real)
        ck.record("label_gather", "lidog_tpu_torch/csrc/label_gather.cu",
                  "lidog_tpu/serve.py:92-105 (argmax + pos/inverse gathers)",
                  lambda: label_gather(logits, real, pos, inv),
                  lambda: labels_plain(logits, real, pos, inv), torch.int32,
                  nbytes(pos, *([] if inv is None else [inv]))
                  + labelled * (logits.shape[1] * 2 + 1) + n_out * 4, 0,
                  f"{'sortless' if sortless else 'sorted'} {n_out} points",
                  mma=False, exact=True)
    return ck.rows


def generic_plan_checks(model, dev):
    """Phase 21: (1) build_unet_plan on the card and on the CPU bitwise
    equal (levels, perm, every kmap, overflow) on the voxels of the
    20,000-point check scan at make_caps(1, 98,304); (2) phase 4's
    MinkUNet34 weights in f32 on phase 4's scan: the forward on the
    generic UNetPlan at make_caps(1) (LA throughout, the stem KO) against
    the forward on the ZPlan, row by row aligned by coordinate, within
    rtol = atol = 2e-3 (tests/test_zseg_model.py:51-73), and zero on the
    padding rows."""
    import torch

    from lidog_tpu_torch.caps import make_caps
    from lidog_tpu_torch.core import keys
    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.core.plan import build_unet_plan
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor

    caps = make_caps(1, PER_SCAN)
    kw = dict(batch_size=1, voxel_size=VOXEL, caps_per_scan=PER_SCAN,
              grid_half=GRID_HALF)
    flat = torch.from_numpy(scan(CHECK_POINTS, SEED + 1)[0])
    plans = []
    for d in (dev, torch.device("cpu")):
        vox = voxelize_device(
            flat.to(d), torch.ones(CHECK_POINTS, dtype=torch.bool, device=d),
            torch.zeros(CHECK_POINTS, dtype=torch.int32, device=d), VOXEL,
            PER_SCAN, batch_size=1)
        plans.append(build_unet_plan(vox.coords, vox.mask, caps))
    gp, cp = plans
    for i, (a, b) in enumerate(zip(gp.levels, cp.levels)):
        for f in ("coords", "mask", "hi", "lo"):
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f)):
                raise AssertionError(f"card vs CPU UNetPlan: level {i} {f}")
    if sorted(gp.kmaps) != sorted(cp.kmaps):
        raise AssertionError("card vs CPU UNetPlan: kmap names differ")
    for k in cp.kmaps:
        if not torch.equal(gp.kmaps[k].cpu(), cp.kmaps[k]):
            raise AssertionError(f"card vs CPU UNetPlan: kmap {k} differs")
    for f in ("perm", "overflow"):
        if not torch.equal(getattr(gp, f).cpu(), getattr(cp, f)):
            raise AssertionError(f"card vs CPU UNetPlan: {f} differs")
    if int(cp.overflow.sum()):
        raise AssertionError(f"check UNetPlan overflow {cp.overflow}")
    print(f"[generic] {CHECK_POINTS} points: UNetPlan card == CPU bitwise "
          f"({len(cp.kmaps)} maps, {int(cp.level(0).mask.sum())} voxels)",
          flush=True)
    del plans, gp, cp

    f32 = MinkUNet34(out_channels=NUM_CLASSES, compute_dtype=torch.float32)
    f32.load_state_dict(model.state_dict())
    pred = Predictor(f32, device=dev, **kw)
    # the UNetPlan at lidog_tpu's default pooled caps of one scan,
    # make_caps(1): its 80,044 voxels overflow make_caps(1, 98,304)'s level
    # 1; the voxels padded to its 131,072 input rows
    ucaps = make_caps(1)
    with torch.no_grad():
        vox, zplan, lz = pred.forward_voxels(
            torch.from_numpy(scan(POINTS, SEED)).to(dev))
        coords = torch.zeros(ucaps[0], 4, dtype=torch.int32, device=dev)
        mask = torch.zeros(ucaps[0], dtype=torch.bool, device=dev)
        coords[:PER_SCAN], mask[:PER_SCAN] = vox.coords, vox.mask
        uplan = build_unet_plan(coords, mask, ucaps)
        lu = pred.model(input_tensor(uplan, mask[:, None].float()), uplan)
    if int(zplan.overflow.sum()) or int(uplan.overflow.sum()):
        raise AssertionError(f"phase 21 overflow: ZPlan {zplan.overflow}, "
                             f"UNetPlan {uplan.overflow}")
    zl, ul = zplan.level(0), uplan.level(0)
    uk = keys.combined(ul.hi, ul.lo)  # sorted; padding rows last
    zk = keys.combined(*keys.pack(zl.coords, zl.real))[zl.real]
    row = torch.searchsorted(uk, zk)
    n_u = int(ul.mask.sum())
    if n_u != zk.numel() or not torch.equal(uk[row], zk):
        raise AssertionError(f"generic vs ZPlan voxels: {n_u} vs "
                             f"{zk.numel()}")
    a, b = lu[row], lz[zl.real]
    err = float(((a - b).abs() - 2e-3 * b.abs()).max())
    print(f"[generic] f32 forward UNetPlan vs ZPlan on {n_u} voxels: max "
          f"|diff| {float((a - b).abs().max()):.3e}, max |logit| "
          f"{float(b.abs().max()):.3e}, excess over rtol=atol=2e-3 {err:.3e}",
          flush=True)
    if not err <= 2e-3 or bool((lu[~ul.mask] != 0).any()):
        raise AssertionError(f"generic vs ZPlan forward: excess {err}")
    return {"voxels": n_u, "max_abs_diff": float((a - b).abs().max()),
            "max_abs_logit": float(b.abs().max())}


def profile_device(fn):
    """(device ms, kernel launches, [(kernel, device us, launches)] by
    device time) of fn() under torch.profiler."""
    import torch

    from lidog_tpu_torch.profile_serve import kernel_events

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = kernel_events(prof)
    return (sum(us for _, us, _ in events) / 1e3,
            sum(n for _, _, n in events), events)


def generic_train(dev):
    """Phase 22: full-width bf16 training of MinkUNet34 on the generic
    plan (bench.py's batch, GENERIC_CAPS; SoftDICE + Adam 1e-3): the
    ZPlan step and the generic step (no plan given: the step builds the
    batch's UNetPlan) from the same seeded weights, GENERIC_WARMUP
    warm-up steps each, then TRAIN_STEPS of each in turns (the generic
    counters = launches x steps); finite losses, the last below the first,
    confusion totals equal to the supervised voxels; one generic eval
    step; the plan build's device ms and launches alone (profiler)."""
    import torch

    from lidog_tpu_torch.core.plan import build_unet_plan
    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState, make_eval_step

    pts, labels = train_data()
    batch, plan = generic_batch_plan(dev)
    supervised = int(((batch["labels"] >= 0) & batch["mask"]).sum())
    real_rows = [int(l.mask.sum()) for l in plan.levels]
    # the plan build's bytes: its input read once, every tensor of the
    # plan written once
    plan_bytes = nbytes(batch["coords"], batch["mask"], plan.perm,
                        plan.overflow, *plan.kmaps.values(),
                        *[getattr(lv, f) for lv in plan.levels
                          for f in ("coords", "mask", "hi", "lo")])
    del plan
    builder = train_plan_builder()
    steps = {"zplan": variant_step("source"), "generic": variant_step(
        "generic")}
    states = {k: TrainState.create(
        variant_model("source", torch.bfloat16,
                      torch.Generator().manual_seed(SEED)),
        make_optimizer("Adam", lr=1e-3), device=dev) for k in steps}

    def run_step(kind):
        if kind == "generic":
            b = train_batch(pts, labels, dev, cap_in=GENERIC_CAPS[0])
            _, metrics = steps[kind](states[kind], b)
        else:
            b = train_batch(pts, labels, dev)
            _, metrics = steps[kind](states[kind], b,
                                     builder(b["coords"], b["mask"]))
        return metrics

    losses = {"zplan": [], "generic": []}
    for kind in ("zplan", *["generic"] * GENERIC_WARMUP):
        losses[kind].append(float(run_step(kind)["loss"]))
    torch.cuda.synchronize()
    ms = {"zplan": [], "generic": []}
    launches = dict.fromkeys(counters(), 0)
    peak = 0.0
    for i in range(TRAIN_STEPS):
        for kind in in_turns(("zplan", "generic"), i):
            zero_counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run_step(kind)
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            losses[kind].append(float(metrics["loss"]))
            total = int(metrics["confusion"].sum())
            if kind == "generic":
                peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
                for k, v in counters().items():
                    launches[k] += v
                if total != supervised:
                    raise AssertionError(f"generic confusion total {total} "
                                         f"!= {supervised} supervised voxels")
    print(f"[generic] losses {losses} step ms {ms}", flush=True)
    for kind, seq in losses.items():
        if not all(math.isfinite(v) for v in seq) or not seq[-1] < seq[0]:
            raise AssertionError(f"{kind} losses {seq}: not finite or not "
                                 "falling")
    for k, per in PER_GENERIC_STEP.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in generic "
                                 f"training, expected {per} x {TRAIN_STEPS}")
    ev = make_eval_step(SoftDICELoss(ignore_label=-1), NUM_CLASSES,
                        caps=GENERIC_CAPS)(states["generic"], batch)
    evals = {"eval_loss": float(ev["loss"]),
             "eval_confusion_total": int(ev["confusion"].sum())}
    print(f"[generic] eval step: {evals}", flush=True)
    if not math.isfinite(evals["eval_loss"]) \
            or evals["eval_confusion_total"] != supervised:
        raise AssertionError(f"generic eval step {evals}")
    plan_ms, plan_launches, top = profile_device(lambda: build_unet_plan(
        batch["coords"], batch["mask"], GENERIC_CAPS))
    print(f"[generic] build_unet_plan alone: {plan_ms:.3f} ms device in "
          f"{plan_launches} launches (plain torch; byte bound "
          f"{plan_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); top kernels "
          f"{[(name[:60], round(us / 1e3, 3), n) for name, us, n in top[:6]]}",
          flush=True)
    p50 = {k: statistics.median(v) for k, v in ms.items()}
    return {"p50_ms": p50["generic"], "zplan_p50_ms": p50["zplan"],
            "scans_per_s": TRAIN_BATCH / p50["generic"] * 1e3,
            "step_ms": ms, "losses": losses, **evals, "launches": launches,
            "supervised_voxels": supervised, "real_rows_per_level": real_rows,
            "plan_build_device_ms": plan_ms,
            "plan_build_launches": plan_launches,
            "plan_build_bound_ms": plan_bytes / HBM_BYTES_PER_S * 1e3,
            "peak_mem_gb": peak}


def probes(dev):
    """Phase 23: the three probe mains on the card at the JAX scripts'
    shapes; raises unless every check is true; returns their numbers and
    the kernels' launches in the run."""
    from lidog_tpu_torch.probes import (micro_bisect, micro_gather,
                                        micro_lanegather)

    zero_counters()
    t0 = time.perf_counter()
    out = {"gather": micro_gather.main(dev), "bisect": micro_bisect.main(dev),
           "lanegather": micro_lanegather.main(dev)}
    launches = counters()
    failed = [f"{p}: {k}" for p, r in out.items()
              for k, ok in r["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"probe checks failed: {failed}")
    return {**out, "s": time.perf_counter() - t0, "launches": launches}


def probe_kernel_checks(dev, gen):
    """Phase 23, LE-LH against their plain versions, torch.equal: LE at
    P1's window (2048 x 96, 512 rows; f32 and bf16) and P4's sublane
    cases (W 256, 1024, 4096 at 128 columns, T = W); LF at P1's
    transposed window (f32 and bf16) and P4's lane cases (W 256, 2048);
    LE and LF at the edge shapes of the CPU test (WINDOW_EDGES: indices
    of -1 and >= W, T no multiple of 32, 16-byte and wide LE rows, LF
    channels no multiple of its block, bf16 at an odd T); LG at t1's
    shape (65,536 x 96, tiles of 512 at min(512 t, N - 2048); bf16 and
    f32); LH at P5's (96 x 8192, 64 chunks).  Library calls:
    index_select (LE, LG with the prebuilt row index), gather (LF); at
    LE's and LF's probe shapes also the device ms of kernel and library
    call (torch.profiler), warm and with the L2 cache flushed before each
    call.  Bounds: the bytes the function must move on this run's data:
    the distinct window rows (LE, LG) or elements (LF, LH) that the index
    names inside the window, read once, the index once and the output
    once."""
    import torch

    from lidog_tpu_torch.ops import gather as g
    from lidog_tpu_torch.probes.common import flushed_device_ms, timed

    ck = Checker(gen, dev)
    src = "lidog_tpu_torch/csrc/window_gather.cu"
    f32, bf = torch.float32, torch.bfloat16

    def rand(shape, dt):
        return torch.randn(*shape, generator=gen).to(dev, dt)

    def index(low, high, n):
        return torch.randint(low, high, (n,), generator=gen,
                             dtype=torch.int32).to(dev)

    def distinct(t):
        return int(torch.unique(t).numel())

    def hits(idx, w):
        return distinct(idx[(idx >= 0) & (idx < w)])

    def gather_row(name, replaces, kfn, pfn, lfn, dt, nbyte, shape):
        ck.record(name, src, replaces, kfn, pfn, dt, nbyte, 0, shape,
                  mma=False, exact=True, lfn=lfn)
        if lfn is None:
            return
        row = ck.rows[-1]
        for key, fn in (("", kfn), ("library_", lfn)):
            # None where the profiler lost the kernels (NaN from the timers)
            for k, v in ((f"{key}device_ms", timed(fn, dev, 50)[1]),
                         (f"{key}flushed_device_ms",
                          flushed_device_ms(fn, dev, 50))):
                row[k] = None if math.isnan(v) else v
        print(f"[kernel] {name} {row['shape']}: device {row['device_ms']}"
              f" ms (L2 flushed {row['flushed_device_ms']}), library "
              f"{row['library_device_ms']} (L2 flushed "
              f"{row['library_flushed_device_ms']})", flush=True)

    p1 = ("benchmarks/micro/micro_gather.py:83,110 q2_pallas_vmem_gather:71 "
          "(P1 a, b); micro_bisect.py:73 gather_case:54 (P4 sublane)")
    dts = {"f32": f32, "bf16": bf}
    edges = [(k, a, b, t, dts[d], lo, hi, f"edge {name}")
             for name, (k, a, b, t, d, lo, hi) in WINDOW_EDGES.items()]
    for _, w, c, t, dt, lo, hi, case in [
            ("row", 2048, 96, 512, f32, 0, 2048, "P1"),
            ("row", 2048, 96, 512, bf, 0, 2048, "P1"),
            ("row", 256, 128, 256, f32, 0, 256, "t2"),
            ("row", 1024, 128, 1024, f32, 0, 1024, "t3a"),
            ("row", 4096, 128, 4096, f32, 0, 4096, "t3b")] + [
                e for e in edges if e[0] == "row"]:
        win, idx = rand((w, c), dt), index(lo, hi, t)
        i64 = idx.long()
        gather_row("window_row_gather", p1,
                   lambda: g.window_row_gather(win, idx),
                   lambda: g.window_row_gather_plain(win, idx),
                   None if lo < 0 or hi > w else
                   (lambda: torch.index_select(win, 0, i64)), dt,
                   (hits(idx, w) + t) * c * win.element_size()
                   + nbytes(idx), f"{case} win [{w}, {c}] {t} rows")
    p1c = ("benchmarks/micro/micro_gather.py:135 q2_pallas_vmem_gather:71 "
           "(P1 c); micro_bisect.py:87 gather_case:54 (P4 lane)")
    for _, c, w, t, dt, lo, hi, case in [
            ("lane", 96, 2048, 512, f32, 0, 2048, "P1"),
            ("lane", 96, 2048, 512, bf, 0, 2048, "P1"),
            ("lane", 128, 256, 256, f32, 0, 256, "t4"),
            ("lane", 128, 2048, 2048, f32, 0, 2048, "t4b")] + [
                e for e in edges if e[0] == "lane"]:
        win, idx = rand((c, w), dt), index(lo, hi, t)
        i64 = idx.long()[None].expand(c, -1)
        gather_row("window_lane_gather", p1c,
                   lambda: g.window_lane_gather(win, idx),
                   lambda: g.window_lane_gather_plain(win, idx),
                   None if lo < 0 or hi > w else
                   (lambda: torch.gather(win, 1, i64)), dt,
                   c * (hits(idx, w) + t) * win.element_size()
                   + nbytes(idx), f"{case} win [{c}, {w}] {t} lanes")
    n, c, tile, wn = 65_536, 96, 512, 2048
    ws = torch.clamp(torch.arange(n // tile, dtype=torch.int32) * tile,
                     max=n - wn).to(dev)
    rows = g.window_rows(ws, tile)
    read = distinct(rows[(rows >= 0) & (rows < n)])
    for dt in (bf, f32):
        feats = rand((n, c), dt)
        ck.record("window_copy", "lidog_tpu_torch/csrc/window_copy.cu",
                  "benchmarks/micro/micro_bisect.py:46 t1_dma:23 (P4)",
                  lambda: g.window_copy(feats, ws, tile),
                  lambda: g.window_copy_plain(feats, ws, tile), dt,
                  (read + rows.numel()) * c * feats.element_size()
                  + nbytes(ws),
                  0, f"t1 feats [{n}, {c}] tiles of {tile}, window {wn}",
                  mma=False, exact=True,
                  lfn=lambda: torch.index_select(feats, 0, rows))
    c, reps = 96, 64
    win = rand((c, 128 * reps), f32)
    idx = torch.randint(0, 128, (c, 128 * reps), generator=gen,
                        dtype=torch.int32).to(dev)
    # the window elements the index names: chunk base + lane
    chunk = torch.arange(c * 128 * reps, device=dev).view(c, -1) // 128
    read = distinct(chunk * 128 + idx)
    ck.record("lane_gather_sum", src,
              "benchmarks/micro_lanegather.py:48 main:29 (P5)",
              lambda: g.lane_gather_sum(win, idx),
              lambda: g.lane_gather_sum_plain(win, idx), f32,
              (read + c * 128) * 4 + nbytes(idx), 0,
              f"P5 win [{c}, {128 * reps}] {reps} chunks", mma=False,
              exact=True)
    return ck.rows


def stream_check(dev):
    """Phase 23: a port kernel launched inside `with torch.cuda.stream(s)`
    runs on s.  LF runs once on the default stream (a cached stream would
    keep that one), then on s behind ~0.1 s of spinning and a rewrite of
    its window: on s it reads the rewritten window, on any other stream
    the old one.  Raises unless s was still busy when the host had
    enqueued all of it and LF's output is the rewritten window's."""
    import torch

    from lidog_tpu_torch.ops import gather as g

    win = torch.zeros(96, 2048, device=dev)
    idx = torch.arange(0, 2048, 4, dtype=torch.int32, device=dev)
    g.window_lane_gather(win, idx)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)
        win.fill_(1.0)
        out = g.window_lane_gather(win, idx)
    pending = not s.query()
    torch.cuda.synchronize()
    ones = int((out == 1).sum())
    print(f"[stream] LF inside torch.cuda.stream(s): s busy after the "
          f"launch {pending}, {ones} of {out.numel()} outputs read the "
          "window rewritten on s", flush=True)
    if not pending or ones != out.numel():
        raise AssertionError("a port kernel launched inside "
                             "torch.cuda.stream(s) did not run on s")
    return {"pending_after_launch": pending, "outputs_from_s": ones}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "lidog_tpu_torch")):
        print("chip_smoke: lidog_tpu_torch package not found beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.ops import _cuda
    from lidog_tpu_torch.serve import Predictor

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")

    build_s = _cuda.build()
    import triton  # noqa: F401  (KM/KN's compiler)

    print(f"[build] nvcc x{len(_cuda.SOURCES)} in parallel: {build_s:.1f} s",
          flush=True)
    for name in _cuda.SOURCES:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas] {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    model = MinkUNet34(out_channels=NUM_CLASSES,
                       compute_dtype=torch.bfloat16, generator=gen)
    pts = scan(POINTS, SEED)

    # phase 3 inputs: the full-width plan of the same scan (no forward yet)
    probe = Predictor(model, batch_size=1, voxel_size=VOXEL,
                      caps_per_scan=PER_SCAN, grid_half=GRID_HALF, device=dev)
    flat = torch.from_numpy(pts[0]).to(dev)
    vox = voxelize_device(flat, torch.ones(POINTS, dtype=torch.bool,
                                           device=dev),
                          torch.zeros(POINTS, dtype=torch.int32, device=dev),
                          VOXEL, probe.cap_in, batch_size=1)
    plan = probe.builder(vox.coords, vox.mask)
    rows = kernel_checks(plan, torch.Generator().manual_seed(SEED + 7))
    del probe, vox, plan
    # phase 3, backward kernels: the training plan of 4 scans
    tpts, tlabels = train_data()
    tbatch = train_batch(tpts, tlabels, dev)
    tplan = train_plan_builder()(tbatch["coords"], tbatch["mask"])
    rows += backward_kernel_checks(tplan,
                                   torch.Generator().manual_seed(SEED + 8))
    rows += bev_kernel_checks(tplan, torch.Generator().manual_seed(SEED + 9))
    rows += variant_kernel_checks(tplan,
                                  torch.Generator().manual_seed(SEED + 10))
    del tbatch, tplan
    torch.cuda.empty_cache()
    rows += stem_kernel_checks(dev, torch.Generator().manual_seed(SEED + 11))
    torch.cuda.empty_cache()
    rows += plan_kernel_checks(dev)
    torch.cuda.empty_cache()
    rows += table_kernel_checks(dev)
    torch.cuda.empty_cache()
    # phase 20: the generic sparse conv LA/LB, the voxelizer LC and the
    # label gather LD against their plain versions
    rows += generic_kernel_checks(dev, torch.Generator().manual_seed(SEED + 12))
    torch.cuda.empty_cache()
    rows += pipeline_kernel_checks(dev,
                                   torch.Generator().manual_seed(SEED + 13))
    torch.cuda.empty_cache()

    zero_counters()
    stats = serve(model, pts, dev)
    print(f"[serve] p50 {stats['p50_ms']:.3f} ms per 100k-point request on "
          f"{card}; stages {stats['stages_ms']}", flush=True)
    agree = cross_check(model, dev)
    gplan_check = generic_plan_checks(model, dev)  # phase 21
    del model
    torch.cuda.empty_cache()

    def train_path(variant):
        zero_counters()
        st = train(dev, variant)
        print(f"[{variant}] p50 {st['p50_ms']:.3f} ms per step of "
              f"{TRAIN_BATCH} x {POINTS} points ({st['scans_per_s']:.3f} "
              f"scans/s), peak {st['peak_mem_gb']:.2f} GB on {card}; stages "
              f"{st['stages_ms']}", flush=True)
        torch.cuda.empty_cache()
        return st

    tstats = train_path("source")
    tcheck = train_cross_check(dev)
    torch.cuda.empty_cache()

    zero_counters()
    lstats = lidog(dev)
    print(f"[lidog] p50 {lstats['p50_ms']:.3f} ms per step of "
          f"{TRAIN_BATCH} x {POINTS} points ({lstats['scans_per_s']:.3f} "
          f"scans/s), peak {lstats['peak_mem_gb']:.2f} GB on {card}; stages "
          f"{lstats['stages_ms']}", flush=True)
    torch.cuda.empty_cache()
    bcheck = bev_cross_check(dev)

    rstats = train_path("robustnet")
    istats = train_path("ibn")
    rcheck = train_cross_check(dev, "robustnet")

    cstats = train_path("cin4")
    ccheck = train_cross_check(dev, "cin4")
    torch.cuda.empty_cache()
    sstats = sortless(dev)
    print(f"[sortless] p50 {sstats['serve_p50_ms']:.3f} ms per 100k-point "
          f"request (sorted in turns: {sstats['serve_sorted_p50_ms']:.3f}), "
          f"{sstats['p50_ms']:.3f} ms per step of {TRAIN_BATCH} x {POINTS} "
          f"points ({sstats['scans_per_s']:.3f} scans/s; sorted in turns: "
          f"{sstats['sorted_p50_ms']:.3f} ms), peak "
          f"{sstats['peak_mem_gb']:.2f} GB on {card}", flush=True)
    torch.cuda.empty_cache()
    zero_counters()
    gstats = generic_train(dev)  # phase 22
    print(f"[generic] p50 {gstats['p50_ms']:.3f} ms per step of "
          f"{TRAIN_BATCH} x {POINTS} points ({gstats['scans_per_s']:.3f} "
          f"scans/s; the ZPlan step in turns: {gstats['zplan_p50_ms']:.3f} "
          f"ms), peak {gstats['peak_mem_gb']:.2f} GB on {card}", flush=True)
    torch.cuda.empty_cache()
    gcheck = train_cross_check(dev, "generic")
    torch.cuda.empty_cache()
    pstats = probes(dev)  # phase 23
    print(f"[probes] all checks true in {pstats['s']:.1f} s on {card}; "
          f"launches {pstats['launches']}", flush=True)
    torch.cuda.empty_cache()
    rows += probe_kernel_checks(dev, torch.Generator().manual_seed(SEED + 14))
    pstats["stream_check"] = stream_check(dev)

    by_path = {"serve": stats["launches"], "train": tstats["launches"],
               "lidog": lstats["launches"], "robustnet": rstats["launches"],
               "ibn": istats["launches"], "cin4": cstats["launches"],
               "sortless_serve": sstats["serve_launches"],
               "sortless": sstats["launches"], "generic": gstats["launches"],
               "probes": pstats["launches"]}
    for path, names in (("serve", PER_REQUEST),
                        ("train", PER_VARIANT_STEP["source"]),
                        ("lidog", PER_LIDOG_STEP),
                        ("robustnet", PER_VARIANT_STEP["robustnet"]),
                        ("ibn", PER_VARIANT_STEP["ibn"]),
                        ("cin4", PER_VARIANT_STEP["cin4"]),
                        ("sortless_serve", PER_SORTLESS_REQUEST),
                        ("sortless", PER_STEP),
                        ("generic", PER_GENERIC_STEP),
                        ("probes", PROBE_KERNELS)):
        for k in names:  # every kernel of the path ran in the path's run
            if by_path[path][k] <= 0:
                raise AssertionError(f"{k} never launched on the {path} path")
    for r in rows:
        r["launches"] = sum(by_path[p].get(r["name"], 0) for p in by_path)
        r["launches_by_path"] = {p: by_path[p].get(r["name"], 0)
                                 for p in by_path}
        if r["name"] in LEVEL_KERNELS:  # KU and KX: that level's launches
            key = f"{r['name']}@L{r['level']}"
            r["level_launches"] = sum(by_path[p].get(key, 0) for p in by_path)

    summary = {"card": card, "build_s": build_s,
               "total_s": time.perf_counter() - t_start,
               "serve": stats, "label_agreement_vs_cpu": agree,
               "train": tstats, "train_check_vs_cpu": tcheck,
               "lidog": lstats, "bev_check_vs_cpu": bcheck,
               "robustnet": rstats, "ibn": istats,
               "robustnet_check_vs_cpu": rcheck, "cin4": cstats,
               "cin4_check_vs_cpu": ccheck, "sortless": sstats,
               "generic_plan_check": gplan_check, "generic": gstats,
               "generic_check_vs_cpu": gcheck,
               "probes": {k: v for k, v in pstats.items() if k != "launches"}}
    print("[summary] " + json.dumps(summary), flush=True)
    print(f"[total] {summary['total_s']:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("shape", "max_rel_err", "tol_rel")
    entries = {}
    # LE's and LF's device ms beside their library call's (phase 23)
    level = ("level", "level_launches", "device_ms", "flushed_device_ms",
             "library_device_ms", "library_flushed_device_ms",
             "fill_device_ms", "scatter_device_ms")
    for r in rows:  # one entry per kernel; further shapes nest under it
        if r["name"] in entries:
            entries[r["name"]]["more_shapes"].append(
                {k: r[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")
                 + level if k in r})
        else:
            entries[r["name"]] = {**{k: r[k] for k in keys + extra + level
                                     if k in r}, "more_shapes": []}
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
