"""Compare this checkout with another on one card, in turns.

    python -m lidog_tpu_torch.profile_turns --other DIR [--rounds 2]
        {train,serve,kernels,stages} [-- extra arguments]

Runs the same measurement in a fresh process from this checkout's root
and from DIR (another checkout of the repo, e.g. its parent commit
unpacked with `git archive`), in the order this, other, other, this (each
round adds one such quartet), and prints every output line tagged with
its checkout.  `train` and `serve` run `python -m
lidog_tpu_torch.profile_train` / `profile_serve` (extra arguments are
passed on); `kernels` times the zconv3 weight gradient (KF) at
chip_smoke's training-plan shapes, the zconv3 forward and input gradient
(KA, KE) at the training plan's L0 shapes and at every zconv3 width pair
of MinkUNet34 at its level (bf16), KA also at the serving plan's shapes,
KB and KC at their forward (serving) and transposed-weight (training)
shapes, and the voxelizer (LC) at its serving and training shapes, with
CUDA events (ms per call, mean of 10 after a warm-up, as chip_smoke's
`cuda_ms`), on the seeded inputs of chip_smoke and with each checkout's
own kernels, and prints one JSON line; `stages`
prints the device ms of the training step's stages (chip_smoke's
`train_stage_split`: voxelize, plan, forward, backward, optimizer) after
two warm-up steps, and of a serving request's (`stage_split`: voxelize,
plan, forward, labels; median of 5 after 2 warm-up requests), as one JSON
line.  Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# run inside each checkout: its own chip_smoke helpers and kernels
_KERNELS = r"""
import inspect, json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from lidog_tpu_torch.core import voxelize as V
from lidog_tpu_torch.ops import _cuda, zconv

_cuda.build()
dev = torch.device("cuda")
out = {}
tpts, tlabels = cs.train_data()
b = cs.train_batch(tpts, tlabels, dev)
plan = cs.train_plan_builder()(b["coords"], b["mask"])
gen = torch.Generator().manual_seed(cs.SEED + 8)
ck = cs.Checker(gen, dev)
bf, f32 = torch.bfloat16, torch.float32
for lvl, cin, cout, dt, cut in ((0, 128, 96, bf, 0), (0, 96, 96, bf, 0),
                                (0, 96, 96, f32, 0), (1, 32, 32, bf, 0),
                                (1, 32, 32, f32, 0), (1, 128, 96, bf, 0),
                                (4, 256, 256, bf, 0), (2, 64, 64, bf, 37),
                                (2, 64, 64, f32, 37)):
    L = plan.level(lvl)
    n = L.coords.shape[0] - cut
    nbr9 = plan.kmaps[f"conv9_l{lvl}"][:, :n].contiguous()
    zup, zdn, real = (t[:n].contiguous() for t in (L.zup, L.zdn, L.real))
    x = ck.feats(n, cin, real, dt)
    dout = ck.feats(n, cout, torch.ones(n, dtype=torch.bool, device=dev), dt)
    key = f"zconv3_wgrad L{lvl} {n} rows {cin}->{cout} {str(dt)[6:]}"
    out[key] = cs.cuda_ms(lambda: zconv.zconv3_wgrad(x, dout, nbr9, zup, zdn,
                                                     real))
# KA and KE (and KB, KC beside them): the training plan's L0 shapes, then
# every other zconv3 width pair of MinkUNet34 at its level, bf16
ones = {lvl: torch.ones(plan.level(lvl).coords.shape[0], dtype=torch.bool,
                        device=dev) for lvl in range(5)}


def conv3(tag, p, lvl, cin, cout, dt, kinds=("fwd", "dx")):
    L = p.level(lvl)
    nbr9 = p.kmaps[f"conv9_l{lvl}"]
    n = nbr9.shape[1]
    x = ck.feats(n, cin, L.real, dt)
    dout = ck.feats(n, cout, torch.ones(n, dtype=torch.bool, device=dev), dt)
    wf = ck.weights(dt, 9, 3 * cin, cout)
    shape = f"{tag}L{lvl} {n} rows {cin}->{cout} {str(dt)[6:]}"
    if "fwd" in kinds:
        out[f"zconv3_fwd {shape}"] = cs.cuda_ms(
            lambda: zconv.zconv3_fwd(x, nbr9, L.zup, L.zdn, wf, L.real))
    if "dx" in kinds:
        out[f"zconv3_bwd_dx {shape}"] = cs.cuda_ms(
            lambda: zconv.zconv3_bwd_dx(dout, nbr9, L.zup, L.zdn, wf, L.real))


for cin, cout, dt in ((128, 96, bf), (96, 96, bf), (96, 96, f32)):
    conv3("training ", plan, 0, cin, cout, dt)
conv3("training ", plan, 1, 32, 32, f32)
for lvl, cin, cout in ((1, 32, 32), (2, 32, 64), (2, 64, 64), (3, 64, 128),
                       (3, 128, 128), (4, 128, 256), (4, 256, 256),
                       (3, 384, 256), (2, 192, 128), (1, 128, 96),
                       (1, 96, 96)):
    conv3("training ", plan, lvl, cin, cout, bf)
l0, l1 = plan.level(0), plan.level(1)
nbr8, parent, off = (plan.kmaps[k]
                     for k in ("down8_l0", "parent_l0", "off_l0"))
for dt in (bf, f32):
    sfx = str(dt)[6:]
    d1 = ck.feats(l1.coords.shape[0], 32, ones[1], dt)
    w8 = ck.weights(dt, 8, 32, 32)
    out[f"zconv_up_fwd W^T L1->L0 32->32 {sfx}"] = cs.cuda_ms(
        lambda: zconv.zconv_up_fwd(d1, parent, off, w8, None,
                                   src_mask=l1.real))
    d0 = ck.feats(l0.coords.shape[0], 96, ones[0], dt)
    u8 = ck.weights(dt, 8, 96, 96)
    out[f"zconv_down_fwd W^T L0->L1 96->96 {sfx}"] = cs.cuda_ms(
        lambda: zconv.zconv_down_fwd(d0, nbr8, u8, None, src_mask=l0.real))
# KA (with KB, KC) at the serving plan of one scan, as chip_smoke phase 3
from lidog_tpu_torch.models.minkunet import MinkUNet34
from lidog_tpu_torch.serve import Predictor

probe = Predictor(MinkUNet34(out_channels=cs.NUM_CLASSES, compute_dtype=bf,
                             generator=torch.Generator().manual_seed(cs.SEED)),
                  batch_size=1, voxel_size=cs.VOXEL, caps_per_scan=cs.PER_SCAN,
                  grid_half=cs.GRID_HALF, device=dev)
one = torch.from_numpy(cs.scan(cs.POINTS, cs.SEED)[0]).to(dev)
vox = V.voxelize_device(one, torch.ones(cs.POINTS, dtype=torch.bool,
                                        device=dev),
                        torch.zeros(cs.POINTS, dtype=torch.int32, device=dev),
                        cs.VOXEL, probe.cap_in, batch_size=1)
splan = probe.builder(vox.coords, vox.mask)
for lvl, cin, cout, dt in ((0, 128, 96, bf), (0, 96, 96, bf), (1, 32, 32, bf),
                           (1, 32, 32, f32)):
    conv3("serving ", splan, lvl, cin, cout, dt, ("fwd",))
s0, s1 = splan.level(0), splan.level(1)
for dt in (bf, f32):
    sfx = str(dt)[6:]
    xs = ck.feats(s0.coords.shape[0], 32, s0.real, dt)
    w8 = ck.weights(dt, 8, 32, 32)
    out[f"zconv_down_fwd serving L0->L1 32->32 {sfx}"] = cs.cuda_ms(
        lambda: zconv.zconv_down_fwd(xs, splan.kmaps["down8_l0"], w8, s1.real))
    xc = ck.feats(s1.coords.shape[0], 96, s1.real, dt)
    u8 = ck.weights(dt, 8, 96, 96)
    out[f"zconv_up_fwd serving L1->L0 96->96 {sfx}"] = cs.cuda_ms(
        lambda: zconv.zconv_up_fwd(xc, splan.kmaps["parent_l0"],
                                   splan.kmaps["off_l0"], u8, s0.real))
kw = ("batch_size" in inspect.signature(V.voxelize_cells).parameters)
for name, pts, bsz, cap in (
        ("serve", cs.scan(cs.POINTS, cs.SEED)[0], 1, cs.PER_SCAN),
        ("train", tpts.reshape(-1, 3), cs.TRAIN_BATCH, cs.TRAIN_CAP_IN),
        ("overflow", tpts.reshape(-1, 3), cs.TRAIN_BATCH,
         cs.TRAIN_CAP_IN // 2)):
    flat = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
    disc = V.quantize(flat, cs.VOXEL)
    valid = torch.ones(flat.shape[0], dtype=torch.bool, device=dev)
    bidx = torch.arange(bsz, dtype=torch.int32, device=dev) \
        .repeat_interleave(flat.shape[0] // bsz)
    extra = {"batch_size": bsz} if kw else {}
    out[f"voxelize {name}"] = cs.cuda_ms(lambda: V.voxelize_cells(
        disc, valid, bidx, cap, **extra))
print("[kernels] " + json.dumps(out), flush=True)
"""


_STAGES = r"""
import json, statistics, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from lidog_tpu_torch.models.minkunet import MinkUNet34
from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.serve import Predictor
from lidog_tpu_torch.train.optim import make_optimizer
from lidog_tpu_torch.train.train_step import TrainState

_cuda.build()
dev = torch.device("cuda")
pts, labels = cs.train_data()
model = cs.variant_model("source", torch.bfloat16,
                         torch.Generator().manual_seed(cs.SEED))
state = TrainState.create(model, make_optimizer("Adam", lr=1e-3), device=dev)
builder = cs.train_plan_builder()
step = cs.variant_step("source")
for _ in range(2):
    batch = cs.train_batch(pts, labels, dev)
    step(state, batch, builder(batch["coords"], batch["mask"]))
torch.cuda.synchronize()
train = cs.train_stage_split(state, pts, labels, builder, dev)
train.pop("bounds")
smodel = MinkUNet34(out_channels=cs.NUM_CLASSES, compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(cs.SEED))
pred = Predictor(smodel, batch_size=1, voxel_size=cs.VOXEL,
                 caps_per_scan=cs.PER_SCAN, grid_half=cs.GRID_HALF, device=dev)
one = torch.from_numpy(cs.scan(cs.POINTS, cs.SEED)).to(dev)
for _ in range(2):
    pred(one)
runs = [cs.stage_split(pred, one)[0] for _ in range(5)]
serve = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
print("[stages] " + json.dumps({"train": train, "serve": serve}), flush=True)
"""


def _run(tag, root, cmd):
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        print(f"[{tag}] {line}", flush=True)
    if r.returncode != 0:
        raise SystemExit(f"profile_turns: {tag} exited {r.returncode}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("what", choices=("train", "serve", "kernels", "stages"))
    ap.add_argument("extra", nargs="*")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_turns: needs a CUDA device")
    from lidog_tpu_torch.profile_serve import card_line

    print(card_line(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.other)
    if args.what in ("kernels", "stages"):
        cmd = [sys.executable, "-c",
               _KERNELS if args.what == "kernels" else _STAGES]
    else:
        cmd = [sys.executable, "-m", f"lidog_tpu_torch.profile_{args.what}",
               *args.extra]
    for _ in range(args.rounds):
        for tag, root in (("this", here), ("other", other), ("other", other),
                          ("this", here)):
            _run(tag, root, cmd)


if __name__ == "__main__":
    main()
