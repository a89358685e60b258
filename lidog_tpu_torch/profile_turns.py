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
chip_smoke's training-plan shapes and the voxelizer (LC) at its serving
and training shapes, with CUDA events (ms per call, mean of 10 after a
warm-up, as chip_smoke's `cuda_ms`), on the seeded inputs of chip_smoke
and with each checkout's own kernels, and prints one JSON line; `stages`
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
