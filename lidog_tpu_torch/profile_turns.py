"""Compare this checkout with another on one card, in turns.

    python -m lidog_tpu_torch.profile_turns --other DIR [--rounds 2]
        {train,serve,kernels,stages,gathers,p50} [-- extra arguments]
    python -m lidog_tpu_torch.profile_turns --other DIR kernels -- plan
    python -m lidog_tpu_torch.profile_turns --other DIR kernels -- in
    python -m lidog_tpu_torch.profile_turns --other DIR p50 -- robustnet ibn

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
KB, KC and KF at every strided form of MinkUNet34 (chip_smoke's
STRIDED_FORMS: forward, dx and dW on the training plan, the forward on
the serving plan, also as device ms with the sums over a step's 24 and a
request's 8 launches), LA and LB at the generic training plan's shapes
(chip_smoke phase 20), the masked BatchNorm's KG, KH and KD at every
(level, width, residual, ReLU) form of MinkUNet34's norms (chip_smoke's
BN_FORMS; bf16,
and L0 96 in f32) on the training plan and KD on the serving plan, also
as device ms (torch.profiler) with their sums over a step's and a
request's 62 norms and the device split of KG's and KH's kernels at L0
96, the voxelizer (LC) at its serving and training shapes, and the plan
kernels of chip_smoke's PLAN_FORMS (KT, KU and the column tables KV-KY at
every level of the serving and training plans, KR, KS and KQ at some) on
the builder's own inputs, also as device ms (KV, KW and KY split into each
kernel and fill), with a step's and a request's device sums of KT, KU and
of each of KV-KY beside their byte bounds (each checkout's own tables),
with CUDA events (ms per call, mean of 10 after a warm-up, as chip_smoke's
`cuda_ms`), on the seeded inputs of chip_smoke and with each checkout's
own kernels, and prints one JSON line (`kernels -- plan`: the plan
kernels alone; `kernels -- in`: the instance norm's KK and KL alone at
chip_smoke's IN_FORMS, bf16 and L0 f32, events and device ms, the device
split by kernel and fill at L0, the byte bounds, the sums over a
RobustNet step's 11 calls and an IBN step's 9, and the host us of one
call on 1,024 rows); `stages`
prints the device ms of the training step's stages (chip_smoke's
`train_stage_split`: voxelize, plan, forward, backward, optimizer) after
two warm-up steps, and of a serving request's (`stage_split`: voxelize,
plan, forward, labels; median of 5 after 2 warm-up requests), as one JSON
line.  `gathers` times the probes' window gathers LE and LF at every
probe shape of chip_smoke's phase 23 beside the PyTorch call for the same
gather (index_select, gather): CUDA events over 10 calls back to back
(chip_smoke's `cuda_ms`) and over 50 (`probes.common.timed`), device ms
(torch.profiler) and device ms with the L2 cache flushed before each call;
then the host us of one call and of each piece of a port kernel's call
path (`on_card`, the output's allocation, the stream, the library
lookup, the ctypes call, `_cuda.call`, the wrapper with the call stubbed
out), by time.perf_counter_ns over 10,000 calls in batches of 500 (the
device synchronised between batches, outside the clock), as one JSON
line.  `p50` runs chip_smoke's
phase 4 (5 timed requests) and phase 6 (5 timed training steps) and
prints their p50s and each request's and step's ms as one JSON line
(`p50 -- VARIANT ...`: the 5 timed steps of each of chip_smoke's train
variants named, e.g. robustnet, ibn, instead).
Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the host us of one call: 10,000 calls by time.perf_counter_ns in batches
# of 500, the device synchronised between batches (outside the clock)
_HOST_US = r"""
import time
import torch


def host_us(fn, n=10_000, batch=500):
    fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(n // batch):
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
    return total / n / 1e3


"""

# run inside each checkout: its own chip_smoke helpers and kernels
_KERNELS = _HOST_US + r"""
import inspect, json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from lidog_tpu_torch.core import voxelize as V
from lidog_tpu_torch.ops import _cuda, norm, zconv

from lidog_tpu_torch.profile_serve import kernel_events

_cuda.build()
dev = torch.device("cuda")
out = {}


def device_ms(fn, calls=5, split=False):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = kernel_events(prof)
    if split:
        return {name[:60]: [us / calls / 1e3, k // calls]
                for name, us, k in ev}
    return sum(us for _, us, _ in ev) / calls / 1e3


tpts, tlabels = cs.train_data()
b = cs.train_batch(tpts, tlabels, dev)
if sys.argv[5:] == ["in"]:
    # KK and KL alone at the instance-norm forms of RobustNet's and IBN's
    # steps (chip_smoke's IN_FORMS, passed in as JSON) on the training
    # plan, bf16 and L0 x 32 f32: events and device ms, the byte bound
    # (chip_smoke phase 11's), the device split by kernel and fill at L0,
    # the sums over a RobustNet step's 11 and an IBN step's 9 calls; then
    # the host us of one call on a small input (1,024 rows of 4 scans x
    # 32 bf16, device time below the host's)
    plan = cs.train_plan_builder()(b["coords"], b["mask"])
    ck = cs.Checker(torch.Generator().manual_seed(cs.SEED + 10), dev)
    sums = {}
    for lvl, c, robust, ibn in json.loads(sys.argv[4]):
        L = plan.level(lvl)
        n, bidx = L.coords.shape[0], L.coords[:, 0]
        io = L.real.numel() + 4 * n
        for dt in (torch.bfloat16, torch.float32)[:2 if lvl == 0 else 1]:
            esz = torch.finfo(dt).bits // 8
            x = (ck.feats(n, c, L.real, torch.float32) * 3.0 + 1.5).to(dt)
            x = (x * L.real[:, None].to(dt)).contiguous()
            st = norm.instance_norm_fwd_plain(x, L.real, bidx)[1:]
            dy = ck.feats(n, c, L.real, dt)
            calls = {"instance_norm_fwd": (
                lambda: norm.instance_norm_fwd(x, L.real, bidx),
                2 * n * c * esz + io),
                "instance_norm_bwd": (
                lambda: norm.instance_norm_bwd(dy, x, L.real, bidx, *st),
                3 * n * c * esz + io)}
            for name, (fn, nbyte) in calls.items():
                key = f"{name} L{lvl} {n} rows x {c} {str(dt)[6:]}"
                out[key] = cs.cuda_ms(fn)
                out[f"{key} device"] = device_ms(fn)
                out[f"{key} bound"] = nbyte / cs.HBM_BYTES_PER_S * 1e3
                if lvl == 0:
                    out[f"{key} split"] = device_ms(fn, split=True)
                if dt != torch.bfloat16:
                    continue
                for step, count in (("RobustNet", robust), ("IBN", ibn)):
                    for part in ("device", "bound"):
                        k = f"{name} a {step} step, {part}"
                        sums[k] = sums.get(k, 0.0) + count * out[
                            f"{key} {part}"]
    out.update(sums)
    n = 1024
    small = {"x": ck.feats(n, 32, torch.ones(n, dtype=torch.bool,
                                             device=dev), torch.bfloat16),
             "m": torch.arange(n, device=dev) % 4 != 3,
             "b": torch.arange(n, device=dev, dtype=torch.int32) * 4 // n}
    st = norm.instance_norm_fwd_plain(small["x"], small["m"], small["b"])[1:]
    out["host us: instance_norm_fwd, 1,024 rows x 32 bf16"] = host_us(
        lambda: norm.instance_norm_fwd(small["x"], small["m"], small["b"]))
    out["host us: instance_norm_bwd, 1,024 rows x 32 bf16"] = host_us(
        lambda: norm.instance_norm_bwd(small["x"], small["x"], small["m"],
                                       small["b"], *st))
    print("[kernels] " + json.dumps(out), flush=True)
    sys.exit(0)
# the plan kernels (chip_smoke's PLAN_FORMS, passed in as JSON) on the
# inputs the builder gives them: events and device ms, the byte bound (KV,
# KW and KY also the device ms of each kernel and fill of a call), and the
# KT, KU, KV, KW, KX and KY sums over a step's and a request's 5 levels
from lidog_tpu_torch.caps import make_zcaps
from lidog_tpu_torch.core import zseg as Z

one = torch.from_numpy(cs.scan(cs.POINTS, cs.SEED)[0]).to(dev)
vox = V.voxelize_device(one, torch.ones(cs.POINTS, dtype=torch.bool,
                                        device=dev),
                        torch.zeros(cs.POINTS, dtype=torch.int32, device=dev),
                        cs.VOXEL, cs.PER_SCAN, batch_size=1)
zc = make_zcaps(cs.PER_SCAN)
builders = {"serve": (Z.ZSegPlanBuilder(*zc[:2], num_batches=1,
                                        grid_half=cs.GRID_HALF,
                                        caps_col_dil=zc[2]),
                      vox.coords, vox.mask),
            "train": (cs.train_plan_builder(), b["coords"], b["mask"]),
            "cin4": (cs.train_plan_builder(cs.IN_CHANNELS), b["coords"],
                     b["mask"])}
plan_sums = {}
for pname, (builder, coords, mask) in builders.items():
    want = {(lvl, k) for p, lvl, k in json.loads(sys.argv[3]) if p == pname}
    calls = [c for c in builder.sweep_inputs(coords, mask)
             if (c[0], c[1]) in want]
    calls += [c for c in builder.table_inputs(coords, mask)
              if (c[0], c[1]) in want]
    for lvl, name, args, kwargs in calls:
        fn = getattr(Z, name)
        key = f"{name} {pname} L{lvl}"
        out[key] = cs.cuda_ms(lambda: fn(*args, **kwargs))
        out[f"{key} device"] = device_ms(lambda: fn(*args, **kwargs))
        table = name in cs.TABLE_KERNELS
        nbyte = (cs.table_nbytes if table else cs.sweep_nbytes)(
            name, args, kwargs)
        out[f"{key} bound"] = nbyte / cs.HBM_BYTES_PER_S * 1e3
        if name in ("column_grid", "real_words", "emit_rows"):  # by kernel
            out[f"{key} split"] = device_ms(lambda: fn(*args, **kwargs),
                                            split=True)
        tag = {"train": "a step", "serve": "a request"}.get(pname)
        group = {"_build_packed": "KU", "column_grid": "KV",
                 "real_words": "KW", "assemble_aug": "KX",
                 "emit_rows": "KY", "pos3_lookup": "KT"}.get(name)
        if tag and group:
            for part in ("device", "bound"):
                k = f"{group} {tag} (5 levels), {part}"
                plan_sums[k] = plan_sums.get(k, 0.0) + out[f"{key} {part}"]
    del calls
out.update(plan_sums)
if sys.argv[5:] == ["plan"]:  # the plan kernels alone
    print("[kernels] " + json.dumps(out), flush=True)
    sys.exit(0)
del vox, builders
torch.cuda.empty_cache()
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
# every strided form of MinkUNet34 (chip_smoke's STRIDED_FORMS, passed in
# as JSON): the forward, dx (the partner kernel with W^T) and dW on the
# training plan in bf16 (events and device ms; the device sum of a step's
# 24 launches), the L0 <-> L1 pair also in f32 (events)
def strided(p, kind, lvl, cin, cout, dt):
    fine, coarse = p.level(lvl), p.level(lvl + 1)
    nbr8, parent, off = (p.kmaps[f"{k}_l{lvl}"]
                         for k in ("down8", "parent", "off"))
    nf, nc = fine.coords.shape[0], coarse.coords.shape[0]
    down = kind == "down"
    ni, mi, no = (nf, fine.real, nc) if down else (nc, coarse.real, nf)
    x = ck.feats(ni, cin, mi, dt)
    dout = ck.feats(no, cout, torch.ones(no, dtype=torch.bool, device=dev),
                    dt)
    w8 = ck.weights(dt, 8, cin, cout)
    w8t = w8.transpose(1, 2).contiguous()
    a, b = (lvl, lvl + 1) if down else (lvl + 1, lvl)
    label = f"{kind} L{a}->L{b} {cin}->{cout} {str(dt)[6:]}"
    if down:
        return label, {
            "fwd": lambda: zconv.zconv_down_fwd(x, nbr8, w8, coarse.real),
            "dx": lambda: zconv.zconv_up_fwd(dout, parent, off, w8t, None,
                                             src_mask=coarse.real),
            "dW": lambda: zconv.zconv_down_wgrad(x, dout, parent, off,
                                                 coarse.real)}
    return label, {
        "fwd": lambda: zconv.zconv_up_fwd(x, parent, off, w8, fine.real),
        "dx": lambda: zconv.zconv_down_fwd(dout, nbr8, w8t, None,
                                           src_mask=fine.real),
        "dW": lambda: zconv.zconv_up_wgrad(x, dout, parent, off, fine.real)}


forms = [tuple(f) for f in json.loads(sys.argv[2])]
step = 0.0
for form in forms:
    label, calls = strided(plan, *form, bf)
    for part, fn in calls.items():
        out[f"{part} {label}"] = cs.cuda_ms(fn)
        out[f"{part} {label} device"] = device_ms(fn)
        step += out[f"{part} {label} device"]
    del calls
out["strided a step (24 launches), device"] = step
for form in forms:
    if form[1] == 0:
        label, calls = strided(plan, *form, f32)
        for part, fn in calls.items():
            out[f"{part} {label}"] = cs.cuda_ms(fn)
        del calls
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
# KB and KC: every strided form's forward on the serving plan (bf16;
# events and device ms, the device sum of a request's 8)
req = 0.0
for form in forms:
    label, calls = strided(splan, *form, bf)
    fn = calls["fwd"]
    out[f"fwd serving {label}"] = cs.cuda_ms(fn)
    out[f"fwd serving {label} device"] = device_ms(fn)
    req += out[f"fwd serving {label} device"]
    del calls
out["KB + KC a request (8 launches), device"] = req
# the masked BatchNorm at every norm form of MinkUNet34 (bf16; chip_smoke's
# BN_FORMS, passed in as JSON): KG, KH and KD on the training plan's rows
# (CUDA events, and device ms by the profiler), KD on the serving plan's
# rows (device ms), L0 96 +res +relu also in f32, the sums over a step's
# and a request's 62 norms, and the device split of KG's and KH's kernels
# at L0 96 +res +relu
def bn_inputs(L, c, has_res, relu, dt):
    n = L.coords.shape[0]
    every = torch.ones(n, dtype=torch.bool, device=dev)
    x, dy = ck.feats(n, c, every, dt), ck.feats(n, c, every, dt)
    res = ck.feats(n, c, every, dt) if has_res else None
    scale = torch.rand(c, generator=gen).to(dev) + 0.5
    bias = torch.zeros(c, device=dev)
    run = [torch.zeros(c, device=dev), torch.ones(c, device=dev)]
    y, mean, var_raw, inv, cnt = norm.bn_train_fwd_plain(
        x, L.real, scale, bias, *[t.clone() for t in run], 0.1, 1e-5, res,
        relu)
    bwd = (dy, y, x, L.real, scale, mean, var_raw, inv, cnt, 1e-5, has_res,
           relu)
    return {"bn_train_fwd": lambda: norm.bn_train_fwd(
                x, L.real, scale, bias, *run, 0.1, 1e-5, res, relu),
            "bn_train_bwd": lambda: norm.bn_train_bwd(*bwd),
            "bn_act": lambda: norm.bn_act(x, mean, inv, bias, L.real, res,
                                          relu)}


sums = {"bn_train_fwd + bn_train_bwd a step (62 norms), device": 0.0,
        "bn_act a step (in bn_train_fwd), device": 0.0,
        "bn_act a request (62 norms), device": 0.0}
forms = [tuple(f) for f in json.loads(sys.argv[1])]
for lvl, c, has_res, relu, count, dt in [f + (bf,) for f in forms] + [
        (0, 96, True, True, 0, f32)]:
    calls = bn_inputs(plan.level(lvl), c, has_res, relu, dt)
    shape = (f"L{lvl} {plan.level(lvl).coords.shape[0]} rows {c}"
             + (" +res" if has_res else "") + (" +relu" if relu else "")
             + f" {str(dt)[6:]}")
    for name, fn in calls.items():
        out[f"{name} {shape}"] = cs.cuda_ms(fn)
        out[f"{name} {shape} device"] = device_ms(fn)
    sums["bn_train_fwd + bn_train_bwd a step (62 norms), device"] += count * (
        out[f"bn_train_fwd {shape} device"]
        + out[f"bn_train_bwd {shape} device"])
    sums["bn_act a step (in bn_train_fwd), device"] += count * out[
        f"bn_act {shape} device"]
    if lvl == 0 and c == 96 and has_res:
        for name in ("bn_train_fwd", "bn_train_bwd"):
            for kname, v in device_ms(calls[name], split=True).items():
                out[f"{name} {shape} device: {kname}"] = v
    if count:
        fn = bn_inputs(splan.level(lvl), c, has_res, relu, dt)["bn_act"]
        sshape = f"serving L{lvl} {splan.level(lvl).coords.shape[0]} rows " \
            + shape.split(" rows ", 1)[1]
        out[f"bn_act {sshape} device"] = device_ms(fn)
        sums["bn_act a request (62 norms), device"] += count * out[
            f"bn_act {sshape} device"]
out.update(sums)
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
# LA and LB at the generic training plan's shapes (chip_smoke phase 20):
# the forward, dIn over the transpose map and dW, bf16, events and device
del plan, b
torch.cuda.empty_cache()
_, gplan = cs.generic_batch_plan(dev)
from lidog_tpu_torch.ops import sparse_conv as sc

for name, li, lo, cin, cout, partner in (
        ("conv3_l0", 0, 0, 32, 32, None), ("conv3_l0", 0, 0, 128, 96, None),
        ("conv3_l3", 3, 3, 512, 256, None), ("down_l0", 0, 1, 32, 32, "up_l0"),
        ("up_l0", 1, 0, 96, 96, "down_l0")):
    nbr = gplan.kmaps[name]
    m_in, m_out = gplan.level(li).mask, gplan.level(lo).mask
    x = ck.feats(m_in.shape[0], cin, m_in, bf)
    w = ck.weights(bf, nbr.shape[0], cin, cout)
    dout = ck.feats(m_out.shape[0], cout, m_out, bf)
    rev = partner is None
    tmap = nbr if rev else gplan.kmaps[partner]
    wt = (w.flip(0) if rev else w).transpose(1, 2).contiguous()
    shape = f"{name} {nbr.shape[1]} rows K {nbr.shape[0]} {cin}->{cout}"
    for part, fn in (
            ("sparse_conv_fwd", lambda: sc.sparse_conv_fwd(x, nbr, w, m_out)),
            ("sparse_conv_fwd dIn", lambda: sc.sparse_conv_fwd(
                dout, tmap, wt, None, m_out)),
            ("sparse_conv_wgrad", lambda: sc.sparse_conv_wgrad(
                x, dout, tmap, m_out, reverse=rev))):
        out[f"{part} {shape}"] = cs.cuda_ms(fn)
        out[f"{part} {shape} device"] = device_ms(fn)
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


# run inside each checkout: LE and LF beside their library calls, and the
# host time of a port kernel's call path, piece by piece
_GATHERS = _HOST_US + r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from lidog_tpu_torch.ops import _cuda, gather as g
from lidog_tpu_torch.ops._wrap import on_card
from lidog_tpu_torch.probes.common import flushed_device_ms, timed

_cuda.build(("window_gather",))
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(cs.SEED + 14)
f32, bf = torch.float32, torch.bfloat16
out = {}
# (kernel, case, rows, columns of the window, T, dtype): LE's window
# [W, C], LF's [C, W]
SHAPES = (("LE", "P1", 2048, 96, 512, f32), ("LE", "P1", 2048, 96, 512, bf),
          ("LE", "t2", 256, 128, 256, f32), ("LE", "t3a", 1024, 128, 1024, f32),
          ("LE", "t3b", 4096, 128, 4096, f32), ("LF", "P1", 96, 2048, 512, f32),
          ("LF", "P1", 96, 2048, 512, bf), ("LF", "t4", 128, 256, 256, f32),
          ("LF", "t4b", 128, 2048, 2048, f32))
for kind, case, a, b, t, dt in SHAPES:
    win = torch.randn(a, b, generator=gen).to(dev, dt)
    idx = torch.randint(0, a if kind == "LE" else b, (t,), generator=gen,
                        dtype=torch.int32).to(dev)
    if kind == "LE":
        i64 = idx.long()
        calls = {"kernel": lambda: g.window_row_gather(win, idx),
                 "index_select": lambda: torch.index_select(win, 0, i64)}
    else:
        i64 = idx.long()[None].expand(a, -1)
        calls = {"kernel": lambda: g.window_lane_gather(win, idx),
                 "gather": lambda: torch.gather(win, 1, i64)}
    got = [fn() for fn in calls.values()]
    if not torch.equal(*got):
        raise SystemExit(f"{kind} {case}: the kernel differs from the library")
    for part, fn in calls.items():
        key = f"{kind} {case} {str(dt)[6:]} {part}"
        out[f"{key} events10 ms"] = cs.cuda_ms(fn)
        out[f"{key} events50 ms"], out[f"{key} device ms"] = timed(fn, dev, 50)
        out[f"{key} flushed device ms"] = flushed_device_ms(fn, dev, 50)


# LF at P1 f32 (win [96, 2048], 512 lanes) and LE at P1 f32, piece by piece
c, w, t = 96, 2048, 512
win = torch.randn(c, w, generator=gen).to(dev)
rwin = win.T.contiguous()
idx = torch.randint(0, w, (t,), generator=gen, dtype=torch.int32).to(dev)
i64 = idx.long()
i64x = i64[None].expand(c, -1)
name = "window_lane_gather"
res = torch.empty(c, t, device=dev)
args = (win.data_ptr(), idx.data_ptr(), res.data_ptr(), c, w, t, 4)
fn = getattr(_cuda.library("window_gather"), name)
stream = torch.cuda.current_stream().cuda_stream
pieces = {
    "LF wrapper (P1 f32)": lambda: g.window_lane_gather(win, idx),
    "LE wrapper (P1 f32)": lambda: g.window_row_gather(rwin, idx),
    "torch.gather (LF's library call)": lambda: torch.gather(win, 1, i64x),
    "torch.index_select (LE's library call)":
        lambda: torch.index_select(rwin, 0, i64),
    "on_card": lambda: on_card(name, win, idx),
    "torch.empty(c, t, dtype, device=win.device)":
        lambda: torch.empty(c, t, dtype=win.dtype, device=win.device),
    "torch.cuda.current_stream().cuda_stream":
        lambda: torch.cuda.current_stream().cuda_stream,
    "raw stream (_cuda_getCurrentRawStream(_cuda_getDevice()))":
        lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()),
    "library + getattr": lambda: getattr(_cuda.library("window_gather"), name),
    "ctypes call (bound, stream given)": lambda: fn(*args, stream),
    "_cuda.call": lambda: _cuda.call(name, *args),
}
for k, f in pieces.items():
    out[f"host us: {k}"] = host_us(f)
# the wrapper with its C call stubbed out: its Python side alone
launch = _cuda.call
_cuda.call = lambda *a: None
out["host us: LF wrapper, _cuda.call stubbed"] = host_us(
    lambda: g.window_lane_gather(win, idx))
_cuda.call = launch
print("[gathers] " + json.dumps(out), flush=True)
"""

_P50 = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from lidog_tpu_torch.models.minkunet import MinkUNet34
from lidog_tpu_torch.ops import _cuda

_cuda.build()
dev = torch.device("cuda")
out = {}
if not sys.argv[1:]:  # a request, then the plain step
    model = MinkUNet34(out_channels=cs.NUM_CLASSES,
                       compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(cs.SEED))
    s = cs.serve(model, cs.scan(cs.POINTS, cs.SEED), dev)
    out = {"request p50 ms": s["p50_ms"], "request ms": s["request_ms"]}
    del model
    torch.cuda.empty_cache()
for variant in sys.argv[1:] or ["source"]:  # chip_smoke's train variants
    t = cs.train(dev, variant)
    tag = "" if variant == "source" else f"{variant} "
    out[f"{tag}step p50 ms"], out[f"{tag}step ms"] = t["p50_ms"], t["step_ms"]
    torch.cuda.empty_cache()
print("[p50] " + json.dumps(out), flush=True)
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
    ap.add_argument("what", choices=("train", "serve", "kernels", "stages",
                                     "gathers", "p50"))
    ap.add_argument("extra", nargs="*")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_turns: needs a CUDA device")
    from lidog_tpu_torch.profile_serve import card_line

    print(card_line(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.other)
    if args.what == "kernels":
        sys.path.insert(0, here)
        from chip_smoke import BN_FORMS, IN_FORMS, PLAN_FORMS, STRIDED_FORMS

        cmd = [sys.executable, "-c", _KERNELS, json.dumps(BN_FORMS),
               json.dumps(STRIDED_FORMS), json.dumps(PLAN_FORMS),
               json.dumps(IN_FORMS), *args.extra]
    elif args.what in ("stages", "gathers", "p50"):
        cmd = [sys.executable, "-c", {"stages": _STAGES, "gathers": _GATHERS,
                                      "p50": _P50}[args.what], *args.extra]
    else:
        cmd = [sys.executable, "-m", f"lidog_tpu_torch.profile_{args.what}",
               *args.extra]
    for _ in range(args.rounds):
        for tag, root in (("this", here), ("other", other), ("other", other),
                          ("this", here)):
            _run(tag, root, cmd)


if __name__ == "__main__":
    main()
