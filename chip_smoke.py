#!/usr/bin/env python3
"""Drive lidog_tpu_torch's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

  1. the card: name and power limit (nvidia-smi);
  2. build every kernel of the path from the sources in this checkout
     (one nvcc per CUDA source, in parallel; Triton compiles at first
     launch);
  3. per kernel: the kernel against its plain PyTorch version on the same
     inputs, at shapes from a full-width plan of one synthetic scan: max
     error relative to max|plain| against a stated bound, kernel / plain
     times (CUDA events), and the kernel's least possible time on an H100
     (bytes over 3.35 TB/s or operations over the peak rate of their type);
  4. full-width serving: Predictor(MinkUNet34, bf16) on a 100,000-point
     scan, 1 warm-up and 5 timed requests; zero overflow, >= 95% of points
     labelled, labels in [0, 7), and every kernel counter equal to its
     launches per forward x requests;
  5. cross-check: the same weights through the Predictor on the CPU (plain
     versions) on a 20,000-point scan: the plan's integer fields bitwise
     equal to the card's plan, and label agreement >= 99%.

The line before the last is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.  Exits non-zero without a card, and
in a directory that does not hold the lidog_tpu_torch package.
"""

import copy
import json
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


def scan(points, seed):
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset

    ds = SyntheticLidarDataset(num_scans=1, points_per_scan=points,
                               radius=50.0, seed=seed)
    return ds[0]["points"][None]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_checks(plan, gen):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from lidog_tpu_torch.ops import norm, zconv

    bf, f32 = torch.bfloat16, torch.float32
    dev = plan.levels[0].coords.device
    l0, l1 = plan.level(0), plan.level(1)
    na = l0.coords.shape[0]
    # kernel vs plain, relative to max |plain|: bf16 kernels sum in f32 in
    # another order (KA also skips JAX's per-offset rounding); f32 differs
    # by summation order only
    tol = {bf: {"zconv3_fwd": 2e-2}, f32: {}}
    tol_default = {bf: 1e-2, f32: 1e-4}

    def feats(n_rows, c, real, dt):
        x = torch.randn(n_rows, c, generator=gen).to(dev, dt)
        return (x * real[:, None].to(dt)).contiguous()

    def weights(dt, *shape):
        return (torch.randn(*shape, generator=gen) * 0.05).to(dev, dt)

    def rel_err(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))

    def bound(nbyte, ops, kind):
        tb = nbyte / HBM_BYTES_PER_S * 1e3
        to = ops / PEAK_OPS[kind] * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    rows = []

    def record(name, source, replaces, kfn, pfn, dt, nbyte, ops, shape):
        out_k, out_p = kfn(), pfn()
        torch.cuda.synchronize()
        err = rel_err(out_k, out_p)
        t = tol[dt].get(name, tol_default[dt])
        kind = "bf16" if dt == bf and name != "bn_act" else "f32"
        b_ms, b_by = bound(nbyte, ops, kind)
        shape = f"{shape} {str(dt).split('.')[-1]}"
        row = {"name": name, "route": "triton" if source.endswith(".py")
               else "cuda", "source": source, "replaces": replaces,
               "shape": shape, "max_abs_err": float(
                   (out_k.float() - out_p.float()).abs().max()),
               "max_rel_err": err, "tol_rel": t, "ms": cuda_ms(kfn),
               "plain_ms": cuda_ms(pfn), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        print(f"[kernel] {name} {shape}: rel err {err:.3e} (bound {t}) "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        if not err <= t:
            raise AssertionError(f"{name} {shape}: rel err {err} > {t}")
        rows.append(row)

    # KA: zconv3 at the main path's shapes: L0 128 -> 96 (block8_0.conv1:
    # up 96 + skip 32), L0 96 -> 96 (block8 conv2), L1 32 -> 32 (block1);
    # f32 (MinkUNet34's default compute dtype) at L1 32 -> 32
    for lvl, cin, cout, dt in ((0, 128, 96, bf), (0, 96, 96, bf),
                               (1, 32, 32, bf), (1, 32, 32, f32)):
        L = plan.level(lvl)
        nbr9 = plan.kmaps[f"conv9_l{lvl}"]
        n = nbr9.shape[1]
        # (offset, z tap) sources that the k=3 sum needs on real rows
        src = nbr9.clamp(min=0).long()
        taps = (nbr9 >= 0).long() * (1 + L.zdn.long()[src] + L.zup.long()[src])
        taps[4] = L.valid.long() * (1 + L.zdn.long() + L.zup.long())
        nnz9 = int((taps * L.real.long()).sum())
        x = feats(n, cin, L.real, dt)
        wf = weights(dt, 9, 3 * cin, cout)
        record("zconv3_fwd", "lidog_tpu_torch/csrc/zconv3_fwd.cu",
               "lidog_tpu/ops/zconv.py:180 (_zconv3_core); "
               "benchmarks/micro/micro_windowconv.py:113 (make_windowed)",
               lambda: zconv.zconv3_fwd(x, nbr9, L.zup, L.zdn, wf, L.real),
               lambda: zconv.zconv3_plain(x, nbr9, L.zup, L.zdn, wf, L.real),
               dt, nbytes(x, nbr9, L.zup, L.zdn, wf, L.real)
               + n * cout * x.element_size(), 2 * cin * cout * nnz9,
               f"L{lvl} {n} rows {cin}->{cout}")

    # KB: zconv_down L0 -> L1, 32 -> 32 (conv1)
    nbr8 = plan.kmaps["down8_l0"]
    nnz8 = int(((nbr8 >= 0) & l1.real[None]).sum())
    for dt in (bf, f32):
        x = feats(na, 32, l0.real, dt)
        w8 = weights(dt, 8, 32, 32)
        record("zconv_down_fwd", "lidog_tpu_torch/csrc/zconv_down_fwd.cu",
               "lidog_tpu/ops/zconv.py:466 (_down_loop / _zdown_core)",
               lambda: zconv.zconv_down_fwd(x, nbr8, w8, l1.real),
               lambda: zconv.zconv_down_plain(x, nbr8, w8, l1.real),
               dt, nbytes(x, nbr8, w8, l1.real)
               + nbr8.shape[1] * 32 * x.element_size(), 2 * 32 * 32 * nnz8,
               f"L0->L1 {nbr8.shape[1]} rows 32->32")

    # KC: zconv_up L1 -> L0 into 96 (convtr7: 96 -> 96)
    parent, off = plan.kmaps["parent_l0"], plan.kmaps["off_l0"]
    nnz_up = int(((parent >= 0) & l0.real).sum())
    for dt in (bf, f32):
        x = feats(l1.coords.shape[0], 96, l1.real, dt)
        w8 = weights(dt, 8, 96, 96)
        record("zconv_up_fwd", "lidog_tpu_torch/csrc/zconv_up_fwd.cu",
               "lidog_tpu/ops/zconv.py:548 (_zup_core, _onehot_matmuls:437)",
               lambda: zconv.zconv_up_fwd(x, parent, off, w8, l0.real),
               lambda: zconv.zconv_up_plain(x, parent, off, w8, l0.real),
               dt, nbytes(x, parent, off, w8, l0.real)
               + na * 96 * x.element_size(), 2 * 96 * 96 * nnz_up,
               f"L1->L0 {na} rows 96->96")

    # KD: BN(eval) + residual + ReLU at L0, width 96 (block8 norm2)
    mean = (torch.randn(96, generator=gen) * 0.1).to(dev)
    inv = (torch.rand(96, generator=gen) + 0.5).to(dev)
    bias = (torch.randn(96, generator=gen) * 0.1).to(dev)
    for dt in (bf, f32):
        x = feats(na, 96, l0.real, dt)
        res = feats(na, 96, l0.real, dt)
        record("bn_act", "lidog_tpu_torch/ops/bn_act_triton.py",
               "lidog_tpu/ops/norm.py:73 (MaskedBatchNorm eval) + "
               "lidog_tpu/models/minkunet.py:252 (residual, ReLU)",
               lambda: norm.bn_act(x, mean, inv, bias, l0.real, res, True),
               lambda: norm.bn_act_plain(x, mean, inv, bias, l0.real, res,
                                         True),
               dt, nbytes(x, res, l0.real, mean, inv, bias)
               + na * 96 * x.element_size(), 5 * na * 96,
               f"L0 {na} rows 96 +res +relu")
    return rows


def serve(model, pts, dev):
    """Phase 4: timed requests through the Predictor; returns stats."""
    import torch

    from lidog_tpu_torch.ops import norm, zconv
    from lidog_tpu_torch.serve import Predictor

    pred = Predictor(model, batch_size=1, voxel_size=VOXEL,
                     caps_per_scan=PER_SCAN, grid_half=GRID_HALF, device=dev)
    pts_dev = torch.from_numpy(pts).to(dev)
    labels = pred(pts_dev)  # warm-up (Triton specializations, caches)
    torch.cuda.synchronize()
    for k in zconv.LAUNCHES:
        zconv.LAUNCHES[k] = 0
    norm.LAUNCHES["bn_act"] = 0
    ms = []
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = pred(pts_dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {**zconv.LAUNCHES, **norm.LAUNCHES}
    lab = labels.cpu().numpy()
    ov = pred.overflow
    print(f"[serve] overflow {ov.tolist()} labelled "
          f"{(lab >= 0).mean():.4f} request ms {ms}", flush=True)
    if ov.sum() != 0:
        raise AssertionError(f"plan overflow {ov.tolist()}")
    if not (lab >= 0).mean() >= 0.95:
        raise AssertionError(f"only {(lab >= 0).mean():.4f} of points labelled")
    if lab.max() >= NUM_CLASSES or lab.min() < -1:
        raise AssertionError(f"labels outside [0, {NUM_CLASSES})")
    for k, per in PER_FORWARD.items():
        if launches[k] != per * REQUESTS:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} x {REQUESTS}")
    stages, plan_rows = stage_split(pred, pts_dev)
    return {"p50_ms": statistics.median(ms), "request_ms": ms,
            "launches": launches, "stages_ms": stages,
            "real_rows_per_level": plan_rows,
            "labelled": float((lab >= 0).mean()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def stage_split(pred, pts_dev):
    """Device ms of voxelize / plan / forward / labels for one request
    (CUDA events between the Predictor's stages; median of 3)."""
    import torch

    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.core.voxelize import voxelize_device

    runs = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.no_grad():
            ev[0].record()
            flat = pts_dev.reshape(-1, 3)
            valid = torch.ones(flat.shape[0], dtype=torch.bool,
                               device=flat.device)
            bidx = torch.zeros(flat.shape[0], dtype=torch.int32,
                               device=flat.device)
            vox = voxelize_device(flat, valid, bidx, pred.voxel_size,
                                  pred.cap_in)
            ev[1].record()
            plan = pred.builder(vox.coords, vox.mask)
            ev[2].record()
            logits = pred.model(input_tensor(
                plan, vox.mask[:, None].float()), plan)
            ev[3].record()
            vp = torch.where(plan.level(0).real,
                             logits.argmax(-1).to(torch.int32), -1)
            pv = torch.where(plan.pos >= 0, vp[plan.pos.clamp(min=0).long()],
                             -1)
            torch.where(vox.inverse >= 0,
                        pv[vox.inverse.clamp(min=0).long()], -1)
            ev[4].record()
        torch.cuda.synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    names = ("voxelize", "plan", "forward", "labels")
    return ({n: statistics.median(r[i] for r in runs)
             for i, n in enumerate(names)},
            [int(l.real.sum()) for l in plan.levels])


def cross_check(model, dev):
    """Phase 5: card vs CPU on a smaller scan, same weights and caps."""
    import torch

    from lidog_tpu_torch.serve import Predictor

    pts = scan(CHECK_POINTS, SEED + 1)
    kw = dict(batch_size=1, voxel_size=VOXEL, caps_per_scan=PER_SCAN,
              grid_half=GRID_HALF)
    gpu = Predictor(model, device=dev, **kw)
    cpu = Predictor(copy.deepcopy(model).cpu(), device="cpu", **kw)
    _, plan_g, _ = gpu.forward_voxels(pts)
    _, plan_c, _ = cpu.forward_voxels(pts)
    for i, (lg, lc) in enumerate(zip(plan_g.levels, plan_c.levels)):
        for f in ("coords", "real", "valid", "zup", "zdn"):
            if not torch.equal(getattr(lg, f).cpu(), getattr(lc, f)):
                raise AssertionError(f"plan level {i} {f} differs")
    for k in plan_c.kmaps:
        if not torch.equal(plan_g.kmaps[k].cpu(), plan_c.kmaps[k]):
            raise AssertionError(f"plan kmap {k} differs")
    for f in ("pos", "overflow"):
        if not torch.equal(getattr(plan_g, f).cpu(), getattr(plan_c, f)):
            raise AssertionError(f"plan {f} differs")
    if int(plan_c.overflow.sum()) != 0:
        raise AssertionError(f"plan overflow {plan_c.overflow.tolist()}")
    lab_g = gpu(pts).cpu().numpy()
    lab_c = cpu(pts).numpy()
    both = (lab_g >= 0) | (lab_c >= 0)
    agree = float((lab_g == lab_c)[both].mean())
    print(f"[check] plan bitwise equal on {len(plan_c.kmaps)} maps; label "
          f"agreement card vs CPU {agree:.5f}", flush=True)
    if not agree >= 0.99:
        raise AssertionError(f"label agreement {agree} < 0.99")
    return agree


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
    import triton  # noqa: F401  (the bn_act kernel's compiler)

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
                          VOXEL, probe.cap_in)
    plan = probe.builder(vox.coords, vox.mask)
    rows = kernel_checks(plan, torch.Generator().manual_seed(SEED + 7))

    stats = serve(model, pts, dev)
    for r in rows:
        r["launches"] = stats["launches"][r["name"]]
    print(f"[serve] p50 {stats['p50_ms']:.3f} ms per 100k-point request on "
          f"{card}; stages {stats['stages_ms']}", flush=True)
    agree = cross_check(model, dev)

    summary = {"card": card, "build_s": build_s,
               "total_s": time.perf_counter() - t_start,
               "serve": stats, "label_agreement_vs_cpu": agree}
    print("[summary] " + json.dumps(summary), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "max_rel_err", "tol_rel")
    entries = {}
    for r in rows:  # one entry per kernel; further shapes nest under it
        if r["name"] in entries:
            entries[r["name"]]["more_shapes"].append(
                {k: r[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by")})
        else:
            entries[r["name"]] = {**{k: r[k] for k in keys + extra},
                                  "more_shapes": []}
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
