"""Where the device time of one full-width serving request goes.

    python -m lidog_tpu_torch.profile_serve [--requests 3] [--sortless]

Runs Predictor(MinkUNet34, bf16) on one synthetic 100,000-point scan at the
serving caps (make_zcaps(98_304), voxel 0.05, grid_half 1024; seeded random
weights; --sortless: Predictor(sortless=True), which feeds the per-point
voxel cells straight into the plan), then traces `--requests` requests with
torch.profiler and prints, per request: wall ms, device busy ms and idle
share, device ms of this package's hand-written kernels (the three sparse
conv forwards and the fused norm) and of everything else; then the device
ms and launches of the stages alone (voxelize, or the raw cells, the
plan build and the labels) and the top device
kernels and kernel groups of the plan build.
Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import time


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def kernel_events(prof):
    """(name, self device us, count) of the device-side events."""
    out = []
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0 and getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            out.append((e.key, us, e.count))
    return sorted(out, key=lambda t: -t[1])


# device kernel name fragment -> the wrapper (launch counter) it belongs to
_GROUPS = (("zconv3_fwd_kernel", "zconv3_fwd"),
           ("DownMap", "zconv_down_fwd"), ("UpMap", "zconv_up_fwd"),
           ("bn_act_kernel", "bn_act"),
           ("zconv3_bwd_dx_kernel", "zconv3_bwd_dx"),
           ("zconv3_wgrad", "zconv3_wgrad"),
           ("DownWMap", "zconv_down_wgrad"), ("UpWMap", "zconv_up_wgrad"),
           ("NbrMap", "sparse_conv_fwd"), ("TransposeWMap", "sparse_conv_wgrad"),
           ("vox_", "voxelize"), ("label_gather_kernel", "label_gather"),
           ("bn_moments_kernel", "bn_train_fwd"),
           ("bn_bwd_", "bn_train_bwd"),
           ("scatter_max_bwd", "bev_scatter_max_bwd"),
           ("scatter_max_bf16", "bev_scatter_max"),
           ("scatter_max_f32", "bev_scatter_max"),
           ("in_stats_kernel", "instance_norm_fwd"),
           ("in_apply_kernel", "instance_norm_fwd"),
           ("in_bwd_", "instance_norm_bwd"),
           ("whiten_rows_kernel", "whitening_fwd"),
           ("whiten_finalize_kernel", "whitening_fwd"),
           ("whiten_bwd_kernel", "whitening_bwd"),
           ("full_fwd_kernel", "zconv_full_fwd"),
           ("full_wgrad", "zconv_full_wgrad"),
           ("stem_feat125_kernel", "stem_feat125"),
           ("sweep_kernel<2", "stem_conv9_packed"),
           ("sweep_kernel<1", "conv9_packed"),
           ("pos3_kernel", "pos3_lookup"),
           ("build_packed_kernel", "build_packed"),
           ("bit_stamp_kernel", "column_grid"),
           ("grid_rows_kernel", "column_grid"),
           ("stamp_kernel", "column_grid"), ("real_zero_kernel", "real_words"),
           ("real_bits_kernel", "real_words"),
           ("real_over_kernel", "real_words"),
           ("coarsen_kernel", "real_words"), ("aug_kernel", "assemble_aug"),
           ("scatter_rows_kernel", "emit_rows"),
           ("decode_kernel", "emit_rows"),
           ("FillFunctor", "fill (torch.zeros / full of new buffers)"),
           ("Memset", "memset (every cudaMemset; KI's and LC's zero-fills)"))


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other (plain torch)"


def print_groups(kernels, per: int, unit: str) -> None:
    """Device ms and launches per `unit` of each kernel group."""
    groups = {}
    for name, us, n in kernels:
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += us / 1e3 / per
        g[1] += n // per
    for g, (ms, n) in sorted(groups.items(), key=lambda t: -t[1][0]):
        print(f"[profile] {g}: {ms:.3f} ms device, {n} launches per {unit}")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    import torch

    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor
    from lidog_tpu_torch.train.device_pipeline import device_batch_raw

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--sortless", action="store_true",
                    help="profile the sortless Predictor")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    print(card_line())
    model = MinkUNet34(out_channels=7, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    pts = SyntheticLidarDataset(num_scans=1, points_per_scan=100_000,
                                radius=50.0, seed=0)[0]["points"][None]
    pred = Predictor(model, batch_size=1, voxel_size=0.05,
                     caps_per_scan=98_304, grid_half=1024,
                     sortless=args.sortless)
    pts_dev = torch.from_numpy(pts).cuda()
    for _ in range(2):
        pred(pts_dev)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            pred(pts_dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.requests
    kernels = kernel_events(prof)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / args.requests
    print(f"[profile] {'sortless ' if args.sortless else ''}per request: "
          f"wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    print_groups(kernels, args.requests, "request")

    # the stages alone: voxelize (K1: quantize, then kernel LC; sortless:
    # the raw per-point cells), the plan build (kernels KQ-KY) and the
    # labels (K15: kernel LD)
    stages = {}

    def alone(name, fn):
        with torch.profiler.profile(activities=acts) as p:
            out = fn()
            torch.cuda.synchronize()
        stages[name] = kernel_events(p)
        return out

    with torch.no_grad():
        flat = pts_dev.reshape(-1, 3)
        ones = torch.ones(flat.shape[0], dtype=torch.bool, device=flat.device)
        zeros = torch.zeros(flat.shape[0], dtype=torch.int32,
                            device=flat.device)
        if args.sortless:
            raw = alone("raw cells", lambda: device_batch_raw(
                pts_dev, ones[None], zeros[None], pred.voxel_size))
            coords, mask, vox = raw["coords"], raw["mask"], None
        else:
            vox = alone("voxelize", lambda: voxelize_device(
                flat, ones, zeros, pred.voxel_size, pred.cap_in,
                batch_size=1))
            coords, mask = vox.coords, vox.mask
        plan = alone("plan build", lambda: pred.builder(coords, mask))
        logits = pred.model(input_tensor(plan, mask[:, None].float()), plan)
        alone("labels", lambda: pred.labels_of(plan, logits, vox))
    for name, events in stages.items():
        print(f"[profile] {name}: "
              f"{sum(us for _, us, _ in events) / 1e3:.3f} ms device in "
              f"{sum(n for _, _, n in events)} kernel launches")
    print("[profile] plan build, top kernels:")
    for name, us, n in stages["plan build"][:12]:
        print(f"[profile]   {us / 1e3:8.3f} ms  x{n:4d}  {name[:110]}")
    print_groups(stages["plan build"], 1, "plan")

if __name__ == "__main__":
    main()
