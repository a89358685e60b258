"""Where the device time of one full-width training step goes.

    python -m lidog_tpu_torch.profile_train [--steps 3]
        [--lidog | --robustnet | --ibn | --generic] [--in-channels N]
        [--sortless]

Runs the training step of bench.py's shapes (MinkUNet34 bf16 with seeded
random weights; 4 synthetic scans x 100,000 points, voxel 0.05, the
per-scan plan caps of bench.py:40-44, grid_half 1024; SoftDICE + Adam lr
1e-3: voxelize, plan, forward, backward, update), or with --lidog the LiDOG
step of bench_lidog.py's shapes (MinkUNet34BEV bf16; the same scans through
the host BEV preprocessing with 167^2 labels at level block8, collated to
393,216 rows; plan, forward with the pooled BEV scatter and Encoder2D,
SoftDICE + DICE, backward, Adam), with --robustnet the RobustNet step
(MinkUNet34Robust bf16 on the training step's batch; SoftDICE + 0.5 IW over
its 5 instance-normed taps, the gate on from the first step) or with --ibn
the IBN step (MinkUNet34IBN bf16, SoftDICE). --in-channels N (2 to 4) gives
the model N input channels, the points' (x, y, z) and a remission drawn
from the seed: the plan then carries the stem's source-row maps (kernel KQ)
and the stem runs as KO/KP. --sortless feeds the per-point voxel cells
straight into the plan (device_batch_raw, assume_unique=False) instead of
voxelizing. --generic runs the step on the generic plan: the batch at the
pooled caps make_caps(4) (524,288 input rows), no plan given, so the step
builds the batch's UNetPlan (plain torch) and every conv is LA / LB (the
stem KO / KP). Then it traces `--steps` steps with torch.profiler and prints,
per step: wall ms, device busy ms and idle share, and the device ms and
launches of each hand-written kernel and of everything else; then those of
one batch (voxelize; the raw cells with --sortless) and one plan build
alone, with the plan build's kernel groups. Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import time

# bench.py's per-scan (caps_real, caps_aug, caps_col_dil)
CAPS = ((92_160, 61_440, 22_528, 9_216, 3_584),
        (122_880, 77_824, 25_600, 10_752, 4_352),
        (196_608, 93_184, 54_272, 23_552, 9_728))


def _train_step(scans, builder, variant="source", in_channels=1,
                sortless=False):
    """bench.py's step as a closure, with MinkUNet34 or (variant "ibn")
    MinkUNet34IBN, or (variant "robustnet") the RobustNet step, or
    (variant "generic") MinkUNet34 on the generic plan; the builder must
    match in_channels and sortless (generic: it is not called by the
    step)."""
    import numpy as np
    import torch

    from lidog_tpu_torch.caps import make_caps
    from lidog_tpu_torch.data.synthetic import point_features
    from lidog_tpu_torch.losses.losses import IWLoss, SoftDICELoss
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.models.minkunet_ibn import MinkUNet34IBN
    from lidog_tpu_torch.models.minkunet_robustnet import MinkUNet34Robust
    from lidog_tpu_torch.train.device_pipeline import (
        device_batch_from_points, device_batch_raw)
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.robustnet_step import make_robustnet_train_step
    from lidog_tpu_torch.train.train_step import TrainState, make_train_step

    pts = torch.from_numpy(np.stack([d["points"] for d in scans])).cuda()
    labels = torch.from_numpy(np.stack([d["sem_labels"] for d in scans])
                              .astype(np.int32)).cuda()
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    feats = None
    if in_channels != 1:
        feats = torch.from_numpy(point_features(pts.cpu().numpy(),
                                                in_channels)).cuda()
    cls = {"source": MinkUNet34, "ibn": MinkUNet34IBN, "generic": MinkUNet34,
           "robustnet": MinkUNet34Robust}[variant]
    model = cls(out_channels=7, compute_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0),
                in_channels=in_channels)
    state = TrainState.create(model, make_optimizer("Adam", lr=1e-3))
    crit = SoftDICELoss(ignore_label=-1)
    generic = variant == "generic"
    caps = make_caps(len(scans)) if generic else None
    step = (make_robustnet_train_step(crit, IWLoss(), num_classes=7,
                                      cov_stat_epoch=0)
            if variant == "robustnet" else make_train_step(crit,
                                                           num_classes=7,
                                                           caps=caps))

    def make_batch():
        if sortless:
            return device_batch_raw(pts, valid, labels, 0.05, feats)
        return device_batch_from_points(pts, valid, labels, 0.05,
                                        caps[0] if generic else 393_216,
                                        feats)

    def full_step():
        batch = make_batch()
        if generic:
            step(state, batch)  # builds the batch's UNetPlan itself
        else:
            step(state, batch, builder(batch["coords"], batch["mask"]))

    return full_step, make_batch


def _lidog_step(scans, builder):
    """bench_lidog.py's step as a closure (the host BEV preprocessing is
    input, made once)."""
    import torch

    from lidog_tpu_torch.data.bev import collate_bev, preprocess_scan_bev
    from lidog_tpu_torch.losses.losses import DICELoss, SoftDICELoss
    from lidog_tpu_torch.models.minkunet_bev import MinkUNet34BEV
    from lidog_tpu_torch.train.lidog_step import make_lidog_train_step
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState

    samples = [preprocess_scan_bev(d["points"], d["sem_labels"],
                                   voxel_size=0.05, bound_2d=50.0, sub_p=1.0,
                                   train=False, bev_img_sizes={"block8": 167})
               for d in scans]
    arrays = collate_bev(samples, 393_216)
    arrays.pop("dropped")
    batch = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    model = MinkUNet34BEV(out_channels=7, num_batches=len(scans),
                          voxel_size=0.05, bound_2d=50.0,
                          compute_dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer("Adam", lr=1e-3))
    step = make_lidog_train_step(SoftDICELoss(ignore_label=-1),
                                 DICELoss(ignore_label=-1), num_classes=7)

    def full_step():
        step(state, batch, builder(batch["coords"], batch["mask"]))

    return full_step, lambda: batch


def main(argv=None):
    import torch

    from lidog_tpu_torch.caps import make_caps, plan_builder
    from lidog_tpu_torch.core.plan import build_unet_plan
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset
    from lidog_tpu_torch.profile_serve import (_kernel_events, card_line,
                                               print_groups)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    paths = ap.add_mutually_exclusive_group()
    paths.add_argument("--lidog", action="store_true",
                       help="profile the LiDOG step (MinkUNet34BEV)")
    paths.add_argument("--robustnet", action="store_true",
                       help="profile the RobustNet step (MinkUNet34Robust)")
    paths.add_argument("--ibn", action="store_true",
                       help="profile the IBN step (MinkUNet34IBN)")
    paths.add_argument("--generic", action="store_true",
                       help="profile the step on the generic UNetPlan")
    ap.add_argument("--in-channels", type=int, default=1,
                    help="input channels of the model (the general stem)")
    ap.add_argument("--sortless", action="store_true",
                    help="sortless input (device_batch_raw)")
    args = ap.parse_args(argv)
    if (args.lidog or args.generic) and (args.in_channels != 1
                                         or args.sortless):
        ap.error("--lidog and --generic take neither --in-channels nor "
                 "--sortless")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    print(card_line())
    ds = SyntheticLidarDataset(num_scans=4, points_per_scan=100_000,
                               radius=50.0, seed=0)
    scans = [ds[i] for i in range(4)]
    builder = plan_builder(args.in_channels, 4, CAPS,
                           assume_unique=not args.sortless)
    variant = ("lidog" if args.lidog else "robustnet" if args.robustnet
               else "ibn" if args.ibn else "generic" if args.generic
               else "source")
    if args.generic:  # the plan build the generic step makes
        def builder(coords, mask):
            return build_unet_plan(coords, mask, make_caps(4))
    full_step, make_batch = (
        _lidog_step(scans, builder) if args.lidog
        else _train_step(scans, builder, variant, args.in_channels,
                         args.sortless))

    for _ in range(2):
        full_step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            full_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = _kernel_events(prof)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / args.steps
    if args.in_channels != 1:
        variant += f" in_channels={args.in_channels}"
    if args.sortless:
        variant += " sortless"
    print(f"[profile] {variant} per step: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    print_groups(kernels, args.steps, "step")
    print("[profile] top device kernels per step:")
    for name, us, n in kernels[:15]:
        print(f"[profile]   {us / 1e3 / args.steps:8.3f} ms  "
              f"x{n // args.steps:5d}  {name[:110]}")
    batch = {}

    def batch_alone():
        batch.update(make_batch())

    for name, fn in (("batch", batch_alone),
                     ("plan build", lambda: builder(batch["coords"],
                                                    batch["mask"]))):
        with torch.profiler.profile(activities=acts) as prof_stage:
            fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof_stage)
        print(f"[profile] {name} alone: "
              f"{sum(us for _, us, _ in events) / 1e3:.3f} ms device in "
              f"{sum(n for _, _, n in events)} kernel launches")
    print_groups(events, 1, "plan")  # the plan build's kernel groups


if __name__ == "__main__":
    main()
