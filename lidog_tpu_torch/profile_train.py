"""Where the device time of one full-width training step goes.

    python -m lidog_tpu_torch.profile_train [--steps 3]

Runs the training step of bench.py's shapes (MinkUNet34 bf16 with seeded
random weights; 4 synthetic scans x 100,000 points, voxel 0.05, the
per-scan plan caps of bench.py:40-44, grid_half 1024; SoftDICE + Adam lr
1e-3: voxelize, plan, forward, backward, update), then traces `--steps`
steps with torch.profiler and prints, per step: wall ms, device busy ms and
idle share, and the device ms and launches of each hand-written kernel and
of everything else.  Needs a CUDA card; prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    import numpy as np
    import torch

    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset
    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.profile_serve import (_kernel_events, card_line,
                                               print_groups)
    from lidog_tpu_torch.train.device_pipeline import device_batch_from_points
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState, make_train_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    print(card_line())
    ds = SyntheticLidarDataset(num_scans=4, points_per_scan=100_000,
                               radius=50.0, seed=0)
    scans = [ds[i] for i in range(4)]
    pts = torch.from_numpy(np.stack([d["points"] for d in scans])).cuda()
    labels = torch.from_numpy(np.stack([d["sem_labels"] for d in scans])
                              .astype(np.int32)).cuda()
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    model = MinkUNet34(out_channels=7, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer("Adam", lr=1e-3))
    builder = ZSegPlanBuilder((92_160, 61_440, 22_528, 9_216, 3_584),
                              (122_880, 77_824, 25_600, 10_752, 4_352),
                              num_batches=4, grid_half=1024,
                              caps_col_dil=(196_608, 93_184, 54_272, 23_552,
                                            9_728))
    step = make_train_step(SoftDICELoss(ignore_label=-1), num_classes=7)

    def full_step():
        batch = device_batch_from_points(pts, valid, labels, 0.05, 393_216)
        step(state, batch, builder(batch["coords"], batch["mask"]))

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
    print(f"[profile] per step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    print_groups(kernels, args.steps, "step")
    print("[profile] top device kernels per step:")
    for name, us, n in kernels[:15]:
        print(f"[profile]   {us / 1e3 / args.steps:8.3f} ms  "
              f"x{n // args.steps:5d}  {name[:110]}")


if __name__ == "__main__":
    main()
