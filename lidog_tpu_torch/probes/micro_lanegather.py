"""The chunked lane-gather probe of benchmarks/micro_lanegather.py (P5) on
the card, through LH (ops/gather.py lane_gather_sum).

out[c, l] = sum over r < REPS, in order, of win[c, 128 r + idx[c, 128 r +
l]]: REPS chunk gathers of [C, 128] lanes per call.  The probe prints the
time per chunk (the kernel's device time under torch.profiler over its
REPS chunks; the wall of back-to-back calls and the device time with the
L2 cache flushed before each call beside it) and what a
windowed conv would spend on such gathers at level-0 scale, (N / 128) x
K x (W / 128) chunks at N 393,216, K 27, for windows of W 1024 and 2048
rows.
"""

from __future__ import annotations

import numpy as np
import torch

from lidog_tpu_torch.ops.gather import lane_gather_sum
from lidog_tpu_torch.probes.common import (device_line, flushed_device_ms,
                                          timed)
from lidog_tpu_torch.utils.device import resolve_device

CONV_N, CONV_K = 393_216, 27
WINDOWS = (1024, 2048)


def main(device=None, C=96, REPS=64, iters=50):
    """LH on `device` (the card unless "cpu") at [C, 128 REPS]."""
    dev = resolve_device(device)
    print(device_line(dev), flush=True)
    rng = np.random.default_rng(0)
    wn = np.asarray(rng.standard_normal((C, 128 * REPS)), np.float32)
    ixn = rng.integers(0, 128, (C, 128 * REPS), dtype=np.int32)
    win, idx = torch.from_numpy(wn).to(dev), torch.from_numpy(ixn).to(dev)
    out = lane_gather_sum(win, idx).cpu().numpy()
    # the sum in the same order in numpy: bitwise equal
    want = np.zeros((C, 128), np.float32)
    for r in range(REPS):
        sl = slice(r * 128, (r + 1) * 128)
        want += np.take_along_axis(wn[:, sl], ixn[:, sl], 1)
    err = float(np.abs(out - want).max())
    ok = np.array_equal(out, want)
    ms, dms = timed(lambda: lane_gather_sum(win, idx), dev, iters)
    fms = flushed_device_ms(lambda: lane_gather_sum(win, idx), dev, iters)
    t_chunk = dms / 1e3 / REPS
    print(f"lane-gather chunk [{C},128] (LH): {t_chunk*1e9:7.1f} ns/chunk "
          f"(kernel {dms*1e3:.2f} us device, L2 flushed {fms*1e3:.2f} us, "
          f"{ms*1e3:.1f} us per call, REPS={REPS}, max_err={err:.1e}), "
          f"correct={ok}", flush=True)
    est = {}
    for w in WINDOWS:
        est[w] = (CONV_N / 128) * CONV_K * (w / 128) * t_chunk * 1e3
        print(f"  windowed-conv gather estimate at W={w}: {est[w]:7.1f} ms",
              flush=True)
    return {"ns_per_chunk": t_chunk * 1e9, "ms": ms, "device_ms": dms,
            "flushed_device_ms": fms,
            "max_err": err, "conv_estimate_ms": est, "checks": {"p5": ok}}


if __name__ == "__main__":
    main()
