"""The copy and gather cases of benchmarks/micro/micro_bisect.py (P4) on
the card.

 t1: the windowed async copy (`t1_dma:23`) on LG: per tile of TILE rows,
     the TILE rows at ws[t] = min(TILE t, N - WIN) (the TPU DMAs a WIN-row
     window and keeps its first TILE rows), bf16, seeded values;
 t2-t4b: the window gathers of `gather_case:54` on LE (sublane: out[t] =
     win[idx[t]], win [W, C]) and LF (lane: out[c, t] = win[c, idx[t]],
     win [C, W]), f32, with idx [W] and T = W.

Each case prints correct= (the result against numpy or torch indexing of
the same inputs on the CPU), its us per call (the wall of back-to-back
calls, the device's time under torch.profiler, and the device's time
with the L2 cache flushed before each call) and its rows per second on
device time.
"""

from __future__ import annotations

import numpy as np
import torch

from lidog_tpu_torch.ops.gather import (window_copy, window_lane_gather,
                                        window_row_gather)
from lidog_tpu_torch.probes.common import (device_line, flushed_device_ms,
                                          timed)
from lidog_tpu_torch.utils.device import resolve_device

# (name, W, T, C, lane) of the gather cases
CASES = (("t2 sublane W=256 T=256 C=128", 256, 256, 128, False),
         ("t3a sublane W=1024 C=128", 1024, 1024, 128, False),
         ("t3b sublane W=4096 C=128", 4096, 4096, 128, False),
         ("t4 lane W=256 C=128", 256, 256, 128, True),
         ("t4b lane W=2048 C=128", 2048, 2048, 128, True))


def t1_dma(dev, N=65_536, C=96, TILE=512, WIN=2048, iters=50):
    rng = np.random.default_rng(0)
    feats_cpu = torch.from_numpy(rng.standard_normal((N, C))).to(
        torch.bfloat16)
    ws_np = np.minimum(np.arange(N // TILE) * TILE, N - WIN).astype(np.int32)
    feats, ws = feats_cpu.to(dev), torch.from_numpy(ws_np).to(dev)
    rows = torch.from_numpy((ws_np[:, None].astype(np.int64)
                             + np.arange(TILE)).reshape(-1))
    ok = torch.equal(window_copy(feats, ws, TILE).cpu(), feats_cpu[rows])
    def lg():
        return window_copy(feats, ws, TILE)

    rows_dev = rows.to(dev)

    def lib():
        return torch.index_select(feats, 0, rows_dev)

    ms, dms = timed(lg, dev, iters)
    fms = flushed_device_ms(lg, dev, iters)
    ms_lib, dms_lib = timed(lib, dev, iters)
    fms_lib = flushed_device_ms(lib, dev, iters)
    print(f"t1 DMA-only (LG, N={N} TILE={TILE} WIN={WIN} bf16): "
          f"correct={ok}", flush=True)
    print(f"   {ms*1e3:.1f} us per call (device {dms*1e3:.2f} us, L2 flushed "
          f"{fms*1e3:.2f} us) -> {N/dms/1e3:.0f} M copied rows/s "
          f"(index_select {ms_lib*1e3:.1f} us, device {dms_lib*1e3:.2f} us, "
          f"L2 flushed {fms_lib*1e3:.2f} us)", flush=True)
    return {"name": "t1", "correct": ok, "ms": ms, "device_ms": dms,
            "flushed_device_ms": fms, "index_select_ms": ms_lib,
            "index_select_device_ms": dms_lib,
            "index_select_flushed_device_ms": fms_lib,
            "rows_per_s": N / dms * 1e3}


def gather_case(dev, name, W, T, C, lane=False, iters=50):
    rng = np.random.default_rng(0)
    wn = np.asarray(rng.standard_normal((C, W) if lane else (W, C)),
                    np.float32)
    idxn = rng.integers(0, W, W, dtype=np.int32)[:T]
    win, idx = torch.from_numpy(wn).to(dev), torch.from_numpy(idxn).to(dev)
    fn = window_lane_gather if lane else window_row_gather
    ok = np.array_equal(fn(win, idx).cpu().numpy(),
                        wn[:, idxn] if lane else wn[idxn])
    ms, dms = timed(lambda: fn(win, idx), dev, iters)
    fms = flushed_device_ms(lambda: fn(win, idx), dev, iters)
    print(f"{name} ({'LF' if lane else 'LE'}): correct={ok}", flush=True)
    print(f"   {ms*1e3:.1f} us per call (device {dms*1e3:.2f} us, L2 flushed "
          f"{fms*1e3:.2f} us) -> {W/dms/1e3:.0f} M gathered rows/s",
          flush=True)
    return {"name": name.split()[0], "correct": ok, "ms": ms,
            "device_ms": dms, "flushed_device_ms": fms,
            "rows_per_s": W / dms * 1e3}


def main(device=None, t1=None, cases=CASES, iters=50):
    """t1 and the gather cases on `device` (the card unless "cpu"); t1:
    keyword overrides of its shapes; cases: (name, W, T, C, lane)."""
    dev = resolve_device(device)
    print(device_line(dev), flush=True)
    rows = [t1_dma(dev, **{"iters": iters, **(t1 or {})})]
    rows += [gather_case(dev, *case, iters=iters) for case in cases]
    return {"cases": rows, "checks": {r["name"]: r["correct"] for r in rows}}


if __name__ == "__main__":
    main()
