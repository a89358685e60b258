"""The gather probes of benchmarks/micro/micro_gather.py on the card.

Q1: device-memory row-gather cost by row width (64 to 640 bytes), random
    and near-sorted indices.  lidog_tpu's Q1 is an XLA gather outside
    Pallas, so plain torch indexing is its counterpart here.
Q2: the window gathers of P1 (`q2_pallas_vmem_gather:71`) on LE (axis 0;
    the TPU's index in SMEM or in VMEM is one kernel here) and LF (axis 1,
    the transposed window), each beside the PyTorch call for the same
    gather (index_select, gather): the port's window gathers against
    PyTorch's, both reading the window from device memory (L2-resident
    after the first call).
Q3: P2's 27-tap windowed conv (`q3_windowed_vs_xla:155`) on LA
    (ops/sparse_conv.py sparse_conv_fwd) against the per-offset gather +
    matmul reference (sparse_conv_plain).

Each time is printed twice: ms, the wall of back-to-back calls (on a card
the host's launch overhead bounds it for short kernels), and device ms,
the kernels' own time (torch.profiler); rates (ns per row, GB/s, TFLOPS)
are taken on device ms.  GB/s counts the gathered rows once (the output's
bytes), as the JAX script does.  Q2's window stays in L2 between
back-to-back calls, so Q2 also gives the device time with the L2 cache
flushed before each call (Q1's tables, 256 MB to 2.56 GB, exceed it).
"""

from __future__ import annotations

import numpy as np
import torch

from lidog_tpu_torch.ops.gather import window_lane_gather, window_row_gather
from lidog_tpu_torch.ops.sparse_conv import sparse_conv_fwd, sparse_conv_plain
from lidog_tpu_torch.probes.common import (device_line, flushed_device_ms,
                                          timed)
from lidog_tpu_torch.utils.device import resolve_device

# (row bytes, columns, dtype) of Q1's tables
Q1_WIDTHS = ((64, 16, torch.float32), (64, 32, torch.bfloat16),
             (192, 48, torch.float32), (192, 96, torch.bfloat16),
             (384, 96, torch.float32), (640, 160, torch.float32))
# bf16 LA against its plain version, relative to max |plain| (chip_smoke's
# bound for the bf16 gather-GEMMs: both sum in f32, in other orders)
Q3_TOL = 1e-2


def q1_row_width(dev, n_rows=4_000_000, n_q=400_000, iters=20):
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, n_rows, n_q, dtype=np.int32))
    # near-sorted indices (sorted + small jitter), like canonical-order maps
    idx_sorted = torch.from_numpy(np.clip(
        np.sort(rng.integers(0, n_rows, n_q)).astype(np.int32)
        + rng.integers(-64, 64, n_q), 0, n_rows - 1).astype(np.int32))
    idx, idx_sorted = idx.long().to(dev), idx_sorted.long().to(dev)
    rows = []
    for width_bytes, cols, dtype in Q1_WIDTHS:
        t = torch.zeros(n_rows, cols, dtype=dtype, device=dev)
        ms, dms = timed(lambda: t[idx], dev, iters)
        ms_s, dms_s = timed(lambda: t[idx_sorted], dev, iters)
        del t
        row = {"width_bytes": width_bytes, "dtype": str(dtype).split(".")[-1],
               "random_ms": ms, "random_device_ms": dms,
               "ns_per_row": dms / n_q * 1e6,
               "random_gbs": n_q * width_bytes / dms / 1e6,
               "sorted_ms": ms_s, "sorted_device_ms": dms_s,
               "sorted_gbs": n_q * width_bytes / dms_s / 1e6}
        rows.append(row)
        print(f"Q1 gather {width_bytes:4d}B x {n_q/1e3:.0f}k rows: "
              f"random {ms:7.3f} ms, device {dms:7.4f} ms "
              f"({row['ns_per_row']:6.3f} ns/row, {row['random_gbs']:6.1f} "
              f"GB/s)  sorted {ms_s:7.3f} ms, device {dms_s:7.4f} ms "
              f"({row['sorted_gbs']:6.1f} GB/s)", flush=True)
    return rows


def q2_window_gather(dev, W=2048, T=512, C=96, iters=50):
    rng = np.random.default_rng(0)
    win_np = np.asarray(rng.standard_normal((W, C)), np.float32)
    idx_np = rng.integers(0, W, T, dtype=np.int32)
    win = torch.from_numpy(win_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    idx64 = idx.long()
    win_t = win.T.contiguous()
    out = {}
    for label in ("idx in SMEM", "idx in VMEM"):  # one kernel here
        ok = np.array_equal(window_row_gather(win, idx).cpu().numpy(),
                            win_np[idx_np])
        out[f"axis0 ({label})"] = ok
        print(f"Q2 LE window gather axis=0 (take, {label}): ok={ok}",
              flush=True)
    ok = np.array_equal(window_lane_gather(win_t, idx).cpu().numpy(),
                        win_np.T[:, idx_np])
    out["axis1"] = ok
    print(f"Q2 LF window lane-gather axis=1 (take_along_axis): ok={ok}",
          flush=True)
    idx_t = idx64[None].expand(C, -1)
    calls = {"le": lambda: window_row_gather(win, idx),
             "index_select": lambda: torch.index_select(win, 0, idx64),
             "lf": lambda: window_lane_gather(win_t, idx),
             "gather": lambda: torch.gather(win_t, 1, idx_t)}
    ms = {}
    for k, fn in calls.items():
        ms[k + "_ms"], ms[k + "_device_ms"] = timed(fn, dev, iters)
        ms[k + "_flushed_device_ms"] = flushed_device_ms(fn, dev, iters)
    print(f"Q2 the port's window gathers against PyTorch's: [{W}, {C}] f32 "
          f"window, {T} rows, us (device us): LE "
          f"{ms['le_ms']*1e3:.1f} ({ms['le_device_ms']*1e3:.2f}) vs "
          f"index_select {ms['index_select_ms']*1e3:.1f} "
          f"({ms['index_select_device_ms']*1e3:.2f}); LF {ms['lf_ms']*1e3:.1f}"
          f" ({ms['lf_device_ms']*1e3:.2f}) vs gather "
          f"{ms['gather_ms']*1e3:.1f} ({ms['gather_device_ms']*1e3:.2f})",
          flush=True)
    print(f"Q2 the same, L2 flushed before each call, device us: LE "
          f"{ms['le_flushed_device_ms']*1e3:.2f} vs index_select "
          f"{ms['index_select_flushed_device_ms']*1e3:.2f}; LF "
          f"{ms['lf_flushed_device_ms']*1e3:.2f} vs gather "
          f"{ms['gather_flushed_device_ms']*1e3:.2f}", flush=True)
    return {"checks": out, **ms}


def q3_windowed_conv(dev, N=393_216, C=96, K=27, TILE=1024, WIN=4096,
                     iters=5):
    """out[i] = sum_k W_k @ feats[nbr[k, i]] at level-0 scale."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((N, C))).to(
        dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((K, C, C)) * 0.05).to(
        dev, torch.bfloat16)
    # synthetic monotone-ish nbr: nbr[k, i] ~ i + jitter (within window)
    base = np.arange(N, dtype=np.int64)
    nbr = np.stack([np.clip(base + rng.integers(-WIN // 4, WIN // 4, N), 0,
                            N - 1) for _ in range(K)]).astype(np.int32)
    nbr[:, :N // 100] = -1  # some misses
    # the window each tile of TILE rows would stage (P2's), and the map
    # restricted to the entries inside it
    n_tiles = N // TILE
    win_start = np.minimum(np.maximum(nbr[:, ::TILE].min(axis=0) - 64, 0),
                           N - WIN)
    lidx = nbr - win_start[np.repeat(np.arange(n_tiles), TILE)][None, :]
    visible = (nbr >= 0) & (lidx >= 0) & (lidx < WIN)
    nbr_eff = torch.from_numpy(np.where(visible, nbr, -1).astype(np.int32)) \
        .to(dev)
    nbr = torch.from_numpy(nbr).to(dev)
    flops = 2 * N * K * C * C
    ms_ref, dms_ref = timed(lambda: sparse_conv_plain(feats, nbr, w), dev,
                            iters)
    print(f"Q3 plain gather-GEMM (per-offset gather + matmul): "
          f"{ms_ref:.2f} ms, device {dms_ref:.2f} ms "
          f"({flops/dms_ref/1e9:.1f} TFLOPS effective)", flush=True)
    got = sparse_conv_fwd(feats, nbr_eff, w).float()
    want = sparse_conv_plain(feats, nbr_eff, w).float()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    ms, dms = timed(lambda: sparse_conv_fwd(feats, nbr_eff, w), dev, iters)
    ok = rel <= Q3_TOL
    print(f"Q3 LA gather-GEMM (window-visible map): {ms:.3f} ms, device "
          f"{dms:.3f} ms ({flops/dms/1e9:.1f} TFLOPS effective), "
          f"max_err={err:.3f} (relative {rel:.2e}, bound {Q3_TOL}), speedup "
          f"{dms_ref/dms:.2f}x, ok={ok}", flush=True)
    return {"checks": {"q3": ok}, "plain_ms": ms_ref,
            "plain_device_ms": dms_ref, "la_ms": ms, "la_device_ms": dms,
            "max_err": err, "max_rel_err": rel}


def main(device=None, q1=None, q2=None, q3=None):
    """Q1-Q3 on `device` (the card unless "cpu"); q1, q2, q3: keyword
    overrides of each probe's shapes and iterations."""
    dev = resolve_device(device)
    print(device_line(dev), flush=True)
    rows = q1_row_width(dev, **(q1 or {}))
    r2 = q2_window_gather(dev, **(q2 or {}))
    r3 = q3_windowed_conv(dev, **(q3 or {}))
    checks = {**{f"q2 {k}": v for k, v in r2.pop("checks").items()},
              **r3.pop("checks")}
    return {"q1": rows, "q2": r2, "q3": r3, "checks": checks}


if __name__ == "__main__":
    main()
