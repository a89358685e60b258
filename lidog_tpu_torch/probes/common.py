"""What the probes share: the device line they print first and the
timing of one call, with the L2 cache warm or flushed."""

from __future__ import annotations

import subprocess
import time

import torch

# the bytes written between two calls to flush the L2 cache (an H100's is
# 50 MB)
FLUSH_BYTES = 256 << 20


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    CPU (where every kernel wrapper runs its plain version)."""
    if dev.type != "cuda":
        return "device: cpu (the kernels' plain versions; no device metric)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return "device: " + out.strip().splitlines()[0].strip()


def timed(fn, dev: torch.device, iters: int):
    """(ms, device ms) per call of fn() over iters calls after one
    warm-up.  ms: on a card CUDA events around back-to-back calls (the
    host's launch overhead bounds it for short kernels), on the CPU the
    host clock.  device ms: on a card the device time of the kernels fn()
    launches (torch.profiler over another iters calls), the rates' basis;
    where the profiler returns no device event twice, ms again, with the
    reason printed; on the CPU ms again."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
        return ms, ms
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    for _ in range(2):
        dms = _device_ms(fn, iters)
        if dms > 0:
            return ms, dms
    print("device time not measured: the profiler returned no device "
          "event; CUDA events' ms stands in", flush=True)
    return ms, ms


def flushed_device_ms(fn, dev: torch.device, iters: int) -> float:
    """Device ms per call of fn() with the L2 cache flushed before each
    call: FLUSH_BYTES written between calls, and only the kernels that
    fn() launches alone summed (torch.profiler).  On the CPU the host
    clock, as timed.  NaN, with the reason printed, where the profiler
    loses fn()'s kernels (a timing, not a check: nothing fails on it)."""
    if dev.type != "cuda":
        return timed(fn, dev, iters)[1]
    own = set(_events(fn, iters))  # the names of fn()'s kernels
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def call():
        buf.fill_(1.0)
        fn()

    events = _events(call, iters)
    if not own or not own <= set(events):
        print(f"L2-flushed time not measured: the profiler saw {sorted(own)} "
              f"alone and {sorted(events)} behind the flush", flush=True)
        return float("nan")
    return sum(events[name] for name in own) / iters / 1e3


def _events(fn, iters=1):
    """kernel_events of iters calls of fn() under torch.profiler."""
    from lidog_tpu_torch.profile_serve import kernel_events

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {name: us for name, us, _ in kernel_events(prof)}


def _device_ms(fn, iters):
    """The device ms per call of the kernels fn() launches."""
    return sum(_events(fn, iters).values()) / iters / 1e3
