"""Probes and ablations of LiDOG's pooled BEV scatter-max (KI, KJ;
csrc/bev_scatter_max.cu).

    python -m lidog_tpu_torch.ablate_bev --probe
    python -m lidog_tpu_torch.ablate_bev --count
    python -m lidog_tpu_torch.ablate_bev

`--probe` compiles, each in a file of its own, a one-line kernel for every
form of the bf16 max reduction of PTX (`red.global.max.noftz` on
`.v4.bf16x2`, `.v2.bf16x2`, `.v8.bf16`, `.v2.bf16`, the scalar `.bf16x2`,
and `.v4.bf16x2` with `.relaxed.gpu` spelt out; `red.global.max` on
`.v4.f32` and `.v2.f32`, and on `.s32` (KI's f32 form), `.v4.s32`,
`.v2.s32` and `.v4.u32` of f32 bits), prints which of them the toolkit
assembles for sm_90a, and runs each that does on seeded values (4 to 16
bytes a thread into a few cells) against torch's amax; then again with
every 7th thread's values a +NaN, and with them a -NaN, and gives the
share of cells that end NaN (every cell receives one): whether the
reduction could carry lidog_tpu's NaN (ROADMAP queue 3 item 6).

`--count` builds csrc/bev_scatter_max.cu with -DBEV_COUNT_REDUCTIONS,
runs KI once at chip_smoke phase 8's shapes, bf16 and f32, and prints its
device counts, the chunks flushed and the reduction instructions issued,
beside the live (row, candidate) pairs and the chunks a row, and the
cells that `held_flushes` (the source's holding rule, in torch) gives a
chunk; it fails unless chunks flushed = those cells x the chunks a row.

Without it: builds, beside this checkout's own, variants of
csrc/bev_scatter_max.cu made by text substitutions (KI's runs of 1 row,
which holds no cell across rows; bf16 runs of 2 and 8 rows instead of 4,
f32 runs of 4 and 16 instead of 8; tiles of 128 and 512 rows instead of
256; KI's next task loaded during the walk instead of after it; KJ's
tasks two at a time, unrolled, instead of one; KJ's candidates walked
in a loop instead of unrolled; the zero fill by a kernel of one
16-byte store a thread, or of 16-byte stores in a grid-stride loop over 4
blocks a SM, instead of cudaMemsetAsync; and, as diagnostics whose results are
wrong and not checked, KI without its reductions, KI with its loads
alone, KI and KJ with their geometry alone, KJ without its gathers of out
and dout), holds each other one's KI equal to
the plain version and its KJ within 1 ulp, and times KI and KJ through
their C entry points (CUDA events, ms per call, mean of 10 after a
warm-up, as chip_smoke's `cuda_ms`) at chip_smoke phase 8's shapes (the
training plan's level 0 x 96 -> 4 x 666^2, ReLU-like seeded features),
bf16 and f32, every variant twice, in the order first to last, then last
to first.  Prints the card's name and power limit, then one JSON line.
Needs a CUDA card and nvcc.  The variants are exact text substitutions:
`build` fails, naming the variant, when the source no longer holds one.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

# PTX of each probed form: (instruction, operands, register kind: "r"
# 32-bit words of bf16 pairs, "h" 16-bit halves, "f" f32, "s" the bits of
# f32 values >= +0 as 32-bit integers)
FORMS = {
    "v4.bf16x2": ("red.global.max.noftz.v4.bf16x2", 4, "r"),
    "v2.bf16x2": ("red.global.max.noftz.v2.bf16x2", 2, "r"),
    "v8.bf16": ("red.global.max.noftz.v8.bf16", 8, "h"),
    "v2.bf16": ("red.global.max.noftz.v2.bf16", 2, "h"),
    "bf16x2": ("red.global.max.noftz.bf16x2", 1, "r"),
    "s32": ("red.global.max.s32", 1, "s"),
    "relaxed.gpu v4.bf16x2": ("red.relaxed.gpu.global.max.noftz.v4.bf16x2",
                              4, "r"),
    "v4.f32": ("red.global.max.v4.f32", 4, "f"),
    "v2.f32": ("red.global.max.v2.f32", 2, "f"),
    "v4.s32": ("red.global.max.v4.s32", 4, "s"),
    "v2.s32": ("red.global.max.v2.s32", 2, "s"),
    "v4.u32": ("red.global.max.v4.u32", 4, "s"),
}


_RUN = "constexpr int RUN_ROWS_BF16 = 4;"
_RUN32 = "constexpr int RUN_ROWS_F32 = 8;"
_FILL_CALL = ("cudaError_t err = cudaMemsetAsync(out, 0, (size_t)nb * out_hw "
              "* out_hw * c * esz, s);")
_NS_END = "}  // namespace\n\n// KI."
_FILL = """
__global__ void fill_kernel(uint4* p, size_t n16, int per) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < per && i < n16; ++k, i += step) p[i] = make_uint4(0, 0, 0, 0);
}

cudaError_t fill(void* out, size_t bytes, cudaStream_t s) {
  if (bytes % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaMemsetAsync(out, 0, bytes, s);
  const size_t n16 = bytes / 16;
  const int per = PER;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const size_t blocks = per == 1 ? (n16 + 255) / 256 : (size_t)sms * 4;
  const int rounds = per == 1 ? 1 : (int)((n16 + blocks * 256 - 1) / (blocks * 256));
  fill_kernel<<<(unsigned)blocks, 256, 0, s>>>(static_cast<uint4*>(out), n16, rounds);
  return cudaGetLastError();
}
"""


def _fill_variant(per: str):
    return [(_NS_END, _FILL.replace("PER", per) + "\n" + _NS_END),
            (_FILL_CALL, "cudaError_t err = fill(out, (size_t)nb * out_hw * "
                         "out_hw * c * esz, s);")]


_KJ_SWITCH = ("switch (g.cands > MAX_CANDS ? 0 : g.cands) {\n    case 1:\n"
              "      scatter_max_bwd_kernel")
_TILE = "constexpr int TILE = 256;"
VARIANTS = {
    "as built": [],
    "runs of 1 row (no cell held)": [
        (_RUN, "constexpr int RUN_ROWS_BF16 = 1;"),
        (_RUN32, "constexpr int RUN_ROWS_F32 = 1;")],
    "bf16 runs of 2 rows": [(_RUN, "constexpr int RUN_ROWS_BF16 = 2;")],
    "bf16 runs of 8 rows": [(_RUN, "constexpr int RUN_ROWS_BF16 = 8;")],
    "f32 runs of 4 rows": [(_RUN32, "constexpr int RUN_ROWS_F32 = 4;")],
    "f32 runs of 16 rows": [(_RUN32, "constexpr int RUN_ROWS_F32 = 16;")],
    "tiles of 128 rows": [(_TILE, "constexpr int TILE = 128;")],
    "tiles of 512 rows": [(_TILE, "constexpr int TILE = 512;")],
    "KJ candidates in a loop": [
        (_KJ_SWITCH, _KJ_SWITCH.replace("g.cands > MAX_CANDS ? 0 : g.cands",
                                        "0"))],
    "fill kernel, one 16-byte store a thread": _fill_variant("1"),
    "fill kernel, 4 blocks a SM": _fill_variant("0"),
    # diagnostics: wrong results, not checked
    "KI without reductions": [
        ('"r"((uint32_t)(on && nonzero(v)))',
         '"r"((uint32_t)(on && v.w[0] == 0x12345u))'),
        ('"r"((uint32_t)(on && v.w[i] != 0u))',
         '"r"((uint32_t)(on && v.w[i] == 0x12345u))')],
    "KI loads only": [
        ("    int held[K];  // the cell of each slot, or -1",
         "    { uint32_t x = 0; for (int i = 0; i < R; ++i) x ^= v[i].w[0] ^ "
         "v[i].w[W - 1]; if (x == 0x9E3779B9u) out[0] = x; continue; }\n"
         "    int held[K];  // the cell of each slot, or -1")],
    "KI with the next task's loads in flight": [
        ("  __syncthreads();\n  for (int t = threadIdx.x; t < s.tasks; t += TILE) {",
         "  __syncthreads();\n  Chunk<W> v[R];\n  if (threadIdx.x < s.tasks) "
         "load_run<BF16>(v, feats, slot, row0, threadIdx.x, s.chunks, words);\n"
         "  for (int t = threadIdx.x; t < s.tasks; t += TILE) {"),
        ("    Chunk<W> v[R];\n    load_run<BF16>(v, feats, slot, row0, t, "
         "s.chunks, words);\n",
         "    Chunk<W> next[R];\n    if (t + TILE < s.tasks) load_run<BF16>("
         "next, feats, slot, row0, t + TILE, s.chunks, words);\n"),
        ("      flush<BF16>(out + (size_t)(unsigned)held[k] * words + col, hv[k], "
         "held[k] >= 0);\n  }\n}",
         "      flush<BF16>(out + (size_t)(unsigned)held[k] * words + col, hv[k], "
         "held[k] >= 0);\n#pragma unroll\n    for (int i = 0; i < R; ++i) v[i] = "
         "next[i];\n  }\n}")],
    "KJ two tasks unrolled": [("#pragma unroll 1\n  for (int t",
                               "#pragma unroll 2\n  for (int t")],
    "KI geometry only": [
        ("  __syncthreads();\n  for (int t = threadIdx.x; t < s.tasks; t += TILE) {",
         "  __syncthreads();\n  if (slot[threadIdx.x] != 0x7FFFFFFF) return;\n"
         "  for (int t = threadIdx.x; t < s.tasks; t += TILE) {")],
    "KJ geometry only": [
        ("  const int tasks = n - row0 >= TILE ? s.tasks : (n - row0) * s.chunks;",
         "  const int tasks = geo[0].w == 0x7FFFFFFF ? s.tasks : 0;")],
    "KJ without gathers": [
        ("            o[j] = load<W>(out + at);\n            d[j] = load<W>(dout + at);",
         "            o[j] = load<W>(out + col);\n            d[j] = load<W>(dout + col);")],
}
DIAGNOSTIC = ("KI without reductions", "KI loads only", "KI geometry only",
              "KJ geometry only", "KJ without gathers")


def build(out: Path):
    """Every variant's library, built in parallel; returns {variant: lib}."""
    from lidog_tpu_torch.ops import _cuda

    nvcc, procs = _cuda._nvcc(), {}
    src = (_cuda.CSRC / "bev_scatter_max.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"ablate_bev: {name}: {a!r} is not in "
                                 "bev_scatter_max.cu")
            text = text.replace(a, b)
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(so),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0].decode()
        if p.returncode != 0:
            raise SystemExit(f"ablate_bev: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("bev_scatter_max_fwd", "bev_scatter_max_bwd"):
            getattr(lib, fn).argtypes = _cuda._ARGTYPES[fn]
        libs[name] = lib
    return libs


def forms(dev):
    """(label, dtype, feats, coords, mask, geom, out, dout) of chip_smoke
    phase 8's shapes, bf16 and f32; out is the plain forward."""
    import torch

    import chip_smoke as cs
    from lidog_tpu_torch.ops import bev

    pts, labels = cs.train_data()
    batch = cs.train_batch(pts, labels, dev)
    l0 = cs.train_plan_builder()(batch["coords"], batch["mask"]).level(0)
    gen = torch.Generator().manual_seed(cs.SEED + 9)
    ck = cs.Checker(gen, dev)
    n, c = l0.coords.shape[0], 96
    grid = int(round(2 * cs.BOUND_2D / cs.VOXEL))
    geom = (cs.TRAIN_BATCH, grid, bev.pooled_size(grid, 5, 3, 1), 5, 3, 1)
    out = []
    for dt in (torch.bfloat16, torch.float32):
        feats = torch.relu(ck.feats(n, c, l0.real, dt)).contiguous()
        res = bev.bev_scatter_max_plain(feats, l0.coords, l0.real, *geom)
        dout = torch.randn(res.shape, generator=gen).to(dev, dt)
        out.append((f"L0 {n} rows {c} {str(dt)[6:]}", dt, feats, l0.coords,
                    l0.real, geom, res, dout))
    return out


def timings(libs, dev):
    """{variant: {call: [ms, ms]}}, every variant checked first."""
    import torch

    import chip_smoke as cs
    from lidog_tpu_torch.ops import bev
    from lidog_tpu_torch.ops._wrap import DTYPES

    res = {name: {} for name in libs}
    for label, dt, feats, coords, mask, geom, want, dout in forms(dev):
        n, c = feats.shape
        plain_g = bev.bev_scatter_max_bwd_plain(feats, coords, mask, want,
                                                dout, *geom)
        out = torch.empty_like(want)
        dfeats = torch.empty_like(feats)

        def calls(lib):
            st = torch.cuda.current_stream().cuda_stream
            return {
                f"KI {label}": lambda: lib.bev_scatter_max_fwd(
                    feats.data_ptr(), coords.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), n, c, *geom, DTYPES[dt], st),
                f"KJ {label}": lambda: lib.bev_scatter_max_bwd(
                    feats.data_ptr(), coords.data_ptr(), mask.data_ptr(),
                    want.data_ptr(), dout.data_ptr(), dfeats.data_ptr(), n,
                    c, *geom, DTYPES[dt], st)}

        for name, lib in libs.items():
            ki, kj = calls(lib).values()
            if ki() or kj():
                raise SystemExit(f"ablate_bev: {name}: a launch failed")
            torch.cuda.synchronize()
            if name in DIAGNOSTIC:
                continue
            if not torch.equal(out.view(torch.int16 if dt == torch.bfloat16
                                        else torch.int32),
                               want.view(torch.int16 if dt == torch.bfloat16
                                         else torch.int32)):
                raise SystemExit(f"ablate_bev: {name} {label}: KI differs")
            if cs.ulp_err(dfeats, plain_g) > 1:
                raise SystemExit(f"ablate_bev: {name} {label}: KJ > 1 ulp")
        order = list(libs) + list(libs)[::-1]
        for name in order:
            for key, fn in calls(libs[name]).items():
                res[name].setdefault(key, []).append(cs.cuda_ms(fn))
    return res


def held_flushes(coords, mask, geom, run_rows, max_cands):
    """(cells, pairs): the cells a KI task flushes, and the live (row,
    candidate) pairs, by the source's rule in torch.  A task holds each
    cell its live row reaches and flushes it when the next live row of its
    run of run_rows rows does not reach it; a row with no live candidate
    is skipped.  Where KI holds no cell (more than max_cands cells per
    axis, or a grid of 2^31 cells or more) each pair flushes directly."""
    import torch

    from lidog_tpu_torch.ops import bev

    nb, _, out_hw, window, stride, _ = geom
    cells, live = bev.candidates(coords, mask, *geom)
    pairs = int(live.sum())
    if -(-window // stride) > max_cands or nb * out_hw * out_hw >= 2**31 - 1:
        return pairs, pairs
    rows = torch.nonzero(live.any(0)).flatten()
    now = torch.where(live[:, rows], cells[:, rows], -1)  # [K, M]
    prev = torch.cat([torch.full_like(now[:, :1], -1), now[:, :-1]], 1)
    run = torch.div(rows, run_rows, rounding_mode="floor")
    same_run = torch.cat([run.new_zeros(1, dtype=torch.bool),
                          run[1:] == run[:-1]])
    kept = ((now[:, None, :] == prev[None, :, :]).any(1) & same_run
            & (now >= 0))
    return pairs - int(kept.sum()), pairs


def counts(out_dir: Path, dev) -> dict:
    """KI's device counts at phase 8's shapes beside held_flushes'."""
    import torch

    from lidog_tpu_torch.ops import _cuda
    from lidog_tpu_torch.ops._wrap import DTYPES

    src = (_cuda.CSRC / "bev_scatter_max.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))
             for name in ("RUN_ROWS_BF16", "RUN_ROWS_F32", "MAX_CANDS")}
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libcount.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DBEV_COUNT_REDUCTIONS",
                    "-I", str(_cuda.CSRC), "-o", str(so),
                    str(_cuda.CSRC / "bev_scatter_max.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.bev_scatter_max_fwd.argtypes = _cuda._ARGTYPES["bev_scatter_max_fwd"]
    lib.bev_take_counts.argtypes = [ctypes.c_void_p]
    got = (ctypes.c_ulonglong * 2)()
    res = {}
    for label, dt, feats, coords, mask, geom, want, _ in forms(dev):
        n, c = feats.shape
        esz = feats.element_size()
        out = torch.empty_like(want)
        lib.bev_take_counts(got)  # zero them
        rc = lib.bev_scatter_max_fwd(
            feats.data_ptr(), coords.data_ptr(), mask.data_ptr(),
            out.data_ptr(), n, c, *geom, DTYPES[dt],
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc or lib.bev_take_counts(got):
            raise SystemExit(f"ablate_bev: {label}: the count build failed")
        if not torch.equal(out, want):
            raise SystemExit(f"ablate_bev: {label}: KI differs")
        wide = (c * esz) % 16 == 0  # torch's buffers are 16-byte aligned
        chunks = c * esz // (16 if wide else 4)
        run_rows = const["RUN_ROWS_BF16" if esz == 2 else "RUN_ROWS_F32"]
        cells, pairs = held_flushes(coords, mask, geom, run_rows,
                                    const["MAX_CANDS"])
        res[label] = {"live_pairs": pairs, "chunks_a_row": chunks,
                      "modelled_cells": cells, "chunks_flushed": got[0],
                      "reductions": got[1]}
        if got[0] != cells * chunks:
            raise SystemExit(f"ablate_bev: {label}: {res[label]}")
    return res


def probe_source(instr: str, k: int, kind: str) -> str:
    """A kernel whose thread i reduces its 4 * k / (2 if h) bytes of vals
    into cell i % cells with `instr`."""
    words = k // 2 if kind == "h" else k
    if kind in "rfs":
        regs = ", ".join(f"%{i + 1}" for i in range(k))
        cast = "__uint_as_float" if kind == "f" else ""
        ops = ", ".join(f'"{"f" if kind == "f" else "r"}"({cast}(v[{i}]))'
                        for i in range(k))
        load = "const uint32_t* v = vals + (size_t)i * W;"
    else:
        regs = ", ".join(f"%{i + 1}" for i in range(k))
        ops = ", ".join(f'"h"(h[{i}])' for i in range(k))
        load = ("const unsigned short* h = reinterpret_cast<const unsigned "
                "short*>(vals + (size_t)i * W);")
    ops_list = "{" + regs + "}" if k > 1 else regs
    return f"""#include <cuda_runtime.h>
#include <stdint.h>
constexpr int W = {words};
__global__ void probe_kernel(uint32_t* out, const uint32_t* vals, int n, int cells) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  {load}
  uint32_t* a = out + (size_t)(i % cells) * W;
  asm volatile("{instr} [%0], {ops_list};" :: "l"(a), {ops} : "memory");
}}
extern "C" int probe(void* out, const void* vals, int n, int cells, void* stream) {{
  probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(vals), n, cells);
  return (int)cudaGetLastError();
}}
"""


def probe(out_dir: Path) -> dict:
    """Which forms assemble, and whether each that does agrees with amax."""
    import torch

    from lidog_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _cuda._nvcc(), {}
    for i, (name, (instr, k, kind)) in enumerate(FORMS.items()):
        cu, so = out_dir / f"probe{i}.cu", out_dir / f"libprobe{i}.so"
        cu.write_text(probe_source(instr, k, kind))
        procs[name] = (subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so, k, kind)
    res = {}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name, (p, so, k, kind) in procs.items():
        log = p.communicate()[0].decode()
        if p.returncode != 0:
            err = [ln for ln in log.splitlines() if "error" in ln.lower()]
            res[name] = {"assembles": False, "error": " | ".join(err[:2])}
            continue
        lib = ctypes.CDLL(str(so))
        lib.probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        dt = torch.float32 if kind in "fs" else torch.bfloat16
        width = {"r": 2 * k, "h": k, "f": k, "s": k}[kind]
        n, cells = 100_000, 37
        vals = torch.rand(n, width, generator=gen).to(dev, dt)
        if width > 1:
            vals[:, 0] = 0.0  # +0 values beside the others
        out = torch.zeros(cells, width, dtype=dt, device=dev)
        rc = lib.probe(out.data_ptr(), vals.data_ptr(), n, cells,
                       torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        want = torch.zeros_like(out).index_reduce_(
            0, torch.arange(n, device=dev) % cells, vals, "amax")
        res[name] = {"assembles": True, "rc": rc,
                     "equal": bool(rc == 0 and torch.equal(out, want))}
        for sign in "+-":  # every 7th thread's values a NaN
            nan_vals = vals.clone()
            nan_vals[::7] = float("nan")
            if sign == "-":  # the sign bit set (-x of a NaN on the card is +NaN)
                bits = nan_vals.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32)
                bits[::7] |= torch.iinfo(bits.dtype).min
            out.zero_()
            lib.probe(out.data_ptr(), nan_vals.data_ptr(), n, cells,
                      torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            res[name][f"{sign}NaN cells"] = float(
                torch.isnan(out).float().mean())
    return res


def main(argv=None):
    import torch

    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("ablate_bev: needs a CUDA device")
    from lidog_tpu_torch.profile_serve import card_line

    print(card_line(), flush=True)
    root = Path(__file__).resolve().parents[1]
    if "--probe" in args:
        res = probe(root / "build" / "ablate_bev")
        for name, r in res.items():
            print(f"[probe] {name}: {r}", flush=True)
        print("[probe] " + json.dumps(res), flush=True)
        return 0
    sys.path.insert(0, str(root))
    dev = torch.device("cuda")
    if "--count" in args:
        res = counts(root / "build" / "ablate_bev", dev)
        for label, r in res.items():
            print(f"[count] KI {label}: {r}", flush=True)
        print("[count] " + json.dumps(res), flush=True)
        return 0
    res = timings(build(root / "build" / "ablate_bev"), dev)
    for name, calls in res.items():
        for key, ms in calls.items():
            print(f"[ablate] {name}: {key}: " + ", ".join(
                f"{m:.4f}" for m in ms), flush=True)
    print("[ablate] " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
