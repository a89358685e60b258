"""Ablations of the general stem's kernels (KO, KP; csrc/zconv_full.cu).

    python -m lidog_tpu_torch.ablate_zconv_full

Builds, beside this checkout's own, variants of csrc/zconv_full.cu made by
text substitutions: KO's bf16 and f32 stems through the hit lists instead
of the tensor-core and row forms, KO's hit lists and KP without their x
gathers (every hit reads row 0), KP without its dout gathers, KP with its
hits' x rows gathered instead of copied beside the list, the hit lists in
batches of 8 hits (4 for f32), and KO's tensor-core form with 8 warps a
block.  Each is timed through its C entry points (CUDA events, ms per
call, mean of 10 after a warm-up, as chip_smoke's `cuda_ms`) at chip_smoke
phase 15's shapes (the general stem's level 0, 4 -> 32, and KO as dx, 32
-> 4) and phase 20's generic stem (1 -> 32), bf16 and f32, on seeded
inputs, twice in turns.  A variant without gathers computes a wrong
result; nothing is checked.  Prints the card's name and power limit, then
one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

_BATCH = "static constexpr int U = Pack<T, AB>::WORDS <= 2 ? 4 : 2;"
VARIANTS = {
    "as built": [],
    "KO bf16 stems on the hit lists": [
        ("  if (cout <= 16) return -1;\n  switch (cin) {\n    case 1: return mma_nt",
         "  if (cout <= 64) return -1;\n  switch (cin) {\n    case 1: return mma_nt")],
    "KO f32 stems on the hit lists": [
        ("  if (cout > 32) return -1;\n  switch (cin) {\n    case 1: return launch_rows",
         "  if (cout > 0) return -1;\n  switch (cin) {\n    case 1: return launch_rows")],
    "no x gathers (KO hit lists, KP)": [
        ("xv[u].template load<VEC>(x + (size_t)ent[u].x * cin + a0, valid);",
         "xv[u].template load<VEC>(x + a0, valid);"),
        ("xv[u].template load<VEC>(x + (size_t)(r0 + ent[u].y) * cin + a0, valid);",
         "xv[u].template load<VEC>(x + a0, valid);"),
        ("const bool stage = rb == 4 || rb == 8 || rb == 16;", "const bool stage = false;")],
    "KP without dout gathers": [
        ("to_f32(__ldg(dout + (size_t)ent[u].x * cout + col))", "to_f32(__ldg(dout + col))")],
    "KP x rows gathered, not copied": [
        ("const bool stage = rb == 4 || rb == 8 || rb == 16;", "const bool stage = false;")],
    "hit lists in batches of 8": [
        (_BATCH, "static constexpr int U = Pack<T, AB>::WORDS <= 2 ? 8 : 4;")],
    "KO tensor cores, 8 warps a block": [
        ("constexpr int KM_WARPS = 4;", "constexpr int KM_WARPS = 8;")],
}


def build(out: Path):
    """Every variant's library, built in parallel; returns {variant: lib}."""
    from lidog_tpu_torch.ops import _cuda

    nvcc, procs = _cuda._nvcc(), {}
    src = (_cuda.CSRC / "zconv_full.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"ablate_zconv_full: {name}: {a!r} is not in "
                                 "zconv_full.cu")
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
            raise SystemExit(f"ablate_zconv_full: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("zconv_full_fwd", "zconv_full_wgrad"):
            getattr(lib, fn).argtypes = _cuda._ARGTYPES[fn]
        libs[name] = lib
    return libs


def forms(dev):
    """(label, kind, args) of every timed call: chip_smoke phase 15's and
    phase 20's stem shapes, bf16 and f32."""
    import torch

    import chip_smoke as cs

    pts, labels = cs.train_data()
    batch = cs.train_batch(pts, labels, dev)
    plan = cs.train_plan_builder(cs.IN_CHANNELS)(batch["coords"], batch["mask"])
    _, gplan = cs.generic_batch_plan(dev)
    ck = cs.Checker(torch.Generator().manual_seed(cs.SEED + 11), dev)
    out = []
    for tag, nbr, mask, cin in (
            ("L0", plan.kmaps["stem125"], plan.level(0).real, cs.IN_CHANNELS),
            ("generic", gplan.kmaps["stem"], gplan.level(0).mask, 1)):
        n = nbr.shape[1]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            x = ck.feats(n, cin, mask, dt)
            w = ck.weights(dt, nbr.shape[0], cin, 32)
            dout = ck.feats(n, 32, ones, dt)
            wt = w.flip(0).transpose(1, 2).contiguous()
            d = str(dt)[6:]
            out.append((f"KO {tag} {cin}->32 {d}", "fwd", (x, nbr, w, mask, None)))
            if tag == "L0":
                out.append((f"KO dx {tag} 32->{cin} {d}", "fwd",
                            (dout, nbr, wt, None, mask)))
            out.append((f"KP {tag} {cin}->32 {d}", "wgrad", (x, dout, nbr, mask)))
    return out


def runner(lib, kind, args):
    """A zero-argument call of the variant's C entry point on args."""
    import torch

    from lidog_tpu_torch.ops import sparse_conv as sc
    from lidog_tpu_torch.ops._wrap import DTYPES, ptr

    stream = torch.cuda.current_stream().cuda_stream
    if kind == "fwd":
        x, nbr, w, om, sm = args
        k, n = nbr.shape
        out = torch.empty(n, w.shape[2], dtype=x.dtype, device=x.device)
        a = (x.data_ptr(), nbr.data_ptr(), w.data_ptr(), ptr(om), ptr(sm),
             out.data_ptr(), x.shape[0], n, k, x.shape[1], w.shape[2],
             DTYPES[x.dtype], stream)
        return lambda: lib.zconv_full_fwd(*a)
    x, dout, nbr, m = args
    k, n = nbr.shape
    sp = sc.full_wgrad_split(n)
    part = torch.empty(sp.chunks, k, x.shape[1], dout.shape[1],
                       dtype=torch.float32, device=x.device)
    dw = torch.empty(k, x.shape[1], dout.shape[1], dtype=x.dtype,
                     device=x.device)
    a = (x.data_ptr(), dout.data_ptr(), nbr.data_ptr(), ptr(m), part.data_ptr(),
         dw.data_ptr(), n, k, x.shape[1], dout.shape[1], sp.chunks,
         sp.rows_per_chunk, DTYPES[x.dtype], stream)
    return lambda: lib.zconv_full_wgrad(*a)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_zconv_full: needs a CUDA card")
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    libs = build(root / "build" / "ablate_zconv_full")
    dev = torch.device("cuda")
    res = {}
    calls = forms(dev)
    for _ in range(2):  # in turns
        for label, kind, args in calls:
            for name, lib in libs.items():
                fn = runner(lib, kind, args)
                if fn() != 0:
                    raise SystemExit(f"ablate_zconv_full: {name} {label}: launch failed")
                res.setdefault(label, {}).setdefault(name, []).append(cs.cuda_ms(fn))
    for label, row in res.items():
        print(f"{label}: " + ", ".join(f"{k} {min(v):.4f}-{max(v):.4f}"
                                       for k, v in row.items()), flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
