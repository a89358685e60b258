"""Ablations of the zconv3 forward and input-gradient kernels (KA, KE).

    python -m lidog_tpu_torch.ablate_zconv3

Builds, beside this checkout's own, variants of csrc/zconv3_fwd.cu and
csrc/zconv3_bwd_dx.cu made by text substitutions: without the MMAs (the
tiles are loaded, nothing is multiplied), without the copies (every
cp.async piece zero-filled, nothing read), and KA with 32-element K
chunks in 4 stages (the first redesign's ring).  Each is timed through its
C entry point at the main path's L0 shapes (chip_smoke's seeded inputs;
CUDA events, ms per call, mean of 10 after a warm-up) and held against
the plain version (max error relative to max |plain|; 1.0 where the
variant computes nothing).  Prints the card's name and power limit, then
one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (file, text, replacement) of each variant
_NO_MMA = [("zconv3_fwd", "acc.template k16<false>(A + kk, AP, B + kk * BP, "
            "BP, nullptr, nullptr);", ";")] + [
    ("zconv3_bwd_dx", f"acc.template k16<{m}>({a}, AP, {b}, BP, {lh});", ";")
    for m, a, b, lh in (
        ("true", "A + 2 * AP + kk", "B + kk * BP", "lo0, hi0"),
        ("false", "A + AP + kk", "B + (BK + kk) * BP", "nullptr, nullptr"),
        ("true", "A + kk", "B + (2 * BK + kk) * BP", "lo2, hi2"))]
_NO_COPIES = [("zconv3_fwd", "ok ? 16 : 0);", "0);"),
              ("zconv3_fwd", "k < k3 ? 16 : 0);", "0);"),
              ("zconv3_bwd_dx", "ok ? 16 : 0);", "0);"),
              ("zconv3_bwd_dx", "k < cout ? 16 : 0);", "0);")]
_KA_BK32 = [("zconv3_fwd", "constexpr int kBKBf16 = 64, kStagesBf16 = 3,",
             "constexpr int kBKBf16 = 32, kStagesBf16 = 4,")]
VARIANTS = {"as built": [], "no MMAs": _NO_MMA, "no copies": _NO_COPIES,
            "KA 32-element chunks, 4 stages": _KA_BK32}
FILES = ("zconv3_fwd", "zconv3_bwd_dx")


def build(out: Path):
    """Every variant's two libraries, built in parallel; returns
    {(variant, file): the C function}."""
    from lidog_tpu_torch.ops import _cuda

    nvcc, procs = _cuda._nvcc(), {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        text = {f: (_cuda.CSRC / f"{f}.cu").read_text() for f in FILES}
        for f, a, b in subs:
            if a not in text[f]:
                raise SystemExit(f"ablate_zconv3: {name}: {a!r} is not in "
                                 f"{f}.cu")
            text[f] = text[f].replace(a, b)
        (d / "zconv3_mma.cuh").write_text(
            (_cuda.CSRC / "zconv3_mma.cuh").read_text())
        for f in FILES:
            (d / f"{f}.cu").write_text(text[f])
            procs[(name, f)] = (d / f"lib{f}.so", subprocess.Popen(
                [nvcc, *_cuda.NVCC_FLAGS, "-o", str(d / f"lib{f}.so"),
                 str(d / f"{f}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ablate_zconv3: nvcc failed for {key}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), key[1])
        fn.argtypes, fn.restype = _cuda._ARGTYPES[key[1]], ctypes.c_int
        fns[key] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_zconv3: needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.ops import _cuda, zconv
    from lidog_tpu_torch.ops._wrap import DTYPES
    from lidog_tpu_torch.serve import Predictor

    print(cs.card_line(), flush=True)
    fns = build(_cuda.BUILD_DIR / "ablate")
    dev, bf = torch.device("cuda"), torch.bfloat16
    ck = cs.Checker(torch.Generator().manual_seed(cs.SEED + 8), dev)
    probe = Predictor(MinkUNet34(out_channels=cs.NUM_CLASSES,
                                 compute_dtype=bf,
                                 generator=torch.Generator().manual_seed(
                                     cs.SEED)),
                      batch_size=1, voxel_size=cs.VOXEL,
                      caps_per_scan=cs.PER_SCAN, grid_half=cs.GRID_HALF,
                      device=dev)
    one = torch.from_numpy(cs.scan(cs.POINTS, cs.SEED)[0]).to(dev)
    vox = voxelize_device(one, torch.ones(cs.POINTS, dtype=torch.bool,
                                          device=dev),
                          torch.zeros(cs.POINTS, dtype=torch.int32,
                                      device=dev), cs.VOXEL, probe.cap_in,
                          batch_size=1)
    splan = probe.builder(vox.coords, vox.mask)
    tb = cs.train_batch(*cs.train_data(), dev)
    tplan = cs.train_plan_builder()(tb["coords"], tb["mask"])
    res = {}
    for f, tag, plan, cin, cout in (
            ("zconv3_fwd", "serving", splan, 128, 96),
            ("zconv3_fwd", "training", tplan, 128, 96),
            ("zconv3_bwd_dx", "training", tplan, 96, 96),
            ("zconv3_bwd_dx", "training", tplan, 128, 96)):
        L, nbr9 = plan.level(0), plan.kmaps["conv9_l0"]
        n = nbr9.shape[1]
        wf = ck.weights(bf, 9, 3 * cin, cout)
        if f == "zconv3_fwd":
            x = ck.feats(n, cin, L.real, bf)
            want = zconv.zconv3_plain(x, nbr9, L.zup, L.zdn, wf, L.real)
            out = torch.empty(n, cout, dtype=bf, device=dev)
            args = (x, nbr9, L.zup, L.zdn, wf, L.real, out, n, cin, cout)
        else:
            d = ck.feats(n, cout, torch.ones(n, dtype=torch.bool, device=dev),
                         bf)
            want = zconv.zconv3_bwd_dx_plain(d, nbr9, L.zup, L.zdn, wf,
                                             L.real)
            out = torch.empty(n, cin, dtype=bf, device=dev)
            args = (d, nbr9, L.zup, L.zdn, zconv.dx_weights(wf), L.real, out,
                    n, cout, cin)
        cargs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
        key = f"{f} {tag} L0 {n} rows {cin}->{cout} bfloat16"
        for name in VARIANTS:
            fn = fns[(name, f)]

            def run():
                err = fn(*cargs, DTYPES[bf],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"ablate_zconv3: {name}: CUDA error "
                                     f"{err}")

            res.setdefault(key, {})[name] = {
                "ms": cs.cuda_ms(run), "max_rel_err": cs.rel_err(out, want)}
    print("[ablate] " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
