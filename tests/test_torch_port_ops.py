"""lidog_tpu_torch's ops vs lidog_tpu's, on the CPU.

Inputs are made with numpy from a fixed seed and go through the JAX
function (XLA:CPU) and the port (its plain PyTorch versions: every kernel
wrapper takes its plain version for a CPU tensor).  The CUDA and Triton
kernels are held against these plain versions on the card by
chip_smoke.py.

Tolerances (relative to max |JAX output|):
  * voxelize_device: bitwise.
  * zconv3 / zconv_down / zconv_up: 1e-4 in f32 (summation order only);
    2e-2 in bf16 (both sides round at the same points, lidog_tpu
    ops/zconv.py:205-213 and :445-447, but sum in different orders, so a
    rounded value may land one bf16 step apart).
  * MaskedBatchNorm eval + residual + ReLU: 1e-5 in f32, 1e-2 in bf16.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_voxelize_bitwise(request):
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.voxelize import voxelize_device as jax_vox
    from lidog_tpu_torch.core.voxelize import voxelize_device

    rng = np.random.RandomState(3)
    B, P = 2, 700
    pts = ((rng.rand(B * P, 3) - 0.5) * 12.0).astype(np.float32)
    pts[::97] = 0.25  # duplicate points in one voxel
    valid = rng.rand(B * P) > 0.05
    bidx = np.repeat(np.arange(B, dtype=np.int32), P)
    # roomy capacity, then one that drops voxels (overflow path)
    for cap in (2048, 600):
        jv = jax_vox(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(bidx),
                     0.5, cap)
        tv = voxelize_device(torch.from_numpy(pts), torch.from_numpy(valid),
                             torch.from_numpy(bidx), 0.5, cap)
        for f in tv._fields:
            a, b = np.asarray(getattr(jv, f)), getattr(tv, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f"{f} cap={cap}")
    assert int(tv.overflow) > 0


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zconv_ops_match_jax(dtype, request):
    """zconv3, zconv_down and zconv_up forward on a JAX-built plan's maps."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.zseg import ZSegPlanBuilder
    from lidog_tpu.ops import zconv as jz
    from lidog_tpu_torch.ops import zconv as tz
    from tests.test_zseg import B, CAPS_A, CAPS_R, _build_inputs

    coords, mask, _ = _build_inputs(np.random.RandomState(7))
    plan = jax.jit(ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                                   grid_half=64))(
        jnp.asarray(coords), jnp.asarray(mask))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    rng = np.random.RandomState(11)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    def feats(level, c):
        real = np.asarray(plan.level(level).real)
        x = rng.randn(real.shape[0], c).astype(np.float32) * real[:, None]
        return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    def weights(*shape):
        w = (rng.randn(*shape) * 0.2).astype(np.float32)
        return jnp.asarray(w, jdt), torch.from_numpy(w).to(tdt)

    launches = dict(tz.LAUNCHES)
    for lvl, cin, cout in ((0, 8, 16), (2, 16, 8)):
        L = plan.level(lvl)
        xj, xt = feats(lvl, cin)
        wj, wt = weights(27, cin, cout)
        nbr = plan.kmaps[f"conv9_l{lvl}"]
        oj = jz.zconv3(xj, nbr, L.zup, L.zdn, wj, out_mask=L.real,
                       num_batches=B)
        ot = tz.zconv3(xt, t(nbr), t(L.zup), t(L.zdn), wt, out_mask=t(L.real))
        assert ot.dtype == tdt
        err = _rel(oj.astype(jnp.float32), ot.float())
        assert err <= tol, ("zconv3", lvl, err)

        fine, coarse = plan.level(lvl), plan.level(lvl + 1)
        dj, dt_ = weights(8, cin, cout)
        nbr8 = plan.kmaps[f"down8_l{lvl}"]
        parent, off = plan.kmaps[f"parent_l{lvl}"], plan.kmaps[f"off_l{lvl}"]
        oj = jz.zconv_down(xj, nbr8, parent, off, dj, out_mask=coarse.real,
                           num_batches=B)
        ot = tz.zconv_down(xt, t(nbr8), dt_, out_mask=t(coarse.real))
        err = _rel(oj.astype(jnp.float32), ot.float())
        assert err <= tol, ("zconv_down", lvl, err)

        cj, ct = feats(lvl + 1, cin)
        oj = jz.zconv_up(cj, parent, off, nbr8, dj, out_mask=fine.real,
                         num_batches=B)
        ot = tz.zconv_up(ct, t(parent), t(off), dt_, out_mask=t(fine.real))
        err = _rel(oj.astype(jnp.float32), ot.float())
        assert err <= tol, ("zconv_up", lvl, err)
        # ghost and pad rows stay exactly zero
        assert (ot[~t(fine.real)] == 0).all()
    # CPU tensors take the plain versions: no kernel launch was counted
    assert tz.LAUNCHES == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_relu_residual_match_jax(dtype, request):
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops.norm import MaskedBatchNorm as JaxBN
    from lidog_tpu_torch.ops import norm

    rng = np.random.RandomState(5)
    n, c = 300, 24
    mask = rng.rand(n) > 0.3
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32) * mask[:, None]
    res = np.maximum(rng.randn(n, c), 0).astype(np.float32) * mask[:, None]
    stats = {"mean": rng.randn(c).astype(np.float32) * 0.3,
             "var": rng.uniform(0.3, 3.0, c).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32) * 0.2}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2

    def jax_bn(res_, relu):
        y = JaxBN().apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x, jdt), jnp.asarray(mask),
                          use_running_average=True)
        if res_ is not None:
            y = y + jnp.asarray(res_, jdt)
        return np.asarray((jax.nn.relu(y) if relu else y).astype(jnp.float32))

    bn = norm.MaskedBatchNorm(c)
    bn.load_state_dict({k: torch.from_numpy(v)
                        for k, v in {**params, **stats}.items()})
    for res_, relu in ((None, False), (None, True), (res, True)):
        with torch.no_grad():
            got = bn(torch.from_numpy(x).to(tdt), torch.from_numpy(mask),
                     None if res_ is None else torch.from_numpy(res_).to(tdt),
                     relu)
        assert got.dtype == tdt
        want = jax_bn(res_, relu)
        assert _rel(want, got.float()) <= tol, (res_ is None, relu)
        assert (got[~torch.from_numpy(mask)] == 0).all()


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """Each kernel wrapper takes its plain version for a CPU tensor and
    counts no launch; a tensor on neither the CPU nor a card raises."""
    import torch

    from lidog_tpu_torch.ops import norm, zconv

    g = torch.Generator().manual_seed(0)
    n = 6
    x = torch.randn(n, 32, generator=g)
    m = torch.rand(n, generator=g) > 0.3
    zup, zdn = torch.rand(n, generator=g) > 0.5, torch.rand(n, generator=g) > 0.5
    nbr = torch.randint(-1, n, (9, n), generator=g, dtype=torch.int32)
    nbr[4] = torch.arange(n, dtype=torch.int32)
    off = torch.randint(0, 8, (n,), generator=g, dtype=torch.int32)
    wf, w8 = torch.randn(9, 96, 32, generator=g), torch.randn(8, 32, 32, generator=g)
    vec = [torch.randn(32, generator=g) for _ in range(3)]
    cases = [
        (zconv.zconv3_fwd, zconv.zconv3_plain, (x, nbr, zup, zdn, wf, m)),
        (zconv.zconv_down_fwd, zconv.zconv_down_plain, (x, nbr[:8], w8, m)),
        (zconv.zconv_up_fwd, zconv.zconv_up_plain, (x, nbr[0], off, w8, m)),
        (norm.bn_act, norm.bn_act_plain, (x, *vec, m, x, True)),
    ]
    before = {**zconv.LAUNCHES, **norm.LAUNCHES}
    for wrapper, plain, args in cases:
        out = wrapper(*args)
        assert out.abs().sum() > 0
        assert torch.equal(out, plain(*args)), wrapper.__name__
        meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*meta)
    assert {**zconv.LAUNCHES, **norm.LAUNCHES} == before


def test_port_imports_no_jax():
    """Importing every lidog_tpu_torch module (and chip_smoke.py) leaves
    jax, flax and lidog_tpu out of sys.modules.  bn_act_triton is the one
    module that needs the triton package; it is imported only by the
    launching function."""
    code = r"""
import importlib, pkgutil, sys
import lidog_tpu_torch
names = ["chip_smoke"]
for m in pkgutil.walk_packages(lidog_tpu_torch.__path__, "lidog_tpu_torch."):
    names.append(m.name)
assert "lidog_tpu_torch.ops.bn_act_triton" in names
for n in names:
    if n != "lidog_tpu_torch.ops.bn_act_triton":
        importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "lidog_tpu"))
assert not bad, bad
assert "triton" not in sys.modules
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) > 10
