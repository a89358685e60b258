"""lidog_tpu_torch's ops, loss, metrics and optimizer vs lidog_tpu's, on
the CPU.

Inputs are made with numpy from a fixed seed and go through the JAX
function (XLA:CPU) and the port (its plain PyTorch versions: every kernel
wrapper takes its plain version for a CPU tensor).  The CUDA and Triton
kernels are held against these plain versions on the card by
chip_smoke.py.

Tolerances (relative to max |JAX output|, per compared tensor):
  * voxelize_device: bitwise; at voxel 0.05 also against lidog_tpu's
    jitted batch builders (which multiply by the f32 reciprocal).
  * the plan sweeps' wrappers (KQ-KU) on the CPU: equal to their plain
    versions.
  * zconv3 / zconv_down / zconv_up forward: 1e-4 in f32 (summation order
    only); 2e-2 in bf16 (both sides round at the same points, lidog_tpu
    ops/zconv.py:205-213 and :445-447, but sum in different orders, so a
    rounded value may land one bf16 step apart).
  * their dx and dW: 1e-5 in f32 (summation order only); 2e-2 in bf16
    (the same rounding points: gathered rows in bf16, dxc rounded before
    the z fold, dW rounded once from f32; other summation orders).
  * MaskedBatchNorm eval + residual + ReLU: 1e-5 in f32, 1e-2 in bf16.
  * MaskedBatchNorm train mode, output, running stats and the grads of
    feats, scale, bias and res: 1e-5 in f32 (f32 sums in another order);
    2e-2 in bf16 (one bf16 step where the f32 results round differently).
  * SoftDICE loss and dlogits: 1e-5 (f32 throughout); confusion matrix:
    exact.
  * MaskedInstanceNorm output and grad: 1e-5 in f32 (f32 sums in another
    order); 2e-2 in bf16 (one bf16 step where the f32 results round
    differently).
  * IW / IRW loss and grad: 1e-5 (f32; sums in another order).
  * The four models' parameter trees from their YAMLs: keys, shapes and
    dtypes equal.
  * keys.merge_lookup / lookup: bitwise (int32 rows, -1 for a miss).
  * sparse_conv (the generic plan's K21) forward, dIn and dW through
    autograd vs jax.grad of lidog_tpu's: 1e-5 in f32 (summation order
    only: lidog_tpu sums offset groups of ~128 / Cin, the port offset by
    offset); 1e-2 in bf16 (both round once from f32 at the same points,
    so a value may land one bf16 step apart).
  * Adam / SGD vs optax over 3 steps: 1e-6 of max |param| (f32; torch
    divides by sqrt(nu) / sqrt(1 - b2^t) where optax takes sqrt(nu / (1 -
    b2^t)), and the schedules are taken in f64 here, f32 there).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_port_serve import one_torch_thread  # noqa: F401

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
    # roomy capacity, then one that drops voxels (overflow path); called as
    # lidog_tpu's, without a batch size
    for cap in (2048, 600):
        jv = jax_vox(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(bidx),
                     0.5, cap)
        tv = voxelize_device(torch.from_numpy(pts), torch.from_numpy(valid),
                             torch.from_numpy(bidx), 0.5, cap)
        for f in jv._fields:
            a, b = np.asarray(getattr(jv, f)), getattr(tv, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f"{f} cap={cap}")
        assert tv._fields == jv._fields + ("batch_breach",)
        assert tv.batch_breach.dtype == torch.int32
        assert int(tv.batch_breach) == 0
    assert int(tv.overflow) == int(tv.num_voxels) - 600 > 0
    # a valid point past the batch field (MAX_BATCH): flagged, not raised
    big = torch.from_numpy(bidx).clone()
    big[5] = 1 << 17
    tv = voxelize_device(torch.from_numpy(pts), torch.from_numpy(valid), big,
                         0.5, 2048)
    assert int(tv.batch_breach) == int(valid[5]) == 1


def test_voxel_quantization_matches_jitted_jax():
    """At voxel 0.05 the port's voxelize_device, device_batch_from_points
    and device_batch_raw put each point in the cell that lidog_tpu's
    jitted device_batch_from_points and device_batch_raw give (XLA folds
    the constant division into a multiply by the f32 reciprocal: the first
    two points floor one y cell lower under a true division)."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.train import device_pipeline as jdp
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.train import device_pipeline as tdp

    pts = np.array([[0.6157845, 4.2, -1.6997496],
                    [3.1750686, 9.4, -0.4643165], [1, 1, 1]], np.float32)
    valid, labels = np.ones((1, 3), bool), np.arange(3, dtype=np.int32)[None]
    jargs = (jnp.asarray(pts[None]), jnp.asarray(valid), jnp.asarray(labels))
    targs = (torch.from_numpy(pts[None]), torch.from_numpy(valid),
             torch.from_numpy(labels))
    want = np.array([[0, 12, 84, -34], [0, 20, 20, 20], [0, 63, 188, -10]],
                    np.int32)  # canonical order
    jb = jdp.device_batch_from_points(*jargs, 0.05, 8)
    tb = tdp.device_batch_from_points(*targs, 0.05, 8)
    tv = voxelize_device(torch.from_numpy(pts), torch.ones(3, dtype=torch.bool),
                         torch.zeros(3, dtype=torch.int32), 0.05, 8)
    np.testing.assert_array_equal(np.asarray(jb["coords"])[:3], want)
    for k in ("coords", "labels", "mask"):
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy(), k)
    np.testing.assert_array_equal(tv.coords.numpy(), tb["coords"].numpy())
    jr = jdp.device_batch_raw(*jargs, 0.05)
    tr = tdp.device_batch_raw(*targs, 0.05)
    np.testing.assert_array_equal(np.asarray(jr["coords"])[[0, 2, 1]], want)
    for k in ("coords", "labels", "mask"):
        np.testing.assert_array_equal(np.asarray(jr[k]), tr[k].numpy(), k)


@pytest.mark.parametrize("fn", ["merge_lookup", "lookup"])
def test_lookups_match_jax(fn):
    """keys.merge_lookup and keys.lookup against lidog_tpu's on a lex-sorted
    table with duplicate hi words, misses on both sides of the table and
    INVALID_KEY queries: bitwise int32 results."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core import keys as jk
    from lidog_tpu_torch.core import keys as tk

    rng = np.random.RandomState(7)
    th = rng.randint(0, 60, 300).astype(np.int32)
    tl = rng.randint(0, 6, 300).astype(np.int32)
    order = np.lexsort((tl, th))
    th, tl = th[order], tl[order]
    qh = rng.randint(-2, 63, 500).astype(np.int32)
    ql = rng.randint(0, 7, 500).astype(np.int32)
    qh[:9] = ql[:9] = jk.INVALID_KEY
    want = np.asarray(getattr(jk, fn)(*map(jnp.asarray, (th, tl, qh, ql))))
    got = getattr(tk, fn)(*map(torch.from_numpy, (th, tl, qh, ql)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    assert (want >= 0).sum() > 100 and (want < 0).sum() > 100


def _unet_plan(caps=(768, 512, 256, 128, 64), seed=5):
    """The port's UNetPlan of seeded voxels in 2 scans (bitwise equal to
    lidog_tpu's builder: test_unet_plan_bitwise_equal)."""
    import torch

    from lidog_tpu_torch.core.plan import build_unet_plan

    rng = np.random.RandomState(seed)
    n = caps[0]
    coords = np.concatenate([rng.randint(0, 2, (n, 1)),
                             rng.randint(-8, 8, (n, 3))], 1).astype(np.int32)
    mask = rng.rand(n) < 0.85
    return build_unet_plan(torch.from_numpy(coords), torch.from_numpy(mask),
                           caps)


# (kmap, input level, output level, Cin, Cout, the transpose partner map)
SPARSE_CONV_CASES = {"conv3": ("conv3_l1", 1, 1, 8, 16, None),
                     "stem": ("stem", 0, 0, 1, 8, None),
                     "down": ("down_l0", 0, 1, 8, 16, "up_l0"),
                     "up": ("up_l1", 2, 1, 16, 8, "down_l1")}


@pytest.mark.parametrize("kind", list(SPARSE_CONV_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_conv_matches_jax(dtype, kind):
    """sparse_conv's forward, and dIn and dW through autograd, against
    jax.value_and_grad of lidog_tpu's sparse_conv on the maps of one
    UNetPlan: the k=3 and k=5 (stem) symmetric maps, and the down and up
    maps with their partner as nbr_t (the offset reversal of the
    backward).  The stem's input takes no grad (feats without
    requires_grad), as in the model."""
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops.sparse_conv import sparse_conv as jax_conv
    from lidog_tpu_torch.ops.sparse_conv import sparse_conv

    name, li, lo, cin, cout, partner = SPARSE_CONV_CASES[kind]
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    plan = _unet_plan()
    nbr = plan.kmaps[name]
    nbr_t = None if partner is None else plan.kmaps[partner]
    m_in, m_out = plan.level(li).mask.numpy(), plan.level(lo).mask
    rng = np.random.RandomState(11)
    x = (rng.randn(m_in.shape[0], cin) * m_in[:, None]).astype(np.float32)
    w = (rng.randn(nbr.shape[0], cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(nbr.shape[1], cout).astype(np.float32)
    jd = jnp.dtype(dtype)

    def loss(x, w):
        out = jax_conv(x.astype(jd), jnp.asarray(nbr.numpy()), w.astype(jd),
                       nbr_t=None if nbr_t is None
                       else jnp.asarray(nbr_t.numpy()),
                       out_mask=jnp.asarray(m_out.numpy()))
        return (out.astype(jnp.float32) * g).sum(), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).requires_grad_(kind != "stem")
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_conv(xt.to(td), nbr, wt.to(td), nbr_t=nbr_t, out_mask=m_out)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == td and _rel(jout, out.detach().float()) <= tol
    assert (out[~m_out] == 0).all()
    assert _rel(jdw, wt.grad) <= tol
    if kind == "stem":
        assert xt.grad is None
    else:
        assert _rel(jdx, xt.grad) <= tol
    with pytest.raises(ValueError, match="nbr_t"):
        sparse_conv(xt.to(td), plan.kmaps["down_l0"],
                    torch.zeros(8, cin, cout, dtype=td))


def _zseg_plan():
    """The plan of tests/test_zseg.py's input (grid_half 64) as a lidog_tpu
    ZPlan: the port's builder, bitwise equal to lidog_tpu's there
    (test_plan_bitwise_equal[zseg]), converted (_jax_plan_of)."""
    import torch

    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from tests.test_torch_port_serve import _jax_plan_of
    from tests.test_zseg import B, CAPS_A, CAPS_R, _build_inputs

    coords, mask, _ = _build_inputs(np.random.RandomState(7))
    return _jax_plan_of(ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                                        grid_half=64)(
        torch.from_numpy(np.asarray(coords)),
        torch.from_numpy(np.asarray(mask))))


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
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops import zconv as jz
    from lidog_tpu_torch.ops import zconv as tz
    from tests.test_zseg import B

    plan = _zseg_plan()
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
        ot = tz.zconv_down(xt, t(nbr8), t(parent), t(off), dt_,
                           out_mask=t(coarse.real))
        err = _rel(oj.astype(jnp.float32), ot.float())
        assert err <= tol, ("zconv_down", lvl, err)

        cj, ct = feats(lvl + 1, cin)
        oj = jz.zconv_up(cj, parent, off, nbr8, dj, out_mask=fine.real,
                         num_batches=B)
        ot = tz.zconv_up(ct, t(parent), t(off), t(nbr8), dt_,
                         out_mask=t(fine.real))
        err = _rel(oj.astype(jnp.float32), ot.float())
        assert err <= tol, ("zconv_up", lvl, err)
        # ghost and pad rows stay exactly zero
        assert (ot[~t(fine.real)] == 0).all()
    # CPU tensors take the plain versions: no kernel launch was counted
    assert tz.LAUNCHES == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zconv_grads_match_jax(dtype, request):
    """dx and dW of zconv3, zconv_down and zconv_up: jax.vjp through
    lidog_tpu's custom VJPs against autograd through the port's ops (the
    plain versions on the CPU), every row compared."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops import zconv as jz
    from lidog_tpu_torch.ops import zconv as tz
    from tests.test_zseg import B

    plan = _zseg_plan()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    rng = np.random.RandomState(13)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    def rows(level, c, masked=True):
        real = np.asarray(plan.level(level).real)
        x = rng.randn(real.shape[0], c).astype(np.float32)
        if masked:
            x *= real[:, None]
        return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    def weights(*shape):
        w = (rng.randn(*shape) * 0.2).astype(np.float32)
        return jnp.asarray(w, jdt), torch.from_numpy(w).to(tdt)

    def check(what, jfn, tfn, x, w, dout):
        _, vjp = jax.vjp(jfn, x[0], w[0])
        dxj, dwj = vjp(dout[0])
        xt = x[1].clone().requires_grad_()
        wt = w[1].clone().requires_grad_()
        tfn(xt, wt).backward(dout[1])
        for name, a, b in (("dx", dxj, xt.grad), ("dW", dwj, wt.grad)):
            assert b.dtype == tdt and tuple(b.shape) == a.shape, (what, name)
            err = _rel(a.astype(jnp.float32), b.float())
            assert err <= tol, (what, name, err)

    for lvl, cin, cout in ((0, 8, 16), (2, 16, 8)):
        L, C = plan.level(lvl), plan.level(lvl + 1)
        nbr = plan.kmaps[f"conv9_l{lvl}"]
        nbr8 = plan.kmaps[f"down8_l{lvl}"]
        parent, off = plan.kmaps[f"parent_l{lvl}"], plan.kmaps[f"off_l{lvl}"]
        # the cotangents are not masked: the ops' own out_mask must zero
        # them where the forward did
        check(("zconv3", lvl),
              lambda x, w: jz.zconv3(x, nbr, L.zup, L.zdn, w,
                                     out_mask=L.real, num_batches=B),
              lambda x, w: tz.zconv3(x, t(nbr), t(L.zup), t(L.zdn), w,
                                     out_mask=t(L.real)),
              rows(lvl, cin), weights(27, cin, cout),
              rows(lvl, cout, masked=False))
        check(("zconv_down", lvl),
              lambda x, w: jz.zconv_down(x, nbr8, parent, off, w,
                                         out_mask=C.real, num_batches=B),
              lambda x, w: tz.zconv_down(x, t(nbr8), t(parent), t(off), w,
                                         out_mask=t(C.real)),
              rows(lvl, cin), weights(8, cin, cout),
              rows(lvl + 1, cout, masked=False))
        check(("zconv_up", lvl),
              lambda x, w: jz.zconv_up(x, parent, off, nbr8, w,
                                       out_mask=L.real, num_batches=B),
              lambda x, w: tz.zconv_up(x, t(parent), t(off), t(nbr8), w,
                                       out_mask=t(L.real)),
              rows(lvl + 1, cin), weights(8, cin, cout),
              rows(lvl, cout, masked=False))


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

    bn = norm.MaskedBatchNorm(c).eval()  # the running stats
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_match_jax(dtype, request):
    """Train-mode MaskedBatchNorm (+ residual, ReLU): output, the new
    running stats, and the grads of feats, scale, bias and res."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops.norm import MaskedBatchNorm as JaxBN
    from lidog_tpu_torch.ops import norm

    rng = np.random.RandomState(6)
    n, c = 300, 24
    mask = rng.rand(n) > 0.3
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32) * mask[:, None]
    res = rng.randn(n, c).astype(np.float32) * mask[:, None]
    dy = rng.randn(n, c).astype(np.float32)
    stats = {"mean": rng.randn(c).astype(np.float32) * 0.3,
             "var": rng.uniform(0.3, 3.0, c).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32) * 0.2}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    f32 = jnp.float32

    for with_res, relu in ((False, False), (False, True), (True, True)):
        def jax_fn(feats, scale, bias, r):
            y, upd = JaxBN().apply(
                {"params": {"scale": scale, "bias": bias},
                 "batch_stats": stats},
                feats, jnp.asarray(mask), use_running_average=False,
                mutable=["batch_stats"])
            if with_res:
                y = y + r
            return (jax.nn.relu(y) if relu else y), upd["batch_stats"]

        args = (jnp.asarray(x, jdt), jnp.asarray(params["scale"]),
                jnp.asarray(params["bias"]), jnp.asarray(res, jdt))
        yj, vjp, new_stats = jax.vjp(jax_fn, *args, has_aux=True)
        grads_j = vjp(jnp.asarray(dy, jdt))

        bn = norm.MaskedBatchNorm(c).train()
        bn.load_state_dict({k: torch.from_numpy(v)
                            for k, v in {**params, **stats}.items()})
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        rt = torch.from_numpy(res).to(tdt).requires_grad_()
        yt = bn(xt, torch.from_numpy(mask), rt if with_res else None, relu)
        yt.backward(torch.from_numpy(dy).to(tdt))
        assert yt.dtype == tdt
        assert (yt[~torch.from_numpy(mask)] == 0).all()
        assert (xt.grad[~torch.from_numpy(mask)] == 0).all()
        got = {"y": yt, "mean": bn.mean, "var": bn.var, "dfeats": xt.grad,
               "dscale": bn.scale.grad, "dbias": bn.bias.grad}
        want = {"y": yj, "mean": new_stats["mean"], "var": new_stats["var"],
                "dfeats": grads_j[0], "dscale": grads_j[1],
                "dbias": grads_j[2]}
        if with_res:
            got["dres"], want["dres"] = rt.grad, grads_j[3]
        for k in want:
            err = _rel(np.asarray(want[k].astype(f32)),
                       got[k].detach().float())
            assert err <= tol, (with_res, relu, k, err)


def _bn_blocked_sums(vals, sp, order):
    """The f32 column sums of KG's and KH's reductions (csrc/masked_bn.cu)
    over vals [n, k] as blocked by the split sp: each block, in the finish
    order `order`, sums its run of lanes * steps rows per lane (lane j
    takes rows j, j + lanes, ... in order), then over its lanes by the
    pairwise tree (lane j adds lane j + h, h = lanes / 2 ... 1), into its
    partial row, and draws a ticket; the block that draws the last ticket
    sums the partial rows by the same lane walk and tree in block order.
    Returns the sums and how many blocks ran that finish."""
    rows = sp.lanes * sp.steps
    parts = np.zeros((sp.blocks, vals.shape[1]), np.float32)
    written = np.zeros(sp.blocks, bool)

    def lanes_tree(v):
        acc = np.zeros((sp.lanes, v.shape[1]), np.float32)
        for i in range(0, len(v), sp.lanes):
            step = v[i:i + sp.lanes]
            acc[:len(step)] += step
        h = sp.lanes // 2
        while h:
            acc[:h] += acc[h:2 * h]
            h //= 2
        return acc[0]

    ticket, finishes, out = 0, 0, None
    for b in order:
        parts[b] = lanes_tree(vals[b * rows:(b + 1) * rows])
        written[b] = True
        ticket += 1
        if ticket == sp.blocks:  # the last ticket: every partial is written
            assert written.all()
            out = lanes_tree(parts)
            finishes += 1
    return out, finishes


def _bn_train_model(x, m, scale, run_mean, run_var, momentum, eps, sp,
                    order):
    """KG's moments (bn_train_stats) in numpy f32 over the blocked sums:
    (mean, var_raw, inv, count, run_mean, run_var) with JAX's clamps."""
    f32 = np.float32
    c = x.shape[1]
    f = x * m[:, None].astype(f32)
    sums, finishes = _bn_blocked_sums(np.concatenate([f, f * f], 1), sp,
                                      order)
    assert finishes == 1
    count = f32(max(int(m.sum()), 1))  # an integer count, exact
    mean = sums[:c] / count
    var_raw = sums[c:] / count - mean * mean
    var = np.maximum(var_raw, f32(0))
    unbiased = var * count / max(count - f32(1), f32(1))
    mom = f32(momentum)
    new_mean = (f32(1) - mom) * run_mean + mom * mean
    new_var = (f32(1) - mom) * run_var + mom * unbiased
    inv = scale / np.sqrt(var + f32(eps))
    return mean, var_raw, inv, np.array([count]), new_mean, new_var


def _bn_bwd_model(dy, y, x, m, scale, mean, var_raw, inv, count, eps, sp,
                  order):
    """KH (bn_bwd_reduce, then bn_bwd_apply) in numpy f32 over the blocked
    sums, with the ReLU gate: (dx, dscale, dbias)."""
    f32 = np.float32
    c = x.shape[1]
    mf = m[:, None].astype(f32)
    g = np.where(y > 0, dy, f32(0))
    gm = g * mf
    sums, finishes = _bn_blocked_sums(
        np.concatenate([gm, gm * (x - mean)], 1), sp, order)
    assert finishes == 1
    s1, s2 = sums[:c], sums[c:]
    ve = np.maximum(var_raw, f32(0)) + f32(eps)
    rstd = f32(1) / np.sqrt(ve)
    tie = np.where(var_raw > 0, f32(1), np.where(var_raw == 0, f32(0.5),
                                                 f32(0)))
    dvar = s2 * scale * (f32(-0.5) * rstd / ve) * tie
    dmean = -(s1 * inv) - f32(2) * mean * dvar
    a, b = dmean / count, f32(2) * dvar / count
    dx = gm * inv + mf * (a + b * x)
    return dx, s2 * rstd, s1


# (n, c, blocks target or None for BN_REDUCE_BLOCKS) of each model case
BN_MODEL_CASES = {"c24": (300, 24, None), "odd_c": (1000, 37, None),
                  "empty_mask": (300, 24, None), "one_row": (300, 24, None),
                  "constant": (513, 24, None), "long_runs": (3001, 24, 7)}


@pytest.mark.parametrize("case", list(BN_MODEL_CASES))
def test_bn_blocked_model(case, monkeypatch):
    """A numpy f32 model of KG's and KH's reductions (csrc/masked_bn.cu)
    as blocked by bn_split, in both the f32 and the bf16 split of the
    rows: bitwise the same under several orders in which the blocks
    finish, and within 1e-5 of max |plain| of bn_train_fwd_plain /
    bn_train_bwd_plain (f32 sums in another order).  Cases: C = 24, an
    odd C (the scalar path), a mask with no row (count clamped at 1), one
    row (count - 1 clamped at 1), constant channels (var_raw exactly 0)
    and given var_raw of 0 and below 0 in the backward (JAX's 1/2 at a
    tie, 0 below), rows not a multiple of a block's run, and blocks that
    walk several steps (a target of 7 blocks)."""
    import torch

    from lidog_tpu_torch.ops import norm

    n, c, blocks = BN_MODEL_CASES[case]
    rng = np.random.default_rng(list(BN_MODEL_CASES).index(case))
    x = (rng.standard_normal((n, c)) * 2 + 0.5).astype(np.float32)
    m = rng.random(n) > 0.3
    if case == "empty_mask":
        m[:] = False
    elif case == "one_row":
        m[:] = False
        m[n // 2] = True
    elif case == "constant":
        x[:, :3] = np.array([0.5, 0.0, -3.0], np.float32)  # exact sums
    res = rng.standard_normal((n, c)).astype(np.float32)
    dy = rng.standard_normal((n, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.2).astype(np.float32)
    run = [(rng.standard_normal(c) * 0.3).astype(np.float32),
           rng.uniform(0.3, 3.0, c).astype(np.float32)]
    t = torch.from_numpy
    run_p = [t(v.copy()) for v in run]
    y, mean, var_raw, inv, count = norm.bn_train_fwd_plain(
        t(x), t(m), t(scale), t(bias), *run_p, 0.1, 1e-5, t(res), True)
    want_fwd = [v.numpy() for v in (mean, var_raw, inv, count, *run_p)]
    if case == "constant":
        assert (want_fwd[1][:3] == 0).all()
        var_raw = var_raw.clone()
        var_raw[3:5] = torch.tensor([0.0, -1e-3])  # a tie, and below 0
    if case in ("empty_mask", "one_row"):
        assert float(count) == 1.0
    bwd_in = [v.numpy() for v in (y, mean, var_raw, inv, count)]
    dx, dscale, dbias, _ = norm.bn_train_bwd_plain(
        t(dy), y, t(x), t(m), t(scale), mean, var_raw, inv, count, 1e-5,
        True, True)
    want_bwd = [v.numpy() for v in (dx, dscale, dbias)]
    if blocks:
        monkeypatch.setattr(norm, "BN_REDUCE_BLOCKS", blocks)
    for esz in (4, 2):
        sp = norm.bn_split(n, c, esz, reduce=True)
        if case == "long_runs":
            assert sp.steps > 1 and sp.blocks > 1
        orders = [np.arange(sp.blocks), np.arange(sp.blocks)[::-1],
                  *(rng.permutation(sp.blocks) for _ in range(3))]
        fwd = [_bn_train_model(x, m, scale, *run, 0.1, 1e-5, sp, o)
               for o in orders]
        bwd = [_bn_bwd_model(dy, bwd_in[0], x, m, scale, *bwd_in[1:], 1e-5,
                             sp, o) for o in orders]
        for got in fwd[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(got, fwd[0]))
        for got in bwd[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(got, bwd[0]))
        for name, want, got in zip(
                ("mean", "var_raw", "inv", "count", "run_mean", "run_var",
                 "dx", "dscale", "dbias"),
                want_fwd + want_bwd, list(fwd[0]) + list(bwd[0])):
            assert got.dtype == np.float32, name
            assert _rel(want, got) <= 1e-5, (case, esz, name,
                                              _rel(want, got))


@pytest.mark.parametrize("n", [0, 1, 37, 300, 102_400, 491_520])
def test_bn_split(n):
    """bn_split (KD, KG, KH): the 16-byte path only where a row is a
    multiple of 16 bytes and the tensors are aligned; the chunks cover the
    row's channel groups and the blocks every row exactly once, with no
    empty chunk or block; lanes a power of two, at most BN_MAX_THREADS
    threads (BN_REDUCE_THREADS in a reduction, BN_APPLY_THREADS in a
    streaming pass), at most BN_REDUCE_BLOCKS or BN_APPLY_BLOCKS blocks,
    a streaming pass's blocks at least BN_APPLY_STEPS steps long.  The
    thread caps are the ones csrc/masked_rows.cuh states (masked_bn.cu
    and instance_norm.cu check the split with them)."""
    import re

    from lidog_tpu_torch.ops import _cuda, norm

    src = (_cuda.CSRC / "masked_rows.cuh").read_text()
    for name, cap in (("MAX_THREADS", norm.BN_REDUCE_THREADS),
                      ("MAX_APPLY_THREADS", norm.BN_APPLY_THREADS)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         src).group(1) == str(cap), name

    for c in (1, 7, 24, 32, 37, 96, 256, 4100):
        for esz in (4, 2):
            for aligned in (True, False):
                for reduce in (False, True):
                    sp = norm.bn_split(n, c, esz, aligned, reduce)
                    cap = (norm.BN_REDUCE_THREADS if reduce
                           else norm.BN_APPLY_THREADS)
                    wide = aligned and (c * esz) % 16 == 0
                    assert sp.vec == (16 // esz if wide else 1)
                    assert sp.groups * sp.vec == c
                    assert sp.gpb * (sp.chunks - 1) < sp.groups \
                        <= sp.gpb * sp.chunks
                    assert sp.lanes & (sp.lanes - 1) == 0
                    assert sp.threads == sp.gpb * sp.lanes <= cap
                    assert 2 * sp.threads > cap or sp.gpb == sp.groups
                    limit = (norm.BN_REDUCE_BLOCKS if reduce
                             else norm.BN_APPLY_BLOCKS)
                    assert 1 <= sp.blocks <= limit and sp.steps >= 1
                    assert reduce or sp.steps >= norm.BN_APPLY_STEPS
                    run = sp.lanes * sp.steps
                    if n == 0:
                        assert sp.blocks == 1
                    else:
                        assert (sp.blocks - 1) * run < n <= sp.blocks * run
            if c != 96 or esz != 2:
                continue
            # every row once: block b, lane j, step i take row
            # b * run + i * lanes + j
            sp = norm.bn_split(n, c, esz, True, reduce=True)
            run = sp.lanes * sp.steps
            r = (np.arange(sp.blocks)[:, None, None] * run
                 + np.arange(sp.steps)[None, :, None] * sp.lanes
                 + np.arange(sp.lanes)[None, None, :]).ravel()
            assert np.array_equal(np.sort(r[r < n]), np.arange(n))
            assert (sp.vec, sp.gpb, sp.lanes, sp.threads) == (8, 12, 32, 384)


def _in_blocked_sums(vals, seg, segs, sp, order, units):
    """The f32 per-segment column sums of KK's and KL's reductions
    (csrc/instance_norm.cu) over vals [n, k], row r in segment seg[r] (-1:
    in none), as blocked by the split sp: each block, in the finish order
    `order`, finds the segments of its run of lanes * steps rows and, for
    each in increasing order, sums its rows of that segment per lane
    (lane j takes rows j, j + lanes, ... in order) and over its lanes by
    the pairwise tree into its partial row [b, s], then writes its bit
    word and draws a ticket; the block that draws the last ticket sums,
    per segment, the partial rows of the blocks whose bit is set: G lanes
    a segment and channel group (as finish_lanes chooses G for `units`
    channel groups a segment), lane q taking the blocks q, q + G, ... in
    order, then the G sums added pairwise (lane q takes lane q + h, h = 1,
    2, ..., G / 2).  Returns the sums [segs, k], the row counts [segs],
    the most segments one block met and how many blocks ran that
    finish."""
    rows = sp.lanes * sp.steps
    k = vals.shape[1]
    parts = np.full((sp.blocks, segs, k), np.nan, np.float32)  # no fill
    counts = np.zeros((sp.blocks, segs), np.int64)
    bits = np.full(sp.blocks, -1, np.int64)

    def lanes_tree(v):
        acc = np.zeros((sp.lanes, k), np.float32)
        for i in range(0, len(v), sp.lanes):
            step = v[i:i + sp.lanes]
            acc[:len(step)] += step
        h = sp.lanes // 2
        while h:
            acc[:h] += acc[h:2 * h]
            h //= 2
        return acc[0]

    ticket, finishes, most, out, cnt = 0, 0, 0, None, None
    for b in order:
        run = slice(b * rows, (b + 1) * rows)
        met = sorted(set(seg[run][seg[run] >= 0].tolist()))
        most = max(most, len(met))
        for s_ in met:
            on = seg[run] == s_
            parts[b, s_] = lanes_tree(np.where(on[:, None], vals[run],
                                               np.float32(0)))
            counts[b, s_] = on.sum()
        bits[b] = sum(1 << s_ for s_ in met)
        ticket += 1
        if ticket == sp.blocks:  # the last ticket: every bit word written
            assert (bits >= 0).all()
            out = np.zeros((segs, k), np.float32)
            cnt = np.zeros(segs, np.int64)
            nset = bin(int(np.bitwise_or.reduce(bits))).count("1")
            g = 1  # csrc/instance_norm.cu finish_lanes
            while g < 32 and nset * units * g * 2 <= sp.threads // 32 * 32:
                g *= 2
            for s_ in range(segs):
                have = (bits >> s_) & 1 == 1
                lanes = np.zeros((g, k), np.float32)
                for b2 in np.flatnonzero(have):  # the others wrote none
                    lanes[b2 % g] += parts[b2, s_]
                h = 1
                while h < g:
                    lanes[::2 * h] += lanes[h::2 * h]
                    h *= 2
                out[s_] = lanes[0]
                cnt[s_] = counts[have, s_].sum()
            finishes += 1
    return out, cnt, most, finishes


def _in_model(x, m, bidx, dy, segs, eps, sp, order):
    """KK and KL (instance_norm_fwd, instance_norm_bwd) in numpy f32 over
    the blocked sums: (y, mean, var_raw, rstd, count), then dx, with
    JAX's clamps and its 1/2 at var_raw == 0; the streaming passes take a
    masked row to the padding segment.  Also the most segments a block of
    the sums met."""
    f32 = np.float32
    c = x.shape[1]
    mf = m[:, None].astype(f32)
    real_seg = np.where(m & (bidx >= 0) & (bidx < segs), bidx, -1)
    seg = np.where(m, np.clip(bidx, 0, segs - 1), segs - 1)
    units = c // (4 if sp.vec > 1 else 1)  # the finish's channel groups
    sums, cnt, most, finishes = _in_blocked_sums(
        np.concatenate([x, x * x], 1), real_seg, segs, sp, order, units)
    assert finishes == 1
    count = np.maximum(cnt, 1).astype(f32)[:, None]
    mean = sums[:, :c] / count
    var_raw = sums[:, c:] / count - mean * mean
    rstd = f32(1) / np.sqrt(np.maximum(var_raw, f32(0)) + f32(eps))
    f = x * mf
    y = (f - mean[seg]) * rstd[seg] * mf
    g = dy * mf
    sums, _, _, finishes = _in_blocked_sums(
        np.concatenate([dy, dy * (x - mean[seg])], 1), real_seg, segs, sp,
        order, units)
    assert finishes == 1
    s1, s2 = sums[:, :c], sums[:, c:]
    ve = np.maximum(var_raw, f32(0)) + f32(eps)
    tie = np.where(var_raw > 0, f32(1), np.where(var_raw == 0, f32(0.5),
                                                 f32(0)))
    dvar = s2 * (f32(-0.5) * rstd / ve) * tie
    dmean = -(s1 * rstd) - f32(2) * mean * dvar
    a, b = dmean / count, f32(2) * dvar / count
    dx = (g * rstd[seg] + a[seg] + b[seg] * f) * mf
    return (y, mean, var_raw, rstd, count[:, 0], dx), most


# (n, c, scans, blocks target or None for BN_REDUCE_BLOCKS) of each case
IN_MODEL_CASES = {"contiguous": (3001, 24, 4, 7), "shuffled": (1000, 24, 16, None),
                  "three_segments": (300, 24, 8, None),
                  "empty_mask": (300, 24, 4, None), "one_row": (300, 24, 4, None),
                  "odd_c": (1000, 37, 4, None)}


@pytest.mark.parametrize("case", list(IN_MODEL_CASES))
def test_in_blocked_model(case, monkeypatch):
    """A numpy f32 model of KK's and KL's segmented reductions
    (csrc/instance_norm.cu) as blocked by bn_split, in both the f32 and
    the bf16 split of the rows: bitwise the same under several orders in
    which the blocks finish, and within 1e-5 of max |plain| of
    instance_norm_fwd_plain / instance_norm_bwd_plain (f32 sums in another
    order).  Cases: the scans' rows contiguous as in a plan level (7
    blocks, several steps each, one or two segments a block), batch ids
    shuffled over the rows, a block's run over 3 or more scans, a mask
    with no row (every count clamped at 1), a scan of one row (its
    var_raw exactly 0: JAX's 1/2 at the tie), and width 37 (the scalar
    path); masked rows carry random batch ids."""
    import torch

    from lidog_tpu_torch.ops import norm

    n, c, scans, blocks = IN_MODEL_CASES[case]
    rng = np.random.default_rng(17 + list(IN_MODEL_CASES).index(case))
    bidx = np.sort(rng.integers(0, scans, n)).astype(np.int32)
    if case == "shuffled":
        rng.shuffle(bidx)
    m = rng.random(n) > 0.3
    bidx[~m] = rng.integers(0, norm.NUM_BATCHES + 1, (~m).sum())
    if case == "empty_mask":
        m[:] = False
    elif case == "one_row":
        m[bidx == 2] = False
        bidx[n // 2], m[n // 2] = 2, True
    x = (rng.standard_normal((n, c)) * 2 + 0.7).astype(np.float32)
    x[:, 3] *= 40.0  # a wide channel
    dy = rng.standard_normal((n, c)).astype(np.float32)
    segs = norm.NUM_BATCHES + 1
    t = torch.from_numpy
    y, mean, var_raw, rstd, count = norm.instance_norm_fwd_plain(
        t(x), t(m), t(bidx))
    dx = norm.instance_norm_bwd_plain(t(dy), t(x), t(m), t(bidx), mean,
                                      var_raw, rstd, count)
    want = [v.numpy() for v in (y, mean, var_raw, rstd, count, dx)]
    if case == "one_row":
        assert want[2][2].max() == 0 and (want[0][n // 2] == 0).all()
    if case == "empty_mask":
        assert (want[4] == 1).all()
    if blocks:
        monkeypatch.setattr(norm, "BN_REDUCE_BLOCKS", blocks)
    for esz in (4, 2):
        sp = norm._in_plan(n, c, esz, True, segs).sums
        if case == "contiguous":
            assert sp.steps > 1 and sp.blocks > 1
        orders = [np.arange(sp.blocks), np.arange(sp.blocks)[::-1],
                  *(rng.permutation(sp.blocks) for _ in range(3))]
        runs = [_in_model(x, m, bidx, dy, segs, 1e-5, sp, o)
                for o in orders]
        most = runs[0][1]
        assert most == {"contiguous": 2, "shuffled": scans,
                        "empty_mask": 0}.get(case, most), (esz, most)
        if case == "three_segments":
            assert most >= 3, most
        for got, _ in runs[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(got, runs[0][0]))
        got = runs[0][0]
        if case == "one_row":
            assert got[2][2].max() == 0 and (got[0][n // 2] == 0).all()
        for name, w, g in zip(("y", "mean", "var_raw", "rstd", "count", "dx"),
                              want, got):
            assert g.dtype == np.float32, name
            assert _rel(w, g) <= 1e-5, (case, esz, name, _rel(w, g))


@pytest.mark.parametrize("n", [0, 1, 37, 300, 102_400, 491_520])
def test_in_split(n):
    """KK's and KL's launch plan (ops/norm.py _in_plan) against the C
    constants: the sums take bn_split's reduction, the streaming pass its
    streaming split, with csrc/masked_rows.cuh's thread caps and at most
    csrc/instance_norm.cu's MAX_SUM_BLOCKS blocks of sums, and the C
    arguments are the two splits in order; the segments a launch takes
    (num_batches + 1) at most csrc/instance_norm.cu's MAX_SEGMENTS, one
    bit each in a 32-bit word, and the wrapper refuses more; each region
    of KK's and KL's workspaces starts 16-byte aligned, after the one
    before it, inside the workspace; the plan kept per shape is the one
    made anew."""
    import re

    from lidog_tpu_torch.ops import _cuda, norm

    head = (_cuda.CSRC / "masked_rows.cuh").read_text()
    src = (_cuda.CSRC / "instance_norm.cu").read_text()
    for text, name, value in ((head, "MAX_THREADS", norm.BN_REDUCE_THREADS),
                              (head, "MAX_APPLY_THREADS", norm.BN_APPLY_THREADS),
                              (src, "MAX_SEGMENTS", norm.IN_MAX_SEGMENTS)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         text).group(1) == str(value), name
    max_blocks = int(re.search(r"constexpr int MAX_SUM_BLOCKS = (\d+);",
                               src).group(1))
    assert norm.IN_MAX_SEGMENTS <= 32
    ns = norm.NUM_BATCHES + 1
    assert ns <= norm.IN_MAX_SEGMENTS
    for c in (24, 32, 37, 64, 128):
        for esz in (4, 2):
            for aligned in (True, False):
                plan = norm._in_plan(n, c, esz, aligned, ns)
                sums, apply = plan.sums, plan.apply
                assert sums == norm.bn_split(n, c, esz, aligned, reduce=True)
                assert apply == norm.bn_split(n, c, esz, aligned)
                assert sums.threads <= norm.BN_REDUCE_THREADS
                assert apply.threads <= norm.BN_APPLY_THREADS
                assert sums.blocks <= max_blocks
                assert sums.vec == apply.vec
                assert plan.args == (*norm._split_args(sums),
                                     *norm._split_args(apply))
                norm._IN_PLANS.clear()
                assert norm._in_plan(n, c, esz, aligned, ns) == plan
                sc, part = ns * c, sums.blocks * ns * c
                for sizes, (offs, size) in (
                        ((3 * sc, ns, part, part, sums.blocks * ns,
                          sums.blocks), plan.fwd),
                        ((part, part, sums.blocks, sc, sc), plan.bwd)):
                    ends = [o + k for o, k in zip(offs, sizes)]
                    assert len(offs) == len(sizes)
                    assert all(o % 4 == 0 for o in offs)
                    assert offs[0] == 0 and ends[-1] <= size
                    assert all(e <= o for e, o in zip(ends, offs[1:]))
    with pytest.raises(ValueError, match="segments"):
        norm._in_segments("instance_norm_fwd", norm.IN_MAX_SEGMENTS + 1)
    norm._in_segments("instance_norm_fwd", norm.NUM_BATCHES + 1)


def _ulp(a, dtype):
    """One unit in the last place of dtype at |a| (a as float32 numpy)."""
    mant = {"float32": 23, "bfloat16": 7}[dtype]
    _, e = np.frexp(np.abs(np.asarray(a, np.float32)))
    return np.ldexp(np.float32(1.0), e - 1 - mant)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bev_scatter_pooled_match_jax(dtype, request):
    """bev_scatter_pooled forward and VJP against lidog_tpu's, with both of
    its backward plans (segmented_rows), at pool strides 3 and 5 on a 40^2
    grid of 2 scans.  The rows include masked ones, coords off the grid,
    exact ties (same pixel, same features), all-zero rows and negative
    values.  Forward: equal.  Grad: f32 within 1e-6 of max |JAX grad|,
    bf16 within 1 ulp (both sum the same terms in f32 in the same order
    and round once)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops.bev import bev_scatter_pooled as jax_bev
    from lidog_tpu_torch.ops import bev as tb

    rng = np.random.RandomState(5)
    grid, n_per, c = 40, 150, 4
    n = 2 * n_per
    coords = np.hstack([
        np.repeat([[0], [1]], n_per, axis=0),  # per-scan segmented rows
        rng.randint(-grid // 2 - 3, grid // 2 + 3, (n, 2)),  # some off grid
        rng.randint(-5, 5, (n, 1)),
    ]).astype(np.int32)
    feats = rng.randn(n, c).astype(np.float32)
    feats[rng.rand(n) < 0.3] = 0.0  # ReLU-like zero rows
    coords[20:40, :3] = coords[0:20, :3]  # same pixel, another z
    feats[20:40] = feats[0:20]  # exact ties
    mask = rng.rand(n) > 0.1
    dout = rng.randn(*(2, 13, 13, c)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    launches = dict(tb.LAUNCHES)
    for stride in (3, 5):
        fj = jnp.asarray(feats, jdt)
        kw = dict(num_batches=2, voxel_size=1.0, bound=grid / 2,
                  pool_stride=stride)
        ft = torch.from_numpy(feats).to(tdt).requires_grad_()
        out_t = tb.bev_scatter_pooled(torch.from_numpy(coords), ft,
                                      torch.from_numpy(mask), **kw)
        hw = out_t.shape[1]
        dj = dout[:, :hw, :hw]
        out_t.backward(torch.from_numpy(np.ascontiguousarray(dj)).to(tdt))
        g_t = ft.grad.float().numpy()
        assert (g_t != 0).sum() > 20, stride
        for seg in (False, True):
            out_j, vjp = jax.vjp(jax.jit(lambda f: jax_bev(
                jnp.asarray(coords), f, jnp.asarray(mask),
                segmented_rows=seg, **kw)), fj)
            np.testing.assert_array_equal(
                np.asarray(out_j.astype(jnp.float32)),
                out_t.detach().float().numpy(), err_msg=f"{stride} {seg}")
            g_j = np.asarray(vjp(jnp.asarray(dj, jdt))[0].astype(jnp.float32))
            if dtype == "float32":
                assert _rel(g_j, g_t) <= 1e-6, (stride, seg)
            else:
                assert (np.abs(g_j - g_t) <= _ulp(g_j, dtype)).all(), \
                    (stride, seg)
        assert (out_t > 0).sum() > 20, stride
    assert tb.LAUNCHES == launches  # the CPU path launches no kernel


def _bev_geo(coords, mask, geom):
    """csrc/bev_scatter_max.cu row_geo over all rows: (b, or -1 for a row
    that is not live; the first iy and ix; the cells per axis ny, nx),
    int64 tensors."""
    import torch

    nb, grid, out_hw, window, stride, pad = geom
    c = coords.long()
    half = grid // 2
    b, px, py = c[:, 0], c[:, 1] + half, grid - 1 - (c[:, 2] + half)
    back = window - 1 - pad

    def floor(a):
        return torch.div(a, stride, rounding_mode="floor")

    ylo, yhi = (-floor(back - py)).clamp(min=0), floor(py + pad).clamp(
        max=out_hw - 1)
    xlo, xhi = (-floor(back - px)).clamp(min=0), floor(px + pad).clamp(
        max=out_hw - 1)
    live = (mask & (b >= 0) & (b < nb) & (px >= 0) & (px < grid) & (py >= 0)
            & (py < grid) & (ylo <= yhi) & (xlo <= xhi))
    return (torch.where(live, b, -1), ylo, xlo, yhi - ylo + 1,
            xhi - xlo + 1)


def _bev_csrc_constants():
    """csrc/bev_scatter_max.cu's RUN_ROWS_BF16, RUN_ROWS_F32 and MAX_CANDS,
    which the models below follow: the rows a KI task walks in bf16 and
    f32, and the most cells per axis KI holds in registers (above it, or
    on a grid of 2^31 cells or more, each live (row, candidate) reduces
    directly)."""
    import re

    from lidog_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / "bev_scatter_max.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("RUN_ROWS_BF16", "RUN_ROWS_F32", "MAX_CANDS")}


def _bev_held(nb, out_hw, window, stride, consts):
    """Whether KI holds cells (csrc launch_fwd)."""
    return (-(-window // stride) <= consts["MAX_CANDS"]
            and nb * out_hw * out_hw < 2**31 - 1)


def _bev_model_fwd(bits, coords, mask, geom, esz, wide):
    """KI (csrc scatter_max_held_kernel, scatter_max_direct_kernel)
    transliterated in torch over the element bits [n, c] (int64, the
    unsigned bits of bf16 or f32): tasks of one chunk (16 bytes when
    `wide`, else 4) of a run of RUN_ROWS_BF16 or RUN_ROWS_F32 rows (csrc
    make_split); values not > 0 (bits outside 1 .. +inf) become +0;
    a task holds the running max of each cell its live row reaches in slot
    (iy % cands, ix % cands) and flushes a held cell (a max into the grid,
    none for a chunk of +0) when the next live row of the run does not
    reach it, and every held cell at the run's end; where _bev_held is
    false each live (row, candidate) flushes directly.
    Returns the grid's bits, the cells flushed and the reductions issued
    (one a flushed cell and nonzero chunk).  A slot that holds no cell
    merges nothing that is ever flushed, so the model skips it."""
    import torch

    consts = _bev_csrc_constants()
    nb, grid, out_hw, window, stride, pad = geom
    n, c = bits.shape
    r = consts["RUN_ROWS_BF16" if esz == 2 else "RUN_ROWS_F32"]
    e = (16 if wide else 4) // esz  # elements a chunk
    chunks = c // e
    assert chunks * e == c
    runs = -(-n // r)
    pad_rows = runs * r - n
    geo = [torch.cat([g, g.new_full((pad_rows,), -1 if i == 0 else 0)])
           .view(runs, r) for i, g in enumerate(_bev_geo(coords, mask, geom))]
    b, ylo, xlo, ny, nx = geo
    top = 0x7F80 if esz == 2 else 0x7F800000
    v = torch.where((bits >= 1) & (bits <= top), bits, 0)
    v = torch.cat([v, v.new_zeros(pad_rows, c)]).view(runs, r, chunks, e)
    v[b < 0] = 0  # a row that is not live loads nothing
    out = torch.zeros(nb * out_hw * out_hw, c, dtype=torch.int64)
    stats = {"cells": 0, "reductions": 0}

    def flush(cells, vals):
        stats["cells"] += cells.numel()
        stats["reductions"] += int(vals.ne(0).any(-1).sum())
        out.scatter_reduce_(0, cells[:, None].expand(-1, c),
                            vals.reshape(-1, c), "amax")

    cands = -(-window // stride)
    if not _bev_held(nb, out_hw, window, stride, consts):  # directly
        for i in range(r):
            for dy in range(cands):
                for dx in range(cands):
                    on = (b[:, i] >= 0) & (dy < ny[:, i]) & (dx < nx[:, i])
                    flush(((b * out_hw + ylo + dy) * out_hw + xlo
                           + dx)[on, i], v[on, i])
        return out, stats["cells"], stats["reductions"]
    k2 = cands * cands
    held = torch.full((runs, k2), -1, dtype=torch.int64)
    hv = torch.zeros(runs, k2, chunks, e, dtype=torch.int64)
    for i in range(r):
        row = b[:, i] >= 0
        base = (b[:, i] * out_hw + ylo[:, i]) * out_hw + xlo[:, i]
        for sy in range(cands):
            dy = (sy - ylo[:, i] % cands) % cands
            for sx in range(cands):
                dx = (sx - xlo[:, i] % cands) % cands
                k = sy * cands + sx
                cell = torch.where(row & (dy < ny[:, i]) & (dx < nx[:, i]),
                                   base + dy * out_hw + dx, -1)
                same = cell == held[:, k]
                m = row & same & (cell >= 0)
                hv[m, k] = torch.maximum(hv[m, k], v[m, i])
                f = row & ~same & (held[:, k] >= 0)
                flush(held[f, k], hv[f, k])
                s = row & ~same
                held[s, k] = cell[s]
                hv[s, k] = v[s, i]
    f = held >= 0
    flush(held[f], hv[f])
    return out, stats["cells"], stats["reductions"]


def _bev_model_bwd(feats, coords, mask, out, dout, geom):
    """KJ (csrc scatter_max_bwd_kernel) in torch f32: each element of a
    live row adds, at each of its cells in candidate order (dy, then dx),
    the cell's cotangent where it equals the cell's value; a row that is
    not live gets 0.  The chunking splits only the elements."""
    import torch

    nb, grid, out_hw, window, stride, pad = geom
    c = feats.shape[1]
    b, ylo, xlo, ny, nx = _bev_geo(coords, mask, geom)
    f, out_f = feats.float(), out.float().reshape(-1, c)
    dout_f = dout.float().reshape(-1, c)
    acc = torch.zeros(f.shape)
    cands = -(-window // stride)
    for dy in range(cands):
        for dx in range(cands):
            on = (b >= 0) & (dy < ny) & (dx < nx)
            cell = torch.where(on, (b * out_hw + ylo + dy) * out_hw + xlo + dx,
                               0)
            won = on[:, None] & (f == out_f[cell])
            acc = torch.where(won, acc + dout_f[cell], acc)
    return acc


def _bev_model_inputs(rng, grid, c, run_rows):
    """Two scans' rows in canonical order (lex-sorted by b, x, y, z), with
    the rows of one column adjacent and a blob of neighbouring columns,
    the first scan's row count not a multiple of run_rows (a run crosses
    the boundary), rows of scan 2 (b >= nb), rows off the grid, masked
    rows, exact ties (a column's rows, and a row of the next column, given
    the same features), -0.0, NaN, negatives and all-zero rows."""
    rows = []
    for b, cols in ((0, 37), (1, 30), (2, 3)):
        xy = rng.choice(13 * 13, cols, replace=False)
        for x, y in zip(xy // 13 - 6, xy % 13 - 6):
            for z in sorted(rng.choice(6, rng.integers(1, 4), replace=False)):
                rows.append((b, x, y, z))
    for _ in range(6):  # off the grid
        rows.append((int(rng.integers(0, 2)), grid // 2 + int(
            rng.integers(0, 3)), int(rng.integers(-3, 3)), 0))
    if sum(r[0] == 0 for r in rows) % run_rows == 0:
        rows.append((0, 7, 0, 0))
    coords = np.array(sorted(rows), np.int32)
    n = len(coords)
    feats = rng.standard_normal((n, c)).astype(np.float32)
    feats[rng.random(n) < 0.25] = 0.0  # ReLU-like all-zero rows
    same_px = np.flatnonzero((coords[1:, :3] == coords[:-1, :3]).all(1))
    feats[same_px[::2] + 1] = feats[same_px[::2]]  # exact ties, one column
    next_col = np.flatnonzero((coords[1:, :2] == coords[:-1, :2]).all(1)
                              & (coords[1:, 2] == coords[:-1, 2] + 1))
    feats[next_col[::3] + 1] = feats[next_col[::3]]  # ties, the next y
    feats[rng.random((n, c)) < 0.05] = -0.0
    feats[rng.random((n, c)) < 0.03] = np.nan
    mask = rng.random(n) > 0.15
    return coords, feats, mask


# pool stride (window 5, pad 1: 4, 25, 1 and 9 candidates), channels, and
# the dtype held against lidog_tpu
BEV_MODEL_CASES = {"stride3_c16": (3, 16, "float32"),
                   "stride1_c4": (1, 4, "bfloat16"),
                   "stride5_c2": (5, 2, "float32"),
                   "stride3_c10": (3, 10, "bfloat16"),
                   "stride2_c8": (2, 8, "float32")}


@pytest.mark.parametrize("case", list(BEV_MODEL_CASES))
def test_bev_blocked_model(case):
    """Torch models of KI's and KJ's work split (csrc/bev_scatter_max.cu,
    with the source's run lengths and holding limit) at pool strides 3, 1,
    5 and 2 on a 40^2 grid of 2 scans, bf16 and f32, in 16-byte chunks
    where a row is a multiple of 16 bytes and in 4-byte chunks always (C =
    2, 4, 10: a bf16 row of 4 or 20 bytes takes the 4-byte form): the
    forward's bits equal bev_scatter_max_plain's and the backward's
    bev_scatter_max_bwd_plain's, and the forward's cell flushes fall below
    the live (row, candidate) pairs where cells are held.  Against
    lidog_tpu's bev_scatter_pooled forward and VJP in the case's dtype,
    with test_bev_scatter_pooled_match_jax's tolerances (forward equal, f32
    grad within 1e-6 of max |JAX grad|, bf16 within 1 ulp), on the same
    rows with each NaN replaced by -1.0; and the forward on the rows with
    their NaNs, at the cells no NaN reaches (ROADMAP queue 3 item 6: where
    a live NaN lands, lidog_tpu's cell is NaN and the port's the max of
    the cell's other values, a known difference).  One XLA compile a case
    (forward and VJP in one function, backend optimisation level 0)."""
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops.bev import bev_scatter_pooled as jax_bev
    from lidog_tpu_torch.ops import bev

    consts = _bev_csrc_constants()
    stride, c, jax_dtype = BEV_MODEL_CASES[case]
    rng = np.random.default_rng(23 + list(BEV_MODEL_CASES).index(case))
    grid = 40
    coords, feats, mask = _bev_model_inputs(rng, grid, c,
                                            consts["RUN_ROWS_BF16"])
    hw = bev.pooled_size(grid, 5, stride, 1)
    geom = (2, grid, hw, 5, stride, 1)
    ct, mt = torch.from_numpy(coords), torch.from_numpy(mask)
    # a run crosses from scan 0 into scan 1
    assert (coords[:, 0] == 0).sum() % consts["RUN_ROWS_BF16"]
    pairs = int(bev.candidates(ct, mt, *geom)[1].sum())
    dout = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    for dtype, esz in (("float32", 4), ("bfloat16", 2)):
        tdt, itype = getattr(torch, dtype), (torch.int16 if esz == 2
                                             else torch.int32)
        ft = torch.from_numpy(feats).to(tdt)
        dt_ = torch.from_numpy(dout).to(tdt)
        ibits = ft.view(itype).long() & (0xFFFF if esz == 2 else 0xFFFFFFFF)
        out_p = bev.bev_scatter_max_plain(ft, ct, mt, *geom)
        g_p = bev.bev_scatter_max_bwd_plain(ft, ct, mt, out_p, dt_, *geom)
        for wide in (False, True)[:1 + ((c * esz) % 16 == 0)]:
            bits, cells, reds = _bev_model_fwd(ibits, ct, mt, geom, esz, wide)
            assert torch.equal(bits.to(itype).view(out_p.shape),
                               out_p.view(itype)), (dtype, wide)
            if _bev_held(2, hw, 5, stride, consts):
                assert cells < pairs, (cells, pairs)
            else:
                assert cells == pairs, (cells, pairs)
            chunks = c * esz // (16 if wide else 4)
            assert 0 < reds <= cells * chunks, (reds, cells, chunks)
        g_m = _bev_model_bwd(ft, ct, mt, out_p, dt_, geom).to(tdt)
        assert torch.equal(g_m, g_p), dtype
        assert (g_p.float() != 0).sum() > 20 and (out_p > 0).sum() > 20
        if dtype != jax_dtype:
            continue
        fj = torch.from_numpy(np.where(np.isnan(feats), np.float32(-1.0),
                                       feats)).to(tdt)
        out_pj = bev.bev_scatter_max_plain(fj, ct, mt, *geom)
        g_pj = bev.bev_scatter_max_bwd_plain(fj, ct, mt, out_pj, dt_, *geom)
        jdt = jnp.dtype(dtype)

        def fwd_vjp(f, d):
            out, vjp = jax.vjp(lambda f: jax_bev(
                jnp.asarray(coords), f, jnp.asarray(mask), num_batches=2,
                voxel_size=1.0, bound=grid / 2, pool_stride=stride), f)
            return out, vjp(d)[0]

        f_j, d_j = jnp.asarray(fj.float().numpy(), jdt), jnp.asarray(dout,
                                                                      jdt)
        run = jax.jit(fwd_vjp).lower(f_j, d_j).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        out_j, g_j = (np.asarray(a.astype(jnp.float32))
                      for a in run(f_j, d_j))
        np.testing.assert_array_equal(out_j, out_pj.float().numpy(),
                                      err_msg=dtype)
        g_t = g_pj.float().numpy()
        if dtype == "float32":
            assert _rel(g_j, g_t) <= 1e-6, dtype
        else:
            assert (np.abs(g_j - g_t) <= _ulp(g_j, dtype)).all(), dtype
        # the rows with their NaNs: equal wherever no NaN lands in
        # lidog_tpu's forward (the NaN cells: ROADMAP queue 3 item 6)
        nan_j = np.asarray(run(jnp.asarray(feats, jdt), d_j)[0].astype(
            jnp.float32))
        lands = np.isnan(nan_j)
        assert lands.any() and (~lands).sum() > 20
        np.testing.assert_array_equal(nan_j[~lands],
                                      out_p.float().numpy()[~lands])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_match_jax(dtype, request):
    """MaskedInstanceNorm forward and its grad through JAX's autodiff, on
    rows of scans 0, 1, 3 and 5 of num_batches 16 (scan 2 absent, scan 5
    a single row), a quarter of the rows masked (they go to the padding
    segment), batch_idx read as a column of coords as the models pass
    it.  Relative to max |JAX| per tensor: f32 1e-5 (f32 sums in another
    order); bf16 2e-2 (the same two roundings, input and output, and one
    bf16 step where the f32 results round differently).  A single-row
    scan normalises to exactly 0; its variance is exactly 0, so JAX's
    max(var, 0) sits at its tie, where JAX's gradient is 1/2 each side:
    the port's backward applies the same rule, and the row's gradient
    (0 on both sides, since sum g (f - mean) = 0 there) is held too."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops.norm import MaskedInstanceNorm as JaxIN
    from lidog_tpu_torch.ops.norm import LAUNCHES, MaskedInstanceNorm

    rng = np.random.RandomState(14)
    n, c = 300, 24
    bidx = rng.choice([0, 1, 3], n).astype(np.int32)
    mask = rng.rand(n) > 0.25
    bidx[17], mask[17] = 5, True  # the one row of scan 5
    bidx[~mask] = rng.randint(0, 16, (~mask).sum())
    coords = np.zeros((n, 4), np.int32)
    coords[:, 0] = bidx
    x = (rng.randn(n, c) * 2 + 0.7).astype(np.float32)
    x[:, 3] *= 50.0  # a wide channel
    dy = rng.randn(n, c).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2

    yj, vjp = jax.vjp(lambda f: JaxIN().apply({}, f, jnp.asarray(mask),
                                              jnp.asarray(bidx)),
                      jnp.asarray(x, jdt))
    gj, = vjp(jnp.asarray(dy, jdt))
    launches = dict(LAUNCHES)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    ct = torch.from_numpy(coords)
    yt = MaskedInstanceNorm()(xt, torch.from_numpy(mask), ct[:, 0])
    yt.backward(torch.from_numpy(dy).to(tdt))
    assert yt.dtype == xt.grad.dtype == tdt
    for name, a, b in (("y", yj, yt), ("dx", gj, xt.grad)):
        a = np.asarray(a.astype(jnp.float32))
        b = b.detach().float().numpy()
        assert _rel(a, b) <= tol, (name, _rel(a, b))
        assert (b[~mask] == 0).all(), name
    assert (yt[17] == 0).all() and (np.asarray(yj[17]) == 0).all()
    assert np.abs(xt.grad[17].float().numpy()
                  - np.asarray(gj[17].astype(jnp.float32))).max() <= \
        tol * np.abs(np.asarray(gj.astype(jnp.float32))).max()
    assert LAUNCHES == launches  # the CPU path launches no kernel


@pytest.mark.parametrize("loss", ["IW", "IRW"])
def test_whitening_losses_match_jax(loss, request):
    """IW / IRW loss and its grad through JAX's autodiff, f32, on 200 rows
    x 16 channels with a fifth of the rows masked, a third of the entries
    exactly 0 and one all-zero real row (JAX's |x|' is +1 at 0, so a 0
    entry of a live row gets the row's sum |f|), and rows scaled up so
    that IRW's hinge is live on some rows and not on others.  Relative to
    max |JAX|: 1e-5 (f32 sums in another order)."""
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.losses import losses as jl
    from lidog_tpu_torch.losses import losses as tl

    rng = np.random.RandomState(15)
    n, c = 200, 16
    x = rng.randn(n, c).astype(np.float32)
    x[rng.rand(n, c) < 0.3] = 0.0
    x[5] = 0.0
    x *= np.where(rng.rand(n) < 0.3, 12.0, 1.0).astype(np.float32)[:, None]
    mask = rng.rand(n) > 0.2
    mask[5] = True
    jfn, tfn = {"IW": (jl.IWLoss(), tl.IWLoss()),
                "IRW": (jl.IRWLoss(), tl.IRWLoss())}[loss]
    lj, gj = jax.value_and_grad(lambda f: jfn(f, jnp.asarray(mask)))(
        jnp.asarray(x))
    launches = dict(tl.LAUNCHES)
    xt = torch.from_numpy(x).requires_grad_()
    lt = tfn(xt, torch.from_numpy(mask))
    lt.backward()
    assert lt.shape == () and float(lj) > 0
    assert abs(float(lj) - lt.item()) <= 1e-5 * abs(float(lj))
    g = xt.grad.numpy()
    assert _rel(np.asarray(gj), g) <= 1e-5
    assert (g[~mask] == 0).all() and (g[x == 0] != 0).any()
    if loss == "IRW":  # the hinge is live on some rows, not on others
        assert 0 < (np.abs(g).sum(1) > 0).sum() < mask.sum()
    assert tl.LAUNCHES == launches


@pytest.mark.parametrize("case", ["float32", "float32-2src-gate"])
def test_robustnet_step_matches_jax(case, request, monkeypatch):
    """The RobustNet step (narrow MinkUNet34Robust: instance norms KK/KL
    and IW's KM/KN on their plain versions; SoftDICE + 0.5 IW over the 5
    taps, Adam) against lidog_tpu's, two steps from a carried-over
    TrainState: loss, aux_loss, confusion, grads, params after Adam and
    batch_stats, with the tolerances of test_train_step_matches_jax.  The
    gate is on at both steps, or, with two sources, off at the first and
    on at the second.  The helper and its tolerances are in
    tests/test_torch_port_serve.py; the test sits here so that the three
    port files share the heavy parity tests."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    from tests.test_torch_port_serve import _variant_step_matches_jax

    _variant_step_matches_jax("robustnet", case, monkeypatch)


def _shapes_of(tree, prefix, out):
    """Flax tree of ShapeDtypeStructs -> {dotted key: (shape, dtype)}."""
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            _shapes_of(v, key, out)
        else:
            assert key not in out, key
            out[key] = (tuple(v.shape), str(v.dtype))
    return out


def test_variant_registry_and_weights():
    """get_model builds each of the four models from its YAML at full
    width, with the YAML's compute dtype, and its state_dict has exactly
    the keys and shapes of lidog_tpu's flax tree for the same YAML
    (jax.eval_shape of the init: traced, not compiled); so does
    MinkUNet34 from a YAML set to in_channels 4 (stem kernel [125, 4,
    32]), whose plan builder (make_plan_builder, lidog_tpu/cli/common.py's
    rule) emits the stem's source-row maps."""
    import jax
    import jax.numpy as jnp

    from lidog_tpu.config import get_config as jax_config
    from lidog_tpu.core.engine import input_tensor as jax_input
    from lidog_tpu.models.registry import get_model as jax_get_model
    from lidog_tpu.models.registry import precision_dtype as jax_precision
    from lidog_tpu_torch.caps import make_plan_builder
    from lidog_tpu_torch.config import get_config
    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.models.registry import get_model
    from tests.test_torch_port_serve import _jax_plan_of, _points, _torch_plan

    tvox, tplan = _torch_plan(_points())
    jplan = _jax_plan_of(tplan)
    x = jax_input(jplan, jnp.asarray(tvox.mask.numpy())[:, None].astype(
        jnp.float32))
    assert input_tensor(tplan, tvox.mask[:, None].float()).feats.shape == \
        x.feats.shape
    x4 = jax_input(jplan, jnp.ones((tvox.mask.shape[0], 4), jnp.float32))
    for method, name, cin in (("source", "MinkUNet34", 1),
                              ("ibn", "MinkUNet34IBN", 1),
                              ("robustnet", "MinkUNet34Robust", 1),
                              ("lidog", "MinkUNet34BEV", 1),
                              ("source", "MinkUNet34", 4)):
        path = f"configs/{method}/single/semantickitti.yaml"
        config, tconfig = jax_config(path), get_config(path)
        assert config.model.name == name and config.model.in_channels == 1
        config.model.in_channels = tconfig.model.in_channels = cin
        assert make_plan_builder(tconfig, 2).stem_feature_map == (cin != 1)
        jm = jax_get_model(config, num_batches=2)
        kw = {"is_train": True} if name == "MinkUNet34BEV" else {}
        shapes = jax.eval_shape(
            lambda k: jm.init(k, x if cin == 1 else x4, jplan, train=False,
                              **kw),
            jax.random.PRNGKey(0))
        want = {}
        for col in ("params", "batch_stats"):
            _shapes_of(shapes.get(col, {}), "", want)
        model = get_model(tconfig, num_batches=2)
        assert type(model).__name__ == name
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in model.state_dict().items()}
        assert got == want, (name, set(got) ^ set(want))
        stem = model.conv0 if hasattr(model, "conv0") else \
            model.backbone.conv0
        assert tuple(stem.kernel.shape) == (125, cin, 32)
        dt = getattr(model, "compute_dtype", None) or \
            model.backbone.compute_dtype
        assert str(dt) == f"torch.{jnp.dtype(jax_precision(config)).name}"


def test_softdice_confusion_match_jax():
    """SoftDICE (plain and is_kitti): loss and dlogits; the confusion
    matrix exactly and the IoU from it."""
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.losses.losses import SoftDICELoss as JaxDice
    from lidog_tpu.metrics.metrics import confusion_matrix as jax_cm
    from lidog_tpu.metrics.metrics import iou_from_confusion as jax_iou
    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.metrics.metrics import (confusion_matrix,
                                                 iou_from_confusion)

    rng = np.random.RandomState(8)
    n, c = 400, 7
    logits = (rng.randn(n, c) * 2).astype(np.float32)
    labels = rng.randint(-1, c, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    for kitti in (False, True):
        jl = JaxDice(ignore_label=-1, is_kitti=kitti)
        lj, gj = jax.value_and_grad(lambda z: jl(z, jnp.asarray(labels),
                                                 jnp.asarray(valid)))(
            jnp.asarray(logits))
        lt_in = torch.from_numpy(logits).requires_grad_()
        lt = SoftDICELoss(ignore_label=-1, is_kitti=kitti)(
            lt_in, torch.from_numpy(labels), torch.from_numpy(valid))
        lt.backward()
        assert abs(float(lj) - lt.item()) <= 1e-5 * abs(float(lj)), kitti
        assert _rel(np.asarray(gj), lt_in.grad) <= 1e-5, kitti
    preds = rng.randint(0, c, n).astype(np.int32)
    cm_j = np.asarray(jax_cm(jnp.asarray(preds), jnp.asarray(labels),
                             jnp.asarray(valid), c))
    cm_t = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels),
                            torch.from_numpy(valid), c)
    assert cm_t.dtype == torch.int32
    np.testing.assert_array_equal(cm_j, cm_t.numpy())
    np.testing.assert_allclose(np.asarray(jax_iou(jnp.asarray(cm_j))),
                               iou_from_confusion(cm_t).numpy(), rtol=1e-6)


@pytest.mark.parametrize("name,scheduler,wd", [
    ("Adam", None, 0.0), ("Adam", None, 1e-2), ("Adam", "ExponentialLR", 0.0),
    ("Adam", "CosineAnnealingLR", 1e-2), ("Adam", "CyclicLR", 0.0),
    ("SGD", None, 1e-2)])
def test_optimizer_matches_optax(name, scheduler, wd):
    """The port's optimizer against lidog_tpu's optax chain over 3 steps of
    the same gradients, one epoch per step (so each schedule moves)."""
    import jax.numpy as jnp
    import optax
    import torch

    from lidog_tpu.train.optim import make_optimizer as jax_make
    from lidog_tpu_torch.train.optim import make_optimizer, make_schedule

    rng = np.random.RandomState(9)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    kw = dict(lr=0.05, scheduler=scheduler, steps_per_epoch=1,
              weight_decay=wd)
    tx = jax_make(name, **kw)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = tx.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(name, **kw).build(pt.values())
    for step, g in enumerate(grads):
        upd, sj = tx.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            err = _rel(np.asarray(pj[k]), pt[k].detach())
            assert err <= 1e-6, (step, k, err)
    assert opt.count == 3
    if scheduler is not None:
        from lidog_tpu.train.optim import make_schedule as jax_sched

        sched_j, sched_t = jax_sched(scheduler, 0.05, 2), make_schedule(
            scheduler, 0.05, 2)
        for step in range(0, 60, 3):  # f32 there, f64 here: 1e-6 of lr
            assert abs(float(sched_j(step)) - sched_t(step)) <= 5e-8, step


def _edge_points(rng, b, p):
    """b scans of p points at voxel 0.5 with cells at and just beyond the
    ends of the 13-bit range (x, y or z of -4096, 4095, -4097, 4096),
    duplicates, and every 7th point invalid."""
    pts = ((rng.rand(b * p, 3) - 0.5) * 40.0).astype(np.float32)
    ends = np.array([-2048.0, 2047.75, -2048.25, 2048.0], np.float32)
    for a in range(3):
        pts[a::5, a] = ends[(np.arange(len(pts[a::5])) // 3) % 4]
    pts[1::11] = pts[0]  # duplicates of one voxel
    valid = np.ones(b * p, bool)
    valid[::7] = False
    return pts, valid, np.repeat(np.arange(b, dtype=np.int32), p)


def test_voxelize_bitwise_edges():
    """voxelize_device against lidog_tpu's with points at and just beyond
    the ends of the 13-bit cell range (+-4096 cells) and invalid points,
    4 scans, with and without the caller's batch size (the plain version
    that LC is held to on the card)."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.voxelize import voxelize_device as jax_vox
    from lidog_tpu_torch.core.voxelize import voxelize_device

    pts, valid, bidx = _edge_points(np.random.RandomState(5), 4, 300)
    for cap in (1024, 500):
        jv = jax_vox(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(bidx),
                     0.5, cap)
        for bs in (None, 4):
            tv = voxelize_device(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(bidx), 0.5, cap,
                                 batch_size=bs)
            for f in jv._fields:
                a, b = np.asarray(getattr(jv, f)), getattr(tv, f).numpy()
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f"{f} cap={cap}")
            assert int(tv.batch_breach) == 0
    coords = tv.coords.numpy()[tv.mask.numpy()]
    assert coords[:, 1:].min() == -4096 and coords[:, 1:].max() == 4095
    assert int(tv.overflow) > 0


def _lsd_order(u, passes, bits, tile):
    """A stable LSD radix sort of uint64 u over its low passes * bits bits,
    each pass as LC does it: a key's slot is its digit's start, plus the
    digit's count in the earlier tiles, plus its rank in its tile."""
    order = np.arange(len(u))
    radix = 1 << bits
    for p in range(passes):
        k = u[order]
        d = ((k >> np.uint64(bits * p)) & np.uint64(radix - 1)).astype(np.int64)
        start = np.concatenate([[0], np.cumsum(np.bincount(d, minlength=radix))])
        out = np.empty_like(order)
        seen = np.zeros(radix, np.int64)  # the earlier tiles' counts
        for t0 in range(0, len(d), tile):
            dt = d[t0:t0 + tile]
            rank = np.empty(len(dt), np.int64)
            for v in np.unique(dt):
                at = np.nonzero(dt == v)[0]
                rank[at] = np.arange(len(at))
            out[start[dt] + seen[dt] + rank] = order[t0:t0 + tile]
            seen += np.bincount(dt, minlength=radix)
        order = out
    return order


def _sort_key(disc, valid, batch_idx, invalid_key):
    """int64 [P]: the key LC sorts stably (before its sign flip), c = hi *
    2^26 + lo of keys.pack, invalid_key where keys.pack marks the point
    invalid."""
    import torch

    from lidog_tpu_torch.core import keys

    hi, lo = keys.pack(torch.cat([batch_idx[:, None].to(torch.int32), disc],
                                 dim=1), valid)
    ok = lo != keys.INVALID_KEY  # (a valid lo is below 2^26)
    c = hi.to(torch.int64) * (1 << 26) + lo.to(torch.int64)
    return torch.where(ok, c, torch.full_like(c, invalid_key))


@pytest.mark.parametrize("batch_size", [1, 4, 64, None])
def test_voxelize_passes_lsd(batch_size):
    """LC's pass plan (core/voxelize.py voxelize_passes, which the kernel
    runs): the packed key with the plan's invalid key, sorted by a tiled
    LSD radix over only the plan's passes, gives voxelize_plain's order
    (keys.sort_by_key) with invalid points, cells at the ends of the
    13-bit range, and 3 tiles; at B = 1, 4 and 64 the key has 40, 42 and
    46 live bits (5, 5 and 6 passes of 9 bits).  None: a batch of 2
    voxelized without a batch size, as lidog_tpu's voxelize_device is
    called, which the card runs at B = MAX_BATCH (57 bits, 7 passes)."""
    import torch

    from lidog_tpu_torch.core import keys
    from lidog_tpu_torch.core.voxelize import (_RADIX_BITS, _TILE, MAX_BATCH,
                                               quantize, voxelize_passes,
                                               voxelize_plain)

    b = 2 if batch_size is None else batch_size
    bs = MAX_BATCH if batch_size is None else batch_size
    pts, valid, bidx = _edge_points(np.random.RandomState(7), b,
                                    (2 * _TILE + 700) // b)
    disc = quantize(torch.from_numpy(pts), 0.5)
    tvalid, tb = torch.from_numpy(valid), torch.from_numpy(bidx)
    plan = voxelize_passes(len(pts), bs)
    assert plan.tiles == 3 and plan.invalid_key == bs << 39
    assert plan.passes == {1: 5, 4: 5, 64: 6, MAX_BATCH: 7}[bs]
    assert plan.passes * _RADIX_BITS >= 39 + bs.bit_length()
    c = _sort_key(disc, tvalid, tb, plan.invalid_key).numpy()
    u = c.view(np.uint64) ^ np.uint64(1 << 63)
    order = _lsd_order(u, plan.passes, _RADIX_BITS, _TILE)
    hi, lo = keys.pack(torch.cat([tb[:, None], disc], dim=1), tvalid)
    np.testing.assert_array_equal(order, keys.sort_by_key(hi, lo).numpy())
    want = voxelize_plain(disc, tvalid, tb, len(pts))
    first = np.r_[True, u[order][1:] != u[order][:-1]] \
        & (c[order] != plan.invalid_key)
    assert first.sum() == int(want.num_voxels)
    np.testing.assert_array_equal(order[first],
                                  want.rep_idx.numpy()[:first.sum()])


def _zconv3_wgrad_tiled(x, dout, nbr9, zup, zdn, mask, sp):
    """csrc/zconv3_wgrad.cu's blocking in float64: per xy offset o and
    chunk c the steps c, c + chunks, ... of sp.rows rows; per step the G_o
    rows (zero without a source), the x window of rows r0 - 1 .. r0 +
    sp.rows, and the tap byte of each row (G live; z-1 and z+1 flags); the
    chunk's partial sums, then their ordered sum."""
    import torch

    rk = sp.rows
    na = x.shape[0]
    x64, d64 = x.double(), dout.double()
    partial = torch.zeros(sp.partial, dtype=torch.float64)
    for o in range(9):
        for c in range(sp.chunks):
            for s in range(c, sp.steps, sp.chunks):
                r = torch.arange(s * rk, (s + 1) * rk)
                inl = r < na
                rc = r.clamp(max=na - 1)
                src = rc if o == 4 else nbr9[8 - o, rc].long()
                src = torch.where(inl & (src >= 0) & (src < na), src, -1)
                g = src >= 0
                if mask is not None:
                    g &= mask[src.clamp(min=0)]
                G = d64[src.clamp(min=0)] * (src >= 0)[:, None]
                w = torch.arange(s * rk - 1, (s + 1) * rk + 1)
                okw = (w >= 0) & (w < na)
                X = x64[w.clamp(0, na - 1)] * okw[:, None]
                bits = (g & zdn[rc] & inl, g, g & zup[rc] & inl)
                for t in range(3):
                    A = X[t:t + rk] * bits[t][:, None]
                    partial[c, 3 * o + t] += A.T @ G
    return partial.sum(0)


@pytest.mark.parametrize("rows", [491_520, 311_296, 102_400, 43_008, 0, 1,
                                  37, 65, 129])
def test_zconv3_wgrad_split(rows):
    """KF's zconv3 split (ops/zconv.py zconv3_wgrad_split) at the training
    plan's level row counts and at 0 rows, 1 row, fewer than one step and
    one row past a step (64 rows a step in f32, 128 in bf16): the slabs tile the widths with <= 12 warps, the
    strided chunks cover every step once, each step's window has one halo
    row a side, and the grid takes at most 8 waves of an H100's resident
    blocks.
    At the small counts the kernel's blocking, run in float64 on seeded
    inputs with -1 and out-of-range sources, z flags at the level's ends
    and a dout mask, equals zconv3_wgrad_plain."""
    import torch

    from lidog_tpu_torch.ops.zconv import (SM_SMEM, SMS, ZW_MAX_WARPS,
                                           zconv3_wgrad_plain,
                                           zconv3_wgrad_split, zw_rows,
                                           zw_smem)

    for cin, cout, dt in ((96, 96, torch.bfloat16), (128, 96, torch.bfloat16),
                          (32, 32, torch.bfloat16), (256, 256, torch.bfloat16),
                          (384, 256, torch.bfloat16), (96, 96, torch.float32)):
        sp = zconv3_wgrad_split(rows, cin, cout, dt)
        assert cin % sp.bm == 0 and cout % sp.bn == 0
        assert sp.bm % 32 == 0 and sp.bn % 32 == 0
        warps = (sp.bm // 32) * (sp.bn // 32) * sp.ks
        assert warps <= ZW_MAX_WARPS and sp.ks in (1, 2, 4, 8)
        assert sp.rows % (32 * sp.ks) == 0 or dt == torch.float32
        assert zw_smem(sp.bm, sp.bn, dt) <= 227 * 1024
        per_sm = max(1, min(ZW_MAX_WARPS // warps,
                            SM_SMEM // (zw_smem(sp.bm, sp.bn, dt) + 1024)))
        blocks = 9 * (cin // sp.bm) * (cout // sp.bn) * sp.chunks
        assert blocks <= 8 * SMS * per_sm or sp.chunks == 1  # <= 8 waves
        assert sp.rows == zw_rows(dt) and sp.halo == 1
        assert sp.steps == -(-rows // sp.rows)
        assert 1 <= sp.chunks <= max(1, sp.steps)
        seen = sorted(s for c in range(sp.chunks)
                      for s in range(c, sp.steps, sp.chunks))
        assert seen == list(range(sp.steps))
        assert sp.rows_per_chunk == -(-sp.steps // sp.chunks) * sp.rows
        assert sp.rows_per_chunk * sp.chunks >= rows
        assert sp.partial == (sp.chunks * sp.ks, 27, cin, cout)
    if rows == 0 or rows > 129:
        return
    rng = np.random.default_rng(rows)
    na, cin, cout = rows, 32, 32
    x = torch.from_numpy(rng.standard_normal((na, cin)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((na, cout)).astype(np.float32))
    nbr9 = torch.from_numpy(rng.integers(-1, na + 3, (9, na)).astype(np.int32))
    zup = torch.from_numpy(rng.random(na) < 0.6)
    zup[-1] = True  # a z+1 flag on the last row: its source is past the level
    zdn = torch.zeros(na, dtype=torch.bool)
    zdn[1:] = zup[:-1]
    zdn[0] = True  # and a z-1 flag on the first
    mask = torch.from_numpy(rng.random(na) < 0.8)
    want = zconv3_wgrad_plain(x, dout, nbr9, zup, zdn, mask)  # f32 sums
    scale = float(want.abs().max())
    for dt in (torch.float32, torch.bfloat16):
        sp = zconv3_wgrad_split(na, cin, cout, dt)
        got = _zconv3_wgrad_tiled(x, dout, nbr9, zup, zdn, mask, sp)
        np.testing.assert_allclose(got.reshape(9, 3 * cin, cout).numpy(),
                                   want.double().numpy(), rtol=0,
                                   atol=1e-5 * scale)


def _z_columns(rng, na):
    """zup / zdn of a level of na rows cut into z columns of 1-9 cells,
    with z flags also on row 0 (z-1) and row na - 1 (z+1), whose sources
    lie past the level's ends."""
    import torch

    zup = np.zeros(na, bool)
    j = 0
    while j < na:
        n = int(rng.integers(1, 10))
        zup[j:min(j + n, na) - 1] = True
        j += n
    zdn = np.zeros(na, bool)
    zdn[1:] = zup[:-1]
    zup[-1] = zdn[0] = True
    return torch.from_numpy(zup), torch.from_numpy(zdn)


def _zconv3_fwd_tiled(x, nbr9, zup, zdn, wf, mask, tl):
    """csrc/zconv3_fwd.cu's blocking in float64: per block of tl.bm rows and
    tl.bn columns, each xy offset's source n and tap flags per row (tap 0:
    n > 0 and zdn[n]; tap 2: n + 1 < Na and zup[n]; no source where the
    output mask is 0), the offsets with a source, and per such offset the
    K chunks of tl.bk elements of each row's run x[n-1] | x[n] | x[n+1]
    (zero where a column's tap does not count; a chunk may span two taps
    and the last may be short) against the same rows of wf[d]; the block's
    rows masked, rows past the level dropped.  (The kernel also puts a
    block's live rows first; that reorders the rows, not the sums.)"""
    import torch

    na, cin = x.shape
    cout = wf.shape[2]
    zero = torch.zeros(1, cin, dtype=torch.float64)
    xp = torch.cat([zero, x.double(), zero])
    run = torch.cat([xp[:-2], xp[1:-1], xp[2:]], dim=1)  # row n's run
    w64 = wf.double()
    out = torch.full((na, cout), float("nan"), dtype=torch.float64)
    for b in range(tl.grid[0]):
        rows = torch.arange(b * tl.bm, (b + 1) * tl.bm)
        inl = rows < na
        rc = rows.clamp(max=na - 1)
        keep = inl if mask is None else inl & mask[rc]
        for c in range(tl.grid[1]):
            cols = slice(c * tl.bn, (c + 1) * tl.bn)
            acc = torch.zeros(tl.bm, tl.bn, dtype=torch.float64)
            for d in range(9):
                n = rc if d == 4 else nbr9[d, rc].long()
                ok = keep & (n >= 0) & (n < na)
                if not ok.any():
                    continue
                nc = n.clamp(0, na - 1)
                taps = (ok & (nc > 0) & zdn[nc], ok,
                        ok & (nc + 1 < na) & zup[nc])
                for k0 in range(0, 3 * cin, tl.bk):  # (the last may be short)
                    ks = torch.arange(k0, min(k0 + tl.bk, 3 * cin))
                    keep_k = torch.stack(taps)[ks // cin].T  # column taps
                    a = run[nc][:, ks] * keep_k
                    acc += a @ w64[d][ks][:, cols]
            out[rows[inl], cols] = (acc * keep[:, None])[inl]
    return out


def _zconv3_bwd_dx_tiled(dout, nbr9, zup, zdn, wt, dmask, tl):
    """csrc/zconv3_bwd_dx.cu's blocking in float64: per block of output
    rows j = m0 .. m0 + tl.bm - 1 and tl.bn columns, each xy offset's
    tl.bm + 2 gathered rows G_e(m0 - 1 .. m0 + tl.bm) (zero outside the
    level, where the map misses and where the dout mask is 0), the offsets
    with a source, and per such offset and K chunk of tl.bk the three taps
    as views of that tile shifted by 2, 1 and 0 rows, taps 0 and 2 masked
    by zdn[j+1] and zup[j-1] (and the level's ends), against wt[e][t]."""
    import torch

    na, cout = dout.shape
    cin = wt.shape[3]
    d64, w64 = dout.double(), wt.double()
    dx = torch.full((na, cin), float("nan"), dtype=torch.float64)
    bm = tl.bm
    for b in range(tl.grid[0]):
        j = torch.arange(b * bm, (b + 1) * bm)
        r = torch.arange(b * bm - 1, (b + 1) * bm + 1)
        jin, rin = j < na, (r >= 0) & (r < na)
        rc = r.clamp(0, na - 1)
        m0 = ((j + 1 < na) & zdn[(j + 1).clamp(max=na - 1)])[:, None]
        m2 = ((j >= 1) & (j - 1 < na) & zup[(j - 1).clamp(0, na - 1)])[:, None]
        for c in range(tl.grid[1]):
            cols = slice(c * tl.bn, (c + 1) * tl.bn)
            acc = torch.zeros(bm, tl.bn, dtype=torch.float64)
            for e in range(9):
                src = rc if e == 4 else nbr9[e, rc].long()
                ok = rin & (src >= 0) & (src < na)
                sc = src.clamp(0, na - 1)
                if dmask is not None:
                    ok &= dmask[sc]
                if not ok.any():
                    continue
                for k0 in range(0, cout, tl.bk):  # (the last may be short)
                    g = d64[sc, k0:k0 + tl.bk] * ok[:, None]  # [bm + 2, bk]
                    for t, (shift, m) in enumerate(((2, m0), (1, None),
                                                    (0, m2))):
                        a = g[shift:shift + bm]
                        if m is not None:
                            a = a * m
                        acc += a @ w64[e, t, k0:k0 + g.shape[1], cols]
            dx[j[jin], cols] = acc[jin]
    return dx


# MinkUNet34's zconv3 width pairs (Cin, Cout), each at its level
ZCONV3_PAIRS = ((32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
                (128, 256), (256, 256), (384, 256), (192, 128), (128, 96),
                (96, 96))
# (kernel, Cin, Cout, with a mask) of the float64 blocking checks
Z3_CASES = {"fwd 32->96": ("fwd", 32, 96, True),
            "fwd 32->256": ("fwd", 32, 256, True),
            "fwd 64->32 no mask": ("fwd", 64, 32, False),
            "dx 96<-32": ("dx", 96, 32, True),
            "dx 256<-64": ("dx", 256, 64, True),
            "dx 192<-32 no mask": ("dx", 192, 32, False)}


@pytest.mark.parametrize("case", list(Z3_CASES))
def test_zconv3_tiles(case):
    """KA's and KE's blocking (ops/zconv.py zconv3_tiles, which their C
    launchers mirror): at the training plan's level row counts and at
    every MinkUNet34 width pair, the column tile is all of the output width
    up to 128 (two or three tiles only at 192, 256 and 384), K chunks of
    whole 16-byte pieces, 128-row blocks where they make 4 waves of the
    card (else 64), the grid covers the rows and two 128-row blocks fit in
    an H100 SM's shared memory.  At 300 rows (row blocks that split z
    columns, the last one partial) the kernel's blocking, run in float64
    on seeded inputs with -1 and out-of-range sources, z flags at the
    level's ends and a mask (or none), equals zconv3_plain /
    zconv3_bwd_dx_plain, in both dtypes' tilings."""
    import torch

    from lidog_tpu_torch.ops.zconv import (SM_SMEM, SMS, dx_weights,
                                           zconv3_bwd_dx_plain, zconv3_plain,
                                           zconv3_tiles)

    kernel, cin, cout, with_mask = Z3_CASES[case]
    for rows in (491_520, 311_296, 102_400, 43_008, 17_408, 1):
        for ci, co in ZCONV3_PAIRS:
            for dt in (torch.bfloat16, torch.float32):
                tl = zconv3_tiles(kernel, rows, ci, co, dt)
                width = co if kernel == "fwd" else ci
                bf16 = dt == torch.bfloat16
                assert tl.bn == next(b for b in (128, 96, 64, 32)
                                     if width % b == 0)
                assert tl.bn == width or width in (192, 256, 384)
                assert tl.bk % 8 == 0 and tl.bk * (2 if bf16 else 4) in (
                    32, 64, 128)
                blocks = -(-rows // 128) * (width // tl.bn)
                assert tl.bm == (128 if blocks >= 4 * 2 * SMS else 64)
                narrow_fwd = kernel == "fwd" and tl.bn <= 64
                assert tl.threads == 2 * tl.bm
                assert tl.per_sm * tl.threads == (1024 if narrow_fwd else 512)
                # bf16: warps of 32 rows x BN/2; f32: threads of 8 rows x
                # BN/16
                assert tl.threads // 32 == tl.bm // 32 * 2
                assert tl.threads == tl.bm // 8 * 16
                assert tl.halo == (kernel == "dx") and tl.stages in (2, 3, 4)
                assert (tl.stages == 2) == (bf16 and tl.bn == 128
                                            or narrow_fwd)
                assert tl.grid == (-(-rows // tl.bm), width // tl.bn)
                assert tl.smem <= 227 * 1024
                if tl.bm == 128 and not narrow_fwd:  # two blocks an SM
                    assert 2 * (tl.smem + 1024 + 16) <= SM_SMEM
    with pytest.raises(ValueError, match="multiples of 32"):
        zconv3_tiles(kernel, 10, 48, 32)
    rng = np.random.default_rng(sum(map(ord, case)))
    na = 300
    x = torch.from_numpy(rng.standard_normal((na, cin)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((na, cout)).astype(np.float32))
    nbr9 = torch.from_numpy(rng.integers(-1, na + 3, (9, na)).astype(np.int32))
    nbr9[:, ::13] = -1  # whole rows without a neighbour
    zup, zdn = _z_columns(rng, na)
    mask = torch.from_numpy(rng.random(na) < 0.8) if with_mask else None
    wf = torch.from_numpy((rng.standard_normal((9, 3 * cin, cout)) * 0.1)
                          .astype(np.float32))
    if kernel == "fwd":
        want = zconv3_plain(x, nbr9, zup, zdn, wf, mask)
    else:
        want = zconv3_bwd_dx_plain(dout, nbr9, zup, zdn, wf, mask)
    scale = float(want.abs().max())
    for dt in (torch.bfloat16, torch.float32):
        tl = zconv3_tiles(kernel, na, cin, cout, dt)
        if kernel == "fwd":
            got = _zconv3_fwd_tiled(x, nbr9, zup, zdn, wf, mask, tl)
        else:
            got = _zconv3_bwd_dx_tiled(dout, nbr9, zup, zdn, dx_weights(wf),
                                       mask, tl)
        np.testing.assert_allclose(got.numpy(), want.double().numpy(),
                                   rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{case} {dt}")


def _gg_tiled(x, w, n_out, mask, src_mask, tl, nbr=None, parent=None,
              off=None):
    """csrc/gather_gemm.cuh's blockings in float64: KB / LA (`nbr` [K,
    n_out], gathering) or KC (`parent`, `off` [n_out], one-hot).
    Gathering, per block of tl.bm rows and tl.bn columns: the rows whose
    output mask is set and each one's validated source at each offset
    (with K <= 8 sorted by the set of offsets they have a source at, here
    stably), the offsets with a source, then chunks of tl.bk of those
    offsets' Cin columns end to end (a chunk may hold two offsets, the last
    may be short): a fresh A tile (NaN where the kernel copies nothing; a
    missing source zero), the matching weight rows, and per k16 (bf16) /
    k4 (f32) step of an offset the products of the warps' 32 rows (bf16)
    or the threads' 8 (f32) where one of them has a source at it; the
    live
    rows written, the block's others 0.  One-hot, per block (range of
    tl.rows rows, offset o, tl.bn columns): the range's rows with mask set
    and a source inside x, not src_mask-dead, at offset o, in row order,
    in tiles of tl.bm (NaN past a tile's rows), each times w[o] and
    written to its row; the offset-0 blocks write zeros in the range's
    rows that are not live at an offset < K."""
    import torch

    n_in, cin = x.shape
    noff, _, cout = w.shape
    x64, w64 = x.double(), w.double()
    nan = float("nan")
    out = torch.full((n_out, cout), nan, dtype=torch.float64)

    def src_ok(s):
        return 0 <= s < n_in and (src_mask is None or bool(src_mask[s]))

    if nbr is None:
        def live(r):
            return (mask is None or bool(mask[r])) and 0 <= int(off[r]) < noff \
                and src_ok(int(parent[r]))

        for rb, o, cb in np.ndindex(*tl.grid):
            rows = range(rb * tl.rows, min((rb + 1) * tl.rows, n_out))
            cols = slice(cb * tl.bn, (cb + 1) * tl.bn)
            mine = [r for r in rows if live(r) and int(off[r]) == o]
            for t0 in range(0, len(mine), tl.bm):
                tile = mine[t0:t0 + tl.bm]
                a = torch.full((tl.bm, cin), nan, dtype=torch.float64)
                for p, r in enumerate(tile):
                    a[p] = x64[int(parent[r])]
                prod = a @ w64[o, :, cols]
                for p, r in enumerate(tile):
                    out[r, cols] = prod[p]
            if o == 0:
                for r in rows:
                    if not live(r):
                        out[r, cols] = 0
        return out
    bm, rg = tl.bm, tl.group
    step = 16 if rg == 32 else 4
    for b in range(tl.grid[0]):
        rows = range(b * bm, min((b + 1) * bm, n_out))
        rowof = [r for r in rows if mask is None or bool(mask[r])]
        out[list(rows)] = 0
        if noff <= 8:
            rowof.sort(key=lambda r: sum(src_ok(int(nbr[k, r])) << k
                                         for k in range(noff)))
        tab = [[int(nbr[k, r]) if src_ok(int(nbr[k, r])) else -1
                for r in rowof] for k in range(noff)]
        offs = [k for k in range(noff) if max(tab[k], default=-1) >= 0]
        cols_all = [(k, c) for k in offs for c in range(cin)]
        for cb in range(tl.grid[1]):
            cols = slice(cb * tl.bn, (cb + 1) * tl.bn)
            acc = torch.zeros(bm, tl.bn, dtype=torch.float64)
            for q0 in range(0, len(cols_all), tl.bk):
                chunk = cols_all[q0:q0 + tl.bk]
                a = torch.full((bm, len(chunk)), nan, dtype=torch.float64)
                bmat = torch.stack([w64[k, c, cols] for k, c in chunk])
                for p in range(len(rowof)):
                    for i, (k, c) in enumerate(chunk):
                        s = tab[k][p]
                        a[p, i] = x64[s, c] if s >= 0 else 0
                for i0 in range(0, len(chunk), step):
                    k = chunk[i0][0]
                    for p in range(0, bm, rg):
                        if max(tab[k][p:p + rg], default=-1) >= 0:
                            acc[p:p + rg] += (a[p:p + rg, i0:i0 + step]
                                              @ bmat[i0:i0 + step])
            for p, r in enumerate(rowof):
                out[r, cols] = acc[p]
    return out


def _onehot_wgrad_tiled(a, g, g_mask, parent, off, up, sp):
    """csrc/wgrad.cuh's one-hot kernel (KF down / up) in float64: per chunk
    of sp.rows_per_chunk fine rows, dW tile (32 x sp.bn) and offset k (one
    warp), the chunk walked in windows of 32 rows, each window's rows of
    offset k with an (A, G) pair inside a and g (and g_mask set) appended
    in row order to the warp's list; a stage takes the list's first
    min(len, 16) entries once it holds 16 or the chunk has ended (the rest
    of the stage zero) and adds A^T G to offset k's sums; partial[chunk, k]
    summed over the chunks in order.  A = a[r], G = g[parent[r]] (down) or
    A = a[parent[r]], G = g[r] (up)."""
    import torch

    rows, rpc = parent.shape[0], sp.rows_per_chunk
    n_a, cin = a.shape
    n_g, cout = g.shape
    a64, g64 = a.double(), g.double()
    part = torch.zeros(sp.partial, dtype=torch.float64)
    for ch in range(sp.chunks):
        r_end = min(rows, (ch + 1) * rpc)
        for m0 in range(0, cin, sp.bm):
            for n0 in range(0, cout, sp.bn):
                for k in range(8):
                    acc = torch.zeros(sp.bm, sp.bn, dtype=torch.float64)
                    pos, lst = ch * rpc, []
                    while True:
                        while len(lst) < sp.rows_step and pos < r_end:
                            for r in range(pos, min(pos + 32, r_end)):
                                p = int(parent[r])
                                sa, sg = (p, r) if up else (r, p)
                                if int(off[r]) == k and 0 <= sa < n_a \
                                        and 0 <= sg < n_g and (
                                            g_mask is None or g_mask[sg]):
                                    lst.append((sa, sg))
                            pos += 32
                        n = min(len(lst), sp.rows_step)
                        if n == 0:
                            break
                        A = torch.zeros(sp.rows_step, sp.bm,
                                        dtype=torch.float64)
                        G = torch.zeros(sp.rows_step, sp.bn,
                                        dtype=torch.float64)
                        for i, (sa, sg) in enumerate(lst[:n]):
                            A[i] = a64[sa, m0:m0 + sp.bm]
                            G[i] = g64[sg, n0:n0 + sp.bn]
                        acc += A.T @ G
                        lst = lst[n:]
                    part[ch, k, m0:m0 + sp.bm, n0:n0 + sp.bn] = acc
    return part.sum(0)


def _group_wgrad_tiled(x, dout, tmap, dmask, reverse, sp):
    """csrc/wgrad.cuh's grouped kernel (LB) in float64: per chunk, dW tile
    and group of sp.group offsets (warp w: offset group * sp.group + w),
    steps of 32 rows r0 .. of x (zero past the chunk), each warp's G rows
    dout[T[k, r]] (T[k] = tmap[K-1-k] when `reverse`, else tmap[k]; zero
    where T misses or dmask is 0), its 16-row halves (bf16) or rows (f32:
    sp.bn 32 with group 9 and 8 alike) without a G row skipped."""
    import torch

    n_in, cin = x.shape
    n_out, cout = dout.shape
    kk, rpc = tmap.shape[0], sp.rows_per_chunk
    x64, d64 = x.double(), dout.double()
    part = torch.zeros(sp.partial, dtype=torch.float64)
    for ch in range(sp.chunks):
        r_begin, r_end = ch * rpc, min(n_in, (ch + 1) * rpc)
        for m0 in range(0, cin, sp.bm):
            for n0 in range(0, cout, sp.bn):
                for gi in range(kk // sp.group):
                    for w in range(sp.group):
                        k = gi * sp.group + w
                        t = tmap[kk - 1 - k if reverse else k]
                        acc = torch.zeros(sp.bm, sp.bn, dtype=torch.float64)
                        for r0 in range(r_begin, r_end, sp.rows_step):
                            A = torch.zeros(sp.rows_step, sp.bm,
                                            dtype=torch.float64)
                            G = torch.zeros(sp.rows_step, sp.bn,
                                            dtype=torch.float64)
                            bits = 0
                            for i, r in enumerate(range(r0, min(
                                    r0 + sp.rows_step, r_end))):
                                A[i] = x64[r, m0:m0 + sp.bm]
                                s = int(t[r])
                                if 0 <= s < n_out and (dmask is None
                                                       or dmask[s]):
                                    G[i] = d64[s, n0:n0 + sp.bn]
                                    bits |= 1 << i
                            for h in range(0, sp.rows_step, 16):
                                if (bits >> h) & 0xFFFF:
                                    acc += A[h:h + 16].T @ G[h:h + 16]
                        part[ch, k, m0:m0 + sp.bm, n0:n0 + sp.bn] = acc
    return part.sum(0)


def _strided_maps(rng, nf, nc, mixed=True):
    """A level pair of nf fine and nc coarse rows: parent / off (some -1
    parents; offsets mixed within every 16 rows) and the down map nbr8 it
    implies, with some out-of-range entries."""
    import torch

    parent = rng.integers(-1, nc, nf).astype(np.int32)
    parent[::11] = -1
    off = rng.integers(0, 8, nf).astype(np.int32)
    if not mixed:  # runs of one offset, as a z-sorted level holds them
        off = np.sort(off)
    nbr8 = np.full((8, nc), -1, np.int32)
    for j in range(nf):
        if parent[j] >= 0:
            nbr8[off[j], parent[j]] = j
    nbr8[:, ::17] = nf + 5  # past the fine level: a miss
    return (torch.from_numpy(parent), torch.from_numpy(off),
            torch.from_numpy(nbr8))


# (kind, Cin, Cout, row tile forced (0: the launcher's), with masks) of
# the float64 gather-GEMM blocking checks; KC's dx and KB's dx run with
# mask None
GG_CASES = {"down 32->96": ("down", 32, 96, 0, True),
            "down 96->256 bm128": ("down", 96, 256, 128, True),
            "down dx 64->32 no mask": ("down", 64, 32, 0, False),
            "up 32->256": ("up", 32, 256, 0, True),
            "up 96->64 short range": ("up", 96, 64, 128, True),
            "up dx 128->32 no mask short range": ("up", 128, 32, 128, False),
            "la K27 32->128 bm128": ("la27", 32, 128, 128, True),
            "la K8 64->96 bm128": ("la8", 64, 96, 128, True)}


@pytest.mark.parametrize("case", list(GG_CASES))
def test_gather_gemm_tiles(case):
    """The gather-GEMMs' blocking (ops/_wrap.py gather_gemm_tiles, which
    the C launcher mirrors): the column tile is all of Cout up to 128 (two
    tiles at 256); gathering: 128-row blocks where they make 4 waves of two
    blocks an SM, two blocks' shared memory within an SM's; one-hot: a
    block per (1024-row range, offset, column tile), two 128-row tiles in
    flight in bf16; a block's shared memory within an H100's, at
    MinkUNet34's strided and generic widths.  At ~300 rows (the last block
    partial; gathering also in 128-row blocks; one-hot also in 64-row
    tiles and 128-row ranges) the kernel's
    blocking in float64, in both dtypes' tilings, on seeded maps with -1
    and out-of-range sources, all 8 offsets mixed in a tile, an output
    and a source mask, equals zconv_down_plain (KB), zconv_up_plain (KC)
    and sparse_conv_plain (LA)."""
    import torch

    from lidog_tpu_torch.ops._wrap import (ONEHOT_ROWS, SMEM_MAX, SMS,
                                           gather_gemm_tiles)
    from lidog_tpu_torch.ops.sparse_conv import sparse_conv_plain
    from lidog_tpu_torch.ops.zconv import (SM_SMEM, zconv_down_plain,
                                           zconv_up_plain)

    for rows in (491_520, 311_296, 153_600, 43_008, 17_408, 1):
        for cin, cout in ((32, 32), (96, 64), (128, 96), (256, 128),
                          (96, 256), (256, 256)):
            for noff, onehot in ((8, False), (8, True), (27, False)):
                for dt in (torch.bfloat16, torch.float32):
                    tl = gather_gemm_tiles(rows, noff, cin, cout, onehot, dt)
                    bf16 = dt == torch.bfloat16
                    assert tl.bn == {32: 32, 64: 64, 96: 96, 128: 128,
                                     256: 128}[cout]
                    ct = cout // tl.bn
                    assert tl.threads == 2 * tl.bm
                    assert tl.smem <= SMEM_MAX - 1024
                    if onehot:
                        assert tl.rows == ONEHOT_ROWS and tl.bk == cin
                        assert tl.grid == (-(-rows // tl.rows), 8, ct)
                        # two tiles of 128 rows in flight (bf16: at every
                        # width here)
                        assert (tl.bm, tl.stages) == (128, 2) or not bf16
                        continue
                    assert tl.bm == (128 if -(-rows // 128) * ct >= 8 * SMS
                                     else 64)
                    assert tl.grid == (-(-rows // tl.bm), ct)
                    assert tl.group == (32 if bf16 else 8)
                    assert tl.bk * torch.finfo(dt).bits // 8 == 128
                    assert tl.stages == (2 if tl.bn == 128 or tl.bm == 64
                                         else 3)
                    assert 2 * (tl.smem + 1024 + 64) <= SM_SMEM
    with pytest.raises(ValueError, match="multiples of 32"):
        gather_gemm_tiles(10, 8, 48, 32)
    kind, cin, cout, bm, masks = GG_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    nf, nc = 301, 173
    parent, off, nbr8 = _strided_maps(rng, nf, nc)
    w8 = torch.from_numpy((rng.standard_normal((8, cin, cout)) * 0.1)
                          .astype(np.float32))
    if kind == "down":  # x fine -> coarse rows
        n_in, n_out = nf, nc
    elif kind == "up":
        n_in, n_out = nc, nf
    else:
        noff = 27 if kind == "la27" else 8
        n_in, n_out = nf, 307
        nbr = torch.from_numpy(rng.integers(-1, nf + 2, (noff, n_out))
                               .astype(np.int32))
        nbr[:, ::9] = -1
        w8 = torch.from_numpy((rng.standard_normal((noff, cin, cout)) * 0.1)
                              .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n_in, cin)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n_out) < 0.8) if masks else None
    src_mask = torch.from_numpy(rng.random(n_in) < 0.85)
    if kind == "down":
        want = zconv_down_plain(x, nbr8, w8, mask, src_mask)
    elif kind == "up":
        want = zconv_up_plain(x, parent, off, w8, mask, src_mask)
    else:
        want = sparse_conv_plain(x, nbr, w8, mask, src_mask)
    scale = float(want.abs().max())
    assert scale > 0
    for dt in (torch.bfloat16, torch.float32):
        tl = gather_gemm_tiles(n_out, w8.shape[0], cin, cout, kind == "up",
                               dt)
        if bm and kind == "up":  # 64-row tiles, 128-row ranges
            tl = tl._replace(bm=64, threads=128, rows=128,
                             grid=(-(-n_out // 128),) + tl.grid[1:])
        elif bm:
            tl = tl._replace(bm=bm, threads=2 * bm,
                             grid=(-(-n_out // bm), tl.grid[1]))
        maps = ({"parent": parent, "off": off} if kind == "up" else
                {"nbr": nbr8 if kind == "down" else nbr})
        got = _gg_tiled(x, w8, n_out, mask, src_mask, tl, **maps)
        np.testing.assert_allclose(got.numpy(), want.double().numpy(),
                                   rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{case} {dt}")


# (kind, Cin, Cout, offsets mixed in every 16 rows) of the one-hot dW checks
OW_CASES = {"down 32->96": ("down", 32, 96, True),
            "down 64->256 sorted": ("down", 64, 256, False),
            "up 96->32": ("up", 96, 32, True),
            "up 32->64 sorted": ("up", 32, 64, False)}


@pytest.mark.parametrize("case", list(OW_CASES))
def test_onehot_wgrad_tiled(case):
    """KF's down / up forms (csrc/wgrad.cuh one-hot kernel) in float64 at
    ~300 fine rows: one pass over the fine rows, each added only to its own
    offset's sums, in the wrapper's split and in one of 2 chunks of 160
    rows (windows that carry rows over to the next stage), both dtypes'
    tiles, with -1 parents, every offset in every tile and a dout mask,
    equals zconv_down_wgrad_plain / zconv_up_wgrad_plain."""
    import torch

    from lidog_tpu_torch.ops._wrap import wgrad_split
    from lidog_tpu_torch.ops.zconv import (zconv_down_wgrad_plain,
                                           zconv_up_wgrad_plain)

    kind, cin, cout, mixed = OW_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    nf, nc = 301, 97
    parent, off, _ = _strided_maps(rng, nf, nc, mixed)
    up = kind == "up"
    n_a, n_g = (nc, nf) if up else (nf, nc)
    a = torch.from_numpy(rng.standard_normal((n_a, cin)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_g, cout)).astype(np.float32))
    gmask = torch.from_numpy(rng.random(n_g) < 0.8)
    plain = zconv_up_wgrad_plain if up else zconv_down_wgrad_plain
    want = plain(a, g, parent, off, gmask).double()
    scale = float(want.abs().max())
    for dt in (torch.bfloat16, torch.float32):
        sp = wgrad_split("onehot", nf, 8, cin, cout, dt)
        for split in (sp, sp._replace(chunks=2, rows_per_chunk=160,
                                      partial=(2, 8, cin, cout))):
            got = _onehot_wgrad_tiled(a, g, gmask, parent, off, up, split)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{case} {dt} {split}")


# (K, reverse, Cin, Cout) of LB's grouped dW checks
GW_CASES = {"K27 reverse 32->64": (27, True, 32, 64),
            "K8 partner 64->96": (8, False, 64, 96),
            "K27 reverse 64->32": (27, True, 64, 32)}


@pytest.mark.parametrize("case", list(GW_CASES))
def test_group_wgrad_tiled(case):
    """LB (csrc/wgrad.cuh grouped kernel) in float64 at ~300 rows: 9 (of
    27) or all 8 offsets a block, the x rows of each 32-row step shared,
    in the wrapper's split and in 2 chunks (the last ragged), both dtypes'
    tiles, with -1 and out-of-range map entries and a dout mask, equals
    sparse_conv_wgrad_plain."""
    import torch

    from lidog_tpu_torch.ops._wrap import wgrad_split
    from lidog_tpu_torch.ops.sparse_conv import sparse_conv_wgrad_plain

    k, reverse, cin, cout = GW_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    n_in, n_out = 299, 211
    tmap = torch.from_numpy(rng.integers(-1, n_out + 3, (k, n_in))
                            .astype(np.int32))
    tmap[:, 40:72] = -1  # a step half without a G row at every offset
    x = torch.from_numpy(rng.standard_normal((n_in, cin)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((n_out, cout))
                            .astype(np.float32))
    dmask = torch.from_numpy(rng.random(n_out) < 0.8)
    want = sparse_conv_wgrad_plain(x, dout, tmap, dmask,
                                   reverse=reverse).double()
    scale = float(want.abs().max())
    for dt in (torch.bfloat16, torch.float32):
        sp = wgrad_split("group", n_in, k, cin, cout, dt)
        assert sp.group == (9 if k == 27 else 8)
        for split in (sp, sp._replace(chunks=2, rows_per_chunk=192,
                                      partial=(2, k, cin, cout))):
            got = _group_wgrad_tiled(x, dout, tmap, dmask, reverse, split)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{case} {dt} {split}")


@pytest.mark.parametrize("rows", [0, 1, 300, 17_408, 102_400, 311_296,
                                  491_520, 524_288])
def test_wgrad_split(rows):
    """csrc/wgrad.cuh's split (ops/_wrap.py wgrad_split, whose tile rules
    the C launchers mirror) at MinkUNet34's strided widths (one-hot) and
    the generic plan's (grouped): dW tiles of 32 Cin x (one-hot bf16:
    all of Cout up to 128; f32 and grouped: 64 or 32) columns, 9 of 27 or
    8 offsets a block, chunks of a multiple of 32 rows that cover the rows
    once, the last non-empty, at most 65,535, and as many as bring the
    blocks to the kind's target (fewer only where chunks of 32 rows run
    out)."""
    import torch

    from lidog_tpu_torch.ops._wrap import WGRAD_BLOCKS, wgrad_split

    widths = {"onehot": [(8, 32, 32), (8, 64, 64), (8, 128, 128),
                         (8, 256, 256), (8, 256, 128), (8, 128, 96),
                         (8, 96, 96)],
              "group": [(27, 32, 32), (27, 128, 96), (27, 512, 256),
                        (8, 32, 32), (8, 96, 96)]}
    for kind, shapes in widths.items():
        for k, cin, cout in shapes:
            for dt in (torch.bfloat16, torch.float32):
                sp = wgrad_split(kind, rows, k, cin, cout, dt)
                bf16 = dt == torch.bfloat16
                if kind == "onehot" and bf16:
                    bn = next(b for b in (128, 96, 64, 32) if cout % b == 0)
                else:
                    bn = 64 if cout % 64 == 0 and (bf16 or kind == "onehot") \
                        else 32
                assert (sp.bm, sp.bn) == (32, bn)
                assert sp.group == (8 if k == 8 else 9)
                assert sp.rows_step == (16 if kind == "onehot" else 32)
                assert sp.blocks == (cin // 32) * (cout // bn) * (k // sp.group)
                assert sp.rows_per_chunk % 32 == 0 and sp.rows_per_chunk >= 32
                assert sp.chunks * sp.rows_per_chunk >= rows
                assert (sp.chunks - 1) * sp.rows_per_chunk < max(rows, 1)
                assert 1 <= sp.chunks <= 65_535
                assert sp.partial == (sp.chunks, k, cin, cout)
                target = -(-WGRAD_BLOCKS[kind] // sp.blocks)
                if sp.rows_per_chunk > 32:  # not one 32-row step a chunk
                    assert sp.chunks <= target
                    assert sp.chunks >= min(target, -(-rows // 32)) // 2
    with pytest.raises(ValueError, match="8 offsets"):
        wgrad_split("onehot", 10, 27, 32, 32)
    with pytest.raises(ValueError, match="K 27 or 8"):
        wgrad_split("group", 10, 125, 32, 32)


@functools.lru_cache(maxsize=1)
def _small_stem_map():
    """The port's stem125 map and level-0 real mask of
    test_zconv_full_matches_jax's input (2 scans, 2,048 rows; bitwise
    equal to lidog_tpu's, test_plan_bitwise_equal[stem125])."""
    import torch

    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from tests.test_zseg import B as ZB
    from tests.test_zseg import CAPS_A as ZCAPS_A
    from tests.test_zseg import CAPS_R as ZCAPS_R
    from tests.test_zseg import _build_inputs

    coords, mask, _ = _build_inputs(np.random.RandomState(11))
    plan = ZSegPlanBuilder(ZCAPS_R, ZCAPS_A, num_batches=ZB, grid_half=64,
                           stem_feature_map=True)(
        torch.from_numpy(coords), torch.from_numpy(mask))
    return (plan.kmaps["stem125"].numpy(), plan.level(0).real.numpy(), ZB)


def _ko_model(x, nbr, w, out_mask, src_mask, n_in):
    """KO (csrc/zconv_full.cu full_fwd_kernel) in numpy f32, in its order:
    each lane (q, c) keeps an f32 sum a tile row (its slot); per group of
    FULL_FWD_GROUP offsets and per pass of ab channels, the row's hits
    (offsets in order) sum their products over the slice's channels in
    order from 0 in registers, added into the slot; at the tile's end the q
    slots of each column meet by the pairwise tree (q, q + h), h = 1, 2,
    ....  An entry < 0, >= n_in or onto a source row that src_mask drops
    adds nothing.  The warps' tiles of FULL_FWD_ROWS rows only cut the
    rows, each of which sums alone."""
    from lidog_tpu_torch.ops.sparse_conv import FULL_FWD_GROUP, full_tiles

    k, n = nbr.shape
    cin, cout = w.shape[1:]
    t = full_tiles(cin, cout)
    f32 = np.float32
    xf, wf = x.astype(f32), w.astype(f32)
    hit = (nbr >= 0) & (nbr < n_in)
    src = np.where(hit, nbr, 0)
    if src_mask is not None:
        hit &= src_mask[src]
    width = t.ct * t.nc  # a lane's columns c + 32 m, as one axis
    cols = np.arange(width)
    slots = np.zeros((n, t.q, width), f32)
    for og in range(0, k, FULL_FWD_GROUP):
        for p in range(t.passes):
            part = np.zeros((n, t.q, width), f32)  # the row's sum in registers
            for o in range(og, min(og + FULL_FWD_GROUP, k)):
                xo = np.where(hit[o][:, None], xf[src[o]], f32(0))
                for j in range(t.ab):
                    i = p * t.ab + j
                    a = np.arange(t.q) * t.a_slice + i
                    ok = (i < t.a_slice) & (a < cin)
                    if not ok.any():
                        continue
                    ac = np.where(ok, a, 0)
                    xv = np.where(ok[None], xo[:, ac], f32(0))
                    wv = np.where(ok[:, None] & (cols < cout)[None],
                                  wf[o][ac][:, np.minimum(cols, cout - 1)],
                                  f32(0))
                    part += xv[:, :, None] * wv[None]  # a miss adds zeros
            slots += part
    h = 1
    while h < t.q:
        slots[:, ::2 * h] = slots[:, ::2 * h] + slots[:, h::2 * h]
        h *= 2
    out = slots[:, 0, :cout]
    if out_mask is not None:
        out = np.where(out_mask[:, None], out, f32(0))
    return out


def _ko_rows_model(x, nbr, w, out_mask, src_mask, n_in):
    """KO's f32 row form (csrc/zconv_full.cu full_fwd_rows_kernel) in numpy
    f32: each output row's 32 sums run over every offset in order, each
    offset's channels in order (a miss adds zeros)."""
    k, n = nbr.shape
    cin, cout = w.shape[1:]
    f32 = np.float32
    hit = (nbr >= 0) & (nbr < n_in)
    src = np.where(hit, nbr, 0)
    if src_mask is not None:
        hit &= src_mask[src]
    acc = np.zeros((n, cout), f32)
    for o in range(k):
        xo = np.where(hit[o][:, None], x[src[o]].astype(f32), f32(0))
        for a in range(cin):
            acc = acc + xo[:, a:a + 1] * w[o, a].astype(f32)[None]
    if out_mask is not None:
        acc = np.where(out_mask[:, None], acc, f32(0))
    return acc


def _ko_mma_model(x, nbr, w, out_mask, src_mask, n_in):
    """KO's tensor-core form (csrc/zconv_full.cu full_fwd_mma_kernel, bf16
    at Cin in (1, 2, 4, 8, 16)) in numpy f32: each output row's sum runs
    over the k-steps of 16 / Cin offsets in order, a k-step's 16 products
    summed first (by the tensor core; here in numpy's order) and then
    added; a miss (an entry < 0, >= n_in or onto a source row that
    src_mask drops) reads zeros."""
    from lidog_tpu_torch.ops.sparse_conv import FULL_MMA_GROUP

    k, n = nbr.shape
    cin, cout = w.shape[1:]
    f32 = np.float32
    hit = (nbr >= 0) & (nbr < n_in)
    src = np.where(hit, nbr, 0)
    if src_mask is not None:
        hit &= src_mask[src]
    opk = 16 // cin
    steps = -(-k // FULL_MMA_GROUP) * (FULL_MMA_GROUP // opk)
    acc = np.zeros((n, cout), f32)
    for p in range(steps):
        part = np.zeros((n, cout), f32)
        for o in range(p * opk, min((p + 1) * opk, k)):
            xo = np.where(hit[o][:, None], x[src[o]].astype(f32), f32(0))
            part += xo @ w[o].astype(f32)
        acc = acc + part
    if out_mask is not None:
        acc = np.where(out_mask[:, None], acc, f32(0))
    return acc


def _kp_model(x, dout, nbr, dout_mask, sp):
    """KP (csrc/zconv_full.cu full_wgrad_kernel, then the sum kernel) in
    numpy f32 over the split sp: for each offset o (read through map row
    K-1-o) and chunk, each of the FULL_WGRAD_WARPS warps sums its run's
    hits in row order; the block adds its warps' tiles in warp order into
    the partial [chunk, o], written once; dW sums the partials over the
    chunks in order."""
    from lidog_tpu_torch.ops.sparse_conv import FULL_WGRAD_WARPS

    f32 = np.float32
    k, na = nbr.shape
    cin, cout = x.shape[1], dout.shape[1]
    xf = x.astype(f32)
    hit = (nbr >= 0) & (nbr < na)
    src = np.where(hit, nbr, 0)
    partial = np.full((sp.chunks, k, cin, cout), np.nan, f32)
    for o in range(k):
        keep = hit[k - 1 - o].copy()
        s = src[k - 1 - o]
        if dout_mask is not None:
            keep &= dout_mask[s]
        g = dout[s].astype(f32)
        for ch in range(sp.chunks):
            block = np.zeros((cin, cout), f32)
            for wp in range(FULL_WGRAD_WARPS):
                lo = ch * sp.rows_per_chunk + wp * sp.rows_per_warp
                hi = min(na, (ch + 1) * sp.rows_per_chunk,
                         lo + sp.rows_per_warp)
                r = np.arange(lo, max(lo, hi))
                r = r[keep[r]]
                tile = np.zeros((cin, cout), f32)
                if len(r):  # in row order
                    tile = np.add.accumulate(
                        xf[r][:, :, None] * g[r][:, None, :], axis=0,
                        dtype=f32)[-1]
                block = block + tile
            partial[ch, o] = block
    dw = np.zeros((k, cin, cout), f32)
    for ch in range(sp.chunks):
        dw = dw + partial[ch]
    return dw


# (Cin, Cout) of each case: the general stem (4 -> 32, dx 32 -> 4), the
# generic stem (1 -> 32), a ragged slice over two column sets (33 -> 40:
# passes of 16 channels, c and c + 32) and 4 slices of 16 (64 -> 8)
FULL_MODEL_CASES = {"cin4": (4, 32), "cin1": (1, 32), "cin33": (33, 40),
                    "cin64": (64, 8)}


@pytest.mark.parametrize("case", list(FULL_MODEL_CASES))
def test_zconv_full_blocked_model(case, monkeypatch):
    """numpy f32 models of KO's and KP's blocking and fixed summation
    orders (_ko_model, _kp_model over ops/sparse_conv.py full_tiles and
    full_wgrad_split, the functions the wrapper and the C side share) on
    the small stem125 map of test_zconv_full_matches_jax: held against the
    plain versions (sparse_conv_plain, sparse_conv_wgrad_plain) on the
    map with entries >= n_in added and a random source / dout mask
    (forward, KO as dx with W[::-1]^T, dW; KP at its own split and, in
    f32, at chunks of 640 rows: 4 chunks, 16 warp runs of 32 rows, the
    last short or empty), and against lidog_tpu's _zfull_bwd on the map
    as it is (dx and dW at chunks of 640 rows, the cotangent through the
    level's real mask).
    Tolerances (relative to max |reference|): 1e-5 in f32 (summation order
    only), 1e-2 in bf16 (inputs in bf16, f32 sums rounded once on both
    sides)."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops import zconv as jz
    from lidog_tpu_torch.ops import sparse_conv as sc

    cin, cout = FULL_MODEL_CASES[case]
    nbr, real, nb = _small_stem_map()
    k, n = nbr.shape
    rng = np.random.default_rng(23 + list(FULL_MODEL_CASES).index(case))
    x = (rng.standard_normal((n, cin)) * real[:, None]).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) * 0.2).astype(np.float32)
    dout = rng.standard_normal((n, cout)).astype(np.float32)
    wt = np.ascontiguousarray(w[::-1].transpose(0, 2, 1))
    # the map with entries >= n_in (misses) and random masks
    odd = nbr.copy()
    far = (odd >= 0) & (rng.random(odd.shape) < 0.05)
    odd[far] = n + rng.integers(0, 50, int(far.sum()))
    assert (odd >= n).sum() > 50 and (odd < 0).sum() > 50
    smask = rng.random(n) > 0.25
    t = torch.from_numpy
    splits = [sc.full_wgrad_split(n)]
    monkeypatch.setattr(sc, "FULL_WGRAD_ROWS", 640)
    splits.append(sc.full_wgrad_split(n))
    assert [s.chunks for s in splits] == [1, 4]
    assert splits[1].rows_per_warp == 32
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        tol = 1e-5 if dt == "float32" else 1e-2

        def rnd(a):  # the values the card sees, as f32 numpy
            return t(a).to(tdt).float().numpy()

        xs, ws_, wts, ds = rnd(x), rnd(w), rnd(wt), rnd(dout)
        want = {"fwd": sc.sparse_conv_plain(t(xs).to(tdt), t(odd), t(ws_).to(tdt),
                                            t(real), t(smask)),
                "dx": sc.sparse_conv_plain(t(ds).to(tdt), t(odd), t(wts).to(tdt),
                                           None, t(smask)),
                "dW": sc.sparse_conv_wgrad_plain(t(xs).to(tdt), t(ds).to(tdt),
                                                 t(odd), t(smask),
                                                 reverse=True)}
        models = {"mma": _ko_mma_model, "rows": _ko_rows_model,
                  "cores": _ko_model}
        route = sc.full_fwd_route(cin, cout, k, tdt)
        assert route == ("cores" if case in ("cin33", "cin64") else
                         "mma" if dt == "bfloat16" else "rows"), route
        dx_route = sc.full_fwd_route(cout, cin, k, tdt)  # KO as dx
        assert dx_route == ("mma" if case == "cin64" and dt == "bfloat16"
                            else "cores"), dx_route
        got = {"fwd": models[route](xs, odd, ws_, real, smask, n),
               "dx": models[dx_route](ds, odd, wts, None, smask, n)}
        for name in ("fwd", "dx"):
            g = t(got[name]).to(tdt).float().numpy()
            assert _rel(want[name].float().numpy(), g) <= tol, (dt, name)
        for sp in splits if dt == "float32" else splits[:1]:
            g = t(_kp_model(xs, ds, odd, smask, sp)).to(tdt).float().numpy()
            assert _rel(want["dW"].float().numpy(), g) <= tol, (dt, sp)
    # lidog_tpu's backward on the map as it is (f32)
    dm = dout * real[:, None]
    dx_j, _, dw_j = jz._zfull_bwd(jnp.float32, 3, nb,
                                  (jnp.asarray(x), jnp.asarray(nbr),
                                   jnp.asarray(w)), jnp.asarray(dm))
    assert _rel(np.asarray(dx_j), _ko_model(dout, nbr, wt, None, real,
                                            n)) <= 1e-5
    assert _rel(np.asarray(dw_j), _kp_model(x, dout, nbr, real,
                                            splits[1])) <= 1e-5


@pytest.mark.parametrize("rows", [0, 1, 37, 2_048, 491_520, 524_288,
                                  10_000_000])
def test_zconv_full_split(rows):
    """KO's and KP's blocking (ops/sparse_conv.py) against
    csrc/zconv_full.cu's constants: full_tiles at every width pair in [1,
    64]^2 gives lanes (q, c) that cover each output column once (c + 32 m
    < ct * nc, a power-of-two ct <= 32, nc = 2 only above 32 columns) and
    each input channel once (q slices of a_slice, ab in (1, 4, 16) a pass,
    passes covering the slice); full_wgrad_split cuts the rows into chunks
    that cover them once (at most FULL_WGRAD_MAX_CHUNKS, the last
    non-empty) and each chunk into FULL_WGRAD_WARPS runs of a multiple of
    32 rows that cover it; full_offset_order issues every offset once,
    the centre first."""
    import re

    from lidog_tpu_torch.ops import _cuda
    from lidog_tpu_torch.ops import sparse_conv as sc

    src = (_cuda.CSRC / "zconv_full.cu").read_text()
    for name, value in (("KO_ROWS", sc.FULL_FWD_ROWS),
                        ("KO_GROUP", sc.FULL_FWD_GROUP),
                        ("KM_WARPS", sc.FULL_MMA_WARPS),
                        ("KM_GROUP", sc.FULL_MMA_GROUP),
                        ("KR_WARPS", sc.FULL_ROWS_WARPS),
                        ("KR_GROUP", sc.FULL_ROWS_GROUP),

                        ("KP_WARPS", sc.FULL_WGRAD_WARPS),
                        ("KP_STEPS", sc.FULL_WGRAD_STEPS),
                        ("MAXW", sc.FULL_MAX_WIDTH)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         src).group(1) == str(value), name
    assert re.search(r"constexpr int SMEM_LIMIT = (\d+) \* 1024;",
                     src).group(1) == str(sc.FULL_SMEM // 1024)
    assert sc.FULL_FWD_ROWS == 32  # lane = row: (offset << 5) | row
    if rows == 0:
        for cin in range(1, 65):
            for cout in range(1, 65):
                t = sc.full_tiles(cin, cout)
                assert t.ct & (t.ct - 1) == 0 and t.ct <= 32
                assert t.ct * t.nc >= cout and t.nc == (2 if cout > 32 else 1)
                assert cout > t.ct // 2 or t.ct == 1
                assert t.a_slice == -(-cin // t.q)  # q slices cover Cin
                assert t.ab in (1, 4, 16) and t.ab * t.passes >= t.a_slice
                assert t.ab * (t.passes - 1) < t.a_slice
        import torch

        bf, f32 = torch.bfloat16, torch.float32
        route = sc.full_fwd_route
        assert route(4, 32, 125, bf) == route(1, 32, 125, bf) == "mma"
        assert route(4, 32, 125, f32) == route(1, 32, 125, f32) == "rows"
        assert route(16, 64, 125, bf) == "cores"  # W's fragments: 256 KB
        assert route(32, 4, 125, bf) == route(32, 4, 125, f32) == "cores"
        assert route(3, 32, 125, bf) == route(4, 33, 125, f32) == "cores"
        assert route(4, 33, 125, bf) == "mma"
        assert sc.full_tiles(4, 32) == (32, 1, 4, 4, 1)
        assert sc.full_tiles(1, 32) == (32, 1, 1, 1, 1)
        assert sc.full_tiles(32, 4) == (4, 1, 4, 4, 1)
        for k in (1, 2, 8, 27, 125):
            order = sc.full_offset_order(k)
            assert sorted(order) == list(range(k)) and order[0] == k // 2
        assert sc.full_offset_order(125)[:3] == [62, 61, 63]
    sp = sc.full_wgrad_split(rows)
    assert 1 <= sp.chunks <= sc.FULL_WGRAD_MAX_CHUNKS
    assert sp.chunks * sp.rows_per_chunk >= rows
    assert (sp.chunks - 1) * sp.rows_per_chunk < max(rows, 1)
    # the C side: ((ceil(rpc / warps) + 31) & ~31)
    assert sp.rows_per_warp == (-(-sp.rows_per_chunk // sc.FULL_WGRAD_WARPS)
                                + 31) // 32 * 32
    assert sc.FULL_WGRAD_WARPS * sp.rows_per_warp >= sp.rows_per_chunk
    if rows <= sc.FULL_WGRAD_ROWS * sc.FULL_WGRAD_MAX_CHUNKS:
        assert sp.rows_per_chunk <= sc.FULL_WGRAD_ROWS
    # every row once: chunk c, warp v, row j of its run
    if rows and rows <= 600_000:
        r = (np.arange(sp.chunks)[:, None] * sp.rows_per_chunk
             + np.arange(sc.FULL_WGRAD_WARPS)[None, :] * sp.rows_per_warp)
        runs = [np.arange(lo, min(lo + sp.rows_per_warp,
                                  (c + 1) * sp.rows_per_chunk, rows))
                for c, row in enumerate(r) for lo in row]
        allr = np.concatenate(runs)
        assert np.array_equal(np.sort(allr), np.arange(rows))


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """Each kernel wrapper takes its plain version for a CPU tensor and
    counts no launch; a tensor on neither the CPU nor a card raises.  The
    plan sweeps' wrappers (KQ-KU), the column tables' (KV-KY, with the
    overflow terms they add in place), the generic sparse conv's (LA,
    LB, and KO/KP for the convs LA/LB do not take: a 125-offset stem at
    4 or 32 channels), the voxelizer's (LC), the label gather's (LD) and
    the probes' window gathers (LE-LH, with indices and copied rows
    outside the window) are among them."""
    import functools

    import torch

    from lidog_tpu_torch.core import voxelize, zseg
    from lidog_tpu_torch.losses import losses
    from lidog_tpu_torch.ops import (bev, gather, labels, norm, sparse_conv,
                                     zconv)

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
    run = [torch.zeros(32), torch.ones(32)]
    y, mean, var_raw, inv, count = norm.bn_train_fwd_plain(
        x, m, vec[0], vec[1], *[t.clone() for t in run], 0.1, 1e-5, x, True)
    # BEV: 2 scans on an 8^2 grid pooled (5, 3, 1) to 2^2
    coords = torch.randint(-4, 4, (n, 4), generator=g, dtype=torch.int32)
    coords[:, 0] = torch.arange(n) % 2
    geom = (2, 8, 2, 5, 3, 1)
    pooled = bev.bev_scatter_max_plain(x, coords, m, *geom)
    # instance norm over one scan (batch_idx as a column of coords); IW,
    # and IRW on rows scaled so that its hinge is live
    bidx = torch.zeros(n, 4, dtype=torch.int32)[:, 0]
    _, mean_i, var_i, rstd_i, count_i = norm.instance_norm_fwd_plain(x, m,
                                                                     bidx)
    _, s_w, n_w = losses.whitening_fwd_plain(x, m)
    # the general stem: a 125-offset map over the n rows (KO, KO as dx,
    # KP) and KQ's sweep over random tables (2 scans, a 4^2 grid of 3
    # columns each; packed rows of 5 real + 5 aug slabs of 14 words and a
    # start, bits only in the words around z = 0: 6 and 7)
    nbr125 = torch.randint(-1, n, (125, n), generator=g, dtype=torch.int32)
    x4, w4 = x[:, :4].contiguous(), torch.randn(125, 4, 32, generator=g)
    grid = torch.randint(-1, 3, (2, 16), generator=g)
    grid = torch.where(grid >= 0, grid + 3 * torch.arange(2)[:, None], -1)
    packed = torch.zeros(6, 145, dtype=torch.int64)
    for col in (76, 77, 84):  # words 6, 7 and the start of each aug slab
        packed[:, col::15] = torch.randint(0, 2**32 if col < 84 else 4,
                                           (6, 5), generator=g)
    cq = torch.randint(-2, 2, (n, 4), generator=g, dtype=torch.int32)
    cq[:, 3] = torch.randint(-3, 3, (n,), generator=g, dtype=torch.int32)
    kq = (grid.reshape(-1), packed, cq, m, 4, 3, 64, 2, 2)
    # KT, KU, KR (level 0) and KS (level 1) on the plan sweeps' own inputs
    # of the edge voxels (data/synthetic.py plan_edge_voxels)
    from lidog_tpu_torch.data import synthetic

    ec, em = synthetic.plan_edge_voxels()
    sweeps = {}
    for _, name, a, kw in zseg.ZSegPlanBuilder(
            *synthetic.EDGE_CAPS, num_batches=2,
            grid_half=synthetic.EDGE_GRID_HALF).sweep_inputs(
                torch.from_numpy(ec), torch.from_numpy(em)):
        sweeps.setdefault(name, tuple(a) + tuple(kw.values()))
    # KV, KW, KX and KY on their own inputs of the edge voxels with starved
    # column caps (KV adds a nonzero overflow term): level 0, and KW's
    # coarsening and KY's pair maps at level 1
    tables = [(name, a, kw) for lvl, name, a, kw in zseg.ZSegPlanBuilder(
        *synthetic.EDGE_CAPS, num_batches=2,
        grid_half=synthetic.EDGE_GRID_HALF,
        caps_col_dil=synthetic.EDGE_COL_DIL_STARVED).table_inputs(
            torch.from_numpy(ec), torch.from_numpy(em))
        if lvl == 0 or (lvl == 1 and name in ("real_words", "emit_rows"))]
    cases = [
        (zconv.zconv3_fwd, zconv.zconv3_plain, (x, nbr, zup, zdn, wf, m)),
        (zconv.zconv_down_fwd, zconv.zconv_down_plain, (x, nbr[:8], w8, m)),
        (zconv.zconv_up_fwd, zconv.zconv_up_plain, (x, nbr[0], off, w8, m)),
        (norm.bn_act, norm.bn_act_plain, (x, *vec, m, x, True)),
        (zconv.zconv3_bwd_dx, zconv.zconv3_bwd_dx_plain,
         (x, nbr, zup, zdn, wf, m)),
        (zconv.zconv3_wgrad, zconv.zconv3_wgrad_plain, (x, x, nbr, zup, zdn, m)),
        (zconv.zconv_down_wgrad, zconv.zconv_down_wgrad_plain,
         (x, x, nbr[0], off, m)),
        (zconv.zconv_up_wgrad, zconv.zconv_up_wgrad_plain,
         (x, x, nbr[0], off, m)),
        (norm.bn_train_fwd, norm.bn_train_fwd_plain,
         (x, m, vec[0], vec[1], *run, 0.1, 1e-5, x, True)),
        (norm.bn_train_bwd, norm.bn_train_bwd_plain,
         (x, y, x, m, vec[0], mean, var_raw, inv, count, 1e-5, True, True)),
        (bev.bev_scatter_max, bev.bev_scatter_max_plain,
         (x, coords, m, *geom)),
        (bev.bev_scatter_max_bwd, bev.bev_scatter_max_bwd_plain,
         (x, coords, m, pooled, torch.randn(pooled.shape, generator=g),
          *geom)),
        (norm.instance_norm_fwd, norm.instance_norm_fwd_plain, (x, m, bidx)),
        (norm.instance_norm_bwd, norm.instance_norm_bwd_plain,
         (x, x, m, bidx, mean_i, var_i, rstd_i, count_i)),
        (losses.whitening_fwd, losses.whitening_fwd_plain, (x, m, False)),
        (losses.whitening_fwd, losses.whitening_fwd_plain,
         (12 * x, m, True)),
        (losses.whitening_bwd, losses.whitening_bwd_plain,
         (torch.tensor(1.0), x, m, s_w, n_w, False)),
        (sparse_conv.zconv_full_fwd, sparse_conv.sparse_conv_plain,
         (x4, nbr125, w4, m)),
        (sparse_conv.zconv_full_fwd, sparse_conv.sparse_conv_plain,
         (x, nbr125, w4.flip(0).transpose(1, 2).contiguous(), None, m)),
        (sparse_conv.zconv_full_wgrad,
         functools.partial(sparse_conv.sparse_conv_wgrad_plain, reverse=True),
         (x4, x, nbr125, m)),
        (zseg.stem_feat125_packed, zseg.stem_feat125_plain, kq),
        (zseg.pos3_lookup, zseg.pos3_plain, sweeps["pos3_lookup"]),
        (zseg._build_packed, zseg._build_packed_plain,
         sweeps["_build_packed"]),
        (zseg.stem_conv9_packed, zseg.stem_conv9_plain,
         sweeps["stem_conv9_packed"]),
        (zseg.conv9_packed, zseg.conv9_plain, sweeps["conv9_packed"]),
    ]
    cases += [(getattr(zseg, name), getattr(zseg, name + "_plain"), a, kw)
              for name, a, kw in tables]
    assert tables[0][0] == "column_grid" and len(tables) == 6
    # the generic plan's sparse conv LA (also as dIn), LB over a symmetric
    # 27-tap map and an 8-tap partner map; the voxelizer LC (duplicate
    # cells, an invalid point, a capacity that drops voxels); the label
    # gather LD, sorted and sortless
    nbr27 = torch.randint(-1, n, (27, n), generator=g, dtype=torch.int32)
    w27 = torch.randn(27, 32, 32, generator=g)
    w125 = torch.randn(125, 32, 32, generator=g)
    disc = torch.randint(-2, 2, (3 * n, 3), generator=g, dtype=torch.int32)
    vvalid = torch.rand(3 * n, generator=g) > 0.1
    vbatch = torch.randint(0, 2, (3 * n,), generator=g, dtype=torch.int32)
    logits = torch.randn(n, 7, generator=g)
    pos = torch.randint(-1, n, (n,), generator=g, dtype=torch.int32)
    inv_pt = torch.randint(-1, n, (3 * n,), generator=g, dtype=torch.int32)
    cases += [
        (sparse_conv.sparse_conv_fwd, sparse_conv.sparse_conv_plain,
         (x, nbr27, w27, m)),
        (sparse_conv.sparse_conv_fwd, sparse_conv.sparse_conv_plain,
         (x, nbr27, w27.flip(0).transpose(1, 2).contiguous(), None, m)),
        (sparse_conv.sparse_conv_wgrad, sparse_conv.sparse_conv_wgrad_plain,
         (x, x, nbr27, m), {"reverse": True}),
        (sparse_conv.sparse_conv_wgrad, sparse_conv.sparse_conv_wgrad_plain,
         (x, x, nbr[:8], m), {"reverse": False}),
        (sparse_conv.sparse_conv_fwd, sparse_conv.sparse_conv_plain,
         (x, nbr125, w125, m)),
        (sparse_conv.sparse_conv_wgrad, sparse_conv.sparse_conv_wgrad_plain,
         (x, x, nbr125, m), {"reverse": True}),
        (voxelize.voxelize_cells, voxelize.voxelize_plain,
         (disc, vvalid, vbatch, 2 * n)),
        (voxelize.voxelize_cells, voxelize.voxelize_plain,
         (disc, vvalid, vbatch, 3)),
        (labels.label_gather, labels.labels_plain, (logits, m, pos, inv_pt)),
        (labels.label_gather, labels.labels_plain, (logits, m, pos)),
    ]
    # LE-LH: window rows / lanes at indices in [-1, W], windows of 4 rows
    # starting before, inside and past x's rows, 2 chunks of 128 lanes
    idx_w = torch.randint(-1, n + 1, (9,), generator=g, dtype=torch.int32)
    idx_l = torch.randint(-1, 33, (9,), generator=g, dtype=torch.int32)
    ws = torch.tensor([-2, 0, 3, 5], dtype=torch.int32)
    win_h = torch.randn(3, 256, generator=g)
    idx_h = torch.randint(-1, 129, (3, 256), generator=g, dtype=torch.int32)
    cases += [
        (gather.window_row_gather, gather.window_row_gather_plain,
         (x, idx_w)),
        (gather.window_lane_gather, gather.window_lane_gather_plain,
         (x, idx_l)),
        (gather.window_copy, gather.window_copy_plain, (x, ws, 4)),
        (gather.lane_gather_sum, gather.lane_gather_sum_plain,
         (win_h, idx_h)),
    ]

    def clone(v):
        return v.clone() if torch.is_tensor(v) else v

    counters = (zconv.LAUNCHES, norm.LAUNCHES, bev.LAUNCHES,
                losses.LAUNCHES, zseg.LAUNCHES, sparse_conv.LAUNCHES,
                voxelize.LAUNCHES, labels.LAUNCHES, gather.LAUNCHES)
    before = {k: v for t in counters for k, v in t.items()}
    for wrapper, plain, args, *kw in cases:
        kw = kw[0] if kw else {}
        copy = [clone(a) for a in args]
        kcopy = {k: clone(v) for k, v in kw.items()}
        out, want = wrapper(*args, **kw), plain(*copy, **kcopy)
        out = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        # (widened first: an int32 table's words may hold -2^31)
        assert out[0].double().abs().sum() > 0, wrapper.__name__
        if wrapper.__module__ == zseg.__name__:  # some neighbours are found
            assert all((o > 0 if o.is_floating_point() else o >= 0).any()
                       for o in out)
        for a, b in zip(out, want):
            assert a.dtype == b.dtype and torch.equal(a, b), wrapper.__name__
        # what a wrapper adds in place (the plan's overflow vector)
        for a, b in zip([*args, *kw.values()], [*copy, *kcopy.values()]):
            assert not torch.is_tensor(a) or torch.equal(a, b)
        meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        kmeta = {k: v.to("meta") if torch.is_tensor(v) else v
                 for k, v in kw.items()}
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*meta, **kmeta)
    # LA / LB take K 27 or 8 at widths in multiples of 32, KO / KP every
    # other conv: the 125-offset stem at 32 channels as well as at 4
    on_meta = {k: v.to("meta") for k, v in (
        ("x", x), ("x4", x4), ("m", m), ("nbr27", nbr27),
        ("nbr125", nbr125), ("w27", w27), ("w125", w125), ("w4", w4))}
    for k_map, w_k, xm, kernel in (("nbr27", "w27", "x", "sparse_conv"),
                                   ("nbr125", "w125", "x", "zconv_full"),
                                   ("nbr125", "w4", "x4", "zconv_full")):
        with pytest.raises(ValueError, match=kernel + "_fwd: .*CUDA"):
            sparse_conv.sparse_conv_fwd(on_meta[xm], on_meta[k_map], on_meta[w_k],
                                        on_meta["m"])
        with pytest.raises(ValueError, match=kernel + "_wgrad: .*CUDA"):
            sparse_conv.sparse_conv_wgrad(on_meta[xm], on_meta["x"], on_meta[k_map],
                                          on_meta["m"], reverse=True)
    with pytest.raises(ValueError, match="symmetric"):
        sparse_conv.sparse_conv_wgrad(on_meta["x4"], on_meta["x"], on_meta["nbr125"],
                                      on_meta["m"], reverse=False)
    assert int(tables[0][2]["overflow"][1]) > 0  # KV's dropped columns
    assert int(voxelize.voxelize_plain(disc, vvalid, vbatch, 3).overflow) > 0
    # LC's batch-size contract (the batch id of a valid point lies below
    # batch_size): held on the CPU too, where breaking it raises
    for cap in (2 * n, 3):
        got = voxelize.voxelize_cells(disc, vvalid, vbatch, cap, batch_size=2)
        want = voxelize.voxelize_plain(disc, vvalid, vbatch, cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="batch_size"):
        voxelize.voxelize_cells(disc, vvalid, vbatch, 3, batch_size=1)
    with pytest.raises(ValueError, match="batch_size"):
        voxelize.voxelize_cells(disc, vvalid, vbatch, 3, batch_size=0)
    assert {k: v for t in counters for k, v in t.items()} == before


def test_port_imports_no_jax():
    """Importing every lidog_tpu_torch module (and chip_smoke.py) leaves
    jax, flax and lidog_tpu out of sys.modules.  whiten_triton is the
    module that needs the triton package; it is imported only by its
    launching functions (the instance norm is CUDA C++ since
    csrc/instance_norm.cu, and ops/bn_act_triton.py is gone).  Each kernel's ctypes
    signature matches its C function's parameters.  The general stem's and
    the sortless path's modules (core/zseg.py with KQ-KY, ops/sparse_conv.py
    with KO/KP, caps.py, train/device_pipeline.py, serve.py) are among
    them, and the probes' window gathers (ops/gather.py, LE-LH)."""
    code = r"""
import importlib, pkgutil, sys
import lidog_tpu_torch
names = ["chip_smoke"]
for m in pkgutil.walk_packages(lidog_tpu_torch.__path__, "lidog_tpu_torch."):
    names.append(m.name)
triton_modules = {"lidog_tpu_torch.losses.whiten_triton"}
assert triton_modules <= set(names)
assert "lidog_tpu_torch.ops.bn_act_triton" not in names
for n in names:
    if n not in triton_modules:
        importlib.import_module(n)
# the general stem's kernels KO/KP (ops.sparse_conv) and the plan's KQ-KY
# (core.zseg), each with its CUDA source registered for nvcc
from lidog_tpu_torch.core import zseg
from lidog_tpu_torch.ops import _cuda, sparse_conv
assert {"zconv_full", "stem_feat125", "zseg_sweeps",
        "zseg_tables"} <= set(_cuda.SOURCES)
for src in ("zconv_full", "stem_feat125", "zseg_sweeps", "zseg_tables"):
    assert (_cuda.CSRC / (src + ".cu")).exists(), src
assert {"zconv_full_fwd", "zconv_full_wgrad"} <= set(sparse_conv.LAUNCHES)
# the generic plan's LA/LB, the voxelizer LC and the label gather LD
from lidog_tpu_torch.core import voxelize
from lidog_tpu_torch.ops import labels
for src in ("sparse_conv", "voxelize", "label_gather"):
    assert src in _cuda.SOURCES and (_cuda.CSRC / (src + ".cu")).exists()
# the probes' LE-LH
from lidog_tpu_torch.ops import gather
for src in ("window_gather", "window_copy"):
    assert src in _cuda.SOURCES and (_cuda.CSRC / (src + ".cu")).exists()
# the masked norms: KD, KG, KH and the instance norm's KK, KL
for src in ("masked_bn", "instance_norm"):
    assert src in _cuda.SOURCES and (_cuda.CSRC / (src + ".cu")).exists()
for fn in (*sparse_conv.LAUNCHES, *voxelize.LAUNCHES, *labels.LAUNCHES,
           *gather.LAUNCHES, "instance_norm_fwd", "instance_norm_bwd"):
    assert _cuda._SOURCE_OF.get(fn, fn) in _cuda.SOURCES, fn
    assert fn in _cuda._ARGTYPES, fn
# each ctypes signature matches its C function's: a pointer (void*) or an
# int per parameter, then the stream
import re
for fn, argtypes in _cuda._ARGTYPES.items():
    src = (_cuda.CSRC / (_cuda._SOURCE_OF.get(fn, fn) + ".cu")).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", src, re.S)
    kinds = ["*" in p for p in m.group(1).split(",")]
    assert kinds == [a is _cuda._P for a in argtypes], fn
assert set(zseg.LAUNCHES) == {"stem_feat125", "stem_conv9_packed",
                              "conv9_packed", "pos3_lookup", "build_packed",
                              "column_grid", "real_words", "assemble_aug",
                              "emit_rows"}
for fn in zseg.LAUNCHES:  # each launch count names a C function of its source
    assert _cuda._SOURCE_OF.get(fn, fn) in _cuda.SOURCES, fn
    assert fn in _cuda._ARGTYPES, fn
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


# the Pallas probes P1, P4 and P5, restated from their scripts (which keep
# them as closures) for interpret mode, and the port's plain version of
# each: (case, shape)
PROBE_CASES = ("P1a", "P1b", "P1c", "P4t1", "P4sublane", "P4lane", "P5")


def _probe_pallas(case):
    """(lidog_tpu's Pallas kernel of the probe, run in interpret mode on
    JAX's CPU, as numpy; the port's plain version on the same seeded numpy
    inputs, as numpy)."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from lidog_tpu_torch.ops import gather

    rng = np.random.default_rng(0)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    if case.startswith("P1"):
        W, T, C = 2048, 512, 96
        win = np.asarray(rng.standard_normal((W, C)), np.float32)
        idx = rng.integers(0, W, T, dtype=np.int32)
        twin, tidx = torch.from_numpy(win), torch.from_numpy(idx)
        if case == "P1a":
            # benchmarks/micro/micro_gather.py:77-80 (kernel), :83 (call)
            def kernel(idx_ref, win_ref, out_ref):
                idx = idx_ref[:]  # [T]
                g = jnp.take(win_ref[:], idx, axis=0)  # dynamic VMEM gather?
                out_ref[:] = g

            specs = [pl.BlockSpec(memory_space=pltpu.SMEM), vmem]
        elif case == "P1b":
            # micro_gather.py:104-106 (kernel2), :110 (call)
            def kernel(idx_ref, win_ref, out_ref):
                idx = idx_ref[:]
                out_ref[:] = jnp.take(win_ref[:], idx, axis=0)

            specs = [vmem, vmem]
        else:
            # micro_gather.py:128-131 (kernel3), :135 (call): the window
            # transposed
            def kernel(idx_ref, win_ref, out_ref):
                idx = idx_ref[:]  # [T]
                idx2 = jnp.broadcast_to(idx[None, :], (C, T))
                out_ref[:] = jnp.take_along_axis(win_ref[:], idx2, axis=1)

            win = win.T.copy()
            out = pl.pallas_call(
                kernel, out_shape=jax.ShapeDtypeStruct((C, T), jnp.float32),
                in_specs=[vmem, vmem], out_specs=vmem, interpret=True)(
                    jnp.asarray(idx), jnp.asarray(win))
            return (np.asarray(out), gather.window_lane_gather(
                torch.from_numpy(win), tidx).numpy())
        out = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((T, C), jnp.float32),
            in_specs=specs, out_specs=vmem, interpret=True)(
                jnp.asarray(idx), jnp.asarray(win))
        return np.asarray(out), gather.window_row_gather(twin, tidx).numpy()
    if case == "P4t1":
        # benchmarks/micro/micro_bisect.py:24-32 (kernel), :34-42 (grid
        # spec), :46 (call), at N 4,096 so that tiles 4-7 clip to N - WIN
        N, C, TILE, WIN = 4096, 96, 512, 2048

        def kernel(ws_ref, feats_hbm, out_ref, win_buf, sem):
            t = pl.program_id(0)
            cp = pltpu.make_async_copy(feats_hbm.at[pl.ds(ws_ref[t], WIN)],
                                       win_buf, sem)
            cp.start()
            cp.wait()
            out_ref[:] = win_buf[:TILE]

        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(N // TILE,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((TILE, C), lambda t, ws: (t, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((WIN, C), jnp.bfloat16),
                            pltpu.SemaphoreType.DMA(())],
        )
        feats = jnp.asarray(rng.standard_normal((N, C)), jnp.bfloat16)
        ws = np.minimum(np.arange(N // TILE) * TILE, N - WIN).astype(np.int32)
        assert (ws[4:] == N - WIN).all()
        out = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((N, C), jnp.bfloat16),
            grid_spec=grid_spec, interpret=True)(jnp.asarray(ws), feats)
        tfeats = torch.from_numpy(np.asarray(feats, np.float32)).to(
            torch.bfloat16)
        got = gather.window_copy(tfeats, torch.from_numpy(ws), TILE)
        return np.asarray(out, np.float32), got.float().numpy()
    if case in ("P4sublane", "P4lane"):
        # micro_bisect.py:55-66 (kernel), :71-77 (call): t2 and t4, W 256
        W = T = 256
        C = 128
        lane = case == "P4lane"

        def kernel(idx_ref, win_ref, out_ref):
            idx = idx_ref[:]  # [W] int32 in VMEM
            if lane:
                g = jnp.take_along_axis(
                    win_ref[:], jnp.broadcast_to(idx[None, :], (C, W)), axis=1
                )
                out_ref[:] = g[:, :T]
            else:
                g = jnp.take_along_axis(
                    win_ref[:], jnp.broadcast_to(idx[:, None], (W, C)), axis=0
                )
                out_ref[:] = g[:T]

        win = np.asarray(rng.standard_normal((C, W) if lane else (W, C)),
                         np.float32)
        idx = rng.integers(0, W, W, dtype=np.int32)
        out = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(
                (C, T) if lane else (T, C), jnp.float32),
            in_specs=[vmem, vmem], out_specs=vmem, interpret=True)(
                jnp.asarray(idx), jnp.asarray(win))
        fn = gather.window_lane_gather if lane else gather.window_row_gather
        return np.asarray(out), fn(torch.from_numpy(win),
                                   torch.from_numpy(idx[:T])).numpy()
    # P5: benchmarks/micro_lanegather.py:32-40 (kernel), :48 (call), at
    # REPS 4
    C, REPS = 96, 4

    def kernel(idx_ref, win_ref, o_ref):
        # win_ref: [C, 128*REPS] viewed as REPS chunks; gather within each.
        acc = jnp.zeros((C, 128), jnp.float32)
        for r in range(REPS):
            chunk = win_ref[:, r * 128:(r + 1) * 128]
            idx = idx_ref[:, r * 128:(r + 1) * 128]
            g = jnp.take_along_axis(chunk, idx, axis=1)
            acc = acc + g
        o_ref[:] = acc

    win = np.asarray(rng.standard_normal((C, 128 * REPS)), np.float32)
    idx = rng.integers(0, 128, (C, 128 * REPS), dtype=np.int32)
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((C, 128), jnp.float32),
        in_specs=[vmem, vmem], out_specs=vmem, interpret=True)(
            jnp.asarray(idx), jnp.asarray(win))
    return np.asarray(out), gather.lane_gather_sum(
        torch.from_numpy(win), torch.from_numpy(idx)).numpy()


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_kernels_match_pallas(case):
    """Each Pallas probe kernel (P1 a/b/c: micro_gather.py
    q2_pallas_vmem_gather; P4 t1 and gather_case: micro_bisect.py; P5:
    micro_lanegather.py), run through pl.pallas_call in interpret mode on
    JAX's CPU, against the port's plain version (ops/gather.py: LE, LF,
    LG, LH take it for CPU tensors) on the same seeded numpy inputs:
    exactly equal (copies, and P5's f32 sums in the same chunk order)."""
    from lidog_tpu_torch.ops import gather

    before = dict(gather.LAUNCHES)
    want, got = _probe_pallas(case)
    assert want.shape == got.shape and want.dtype == got.dtype, case
    np.testing.assert_array_equal(got, want)
    assert gather.LAUNCHES == before  # the CPU path launches nothing


def _smoke_module():
    """chip_smoke.py (at the repo's root) as a module: its constants."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# LE's (row) and LF's (lane) shapes: (kind, window rows or channels W / C,
# width, T, dtype, lowest and highest index drawn): the probes' shapes,
# then chip_smoke's edge shapes (WINDOW_EDGES: indices of -1 and >= W, T
# no multiple of 32, LE rows of 16 bytes and rows that take a thread two
# loop steps, LF channels no multiple of its channel block, bf16 at an
# odd T), which phase 23 holds on the card
WINDOW_GATHER_CASES = {
    "LE_P1_f32": ("row", 2048, 96, 512, "f32", 0, 2048),
    "LE_P1_bf16": ("row", 2048, 96, 512, "bf16", 0, 2048),
    "LE_t2": ("row", 256, 128, 256, "f32", 0, 256),
    "LE_t3a": ("row", 1024, 128, 1024, "f32", 0, 1024),
    "LE_t3b": ("row", 4096, 128, 4096, "f32", 0, 4096),
    "LF_P1_f32": ("lane", 96, 2048, 512, "f32", 0, 2048),
    "LF_P1_bf16": ("lane", 96, 2048, 512, "bf16", 0, 2048),
    "LF_t4": ("lane", 128, 256, 256, "f32", 0, 256),
    "LF_t4b": ("lane", 128, 2048, 2048, "f32", 0, 2048),
    **_smoke_module().WINDOW_EDGES,
}


def _le_blocked(vec, idx, row_bytes):
    """LE's kernel (csrc/window_gather.cu window_rows_kernel) run thread by
    thread, vectorised over the grid, in numpy: vec [W, v_row, 4] uint32
    (a window row's 16-byte vectors) -> [T, v_row, 4], each vector written
    exactly once."""
    from lidog_tpu_torch.ops import gather

    w, v_row, _ = vec.shape
    t_count = len(idx)
    g, blocks = gather.row_gather_split(t_count, row_bytes)
    assert g & (g - 1) == 0 and g <= 32 and g * gather.ROW_VECTORS >= min(
        v_row, 32 * gather.ROW_VECTORS)
    gid = np.arange(blocks * gather.GATHER_THREADS)
    t, j = gid // g, gid % g
    # the thread whose index the group's shuffle reads: lane & ~(g - 1) of
    # the same warp, the group's first thread
    reader = gid - gid % 32 + (gid % 32 & ~(g - 1))
    assert (reader // g == t).all() and (reader % g == 0).all()
    live = t < t_count
    s = np.where(live, idx[np.minimum(t, t_count - 1)], 0)
    hit = (s >= 0) & (s < w)
    out = np.full((t_count, v_row, 4), 0xDEADBEEF, np.uint32)
    writes = np.zeros((t_count, v_row), np.int64)
    for v0 in range(0, v_row, gather.ROW_VECTORS * g):  # a thread's steps
        for k in range(gather.ROW_VECTORS):
            v = j + v0 + k * g
            put = live & (v < v_row)
            val = np.where((hit & put)[:, None],
                           vec[np.clip(s, 0, w - 1), np.minimum(v, v_row - 1)],
                           0)
            out[t[put], v[put]] = val[put]
            np.add.at(writes, (t[put], v[put]), 1)
    assert (writes == 1).all()
    return out


def _lf_blocked(win, idx):
    """LF's kernel (window_lanes_kernel) run thread by thread in numpy:
    win [C, W] uint32 or uint16 bits -> out [C, T] of the same bits, each
    element written exactly once."""
    from lidog_tpu_torch.ops import gather

    c_count, w = win.shape
    t_count = len(idx)
    gx, gy = gather.lane_gather_split(c_count, t_count)
    bx, by, i = (a.reshape(-1) for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(gather.GATHER_THREADS),
        indexing="ij"))
    t = bx * gather.GATHER_THREADS + i
    live = t < t_count
    s = idx[np.minimum(t, t_count - 1)]
    out = np.full((c_count, t_count), 0xDEAD, win.dtype)
    writes = np.zeros((c_count, t_count), np.int64)
    for k in range(gather.LANE_CHANNELS):
        c = by * gather.LANE_CHANNELS + k
        put = live & (c < c_count)
        hit = put & (s >= 0) & (s < w)
        val = np.where(hit, win[np.minimum(c, c_count - 1),
                                np.clip(s, 0, w - 1)], 0)
        out[c[put], t[put]] = val[put]
        np.add.at(writes, (c[put], t[put]), 1)
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("case", list(WINDOW_GATHER_CASES))
def test_window_gather_split(case):
    """LE's and LF's plain versions (ops/gather.py) against numpy indexing
    with a zero for an index outside [0, W), and the kernels' thread ->
    (t, 16-byte vector) and (t, channel) mappings
    (row_gather_split, lane_gather_split, transliterated from
    csrc/window_gather.cu) against the plain versions: bitwise equal, at
    the probes' shapes and at edge shapes.  The blocking constants equal
    the source's."""
    import re

    import torch

    from lidog_tpu_torch.ops import _cuda, gather

    src = (_cuda.CSRC / "window_gather.cu").read_text()
    for const, value in (("kThreads", gather.GATHER_THREADS),
                         ("kRowVecs", gather.ROW_VECTORS),
                         ("kLaneChannels", gather.LANE_CHANNELS)):
        assert int(re.search(rf"constexpr int {const} = (\d+);",
                             src).group(1)) == value, const
    kind, rows, width, t_count, dt, lo, hi = WINDOW_GATHER_CASES[case]
    rng = np.random.default_rng(list(WINDOW_GATHER_CASES).index(case))
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    win = torch.from_numpy(rng.standard_normal((rows, width),
                                               np.float32)).to(tdt)
    idx_np = rng.integers(lo, hi, t_count, dtype=np.int32)
    idx_np[: min(2, t_count)] = (lo, hi - 1)[: min(2, t_count)]
    idx = torch.from_numpy(idx_np)
    ibits = torch.int32 if dt == "f32" else torch.int16
    ubits = np.uint32 if dt == "f32" else np.uint16
    bits = win.view(ibits).numpy().view(ubits)
    w = rows if kind == "row" else width
    hit = (idx_np >= 0) & (idx_np < w)
    safe = np.clip(idx_np, 0, w - 1)
    before = dict(gather.LAUNCHES)
    if kind == "row":
        plain = gather.window_row_gather_plain(win, idx)
        want = np.where(hit[:, None], bits[safe], 0).astype(ubits)
        row_bytes = width * win.element_size()
        vec = bits.view(np.uint32).reshape(rows, row_bytes // 16, 4)
        got = _le_blocked(vec, idx_np, row_bytes).view(ubits).reshape(
            t_count, width)
        assert torch.equal(gather.window_row_gather(win, idx), plain)
    else:
        plain = gather.window_lane_gather_plain(win, idx)
        want = np.where(hit[None], bits[:, safe], 0).astype(ubits)
        got = _lf_blocked(bits, idx_np)
        assert torch.equal(gather.window_lane_gather(win, idx), plain)
    assert gather.LAUNCHES == before
    plain_bits = plain.view(ibits).numpy().view(ubits)
    assert plain.dtype == tdt
    np.testing.assert_array_equal(plain_bits, want)
    np.testing.assert_array_equal(got, plain_bits)
    assert (~hit).any() == (lo < 0 or hi > w), case


@pytest.mark.parametrize("probe", ["gather", "bisect", "lanegather"])
def test_probe_entry_points_cpu(probe, capsys, monkeypatch):
    """The probe mains with device="cpu" at small shapes print ok=True /
    correct=True on every check line and return every check true (the
    lane-gather probe through `python -m lidog_tpu_torch.probes
    lanegather --device cpu`, at its own shape); without a card and
    without a device they raise."""
    import torch

    from lidog_tpu_torch.probes import (__main__ as cli, micro_bisect,
                                        micro_gather, micro_lanegather)

    if probe == "gather":
        out = micro_gather.main(
            "cpu", q1=dict(n_rows=4096, n_q=512, iters=1),
            q2=dict(iters=1), q3=dict(N=8192, iters=1))
        checks = ("ok=", 4)
    elif probe == "bisect":
        out = micro_bisect.main("cpu", t1=dict(N=4096), iters=1)
        checks = ("correct=", 6)
    else:
        assert cli.main(["lanegather", "--device", "cpu"]) == 0
        out = micro_lanegather.main("cpu", REPS=4, iters=1)
        checks = ("correct=", 2)
    text = capsys.readouterr().out
    assert text.startswith("device: cpu")
    lines = [ln for ln in text.splitlines() if checks[0] in ln]
    assert len(lines) == checks[1], lines
    assert all(f"{checks[0]}True" in ln for ln in lines), lines
    assert out["checks"] and all(out["checks"].values()), out["checks"]
    main = {"gather": micro_gather, "bisect": micro_bisect,
            "lanegather": micro_lanegather}[probe].main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main()
