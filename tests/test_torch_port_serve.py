"""lidog_tpu_torch's models and train steps vs lidog_tpu's, on the CPU.

Weights come from the port model's seeded init, carried into lidog_tpu
as a flax tree (and back through lidog_tpu_torch.utils.from_jax), with
BatchNorm running statistics randomized from a numpy seed so the
eval-mode norm is not the identity.
Shapes are those of tests/test_serve.py (B = 2, P = 600, voxel 0.5,
grid_half 32).  lidog_tpu's side takes the port's plans (_jax_plan_of),
which are bitwise equal to its own builder's (test_plan_bitwise_equal).
The full-width Predictor test, at these shapes, sits in
tests/test_torch_port_plan.py.

Tolerances (relative to max |JAX logits|):
  * narrow backbone, f32: 1e-4 (summation order only); bf16: 2e-2 and
    >= 99% equal argmax labels (the same rounding points, other sums);
  * train step (narrow backbone, SoftDICE, Adam), each of two steps from
    a carried-over lidog_tpu TrainState: see TRAIN_TOL.  In f32 the loss,
    every grad and the batch_stats agree to summation order, and the
    confusion matrix is exact.  Adam's update is about lr * sign(g) where
    |g| is small against its moments, so the params after the step are
    compared elementwise only where |g| >= 1e-5 max|g| of the tensor, and
    elsewhere within 2 lr per step taken (each side steps from its own
    params, which by then differ there by up to about lr).  bf16 rounds at the same points with other
    summation orders: one bf16 step moves a logit by 4e-3 relative, so
    argmax may differ on near-ties, and the confusion matrix then agrees
    in its total and in all but a few rows.
  * RobustNet and IBN steps (narrow, f32): as the train step, plus
    aux_loss as the loss.  A RobustBlock's BN shifts (norm2's and the
    shortcut's bias) reach only its instance norm, which removes them:
    their grads are 0 but for rounding, so both sides are held below
    1e-4 of the same norm's scale grad instead, and their params within
    2 lr.
"""

import numpy as np
import pytest

B, P, VOXEL, GRID_HALF = 2, 600, 0.5, 32
CAPS_R = (1024, 1024, 512, 256, 128)
CAPS_A = (2048, 1536, 768, 384, 192)
# the generic UNetPlan's pooled caps for B scans (caps[0] = the batch's
# B * CAPS_R[0] input rows; no level overflows on these points)
CAPS_G = (2048, 2048, 1024, 512, 256)
NARROW = dict(init_dim=8, planes=(8, 8, 16, 16, 16, 16, 8, 8),
              layers=(1,) * 8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU side runs on one thread in these tests (the ops and
    plan files take this fixture too).  Their inputs are small, and beside
    the other pytest-xdist workers torch's thread pool oversubscribes the
    cores: a narrow train step took 3.8 s alone, 45 s with 8 threads
    beside 8 busy processes, 3.8 s with one thread."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, P, 3).astype(np.float32) - 0.5) * 10.0


def _jax_plan_of(tp):
    """The port's ZPlan as a lidog_tpu ZPlan.  The port's builder is
    bitwise equal to lidog_tpu's (test_plan_bitwise_equal), whose XLA:CPU
    compile would add ~15 s to every test that built one."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.zseg import ZLevel, ZPlan

    def to_jax(t):
        return (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))

    return ZPlan(
        levels=tuple(ZLevel(*(to_jax(getattr(lv, f)) for f in (
            "coords", "real", "valid", "zup", "zdn")), stride=lv.stride)
            for lv in tp.levels),
        kmaps={k: to_jax(v) for k, v in tp.kmaps.items()},
        pos=to_jax(tp.pos), overflow=to_jax(tp.overflow),
        rep=None if tp.rep is None else to_jax(tp.rep))


def _jax_unet_plan_of(tp):
    """The port's UNetPlan as a lidog_tpu UNetPlan (bitwise equal to
    lidog_tpu's builder: test_unet_plan_bitwise_equal)."""
    import jax.numpy as jnp

    from lidog_tpu.core.plan import LevelPlan, UNetPlan

    return UNetPlan(
        levels=tuple(LevelPlan(*(jnp.asarray(getattr(lv, f).numpy()) for f in (
            "coords", "mask", "hi", "lo")), stride=lv.stride)
            for lv in tp.levels),
        perm=jnp.asarray(tp.perm.numpy()),
        kmaps={k: jnp.asarray(v.numpy()) for k, v in tp.kmaps.items()},
        overflow=jnp.asarray(tp.overflow.numpy()))


def _jax_plan(pts):
    """lidog_tpu's voxels of the points and their plan (_jax_plan_of)."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.voxelize import voxelize_device
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder

    vox = voxelize_device(
        jnp.asarray(pts.reshape(-1, 3)), jnp.ones((B * P,), bool),
        jnp.repeat(jnp.arange(B, dtype=jnp.int32), P), VOXEL, B * CAPS_R[0])
    plan = ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                           grid_half=GRID_HALF)(
        torch.from_numpy(np.asarray(vox.coords)),
        torch.from_numpy(np.asarray(vox.mask)))
    return vox, _jax_plan_of(plan)


def _with_random_stats(var, seed=1):
    """A flax tree with its BatchNorm running statistics randomized from a
    numpy seed."""
    rng = np.random.RandomState(seed)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = perturb(v)
            elif k == "mean":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return out

    return {"params": var["params"],
            "batch_stats": perturb(var["batch_stats"])}


def _jax_variables(model, vox, plan, seed=1, subtree=None):
    """The port model's seeded initial weights as a flax tree (`subtree`:
    the level of it that the flax module holds) with randomized BatchNorm
    statistics, and lidog_tpu's input tensor.  Initialising the flax model
    instead would compile its whole forward on XLA:CPU."""
    import jax.numpy as jnp

    from lidog_tpu.core.engine import input_tensor

    x = input_tensor(plan, vox.mask[:, None].astype(jnp.float32))
    var = _flax_variables_of(model)
    if subtree is not None:
        var = {c: var[c][subtree] for c in var}
    return _with_random_stats(var, seed), x


def _torch_plan(pts):
    import torch

    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder

    vox = voxelize_device(
        torch.from_numpy(pts.reshape(-1, 3)),
        torch.ones(B * P, dtype=torch.bool),
        torch.arange(B, dtype=torch.int32).repeat_interleave(P), VOXEL,
        B * CAPS_R[0])
    return vox, ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                                grid_half=GRID_HALF)(vox.coords, vox.mask)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_weights_carry_over(request):
    """Every flax leaf of the full MinkUNet34 maps to exactly one torch key
    (same shape and dtype) and back; about 37.85M parameters.  The leaves
    hold seeded random values in the shapes and dtypes of the flax init
    (jax.eval_shape: traced, not compiled)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp

    from lidog_tpu.core.engine import input_tensor
    from lidog_tpu.models import MinkUNet34 as JaxMinkUNet34
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.utils.from_jax import state_dict_from_flax

    vox, plan = _jax_plan(_points())
    x = input_tensor(plan, vox.mask[:, None].astype(jnp.float32))
    shapes = jax.eval_shape(
        lambda k: JaxMinkUNet34(out_channels=7).init(k, x, plan, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype),
        {c: shapes[c] for c in ("params", "batch_stats")})
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    sd = state_dict_from_flax(variables)
    assert len(sd) == len(leaves)
    for path, leaf in leaves:
        key = ".".join(str(p.key) for p in path[1:])
        assert sd[key].shape == leaf.shape and \
            sd[key].numpy().dtype == leaf.dtype, key
        np.testing.assert_array_equal(sd[key].numpy(), leaf)
    model = MinkUNet34(out_channels=7)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    assert abs(n_params - 37.85e6) < 0.01e6, n_params
    assert n_params == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(variables["params"]))
    # and back: every torch key names one flax leaf, which it holds
    buffers = {k for k, _ in model.named_buffers()}
    for key, t in model.state_dict().items():
        col = "batch_stats" if key in buffers else "params"
        node = variables[col]
        for part in key.split("."):
            node = node[part]
        np.testing.assert_array_equal(t.numpy(), node, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_backbone_logits(dtype, request):
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.models.minkunet import MinkUNetBackbone
    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.utils.from_jax import state_dict_from_flax

    pts = _points()
    vox, plan = _jax_plan(pts)
    jm = MinkUNetBackbone(out_channels=5, compute_dtype=jnp.dtype(dtype),
                          **NARROW)
    model = MinkUNet34(out_channels=5, compute_dtype=getattr(torch, dtype),
                       **NARROW).eval()  # the running stats, as train=False
    variables, x = _jax_variables(model, vox, plan, subtree="backbone")
    want, _ = jax.jit(lambda v: jm.apply(v, x, plan, train=False))(variables)
    want = np.asarray(want.astype(jnp.float32))

    model.load_state_dict(state_dict_from_flax(
        {c: {"backbone": variables[c]} for c in variables}), strict=True)
    tvox, tplan = _torch_plan(pts)
    with torch.no_grad():
        got = model(input_tensor(tplan, tvox.mask[:, None].float()), tplan)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    real = np.asarray(plan.level(0).real)
    assert (got[~real] == 0).all()
    if dtype == "float32":
        assert _rel(want, got) <= 1e-4
    else:
        assert _rel(want, got) <= 2e-2
        agree = (want.argmax(-1) == got.argmax(-1))[real].mean()
        assert agree >= 0.99, agree


@pytest.mark.parametrize("variant", ["minkunet34", "robustnet", "ibn",
                                     "bev"])
def test_generic_forward_matches_zplan(variant):
    """The same narrow model (seeded weights, randomized running
    statistics, eval mode, f32) on the generic UNetPlan (every conv the
    gather-GEMM sparse_conv) and on the ZPlan (the z-fused convs) of the
    same voxels: the logits of each voxel, aligned by coordinate, within
    rtol = atol = 2e-3 (lidog_tpu's rule, tests/test_zseg_model.py:51-73),
    and zero on the generic plan's padding rows.  MinkUNet34Robust,
    MinkUNet34IBN and MinkUNet34BEV share the backbone and run on either
    plan unchanged; the BEV model's head (the pooled scatter of block8's
    features, Encoder2D) gives the same BEV logits on both."""
    import torch

    from lidog_tpu_torch.core.engine import input_tensor
    from lidog_tpu_torch.core.plan import build_unet_plan
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.models.minkunet_bev import MinkUNet34BEV
    from lidog_tpu_torch.models.minkunet_ibn import MinkUNet34IBN
    from lidog_tpu_torch.models.minkunet_robustnet import MinkUNet34Robust

    vox, zplan = _torch_plan(_points(2))
    uplan = build_unet_plan(vox.coords, vox.mask, CAPS_G)
    assert int(uplan.overflow.sum()) == 0
    model = {"minkunet34": MinkUNet34, "robustnet": MinkUNet34Robust,
             "ibn": MinkUNet34IBN,
             "bev": lambda **kw: MinkUNet34BEV(
                 num_batches=B, voxel_size=VOXEL, bound_2d=10.0, **kw)}[
        variant](out_channels=5, **NARROW)
    g = torch.Generator().manual_seed(3)
    for name, buf in model.named_buffers():
        buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if "var" in name
                  else torch.randn(buf.shape, generator=g) * 0.1)
    model.eval()
    out = {}
    with torch.no_grad():
        for p in (zplan, uplan):
            x = input_tensor(p, vox.mask[:, None].float())
            out[id(p)] = (model(x, p, is_train=True) if variant == "bev"
                          else (model(x, p), {}))
    (lz, bz), (lu, bu) = out[id(zplan)], out[id(uplan)]
    lz, lu = lz.numpy(), lu.numpy()
    zl, ul = zplan.level(0), uplan.level(0)
    row = {tuple(c): j for j, c in enumerate(zl.coords.numpy().tolist())
           if zl.real[j]}
    um = ul.mask.numpy()
    idx = np.array([row[tuple(c)] for c in ul.coords.numpy()[um].tolist()])
    assert len(idx) == int(zl.real.sum()) > 500
    np.testing.assert_allclose(lu[um], lz[idx], rtol=2e-3, atol=2e-3)
    assert (lu[~um] == 0).all() and np.abs(lu[um]).max() > 0.1
    assert sorted(bz) == sorted(bu) == (["block8"] if variant == "bev"
                                        else [])
    for k in bz:
        np.testing.assert_allclose(bu[k].numpy(), bz[k].numpy(), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zconv_full_matches_jax(dtype, request):
    """zconv_full (the general stem's 125-offset conv) forward, dx and dW:
    jax.vjp through lidog_tpu's custom VJP against autograd through the
    port's op for it, ops/sparse_conv.py `sparse_conv` over the symmetric
    map (the plain versions of KO, KO as dx and KP on the CPU), every
    row compared, on the port's stem125 map of tests/test_zseg_stem_feat.py's
    input (bitwise equal to lidog_tpu's, test_plan_bitwise_equal[stem125])
    converted (_jax_plan_of).  Cin 4 -> Cout 32 (the stem) and 32 -> 4.
    Tolerance (relative to max |JAX|): 1e-5 in f32 (summation order only),
    1e-2 in bf16 (one rounding after an f32 sum on both sides).  The op
    test of zconv3/down/up is test_zconv_grads_match_jax; this one sits in
    the serve file to level the three port files' times."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.ops import zconv as jz
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.ops import sparse_conv as tsc
    from tests.test_zseg import B as ZB
    from tests.test_zseg import CAPS_A as ZCAPS_A
    from tests.test_zseg import CAPS_R as ZCAPS_R
    from tests.test_zseg import _build_inputs

    coords, mask, _ = _build_inputs(np.random.RandomState(11))
    tplan = ZSegPlanBuilder(ZCAPS_R, ZCAPS_A, num_batches=ZB, grid_half=64,
                            stem_feature_map=True)(
        torch.from_numpy(coords), torch.from_numpy(mask))
    plan = _jax_plan_of(tplan)
    nbr, real = plan.kmaps["stem125"], plan.level(0).real
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    rng = np.random.RandomState(17)
    n = nbr.shape[1]
    launches = dict(tsc.LAUNCHES)

    def both(a):
        return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)

    for cin, cout in ((4, 32), (32, 4)):
        x = both(rng.randn(n, cin).astype(np.float32)
                 * np.asarray(real)[:, None])
        w = both((rng.randn(125, cin, cout) * 0.2).astype(np.float32))
        dout = both(rng.randn(n, cout).astype(np.float32))  # not masked
        out_j, vjp = jax.vjp(
            lambda a, b: jz.zconv_full(a, nbr, b, out_mask=real,
                                       num_batches=ZB), x[0], w[0])
        dx_j, dw_j = vjp(dout[0])
        xt = x[1].clone().requires_grad_()
        wt = w[1].clone().requires_grad_()
        out_t = tsc.sparse_conv(xt, torch.from_numpy(np.asarray(nbr)), wt,
                                out_mask=torch.from_numpy(np.asarray(real)))
        out_t.backward(dout[1])
        for name, a, b in (("out", out_j, out_t), ("dx", dx_j, xt.grad),
                           ("dW", dw_j, wt.grad)):
            assert b.dtype == tdt and tuple(b.shape) == a.shape, (cin, name)
            err = _rel(a.astype(jnp.float32), b.detach().float())
            assert err <= tol, (cin, cout, name, err)
        # ghost and pad rows stay exactly zero
        assert (out_t[~torch.from_numpy(np.asarray(real))] == 0).all()
    # the map holds neighbours besides each row itself
    assert int((np.asarray(nbr) >= 0).sum()) > 2 * int(np.asarray(real).sum())
    assert tsc.LAUNCHES == launches  # CPU tensors: the plain versions


def test_predictor_needs_a_device(monkeypatch):
    """Without a card and without device="cpu" the Predictor raises; with
    device="cpu" it serves per-point labels on the plain path."""
    import torch

    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor

    model = MinkUNet34(out_channels=5, **NARROW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(batch_size=B, voxel_size=VOXEL, caps_per_scan=CAPS_R[0],
              grid_half=GRID_HALF, caps=(CAPS_R, CAPS_A, None))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, **kw)
    pred = Predictor(model, device="cpu", **kw)
    labels = pred(_points()).numpy()
    assert labels.shape == (B, P) and labels.dtype == np.int32
    assert pred.overflow.sum() == 0
    assert (labels >= 0).mean() > 0.95 and labels.max() < 5


# (loss, grads and batch_stats relative to max |JAX| per tensor, params
# where |g| is large: |delta| / lr)
TRAIN_TOL = {"float32": (1e-5, 5e-5, 1e-2), "bfloat16": (1e-3, 1e-2, 0.5)}
# the data of the train-step test: at this seed lidog_tpu's own jit of its
# step and jit of its grad agree to 1e-4 at every step (at seed 3 with two
# sources they part by 8% after one Adam step: a BatchNorm over a few
# level-4 rows whose variance cancels), and the two bf16 forwards round
# alike (at seeds 5 and 6 one bf16 sum rounds one step apart early, and
# BatchNorm's backward, a difference of two bf16-rounded terms, amplifies
# it to 10-50% of the grads on both sides alike)
TRAIN_SEED = 4


def _batches(seed, nsrc):
    """Per source: points [B, P, 3] and labels [B, P] in [-1, 5)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(nsrc):
        pts = (rng.rand(B, P, 3).astype(np.float32) - 0.5) * 10.0
        out.append((pts, rng.randint(-1, 5, (B, P)).astype(np.int32)))
    return out


def _voxel_feats(pts, coords, mask, feats):
    """numpy: the per-point features of each voxel's representative point
    (the smallest point index in it, voxelize_device's pick), 0 on
    padding."""
    b, p = pts.shape[:2]
    disc = np.floor(pts.reshape(-1, 3) / np.float32(VOXEL)).astype(np.int32)
    first = {}
    for i in range(b * p - 1, -1, -1):
        first[(i // p, *disc[i])] = i
    out = np.zeros((coords.shape[0], feats.shape[-1]), np.float32)
    for j in np.nonzero(mask)[0]:
        out[j] = feats.reshape(b * p, -1)[first[tuple(coords[j])]]
    return out


@pytest.mark.parametrize("case", ["float32", "bfloat16", "float32-2src",
                                  "cin4", "generic"])
def test_train_step_matches_jax(case, request):
    """From a lidog_tpu TrainState (after one JAX step, so Adam's moments
    and count are not trivial) carried into the port, two steps on each
    side: loss, confusion, every grad, the params after Adam and the
    batch_stats.  JAX's plans are the port's (_jax_plan_of).  The cin4
    case (f32) trains MinkUNet34 with 4 input channels (each voxel's
    representative point's x, y, z and a seeded remission) through the
    general stem: stem_feature_map plans and sparse_conv.  The generic
    case (f32) gives both steps no plans: each builds the batch's UNetPlan
    at CAPS_G (lidog_tpu in-graph) and every conv is the gather-GEMM
    sparse_conv."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    from typing import Any

    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.engine import input_tensor as jax_input
    from lidog_tpu.losses import SoftDICELoss as JaxDice
    from lidog_tpu.models.minkunet import MinkUNetBackbone
    from lidog_tpu.train import TrainState as JaxState
    from lidog_tpu.train import make_optimizer as jax_optimizer
    from lidog_tpu.train import make_train_step as jax_train_step
    from lidog_tpu.train.device_pipeline import device_batch_from_points as jdb
    from lidog_tpu.train.train_step import _forward_loss
    from lidog_tpu_torch.caps import plan_builder
    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.train.device_pipeline import device_batch_from_points
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState, make_train_step
    from lidog_tpu_torch.utils.from_jax import (load_train_state,
                                                state_dict_from_flax)

    from lidog_tpu_torch.data.synthetic import point_features

    from lidog_tpu_torch.core.plan import build_unet_plan

    generic = case == "generic"
    dtype = "float32" if case in ("cin4", "generic") else case.split("-")[0]
    in_ch = 4 if case == "cin4" else 1
    nsrc = 2 if case.endswith("2src") else 1
    tol_loss, tol_grad, tol_param = TRAIN_TOL[dtype]
    lr, C = 1e-3, 5
    sfx = [""] if nsrc == 1 else [str(s) for s in range(nsrc)]
    weights = (0.5, 0.5)

    class JaxNarrow(fnn.Module):
        compute_dtype: Any

        @fnn.compact
        def __call__(self, x, plan, train=True):
            return MinkUNetBackbone(out_channels=C,
                                    compute_dtype=self.compute_dtype,
                                    name="backbone", **NARROW)(
                x, plan, train)[0]

    jm = JaxNarrow(jnp.dtype(dtype))
    tbuilder = plan_builder(in_ch, B, (CAPS_R, CAPS_A, None),
                            grid_half=GRID_HALF)
    jbatch, jplans, tbatch, tplans = {}, {}, {}, {}
    for s, (pts, lab) in zip(sfx, _batches(TRAIN_SEED, nsrc)):
        jb = jdb(jnp.asarray(pts), jnp.ones((B, P), bool), jnp.asarray(lab),
                 VOXEL, B * CAPS_R[0])
        pf = point_features(pts, in_ch) if in_ch != 1 else None
        tb = device_batch_from_points(torch.from_numpy(pts),
                                      torch.ones(B, P, dtype=torch.bool),
                                      torch.from_numpy(lab), VOXEL,
                                      B * CAPS_R[0], None if pf is None
                                      else torch.from_numpy(pf))
        if pf is not None:  # lidog_tpu's batch carries one channel
            want = _voxel_feats(pts, tb["coords"].numpy(),
                                tb["mask"].numpy(), pf)
            np.testing.assert_array_equal(tb["feats"].numpy(), want)
            jb["feats"] = jnp.asarray(want)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
            jbatch[k + s], tbatch[k + s] = jb[k], tb[k]
        if generic:  # for lidog_tpu's init only: the steps take none
            jplans[s] = _jax_unet_plan_of(build_unet_plan(
                tb["coords"], tb["mask"], CAPS_G))
        else:
            tplans[s] = tbuilder(tb["coords"], tb["mask"])
            jplans[s] = _jax_plan_of(tplans[s])
        assert int(np.asarray(jplans[s].overflow).sum()) == 0
    jplan_arg = None if generic else jplans if nsrc > 1 else jplans[""]
    tplan_arg = None if generic else tplans if nsrc > 1 else tplans[""]
    caps = CAPS_G if generic else CAPS_R

    # lidog_tpu's own init: the data and weights where lidog_tpu agrees
    # with itself (TRAIN_SEED)
    plan0 = jplans[sfx[0]]
    x0 = jax_input(plan0, jbatch["feats" + sfx[0]])
    variables = _with_random_stats(jax.device_get(jax.jit(
        lambda k: jm.init(k, x0, plan0, train=False))(jax.random.PRNGKey(0))))
    tx = jax_optimizer("Adam", lr=lr)
    crit = JaxDice(ignore_label=-1)
    jstep = jax.jit(jax_train_step(jm, tx, crit, caps, num_classes=C,
                                   source_weights=weights,
                                   num_sources=nsrc))

    def loss_fn(params, stats):
        total = 0.0
        for i, s in enumerate(sfx):
            loss, stats, _ = _forward_loss(jm, params, stats, jbatch, CAPS_R,
                                           crit, C, True, suffix=s,
                                           plan=jplans[s])
            total = total + (weights[i] * loss if nsrc > 1 else loss)
        return total

    # JAX's grads: in f32 read back from its step's Adam moment (as in
    # test_lidog_step_matches_jax: one compile less); in bf16 from a
    # separately jitted grad, since XLA's fusion of the whole step rounds
    # its bf16 grads up to ~1% apart from the op order both the port and
    # the separate grad follow
    jgrad = jax.jit(jax.grad(loss_fn)) if dtype == "bfloat16" else None
    jstate = JaxState.create(variables, tx)
    jstate, _ = jstep(jstate, jbatch, jplan_arg)  # Adam's moments, count 1

    model = MinkUNet34(out_channels=C, compute_dtype=getattr(torch, dtype),
                       in_channels=in_ch, **NARROW)
    tstate = TrainState.create(model, make_optimizer("Adam", lr=lr),
                               device="cpu")
    load_train_state(tstate, jax.device_get(jstate))
    tstep = make_train_step(SoftDICELoss(ignore_label=-1), num_classes=C,
                            source_weights=weights, num_sources=nsrc,
                            caps=CAPS_G if generic else None)

    def leaf(tree, key):
        for part in key.split("."):
            tree = tree[part]
        return np.asarray(tree, np.float32)

    def adam_mu(state):
        return [p for p in jax.device_get(state.opt_state)
                if hasattr(p, "mu")][0].mu

    for step in range(2):
        if step:
            # the second step starts from JAX's params (the optimizer state
            # and batch_stats stay the port's own): where Adam's moment is
            # near 0 the first update is sign-sensitive and the two runs'
            # params part by up to ~lr, which would blur this step
            model.load_state_dict(state_dict_from_flax(
                {"params": jax.device_get(jstate.params)}), strict=False)
        mu_before = adam_mu(jstate)
        grads = (None if jgrad is None else
                 jax.device_get(jgrad(jstate.params, jstate.batch_stats)))
        jstate, jm_out = jstep(jstate, jbatch, jplan_arg)
        tstate, tm_out = tstep(tstate, tbatch, tplan_arg)
        lj, lt = float(jm_out["loss"]), float(tm_out["loss"])
        assert np.isfinite(lt) and abs(lj - lt) <= tol_loss * abs(lj), \
            (step, lj, lt)
        cm_t = tm_out["confusion"].numpy()
        np.testing.assert_array_equal(np.asarray(jm_out["confusion"]), cm_t)
        assert cm_t.sum() > 0
        jvars = jax.device_get({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
        mu = adam_mu(jstate)
        for name, p in model.named_parameters():
            # mu = 0.9 mu_before + 0.1 g (f32 rounding of mu, times 10:
            # ~1e-6 of max |g|)
            g = (leaf(grads, name) if grads is not None else
                 (leaf(mu, name) - 0.9 * leaf(mu_before, name)) / 0.1)
            assert _rel(g, p.grad.numpy()) <= tol_grad, (step, name)
            # Adam's update is well-conditioned where its new first moment
            # is not near 0 (from a fresh state mu = 0.1 g: the |g| rule)
            m = np.abs(leaf(mu, name))
            sure = m >= 1e-3 * m.max()
            d = np.abs(leaf(jvars["params"], name) - p.detach().numpy())
            assert (d[sure] <= tol_param * lr).all(), (step, name, d.max())
            assert (d <= 2 * lr).all(), (step, name, d.max())
        for name, buf in model.named_buffers():
            assert _rel(leaf(jvars["batch_stats"], name),
                        buf.numpy()) <= tol_grad, (step, name)
    assert tstate.step == int(jstate.step) == 3


def test_train_step_needs_a_device(monkeypatch):
    """Without a card and without device="cpu" TrainState.create raises;
    with device="cpu" a step runs on the plain path and trains."""
    import torch

    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.train.device_pipeline import device_batch_from_points
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import (TrainState, make_eval_step,
                                                  make_train_step)

    model = MinkUNet34(out_channels=5, **NARROW)
    tx = make_optimizer("Adam", lr=1e-2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(model, tx)
    state = TrainState.create(model, tx, device="cpu")
    (pts, lab), = _batches(4, 1)
    batch = device_batch_from_points(torch.from_numpy(pts),
                                     torch.ones(B, P, dtype=torch.bool),
                                     torch.from_numpy(lab), VOXEL,
                                     B * CAPS_R[0])
    plan = ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                           grid_half=GRID_HALF)(batch["coords"],
                                                batch["mask"])
    crit = SoftDICELoss(ignore_label=-1)
    step = make_train_step(crit, num_classes=5)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch, plan)
        losses.append(float(metrics["loss"]))
    supervised = int(((batch["labels"] >= 0) & batch["mask"]).sum())
    assert int(metrics["confusion"].sum()) == supervised
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    ev = make_eval_step(crit, num_classes=5)(state, batch, plan)
    assert np.isfinite(float(ev["loss"])) and state.step == 3


# LiDOG's BEV branch at the serve shapes: bound 10 m at voxel 0.5 is a 40^2
# raster, pooled to 13^2, and Encoder2D's two stride-2 convs give 4^2 BEV
# logits (bev_head_size)
BOUND_2D = 10.0
LIDOG_SEED = 4


def _lidog_batches(seed, nsrc):
    """Per source: collate_bev's numpy arrays of B scans (the port's host
    pipeline; tests/test_torch_port_plan.py holds it bitwise to
    lidog_tpu's)."""
    from lidog_tpu_torch.data.bev import collate_bev, preprocess_scan_bev
    from lidog_tpu_torch.models.minkunet_bev import bev_head_size

    head = bev_head_size(BOUND_2D, VOXEL)
    out = []
    for pts, lab in _batches(seed, nsrc):
        samples = [preprocess_scan_bev(pts[b], lab[b], voxel_size=VOXEL,
                                       bound_2d=BOUND_2D, sub_p=1.0,
                                       augmentations=None, train=False,
                                       bev_img_sizes={"block8": head})
                   for b in range(B)]
        batch = collate_bev(samples, B * CAPS_R[0])
        batch.pop("dropped")
        out.append(batch)
    return out


def test_lidog_step_needs_a_device(monkeypatch):
    """Without a card and without device="cpu" TrainState.create raises;
    with device="cpu" the LiDOG step of a narrow MinkUNet34BEV runs on the
    plain path and trains (total, sem and bev losses finite, the total
    falling, proj_iou in [0, 1]), and make_eval_step takes the model's
    (logits, {}) outside training."""
    import torch

    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.losses.losses import DICELoss, SoftDICELoss
    from lidog_tpu_torch.models.minkunet_bev import MinkUNet34BEV
    from lidog_tpu_torch.ops import bev
    from lidog_tpu_torch.train.lidog_step import make_lidog_train_step
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState, make_eval_step

    model = MinkUNet34BEV(out_channels=5, num_batches=B, voxel_size=VOXEL,
                          bound_2d=BOUND_2D, **NARROW)
    tx = make_optimizer("Adam", lr=1e-2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(model, tx)
    state = TrainState.create(model, tx, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lidog_batches(5, 1)[0].items()}
    plan = ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                           grid_half=GRID_HALF)(batch["coords"],
                                                batch["mask"])
    step = make_lidog_train_step(SoftDICELoss(ignore_label=-1),
                                 DICELoss(ignore_label=-1), num_classes=5)
    launches = dict(bev.LAUNCHES)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch, plan)
        losses.append([float(metrics[k]) for k in ("loss", "sem_loss",
                                                   "bev_loss")])
        assert 0.0 <= float(metrics["proj_iou_block8"]) <= 1.0
    assert np.isfinite(losses).all() and losses[-1][0] < losses[0][0], losses
    supervised = int(((batch["labels"] >= 0) & batch["mask"]).sum())
    assert int(metrics["confusion"].sum()) == supervised
    assert bev.LAUNCHES == launches
    ev = make_eval_step(SoftDICELoss(ignore_label=-1), num_classes=5)(
        state, batch, plan)
    assert np.isfinite(float(ev["loss"])) and state.step == 3


def _flax_variables_of(model):
    """The port model's state as a flax {'params', 'batch_stats'} tree."""
    variables = {"params": {}, "batch_stats": {}}
    buffers = dict(model.named_buffers())
    for name, v in model.state_dict().items():
        node = variables["batch_stats" if name in buffers else "params"]
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v.numpy().copy()
    return variables


def _variant_step_matches_jax(variant, case, monkeypatch):
    """Two steps of the RobustNet or IBN step (narrow, f32) from a
    carried-over lidog_tpu TrainState, compared as
    test_lidog_step_matches_jax compares them.  lidog_tpu's models take
    their widths from module constants, narrowed here with monkeypatch (in
    the isolated process)."""
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.losses import IWLoss as JaxIW
    from lidog_tpu.losses import SoftDICELoss as JaxSoftDICE
    from lidog_tpu.models import minkunet_ibn as jibn
    from lidog_tpu.models import minkunet_robustnet as jrob
    from lidog_tpu.train import TrainState as JaxState
    from lidog_tpu.train import make_optimizer as jax_optimizer
    from lidog_tpu.train import make_train_step as jax_train_step
    from lidog_tpu.train.robustnet_step import (
        make_robustnet_train_step as jax_robust_step)
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.losses.losses import IWLoss, SoftDICELoss
    from lidog_tpu_torch.models.minkunet_ibn import MinkUNet34IBN
    from lidog_tpu_torch.models.minkunet_robustnet import MinkUNet34Robust
    from lidog_tpu_torch.train.device_pipeline import device_batch_from_points
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.robustnet_step import make_robustnet_train_step
    from lidog_tpu_torch.train.train_step import TrainState, make_train_step
    from lidog_tpu_torch.utils.from_jax import (load_train_state,
                                                state_dict_from_flax)

    for mod in (jrob, jibn):
        monkeypatch.setattr(mod, "PLANES", NARROW["planes"])
        monkeypatch.setattr(mod, "LAYERS", NARROW["layers"])
        monkeypatch.setattr(mod, "INIT_DIM", NARROW["init_dim"])
    nsrc = 2 if "2src" in case else 1
    # the gate: on at both compared steps, or (cov_stat_epoch 2, one step
    # per epoch, after the carried-over step) off at the first, on at the
    # second
    cov = 2 if case.endswith("gate") else 0
    tol_loss, tol_grad, tol_param = TRAIN_TOL["float32"]
    lr, C = 1e-3, 5
    sfx = [""] if nsrc == 1 else [str(s) for s in range(nsrc)]
    weights = (0.5, 0.5)

    tbuilder = ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                               grid_half=GRID_HALF)
    jbatch, jplans, tbatch, tplans = {}, {}, {}, {}
    for s, (pts, lab) in zip(sfx, _batches(TRAIN_SEED, nsrc)):
        tb = device_batch_from_points(torch.from_numpy(pts),
                                      torch.ones(B, P, dtype=torch.bool),
                                      torch.from_numpy(lab), VOXEL,
                                      B * CAPS_R[0])
        for k, v in tb.items():
            jbatch[k + s], tbatch[k + s] = jnp.asarray(v.numpy()), v
        tplans[s] = tbuilder(tb["coords"], tb["mask"])
        jplans[s] = _jax_plan_of(tplans[s])
        assert int(tplans[s].overflow.sum()) == 0
    jplan_arg = jplans if nsrc > 1 else jplans[""]
    tplan_arg = tplans if nsrc > 1 else tplans[""]

    tx = jax_optimizer("Adam", lr=lr)
    crit = JaxSoftDICE(ignore_label=-1)
    tcrit = SoftDICELoss(ignore_label=-1)
    if variant == "robustnet":
        model = MinkUNet34Robust(out_channels=C, **NARROW)
        jstep = jax_robust_step(
            jrob.MinkUNet34Robust(out_channels=C), tx, crit, JaxIW(), CAPS_R,
            num_classes=C, source_weights=weights, num_sources=nsrc,
            cov_stat_epoch=cov, steps_per_epoch=1)
        tstep = make_robustnet_train_step(
            tcrit, IWLoss(), num_classes=C, source_weights=weights,
            num_sources=nsrc, cov_stat_epoch=cov, steps_per_epoch=1)
    else:
        model = MinkUNet34IBN(out_channels=C, **NARROW)
        jstep = jax_train_step(jibn.MinkUNet34IBN(out_channels=C), tx, crit,
                               CAPS_R, num_classes=C, source_weights=weights,
                               num_sources=nsrc)
        tstep = make_train_step(tcrit, num_classes=C, source_weights=weights,
                                num_sources=nsrc)
    jstep = jax.jit(jstep)
    # RobustBlock's norm2 (with the residual) and shortcut_norm feed only
    # its instance norm
    vanishing = {n for n, _ in model.named_parameters()
                 if ".norm2.bn.bias" in n or ".shortcut_norm.bn.bias" in n}
    vanishing = {n for n in vanishing
                 if variant == "robustnet" and n[5] in "123"}
    jstate = JaxState.create(_flax_variables_of(model), tx)
    jstate, _ = jstep(jstate, jbatch, jplan_arg)  # Adam's moments, count 1
    tstate = TrainState.create(model, make_optimizer("Adam", lr=lr),
                               device="cpu")
    load_train_state(tstate, jax.device_get(jstate))  # strict=True

    def leaf(tree, key):
        for part in key.split("."):
            tree = tree[part]
        return np.asarray(tree, np.float32)

    def adam_mu(state):
        return [p for p in jax.device_get(state.opt_state)
                if hasattr(p, "mu")][0].mu

    aux = []
    for step in range(2):
        if step:  # as in test_train_step_matches_jax
            model.load_state_dict(state_dict_from_flax(
                {"params": jax.device_get(jstate.params)}), strict=False)
        mu_before = adam_mu(jstate)
        jstate, jm_out = jstep(jstate, jbatch, jplan_arg)
        tstate, tm_out = tstep(tstate, tbatch, tplan_arg)
        assert sorted(jm_out) == sorted(tm_out)
        for k in jm_out:
            if k != "confusion":
                lj, lt = float(jm_out[k]), float(tm_out[k])
                assert np.isfinite(lt) and abs(lj - lt) <= \
                    tol_loss * abs(lj), (step, k, lj, lt)
        aux.append(float(tm_out.get("aux_loss", 0.0)))
        cm_t = tm_out["confusion"].numpy()
        np.testing.assert_array_equal(np.asarray(jm_out["confusion"]), cm_t)
        jvars = jax.device_get({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
        mu = adam_mu(jstate)
        named = dict(model.named_parameters())
        for name, p in named.items():
            g = (leaf(mu, name) - 0.9 * leaf(mu_before, name)) / 0.1
            m = np.abs(leaf(mu, name))
            sure = m >= 1e-3 * m.max()
            if name in vanishing:
                # the BN's shift reaches only an instance norm, which
                # removes it: the grad is 0 but for rounding on both
                # sides, far below its scale's; the update's sign there
                # is rounding's, so the params differ by up to 2 lr
                scale = np.abs(named[name[:-4] + "scale"].grad.numpy()).max()
                assert max(np.abs(g).max(), np.abs(p.grad.numpy()).max()) \
                    <= 1e-4 * scale, (step, name)
                sure[:] = False
            else:
                assert _rel(g, p.grad.numpy()) <= tol_grad, (step, name)
            d = np.abs(leaf(jvars["params"], name) - p.detach().numpy())
            assert (d[sure] <= tol_param * lr).all(), (step, name, d.max())
            assert (d <= 2 * lr).all(), (step, name, d.max())
        for name, buf in model.named_buffers():
            assert _rel(leaf(jvars["batch_stats"], name),
                        buf.numpy()) <= tol_grad, (step, name)
    if variant == "robustnet":
        assert all(v > 0 for v in aux), aux
    assert tstate.step == int(jstate.step) == 3


def test_robustnet_step_needs_a_device(monkeypatch):
    """Without a card and without device="cpu" TrainState.create raises;
    with device="cpu" the RobustNet step of a narrow MinkUNet34Robust
    (gate on from the first step) runs on the plain path and trains: the
    loss finite and falling, aux_loss finite and positive, the confusion
    total equal to the supervised voxels, and no kernel launched."""
    import torch

    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.losses import losses
    from lidog_tpu_torch.models.minkunet_robustnet import MinkUNet34Robust
    from lidog_tpu_torch.ops import norm
    from lidog_tpu_torch.train.device_pipeline import device_batch_from_points
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.robustnet_step import make_robustnet_train_step
    from lidog_tpu_torch.train.train_step import TrainState

    model = MinkUNet34Robust(out_channels=5, **NARROW)
    tx = make_optimizer("Adam", lr=1e-2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(model, tx)
    state = TrainState.create(model, tx, device="cpu")
    (pts, lab), = _batches(4, 1)
    batch = device_batch_from_points(torch.from_numpy(pts),
                                     torch.ones(B, P, dtype=torch.bool),
                                     torch.from_numpy(lab), VOXEL,
                                     B * CAPS_R[0])
    plan = ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                           grid_half=GRID_HALF)(batch["coords"],
                                                batch["mask"])
    step = make_robustnet_train_step(losses.SoftDICELoss(ignore_label=-1),
                                     losses.IWLoss(), num_classes=5,
                                     cov_stat_epoch=0)
    before = {**norm.LAUNCHES, **losses.LAUNCHES}
    out = []
    for _ in range(3):
        state, metrics = step(state, batch, plan)
        out.append((float(metrics["loss"]), float(metrics["aux_loss"])))
    assert np.isfinite(out).all() and out[-1][0] < out[0][0], out
    assert all(aux > 0 for _, aux in out), out
    supervised = int(((batch["labels"] >= 0) & batch["mask"]).sum())
    assert int(metrics["confusion"].sum()) == supervised
    assert {**norm.LAUNCHES, **losses.LAUNCHES} == before
    assert state.step == 3
