"""lidog_tpu_torch's model and Predictor vs lidog_tpu's, on the CPU.

Weights come from the JAX model's init (flax tree -> state_dict through
lidog_tpu_torch.utils.from_jax), with BatchNorm running statistics
randomized from a numpy seed so the eval-mode norm is not the identity.
Shapes are those of tests/test_serve.py (B = 2, P = 600, voxel 0.5,
grid_half 32).

Tolerances (relative to max |JAX logits|):
  * narrow backbone, f32: 1e-4 (summation order only); bf16: 2e-2 and
    >= 99% equal argmax labels (the same rounding points, other sums);
  * full MinkUNet34 Predictor, f32: logits 1e-3 (23 blocks of f32 sums in
    another order), and per-point labels equal wherever the JAX top-2
    logit margin exceeds 1e-3 of max |logits|.
"""

import numpy as np
import pytest

B, P, VOXEL, GRID_HALF = 2, 600, 0.5, 32
CAPS_R = (1024, 1024, 512, 256, 128)
CAPS_A = (2048, 1536, 768, 384, 192)
NARROW = dict(init_dim=8, planes=(8, 8, 16, 16, 16, 16, 8, 8),
              layers=(1,) * 8)


def _points(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, P, 3).astype(np.float32) - 0.5) * 10.0


def _jax_plan(pts):
    import jax
    import jax.numpy as jnp

    from lidog_tpu.core.voxelize import voxelize_device
    from lidog_tpu.core.zseg import ZSegPlanBuilder

    vox = voxelize_device(
        jnp.asarray(pts.reshape(-1, 3)), jnp.ones((B * P,), bool),
        jnp.repeat(jnp.arange(B, dtype=jnp.int32), P), VOXEL, B * CAPS_R[0])
    plan = jax.jit(ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                                   grid_half=GRID_HALF))(vox.coords, vox.mask)
    return vox, plan


def _jax_variables(model, vox, plan, seed=1):
    """Init the flax model; randomize its BatchNorm running statistics."""
    import jax
    import jax.numpy as jnp

    from lidog_tpu.core.engine import input_tensor

    x = input_tensor(plan, vox.mask[:, None].astype(jnp.float32))
    var = jax.device_get(jax.jit(
        lambda k: model.init(k, x, plan, train=False))(jax.random.PRNGKey(0)))
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

    return ({"params": var["params"],
             "batch_stats": perturb(var["batch_stats"])}, x)


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
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_weights_carry_over(request):
    """Every flax leaf of the full MinkUNet34 maps to exactly one torch key
    (same shape and dtype) and back; about 37.85M parameters."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax

    from lidog_tpu.models import MinkUNet34 as JaxMinkUNet34
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.utils.from_jax import state_dict_from_flax

    vox, plan = _jax_plan(_points())
    variables, _ = _jax_variables(JaxMinkUNet34(out_channels=7), vox, plan)
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
    variables, x = _jax_variables(jm, vox, plan)
    want, _ = jax.jit(lambda v: jm.apply(v, x, plan, train=False))(variables)
    want = np.asarray(want.astype(jnp.float32))

    model = MinkUNet34(out_channels=5, compute_dtype=getattr(torch, dtype),
                       **NARROW)
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


def test_full_predictor_matches_jax(request):
    """Full-width MinkUNet34 in f32: the port's Predictor on the CPU vs
    lidog_tpu.serve.Predictor."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax

    from lidog_tpu.models import MinkUNet34 as JaxMinkUNet34
    from lidog_tpu.serve import Predictor as JaxPredictor
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor
    from lidog_tpu_torch.utils.from_jax import state_dict_from_flax

    pts = _points()
    vox, plan = _jax_plan(pts)
    jm = JaxMinkUNet34(out_channels=7)
    variables, x = _jax_variables(jm, vox, plan)
    kw = dict(batch_size=B, voxel_size=VOXEL, caps_per_scan=CAPS_R[0],
              grid_half=GRID_HALF, caps=(CAPS_R, CAPS_A, None))
    jlabels = np.asarray(JaxPredictor(jm, variables, **kw)(pts))
    jlogits = np.asarray(jax.jit(
        lambda v: jm.apply(v, x, plan, train=False))(variables))

    model = MinkUNet34(out_channels=7)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    pred = Predictor(model, device="cpu", **kw)
    _, tplan, tlogits = pred.forward_voxels(pts)
    labels = pred(pts).numpy()
    assert pred.overflow is not None and pred.overflow.sum() == 0
    assert _rel(jlogits, tlogits.numpy()) <= 1e-3

    # per-point JAX top-2 margin, through the plan and voxel inverse maps
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    margin_row = top2[:, 1] - top2[:, 0]
    pos = np.asarray(plan.pos)
    inv = np.asarray(vox.inverse)
    row_of_pt = np.where(inv >= 0, pos[np.maximum(inv, 0)], -1)
    margin = np.where(row_of_pt >= 0,
                      margin_row[np.maximum(row_of_pt, 0)], 0.0)
    sure = (margin > 1e-3 * np.abs(jlogits).max()).reshape(B, P)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(labels[sure], jlabels[sure])
    assert ((labels >= 0) == (jlabels >= 0)).all()


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
