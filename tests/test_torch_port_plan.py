"""lidog_tpu_torch's zseg plan builder vs lidog_tpu's, bitwise.

The same numpy voxel coords go through lidog_tpu.core.zseg.ZSegPlanBuilder
(jitted, XLA:CPU) and lidog_tpu_torch.core.zseg.ZSegPlanBuilder (plain
PyTorch on the CPU).  Every ZPlan field must be equal bit for bit: per
level coords, real, valid, zup, zdn; the conv9/down8/parent/off maps and
the stem occupancy; pos and the overflow counters.  Cases: the shapes of
tests/test_zseg.py (grid_half 64), the same input with starved capacities
(every overflow counter path), and the serving shapes of
tests/test_serve.py (voxelized points, grid_half 32).
"""

import numpy as np
import pytest


def _assert_plans_equal(jp, tp):
    import jax.numpy as jnp
    import torch

    def np_of(a):
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        return a

    def t_of(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    fields = [(f"level{i}.{f}", getattr(jl, f), getattr(tl, f))
              for i, (jl, tl) in enumerate(zip(jp.levels, tp.levels))
              for f in ("coords", "real", "valid", "zup", "zdn")]
    assert sorted(jp.kmaps) == sorted(tp.kmaps)
    fields += [(k, jp.kmaps[k], tp.kmaps[k]) for k in sorted(jp.kmaps)]
    fields += [("pos", jp.pos, tp.pos), ("overflow", jp.overflow, tp.overflow)]
    assert len(jp.levels) == len(tp.levels) == 5
    for name, a, b in fields:
        a, b = np_of(a), t_of(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["zseg", "zseg_starved", "serve"])
def test_plan_bitwise_equal(case, request):
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.voxelize import voxelize_device
    from lidog_tpu.core.zseg import ZSegPlanBuilder as JaxBuilder
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder

    if case.startswith("zseg"):
        from tests.test_zseg import B, CAPS_A, CAPS_R, _build_inputs

        coords, mask, _ = _build_inputs(np.random.RandomState(7))
        caps_r, caps_a, grid_half = CAPS_R, CAPS_A, 64
        if case == "zseg_starved":
            caps_r = tuple(c // 2 for c in CAPS_R)
            caps_a = tuple(c // 3 for c in CAPS_A)
    else:
        B, P = 2, 600
        pts = (np.random.RandomState(0).rand(B, P, 3).astype(np.float32)
               - 0.5) * 10.0
        vox = voxelize_device(
            jnp.asarray(pts.reshape(-1, 3)), jnp.ones((B * P,), bool),
            jnp.repeat(jnp.arange(B, dtype=jnp.int32), P), 0.5, 2048)
        coords, mask = np.asarray(vox.coords), np.asarray(vox.mask)
        caps_r = (1024, 1024, 512, 256, 128)
        caps_a = (2048, 1536, 768, 384, 192)
        grid_half = 32
    jp = jax.jit(JaxBuilder(caps_r, caps_a, num_batches=B,
                            grid_half=grid_half))(
        jnp.asarray(coords), jnp.asarray(mask))
    tp = ZSegPlanBuilder(caps_r, caps_a, num_batches=B, grid_half=grid_half)(
        torch.from_numpy(coords), torch.from_numpy(mask))
    if case == "zseg_starved":
        assert int(np.asarray(jp.overflow)[1:].sum()) > 0
    else:
        assert int(np.asarray(jp.overflow).sum()) == 0
    _assert_plans_equal(jp, tp)
