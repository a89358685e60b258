"""lidog_tpu_torch's zseg plan builder vs lidog_tpu's, bitwise.

The same numpy voxel coords go through lidog_tpu.core.zseg.ZSegPlanBuilder
(jitted, XLA:CPU) and lidog_tpu_torch.core.zseg.ZSegPlanBuilder (plain
PyTorch on the CPU).  Every ZPlan field must be equal bit for bit: per
level coords, real, valid, zup, zdn; the conv9/down8/parent/off maps and
the stem occupancy; pos and the overflow counters.  Cases: the shapes of
tests/test_zseg.py (grid_half 64), the same input with starved capacities
(every overflow counter path), and the serving shapes of
tests/test_serve.py (voxelized points, grid_half 32).

Also the LiDOG step's host and device pipeline: the BEV preprocessing and
collation bitwise, and the whole LiDOG train step against lidog_tpu's.
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


def test_bev_preprocess_collate_match():
    """The port's host BEV pipeline (data/bev.py preprocess_scan_bev and
    collate_bev, numpy) against lidog_tpu's on 2 synthetic scans at bound
    10 m: every array bitwise equal and of the same dtype, including the
    BEV label and selected-index images.  One case samples (sub_p 0.8)
    and augments through the callable protocol with a seeded rng and
    collates within capacity; the other collates into a capacity that
    drops voxels (the remap to -1)."""
    from lidog_tpu.data.bev import collate_bev as jax_collate
    from lidog_tpu.data.bev import preprocess_scan_bev as jax_prep
    from lidog_tpu_torch.data.bev import collate_bev, preprocess_scan_bev
    from lidog_tpu_torch.data.synthetic import SyntheticLidarDataset

    ds = SyntheticLidarDataset(num_scans=2, points_per_scan=6000, radius=10.0,
                               seed=3)

    def jitter(pts, rng):
        return pts + rng.normal(0, 0.05, pts.shape).astype(np.float32), {}

    kw = dict(voxel_size=0.1, bound_2d=10.0, bev_img_sizes={"block8": 34})
    for case, (train, capacity) in {"augmented": (True, 12_000),
                                    "dropping": (False, 4_000)}.items():
        samples = []
        for prep in (jax_prep, preprocess_scan_bev):
            samples.append([prep(ds[i]["points"], ds[i]["sem_labels"],
                                 sub_p=0.8, augmentations=jitter, train=train,
                                 rng=np.random.RandomState(i), **kw)
                            for i in range(2)])
        ja, ta = (collate(s, capacity) for collate, s in
                  ((jax_collate, samples[0]), (collate_bev, samples[1])))
        assert sorted(ja) == sorted(ta)
        for k in ja:
            a, b = np.asarray(ja[k]), np.asarray(ta[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (case, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{case} {k}")
        sel = ta["bev_selected_idx_block8"]
        assert (sel >= 0).sum() > 100, case
        assert (int(ta["dropped"]) > 0) == (case == "dropping")
        if case == "dropping":
            hit = ta["bev_labels_block8"] >= 0
            assert (sel[hit] == -1).any()  # a selected voxel was dropped


@pytest.mark.parametrize("case", ["float32", "float32-2src-warmup"])
def test_lidog_step_matches_jax(case, request):
    """The LiDOG step (narrow MinkUNet34BEV: the narrow backbone, the
    pooled BEV scatter of block8 and a full Encoder2D; SoftDICE + DICE,
    Adam) from a carried-over lidog_tpu TrainState: two steps on each
    side, compared as test_train_step_matches_jax compares them (loss,
    confusion, grads, params after Adam, batch_stats, here with
    Encoder2D's), plus the sem and bev losses and proj_iou (1e-5 relative,
    f32).  To keep JAX's tracing short, its step is the one jitted
    function: its grads are read back from its Adam step's first moment,
    its plans are the port's plans (bitwise equal to its own builder's,
    test_plan_bitwise_equal) and its initial variables the port model's
    random ones.  The two-source case warms up for 2 epochs of one step:
    the carried state has taken one step, so the gate is 0 at the first
    compared step (BEV loss only) and 1 at the second.  The shapes and
    tolerances are the serve file's train-step test's; the test sits here
    so that the three port files share the heavy parity tests (pytest-xdist
    runs a file on one worker)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return

    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.zseg import ZLevel as JaxLevel
    from lidog_tpu.core.zseg import ZPlan as JaxPlan
    from lidog_tpu.losses import DICELoss as JaxDICE
    from lidog_tpu.losses import SoftDICELoss as JaxSoftDICE
    from lidog_tpu.models.conv2d import Encoder2D as JaxEncoder
    from lidog_tpu.models.minkunet import MinkUNetBackbone
    from lidog_tpu.ops.bev import bev_scatter_pooled as jax_bev
    from lidog_tpu.train import TrainState as JaxState
    from lidog_tpu.train import make_optimizer as jax_optimizer
    from lidog_tpu.train.lidog_step import make_lidog_train_step as jax_step
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.losses.losses import DICELoss, SoftDICELoss
    from lidog_tpu_torch.models.minkunet_bev import MinkUNet34BEV
    from lidog_tpu_torch.train.lidog_step import make_lidog_train_step
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState
    from lidog_tpu_torch.utils.from_jax import (load_train_state,
                                                state_dict_from_flax)
    from tests.test_torch_port_serve import (B, BOUND_2D, CAPS_A, CAPS_R,
                                             GRID_HALF, LIDOG_SEED, NARROW,
                                             TRAIN_TOL, VOXEL, _lidog_batches,
                                             _rel)

    nsrc = 2 if "2src" in case else 1
    warmup = 2 if case.endswith("warmup") else 0
    tol_loss, tol_grad, tol_param = TRAIN_TOL["float32"]
    lr, C = 1e-3, 5
    sfx = [""] if nsrc == 1 else [str(s) for s in range(nsrc)]
    weights = (0.5, 0.5)

    class JaxNarrowBEV(fnn.Module):
        """lidog_tpu's MinkUNet34BEV with the narrow backbone."""

        @fnn.compact
        def __call__(self, x, plan, train=True, is_train=False):
            logits, taps = MinkUNetBackbone(out_channels=C, name="backbone",
                                            **NARROW)(x, plan, train)
            if not is_train:
                return logits, {}
            t = taps["block8"]
            bev = jax_bev(t.coords, t.feats, t.mask, num_batches=B,
                          voxel_size=VOXEL, bound=BOUND_2D,
                          segmented_rows=True)
            return logits, {"block8": JaxEncoder(
                n_classes=C, name="encoder2d_block8")(bev, train)}

    def to_jax(t):
        return (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))

    def jax_plan(tp):
        return JaxPlan(
            levels=tuple(JaxLevel(*(to_jax(getattr(lv, f)) for f in (
                "coords", "real", "valid", "zup", "zdn")), stride=lv.stride)
                for lv in tp.levels),
            kmaps={k: to_jax(v) for k, v in tp.kmaps.items()},
            pos=to_jax(tp.pos), overflow=to_jax(tp.overflow))

    jm = JaxNarrowBEV()
    tbuilder = ZSegPlanBuilder(CAPS_R, CAPS_A, num_batches=B,
                               grid_half=GRID_HALF)
    jbatch, jplans, tbatch, tplans = {}, {}, {}, {}
    for s, nb in zip(sfx, _lidog_batches(LIDOG_SEED, nsrc)):
        for k, v in nb.items():
            jbatch[k + s], tbatch[k + s] = jnp.asarray(v), torch.from_numpy(v)
        tplans[s] = tbuilder(tbatch["coords" + s], tbatch["mask" + s])
        jplans[s] = jax_plan(tplans[s])
        assert int(tplans[s].overflow.sum()) == 0
    jplan_arg = jplans if nsrc > 1 else jplans[""]
    tplan_arg = tplans if nsrc > 1 else tplans[""]

    model = MinkUNet34BEV(out_channels=C, num_batches=B, voxel_size=VOXEL,
                          bound_2d=BOUND_2D, **NARROW)
    variables = {"params": {}, "batch_stats": {}}
    buffers = dict(model.named_buffers())
    for name, v in model.state_dict().items():
        node = variables["batch_stats" if name in buffers else "params"]
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v.numpy().copy()
    tx = jax_optimizer("Adam", lr=lr)
    crit, bcrit = JaxSoftDICE(ignore_label=-1), JaxDICE(ignore_label=-1)
    jstep = jax.jit(jax_step(jm, tx, crit, bcrit, CAPS_R, num_classes=C,
                             source_weights=weights, num_sources=nsrc,
                             warmup_epochs=warmup, steps_per_epoch=1))

    jstate = JaxState.create(variables, tx)
    jstate, _ = jstep(jstate, jbatch, jplan_arg)  # Adam's moments, count 1

    tstate = TrainState.create(model, make_optimizer("Adam", lr=lr),
                               device="cpu")
    load_train_state(tstate, jax.device_get(jstate))
    tstep = make_lidog_train_step(SoftDICELoss(ignore_label=-1),
                                  DICELoss(ignore_label=-1), num_classes=C,
                                  source_weights=weights, num_sources=nsrc,
                                  warmup_epochs=warmup, steps_per_epoch=1)

    def leaf(tree, key):
        for part in key.split("."):
            tree = tree[part]
        return np.asarray(tree, np.float32)

    def adam_mu(state):
        return [p for p in jax.device_get(state.opt_state)
                if hasattr(p, "mu")][0].mu

    gates = []
    for step in range(2):
        if step:
            # as in test_train_step_matches_jax: the second step starts
            # from JAX's params
            model.load_state_dict(state_dict_from_flax(
                {"params": jax.device_get(jstate.params)}), strict=False)
        gates.append(float(int(jstate.step) >= warmup))
        mu_before = adam_mu(jstate)
        jstate, jm_out = jstep(jstate, jbatch, jplan_arg)
        tstate, tm_out = tstep(tstate, tbatch, tplan_arg)
        for k in jm_out:
            if k == "confusion":
                continue
            lj, lt = float(jm_out[k]), float(tm_out[k])
            assert np.isfinite(lt) and abs(lj - lt) <= tol_loss * abs(lj), \
                (step, k, lj, lt)
        assert sorted(jm_out) == sorted(tm_out)
        assert [k for k in tm_out if k.startswith("proj_iou")]
        cm_t = tm_out["confusion"].numpy()
        np.testing.assert_array_equal(np.asarray(jm_out["confusion"]), cm_t)
        jvars = jax.device_get({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
        mu = adam_mu(jstate)
        named = dict(model.named_parameters())
        assert any(k.startswith("encoder2d_block8.") for k in named)
        for name, p in named.items():
            # JAX's grad, from its Adam moment: mu = 0.9 mu_before + 0.1 g
            # (f32 rounding of mu, times 10: ~1e-6 of max |g|)
            g = (leaf(mu, name) - 0.9 * leaf(mu_before, name)) / 0.1
            assert _rel(g, p.grad.numpy()) <= tol_grad, (step, name)
            m = np.abs(leaf(mu, name))
            sure = m >= 1e-3 * m.max()
            d = np.abs(leaf(jvars["params"], name) - p.detach().numpy())
            assert (d[sure] <= tol_param * lr).all(), (step, name, d.max())
            assert (d <= 2 * lr).all(), (step, name, d.max())
        for name, buf in model.named_buffers():
            assert _rel(leaf(jvars["batch_stats"], name),
                        buf.numpy()) <= tol_grad, (step, name)
    assert gates == ([0.0, 1.0] if warmup else [1.0, 1.0])
    assert tstate.step == int(jstate.step) == 3
