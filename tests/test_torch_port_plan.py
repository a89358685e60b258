"""lidog_tpu_torch's zseg plan builder vs lidog_tpu's, bitwise.

The same numpy voxel coords go through lidog_tpu.core.zseg.ZSegPlanBuilder
(jitted, XLA:CPU) and lidog_tpu_torch.core.zseg.ZSegPlanBuilder (plain
PyTorch on the CPU).  Every ZPlan field must be equal bit for bit: per
level coords, real, valid, zup, zdn; the conv9/down8/parent/off maps and
the stem occupancy or source-row maps; pos, rep and the overflow
counters.  Cases: the shapes of tests/test_zseg.py (grid_half 64), the
same input with starved capacities (every overflow counter path), the
serving shapes of tests/test_serve.py (voxelized points, grid_half 32),
the feature stem (stem_feature_map=True, tests/test_zseg_stem_feat.py's
input), sortless input (raw per-point cells with duplicates,
tests/test_sortless.py's clouds and caps), and voxels at the sweeps'
edges (data/synthetic.py plan_edge_voxels: the grid's x and y edges, z
at both ends of the plan's range, y columns with and without gaps
between their dilated slots), roomy, with starved row caps, with starved
y-dilated column caps (columns and their voxels dropped past the cap),
and as sortless input (each edge voxel 1-3 times, shuffled).

The generic UNetPlan (core/plan.py build_unet_plan) vs lidog_tpu's
core/plan.py, bitwise too: per level coords, mask and the sorted keys,
perm, every kernel map and the overflow counters, with roomy and with
starved coarse caps.

Also the LiDOG step's host and device pipeline: the BEV preprocessing and
collation bitwise, Encoder2D + DICE, and the whole LiDOG train step
against lidog_tpu's; the full-width Predictor and the IBN train step
against lidog_tpu's.  The last three sit here so that the three port
files share the heavy parity tests (pytest-xdist runs a file on one
worker).
"""

import numpy as np
import pytest

from tests.test_torch_port_serve import one_torch_thread  # noqa: F401


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
    assert (jp.rep is None) == (tp.rep is None)
    if jp.rep is not None:
        fields.append(("rep", jp.rep, tp.rep))
    assert len(jp.levels) == len(tp.levels) == 5
    for name, a, b in fields:
        a, b = np_of(a), t_of(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _sortless_inputs():
    """tests/test_sortless.py's two clouds (with in-voxel duplicates) as raw
    per-point cells: (coords [B*P, 4] int32, mask [B*P]), the per-point
    labels [B*P] and the points [B, P, 3]."""
    from tests.test_sortless import B, VOXEL, _cloud

    rng = np.random.RandomState(7)
    clouds = [_cloud(rng) for _ in range(B)]
    p = max(len(c[0]) for c in clouds)
    pts = np.zeros((B, p, 3), np.float32)
    valid = np.zeros((B, p), bool)
    labels = np.full((B, p), -1, np.int32)
    for b, (c, lab) in enumerate(clouds):
        pts[b, :len(c)], valid[b, :len(c)], labels[b, :len(c)] = c, True, lab
    vflat = valid.reshape(-1)
    disc = np.floor(pts.reshape(-1, 3) / np.float32(VOXEL)).astype(np.int32)
    bidx = np.repeat(np.arange(B, dtype=np.int32), p)
    coords = np.where(vflat[:, None], np.concatenate([bidx[:, None], disc],
                                                     1), 0).astype(np.int32)
    return coords, vflat, labels.reshape(-1), pts


@pytest.mark.parametrize("case", ["zseg", "zseg_starved", "serve", "stem125",
                                  "sortless", "edges", "edges_starved",
                                  "edges_col_starved", "edges_sortless"])
def test_plan_bitwise_equal(case, request):
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.voxelize import voxelize_device
    from lidog_tpu.core.zseg import ZSegPlanBuilder as JaxBuilder
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder, stem_feat125_plain

    options = {}
    if case.startswith("zseg") or case == "stem125":
        from tests.test_zseg import B, CAPS_A, CAPS_R, _build_inputs

        seed = 11 if case == "stem125" else 7  # test_zseg_stem_feat's: 11
        coords, mask, _ = _build_inputs(np.random.RandomState(seed))
        caps_r, caps_a, grid_half = CAPS_R, CAPS_A, 64
        if case == "zseg_starved":
            caps_r = tuple(c // 2 for c in CAPS_R)
            caps_a = tuple(c // 3 for c in CAPS_A)
        if case == "stem125":
            options = dict(stem_feature_map=True)
    elif case == "sortless":
        from tests.test_sortless import B, CAPS_A, CAPS_R, GRID_HALF

        coords, mask, _, _ = _sortless_inputs()
        caps_r, caps_a, grid_half = CAPS_R, CAPS_A, GRID_HALF
        options = dict(assume_unique=False)
    elif case.startswith("edges"):
        from lidog_tpu_torch.data import synthetic

        B, grid_half = 2, synthetic.EDGE_GRID_HALF
        coords, mask = synthetic.plan_edge_voxels(B)
        caps_r, caps_a = (synthetic.EDGE_CAPS_STARVED
                          if case == "edges_starved" else synthetic.EDGE_CAPS)
        if case == "edges_col_starved":  # columns past the dilated caps
            options = dict(caps_col_dil=synthetic.EDGE_COL_DIL_STARVED)
        if case == "edges_sortless":  # each voxel 1-3 times, shuffled
            coords, mask = synthetic.plan_edge_voxels_sortless(B)
            options = dict(assume_unique=False)
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
                            grid_half=grid_half, **options))(
        jnp.asarray(coords), jnp.asarray(mask))
    tbuilder = ZSegPlanBuilder(caps_r, caps_a, num_batches=B,
                               grid_half=grid_half, **options)
    tp = tbuilder(torch.from_numpy(coords), torch.from_numpy(mask))
    if case.endswith("starved"):
        assert int(np.asarray(jp.overflow)[1:].sum()) > 0
    else:
        assert int(np.asarray(jp.overflow).sum()) == 0
    if case == "stem125":  # the feature stem's maps replace the occupancy
        assert "stem_occ" not in tp.kmaps
        hits = int((tp.kmaps["stem125"] >= 0).sum())
        assert hits > int(tp.level(0).real.sum())
        # stem_inputs: the arguments the builder's level-0 sweep takes
        args, kwargs = tbuilder.stem_inputs(torch.from_numpy(coords),
                                            torch.from_numpy(mask))
        nbr, conv9 = stem_feat125_plain(*args, **kwargs)
        assert torch.equal(nbr, tp.kmaps["stem125"])
        assert torch.equal(conv9, tp.kmaps["conv9_l0"])
    if case.startswith("edges"):  # the stem window leaves [0, ZMAX) at z
        bz = coords[mask, 3] + 224  # ends, and x/y reach the grid's edges
        assert (bz < 2).any() and (bz >= 446).any()
        assert (np.abs(coords[mask, 1:3] + 0.5) > grid_half - 1).any()
    if case == "sortless":  # duplicates went in; every point has a row
        assert len(np.unique(coords[mask], axis=0)) < int(mask.sum())
        assert (tp.pos[torch.from_numpy(mask)] >= 0).all()
    if case == "edges_sortless":  # every point inside the grid has a row
        assert len(np.unique(coords[mask], axis=0)) < int(mask.sum())
        inside = mask & (np.abs(coords[:, 1:3] + 0.5).max(1) < grid_half)
        inside &= np.abs(coords[:, 3] + 0.5) < 224
        assert (tp.pos[torch.from_numpy(inside)] >= 0).all()
        assert (tp.pos[torch.from_numpy(mask & ~inside)] == -1).all()
    if case == "edges_col_starved":  # the column caps drop voxels at L0
        assert int(np.asarray(jp.overflow)[1]) > 0
    _assert_plans_equal(jp, tp)


@pytest.mark.parametrize("case", ["roomy", "starved"])
def test_unet_plan_bitwise_equal(case):
    """build_unet_plan on the same seeded rows (2 scans, duplicate
    cells, masked rows, coordinates on both sides of 0 so that the coarse
    levels floor negative coordinates) against lidog_tpu's jitted
    builder: every field equal; the starved caps drop voxels at levels 1-4
    (overflow > 0).  Also core/engine.py's UNetPlan branches
    (input_to_canon_map, canon_labels, input_tensor) against lidog_tpu's
    on the two plans."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.plan import build_unet_plan as jax_build
    from lidog_tpu_torch.core.plan import build_unet_plan

    rng = np.random.RandomState(13)
    n = 640
    coords = np.concatenate([rng.randint(0, 2, (n, 1)),
                             rng.randint(-12, 12, (n, 3))],
                            1).astype(np.int32)
    mask = rng.rand(n) < 0.9
    caps = {"roomy": (n, 640, 384, 192, 64),
            "starved": (n, 400, 120, 24, 3)}[case]
    jp = jax_build(jnp.asarray(coords), jnp.asarray(mask), caps)
    tp = build_unet_plan(torch.from_numpy(coords), torch.from_numpy(mask),
                         caps)
    for i, (a, b) in enumerate(zip(jp.levels, tp.levels)):
        assert a.stride == b.stride
        for f in ("coords", "mask", "hi", "lo"):
            want = np.asarray(getattr(a, f))
            got = getattr(b, f).numpy()
            assert want.dtype == got.dtype, (i, f)
            np.testing.assert_array_equal(want, got, err_msg=f"L{i} {f}")
    np.testing.assert_array_equal(np.asarray(jp.perm), tp.perm.numpy())
    assert sorted(jp.kmaps) == sorted(tp.kmaps)
    for k in jp.kmaps:
        assert tp.kmaps[k].dtype == torch.int32, k
        np.testing.assert_array_equal(np.asarray(jp.kmaps[k]),
                                      tp.kmaps[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(jp.overflow),
                                  tp.overflow.numpy())
    ov = tp.overflow.numpy()
    assert (ov[1:] > 0).all() if case == "starved" else not ov.any()
    # the engine's UNetPlan branches: input rows <-> level-0 rows
    from lidog_tpu.core import engine as jax_engine
    from lidog_tpu_torch.core import engine

    labels = rng.randint(-1, 5, n).astype(np.int32)
    feats = rng.randn(n, 3).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax_engine.input_to_canon_map(jp)),
        engine.input_to_canon_map(tp).numpy())
    for want, got in zip(jax_engine.canon_labels(jp, jnp.asarray(labels)),
                         engine.canon_labels(tp, torch.from_numpy(labels))):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_engine.input_tensor(jp, jnp.asarray(feats)).feats),
        engine.input_tensor(tp, torch.from_numpy(feats)).feats.numpy())


def test_sortless_matches_jax():
    """The port's sortless path (raw per-point cells, assume_unique=False)
    against its sorted one (voxelize_device, then the plan), as
    tests/test_sortless.py holds lidog_tpu's, on that file's clouds: the
    levels, kmaps and overflow of the two plans; pos (point -> the row of
    its voxel) and rep (each row's representative point: voxelize_device's
    rep_idx); canon_labels and input_tensor (labels, and 4-channel point
    features); one train step of a narrow MinkUNet34 each with the
    occupancy stem and with in_channels 4 on the feature stem: the loss
    and confusion -- all equal (atol 0).  lidog_tpu's canon_labels and
    input_tensor on the converted sortless plan give the same labels and
    features; Predictor(sortless=True, device="cpu") labels every point as
    the sorted Predictor does.  test_plan_bitwise_equal[sortless] holds the
    sortless plan against lidog_tpu's builder."""
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core.engine import canon_labels as jax_canon
    from lidog_tpu.core.engine import input_tensor as jax_input
    from lidog_tpu_torch.core.engine import canon_labels, input_tensor
    from lidog_tpu_torch.core.voxelize import voxelize_device
    from lidog_tpu_torch.core.zseg import ZSegPlanBuilder
    from lidog_tpu_torch.data.synthetic import point_features
    from lidog_tpu_torch.losses.losses import SoftDICELoss
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor
    from lidog_tpu_torch.train.optim import make_optimizer
    from lidog_tpu_torch.train.train_step import TrainState, make_train_step
    from tests.test_sortless import B, CAPS_A, CAPS_R, GRID_HALF, VOXEL
    from tests.test_torch_port_serve import NARROW, _jax_plan_of

    coords_raw, vflat, labels, pts = _sortless_inputs()
    n = vflat.shape[0]
    t = torch.from_numpy
    vox = voxelize_device(t(pts.reshape(-1, 3)), t(vflat),
                          torch.arange(B, dtype=torch.int32)
                          .repeat_interleave(pts.shape[1]), VOXEL,
                          B * CAPS_R[0])
    mask_s = vox.mask
    lab_s = torch.where(mask_s, t(labels)[vox.rep_idx.long()], -1)
    pf = t(point_features(pts, 4).reshape(n, 4)) * t(vflat)[:, None]
    feats_s = pf[vox.rep_idx.long()] * mask_s[:, None]
    for stem in (False, True):
        kw = dict(num_batches=B, grid_half=GRID_HALF, stem_feature_map=stem)
        plan_s = ZSegPlanBuilder(CAPS_R, CAPS_A, **kw)(vox.coords, mask_s)
        plan_r = ZSegPlanBuilder(CAPS_R, CAPS_A, assume_unique=False, **kw)(
            t(coords_raw), t(vflat))
        assert plan_s.rep is None and int(plan_s.overflow.sum()) == 0
        assert torch.equal(plan_s.overflow, plan_r.overflow)
        for ls, lr in zip(plan_s.levels, plan_r.levels):
            for f in ("coords", "real", "valid", "zup", "zdn"):
                assert torch.equal(getattr(ls, f), getattr(lr, f)), f
        assert sorted(plan_s.kmaps) == sorted(plan_r.kmaps)
        for k in plan_s.kmaps:
            assert torch.equal(plan_s.kmaps[k], plan_r.kmaps[k]), k
        ok = t(vflat) & (vox.inverse >= 0)
        assert torch.equal(plan_r.pos[ok],
                           plan_s.pos[vox.inverse[ok].long()])
        rows = plan_s.pos[mask_s].long()
        assert torch.equal(plan_r.rep[rows], vox.rep_idx[mask_s])
        assert (plan_r.rep[~plan_r.level(0).real] == -1).all()

        cs, cr = canon_labels(plan_s, lab_s), canon_labels(plan_r, t(labels))
        xs, xr = input_tensor(plan_s, feats_s), input_tensor(plan_r, pf)
        assert torch.equal(cs[0], cr[0]) and torch.equal(cs[1], cr[1])
        assert torch.equal(xs.feats, xr.feats) and int(cs[1].sum()) > 0
        jplan = _jax_plan_of(plan_r)
        jl, jv = jax_canon(jplan, jnp.asarray(labels))
        assert np.array_equal(np.asarray(jl), cr[0].numpy())
        assert np.array_equal(np.asarray(jv), cr[1].numpy())
        jx = jax_input(jplan, jnp.asarray(pf.numpy()))
        assert np.array_equal(np.asarray(jx.feats), xr.feats.numpy())

        cin = 4 if stem else 1
        batches = ({"feats": feats_s[:, :cin] if stem else mask_s[:, None]
                    .float(), "labels": lab_s},
                   {"feats": pf if stem else t(vflat)[:, None].float(),
                    "labels": t(labels)})
        metrics = []
        for batch, plan in zip(batches, (plan_s, plan_r)):
            model = MinkUNet34(out_channels=7, in_channels=cin,
                               generator=torch.Generator().manual_seed(3),
                               **NARROW)
            state = TrainState.create(model, make_optimizer("Adam", lr=1e-3),
                                      device="cpu")
            step = make_train_step(SoftDICELoss(ignore_label=-1))
            metrics.append(step(state, batch, plan)[1])
        assert float(metrics[0]["loss"]) == float(metrics[1]["loss"])
        assert torch.equal(metrics[0]["confusion"], metrics[1]["confusion"])

    model = MinkUNet34(out_channels=7, **NARROW)
    kw = dict(batch_size=1, voxel_size=VOXEL, caps_per_scan=CAPS_R[0],
              grid_half=GRID_HALF, device="cpu",
              caps=(CAPS_R, CAPS_A, tuple(5 * c for c in CAPS_R)))
    one = pts[:1]
    sorted_labels = Predictor(model, **kw)(one)
    raw_labels = Predictor(model, sortless=True, **kw)(one)
    assert torch.equal(sorted_labels, raw_labels)
    assert (raw_labels >= 0).float().mean() > 0.99


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
    from tests.test_torch_port_serve import _lidog_step_matches_jax

    _lidog_step_matches_jax(case)


def test_full_predictor_matches_jax(request):
    """Full-width MinkUNet34 in f32: the port's Predictor on the CPU vs
    lidog_tpu.serve.Predictor, at the shapes and tolerances of
    tests/test_torch_port_serve.py (logits 1e-3 of max |JAX logits|;
    per-point labels equal wherever the JAX top-2 logit margin exceeds
    1e-3 of max |logits|).  It sits here so that the three port files
    share the heavy parity tests (pytest-xdist runs a file on one
    worker)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax

    from lidog_tpu.models import MinkUNet34 as JaxMinkUNet34
    from lidog_tpu.serve import Predictor as JaxPredictor
    from lidog_tpu_torch.models.minkunet import MinkUNet34
    from lidog_tpu_torch.serve import Predictor
    from lidog_tpu_torch.utils.from_jax import state_dict_from_flax
    from tests.test_torch_port_serve import (B, CAPS_A, CAPS_R, GRID_HALF,
                                             VOXEL, P, _jax_plan,
                                             _jax_variables, _points, _rel)

    pts = _points()
    vox, plan = _jax_plan(pts)
    jm = JaxMinkUNet34(out_channels=7)
    model = MinkUNet34(out_channels=7)
    variables, x = _jax_variables(model, vox, plan)
    kw = dict(batch_size=B, voxel_size=VOXEL, caps_per_scan=CAPS_R[0],
              grid_half=GRID_HALF, caps=(CAPS_R, CAPS_A, None))
    jlabels = np.asarray(JaxPredictor(jm, variables, **kw)(pts))
    jlogits = np.asarray(jax.jit(
        lambda v: jm.apply(v, x, plan, train=False))(variables))

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


@pytest.mark.parametrize("case", ["float32"])
def test_ibn_step_matches_jax(case, request, monkeypatch):
    """The IBN step (narrow MinkUNet34IBN: the [BN, IN] norms of stages
    1-3; SoftDICE, Adam, through make_train_step) against lidog_tpu's, as
    test_robustnet_step_matches_jax (tests/test_torch_port_ops.py)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    from tests.test_torch_port_serve import _variant_step_matches_jax

    _variant_step_matches_jax("ibn", case, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder2d_dice_match_jax(dtype, request):
    """Encoder2D in train mode with from_jax weights against flax's on
    [2, 33, 33, 16]: the logits, the DICE(-1) loss on them, the grads of
    every parameter and of the input, and both BatchNorms' running mean
    and var after the update (flax's biased variance, momentum 0.9).
    JAX runs op by op (not jitted): under jit XLA fuses the bf16 norm and
    keeps intermediates in f32, and its bf16 grads then part from its own
    op-by-op grads by 6-30% (BatchNorm's backward sums two rounded
    cotangents that nearly cancel); op by op, JAX rounds where the port
    does.  Relative to max |JAX| per tensor: f32 1e-5 (logits, loss,
    running stats; summation order only) and 1e-4 (grads: the conv
    backward sums in another order); bf16 2e-2 (the same rounding points,
    other summation orders; measured <= 6e-3)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.losses.losses import DICELoss as JaxDICE
    from lidog_tpu.models.conv2d import Encoder2D as JaxEncoder
    from lidog_tpu_torch.losses.losses import DICELoss
    from lidog_tpu_torch.models.conv2d import Encoder2D
    from lidog_tpu_torch.utils.from_jax import state_dict_from_flax
    from tests.test_torch_port_serve import _rel

    rng = np.random.RandomState(12)
    c_in, n_cls = 16, 5
    x = np.maximum(rng.randn(2, 33, 33, c_in), 0).astype(np.float32)
    labels = rng.randint(-1, n_cls, (2, 9, 9)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol, tol_g = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)

    jm = JaxEncoder(n_classes=n_cls, compute_dtype=jdt)
    var = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                 train=False))
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 2.0, v.shape).astype(np.float32),
        var["batch_stats"])
    crit_j = JaxDICE(ignore_label=-1)

    def loss_j(params, xin):
        logits, upd = jm.apply({"params": params, "batch_stats": stats}, xin,
                               train=True, mutable=["batch_stats"])
        return crit_j(logits, jnp.asarray(labels)), (logits, upd)

    (lj, (logits_j, upd)), (gp, gx) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(var["params"],
                                              jnp.asarray(x, jdt))
    gp, upd = jax.device_get(gp), jax.device_get(upd)

    tm = Encoder2D(c_in, n_classes=n_cls, compute_dtype=tdt).train()
    tm.load_state_dict(state_dict_from_flax(
        {"params": var["params"], "batch_stats": stats}), strict=True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    logits_t = tm(xt)
    lt = DICELoss(ignore_label=-1)(logits_t, torch.from_numpy(labels))
    lt.backward()
    assert logits_t.dtype == torch.float32
    assert _rel(np.asarray(logits_j), logits_t.detach()) <= tol
    assert abs(float(lj) - lt.item()) <= tol * abs(float(lj))
    assert _rel(np.asarray(gx.astype(jnp.float32)), xt.grad.float()) <= tol_g
    named = dict(tm.named_parameters())
    flat = state_dict_from_flax({"params": gp})
    assert set(flat) == set(named)
    for k, g in flat.items():
        assert _rel(g.numpy(), named[k].grad) <= tol_g, k
    new_stats = state_dict_from_flax({"batch_stats": upd["batch_stats"]})
    buffers = dict(tm.named_buffers())
    assert set(new_stats) == set(buffers) and len(buffers) == 4
    for k, v in new_stats.items():
        assert _rel(v.numpy(), buffers[k]) <= tol, k
