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
and as sortless input (each edge voxel 1-3 times, shuffled).  The int32
tables behind the plan's sweeps, aug16 and the packed rows, are held
against lidog_tpu's _assemble_aug and _build_packed at their three
widths (test_plan_tables_bitwise_equal).

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


@pytest.mark.parametrize("case", ["zseg", "zseg_starved", "sortless"])
def test_plan_tables_bitwise_equal(case, request):
    """The port's int32 tables against lidog_tpu's, bitwise: the plain KX
    (assemble_aug_plain) and KU (_build_packed_plain) against
    lidog_tpu's _assemble_aug and _build_packed, jitted on the CPU, on the
    same tables (the port's plain builder's column tables of each level,
    as numpy; its real words, int32 [slots, 16] with zero pad words as
    lidog_tpu's real16, go in unchanged): aug16 (int32 words, global
    start, count), counts_b, the aug rows' overflow term, and the packed
    rows with their padding.  Widths:
    r 2 / aug_r 1 (115 -> 120 words) and r 2 / aug_r 2 (the general stem,
    145 -> 152) at level 0, r -1 / aug_r 1 (45 -> 48) at levels 1-4.
    Inputs: tests/test_zseg.py's (unique; and its starved caps, as
    test_plan_bitwise_equal's zseg_starved) and tests/test_sortless.py's
    clouds as raw cells (sortless)."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core import zseg as jz
    from lidog_tpu_torch.core import zseg as tz

    options = {}
    if case.startswith("zseg"):
        from tests.test_zseg import B, CAPS_A, CAPS_R, _build_inputs

        coords, mask, _ = _build_inputs(np.random.RandomState(7))
        caps_r, caps_a, grid_half = CAPS_R, CAPS_A, 64
        if case == "zseg_starved":
            caps_r = tuple(c // 2 for c in CAPS_R)
            caps_a = tuple(c // 3 for c in CAPS_A)
    else:
        from tests.test_sortless import B, CAPS_A, CAPS_R, GRID_HALF

        coords, mask, _, _ = _sortless_inputs()
        caps_r, caps_a, grid_half = CAPS_R, CAPS_A, GRID_HALF
        options = dict(assume_unique=False)
    builder = tz.ZSegPlanBuilder(caps_r, caps_a, num_batches=B,
                                 grid_half=grid_half, **options)
    aug_j = jax.jit(jz._assemble_aug, static_argnums=(4, 5, 6, 7))
    packed_j = jax.jit(jz._build_packed, static_argnums=(4, 5, 6, 7),
                       static_argnames=("aug_r",))
    aug_over = 0
    widths = set()
    for lvl, name, args, kwargs in builder.table_inputs(
            torch.from_numpy(coords), torch.from_numpy(mask)):
        if name != "assemble_aug":
            continue
        real_w, col_bxy, col_valid, grid_d, nb, g, ccap, cap_a = args
        # lidog_tpu's real16 and cid_grid dtypes and layout
        assert real_w.dtype == torch.int32
        assert tuple(real_w.shape) == (nb * ccap, 16)
        assert not real_w[:, 14:].any() and real_w[:, :14].any()
        assert grid_d.dtype == torch.int32
        jargs = (jnp.asarray(real_w.numpy()),
                 jnp.asarray(col_bxy.numpy().astype(np.int32)),
                 jnp.asarray(col_valid.numpy()),
                 jnp.asarray(grid_d.numpy()))
        overflow = torch.zeros_like(kwargs["overflow"])
        aug16, counts_b = tz.assemble_aug_plain(*args, level=lvl,
                                                overflow=overflow)
        ja, jc = aug_j(*jargs, nb, g, ccap, cap_a)
        assert aug16.dtype == torch.int32 and np.asarray(ja).dtype == np.int32
        np.testing.assert_array_equal(aug16.numpy(), np.asarray(ja),
                                      err_msg=f"aug16 L{lvl}")
        np.testing.assert_array_equal(counts_b.numpy(), np.asarray(jc),
                                      err_msg=f"counts_b L{lvl}")
        term = int(jnp.sum(jnp.maximum(jc - cap_a, 0)))
        assert int(overflow[1 + lvl]) == term, (lvl, overflow, term)
        aug_over += term
        forms = ((2, 1), (2, 2)) if lvl == 0 else ((-1, 1),)
        for r, aug_r in forms:
            packed = tz._build_packed_plain(real_w, aug16, col_bxy, col_valid,
                                            nb, ccap, cap_a, r, aug_r)
            jp = np.asarray(packed_j(jargs[0], ja, *jargs[1:3], nb, ccap,
                                     cap_a, r, aug_r=aug_r))
            assert packed.dtype == torch.int32 and jp.dtype == np.int32
            assert packed.shape[1] == tz.packed_width(r, aug_r) \
                and packed.shape[1] % 8 == 0
            np.testing.assert_array_equal(packed.numpy(), jp,
                                          err_msg=f"packed L{lvl} {r} {aug_r}")
            widths.add(packed.shape[1])
    assert widths == {120, 152, 48}
    # the starved caps drop aug rows; the roomy ones hold every row
    assert (aug_over > 0) == (case == "zseg_starved")


def _zseg_case(case):
    """(coords, mask, B, caps_real, caps_aug, grid_half, builder options)
    of the zseg cases: tests/test_zseg.py's input (zseg), with caps_col_dil
    below its dilated columns at every level (zseg_starved: columns and
    their voxels dropped at L0), or tests/test_sortless.py's clouds as raw
    cells (sortless)."""
    if case.startswith("zseg"):
        from tests.test_zseg import B, CAPS_A, CAPS_R, _build_inputs

        coords, mask, _ = _build_inputs(np.random.RandomState(7))
        options = {}
        if case == "zseg_starved":
            options = dict(caps_col_dil=(300, 300, 150, 60, 30))
        return coords, mask, B, CAPS_R, CAPS_A, 64, options
    from tests.test_sortless import B, CAPS_A, CAPS_R, GRID_HALF

    coords, mask, _, _ = _sortless_inputs()
    return (coords, mask, B, CAPS_R, CAPS_A, GRID_HALF,
            dict(assume_unique=False))


@pytest.mark.parametrize("case", ["zseg", "zseg_starved", "sortless"])
def test_column_grid_bitwise_equal(case, request):
    """The port's plain KV (column_grid_plain) against lidog_tpu's column
    grid, bitwise, at every level of the builder's plan: on the has grid
    of the level's source rows (lidog_tpu's _cell_of and key), lidog_tpu's
    _dilate_y + _grid_from_has (jitted on the CPU) give the int32 grid_d
    and the column-overflow term that column_grid_plain gives (its
    overflow[1 + level] less the voxels whose column was dropped), and at
    level 0 of unique input the real rows past caps_real[0].  Inputs as
    _zseg_case; zseg_starved drops columns and voxels at L0."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core import zseg as jz
    from lidog_tpu.core.bitgrid import _cell_of
    from lidog_tpu_torch.core import zseg as tz

    coords, mask, B, caps_r, caps_a, gh, options = _zseg_case(case)
    builder = tz.ZSegPlanBuilder(caps_r, caps_a, num_batches=B,
                                 grid_half=gh, **options)
    dilate = jax.jit(jz._dilate_y, static_argnums=(1, 2))
    grid_of = jax.jit(jz._grid_from_has, static_argnums=(1, 2, 3))
    drops = []
    for lvl, name, args, kwargs in builder.table_inputs(
            torch.from_numpy(coords), torch.from_numpy(mask)):
        if name != "column_grid":
            continue
        src, valid, nb, _, _, ccap, r = args
        g = (2 * gh) >> lvl
        overflow = torch.zeros_like(kwargs["overflow"])
        grid_d, vox_cid, _, _ = tz.column_grid_plain(
            *args, overflow=overflow, cap_real=kwargs["cap_real"])
        # lidog_tpu's has grid of the same rows (its __call__:863-884)
        b_, gx, gy, _, inb = _cell_of(jnp.asarray(src.numpy()), gh, lvl)
        ok = jnp.asarray(valid.numpy()) & inb
        key = (jnp.where(ok, b_, 0) * g + jnp.clip(gx, 0, g - 1)) * g \
            + jnp.clip(gy, 0, g - 1)
        cells = nb * g * g
        has2 = jnp.zeros((cells + 1,), jnp.int8).at[
            jnp.where(ok, key, cells)].set(1, mode="drop")[:cells]
        has2 = has2.reshape(nb, g * g).astype(jnp.int32)
        jgrid, _, jover = grid_of(dilate(has2, g, r), nb, g, ccap)
        assert grid_d.dtype == torch.int32
        np.testing.assert_array_equal(grid_d.numpy(), np.asarray(jgrid),
                                      err_msg=f"grid_d L{lvl}")
        drop = int((torch.from_numpy(np.asarray(ok)) & (vox_cid < 0)).sum())
        assert int(overflow[1 + lvl]) - drop == int(jover), (lvl, overflow)
        drops.append(drop)
        real_over = 0
        if kwargs["cap_real"] >= 0:
            nreal = jnp.zeros((nb + 1,), jnp.int32).at[
                jnp.where(ok, b_, nb)].add(1, mode="drop")[:nb]
            real_over = int(jnp.sum(jnp.maximum(nreal - kwargs["cap_real"],
                                                0)))
        assert int(overflow[0]) == real_over, (lvl, overflow)
    assert len(drops) == 5
    assert (drops[0] > 0) == (case == "zseg_starved"), drops


def _kv_row_pass(has, ccap, r, tile_words, blocks, rng):
    """A numpy transliteration of KV's row pass (csrc/zseg_tables.cu
    grid_rows_kernel) on a has grid bool [B, g, g]: bit words of each
    (b, gx) row padded to W words, per tile of whole rows the word
    dilation with carries from the row's neighbour words, popcounts,
    KV_WORDS-word thread sums and their block scan, the decoupled
    look-back over the scan's tiles (each tile publishes its sum at once
    and its inclusive prefix at a random later point, so that a look-back
    also sums tiles that only published their own sum), and the grid's
    4-cell stores.  Returns (grid int32 [B*g*g], column overflow)."""
    from lidog_tpu_torch.core.zseg import column_grid_tiles

    nb, g, _ = has.shape
    w, rows_per_tile, tiles = column_grid_tiles(g, nb, tile_words, blocks)
    bits = np.zeros((nb, g, w * 32), bool)
    bits[:, :, :g] = has
    words = np.packbits(bits.reshape(nb, g, w, 32), axis=-1,
                        bitorder="little").view("<u4")[..., 0]
    tail = np.uint32((1 << (g % 32)) - 1 if g % 32 else 0xFFFFFFFF)

    def popc(x):
        return np.unpackbits(x.astype("<u4").view(np.uint8).reshape(
            x.shape + (4,)), axis=-1).sum(-1).astype(np.int64)

    agg, prefix = 1 << 62, 2 << 62
    grid = np.full((nb, g, g), -1, np.int64)
    col_over = 0
    for b in range(nb):
        st = [0] * tiles
        pending = []
        for k in range(tiles):
            row0 = k * rows_per_tile
            x = words[b, row0:row0 + rows_per_tile]  # the tile's rows
            px = np.zeros_like(x)
            px[:, 1:] = x[:, :-1]
            nx = np.zeros_like(x)
            nx[:, :-1] = x[:, 1:]
            d = x.copy()
            for s in range(1, r + 1):
                d |= ((x >> np.uint32(s)) | (nx << np.uint32(32 - s))
                      | (x << np.uint32(s)) | (px >> np.uint32(32 - s)))
            d[:, -1] &= tail
            flat = d.reshape(-1)
            cnt = popc(flat)
            # 4 words a thread, the block scan of the thread sums
            per = np.zeros(-(-flat.size // 4) * 4, np.int64)
            per[:flat.size] = cnt
            thread = per.reshape(-1, 4)
            excl = np.cumsum(thread.sum(1)) - thread.sum(1)
            pre = (excl[:, None] + np.cumsum(thread, 1) - thread).reshape(-1)
            pre = pre[:flat.size]
            tile_sum = int(cnt.sum())
            st[k] = (prefix if k == 0 else agg) | tile_sum
            before, p = 0, k - 1
            while p >= 0:  # 32 lanes a round
                ws = [st[p - lane] if p - lane >= 0 else prefix
                      for lane in range(32)]
                first_p = next((i for i, v in enumerate(ws) if v & prefix),
                               32)
                first_z = next((i for i, v in enumerate(ws) if v == 0), 32)
                upto = min(first_p + 1, first_z)
                before += sum(v & (agg - 1) for v in ws[:upto])
                if first_p < first_z:
                    break
                p -= upto
            if k:
                pending.append((k, before + tile_sum))
            for i in sorted(rng.choice(len(pending), rng.randint(
                    len(pending) + 1), replace=False), reverse=True):
                kk, v = pending.pop(i)
                st[kk] = prefix | v
            if k == tiles - 1:
                col_over += max(before + tile_sum - ccap, 0)
            # the stores: cell (row, col) of word row * W + col // 32
            nrows = d.shape[0]
            row, col = np.divmod(np.arange(nrows * g), g)
            e = row * w + col // 32
            bit = (col % 32).astype(np.uint32)
            we = flat[e]
            if g % 4 == 0:  # 4 cells a store, from the first one's rank
                first = bit & np.uint32(~3 & 31)
                lower = we & ((np.uint32(1) << first) - np.uint32(1))
                c = before + pre[e] + popc(lower)
                on = ((we >> bit) & 1).astype(np.int64)
                within = on.reshape(-1, 4)
                c = c + (np.cumsum(within, 1) - within).reshape(-1)
            else:
                lower = we & ((np.uint32(1) << bit) - np.uint32(1))
                c = before + pre[e] + popc(lower)
                on = ((we >> bit) & 1).astype(np.int64)
            out = np.where((on == 1) & (c < ccap), c + b * ccap, -1)
            grid[b, row0:row0 + nrows] = out.reshape(nrows, g)
    return grid.reshape(-1).astype(np.int32), col_over


@pytest.mark.parametrize("g,r,tile_words,blocks", [
    (2048, 2, 1024, 264), (40, 1, 2, 264), (30, 2, 4, 1), (4, 1, 1024, 264),
    (200, 1, 1024, 4)])
def test_column_grid_row_pass_model(g, r, tile_words, blocks):
    """KV's row pass, transliterated to numpy (_kv_row_pass), against
    lidog_tpu's _dilate_y + _grid_from_has on the same has grid (2 scans):
    the training plan's level-0 width with the kernel's own blocking (15
    rows a tile, 137 tiles a scan, the last one short), and other tiles
    over widths that are not powers of two (g 200: 7 words a row), not
    multiples of 4 or below one word, with one row a tile or a short last
    tile (40 tiles a scan at g 40, so that the look-back crosses 32-tile
    rounds; every look-back also sums tiles that only published their own
    sum); columns past ccap are dropped in each case."""
    import jax
    import jax.numpy as jnp

    from lidog_tpu.core import zseg as jz

    rng = np.random.RandomState(g + r)
    nb = 2
    has = np.zeros((nb, g, g), bool)
    for b in range(nb):  # clusters of occupied cells and a few lone ones
        n = max(g * g // 200, 3)
        gx, gy = rng.randint(0, g, n), rng.randint(0, g, n)
        for dx in range(3):
            has[b, np.minimum(gx + dx, g - 1), gy] = True
        has[b, rng.randint(0, g, n), rng.randint(0, g, n)] = True
    has[0, :, g - 1] = True  # the rows' last cells (the tail word)
    dil = np.asarray(jax.jit(jz._dilate_y, static_argnums=(1, 2))(
        jnp.asarray(has.reshape(nb, g * g).astype(np.int32)), g, r))
    ccap = int(dil.sum(1).max() * 3 // 4)
    jgrid, _, jover = jax.jit(jz._grid_from_has, static_argnums=(1, 2, 3))(
        jnp.asarray(dil), nb, g, ccap)
    grid, over = _kv_row_pass(has, ccap, r, tile_words, blocks, rng)
    np.testing.assert_array_equal(grid, np.asarray(jgrid))
    assert over == int(jover) > 0


def _pos3_case(case):
    """(coords, mask, B, caps_real, caps_aug, grid_half, builder options)
    of the pos3 cases: _zseg_case's zseg and sortless; zseg_starved with
    tests/test_zseg.py's caps_real and caps_aug cut as
    test_plan_tables_bitwise_equal's (aug rows past cap_a) and its
    y-dilated column caps as _zseg_case's (rows whose column was
    dropped)."""
    coords, mask, B, caps_r, caps_a, gh, options = _zseg_case(case)
    if case == "zseg_starved":
        caps_r = tuple(c // 2 for c in caps_r)
        caps_a = tuple(c // 3 for c in caps_a)
    return coords, mask, B, caps_r, caps_a, gh, options


@pytest.mark.parametrize("case", ["zseg", "zseg_starved", "sortless"])
def test_pos3_bitwise_equal(case, request):
    """The port's plain KT (pos3_plain) against lidog_tpu's pos3_lookup,
    jitted on the CPU, at every level of the builder's plan: the same aug16,
    source rows and column ids (the builder's vox_cid), and the level's
    grid; both int32 [3, N] and equal.  The starved case loses rows both
    to dropped columns and to the aug rows' cap."""
    from tests.conftest import run_isolated

    if run_isolated(request):
        return
    import jax.numpy as jnp
    import torch

    from lidog_tpu.core import zseg as jz
    from lidog_tpu_torch.core import zseg as tz

    coords, mask, B, caps_r, caps_a, gh, options = _pos3_case(case)
    builder = tz.ZSegPlanBuilder(caps_r, caps_a, num_batches=B,
                                 grid_half=gh, **options)
    calls = {}
    for lvl, name, args, kwargs in builder.sweep_inputs(
            torch.from_numpy(coords), torch.from_numpy(mask)):
        calls.setdefault(lvl, {})[name] = (args, kwargs)
    misses = 0
    for lvl in range(5):
        args, kwargs = calls[lvl]["pos3_lookup"]
        aug16, src, valid, g, cap_a, _, level = args
        ccap = calls[lvl]["_build_packed"][0][5]
        grid_d = calls[lvl]["conv9_packed" if lvl else
                            "stem_conv9_packed"][0][0]
        pos3 = tz.pos3_plain(*args, **kwargs)
        cid = kwargs["cid"].numpy()
        assert cid.min() >= -1 and cid.max() < 2**31
        want = np.asarray(jz.pos3_lookup(
            jnp.asarray(grid_d.numpy()), jnp.asarray(aug16.numpy()),
            jnp.asarray(src.numpy()), jnp.asarray(valid.numpy()), g=g,
            ccap=ccap, cap_a=cap_a, nb=B, grid_half=gh, level=level,
            cid=jnp.asarray(cid.astype(np.int32))))
        assert pos3.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(pos3.numpy(), want,
                                      err_msg=f"pos3 L{lvl}")
        assert (want[1][valid.numpy()] >= 0).any()
        misses += int((want[1][valid.numpy()] < 0).sum())
    assert (misses > 0) == (case == "zseg_starved"), misses


def _kw_coarsen_model(col_bxy, col_valid, fine_grid, fine_real, nb: int,
                      grid_half: int, level: int, threads: int = 256):
    """A numpy transliteration of KW's coarsening at levels 1-4
    (csrc/zseg_tables.cu coarsen_kernel), lane by lane: 4 lanes a slot
    (thread t: slot t // 4, quarter q = t % 4), lane q's grid lookup of
    child column q shuffled to its group, every lane's 16-byte quarter of
    the 4 child rows ORed, the pair compression, the packed halves p0 and
    p1, the 5 width-4 shuffles from lanes 2q-2, 2q-1 and 2q, and the
    16-bit funnel shifts into the lane's 4 output words.  Returns the
    int32 table [slots, 16]."""
    u32 = np.uint64(0xFFFFFFFF)
    slots, fs = col_bxy.shape[0], fine_real.shape[0]
    n = -(-slots * 4 // threads) * threads  # the launch's lanes
    t = np.arange(n)
    s, q = t // 4, t % 4
    inn = s < slots
    sc = np.minimum(s, slots - 1)
    f_g = (2 * grid_half) >> (level - 1)
    p = col_bxy[sc]
    b = p >> 24
    gxf = 2 * ((p >> 12) & 4095) + (q >> 1)
    gyf = 2 * (p & 4095) + (q & 1)
    ok = (inn & col_valid[sc] & (gxf < f_g) & (gyf < f_g) & (b >= 0)
          & (b < nb))
    c = fine_grid[np.where(ok, (b * f_g + gxf) * f_g + gyf, 0)]
    cidf = np.where(ok & (c >= 0) & (c < fs), c, -1)

    def shfl(v, src):  # __shfl_sync(.., v, src, 4): src in [0, 4)
        return v[t - t % 4 + src]

    quarters = fine_real.astype(np.int64).astype(np.uint64).reshape(
        fs, 4, 4) & u32
    acc = np.zeros((n, 4), np.uint64)
    for j in range(4):
        cj = shfl(cidf, j)
        acc |= np.where(cj[:, None] >= 0, quarters[np.maximum(cj, 0), q], 0)
    acc[q == 3, 2:] = 0  # words 14, 15

    def compress(x):
        x = x & np.uint64(0x55555555)
        for sh, m in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF),
                      (8, 0x0000FFFF)):
            x = (x | (x >> np.uint64(sh))) & np.uint64(m)
        return x

    comp = compress(acc | (acc >> np.uint64(1)))
    sixteen = np.uint64(16)
    p0 = comp[:, 0] | (comp[:, 1] << sixteen)
    p1 = comp[:, 2] | (comp[:, 3] << sixteen)
    w = []
    for j in range(5):
        src = 2 * q - 2 + (j >> 1)
        x = shfl(p1 if j & 1 else p0, src & 3)
        w.append(np.where((src >= 0) & (src < 4), x, np.uint64(0)))
    out = np.zeros((slots, 16), np.uint64)
    for e in range(4):
        word = ((w[e] >> sixteen) | (w[e + 1] << sixteen)) & u32
        out[s[inn], 4 * q[inn] + e] = word[inn]
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", ["zseg", "sortless", "edges",
                                  "edges_col_starved"])
def test_real_words_coarsen_model(case):
    """KW's coarsening (levels 1-4), transliterated to numpy
    (_kw_coarsen_model), against real_words_plain on the builder's own
    inputs at every level: _zseg_case's zseg and sortless inputs, and the
    edge voxels (data/synthetic.py plan_edge_voxels) with roomy and with
    starved y-dilated column caps (child columns missing from the finer
    grid).  The output is int32 [slots, 16] with zero pad words, the row
    layout that csrc/zseg_rows.cuh states for both CUDA sources."""
    import re

    import torch

    from lidog_tpu_torch.core import zseg as tz
    from lidog_tpu_torch.data import synthetic
    from lidog_tpu_torch.ops import _cuda

    rows = (_cuda.CSRC / "zseg_rows.cuh").read_text()
    for name in ("ZWORDS", "REAL_W"):
        m = re.search(rf"constexpr int {name} = (\d+);", rows)
        assert m and int(m.group(1)) == getattr(tz, name), name
    for src in ("zseg_tables", "zseg_sweeps"):
        text = (_cuda.CSRC / f"{src}.cu").read_text()
        assert '#include "zseg_rows.cuh"' in text, src
        assert not re.search(r"constexpr int (ZWORDS|REAL_W) ", text), src

    if case.startswith("edges"):
        B, gh = 2, synthetic.EDGE_GRID_HALF
        coords, mask = synthetic.plan_edge_voxels(B)
        caps_r, caps_a = synthetic.EDGE_CAPS
        options = ({} if case == "edges" else
                   dict(caps_col_dil=synthetic.EDGE_COL_DIL_STARVED))
    else:
        coords, mask, B, caps_r, caps_a, gh, options = _zseg_case(case)
    builder = tz.ZSegPlanBuilder(caps_r, caps_a, num_batches=B,
                                 grid_half=gh, **options)
    levels = 0
    for lvl, name, args, kwargs in builder.table_inputs(
            torch.from_numpy(coords), torch.from_numpy(mask)):
        if name != "real_words" or lvl == 0:
            continue
        level, nb, ccap, _ = args
        want = tz.real_words_plain(*args, **kwargs)
        assert want.dtype == torch.int32
        assert tuple(want.shape) == (nb * ccap, 16)
        assert not want[:, 14:].any() and want.any()
        got = _kw_coarsen_model(
            kwargs["col_bxy"].numpy(), kwargs["col_valid"].numpy(),
            kwargs["fine_grid"].numpy().astype(np.int64),
            kwargs["fine_real"].numpy(), nb, gh, level)
        np.testing.assert_array_equal(got, want.numpy(),
                                      err_msg=f"real words L{level}")
        levels += 1
    assert levels == 4


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
