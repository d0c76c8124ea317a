"""The row-move probes of the port (ops/kernels/rows.py) against the JAX
package's probe, benchmarks/micro_pallas_gather.py.

On the CPU the wrappers run their plain twins; the twins are held against
jnp and against the probe's two Pallas kernels, restated here and run in
interpret mode at a small shape.  Inputs come from numpy seeds.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, PARENTS, BLK = 4096, 1500, 2048   # two 2,048-row blocks


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "micro_pallas_gather",
        os.path.join(ROOT, "benchmarks", "micro_pallas_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(rows=ROWS, parents=PARENTS, dtype=np.float32):
    ids = RW.make_segments(rows, parents)
    v = np.random.RandomState(1).rand(parents, 8).astype(dtype)
    x = np.random.RandomState(2).rand(rows, 8).astype(dtype)
    return ids, v, x


@pytest.mark.parametrize("rows,parents", [(85504, 34816), (4096, 1500),
                                          (300, 200)])
def test_make_segments_is_the_probes(rows, parents):
    """Same numpy stream, same ids; the last shape runs out of parents and
    pads with the last id."""
    ref = np.asarray(_probe_module().make_segments(rows, parents))
    ids = RW.make_segments(rows, parents)
    assert ids.dtype == np.int32 and ids.shape == (rows,)
    np.testing.assert_array_equal(ids, ref)
    assert (np.diff(ids) >= 0).all() and 0 <= ids[0] and ids[-1] < parents


def test_take_rows_twin_against_jnp():
    ids, v, _ = _inputs()
    out = RW.take_rows(torch.as_tensor(v), torch.as_tensor(ids))
    assert PK.launch_counts()["take_rows"] == 0  # the twin, on the CPU
    np.testing.assert_array_equal(out.numpy(), np.asarray(jnp.asarray(v)[ids]))
    # ids outside [0, P) give zero rows, in any order
    rng = np.random.RandomState(3)
    wild = rng.randint(-5, PARENTS + 5, size=ROWS).astype(np.int32)
    out = RW.take_rows(torch.as_tensor(v), torch.as_tensor(wild)).numpy()
    ok = (wild >= 0) & (wild < PARENTS)
    assert (~ok).any()
    np.testing.assert_array_equal(out[ok], v[wild[ok]])
    assert not out[~ok].any()
    # where both conventions are defined (ids past the end), jnp.take's
    # fill agrees
    high = np.where(wild < 0, 0, wild)
    np.testing.assert_array_equal(
        RW.take_rows(torch.as_tensor(v), torch.as_tensor(high)).numpy(),
        np.asarray(jnp.take(jnp.asarray(v), high, axis=0, fill_value=0.0)))


def _pallas_take(v, ids, blk):
    """The probe's take_kernel with its block specs (the whole table in VMEM
    for each block of ids), in interpret mode."""
    def take_kernel(idx_ref, tab_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0, fill_value=0.0)

    rows, (parents, cols) = ids.shape[0], v.shape
    vmem = pltpu.VMEM
    return pl.pallas_call(
        take_kernel,
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        grid=(rows // blk,),
        in_specs=[pl.BlockSpec((blk,), lambda i: (i,), memory_space=vmem),
                  pl.BlockSpec((parents, cols), lambda i: (0, 0),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((blk, cols), lambda i: (i, 0),
                               memory_space=vmem),
        interpret=True)(jnp.asarray(ids), jnp.asarray(v))


@pytest.mark.parametrize("ids_kind", ["sorted", "unsorted", "out_of_range"])
@pytest.mark.parametrize("cols", [1, 6, 12, 13, 26])
def test_take_rows_twin_at_the_tree_widths(cols, ids_kind):
    """The widths of the tables the tree's passes gather from (the per-atom
    gamma, the atomic rows of one and two parameterizations, a level's
    packed rows of one and two), exact: rows are copied or zero.  Against
    the probe's take_kernel in interpret mode, whose fill agrees where ids
    run past the end; ids below zero (where jnp.take wraps) against numpy.
    A one-column table also as the vector the tree's gamma pass holds."""
    ids = RW.make_segments(ROWS, PARENTS)
    rng = np.random.RandomState(4)
    if ids_kind == "unsorted":
        ids = rng.permutation(ids)
    elif ids_kind == "out_of_range":
        ids = rng.randint(-5, PARENTS + 5, size=ROWS).astype(np.int32)
    v = np.random.RandomState(1).rand(PARENTS, cols).astype(np.float32)
    tv, ti = torch.as_tensor(v), torch.as_tensor(ids)
    out = RW.take_rows(tv, ti)
    assert PK.launch_counts()["take_rows"] == 0  # the twin, on the CPU
    assert out.dtype == torch.float32 and tuple(out.shape) == (ROWS, cols)
    high = ids >= 0
    taken = np.asarray(_pallas_take(v, np.where(high, ids, PARENTS), BLK))
    np.testing.assert_array_equal(out.numpy(), taken)
    ok = high & (ids < PARENTS)
    assert ok.all() == (ids_kind != "out_of_range")
    np.testing.assert_array_equal(out.numpy()[ok], v[ids[ok]])
    assert not out.numpy()[~ok].any()
    # in range, the twin is the stock gather the passes ran before
    assert torch.equal(out[torch.as_tensor(ok)],
                       tv[ti.long()[torch.as_tensor(ok)]])
    if cols == 1:
        vec = RW.take_rows(tv[:, 0].contiguous(), ti)
        assert tuple(vec.shape) == (ROWS,)
        assert torch.equal(vec, out[:, 0])
    # on the CPU float64 tables (what the CPU tests run the tree in) move
    # the same way through the twin
    out64 = RW.take_rows(tv.double(), ti)
    assert out64.dtype == torch.float64 and torch.equal(out64, out.double())


def test_cumsum_rows_twin_against_jnp_f64():
    _, _, x = _inputs(dtype=np.float64)
    out = RW.cumsum_rows(torch.as_tensor(x)).numpy()
    assert PK.launch_counts()["cumsum_rows"] == 0
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    assert ref.dtype == np.float64
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


def test_twins_against_the_probes_pallas_kernels():
    """The probe's take_kernel and cum_kernel, restated with its block
    specs (pltpu.VMEM blocks, the carried VMEM scratch row) and run in
    interpret mode on the CPU."""
    ids, v, x = _inputs()
    vmem = pltpu.VMEM

    def take_kernel(idx_ref, tab_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0, fill_value=0.0)

    taken = pl.pallas_call(
        take_kernel,
        out_shape=jax.ShapeDtypeStruct((ROWS, 8), jnp.float32),
        grid=(ROWS // BLK,),
        in_specs=[pl.BlockSpec((BLK,), lambda i: (i,), memory_space=vmem),
                  pl.BlockSpec((PARENTS, 8), lambda i: (0, 0),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((BLK, 8), lambda i: (i, 0), memory_space=vmem),
        interpret=True)(jnp.asarray(ids), jnp.asarray(v))
    np.testing.assert_array_equal(
        RW.take_rows(torch.as_tensor(v), torch.as_tensor(ids)).numpy(),
        np.asarray(taken))

    def cum_kernel(d_ref, out_ref, carry_ref):
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _():
            carry_ref[:] = jnp.zeros_like(carry_ref)
        c = jnp.cumsum(d_ref[:], axis=0) + carry_ref[:]
        out_ref[:] = c
        carry_ref[:] = c[-1:, :]

    summed = pl.pallas_call(
        cum_kernel,
        out_shape=jax.ShapeDtypeStruct((ROWS, 8), jnp.float32),
        grid=(ROWS // BLK,),
        in_specs=[pl.BlockSpec((BLK, 8), lambda i: (i, 0),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((BLK, 8), lambda i: (i, 0), memory_space=vmem),
        scratch_shapes=[vmem((1, 8), jnp.float32)],
        interpret=True)(jnp.asarray(x))
    out = RW.cumsum_rows(torch.as_tensor(x)).numpy()
    # two f32 summation orders of 4,096 values in [0, 1): each is within
    # R eps / 2 of the exact column sum in the worst case
    ref = np.cumsum(x.astype(np.float64), axis=0)
    tol = ROWS * np.finfo(np.float32).eps * np.abs(ref).max()
    assert np.abs(np.asarray(summed) - ref).max() <= tol
    assert np.abs(out - np.asarray(summed)).max() <= tol


@pytest.mark.parametrize("dtype,eps", [(np.float32, 2.0 ** -23),
                                       (np.float64, 2.0 ** -52)])
def test_boundary_diffs_cumsum_is_the_gather(dtype, eps):
    """cumsum_rows(boundary_diffs(v)) against take_rows(v, ids): every one
    of the R additions rounds a partial sum no larger than max|v| and every
    step was rounded once, so the deviation stays below R eps max|v|."""
    ids, v, _ = _inputs(dtype=dtype)
    # ids that skip parents, as a tree level's do (a parent without children)
    ids = (ids.astype(np.int64) * 2 % PARENTS).astype(np.int32)
    ids.sort()
    tv, ti = torch.as_tensor(v), torch.as_tensor(ids)
    starts = RW.row_starts(ti)
    assert starts[0].shape == starts[1].shape
    assert int(starts[0][0]) == 0
    np.testing.assert_array_equal(
        starts[0].numpy(), np.nonzero(np.r_[True, ids[1:] != ids[:-1]])[0])
    diffs = RW.boundary_diffs(tv, starts, ROWS)
    assert tuple(diffs.shape) == (ROWS, 8)
    assert int((diffs.abs().sum(1) > 0).sum()) <= starts[0].shape[0]
    out = RW.cumsum_rows(diffs)
    dev = float((out - RW.take_rows(tv, ti)).abs().max())
    assert dev == RW.broadcast_deviation(tv, ti)
    assert dev <= ROWS * eps * float(np.abs(v).max())
    # the JAX probe's own formulation on the same ids
    dvj = jnp.asarray(v)[ids[starts[0].numpy()]]
    dvj = jnp.concatenate([dvj[:1], dvj[1:] - dvj[:-1]], 0)
    diffs_j = jnp.zeros((ROWS, 8), dtype).at[starts[0].numpy()].set(dvj)
    np.testing.assert_array_equal(diffs.numpy(), np.asarray(diffs_j))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Argument checks that run before any launch (so they hold here too,
    on meta tensors that claim to lie on a card)."""
    tab = torch.empty((16, 6), dtype=torch.float32, device="meta")
    ids = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=r"\[P, C\]"):
        RW.take_rows(torch.empty((16, 6, 2), device="meta"), ids)
    with pytest.raises(ValueError, match="no columns"):
        RW.take_rows(torch.empty((16, 0), device="meta"), ids)
    with pytest.raises(ValueError, match="contiguous"):
        RW.take_rows(torch.empty((16, 8), device="meta")[:, :6], ids)
    with pytest.raises(ValueError, match="requires grad"):
        RW.take_rows(torch.empty((16, 6), device="meta", requires_grad=True),
                     ids)
    with pytest.raises(TypeError, match="dtype"):
        RW.take_rows(tab, ids.long())
    with pytest.raises(TypeError, match="dtype"):
        RW.take_rows(tab.half(), ids)
    with pytest.raises(ValueError, match="columns"):
        RW.cumsum_rows(torch.empty((8, 300), device="meta"))
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        RW.cumsum_rows(torch.empty((8,), device="meta"))


def _mirror_shapes():
    """(rows, cols) for each width the tests hold the #9 mirror at: 33
    tiles and 7 rows (the last tile cut short; the carry a tree over every
    tile before, or at 256 columns the group level, where the last group
    of 32 tiles closes and one tile stands past it), and for 8, 13 and 26
    columns enough tiles for the group level (ntiles * C > FLAT_VALUES)."""
    shapes = [(33 * RW.cumsum_layout(c)[1] + 7, c)
              for c in (1, 3, 8, 13, 26, 256)]
    for c in (8, 13, 26):
        tiles = RW.FLAT_VALUES // c + 2
        shapes.append(((tiles - 1) * RW.cumsum_layout(c)[1] + 7, c))
    return shapes


def _pallas_cumsum(x, blk=BLK):
    """The probe's cum_kernel with its block specs, in interpret mode; the
    rows padded with zeros to whole blocks (prefix sums of the first rows
    do not see them)."""
    rows, cols = x.shape
    padded = -(-rows // blk) * blk
    xp = np.zeros((padded, cols), np.float32)
    xp[:rows] = x
    vmem = pltpu.VMEM

    def cum_kernel(d_ref, out_ref, carry_ref):
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _():
            carry_ref[:] = jnp.zeros_like(carry_ref)
        c = jnp.cumsum(d_ref[:], axis=0) + carry_ref[:]
        out_ref[:] = c
        carry_ref[:] = c[-1:, :]

    out = pl.pallas_call(
        cum_kernel,
        out_shape=jax.ShapeDtypeStruct((padded, cols), jnp.float32),
        grid=(padded // blk,),
        in_specs=[pl.BlockSpec((blk, cols), lambda i: (i, 0),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((blk, cols), lambda i: (i, 0),
                               memory_space=vmem),
        scratch_shapes=[vmem((1, cols), jnp.float32)],
        interpret=True)(jnp.asarray(xp))
    return np.asarray(out)[:rows]


@pytest.mark.parametrize("rows,cols", _mirror_shapes())
def test_cumsum_mirror_against_f64_and_the_probes_kernel(rows, cols):
    """The redesigned #9's summation order (tiles of 32 (256 // C) rows, a
    Hillis-Steele scan of the part totals, the look-back's warp trees over
    group and tile totals), stated in plain torch: within 1e-5 of an f64
    prefix sum (of max|prefix|) and as close to the probe's Pallas kernel
    (interpret mode), on shapes that are not a tile multiple."""
    parts, tile_rows = RW.cumsum_layout(cols)
    assert parts == max(1, 256 // cols)
    assert tile_rows == RW.PART_ROWS * parts
    assert rows % tile_rows and -(-rows // tile_rows) > RW.GROUP_TILES
    x = np.random.RandomState(cols).rand(rows, cols).astype(np.float32)
    out = RW.cumsum_rows_mirror(torch.as_tensor(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == (rows, cols)
    ref = np.cumsum(x.astype(np.float64), axis=0)
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * scale
    pallas = _pallas_cumsum(x)
    assert np.abs(pallas - ref).max() <= 1e-5 * scale
    assert np.abs(out.numpy() - pallas).max() <= 2e-5 * scale


@pytest.mark.parametrize("rows,cols", _mirror_shapes()[1:4]
                         + _mirror_shapes()[-2:] + [(1, 8), (0, 3)])
def test_cumsum_mirror_is_exact_on_integers(rows, cols):
    """Small integers add exactly in float32 in any order, so the mirror
    equals the running sum bit for bit: every tile's carry takes the
    totals of exactly the tiles before it, and every row its parts."""
    x = np.random.RandomState(5).randint(-3, 4, (rows, cols))
    out = RW.cumsum_rows_mirror(torch.as_tensor(x, dtype=torch.float32))
    np.testing.assert_array_equal(out.numpy(),
                                  np.cumsum(x, axis=0).astype(np.float32))
    # signed floats: order-dependent, the mirror repeats itself
    y = torch.as_tensor(np.random.RandomState(6).randn(rows, cols),
                        dtype=torch.float32)
    assert torch.equal(RW.cumsum_rows_mirror(y), RW.cumsum_rows_mirror(y))
