"""K2, the block SpMV kernel (``hpdg_tpu_torch.ops.block_spmv``), and
``blockmatrix.matvec``'s dispatch to it.

On the CPU (no card, no nvcc):

* the row-sorted table (``row_ptr``, ``slot``, ``col``) of the patterns
  of config 4's hierarchy at 4^3 p=2 (the plan's diagonal-first fine
  pattern, the Galerkin p- and h-coarse patterns), of a mixed-degree hp
  pattern with rectangular buckets, and of a pattern with empty rows;
* the kernel's traversal (rows by ``row_ptr``, blocks by ``slot``,
  later buckets of a row bucket adding into its y) replayed in numpy
  against the plain ``matvec``, 1e-13 of max|y| in f64, which checks
  everything of the kernel but its arithmetic on the CPU;
* the plain ``matvec`` against the reference's (``hpdg_tpu``) on the hp
  pattern, 1e-12 (JAX is imported inside that test only);
* the dispatch: CPU tensors take the plain version and build nothing;
  the kernel's wrapper refuses CPU tensors, f16 and blocks over 6144,
  and takes every bucket of 3D elasticity at p=3, 4, 5 and mixed 4/5
  (blocks of 192, 375 and 648), whose plain product equals the
  kernel's traversal replayed in numpy;
* the launch geometry's Python mirror (``block_spmv.layout``): at the
  widths of configs 4 and 5 and of elasticity at p=3, 4, 5 and 4/5, in
  f32 and f64, aligned or not, with many and few block rows, every
  (block row, matrix row) is summed by exactly one lane group
  (``block_spmv.coverage``), and the mapping takes the narrow kernel,
  or splits a block row, where it should;
* the numpy emulation of the kernel's summation order
  (``block_spmv.emulate``) against ``plain_matvec`` in f64 (1e-13 of
  max|y|), later buckets adding into y; and narrow groups (1-4 lanes)
  giving the same f32 bits as groups of 8 or 16 lanes.

On a card (``cuda`` marker; skipped here), in this file's other half,
which imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_block_spmv.py

K2 against its plain version at block sizes 81, 24, 125, 375, 8 and on
rectangular buckets, with empty rows, rows of more blocks than one
shared-memory chunk holds and values that are not 16-byte aligned (f32
within 1e-5 of max|y|: sums in another order; f64 within 1e-12);
repeated launches bitwise equal; a CUDA-graph capture and replay of
``matvec`` bitwise equal to eager; the refusals on the card; blocks
wider than one lane group's loads (729 and 1029, and 648 not 16-byte
aligned: K2's column tiles); the card's ``matvec`` of 3D elasticity at
p=3, 4, 5 and mixed 4/5 against ``plain_matvec``, K2 launched once per
bucket.  Then the redesigned mapping: K2's f32 output bitwise equal to
``block_spmv.emulate`` at widths 4 to 1029 and 375 x 648, 16-byte
aligned or not, with and without ``accumulate``; the launch geometry the
built kernel reports equal to the Python mirror; narrow and split
buckets captured in a CUDA graph and replayed, equal to eager.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.assemble import (assemble_elasticity, assemble_laplace,
                                     build_plan)
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.linalg import blockmatrix as bm
from hpdg_tpu_torch.ops import block_spmv
from hpdg_tpu_torch.solvers.multigrid import setup_hierarchy

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tests run in several worker processes on one machine: one
    # thread each for torch and numpy's BLAS keeps them from
    # oversubscribing its cores (the card's machine may lack
    # threadpoolctl; its card tests need no limit)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = lambda n: contextlib.nullcontext()  # noqa: E731
    with threadpool_limits(1):
        yield


@functools.lru_cache(maxsize=1)
def config4_hierarchy(n_el=4):
    """Config 4's assembled hierarchy at n_el^3 p=2: fine (plan,
    diagonal first), Galerkin p-coarse p=1, Galerkin h-coarse p=1."""
    mc = tmesh.structured((n_el // 2,) * 3)
    mf = tmesh.refine(mc)
    basis = DGBasis(mf, np.full(mf.n_elements, 2, dtype=np.int32))
    A = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                            dirichlet=True, plan=build_plan(basis),
                            device=CPU)
    return setup_hierarchy(basis, A, meshes=[mc, mf]).matrices


def hp_matrix():
    """A mixed-degree (p = 1, 2, 3) SIPG Laplace matrix: rectangular
    buckets (pr != pc)."""
    m = tmesh.structured((3, 2, 2))
    deg = np.random.default_rng(7).integers(1, 4, size=m.n_elements)
    return assemble_laplace(DGBasis(m, deg), penalty=3.0, dirichlet=True,
                            penalty_scaling="normal", device=CPU)


def random_matrix(row_sizes, col_sizes, blocks, ncomp=1, dim=3, seed=0,
                  dtype=torch.float64, device=CPU, empty_rows=(),
                  dense_rows=(), offset=0):
    """A random block matrix on buckets ``row_sizes``/``col_sizes``
    ({p: n}) with about ``blocks`` blocks per row in every (pr, pc)
    bucket, slots in random order; the rows ``empty_rows`` hold no
    block, the rows ``dense_rows`` one in every column.  ``offset``
    shifts the values' storage by that many elements (offset 1: f32
    values that are not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    entries, values = {}, {}
    for pr, nr in row_sizes.items():
        for pc, nc in col_sizes.items():
            rows, cols = [], []
            for r in range(nr):
                if r in empty_rows:
                    continue
                k = nc if r in dense_rows else min(nc, blocks)
                c = rng.choice(nc, size=k, replace=False)
                rows += [r] * k
                cols += list(c)
            perm = rng.permutation(len(rows))
            entries[(pr, pc)] = (np.asarray(rows, np.int32)[perm],
                                 np.asarray(cols, np.int32)[perm])
            br, bc = ncomp * (pr + 1) ** dim, ncomp * (pc + 1) ** dim
            v = rng.standard_normal((len(rows), br, bc))
            buf = torch.empty(v.size + offset, dtype=dtype, device=device)
            values[(pr, pc)] = buf[offset:].view(v.shape)
            values[(pr, pc)].copy_(torch.as_tensor(v))
    pat = bm.BlockPattern(row_sizes, col_sizes, entries, diag_first=False)
    return bm.BlockSparseMatrix(pat, dim, values, (ncomp, ncomp))


def rand_x(A, seed, dtype=torch.float64, device=CPU):
    rng = np.random.default_rng(seed)
    return {p: torch.as_tensor(rng.standard_normal((n, A.bc(p))),
                               dtype=dtype, device=device)
            for p, n in A.pattern.col_sizes.items()}


def check_table(A):
    for key, (rows, cols) in A.pattern.entries.items():
        t = A.spmv_table(key, torch.device(CPU))
        row_ptr, slot, col = (t[k].numpy() for k in ("row_ptr", "slot",
                                                     "col"))
        assert row_ptr.dtype == slot.dtype == col.dtype == np.int32
        n = A.pattern.row_sizes[key[0]]
        assert row_ptr.shape == (n + 1,) and row_ptr[0] == 0
        assert row_ptr[-1] == len(rows) and (np.diff(row_ptr) >= 0).all()
        np.testing.assert_array_equal(np.sort(slot), np.arange(len(rows)))
        np.testing.assert_array_equal(col, cols[slot])
        for r in range(n):
            s = slot[row_ptr[r]:row_ptr[r + 1]]
            assert (rows[s] == r).all() and (np.diff(s) > 0).all()
        assert t["max_row_nnz"] == int(np.diff(row_ptr).max(initial=0))


def replay(A, x: dict) -> dict:
    """The kernel's traversal in numpy f64: per bucket, each block row's
    blocks by ``slot`` through ``row_ptr``, summed from zero; the first
    bucket of a row bucket writes y, later ones add to it."""
    out = {}
    for key in A.pattern.entries:
        pr, pc = key
        t = A.spmv_table(key, torch.device(CPU))
        row_ptr, slot, col = (t[k].numpy() for k in ("row_ptr", "slot",
                                                     "col"))
        vals = A.values[key].numpy()
        xp = x[pc].numpy()
        y = np.empty((len(row_ptr) - 1, vals.shape[1]))
        for r in range(len(row_ptr) - 1):
            acc = np.zeros(vals.shape[1])
            for k in range(row_ptr[r], row_ptr[r + 1]):
                acc += vals[slot[k]] @ xp[col[k]]
            y[r] = acc
        out[pr] = out[pr] + y if pr in out else y
    return out


def assert_close(want: dict, got: dict, tol: float):
    assert want.keys() == got.keys()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in want:
        d = np.abs(np.asarray(want[k]) - np.asarray(got[k])).max()
        assert d <= tol * scale, (k, d / scale)


MATRICES = {
    "config4_fine_p2": lambda: config4_hierarchy()[2],
    "config4_p_coarse_p1": lambda: config4_hierarchy()[1],
    "config4_h_coarse_p1": lambda: config4_hierarchy()[0],
    "hp_mixed_rectangular": hp_matrix,
    "empty_rows": lambda: random_matrix({1: 9, 2: 4}, {1: 5, 2: 6}, 3,
                                        empty_rows=(0, 3, 8)),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_row_table(name):
    A = MATRICES[name]()
    if name.startswith("config4"):
        assert A.block_shape == (3, 3)
    if name == "config4_fine_p2":
        assert A.pattern.diag_first and A.br(2) == 81
    if name == "hp_mixed_rectangular":
        assert any(pr != pc for pr, pc in A.pattern.entries)
    if name == "empty_rows":
        assert (np.diff(A.spmv_table((1, 1), torch.device(CPU))["row_ptr"]
                        .numpy())[[0, 3, 8]] == 0).all()
    check_table(A)


@pytest.mark.parametrize("name", list(MATRICES))
def test_traversal_replay_matches_plain_matvec(name):
    A = MATRICES[name]()
    x = rand_x(A, 3)
    want = {k: v.numpy() for k, v in bm.matvec(A, x).items()}
    assert_close(want, replay(A, x), 1e-13)


def test_plain_matvec_matches_reference():
    import jax
    import jax.numpy as jnp
    from hpdg_tpu.linalg import blockmatrix as rbm

    A = hp_matrix()
    pat = A.pattern
    RA = rbm.BlockSparseMatrix(
        rbm.BlockPattern(pat.row_sizes, pat.col_sizes, pat.entries),
        A.dim, {k: jnp.asarray(v.numpy()) for k, v in A.values.items()})
    x = rand_x(A, 4)
    want = jax.jit(lambda v: rbm.matvec(RA, v))(
        {p: jnp.asarray(v.numpy()) for p, v in x.items()})
    assert_close(want, {k: v.numpy() for k, v in bm.matvec(A, x).items()},
                 1e-12)


def test_cpu_tensors_take_the_plain_version():
    A = random_matrix({2: 5}, {2: 5}, 3, dtype=torch.float32)
    x = rand_x(A, 1, dtype=torch.float32)
    n0, c0 = block_spmv.launches, block_spmv.captured
    y = bm.matvec(A, x)
    torch.testing.assert_close(y[2], bm.plain_matvec(A, x)[2], rtol=0,
                               atol=0)
    assert (block_spmv.launches, block_spmv.captured) == (n0, c0)
    assert block_spmv._lib is None  # nothing was built


def test_wrapper_refuses_what_the_kernel_does_not_take():
    A = random_matrix({1: 3}, {1: 3}, 2)
    t = A.spmv_table((1, 1), torch.device(CPU))
    with pytest.raises(ValueError, match="CUDA"):
        block_spmv.launch(A.values[(1, 1)], rand_x(A, 0)[1], t)
    with pytest.raises(TypeError, match="float16"):
        block_spmv.check(torch.float16, 81, 81)
    with pytest.raises(ValueError, match="6144"):
        block_spmv.check(torch.float32, 6145, 81)
    with pytest.raises(ValueError, match="6144"):
        block_spmv.check(torch.float64, 24, 0)
    block_spmv.check(torch.float64, 6144, 6144)


@functools.lru_cache(maxsize=None)
def elasticity_matrix(degrees: tuple):
    """3D elasticity on a 2^3 mesh with the elements' degrees
    ``degrees`` (blocks of 3 (p+1)^3: 192 at p=3, 375 at p=4, 648 at
    p=5), f64 on the CPU."""
    m = tmesh.structured((2, 2, 2))
    basis = DGBasis(m, np.asarray(degrees, dtype=np.int32))
    return assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                               dirichlet=True, device=CPU)


# 3D elasticity on 2^3 elements: the degrees, and the block widths of
# each bucket
ELASTICITY = {
    "p3": ((3,) * 8, {(3, 3): (192, 192)}),
    "p4": ((4,) * 8, {(4, 4): (375, 375)}),
    "p5": ((5,) * 8, {(5, 5): (648, 648)}),
    "p4_p5": ((5, 4, 4, 5, 4, 5, 5, 4),
              {(4, 4): (375, 375), (4, 5): (375, 648), (5, 4): (648, 375),
               (5, 5): (648, 648)}),
}


@pytest.mark.parametrize("case", list(ELASTICITY))
def test_k2_takes_every_elasticity_width(case):
    """K2 takes every bucket of 3D elasticity up to p=5 (blocks of 192,
    375 and 648, the widest rectangular) in f32 and f64, and the plain
    product on these buckets equals the kernel's traversal replayed in
    numpy."""
    degrees, widths = ELASTICITY[case]
    A = elasticity_matrix(degrees)
    assert {k: tuple(v.shape[1:]) for k, v in A.values.items()} == widths
    for br, bc in widths.values():
        for dtype in block_spmv.DTYPES:
            block_spmv.check(dtype, br, bc)
    check_table(A)
    x = rand_x(A, 12)
    want = {k: v.numpy() for k, v in bm.matvec(A, x).items()}
    assert_close(want, replay(A, x), 1e-13)


# (dtype, br, bc, aligned, n_rows): the buckets of configs 4 and 5 and of
# elasticity, with many block rows (the main path's levels have more) and
# with fewer than two thread blocks per SM
GEOMETRY = {
    "config5_p1_4x4": (torch.float32, 4, 4, True, 1216),
    "config5_p1_4x4_unaligned": (torch.float32, 4, 4, False, 300),
    "config5_p3_16x16": (torch.float32, 16, 16, True, 700),
    "config5_p3_16x16_unaligned": (torch.float32, 16, 16, False, 300),
    "config5_A64_16x16": (torch.float64, 16, 16, True, 300),
    "poisson3d_p1_8x8_f64": (torch.float64, 8, 8, False, 100),
    "config4_p2_81x81": (torch.float32, 81, 81, True, 300),
    "config4_p2_81x81_few": (torch.float32, 81, 81, True, 5),
    "config4_p1_24x24": (torch.float32, 24, 24, True, 300),
    "config4_A64_81x81": (torch.float64, 81, 81, True, 40),
    "elasticity_p3_192": (torch.float32, 192, 192, True, 8),
    "elasticity_p4_375": (torch.float32, 375, 375, True, 64),
    "elasticity_p4_375_f64": (torch.float64, 375, 375, False, 4),
    "elasticity_p5_648": (torch.float32, 648, 648, True, 4),
    "elasticity_p5_648_unaligned": (torch.float32, 648, 648, False, 4),
    "elasticity_p4_p5_375x648": (torch.float32, 375, 648, True, 4),
    "elasticity_p4_p5_648x375": (torch.float64, 648, 375, False, 4),
}


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_launch_geometry_sums_every_row_once(case):
    dtype, br, bc, aligned, n_rows = GEOMETRY[case]
    L = block_spmv.layout(dtype, br, bc, aligned, n_rows, 7, 132)
    count = block_spmv.coverage(L, n_rows, br)
    assert count.shape == (n_rows, br) and (count == 1).all()
    narrow = bc * (4 if dtype == torch.float32 else 8) <= 64
    assert L["narrow"] == narrow
    if narrow:
        assert L["gw"] <= 16 and L["grid"] * L["threads"] >= n_rows * br
    elif L["rows_per_cta"] == 1 and n_rows < 2 * 132:
        assert L["slices"] > 1 and L["grid"] >= min(
            2 * 132, n_rows * L["passes"])
    else:
        assert L["slices"] == 1


def test_launch_geometry_at_the_main_paths_levels():
    """Config 5's levels take the narrow kernel, one lane a 4-wide row and
    four a 16-wide one; config 4's levels keep the wide kernel's mapping,
    unsplit; 2^3 elasticity at p=5 is split over thread blocks."""
    f32, f64 = torch.float32, torch.float64
    for n_rows in (16384, 4096, 1024, 256):
        L = block_spmv.layout(f32, 4, 4, True, n_rows, 5, 132)
        assert (L["narrow"], L["gw"]) == (1, 1)
        assert L["grid"] == n_rows * 4 // 128 or n_rows * 4 < 128
    L = block_spmv.layout(f32, 16, 16, True, 16384, 5, 132)
    assert (L["narrow"], L["gw"], L["grid"]) == (1, 4, 16384 * 16 * 4 // 128)
    L = block_spmv.layout(f64, 16, 16, True, 16384, 5, 132)
    assert (L["narrow"], L["shape"], L["rows_per_cta"]) == (0, 0, 8)
    for dtype, br, n_rows in ((f32, 81, 13824), (f32, 24, 13824),
                              (f32, 24, 1728), (f64, 81, 13824)):
        L = block_spmv.layout(dtype, br, br, True, n_rows, 7, 132)
        assert (L["narrow"], L["slices"], L["grid"]) == (0, 1, n_rows)
    L = block_spmv.layout(f32, 648, 648, True, 4, 4, 132)
    assert L["slices"] * 4 >= 132 and L["grid"] == 4 * L["slices"]


# (row sizes, col sizes, blocks per row, ncomp, dim, offset): blocks of
# ncomp (p+1)^dim; offset 1: values not 16-byte aligned
EMULATED = {
    "bs4_poisson2d_p1": ({1: 60}, {1: 60}, 5, 1, 2, 0),
    "bs4_unaligned": ({1: 60}, {1: 60}, 5, 1, 2, 1),
    "bs16_poisson2d_p3": ({3: 40}, {3: 40}, 5, 1, 2, 0),
    "bs16_unaligned": ({3: 40}, {3: 40}, 5, 1, 2, 1),
    "bs8_poisson3d_p1": ({1: 50}, {1: 50}, 7, 1, 3, 0),
    "rectangular_4_16_accumulate": ({1: 30, 3: 20}, {1: 25, 3: 31}, 4, 1, 2,
                                    0),
    "rectangular_24_81_accumulate": ({1: 20, 2: 15}, {1: 17, 2: 22}, 4, 3,
                                     3, 1),
    "bs648_elasticity_p5": ({5: 4}, {5: 4}, 3, 3, 3, 0),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_summation_order_matches_plain_matvec(case):
    """``block_spmv.emulate``'s f64 sums (the kernel's order before its
    rounding to f32) against the plain product in f64 on the same f32
    values, 1e-13 of max|y|; its f32 output is those sums rounded."""
    rs, cs, blocks, ncomp, dim, offset = EMULATED[case]
    A = random_matrix(rs, cs, blocks, ncomp, dim, seed=len(case),
                      dtype=torch.float32, offset=offset)
    x = rand_x(A, 5, dtype=torch.float32)
    A64 = bm.BlockSparseMatrix(
        A.pattern, A.dim, {k: v.double() for k, v in A.values.items()},
        A.block_shape)
    want = {k: v.numpy() for k, v in bm.plain_matvec(
        A64, {p: v.double() for p, v in x.items()}).items()}
    sums = block_spmv.emulate_matvec(A, x, rounded=False)
    assert_close(want, sums, 1e-13)
    got = block_spmv.emulate_matvec(A, x)
    assert all(got[p].dtype == np.float32 for p in got)
    if len(A.pattern.entries) == len(A.pattern.row_sizes):
        for p in got:  # one bucket per row bucket: one rounding
            np.testing.assert_array_equal(got[p], sums[p].astype(np.float32))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("width", [4, 8, 12, 16])
def test_narrow_groups_give_the_bits_of_eight_lane_groups(width, aligned):
    """A narrow row's group of 1-16 lanes sums in the order of the wide
    kernel's group of at least 8 (16 for 9-16 single loads): the lanes it
    drops add zeros, so the f32 output keeps its bits."""
    rng = np.random.default_rng(width)
    n_rows, nnz = 40, 160
    rows = np.sort(rng.integers(0, n_rows, nnz))
    row_ptr, slot = block_spmv.row_table(rows, n_rows)
    vals = rng.standard_normal((nnz, 5, width)).astype(np.float32)
    x = rng.standard_normal((30, width)).astype(np.float32)
    col = rng.integers(0, 30, nnz).astype(np.int32)
    y0 = rng.standard_normal((n_rows, 5)).astype(np.float32)
    W, gw, cpl, _ = block_spmv.lanes(torch.float32, width, aligned)
    units = width // W
    wide_gw = 8 if units <= 8 else 16
    assert gw <= wide_gw
    for y in (None, y0):
        narrow = block_spmv.emulate(vals, x, row_ptr, slot, col, aligned, y)
        wide = block_spmv.emulate(vals, x, row_ptr, slot, col, aligned, y,
                                  gw=wide_gw)
        np.testing.assert_array_equal(narrow.view(np.int32),
                                      wide.view(np.int32))


def test_row_table_refuses_rows_outside_the_bucket():
    with pytest.raises(ValueError, match="outside"):
        block_spmv.row_table(np.array([0, 4]), 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def card_pair(A, x, dev):
    """(K2's y, the plain version's y) of A x on the card."""
    Ad = bm.BlockSparseMatrix(A.pattern, A.dim,
                              {k: v.to(dev) for k, v in A.values.items()},
                              A.block_shape)
    xd = {p: v.to(dev) for p, v in x.items()}
    yk = bm.matvec(Ad, xd)
    yp = bm.plain_matvec(Ad, xd)
    torch.cuda.synchronize()
    return yk, yp, Ad, xd


# (row sizes, col sizes, blocks per row, ncomp, dim): block sizes ncomp
# (p+1)^dim
CARD_CASES = {
    "bs81_elasticity_p2": ({2: 301}, {2: 301}, 7, 3, 3),
    "bs24_elasticity_p1": ({1: 301}, {1: 301}, 7, 3, 3),
    "bs125_poisson_p4": ({4: 97}, {4: 97}, 7, 1, 3),
    "bs375_elasticity_p4": ({4: 23}, {4: 23}, 5, 3, 3),
    "bs8_poisson_p1": ({1: 1001}, {1: 1001}, 7, 1, 3),
    "rectangular_27_64": ({2: 40, 3: 33}, {2: 35, 3: 41}, 4, 1, 3),
    "rectangular_24_81": ({1: 50, 2: 45}, {1: 47, 2: 52}, 4, 3, 3),
    "bs648_elasticity_p5": ({5: 12}, {5: 12}, 4, 3, 3),
    # wider than one lane group's loads: K2's column tiles
    "bs729_poisson_p8": ({8: 10}, {8: 10}, 4, 1, 3),
    "bs1029_elasticity_p6": ({6: 8}, {6: 8}, 3, 3, 3),
    "rectangular_375_1029": ({4: 9, 6: 7}, {4: 8, 6: 7}, 3, 3, 3),
    # rows of at most 64 bytes: K2's narrow kernel
    "bs4_poisson2d_p1": ({1: 1001}, {1: 1001}, 5, 1, 2),
    "bs16_poisson2d_p3": ({3: 301}, {3: 301}, 5, 1, 2),
    # fewer block rows than SMs: wide block rows split over thread blocks
    "bs648_elasticity_p5_6_rows": ({5: 6}, {5: 6}, 4, 3, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_k2_matches_plain(dev, case, dtype):
    rs, cs, blocks, ncomp, dim = CARD_CASES[case]
    A = random_matrix(rs, cs, blocks, ncomp, dim, seed=len(case),
                      dtype=dtype, empty_rows=(0, 5), dense_rows=(2,))
    x = rand_x(A, 2, dtype=dtype)
    n0 = block_spmv.launches
    yk, yp, _, _ = card_pair(A, x, dev)
    assert block_spmv.launches - n0 == len(A.pattern.entries)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert_close({k: v.cpu().numpy() for k, v in yp.items()},
                 {k: v.cpu().numpy() for k, v in yk.items()}, tol)
    for k in yk:  # the empty rows of every bucket
        assert torch.equal(yk[k][[0, 5]], torch.zeros_like(yk[k][[0, 5]]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_takes_values_that_are_not_16_byte_aligned(dev, dtype):
    A = random_matrix({1: 200}, {1: 200}, 7, 3, 3, seed=3, dtype=dtype,
                      device=dev, offset=1)
    assert A.values[(1, 1)].data_ptr() % 16
    x = rand_x(A, 5, dtype=dtype, device=dev)
    yk = bm.matvec(A, x)[1]
    yp = bm.plain_matvec(A, x)[1]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_tiles_wide_blocks_that_are_not_16_byte_aligned(dev, dtype):
    # 648 wide without 16-byte loads: 648 loads a row, two column tiles
    A = random_matrix({5: 10}, {5: 10}, 4, 3, 3, seed=4, dtype=dtype,
                      device=dev, offset=1)
    assert A.values[(5, 5)].data_ptr() % 16
    x = rand_x(A, 5, dtype=dtype, device=dev)
    yk = bm.matvec(A, x)[5]
    yp = bm.plain_matvec(A, x)[5]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())
    assert torch.equal(bm.matvec(A, x)[5], yk)


@pytest.mark.cuda
def test_k2_repeated_launches_are_bitwise_equal(dev):
    A = random_matrix({2: 301}, {2: 301}, 7, 3, 3, seed=8,
                      dtype=torch.float32, device=dev)
    x = rand_x(A, 6, dtype=torch.float32, device=dev)
    first = bm.matvec(A, x)[2]
    for _ in range(5):
        assert torch.equal(bm.matvec(A, x)[2], first)


@pytest.mark.cuda
def test_k2_under_graph_capture_equals_eager(dev):
    A = random_matrix({1: 60, 2: 50}, {1: 60, 2: 50}, 5, 3, 3, seed=9,
                      dtype=torch.float32, device=dev)
    x = rand_x(A, 7, dtype=torch.float32, device=dev)
    eager = bm.matvec(A, x)  # builds the tables outside the capture
    static_x = {p: v.clone() for p, v in x.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        bm.matvec(A, static_x)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    c0 = block_spmv.captured
    with torch.cuda.graph(graph):
        out = bm.matvec(A, static_x)
    assert block_spmv.captured - c0 == len(A.pattern.entries)
    n0 = block_spmv.launches
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert block_spmv.launches == n0  # replays call no wrapper
    for p in eager:
        assert torch.equal(out[p], eager[p])
    # new input through the static buffer
    x2 = rand_x(A, 8, dtype=torch.float32, device=dev)
    for p in x2:
        static_x[p].copy_(x2[p])
    graph.replay()
    want = bm.matvec(A, x2)
    torch.cuda.synchronize()
    for p in want:
        assert torch.equal(out[p], want[p])


@pytest.mark.cuda
def test_k2_refuses_on_the_card(dev):
    A = random_matrix({1: 4}, {1: 4}, 2, 3, 3, dtype=torch.float32,
                      device=dev)
    x = rand_x(A, 0, dtype=torch.float32, device=dev)
    A16 = bm.BlockSparseMatrix(A.pattern, A.dim,
                               {k: v.half() for k, v in A.values.items()},
                               A.block_shape)
    with pytest.raises(TypeError, match="float16"):
        bm.matvec(A16, {p: v.half() for p, v in x.items()})
    # one block of 6145 x 1: wider than one f64 x block in shared memory
    i32 = dict(dtype=torch.int32, device=dev)
    table = dict(row_ptr=torch.tensor([0, 1], **i32),
                 slot=torch.zeros(1, **i32), col=torch.zeros(1, **i32),
                 max_row_nnz=1)
    with pytest.raises(ValueError, match="6144"):
        block_spmv.launch(torch.zeros((1, 6145, 1), device=dev),
                          torch.zeros((1, 1), device=dev), table)
    with pytest.raises(ValueError, match="dtype"):
        bm.matvec(A, {p: v.double() for p, v in x.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(ELASTICITY))
def test_matvec_on_card_matches_plain_elasticity(dev, case, dtype):
    """The card's ``matvec`` of 3D elasticity at p = 3, 4, 5 and mixed
    4/5 (blocks of 192, 375 and 648) against ``plain_matvec``: K2 launches
    once per bucket (f32 within 1e-5 of max|y|, f64 within 1e-12)."""
    degrees, _ = ELASTICITY[case]
    A = elasticity_matrix(degrees)
    A = bm.BlockSparseMatrix(A.pattern, A.dim,
                             {k: v.to(dtype) for k, v in A.values.items()},
                             A.block_shape)
    x = rand_x(A, 11, dtype=dtype)
    n0 = block_spmv.launches
    yk, yp, _, _ = card_pair(A, x, dev)
    assert block_spmv.launches - n0 == len(A.pattern.entries)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert_close({k: v.cpu().numpy() for k, v in yp.items()},
                  {k: v.cpu().numpy() for k, v in yk.items()}, tol)


# width -> (row sizes, col sizes, blocks per row, ncomp, dim): one bucket
# of blocks width x width (375 x 648: rectangular); the narrow kernel up
# to 16, the wide one above, split over thread blocks below 264 block rows
BITWISE = {
    "4": ({1: 1001}, {1: 1001}, 5, 1, 2),
    "8": ({1: 500}, {1: 500}, 7, 1, 3),
    "16": ({3: 700}, {3: 700}, 5, 1, 2),
    "24": ({1: 301}, {1: 301}, 7, 3, 3),
    "81": ({2: 301}, {2: 301}, 7, 3, 3),
    "125": ({4: 97}, {4: 97}, 7, 1, 3),
    "192": ({3: 40}, {3: 40}, 5, 3, 3),
    "375": ({4: 23}, {4: 23}, 5, 3, 3),
    "648": ({5: 12}, {5: 12}, 4, 3, 3),
    "729": ({8: 10}, {8: 10}, 4, 1, 3),
    "1029": ({6: 8}, {6: 8}, 3, 3, 3),
    "375x648": ({4: 9}, {5: 8}, 3, 3, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("width", list(BITWISE))
def test_k2_f32_is_bitwise_the_emulated_order(dev, width, offset):
    """K2's f32 output equals ``block_spmv.emulate`` bit for bit (f64 sums
    of exact products in the kernel's lane, block and shuffle order),
    writing y and adding into a given y (``accumulate``)."""
    rs, cs, blocks, ncomp, dim = BITWISE[width]
    A = random_matrix(rs, cs, blocks, ncomp, dim, seed=len(width) + offset,
                      dtype=torch.float32, device=dev, empty_rows=(1,),
                      offset=offset)
    assert (A.values[next(iter(A.values))].data_ptr() % 16 != 0) == offset
    x = rand_x(A, 9, dtype=torch.float32, device=dev)
    ((pr, pc), vals), = A.values.items()
    table = A.spmv_table((pr, pc), dev)
    y = block_spmv.launch(vals, x[pc], table)
    y0 = torch.as_tensor(np.random.default_rng(3).standard_normal(
        tuple(y.shape)), dtype=torch.float32, device=dev)
    y_acc = block_spmv.launch(vals, x[pc], table, y0.clone())
    torch.cuda.synchronize()
    t = A.spmv_table((pr, pc), torch.device(CPU))
    args = (vals.cpu().numpy(), x[pc].cpu().numpy(), t["row_ptr"].numpy(),
            t["slot"].numpy(), t["col"].numpy(), offset == 0)
    want = block_spmv.emulate(*args)
    want_acc = block_spmv.emulate(*args, y=y0.cpu().numpy())
    np.testing.assert_array_equal(y.cpu().numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(y_acc.cpu().numpy().view(np.int32),
                                  want_acc.view(np.int32))


@pytest.mark.cuda
def test_k2_reports_the_mirrored_geometry(dev):
    """The geometry the built kernel launches (``hpdg_block_spmv_layout``)
    is ``block_spmv.layout``'s, field by field, at every case of the CPU
    geometry test and at the main path's level sizes."""
    sms = block_spmv.sm_count(dev)
    cases = list(GEOMETRY.values()) + [
        (torch.float32, 4, 4, True, 16384), (torch.float32, 16, 16, True,
                                             16384),
        (torch.float32, 81, 81, False, 13824), (torch.float32, 24, 24, True,
                                                1728),
        (torch.float64, 81, 81, False, 13824)]
    for dtype, br, bc, aligned, n_rows in cases:
        for nnz in (1, 7, 40):
            want = block_spmv.layout(dtype, br, bc, aligned, n_rows, nnz, sms)
            got = block_spmv.card_layout(dtype, br, bc, aligned, n_rows, nnz,
                                         sms)
            assert got == want, (dtype, br, bc, aligned, n_rows, nnz)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow_4_16", "split_375_648"])
def test_k2_narrow_and_split_under_graph_capture_equal_eager(dev, case):
    """The narrow kernel (4 x 4 and 16 x 16 buckets, one adding into the
    other's y) and the split wide kernel (4 block rows of 375 and 648)
    captured in a CUDA graph: each replay equals the eager apply bit for
    bit, also on new input through the static buffer."""
    if case == "narrow_4_16":
        A = random_matrix({1: 300, 3: 200}, {1: 250, 3: 310}, 5, 1, 2,
                          seed=11, dtype=torch.float32, device=dev)
    else:
        A = random_matrix({4: 4, 5: 4}, {4: 4, 5: 4}, 3, 3, 3, seed=12,
                          dtype=torch.float32, device=dev)
    x = rand_x(A, 7, dtype=torch.float32, device=dev)
    eager = bm.matvec(A, x)
    static_x = {p: v.clone() for p, v in x.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        bm.matvec(A, static_x)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    c0 = block_spmv.captured
    with torch.cuda.graph(graph):
        out = bm.matvec(A, static_x)
    assert block_spmv.captured - c0 == len(A.pattern.entries)
    graph.replay()
    torch.cuda.synchronize()
    for p in eager:
        assert torch.equal(out[p], eager[p])
    x2 = rand_x(A, 8, dtype=torch.float32, device=dev)
    for p in x2:
        static_x[p].copy_(x2[p])
    graph.replay()
    want = bm.matvec(A, x2)
    torch.cuda.synchronize()
    for p in want:
        assert torch.equal(out[p], want[p])
