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
  the kernel's wrapper refuses CPU tensors, f16 and blocks over 375.

On a card (``cuda`` marker; skipped here), in this file's other half,
which imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_block_spmv.py

K2 against its plain version at block sizes 81, 24, 125, 375, 8 and on
rectangular buckets, with empty rows, rows of more blocks than one
shared-memory chunk holds and values that are not 16-byte aligned (f32
within 1e-5 of max|y|: sums in another order; f64 within 1e-12);
repeated launches bitwise equal; a CUDA-graph capture and replay of
``matvec`` bitwise equal to eager; the refusals on the card.
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
    with pytest.raises(ValueError, match="375"):
        block_spmv.check(torch.float32, 376, 81)
    with pytest.raises(ValueError, match="375"):
        block_spmv.check(torch.float64, 24, 0)
    block_spmv.check(torch.float64, 375, 375)


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
    big = random_matrix({4: 2}, {4: 2}, 1, 4, 3, dtype=torch.float32,
                        device=dev)  # 4 * 125 = 500 > 375
    with pytest.raises(ValueError, match="375"):
        bm.matvec(big, rand_x(big, 0, dtype=torch.float32, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        bm.matvec(A, {p: v.double() for p, v in x.items()})
