"""Port vs reference: the deduplicated block-sparse SpMV.

* unique_rows group ids bitwise (both run the same host numpy hash and
  verification), and the coefficient tables of
  assemble_laplace(coef_parts=True) bitwise;
* the collision fallback forced by patching the hash weights: the port
  numbers groups by first occurrence, the reference lexicographically
  (its fault R5) — the two are compared as partitions;
* dedup_spmv_from_plan / dedup_spmv_operator in f64 at 1e-12 of max|y|
  against the reference's and against the port's sipg_operator (sums
  in another order: a few hundred ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu.assemble import assemble_laplace as r_assemble
from hpdg_tpu.matrixfree import dedup as rdedup

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import matrixfree as tmf
from hpdg_tpu_torch.assemble import assemble_laplace as t_assemble
from hpdg_tpu_torch.matrixfree import dedup as tdedup

from test_torch_sumfact import assert_close, hanging_pair, random_x

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


class _ZeroWeights:
    """A stand-in for ``np.random.default_rng`` whose integers are all
    zero: both hashes then weigh every u64 word by 1, so rows that hold
    the same words in another order collide."""

    def __init__(self, seed=None):
        pass

    def integers(self, lo, hi, size, dtype):
        return np.zeros(size, dtype)


def same_partition(a, b):
    """True iff the labellings a and b group the rows identically."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_coef_tables_and_unique_rows_bitwise(case):
    rb, tb = hanging_pair(case)
    kw = dict(penalty=2.0, dirichlet=True, penalty_scaling="normal",
              coef_parts=True)
    rparts = r_assemble(rb, **kw)
    tparts = t_assemble(tb, **kw, device=CPU)
    assert rparts.keys() == tparts.keys()
    for key in rparts:
        (rc, rD), (tc, tD) = rparts[key], tparts[key]
        np.testing.assert_array_equal(rc, tc)
        np.testing.assert_array_equal(rD, tD)
        if rD.shape[0]:
            ruid, rreps = rdedup.unique_rows(np.ascontiguousarray(rc))
            tuid, treps = tdedup.unique_rows(np.ascontiguousarray(tc))
            np.testing.assert_array_equal(ruid, tuid)
            np.testing.assert_array_equal(rreps, treps)


def test_unique_rows_collision_fallback_first_occurrence(monkeypatch):
    """R5: on the collision path the reference orders groups
    lexicographically; the port keeps first-occurrence order."""
    rows = np.array([[2, 1], [1, 2], [2, 1], [3, 0], [1, 2]], np.uint64)
    monkeypatch.setattr(np.random, "default_rng", _ZeroWeights)
    tuid, treps = tdedup.unique_rows(rows)
    ruid, rreps = rdedup.unique_rows(rows)
    np.testing.assert_array_equal(tuid, [0, 1, 0, 2, 1])
    np.testing.assert_array_equal(treps, [0, 1, 3])
    # the reference's lexicographic ids: [1, 2] < [2, 1] < [3, 0]
    np.testing.assert_array_equal(ruid, [1, 0, 1, 2, 0])
    assert same_partition(tuid, ruid)


def test_unique_rows_collision_fallback_matches_hash_path(monkeypatch):
    """Forced onto the fallback, the port returns exactly what its hash
    path returns (ids by first occurrence), and the same partition as
    the reference."""
    rng = np.random.default_rng(7)
    flat = rng.integers(0, 3, size=(200, 3)).astype(np.float64)
    want_uid, want_reps = tdedup.unique_rows(flat)
    monkeypatch.setattr(np.random, "default_rng", _ZeroWeights)
    uid, reps = tdedup.unique_rows(flat)
    ruid, _ = rdedup.unique_rows(flat)
    np.testing.assert_array_equal(uid, want_uid)
    np.testing.assert_array_equal(reps, want_reps)
    assert same_partition(uid, ruid)
    # first occurrence: group g first appears after groups 0..g-1
    assert (np.diff(np.unique(uid, return_index=True)[1]) > 0).all()


@pytest.mark.parametrize("case", ["2d", "3d"])
@pytest.mark.parametrize("dirichlet,scaling,dg_form,sigma1", [
    (True, "normal", "sipg", 0.0), (False, "measure", "nipg", 0.5)])
def test_dedup_from_plan_matches_reference_and_sumfact(case, dirichlet,
                                                       scaling, dg_form,
                                                       sigma1):
    rb, tb = hanging_pair(case)
    kw = dict(penalty=2.0, dirichlet=dirichlet, penalty_scaling=scaling,
              dg_form=dg_form, sigma1=sigma1)
    x = random_x(rb, seed=3)
    rop, rst = rdedup.dedup_spmv_from_plan(rb, dtype=jnp.float64, **kw)
    top, tst = tdedup.dedup_spmv_from_plan(tb, dtype=torch.float64, **kw,
                                           device=CPU)
    assert rst["n_unique"] == tst["n_unique"]
    assert rst["dedup"] == tst["dedup"]
    assert rst["compression"] == tst["compression"]
    ty = top(convert.bucket_dict(x, device=CPU))
    assert_close(rop({p: jnp.asarray(v) for p, v in x.items()}), ty)
    sf = tmf.sipg_operator(tb, **kw, device=CPU)(
        convert.bucket_dict(x, device=CPU))
    assert_close({p: v.numpy() for p, v in sf.items()}, ty)


@pytest.mark.parametrize("frac", [0.25, 0.0])
def test_dedup_operator_from_matrix(frac):
    """dedup_spmv_operator on the reference's assembled matrix (carried
    across with convert); frac=0 forces the plain per-entry branch."""
    rb, tb = hanging_pair("3d")
    RA = r_assemble(rb, penalty=2.0, dirichlet=True, dtype=jnp.float64)
    TA = convert.block_sparse_matrix(
        RA.pattern.row_sizes, RA.pattern.col_sizes, RA.pattern.entries,
        {k: np.asarray(v) for k, v in RA.values.items()}, RA.dim, device=CPU)
    x = random_x(rb, seed=6)
    rop, rst = rdedup.dedup_spmv_operator(RA, dtype=jnp.float64,
                                          max_unique_frac=frac)
    top, tst = tdedup.dedup_spmv_operator(TA, dtype=torch.float64,
                                          max_unique_frac=frac, device=CPU)
    assert rst["n_unique"] == tst["n_unique"]
    assert rst["dedup"] == tst["dedup"]
    assert_close(rop({p: jnp.asarray(v) for p, v in x.items()}),
                 top(convert.bucket_dict(x, device=CPU)))


def test_dedup_blocks_and_size_classes():
    """dedup_blocks equals the reference's; the grouped layout covers
    every entry once, pads each unique block's entries at most 2x, and
    issues one gather and one bmm per size class."""
    rb, tb = hanging_pair("2d")
    RA = r_assemble(rb, penalty=2.0, dirichlet=True, dtype=jnp.float64)
    vals = {k: np.asarray(v) for k, v in RA.values.items()}
    rg = rdedup.dedup_blocks(RA.pattern, vals)
    TA = t_assemble(tb, penalty=2.0, dirichlet=True, device=CPU)
    tg = tdedup.dedup_blocks(TA.pattern, {k: v.numpy()
                                          for k, v in TA.values.items()})
    assert rg.keys() == tg.keys()
    for key in rg:
        for a, b in zip(rg[key][:3], tg[key][:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(rg[key][3], tg[key][3], rtol=0,
                                   atol=1e-12 * np.abs(rg[key][3]).max())
    op, st = tdedup.dedup_spmv_operator(TA, dtype=torch.float64,
                                        max_unique_frac=1.0, device=CPU)
    n_class = 0
    for key, item in op.prep.items():
        assert item[0] == "dedup"
        rows, _ = TA.pattern.entries[key]
        valid = 0
        for cidx, ridx, Wt in item[1]:
            g, m = cidx.shape
            n_class += 1
            counts = (ridx.reshape(g, m) >= 0).sum(1)
            assert (counts * 2 > m).all() or m == 1
            valid += int(counts.sum())
        assert valid == len(rows)
    assert st["launches"] == 2 * n_class + 3 * len(tb.bucket_degrees)
