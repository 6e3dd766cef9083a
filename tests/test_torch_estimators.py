"""Port vs reference: error norms, the smoothness indicator and Dörfler
marking.

* ``l2_error`` and ``h1_seminorm_error`` on 2D/3D box meshes with mixed
  degrees, uniform and after ``refine_local``: 1e-12 relative;
* ``smoothness_indicator``: 1e-9 relative (``log|c|`` of near-zero modal
  coefficients amplifies roundoff), the NaN-to-zero and zero patterns
  exactly, computed in f64 even for an f32 vector;
* ``quantile``, ``fraction`` and ``mark_fraction``: equal on seeded
  values, ties at the threshold included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu.estimators import error as rerr
from hpdg_tpu.estimators import smoothness as rsmooth
from hpdg_tpu.estimators import utility as rutil

from hpdg_tpu_torch import convert
from hpdg_tpu_torch.estimators import error as terr
from hpdg_tpu_torch.estimators import smoothness as tsmooth
from hpdg_tpu_torch.estimators import utility as tutil

from test_torch_norms import CASES, bases, coeffs

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


def u_exact(x, lib):
    s = lib.sin(np.pi * x[..., 0]) * lib.cos(0.5 * np.pi * x[..., 1])
    return s * (1.0 + x[..., -1]) if x.shape[-1] == 3 else s


def grad_exact(x, lib):
    a, b = np.pi * x[..., 0], 0.5 * np.pi * x[..., 1]
    g = [np.pi * lib.cos(a) * lib.cos(b),
         -0.5 * np.pi * lib.sin(a) * lib.sin(b)]
    if x.shape[-1] == 3:
        w = 1.0 + x[..., 2]
        g = [g[0] * w, g[1] * w, lib.sin(a) * lib.cos(b)]
    return lib.stack(g, -1)


@pytest.mark.parametrize("cells,refined,pmax", CASES)
@pytest.mark.parametrize("quad_inc", [3, 1])
def test_error_norms_match_reference(cells, refined, pmax, quad_inc):
    rb, tb = bases(cells, refined, pmax, seed=3 + pmax)
    x = coeffs(rb, 8)
    xr = {p: jnp.asarray(v) for p, v in x.items()}
    xt = convert.bucket_dict(x, device=CPU)
    for rfun, tfun, ex in ((rerr.l2_error, terr.l2_error, u_exact),
                           (rerr.h1_seminorm_error, terr.h1_seminorm_error,
                            grad_exact)):
        want = float(rfun(rb, xr, lambda q: ex(q, jnp), quad_inc=quad_inc))
        got = tfun(tb, xt, lambda q: ex(q, torch), quad_inc=quad_inc)
        assert got.dim() == 0 and got.dtype == torch.float64
        assert abs(float(got) - want) <= 1e-12 * want


@pytest.mark.parametrize("cells,refined,pmax", CASES)
def test_smoothness_indicator_matches_reference(cells, refined, pmax):
    rb, tb = bases(cells, refined, pmax, seed=11 + pmax)
    rng = np.random.default_rng(9)
    # decaying modal content, plus elements with zero coefficients (NaN
    # slope -> 0) and with an exactly zero mode (log 0 -> inf)
    x = {}
    for p in rb.bucket_degrees:
        v = rng.standard_normal((rb.bucket_size(p), rb.n_local(p)))
        v *= np.exp(-np.arange(rb.n_local(p)) / 3.0)[None, :]
        v[0] = 0.0
        x[p] = v
    want = rsmooth.smoothness_indicator(rb, {p: jnp.asarray(v)
                                             for p, v in x.items()})
    got = tsmooth.smoothness_indicator(tb, convert.bucket_dict(x, device=CPU))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want) & (want != 0.0)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)
    # an f32 vector: the projection and the fit still run in f64
    x32 = convert.bucket_dict(x, dtype=torch.float32, device=CPU)
    want32 = rsmooth.smoothness_indicator(
        rb, {p: jnp.asarray(v.double().numpy()) for p, v in x32.items()})
    got32 = tsmooth.smoothness_indicator(tb, x32)
    np.testing.assert_array_equal(got32 == 0.0, want32 == 0.0)
    fin = np.isfinite(want32) & (want32 != 0.0)
    np.testing.assert_allclose(got32[fin], want32[fin], rtol=1e-9)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 100), (3, 1000)])
@pytest.mark.parametrize("frac", [0.0, 0.4, 0.6, 1.0])
def test_marking_matches_reference(seed, n, frac):
    rng = np.random.default_rng(seed)
    err = rng.random(n) ** 3
    err[: n // 3] = np.round(err[: n // 3], 2)  # ties
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert tutil.quantile(err, q) == rutil.quantile(err, q)
    assert tutil.fraction(err, frac) == rutil.fraction(err, frac)
    got = tutil.mark_fraction(err, frac)
    np.testing.assert_array_equal(got, rutil.mark_fraction(err, frac))
    if frac > 0:  # the marked set carries at least frac of the total
        assert err[got].sum() >= frac * err.sum() - 1e-12


def test_fraction_of_zero_errors_marks_everything():
    z = np.zeros(5)
    assert tutil.fraction(z, 0.4) == rutil.fraction(z, 0.4) == 0.0
    assert tutil.mark_fraction(z, 0.4).all()
