"""Port vs reference: BASELINE config 3, the hp-adaptive L-shape.

* ``lshape`` bitwise; the ``c3_fro`` fingerprint of ``tests/golden.npz``
  (built with ``c3_degrees``) to 1e-12;
* ``api.local_norm``, ``api.global_error`` and ``api.interpolate``;
* two steps of ``examples.adaptive_lshape.run`` against the same loop
  written with the reference's functions at ``lshape(2)``, held step by
  step: the same x gives eta to 1e-12, the same eta gives the same
  marks; the meshes, degrees and marks of the two loops agree exactly
  while no perturbation of eta within 1e-10 relative can change the
  marks (asserted for the whole loop at Dörfler fraction 0.5);
* a shorter tier-1 version of the reference's slow-marked
  ``test_p_adaptive_loop_lshape``: one p-adaptation cuts the L2 error
  below 0.7 of the first.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from hpdg_tpu import mesh as rmesh
from hpdg_tpu.basis.dgbasis import DGBasis as RBasis
from hpdg_tpu.blocks import api as rapi
from hpdg_tpu.blocks.persist import (degrees_after_refine, interpolate_to,
                                     save_state)
from hpdg_tpu.estimators.smoothness import smoothness_indicator
from hpdg_tpu.estimators.utility import mark_fraction
from hpdg_tpu.matrixfree.norms import jump_indicator
from hpdg_tpu.mesh.adaptive import refine_local

from hpdg_tpu_torch import convert
from hpdg_tpu_torch import mesh as tmesh
from hpdg_tpu_torch.basis.dgbasis import DGBasis as TBasis
from hpdg_tpu_torch.blocks import api as tapi
from hpdg_tpu_torch.estimators import error as terr
from hpdg_tpu_torch.estimators import utility as tutil
from hpdg_tpu_torch.examples import adaptive_lshape
from hpdg_tpu_torch.linalg import blockmatrix as tbm
from hpdg_tpu_torch.matrixfree import norms as tnorms

from test_torch_adaptive import _assert_same_mesh

CPU = "cpu"  # the port defaults to the card; these tests run on the CPU
GOLDEN = os.path.join(os.path.dirname(__file__), "golden.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("n", [1, 2, 3])
def test_lshape_matches_reference(n):
    rm, tm = rmesh.lshape(n), tmesh.lshape(n)
    _assert_same_mesh(rm, tm)
    assert tm.n_elements == 3 * n * n


def test_c3_fingerprint():
    gold = np.load(GOLDEN)
    tb = TBasis(tmesh.lshape(2), gold["c3_degrees"])
    A = tapi.laplace(tb, penalty=2.0, dirichlet=True, device=CPU)
    fro = np.linalg.norm(tbm.to_dense(A, tb))
    assert abs(fro - float(gold["c3_fro"])) <= 1e-12 * float(gold["c3_fro"])


def _u(x, lib):
    return lib.sin(np.pi * x[..., 0]) * lib.sin(np.pi * x[..., 1])


@pytest.mark.parametrize("dirichlet", [True, False])
def test_api_norms_and_interpolate_match_reference(dirichlet):
    deg = np.load(GOLDEN)["c3_degrees"]
    rb, tb = RBasis(rmesh.lshape(2), deg), TBasis(tmesh.lshape(2), deg)
    want = rapi.interpolate(rb, lambda q: _u(q, jnp))
    got = tapi.interpolate(tb, lambda q: _u(q, torch), device=CPU)
    for p in want:
        assert got[p].dtype == torch.float64
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                   rtol=0, atol=1e-15)
    np.testing.assert_allclose(tb.node_positions(5), rb.node_positions(5),
                               rtol=0, atol=0)
    x = {p: np.asarray(v) + 0.1 * np.random.default_rng(p).standard_normal(
        v.shape) for p, v in want.items()}
    xr = {p: jnp.asarray(v) for p, v in x.items()}
    xt = convert.bucket_dict(x, device=CPU)
    eta_r = np.asarray(rapi.local_norm(rb, xr, penalty=2.0,
                                       dirichlet=dirichlet))
    eta_t = tapi.local_norm(tb, xt, penalty=2.0, dirichlet=dirichlet,
                            device=CPU)
    np.testing.assert_allclose(eta_t.numpy(), eta_r, rtol=0,
                               atol=1e-12 * eta_r.max())
    g_r = rapi.global_error(rb, xr, penalty=2.0, dirichlet=dirichlet)
    g_t = tapi.global_error(tb, xt, penalty=2.0, dirichlet=dirichlet,
                            device=CPU)
    assert isinstance(g_t, float) and abs(g_t - g_r) <= 1e-12 * g_r


def _reference_loop(n, steps, frac=0.4, smooth_cut=0.5):
    """The loop of ``examples/adaptive_lshape.py`` with the reference's
    functions, recording what each step computed."""
    m = rmesh.lshape(n)
    basis = RBasis(m, np.full(m.n_elements, 1))
    f = lambda x: 1.0 + 0.0 * x[..., 0]  # noqa: E731
    out = []
    for _ in range(steps):
        A = rapi.laplace(basis, penalty=2.0, dirichlet=True)
        b = rapi.l2_functional(basis, f)
        x, info = rapi.solve_linear(basis, A, b, tol=1e-9, maxiter=80)
        eta = np.asarray(jump_indicator(basis, penalty=2.0)(x))
        marks = mark_fraction(eta, frac)
        smooth = smoothness_indicator(basis, x)
        raise_p = marks & (smooth < smooth_cut)
        refine_h = marks & ~raise_p
        saved = save_state(basis, x)
        out.append(dict(basis=basis, x=x, info=info, eta=eta, marks=marks,
                        raise_p=raise_p, refine_h=refine_h))
        new_deg = basis.degrees.copy()
        new_deg[raise_p] += 1
        if refine_h.any():
            newmesh = refine_local(basis.mesh, refine_h)
            new_deg = degrees_after_refine(new_deg, newmesh)
            basis = RBasis(newmesh, new_deg)
        else:
            basis = basis.with_degrees(new_deg)
        out[-1]["x_next"] = interpolate_to(saved, basis)
    return out


def _marks_are_stable(eta, frac, trials=200):
    """True when no perturbation of eta within 1e-10 relative changes the
    Dörfler marks (no near-tie straddles the cut)."""
    rng = np.random.default_rng(0)
    want = mark_fraction(eta, frac)
    return all(np.array_equal(mark_fraction(
        eta * (1 + 1e-10 * rng.uniform(-1, 1, len(eta))), frac), want)
        for _ in range(trials))


@pytest.mark.parametrize("frac", [0.4, 0.5])
def test_adaptive_loop_matches_reference(frac):
    """Step by step: the reference's x gives the reference's eta through
    the port, and its eta the same marks.  The two loops' trajectories
    (meshes, degrees, x, eta, marks) are compared exactly while the
    marks cannot flip: lshape(2) is symmetric about y = -x, so mirror
    elements tie within 1e-15 at every fraction, and at the example's
    0.4 a tied pair straddles step 0's cut; at 0.5 none does."""
    ref = _reference_loop(2, 2, frac=frac)
    got = adaptive_lshape.run(n=2, steps=2, frac=frac, device=CPU)
    assert len(got) == len(ref) == 2
    same_path = True
    for r, t in zip(ref, got):
        rb = r["basis"]
        tb = TBasis(tmesh.from_boxes(rb.mesh.lower, rb.mesh.extent),
                    rb.degrees)
        xr = convert.bucket_dict({p: np.asarray(v) for p, v in r["x"].items()},
                                 device=CPU)
        eta = tnorms.jump_indicator(tb, penalty=2.0, device=CPU)(xr).numpy()
        np.testing.assert_allclose(eta, r["eta"], rtol=0,
                                   atol=1e-12 * r["eta"].max())
        np.testing.assert_array_equal(tutil.mark_fraction(r["eta"], frac),
                                      r["marks"])
        if not same_path:
            continue
        _assert_same_mesh(rb.mesh, t["basis"].mesh)
        np.testing.assert_array_equal(t["basis"].degrees, rb.degrees)
        assert t["ndof"] == rb.ndof
        assert t["info"]["iterations"] == r["info"]["iterations"]
        for p in r["x"]:
            np.testing.assert_allclose(t["x"][p].numpy(),
                                       np.asarray(r["x"][p]), rtol=0,
                                       atol=1e-9)
        np.testing.assert_allclose(t["eta"], r["eta"], rtol=0,
                                   atol=1e-8 * r["eta"].max())
        same_path = _marks_are_stable(r["eta"], frac)
        if same_path:
            for key in ("marks", "raise_p", "refine_h"):
                np.testing.assert_array_equal(t[key], r[key], err_msg=key)
            for p in r["x_next"]:
                np.testing.assert_allclose(t["x_next"][p].numpy(),
                                           np.asarray(r["x_next"][p]),
                                           rtol=0, atol=1e-9)
    if frac == 0.5:  # no near-tie at any cut: the whole loop was compared
        assert same_path and got[1]["basis"].max_degree() == 2


def test_example_main_prints_the_steps(capsys):
    adaptive_lshape.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 0: 48 dofs" in out and "step 1" in out


def test_p_adaptive_loop_lshape_short():
    """Solve -> local DG norm of the true error -> Dörfler-mark -> raise
    p -> persist -> re-solve on lshape(2): the true L2 error drops."""
    from hpdg_tpu_torch.blocks.persist import interpolate_to as t_interp
    from hpdg_tpu_torch.blocks.persist import save_state as t_save

    m = tmesh.lshape(2)
    u = lambda x: _u(x, torch)  # noqa: E731
    f = lambda x: 2 * np.pi ** 2 * u(x)  # noqa: E731
    basis = TBasis(m, np.full(m.n_elements, 1))

    def solve(basis):
        A = tapi.laplace(basis, penalty=2.0, dirichlet=True, device=CPU)
        b = tapi.l2_functional(basis, f, device=CPU)
        x, _ = tapi.solve_linear(basis, A, b, tol=1e-10, maxiter=60)
        return x

    x = solve(basis)
    err1 = float(terr.l2_error(basis, x, u))
    ui = tapi.interpolate(basis, u, device=CPU)
    eta = tapi.local_norm(basis, {p: x[p] - ui[p] for p in x}, penalty=2.0,
                          device=CPU).numpy()
    marks = tutil.mark_fraction(eta, 0.6)
    assert marks.any() and not marks.all()
    new_deg = basis.degrees.copy()
    new_deg[marks] += 1
    basis2 = basis.with_degrees(new_deg)
    x0 = t_interp(t_save(basis, x), basis2, device=CPU)
    x2 = solve(basis2)
    err2 = float(terr.l2_error(basis2, x2, u))
    assert err2 < 0.7 * err1, (err1, err2)
    # the carried state is the old solution: carried back, it is x again
    back = t_interp(t_save(basis2, x0), basis, device=CPU)
    for p in x:
        np.testing.assert_allclose(back[p].numpy(), x[p].numpy(), rtol=0,
                                   atol=1e-13)
