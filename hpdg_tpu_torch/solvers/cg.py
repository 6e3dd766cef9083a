"""Preconditioned conjugate gradients on bucketed block vectors.

Port of ``hpdg_tpu.solvers.cg.pcg``.  The reference runs a
``lax.while_loop``; here it is a host loop with one device-to-host sync
per iteration (the residual norm for the stopping test), and the same
contract: the history has length ``maxiter + 1``, padded with the final
value, and the loop stops at the first ``k`` with
``residuals[k] <= target``.  ``loop_solve`` drives an iteration step
(a multigrid cycle) with the reference's energy-norm stopping rule.
"""

from __future__ import annotations

import torch

from hpdg_tpu_torch.linalg import blockvector as bv


def pcg(matvec_fn, b: dict, x0: dict | None = None, precond=None,
        tol: float = 1e-8, maxiter: int = 500, rtol: bool = True):
    """Solve A x = b with (preconditioned) CG.

    ``matvec_fn`` / ``precond``: callables dict -> dict.  Returns
    ``(x, info)`` with ``info = {"iterations", "residuals"}`` where
    ``residuals[k] = ||b - A x_k||_2`` as tracked by the recursion (a
    float64 CPU tensor of length ``maxiter + 1``, padded with the final
    value after convergence).
    """
    x = bv.zeros_like(b) if x0 is None else x0
    M = precond or (lambda r: r)
    r = bv.sub(b, matvec_fn(x))
    z = M(r)
    pdir = z
    rz = bv.dot(r, z)
    nb = float(bv.norm(b))
    target = tol * (nb if nb > 0 else 1.0) if rtol else tol
    hist = [float(bv.norm(r))]
    k = 0
    while k < maxiter and hist[k] > target:
        Ap = matvec_fn(pdir)
        alpha = rz / bv.dot(pdir, Ap)
        x = bv.axpy(alpha, pdir, x)
        r = bv.axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = bv.dot(r, z)
        pdir = bv.axpy(rz_new / rz, pdir, z)
        rz = rz_new
        hist.append(float(bv.norm(r)))  # the one sync of the iteration
        k += 1
    hist += [hist[k]] * (maxiter - k)
    return x, {"iterations": k,
               "residuals": torch.tensor(hist, dtype=torch.float64)}


def loop_solve(step_fn, x0: dict, b: dict, matvec_fn=None, tol: float = 1e-8,
               maxiter: int = 100, norm_fn=None):
    """dune-solvers ``LoopSolver`` analog: iterate ``x_{k+1} =
    step_fn(x_k, b)`` until the norm of the correction drops below
    ``tol``.  ``norm_fn(correction)`` defaults to the energy norm
    ``sqrt(|c^T A c|)`` if ``matvec_fn`` is given, else the 2-norm.  A
    host loop with one sync per step (the norm).  Returns ``(x, info)``
    with ``info = {"iterations", "history"}``."""
    if norm_fn is None:
        if matvec_fn is not None:
            norm_fn = lambda c: torch.sqrt(torch.abs(  # noqa: E731
                bv.dot(c, matvec_fn(c))))
        else:
            norm_fn = bv.norm
    x = x0
    history = []
    for _ in range(maxiter):
        xn = step_fn(x, b)
        err = float(norm_fn(bv.sub(xn, x)))  # the step's one sync
        history.append(err)
        x = xn
        if err < tol:
            break
    return x, {"iterations": len(history), "history": history}
